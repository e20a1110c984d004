"""harp_tpu_torch: the PyTorch + CUDA port of harp_tpu for NVIDIA Hopper.

The module tree mirrors harp_tpu/ so each counterpart is easy to find:

    config.py            HarpConfig (+ RasterConfig from render/rasterizer.py)
    ops/                 numerics, rotations, mesh topology and operators
    models/              linear blend skinning, MANO
    assets.py            synthetic MANO-topology hand + avatar asset bundle
    convert.py           arrays of harp_tpu's assets / params -> this package
    render/              camera, tile-binned rasterizer, shading, shadow,
                         the compact render pipeline
    render/kernels/      wrappers of the hand-written CUDA kernels, each with
                         its plain PyTorch version and a launch counter
    csrc/                the CUDA C++ sources (built by nvcc at first use)
    losses/              keypoint / geometry / texture regularisers, the
                         VGG16 perceptual loss (cuDNN convolutions)
    fit/                 parameters, the two Adam groups, the train step,
                         fit_sequence (the staged epochs, checkpoints,
                         resume, frame-parallel on a mesh),
                         fit_sequences_batch (many sequences) and
                         evaluate_sequence
    parallel/            meshes of processes over torch.distributed (NCCL,
                         gloo), the halo exchange, a launcher of local ranks
    eval/                IoU, L1, MS-SSIM, the VGG perceptual proxy,
                         Procrustes
    utils/               checkpoint / result IO, the async checkpointer
                         (orbax_io.py), JSONL metrics and profiling, PNG
                         visual outputs
    data/                synthetic ground-truth sequences
    fit_avatar.py        the CLI: python -m harp_tpu_torch.fit_avatar --synthetic

The package imports torch, numpy, scipy (Procrustes) and PyYAML (config
files) only: never jax, never harp_tpu.
Entry points run on CUDA unless the caller passes ``device="cpu"``; a CUDA
tensor always goes to the hand-written kernel, a CPU tensor to its plain
version.
"""

__version__ = "0.1.0"
