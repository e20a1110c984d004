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
    losses/              keypoint / geometry / texture regularisers
    fit/                 parameters, the two Adam groups, the train step
    data/                synthetic ground-truth sequences

The package imports torch and numpy only: never jax, never harp_tpu.
Entry points run on CUDA unless the caller passes ``device="cpu"``; a CUDA
tensor always goes to the hand-written kernel, a CPU tensor to its plain
version.
"""

__version__ = "0.1.0"
