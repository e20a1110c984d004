"""VGG16 perceptual features (harp_tpu/losses/perceptual.py).

The reference extracts VGG16 activations at relu1_2 / relu2_2 / relu3_3 /
relu4_3, weights them beside the raw image, and takes an L1 between the
predicted and true feature vectors. Here the network is nn.Conv2d (3x3,
padding 1) and 2x2 max pools, run by cuDNN on the card:

- weights load from an .npz (w0..wN / b0..bN in HWIO, harp_tpu's layout,
  moved to OIHW) when given;
- otherwise harp_tpu's deterministic He-initialised random filters, drawn
  from the same numpy RandomState stream. `source` records which.

Inputs are (B, H, W, 3) in [0, 1], as in harp_tpu; no ImageNet
normalisation. `slices` returns the pyramid as (B, C, h, w) tensors in
channels_last memory (the NHWC input permuted, the layout cuDNN's
tensor-core convolutions read and write); the GT cache of
precompute_slices is (N, h, w, C), harp_tpu's layout, so that a frame
gather of it permuted is channels_last too and the differences with the
pred features run on matching layouts.

The filters take no gradient: only the input's gradient is needed. With
compute_dtype "bfloat16" the activations are bf16, each |difference| is
taken in bf16 and summed in float32, as harp_tpu does. |.| has jnp.abs's
derivative (+1 at 0), which matters where pred and GT are equal (the
masked background of the raw-image slice).

Determinism on the card: cuDNN's backward reads the global
torch.backends.cudnn flags at the time it runs, so the callers
(TrainStep, fit_sequence, evaluate_sequence) hold
device.deterministic_convolutions() around both forward and backward.
max_pool2d routes the gradient of a tie to the first maximum, as XLA's
select-and-scatter does.

Memory: with remat each frame chunk is checkpointed and its forward runs
again in the backward; without it autograd keeps the chunk's activations
(saved_bytes counts them). The two give the same bits, and recompute
chooses between them from the free device memory (the train step asks once
a frame shape).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from harp_tpu_torch.ops.numerics import jnp_abs

# Channel widths of the VGG16 conv layers; 'M' marks a max pool.
VGG16_LAYOUT = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M"]
# Conv counts per feature slice (through relu1_2, relu2_2, relu3_3, relu4_3).
SLICE_CONVS = [2, 2, 3, 3]
N_CONVS = sum(SLICE_CONVS)  # 10: through relu4_3
LAYERS_WEIGHTS = (1.0, 1 / 16, 1 / 8, 1 / 4, 1.0)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _init_weights(seed: int = 0):
    """harp_tpu's random filters: [(w HWIO, b)] numpy, He-scaled, one
    RandomState stream over the 10 convs (w comes out float64, as
    harp_tpu's does; the convolutions hold it in their compute dtype)."""
    rng = np.random.RandomState(seed)
    params = []
    cin = 3
    for item in VGG16_LAYOUT:
        if item == "M":
            continue
        cout = int(item)
        w = rng.randn(3, 3, cin, cout).astype(np.float32) * np.sqrt(2.0 / (9 * cin))
        params.append((w, np.zeros(cout, np.float32)))
        cin = cout
    return params


def load_vgg16_npz(path: str):
    """Conv weights from an npz with keys w0..wN / b0..bN in HWIO. Only the
    first N_CONVS (10, through relu4_3) are read, so an npz of all 13
    VGG16 convs works too."""
    data = np.load(path)
    return [(data[f"w{i}"], data[f"b{i}"]) for i in range(N_CONVS)]


class Vgg16Features(nn.Module):
    """Feature-pyramid extractor; `params` holds the (w HWIO, b) numpy pairs
    it was made from, the convolutions hold them OIHW in compute_dtype."""

    def __init__(self, params, layers_weights=LAYERS_WEIGHTS, source: str = "random",
                 compute_dtype: str = "float32", device=None):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        self.params = tuple(params)[:N_CONVS]
        self.layers_weights = tuple(layers_weights)
        self.source = source
        self.compute_dtype = compute_dtype
        dt = _DTYPES[compute_dtype]
        convs = []
        for w, b in self.params:
            conv = nn.Conv2d(w.shape[2], w.shape[3], 3, padding=1)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                    np.asarray(w, np.float32).transpose(3, 2, 0, 1))))
                conv.bias.copy_(torch.from_numpy(np.asarray(b, np.float32)))
            convs.append(conv)
        self.convs = nn.ModuleList(convs)
        self.requires_grad_(False)
        self.to(device=device, dtype=dt, memory_format=torch.channels_last)

    @classmethod
    def create(cls, weights_path: str | None = None, seed: int = 0,
               layers_weights=LAYERS_WEIGHTS, compute_dtype: str = "float32",
               device=None) -> "Vgg16Features":
        if weights_path:
            return cls(load_vgg16_npz(weights_path), layers_weights, "pretrained",
                       compute_dtype, device)
        return cls(_init_weights(seed), layers_weights, "random", compute_dtype, device)

    def with_dtype(self, compute_dtype: str) -> "Vgg16Features":
        """The same filters in another compute dtype (eval runs float32)."""
        if compute_dtype == self.compute_dtype:
            return self
        return Vgg16Features(self.params, self.layers_weights, self.source,
                             compute_dtype, self.convs[0].weight.device)

    def slices(self, x: torch.Tensor) -> list:
        """x (B, H, W, 3) in [0, 1] -> [x, relu1_2, relu2_2, relu3_3, relu4_3],
        each (B, C, h, w); the raw image keeps x's dtype."""
        feats = [x.permute(0, 3, 1, 2)]
        h = feats[0].to(_DTYPES[self.compute_dtype])
        li = 0
        for si, n_convs in enumerate(SLICE_CONVS):
            if si > 0:
                h = F.max_pool2d(h, 2, 2)
            for _ in range(n_convs):
                h = torch.relu(self.convs[li](h))
                li += 1
            feats.append(h)
        return feats


def _feature_count_per_frame(vgg: Vgg16Features, h: int, w: int) -> int:
    """Element count of one frame's feature pyramid (the L1 mean's divisor)."""
    n = h * w * 3  # the raw image slice
    for si, c in enumerate([64, 128, 256, 512]):
        n += (h // 2 ** si) * (w // 2 ** si) * c
    return n


def saved_bytes(vgg: Vgg16Features, batch: int, h: int, w: int) -> int:
    """Bytes that autograd keeps for the backward of the VGG term (either
    of the losses below) over `batch` frames of h x w when the forward runs
    once, without the checkpoint: per frame the input's cast to the
    compute dtype (the first convolution's input; none in float32, where
    the input is the caller's own tensor), each ReLU's output (the next
    convolution's or pool's input too), each pool's output and its int64
    indices, and the L1's sign mask, one bool an element of the pyramid
    (jnp_abs's where keeps its condition; the differences are not kept).
    The filters persist and are not counted."""
    size = torch.empty((), dtype=_DTYPES[vgg.compute_dtype]).element_size()
    per = h * w * 3 * size if vgg.compute_dtype != "float32" else 0
    hh, ww, c, convs = h, w, 3, 0
    for item in VGG16_LAYOUT:
        if convs == N_CONVS:
            break
        if item == "M":
            hh, ww = hh // 2, ww // 2
            per += hh * ww * c * (size + 8)
        else:
            c, convs = int(item), convs + 1
            per += hh * ww * c * size
    return batch * (per + _feature_count_per_frame(vgg, h, w))


# What the card must hold free beside the saved tensors for the VGG term to
# keep them: as much again (the rest of the step's activations and
# gradients, which grow with frames and pixels as the saved tensors do, and
# the backward's working set of a chunk) and a fixed GiB (cuDNN's
# workspaces, the caching allocator's rounding). On an H100, in fits of 18
# frames of 448^2 with the hand, the arm and NIMBLE, the step's peak stood
# 2.35-2.65 GB above what was allocated at the choice plus the 3.39 GB kept,
# 0.69-0.78 of the kept bytes: the headroom, 4.46 GB there, covers it.
_FIXED_HEADROOM = 1 << 30


def free_bytes(device) -> int | None:
    """Device memory this process can still allocate on a CUDA device: the
    driver's free memory and the caching allocator's reserved but unused
    blocks; None off CUDA (no such figure)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def recompute(remat: bool, saved: int, free: int | None) -> bool:
    """Whether the VGG term checkpoints its chunks (runs their forward
    again in the backward): never without `remat`; with it, where the
    saved tensors (saved_bytes) and the headroom do not fit in `free`, or
    where there is no figure of free memory (None: the CPU keeps remat as
    asked). Both ways give the same bits."""
    if not remat or free is None:
        return remat
    return 2 * saved + _FIXED_HEADROOM > free


def _weighted_abs_sum(vgg: Vgg16Features, fp, ft):
    """sum_k w_k * |fp_k - ft_k|: each difference in fp_k's dtype, summed in
    float32 (a bf16 sum over millions of elements would lose ~3 digits)."""
    total = 0.0
    for w, a, b in zip(vgg.layers_weights, fp, ft):
        total = total + w * jnp_abs(a - b.to(a.dtype)).sum(dtype=torch.float32)
    return total


def _chunk_size(n: int, chunk) -> int:
    """The largest divisor of n that is <= chunk (n when chunk is off)."""
    if not chunk or chunk >= n:
        return n
    return max(d for d in range(1, int(chunk) + 1) if n % d == 0)


def _chunked_sum(body, n: int, chunk, remat: bool, *args):
    """sum over frame chunks of body(*chunk of each arg); with remat each
    chunk's activations are recomputed in the backward (checkpoint)."""
    c = _chunk_size(n, chunk)
    sums = []
    for s in range(0, n, c):
        part = tuple(a[s:s + c] for a in args)
        if remat:
            sums.append(checkpoint(body, *part, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            sums.append(body(*part))
    return torch.stack(sums).sum() if len(sums) > 1 else sums[0]


def precompute_slices(vgg: Vgg16Features, images: torch.Tensor, chunk: int | None = 6,
                      dtype=None) -> tuple:
    """Per-frame GT feature pyramids of the whole sequence, computed once
    (no gradient): a tuple of (N, h, w, C) tensors in `dtype` (default the
    vgg's compute dtype: an f32 pipeline caches f32 GT features). `images`
    must already be masked as the loss masks them. Chunked over frames so
    no more than one chunk's pyramid is live at once."""
    dt = _DTYPES[vgg.compute_dtype] if dtype is None else dtype
    n = images.shape[0]
    c = _chunk_size(n, chunk)
    with torch.no_grad():
        parts = [[s.permute(0, 2, 3, 1).to(dt).contiguous()
                  for s in vgg.slices(images[i:i + c])] for i in range(0, n, c)]
    return tuple(torch.cat(p, 0) if len(p) > 1 else p[0] for p in zip(*parts))


def vgg_feature_l1_cached(vgg: Vgg16Features, pred: torch.Tensor, gt_slices: tuple,
                          fids: torch.Tensor, chunk: int | None = None,
                          remat: bool = True) -> torch.Tensor:
    """vgg_feature_l1 against precomputed GT pyramids (precompute_slices):
    only the pred side's VGG forward runs; the GT side is gt[fids]."""
    B = pred.shape[0]
    total_n = _feature_count_per_frame(vgg, pred.shape[1], pred.shape[2]) * B

    def absum(pred_c, fids_c):
        return _weighted_abs_sum(vgg, vgg.slices(pred_c),
                                 [g[fids_c].permute(0, 3, 1, 2) for g in gt_slices])

    return _chunked_sum(absum, B, chunk, remat, pred, fids) / total_n


def vgg_feature_l1(vgg: Vgg16Features, pred: torch.Tensor, true: torch.Tensor,
                   chunk: int | None = None, remat: bool = True) -> torch.Tensor:
    """L1 over the weighted concatenated feature vector (torch L1Loss mean
    semantics), slice by slice. chunk: frames per group, exact (the loss is
    a sum over frames), bounding the live activations to one group's
    pyramid; the largest divisor of B <= chunk is used."""
    B = pred.shape[0]
    total_n = _feature_count_per_frame(vgg, pred.shape[1], pred.shape[2]) * B

    def absum(p, t):
        return _weighted_abs_sum(vgg, vgg.slices(p), vgg.slices(t))

    return _chunked_sum(absum, B, chunk, remat, pred, true) / total_n
