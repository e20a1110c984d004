"""K3: the PCF shadow-map gradient scatter on Hopper.

Replaces harp_tpu/render/pallas/pcf_grad_kernel.py:_kernel (:49-92),
launched by pallas_pcf_scatter (:95-148) from shadow._pcf_sum_depth_bwd:

    dpad[b, yc + di, xc + dj] += upd[b, i, 3 * (di + 1) + (dj + 1)]

on the (B, Hl + 4, Hl + 4) twice-edge-padded light depth map.

What bounds it on this card: bytes. Each camera pixel reads 8 bytes of tap
centres and 36 bytes of tap updates and does nine additions. The TPU
kernel's one-hot matrix products existed only to use the MXU; its locality
stays: csrc/pcf_scatter.cu gives each block a band of rows of one frame's
map in shared memory and walks the frame's pixels in entry order. The sum
is order-free rather than sorted: each update is rounded once to a 64-bit
fixed-point integer at a scale fixed by max |upd| (fixed_point_shift), and
integers add in any order to the same total, so dpad is the same bits from
run to run with no sort and no float atomic. pcf_scatter_fixed_plain is
that function as int64 tensor code; the kernel equals it bit for bit.

pcf_scatter_plain (float32 scatter-adds) stays K3's plain version and the
CPU path. fold_pad2 (plain tensor code) folds the padding back to
(B, Hl, Hl).
"""

from __future__ import annotations

import ctypes
import math

import torch

from harp_tpu_torch.csrc import build
from harp_tpu_torch.utils.debug_nans import check_kernel

LAUNCHES = {"pcf_scatter": 0}


def _lib():
    lib = build.load("pcf_scatter")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pcf_scatter.argtypes = [P, P, P, I, I, I, P, P, P]
        lib.pcf_scatter.restype = I
        lib.pcf_scatter_scratch_bytes.argtypes = [I, I, I]
        lib.pcf_scatter_scratch_bytes.restype = ctypes.c_longlong
        lib.pcf_scatter_layout.argtypes = [I, I, I, P]
        lib.pcf_scatter_layout.restype = I
        lib._typed = True
    return lib


def launch_layout(batch: int, n: int, hl: int) -> dict:
    """The kernel's launch for `batch` frames of n pixels on an (hl + 4)^2
    map: rows a band, bands a frame, splits of a frame's pixels, dynamic
    shared bytes and resident blocks per SM (the CUDA occupancy calculator;
    needs the card)."""
    out = (ctypes.c_int * 5)()
    build.check(_lib().pcf_scatter_layout(batch, n, hl, ctypes.addressof(out)),
                "pcf_scatter_layout")
    return dict(zip(("band_rows", "bands", "splits", "smem_bytes", "blocks_per_sm"), out))


def pcf_scatter(yc: torch.Tensor, xc: torch.Tensor, upd: torch.Tensor,
                hl: int) -> torch.Tensor:
    """yc, xc (B, N) int32 tap centres in the padded map (in [1, hl + 2];
    not checked on the card: that would synchronise); upd (B, N, 9) f32 tap
    gradients -> dpad (B, hl + 4, hl + 4) f32."""
    B, N = yc.shape
    if (yc.dtype != torch.int32 or xc.dtype != torch.int32 or tuple(xc.shape) != (B, N)
            or upd.dtype != torch.float32 or tuple(upd.shape) != (B, N, 9)):
        raise ValueError("pcf_scatter takes yc, xc (B, N) int32 and upd (B, N, 9) float32")
    if not (yc.device == xc.device == upd.device):
        raise ValueError("pcf_scatter inputs must share one device")
    if yc.device.type == "cpu":
        return pcf_scatter_plain(yc, xc, upd, hl)
    if yc.device.type != "cuda":
        raise ValueError(f"unsupported device {yc.device}")
    if not (yc.is_contiguous() and xc.is_contiguous() and upd.is_contiguous()):
        raise ValueError("pcf_scatter inputs must be contiguous")
    dev = yc.device
    hp4 = hl + 4
    if B * N == 0:  # nothing to launch for
        return torch.zeros(B, hp4, hp4, dtype=torch.float32, device=dev)
    lib = _lib()
    scratch = torch.empty(lib.pcf_scatter_scratch_bytes(B, N, hl), dtype=torch.uint8, device=dev)
    dpad = torch.empty(B, hp4, hp4, dtype=torch.float32, device=dev)
    rc = lib.pcf_scatter(yc.data_ptr(), xc.data_ptr(), upd.data_ptr(), B, N, hl,
                         scratch.data_ptr(), dpad.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "pcf_scatter")
    LAUNCHES["pcf_scatter"] += 1
    check_kernel(dpad, "pcf_scatter")
    return dpad


def pcf_scatter_plain(yc, xc, upd, hl: int) -> torch.Tensor:
    """K3's plain PyTorch version: one scatter-add per tap, in upd's dtype."""
    B = yc.shape[0]
    hp4 = hl + 4
    dpad = torch.zeros(B, hp4 * hp4, dtype=upd.dtype, device=yc.device)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            idx = ((yc.long() + di) * hp4 + (xc.long() + dj))
            dpad.scatter_add_(1, idx, upd[:, :, 3 * (di + 1) + (dj + 1)])
    return dpad.reshape(B, hp4, hp4)


def fixed_point_shift(max_abs: float, n: int) -> int:
    """The kernel's scale 2^s for updates of largest finite magnitude
    max_abs, N = n pixels a frame: s = 62 - k - e with 9n <= 2^k and
    max_abs < 2^e (frexp; e = 0 for 0). A texel then sums at most 9n
    terms of magnitude <= 2^(62-k), so |sum| <= 2^62: no int64 overflow."""
    k = (9 * n - 1).bit_length()
    e = math.frexp(max_abs)[1] if max_abs > 0 else 0
    return 62 - k - e


def pcf_scatter_fixed_plain(yc, xc, upd, hl: int) -> torch.Tensor:
    """The kernel's exact function as int64 tensor code: q = rint(u * 2^s)
    per finite update (round half to even), integer scatter-adds, then
    (float)((double)sum * 2^-s). A texel reached by a NaN, or by both
    infinities, is NaN; by one infinity, that infinity."""
    B, N = yc.shape
    hp4 = hl + 4
    finite = torch.isfinite(upd)
    max_abs = float(upd.abs().where(finite, 0.0).max()) if upd.numel() else 0.0
    s = fixed_point_shift(max_abs, N)
    q = torch.round(upd.double().where(finite, 0.0) * 2.0 ** s).long()
    acc = torch.zeros(B, hp4 * hp4, dtype=torch.int64, device=yc.device)
    kinds = (upd == math.inf, upd == -math.inf, torch.isnan(upd))
    seen = [torch.zeros_like(acc) for _ in kinds]
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            tap = 3 * (di + 1) + (dj + 1)
            idx = (yc.long() + di) * hp4 + (xc.long() + dj)
            acc.scatter_add_(1, idx, q[:, :, tap])
            for count, kind in zip(seen, kinds):
                count.scatter_add_(1, idx, kind[:, :, tap].long())
    out = (acc.double() * 2.0 ** -s).float()
    pos, neg, nan = (count > 0 for count in seen)
    out = torch.where(pos, math.inf, out)
    out = torch.where(neg, -math.inf, out)
    out = torch.where(nan | (pos & neg), math.nan, out)
    return out.reshape(B, hp4, hp4)


def fold_pad2(dpad: torch.Tensor) -> torch.Tensor:
    """Transpose of an edge pad by 2: fold the two border rows / cols of
    (B, Hl + 4, Hl + 4) into the nearest core row / col -> (B, Hl, Hl)."""
    def fold_rows(x):
        first = x[:, 2:3] + x[:, 0:2].sum(1, keepdim=True)
        last = x[:, -3:-2] + x[:, -2:].sum(1, keepdim=True)
        return torch.cat([first, x[:, 3:-3], last], 1)

    return fold_rows(fold_rows(dpad).transpose(1, 2)).transpose(1, 2)
