"""K3: the PCF shadow-map gradient scatter on Hopper.

Replaces harp_tpu/render/pallas/pcf_grad_kernel.py:_kernel (:49-92),
launched by pallas_pcf_scatter (:95-148) from shadow._pcf_sum_depth_bwd:

    dpad[b, yc + di, xc + dj] += upd[b, i, 3 * (di + 1) + (dj + 1)]

on the (B, Hl + 4, Hl + 4) twice-edge-padded light depth map.

What bounds it on this card: bytes. Each camera pixel reads 8 bytes of tap
centres and 36 bytes of tap updates and does nine additions. The TPU
kernel's one-hot matrix products existed only to use the MXU. Here the sum
is taken in an order fixed by the input, with no float atomics, so dpad is
the same bits from run to run: the pixels are sorted by tap centre (one
sort of N keys, not 9N), the fixed-order segment sum (ops/segment.py) adds
each pixel's nine updates into its centre, and csrc/pcf_scatter.cu gathers
the nine centre sums that land on each map texel, in tap order.

fold_pad2 (plain tensor code) folds the padding back to (B, Hl, Hl).
"""

from __future__ import annotations

import ctypes

import torch

from harp_tpu_torch.ops.segment import SegmentOrder, segment_sum
from harp_tpu_torch.csrc import build

LAUNCHES = {"pcf_scatter": 0}


def _lib():
    lib = build.load("pcf_scatter")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pcf_gather_taps.argtypes = [P, I, I, P, P]
        lib.pcf_gather_taps.restype = I
        lib._typed = True
    return lib


def pcf_scatter(yc: torch.Tensor, xc: torch.Tensor, upd: torch.Tensor,
                hl: int) -> torch.Tensor:
    """yc, xc (B, N) int32 tap centres in the padded map (in [1, hl + 2]);
    upd (B, N, 9) f32 tap gradients -> dpad (B, hl + 4, hl + 4) f32."""
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
    b = torch.arange(B, device=dev)[:, None]
    centre = SegmentOrder((b * hp4 + yc) * hp4 + xc, B * hp4 * hp4)
    csum = segment_sum(upd.reshape(B * N, 9), centre)
    dpad = torch.empty(B, hp4, hp4, dtype=torch.float32, device=dev)
    rc = _lib().pcf_gather_taps(csum.data_ptr(), B, hl, dpad.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "pcf_scatter")
    LAUNCHES["pcf_scatter"] += 1
    return dpad


def pcf_scatter_plain(yc, xc, upd, hl: int) -> torch.Tensor:
    """K3's plain PyTorch version: one scatter-add per tap."""
    B = yc.shape[0]
    hp4 = hl + 4
    dpad = torch.zeros(B, hp4 * hp4, dtype=torch.float32, device=yc.device)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            idx = ((yc.long() + di) * hp4 + (xc.long() + dj))
            dpad.scatter_add_(1, idx, upd[:, :, 3 * (di + 1) + (dj + 1)])
    return dpad.reshape(B, hp4, hp4)


def fold_pad2(dpad: torch.Tensor) -> torch.Tensor:
    """Transpose of an edge pad by 2: fold the two border rows / cols of
    (B, Hl + 4, Hl + 4) into the nearest core row / col -> (B, Hl, Hl)."""
    def fold_rows(x):
        first = x[:, 2:3] + x[:, 0:2].sum(1, keepdim=True)
        last = x[:, -3:-2] + x[:, -2:].sum(1, keepdim=True)
        return torch.cat([first, x[:, 3:-3], last], 1)

    return fold_rows(fold_rows(dpad).transpose(1, 2)).transpose(1, 2)
