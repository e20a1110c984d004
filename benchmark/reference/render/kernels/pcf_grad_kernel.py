"""Frozen plain copy of harp_tpu_torch/render/kernels/pcf_grad_kernel.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

K3: the PCF shadow-map gradient scatter on Hopper.

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


import torch


def pcf_scatter(yc: torch.Tensor, xc: torch.Tensor, upd: torch.Tensor,
                hl: int) -> torch.Tensor:
    """K3's plain version on every device: (B, hl + 4, hl + 4)."""
    return pcf_scatter_plain(yc, xc, upd, hl)


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


def fold_pad2(dpad: torch.Tensor) -> torch.Tensor:
    """Transpose of an edge pad by 2: fold the two border rows / cols of
    (B, Hl + 4, Hl + 4) into the nearest core row / col -> (B, Hl, Hl)."""
    def fold_rows(x):
        first = x[:, 2:3] + x[:, 0:2].sum(1, keepdim=True)
        last = x[:, -3:-2] + x[:, -2:].sum(1, keepdim=True)
        return torch.cat([first, x[:, 3:-3], last], 1)

    return fold_rows(fold_rows(dpad).transpose(1, 2)).transpose(1, 2)
