"""Frozen plain copy of harp_tpu_torch/losses/texture_reg.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

Stochastic texture smoothness regularisers (harp_tpu/losses/texture_reg.py).

Each texel is compared with a neighbour at a Gaussian offset drawn fresh
every step, here from an explicit torch.Generator; `offsets=` replaces the
draw (the parity tests hand both packages the same offsets).
"""

from __future__ import annotations

import torch

from benchmark.reference.device import constant
from benchmark.reference.ops.numerics import jnp_abs, safe_norm
from benchmark.reference.ops.segment import SegmentOrder, gather_rows


def neighbor_offsets(generator: torch.Generator, shape, std: float,
                     device) -> torch.Tensor:
    """(H, W, 2) int offsets: std * N(0, 1), truncated toward zero."""
    d = std * torch.randn(tuple(shape) + (2,), generator=generator,
                          device=generator.device)
    return torch.trunc(d).to(device=device, dtype=torch.int64)


def smooth_texture_reg(texture: torch.Tensor, generator=None, std: float = 2.0,
                       uv_mask: torch.Tensor | None = None,
                       offsets: torch.Tensor | None = None) -> torch.Tensor:
    """Mean |texel - random neighbour|_1 / 3, uv-masked. |.| has jnp.abs's
    derivative (+1 at 0: on a uniform map every texel moves), and the
    neighbour gather's backward is the fixed-order segment sum."""
    H, W = texture.shape[0], texture.shape[1]
    dev = texture.device
    dist = (neighbor_offsets(generator, (H, W), std, dev) if offsets is None
            else torch.as_tensor(offsets, device=dev).long())
    gx = (torch.arange(H, device=dev)[:, None] + dist[..., 0]).clamp(0, H - 1)
    gy = (torch.arange(W, device=dev)[None, :] + dist[..., 1]).clamp(0, W - 1)
    C = texture.shape[2]
    tar = gather_rows(texture.reshape(H * W, C), SegmentOrder(gx * W + gy, H * W))
    diff = jnp_abs(texture - tar.reshape(H, W, C)).sum(-1) / 3.0
    if uv_mask is not None:
        diff = diff * uv_mask
    return diff.mean()


def albedo_reg(texture, generator=None, std: float = 1.0, uv_mask=None,
               offsets=None) -> torch.Tensor:
    """Reference albedo_reg: L1 over channels per texel pair / 3."""
    return smooth_texture_reg(texture, generator, std=std, uv_mask=uv_mask,
                              offsets=offsets)


def close_to_z_reg(normal_map: torch.Tensor) -> torch.Tensor:
    """Mean ||n - (0, 0, 1)||_2 / 3."""
    z = constant((0.0, 0.0, 1.0), normal_map.device, normal_map.dtype)
    return (safe_norm(normal_map - z, dim=-1) / 3.0).mean()


def normal_reg(normal_map, generator=None, std: float = 2.0, uv_mask=None,
               offsets=None) -> torch.Tensor:
    """0.2 * close-to-flat + local smoothness."""
    return 0.2 * close_to_z_reg(normal_map) + smooth_texture_reg(
        normal_map, generator, std=std, uv_mask=uv_mask, offsets=offsets)
