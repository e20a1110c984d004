"""Frozen plain copy of harp_tpu_torch/ops/numerics.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

Numerically-safe primitives (harp_tpu/ops/numerics.py).

The norm is clamped inside the sqrt so its gradient is zero, not NaN, at 0.
"""

from __future__ import annotations

import torch

from benchmark.reference.device import constant


def safe_norm(x: torch.Tensor, dim=-1, keepdim: bool = False,
              eps: float = 1e-24) -> torch.Tensor:
    """L2 norm with zero gradient at x == 0 (clamped inside the sqrt)."""
    sq = (x * x).sum(dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=eps))


def safe_normalize(x: torch.Tensor, dim=-1, eps: float = 1e-24) -> torch.Tensor:
    """x / ||x|| with zero output (and finite gradient) at x == 0."""
    return x / safe_norm(x, dim=dim, keepdim=True, eps=eps)


def jnp_abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with jnp.abs's derivative: +1 at 0 and at -0.0 (torch.abs: 0)."""
    return torch.where(x >= 0, x, -x)


def jnp_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """x clipped to [lo, hi] with jnp.clip's derivative: 1/2 where x equals
    a bound exactly (torch.clamp: 1). torch.maximum / torch.minimum split
    the gradient of a tie in half, as jnp.maximum / jnp.minimum do."""
    return torch.minimum(torch.maximum(x, constant(lo, x.device, x.dtype)),
                         constant(hi, x.device, x.dtype))
