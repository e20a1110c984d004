"""Frozen plain copy of harp_tpu_torch/models/html.py: the benchmark's reference,
independent of later changes to the program.

HTML's texture-basis appearance model (harp_tpu/models/html.py): a UV
texture is mean + basis @ coeffs (101 coefficients in the HTML release).
A deterministic synthetic basis stands in for the license-gated release.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class TextureBasis:
    """Linear texture model: texture(c) = reshape(mean + basis @ c)."""

    mean: np.ndarray  # (H*W*3,)
    basis: np.ndarray  # (H*W*3, K)
    shape: tuple  # (H, W, 3)
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_coeffs(self) -> int:
        return self.basis.shape[1]

    def on(self, device) -> tuple:
        """(mean, basis) as float32 tensors on `device`, made once."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(
                torch.as_tensor(np.asarray(a, np.float32), device=device)
                for a in (self.mean, self.basis))
        return self._on[device]

    def texture(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(K,) or (B, K) coeffs -> (H, W, 3) or (B, H, W, 3) texture."""
        mean, basis = self.on(coeffs.device)
        flat = mean + coeffs @ basis.T
        return flat.reshape(tuple(coeffs.shape[:-1]) + tuple(self.shape))


def synthetic_texture_basis(size: int = 64, num_coeffs: int = 16,
                            seed: int = 0) -> TextureBasis:
    """Deterministic low-frequency basis."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    mean = np.tile([0.8, 0.6, 0.55], (size, size, 1)).astype(np.float32)
    modes = []
    for _ in range(num_coeffs):
        fy, fx = rng.uniform(1, 6, 2)
        ph = rng.uniform(0, 6.28, 2)
        field = 0.1 * np.sin(2 * np.pi * fy * yy + ph[0]) * np.cos(2 * np.pi * fx * xx + ph[1])
        color = rng.randn(3) * 0.5
        modes.append((field[..., None] * color).astype(np.float32).reshape(-1))
    return TextureBasis(mean=mean.reshape(-1), basis=np.stack(modes, 1), shape=(size, size, 3))
