"""HTML's texture-basis appearance model (harp_tpu/models/html.py).

A UV texture is mean + basis @ coeffs (101 coefficients in the HTML
release). The basis loads from the license-gated release when it is
there; a deterministic synthetic basis stands in for tests.

The product runs on the device of the coefficients: one matrix-vector
product (cuBLAS on the card, deterministic on one stream; chip_smoke.py
fixes its workspace with CUBLAS_WORKSPACE_CONFIG). The device copies of
mean and basis are made at first use and kept on the instance (at
512^2 x 3 x 101 the basis is 318 MB).
"""

from __future__ import annotations

import dataclasses
import pickle

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


def load_html_basis(tex_model_path: str, texture_shape=(1024, 1024, 3),
                    num_coeffs: int = 101) -> TextureBasis:
    """The HTML release's texture model pkl (keys 'mean' / 'basis')."""
    with open(tex_model_path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    mean = np.asarray(d["mean"], np.float32).reshape(-1)
    basis = np.asarray(d["basis"], np.float32)
    if basis.shape[0] != mean.shape[0]:
        basis = basis.T
    return TextureBasis(mean=mean, basis=basis[:, :num_coeffs], shape=texture_shape)


def synthetic_texture_basis(size: int = 64, num_coeffs: int = 16,
                            seed: int = 0) -> TextureBasis:
    """Deterministic low-frequency basis for tests."""
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
