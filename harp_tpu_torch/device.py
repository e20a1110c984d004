"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. There is no silent CPU fallback: with no device given and no
    CUDA card present this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "harp_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch versions"
            )
        return torch.device("cuda")
    return torch.device(device)
