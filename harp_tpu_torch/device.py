"""Device selection and convolution determinism for the port's entry points."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def deterministic_convolutions(allow_tf32: bool | None = None):
    """cuDNN with deterministic algorithms and no autotuning for the
    enclosed forward AND backward: cuDNN reads these global flags when each
    convolution runs, the backward and a checkpoint's recompute included.
    allow_tf32 None leaves the caller's TF32 setting; eval passes False.
    The previous flags are restored on exit."""
    b = torch.backends.cudnn
    old = (b.deterministic, b.benchmark, b.allow_tf32)
    b.deterministic, b.benchmark = True, False
    if allow_tf32 is not None:
        b.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        b.deterministic, b.benchmark, b.allow_tf32 = old
