"""Frozen plain copy of harp_tpu_torch/device.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

Constant tables on the device and convolution determinism."""

from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch


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


# Arrays at most this large are keyed by value, larger ones by identity.
_BY_VALUE_BYTES = 4096
_CONSTANTS: dict = {}


def constant(a, device, dtype=None) -> torch.Tensor:
    """A constant host array (a model's table, a topology's index list, a
    colour tuple) as a tensor on `device`, copied there once and kept.

    A copy from the host synchronises the stream, and a CUDA graph cannot
    hold one (fit/driver.make_epoch_scan): the step reads its constants
    through here, so that its first call, the graph's warm-up, makes every
    copy. `a`: a numpy array, a sequence or a number; dtype: the numpy or
    torch dtype to cast to (a's own when None). A numpy array larger than 4
    KiB is keyed by identity (a model's own table, or a view of one by the
    array it views; the entry goes with that array), anything smaller by
    value. The result is shared: never write into it."""
    device = torch.device(device)
    if isinstance(dtype, torch.dtype):
        dtype = np.dtype(str(dtype).removeprefix("torch."))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    big = isinstance(a, np.ndarray) and a.nbytes > _BY_VALUE_BYTES
    if big:
        # A view (a model table's first rows) is keyed by the array it views.
        root = a
        while isinstance(root.base, np.ndarray):
            root = root.base
        key = (id(root), a.__array_interface__["data"][0], a.shape, a.strides, device,
               np.dtype(dtype).str if dtype is not None else None)
        hit = _CONSTANTS.get(key)
        if hit is not None and hit[0]() is root:
            return hit[1]
        t = torch.as_tensor(np.asarray(a, dtype), device=device)
        _CONSTANTS[key] = (weakref.ref(root), t)
        weakref.finalize(root, _CONSTANTS.pop, key, None)
        return t
    arr = np.asarray(a, dtype)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(arr.copy(), device=device)
    return t
