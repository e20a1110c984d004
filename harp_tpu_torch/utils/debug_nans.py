"""--debug-nans (harp_tpu's jax_debug_nans): raise FloatingPointError at the
first operation that yields a NaN.

DebugNans is a TorchDispatchMode: every ATen operation dispatched while it
is active, forward and backward (the autograd engine carries the mode over
to its threads), has its floating outputs checked for NaN; infinities
pass, as JAX's check lets them. The error names the operation
("invalid value (nan) encountered in aten.sqrt.default"). Outputs that
hold no computed values are not checked: those of the uninitialised
allocations (torch.empty and its kin) and of views, which alias a tensor
that was checked when it was made.

The hand-written kernels fill their outputs through ctypes, where no
dispatch sees them: their wrappers call check_kernel on those outputs,
which checks them while a DebugNans mode is active (and does nothing
otherwise), as JAX checks a pallas_call's outputs. Each check reads the
device from the host, so nothing under the mode may be captured in a CUDA
graph: fit_sequence runs its epoch-scan segments eagerly while active()
holds.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten
# Allocations whose contents are whatever memory held: nothing was computed.
_UNINITIALISED = {aten.empty, aten.empty_like, aten.empty_strided, aten.empty_permuted,
                  aten.new_empty, aten.new_empty_strided, aten.resize_, aten.resize_as_}


def active() -> bool:
    """Whether a DebugNans mode is on this thread's dispatch mode stack
    (the autograd engine's threads carry the caller's)."""
    return any(isinstance(m, DebugNans) for m in _get_current_dispatch_mode_stack())


def _check(outputs, what) -> None:
    for t in tree_leaves(outputs):
        if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                and t.numel() and bool(torch.isnan(t).any())):
            raise FloatingPointError(f"invalid value (nan) encountered in {what}")


def check_kernel(outputs, name: str) -> None:
    """A hand-written kernel's outputs, checked for NaN while a DebugNans
    mode is active; FloatingPointError names the kernel."""
    if active():
        _check(outputs, name)


class DebugNans(TorchDispatchMode):
    """Check each operation's floating outputs for NaN (module docstring)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket not in _UNINITIALISED and not func.is_view:
            _check(out, func)
        return out
