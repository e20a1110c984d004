"""Row gathers whose backward is a fixed-order segment sum, and that segment
sum (csrc/segment_sum.cu).

harp_tpu writes these as jnp gathers and `.at[].add` and leaves the rest to
XLA. On the card, PyTorch's own backward of a gather is either float
atomics (torch.gather, index_add_), whose order and so whose last bits
change from run to run, or a sort-based index_put_ that walks each run of
equal indices one entry after another: the background pixels of a frame
put ~10^5 entries on one clamped texel. segment_sum sums each row in an
order fixed by the input and cuts long runs into fixed chunks, so the step's
gradient is the same bits from run to run.

- SegmentOrder: the entries' row keys and, at first use on the card, their
  stable sort (shared by gathers with the same indices).
- segment_sum(values, order): the kernel's wrapper; out[r] = sum of
  values[j] over key[j] == r.
- gather_rows(table, order): table[key], whose backward is segment_sum.
- gather_table(x, table): x[:, index] for a constant, possibly repeating
  index table, through gather_rows with the table's sort.
- sum_rows(values, order): segment_sum, whose backward is a gather.
- TableOrder: a constant index table (a face table's corners) and its
  stable sort, made once per table (MeshTopology.corners); batched() lays
  the frames on top of it without sorting again.

On a CPU tensor segment_sum runs its plain version (index_add_, which sums
in entry order); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from harp_tpu_torch.csrc import build
from harp_tpu_torch.utils.debug_nans import check_kernel

# Host launches of each kernel, counted by its wrapper: a replayed CUDA graph
# (the epoch scan's step, the eval program) launches its kernels without the
# wrapper, so replays are not in these counts.
LAUNCHES = {"segment_sum": 0}


def _lib():
    lib = build.load("segment_sum")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.segment_sum.argtypes = [P, P, P, I, I, I, P, P, P, P]
        lib.segment_sum.restype = I
        lib.segment_sum_chunk.argtypes = []
        lib.segment_sum_chunk.restype = I
        lib.segment_sum_blocks_per_sm.argtypes = [P]
        lib.segment_sum_blocks_per_sm.restype = I
        lib._typed = True
    return lib


def blocks_per_sm() -> dict:
    """Resident blocks per SM of the chunk kernel at the widths the step
    uses, C = 3, 9 and 24 (the CUDA occupancy calculator; needs the card)."""
    out = (ctypes.c_int * 3)()
    build.check(_lib().segment_sum_blocks_per_sm(ctypes.addressof(out)),
                "segment_sum_blocks_per_sm")
    return {3: out[0], 9: out[1], 24: out[2]}


class SegmentOrder:
    """Entries' row keys (M,) in [0, num_rows) and, computed at first use,
    their stable sort: (skey, perm) int32, the keys ascending and the entry
    each sorted position came from."""

    def __init__(self, key: torch.Tensor, num_rows: int, sorted_=None):
        if num_rows >= 2**31:
            raise ValueError(f"segment keys must fit int32, got {num_rows} rows")
        self.key = key.reshape(-1).long()
        self.num_rows = int(num_rows)
        self._sorted = sorted_

    def sorted(self):
        if self._sorted is None:
            skey, perm = torch.sort(self.key.to(torch.int32), stable=True)
            self._sorted = (skey, perm.to(torch.int32))
        return self._sorted


@dataclasses.dataclass(frozen=True, eq=False)
class TableOrder:
    """A constant index table's entries `key` (M,) in [0, num_rows) and their
    stable sort (skey, perm), made once in numpy; the device copies are kept
    per device on the instance."""

    key: np.ndarray
    skey: np.ndarray
    perm: np.ndarray
    num_rows: int
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def of(cls, index, num_rows: int) -> "TableOrder":
        key = np.asarray(index, dtype=np.int64).reshape(-1)
        perm = np.argsort(key, kind="stable")
        return cls(key, key[perm], perm, int(num_rows))

    def batched(self, batch: int, device) -> SegmentOrder:
        """Order of the entries (b, i), b < batch, with key
        b * num_rows + key[i]: the table's sort with the batch laid on top."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(torch.as_tensor(a, device=device)
                                     for a in (self.key, self.skey, self.perm))
        key, skey, perm = self._on[device]
        R, m = self.num_rows, key.numel()
        b = torch.arange(batch, device=device)[:, None]
        return SegmentOrder((b * R + key).reshape(-1), batch * R,
                            ((b * R + skey).reshape(-1).to(torch.int32),
                             (b * m + perm).reshape(-1).to(torch.int32)))


def segment_sum(values: torch.Tensor, order: SegmentOrder) -> torch.Tensor:
    """(M, C) values -> (num_rows, C): row r is the sum of values[j] over the
    entries with key[j] == r, 0 where there is none. On the card: float32,
    contiguous, keys in range (not checked there: that would synchronise)."""
    M = order.key.numel()
    if values.dim() != 2 or values.shape[0] != M or not values.is_floating_point():
        raise ValueError(f"values must be ({M}, C) floating, got "
                         f"{tuple(values.shape)} {values.dtype}")
    if values.device != order.key.device:
        raise ValueError(f"values on {values.device}, keys on {order.key.device}")
    if values.device.type == "cpu":
        return segment_sum_plain(values, order)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if values.dtype != torch.float32 or not values.is_contiguous():
        raise ValueError("segment_sum on the card takes contiguous float32 values")
    C, R = values.shape[1], order.num_rows
    dev = values.device
    if M == 0 or C == 0:  # nothing to launch for
        return torch.zeros(R, C, dtype=torch.float32, device=dev)
    if R * C >= 2**31:
        raise ValueError(f"segment_sum on the card writes fewer than 2^31 values, got {R} x {C}")
    skey, perm = order.sorted()
    lib = _lib()
    nchunks = math.ceil(M / lib.segment_sum_chunk())
    out = torch.empty(R, C, dtype=torch.float32, device=dev)  # the kernel writes every row
    head = torch.empty(nchunks, C, dtype=torch.float32, device=dev)
    tail = torch.empty(nchunks, C, dtype=torch.float32, device=dev)
    rc = lib.segment_sum(skey.data_ptr(), perm.data_ptr(), values.data_ptr(), M, C, R,
                         out.data_ptr(), head.data_ptr(), tail.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "segment_sum")
    LAUNCHES["segment_sum"] += 1
    check_kernel(out, "segment_sum")
    return out


def segment_sum_plain(values: torch.Tensor, order: SegmentOrder) -> torch.Tensor:
    """segment_sum's plain PyTorch version: index_add_ in entry order."""
    out = torch.zeros(order.num_rows, values.shape[1], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, order.key, values)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, order):
        ctx.order = order
        return table.index_select(0, order.key)

    @staticmethod
    def backward(ctx, g):
        return segment_sum(g.contiguous(), ctx.order), None


def gather_rows(table: torch.Tensor, order: SegmentOrder) -> torch.Tensor:
    """Rows of table (R, C) at the order's keys -> (M, C), in entry order.
    The backward is segment_sum over the same order."""
    if table.dim() != 2 or table.shape[0] != order.num_rows:
        raise ValueError(f"table must be ({order.num_rows}, C), got {tuple(table.shape)}")
    return _GatherRows.apply(table, order)


class _SumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, order):
        ctx.order = order
        return segment_sum(values.contiguous(), order)

    @staticmethod
    def backward(ctx, g):
        return g.index_select(0, ctx.order.key), None


def sum_rows(values: torch.Tensor, order: SegmentOrder) -> torch.Tensor:
    """segment_sum(values, order), differentiable: the backward gathers
    each entry's row of the upstream gradient."""
    return _SumRows.apply(values, order)


def gather_table(x: torch.Tensor, table: TableOrder) -> torch.Tensor:
    """x (B, R, C) at a constant index table's rows -> (B, M, C), x[:,
    table.key]; the backward sums repeated rows in the table's fixed order."""
    B, R, C = x.shape
    if R != table.num_rows:
        raise ValueError(f"x has {R} rows, the table indexes {table.num_rows}")
    rows = gather_rows(x.reshape(B * R, C), table.batched(B, x.device))
    return rows.reshape(B, -1, C)
