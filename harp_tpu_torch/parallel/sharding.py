"""Meshes of processes over torch.distributed (harp_tpu/parallel/sharding.py).

HARP's parameters are KB-MB (shape, texture, normal map, per-frame rows),
so parallelism is over data: the frames of one sequence's minibatch
(fit_sequence(mesh=...)) or whole sequences (fit_sequences_batch). PyTorch
runs one process per device, where JAX runs one process over many; a Mesh
is this process's place among them:

- every rank holds the parameters and the sequence whole (replicated);
- each rank takes its own rows of a minibatch (`frame_rows`), as GSPMD
  places a frame-sharded gather;
- the shared gradient is an explicit all-reduce (`average_gradients`), where
  GSPMD inserts a psum.

NCCL runs on CUDA devices, gloo on the CPU. Gloo also all-reduces and
broadcasts CUDA tensors, but does not send or receive them: `halo` stages
its point-to-point rows through the host on a gloo mesh of CUDA devices.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import warnings

import torch
import torch.distributed as dist

FRAME_AXIS = "frames"
SEQUENCE_AXIS = "sequences"

# Per-frame parameter keys (leading axis = frame) vs shared keys.
PER_FRAME_KEYS = ("trans", "pose", "rot", "wrist_pose", "cam", "light_positions")

# The variables a launcher (torchrun, a cluster's scheduler) sets.
_LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's place in a mesh of processes, one device each.

    axis_names / shape: the mesh's axes and ranks along each (row-major
    over the global ranks). coords: this rank's index along each axis;
    lines: the global ranks of this rank's line along each axis; groups:
    the process group of that line (None: the default group, for a 1-D
    mesh)."""

    world_size: int
    rank: int
    device: torch.device
    backend: str
    axis_names: tuple = (FRAME_AXIS,)
    shape: tuple = ()
    coords: tuple = ()
    lines: dict = dataclasses.field(default_factory=dict)
    groups: dict = dataclasses.field(default_factory=dict)
    owns_group: bool = False

    def __post_init__(self):
        if not self.shape:
            self.shape = (self.world_size,)
            self.coords = (self.rank,)
            self.lines = {self.axis_names[0]: tuple(range(self.world_size))}
            self.groups = {self.axis_names[0]: None}

    def axis_size(self, axis: str = FRAME_AXIS) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str = FRAME_AXIS) -> int:
        return self.coords[self.axis_names.index(axis)]

    def close(self) -> None:
        """End the process group if this mesh started it (make_mesh in a
        process with no group)."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def free_port() -> int:
    """A free TCP port on the loopback interface, for a local rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _default_device(rank: int) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "harp_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _check_backend(backend: str, device: torch.device) -> None:
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL was asked for and this PyTorch has no NCCL backend")
        if device.type != "cuda":
            raise ValueError(f"NCCL needs CUDA devices, not {device}")
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: one of 'nccl', 'gloo'")


def make_mesh(n_devices: int | None = None, devices=None, device=None,
              backend: str | None = None) -> Mesh:
    """A 1-D frame-axis mesh over the ranks of the default process group.

    In a process with no group (no launcher), starts a one-process group on
    a free loopback port; more ranks need launch() or torchrun. devices:
    the device of each rank; device: this rank's (default devices[rank],
    else CUDA device rank % count). backend: NCCL on CUDA, gloo on the CPU
    unless given; gloo may run CUDA devices (two ranks sharing one card),
    NCCL asked for where it is absent raises."""
    owns = not dist.is_initialized()
    world, rank = (1, 0) if owns else (dist.get_world_size(), dist.get_rank())
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices needs {n_devices} processes; this group has "
            f"{world} (start them with harp_tpu_torch.parallel.launch or torchrun)")
    if device is None:
        device = devices[rank] if devices is not None else _default_device(rank)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    _check_backend(backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if owns:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    return Mesh(world_size=world, rank=rank, device=device, backend=backend, owns_group=owns)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None) -> None:
    """Join the processes of a multi-host fit (the default process group).

    A no-op when the group exists. With coordinator_address ("host:port"),
    num_processes and process_id, rendezvous there; else from a launcher's
    environment (torchrun: WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT). A
    process with neither warns and continues on its own. When a launcher's
    variables are set but the rendezvous fails, this raises: going on would
    fit N independent jobs instead of one. backend: NCCL where CUDA is
    available, else gloo, unless given."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
        return
    launcher = [v for v in _LAUNCHER_VARS if os.environ.get(v)]
    if not launcher:
        warnings.warn("no coordinator and no launcher environment "
                      f"({', '.join(_LAUNCHER_VARS)}); continuing single-process",
                      RuntimeWarning)
        return
    try:
        dist.init_process_group(backend, init_method="env://")
    except (ValueError, RuntimeError) as e:
        raise RuntimeError(
            f"torch.distributed initialisation failed with launcher variables {launcher} "
            f"set: {e}") from e


def global_batch_mesh(seq_axis: int | None = None, device=None,
                      backend: str | None = None) -> Mesh:
    """The mesh of the batch-over-sequences fit: axis 0 sequences (across
    hosts), axis 1 frames (within a host), over the default group's ranks
    row-major, with one process group per line of each axis. seq_axis None:
    one sequence group per host (the world over LOCAL_WORLD_SIZE, which
    torchrun sets; 1 without it). A seq_axis that does not divide the world
    falls back to 1, as harp_tpu's does. Every rank must call this (each
    line's group is made collectively)."""
    base = make_mesh(device=device, backend=backend)
    n = base.world_size
    if seq_axis is None:
        seq_axis = max(n // int(os.environ.get("LOCAL_WORLD_SIZE", n)), 1)
    s = seq_axis if n % seq_axis == 0 else 1
    f = n // s
    i, j = divmod(base.rank, f)
    seq_lines = [tuple(ii * f + jj for ii in range(s)) for jj in range(f)]
    frame_lines = [tuple(ii * f + jj for jj in range(f)) for ii in range(s)]
    groups = {}
    for axis, lines, mine in ((SEQUENCE_AXIS, seq_lines, j), (FRAME_AXIS, frame_lines, i)):
        for k, line in enumerate(lines):  # every rank makes every group, in one order
            g = dist.new_group(list(line)) if len(lines) > 1 else None
            if k == mine:
                groups[axis] = g
    return Mesh(world_size=n, rank=base.rank, device=base.device, backend=base.backend,
                axis_names=(SEQUENCE_AXIS, FRAME_AXIS), shape=(s, f), coords=(i, j),
                lines={SEQUENCE_AXIS: seq_lines[j], FRAME_AXIS: frame_lines[i]},
                groups=groups, owns_group=base.owns_group)


# ---------------------------------------------------------------------------
# The frame axis: harp_tpu's frame_sharding / shard_frames / replicate /
# shard_params, as explicit rows and collectives.
# ---------------------------------------------------------------------------


def frame_rows(mesh: Mesh, n: int, axis: str = FRAME_AXIS) -> slice:
    """The rows [r n / w, (r + 1) n / w) of an n-row minibatch that this
    rank owns along `axis`."""
    w, r = mesh.axis_size(axis), mesh.axis_index(axis)
    if n % w:
        raise ValueError(f"a minibatch of {n} rows must be divisible by the mesh's {w} ranks "
                         f"along {axis}")
    return slice(r * n // w, (r + 1) * n // w)


def broadcast_from_rank0(mesh: Mesh, tensors, axis: str = FRAME_AXIS) -> None:
    """Overwrite each tensor with the first rank's of `axis`, in place. A
    tensor that is not contiguous (a parameter made from a broadcast array)
    travels as a contiguous copy: NCCL refuses it as it is."""
    if mesh.axis_size(axis) == 1:
        return
    src, group = mesh.lines[axis][0], mesh.groups[axis]
    with torch.no_grad():
        for t in tensors:
            buf = t.data if t.is_contiguous() else t.data.contiguous()
            dist.broadcast(buf, src, group=group)
            if buf is not t.data:
                t.data.copy_(buf)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor, axis: str = FRAME_AXIS) -> torch.Tensor:
    """t summed over the ranks of `axis`, in place (returned). t must be
    contiguous: the collectives read and write its storage as one run."""
    if not t.is_contiguous():
        raise ValueError("all_reduce_sum sums a contiguous tensor in place")
    if mesh.axis_size(axis) > 1:
        dist.all_reduce(t, group=mesh.groups[axis])
    return t


def average_gradients(mesh: Mesh, params, axis: str = FRAME_AXIS) -> None:
    """Replace each parameter's gradient by its mean over the ranks of
    `axis`: one all-reduce of the gradients flattened into one buffer. With
    every frame term a mean over the rank's local frames and every shared
    term the same on each rank, the mean of the ranks' gradients is the
    gradient of the whole minibatch's loss. A parameter without a gradient
    takes zeros (as the optimizer step does)."""
    w = mesh.axis_size(axis)
    if w == 1:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=mesh.groups[axis])
    flat.div_(w)
    o = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[o:o + n].view_as(p.grad))
        o += n


def all_gather_object(mesh: Mesh, obj) -> list:
    """Every rank's `obj` (picklable; tensors travel through the host), in
    rank order, on every rank."""
    out = [None] * mesh.world_size
    if mesh.world_size == 1:
        out[0] = obj
        return out
    dist.all_gather_object(out, obj)
    return out
