"""Run a function on N local processes, one mesh rank each.

    launch(fn, 2, *args, devices=["cpu", "cpu"])  # fn(mesh, *args) on 2 gloo ranks

Each worker is a fresh interpreter (multiprocessing's spawn): it imports
the module of `fn` (so `fn` must be a module-level function of an
importable module: harp_tpu_torch.parallel.workers holds the package's),
joins a process group on a free loopback port, builds its Mesh and calls
fn(mesh, *args). A worker on the CPU runs torch on one intra-op thread:
fits are bit-equal from run to run on the CPU only so, and N workers share
the host's cores. Rank 0's return value comes back to the caller; a
worker's exception is raised in the caller, and the other workers are then
stopped.
"""

from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import time
import traceback

_GRACE_S = 20.0  # how long the other ranks get to finish after one failed


class WorkerError(RuntimeError):
    """A worker failed; the message holds its traceback."""


def _worker(rank: int, world: int, port: int, backend: str | None, devices: list,
            fn, args: tuple, results) -> None:
    import torch
    import torch.distributed as dist

    from harp_tpu_torch.parallel.sharding import make_mesh

    try:
        dev = torch.device(devices[rank])
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            if dev.index is None:  # "cuda": the process's current device
                dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(dev)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        try:
            out = fn(make_mesh(world, device=dev, backend=backend), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out) if rank == 0 else None))
    except BaseException as e:  # reported to the caller, which raises it
        try:
            exc = pickle.dumps(e)
        except Exception:
            exc = None
        results.put((rank, False, (exc, traceback.format_exc())))


def launch(fn, world_size: int, *args, devices=None, backend: str | None = None,
           timeout: float | None = None):
    """fn(mesh, *args) on world_size spawned processes; rank 0's result.

    devices: each rank's device (default CUDA device r); backend: NCCL on
    CUDA, gloo on the CPU unless given ("gloo" lets ranks share one card).
    The result must pickle; a worker's exception is re-raised here (its own
    type when it pickles, with the worker's traceback as its cause).
    timeout: seconds before the workers are stopped and TimeoutError
    raised."""
    from harp_tpu_torch.parallel.sharding import free_port

    if devices is None:
        import torch

        n = torch.cuda.device_count()
        if n < world_size:
            raise RuntimeError(f"{world_size} ranks on CUDA need {world_size} devices; "
                               f"torch.cuda.device_count() is {n}")
        devices = [f"cuda:{r}" for r in range(world_size)]
    devices = [str(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, world_size, port, backend, devices, fn,
                                                args, results))
             for r in range(world_size)]
    got: dict = {}
    t0 = time.monotonic()
    failed_at = None
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            now = time.monotonic()
            if timeout is not None and now - t0 > timeout:
                raise TimeoutError(f"launch: {world_size} ranks still running after {timeout} s")
            if failed_at is not None and now - failed_at > _GRACE_S:
                break
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                for r, p in enumerate(procs):  # a worker killed before it reported
                    if r not in got and p.exitcode not in (None, 0):
                        got[r] = (False, (None, f"rank {r} exited with code {p.exitcode}"))
                        failed_at = failed_at or time.monotonic()
                continue
            got[rank] = (ok, payload)
            if not ok and failed_at is None:
                failed_at = time.monotonic()
    finally:
        for p in procs:
            if p.is_alive() and (failed_at is not None or len(got) < world_size):
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    # The first failure to arrive: a rank that fails in a collective because
    # another rank failed reports later than that rank.
    errors = [(r, payload) for r, (ok, payload) in got.items() if not ok]
    if errors:
        rank, (exc, tb) = errors[0]
        cause = WorkerError(f"rank {rank} of {world_size} failed:\n{tb}")
        try:
            err = pickle.loads(exc) if exc is not None else None
        except Exception:  # an exception type that does not unpickle
            err = None
        if err is None:
            raise cause
        raise err from cause
    return pickle.loads(got[0][1])
