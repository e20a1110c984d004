"""Functions that parallel.launch runs on each rank: fn(mesh, *args).

They live in the package because a spawned worker imports the module of
the function it runs. A scene travels as numpy arrays and the port's
assets / configs (all picklable):

    scene = {"assets", "config", "rcfg", "frames": (images, masks,
             masks_eroded) as numpy, "init": the preprocessing output}

(for the batch fit, "frames" are (S, N, ...) and "inits" one per sequence).
Results come back to the caller as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from harp_tpu_torch.parallel.halo import neighbor_shift
from harp_tpu_torch.parallel.sharding import (
    FRAME_AXIS, Mesh, all_gather_object, all_reduce_sum, average_gradients, frame_rows,
    global_batch_mesh,
)


def run_all(mesh: Mesh, calls: list) -> list:
    """Several worker functions in one process group: [fn(mesh, *args) for
    fn, args in calls] (one spawn for many checks)."""
    return [fn(mesh, *args) for fn, args in calls]


def _counters() -> tuple:
    from harp_tpu_torch.ops import segment as sg
    from harp_tpu_torch.render.kernels import pcf_grad_kernel as pk
    from harp_tpu_torch.render.kernels import raster_kernel as rk

    return rk.LAUNCHES, pk.LAUNCHES, sg.LAUNCHES


def kernel_launches() -> dict:
    """The hand-written kernels' launch counters of this process."""
    out = {}
    for d in _counters():
        out.update(d)
    return out


def reset_kernel_launches() -> None:
    for d in _counters():
        for k in d:
            d[k] = 0


def _numpy(params: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def fit_sequence_on_mesh(mesh: Mesh, scene: dict, runs: int = 1) -> dict:
    """fit_sequence(mesh=mesh) of the scene, `runs` times from its initial
    parameters. Returns {"runs": [{"params", "history"}] (rank 0's; the
    ranks hold the same parameters), "launches": [each rank's kernel
    launches over the runs]}."""
    from harp_tpu_torch.fit.driver import FitData, fit_sequence
    from harp_tpu_torch.fit.params import init_params

    dev = mesh.device
    data = FitData(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in scene["frames"]])
    reset_kernel_launches()
    out = []
    for _ in range(runs):
        params, aux = init_params(scene["init"], scene["assets"], scene["config"], device=dev)
        params, history = fit_sequence(scene["config"], scene["assets"], data, params, aux,
                                       rcfg=scene["rcfg"], mesh=mesh)
        out.append({"params": _numpy(params), "history": history})
    return {"runs": out, "launches": all_gather_object(mesh, kernel_launches())}


def batch_fit_on_mesh(mesh: Mesh, scene: dict, seed: int = 0) -> dict:
    """fit_sequences_batch(mesh=mesh) of the sequences' scene: {"params":
    [per sequence], "history": [per sequence]}."""
    from harp_tpu_torch.fit.batch import BatchFitData, fit_sequences_batch
    from harp_tpu_torch.fit.params import init_params

    dev = mesh.device
    pairs = [init_params(i, scene["assets"], scene["config"], device=dev) for i in scene["inits"]]
    data = BatchFitData(*[torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in scene["frames"]])
    params, history = fit_sequences_batch(scene["config"], scene["assets"], data,
                                          [p for p, _ in pairs], [a for _, a in pairs],
                                          rcfg=scene["rcfg"], seed=seed, mesh=mesh)
    return {"params": [_numpy(p) for p in params], "history": history}


def neighbor_shift_on_mesh(mesh: Mesh, x: np.ndarray) -> tuple:
    """neighbor_shift of x (N, ...) split over the frame axis, each rank
    its rows on its device; the full (left, right) gathered back."""
    local = torch.from_numpy(np.ascontiguousarray(x[frame_rows(mesh, x.shape[0])]))
    left, right = neighbor_shift(mesh, local.to(mesh.device))
    parts = all_gather_object(mesh, (left.cpu().numpy(), right.cpu().numpy()))
    return (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]))


def shared_gradient_on_mesh(mesh: Mesh, shared: np.ndarray, frames: np.ndarray) -> np.ndarray:
    """The gradient of the per-frame mean sum(sin(frames * shared)) / N
    with respect to the shared row, each rank on its frames, averaged over
    the ranks (average_gradients): the single-process gradient."""
    p = torch.tensor(shared, device=mesh.device, requires_grad=True)
    f = torch.from_numpy(np.ascontiguousarray(frames[frame_rows(mesh, frames.shape[0])]))
    f = f.to(mesh.device)
    (torch.sin(f * p).sum() / f.shape[0]).backward()
    average_gradients(mesh, [p])
    return p.grad.cpu().numpy()


def batch_mesh_layout(mesh: Mesh, seq_axis: int) -> list:
    """Every rank's place in global_batch_mesh(seq_axis) (axes, shape,
    coords, lines), with the frame-axis sum of the ranks' numbers
    ("frame_sum": the sum over this rank's frame line)."""
    bm = global_batch_mesh(seq_axis, device=mesh.device, backend=mesh.backend)
    total = all_reduce_sum(bm, torch.tensor([float(bm.rank)]), FRAME_AXIS)
    return all_gather_object(mesh, {"axis_names": bm.axis_names, "shape": bm.shape,
                                    "coords": bm.coords, "lines": bm.lines,
                                    "frame_sum": float(total[0])})
