"""Resume and known-appearance parameter preparation
(harp_tpu/fit/resume.py; the reference's optimize_sequence.py:355-393).

- prepare_resume_params: a previous run's saved_params.pkl (written by
  either package) with the reference's resume recipe: with
  known_appearance, the per-frame pose, rotation, translation and camera
  come from the new sequence's preprocessing while the fitted appearance
  (texture, normal map, displacements, shape) is kept; then the 30-frame
  pose interpolation, the mean-pooled translation and rotation, and the
  backfills of wrist_pose, amb_ratio and normal_map.
- load_fit_checkpoint: a mid-protocol checkpoint (checkpoint.pt, or the
  latest step of an orbax/ tree of utils/orbax_io.py) for fit_sequence's
  `resume`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from harp_tpu_torch.device import resolve_device
from harp_tpu_torch.utils.io import load_checkpoint, load_result


def interpolate_poses_30(pose) -> torch.Tensor:
    """Linear interpolation between every 30th frame's pose
    (optimize_sequence.py:368-372), in float32 on the host as harp_tpu
    computes it; only n // 30 - 1 blocks are filled (the reference's loop
    bound). Returns a tensor on `pose`'s device (CPU for numpy)."""
    dev = pose.device if isinstance(pose, torch.Tensor) else torch.device("cpu")
    pose = (pose.detach().cpu().numpy() if isinstance(pose, torch.Tensor)
            else np.asarray(pose)).copy()
    n = pose.shape[0]
    for i in range(n // 30 - 1):
        a = pose[i * 30].copy()
        b = pose[i * 30 + 30].copy()
        for j in range(30):
            pose[i * 30 + j] = ((30 - j) * a + j * b) / 30.0
    return torch.from_numpy(pose).to(dev)


def prepare_resume_params(start_from: str, input_params: dict, config,
                          device=None) -> dict:
    """The parameters to fit from: `start_from`'s saved_params.pkl with the
    reference's resume recipe, as float32 leaf tensors with requires_grad
    on `device` (CUDA unless given). input_params: the new sequence's
    preprocessing output (numpy, per frame)."""
    dev = resolve_device(device)
    already = config.pose_already_opt
    params = {k: v.detach() for k, v in load_result(
        start_from, test=config.known_appearance and config.start_from != "" and already,
        device=dev).items()}
    n = np.asarray(input_params["pose"]).shape[0]

    if config.known_appearance and not already:
        # A new sequence: its pose-side parameters from its preprocessing.
        for k in ("trans", "pose", "rot", "cam"):
            params[k] = torch.tensor(np.asarray(input_params[k], np.float32), device=dev)

    params["pose"] = interpolate_poses_30(params["pose"])
    for k in ("trans", "rot"):
        params[k] = params[k].float().mean(0).expand(n, 3)
    if "wrist_pose" not in params:
        params["wrist_pose"] = torch.zeros((n, 3), device=dev)
    if "amb_ratio" not in params:
        params["amb_ratio"] = torch.tensor(0.4, device=dev)
    if "normal_map" not in params:
        ts = config.texture_size
        params["normal_map"] = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(ts, ts, 3)
    return {k: v.float().contiguous().clone().requires_grad_(True) for k, v in params.items()}


def load_fit_checkpoint(path: str, device=None) -> dict:
    """A mid-protocol checkpoint: `path` is a checkpoint.pt, a run
    directory holding one, or a run directory holding an orbax/ tree of
    utils/orbax_io.OrbaxCheckpointer's steps (its latest step is read; it
    wins over a checkpoint.pt beside it, as harp_tpu's does). Returns the
    payload {params, opt_states, epoch, plateau_scale, extra} with the
    parameters on `device` (CUDA unless given): pass payload["params"] to
    fit_sequence as its params and the payload as its `resume`.

    harp_tpu's own Orbax trees (OCDBT) cannot be read without JAX and are
    refused. Carry one across where JAX runs: harp_tpu's
    fit.resume.load_fit_checkpoint reads it, then
    convert.params_from_numpy(payload["params"]) and
    convert.opt_states_from_numpy(payload["opt_states"], ...) give this
    package's params and Adam states for `resume`."""
    from harp_tpu_torch.utils.orbax_io import OrbaxCheckpointer, is_ocdbt_tree

    dev = resolve_device(device)
    norm = os.path.normpath(path)
    run_dir = os.path.dirname(norm) if os.path.basename(norm) == "orbax" else path
    tree = os.path.join(run_dir, "orbax")
    if os.path.isdir(tree):
        if is_ocdbt_tree(tree):
            raise ValueError(
                f"{tree} is harp_tpu's Orbax (OCDBT) checkpoint, which this package cannot "
                "read: load it with harp_tpu.fit.resume.load_fit_checkpoint where JAX runs, "
                "then carry it across with harp_tpu_torch.convert.params_from_numpy and "
                "harp_tpu_torch.convert.opt_states_from_numpy")
        with OrbaxCheckpointer(run_dir) as ckpt:
            return ckpt.restore(device=dev)
    if os.path.isdir(path):
        path = os.path.join(path, "checkpoint.pt")
    return load_checkpoint(path, device=dev)
