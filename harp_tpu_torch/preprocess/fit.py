"""Preprocessing: fit model parameters to METRO's per-frame vertex
predictions and smooth the sequence (harp_tpu/preprocess/fit.py; the
reference's metro_modifications/hand_utils.py:16-131, 540-688, 785-801).
METRO itself stays external; these functions take its vertices.

Each Adam phase is one loop on the device over its iterations, the whole
frame batch at once. Adam is written out as optax's adam is (not
torch.optim.Adam, which rounds in another order), and the early stop is a
`done` flag and a running average kept as device tensors: the loop never
reads a value back to the host. Every function runs on CUDA unless the
caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from harp_tpu_torch.device import resolve_device
from harp_tpu_torch.models.mano import mano_forward

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _adam_scan(loss_fn, params: dict, lr: float, n_iters: int,
               early_stop_rel: float | None = None):
    """n_iters of Adam on loss_fn(params) -> scalar, as optax.adam(lr):
    m = (1 - b1) g + b1 m, v = (1 - b2) g^2 + b2 v, the bias corrections
    1 - b^t, and the update -lr * m_hat / (sqrt(v_hat) + eps). With
    early_stop_rel, an iteration whose loss falls less than early_stop_rel
    below the running average (prev + loss) / 2 sets `done`, and from
    then on parameters and state stay as they were. Returns (params,
    losses): losses[i] is the loss at the parameters before update i."""
    names = list(params)
    p = [params[k].detach().clone() for k in names]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    dev = p[0].device
    count = torch.zeros((), dtype=torch.int32, device=dev)
    b1 = torch.tensor(_B1, device=dev)
    b2 = torch.tensor(_B2, device=dev)
    prev = torch.tensor(1e9, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    losses = []
    for _ in range(n_iters):
        leaves = [x.detach().requires_grad_(True) for x in p]
        loss = loss_fn(dict(zip(names, leaves)))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            loss = loss.detach()
            new_count = count + 1
            bc1 = 1 - b1 ** new_count
            bc2 = 1 - b2 ** new_count
            new_m = [(1 - _B1) * g + _B1 * mi for g, mi in zip(grads, m)]
            new_v = [(1 - _B2) * (g * g) + _B2 * vi for g, vi in zip(grads, v)]
            new_p = [x + (-lr) * ((mi / bc1) / (torch.sqrt(vi / bc2) + _EPS))
                     for x, mi, vi in zip(p, new_m, new_v)]
            if early_stop_rel is not None:
                new_done = done | (prev - loss < early_stop_rel)
                prev = (prev + loss) / 2.0  # the reference's running average
            else:
                new_done = done
            p = [torch.where(new_done, o, n) for n, o in zip(new_p, p)]
            m = [torch.where(new_done, o, n) for n, o in zip(new_m, m)]
            v = [torch.where(new_done, o, n) for n, o in zip(new_v, v)]
            count = torch.where(new_done, count, new_count)
            done = new_done
        losses.append(loss)
    return dict(zip(names, p)), torch.stack(losses)


def _fit_to_vertices(loss_fn, init: dict, epoch_coarse: int, epoch_fine: int,
                     max_tries: int, loss_threshold: float):
    """The reference's retried two-phase fit: (rot, trans) at lr 1e-1,
    then every parameter at lr 1e-2. harp_tpu's tries are one
    deterministic fit repeated (its one_try ignores its key), so every try
    returns the first try's parameters and loss: the port runs the fit
    once and returns that result, whatever max_tries and loss_threshold
    are."""
    del max_tries, loss_threshold  # a retry would repeat the same fit
    coarse = {"rot": init["rot"], "trans": init["trans"]}
    coarse, _ = _adam_scan(lambda cp: loss_fn(dict(init, **cp)), coarse, 1e-1, epoch_coarse)
    params, losses = _adam_scan(loss_fn, dict(init, **coarse), 1e-2, epoch_fine)
    return params, float(losses[-1])


def _target(target_vertices_mm, dev) -> torch.Tensor:
    if isinstance(target_vertices_mm, torch.Tensor):
        return target_vertices_mm.detach().to(device=dev, dtype=torch.float32)
    return torch.tensor(np.asarray(target_vertices_mm), dtype=torch.float32, device=dev)


def mano_fit_objective(model, target_vertices_mm, device=None):
    """(forward, loss, init) of fit_mano_to_vertices: the MANO forward of a
    parameter dict, the mean squared vertex error in mm^2 against the
    targets (B, V, 3), and the starting parameters (zero rotation, pose
    and shape; translation at the targets' mean)."""
    dev = resolve_device(device)
    target = _target(target_vertices_mm, dev)
    B = target.shape[0]

    def fwd(p):
        return mano_forward(model, torch.cat([p["rot"], p["pose"]], 1), p["shape"], p["trans"])

    def mse(p):
        return ((fwd(p)[0] - target) ** 2).mean()

    init = {"rot": torch.zeros((B, 3), device=dev), "pose": torch.zeros((B, 45), device=dev),
            "shape": torch.zeros((B, 10), device=dev), "trans": target.mean(1) / 1000.0}
    return fwd, mse, init


def fit_mano_to_vertices(model, target_vertices_mm, epoch_coarse: int = 500,
                         epoch_fine: int = 700, max_tries: int = 4,
                         loss_threshold: float = 10.0, seed: int = 0, device=None):
    """Fit MANO (rot, pose, shape, trans) to target vertices (B, V, 3) in
    mm (optimize_for_mano_param; mano_fit_objective). Returns the
    per-frame pkl schema (joints, verts, rot, pose, shape, trans as tensors
    on the device) and fit_error, the last fine iteration's loss."""
    del seed  # harp_tpu's tries ignore their keys
    fwd, mse, init = mano_fit_objective(model, target_vertices_mm, device)
    best, err = _fit_to_vertices(mse, init, epoch_coarse, epoch_fine, max_tries,
                                 loss_threshold)
    with torch.no_grad():
        verts, joints = fwd(best)
    return {"joints": joints, "verts": verts, **best, "fit_error": err}


def fit_arm_to_vertices(model, target_vertices_mm, epoch_coarse: int = 500,
                        epoch_fine: int = 700, max_tries: int = 4,
                        loss_threshold: float = 10.0, device=None):
    """Fit the SMPL-X arm (rot, pose, shape, trans) to METRO's 778
    MANO-subset vertices in mm (optimize_for_mano_arm_param): the loss
    compares the arm's MANO-subset vertices, wrist pose zero; translation
    started at the targets' mean, as harp_tpu starts it. Returns the
    per-frame pkl schema (22 joints, the elbow included) and fit_error."""
    from harp_tpu_torch.models.smplx_arm import smplx_arm_forward

    dev = resolve_device(device)
    target = _target(target_vertices_mm, dev)
    B = target.shape[0]
    wrist = torch.zeros((B, 3), device=dev)

    def fwd(p):
        return smplx_arm_forward(model, p["shape"], p["rot"], p["trans"], p["pose"], wrist,
                                 return_type="mano")

    def mse(p):
        return ((fwd(p)[0] - target) ** 2).mean()

    init = {"rot": torch.zeros((B, 3), device=dev), "pose": torch.zeros((B, 45), device=dev),
            "shape": torch.zeros((B, 10), device=dev), "trans": target.mean(1) / 1000.0}
    best, err = _fit_to_vertices(mse, init, epoch_coarse, epoch_fine, max_tries,
                                 loss_threshold)
    with torch.no_grad():
        verts, joints = fwd(best)
    return {"joints": joints, "verts": verts, **best, "fit_error": err}


def fit_nimble_to_vertices(model, target_vertices_mm, epoch_coarse: int = 200,
                           epoch_fine: int = 400, max_tries: int = 1,
                           loss_threshold: float = 10.0, device=None):
    """Fit NIMBLE (rot, PCA pose, shape, trans) to METRO's 778
    MANO-topology vertices in mm (optimize_for_nimble_param): the loss
    compares the MANO surface regressed from NIMBLE's skin; joints are the
    21 MANO-protocol joints of the fitted surface."""
    from harp_tpu_torch.models.nimble import mano_protocol_joints, nimble_forward, nimble_to_mano

    dev = resolve_device(device)
    target = _target(target_vertices_mm, dev)
    B = target.shape[0]

    def mano_verts(p):
        skin, _ = nimble_forward(model, torch.cat([p["rot"], p["pose"]], 1), p["shape"],
                                 p["trans"])
        return nimble_to_mano(model, skin)

    def mse(p):
        return ((mano_verts(p) - target) ** 2).mean()

    init = {"rot": torch.zeros((B, 3), device=dev),
            "pose": torch.zeros((B, model.ncomps), device=dev),
            "shape": torch.zeros((B, model.nshape), device=dev),
            "trans": target.mean(1) / 1000.0}
    best, err = _fit_to_vertices(mse, init, epoch_coarse, epoch_fine, max_tries,
                                 loss_threshold)
    with torch.no_grad():
        mv = mano_verts(best)
        joints = mano_protocol_joints(model, mv)
    return {"joints": joints, "verts": mv, **best, "fit_error": err}


def remove_spike(pose, threshold: float = 1.0) -> torch.Tensor:
    """Replace each interior pose row whose two neighbouring deltas both
    exceed `threshold` by its neighbours' mean
    (hand_utils.remove_spike:785-801)."""
    pose = torch.as_tensor(pose)
    diff = torch.linalg.vector_norm(pose[1:] - pose[:-1], dim=1)  # |p[i+1] - p[i]|
    spike = (diff[:-1] > threshold) & (diff[1:] > threshold)
    mid = torch.where(spike[:, None], (pose[:-2] + pose[2:]) / 2.0, pose[1:-1])
    return torch.cat([pose[:1], mid, pose[-1:]], 0)


def _smooth_poses_penalty(x: torch.Tensor) -> torch.Tensor:
    """sum((x - detached 3-frame mean)^2) / (N - 2) over the interior
    frames (LossSmoothPoses, hand_utils.py:499-513)."""
    interp = ((x[1:-1] + x[:-2] + x[2:]) / 3.0).detach()
    return ((x[1:-1] - interp) ** 2).sum() / (x.shape[0] - 2)


def _on(params: dict, keys, dev) -> dict:
    return {k: torch.as_tensor(np.asarray(params[k].detach().cpu() if isinstance(
        params[k], torch.Tensor) else params[k]), dtype=torch.float32, device=dev)
        for k in keys}


def smooth_pose_sequence(model, params: dict, total_iters: int = 1000, lr: float = 1e-3,
                         w_anchor: float = 1e-2, w_smooth: float = 1e-1,
                         early_stop_rel: float = 1e-5, device=None) -> dict:
    """Temporal smoothing of fitted poses (optimize_smooth_seq, pose
    phase): (rot, pose, shape) against a root-aligned joint anchor and the
    3-frame smoothness penalty. params: per-frame rot (N, 3), pose (N, 45),
    shape (N, 10), trans (N, 3), joints (N, 21, 3). Returns params with
    rot, pose, shape, verts and joints replaced by tensors on the device."""
    dev = resolve_device(device)
    t = _on(params, ("rot", "pose", "shape", "trans", "joints"), dev)
    anchor = t["joints"] - t["joints"][:, 0:1]
    n = anchor.shape[0]
    trans = t["trans"]

    def loss_fn(p):
        _, joints = mano_forward(model, torch.cat([p["rot"], p["pose"]], 1), p["shape"], trans)
        joints = joints - joints[:, 0:1]
        l_anchor = ((joints[:, :21] - anchor[:, :21]) ** 2).sum() / n
        return w_anchor * l_anchor + w_smooth * _smooth_poses_penalty(joints)

    opt, _ = _adam_scan(loss_fn, {k: t[k] for k in ("rot", "pose", "shape")}, lr,
                        total_iters, early_stop_rel)
    out = dict(params)
    out.update(opt)
    with torch.no_grad():
        out["verts"], out["joints"] = mano_forward(
            model, torch.cat([opt["rot"], opt["pose"]], 1), opt["shape"], trans)
    return out


def smooth_camera_sequence(model, params: dict, img_res: int = 224, total_iters: int = 1000,
                           lr: float = 1e-3, w_anchor: float = 1e-2, w_smooth: float = 1e-2,
                           device=None) -> dict:
    """Camera smoothing against the camera-relative root trajectory
    (optimize_smooth_seq, camera phase, hand_utils.py:648-684). Returns
    params with cam replaced by a tensor on the device."""
    dev = resolve_device(device)
    t = _on(params, ("rot", "pose", "shape", "trans", "cam"), dev)
    focal = 1000.0 * img_res / 224.0
    with torch.no_grad():
        _, joints = mano_forward(model, torch.cat([t["rot"], t["pose"]], 1), t["shape"],
                                 t["trans"])
    root = joints[:, 0] / 1000.0

    def cam_rel_root(cam):
        return torch.stack([cam[:, 1], cam[:, 2],
                            2 * focal / (img_res * cam[:, 0] + 1e-9)], 1) + root

    anchor = cam_rel_root(t["cam"])
    n = anchor.shape[0]

    def loss_fn(p):
        crr = cam_rel_root(p["cam"])
        l_anchor = ((crr - anchor) ** 2).sum() / n
        return w_anchor * l_anchor + w_smooth * _smooth_poses_penalty(crr)

    opt, _ = _adam_scan(loss_fn, {"cam": t["cam"]}, lr, total_iters)
    out = dict(params)
    out["cam"] = opt["cam"]
    return out
