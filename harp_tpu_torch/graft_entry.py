"""The port's driver contract: the counterpart of the repository's
__graft_entry__.py.

entry(device=None) -> (forward, example_args): the forward of the flagship
hand avatar at 448^2 and 2 frames (reference density, texture 512^2,
self-shadow): mesh forward, soft silhouette and the shadowed RGB render,
through the hand-written kernels on CUDA (K1 for the camera and the light,
the segment sum); forward(*example_args) -> (alpha (2, 448, 448), rgb (2,
448, 448, 3), joints (2, 21, 3)). Runs on CUDA unless given a device.

dryrun_multichip(n): the full frame-sharded training step over n ranks on
tiny shapes: fit_sequence(mesh=...) of a 3-stage mini-protocol (one
segment of epoch_scan=2, then a stage each), as n gloo ranks on the CPU
started by parallel.launch (harp_tpu's runs on a virtual CPU mesh).

    python -c "from harp_tpu_torch.graft_entry import entry; f, a = entry(); f(*a)"
    python -c "from harp_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(4)"
"""

from __future__ import annotations

import numpy as np
import torch


def _build(img_size: int, texture_size: int, n_frames: int, raster_kw=None,
           density: str = "reference", use_arm: bool = False, device=None):
    """(assets, config, rcfg, params) of the flagship scene, as harp_tpu's
    __graft_entry__._build makes them (the same parameters from
    RandomState(0)); params float32 leaf tensors on `device` (CUDA unless
    given)."""
    from harp_tpu_torch.assets import build_synthetic_arm_assets, build_synthetic_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.convert import params_from_numpy
    from harp_tpu_torch.device import resolve_device
    from harp_tpu_torch.render.rasterizer import RasterConfig

    dev = resolve_device(device)
    build = build_synthetic_arm_assets if use_arm else build_synthetic_assets
    assets = build(uv_size=texture_size, density=density)
    config = HarpConfig(use_arm=use_arm, img_size=img_size,
                        focal_length=2000.0 * img_size / 448.0, texture_size=texture_size,
                        self_shadow=True, w_vgg=0.0, batch_size=n_frames)
    rkw = dict(image_size=img_size)
    if img_size >= 256:  # harp_tpu's budget at reference density
        rkw.update(active_fraction=0.28, cap=448, span_tiles=3)
    rkw.update(raster_kw or {})
    rng = np.random.RandomState(0)
    params = params_from_numpy({
        "pose": 0.15 * rng.randn(n_frames, 45),
        "rot": 0.05 * rng.randn(n_frames, 3),
        "trans": np.zeros((n_frames, 3)),
        "shape": np.zeros(10),
        "wrist_pose": np.zeros((n_frames, 3)),
        "cam": np.tile([6.0, -0.08, -0.01], (n_frames, 1)),
        "verts_disps": np.zeros((assets.num_render_verts, 1)),
        "texture": np.full((texture_size, texture_size, 3), 0.7),
        "normal_map": np.broadcast_to([0.0, 0.0, 1.0], (texture_size, texture_size, 3)),
        "light_positions": np.tile([-0.5, -0.5, -0.5], (n_frames, 1)),
        "amb_ratio": np.asarray(0.4),
    }, dev)
    return assets, config, RasterConfig(**rkw), params


def make_forward(assets, config, rcfg):
    """forward(params, fids) -> (alpha, rgb, joints) of the scene: the mesh
    forward, the soft silhouette and the shadowed RGB render
    (__graft_entry__.entry's forward)."""
    from harp_tpu_torch.render import pipeline
    from harp_tpu_torch.render.shadow import render_rgb_with_shadow

    def forward(params, fids):
        verts, joints = pipeline.mesh_forward(params, fids, assets, config)
        R, T = pipeline.camera_for_frames(params, fids, config)
        alpha = pipeline.render_silhouette(verts, assets, R, T, config, rcfg)
        rgb = render_rgb_with_shadow(verts, assets, config, rcfg, params["cam"][fids],
                                     params["light_positions"][fids], params["amb_ratio"],
                                     params["texture"], params["normal_map"])
        return alpha, rgb, joints

    return forward


def entry(device=None):
    """(forward, (params, fids)) of the flagship hand at 448^2, 2 frames."""
    assets, config, rcfg, params = _build(448, 512, n_frames=2, device=device)
    fids = torch.arange(2, device=params["pose"].device)
    return make_forward(assets, config, rcfg), (params, fids)


def _dryrun_rank(mesh, n_devices: int) -> dict:
    """One rank of dryrun_multichip: harp_tpu's _dryrun_impl scene and fit,
    each rank one frame of each minibatch."""
    import dataclasses

    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.fit.driver import FitData, fit_sequence
    from harp_tpu_torch.fit.params import init_params

    dev = mesh.device
    assets, config, rcfg, _ = _build(
        32, 32, n_devices, density="light", device=dev,
        raster_kw=dict(tile=8, cap=64, bin_chunk=8, tile_chunk=4, face_chunk=32,
                       faces_per_pixel=4))
    config = dataclasses.replace(config, total_epoch=4, training_stage=(2, 1, 1))
    images, masks, masks_er, _, init = make_synthetic_sequence(
        assets, config, rcfg, n_frames=n_devices, seed=0, device=dev)
    params, aux = init_params(init, assets, config, device=dev)
    params, history = fit_sequence(config, assets, FitData(images, masks, masks_er), params,
                                   aux, rcfg=rcfg, mesh=mesh, epoch_scan=2)
    return {"history": history,
            "params": {k: v.detach().cpu().numpy() for k, v in params.items()}}


def dryrun_multichip(n_devices: int) -> dict:
    """The full frame-sharded train step over n gloo ranks on the CPU (one
    frame each), through the user-facing fit_sequence(mesh=...,
    epoch_scan=2). Raises unless every epoch's loss is finite; returns rank
    0's {"history", "params"}."""
    from harp_tpu_torch.parallel.launch import launch

    out = launch(_dryrun_rank, n_devices, n_devices,
                 devices=["cpu"] * n_devices)
    losses = [h["loss"] for h in out["history"]]
    if len(losses) != 4 or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"dryrun_multichip({n_devices}): epoch losses {losses}")
    return out
