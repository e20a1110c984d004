"""The fit step (harp_tpu/fit/driver.py: compute_losses, _grad_step,
make_train_step, stage_flags).

One step: MANO forward, subdivision and displacement; one compact camera
rasterization (K1, soft + hard); silhouette alpha (backward K2); shared
per-pixel geometry; the light's depth-only raster (K1) and 3x3 PCF
(backward K3); Phong shading; the losses; backward; the two Adam groups.
The VGG perceptual term is not ported yet: the step computes the losses
harp_tpu computes with vgg=None.
"""

from __future__ import annotations

import torch

from harp_tpu_torch.device import resolve_device
from harp_tpu_torch.fit.optimizer import build_optimizers
from harp_tpu_torch.losses.basic import arap_loss, kps_anchor_loss, vert_disp_reg
from harp_tpu_torch.losses.texture_reg import albedo_reg, normal_reg
from harp_tpu_torch.ops.mesh import laplacian_smoothing_loss, normal_consistency_loss
from harp_tpu_torch.ops.numerics import jnp_abs
from harp_tpu_torch.render import pipeline
from harp_tpu_torch.render.rasterizer import (
    RasterConfig, gather_tiles, soft_alpha_fast_pack,
)
from harp_tpu_torch.render.shadow import shadow_visibility_compact

OVERFLOW_KEYS = ("bin_overflow", "active_overflow", "span_overflow",
                 "light_bin_overflow", "light_active_overflow",
                 "light_span_overflow")


def compute_losses(params, aux, fids, batch_imgs, batch_masks, batch_masks_er,
                   assets, config, rcfg: RasterConfig, ref_verts,
                   coarse_on: bool, app_on: bool, generator=None,
                   offsets=None):
    """All fitting losses for one minibatch -> (total, breakdown).

    offsets: optional (albedo, normal_reg) (H, W, 2) texture-reg neighbour
    offsets; otherwise they are drawn from `generator`. The breakdown holds
    every loss term and the six raster overflow counters."""
    losses = {}
    verts, joints = pipeline.mesh_forward(params, fids, assets, config)
    R, T = pipeline.camera_for_frames(params, fids, config)
    screen, rout = pipeline.raster_camera_view_compact(
        verts, assets, R, T, config, rcfg, need_soft=coarse_on, need_hard=app_on)
    act_idx = rout["act_idx"]
    n_px = batch_masks.numel()

    if coarse_on:
        alpha_c = soft_alpha_fast_pack(rout["soft_sum"], rout["bins"], screen,
                                       assets.sub_topology.corners, rcfg)
        m_c = gather_tiles(batch_masks, act_idx, rcfg)
        # mean |alpha - m| over the full image; inactive tiles: alpha = 0.
        losses["silhouette"] = (
            jnp_abs(alpha_c - m_c).sum() + batch_masks.sum() - m_c.sum()) / n_px
        if not config.known_appearance:
            losses["kps_anchor"] = kps_anchor_loss(aux["init_joints"][fids], joints,
                                                   use_arm=config.use_arm)
        if config.use_vert_disp and not config.known_appearance:
            losses["vert_disp_reg"] = vert_disp_reg(params["verts_disps"])
            losses["laplacian"] = laplacian_smoothing_loss(verts, assets.sub_topology)
            losses["normal"] = normal_consistency_loss(verts, assets.sub_topology)
            losses["arap"] = arap_loss(verts, ref_verts, assets.sub_topology)

    light_counts = None
    if app_on:
        texture = params["texture"]
        if config.share_light_position:
            light = params["light_positions"][0].expand(fids.shape[0], 3)
        else:
            light = params["light_positions"][fids]
        geom = pipeline.pixel_geometry_compact(verts, screen, rout, assets, rcfg)
        if config.self_shadow:
            vis, _, _, _, _, light_counts = shadow_visibility_compact(
                verts, assets, config, rcfg, params["cam"][fids], light,
                screen, rout, points=geom["points"])
            amb = torch.sigmoid(params["amb_ratio"]).expand(3)
            rgb_c, _ = pipeline.shade_pixels_compact(
                geom, R, T, config, texture, params["normal_map"], light,
                amb, 1.0 - amb, torch.zeros(3, device=verts.device), vis_map=vis)
        else:
            rgb_c, _ = pipeline.shade_pixels_compact(
                geom, R, T, config, texture, params["normal_map"], light,
                config.ambient_color, config.diffuse_color,
                config.specular_color, shininess=config.shininess)
        # Masked photometric L1 with the closed-form background term of the
        # inactive tiles (pred == background there).
        bg = torch.as_tensor(config.background_color, dtype=rgb_c.dtype,
                             device=rgb_c.device)
        gt_c = gather_tiles(batch_imgs, act_idx, rcfg)
        me_c = gather_tiles(batch_masks_er, act_idx, rcfg)[..., None]
        full_bg_term = jnp_abs((bg - batch_imgs) * batch_masks_er[..., None]).sum()
        comp_bg_term = jnp_abs((bg - gt_c) * me_c).sum()
        comp_term = jnp_abs((rgb_c - gt_c) * me_c).sum()
        losses["photo"] = (comp_term + full_bg_term - comp_bg_term) / (n_px * 3)
        off_a, off_n = offsets if offsets is not None else (None, None)
        losses["albedo"] = albedo_reg(params["texture"], generator, std=1.0,
                                      uv_mask=aux["uv_mask"], offsets=off_a)
        losses["normal_reg"] = normal_reg(params["normal_map"], generator,
                                          uv_mask=aux["uv_mask"], offsets=off_n)

    weights = {
        "silhouette": config.w_silhouette, "kps_anchor": config.w_kps_anchor,
        "vert_disp_reg": config.w_vert_disp_reg, "normal": config.w_normal,
        "laplacian": config.w_laplacian, "arap": config.w_arap,
        "photo": config.w_photo, "albedo": config.w_albedo,
        "normal_reg": config.w_normal_reg,
    }
    total = torch.zeros((), device=verts.device)
    for k, v in losses.items():
        total = total + weights[k] * v
    breakdown = {k: v.detach() for k, v in losses.items()}
    for k in ("bin_overflow", "active_overflow", "span_overflow"):
        breakdown[k] = rout[k].sum().float()
    if light_counts is not None:
        for k, v in light_counts.items():
            breakdown["light_" + k] = v.sum().float()
    return total, breakdown


def decode_frames(x: torch.Tensor) -> torch.Tensor:
    """uint8 frame storage -> float32 in [0, 1] at the point of use."""
    if x.dtype == torch.uint8:
        return x.float() * (1.0 / 255.0)
    return x


class TrainStep:
    """One training step: losses, backward, and the two Adam groups (each
    stepped only when its stage flag is on). Parameters are updated in
    place."""

    def __init__(self, assets, config, rcfg: RasterConfig, params: dict,
                 device=None):
        self.device = resolve_device(device)
        for k, v in params.items():
            if v.device.type != self.device.type:
                raise ValueError(f"param {k} is on {v.device}, the step on {self.device}")
        self.assets, self.config, self.rcfg = assets, config, rcfg
        self.params = params
        self.optimizers = build_optimizers(params, config)

    def __call__(self, aux, fids, batch_imgs, batch_masks, batch_masks_er,
                 ref_verts, lr_scale: float = 1.0, *, coarse_on: bool,
                 app_on: bool, generator=None, offsets=None):
        for p in self.params.values():
            p.grad = None
        total, breakdown = compute_losses(
            self.params, aux, fids, decode_frames(batch_imgs),
            decode_frames(batch_masks), decode_frames(batch_masks_er),
            self.assets, self.config, self.rcfg, ref_verts, coarse_on, app_on,
            generator=generator, offsets=offsets)
        total.backward()
        for name, on in (("coarse", coarse_on), ("app", app_on)):
            if not on:
                continue
            opt = self.optimizers[name]
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:  # optax steps zero gradients too
                        p.grad = torch.zeros_like(p)
                if name == "coarse":
                    group["lr"] = self.config.lr_pose * lr_scale
            opt.step()
        return total.detach(), breakdown


def make_train_step(assets, config, rcfg: RasterConfig, params: dict,
                    device=None) -> TrainStep:
    """The train step over `params` on `device` (CUDA unless given)."""
    return TrainStep(assets, config, rcfg, params, device=device)


def stage_flags(epoch: int, config):
    """(coarse_on, app_on) of an epoch: geometry, both, appearance."""
    s0, s1, _ = config.training_stage
    if epoch < s0:
        return True, False
    if epoch < s0 + s1:
        return True, True
    return False, True
