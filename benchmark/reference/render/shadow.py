"""Frozen plain copy of harp_tpu_torch/render/shadow.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

Self-shadow with percentage-closer filtering (harp_tpu/render/shadow.py).

1. place the light on a sphere of radius `shadow_light_radius` around the
   hand centre, looking at it;
2. rasterize a depth map from the light (K1, depth-only mode);
3. reproject the camera's hit points into the light view;
4. 3x3 PCF: mean of sigmoid((light_depth - (point_depth - bias)) * sharpness),
   whose gradient w.r.t. the light depth map is K3's scatter.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.device import constant
from benchmark.reference.ops.numerics import safe_norm
from benchmark.reference.render import camera as cam_mod
from benchmark.reference.render.rasterizer import RasterConfig


def light_raster_config(raster_cfg: RasterConfig, scale: float,
                        active_scale: float = 1.5,
                        cap_slack: float = 1.5) -> RasterConfig:
    """Raster config of the light-view depth pass at `scale` resolution:
    the map size rounded to a tile multiple, the cap scaled by 1/scale
    times `cap_slack` (a downscaled map concentrates faces), the active
    fraction widened by `active_scale`."""
    if scale >= 1.0:
        return raster_cfg
    t = raster_cfg.tile
    Hl = max(t, int(round(raster_cfg.image_size * scale / t)) * t)
    s_eff = Hl / raster_cfg.image_size
    cap = -(-int(round(raster_cfg.cap / s_eff * cap_slack)) // 8) * 8
    af = raster_cfg.active_fraction
    if af < 1.0:
        af = min(1.0, af * active_scale)
    return dataclasses.replace(raster_cfg, image_size=Hl, cap=cap,
                               active_fraction=af)


def shadow_cameras(cam, light_positions, hand_center, config):
    """(light_R, light_T, cam_R, cam_T) for the shadow pass; cam (B, 3)
    weak-perspective params, light_positions / hand_center (B, 3) world.

    The light camera is computed in float64 and returned in the inputs'
    dtype: the light sits at shadow_light_radius from the hand centre,
    looking at it, so the gradient of a light position is the small
    difference of large parts through the light's translation and
    rotation, which float32 loses: on the synthetic arm's scene the float32
    gradient moved with the CPU's and CUDA's rounding orders by more than
    the card-vs-CPU tolerance of chip_smoke.py."""
    cam_T = cam_mod.weak_perspective_to_translation(cam, config.focal_length,
                                                    config.img_size)
    B = cam.shape[0]
    cam_R = constant(cam_mod.OPENCV_TO_P3D_R, cam.device).expand(B, 3, 3)
    dtype = light_positions.dtype
    light_positions, hand_center = light_positions.double(), hand_center.double()
    delta = light_positions - hand_center
    light_pos = hand_center + delta * (
        config.shadow_light_radius
        / torch.clamp(safe_norm(delta, dim=1, keepdim=True), min=1e-9))
    light_R = cam_mod.look_at_rotation(light_pos, at=hand_center)
    light_T = cam_mod.translation_for_position(light_R, light_pos)
    return light_R.to(dtype), light_T.to(dtype), cam_R, cam_T


def _tap_stack(depth_light, x, y):
    """Pre-shifted 9-tap stack (B, (Hl+2)^2, 9) + flat row positions (B, N)
    for integer tap centres x, y."""
    B, Hl = depth_light.shape[0], depth_light.shape[1]
    padded2 = torch.nn.functional.pad(depth_light[:, None], (2, 2, 2, 2),
                                      mode="replicate")[:, 0]
    Hp = Hl + 2
    planes = [padded2[:, 1 + di:1 + di + Hp, 1 + dj:1 + dj + Hp]
              for di in (-1, 0, 1) for dj in (-1, 0, 1)]
    stack = torch.stack(planes, dim=-1).reshape(B, Hp * Hp, 9)
    u = torch.clamp(y.reshape(B, -1), -1, Hl) + 1
    v = torch.clamp(x.reshape(B, -1), -1, Hl) + 1
    return stack, (u * Hp + v).long()


class _PcfSumDepth(torch.autograd.Function):
    """sum over the 9 taps of sigmoid((tap - a) * sharp); the backward
    scatters the tap gradients straight into the padded depth-map gradient
    (K3) and folds the padding (harp_tpu shadow._pcf_sum_depth)."""

    @staticmethod
    def forward(ctx, depth_light, xf, yf, af, sharp):
        stack, pos = _tap_stack(depth_light, xf, yf)
        taps = torch.gather(stack, 1, pos[:, :, None].expand(-1, -1, 9))
        ctx.save_for_backward(taps, xf, yf, af)
        ctx.sharp, ctx.hl = sharp, depth_light.shape[1]
        return torch.sigmoid((taps - af[:, :, None]) * sharp).sum(-1)

    @staticmethod
    def backward(ctx, g):
        from benchmark.reference.render.kernels.pcf_grad_kernel import fold_pad2, pcf_scatter

        taps, xf, yf, af = ctx.saved_tensors
        hl = ctx.hl
        s = torch.sigmoid((taps - af[:, :, None]) * ctx.sharp)
        upd = (g[:, :, None] * (s * (1.0 - s) * ctx.sharp)).contiguous()
        da = -upd.sum(-1)
        yc = (torch.clamp(yf, -1, hl) + 2).to(torch.int32).contiguous()
        xc = (torch.clamp(xf, -1, hl) + 2).to(torch.int32).contiguous()
        return fold_pad2(pcf_scatter(yc, xc, upd, hl)), None, None, da, None


def pcf_visibility(depth_light, x, y, a, config):
    """3x3 percentage-closer filtering: depth_light (B, Hl, Hl) (-1 empty);
    x, y (B, ...) integer tap centres in light-map pixels; a (B, ...) biased
    point depths -> mean over taps of sigmoid((tap - a) * sharpness)."""
    B = depth_light.shape[0]
    vis = _PcfSumDepth.apply(depth_light, x.reshape(B, -1), y.reshape(B, -1),
                             a.reshape(B, -1), float(config.shadow_sharpness))
    return (vis / 9.0).reshape(a.shape)


def render_rgb_with_shadow(verts, assets, config, raster_cfg: RasterConfig, cam,
                           light_positions, amb_ratio_logit, texture, normal_map,
                           counters: dict | None = None):
    """Shadowed Phong colour render (B, H, W, 3) of the full image: K1
    depth-only for the light's depth map and for the camera's hard ids,
    then the camera hits reprojected into the light view, 3x3 PCF, and
    shading with ambient sigmoid(amb_ratio_logit), diffuse 1 - ambient and
    no specular. counters: see rasterizer.add_overflow (light pass under
    "light_")."""
    from benchmark.reference.render import shading
    from benchmark.reference.render.pipeline import _shade_pixels
    from benchmark.reference.render.rasterizer import barycentrics_of, get_hard_ids

    hand_center = verts.mean(dim=1)
    light_R, light_T, cam_R, cam_T = shadow_cameras(cam, light_positions,
                                                    hand_center, config)
    faces = assets.render_faces
    H = config.img_size
    rcfg_l = light_raster_config(raster_cfg, config.shadow_map_scale)
    Hl = rcfg_l.image_size
    focal_l = config.focal_length * (Hl / H)
    screen_l = cam_mod.screen_from_world(verts, light_R, light_T, focal_l, Hl)
    ids_l = get_hard_ids(screen_l, faces, rcfg_l, counters, prefix="light_")
    _, z_l, mask_l = barycentrics_of(ids_l, screen_l, faces, rcfg_l)
    depth_light = torch.where(mask_l, z_l, -1.0)  # pytorch3d's zbuf: -1 where empty

    screen_c = cam_mod.screen_from_world(verts, cam_R, cam_T, config.focal_length, H)
    ids_c = get_hard_ids(screen_c, faces, raster_cfg, counters)
    bary_c, _, mask_c = barycentrics_of(ids_c, screen_c, faces, raster_cfg)
    points = shading.interpolate_face_vertex_attrs(verts, faces, ids_c, bary_c)
    B = verts.shape[0]
    view_l = cam_mod.world_to_view(points.reshape(B, -1, 3), light_R, light_T)
    depth_from_light = view_l[..., 2].reshape(B, H, H)
    spts = cam_mod.view_to_screen(view_l, focal_l, Hl)
    x = torch.round(spts[..., 0]).to(torch.int32).reshape(B, H, H)
    y = torch.round(spts[..., 1]).to(torch.int32).reshape(B, H, H)
    vis = pcf_visibility(depth_light, x, y, depth_from_light - config.shadow_bias, config)

    amb = torch.sigmoid(amb_ratio_logit).expand(3)
    return _shade_pixels(verts, ids_c, bary_c, mask_c, assets, cam_R, cam_T, config,
                         texture, normal_map, light_positions, amb, 1.0 - amb,
                         torch.zeros(3, device=verts.device), vis_map=vis)


def shadow_visibility_compact(verts, assets, config, raster_cfg: RasterConfig,
                              cam, light_positions, screen_c, rout, points):
    """PCF visibility (B, A, P) of the camera's compact active tiles.

    The light pass rasterizes compactly (depth only), its depth map is
    scattered to a full (B, Hl, Hl) image (-1 where empty), and the 3x3 taps
    are read for the camera's hit `points` (B, A, P, 3). Returns
    (vis, light_R, light_T, cam_R, cam_T, light_counts) with the light
    pass's bin / active / span overflow counters."""
    from benchmark.reference.render.rasterizer import (
        raster_compact, tile_pixel_coords, barycentrics_of_at, scatter_tiles,
    )

    faces = assets.render_faces
    hand_center = verts.mean(dim=1)
    light_R, light_T, cam_R, cam_T = shadow_cameras(cam, light_positions,
                                                    hand_center, config)
    H = config.img_size
    rcfg_l = light_raster_config(raster_cfg, config.shadow_map_scale)
    Hl = rcfg_l.image_size
    focal_l = config.focal_length * (Hl / H)

    screen_l = cam_mod.screen_from_world(verts, light_R, light_T, focal_l, Hl)
    lout = raster_compact(screen_l, faces, rcfg_l, need_soft=False, need_hard=True)
    lpx, lpy = tile_pixel_coords(lout["act_idx"], rcfg_l)
    _, z_l, mask_l = barycentrics_of_at(lout["hard_ids"], screen_l, faces,
                                        rcfg_l, lpx, lpy)
    depth_c = torch.where(mask_l, z_l, -1.0)
    depth_light = scatter_tiles(depth_c, lout["act_idx"], rcfg_l, -1.0)

    B, A, P = rout["hard_ids"].shape
    view_l = cam_mod.world_to_view(points.reshape(B, -1, 3), light_R, light_T)
    depth_from_light = view_l[..., 2].reshape(B, A, P)
    spts = cam_mod.view_to_screen(view_l, focal_l, Hl)
    x = torch.round(spts[..., 0]).to(torch.int32).reshape(B, A, P)
    y = torch.round(spts[..., 1]).to(torch.int32).reshape(B, A, P)

    vis = pcf_visibility(depth_light, x, y, depth_from_light - config.shadow_bias,
                         config)
    light_counts = {k: lout[k] for k in ("bin_overflow", "active_overflow",
                                         "span_overflow")}
    return vis, light_R, light_T, cam_R, cam_T, light_counts
