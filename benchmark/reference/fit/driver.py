"""Frozen plain copy of harp_tpu_torch/fit/driver.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

The train step (fit/driver.py: the key stream, texture_reg_offsets,
compute_losses, TrainStep, stage_flags) on plain torch.optim.Adam groups.

One step: the model's forward (MANO or the SMPL-X arm), subdivision and
displacement; one compact camera rasterization (K1, soft + hard);
silhouette alpha (backward K2); shared per-pixel geometry; the light's
depth-only raster (K1) and 3x3 PCF (backward K3); Phong shading; the
silhouette, keypoint, geometry, photometric, VGG perceptual and texture
losses; backward; the two Adam groups. The staged fit around it is
reference/follow.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.device import constant, deterministic_convolutions
from benchmark.reference.fit.optimizer import build_optimizers
from benchmark.reference.losses.basic import arap_loss, kps_anchor_loss, vert_disp_reg
from benchmark.reference.losses.perceptual import (
    Vgg16Features, vgg_feature_l1, vgg_feature_l1_cached,
)
from benchmark.reference.losses.texture_reg import albedo_reg, normal_reg
from benchmark.reference.ops.mesh import laplacian_smoothing_loss, normal_consistency_loss
from benchmark.reference.ops.numerics import jnp_abs
from benchmark.reference.render import pipeline
from benchmark.reference.render.rasterizer import (
    RasterConfig, gather_tiles, scatter_tiles, soft_alpha_fast_pack,
)
from benchmark.reference.render.shadow import shadow_visibility_compact

OVERFLOW_KEYS = ("bin_overflow", "active_overflow", "span_overflow",
                 "light_bin_overflow", "light_active_overflow",
                 "light_span_overflow")


@dataclasses.dataclass
class FitData:
    """Device-resident sequence data: images (N, H, W, 3), masks and
    eroded masks (N, H, W), float32 in [0, 1] or uint8 (decoded per
    minibatch)."""

    images: torch.Tensor
    masks: torch.Tensor
    masks_eroded: torch.Tensor

    @property
    def num_frames(self) -> int:
        return self.images.shape[0]


# ---------------------------------------------------------------------------
# harp_tpu's PRNG stream: threefry-2x32, numpy on the host for the per-step
# keys, int64 tensor code on the device for the texture-reg normal draws.
# ---------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_INJECT = ((1, 2), (2, 0), (0, 1), (1, 2), (2, 0))
_M32 = 0xFFFFFFFF


def _threefry2x32_np(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple:
    """Threefry-2x32 (20 rounds) in numpy, lane for lane
    jax._src.prng.threefry2x32: the rotation schedule [13,15,26,6] /
    [17,29,16,24] over five 4-round groups, with the (k_a, k_b + i) key
    injection after each group."""
    u32 = np.uint32
    ks = (u32(key[0]), u32(key[1]), u32(key[0]) ^ u32(key[1]) ^ u32(0x1BD11BDA))
    x0 = (x0.astype(u32) + ks[0]).astype(u32)
    x1 = (x1.astype(u32) + ks[1]).astype(u32)
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = (x0 + x1).astype(u32)
                x1 = ((x1 << u32(r)) | (x1 >> u32(32 - r))).astype(u32) ^ x0
            a, b = _INJECT[i]
            x0 = (x0 + ks[a]).astype(u32)
            x1 = (x1 + ks[b] + u32(i + 1)).astype(u32)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed): (0, seed) as two uint32. A 64-bit seed
    would need x64 PRNGKeys; refused."""
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f"seed {seed!r} must be in [0, 2**32)")
    return np.array([0, seed], np.uint32)


def split_key(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num) (threefry_partitionable), (num, 2)
    uint32: row i is lane i of threefry2x32(key, hi=0, lo=arange(num))."""
    y0, y1 = _threefry2x32_np(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)


def _key_stream_np(seed: int, count: int) -> np.ndarray:
    """The subkeys of the `key, sub = jax.random.split(key)` chain from
    jax.random.PRNGKey(seed), (count, 2) uint32: the per-step keys of
    harp_tpu's fit."""
    key = prng_key(seed)
    subs = np.empty((count, 2), np.uint32)
    for i in range(count):
        key, subs[i] = split_key(key)
    return subs


def _threefry2x32_torch(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """_threefry2x32_np on int64 tensors masked to 32 bits. k0, k1: keys
    broadcastable against the counters x0 (hi words) and x1 (lo words)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        a, b = _INJECT[i]
        x0 = (x0 + ks[a]) & _M32
        x1 = (x1 + ks[b] + (i + 1)) & _M32
    return x0, x1


def texture_reg_offsets(sub, H: int, W: int, device):
    """The (albedo, normal_reg) (H, W, 2) int64 neighbour offsets that
    harp_tpu's compute_losses draws from a step's subkey `sub` (two uint32:
    numpy, or an int64 tensor on the device, as the epoch scan holds its
    keys): k1, k2 = jax.random.split(sub); trunc(std * jax.random.normal(k,
    (H, W, 2))) at std 1 (k1) and 2 (k2). The split and both draws run on
    the device, with no copy from the host once `sub` is there: split =
    lanes 0 and 1 of threefry2x32(sub, hi=0, lo=iota); bits = b1 ^ b2 of
    threefry2x32(k, hi=0, lo=iota); u in [nextafter(-1, 0), 1) from the
    bits' top 23 as jax.random.uniform makes it; z = sqrt(2) erfinv(u),
    erfinv taken in float64 (XLA's float32 polynomial rounds differently:
    an offset can differ where std * z lies within ~1e-6 of an integer)."""
    if isinstance(sub, torch.Tensor):
        sub = sub.to(device=device, dtype=torch.int64)
    else:
        sub = torch.tensor([int(v) for v in np.asarray(sub, np.uint32)], dtype=torch.int64,
                           device=device)
    lane = torch.arange(2, dtype=torch.int64, device=device)
    y0, y1 = _threefry2x32_torch(sub[0], sub[1], torch.zeros_like(lane), lane)
    lo = torch.arange(H * W * 2, dtype=torch.int64, device=device)[None]
    b1, b2 = _threefry2x32_torch(y0[:, None], y1[:, None], torch.zeros_like(lo), lo)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo_f = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = torch.clamp(floats * 2.0 + lo_f, min=lo_f)  # (hi - lo) is 2.0 in float32
    z = (float(np.float32(np.sqrt(2.0))) * torch.special.erfinv(u.double())).float()
    std = torch.arange(1, 3, dtype=torch.float32, device=device)[:, None]  # 1, 2
    d = torch.trunc(std * z).long().reshape(2, H, W, 2)
    return d[0], d[1]


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def appearance_texture(params: dict, config, extras: dict | None = None) -> torch.Tensor:
    """The UV texture the renders take: HTML's basis texture at the
    fitted coefficients, else the free texel grid params["texture"]."""
    if config.model_type == "html" and extras and "texture_basis" in extras:
        return extras["texture_basis"].texture(params["html_texture"])
    return params["texture"]


def compute_losses(params, aux, fids, batch_imgs, batch_masks, batch_masks_er,
                   assets, config, rcfg: RasterConfig, ref_verts,
                   coarse_on: bool, app_on: bool, generator=None,
                   offsets=None, vgg: Vgg16Features | None = None, key=None,
                   extras: dict | None = None):
    """All fitting losses for one minibatch -> (total, breakdown).

    extras: the model family's statics ({"texture_basis": TextureBasis}
    for HTML). NIMBLE has no keypoint anchor; NIMBLE and HTML have no
    albedo or normal-map regulariser (and draw no offsets for them).

    Texture-reg neighbour offsets: `offsets` (albedo, normal_reg) (H, W, 2)
    when given; else drawn from `key`, the step's harp_tpu subkey (two
    uint32), as harp_tpu draws them; else from `generator`. vgg: the
    perceptual network, or None for no VGG term; aux["vgg_gt"] holds the
    cached GT pyramids when the fit made them. The breakdown holds every
    loss term and the raster overflow counters."""
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
        if not config.known_appearance and config.model_type != "nimble":
            losses["kps_anchor"] = kps_anchor_loss(aux["init_joints"][fids], joints,
                                                   use_arm=config.use_arm)
        if config.use_vert_disp and not config.known_appearance:
            losses["vert_disp_reg"] = vert_disp_reg(params["verts_disps"])
            losses["laplacian"] = laplacian_smoothing_loss(verts, assets.sub_topology)
            losses["normal"] = normal_consistency_loss(verts, assets.sub_topology)
            losses["arap"] = arap_loss(verts, ref_verts, assets.sub_topology)

    light_counts = None
    if app_on:
        texture = appearance_texture(params, config, extras)
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
        bg = constant(config.background_color, rgb_c.device, rgb_c.dtype)
        gt_c = gather_tiles(batch_imgs, act_idx, rcfg)
        me_c = gather_tiles(batch_masks_er, act_idx, rcfg)[..., None]
        full_bg_term = jnp_abs((bg - batch_imgs) * batch_masks_er[..., None]).sum()
        comp_bg_term = jnp_abs((bg - gt_c) * me_c).sum()
        comp_term = jnp_abs((rgb_c - gt_c) * me_c).sum()
        losses["photo"] = (comp_term + full_bg_term - comp_bg_term) / (n_px * 3)
        if vgg is not None:
            rgb = scatter_tiles(rgb_c, act_idx, rcfg, bg)
            m = batch_masks_er[..., None]
            if "vgg_gt" in aux:
                losses["vgg"] = vgg_feature_l1_cached(
                    vgg, rgb * m, aux["vgg_gt"], fids, chunk=config.vgg_chunk,
                    remat=config.vgg_remat)
            else:
                losses["vgg"] = vgg_feature_l1(vgg, rgb * m, batch_imgs * m,
                                               chunk=config.vgg_chunk,
                                               remat=config.vgg_remat)
        if config.model_type not in ("nimble", "html"):
            if offsets is None and key is not None:
                offsets = texture_reg_offsets(key, texture.shape[0], texture.shape[1],
                                              texture.device)
            off_a, off_n = offsets if offsets is not None else (None, None)
            losses["albedo"] = albedo_reg(params["texture"], generator, std=1.0,
                                          uv_mask=aux["uv_mask"], offsets=off_a)
            losses["normal_reg"] = normal_reg(params["normal_map"], generator,
                                              uv_mask=aux["uv_mask"], offsets=off_n)

    weights = {
        "silhouette": config.w_silhouette, "kps_anchor": config.w_kps_anchor,
        "vert_disp_reg": config.w_vert_disp_reg, "normal": config.w_normal,
        "laplacian": config.w_laplacian, "arap": config.w_arap,
        "photo": config.w_photo, "vgg": config.w_vgg, "albedo": config.w_albedo,
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
    place. cuDNN runs deterministic algorithms, without autotuning, over
    the forward and the backward. lr_scale, the plateau's scale, is a
    float multiplied on the host."""

    def __init__(self, assets, config, rcfg: RasterConfig, params: dict,
                 device=None, vgg: Vgg16Features | None = None,
                 extras: dict | None = None):
        self.device = torch.device(device)
        for k, v in params.items():
            if v.device.type != self.device.type:
                raise ValueError(f"param {k} is on {v.device}, the step on {self.device}")
        self.assets, self.config, self.rcfg, self.vgg = assets, config, rcfg, vgg
        self.extras = extras
        self.params = params
        self.optimizers = build_optimizers(params, config)

    def __call__(self, aux, fids, batch_imgs, batch_masks, batch_masks_er,
                 ref_verts, lr_scale=1.0, *, coarse_on: bool,
                 app_on: bool, generator=None, offsets=None, key=None):
        for p in self.params.values():
            p.grad = None
        with deterministic_convolutions():
            total, breakdown = compute_losses(
                self.params, aux, fids, decode_frames(batch_imgs),
                decode_frames(batch_masks), decode_frames(batch_masks_er),
                self.assets, self.config, self.rcfg, ref_verts, coarse_on, app_on,
                generator=generator, offsets=offsets, vgg=self.vgg, key=key,
                extras=self.extras)
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
                    self._set_coarse_lr(group, lr_scale)
            opt.step()
        return total.detach(), breakdown


    def _set_coarse_lr(self, group: dict, lr_scale) -> None:
        lr = group["lr"]
        if not isinstance(lr, torch.Tensor):  # a plain Adam: the CPU
            group["lr"] = self.config.lr_pose * float(lr_scale)
        elif isinstance(lr_scale, torch.Tensor):
            torch.mul(lr_scale, self.config.lr_pose, out=lr)
        else:
            lr.fill_(self.config.lr_pose * lr_scale)




def stage_flags(epoch: int, config):
    """(coarse_on, app_on) of an epoch: geometry, both, appearance."""
    s0, s1, _ = config.training_stage
    if epoch < s0:
        return True, False
    if epoch < s0 + s1:
        return True, True
    return False, True


