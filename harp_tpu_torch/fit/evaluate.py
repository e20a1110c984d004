"""Post-fit evaluation and export (harp_tpu/fit/evaluate.py).

Per render group of frames: the silhouette, the colour render (with the
shadow per config) and the normal render; IoU, L1, the LPIPS-style VGG
proxy and MS-SSIM per frame; GT | pred | normal | overlay composites
quantised to uint8 on the device. Then the composites as PNGs, the texture
maps, the posed frame-0 mesh as an OBJ, the optional Procrustes vertex
error against GT meshes, eval_results[_test].txt, and with `turntables`
frame 0's turntables, their side-by-side combination and its light sweep
(utils/viz.py: render_360, concat_image_dirs, render_360_light).

Every tile is rasterized (harp_tpu's eval runs its full-image raster),
and the eval refuses to report metrics when any raster pass truncated a
tile or a face: the overflow counters, summed over every pass, must all
be 0.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from harp_tpu_torch.device import deterministic_convolutions, resolve_device
from harp_tpu_torch.eval.metrics import (
    align_w_scale, iou_per_frame, l1_per_frame, ms_ssim_per_frame, perceptual_per_frame,
)
from harp_tpu_torch.fit.driver import FitData, appearance_texture, decode_frames
from harp_tpu_torch.losses.perceptual import Vgg16Features
from harp_tpu_torch.render import pipeline
from harp_tpu_torch.render.rasterizer import RasterConfig
from harp_tpu_torch.render.shadow import render_rgb_with_shadow
from harp_tpu_torch.utils import viz
from harp_tpu_torch.utils.io import export_obj


def load_gt_vert(frame_idx: int, gt_mesh_dir: str, start_from_one: bool = True,
                 idx_offset: int = 500) -> np.ndarray:
    """Synthetic-GT vertex loader (eval_util.py:63-70); returns metres."""
    num = idx_offset + frame_idx + (1 if start_from_one else 0)
    return np.loadtxt(os.path.join(gt_mesh_dir, f"{num}_manov.xyz")) / 1000.0


def _render_frame_batch(params, fids, assets, config, rcfg, counters=None, extras=None):
    """(verts, alpha, rgb, normal_img) of frames `fids`; counters: see
    rasterizer.add_overflow; extras: the model family's (HTML's texture
    basis gives the texture)."""
    texture = appearance_texture(params, config, extras)
    verts, _ = pipeline.mesh_forward(params, fids, assets, config)
    R, T = pipeline.camera_for_frames(params, fids, config)
    if config.share_light_position:
        light = params["light_positions"][0].expand(fids.shape[0], 3)
    else:
        light = params["light_positions"][fids]
    alpha = pipeline.render_silhouette(verts, assets, R, T, config, rcfg, counters)
    if config.self_shadow:
        rgb = render_rgb_with_shadow(verts, assets, config, rcfg, params["cam"][fids],
                                     light, params["amb_ratio"], texture,
                                     params["normal_map"], counters)
    else:
        rgb = pipeline.render_rgb(verts, assets, R, T, config, rcfg, texture,
                                  params["normal_map"], light, counters)
    normal_img = pipeline.render_normal(verts, assets, R, T, config, rcfg,
                                        params.get("normal_map"), counters)
    return verts, alpha, rgb, normal_img


def evaluate_sequence(config, assets, data: FitData, params: dict, aux: dict,
                      rcfg: RasterConfig | None = None, out_dir: str | None = None,
                      vgg: Vgg16Features | None = None, render_batch: int = 8,
                      save_images: bool = True, turntables: bool = False,
                      device=None, extras: dict | None = None) -> dict:
    """Metrics of the fitted `params` on `data` -> {"Silhouette IoU", "L1",
    "LPIPS_proxy" (or "LPIPS" with pretrained VGG weights), "MS_SSIM",
    the overflow counters, timings}. The metrics run in float32 with TF32
    off; frames go in groups of the largest divisor of n <= render_batch.
    extras: the model family's statics (HTML's texture basis). With
    turntables, frame 0's RGB and normal turntables (72 views each), their
    combination and the 40-light sweep are written under out_dir, in
    groups of render_batch views, and the result gains eval_turntables_s,
    their overflow counters (turntable_*_overflow, all 0: each group's
    tile capacity grows until nothing is truncated) and turntable_rerenders
    (the renders that grew it). Runs on CUDA unless device is given."""
    dev = resolve_device(device)
    rcfg = dataclasses.replace(rcfg or config.raster_config(), active_fraction=1.0)
    out_dir = out_dir or config.base_output_dir
    test_name = "_test" if config.known_appearance else ""
    img_dir = os.path.join(out_dir, "rendered_after_opt" + test_name)
    if vgg is None:
        vgg = Vgg16Features.create(weights_path=config.vgg_weights or None, device=dev)
    vgg = vgg.with_dtype("float32")
    perc_key = "LPIPS" if vgg.source == "pretrained" else "LPIPS_proxy"

    n = data.num_frames
    g = max(d for d in range(1, min(render_batch, n) + 1) if n % d == 0)
    t0 = time.perf_counter()
    counters: dict = {}
    metrics, comps, verts_all = [], [], []
    with torch.no_grad(), deterministic_convolutions(allow_tf32=False):
        for s in range(0, n, g):
            fids = torch.arange(s, s + g, device=dev)
            verts, alpha, rgb, normal_img = _render_frame_batch(
                params, fids, assets, config, rcfg, counters, extras)
            gt_img = decode_frames(data.images[fids])
            gt_mask = decode_frames(data.masks[fids])
            metrics.append(torch.stack([
                iou_per_frame(gt_mask, alpha), l1_per_frame(gt_img, rgb),
                perceptual_per_frame(vgg, gt_img, rgb), ms_ssim_per_frame(gt_img, rgb)]))
            overlay = torch.stack([gt_mask, torch.zeros_like(gt_mask), alpha], -1)
            comp = torch.cat([gt_img, rgb, normal_img, overlay], 2)
            comps.append((comp.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu())
            verts_all.append(verts.cpu())
        iou, l1, perc, msss = torch.cat(metrics, 1).cpu().numpy().astype(np.float64)
    overflow = {k: int(v) for k, v in counters.items()}
    if any(overflow.values()):
        raise RuntimeError(f"evaluate_sequence: a raster pass truncated the render: "
                           f"{overflow} (summed over every pass of every frame)")
    final = {"Silhouette IoU": float(iou.mean()), "L1": float(l1.mean()),
             perc_key: float(perc.mean()), "MS_SSIM": float(msss.mean()),
             **overflow, "eval_program_s": time.perf_counter() - t0}
    verts_np = torch.cat(verts_all).numpy()

    if config.eval_mesh and config.gt_mesh_dir:
        vert_errs = []
        for f in range(n):
            gt_v = load_gt_vert(f, config.gt_mesh_dir)
            if config.use_arm:  # the arm mesh's MANO vertices
                pred_v = verts_np[f, np.asarray(assets.model.mano_vert_from_arm)]
            else:
                pred_v = verts_np[f, :gt_v.shape[0]]
            aligned = align_w_scale(gt_v, pred_v)
            vert_errs.append(float(np.linalg.norm(gt_v - aligned, axis=1).mean() * 1000.0))
        final["Procrustes-aligned vertex error (mm)"] = float(np.mean(vert_errs))
        os.makedirs(out_dir, exist_ok=True)
        np.savetxt(os.path.join(out_dir, "eval_vert_mm" + test_name + ".txt"), vert_errs)

    walls = {}
    if turntables:
        t1 = time.perf_counter()
        tt: dict = {}
        kw = dict(chunk=render_batch, counters=tt, extras=extras)
        rgb_dir = viz.render_360(params, 0, assets, config, rcfg, out_dir, **kw)
        nrm_dir = viz.render_360(params, 0, assets, config, rcfg, out_dir, render_normal=True,
                                 **kw)
        viz.concat_image_dirs(rgb_dir, nrm_dir, os.path.join(out_dir, "render_360_combine"),
                              device=dev)
        viz.render_360_light(params, 0, assets, config, rcfg, out_dir, **kw)
        walls = {**{"turntable_" + k: v for k, v in tt.items()},
                 "eval_turntables_s": time.perf_counter() - t1}

    if save_images:
        t1 = time.perf_counter()
        comps = torch.cat(comps).numpy()
        viz.save_images_parallel((comps[f], os.path.join(img_dir, "%04d.png" % f))
                                 for f in range(n))
        with torch.no_grad():
            texture = appearance_texture(params, config, extras)
        viz.save_texture_maps(params, aux.get("uv_mask"), out_dir, texture=texture)
        export_obj(os.path.join(out_dir, "uv_out", "final_mesh" + test_name + ".obj"),
                   verts_np[0], assets.render_faces, verts_uvs=assets.verts_uvs,
                   faces_uvs=assets.faces_uvs,
                   texture_png=os.path.join(out_dir, "uv_out", "texture.png"))
        with open(os.path.join(out_dir, "eval_results" + test_name + ".txt"), "w") as f:
            for k, v in final.items():
                f.write(" %s: %.5f\n" % (k, v))
        final["eval_composites_s"] = time.perf_counter() - t1
    final.update(walls)
    return final
