"""Post-fit evaluation and export (harp_tpu/fit/evaluate.py).

Per render group of frames: the silhouette, the colour render (with the
shadow per config) and the normal render; IoU, L1, the LPIPS-style VGG
proxy and MS-SSIM per frame; GT | pred | normal | overlay composites
quantised to uint8 on the device. That pass over the whole sequence is one
program (make_eval_program, harp_tpu's one jit over frame groups): on CUDA
one CUDA graph, captured at its first call and replayed. Then the
composites as JPEGs (rendered_after_opt/%04d.jpg, as harp_tpu writes
them), the texture maps (PNG), the posed frame-0 mesh as an OBJ,
the optional Procrustes vertex error against GT meshes,
eval_results[_test].txt, and with `turntables` frame 0's turntables, their
side-by-side combination and its light sweep (utils/viz.py: render_360,
concat_image_dirs, render_360_light).

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
from harp_tpu_torch.utils import debug_nans, viz
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


class EvalProgram:
    """The eval pass over every frame group as one program (harp_tpu's
    make_eval_program). Call it as program(params, images, masks,
    vgg_params=None) -> (iou, l1, perc, msss (n,) f32, composites (n, H,
    4W, 3) uint8, verts (n, V, 3), overflow): harp_tpu's six outputs in its
    order, then the raster passes' overflow counters summed over every
    pass of every frame ({name: 0-dim int64}). The outputs are the
    caller's: copies of the program's buffers.

    The program owns static buffers: the parameters, the images and masks,
    the groups' frame ids and the outputs (the counters among them). Each
    call copies the caller's tensors into them, then runs the pass on
    them, so a graph never reads what it was captured on. vgg_params:
    (w HWIO, b) pairs copied into the program's float32 VGG, as harp_tpu
    passes its filter bank; None keeps the filters it was built with.

    With graph (CUDA only), the first call runs one group eagerly on a
    side stream (the warm-up: constant tables copied to the card, cuDNN
    and cuBLAS handles made), then captures the whole pass once, as one
    torch.cuda.CUDAGraph, under deterministic_convolutions(allow_tf32=False)
    (cuDNN picks the eager pass's algorithms: no autotuning), and replays
    it; later calls replay it. capture_s is the capture's wall, captures
    their count. A failed capture raises: there is no eager fall-back.
    The captured cudaGraph_t is kept (self.graph.raw_cuda_graph()), so
    that its kernel nodes can be read. Without graph (the CPU) every call
    runs the same pass eagerly. close() releases the graph, its memory
    pool and the buffers."""

    def __init__(self, config, assets, data: FitData, rcfg: RasterConfig, vgg, g: int,
                 device: torch.device, extras: dict | None, graph: bool):
        self.config, self.assets, self.rcfg, self.extras = config, assets, rcfg, extras
        self.vgg = vgg
        self.n, self.g, self.device, self.use_graph = data.num_frames, g, device, graph
        self.graph = None
        self.capture_s = None
        self.captures = 0
        self._static = None

    def _copy_in(self, params: dict, images, masks, vgg_params) -> None:
        if images.shape[0] != self.n or masks.shape[0] != self.n:
            raise ValueError(f"the program evaluates {self.n} frames, got "
                             f"{images.shape[0]} images and {masks.shape[0]} masks")
        if self._static is None:
            fids = torch.arange(self.n, device=self.device).reshape(-1, self.g)
            self._static = {
                "params": {k: v.detach().to(self.device).clone() for k, v in params.items()},
                "images": images.to(self.device).clone(), "masks": masks.to(self.device).clone(),
                "fids": fids}
        else:
            st = self._static["params"]
            if set(params) != set(st):
                raise ValueError(f"parameters {sorted(params)}, the program's {sorted(st)}")
            for k, v in params.items():
                st[k].copy_(v.detach())
            self._static["images"].copy_(images)
            self._static["masks"].copy_(masks)
        if vgg_params is not None:
            with torch.no_grad():
                for conv, (w, b) in zip(self.vgg.convs, vgg_params, strict=True):
                    conv.weight.copy_(torch.as_tensor(w).permute(3, 2, 0, 1))
                    conv.bias.copy_(torch.as_tensor(b))

    def _run(self, groups) -> None:
        """The pass over `groups` on the static buffers, into the static
        outputs (made by the first group, the warm-up's on CUDA)."""
        st, g = self._static, self.g
        counters: dict = {}
        with torch.no_grad(), deterministic_convolutions(allow_tf32=False):
            for i in groups:
                s = slice(i * g, (i + 1) * g)
                verts, alpha, rgb, normal_img = _render_frame_batch(
                    st["params"], st["fids"][i], self.assets, self.config, self.rcfg,
                    counters, self.extras)
                gt_img = decode_frames(st["images"][s])
                gt_mask = decode_frames(st["masks"][s])
                metrics = torch.stack([
                    iou_per_frame(gt_mask, alpha), l1_per_frame(gt_img, rgb),
                    perceptual_per_frame(self.vgg, gt_img, rgb), ms_ssim_per_frame(gt_img, rgb)])
                overlay = torch.stack([gt_mask, torch.zeros_like(gt_mask), alpha], -1)
                comp = torch.cat([gt_img, rgb, normal_img, overlay], 2)
                comp = (comp.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
                if "metrics" not in st:
                    st["metrics"] = metrics.new_empty((4, self.n))
                    st["comps"] = comp.new_empty((self.n,) + comp.shape[1:])
                    st["verts"] = verts.new_empty((self.n,) + verts.shape[1:])
                    st["keys"] = sorted(counters)
                    st["overflow"] = torch.zeros(len(counters), dtype=torch.int64,
                                                 device=self.device)
                st["metrics"][:, s] = metrics
                st["comps"][s] = comp
                st["verts"][s] = verts
            st["overflow"].copy_(torch.stack([counters[k] for k in st["keys"]]))

    def _capture(self) -> None:
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run(range(1))
        torch.cuda.current_stream(dev).wait_stream(side)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            self._run(range(self.n // self.g))
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        self.captures += 1

    def __call__(self, params: dict, images, masks, vgg_params=None):
        self._copy_in(params, images, masks, vgg_params)
        if not self.use_graph:
            self._run(range(self.n // self.g))
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
        st = self._static
        iou, l1, perc, msss = st["metrics"].clone().unbind(0)
        overflow = dict(zip(st["keys"], st["overflow"].clone().unbind(0)))
        return iou, l1, perc, msss, st["comps"].clone(), st["verts"].clone(), overflow

    def close(self) -> None:
        """Release the graph, its memory pool and the static buffers (the
        next call captures again)."""
        self.graph = self._static = None
        if self.use_graph:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def make_eval_program(config, assets, data: FitData, rcfg: RasterConfig,
                      vgg: Vgg16Features | None = None, render_batch: int = 8, device=None,
                      extras: dict | None = None, *, graph: bool | None = None):
    """The eval pass of `data`'s sequence as one program (EvalProgram) and
    its group size g, the largest divisor of n <= render_batch (harp_tpu's
    make_eval_program). Every tile is rasterized (active_fraction 1, as
    harp_tpu's full-image raster). The metrics run the float32 VGG (vgg,
    or the config's). graph: capture the pass as a CUDA graph (default:
    on CUDA, which it needs, unless utils/debug_nans is active). extras:
    the model family's statics (HTML's texture basis). Runs on CUDA unless
    device is given."""
    dev = resolve_device(device)
    graph = dev.type == "cuda" and not debug_nans.active() if graph is None else graph
    if graph and dev.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
    if vgg is None:
        vgg = Vgg16Features.create(weights_path=config.vgg_weights or None, device=dev)
    n = data.num_frames
    g = max(d for d in range(1, min(render_batch, n) + 1) if n % d == 0)
    rcfg = dataclasses.replace(rcfg, active_fraction=1.0)
    return EvalProgram(config, assets, data, rcfg, vgg.with_dtype("float32"), g, dev, extras,
                       graph), g


def evaluate_sequence(config, assets, data: FitData, params: dict, aux: dict,
                      rcfg: RasterConfig | None = None, out_dir: str | None = None,
                      vgg: Vgg16Features | None = None, eval_batch: int = 64,
                      render_batch: int = 8, save_images: bool = True,
                      turntables: bool = False, eval_program: EvalProgram | None = None,
                      device=None, extras: dict | None = None) -> dict:
    """Metrics of the fitted `params` on `data` -> {"Silhouette IoU", "L1",
    "LPIPS_proxy" (or "LPIPS" with pretrained VGG weights), "MS_SSIM",
    the overflow counters, timings}, through eval_program (make_eval_program
    of this sequence: it may be built before the fit, as the CLI does) or
    one built here and released after. eval_program_s is its call's wall
    with the metric vectors on the host; eval_capture_s the graph's capture
    when the call captured it. The metrics run in float32 with TF32 off;
    frames go in groups of the largest divisor of n <= render_batch.
    eval_batch: harp_tpu's, unused (the metrics follow the render groups).
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
    own = eval_program is None
    if own:
        eval_program, _ = make_eval_program(config, assets, data, rcfg, vgg, render_batch,
                                            device=dev, extras=extras)
    elif eval_program.device != dev:
        raise ValueError(f"the eval program runs on {eval_program.device}, not {dev}")
    perc_key = "LPIPS" if eval_program.vgg.source == "pretrained" else "LPIPS_proxy"

    n = data.num_frames
    captures = eval_program.captures
    t0 = time.perf_counter()
    iou, l1, perc, msss, comps, verts, counters = eval_program(params, data.images, data.masks)
    # One host transfer for the metric vectors and the counters.
    host = torch.cat([torch.stack([iou, l1, perc, msss]).double().reshape(-1),
                      torch.stack(list(counters.values())).double()]).cpu().numpy()
    timing = {"eval_program_s": time.perf_counter() - t0}
    if eval_program.captures > captures:
        timing["eval_capture_s"] = eval_program.capture_s
    if own:
        eval_program.close()
    iou, l1, perc, msss = host[:4 * n].reshape(4, n)
    overflow = {k: int(v) for k, v in zip(counters, host[4 * n:])}
    if any(overflow.values()):
        raise RuntimeError(f"evaluate_sequence: a raster pass truncated the render: "
                           f"{overflow} (summed over every pass of every frame)")
    final = {"Silhouette IoU": float(iou.mean()), "L1": float(l1.mean()),
             perc_key: float(perc.mean()), "MS_SSIM": float(msss.mean()),
             **overflow, **timing}
    want_mesh = config.eval_mesh and config.gt_mesh_dir
    verts_np = verts.cpu().numpy() if want_mesh or save_images else None

    if want_mesh:
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
        viz.concat_image_dirs(rgb_dir, nrm_dir, os.path.join(out_dir, "render_360_combine"))
        viz.render_360_light(params, 0, assets, config, rcfg, out_dir, **kw)
        walls = {**{"turntable_" + k: v for k, v in tt.items()},
                 "eval_turntables_s": time.perf_counter() - t1}

    if save_images:
        t1 = time.perf_counter()
        comps = comps.cpu().numpy()  # (n, H, 4W, 3) uint8, one transfer
        viz.save_images_parallel((comps[f], os.path.join(img_dir, "%04d.jpg" % f))
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
