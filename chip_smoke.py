"""GPU smoke test of harp_tpu_torch. Phases, in order: build the CUDA
kernels (ptxas registers per kernel); read the card; hold each kernel
against its plain PyTorch version on the flagship scene at the step's 18
frames (and the fixed-order ones against themselves: two launches must give
the same bits; K3 also bit for bit against its fixed-point mirror), and
time each there, with the raster kernels' work (the
pairs their warp cull kept, by their own ballots, which must equal the
cull's plain mirror; face counts per tile; resident blocks); hold the whole
step on the card against the step on the CPU (2 frames); check K3's fixed
point on the flagship step's own tap updates (pcf_rounding); drive the fit
step (18 frames, 448^2, reference-density hand, self-shadow) through the
kernels without VGG and then with it (bf16, cached GT pyramids), each with
launch counts, step times, memory and one profiled step, after checking
that two train steps from one state give the same gradients and
parameters bit for bit; time segment_sum at every call site of one
stage-2 step; time the VGG step in float32 with TF32 off and on; run
fit_sequence (stages 2 / 2 / 2) twice from one seed, which must give the
same bits, and evaluate_sequence on it. Then the SMPL-X arm at reference
density (4078 render vertices, 8128 faces): the kernels at its shapes
(arm_kernel, each; arm_kernels, all with the arm step's launches), its
card-vs-CPU step, its 18-frame 448^2 step without VGG
(arm_step) and with it (arm_vgg_step), one HTML and one NIMBLE step
(zoo_step), and the arm fit through the CLI (arm_fit). Then the real-data
path: model files and a 36-frame train / 9-frame val sequence written in
the reference's layout (JPEG through nvJPEG's encoder), decoded by
nvJPEG on the card and held to harp_tpu's JPEG bounds, with the decode ms
per frame at 36 and 300 frames (real_data_decode); the CLI's real-data fit
twice (bit-equal), its eval and val keys, its logs, and a known-appearance
fit after it (real_data); preprocessing on the card: the MANO fit to the
36 GT meshes, both smoothers, and the card against the CPU (preprocess).
Between the fit phase and the arm, several sequences and ranks: the batch
fit of 4 sequences of 18 frames (batch_fit: each sequence's update in a
batch step the same bits as a lone step, two batch fits the same bits, S
times one step's launches);
fit_sequence on a one-rank NCCL mesh, the same bits as without a mesh, and
on two gloo ranks sharing the card, against the card's unsharded fit
(mesh_fit); a fit killed after its orbax checkpoint and resumed, the same
bits as the unbroken fit, with the checkpointer's retention (orbax_resume).

    python3 chip_smoke.py

Needs one CUDA card, nvcc with nvJPEG and the repository checkout; builds
the kernels and the frame decoder into harp_tpu_torch/_build/ on first use. Each phase prints one JSON line;
any failed check raises, so the exit code is non-zero. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32
# (non-tensor-core) operations/s.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# FP32 operations of the raster kernels. bound_ms_binned counts them as the
# first csrc/raster.cu did its work, every thread walking every binned face,
# so that kernel designs are read against one number: per binned (pixel,
# face) pair, edge functions, barycentrics and depth (32), and in soft mode
# the three clipped edge distances and their minimum (62).
OPS_HARD = 32
OPS_SOFT = 32 + 62
# bound_ms counts what the redesigned csrc/raster.cu does on this run's data:
OPS_BOX = 4     # per (warp, binned face): its padded box against the warp's rectangle
OPS_COVER = 27  # per kept (pixel, face) pair: three edge functions (21), three sign tests (6)
OPS_DIST = 49   # per kept pair, K1 soft and K2: three clipped edge distances (45),
                # their minimum (2), the sign and the blur test (2)
OPS_DEPTH = 9   # per inside pair, K1: three divisions, the depth (5) and its test
OPS_LOGSUM = 10  # per hit, K1 soft: the coverage log-sum's term
OPS_GRAD = 81   # per hit, K2: the log-sum's derivative (25), one edge's gradient (56)
# Inside pairs and hits are counted from the outputs, one inside pair per
# covered pixel and one hit per soft id: lower bounds, as a pixel may lie
# inside or within blur of more faces.

B_STEP = 18  # frames of the step, and of the kernel checks and timings
IMG, TEX = 448, 512  # image and texture sizes of the flagship fit
# The arm's raster budget (the port's CLI takes it for --use-arm).
# harp_tpu's CLI defaults (active 0.28, span 3) truncate the arm's 18-frame
# synthetic sequence: its forearm takes up to 329 of 784 tiles a frame, and
# faces span 4 tiles (phase arm_budget reads the counters on the card).
ARM_BUDGET = dict(active_fraction=0.5, span_tiles=4, cap=448)
# HTML's and NIMBLE's synthetic meshes are the light hand, not subdivided
# (262 vertices, 500 faces): at 448^2 a face spans up to 8 tiles.
ZOO_BUDGET = dict(active_fraction=0.5, span_tiles=8, cap=448)
# The plain raster versions walk face slots 64 at a time at 18 frames: their
# (B, A, slots, P) temporaries then fit the card.
PLAIN_FACE_CHUNK = 64


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def flagship(n_frames: int, device, arm: bool = False):
    """Assets, config, raster config and parameters of the flagship fit
    (448^2, texture 512, reference density, self-shadow, no VGG; the
    parameters of harp_tpu's __graft_entry__._build), of the MANO hand or,
    with `arm`, of the SMPL-X arm (harp_tpu's value_arm_b18)."""
    import torch
    from harp_tpu_torch.assets import build_synthetic_arm_assets, build_synthetic_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.convert import params_from_numpy
    from harp_tpu_torch.render.rasterizer import RasterConfig

    build = build_synthetic_arm_assets if arm else build_synthetic_assets
    assets = build(uv_size=TEX, density="reference")
    config = HarpConfig(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
                        use_arm=arm, self_shadow=True, w_vgg=0.0, batch_size=n_frames)
    # harp_tpu's bench budget (active_fraction 0.28, span_tiles 3) truncates
    # this scene: the synthetic sequence's hand (seed 0) occupies up to 275
    # of 784 tiles and has faces wider than 3 tiles, in both packages. The
    # budget is widened until every overflow counter is zero.
    rcfg = (RasterConfig(image_size=IMG, **ARM_BUDGET) if arm else
            RasterConfig(image_size=IMG, active_fraction=0.375, cap=448, span_tiles=4))
    rng = np.random.RandomState(0)
    params = params_from_numpy({
        "pose": 0.15 * rng.randn(n_frames, 45),
        "rot": 0.05 * rng.randn(n_frames, 3),
        "trans": np.zeros((n_frames, 3)),
        "shape": np.zeros(10),
        "wrist_pose": np.zeros((n_frames, 3)),
        "cam": np.tile([6.0, -0.08, -0.01], (n_frames, 1)),
        "verts_disps": np.zeros((assets.num_render_verts, 1)),
        "texture": np.full((TEX, TEX, 3), 0.7),
        "normal_map": np.broadcast_to([0.0, 0.0, 1.0], (TEX, TEX, 3)),
        "light_positions": np.tile([-0.5, -0.5, -0.5], (n_frames, 1)),
        "amb_ratio": np.asarray(0.4),
    }, device)
    return assets, config, rcfg, params


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    """nvcc for the three kernel sources and the nvJPEG frame decoder, all
    at once; each build line (compiler and flags) and each kernel's
    registers."""
    from harp_tpu_torch.csrc import build

    out = build.build_all()
    # Each kernel's (mangled) name, then its registers and spills.
    ptxas = [ln.strip() for log in out["logs"].values() for ln in log.splitlines()
             if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": out["seconds"], "ptxas": ptxas,
          "commands": {name: build.command(name) for name in build.SOURCES}})


def phase_device() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi})
    return smi


def kernel_inputs(dev, n_frames: int, arm: bool = False):
    """Every kernel's inputs on the flagship scene (of the hand, or of the
    arm), taken from the main path's own functions: camera and light bins,
    the coverage upstream gradient, the PCF tap updates and the texture
    gather's rows (keys into the 512^2 corner stack) with an upstream
    gradient of its 24 channels."""
    import torch
    from harp_tpu_torch.ops.segment import SegmentOrder
    from harp_tpu_torch.render import pipeline
    from harp_tpu_torch.render import camera as cam_mod
    from harp_tpu_torch.render.shading import texel_corner_rows
    from harp_tpu_torch.render.rasterizer import (
        barycentrics_of_at, raster_compact, scatter_tiles, tile_pixel_coords,
    )
    from harp_tpu_torch.render.shadow import (
        _tap_stack, light_raster_config, shadow_cameras,
    )

    assets, config, rcfg, params = flagship(n_frames, dev, arm)
    fids = torch.arange(n_frames, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        verts, _ = pipeline.mesh_forward(params, fids, assets, config)
        R, T = pipeline.camera_for_frames(params, fids, config)
        screen, rout = pipeline.raster_camera_view_compact(verts, assets, R, T, config, rcfg)
        cam_bins = rout["bins"]
        g_alpha = torch.randn(rout["soft_sum"].shape, generator=gen, device=dev)
        g_ssum = (-torch.exp(rout["soft_sum"]) * g_alpha).contiguous()

        light = params["light_positions"][fids]
        light_R, light_T, _, _ = shadow_cameras(params["cam"][fids], light,
                                                verts.mean(1), config)
        rcfg_l = light_raster_config(rcfg, config.shadow_map_scale)
        Hl = rcfg_l.image_size
        focal_l = config.focal_length * Hl / config.img_size
        screen_l = cam_mod.screen_from_world(verts, light_R, light_T, focal_l, Hl)
        lout = raster_compact(screen_l, assets.render_faces, rcfg_l, need_soft=False)
        lpx, lpy = tile_pixel_coords(lout["act_idx"], rcfg_l)
        _, z_l, m_l = barycentrics_of_at(lout["hard_ids"], screen_l, assets.render_faces,
                                         rcfg_l, lpx, lpy)
        depth = scatter_tiles(torch.where(m_l, z_l, -1.0), lout["act_idx"], rcfg_l, -1.0)
        geom = pipeline.pixel_geometry_compact(verts, screen, rout, assets, rcfg)
        view_l = cam_mod.world_to_view(geom["points"].reshape(n_frames, -1, 3),
                                       light_R, light_T)
        spts = cam_mod.view_to_screen(view_l, focal_l, Hl)
        x = torch.round(spts[..., 0]).to(torch.int32)
        y = torch.round(spts[..., 1]).to(torch.int32)
        a = view_l[..., 2] - config.shadow_bias
        stack, pos = _tap_stack(depth, x, y)
        taps = torch.gather(stack, 1, pos[:, :, None].expand(-1, -1, 9))
        s = torch.sigmoid((taps - a[:, :, None]) * config.shadow_sharpness)
        g_vis = torch.randn(a.shape, generator=gen, device=dev)
        upd = (g_vis[:, :, None] * s * (1 - s) * config.shadow_sharpness).contiguous()
        yc = (torch.clamp(y, -1, Hl) + 2).contiguous()
        xc = (torch.clamp(x, -1, Hl) + 2).contiguous()
        ts = config.texture_size
        row = texel_corner_rows(geom["uv"], ts, ts)[2]
        tex_order = SegmentOrder(row, ts * ts)
        tex_order.sorted()
        tex_g = torch.randn(row.numel(), 24, generator=gen, device=dev)
    return dict(assets=assets, rcfg=rcfg, rcfg_l=rcfg_l, cam_bins=cam_bins,
                light_bins=lout["bins"], g_ssum=g_ssum, yc=yc, xc=xc, upd=upd,
                hl=Hl, n_verts=verts.shape[1], tex_order=tex_order, tex_g=tex_g)


def pcf_scatter_library(yc, xc, upd, hl: int):
    """K3's function as ONE PyTorch call (scatter_add_ over all nine taps):
    the yardstick for library_ms; the port never calls it."""
    import torch

    B, N = yc.shape
    hp4 = hl + 4
    d = torch.arange(-1, 2, device=yc.device)
    idx = ((yc.long()[:, :, None, None] + d[:, None]) * hp4
           + (xc.long()[:, :, None, None] + d[None, :])).reshape(B, N * 9)
    dpad = torch.zeros(B, hp4 * hp4, dtype=torch.float32, device=yc.device)
    return dpad.scatter_add_(1, idx, upd.reshape(B, N * 9)).reshape(B, hp4, hp4)


def segment_sum_library(values, order):
    """segment_sum's function as ONE PyTorch call (index_put_ with
    accumulate, the backward PyTorch gives an advanced-indexing gather):
    the yardstick for library_ms; the port never calls it."""
    import torch

    out = torch.zeros(order.num_rows, values.shape[1], device=values.device)
    return out.index_put_((order.key,), values, accumulate=True)


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_FP32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def raster_work(name: str, args, cfg, blocks_per_sm: int) -> dict:
    """What raster kernel `name` walks on these inputs: the (pixel, face)
    pairs its warps kept, from the kernel's own cull ballots (which must
    equal the plain mirror's, warp_cull_keep), the (warp, face) box tests,
    each tile's face count, and the blocks resident per SM."""
    import torch
    from harp_tpu_torch.render.kernels import raster_kernel as rk

    keep = rk.kernel_cull_keep(*args, cfg, name)
    mirror = rk.warp_cull_keep(*args, cfg)
    if not torch.equal(keep, mirror):
        fail(f"{name}: the kernel kept {int(keep.sum())} (slot, warp) pairs, "
             f"the mirror of its cull {int(mirror.sum())}, "
             f"{int((keep != mirror).sum())} differ")
    count = args[3]
    return dict(pairs_kept=float(keep.sum()) * 32,
                box_tests=float(count.sum()) * (cfg.tile ** 2 // 32),
                count_max=int(count.max()), count_mean=float(count.float().mean()),
                blocks_per_sm=blocks_per_sm)


def phase_kernels(dev, arm: bool = False):
    """Each kernel on the card at the main path's shapes (the flagship scene
    at the step's 18 frames; with `arm`, the arm's) against its plain
    version on the same inputs, the fixed-order ones launched twice (the
    same bits), then timed: ms, plain_ms and library_ms from CUDA events,
    the bound from these inputs. Returns the per-kernel records."""
    import dataclasses

    import torch
    from harp_tpu_torch.ops import segment as sg
    from harp_tpu_torch.render.kernels import pcf_grad_kernel as pk
    from harp_tpu_torch.render.kernels import raster_kernel as rk

    inp = kernel_inputs(dev, B_STEP, arm)
    records = []
    occupancy = rk.blocks_per_sm(inp["rcfg"].tile)

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))

    def plain_cfg(cfg):
        return dataclasses.replace(cfg, face_chunk=PLAIN_FACE_CHUNK)

    hits = 0.0
    for name, key, cfg_key, soft in (("raster_ids_soft", "cam_bins", "rcfg", True),
                                     ("raster_ids_depth", "light_bins", "rcfg_l", False)):
        bins, cfg = inp[key], inp[cfg_key]
        args = (bins["fv9"], bins["s_face"], bins["start_a"], bins["count_a"], bins["act_idx"])
        hard, sid, ssum = rk.raster_ids(*args, cfg, soft)
        hard_p, sid_p, ssum_p = rk.raster_ids_plain(*args, plain_cfg(cfg), soft)
        torch.cuda.synchronize()
        if not torch.equal(hard, hard_p):
            fail(f"{name}: {int((hard != hard_p).sum())} hard ids differ from the plain version")
        err = 0.0
        if soft:
            if not torch.equal(sid, sid_p):
                fail(f"{name}: {int((sid != sid_p).sum())} soft ids differ")
            if not torch.allclose(ssum, ssum_p, rtol=1e-5, atol=1e-6):
                fail(f"{name}: soft_sum beyond rtol 1e-5: max {float((ssum - ssum_p).abs().max())}")
            err = float((ssum - ssum_p).abs().max())
        del hard_p, sid_p, ssum_p
        ms = cuda_ms(lambda: rk.raster_ids(*args, cfg, soft), 20)
        plain_ms = cuda_ms(lambda: rk.raster_ids_plain(*args, plain_cfg(cfg), soft), 2)
        pairs = float(bins["count_a"].sum()) * cfg.tile * cfg.tile
        outs = [hard] + ([sid, ssum] if soft else [])
        work = raster_work(name, args, cfg, occupancy[name])
        covered = float((hard >= 0).sum())
        if soft:
            hits = float((sid >= 0).sum())
        ops = (work["box_tests"] * OPS_BOX
               + work["pairs_kept"] * (OPS_COVER + (OPS_DIST if soft else 0))
               + covered * OPS_DEPTH + (hits * OPS_LOGSUM if soft else 0.0))
        b_ms, b_by = bound_ms(nbytes(*args, *outs), ops)
        bb_ms, bb_by = bound_ms(nbytes(*args, *outs), pairs * (OPS_SOFT if soft else OPS_HARD))
        records.append(dict(name=name, route="cuda", source="harp_tpu_torch/csrc/raster.cu",
                            replaces="harp_tpu/render/pallas/raster_kernel.py:65",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None, bound_ms_binned=bb_ms,
                            bound_by_binned=bb_by, pairs=pairs, covered_pixels=covered,
                            soft_ids=hits if soft else None, **work))

    cb, cfg = inp["cam_bins"], inp["rcfg"]
    corners = inp["assets"].sub_topology.corners
    args = (cb["fv9"], cb["s_face"], cb["start_a"], cb["count_a"], cb["act_idx"], inp["g_ssum"])
    dv = rk.coverage_grad_verts(cb, inp["g_ssum"], corners, cfg)
    dv2 = rk.coverage_grad_verts(cb, inp["g_ssum"], corners, cfg)
    dv_plain = rk.slot_grads_to_verts(cb, rk.coverage_grad_plain(*args, plain_cfg(cfg)),
                                      corners)
    torch.cuda.synchronize()
    r = rel(dv, dv_plain)
    if not r < 1e-4:
        fail(f"coverage_grad: dverts rel err {r} vs the plain version")
    spread_k2 = float((dv - dv2).abs().max())
    if spread_k2 != 0.0:
        fail(f"coverage_grad: two launches differ by {spread_k2}")
    ms = cuda_ms(lambda: rk.coverage_grad(*args, cfg), 20)
    plain_ms = cuda_ms(lambda: rk.coverage_grad_plain(*args, plain_cfg(cfg)), 2)
    pairs = float(cb["count_a"].sum()) * cfg.tile ** 2
    work = raster_work("coverage_grad", args[:5], cfg, occupancy["coverage_grad"])
    # The kernel writes the tiles' occupied slots; the binned bound counted
    # the whole (B, A, cap, 9) buffer.
    out_bytes = float(cb["count_a"].sum()) * 9 * 4
    ops = (work["box_tests"] * OPS_BOX + work["pairs_kept"] * (OPS_COVER + OPS_DIST)
           + hits * OPS_GRAD)
    b_ms, b_by = bound_ms(nbytes(*args) + out_bytes, ops)
    bb_ms, bb_by = bound_ms(nbytes(*args) + cb["act_idx"].numel() * cfg.cap * 9 * 4,
                            pairs * OPS_SOFT)
    records.append(dict(name="coverage_grad", route="cuda", source="harp_tpu_torch/csrc/raster.cu",
                        replaces="harp_tpu/render/pallas/raster_kernel.py:364",
                        max_abs_err=float((dv - dv_plain).abs().max()), ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        bound_ms_binned=bb_ms, bound_by_binned=bb_by, rel_err=r,
                        run_to_run_max_abs=spread_k2, pairs=pairs, soft_ids=hits, **work))

    # K3 sums in fixed point: bit for bit its int64 mirror, within rtol 1e-5
    # the float32 plain version.
    pargs = (inp["yc"], inp["xc"], inp["upd"], inp["hl"])
    d1 = pk.pcf_scatter(*pargs)
    d2 = pk.pcf_scatter(*pargs)
    dp = pk.pcf_scatter_plain(*pargs)
    dfix = pk.pcf_scatter_fixed_plain(*pargs)
    torch.cuda.synchronize()
    if not torch.equal(d1.view(torch.int32), dfix.view(torch.int32)):
        fail(f"pcf_scatter: {int((d1 != dfix).sum())} texels differ from the fixed-point "
             f"mirror, by up to {float((d1 - dfix).abs().max())}")
    r = rel(d1, dp)
    if not r < 1e-5:
        fail(f"pcf_scatter: dpad rel err {r} vs the plain version")
    spread_k3 = float((d1 - d2).abs().max())
    if not torch.equal(d1, d2):
        fail(f"pcf_scatter: two launches differ by {spread_k3}")
    if not rel(pcf_scatter_library(*pargs), dp) < 1e-5:
        fail("pcf_scatter_library disagrees with the plain version")
    ms = cuda_ms(lambda: pk.pcf_scatter(*pargs), 20)
    plain_ms = cuda_ms(lambda: pk.pcf_scatter_plain(*pargs), 20)
    lib_ms = cuda_ms(lambda: pcf_scatter_library(*pargs), 20)
    upd = inp["upd"]
    b_ms, b_by = bound_ms(nbytes(*pargs[:3], d1), 9.0 * upd.shape[0] * upd.shape[1])
    records.append(dict(name="pcf_scatter", route="cuda", source="harp_tpu_torch/csrc/pcf_scatter.cu",
                        replaces="harp_tpu/render/pallas/pcf_grad_kernel.py:49",
                        max_abs_err=float((d1 - dp).abs().max()), ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, rel_err=r,
                        mirror_bit_equal=True, run_to_run_max_abs=spread_k3,
                        nonzero_taps=int((upd != 0).sum()),
                        longest_centre_run=int(torch.unique(
                            (torch.arange(upd.shape[0], device=dev)[:, None] * (inp["hl"] + 4)
                             + inp["yc"]) * (inp["hl"] + 4) + inp["xc"],
                            return_counts=True)[1].max()),
                        **pk.launch_layout(upd.shape[0], upd.shape[1], inp["hl"])))

    # The plain segment sum is held in float64 on the same inputs: in float32
    # its atomics add the 239k-entry background run in a varying order, with
    # an error of their own near the 1e-5 tolerance (rel 2e-6 to 5e-6 at 2
    # frames, where that run is 9x shorter).
    order, vals = inp["tex_order"], inp["tex_g"]
    s1 = sg.segment_sum(vals, order)
    s2 = sg.segment_sum(vals, order)
    sp = sg.segment_sum_plain(vals, order)
    sp64 = sg.segment_sum_plain(vals.double(), order)
    torch.cuda.synchronize()
    r = rel(s1.double(), sp64)
    if not r < 1e-5:
        fail(f"segment_sum: rel err {r} vs the plain version in float64")
    spread_ss = float((s1 - s2).abs().max())
    if not torch.equal(s1, s2):
        fail(f"segment_sum: two launches differ by {spread_ss}")
    if not rel(segment_sum_library(vals, order).double(), sp64) < 1e-5:
        fail("segment_sum_library disagrees with the plain version")
    ms = cuda_ms(lambda: sg.segment_sum(vals, order), 20)
    plain_ms = cuda_ms(lambda: sg.segment_sum_plain(vals, order), 20)
    lib_ms = cuda_ms(lambda: segment_sum_library(vals, order), 3)
    sort_ms = cuda_ms(lambda: sg.SegmentOrder(order.key, order.num_rows).sorted(), 20)
    M, C = vals.shape
    b_ms, b_by = bound_ms(M * (C + 2) * 4 + order.num_rows * C * 4, float(M * C))
    counts = torch.bincount(order.key, minlength=order.num_rows)
    records.append(dict(name="segment_sum", route="cuda", source="harp_tpu_torch/csrc/segment_sum.cu",
                        replaces="none (XLA's gather transpose in harp_tpu/render/shading.py:64)",
                        max_abs_err=float((s1.double() - sp64).abs().max()), ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                        rel_err=r, max_abs_err_vs_f32_plain=float((s1 - sp).abs().max()),
                        run_to_run_max_abs=spread_ss, sort_ms=sort_ms, entries=M,
                        channels=C, rows=order.num_rows, longest_run=int(counts.max()),
                        blocks_per_sm=sg.blocks_per_sm()))
    for rec in records:
        emit(dict(phase="arm_kernel" if arm else "kernel", **rec))
    return records


def phase_vs_cpu(dev, arm: bool = False):
    """The whole step's losses and gradients on the card (kernels) vs on
    the CPU (plain versions), 2 frames of the synthetic sequence at 448^2:
    loss terms to rtol 1e-4, each gradient leaf within 3e-3 of its largest
    entry, overflow counters equal. The ids are equal on both sides; the
    float32 sums run in other orders in PyTorch's CPU and CUDA kernels, and
    the shadow's sharpness-1000 sigmoid amplifies that noise in the
    appearance gradients (measured up to 8e-4 on normal_map). With `arm`,
    the arm's step."""
    import dataclasses

    import torch
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.fit.driver import compute_losses
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.render import pipeline

    assets, config, rcfg, _ = flagship(2, dev, arm)
    rcfg = dataclasses.replace(rcfg, face_chunk=64)  # bounds the plain pass's memory
    images, masks, masks_er, _, init = make_synthetic_sequence(
        assets, config, rcfg, n_frames=2, seed=0, device=dev)
    rng = np.random.RandomState(2)
    ts = config.texture_size
    offsets = [torch.from_numpy(np.trunc(s * rng.randn(ts, ts, 2)).astype(np.int64))
               for s in (1.0, 2.0)]
    out = {}
    for d in (dev, torch.device("cpu")):
        params, aux = init_params(init, assets, config, device=d)
        fids = torch.arange(2, device=d)
        with torch.no_grad():
            ref = pipeline.mesh_forward(params, fids[:1], assets, config)[0][0]
        t0 = time.perf_counter()
        total, br = compute_losses(params, aux, fids, images.to(d), masks.to(d),
                                   masks_er.to(d), assets, config, rcfg, ref, True, True,
                                   offsets=[o.to(d) for o in offsets])
        total.backward()
        out[d.type] = ({k: float(v) for k, v in br.items()},
                       {k: p.grad.cpu() for k, p in params.items() if p.grad is not None},
                       time.perf_counter() - t0)
    (bg, gg, tg), (bc, gc, tc) = out["cuda"], out["cpu"]
    rel = {k: float((gg[k] - gc[k]).abs().max()) / max(float(gc[k].abs().max()), 1e-12)
           for k in gc}
    emit({"phase": "arm_step_vs_cpu" if arm else "step_vs_cpu", "frames": 2, "loss_terms": bg,
          "grad_rel_err": rel, "card_s": tg, "cpu_s": tc})
    for k in bc:
        if not np.isclose(bg[k], bc[k], rtol=1e-4, atol=1e-7):
            fail(f"step vs CPU: loss term {k}: {bg[k]} on the card, {bc[k]} on the CPU")
    for k in gc:
        if rel[k] > 3e-3:
            fail(f"step vs CPU: gradient {k} rel err {rel[k]}")


def flagship_sequence(dev, arm: bool = False) -> dict:
    """The flagship fit's 18-frame synthetic sequence (of the hand, or of
    the arm), rendered by the port (K1) and checked: finite images, masks
    covering part of each frame."""
    import torch
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence

    assets, config, rcfg, _ = flagship(B_STEP, dev, arm)
    t0 = time.perf_counter()
    images, masks, masks_er, gt, init = make_synthetic_sequence(
        assets, config, rcfg, n_frames=B_STEP, seed=0, device=dev)
    torch.cuda.synchronize()
    gt_s = time.perf_counter() - t0
    img = config.img_size
    if not (images.shape == (B_STEP, img, img, 3) and torch.isfinite(images).all()
            and 0 < float(masks.mean()) < 0.5):
        fail("synthetic sequence: bad images or masks")
    return dict(assets=assets, config=config, rcfg=rcfg, images=images, masks=masks,
                masks_er=masks_er, gt=gt, init=init, gt_render_s=gt_s)


def reset_launches() -> None:
    from harp_tpu_torch.parallel.workers import reset_kernel_launches

    reset_kernel_launches()


def read_launches() -> dict:
    from harp_tpu_torch.parallel.workers import kernel_launches

    return kernel_launches()


def expected_launches(n2: int, n1: int, n3: int, tex_reg: bool = True,
                      joint_gather: bool = False) -> dict:
    """Kernel launches of n2 stage-2, n1 stage-1 and n3 stage-3 train steps.
    K1 soft and K2 run in stages 1 and 2; K1 depth-only for the light in
    stages 2 and 3 and for the camera in stage 3; K3 in stages 2 and 3.
    segment_sum per step: eight in stages 2 and 3 (the vertex normals of
    the displacement and of the shading, the face-row gathers of the
    camera and the light, the packed attributes, the texture, the two
    texture regularisers), one in stage 1 (the displacement's vertex
    normals), and one more wherever K2 runs (its vertex scatter). K3 sums
    its taps in fixed point in its own kernel and calls no segment_sum; the
    VGG term launches none of them. HTML and NIMBLE have no texture
    regularisers (tex_reg=False: two fewer in stages 2 and 3); the arm's
    keypoint loss reaches its repeated extra-joint gather (joint_gather:
    one more in stages 1 and 2)."""
    return {"raster_ids_soft": n2 + n1, "raster_ids_depth": n2 + 2 * n3,
            "coverage_grad": n2 + n1, "pcf_scatter": n2 + n3,
            "segment_sum": (8 if tex_reg else 6) * (n2 + n3) + n1 + (n2 + n1)
            + (n2 + n1 if joint_gather else 0)}


def vgg_setup(seq, dev, compute_dtype: str):
    """(config with the VGG term on, the network, aux with the cached GT
    pyramids of the masked frames, seconds to cache them)."""
    import dataclasses

    import torch
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.losses.perceptual import Vgg16Features, precompute_slices

    config = dataclasses.replace(seq["config"], w_vgg=1.0, vgg_compute_dtype=compute_dtype)
    vgg = Vgg16Features.create(compute_dtype=compute_dtype, device=dev)
    _, aux = init_params(seq["init"], seq["assets"], config, device=dev)
    t0 = time.perf_counter()
    aux["vgg_gt"] = precompute_slices(vgg, seq["images"] * seq["masks_er"][..., None],
                                      chunk=config.vgg_chunk)
    torch.cuda.synchronize()
    return config, vgg, aux, time.perf_counter() - t0


def phase_step(dev, seq, vgg_dtype: str | None = None, arm: bool = False):
    """The fit step at 18 frames, 448^2 (without VGG, or with it in
    vgg_dtype from the cached GT pyramids): two stage-2 train steps from
    one state, whose gradients and updated parameters must be the same
    bits; then stage-2, stage-1 and stage-3 steps with launch counts,
    times and peak memory; one profiled stage-2 step. The texture-reg
    offsets come from the fit's key stream, as in fit_sequence. With `arm`,
    the arm's step (harp_tpu's value_arm_b18 without VGG)."""
    import torch
    from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, _key_stream_np, make_train_step
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.render import pipeline

    label = ("arm_" if arm else "") + ("vgg_step" if vgg_dtype else "step")
    assets, config, rcfg = seq["assets"], seq["config"], seq["rcfg"]
    images, masks, masks_er, init = seq["images"], seq["masks"], seq["masks_er"], seq["init"]
    vgg, extra = None, {}
    params, aux = init_params(init, assets, config, device=dev)
    if vgg_dtype:
        config, vgg, aux, extra["gt_cache_s"] = vgg_setup(seq, dev, vgg_dtype)
    fids = torch.arange(B_STEP, device=dev)
    with torch.no_grad():
        ref_verts = pipeline.mesh_forward(params, fids[:1], assets, config)[0][0]
    keys = _key_stream_np(0, 16)

    # Run-to-run spread: two stage-2 train steps from one state.
    runs = []
    for _ in range(2):
        ps = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
        make_train_step(assets, config, rcfg, ps, device=dev, vgg=vgg)(
            aux, fids, images, masks, masks_er, ref_verts, coarse_on=True, app_on=True,
            key=keys[0])
        runs.append({k: (p.grad.clone(), p.detach().clone()) for k, p in ps.items()
                     if p.grad is not None})
    spread = {k: float((g - runs[1][k][0]).abs().max()) for k, (g, _) in runs[0].items()}
    pspread = {k: float((p - runs[1][k][1]).abs().max()) for k, (_, p) in runs[0].items()}
    if any(spread.values()) or any(pspread.values()):
        fail(f"{label}: two steps from one state differ: gradients {spread}, "
             f"parameters {pspread}")
    del runs

    step = make_train_step(assets, config, rcfg, params, device=dev, vgg=vgg)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    plan = [(True, True)] * 8 + [(True, False)] * 3 + [(False, True)] * 3
    times, losses = [], []
    for i, (coarse_on, app_on) in enumerate(plan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total, br = step(aux, fids, images, masks, masks_er, ref_verts,
                         coarse_on=coarse_on, app_on=app_on, key=keys[i + 1])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(total))
        if not np.isfinite(losses[-1]):
            fail(f"{label}: non-finite loss in step ({coarse_on}, {app_on})")
        over = {k: float(br[k]) for k in OVERFLOW_KEYS if k in br}
        if any(over.values()):
            fail(f"{label}: raster overflow in step ({coarse_on}, {app_on}): {over}")
        if coarse_on and app_on and len(over) != 6:
            fail(f"{label}: stage-2 breakdown lacks an overflow counter")
        if app_on and (vgg is not None) != ("vgg" in br):
            fail(f"{label}: the VGG term is {'missing' if vgg else 'present'}")
    launches = read_launches()
    n2, n1, n3 = (plan.count(f) for f in ((True, True), (True, False), (False, True)))
    expected = expected_launches(n2, n1, n3, joint_gather=arm)
    if launches != expected:
        fail(f"{label}: launch counts {launches}, expected {expected}")
    step_ms = float(np.median(times[3:n2])) * 1e3  # the first steps warm up
    peak = torch.cuda.max_memory_allocated() / 2**30

    def stage2():
        step(aux, fids, images, masks, masks_er, ref_verts, coarse_on=True, app_on=True,
             key=keys[0])

    prof = phase_profile(stage2, label)
    emit({"phase": label, "frames": B_STEP, "img": config.img_size,
          "vgg_compute_dtype": vgg_dtype, "gt_render_s": seq["gt_render_s"], **extra,
          "losses": losses, "step_ms_stage2_median": step_ms,
          "frames_per_s": B_STEP / (step_ms / 1e3),
          "step_ms_stage1_median": float(np.median(times[n2:n2 + n1])) * 1e3,
          "step_ms_stage3_median": float(np.median(times[n2 + n1:])) * 1e3,
          "step_ms_all": [t * 1e3 for t in times], "peak_mem_gib": peak,
          "device_busy_ms": prof["device_busy_ms"], "launches": launches,
          "grad_run_to_run_max_abs": spread, "param_run_to_run_max_abs": pspread})
    return launches, stage2


def phase_vgg_f32(dev, seq) -> None:
    """The stage-2 VGG step with float32 convolutions, TF32 off and then on:
    median of 3 warm steps and the profiled step's device-busy ms, as
    numbers only (the port's default is bf16)."""
    import torch
    from harp_tpu_torch.fit.driver import _key_stream_np, make_train_step
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.render import pipeline

    config, vgg, aux, gt_s = vgg_setup(seq, dev, "float32")
    params, _ = init_params(seq["init"], seq["assets"], config, device=dev)
    fids = torch.arange(B_STEP, device=dev)
    with torch.no_grad():
        ref_verts = pipeline.mesh_forward(params, fids[:1], seq["assets"], config)[0][0]
    step = make_train_step(seq["assets"], config, seq["rcfg"], params, device=dev, vgg=vgg)
    key = _key_stream_np(0, 1)[0]
    out = {"phase": "vgg_step_f32", "gt_cache_s": gt_s}
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            def stage2():
                step(aux, fids, seq["images"], seq["masks"], seq["masks_er"], ref_verts,
                     coarse_on=True, app_on=True, key=key)

            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stage2()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            prof = phase_profile(stage2, f"vgg_step_f32_tf32_{'on' if tf32 else 'off'}")
        finally:
            torch.backends.cudnn.allow_tf32 = False
        tag = "tf32_on" if tf32 else "tf32_off"
        out[f"step_ms_stage2_median_{tag}"] = float(np.median(times[1:])) * 1e3
        out[f"device_busy_ms_{tag}"] = prof["device_busy_ms"]
    emit(out)


def phase_pcf_rounding(dev, seq) -> None:
    """K3's fixed point on the flagship's own tap updates. One stage-2 VGG
    step is run three times from one state, its K3 call recorded, with the
    scatter done by K3, by its float32 plain version and by a float64
    scatter: K3's per-texel error on those updates, the texels its
    rounding zeroes, and the change of the light-depth gradient and of
    every parameter gradient. Judged against the step's card-vs-CPU
    tolerance, 8e-4 of each leaf's largest entry, and per frame for the
    per-frame leaves and the depth map; fails beyond it."""
    import torch
    from harp_tpu_torch.fit.driver import _key_stream_np, make_train_step
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.render import pipeline
    from harp_tpu_torch.render.kernels import pcf_grad_kernel as pk

    def scatter_f64(yc, xc, upd, hl):
        return pk.pcf_scatter_plain(yc, xc, upd.double(), hl)

    config, vgg, aux, _ = vgg_setup(seq, dev, "bfloat16")
    params, _ = init_params(seq["init"], seq["assets"], config, device=dev)
    fids = torch.arange(B_STEP, device=dev)
    with torch.no_grad():
        ref_verts = pipeline.mesh_forward(params, fids[:1], seq["assets"], config)[0][0]
    original = pk.pcf_scatter
    runs = {}
    for name, fn in (("k3", original), ("plain", pk.pcf_scatter_plain),
                     ("f64", lambda *a: scatter_f64(*a).float())):
        calls = []

        def recording(yc, xc, upd, hl, fn=fn, calls=calls):
            out = fn(yc, xc, upd, hl)
            calls.append((yc, xc, upd, hl, out))
            return out

        ps = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
        pk.pcf_scatter = recording
        try:
            make_train_step(seq["assets"], config, seq["rcfg"], ps, device=dev, vgg=vgg)(
                aux, fids, seq["images"], seq["masks"], seq["masks_er"], ref_verts,
                coarse_on=True, app_on=True, key=_key_stream_np(0, 1)[0])
            torch.cuda.synchronize()
        finally:
            pk.pcf_scatter = original
        if len(calls) != 1:
            fail(f"pcf_rounding: {len(calls)} K3 calls in a stage-2 step, expected 1")
        runs[name] = (calls[0], {k: p.grad.clone() for k, p in ps.items() if p.grad is not None})
    (yc, xc, upd, hl, d_k3), g_k3 = runs["k3"]
    d_plain, g_plain = runs["plain"][0][4], runs["plain"][1]
    if not all(torch.equal(runs[n][0][2], upd) for n in ("plain", "f64")):
        fail("pcf_rounding: the three steps' tap updates differ")
    d64 = scatter_f64(yc, xc, upd, hl)
    big = d64.abs() > 1e-30

    def texel_rel(d, ref=d64):
        """|d - ref| over the float64 sum, on texels whose |sum| > 1e-30."""
        r = ((d.double() - ref.double()).abs() / d64.abs())[big]
        return {"max": float(r.max()), "p99": float(torch.quantile(r[:2**24].float(), 0.99)),
                "median": float(r.median())}

    def leaf_err(got, want):
        """max |got - want| over max |want|: whole leaf and per frame."""
        whole = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
        per_frame = None
        if got.dim() >= 1 and got.shape[0] == B_STEP:
            w = want.reshape(B_STEP, -1).abs().amax(1)
            e = (got - want).reshape(B_STEP, -1).abs().amax(1)
            per_frame = float((e[w > 0] / w[w > 0]).max()) if bool((w > 0).any()) else 0.0
        return whole, per_frame

    tol = 8e-4
    judged, failures = {}, []
    for ref_name, (d_ref, g_ref) in (("plain", (d_plain, g_plain)),
                                     ("f64", (runs["f64"][0][4], runs["f64"][1]))):
        rows = {"light_depth_dpad": leaf_err(d_k3, d_ref)}
        rows.update({k: leaf_err(g_k3[k], g_ref[k]) for k in g_ref})
        judged[ref_name] = rows
        for k, (whole, per_frame) in rows.items():
            if whole > tol or (per_frame is not None and per_frame > tol):
                failures.append(f"{k} vs {ref_name}: {whole} (per frame {per_frame})")
    finite = torch.isfinite(upd)
    frame_max = upd.abs().where(finite, 0.0).reshape(B_STEP, -1).amax(1)
    shift = pk.fixed_point_shift(float(frame_max.max()), upd.shape[1])
    emit({"phase": "pcf_rounding", "frames": B_STEP, "pixels_per_frame": upd.shape[1],
          "upd_max_abs": float(frame_max.max()), "shift": shift,
          "quantum": 2.0 ** -shift,
          "frame_max_over_global_max_min": float((frame_max / frame_max.max()).min()),
          "nonzero_updates": int((upd != 0).sum()),
          "updates_below_half_quantum": int(((upd != 0) & (upd.abs() < 2.0 ** (-shift - 1))).sum()),
          "texels_f64_nonzero": int(big.sum()),
          "texels_zeroed_nonzero_in_f32": int(((d_k3 == 0) & (d_plain != 0)).sum()),
          "texel_rel_err_k3_vs_f64": texel_rel(d_k3),
          "texel_rel_err_k3_vs_plain": texel_rel(d_k3, d_plain),
          "texel_rel_err_plain_vs_f64": texel_rel(d_plain),
          "leaf_err_k3": judged, "tolerance": tol, "held": not failures})
    if failures:
        fail(f"pcf_rounding: K3's fixed point beyond {tol} of a leaf's largest entry: "
             + "; ".join(failures))


def phase_fit(dev, seq) -> dict:
    """fit_sequence at full width (the flagship: 18 frames of 448^2,
    reference density, self-shadow, VGG in bf16 with the cached GT,
    stages 2 / 2 / 2) twice from one seed, then evaluate_sequence on the
    first: the loss per epoch, the JSONL's overflow counters, IoU / L1 /
    MS-SSIM. The two fits' final parameters must be the same bits, the
    last epoch's loss below the first's, every counter 0, and every kernel
    launched in the fit as many times as its steps need."""
    import dataclasses
    import tempfile

    import torch
    from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, FitData, fit_sequence
    from harp_tpu_torch.fit.evaluate import evaluate_sequence
    from harp_tpu_torch.fit.params import init_params

    config = dataclasses.replace(seq["config"], w_vgg=1.0, training_stage=(2, 2, 2),
                                 total_epoch=6)
    data = FitData(seq["images"], seq["masks"], seq["masks_er"])
    finals, out = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for run in range(2):
            params, aux = init_params(seq["init"], seq["assets"], config, device=dev)
            out_dir = os.path.join(tmp, f"fit{run}")
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, history = fit_sequence(config, seq["assets"], data, params, aux,
                                           rcfg=seq["rcfg"], out_dir=out_dir, device=dev)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = read_launches()
            finals.append({k: p.detach().clone() for k, p in params.items()})
            if run == 0:
                expected = expected_launches(2, 2, 2)
                expected["segment_sum"] += 1  # the ARAP reference's vertex normals
                if launches != expected:
                    fail(f"fit: launch counts {launches}, expected {expected}")
                with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                    logged = [json.loads(ln) for ln in f]
                epochs = [r for r in logged if "loss" in r]
                if len(epochs) != config.total_epoch:
                    fail(f"fit: {len(epochs)} epoch lines in metrics.jsonl")
                missing = [k for k in OVERFLOW_KEYS if k not in epochs[2]]
                counters = {k: max(r.get(k, 0.0) for r in epochs) for k in OVERFLOW_KEYS}
                if missing or any(counters.values()):
                    fail(f"fit: overflow counters missing {missing} or non-zero {counters}")
                losses = [h["loss"] for h in history]
                if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
                    fail(f"fit: epoch losses {losses}")
                reset_launches()
                t0 = time.perf_counter()
                stats = evaluate_sequence(config, seq["assets"], data, params, aux,
                                          rcfg=seq["rcfg"], out_dir=out_dir, device=dev)
                eval_s = time.perf_counter() - t0
                eval_launches = read_launches()
                n_png = len(os.listdir(os.path.join(out_dir, "rendered_after_opt")))
                out = {"epoch_losses": losses, "fit_s": fit_s, "launches": launches,
                       "overflow_max": counters, "eval": stats, "eval_s": eval_s,
                       "eval_launches": eval_launches, "eval_pngs": n_png,
                       "vgg_terms": [h.get("vgg") for h in history]}
                if not (0.5 < stats["Silhouette IoU"] <= 1.0 and 0.0 < stats["MS_SSIM"] <= 1.0
                        and np.isfinite(stats["L1"]) and n_png == B_STEP):
                    fail(f"fit: eval {stats}, {n_png} composites")
    spread = {k: float((finals[0][k] - finals[1][k]).abs().max()) for k in finals[0]}
    if any(spread.values()):
        fail(f"fit: two fits from one seed differ: {spread}")
    emit({"phase": "fit", "frames": B_STEP, "epochs": config.total_epoch,
          "stages": list(config.training_stage), **out, "fit2_param_max_abs_diff": spread})
    return {"config": config, "params": finals[0], "losses": out["epoch_losses"],
            "launches": out["launches"]}


BATCH_S = 4  # sequences of the batch fit (seeds 0 to 3)
# Its per-tile face capacity: seed 1's hand puts more than the flagship's
# 448 faces into one camera tile and 3 x 448 into one light tile (one
# bin_overflow and one light_bin_overflow a step at 448).
BATCH_CAP = 576
# Ranks of mesh_fit's gloo phase, sharing the one card, and the bound of
# harp_tpu's tests/test_parallel.py for a frame-split fit: Adam normalises
# each gradient by its RMS, so an entry whose gradient is rounding noise
# may step either way (epochs * 3 * lr + 2e-6).
MESH_RANKS = 2


def _differ(a: dict, b: dict) -> dict:
    """The leaves of two parameter dicts that are not the same bits, with
    their max |a - b|."""
    import torch

    out = {}
    for k, x in a.items():
        x, y = x.detach(), b[k].detach().to(x.device)
        if not torch.equal(x, y):
            out[k] = float((x.float() - y.float()).abs().max())
    return out


def phase_batch_fit(dev, seq) -> None:
    """fit_sequences_batch at full width: 4 synthetic sequences of 18
    frames (seeds 0-3) of the flagship hand at reference density, 448^2,
    texture 512^2, self-shadow, VGG bf16 on both sides (no GT cache, as
    harp_tpu's batch fit), stages 1 / 1 / 1. One stage-2 batch step: each
    sequence's update the same bits as a lone TrainStep on the same
    minibatch and key, and S times one step's kernel launches; wall ms per
    batch step (median of 3 warm), frames / s over the S x 18 frames, peak
    memory; then two batch fits, which must be the same bits. The tile
    capacity is BATCH_CAP (the light's 3x): every overflow counter 0."""
    import dataclasses

    import torch
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.fit.batch import BatchFitData, fit_sequences_batch, make_batch_train_step
    from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, make_train_step, prng_key, split_key
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.render import pipeline

    config = dataclasses.replace(seq["config"], w_vgg=1.0, vgg_compute_dtype="bfloat16",
                                 training_stage=(1, 1, 1), total_epoch=3)
    assets, rcfg = seq["assets"], dataclasses.replace(seq["rcfg"], cap=BATCH_CAP)
    frames, inits = [(seq["images"], seq["masks"], seq["masks_er"])], [seq["init"]]
    for s in range(1, BATCH_S):
        images, masks, masks_er, _, init = make_synthetic_sequence(
            assets, config, rcfg, n_frames=B_STEP, seed=s, device=dev)
        frames.append((images, masks, masks_er))
        inits.append(init)
    data = BatchFitData(*[torch.stack([f[i] for f in frames]) for i in range(3)])
    del frames

    def fresh():
        pairs = [init_params(i, assets, config, device=dev) for i in inits]
        return [p for p, _ in pairs], [a for _, a in pairs]

    # One stage-2 batch step against lone steps from the same state.
    params, aux = fresh()
    start = [{k: v.detach().clone() for k, v in p.items()} for p in params]
    fids = [torch.arange(B_STEP, device=dev)] * BATCH_S
    keys = split_key(prng_key(0), BATCH_S + 1)[1:]
    with torch.no_grad():
        refs = [pipeline.mesh_forward(p, fids[0][:1], assets, config)[0][0] for p in params]
    seqs = [data.sequence(s) for s in range(BATCH_S)]
    batch = [[q.images for q in seqs], [q.masks for q in seqs], [q.masks_eroded for q in seqs]]
    step = make_batch_train_step(assets, config, rcfg, params, device=dev)
    reset_launches()
    _, breakdowns = step(aux, fids, *batch, refs, keys, [1.0] * BATCH_S, coarse_on=True,
                         app_on=True)
    launches = read_launches()
    counters = [{k: float(br[k]) for k in OVERFLOW_KEYS} for br in breakdowns]
    one = expected_launches(1, 0, 0)
    if launches != {k: BATCH_S * v for k, v in one.items()}:
        fail(f"batch_fit: launches {launches}, expected {BATCH_S} x {one}")
    lone_diff = {}
    for s in range(BATCH_S):
        lone = {k: v.clone().requires_grad_(True) for k, v in start[s].items()}
        make_train_step(assets, config, rcfg, lone, device=dev)(
            aux[s], fids[s], *(b[s] for b in batch), refs[s], 1.0, coarse_on=True,
            app_on=True, key=keys[s])
        lone_diff.update({f"{s}/{k}": v for k, v in _differ(lone, params[s]).items()})
    if lone_diff:
        fail(f"batch_fit: batch step vs lone steps differ: {lone_diff}")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(aux, fids, *batch, refs, keys, [1.0] * BATCH_S, coarse_on=True, app_on=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = float(np.median(times[1:])) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    del step, params, aux, start

    fits = []
    for _ in range(2):
        params, aux = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, hist = fit_sequences_batch(config, assets, data, params, aux, rcfg=rcfg, device=dev)
        torch.cuda.synchronize()
        fits.append((out, hist, time.perf_counter() - t0))
    (p0, h0, fit_s), (p1, h1, _) = fits
    spread = {f"{s}/{k}": v for s in range(BATCH_S) for k, v in _differ(p0[s], p1[s]).items()}
    if spread or h0 != h1:
        fail(f"batch_fit: two batch fits differ: {spread}")
    losses = [[h["loss"] for h in hs] for hs in h0]
    overflow = [[h["raster_overflow"] for h in hs] for hs in h0]
    if not all(np.isfinite(x) for ls in losses for x in ls):
        fail(f"batch_fit: epoch losses {losses}")
    if any(v for c in counters for v in c.values()) or any(v for o in overflow for v in o):
        fail(f"batch_fit: raster overflow: step {counters}, fit {overflow}")
    emit({"phase": "batch_fit", "sequences": BATCH_S, "frames": B_STEP, "img": config.img_size,
          "vgg_compute_dtype": "bfloat16", "vgg_gt_cache": False,
          "stages": list(config.training_stage), "step_launches": launches,
          "batch_step_ms_median": step_ms, "batch_step_ms_all": [t * 1e3 for t in times],
          "frames_per_s": BATCH_S * B_STEP / (step_ms / 1e3), "peak_mem_gib": peak,
          "fit_s": fit_s, "epoch_losses": losses,
          "raster_cap": rcfg.cap, "raster_overflow": overflow,
          "step_overflow_counters": counters,
          "lone_vs_batch_differ": lone_diff, "fit2_differ": spread})


def phase_mesh_fit(dev, seq, fit: dict) -> None:
    """(a) fit_sequence on a one-rank NCCL mesh at the fit phase's setting:
    the same bits as that phase's fit without a mesh; the halo at world
    size 1. (b) Two gloo ranks sharing the card (parallel.launch; 9 of the
    18 frames each), stages 1 / 1 / 1, twice: the two runs the same bits,
    the loss history within rtol 1e-4 of the card's unsharded fit, the
    parameters within harp_tpu's frame-split bound, both ranks through K1,
    K2, K3 and segment_sum; gloo all-reduces and broadcasts the CUDA
    gradients and parameters, and neighbor_shift stages its rows through
    the host (gloo sends no CUDA tensors). One card: no scaling claim."""
    import dataclasses

    import torch
    from harp_tpu_torch.fit.driver import FitData, fit_sequence
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.parallel import make_mesh, neighbor_shift, workers
    from harp_tpu_torch.parallel.launch import launch

    data = FitData(seq["images"], seq["masks"], seq["masks_er"])
    x = torch.arange(B_STEP * 3, dtype=torch.float32, device=dev).reshape(B_STEP, 3)
    fid = torch.arange(B_STEP, device=dev)
    want_left, want_right = x[(fid - 1).clamp(min=0)], x[(fid + 1).clamp(max=B_STEP - 1)]
    params, aux = init_params(seq["init"], seq["assets"], fit["config"], device=dev)
    reset_launches()
    t0 = time.perf_counter()
    with make_mesh(1, device=dev) as mesh:
        if mesh.backend != "nccl":
            fail(f"mesh_fit: a CUDA mesh runs {mesh.backend}")
        params, _ = fit_sequence(fit["config"], seq["assets"], data, params, aux,
                                 rcfg=seq["rcfg"], mesh=mesh)
        left, right = neighbor_shift(mesh, x)
    torch.cuda.synchronize()
    nccl_s = time.perf_counter() - t0
    nccl_launches = read_launches()
    nccl_differ = _differ(params, fit["params"])
    if nccl_differ or nccl_launches != fit["launches"]:
        fail(f"mesh_fit: the one-rank NCCL fit differs from the fit: {nccl_differ}, "
             f"launches {nccl_launches} against {fit['launches']}")
    if not (torch.equal(left, want_left) and torch.equal(right, want_right)):
        fail("mesh_fit: neighbor_shift at world size 1")

    config = dataclasses.replace(fit["config"], training_stage=(1, 1, 1), total_epoch=3)
    params, aux = init_params(seq["init"], seq["assets"], config, device=dev)
    want, want_hist = fit_sequence(config, seq["assets"], data, params, aux, rcfg=seq["rcfg"],
                                   device=dev)
    scene = {"assets": seq["assets"], "config": config, "rcfg": seq["rcfg"],
             "init": seq["init"], "frames": tuple(t.cpu().numpy() for t in (
                 seq["images"], seq["masks"], seq["masks_er"]))}
    t0 = time.perf_counter()
    fits, (h_left, h_right) = launch(
        workers.run_all, MESH_RANKS, [(workers.fit_sequence_on_mesh, (scene, 2)),
                                      (workers.neighbor_shift_on_mesh, (x.cpu().numpy(),))],
        devices=[str(dev)] * MESH_RANKS, backend="gloo", timeout=600)
    gloo_s = time.perf_counter() - t0
    runs = fits["runs"]
    run_differ = {k: float(np.abs(runs[0]["params"][k] - runs[1]["params"][k]).max())
                  for k in runs[0]["params"]
                  if not np.array_equal(runs[0]["params"][k], runs[1]["params"][k])}
    if run_differ or runs[0]["history"] != runs[1]["history"]:
        fail(f"mesh_fit: two gloo fits differ: {run_differ}")
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(runs[0]["history"], want_hist)]
    lr = max(config.lr_pose, config.lr_app)
    bound = config.total_epoch * 3 * lr + 2e-6
    param_err = {k: float(np.max(np.abs(runs[0]["params"][k] - v.detach().cpu().numpy())
                                 - 2e-4 * np.abs(v.detach().cpu().numpy())))
                 for k, v in want.items()}
    over = {k: e for k, e in param_err.items() if e > bound}
    if len(runs[0]["history"]) != len(want_hist) or max(loss_rel) > 1e-4 or over:
        fail(f"mesh_fit: two gloo ranks against the unsharded fit: loss rel {loss_rel}, "
             f"parameters beyond {bound}: {over}")
    per_rank = dict(expected_launches(1, 1, 1), segment_sum=expected_launches(1, 1, 1)[
        "segment_sum"] + 1)  # + the ARAP reference's vertex normals
    per_rank = {k: 2 * v for k, v in per_rank.items()}
    if fits["launches"] != [per_rank] * MESH_RANKS:
        fail(f"mesh_fit: rank launches {fits['launches']}, expected {per_rank} each")
    if not (np.array_equal(h_left, want_left.cpu().numpy())
            and np.array_equal(h_right, want_right.cpu().numpy())):
        fail("mesh_fit: neighbor_shift of CUDA rows over gloo")
    emit({"phase": "mesh_fit", "card_count": torch.cuda.device_count(),
          "nccl_world_1": {"epochs": fit["config"].total_epoch, "fit_s": nccl_s,
                           "differ_from_fit": nccl_differ, "launches": nccl_launches},
          "gloo_ranks_sharing_one_card": {
              "ranks": MESH_RANKS, "frames_per_rank": B_STEP // MESH_RANKS,
              "stages": list(config.training_stage), "launch_s_two_fits": gloo_s,
              "epoch_losses": [h["loss"] for h in runs[0]["history"]],
              "unsharded_epoch_losses": [h["loss"] for h in want_hist],
              "loss_rel_err": loss_rel, "param_excess_over_rtol": param_err,
              "bound": bound, "rank_launches": fits["launches"],
              "runs_differ": run_differ},
          "gloo_cuda": {"all_reduce": "used by the fit", "broadcast": "used by the fit",
                        "send_recv": "not used: neighbor_shift stages its rows through "
                                     "the host on a gloo mesh of CUDA devices"}})


def phase_orbax_resume(dev, seq, fit: dict) -> None:
    """The fit phase's fit with checkpoint_backend "orbax", killed after
    its epoch-4 checkpoint (checkpoints every epoch, max_to_keep 3: steps
    2, 3, 4 left) and resumed through load_fit_checkpoint: the same bits as
    the fit phase's unbroken fit."""
    import dataclasses
    import tempfile

    import torch
    from harp_tpu_torch.fit.driver import FitData, fit_sequence
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.fit.resume import load_fit_checkpoint

    config = dataclasses.replace(fit["config"], checkpoint_backend="orbax")
    data = FitData(seq["images"], seq["masks"], seq["masks_er"])
    with tempfile.TemporaryDirectory() as tmp:
        params, aux = init_params(seq["init"], seq["assets"], config, device=dev)
        t0 = time.perf_counter()
        fit_sequence(dataclasses.replace(config, total_epoch=config.total_epoch - 1),
                     seq["assets"], data, params, aux, rcfg=seq["rcfg"], out_dir=tmp,
                     checkpoint_every=1, device=dev)
        killed_s = time.perf_counter() - t0
        steps = sorted(os.listdir(os.path.join(tmp, "orbax")))
        ck = load_fit_checkpoint(tmp, device=dev)
        _, aux = init_params(seq["init"], seq["assets"], config, device=dev)
        resumed, hist = fit_sequence(config, seq["assets"], data, ck["params"], aux,
                                     rcfg=seq["rcfg"], resume=ck, device=dev)
    differ = _differ(resumed, fit["params"])
    last = config.total_epoch - 1
    if (steps != [str(e) for e in range(last - 3, last)] or int(ck["epoch"]) != last - 1
            or [h["epoch"] for h in hist] != [last] or hist[0]["loss"] != fit["losses"][-1]
            or differ):
        fail(f"orbax_resume: steps {steps}, resumed at {ck['epoch']}, history {hist}, "
             f"differs from the unbroken fit: {differ}")
    emit({"phase": "orbax_resume", "steps_kept": steps, "resumed_from": int(ck["epoch"]),
          "killed_fit_s": killed_s, "last_loss": hist[0]["loss"], "differ_from_fit": differ})


def phase_arm_budget(dev, seq) -> None:
    """The arm sequence's raster counters on the card, at harp_tpu's CLI
    defaults (active 0.28, span 3, cap 448) and at ARM_BUDGET: the ground
    truth's and the initial parameters' meshes, camera (448^2) and light
    (224^2) binnings only. Fails unless ARM_BUDGET's are all 0."""
    import dataclasses

    import torch
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.render import camera as cam_mod
    from harp_tpu_torch.render import pipeline
    from harp_tpu_torch.render.rasterizer import RasterConfig, active_budget, bin_pairs
    from harp_tpu_torch.render.shadow import light_raster_config, shadow_cameras

    assets, config = seq["assets"], seq["config"]
    faces = torch.as_tensor(assets.render_faces.astype(np.int64), device=dev)
    params, _ = init_params(seq["init"], assets, config, device=dev)
    fids = torch.arange(B_STEP, device=dev)
    out = {}
    for budget, rcfg in (("cli_defaults", RasterConfig(image_size=IMG, active_fraction=0.28,
                                                       span_tiles=3, cap=448)),
                         ("arm_budget", seq["rcfg"])):
        for which, p in (("gt", dict(params, pose=seq["gt"]["pose"], rot=seq["gt"]["rot"],
                                     shape=seq["gt"]["shape"])), ("init", params)):
            with torch.no_grad():
                verts, _ = pipeline.mesh_forward(p, fids, assets, config)
                R, T = pipeline.camera_for_frames(p, fids, config)
                light = p["light_positions"][fids]
                lR, lT, _, _ = shadow_cameras(p["cam"][fids], light, verts.mean(1), config)
                rl = light_raster_config(rcfg, config.shadow_map_scale)
                for view, cfg, screen in (
                        ("camera", rcfg, cam_mod.screen_from_world(
                            verts, R, T, config.focal_length, config.img_size)),
                        ("light", rl, cam_mod.screen_from_world(
                            verts, lR, lT, config.focal_length * rl.image_size / config.img_size,
                            rl.image_size))):
                    b = bin_pairs(screen[:, faces], cfg)
                    cr = b["counts_rep"]
                    out[f"{budget}/{which}/{view}"] = {
                        "bin_overflow": int((cr > cfg.cap).sum()),
                        "active_overflow": int((cr > 0).sum(-1).sub(active_budget(cfg))
                                               .clamp(min=0).sum()),
                        "span_overflow": int(b["span_cnt"].sum()),
                        "occupied_tiles_max": int((cr > 0).sum(-1).max()),
                        "active_tiles": active_budget(cfg),
                        "faces_per_tile_max": int(b["counts"].max())}
    emit({"phase": "arm_budget", "arm_budget": dataclasses.asdict(seq["rcfg"]), **out})
    bad = {k: v for k, v in out.items() if k.startswith("arm_budget")
           and (v["bin_overflow"] or v["active_overflow"] or v["span_overflow"])}
    if bad:
        fail(f"arm_budget: ARM_BUDGET truncates the arm sequence: {bad}")


def phase_zoo_step(dev) -> None:
    """One stage-2 step of HTML (texture basis of 101 coefficients at
    512^2, in extras) and one of NIMBLE at 448^2, B18, texture 512, on
    their 18-frame synthetic sequences (ZOO_BUDGET): each run twice from one
    state, whose gradients and updated parameters must be the same bits;
    every overflow counter 0; each kernel launched as the two steps need."""
    import torch
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, _key_stream_np, make_train_step
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.models.zoo import load_hand_model
    from harp_tpu_torch.render import pipeline
    from harp_tpu_torch.render.rasterizer import RasterConfig

    out = {}
    for family in ("html", "nimble"):
        config = HarpConfig(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
                            model_type=family, self_shadow=True, w_vgg=0.0, batch_size=B_STEP)
        rcfg = RasterConfig(image_size=IMG, **ZOO_BUDGET)
        t0 = time.perf_counter()
        assets, extras = load_hand_model(config, synthetic=True)
        setup_s = time.perf_counter() - t0
        images, masks, masks_er, _, init = make_synthetic_sequence(
            assets, config, rcfg, n_frames=B_STEP, seed=0, device=dev)
        params, aux = init_params(init, assets, config, device=dev)
        fids = torch.arange(B_STEP, device=dev)
        with torch.no_grad():
            ref_verts = pipeline.mesh_forward(params, fids[:1], assets, config)[0][0]
        key = _key_stream_np(0, 1)[0]
        runs, times = [], []
        reset_launches()
        for _ in range(2):
            ps = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
            step = make_train_step(assets, config, rcfg, ps, device=dev, extras=extras)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            total, br = step(aux, fids, images, masks, masks_er, ref_verts, coarse_on=True,
                             app_on=True, key=key)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            over = {k: float(br[k]) for k in OVERFLOW_KEYS}
            if any(over.values()) or not np.isfinite(float(total)):
                fail(f"zoo_step {family}: loss {float(total)}, overflow {over}")
            runs.append(({k: (p.grad.clone(), p.detach().clone()) for k, p in ps.items()
                          if p.grad is not None}, float(total)))
        launches = read_launches()
        expected = expected_launches(2, 0, 0, tex_reg=False)
        if launches != expected:
            fail(f"zoo_step {family}: launch counts {launches}, expected {expected}")
        spread = {k: float((g - runs[1][0][k][0]).abs().max()) for k, (g, _) in runs[0][0].items()}
        pspread = {k: float((p - runs[1][0][k][1]).abs().max())
                   for k, (_, p) in runs[0][0].items()}
        if any(spread.values()) or any(pspread.values()) or runs[0][1] != runs[1][1]:
            fail(f"zoo_step {family}: two steps from one state differ: gradients {spread}, "
                 f"parameters {pspread}, losses {runs[0][1]} {runs[1][1]}")
        moved = sorted(k for k, (_, p) in runs[0][0].items() if not torch.equal(p, params[k]))
        want = "html_texture" if family == "html" else "texture"
        if want not in moved:
            fail(f"zoo_step {family}: {want} did not move ({moved})")
        out[family] = {"render_verts": assets.num_render_verts,
                       "faces": int(len(assets.render_faces)), "setup_s": setup_s,
                       "loss": runs[0][1], "terms": sorted(br), "step_ms": times,
                       "launches": launches, "moved": moved,
                       "grad_run_to_run_max_abs": spread, "param_run_to_run_max_abs": pspread}
        del runs, params, aux, extras
    emit({"phase": "zoo_step", "frames": B_STEP, "img": IMG, "budget": ZOO_BUDGET, **out})


def phase_arm_fit(dev) -> None:
    """The arm fit through the CLI, as a user runs it:
    harp_tpu_torch.fit_avatar.main(["--synthetic", "--use-arm", ...]) at
    448^2, 18 frames, stages 2 / 2 / 2 with VGG (bf16, cached GT) and the
    CLI's raster budget for the arm (which must be ARM_BUDGET), then its
    evaluation. The loss must fall, every overflow
    counter of every epoch be 0, every kernel be launched, and IoU / L1 /
    MS-SSIM come out finite."""
    import contextlib
    import io
    import tempfile

    from harp_tpu_torch.fit.driver import OVERFLOW_KEYS
    from harp_tpu_torch.fit_avatar import main as fit_avatar

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--use-arm", "--img-size", str(IMG), "--n-frames", str(B_STEP),
                "--texture-size", str(TEX), "--stages", "2", "2", "2", "--epochs", "6",
                "--out", tmp]
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the CLI prints its summary
            stats = fit_avatar(argv)
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "loss" in r]
        with open(os.path.join(tmp, "config.yaml")) as f:
            cli_cfg = f.read()
        n_png = len(os.listdir(os.path.join(tmp, "rendered_after_opt")))
    losses = [r["loss"] for r in epochs]
    counters = {k: max(r.get(k, 0.0) for r in epochs) for k in OVERFLOW_KEYS}
    missing = [k for k in OVERFLOW_KEYS if k not in epochs[2]]
    unused = [k for k, v in launches.items() if v == 0]
    record = {"phase": "arm_fit", "argv": argv, "epoch_losses": losses,
              "overflow_max": counters, "launches": launches, "cli_wall_s": wall_s,
              "eval_pngs": n_png, **{k: stats.get(k) for k in (
                  "Silhouette IoU", "L1", "MS_SSIM", "LPIPS_proxy", "fit_wall_s",
                  "eval_wall_s", "final_loss", "device")}}
    emit(record)
    if len(losses) != 6 or not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"arm_fit: epoch losses {losses}")
    if missing or any(counters.values()):
        fail(f"arm_fit: overflow counters missing {missing} or non-zero {counters}")
    if unused:
        fail(f"arm_fit: kernels never launched: {unused}")
    budget = {"raster_active_fraction": ARM_BUDGET["active_fraction"],
              "raster_span_tiles": ARM_BUDGET["span_tiles"], "raster_cap": ARM_BUDGET["cap"]}
    if any(f"{k}: {v}" not in cli_cfg for k, v in budget.items()):
        fail(f"arm_fit: the CLI's raster budget is not {budget}:\n{cli_cfg}")
    if not (0.0 < stats["Silhouette IoU"] <= 1.0 and 0.0 < stats["MS_SSIM"] <= 1.0
            and np.isfinite(stats["L1"]) and n_png == B_STEP):
        fail(f"arm_fit: eval {stats}, {n_png} composites")


@contextlib.contextmanager
def chdir(path: str):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


REAL_FRAMES = {"1": 36, "2": 9}  # the train and val sequences of phase real_data
DECODE_LONG = 300  # a real sequence's length, for the decode timing


def _decode_ms(dev, paths: list, repeats: int = 3) -> dict:
    """Per-frame decode ms (nvJPEG on the card, file reads included) of
    `paths`' frames and of their masks, best of `repeats` after one
    warm-up."""
    import torch
    from harp_tpu_torch import native

    out = {}
    for kind, gray in (("rgb", False), ("mask", True)):
        files = [p.replace("unscreen_cropped", "mask").replace(".jpg", "_mask.jpg")
                 for p in paths] if gray else paths
        native.decode_jpeg_batch(files, gray=gray, device=dev)
        best = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            native.decode_jpeg_batch(files, gray=gray, device=dev)
            torch.cuda.synchronize()
            best.append(time.perf_counter() - t0)
        out[kind] = 1000.0 * min(best) / len(files)
    return out


def _run_cli(argv: list) -> tuple:
    """fit_avatar's CLI in this process: (summary, wall s, launches,
    per-epoch JSONL lines)."""
    import contextlib as cl
    import io

    from harp_tpu_torch.fit_avatar import main as fit_avatar

    reset_launches()
    t0 = time.perf_counter()
    with cl.redirect_stdout(io.StringIO()):  # the CLI prints its summary
        stats = fit_avatar(argv)
    wall = time.perf_counter() - t0
    out = argv[argv.index("--out") + 1]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "loss" in r]
    return stats, wall, read_launches(), epochs


def phase_real_data(dev) -> dict:
    """The real-data fit through the CLI, on files in the reference's
    layout that this phase writes in a scratch working directory: the
    model files (MANO_RIGHT.pkl, template/hand/textured_hand.obj,
    uv_mask.png) from the synthetic hand at reference density, and a
    36-frame train sequence "1" and a 9-frame val sequence "2" rendered at
    448^2 from the hand loaded back from them (make_synthetic_sequence
    seeds 0 and 1, its perturbed start as the METRO pkl), written by the
    port's encoder (nvJPEG) at quality 95. load_sequences must give the
    pkl parameters exactly, frames within a mean of 0.015 of the float
    frames and masks within 0.03 (harp_tpu's bounds), eroded masks equal
    to erode_mask of the masks, all on the card; decode ms per frame at 36
    and at 300 frames (the 36 again under new names). Then the CLI at
    harp_tpu's defaults (B18, VGG bf16 with the cached GT, shadow, budget
    0.28 / span 3 / cap 448) with --stages 2 2 2 --epochs 7 --val-list 2,
    twice: the loss falls, every overflow counter reads 0, every kernel
    runs, the eval IoU is over 0.7, the val keys and the epoch-0 image and
    val logs are there, and the two runs' saved_params.pkl are the same
    bits. Then --start-from the first run --known-appearance on sequence
    2: texture, normal map, displacements and shape come out unchanged.
    Returns what phase preprocess fits: the model and the train
    sequence's GT and start."""
    import pickle
    import shutil
    import tempfile

    import torch
    from harp_tpu_torch.assets import build_synthetic_assets, write_hand_model_files
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.data.dataset import load_sequences, write_sequence
    from harp_tpu_torch.data.synthetic import erode_mask, make_synthetic_sequence
    from harp_tpu_torch.fit.driver import OVERFLOW_KEYS
    from harp_tpu_torch.models.zoo import load_hand_model
    from harp_tpu_torch.render.rasterizer import RasterConfig

    rec = {"phase": "real_data"}
    with tempfile.TemporaryDirectory() as tmp, chdir(tmp):
        write_hand_model_files(build_synthetic_assets(uv_size=TEX, density="reference"),
                               "MANO_RIGHT.pkl", "template/hand/textured_hand.obj",
                               "template/hand/uv_mask.png")
        config = HarpConfig(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX)
        assets, _ = load_hand_model(config, mano_pkl="MANO_RIGHT.pkl")
        # The ground truth rendered with a budget it cannot overflow.
        gt_rcfg = RasterConfig(image_size=IMG, active_fraction=0.5, cap=448, span_tiles=4)
        frames, t0 = {}, time.perf_counter()
        for seq, seed in (("1", 0), ("2", 1)):
            images, masks, _, gt, init = make_synthetic_sequence(
                assets, config, gt_rcfg, n_frames=REAL_FRAMES[seq], seed=seed, device=dev)
            init = dict(init, verts=np.zeros((REAL_FRAMES[seq], 1, 3), np.float32))
            write_sequence(tmp, seq, images, masks, init)
            frames[seq] = (images, masks, gt, init)
        rec["write_s"] = time.perf_counter() - t0

        params, images, masks, eroded = load_sequences(tmp, tmp, ["1"], device=dev)
        f_images, f_masks, gt, init = frames["1"]
        bad = [k for k in init if not np.array_equal(params[k], np.asarray(init[k], np.float32))]
        err = {"image_mean_abs": float((images - f_images).abs().mean()),
               "mask_mean_abs": float((masks - f_masks).abs().mean())}
        rec["decode_err"] = err
        if bad or err["image_mean_abs"] >= 0.015 or err["mask_mean_abs"] >= 0.03:
            fail(f"real_data: pkl keys differ {bad} or decode beyond bounds {err}")
        if not (images.device.type == masks.device.type == eroded.device.type == dev.type
                and torch.equal(eroded, erode_mask(masks, iterations=2))):
            fail("real_data: the frames are not on the card or the eroded masks differ")

        paths = [os.path.join(tmp, "1", "unscreen_cropped", "%04d.jpg" % i)
                 for i in range(REAL_FRAMES["1"])]
        long_dir = os.path.join(tmp, "long")
        for sub in ("unscreen_cropped", "mask"):
            os.makedirs(os.path.join(long_dir, sub))
        long_paths = []
        for i in range(DECODE_LONG):
            src = paths[i % len(paths)]
            dst = os.path.join(long_dir, "unscreen_cropped", "%04d.jpg" % i)
            shutil.copyfile(src, dst)
            shutil.copyfile(src.replace("unscreen_cropped", "mask").replace(".jpg", "_mask.jpg"),
                            dst.replace("unscreen_cropped", "mask").replace(".jpg", "_mask.jpg"))
            long_paths.append(dst)
        rec["decode_ms_per_frame"] = {str(len(paths)): _decode_ms(dev, paths),
                                      str(DECODE_LONG): _decode_ms(dev, long_paths)}
        # nvJPEG's batched decode on one host thread (hn_decode_batch).
        rec["decode_route"], rec["decode_host_threads"] = "nvjpeg", 1
        emit(dict(rec, phase="real_data_decode"))

        base = ["--metro-output-dir", tmp, "--image-dir", tmp, "--train-list", "1",
                "--mano-pkl", "MANO_RIGHT.pkl", "--img-size", str(IMG), "--texture-size",
                str(TEX), "--stages", "2", "2", "2", "--epochs", "7"]
        saved = []
        for run in range(2):
            out = f"run{run}"
            stats, wall, launches, epochs = _run_cli(base + ["--val-list", "2", "--out", out])
            with open(os.path.join(out, "saved_params.pkl"), "rb") as f:
                saved.append(pickle.load(f))
            if run:
                rec["cli_wall_s_run2"] = wall
                continue
            losses = [r["loss"] for r in epochs]
            counters = {k: max(r.get(k, 0.0) for r in epochs) for k in OVERFLOW_KEYS}
            logs = [n for n in ("sil_0000.png", "0000.png", "val_0000.png", "uv_0000.png",
                                "normal_0000.png") if os.path.exists(os.path.join(out, n))]
            rec.update({"cli_wall_s": wall, "epoch_losses": losses, "overflow_max": counters,
                        "launches": launches, "logs": logs, **{k: stats.get(k) for k in (
                            "Silhouette IoU", "L1", "MS_SSIM", "LPIPS_proxy",
                            "val Silhouette IoU", "val L1", "val MS_SSIM", "fit_wall_s",
                            "eval_wall_s", "final_loss", "device")}})
            if len(losses) != 7 or not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
                fail(f"real_data: epoch losses {losses}")
            if any(k not in epochs[3] for k in OVERFLOW_KEYS) or any(counters.values()):
                fail(f"real_data: overflow counters {counters}")
            if any(v == 0 for v in launches.values()):
                fail(f"real_data: kernels never launched: {launches}")
            if not stats["Silhouette IoU"] > 0.7 or "val Silhouette IoU" not in stats:
                fail(f"real_data: eval {stats}")
            if len(logs) != 5:
                fail(f"real_data: image / val logs missing, found {logs}")
        spread = {k: float(np.abs(saved[0][k] - saved[1][k]).max()) for k in saved[0]}
        rec["cli2_param_max_abs_diff"] = spread
        if any(spread.values()):
            fail(f"real_data: two CLI fits from one seed differ: {spread}")

        known = base + ["--start-from", "run0", "--known-appearance", "--out", "known"]
        known[known.index("--train-list") + 1] = "2"
        stats, wall, _, _ = _run_cli(known)
        with open(os.path.join("known", "saved_params_test.pkl"), "rb") as f:
            kept = pickle.load(f)
        moved = [k for k in ("texture", "normal_map", "verts_disps", "shape")
                 if not np.array_equal(kept[k], saved[0][k])]
        rec.update({"known_wall_s": wall, "known_Silhouette IoU": stats["Silhouette IoU"]})
        emit(rec)
        if moved:
            fail(f"real_data: --known-appearance changed {moved}")
    return {"model": assets.model, "gt": gt, "init": init}


def phase_preprocess(dev, real: dict) -> None:
    """Preprocessing on the card: fit_mano_to_vertices to the train
    sequence's 36 GT meshes (the port's mano_forward of its GT parameters,
    as harp_tpu's tests/test_preprocess.py builds its targets) at
    harp_tpu's iteration counts (500 / 700), whose fit error must come
    under 10 mm^2; smooth_pose_sequence and smooth_camera_sequence at 1000
    iterations; the wall seconds of each. Card against CPU: the fit's
    objective at its start (loss rtol 1e-5, gradient within 1e-3 of each
    leaf's largest entry) and both smoothers at 50 iterations (within 1e-3
    of each leaf's largest entry). The smoothers' anchor joints carry 1 mm
    of seeded noise there, as METRO's do: joints equal to the forward's
    would leave the end frames' gradients at rounding noise, which Adam
    turns into full steps of either sign on either device.

    The fit's trajectory itself is not held card against CPU: its start
    puts the translation at the targets' mean, where the translation's
    gradient is rounding noise, and Adam's first steps (lr 0.1) take that
    noise's sign. The phase records the 50 + 50 fit's card-vs-CPU gaps
    beside the CPU's own gaps under a 1e-7 relative change of the targets
    (numbers only)."""
    import torch
    from harp_tpu_torch.models.mano import mano_forward
    from harp_tpu_torch.preprocess import (
        fit_mano_to_vertices, smooth_camera_sequence, smooth_pose_sequence,
    )
    from harp_tpu_torch.preprocess.fit import mano_fit_objective

    model, gt, init = real["model"], real["gt"], real["init"]
    n = gt["pose"].shape[0]
    with torch.no_grad():
        target, _ = mano_forward(model, torch.cat([gt["rot"], gt["pose"]], 1),
                                 gt["shape"].expand(n, -1), gt["trans"])
    rec = {"phase": "preprocess", "frames": n}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = fit_mano_to_vertices(model, target, device=dev)
    torch.cuda.synchronize()
    rec["fit_s"], rec["fit_error_mm2"] = time.perf_counter() - t0, fit["fit_error"]
    rec["fit_mean_abs_mm"] = float((fit["verts"] - target).abs().mean())
    seq = dict(fit, cam=init["cam"])
    t0 = time.perf_counter()
    smoothed = smooth_pose_sequence(model, seq, device=dev)
    torch.cuda.synchronize()
    rec["smooth_pose_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    smooth_camera_sequence(model, smoothed, device=dev)
    torch.cuda.synchronize()
    rec["smooth_camera_s"] = time.perf_counter() - t0

    def leaf_err(got: dict, want: dict, keys) -> dict:
        out = {}
        for k in keys:
            a, b = got[k].detach().cpu().double(), want[k].detach().cpu().double()
            out[k] = float((a - b).abs().max() / max(float(b.abs().max()), 1e-12))
        return out

    def start(device):
        _, loss_fn, p = mano_fit_objective(model, target, device=device)
        p = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = loss_fn(p)
        return dict(zip(p, torch.autograd.grad(loss, list(p.values())))), float(loss.detach())

    (g_card, l_card), (g_cpu, l_cpu) = start(dev), start("cpu")
    rec["card_vs_cpu"] = {"start_loss_rel": abs(l_card - l_cpu) / abs(l_cpu),
                          "start_grad": leaf_err(g_card, g_cpu, g_cpu)}
    rng = np.random.RandomState(0)
    noisy = dict(seq, joints=fit["joints"].cpu().numpy()
                 + rng.randn(*fit["joints"].shape).astype(np.float32))
    for name, fn, ks in (("smooth_pose", smooth_pose_sequence, ("rot", "pose", "shape")),
                         ("smooth_camera", smooth_camera_sequence, ("cam",))):
        rec["card_vs_cpu"][name] = leaf_err(fn(model, noisy, total_iters=50, device=dev),
                                            fn(model, noisy, total_iters=50, device="cpu"), ks)
    short = dict(epoch_coarse=50, epoch_fine=50)
    keys = ("rot", "pose", "shape", "trans", "verts")
    cpu_fit = fit_mano_to_vertices(model, target.cpu(), **short, device="cpu")
    rec["fit_50_50_gaps"] = {
        "card_vs_cpu": leaf_err(fit_mano_to_vertices(model, target, **short, device=dev),
                                cpu_fit, keys),
        "cpu_vs_cpu_target_1e-7": leaf_err(fit_mano_to_vertices(
            model, target.cpu() * (1 + 1e-7), **short, device="cpu"), cpu_fit, keys)}
    emit(rec)
    if not rec["fit_error_mm2"] < 10.0:
        fail(f"preprocess: fit error {rec['fit_error_mm2']} mm^2")
    c = rec["card_vs_cpu"]
    worst = {f"{part}.{k}": v for part in ("start_grad", "smooth_pose", "smooth_camera")
             for k, v in c[part].items() if v > 1e-3}
    if c["start_loss_rel"] > 1e-5 or worst:
        fail(f"preprocess: card vs CPU: start loss rel {c['start_loss_rel']}, beyond 1e-3 "
             f"of a leaf's largest entry: {worst}")


def phase_segment_sum_shapes(run_step, per_step: int) -> None:
    """segment_sum at every call site of one stage-2 step: each call's
    (M, C, R, longest run of one key) with its device time (torch.profiler,
    its kernels over 10 launches on the step's own inputs), the time of
    back-to-back calls (CUDA events; the host's dispatch where that is
    longer) and the bound, and their sums."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from harp_tpu_torch.ops import segment as sg
    from harp_tpu_torch.render.kernels import raster_kernel as rk

    calls, original = [], sg.segment_sum

    def recording(values, order):
        calls.append((values, order))
        return original(values, order)

    sg.segment_sum = rk.segment_sum = recording  # the two names the step calls it by
    try:
        run_step()
        torch.cuda.synchronize()
    finally:
        sg.segment_sum = rk.segment_sum = original
    if len(calls) != per_step:
        fail(f"segment_sum_shapes: {len(calls)} calls in a stage-2 step, expected {per_step}")
    rows = []
    for values, order in calls:
        (M, C), R = values.shape, order.num_rows
        events_ms = cuda_ms(lambda: original(values, order), 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                original(values, order)
            torch.cuda.synchronize()
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA) / 1e3 / 10
        b_ms, b_by = bound_ms(M * (C + 2) * 4 + R * C * 4, float(M * C))
        longest = int(torch.bincount(order.key, minlength=R).max())
        rows.append(dict(M=M, C=C, R=R, longest_run=longest, device_ms=device_ms,
                         events_ms=events_ms, bound_ms=b_ms, bound_by=b_by))
    device_sum = sum(r["device_ms"] for r in rows)
    bound_sum = sum(r["bound_ms"] for r in rows)
    emit({"phase": "segment_sum_shapes", "calls": rows, "device_ms_sum": device_sum,
          "events_ms_sum": sum(r["events_ms"] for r in rows), "bound_ms_sum": bound_sum,
          "gap_ms_sum": device_sum - bound_sum})


def phase_profile(run_step, label: str) -> dict:
    """Where one stage-2 step's device time goes (torch.profiler), and the
    device's busy share of the step's wall time. Returns the record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, memcpy, memset): an operator's row
    # repeats the device time of the kernels it launched.
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    # The same device time by the operator that launched it (self: kernels
    # an aten op launched itself, not through the ops it called).
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda r: -r[1])
    rec = {"phase": "profile", "of": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "top": [{"name": k[:80], "self_device_ms": ms, "count": c} for k, ms, c in rows[:15]],
           "top_ops": [{"op": k[:60], "self_device_ms": ms, "count": c}
                       for k, ms, c in ops[:12]]}
    emit(rec)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # cuBLAS with a fixed workspace (read when its handle is made): the
    # products give the same bits from run to run (HTML's basis texture).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # Full float32 products and convolutions (the JAX reference's precision).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase_build()
    phase_device()
    records = phase_kernels(dev)
    phase_vs_cpu(dev)
    seq = flagship_sequence(dev)
    phase_pcf_rounding(dev, seq)
    _, stage2 = phase_step(dev, seq)
    phase_segment_sum_shapes(stage2, 8 + 1)  # a stage-2 step's count (expected_launches)
    del stage2
    # The headline main path: the step with VGG, whose launches the kernels line reports.
    launches, _ = phase_step(dev, seq, vgg_dtype="bfloat16")
    phase_vgg_f32(dev, seq)
    fit = phase_fit(dev, seq)
    # Several sequences and ranks, and the async checkpointer.
    phase_batch_fit(dev, seq)
    phase_mesh_fit(dev, seq, fit)
    phase_orbax_resume(dev, seq, fit)
    del seq, fit
    # The SMPL-X arm at reference density (harp_tpu's value_arm_b18), then
    # HTML and NIMBLE; each path's launches read from its own run.
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    arm_records = phase_kernels(dev, arm=True)
    arm_seq = flagship_sequence(dev, arm=True)
    phase_arm_budget(dev, arm_seq)
    arm_launches, _ = phase_step(dev, arm_seq, arm=True)
    phase_step(dev, arm_seq, vgg_dtype="bfloat16", arm=True)
    del arm_seq
    # The kernels at the arm's shapes, with the launches of its no-VGG step.
    emit({"phase": "arm_kernels", "kernels": [dict({k: rec[k] for k in keys if k != "launches"},
                                                   launches=arm_launches[rec["name"]])
                                              for rec in arm_records]})
    phase_zoo_step(dev)
    phase_arm_fit(dev)
    phase_vs_cpu(dev, arm=True)
    phase_preprocess(dev, phase_real_data(dev))
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
