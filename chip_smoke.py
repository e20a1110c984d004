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
(zoo_step), and the arm fit through the CLI (arm_fit).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout; builds the kernels
into harp_tpu_torch/_build/ on first use. Each phase prints one JSON line;
any failed check raises, so the exit code is non-zero. The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
    from harp_tpu_torch.csrc import build

    out = build.build_all()
    # Each kernel's (mangled) name, then its registers and spills.
    ptxas = [ln.strip() for log in out["logs"].values() for ln in log.splitlines()
             if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": out["seconds"], "ptxas": ptxas})


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
    from harp_tpu_torch.ops import segment as sg
    from harp_tpu_torch.render.kernels import pcf_grad_kernel as pk
    from harp_tpu_torch.render.kernels import raster_kernel as rk

    for d in (rk.LAUNCHES, pk.LAUNCHES, sg.LAUNCHES):
        for k in d:
            d[k] = 0


def read_launches() -> dict:
    from harp_tpu_torch.ops import segment as sg
    from harp_tpu_torch.render.kernels import pcf_grad_kernel as pk
    from harp_tpu_torch.render.kernels import raster_kernel as rk

    return dict(rk.LAUNCHES, **pk.LAUNCHES, **sg.LAUNCHES)


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
    return out["launches"]


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
    phase_fit(dev, seq)
    del seq
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
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in records]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
