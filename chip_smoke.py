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
same bits, and evaluate_sequence on it; the eval's turntables and light
sweep on the fitted parameters (turntables: harp_tpu's JPEG files, the
host encoder's bytes of the card's views, two evals the same bytes, views
in groups the same bits as one at a time, card against CPU; the writing
walls: image_writing; K1 depth-only at their shape, timed against its
bound: turntable_kernels);
the Unscreen crop of eight 1920 x 1080 RGBA frames on the card against the
CPU, its JPEGs decoded through data/dataset.py (crop); the dense raster API
(raster_full, get_ids, rasterize_soft / hard, soft_alpha_fast) at the
step's 18 frames through K1, ids equal to its plain version's, the alpha's
gradient against the CPU's and its distance from K2's (dense_raster); the
eval of the protocol's 36 frames as one CUDA graph (make_eval_program)
against its eager body, bit for bit, with the walls of both, the capture
apart, a second call with other parameters, and K1 at the eval's shape
(eval_program, eval_kernels). Then the SMPL-X arm at reference
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
Then the layer stamp kernel on a card table of the epoch scan's shape,
held to the CPU's stamps, eagerly and replayed from a CUDA graph (stamps).
Then the epoch scan: fit_sequence(epoch_scan=2) as CUDA graphs of the step,
twice, eagerly under --debug-nans' checks, on a one-rank NCCL mesh (all
the same bits) and as the per-step loop (harp_tpu's scan-against-loop
tolerance), with per stage the replayed and eager step times and the
captured graph's kernels by name (epoch_scan); over two NCCL ranks on two
cards where there are two (nccl_scan); the protocol through the CLI at its
defaults, held to harp_tpu's recorded quality (protocol); graft_entry's
forward on the card against the CPU (graft_entry); the port's bench
(harp_tpu_torch.bench: bench.py's four variants and the replayed step,
the roofline, the breakdown) at 3 steps a variant, and the VGG step at
weight 0 beside it (bench).

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
import sys
import time

import numpy as np

from harp_tpu_torch.bench import ARM_BUDGET, HAND_BUDGET, IMG, KERNEL_NAMES, TEX
from harp_tpu_torch.utils.profiling import (
    bound_ms, cuda_ms, device_record, graph_kernel_counts, nbytes, profile_window,
)

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
# IMG, TEX: the image and texture sizes of the flagship fit. The raster
# budgets, the bench's: HAND_BUDGET, and ARM_BUDGET, which the port's CLI
# takes for --use-arm. harp_tpu's CLI defaults (active 0.28, span 3)
# truncate the arm's 18-frame synthetic sequence: its forearm takes up to
# 329 of 784 tiles a frame, and faces span 4 tiles (phase arm_budget reads
# the counters on the card).
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
    with `arm`, of the SMPL-X arm (harp_tpu's value_arm_b18). harp_tpu's
    bench budget (active_fraction 0.28, span_tiles 3) truncates this scene:
    the synthetic sequence's hand (seed 0) occupies up to 275 of 784 tiles
    and has faces wider than 3 tiles, in both packages. The budget is
    widened until every overflow counter is zero (HAND_BUDGET)."""
    from harp_tpu_torch.graft_entry import _build

    return _build(IMG, TEX, n_frames, raster_kw=ARM_BUDGET if arm else HAND_BUDGET,
                  use_arm=arm, device=device)


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
    rec = device_record()
    print(rec["nvidia_smi"], flush=True)
    emit({"phase": "device", **rec})
    return rec["nvidia_smi"]


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


def raster_record(name: str, bins: dict, cfg, soft: bool, blocks_per_sm: int) -> dict:
    """K1 (soft, or depth only) on one raster pass's bins, against its
    plain version (ids equal, soft_sum within rtol 1e-5), timed (ms over
    20 launches, plain_ms over 2 with face_chunk PLAIN_FACE_CHUNK), with
    its work and bound from these inputs: the kernels line's record."""
    import dataclasses

    import torch
    from harp_tpu_torch.render.kernels import raster_kernel as rk

    plain_cfg = dataclasses.replace(cfg, face_chunk=PLAIN_FACE_CHUNK)
    args = (bins["fv9"], bins["s_face"], bins["start_a"], bins["count_a"], bins["act_idx"])
    hard, sid, ssum = rk.raster_ids(*args, cfg, soft)
    hard_p, sid_p, ssum_p = rk.raster_ids_plain(*args, plain_cfg, soft)
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
    plain_ms = cuda_ms(lambda: rk.raster_ids_plain(*args, plain_cfg, soft), 2)
    pairs = float(bins["count_a"].sum()) * cfg.tile * cfg.tile
    outs = [hard] + ([sid, ssum] if soft else [])
    work = raster_work(name, args, cfg, blocks_per_sm)
    covered = float((hard >= 0).sum())
    hits = float((sid >= 0).sum()) if soft else 0.0
    ops = (work["box_tests"] * OPS_BOX
           + work["pairs_kept"] * (OPS_COVER + (OPS_DIST if soft else 0))
           + covered * OPS_DEPTH + hits * OPS_LOGSUM)
    b_ms, b_by = bound_ms(nbytes(*args, *outs), ops)
    bb_ms, bb_by = bound_ms(nbytes(*args, *outs), pairs * (OPS_SOFT if soft else OPS_HARD))
    return dict(name=name, route="cuda", source="harp_tpu_torch/csrc/raster.cu",
                replaces="harp_tpu/render/pallas/raster_kernel.py:65",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, bound_ms_binned=bb_ms,
                bound_by_binned=bb_by, pairs=pairs, covered_pixels=covered,
                soft_ids=hits if soft else None, **work)


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
        rec = raster_record(name, inp[key], inp[cfg_key], soft, occupancy[name])
        if soft:
            hits = rec["soft_ids"]
        records.append(rec)

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


def _composites(img_dir: str) -> int:
    """The eval's composites in img_dir, harp_tpu's names (%04d.jpg from
    0000 up): their count, or -1 when the directory holds anything else."""
    names = sorted(os.listdir(img_dir))
    return len(names) if names == ["%04d.jpg" % i for i in range(len(names))] else -1


def phase_fit(dev, seq) -> dict:
    """fit_sequence at full width (the flagship: 18 frames of 448^2,
    reference density, self-shadow, VGG in bf16 with the cached GT,
    stages 2 / 2 / 2) twice from one seed, then evaluate_sequence on the
    first through an eval program built for it (make_eval_program: the
    call captures its CUDA graph): the loss per epoch, the JSONL's
    overflow counters, IoU / L1 / MS-SSIM. The two fits' final parameters
    must be the same bits, the last epoch's loss below the first's, every
    counter 0, every kernel launched in the fit as many times as its steps
    need, and the eval's kernels by name in a replay as eval_program_kernels
    says. Returns the program too (captured; phase turntables replays it)."""
    import dataclasses
    import tempfile

    import torch
    from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, FitData, fit_sequence
    from harp_tpu_torch.fit.evaluate import evaluate_sequence, make_eval_program
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
                prog, g = make_eval_program(config, seq["assets"], data, seq["rcfg"],
                                            device=dev)
                reset_launches()
                t0 = time.perf_counter()
                stats = evaluate_sequence(config, seq["assets"], data, params, aux,
                                          rcfg=seq["rcfg"], out_dir=out_dir, device=dev,
                                          eval_program=prog)
                eval_s = time.perf_counter() - t0
                eval_launches, _ = eval_program_kernels(prog, params, data, read_launches(),
                                                        "fit")
                n_jpg = _composites(os.path.join(out_dir, "rendered_after_opt"))
                out = {"epoch_losses": losses, "fit_s": fit_s, "launches": launches,
                       "overflow_max": counters, "eval": stats, "eval_s": eval_s,
                       "eval_launches": eval_launches, "eval_groups": B_STEP // g,
                       "eval_jpgs": n_jpg, "vgg_terms": [h.get("vgg") for h in history]}
                if not (0.5 < stats["Silhouette IoU"] <= 1.0 and 0.0 < stats["MS_SSIM"] <= 1.0
                        and np.isfinite(stats["L1"]) and n_jpg == B_STEP):
                    fail(f"fit: eval {stats}, {n_jpg} composites %04d.jpg")
    spread = {k: float((finals[0][k] - finals[1][k]).abs().max()) for k in finals[0]}
    if any(spread.values()):
        fail(f"fit: two fits from one seed differ: {spread}")
    emit({"phase": "fit", "frames": B_STEP, "epochs": config.total_epoch,
          "stages": list(config.training_stage), **out, "fit2_param_max_abs_diff": spread})
    return {"config": config, "params": finals[0], "losses": out["epoch_losses"],
            "launches": out["launches"], "eval_program": prog}


def eval_program_kernels(prog, params, data, capture_launches: dict, phase: str) -> tuple:
    """The kernels of one replay of the eval program `prog` (captured by
    the call whose launch counts are capture_launches: its warm-up group
    and the captured groups, the host calls that recorded the kernels), by
    name among the graph's kernel nodes (graph_kernel_counts: a replay
    passes no launch counter, and a trace can lose records of the first
    replay after the profiler starts). Per group of frames K1 soft runs
    once (the silhouette) and K1 depth three times (the shadow's light,
    the shadowed colour's camera, the normal render's camera), K2 and K3
    never (no backward); every
    kernel runs in the replay as often as the capture recorded it, a
    group's worth less the warm-up's, and appears in a profiled replay's
    trace. Returns (the counts, the profile_window record of the replay,
    whose trace counts it keeps); fails otherwise."""
    from harp_tpu_torch.bench import KERNEL_NAMES

    groups = prog.n // prog.g
    prof = profile_window(lambda: prog(params, data.images, data.masks),
                          kernel_names=KERNEL_NAMES)
    got, _ = graph_kernel_counts(prog.graph, KERNEL_NAMES)
    if any(n and not prof["kernel_counts"][k] for k, n in got.items()):
        fail(f"{phase}: kernels of the eval program's graph absent from the trace of its "
             f"replay: {prof['kernel_counts']}, graph {got}")
    want = {"raster_ids_soft": groups, "raster_ids_depth": 3 * groups, "coverage_grad": 0,
            "pcf_scatter": 0}
    recorded = {k: capture_launches.get(k, 0) * groups // (groups + 1) for k in got}
    if any(got[k] != n for k, n in want.items()) or got != recorded:
        fail(f"{phase}: the eval program's replay ran kernels {got}, expected {want} and "
             f"the capture's {recorded} (of {capture_launches} with its warm-up group)")
    return got, prof


TT_VIEWS = 36  # views per axis of the eval's turntables
TT_LIGHTS = 40  # lights of its sweep
TT_HELD = (0, TT_VIEWS - 1, TT_VIEWS, 2 * TT_VIEWS - 1)  # views 0, 35, h_0, h_35
TT_SHARE = 0.005  # of a view's pixels whose codes may differ card vs CPU (the test's)


def _turntable_cpu_views(params, assets, config, rcfg) -> dict:
    """The views TT_HELD of frame 0's turntables (RGB and normal) and
    lights 0 and TT_LIGHTS - 1 of its sweep on the CPU, by the plain
    versions: viz's carry and renders, rendered only where held (the
    test holds any grouping of views bit-equal)."""
    import dataclasses

    import torch
    from harp_tpu_torch.render import pipeline
    from harp_tpu_torch.utils import viz

    cpu = torch.device("cpu")
    rcfg = dataclasses.replace(rcfg, face_chunk=PLAIN_FACE_CHUNK)
    p = {k: v.detach().to(cpu) for k, v in params.items()}
    held = viz.turntable_verts(p, 0, assets, config, TT_VIEWS)[list(TT_HELD)]
    with torch.no_grad():
        v0, _ = pipeline.mesh_forward(p, torch.tensor([0]), assets, config)
    lights = viz.sweep_lights(TT_LIGHTS)[[0, TT_LIGHTS - 1]]
    out = {"rgb": viz.render_views(p, 0, held, assets, config, rcfg),
           "normal": viz.render_views(p, 0, held, assets, config, rcfg, render_normal=True),
           "light": viz.render_views(p, 0, v0.expand(2, -1, -1), assets, config, rcfg,
                                     lights=lights)}
    return {k: x.numpy() for k, x in out.items()}


def phase_turntables(dev, seq, fit: dict) -> None:
    """The eval's turntables on the fit phase's parameters at 448^2 (every
    tile rasterized, 784 a view, as the eval does): evaluate_sequence with
    turntables=True twice and without once. Each run's files (72 RGB, 72
    normal, 72 combined and 40 light-sweep JPEGs at harp_tpu's names and
    four GIFs) are there, and the two runs' are the same bytes; each frame
    file is the host encoder's bytes (native.jpeg_bytes, Pillow's) of the
    card's view, as the CPU writes that frame, and each combined frame the
    bytes of its two decoded views side by side; the overflow counters are 0 (a
    group whose turned mesh overflows the tile capacity is rendered again
    with a wider one: turntable_rerenders); each eval replays phase fit's
    captured eval program, which launches nothing from the host (its
    kernels are counted by name in phase fit), so the turntables' K1
    depth-only launches are the eval's without them (none) plus one a group
    of eight views (2 x 9 + 5 = 23) plus the rerenders, and nothing else of
    the step's kernels; the RGB and normal turntables rendered eight views
    at a time are the same bits as one view at a time; views 0, 35, h_0, h_35 and
    lights 0 and 39 agree with the CPU's plain versions within the test's
    bound (tests/test_torch_turntables.py: at most 0.5% of a view's pixels
    with other codes). Then K1 depth-only at the turntable's shape (views
    0-7, A = 784, a capacity that truncates nothing) against its plain
    version, timed, with its bound. Line image_writing: the host walls of
    writing the eval's composites and, for the turntables' views, their
    JPEGs, the combination and the four GIFs."""
    import dataclasses
    import tempfile

    import torch
    from harp_tpu_torch.fit.driver import FitData
    from harp_tpu_torch.fit.evaluate import evaluate_sequence
    from harp_tpu_torch.native import jpeg_bytes
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.render import pipeline
    from harp_tpu_torch.render.kernels import raster_kernel as rk
    from harp_tpu_torch.render.rasterizer import raster_compact
    from harp_tpu_torch.render import camera as cam_mod
    from harp_tpu_torch.utils import viz

    config, params, assets = fit["config"], fit["params"], seq["assets"]
    prog = fit["eval_program"]  # captured by phase fit: each eval here only replays it
    data = FitData(seq["images"], seq["masks"], seq["masks_er"])
    _, aux = init_params(seq["init"], assets, config, device=dev)
    subs = {"render_360": [f"{p}{i:04d}.jpg" for p in ("", "h_") for i in range(TT_VIEWS)],
            "render_360_normal": [f"{p}{i:04d}.jpg" for p in ("", "h_") for i in range(TT_VIEWS)],
            "render_360_combine": [f"{i:04d}.jpg" for i in range(2 * TT_VIEWS)],
            "render_360_light": [f"{i:04d}.jpg" for i in range(TT_LIGHTS)]}
    rec = {"phase": "turntables"}
    args = (params, 0, assets, config, eval_rcfg(seq["rcfg"]))
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for name, turn in (("plain", False), ("a", True), ("b", True)):
            out_dir = os.path.join(tmp, name)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = evaluate_sequence(config, assets, data, params, aux, rcfg=seq["rcfg"],
                                      out_dir=out_dir, turntables=turn, device=dev,
                                      eval_program=prog)
            torch.cuda.synchronize()
            runs.append((out_dir, stats, read_launches(), time.perf_counter() - t0))
        (_, base_stats, base, base_s), (a_dir, stats, launches, eval_s), (b_dir, *_) = runs
        if any(base.values()):
            fail(f"turntables: the eval replayed from its graph launched {base} from the host")
        files = {}
        for sub, names in subs.items():
            got = sorted(os.listdir(os.path.join(a_dir, sub)))
            if got != sorted(names + ["out.gif"]):
                fail(f"turntables: {sub} holds {len(got)} files, not {len(names)} + out.gif")
            differ = [n for n in got if open(os.path.join(a_dir, sub, n), "rb").read()
                      != open(os.path.join(b_dir, sub, n), "rb").read()]
            if differ:
                fail(f"turntables: two evals wrote other bytes in {sub}: {differ[:5]}")
            files[sub] = len(got)
        counters = {k: v for k, v in stats.items() if k.startswith("turntable_")}
        extra = {k: launches[k] - base[k] for k in launches}
        want = dict.fromkeys(extra, 0)
        want["raster_ids_depth"] = (2 * -(-2 * TT_VIEWS // 8) + -(-TT_LIGHTS // 8)
                                    + counters.get("turntable_rerenders", 0))
        extra_sum = extra.pop("segment_sum")
        want.pop("segment_sum")
        rec.update({"files": files, "counters": counters, "eval_turntables_s":
                    stats["eval_turntables_s"], "eval_s": eval_s, "eval_without_s": base_s,
                    "extra_launches": dict(extra, segment_sum=extra_sum)})
        overflow = {k: v for k, v in counters.items() if k.endswith("_overflow")}
        if len(overflow) != 3 or any(overflow.values()):
            fail(f"turntables: overflow counters {counters}")
        if extra != want:
            fail(f"turntables: launches beyond the eval's {extra}, expected {want}")

        # The card's views, and the files: the host encoder's bytes of them.
        views = {}
        for normal in (False, True):
            one = viz.turntable_views(*args, normal, TT_VIEWS, chunk=1)
            eight = viz.turntable_views(*args, normal, TT_VIEWS, chunk=8)
            if not torch.equal(one, eight):
                fail(f"turntables: {'normal' if normal else 'RGB'} views in groups of eight "
                     f"differ from one at a time in {int((one != eight).any(-1).sum())} pixels")
            views["render_360_normal" if normal else "render_360"] = eight.cpu().numpy()
        views["render_360_light"] = viz.light_sweep_views(*args, num=TT_LIGHTS).cpu().numpy()
        t0 = time.perf_counter()
        other = [f"{sub}/{n}" for sub, v in views.items() for n, img in zip(subs[sub], v)
                 if open(os.path.join(a_dir, sub, n), "rb").read() != jpeg_bytes(img, 75)]
        for i, n in enumerate(subs["render_360_combine"]):
            side = np.concatenate([viz.read_rgb(os.path.join(a_dir, sub, subs[sub][i]))
                                   for sub in ("render_360", "render_360_normal")], 1)
            if open(os.path.join(a_dir, "render_360_combine", n), "rb").read() != jpeg_bytes(
                    side, 75):
                other.append(f"render_360_combine/{n}")
        rec["files_check_s"] = time.perf_counter() - t0
        if other:
            fail(f"turntables: files that are not the host encoder's bytes of the card's "
                 f"views: {other[:5]} ({len(other)})")

        # The host walls of writing what the eval writes, apart.
        write = os.path.join(tmp, "write")
        comps = prog(params, data.images, data.masks)[4].cpu().numpy()
        t0 = time.perf_counter()
        viz.save_images_parallel((c, os.path.join(write, "comp", "%04d.jpg" % f))
                                 for f, c in enumerate(comps))
        walls = {"eval_composites_jpg_s": time.perf_counter() - t0,
                 "eval_composites_s": base_stats["eval_composites_s"]}
        for sub in ("render_360", "render_360_normal", "render_360_light"):
            t0 = time.perf_counter()
            viz.save_images_parallel((img, os.path.join(write, sub, n))
                                     for n, img in zip(subs[sub], views[sub]))
            walls[sub + "_jpg_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            viz.save_gif(os.path.join(write, sub), os.path.join(write, sub, "out.gif"))
            walls[sub + "_gif_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        viz.concat_image_dirs(os.path.join(write, "render_360"),
                              os.path.join(write, "render_360_normal"),
                              os.path.join(write, "render_360_combine"))
        walls["render_360_combine_s"] = time.perf_counter() - t0
        walls["turntables_writing_s"] = sum(v for k, v in walls.items()
                                            if k.startswith("render_360"))
    emit({"phase": "image_writing", "frames": int(comps.shape[0]),
          "size": list(comps.shape[1:3]), **walls,
          "eval_turntables_s": stats["eval_turntables_s"]})
    t0 = time.perf_counter()
    cpu = _turntable_cpu_views(params, assets, config, eval_rcfg(seq["rcfg"]))
    rec["cpu_views_s"] = time.perf_counter() - t0
    shares = {}
    for key, sub, idx in (("rgb", "render_360", TT_HELD), ("normal", "render_360_normal", TT_HELD),
                          ("light", "render_360_light", (0, TT_LIGHTS - 1))):
        shares[key] = [float((a != b).any(-1).mean())
                       for a, b in zip(views[sub][list(idx)], cpu[key])]
    rec["card_vs_cpu_pixel_share"] = shares
    if max(max(v) for v in shares.values()) > TT_SHARE:
        fail(f"turntables: card vs CPU beyond {TT_SHARE} of a view's pixels: {shares}")

    # K1 depth-only at the turntable's shape: views 0..7 of the RGB turntable,
    # with a tile capacity that truncates nothing.
    rcfg = dataclasses.replace(eval_rcfg(seq["rcfg"]), cap=len(assets.render_faces))
    with torch.no_grad():
        fids = torch.tensor([0], device=dev)
        vb = viz.turntable_verts(params, 0, assets, config, TT_VIEWS)[:8]
        R, T = pipeline.camera_for_frames(params, fids, config)
        screen = cam_mod.screen_from_world(vb, R.expand(8, 3, 3), T.expand(8, 3),
                                           config.focal_length, config.img_size)
        bins = raster_compact(screen, assets.render_faces, rcfg, need_soft=False)["bins"]
    k1 = raster_record("raster_ids_depth", bins, rcfg, False,
                       rk.blocks_per_sm(rcfg.tile)["raster_ids_depth"])
    k1.update(launches=extra["raster_ids_depth"], views=8, active_tiles=int(bins["act_idx"].shape[1]))
    rec["k1_depth_max_faces_in_a_tile"] = int(bins["count_a"].max())
    rec["k1_depth"] = k1
    emit(rec)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"phase": "turntable_kernels", "kernels": [{k: k1[k] for k in keys}]})
    prog.close()


def _same_outputs(a, b) -> bool:
    """Two eval program results (harp_tpu's six outputs and the overflow
    counters) the same bits."""
    import torch

    return (all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))
            and a[6].keys() == b[6].keys() and all(torch.equal(a[6][k], b[6][k]) for k in a[6]))


EVAL_FRAMES = 36  # the protocol's sequence


def phase_eval_program(dev) -> None:
    """make_eval_program at the protocol's size: the flagship hand's
    36-frame sequence (seed 0), 448^2, B18 parameters (the fit's initial
    ones, then the GT pose, camera and appearance), groups of 6 frames.
    The same program eagerly (graph=False) and as one CUDA graph: the
    eager pass's wall (first and second call), the graph's first call
    (warm-up group, capture, replay) with capture_s apart, and the two
    calls after it (a replay each, the second with other parameters); the
    graph's outputs (metrics, uint8 composites, vertices, counters) the
    same bits as the eager body's for the initial parameters and, after
    the copy-in, for the GT ones, whose metrics differ from the initial
    ones'; K1 found by name in a profiled replay (eval_program_kernels),
    and the eager pass profiled beside it (busy ms); the peak memory of
    the eager pass's first call and of the graph's (its pool); every
    overflow counter 0. Then K1 soft and depth only at the eval's shape
    (one group's camera pass, every tile active) against its plain
    version, timed, with its bound and its launches an eval
    (eval_kernels)."""
    import torch
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.fit.driver import FitData
    from harp_tpu_torch.fit.evaluate import make_eval_program
    from harp_tpu_torch.fit.params import init_params

    assets, config, rcfg, _ = flagship(EVAL_FRAMES, dev)
    images, masks, masks_er, gt, init = make_synthetic_sequence(
        assets, config, rcfg, n_frames=EVAL_FRAMES, seed=0, device=dev)
    data = FitData(images, masks, masks_er)
    p_init, _ = init_params(init, assets, config, device=dev)
    p_gt = {k: (gt[k] if k in gt and gt[k].shape == v.shape else v).detach().clone()
            for k, v in p_init.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    eager, g = make_eval_program(config, assets, data, rcfg, device=dev, graph=False)
    prog, _ = make_eval_program(config, assets, data, rcfg, device=dev)
    groups = EVAL_FRAMES // g
    rec = {"phase": "eval_program", "frames": EVAL_FRAMES, "group": g, "groups": groups}
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    reset_launches()
    e_init, rec["eager_first_s"] = timed(lambda: eager(p_init, images, masks))
    eager_launches = read_launches()
    rec["eager_peak_gib_above_base"] = torch.cuda.max_memory_allocated() / 2**30 - base_gib
    e_init2, rec["eager_s"] = timed(lambda: eager(p_init, images, masks))
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    reset_launches()
    g_init, rec["graph_first_call_s"] = timed(lambda: prog(p_init, images, masks))
    capture_launches = read_launches()
    rec["capture_s"] = prog.capture_s
    rec["graph_peak_gib_above_base"] = torch.cuda.max_memory_allocated() / 2**30 - base_gib
    g_init2, rec["first_replay_s"] = timed(lambda: prog(p_init, images, masks))
    g_gt, rec["second_replay_other_params_s"] = timed(lambda: prog(p_gt, images, masks))
    e_gt, rec["eager_other_params_s"] = timed(lambda: eager(p_gt, images, masks))
    rec["eager_launches"] = eager_launches
    rec["capture_launches"] = capture_launches
    for name, a, b in (("eager twice", e_init, e_init2), ("graph vs eager", g_init, e_init),
                       ("graph twice", g_init, g_init2),
                       ("graph vs eager, other parameters", g_gt, e_gt)):
        if not _same_outputs(a, b):
            fail(f"eval_program: {name}: outputs differ "
                 f"(metrics max {float((torch.stack(a[:4]) - torch.stack(b[:4])).abs().max())}, "
                 f"composite codes {int((a[4] != b[4]).sum())})")
    per_group = {k: v // groups for k, v in eager_launches.items()}
    if any(eager_launches[k] != per_group[k] * groups or capture_launches[k] != per_group[k]
           * (groups + 1) for k in eager_launches):
        fail(f"eval_program: eager launches {eager_launches}, capture's {capture_launches}")
    metrics = {}
    for name, out in (("init", g_init), ("gt", g_gt)):
        m = torch.stack(out[:4]).double().mean(1).cpu().tolist()
        metrics[name] = dict(zip(("iou", "l1", "perc", "msss"), m))
        overflow = {k: int(v) for k, v in out[6].items()}
        if any(overflow.values()) or not all(np.isfinite(m)):
            fail(f"eval_program: {name}: metrics {m}, overflow {overflow}")
    rec["metrics"] = metrics
    if metrics["init"] == metrics["gt"] or not 0.5 < metrics["gt"]["iou"] <= 1.0:
        fail(f"eval_program: metrics {metrics}")
    counts, prof = eval_program_kernels(prog, p_gt, data, capture_launches, "eval_program")
    rec["replay_kernels"] = counts
    rec["replay_trace_kernels"] = prof["kernel_counts"]
    rec["replay_profile"] = {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                  "device_busy_share", "top")}
    eprof = profile_window(lambda: eager(p_gt, images, masks))
    rec["eager_profile"] = {k: eprof[k] for k in ("wall_ms", "device_busy_ms",
                                                  "device_busy_share")}
    eager.close()
    prog.close()
    emit(rec)

    # K1 at the eval's shape: the camera pass of the first group (every
    # tile active), soft (the silhouette) and depth only (the colour and
    # normal renders), with the launches of one eval.
    from harp_tpu_torch.render import camera as cam_mod
    from harp_tpu_torch.render import pipeline
    from harp_tpu_torch.render.kernels import raster_kernel as rk
    from harp_tpu_torch.render.rasterizer import raster_compact

    ercfg = eval_rcfg(rcfg)
    with torch.no_grad():
        fids = torch.arange(g, device=dev)
        verts, _ = pipeline.mesh_forward(p_gt, fids, assets, config)
        Rm, T = pipeline.camera_for_frames(p_gt, fids, config)
        screen = cam_mod.screen_from_world(verts, Rm, T, config.focal_length, config.img_size)
        bins = raster_compact(screen, assets.render_faces, ercfg)["bins"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    occupancy = rk.blocks_per_sm(ercfg.tile)
    kernels = []
    for name, soft in (("raster_ids_soft", True), ("raster_ids_depth", False)):
        k1 = raster_record(name, bins, ercfg, soft, occupancy[name])
        k1["launches"] = counts[name]
        kernels.append({k: k1[k] for k in keys})
    emit({"phase": "eval_kernels", "frames": g, "active_tiles": int(bins["act_idx"].shape[1]),
          "kernels": kernels})


def phase_dense_raster(dev, seq) -> None:
    """The dense raster API on the flagship's 18 frames at 448^2 (the GT
    parameters, the step's raster budget): raster_camera_view (raster_full
    soft + hard), get_ids, rasterize_hard (depth only), rasterize_soft and
    soft_alpha_fast's gradient, driven with the launch counts at 0 (K1
    soft 3, K1 depth 1, nothing else); every id the same as K1's plain
    version (raster_ids_plain on the same bins, scattered alike), soft_sum
    within rtol 1e-5; soft_alpha_fast's gradient on the card within 1e-4
    of the largest entry of the CPU's (the same ids); its distance from
    K2's all-faces gradient (soft_alpha_fast_pack) as a number, with the
    pixels whose K id slots are all filled; raster_full's ms beside
    raster_compact's (the scatter), and the gradient's ms."""
    import dataclasses

    import torch
    from harp_tpu_torch.render import pipeline
    from harp_tpu_torch.render import rasterizer as R
    from harp_tpu_torch.render.kernels import raster_kernel as rk

    assets, config, rcfg = seq["assets"], seq["config"], seq["rcfg"]
    faces = assets.render_faces
    fids = torch.arange(B_STEP, device=dev)
    with torch.no_grad():
        verts, _ = pipeline.mesh_forward(seq["gt"], fids, assets, config)
        Rm, T = pipeline.camera_for_frames(seq["gt"], fids, config)
    gen = torch.Generator(device=dev).manual_seed(0)

    def alpha_grad(ids, ssum, screen, g):
        v = screen.detach().requires_grad_(True)
        alpha = R.soft_alpha_fast(ids, ssum, v, faces, rcfg)
        return torch.autograd.grad((alpha * g).sum(), v)[0]

    reset_launches()
    screen, full = pipeline.raster_camera_view(verts, assets, Rm, T, config, rcfg)
    soft, hard = R.get_ids(screen, faces, rcfg)
    hard_only = R.rasterize_hard(screen, faces, rcfg)
    soft_only = R.rasterize_soft(screen, faces, rcfg)
    g = torch.randn(full["soft_sum"].shape, generator=gen, device=dev)
    grad = alpha_grad(full["soft_ids"], full["soft_sum"], screen, g)
    torch.cuda.synchronize()
    launches = read_launches()
    want = {"raster_ids_soft": 3, "raster_ids_depth": 1, "coverage_grad": 0, "pcf_scatter": 0}
    if any(launches[k] != n for k, n in want.items()):
        fail(f"dense_raster: launches {launches}, expected {want}")
    rec = {"phase": "dense_raster", "frames": B_STEP, "launches": launches,
           "overflow": {k: int(full[k].sum()) for k in R.OVERFLOW}}
    if any(rec["overflow"].values()):
        fail(f"dense_raster: overflow {rec['overflow']}")

    out = R.raster_compact(screen, faces, rcfg)
    b, act = out["bins"], out["act_idx"]
    args = (b["fv9"], b["s_face"], b["start_a"], b["count_a"], b["act_idx"])
    hard_p, soft_p, ssum_p = rk.raster_ids_plain(
        *args, dataclasses.replace(rcfg, face_chunk=PLAIN_FACE_CHUNK), True)
    plain = {"soft_ids": R.scatter_tiles(soft_p, act, rcfg, -1),
             "soft_sum": R.scatter_tiles(ssum_p, act, rcfg, 0.0),
             "hard_ids": R.scatter_tiles(hard_p, act, rcfg, -1)}
    for name, got, key in (("raster_full soft", full["soft_ids"], "soft_ids"),
                           ("raster_full hard", full["hard_ids"], "hard_ids"),
                           ("get_ids soft", soft, "soft_ids"), ("get_ids hard", hard, "hard_ids"),
                           ("rasterize_hard", hard_only, "hard_ids"),
                           ("rasterize_soft", soft_only, "soft_ids")):
        if not torch.equal(got, plain[key]):
            fail(f"dense_raster: {name}: {int((got != plain[key]).sum())} ids differ from "
                 f"the plain version's")
    if not torch.allclose(full["soft_sum"], plain["soft_sum"], rtol=1e-5, atol=1e-6):
        fail(f"dense_raster: soft_sum beyond rtol 1e-5 of the plain version's")
    rec["soft_sum_max_abs_err"] = float((full["soft_sum"] - plain["soft_sum"]).abs().max())
    del plain, hard_p, soft_p, ssum_p

    t0 = time.perf_counter()
    grad_cpu = alpha_grad(full["soft_ids"].cpu(), full["soft_sum"].cpu(), screen.cpu(), g.cpu())
    rec["cpu_grad_s"] = time.perf_counter() - t0
    scale = float(grad_cpu.abs().max())
    rec["grad_vs_cpu_max_abs"] = float((grad.cpu() - grad_cpu).abs().max())
    rec["grad_max_abs"] = scale
    if not (scale > 0 and rec["grad_vs_cpu_max_abs"] <= 1e-4 * scale):
        fail(f"dense_raster: soft_alpha_fast's gradient card vs CPU "
             f"{rec['grad_vs_cpu_max_abs']} of {scale}")
    vk = screen.detach().requires_grad_(True)
    ak = R.soft_alpha_fast_pack(out["soft_sum"], b, vk, assets.sub_topology.corners, rcfg)
    (grad_k2,) = torch.autograd.grad((ak * R.gather_tiles(g, act, rcfg)).sum(), vk)
    diff = (grad_k2 - grad).abs()
    rec["k2_vs_k_ids"] = {"max_abs": float(diff.max()), "max_rel": float(diff.max()) / scale,
                          "verts_beyond_1e-4": int((diff.amax(-1) > 1e-4 * scale).sum()),
                          "pixels_with_k_ids": int((full["soft_ids"][..., -1] >= 0).sum())}
    rec["raster_full_ms"] = cuda_ms(lambda: R.raster_full(screen, faces, rcfg), 5)
    rec["raster_compact_ms"] = cuda_ms(lambda: R.raster_compact(screen, faces, rcfg), 5)
    rec["soft_alpha_fast_grad_ms"] = cuda_ms(
        lambda: alpha_grad(full["soft_ids"], full["soft_sum"], screen, g), 3)
    emit(rec)


def eval_rcfg(rcfg):
    """The eval's raster budget: every tile of the image."""
    import dataclasses

    return dataclasses.replace(rcfg, active_fraction=1.0)


def png_all_paeth(arr: np.ndarray) -> bytes:
    """(H, W, C) uint8 as a PNG whose every row has filter 4 (Paeth), the
    filter whose undoing costs the most (the port's writer, as Pillow's,
    chooses a filter per row)."""
    import struct
    import zlib

    from harp_tpu_torch.utils.viz import _chunk

    h, w, c = arr.shape
    x = arr.reshape(h, w * c).astype(np.int64)
    a = np.zeros_like(x)
    a[:, c:] = x[:, :-c]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, c:] = x[:-1, :-c]
    p = a + b - cc
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    rows = np.concatenate([np.full((h, 1), 4), (x - pred) & 0xFF], 1).astype(np.uint8)
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


CROP_FRAMES = 8  # unscreen frames of phase crop
CROP_H, CROP_W = 1920, 1080  # a phone's portrait frame


def phase_crop(dev, seq) -> None:
    """The Unscreen crop on the card: eight 1920 x 1080 RGBA frames (the
    synthetic sequence's 448^2 renders scaled to 1080^2 and centred, alpha
    = the soft silhouette) and their originals (the same hand over a
    gradient), written as PNG by the port's writer;
    crop_unscreen_sequence on the card (resample in int64, nvJPEG at
    quality 95), then crop_frame on the card and on the CPU: the same
    bits before encoding; the JPEGs decoded through data/dataset.py
    (load_sequences, with METRO pkls of the sequence's start) within a
    mean of 0.015 of those arrays; crop_unscreen_sequence on the CPU writes
    the host encoder's bytes of the card's crops. Seconds per frame of the
    crop, and of decode_png (the native decoder) and read_rgba alone on a
    frame as the port writes it (Pillow's adaptive filters) and with every
    row Paeth-filtered."""
    import tempfile

    import torch
    import torch.nn.functional as F
    from harp_tpu_torch.data.dataset import load_sequences, save_frame_pkl
    from harp_tpu_torch.native import jpeg_bytes
    from harp_tpu_torch.preprocess.crop import crop_frame, crop_unscreen_sequence
    from harp_tpu_torch.utils import viz

    n = CROP_FRAMES
    rgb = F.interpolate(seq["images"][:n].permute(0, 3, 1, 2), size=(CROP_W, CROP_W),
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    alpha = F.interpolate(seq["masks"][:n, None], size=(CROP_W, CROP_W), mode="bilinear",
                          align_corners=False)[:, 0]
    top = (CROP_H - CROP_W) // 2
    yy = torch.linspace(0, 1, CROP_H, device=dev)[:, None, None]
    xx = torch.linspace(0, 1, CROP_W, device=dev)[None, :, None]
    back = torch.cat([0.3 + 0.5 * yy * xx.new_ones(1, CROP_W, 1),
                      0.6 - 0.4 * xx * yy.new_ones(CROP_H, 1, 1),
                      0.2 + 0.3 * yy * xx], -1)
    rec = {"phase": "crop", "frames": n, "size": [CROP_H, CROP_W]}
    with tempfile.TemporaryDirectory() as tmp:
        un, ori = os.path.join(tmp, "unscreen"), os.path.join(tmp, "ori")
        os.makedirs(un)
        os.makedirs(ori)
        t0 = time.perf_counter()
        for i in range(n):
            a = torch.zeros(CROP_H, CROP_W, device=dev)
            a[top:top + CROP_W] = alpha[i]
            fg = back.clone()
            fg[top:top + CROP_W] = rgb[i]
            orig = fg * a[..., None] + back * (1 - a[..., None])
            rgba = torch.cat([fg, a[..., None]], -1)
            for img, d in ((rgba, un), (orig, ori)):
                u8 = (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
                with open(os.path.join(d, "%04d.png" % i), "wb") as f:
                    f.write(viz.encode_png(u8))
        rec["write_png_s"] = time.perf_counter() - t0
        with open(os.path.join(un, "0000.png"), "rb") as f:
            data = f.read()
        frame0 = viz.decode_png(data)
        paeth = png_all_paeth(frame0)
        rec["decode_png_s"], rec["read_rgba_s"] = {}, {}
        for name, blob in (("filter_0", data), ("filter_4", paeth)):
            viz.decode_png(blob)  # the native library built and loaded
            t0 = time.perf_counter()
            got = viz.decode_png(blob)
            rec["decode_png_s"][name] = time.perf_counter() - t0
            t0 = time.perf_counter()
            rgba = viz._png_convert(blob, "RGBA")
            rec["read_rgba_s"][name] = time.perf_counter() - t0
            if not (np.array_equal(got, frame0) and np.array_equal(rgba, frame0)):
                fail(f"crop: decode_png of the {name} frame differs")
        root = os.path.join(tmp, "seq")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = crop_unscreen_sequence(un, os.path.join(root, "1"), ori_img_dir=ori, device=dev)
        torch.cuda.synchronize()
        rec["crop_s_per_frame"] = (time.perf_counter() - t0) / n
        if count != n:
            fail(f"crop: {count} frames cropped of {n}")
        card, host, bad = [], [], []
        t0 = time.perf_counter()
        for i in range(n):
            paths = (os.path.join(un, "%04d.png" % i), os.path.join(ori, "%04d.png" % i))
            c = crop_frame(*paths, device=dev)
            h = crop_frame(*paths, device="cpu")
            if not all(torch.equal(x.cpu(), y) for x, y in zip(c, h)):
                bad.append(i)
            card.append(c)
            host.append(h)
        rec["card_and_cpu_crop_s"] = time.perf_counter() - t0
        if bad:
            fail(f"crop: frames {bad} differ between the card and the CPU before encoding")
        # The CPU's crop writes its JPEGs on the host (Pillow's bytes): the
        # host encoder's bytes of the card's crops, frame for frame.
        cpu_root = os.path.join(tmp, "cpu")
        crop_unscreen_sequence(un, cpu_root, ori_img_dir=ori, device="cpu")
        other = [i for i, (rgb_i, mask_i) in enumerate(card)
                 if open(os.path.join(cpu_root, "unscreen_cropped", "%04d.jpg" % i), "rb").read()
                 != jpeg_bytes(rgb_i.cpu().numpy(), 95)
                 or open(os.path.join(cpu_root, "mask", "%04d_mask.jpg" % i), "rb").read()
                 != jpeg_bytes(mask_i.cpu().numpy(), 95)]
        if other:
            fail(f"crop: the CPU's JPEGs of frames {other} are not the host bytes of the "
                 "card's crops")
        init = {k: np.asarray(v)[:n] if np.ndim(v) and np.shape(v)[0] == B_STEP else np.asarray(v)
                for k, v in seq["init"].items()}
        init["verts"] = np.zeros((n, 1, 3), np.float32)
        os.makedirs(os.path.join(root, "1", "metro_mano_smooth"))
        for i in range(n):
            save_frame_pkl(os.path.join(root, "1", "metro_mano_smooth", "%04d_mano.pkl" % i),
                           init, i)
        _, images, masks, _ = load_sequences(root, root, ["1"], device=dev)
        want_img = torch.stack([c[0] for c in card]).float() / 255.0
        want_mask = torch.stack([c[1] for c in card]).float() / 255.0
        err = {"image_mean_abs": float((images - want_img).abs().mean()),
               "mask_mean_abs": float((masks - want_mask).abs().mean())}
        rec.update(decode_err=err, mask_mean=float(want_mask.mean()))
        emit(rec)
        if max(err.values()) >= 0.015 or not 0.02 < rec["mask_mean"] < 0.9:
            fail(f"crop: decoded frames beyond 0.015 ({err}) or a mask of mean {rec['mask_mean']}")


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
                "--no-turntables", "--out", tmp]
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
        n_jpg = _composites(os.path.join(tmp, "rendered_after_opt"))
    losses = [r["loss"] for r in epochs]
    counters = {k: max(r.get(k, 0.0) for r in epochs) for k in OVERFLOW_KEYS}
    missing = [k for k in OVERFLOW_KEYS if k not in epochs[2]]
    unused = [k for k, v in launches.items() if v == 0]
    record = {"phase": "arm_fit", "argv": argv, "epoch_losses": losses,
              "overflow_max": counters, "launches": launches, "cli_wall_s": wall_s,
              "eval_jpgs": n_jpg, **{k: stats.get(k) for k in (
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
            and np.isfinite(stats["L1"]) and n_jpg == B_STEP):
        fail(f"arm_fit: eval {stats}, {n_jpg} composites %04d.jpg")


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
                str(TEX), "--stages", "2", "2", "2", "--epochs", "7", "--no-turntables"]
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
            # Epoch 0's logs, written at the end of its segment, epochs 0 and 1
            # (the CLI's --epoch-scan 10 within stage 1's two epochs).
            logs = [n for n in ("sil_0001.jpg", "0001.jpg", "val_0001.jpg", "uv_0001.jpg",
                                "normal_0001.jpg") if os.path.exists(os.path.join(out, n))]
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


SCAN_STAGES = (3, 3, 3)  # epochs of phase epoch_scan's stages (one step each)
SCAN_TIMED = 12  # steps of each stage timed eagerly and replayed
SCAN_PROFILED = 3  # replayed steps of each stage's profiled segment
# KERNEL_NAMES: the kernels by the names the profiler gives them (csrc/).
# harp_tpu's scan-against-loop tolerance (tests/test_fit_e2e.py): epoch
# loss rtol 5e-5 inside the first segment, 1e-2 after; parameters rtol
# 2e-3, atol epochs * 2 * lr + 2e-6.
SCAN_LOSS_RTOL = (5e-5, 1e-2)


def _metric_lines(out_dir: str) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "loss" in r]


@contextlib.contextmanager
def _plain_adams():
    """fit_sequence's two Adams as they were before the epoch scan: plain
    (not capturable), the coarse lr a float set from the host."""
    import torch
    from harp_tpu_torch.fit import driver
    from harp_tpu_torch.fit.optimizer import group_param_names

    def build(params, config):
        lrs = {"coarse": config.lr_pose, "app": config.lr_app}
        return {g: torch.optim.Adam([params[k] for k in names], lr=lrs[g])
                for g, names in group_param_names(config).items()}

    original = driver.build_optimizers
    driver.build_optimizers = build
    try:
        yield
    finally:
        driver.build_optimizers = original


STAMP_ROWS = (10, 2)  # the benchmark's segments: epoch_scan 10 epochs of 2 steps


def phase_stamps(dev) -> None:
    """The layer stamp kernel (csrc/stamp.cu through utils/profiling.
    StepStamps) on a card table of the epoch scan's shape (epochs x steps,
    len(STAMP_SLOTS)), held to StepStamps on a CPU table, with a guard row
    on each side of the card's. (a) With the device cursor at rows 0, 7 and
    the last, each slot alone: the card writes the one cell [cursor, slot],
    as the CPU does, and nothing else, guard rows included. (b) A row's nine
    slots in their order, with a product between two: non-decreasing, and
    increasing across the product. (c) Captured into a CUDA graph with the
    scan's cursor advance and replayed once a row: every row's slots
    written and non-decreasing, each row's start at or after the previous
    row's end, the guard rows untouched."""
    import torch
    from harp_tpu_torch.utils.profiling import STAMP_SLOTS, StepStamps

    rows, ncols = STAMP_ROWS[0] * STAMP_ROWS[1], len(STAMP_SLOTS)
    buf = torch.zeros(rows + 2, ncols, dtype=torch.int64, device=dev)
    table = buf[1:rows + 1]
    cursor = torch.zeros(1, dtype=torch.int64, device=dev)
    cpu = torch.zeros(rows, ncols, dtype=torch.int64)
    cpu_cursor = torch.zeros(1, dtype=torch.int64)
    card, host = StepStamps(table, cursor), StepStamps(cpu, cpu_cursor)
    cells = 0
    for r in (0, 7, rows - 1):
        for slot in STAMP_SLOTS:
            buf.zero_()
            cpu.zero_()
            cursor.fill_(r)
            cpu_cursor.fill_(r)
            card(slot)
            host(slot)
            written = (buf != 0).cpu()
            if not (torch.equal(written[1:rows + 1], cpu != 0)
                    and int(written.sum()) == 1 and not written[[0, -1]].any()):
                fail(f"stamps: row {r} slot {slot}: the card wrote "
                     f"{written.nonzero().tolist()} (table rows from 1), the CPU "
                     f"{(cpu != 0).nonzero().tolist()}")
            cells += 1
    a = torch.randn(2048, 2048, device=dev)
    buf.zero_()
    cursor.fill_(3)
    for i, slot in enumerate(STAMP_SLOTS):
        card(slot)
        if i == 4:
            a = a @ a / 64
    t = table[3].cpu()
    if not ((t > 0).all() and (t[1:] >= t[:-1]).all() and t[5] > t[4]):
        fail(f"stamps: a row in slot order is not non-decreasing: {t.tolist()}")
    buf.zero_()
    cursor.zero_()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # the product's workspace, before the capture
        b = a @ a
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i, slot in enumerate(STAMP_SLOTS):
            card(slot)
            if i == 4:
                b = a @ a
        cursor.add_(1)
    buf.zero_()  # the capture ran nothing
    cursor.zero_()
    for _ in range(rows):
        graph.replay()
    torch.cuda.synchronize(dev)
    t = buf.cpu()
    tab = t[1:rows + 1]
    ok = ((tab > 0).all() and (tab[:, 1:] >= tab[:, :-1]).all()
          and (tab[1:, 0] >= tab[:-1, -1]).all() and not t[[0, -1]].any()
          and int(cursor.item()) == rows)
    if not ok:
        fail(f"stamps: the replayed graph's table {t.tolist()}, cursor {int(cursor.item())}")
    step_us = (tab[:, -1] - tab[:, 0]).double() / 1e3
    emit({"phase": "stamps", "table": [rows, ncols], "cells_checked": cells,
          "graph_rows": rows, "replayed_row_us": {"min": float(step_us.min()),
                                                  "max": float(step_us.max())}})


def phase_epoch_scan(dev, seq) -> None:
    """harp_tpu's epoch scan as CUDA graphs of the step (fit_sequence(
    epoch_scan=2)) on the flagship (18 frames of 448^2, one step an epoch,
    reference density, self-shadow, VGG bf16 from the cached GT), stages
    3 / 3 / 3: each stage a segment of two epochs (warm-up, capture,
    replay) and one of one (replay). Four fits from one seed: the graph
    twice (the same bits), the same segments eagerly on the card under
    --debug-nans' checks (utils/debug_nans.DebugNans on every op and
    kernel, and anomaly mode: "graph": false; no NaN, and the same bits as
    the graph), the per-step loop (within harp_tpu's scan-against-loop
    tolerance), and the graph on a one-rank NCCL mesh (the same bits).
    Every overflow counter 0. Then per stage, on a fresh state: the step
    timed eagerly and replayed (SCAN_TIMED steps each, CUDA-synchronised
    host clock), and one replayed segment of SCAN_PROFILED steps under
    torch.profiler (profile_window): the captured graph's kernel nodes by
    name (utils/profiling.graph_kernel_counts, read through the driver
    API from the kept cudaGraph_t) times the replays must be the per-step launches times the steps,
    and each of those kernels must appear in the trace of the replays
    (whose own counts are recorded: a trace can lose an activity record),
    with its device-busy ms and idle gaps. And the per-step loop with
    the plain Adams of before (not capturable): how far the capturable
    Adams moved the loop's bits (numbers only)."""
    import dataclasses
    import tempfile

    import torch
    from harp_tpu_torch.fit.driver import (
        OVERFLOW_KEYS, FitData, _key_stream_np, fit_sequence, make_epoch_scan, make_train_step,
    )
    from harp_tpu_torch.fit.optimizer import DevicePlateau, PlateauState
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.parallel import make_mesh
    from harp_tpu_torch.render import pipeline
    from harp_tpu_torch.utils.debug_nans import DebugNans

    base, vgg, aux_gt, _ = vgg_setup(seq, dev, "bfloat16")
    config = dataclasses.replace(base, training_stage=SCAN_STAGES, total_epoch=sum(SCAN_STAGES))
    data = FitData(seq["images"], seq["masks"], seq["masks_er"])
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, scan, anomaly, mesh in (("graph", 2, False, False), ("graph2", 2, False, False),
                                          ("eager", 2, True, False), ("loop", 0, False, False),
                                          ("nccl1", 2, False, True),
                                          ("loop_plain_adam", 0, False, False)):
            params, aux = init_params(seq["init"], seq["assets"], config, device=dev)
            out_dir = os.path.join(tmp, name)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.autograd.set_detect_anomaly(anomaly), contextlib.ExitStack() as stack:
                if anomaly:  # --debug-nans' checks: every op's outputs, and anomaly mode
                    stack.enter_context(DebugNans())
                m = stack.enter_context(make_mesh(1, device=dev)) if mesh else None
                if name == "loop_plain_adam":  # the Adams before they were capturable
                    stack.enter_context(_plain_adams())
                params, history = fit_sequence(config, seq["assets"], data, params, aux,
                                               rcfg=seq["rcfg"], vgg=vgg, out_dir=out_dir,
                                               device=dev, epoch_scan=scan, mesh=m)
            torch.cuda.synchronize()
            runs[name] = {"params": {k: p.detach().clone() for k, p in params.items()},
                          "losses": [h["loss"] for h in history],
                          "fit_s": time.perf_counter() - t0,
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                          "lines": _metric_lines(out_dir)}
    g = runs["graph"]
    seg = [r for r in g["lines"] if "segment_s" in r]
    capture_s = [r["capture_s"] for r in g["lines"] if "capture_s" in r]
    counters = {k: max(r.get(k, 0.0) for r in g["lines"]) for k in OVERFLOW_KEYS}
    differ = {name: _differ(runs[name]["params"], g["params"])
              for name in ("graph2", "eager", "nccl1")}
    lr = max(config.lr_pose, config.lr_app)
    loop_err = {k: float((g["params"][k] - p).abs().max())
                for k, p in runs["loop"]["params"].items()}
    loop_loss_rel = [abs(a - b) / abs(b) for a, b in zip(g["losses"], runs["loop"]["losses"])]
    # What the capturable Adams moved in the per-step loop's bits.
    plain = runs["loop_plain_adam"]
    adam_moved = {"param_max_abs": {k: float((runs["loop"]["params"][k] - p).abs().max())
                                    for k, p in plain["params"].items()},
                  "loss_rel": [abs(a - b) / abs(b) for a, b in
                               zip(runs["loop"]["losses"], plain["losses"])]}

    # Per stage, on a fresh state: the step eager and replayed, and a
    # profiled replayed segment.
    stages = {}
    keys = _key_stream_np(1, 2 * SCAN_TIMED + 2 + SCAN_PROFILED)
    rng = np.random.RandomState(1)
    for label, flags, n_of in (("stage1", (True, False), (0, 1, 0)),
                               ("stage2", (True, True), (1, 0, 0)),
                               ("stage3", (False, True), (0, 0, 1))):
        params, _ = init_params(seq["init"], seq["assets"], config, device=dev)
        step = make_train_step(seq["assets"], config, seq["rcfg"], params, device=dev, vgg=vgg)
        with torch.no_grad():
            ref = pipeline.mesh_forward(params, torch.zeros(1, dtype=torch.long, device=dev),
                                        seq["assets"], config)[0][0]
        plateau = DevicePlateau.of(PlateauState(), dev)

        def segment(scan, n, k0):
            scan.upload(np.stack([rng.permutation(B_STEP)[None] for _ in range(n)]),
                        keys[k0:k0 + n, None])
            return scan.run(config.plateau_patience, config.plateau_factor)

        ms = {}
        for mode, use_graph in (("eager", False), ("graph", True)):
            scan = make_epoch_scan(step, data, aux_gt, ref, plateau, coarse_on=flags[0],
                                   app_on=flags[1], epochs=SCAN_TIMED, steps=1, batch=B_STEP,
                                   graph=use_graph)
            k0 = 0 if mode == "eager" else SCAN_TIMED + 1
            segment(scan, 1 if mode == "eager" else 2, k0)  # warm-up (and capture)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = segment(scan, SCAN_TIMED, k0)
            torch.cuda.synchronize()
            ms[mode] = (time.perf_counter() - t0) * 1e3 / SCAN_TIMED
            if not torch.isfinite(out).all():
                fail(f"epoch_scan: {label} {mode} steps gave non-finite sums")
            if use_graph:
                prof = profile_window(lambda: segment(scan, SCAN_PROFILED, 2 * SCAN_TIMED + 2),
                                      kernel_names=KERNEL_NAMES)
                trace = prof["kernel_counts"]
                nodes, n_nodes = graph_kernel_counts(scan.graph, KERNEL_NAMES)
                counts = {k: v * SCAN_PROFILED for k, v in nodes.items()}
                per_step = expected_launches(*n_of)
                want = {k: v * SCAN_PROFILED for k, v in per_step.items()}
                stages[label] = {"eager_step_ms": ms["eager"], "replayed_step_ms": ms["graph"],
                                 "capture_s": scan.capture_s,
                                 "profiled_steps": SCAN_PROFILED,
                                 "profiled_wall_ms": prof["wall_ms"],
                                 "device_busy_ms": prof["device_busy_ms"],
                                 "device_busy_share": prof["device_busy_share"],
                                 "graph_kernel_nodes": n_nodes,
                                 "kernel_counts": counts, "expected_counts": want,
                                 "trace_kernel_counts": trace,
                                 "top": prof["top"][:8], "idle_gaps": prof["idle_gaps"][:3]}
                if counts != want:
                    fail(f"epoch_scan: {label}: the graph's kernels of {SCAN_PROFILED} "
                         f"replayed steps {counts}, expected {want}")
                if any(want[k] and not trace[k] for k in want):
                    fail(f"epoch_scan: {label}: kernels of the graph absent from the trace of "
                         f"its replays: {trace}, expected {want}")
            scan.close()
        del step, params
    emit({"phase": "epoch_scan", "frames": B_STEP, "stages": list(SCAN_STAGES),
          "epoch_scan": 2, "vgg_compute_dtype": "bfloat16",
          "fit_s": {k: r["fit_s"] for k, r in runs.items()},
          "peak_mem_gib": {k: r["peak_mem_gib"] for k, r in runs.items()},
          "epoch_losses": g["losses"], "loop_epoch_losses": runs["loop"]["losses"],
          "loop_loss_rel": loop_loss_rel, "loop_param_max_abs": loop_err,
          "loop_capturable_vs_plain_adam": adam_moved,
          "graph_segments": [r["graph"] for r in seg],
          "eager_segments": [r.get("graph") for r in runs["eager"]["lines"] if "segment_s" in r],
          "capture_s": capture_s, "segment_s": [r["segment_s"] for r in seg],
          "differ_from_graph": differ, "overflow_max": counters, "stages_timed": stages})
    if any(differ.values()):
        fail(f"epoch_scan: fits that must be the graph's bits differ: {differ}")
    if [r["graph"] for r in seg] != [True] * 6 or len(capture_s) != 3:
        fail(f"epoch_scan: segments {[r['graph'] for r in seg]}, captures {capture_s}")
    if [r.get("graph") for r in runs["eager"]["lines"] if "segment_s" in r] != [False] * 6:
        fail("epoch_scan: the --debug-nans fit's segments are not logged graph: false")
    if any(counters.values()):
        fail(f"epoch_scan: overflow counters {counters}")
    losses = g["losses"]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"epoch_scan: epoch losses {losses}")
    for e, rel in enumerate(loop_loss_rel):
        if rel > SCAN_LOSS_RTOL[e >= 2]:
            fail(f"epoch_scan: epoch {e} loss {rel} from the per-step loop's")
    for k, p in runs["loop"]["params"].items():
        excess = float(((g["params"][k] - p).abs() - 2e-3 * p.abs()).max())
        if excess > config.total_epoch * 2 * lr + 2e-6:
            fail(f"epoch_scan: parameter {k} beyond harp_tpu's scan-against-loop bound")


def phase_nccl_scan(dev, seq) -> None:
    """fit_sequence(mesh=, epoch_scan=2) over two NCCL ranks, one card each
    (parallel.launch): each rank's graph holds the gradient all-reduce. 9
    of the 18 frames a rank, no VGG, stages 2 / 2 / 2; every segment a
    graph; the loss within rtol 1e-4 of the one-card scan fit and the
    parameters within harp_tpu's frame-split bound (as mesh_fit). Needs
    two cards: with one it says so and checks nothing."""
    import dataclasses

    import torch
    from harp_tpu_torch.fit.driver import FitData, fit_sequence
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.parallel import workers
    from harp_tpu_torch.parallel.launch import launch

    cards = torch.cuda.device_count()
    if cards < 2:
        emit({"phase": "nccl_scan", "skipped": f"{cards} card: an all-reduce inside a graph "
                                                "needs two"})
        return
    config = dataclasses.replace(seq["config"], w_vgg=0.0, training_stage=(2, 2, 2),
                                 total_epoch=6)
    params, aux = init_params(seq["init"], seq["assets"], config, device=dev)
    want, want_hist = fit_sequence(config, seq["assets"],
                                   FitData(seq["images"], seq["masks"], seq["masks_er"]),
                                   params, aux, rcfg=seq["rcfg"], device=dev, epoch_scan=2)
    scene = {"assets": seq["assets"], "config": config, "rcfg": seq["rcfg"],
             "init": seq["init"], "frames": tuple(t.cpu().numpy() for t in (
                 seq["images"], seq["masks"], seq["masks_er"]))}
    t0 = time.perf_counter()
    out = launch(workers.fit_sequence_on_mesh, 2, scene, 1, 2, devices=["cuda:0", "cuda:1"],
                 backend="nccl", timeout=600)["runs"][0]
    launch_s = time.perf_counter() - t0
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(out["history"], want_hist)]
    lr = max(config.lr_pose, config.lr_app)
    bound = config.total_epoch * 3 * lr + 2e-6
    param_err = {k: float(np.max(np.abs(out["params"][k] - v.detach().cpu().numpy())
                                 - 2e-4 * np.abs(v.detach().cpu().numpy())))
                 for k, v in want.items()}
    emit({"phase": "nccl_scan", "cards": cards, "ranks": 2, "launch_s": launch_s,
          "graph_segments": [r["graph"] for r in out["segments"]],
          "capture_s": [r.get("capture_s") for r in out["segments"]],
          "epoch_losses": [h["loss"] for h in out["history"]],
          "one_card_epoch_losses": [h["loss"] for h in want_hist], "loss_rel_err": loss_rel,
          "param_excess_over_rtol": param_err, "bound": bound})
    if [r["graph"] for r in out["segments"]] != [True] * 3:
        fail(f"nccl_scan: segments {out['segments']}")
    over = {k: e for k, e in param_err.items() if e > bound}
    if len(loss_rel) != 6 or max(loss_rel) > 1e-4 or over:
        fail(f"nccl_scan: loss rel {loss_rel}, parameters beyond {bound}: {over}")


def phase_protocol(dev) -> None:
    """The protocol as a user runs it (harp_tpu_torch.bench.run_protocol):
    the CLI at its defaults with 36 frames (301 epochs, 448^2, B18,
    shadow, VGG bf16 with the cached GT, --epoch-scan 10, the turntables).
    The fit and eval walls, the turntables' seconds, IoU / L1 / MS-SSIM
    within PERF.md's limits of harp_tpu's recorded protocol, every segment
    a graph, every overflow counter 0."""
    from harp_tpu_torch.bench import run_protocol

    rec = run_protocol()
    emit({"phase": "protocol", **rec})
    if rec["failures"]:
        fail("protocol: " + "; ".join(rec["failures"]))


BENCH_STEPS = 3  # timed steps of each of the bench's variants in phase bench


def phase_bench(dev) -> None:
    """The port's bench (harp_tpu_torch.bench.run, as python -m
    harp_tpu_torch.bench runs it) at BENCH_STEPS timed steps a variant:
    bench.py's four variants (the VGG bf16 step at B18, the step without
    VGG at B18 and B8, the arm at B18) and the VGG step replayed from the
    epoch scan's CUDA graph, with the roofline and the headline's
    breakdown; its JSON line printed as the bench prints it. The bench
    fails on a non-finite loss, a non-zero overflow counter or a timed
    step that did not launch every kernel. Then the headline's step with
    the VGG term at weight 0 (harp_tpu's bench builds w_vgg=0.0 and still
    runs the network): its time and device work beside the weight-1
    step's. Fails on a non-finite value, a variant without busy ms or peak
    memory, or a roofline share outside (0, 100]."""
    from harp_tpu_torch import bench

    rec = bench.run(steps=BENCH_STEPS)
    print(json.dumps(rec), flush=True)
    w0 = bench.measure(B_STEP, use_vgg=True, device=dev, steps=BENCH_STEPS, w_vgg=0.0)
    w1 = rec["variants"]["vgg_b18"]
    values = {k: rec[k] for k in ("value", "value_novgg_b18", "value_novgg_b8",
                                  "value_arm_b18", "value_replayed")}
    emit({"phase": "bench", "steps": BENCH_STEPS, **values,
          "busy_ms": {k: v["busy_ms"] for k, v in rec["variants"].items()},
          "launches": {k: v.get("launches") for k, v in rec["variants"].items()},
          "vgg_w0": {k: w0[k] for k in ("trimmed_mean_ms", "median_ms", "busy_ms", "peak_gib",
                                        "step_flops", "launches")},
          "vgg_w0_minus_w1": {k: w0[k] - w1[k] for k in ("trimmed_mean_ms", "busy_ms",
                                                           "step_flops")}})
    if not all(np.isfinite(v) and v > 0 for v in values.values()):
        fail(f"bench: values {values}")
    for k, v in rec["variants"].items():
        if not (v["busy_ms"] and v["peak_gib"]) or any(v["overflow"].values()):
            fail(f"bench: {k}: busy {v['busy_ms']}, peak {v['peak_gib']}, "
                 f"overflow {v['overflow']}")
    for k in ("vgg_mfu_pct", "mfu_step_vgg"):
        if not (rec["roofline"][k] and 0 < rec["roofline"][k] <= 100):
            fail(f"bench: roofline {k} {rec['roofline'][k]}")


def phase_graft_entry(dev) -> None:
    """graft_entry.entry()'s forward (the flagship hand at 448^2, 2 frames:
    mesh forward, soft silhouette, shadowed RGB) on the card against the
    same forward on the CPU (the kernels' plain versions): joints rtol
    1e-5; alpha and RGB within 1e-3 on all but 0.5% of the pixels (the
    shadow's sharpness-1000 sigmoid amplifies float32 rounding where a
    pixel's depth meets the light's), and within 0.05 everywhere."""
    import torch
    from harp_tpu_torch.graft_entry import entry

    out = {}
    for d in (dev, torch.device("cpu")):
        forward, args = entry(d)
        t0 = time.perf_counter()
        with torch.no_grad():
            res = forward(*args)
        if d.type == "cuda":
            torch.cuda.synchronize()
        out[d.type] = ([t.cpu() for t in res], time.perf_counter() - t0)
    (card, card_s), (cpu, cpu_s) = out["cuda"], out["cpu"]
    rec = {"phase": "graft_entry", "shapes": [list(t.shape) for t in card], "card_s": card_s,
           "cpu_s": cpu_s}
    for name, a, b in zip(("alpha", "rgb", "joints"), card, cpu):
        diff = (a - b).abs()
        rec[name] = {"max_abs": float(diff.max()), "share_over_1e-3": float((diff > 1e-3)
                                                                           .float().mean())}
    emit(rec)
    if [list(t.shape) for t in card] != [[2, IMG, IMG], [2, IMG, IMG, 3], [2, 21, 3]]:
        fail(f"graft_entry: shapes {rec['shapes']}")
    if not torch.allclose(card[2], cpu[2], rtol=1e-5, atol=1e-4):
        fail(f"graft_entry: joints {rec['joints']}")
    for name in ("alpha", "rgb"):
        if rec[name]["share_over_1e-3"] > 0.005 or rec[name]["max_abs"] > 0.05:
            fail(f"graft_entry: {name} card vs CPU {rec[name]}")
    if not 0.01 < float(card[0].mean()) < 0.5:
        fail(f"graft_entry: silhouette coverage {float(card[0].mean())}")


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
    """Where one stage-2 step's device time goes (torch.profiler), the
    device's busy share of the step's wall time, and its longest idle gaps
    (utils/profiling.profile_window). Returns the record."""
    rec = {"phase": "profile", "of": label, **profile_window(run_step)}
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
    phase_turntables(dev, seq, fit)
    phase_crop(dev, seq)
    # The dense raster API and the eval as one CUDA graph.
    phase_dense_raster(dev, seq)
    phase_eval_program(dev)
    # Several sequences and ranks, and the async checkpointer.
    phase_batch_fit(dev, seq)
    phase_mesh_fit(dev, seq, fit)
    phase_orbax_resume(dev, seq, fit)
    # The epoch scan: segments of epochs as CUDA graphs of the step, and
    # the layer stamps that a profiled scan captures into them.
    phase_stamps(dev)
    phase_epoch_scan(dev, seq)
    phase_nccl_scan(dev, seq)
    del seq, fit
    phase_protocol(dev)
    phase_graft_entry(dev)
    phase_bench(dev)
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
