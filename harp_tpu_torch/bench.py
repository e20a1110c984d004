"""The port's benchmark: the counterpart of the repository's bench.py, and of
scripts/mfu_roofline.py, scripts/profile_step.py and scripts/bench_step.py.

    python -m harp_tpu_torch.bench               # one JSON line, below
    python -m harp_tpu_torch.bench --components  # chained component ms
    python -m harp_tpu_torch.bench --protocol    # the CLI's 301-epoch protocol

Every variant is the full train step (MANO forward, subdivision,
displacement, the camera's soft + hard raster through K1, silhouette alpha
with K2 in its backward, the light's depth-only raster through K1 and 3x3
PCF with K3 in its backward, shading, the losses, backward through
segment_sum, the two Adams) at stage 2 (coarse and appearance on), on the
synthetic sequence (seed 0) of the flagship hand at reference density
(3088 render vertices, 6152 faces), 448^2, texture 512^2, self-shadow. The
headline, train_frames_per_sec_448_vgg, is the step the protocol spends
its wall clock in: B = 18 with the VGG term on (w_vgg 1.0, bf16, the GT
pyramids cached), as the CLI runs it. bench.py's keys beside it:
value_novgg_b18, value_novgg_b8 (the step without VGG) and value_arm_b18
(the SMPL-X arm at reference density, without VGG); and value_replayed,
the headline's step replayed from the epoch scan's CUDA graph. Each is
frames / s over bench.py's trimmed mean of synchronised steps (the mean of
the fastest n - 2 of n), with the median, min, max, the device-busy ms of
one step profiled in a window of its own, peak memory, the raster budget
and the overflow counters (any non-zero counter fails the run). harp_tpu's
bench budget (active_fraction 0.28, span_tiles 3) truncates the 18-frame
sequences; the bench runs the hand at 0.375 / 4 and the arm at 0.5 / 4,
cap 448 both.

roofline (mfu_roofline.py): the VGG term's analytic convolution count (3 x
the pred side's forward: forward, checkpoint recompute, backward to the
input), its ms (the VGG step minus the no-VGG step of the same run), its
MFU against the H100's bf16 peak, and the whole VGG step's operation count
(torch.utils.flop_counter on one eager step) over its time, mfu_step_vgg.
breakdown (profile_step.py): the headline step's top kernels and its
longest device idle gaps by the host op open when each began.

Needs one CUDA card and refuses to run without one; the roofline divides by
the H100's published peaks and refuses another card. vs_baseline divides by
bench.py's estimate of 8 frames/s for the reference's pytorch3d pipeline on
a V100-class GPU: a literature estimate, not a measurement.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from harp_tpu_torch.utils.profiling import (
    PEAK_BF16_S, device_record, graph_kernel_counts, profile_window, timing_stats,
)

REFERENCE_FRAMES_PER_SEC_ESTIMATE = 8.0
IMG, TEX = 448, 512
# Raster budgets with every overflow counter 0 on the 18-frame synthetic
# sequences: the hand occupies up to 275 of 784 tiles a frame and has
# faces wider than 3 tiles, the arm's forearm up to 329 tiles.
HAND_BUDGET = dict(active_fraction=0.375, span_tiles=4, cap=448)
ARM_BUDGET = dict(active_fraction=0.5, span_tiles=4, cap=448)
# The hand-written kernels by the names the profiler gives them (csrc/),
# under the names of their launch counters.
KERNEL_NAMES = {"raster_ids_soft": "raster_ids_kernel<true", "raster_ids_depth":
                "raster_ids_kernel<false", "coverage_grad": "coverage_grad_kernel",
                "pcf_scatter": "pcf_scatter_kernel", "segment_sum": "chunk_sums_kernel"}
# harp_tpu's recorded protocol (RESULTS.md:350-352) and PERF.md section 2's
# limits on the port's distance from it.
PROTOCOL_REF = {"Silhouette IoU": (0.9386, 0.01), "L1": (0.0051, 0.002),
                "MS_SSIM": (0.9790, 0.01)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _scene(B: int, *, use_arm: bool, use_vgg: bool, device, img: int, texture: int,
           density: str, raster_kw, w_vgg: float = 1.0) -> SimpleNamespace:
    """The flagship scene of B frames (graft_entry._build at the bench's
    budget), its synthetic sequence (seed 0), fresh parameters and the
    train step; with use_vgg the VGG term in bf16 at weight w_vgg from
    the cached GT pyramids, as fit_sequence runs it."""
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.device import resolve_device
    from harp_tpu_torch.fit.driver import make_train_step
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.graft_entry import _build
    from harp_tpu_torch.losses.perceptual import Vgg16Features, precompute_slices
    from harp_tpu_torch.render import pipeline

    dev = resolve_device(device)
    budget = raster_kw if raster_kw is not None else ARM_BUDGET if use_arm else HAND_BUDGET
    assets, config, rcfg, _ = _build(img, texture, B, raster_kw=budget, density=density,
                                     use_arm=use_arm, device=dev)
    images, masks, masks_er, _, init = make_synthetic_sequence(
        assets, config, rcfg, n_frames=B, seed=0, device=dev)
    params, aux = init_params(init, assets, config, device=dev)
    vgg = None
    if use_vgg:
        config = dataclasses.replace(config, w_vgg=w_vgg, vgg_compute_dtype="bfloat16")
        vgg = Vgg16Features.create(compute_dtype="bfloat16", device=dev)
        aux["vgg_gt"] = precompute_slices(vgg, images * masks_er[..., None],
                                          chunk=config.vgg_chunk)
    fids = torch.arange(B, device=dev)
    with torch.no_grad():
        ref_verts = pipeline.mesh_forward(params, fids[:1], assets, config)[0][0]
    return SimpleNamespace(
        device=dev, assets=assets, config=config, rcfg=rcfg, images=images, masks=masks,
        masks_er=masks_er, params=params, aux=aux, vgg=vgg, fids=fids, ref_verts=ref_verts,
        step=make_train_step(assets, config, rcfg, params, device=dev, vgg=vgg),
        budget={k: getattr(rcfg, k) for k in ("active_fraction", "span_tiles", "cap")})


def _merge_overflow(seen: dict, values: dict) -> None:
    for k, v in values.items():
        seen[k] = max(seen.get(k, 0.0), float(v))


def _step_flops(run) -> tuple:
    """(all, convolution) operations of run() by torch's FlopCounterMode
    (2 per multiply-add of the matrix products and convolutions, the
    backward's included); outside any graph capture."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        run()
    conv = sum(n for op, n in fc.get_flop_counts().get("Global", {}).items()
               if "convolution" in str(op))
    return fc.get_total_flops(), conv


def _record(sc, times: list, overflow: dict, peak_gib, prof) -> dict:
    """A variant's record: frames / s over the trimmed mean, the step's
    timing statistics in ms, and (on the card only) the profiled step's
    busy ms, its wall (the profiler slows the host) and the busy share of
    that wall, and peak memory; None where nothing was measured on a
    card."""
    st = timing_stats([t * 1e3 for t in times])
    B = sc.fids.numel()
    return {"frames": B, "device": sc.device.type,
            "frames_per_s": B / (st["trimmed_mean"] / 1e3),
            "trimmed_mean_ms": st["trimmed_mean"], "median_ms": st["median"],
            "min_ms": st["min"], "max_ms": st["max"], "steps": st["n"],
            "busy_ms": prof and prof["device_busy_ms"],
            "busy_share": prof and prof["device_busy_share"],
            "profiled_wall_ms": prof and prof["wall_ms"], "peak_gib": peak_gib,
            "budget": sc.budget, "overflow": overflow,
            "vgg": None if sc.vgg is None else {"w_vgg": sc.config.w_vgg,
                                                "compute_dtype": sc.config.vgg_compute_dtype},
            "profile": prof}


def _check(label: str, rec: dict) -> None:
    bad = {k: v for k, v in rec["overflow"].items() if v}
    if bad:
        raise RuntimeError(f"bench {label}: raster overflow {bad}")
    if not (math.isfinite(rec["loss"]) and math.isfinite(rec["frames_per_s"])):
        raise RuntimeError(f"bench {label}: non-finite loss {rec['loss']} or rate")


def measure(B: int, use_arm: bool = False, use_vgg: bool = False, device=None,
            steps: int = 10, *, img: int = IMG, texture: int = TEX,
            density: str = "reference", raster_kw=None, w_vgg: float = 1.0) -> dict:
    """bench.py's measure: one warm-up stage-2 step (its loss must be
    finite), then `steps` synchronised stage-2 steps threading the state;
    the record of _record, with the timed steps' kernel launches, the
    last loss, one more step's operation count (FlopCounterMode) and, on
    the card, one more step profiled in a window of its own. Raises on a
    non-finite loss or a non-zero overflow counter, and on the card when a
    timed step did not launch every hand-written kernel. On the card
    unless given a device."""
    from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, _key_stream_np
    from harp_tpu_torch.parallel.workers import kernel_launches, reset_kernel_launches

    sc = _scene(B, use_arm=use_arm, use_vgg=use_vgg, device=device, img=img,
                texture=texture, density=density, raster_kw=raster_kw, w_vgg=w_vgg)
    dev, cuda = sc.device, sc.device.type == "cuda"
    keys = _key_stream_np(0, steps + 3)

    def one(i):
        return sc.step(sc.aux, sc.fids, sc.images, sc.masks, sc.masks_er, sc.ref_verts,
                       coarse_on=True, app_on=True, key=keys[i])

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    total, br = one(0)
    if not math.isfinite(float(total)):
        raise RuntimeError(f"bench: non-finite warm-up loss {float(total)}")
    overflow = {}
    _merge_overflow(overflow, {k: br[k] for k in OVERFLOW_KEYS})
    reset_kernel_launches()
    times = []
    for i in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        total, br = one(i + 1)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        _merge_overflow(overflow, {k: br[k] for k in OVERFLOW_KEYS})
    launches = kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None
    flops, conv_flops = _step_flops(lambda: one(steps + 1))
    prof = profile_window(lambda: one(steps + 2)) if cuda else None
    rec = dict(_record(sc, times, overflow, peak, prof), loss=float(total),
               launches=launches, step_flops=flops, step_conv_flops=conv_flops)
    _check(f"B{B}{' arm' if use_arm else ''}{' vgg' if use_vgg else ''}", rec)
    short = {k: n for k, n in launches.items() if n < steps}
    if cuda and short:
        raise RuntimeError(f"bench: {steps} timed steps launched {short}: each runs every kernel")
    return rec


def measure_replayed(B: int = 18, device=None, steps: int = 10, *, img: int = IMG,
                     texture: int = TEX, density: str = "reference", raster_kw=None) -> dict:
    """The headline's step (VGG bf16, cached GT) replayed from the epoch
    scan's CUDA graph (make_epoch_scan, one step an epoch): a segment of
    two epochs warms up (one eager step), captures and replays; then
    `steps` segments of one epoch, each synchronised and timed (one replay,
    the epoch's fold and the plateau's update on the device, the segment's
    ids and key copied in); one more profiled. The captured graph's kernel
    nodes by name (graph_kernel_counts: a trace can lose records of the
    first replay after the profiler starts) must include each hand-written
    kernel. The record of _record with the capture's seconds and those
    counts. CUDA only (a graph needs the card)."""
    from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, FitData, _key_stream_np, make_epoch_scan
    from harp_tpu_torch.fit.optimizer import DevicePlateau, PlateauState

    sc = _scene(B, use_arm=False, use_vgg=True, device=device, img=img, texture=texture,
                density=density, raster_kw=raster_kw)
    dev, cfg = sc.device, sc.config
    scan = make_epoch_scan(sc.step, FitData(sc.images, sc.masks, sc.masks_er), sc.aux,
                           sc.ref_verts, DevicePlateau.of(PlateauState(), dev),
                           coarse_on=True, app_on=True, epochs=2, steps=1, batch=B, graph=True)
    keys = _key_stream_np(0, steps + 3)
    rng = np.random.RandomState(0)

    def segment(n: int, k0: int) -> torch.Tensor:
        scan.upload(np.stack([rng.permutation(B)[None] for _ in range(n)]), keys[k0:k0 + n, None])
        return scan.run(cfg.plateau_patience, cfg.plateau_factor)

    torch.cuda.reset_peak_memory_stats(dev)
    try:
        out = segment(2, 0)  # warm-up step, capture, one replay
        if not torch.isfinite(out).all():
            raise RuntimeError("bench replayed: non-finite warm-up sums")
        overflow, times, cols = {}, [], [1 + scan.terms.index(k) for k in OVERFLOW_KEYS]
        _merge_overflow(overflow, dict(zip(OVERFLOW_KEYS, out[:, cols].amax(0).tolist())))
        for i in range(steps):
            _sync(dev)
            t0 = time.perf_counter()
            out = segment(1, 2 + i)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            _merge_overflow(overflow, dict(zip(OVERFLOW_KEYS, out[0, cols].tolist())))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        prof = profile_window(lambda: segment(1, 2 + steps), kernel_names=KERNEL_NAMES)
        nodes, _ = graph_kernel_counts(scan.graph, KERNEL_NAMES)
        rec = dict(_record(sc, times, overflow, peak, prof), loss=float(out[0, 0]),
                   capture_s=scan.capture_s, graph_kernel_counts=nodes)
    finally:
        scan.close()
    _check("replayed", rec)
    missing = [k for k, n in nodes.items() if n < 1]
    if missing:
        raise RuntimeError(f"bench replayed: the captured step launches no {missing}")
    return rec


def vgg_conv_flops_per_frame(img: int) -> float:
    """Operations (2 per multiply-add) of one pred-side VGG16 forward to
    relu4_3 at img^2: mfu_roofline.py's count, over the port's VGG16_LAYOUT."""
    from harp_tpu_torch.losses.perceptual import VGG16_LAYOUT

    total, cin, hw = 0.0, 3, img
    for item in VGG16_LAYOUT:
        if item == "M":
            hw //= 2
            continue
        total += 2.0 * 9.0 * cin * int(item) * hw * hw
        cin = int(item)
    return total


def roofline(vgg: dict, novgg: dict, img: int = IMG) -> dict:
    """mfu_roofline.py's accounting against the H100's bf16 peak: the VGG
    term's analytic operations, 3 x the pred side's forward (the forward,
    its checkpoint recompute and the backward to the input; the filters
    are frozen and the GT side is cached), over its ms (the VGG step's
    trimmed mean minus the no-VGG step's), and over its device time (the
    profiled steps' busy ms, VGG minus no VGG: steadier than the walls of
    the eager, host-bound step); and the whole VGG step's FlopCounterMode
    count over the VGG step's trimmed mean (mfu_step_vgg). All in percent.
    Bytes accessed: XLA's cost analysis has no torch counterpart."""
    B = vgg["frames"]
    fwd = vgg_conv_flops_per_frame(img) * B
    step_ops = 3.0 * fwd
    delta_ms = vgg["trimmed_mean_ms"] - novgg["trimmed_mean_ms"]
    busy_ms = vgg["busy_ms"] - novgg["busy_ms"]
    achieved = step_ops / (delta_ms * 1e-3) if delta_ms > 0 else None
    return {"vgg_fwd_gflop_frame": fwd / B / 1e9, "vgg_step_tflop": step_ops / 1e12,
            "vgg_delta_ms": delta_ms,
            "vgg_achieved_tflops": achieved and achieved / 1e12,
            "vgg_mfu_pct": achieved and 100.0 * achieved / PEAK_BF16_S,
            "vgg_delta_busy_ms": busy_ms,
            "vgg_mfu_busy_pct": 100.0 * step_ops / (busy_ms * 1e-3) / PEAK_BF16_S
            if busy_ms > 0 else None,
            "vgg_min_ms_at_peak": step_ops / PEAK_BF16_S * 1e3,
            "peak_tflops_used": PEAK_BF16_S / 1e12,
            "step_flops": vgg["step_flops"], "step_conv_flops": vgg["step_conv_flops"],
            "mfu_step_vgg": 100.0 * vgg["step_flops"] / (vgg["trimmed_mean_ms"] * 1e-3)
            / PEAK_BF16_S,
            "bytes_accessed": "not measured"}


def run(steps: int = 10) -> dict:
    """bench.py's four variants and the replayed one on the card, with the
    roofline and the headline's breakdown: the bench's JSON record."""
    dev = torch.device("cuda")
    variants = {"vgg_b18": measure(18, use_vgg=True, device=dev, steps=steps),
                "novgg_b18": measure(18, device=dev, steps=steps),
                "novgg_b8": measure(8, device=dev, steps=steps),
                "arm_b18": measure(18, use_arm=True, device=dev, steps=steps),
                "replayed_vgg_b18": measure_replayed(18, device=dev, steps=steps)}
    profiles = {k: v.pop("profile") for k, v in variants.items()}
    fps = variants["vgg_b18"]["frames_per_s"]
    head = profiles["vgg_b18"]
    return {
        "metric": "train_frames_per_sec_448_vgg", "value": fps, "unit": "frames/s/chip",
        "vs_baseline": fps / REFERENCE_FRAMES_PER_SEC_ESTIMATE,
        "vs_baseline_basis": "estimate:8fps-V100-literature",
        "value_novgg_b18": variants["novgg_b18"]["frames_per_s"],
        "value_novgg_b8": variants["novgg_b8"]["frames_per_s"],
        "value_arm_b18": variants["arm_b18"]["frames_per_s"],
        "value_replayed": variants["replayed_vgg_b18"]["frames_per_s"],
        "variants": variants, "device": device_record(),
        "roofline": roofline(variants["vgg_b18"], variants["novgg_b18"]),
        "breakdown": {"of": "vgg_b18", "wall_ms": head["wall_ms"], "top": head["top"],
                      "top_ops": head["top_ops"], "idle_gaps": head["idle_gaps"]}}


def components(device=None, B: int = 18, iters: int = 15, *, img: int = IMG,
               texture: int = TEX, density: str = "reference", raster_kw=None) -> dict:
    """bench_step.py's chained component timing, of the headline's scene
    (VGG bf16, cached GT): each part run `iters` times back to back after
    one warm-up, synchronised once at the end, ms a call. The train step
    at stage 2, stage 1 (coarse only) and stage 3 (appearance only); the
    losses (compute_losses) forward only (no autograd graph), forward +
    backward, forward + backward without the self-shadow, and the coarse
    and the appearance losses alone forward + backward."""
    from harp_tpu_torch.device import deterministic_convolutions
    from harp_tpu_torch.fit.driver import _key_stream_np, compute_losses

    sc = _scene(B, use_arm=False, use_vgg=True, device=device, img=img, texture=texture,
                density=density, raster_kw=raster_kw)
    key = _key_stream_np(0, 1)[0]

    def chained(fn) -> float:
        fn()
        _sync(sc.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(sc.device)
        return (time.perf_counter() - t0) * 1e3 / iters

    def step(coarse_on, app_on):
        return lambda: sc.step(sc.aux, sc.fids, sc.images, sc.masks, sc.masks_er,
                               sc.ref_verts, coarse_on=coarse_on, app_on=app_on, key=key)

    def losses(coarse_on, app_on, backward=True, config=sc.config):
        def run_losses():
            for p in sc.params.values():
                p.grad = None
            with deterministic_convolutions(), torch.set_grad_enabled(backward):
                total, _ = compute_losses(sc.params, sc.aux, sc.fids, sc.images, sc.masks,
                                          sc.masks_er, sc.assets, config, sc.rcfg,
                                          sc.ref_verts, coarse_on, app_on, vgg=sc.vgg, key=key)
                if backward:
                    total.backward()
        return run_losses

    no_shadow = dataclasses.replace(sc.config, self_shadow=False)
    ms = {"full_step": chained(step(True, True)),
          "coarse_only_step": chained(step(True, False)),
          "app_only_step": chained(step(False, True)),
          "loss_fwd": chained(losses(True, True, backward=False)),
          "loss_fwd_bwd": chained(losses(True, True)),
          "fwd_bwd_no_shadow": chained(losses(True, True, config=no_shadow)),
          "coarse_fwd_bwd": chained(losses(True, False)),
          "app_fwd_bwd": chained(losses(False, True))}
    return {"components_ms": ms, "frames": B, "img": img, "iters": iters,
            "device": sc.device.type, "vgg": {"w_vgg": sc.config.w_vgg,
                                              "compute_dtype": sc.config.vgg_compute_dtype}}


def run_protocol() -> dict:
    """The protocol as a user runs it: python -m harp_tpu_torch.fit_avatar
    --synthetic --n-frames 36 with every other flag at its default (301
    epochs, 448^2, B18, shadow, VGG bf16 with the cached GT, --epoch-scan
    10, the turntables), in this process, on the card. The record: the fit
    and eval walls, the eval program's (eval_program_s, its capture
    eval_capture_s), the turntables' seconds, IoU / L1 / MS-SSIM and their
    gaps to harp_tpu's recorded protocol, the segments, the overflow
    counters, and "failures": each limit missed (PROTOCOL_REF's, every
    segment a graph, every counter 0)."""
    from harp_tpu_torch.fit.driver import OVERFLOW_KEYS
    from harp_tpu_torch.fit_avatar import main as fit_avatar

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--synthetic", "--n-frames", "36", "--out", tmp]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the CLI prints its summary
            stats = fit_avatar(argv)
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "loss" in r]
    seg = [r for r in epochs if "segment_s" in r]
    counters = {k: max(r.get(k, 0.0) for r in epochs) for k in OVERFLOW_KEYS}
    failures = []
    if len(epochs) != 301 or not all(r["graph"] is True for r in seg):
        failures.append(f"{len(epochs)} epochs, segments as graphs {[r['graph'] for r in seg]}")
    if any(counters.values()):
        failures.append(f"overflow counters {counters}")
    for k, (ref, tol) in PROTOCOL_REF.items():
        if not abs(stats[k] - ref) <= tol:
            failures.append(f"{k} {stats[k]} is beyond {tol} of harp_tpu's {ref}")
    return {"argv": argv[:-2], "cli_wall_s": wall,
            **{k: stats.get(k) for k in ("fit_wall_s", "eval_wall_s", "eval_program_s",
                                         "eval_capture_s", "eval_turntables_s",
                                         "Silhouette IoU", "L1", "MS_SSIM", "LPIPS_proxy",
                                         "final_loss")},
            "harp_tpu_recorded": {k: ref for k, (ref, _) in PROTOCOL_REF.items()},
            "gaps": {k: stats[k] - ref for k, (ref, _) in PROTOCOL_REF.items()},
            "epochs": len(epochs), "segments": len(seg),
            "graph_segments": sum(bool(r["graph"]) for r in seg),
            "capture_s": [r["capture_s"] for r in epochs if "capture_s" in r],
            "segment_s_median": float(np.median([r["segment_s"] for r in seg])),
            "lr_scale_last": epochs[-1]["lr_scale"], "overflow_max": counters,
            "failures": failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m harp_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--components", action="store_true",
                      help="chained component ms of the headline's step (bench_step.py)")
    mode.add_argument("--protocol", action="store_true",
                      help="the CLI's 301-epoch protocol at its defaults, held to "
                           "harp_tpu's recorded quality")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("harp_tpu_torch.bench: no CUDA device; the bench measures the card and has "
              "no CPU fallback", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    if not (args.components or args.protocol) and "H100" not in name:
        print(f"harp_tpu_torch.bench: the card is {name!r}, not an H100: the roofline "
              "knows the H100's peaks only", file=sys.stderr)
        return 1
    from harp_tpu_torch.csrc import build

    build.build_all()  # one nvcc per source, all at once
    if args.components:
        rec = dict(components(), device=device_record())
    elif args.protocol:
        rec = dict(run_protocol(), device=device_record())
    else:
        rec = run()
    print(json.dumps(rec), flush=True)
    return 1 if rec.get("failures") else 0


if __name__ == "__main__":
    sys.exit(main())
