"""Shared arithmetic of the per-layer readers (not a metric: no entry of
BENCHMARK.json names it)."""

from __future__ import annotations

import dataclasses

from benchmark.roofline import counts

KERNELS = {"k1_soft": ("raster_ids_kernel<true",), "k1_depth": ("raster_ids_kernel<false",),
           "k2": ("coverage_grad_kernel",), "k3": ("pcf_prepass_kernel", "pcf_scatter_kernel"),
           "segment_sum": ("chunk_sums_kernel", "cross_sums_kernel")}


def window_flags(run) -> tuple:
    """(coarse_on, app_on) of the stage the window's fits run: the first
    stage with epochs."""
    s0, s1, _ = run["traffic"]["stages"]
    return (True, False) if s0 else ((True, True) if s1 else (False, True))


def shapes(run) -> dict:
    mesh = run["spec"]["render_mesh"]
    return counts.step_shapes(dataclasses.asdict(run["config"]), mesh["faces"],
                              mesh["vertices"])


def kernel_of(name: str):
    return next((k for k, pats in KERNELS.items() if any(p in name for p in pats)), None)


def idle_pct(run):
    """The share of the traced job's wall in which no kernel, copy or
    memset ran on the device, in percent."""
    tr = run["trace"]
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def actions_ms(run):
    """The mean host seconds fit_sequence spends after a segment's steps on
    its due actions (metrics.jsonl's actions_s: the image logs' renders and
    copies, handed to the writer thread), over every segment of every fit
    job in the window; in ms."""
    vals = [a for j in run["jobs"] for a in j.get("actions_s", [])]
    return 1e3 * sum(vals) / len(vals) if vals else None


def capture_ms(run):
    """The seconds a fit job spends capturing the step's CUDA graphs
    (metrics.jsonl's capture_s, one a stage), summed over the job and
    averaged over the window's jobs; in ms."""
    jobs = [j for j in run["jobs"] if j.get("capture_s")]
    return 1e3 * sum(sum(j["capture_s"]) for j in jobs) / len(jobs) if jobs else None


def roofline_pct(run):
    """Over the traced fit job's graph replays, the sum of the least times
    of the hand-written kernels' launches (K1 soft and depth, K2, K3,
    segment_sum; counts.kernel_bytes over the peak bandwidth, from the
    step's shapes and the configuration's capacities) over the sum of
    their traced device times, matched by kernel name; in percent. A
    replayed step is counted by its K1 soft launch. Kernels that the trace
    does not show are left out of both sums."""
    from benchmark.roofline import PEAK_BYTES_S

    gk = run["trace"].get("graph_kernels") or {}
    device, seen, steps = 0.0, set(), 0
    for name, (sec, n) in gk.items():
        k = kernel_of(name)
        if k is None:
            continue
        device += sec
        seen.add(k)
        if k == "k1_soft":
            steps += n
    if not steps or not device:
        return None
    need = counts.kernel_bytes(shapes(run), *window_flags(run))
    least = steps * sum(need[k] for k in seen if k in need) / PEAK_BYTES_S
    return 100.0 * least / device


def frames_per_s(run):
    """The frames of every fit job's epochs (epochs x the frames an epoch
    visits) over the window's wall, host clock."""
    return sum(j["work"] for j in run["jobs"]) / run["window_s"]
