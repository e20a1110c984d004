"""Shared reading of the program's span store (not a metric: no entry of
BENCHMARK.json names it).

The program keeps its spans, and the train step's layer stamps on the
device's clock, in memory (harp_tpu_torch/utils/profiling.py: spans(),
STAMP_SLOTS, step_parts()). The epoch scan stamps its step only when the
step is captured while a torch.profiler records, so in a run only the
traced job's fit carries stamps: each segment's "segment.read" span holds
its steps' rows (the first `eager` of them run eagerly, the rest replayed
from the stage's CUDA graph). These readers read the store after the
window, in the run's process. A program without the store reads None.
"""

from __future__ import annotations

import statistics


def _profiling():
    try:
        from harp_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") and hasattr(profiling, "step_parts") else None


def stamped_segments(prof) -> list:
    """The stamped segment reads of the first fit that has any (the traced
    job's), in the order they began."""
    recs = [r for r in prof.spans() if "stamps" in r]
    if not recs:
        return []
    fit = min(recs, key=lambda r: r["start_ns"])["fit"]
    return sorted((r for r in recs if r["fit"] == fit), key=lambda r: r["start_ns"])


def replayed(prof, seg: dict):
    """A segment's replayed, stamped rows (steps x STAMP_SLOTS, ns)."""
    st = seg["stamps"]
    t = st["t"][st["eager"]:]
    return t[t[:, prof.STAMP_SLOTS.index("start")] > 0]


def part_ms(run, part: str):
    """The median over the traced job's replayed steps of one part of the
    step (step_parts: "step", the stamp at the step's end minus the one at
    its start, or one of its layers), device clock, in ms."""
    prof = _profiling()
    if prof is None:
        return None
    vals = [v for seg in stamped_segments(prof)
            for v in prof.step_parts(replayed(prof, seg))[part].tolist()]
    return statistics.median(vals) / 1e6 if vals else None


def turnaround_ms(run):
    """The median over the boundaries, within a stage of the traced job,
    of the device-clock gap from a segment's last replayed step's end stamp
    to the next segment's first replayed step's start stamp, less the
    host-clock wall of the "segment.actions" spans begun between the two
    segments' reads (the image logs, which fit.actions_ms times): the fold
    of the segment's last epoch, its host read, the next segment's
    permutations and their copies, and the first step's minibatch gather,
    as the device sees them; in ms. The actions run after the read's sync
    and before the next upload, so they lie inside the gap."""
    prof = _profiling()
    if prof is None:
        return None
    start, end = prof.STAMP_SLOTS.index("start"), prof.STAMP_SLOTS.index("adam")
    segs = stamped_segments(prof)
    if not segs:
        return None
    actions = [r for r in prof.spans()
               if r["name"] == "segment.actions" and r["fit"] == segs[0]["fit"]]
    gaps = []
    for a, b in zip(segs, segs[1:]):
        ta, tb = replayed(prof, a), replayed(prof, b)
        if a["stamps"]["flags"] == b["stamps"]["flags"] and len(ta) and len(tb):
            held = sum(r["end_ns"] - r["start_ns"] for r in actions
                       if a["start_ns"] <= r["start_ns"] < b["start_ns"])
            gaps.append(int(tb[0, start]) - int(ta[-1, end]) - held)
    return statistics.median(gaps) / 1e6 if gaps else None


def warmup_fit_s(run):
    """The wall of the process's first "fit" span, set-up's warm-up fit, on
    the host's clock, in s. The store keeps the last few thousand spans,
    some fifty a fit, so the first fit of a run is still there."""
    prof = _profiling()
    if prof is None:
        return None
    fits = [r for r in prof.spans() if r["name"] == "fit"]
    if not fits:
        return None
    first = min(fits, key=lambda r: r["start_ns"])
    return (first["end_ns"] - first["start_ns"]) / 1e9
