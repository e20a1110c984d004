"""Where a cell's traced fit job spends its device time, by the program's
own names (not a metric: no entry of BENCHMARK.json names it).

    python3 -m benchmark.gaps --workload hand.fit_stage2 --seed 7 [--cost 3] [--out f.json]

Set-up's warm-up fit, then one fit job traced as a `--trace 1` run traces
it (benchmark/trace.py). Prints, as JSON lines: the step's split from its
layer stamps over the job's replayed steps (medians and means, ms:
utils/profiling.step_parts), the job's device busy and window seconds and
its idle time put down to the innermost program span open when each idle
stretch began, with the longest stretches (utils/profiling.idle_by_span),
and each span name's wall ms. With --cost N, then N rounds of three jobs in
turns, at the same inputs: unprofiled, under a recording profiler, and
under one with the stamps held off; their fit_frames_per_s (epochs x
frames over the job's wall) and medians: what tracing costs when on, and
how much of it is the stamps'.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import sys
import tempfile

import numpy as np
import torch
from torch.autograd import DeviceType

from benchmark.inputs import make_inputs
from benchmark.jobs import FitCell
from benchmark.run import find_cell
from benchmark.trace import WINDOW, traced


@contextlib.contextmanager
def _stamps_held_off():
    from harp_tpu_torch.fit import driver

    on = driver.stamps_on
    driver.stamps_on = lambda: False
    try:
        yield
    finally:
        driver.stamps_on = on


def read_traced(prof, profiling) -> dict:
    """The split, the idle time by span and the span walls of the latest
    fit in the span store, traced by `prof` (torch.profiler.profile)."""
    events = prof.profiler.kineto_results.events()
    win = next(e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU)
    device = [(e.start_ns(), e.end_ns()) for e in events
              if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    fit = max((r for r in profiling.spans() if r["name"] == "fit"), key=lambda r: r["id"])
    recs = profiling.spans(fit["id"])
    segs = sorted((r for r in recs if "stamps" in r), key=lambda r: r["start_ns"])
    rows = np.concatenate([r["stamps"]["t"][r["stamps"]["eager"]:] for r in segs])
    rows = rows[rows[:, 0] > 0]
    parts = profiling.step_parts(rows)
    walls: dict = {}
    for r in recs:
        walls.setdefault(r["name"], []).append((r["end_ns"] - r["start_ns"]) / 1e6)
    return {"replayed_steps": len(rows),
            "parts_median_ms": {k: float(np.median(v)) / 1e6 for k, v in parts.items()},
            "parts_mean_ms": {k: float(np.mean(v)) / 1e6 for k, v in parts.items()},
            "step_sum_s": float(parts["step"].sum()) / 1e9,
            "idle": profiling.idle_by_span(device, recs, (win.start_ns(), win.end_ns())),
            "span_ms": walls}


def main(argv=None) -> int:
    from harp_tpu_torch.utils import profiling

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost", type=int, default=0, help="rounds of the three jobs after it")
    ap.add_argument("--out", help="also write the whole record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.gaps: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _, spec, traffic, _, _ = find_cell(args.workload)
    cell = FitCell(make_inputs(spec, args.seed, dev, traffic), traffic)
    rec = {"workload": args.workload, "seed": args.seed}
    with tempfile.TemporaryDirectory() as d:
        cell.warmup(os.path.join(d, "warmup"))
        into: dict = {}
        with traced(dev, into):
            cell.job(os.path.join(d, "traced"))
        rec.update(read_traced(into["_prof"], profiling))
        print(json.dumps({k: rec[k] for k in ("workload", "seed", "replayed_steps",
                                              "parts_median_ms", "step_sum_s")}), flush=True)
        print(json.dumps(rec["idle"]), flush=True)
        if args.cost:
            rates: dict = {"off": [], "on": [], "on_stamps_off": []}
            for i in range(args.cost):
                for arm in rates:
                    out_dir = os.path.join(d, f"{arm}{i}")
                    with contextlib.ExitStack() as ctx:
                        if arm != "off":
                            ctx.enter_context(traced(dev, {}))
                        if arm == "on_stamps_off":
                            ctx.enter_context(_stamps_held_off())
                        j = cell.job(out_dir)
                    rates[arm].append(j["work"] / j["wall_s"])
                    shutil.rmtree(out_dir, ignore_errors=True)
            rec["fit_frames_per_s"] = rates
            rec["median_fit_frames_per_s"] = {k: statistics.median(v) for k, v in rates.items()}
            print(json.dumps({k: rec[k] for k in ("fit_frames_per_s",
                                                  "median_fit_frames_per_s")}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
