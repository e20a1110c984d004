"""Readings that set the limits of `correct`: the program's numbers over
many seeds (the lower readings), the control's (the reference in TF32,
put in the program's place: the upper readings) and the planted faults'.
The benchmark's own runs never run this.

    python3 -m benchmark.control --workload hand.fit_stage2 --seeds 1 2 3 \
        [--control] [--faults] [--out readings.jsonl]

Each seed runs the program's warm-up fit (the timed path's fit_sequence
over the traffic's warmup_stages: its history is the window's first
epochs, its parameters those after them), the reference over the same
epochs, with --control the reference in TF32, and with --faults the
program twice more: with half of each minibatch left out (the loss the
mean over the rest), and with the VGG term's weight 1% high (a fault of
one layer, where the cell has the term). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@contextlib.contextmanager
def half_batch():
    """The program's losses over the first half of each minibatch only."""
    from harp_tpu_torch.fit import driver

    orig = driver.compute_losses

    def broken(params, aux, fids, imgs, masks, masks_er, *args, **kw):
        h = fids.shape[0] // 2
        return orig(params, aux, fids[:h], imgs[:h], masks[:h], masks_er[:h], *args, **kw)

    driver.compute_losses = broken
    try:
        yield
    finally:
        driver.compute_losses = orig


def fit_readings(kind, control: bool, faults: bool, out_dir: str) -> dict:
    import dataclasses

    from benchmark.check import fit_numbers, reference_fit

    kind.warmup(os.path.join(out_dir, "prog"))
    prog = kind.warm
    epochs = prog["epochs"]
    cfg = kind.inputs.ref_config
    planted = {}
    if faults:
        with half_batch():
            kind.warmup(os.path.join(out_dir, "half"))
        planted["half_batch"] = kind.warm
        if kind.config.w_vgg > 0:
            sound = kind.config
            kind.config = dataclasses.replace(sound, w_vgg=sound.w_vgg * 1.01)
            kind.warmup(os.path.join(out_dir, "vgg"))
            kind.config = sound
            planted["vgg_weight"] = kind.warm
        kind.warm = prog
    ref = reference_fit(kind.inputs, epochs)
    rec = {"program": fit_numbers(prog["history"], prog["params"], ref, cfg, epochs)}
    for name, bad in planted.items():
        rec[name] = fit_numbers(bad["history"], bad["params"], ref, cfg, epochs)
    if control:
        ctl = reference_fit(kind.inputs, epochs, tf32=True)
        rec["control"] = fit_numbers(ctl["history"], {k: v.cpu() for k, v in
                                                      ctl["params"].items()}, ref, cfg, epochs)
    return rec


def main(argv=None) -> int:
    import torch

    from benchmark.inputs import make_inputs
    from benchmark.jobs import KINDS
    from benchmark.run import find_cell

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _, spec, traffic, _, _ = find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        inputs = make_inputs(spec, seed, dev, traffic)
        kind = KINDS[traffic["kind"]](inputs, traffic)
        with tempfile.TemporaryDirectory() as d:
            rec = fit_readings(kind, args.control, args.faults, d)
        line = {"workload": args.workload, "seed": seed, "s": time.perf_counter() - t0,
                **{side: {k: v["value"] for k, v in nums.items()} for side, nums in rec.items()},
                "at": {side: {k: v.get("at") for k, v in nums.items()}
                       for side, nums in rec.items()},
                "leaves": {side: nums["change_gap"]["leaves"] for side, nums in rec.items()},
                "terms": {side: nums["loss_gap"]["terms"] for side, nums in rec.items()}}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del kind, inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
