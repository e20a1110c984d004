"""The general generator: a cell's jobs, as its traffic file describes them.

A traffic file's "kind" picks the job, its other keys parametrise it:

- "fit": one fit_sequence of the whole sequence from a fresh copy of the
  initial parameters, as the CLI calls it (epoch_scan, image_log_every,
  an out_dir), over the traffic's "stages"; set-up runs one such fit over
  "warmup_stages". The fit's own minibatch seed is the CLI's (0).

Jobs run back to back (a closed loop of one user): a job starts while
fewer than the window's seconds have passed, and every job counts whole.
Each job's files go under a directory of its own below TMPDIR.
"""

from __future__ import annotations

import json
import math
import os
import time

import torch

from benchmark.check import OVERFLOW_KEYS
from benchmark.inputs import Inputs, harp_kwargs, port_assets


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read_jsonl(path: str) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class FitCell:
    """The program's objects that every fit job shares, built from the
    inputs at set-up, and the jobs."""

    def __init__(self, inputs: Inputs, traffic: dict):
        from harp_tpu_torch.config import HarpConfig
        from harp_tpu_torch.fit.driver import FitData
        from harp_tpu_torch.fit.params import init_params
        from harp_tpu_torch.losses.perceptual import Vgg16Features

        self.inputs, self.traffic = inputs, traffic
        self.device = inputs.device
        self.config = HarpConfig(**harp_kwargs(inputs.spec, traffic))
        self.rcfg = self.config.raster_config()
        self.assets = port_assets(inputs)
        self.extras = inputs.family.program_extras(inputs)
        self.data = FitData(inputs.images, inputs.masks, inputs.masks_eroded)
        self.params0, self.aux = init_params(inputs.input_params, self.assets, self.config,
                                             device=self.device)
        self.vgg = Vgg16Features(inputs.vgg_weights, compute_dtype=self.config.vgg_compute_dtype,
                                 device=self.device)
        n = inputs.images.shape[0]
        self.batch = min(self.config.batch_size, n)
        self.frames_per_epoch = max(n // self.batch, 1) * self.batch
        self.first_history = None
        self.warm = None

    def release(self) -> None:
        """Drop the program's state before the reference runs."""
        for k in ("assets", "extras", "data", "params0", "aux", "vgg"):
            self.__dict__.pop(k, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _fit(self, config, out_dir: str):
        from harp_tpu_torch.fit.driver import fit_sequence

        params = {k: v.detach().clone().requires_grad_(True) for k, v in self.params0.items()}
        return fit_sequence(config, self.assets, self.data, params, self.aux, rcfg=self.rcfg,
                            vgg=self.vgg, out_dir=out_dir, extras=self.extras,
                            image_log_every=self.traffic["image_log_every"],
                            epoch_scan=self.traffic["epoch_scan"], device=self.device)

    def warmup(self, out_dir: str) -> None:
        """One fit over warmup_stages: an eager step, a capture and replays
        of each stage the window runs. Its parameters are the program's
        after those steps, which the check compares."""
        import dataclasses

        stages = tuple(self.traffic["warmup_stages"])
        cfg = dataclasses.replace(self.config, training_stage=stages, total_epoch=sum(stages))
        params, history = self._fit(cfg, out_dir)
        self.warm = {"epochs": sum(stages), "history": history,
                     "params": {k: v.detach().cpu() for k, v in params.items()}}

    def job(self, out_dir: str) -> dict:
        t0 = time.perf_counter()
        failed = None
        history = []
        try:
            _, history = self._fit(self.config, out_dir)
        except Exception as exc:  # a job that raises counts as failed
            failed = f"{type(exc).__name__}: {exc}"
        _sync(self.device)
        wall = time.perf_counter() - t0
        if failed is None:
            bad = [h["epoch"] for h in history if not math.isfinite(h["loss"])]
            over = sorted({k for h in history for k in OVERFLOW_KEYS if h.get(k, 0.0)})
            if bad or over or len(history) != self.config.total_epoch:
                failed = (f"{len(history)} epochs; non-finite loss in epochs {bad[:5]}; "
                          f"raster overflow {over}")
        if self.first_history is None:
            self.first_history = history
        lines = _read_jsonl(os.path.join(out_dir, "metrics.jsonl"))
        return {"wall_s": wall, "failed": failed,
                "work": len(history) * self.frames_per_epoch,
                "steps": len(history) * self.frames_per_epoch // self.batch,
                "actions_s": [r["actions_s"] for r in lines if "actions_s" in r],
                "capture_s": [r["capture_s"] for r in lines if "capture_s" in r]}


KINDS = {"fit": FitCell}
