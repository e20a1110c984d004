"""Profiling and observability (harp_tpu/utils/profiling.py).

- Timer: wall clock around a block, synchronising the CUDA device first
  so that the block's queued kernels are inside the time.
- trace: torch.profiler around a block (CPU and CUDA activities), written
  as a Chrome trace.
- annotate: a named range in the profiler's trace and in NVTX.
- MetricsLogger: append-only JSONL scalars.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


class Timer:
    """with Timer(device) as t: ...; t.elapsed in seconds. A CUDA device
    is synchronised on exit; None or a CPU device is not."""

    def __init__(self, device=None):
        self._device = torch.device(device) if device is not None else None

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self.elapsed = time.perf_counter() - self.start
        return False


@contextlib.contextmanager
def trace(log_dir: str, cuda: bool = True):
    """torch.profiler over the block; the Chrome trace goes to
    log_dir/trace.json. Yields the profiler (key_averages() for sums)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range: record_function for torch.profiler, and an NVTX range
    when CUDA is present."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


class MetricsLogger:
    """Append-only JSONL scalar logger: one {"step", "ts", ...} per log;
    numbers as floats, flags as booleans."""

    def __init__(self, out_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._f = open(self.path, "a")

    def log(self, step: int, **scalars) -> None:
        rec = {"step": step, "ts": time.time()}
        rec.update({k: v if isinstance(v, bool) else float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
