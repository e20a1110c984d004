"""Profiling and observability (harp_tpu/utils/profiling.py).

- Timer: wall clock around a block, synchronising the CUDA device first
  so that the block's queued kernels are inside the time.
- trace: torch.profiler around a block (CPU and CUDA activities), written
  as a Chrome trace.
- annotate: a named range in the profiler's trace and in NVTX.
- MetricsLogger: append-only JSONL scalars.

The card's measuring helpers (bench.py and chip_smoke.py):
- the published H100 peaks, bound_ms and nbytes: the least time the card
  could take for a function's bytes and operations;
- cuda_ms: a function's time over many launches, by CUDA events;
- device_record: the card's name, power limit and count;
- profile_window: one call under torch.profiler, in a window of its own:
  device busy ms and share, the top kernels and operators, and the longest
  idle gaps of the device timeline (idle_gaps) by the host op open when
  each began;
- trimmed_mean (bench.py's) and timing_stats.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import time

import numpy as np
import torch

# Published NVIDIA H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W):
# HBM3 bytes/s; FP32 outside the tensor cores, TF32 and bf16 tensor-core
# operations/s.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12
PEAK_BF16_S = 989e12


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


def bound_ms(nbytes: float, ops: float, peak_ops_s: float = PEAK_FP32_S):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move nbytes (each input read once, each output written once) and do
    `ops` operations at peak_ops_s, the larger of the two, and which one."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def cuda_ms(fn, iters: int) -> float:
    """fn's mean ms over `iters` back-to-back calls on the card, by CUDA
    events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_record() -> dict:
    """The card as nvidia-smi and torch see it: its name and power limit
    (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader, the
    first card's line) and the count of cards."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "power_limit": smi.rsplit(",", 1)[-1].strip(), "count": torch.cuda.device_count()}


def trimmed_mean(times) -> float:
    """bench.py's statistic: the mean of the fastest n - 2 of n samples
    (of the fastest one when n <= 2)."""
    k = max(len(times) - 2, 1)
    return sum(sorted(times)[:k]) / k


def timing_stats(times) -> dict:
    """trimmed_mean, median, min and max of the samples, and their count."""
    return {"trimmed_mean": trimmed_mean(times), "median": float(np.median(times)),
            "min": min(times), "max": max(times), "n": len(times)}


def idle_gaps(device, host, window=None, top: int = 10) -> list:
    """The longest stretches of the device timeline with no device event.

    device: (start, end, name) of each device event (kernel, copy, memset);
    host: (start, end, name) of each host op or record_function span; both
    on one clock, in microseconds (torch.profiler's). window: (start, end)
    of the stretch that counts, so that idle time before the first and
    after the last device event is a gap too; None counts from the first
    device event to the last. Device events may overlap. Returns at most
    `top` gaps, longest first: {"ms", "start_us", "host"}, where host is
    the innermost host interval open when the gap began (the latest to
    start among those with start <= t < end), None when none was."""
    busy = sorted((s, e) for s, e, _ in device if e > s)
    if window is None:
        if not busy:
            return []
        lo, hi = busy[0][0], max(e for _, e in busy)
    else:
        lo, hi = window
    gaps, cursor = [], lo
    for s, e in busy:
        if min(s, hi) > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    out = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        open_at = [h for h in host if h[0] <= g0 < h[1]]
        inner = max(open_at, key=lambda h: (h[0], -h[1]))[2] if open_at else None
        out.append({"ms": (g1 - g0) / 1e3, "start_us": g0, "host": inner})
    return out


_WINDOW = "profile_window"


def profile_window(run, kernel_names=None) -> dict:
    """One call of run() under torch.profiler (CPU and CUDA activities),
    in a window of its own, synchronised at both ends: its wall ms, the
    device's busy ms (the device events' self time) and busy share, the
    top 15 kernels by self time, the top 12 operators by the device time
    of the kernels they launched themselves, and the 10 longest idle gaps
    of the device timeline over the window (idle_gaps; at_ms from the
    window's start). kernel_names {label: pattern}: also "kernel_counts", the device
    events whose name holds each pattern (kernels replayed from a CUDA
    graph included, which no launch counter sees)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(_WINDOW):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, memcpy, memset): an operator's row
    # repeats the device time of the kernels it launched, and a
    # record_function span (this window's, the optimizers') has a copy on
    # the device's timeline that covers the kernels inside it.
    def on_device(e) -> bool:
        return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)

    avg = prof.key_averages()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in avg
                   if on_device(e) and e.self_device_time_total > 0), key=lambda r: -r[1])
    ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in avg
                  if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    events = prof.events()
    win = next(e.time_range for e in events
               if e.name == _WINDOW and e.device_type == DeviceType.CPU)
    dev_iv = [(e.time_range.start, e.time_range.end, e.name) for e in events if on_device(e)]
    host_iv = [(e.time_range.start, e.time_range.end, e.name) for e in events
               if e.device_type == DeviceType.CPU and e.name != _WINDOW]
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
           "top": [{"name": k[:80], "self_device_ms": ms, "count": c} for k, ms, c in rows[:15]],
           "top_ops": [{"op": k[:60], "self_device_ms": ms, "count": c}
                       for k, ms, c in ops[:12]],
           "idle_gaps": [{"ms": g["ms"], "at_ms": (g["start_us"] - win.start) / 1e3,
                          "host": g["host"] and g["host"][:80]}
                         for g in idle_gaps(dev_iv, host_iv, (win.start, win.end))]}
    if kernel_names:
        rec["kernel_counts"] = {k: sum(pat in name for _, _, name in dev_iv)
                                for k, pat in kernel_names.items()}
    return rec


def graph_kernel_counts(graph, kernel_names: dict) -> tuple:
    """The kernels one replay of a captured CUDA graph launches, read from
    the graph itself (a torch.cuda.CUDAGraph(keep_graph=True), as the
    epoch scan and the eval program keep theirs) through the driver API:
    ({label: the kernel nodes whose demangled function name holds the
    pattern}, the number of kernel nodes). Child graphs are walked too.
    Unlike a profiler's trace, this does not depend on every activity
    record of a replay reaching the trace: CUPTI drops some of the first
    graph launch after the profiler starts (PERF.md section 6)."""
    import ctypes

    vp, name_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)
    size_p, int_p = ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int)
    cu = ctypes.CDLL("libcuda.so.1")
    for fn, args in (("cuGraphGetNodes", [vp, vp, size_p]), ("cuGraphNodeGetType", [vp, int_p]),
                     ("cuGraphChildGraphNodeGetGraph", [vp, ctypes.POINTER(vp)]),
                     ("cuGraphKernelNodeGetParams_v2", [vp, vp]),
                     ("cuFuncGetName", [name_p, vp]), ("cuKernelGetName", [name_p, vp])):
        getattr(cu, fn).argtypes = args
        getattr(cu, fn).restype = ctypes.c_int
    cxx = ctypes.CDLL("libstdc++.so.6")
    cxx.__cxa_demangle.argtypes = [ctypes.c_char_p, vp, vp, int_p]
    cxx.__cxa_demangle.restype = vp
    libc = ctypes.CDLL(None)
    libc.free.argtypes = [vp]

    def check(rc: int, what: str) -> None:
        if rc:
            raise RuntimeError(f"graph_kernel_counts: {what} failed (CUresult {rc})")

    def demangle(name: bytes) -> str:
        status = ctypes.c_int()
        out = cxx.__cxa_demangle(name, None, None, ctypes.byref(status))
        if status.value or not out:
            return name.decode()
        text = ctypes.string_at(out).decode()
        libc.free(out)
        return text

    names = []

    def walk(g: int) -> None:
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (vp * n.value)()
        check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int()
            check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
            if kind.value == 4:  # CU_GRAPH_NODE_TYPE_GRAPH
                child = vp()
                check(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                      "cuGraphChildGraphNodeGetGraph")
                walk(child.value)
            elif kind.value == 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                # CUDA_KERNEL_NODE_PARAMS_v2: func at 0, kern (CUkernel) at 56.
                params = (ctypes.c_uint64 * 16)()
                check(cu.cuGraphKernelNodeGetParams_v2(node, params),
                      "cuGraphKernelNodeGetParams")
                name = ctypes.c_char_p()
                if params[0]:
                    check(cu.cuFuncGetName(ctypes.byref(name), params[0]), "cuFuncGetName")
                else:
                    check(cu.cuKernelGetName(ctypes.byref(name), params[7]), "cuKernelGetName")
                names.append(demangle(name.value))

    walk(int(graph.raw_cuda_graph()))
    return {k: sum(p in nm for nm in names) for k, p in kernel_names.items()}, len(names)
