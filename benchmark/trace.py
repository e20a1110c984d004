"""The traced sub-window: one whole job under torch.profiler.

Before the job, one replay of a small CUDA graph of the benchmark's own
absorbs CUPTI's loss of kernel records from the first graph launch after
the profiler starts. The job runs inside a record_function span that
marks the window. Once the run's window has closed, the profile is read
in memory from the kineto events (nothing is written to disk) into:

- busy_s: the union of the device's activity intervals (kernels, copies,
  memsets) inside the window; window_s: the window's length;
- kernels: device seconds and launches by kernel name, and the same for
  the kernels that graph replays launched (their correlation id is a
  cudaGraphLaunch's);
- breakdown: the ten device operations that took most time, and the ten
  longest idle gaps of the device, each named by the innermost host
  operation open when it began (the arithmetic of the program's
  utils/profiling.idle_gaps, copied here).
"""

from __future__ import annotations

import contextlib
import time

import torch

WINDOW = "benchmark.window"


def idle_gaps(device, host, window, top: int = 10) -> list:
    """(seconds, host op) of the `top` longest stretches of `window` with
    no device interval; device / host: (start, end, name) in ns."""
    busy = sorted((s, e) for s, e, _ in device if e > s)
    lo, hi = window
    gaps, cursor = [], lo
    for s, e in busy:
        if min(s, hi) > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    host = sorted(host)
    out = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        open_at = [h for h in host if h[0] <= g0 < h[1]]
        inner = max(open_at, key=lambda h: (h[0], -h[1]))[2] if open_at else "(no host op)"
        out.append([inner[:80], (g1 - g0) / 1e9])
    return out


def union_ns(intervals, lo: int, hi: int) -> int:
    total, cursor = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, cursor), min(e, hi)
        if e > s:
            total += e - s
            cursor = e
    return total


def _dummy_graph(device):
    x = torch.zeros(1024, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream(device).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        x.add_(1.0)
    return g


@contextlib.contextmanager
def traced(device, into: dict):
    """Profile the block as the window. `into` receives the profile and
    the seconds the profiler took to stop (kept out of the run's window);
    summarize(into) reads it once the window has closed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    dummy = _dummy_graph(device)
    torch.cuda.synchronize(device)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    dummy.replay()
    torch.cuda.synchronize(device)
    with record_function(WINDOW):
        yield
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    prof.stop()
    into.update({"_prof": prof, "overhead_s": time.perf_counter() - t0})


def summarize(into: dict) -> None:
    """The traced window's busy and window seconds, kernels and breakdown."""
    from torch.autograd import DeviceType

    events = into.pop("_prof").profiler.kineto_results.events()
    win = next(e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU)
    lo, hi = win.start_ns(), win.end_ns()
    dev, host, graph_corr = [], [], set()
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.name() == "cudaGraphLaunch":
                graph_corr.add(e.correlation_id())
            if e.name() != WINDOW and e.end_ns() > e.start_ns():
                host.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            s, t = e.start_ns(), e.end_ns()
            if t > lo and s < hi:
                dev.append((s, t, e.name(), e.correlation_id()))
    kernels, graph_kernels = {}, {}
    for s, t, name, corr in dev:
        for table in (kernels, graph_kernels) if corr in graph_corr else (kernels,):
            sec, n = table.get(name, (0.0, 0))
            table[name] = (sec + (t - s) / 1e9, n + 1)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    into.update({
        "window_s": (hi - lo) / 1e9,
        "busy_s": union_ns([(s, t) for s, t, _, _ in dev], lo, hi) / 1e9,
        "kernels": kernels, "graph_kernels": graph_kernels,
        "breakdown": {"device_ops": [[k[:80], v[0]] for k, v in top],
                      "idle_gaps": idle_gaps([d[:3] for d in dev], host, (lo, hi))},
    })
