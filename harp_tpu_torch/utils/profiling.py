"""Profiling and observability (harp_tpu/utils/profiling.py).

- Timer: wall clock around a block, synchronising the CUDA device first
  so that the block's queued kernels are inside the time.
- annotate: the port's one span recorder (a range in the profiler's trace
  and in NVTX, and a record in a bounded in-memory store, read by spans(),
  on the profiler's clock); fit_sequence and the epoch scan open spans.
- StepStamps, stamp, mark, step_parts: layer stamps of the train step on
  the device's clock, captured into the epoch scan's CUDA graph while a
  profiler records, and the step's split into layers from them.
- MetricsLogger: append-only JSONL scalars (fit_sequence's metrics.jsonl,
  its timing fields written from the spans).

The card's measuring helpers (bench.py and chip_smoke.py):
- the published H100 peaks, bound_ms and nbytes: the least time the card
  could take for a function's bytes and operations;
- cuda_ms: a function's time over many launches, by CUDA events;
- device_record: the card's name, power limit and count;
- profile_window: one call under torch.profiler, in a window of its own:
  device busy ms and share, the top kernels and operators, and the longest
  idle gaps of the device timeline (idle_gaps) by the host op open when
  each began;
- idle_by_span: a traced fit's device idle time by the innermost program
  span open when each idle stretch began (benchmark/gaps.py prints it);
- trimmed_mean (bench.py's) and timing_stats.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import json
import os
import subprocess
import threading
import time

import numpy as np
import torch

from harp_tpu_torch.csrc import build

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


SPAN_RING = 4096  # span records kept (a fit of 100 epochs in segments of 10 writes ~50)
_SPANS: collections.deque = collections.deque(maxlen=SPAN_RING)
_SPAN_IDS = itertools.count(1)
_OPEN = threading.local()  # the spans open on each thread, innermost last
FIT = "fit"  # the span that gives its id to the records inside it


@contextlib.contextmanager
def annotate(name: str):
    """The port's span: a record_function range (in any torch.profiler
    trace, beside the host ops), an NVTX range when CUDA is present, and a
    record in the process's span store (spans()). Yields the record, a dict:
    name, id, parent (the id of the innermost span open on this thread
    when it began, or None), fit (the id of the enclosing "fit" span, its
    own for a "fit" span, else None), start_ns and, once the block has
    ended, end_ns; the caller may add data to it. Times are time.time_ns(),
    the clock of the profiler's kineto events (Unix-epoch ns), taken
    inside the range. The record enters the store when the span ends."""
    stack = _OPEN.__dict__.setdefault("stack", [])
    parent = stack[-1] if stack else None
    rec = {"name": name, "id": next(_SPAN_IDS), "parent": parent["id"] if parent else None}
    rec["fit"] = rec["id"] if name == FIT else parent["fit"] if parent else None
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        stack.append(rec)
        rec["start_ns"] = time.time_ns()
        try:
            yield rec
        finally:
            rec["end_ns"] = time.time_ns()
            stack.pop()
            if nvtx:
                torch.cuda.nvtx.range_pop()
            _SPANS.append(rec)


def spans(fit: int | None = None) -> list:
    """The span store: copies of the last SPAN_RING ended spans' records of
    this process, in the order they ended; with `fit`, that fit's only."""
    return [dict(r) for r in list(_SPANS) if fit is None or r["fit"] == fit]


def span_s(rec: dict) -> float:
    """A span's seconds: an ended span's, an open span's so far."""
    return (rec.get("end_ns", time.time_ns()) - rec["start_ns"]) / 1e9


# ---------------------------------------------------------------------------
# Layer stamps of the train step
# ---------------------------------------------------------------------------

# A stamp table's columns. Forward (fit/driver.compute_losses): the step's
# start; after mesh_forward and the camera; before and after the VGG term
# (both written, back to back, where a step has none); the losses' end.
# Backward: the VGG input's and the vertices' gradients complete (marker
# nodes; unwritten, 0, where the step has no such gradient); after backward
# (TrainStep). Then the model's two, which the step writes inside its
# geometry: after the family's model forward in render/pipeline.mesh_forward
# ("posed"), and its output's gradient complete ("posed_grad", a marker).
# Last, after the two Adams, the step's end. The step writes the columns in
# this order but for the model's two; they come before the end so that the
# older columns keep their places.
STAMP_SLOTS = ("start", "camera", "vgg_in", "vgg_out", "losses", "vgg_grad", "verts_grad",
               "backward", "posed", "posed_grad", "adam")
_COL = {s: i for i, s in enumerate(STAMP_SLOTS)}


def stamps_on() -> bool:
    """Whether a torch.profiler is recording: the epoch scan captures its
    step with stamps only then (and stamps its eager steps only then)."""
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


def stamp_library():
    """The stamp kernel's library (csrc/stamp.cu), built on first use."""
    lib = build.load("stamp")
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.write_stamp.argtypes = [P, P, I, I, P]
        lib.write_stamp.restype = I
        lib._typed = True
    return lib


class StepStamps:
    """One step's row of a stamp table: table (rows, len(STAMP_SLOTS))
    int64, the row the device tensor cursor (1,) int64 holds when the
    stamp runs. On a CUDA table a stamp is csrc/stamp.cu's kernel on the
    current stream (the device's %globaltimer once the work before it is
    done; capturable into a CUDA graph); on a CPU table, the host's
    time.monotonic_ns(), written without reading the cursor."""

    def __init__(self, table: torch.Tensor, cursor: torch.Tensor):
        self.table, self.cursor = table, cursor

    def __call__(self, slot: str) -> None:
        col, ncols = _COL[slot], self.table.shape[1]
        if self.table.is_cuda:
            rc = stamp_library().write_stamp(
                self.table.data_ptr(), self.cursor.data_ptr(), ncols, col,
                torch.cuda.current_stream(self.table.device).cuda_stream)
            build.check(rc, "write_stamp")
        else:
            self.table.view(-1).index_fill_(0, self.cursor * ncols + col, time.monotonic_ns())


class _GradStamp(torch.autograd.Function):
    """Identity; its backward stamps when the gradient of its input is
    complete (autograd sums every use's gradient before calling it) and
    passes that gradient on unchanged."""

    @staticmethod
    def forward(ctx, x, stamps, slot):
        ctx.stamps, ctx.slot = stamps, slot
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.stamps(ctx.slot)
        return g, None, None


def stamp(stamps: StepStamps | None, slot: str) -> None:
    """Write `slot` of the step's row; nothing when stamps is None."""
    if stamps is not None:
        stamps(slot)


def mark(stamps: StepStamps | None, x: torch.Tensor, slot: str) -> torch.Tensor:
    """x through a marker node whose backward stamps `slot`; x itself
    (no node) when stamps is None or x needs no gradient."""
    if stamps is None or not x.requires_grad:
        return x
    return _GradStamp.apply(x, stamps, slot)


def step_parts(t) -> dict:
    """A stamp table's rows (n, len(STAMP_SLOTS)) -> {part: (n,) ns}. Each
    stretch of a step between two stamps belongs to one part, so the parts
    sum to "step", the start to the end:
    - geometry: start to camera (mesh_forward, the camera), and the
      vertices' gradient to the end of backward (their backward);
    - render: camera to vgg_in (raster, silhouette, pixel geometry, shadow,
      shading, the geometric and photometric losses) and the VGG input's
      gradient to the vertices' (their backward);
    - vgg: vgg_in to vgg_out, and the losses' end to the VGG input's
      gradient. That backward stretch also holds the backward of the loss
      sum and of the two texture regularisers, made after the VGG term;
    - other: vgg_out to the losses' end (the regularisers' forward);
    - adam: after backward to after the two Adams (with a mesh, the
      gradient all-reduce too).
    An unwritten gradient stamp (0) takes the time that makes its part's
    backward stretch empty: the VGG input's the losses' end, the vertices'
    and the model's the end of backward.
    "model", a part of geometry and not in the sum: start to posed (the
    family's model forward: MANO, the arm or NIMBLE) and the model output's
    gradient to the end of backward (its backward to the parameters)."""
    t = np.asarray(t, np.int64)
    c = {s: t[:, i] for i, s in enumerate(STAMP_SLOTS)}
    vgg_grad = np.where(c["vgg_grad"] == 0, c["losses"], c["vgg_grad"])
    verts_grad = np.where(c["verts_grad"] == 0, c["backward"], c["verts_grad"])
    posed_grad = np.where(c["posed_grad"] == 0, c["backward"], c["posed_grad"])
    return {"geometry": (c["camera"] - c["start"]) + (c["backward"] - verts_grad),
            "model": (c["posed"] - c["start"]) + (c["backward"] - posed_grad),
            "render": (c["vgg_in"] - c["camera"]) + (verts_grad - vgg_grad),
            "vgg": (c["vgg_out"] - c["vgg_in"]) + (vgg_grad - c["losses"]),
            "other": c["losses"] - c["vgg_out"],
            "adam": c["adam"] - c["backward"],
            "step": c["adam"] - c["start"]}


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


def _gaps(busy, lo, hi) -> list:
    """(start, end) of the stretches of [lo, hi) that no interval of
    `busy` (sorted (start, end)) covers."""
    gaps, cursor = [], lo
    for s, e in busy:
        if min(s, hi) > cursor:
            gaps.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    return gaps


def _innermost(intervals, t):
    """The name of the innermost (start, end, name) open at t (the latest
    to start among those with start <= t < end), None when none is."""
    open_at = [h for h in intervals if h[0] <= t < h[1]]
    return max(open_at, key=lambda h: (h[0], -h[1]))[2] if open_at else None


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
    return [{"ms": (g1 - g0) / 1e3, "start_us": g0, "host": _innermost(host, g0)}
            for g0, g1 in sorted(_gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:top]]


def idle_by_span(device, recs, window, top: int = 10) -> dict:
    """The device's idle time in `window` put down to the program's spans.

    device: (start_ns, end_ns) of each device event; recs: span records
    (spans(), a fit's); window: (start_ns, end_ns); all on the spans' clock,
    which is that of torch.profiler's kineto events (their start_ns() and
    end_ns()). Each idle stretch belongs to the innermost span open when
    it began (None: no span). Returns {"window_s", "busy_s", "idle_s":
    {span name: idle seconds}, largest first, "longest": the `top`
    longest stretches, [{"s", "span"}]}."""
    lo, hi = window
    busy = sorted((max(s, lo), min(e, hi)) for s, e in device if min(e, hi) > max(s, lo))
    gaps = _gaps(busy, lo, hi)
    iv = [(r["start_ns"], r["end_ns"], r["name"]) for r in recs if "end_ns" in r]
    by_span: dict = {}
    for g0, g1 in gaps:
        name = _innermost(iv, g0)
        by_span[name] = by_span.get(name, 0) + (g1 - g0)
    idle = sum(g1 - g0 for g0, g1 in gaps)
    return {"window_s": (hi - lo) / 1e9, "busy_s": (hi - lo - idle) / 1e9,
            "idle_s": {k: v / 1e9 for k, v in sorted(by_span.items(), key=lambda kv: -kv[1])},
            "longest": [{"s": (g1 - g0) / 1e9, "span": _innermost(iv, g0)}
                        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:top]]}


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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with annotate(_WINDOW):
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
