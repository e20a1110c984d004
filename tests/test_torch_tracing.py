"""harp_tpu_torch's tracing (utils/profiling.py) on the CPU: the span store
(nesting, its bound, its clock against torch.profiler's events), the train
step's layer stamps (on the CPU the host's monotonic clock: a CUDA stamp
reads the card's timer inside the step's graph, tests/test_torch_cuda.py),
and the fit's spans behind metrics.jsonl's timing fields. The scene is the
bench's (harp_tpu_torch/bench._scene) at 32^2, two frames, VGG in bf16 from
the cached GT pyramids. Times taken here are the CPU's and are never read
as the card's."""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from harp_tpu_torch import bench
from harp_tpu_torch.fit.driver import (
    FitData, compute_losses, fit_sequence, make_epoch_scan, make_train_step,
)
from harp_tpu_torch.fit.optimizer import DevicePlateau, PlateauState
from harp_tpu_torch.utils import profiling
from harp_tpu_torch.utils.debug_nans import DebugNans
from harp_tpu_torch.utils.profiling import (
    SPAN_RING, STAMP_SLOTS, StepStamps, annotate, span_s, spans, step_parts,
)

SMALL = dict(img=32, texture=64, density="light",
             raster_kw=dict(tile=8, cap=1024, face_chunk=256, faces_per_pixel=16,
                            span_tiles=4, active_fraction=1.0))
PARTS = ("geometry", "render", "vgg", "other", "adam")


@pytest.fixture(scope="module")
def scene():
    return bench._scene(2, use_arm=False, use_vgg=True, device="cpu", **SMALL)


def _fresh(params: dict) -> dict:
    return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _markers(total: torch.Tensor) -> int:
    """The marker nodes in the autograd graph behind `total`."""
    seen, todo, n = set(), [total.grad_fn], 0
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        n += type(node).__name__ == "_GradStampBackward"
        todo.extend(f for f, _ in node.next_functions)
    return n


def test_spans_nest_and_record_their_parents():
    with annotate("outside") as outside:
        pass
    with annotate("fit") as fit:
        with annotate("a") as a:
            with annotate("b") as b:
                pass
        with annotate("c") as c:
            pass
    recs = spans(fit["id"])
    assert [r["name"] for r in recs] == ["b", "a", "c", "fit"]  # in the order they ended
    assert [r["parent"] for r in recs] == [a["id"], fit["id"], fit["id"], None]
    assert {r["fit"] for r in recs} == {fit["id"]}
    assert outside["fit"] is None and outside["parent"] is None
    assert fit["start_ns"] <= a["start_ns"] <= b["start_ns"] <= b["end_ns"] <= a["end_ns"]
    assert a["end_ns"] <= c["start_ns"] <= c["end_ns"] <= fit["end_ns"]
    assert span_s(fit) == (fit["end_ns"] - fit["start_ns"]) / 1e9 >= span_s(a) + span_s(c)


def test_the_span_store_stays_bounded():
    first = None
    for i in range(SPAN_RING + 10):
        with annotate("many") as rec:
            first = first or rec["id"]
    recs = spans()
    assert len(recs) == SPAN_RING
    assert [r["id"] for r in recs] == list(range(first + 10, first + SPAN_RING + 10))


def test_idle_time_goes_to_the_innermost_span_open_when_it_began():
    """idle_by_span on hand-built intervals (ns): device events clipped to
    the window, each idle stretch the innermost span's at its start (a
    stretch that begins before any span: None)."""
    device = [(-5, 5), (10, 20), (15, 30), (50, 60), (95, 120)]
    recs = [{"name": "segment.read", "start_ns": 25, "end_ns": 55},
            {"name": "segment.actions", "start_ns": 70, "end_ns": 90},
            {"name": "fit", "start_ns": 6, "end_ns": 100}]
    got = profiling.idle_by_span(device, recs, (0, 100), top=2)
    assert got["idle_s"] == {"fit": 35e-9, "segment.read": 20e-9, None: 5e-9}
    assert list(got["idle_s"]) == ["fit", "segment.read", None]
    assert got["window_s"] == 100e-9 and got["busy_s"] == 40e-9
    assert got["longest"] == [{"s": 35e-9, "span": "fit"}, {"s": 20e-9, "span": "segment.read"}]


def test_a_span_starts_with_its_profiler_event():
    """A span's record and its record_function event agree within 1 ms on
    the profiler's clock (kineto's events are Unix-epoch ns)."""
    with annotate("warm-up"):  # the first record_function of a process is slow
        pass
    with _profiled() as prof:
        with annotate("fit") as fit:
            for i in range(3):
                with annotate(f"span{i}"):
                    torch.ones(8).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU}
    recs = spans(fit["id"])
    assert len(recs) == 4
    for r in recs:
        e = events[r["name"]]
        assert abs(r["start_ns"] - e.start_ns()) < 1_000_000, r["name"]
        assert abs(r["end_ns"] - e.end_ns()) < 1_000_000, r["name"]


@pytest.mark.parametrize("traced,markers,stamps", [(False, 0, 0), (True, 2, 9)],
                         ids=["tracing_off", "tracing_on"])
def test_the_steps_marker_nodes_and_stamps(scene, monkeypatch, traced, markers, stamps):
    """compute_losses and its backward with a stamp row (tracing on) and
    without: two marker nodes (the vertices, the VGG input) and every slot
    stamped once, or no node and no stamp; the loss and every gradient the
    same bits either way."""
    written = []
    real = StepStamps.__call__
    monkeypatch.setattr(StepStamps, "__call__",
                        lambda self, slot: (written.append(slot), real(self, slot)))
    table = torch.zeros(1, len(STAMP_SLOTS), dtype=torch.int64)
    sc = scene

    def losses_and_grads(row):
        params = _fresh(sc.params)
        total, _ = compute_losses(params, sc.aux, sc.fids, sc.images, sc.masks, sc.masks_er,
                                  sc.assets, sc.config, sc.rcfg, sc.ref_verts, True, True,
                                  vgg=sc.vgg, key=np.array([0, 7], np.uint32), stamps=row)
        n = _markers(total)
        total.backward()
        return total.detach(), {k: p.grad for k, p in params.items()}, n

    plain_total, plain_grads, _ = losses_and_grads(None)
    written.clear()
    total, grads, n = losses_and_grads(StepStamps(table, torch.zeros(1, dtype=torch.int64))
                                       if traced else None)
    assert n == markers
    assert len(written) == stamps - 2 * traced  # backward and adam are TrainStep's
    assert torch.equal(total, plain_total)
    for k, g in grads.items():
        assert (g is None and plain_grads[k] is None) or torch.equal(g, plain_grads[k]), k


@pytest.mark.parametrize("traced", [False, True], ids=["tracing_off", "tracing_on"])
def test_the_epoch_scan_stamps_only_under_a_profiler(scene, monkeypatch, traced):
    """A segment of the epoch scan (eager on the CPU): under a CPU profiler
    every step stamps every slot, the parts are non-negative and sum to the
    step; without one the runner has no stamp table and calls no stamp."""
    sc = scene
    if not traced:
        monkeypatch.setattr(StepStamps, "__call__", lambda self, slot: pytest.fail("stamped"))
    step = make_train_step(sc.assets, sc.config, sc.rcfg, _fresh(sc.params), device="cpu",
                           vgg=sc.vgg)
    scan = make_epoch_scan(step, FitData(sc.images, sc.masks, sc.masks_er), sc.aux,
                           sc.ref_verts, DevicePlateau.of(PlateauState(), torch.device("cpu")),
                           coarse_on=True, app_on=True, epochs=2, steps=1, batch=2, graph=False)
    with _profiled() if traced else contextlib.nullcontext():
        scan.upload(np.array([[[0, 1]], [[1, 0]]]), np.array([[[0, 3]], [[0, 4]]]))
        scan.run(3, 0.5)
    rows = scan.stamp_rows()
    if not traced:
        assert rows is None
        return
    t = rows.numpy()
    assert t.shape == (2, len(STAMP_SLOTS)) and (t > 0).all()
    assert scan.eager_rows == 2
    parts = step_parts(t)
    for k in PARTS:
        assert (parts[k] >= 0).all(), k
    assert (sum(parts[k] for k in PARTS) == parts["step"]).all()
    assert (parts["step"] > 0).all() and (t[1, 0] >= t[0, -1])


@pytest.mark.parametrize("traced,nans", [(False, False), (True, False), (True, True)],
                         ids=["tracing_off", "tracing_on", "tracing_on_debug_nans"])
def test_a_fit_writes_its_timing_fields_from_its_spans(scene, tmp_path, monkeypatch, traced,
                                                       nans):
    """fit_sequence(epoch_scan=2) over stages (1, 2, 0): its spans, and
    metrics.jsonl's timing fields equal to their seconds; under a profiler
    each segment's read carries its eager steps' stamps. Under --debug-nans
    too, with every stamp's low 32 bits a NaN's as float32: the segment's
    read holds no stamp as a float."""
    sc = scene
    config = dataclasses.replace(sc.config, training_stage=(1, 2, 0), total_epoch=3)
    aux = {k: v for k, v in sc.aux.items() if k != "vgg_gt"}  # the fit caches it
    if nans:  # the host's microseconds in the high half, a quiet NaN in the low
        clock = profiling.time.monotonic_ns
        t0 = clock()
        monkeypatch.setattr(profiling.time, "monotonic_ns",
                            lambda: (((clock() - t0) // 1000) << 32) | 0x7FC00000)
    with contextlib.ExitStack() as ctx:
        if traced:
            ctx.enter_context(_profiled())
        if nans:
            ctx.enter_context(DebugNans())
        _, history = fit_sequence(config, sc.assets, FitData(sc.images, sc.masks, sc.masks_er),
                                  _fresh(sc.params), aux, rcfg=sc.rcfg, vgg=sc.vgg,
                                  out_dir=str(tmp_path), image_log_every=1, epoch_scan=2,
                                  device="cpu")
    assert len(history) == 3
    fit = max((r for r in spans() if r["name"] == "fit"), key=lambda r: r["id"])
    recs = spans(fit["id"])
    names = [r["name"] for r in recs]
    assert names.count("fit.setup") == names.count("fit.vgg_gt") == 1
    for name in ("segment.upload", "segment.replays", "segment.read", "segment.actions"):
        assert names.count(name) == 2, name  # [0] coarse, [1, 2] both
    assert names.count("scan.close") == 2 and names[-2:] == ["fit.drain", "fit"]
    by = {n: [r for r in recs if r["name"] == n] for n in set(names)}
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    timing = {k: [r[k] for r in lines if k in r] for k in
              ("setup_total_s", "vgg_gt_materialize_s", "segment_s", "actions_s", "fit_s")}
    assert timing["setup_total_s"] == [pytest.approx(span_s(by["fit.setup"][0]))]
    assert timing["vgg_gt_materialize_s"] == [pytest.approx(span_s(by["fit.vgg_gt"][0]))]
    assert timing["actions_s"] == [pytest.approx(span_s(r)) for r in by["segment.actions"]]
    assert timing["segment_s"] == [
        pytest.approx((r["end_ns"] - u["start_ns"]) / 1e9)
        for u, r in zip(by["segment.upload"], by["segment.read"])]
    assert len(timing["fit_s"]) == 1 and 0 < timing["fit_s"][0] <= span_s(fit)
    reads = by["segment.read"]
    if not traced:
        assert not any("stamps" in r for r in reads)
        return
    assert [r["stamps"]["flags"] for r in reads] == [[True, False], [True, True]]
    for r, n in zip(reads, (1, 2)):
        t = r["stamps"]["t"]
        assert t.shape == (n, len(STAMP_SLOTS)) and r["stamps"]["eager"] == n
        parts = step_parts(t)
        assert all((parts[k] >= 0).all() for k in PARTS)
        assert (sum(parts[k] for k in PARTS) == parts["step"]).all()
    # Stage 1 has no VGG term: its VGG stretches are empty (up to the stamps' own cost).
    coarse = step_parts(reads[0]["stamps"]["t"])
    assert (coarse["vgg"] < coarse["step"] / 100).all()
