"""The readers of the program's span store (benchmark/metrics/_spans.py) on
hand-built stores: the step's parts over the traced fit's replayed steps,
the turnaround between its segments net of their actions, the first fit's wall; and None from a
program without the store."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.metrics import _spans
from harp_tpu_torch.utils import profiling

MS = 1_000_000


def row(t0: int, step_ms: int = 10) -> list:
    """Stamps of one step from t0: slot i at t0 + i ms, the end at t0 + step_ms ms."""
    r = [t0 + i * MS for i in range(len(profiling.STAMP_SLOTS))]
    r[-1] = t0 + step_ms * MS
    return r


def segment(fit: int, start: int, rows: list, eager: int, flags=(True, True)) -> dict:
    return {"name": "segment.read", "fit": fit, "start_ns": start, "end_ns": start + 1,
            "stamps": {"flags": list(flags), "eager": eager, "t": np.array(rows, np.int64)}}


def store() -> list:
    """The traced fit (id 5): a first segment with one eager step, a second
    one; a later stamped fit (id 9) that the readers leave out; two fit
    spans, the first the warm-up's."""
    base = 10**18
    return [
        {"name": "fit", "fit": 1, "start_ns": base - 4 * 10**9, "end_ns": base - 10**9},
        segment(5, base, [row(base, 50), row(base + 60 * MS), row(base + 80 * MS, 12)], 1),
        {"name": "segment.actions", "fit": 5, "start_ns": base + 2, "end_ns": base + 2 + 30 * MS},
        segment(5, base + 10**9, [row(base + 200 * MS), row(base + 220 * MS, 14)], 0),
        segment(9, base + 5 * 10**9, [row(base + 5 * 10**9, 99)], 0),
        {"name": "fit", "fit": 5, "start_ns": base - 10**8, "end_ns": base + 2 * 10**9},
    ]


@pytest.fixture
def fake_store(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda fit=None: [dict(r) for r in store()])


def test_the_step_and_its_parts_over_the_traced_fits_replayed_steps(fake_store):
    # Replayed steps: 10, 12, 10, 14 ms (the eager 50 ms one and fit 9's left out).
    assert _spans.part_ms({}, "step") == pytest.approx(11.0)
    parts = {k: _spans.part_ms({}, k) for k in ("geometry", "render", "vgg", "other", "adam")}
    assert parts == {"geometry": 2.0, "render": 2.0, "vgg": 2.0, "other": 1.0,
                     "adam": pytest.approx(4.0)}


def test_the_turnaround_between_segments_of_a_stage(fake_store):
    # The first segment's last step ends at 92 ms, the next one's first starts
    # at 200 ms; 30 ms of actions between them.
    assert _spans.turnaround_ms({}) == pytest.approx(78.0)


def test_the_turnaround_is_the_median_boundary_net_of_its_actions(monkeypatch):
    """Four segments of a stage: gaps of 100, 20 and 30 ms, the second with
    10 ms of actions: the median of 100, 10 and 30 (their mean would be 46.7);
    a segment of another stage makes no boundary."""
    base = 10**18
    recs = [segment(3, base, [row(base)], 0),
            segment(3, base + 10**9, [row(base + 110 * MS)], 0),
            {"name": "segment.actions", "fit": 3, "start_ns": base + 10**9 + 2,
             "end_ns": base + 10**9 + 2 + 10 * MS},
            segment(3, base + 2 * 10**9, [row(base + 140 * MS)], 0),
            segment(3, base + 3 * 10**9, [row(base + 180 * MS)], 0),
            segment(3, base + 4 * 10**9, [row(base + 900 * MS)], 0, flags=(False, True))]
    monkeypatch.setattr(profiling, "spans", lambda fit=None: [dict(r) for r in recs])
    assert _spans.turnaround_ms({}) == pytest.approx(30.0)


def test_the_warmup_fit_is_the_first_fit_span(fake_store):
    assert _spans.warmup_fit_s({}) == pytest.approx(3.0)


def test_without_the_store_every_reader_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    assert _spans.part_ms({}, "step") is None
    assert _spans.turnaround_ms({}) is None and _spans.warmup_fit_s({}) is None


def test_a_store_with_no_stamps_reads_none(monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda fit=None: [])
    assert _spans.part_ms({}, "vgg") is None and _spans.turnaround_ms({}) is None
