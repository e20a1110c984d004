"""The NIMBLE family (families/nimble.py, configs/nimble_448.json) on the
CPU at a tiny size, and the step.model_ms reader:

- a tiny NIMBLE cell (the published stand-in at 64^2, 4 frames, batch 2)
  runs through run_cell to `correct` true, and with half of each batch left
  out to `correct` false;
- step.model_ms reads the median model part of the traced fit's replayed
  steps from a hand-built store, and None from a program whose stamp
  table has no "posed" slot or that has no span store.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os

import numpy as np
import pytest

from benchmark.tests.conftest import REPO, tiny_spec
from benchmark.tests.test_bench_families import add_cell, run, shared_files_differ


def tiny_nimble() -> dict:
    spec = dict(tiny_spec("nimble_448"), name="tiny_nimble_cfg")
    spec["harp_config"]["raster_cap"] = 4096  # 11956 faces over a 64^2 image's 16 tiles
    return spec


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_a_tiny_nimble_cell_is_correct_and_a_fault_is_not(bench_copy, tmp_path, fault):
    from benchmark.control import half_batch

    root, mod = bench_copy
    add_cell(root, "tiny_nimble.fit", tiny_nimble())
    assert shared_files_differ(root) == []
    with half_batch() if fault else contextlib.nullcontext():
        res = run(mod, "tiny_nimble.fit", tmp_path)
    assert res["failed"] == 0 and res["attempted"] == 1
    assert res["correct"] == (fault is None), res["compared"]


def _reader():
    path = os.path.join(REPO, "benchmark", "metrics", "step.model_ms.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_step_model_ms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


MS = 1_000_000


def _store(model_ms: list) -> list:
    """One traced fit (id 5) of one segment: an eager step, then replayed
    steps whose model part is model_ms[i] (1 ms forward, the rest
    backward)."""
    from harp_tpu_torch.utils import profiling

    col = {s: i for i, s in enumerate(profiling.STAMP_SLOTS)}
    base, rows = 10**18, []
    for i, m in enumerate([99.0] + model_ms):
        t0 = base + i * 100 * MS
        r = np.zeros(len(col), np.int64)
        for s, at in (("start", 0), ("posed", 1), ("camera", 2), ("vgg_in", 3), ("vgg_out", 4),
                      ("losses", 5), ("vgg_grad", 6), ("verts_grad", 7), ("adam", 60)):
            r[col[s]] = t0 + at * MS
        r[col["backward"]] = t0 + 50 * MS
        r[col["posed_grad"]] = r[col["backward"]] - int((m - 1) * MS)
        rows.append(r)
    return [{"name": "segment.read", "fit": 5, "start_ns": base, "end_ns": base + 1,
             "stamps": {"flags": [True, True], "eager": 1, "t": np.stack(rows)}}]


def test_step_model_ms_reads_the_median_model_part(monkeypatch):
    from harp_tpu_torch.utils import profiling

    recs = _store([3.0, 5.0, 4.0])
    monkeypatch.setattr(profiling, "spans", lambda fit=None: [dict(r) for r in recs])
    assert _reader()({}) == pytest.approx(4.0)


def test_step_model_ms_reads_none_without_the_model_stamps(monkeypatch):
    from harp_tpu_torch.utils import profiling

    recs = _store([3.0])
    monkeypatch.setattr(profiling, "spans", lambda fit=None: [dict(r) for r in recs])
    old = tuple(s for s in profiling.STAMP_SLOTS if s not in ("posed", "posed_grad"))
    monkeypatch.setattr(profiling, "STAMP_SLOTS", old)
    assert _reader()({}) is None
    monkeypatch.delattr(profiling, "spans")
    assert _reader()({}) is None
