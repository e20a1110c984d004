"""The harness driven on the CPU at a tiny size: cells, traffic and
per-layer metrics found by name from data files alone; `correct` true on
the program as it is and false with the timed path broken underneath
(a step that leaves its state unchanged, half of each batch left out, the
VGG term weighted 1% high); the trace arithmetic on hand-built
timelines."""

from __future__ import annotations

import contextlib
import json
import time

import pytest
import torch

CPU = torch.device("cpu")


def run(mod, name, tmp_path, trace=False):
    return mod.run_cell(name, 2**31 + 7, 1e-3, trace, CPU, time.perf_counter(),
                        str(tmp_path / "out"))


def test_a_new_cell_traffic_and_metric_are_found_by_name(bench_copy, tmp_path):
    root, mod = bench_copy
    cell, spec, traffic, e2e, layers = mod.find_cell("tiny.fit")
    assert spec["name"] == "tiny_hand" and traffic["stages"] == [0, 2, 0]
    assert {m["name"] for m in e2e} == {"fit_frames_per_s", "setup_s"}
    assert "tiny.jobs" in {m["name"] for m in layers}
    assert mod.reader("tiny.jobs")({"jobs": [1, 2]}) == 2.0
    res = run(mod, "tiny.fit", tmp_path, trace=True)
    assert res["metrics"]["tiny.jobs"]["value"] == res["attempted"] == 1


def test_a_fit_cell_is_correct_on_the_program(bench_copy, tmp_path):
    root, mod = bench_copy
    res = run(mod, "tiny.fit", tmp_path)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] == 1
    assert set(res["metrics"]) == {"fit_frames_per_s", "setup_s"}
    with open(root / "benchmark" / "limits" / "tiny.fit.json") as f:
        assert set(res["compared"]) == set(json.load(f))


@contextlib.contextmanager
def unchanged_state():
    """A step that returns its state unchanged: the program's Adams never
    step (the reference's own are untouched)."""
    from harp_tpu_torch.fit import driver

    orig = driver.build_optimizers

    def frozen(params, config):
        opts = orig(params, config)
        for opt in opts.values():
            opt.step = lambda closure=None: None
        return opts

    driver.build_optimizers = frozen
    try:
        yield
    finally:
        driver.build_optimizers = orig


@contextlib.contextmanager
def vgg_weight():
    """A fault of one layer: the program's VGG term weighted 1% high."""
    from harp_tpu_torch import config

    orig = config.HarpConfig

    def heavy(**kw):
        return orig(**dict(kw, w_vgg=kw.get("w_vgg", 1.0) * 1.01))

    config.HarpConfig = heavy
    try:
        yield
    finally:
        config.HarpConfig = orig


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "vgg_weight"])
def test_a_broken_timed_path_is_not_correct(bench_copy, tmp_path, fault):
    from benchmark.control import half_batch

    _, mod = bench_copy
    broken = {"unchanged_state": unchanged_state, "half_batch": half_batch,
              "vgg_weight": vgg_weight}[fault]
    with broken():
        res = run(mod, "tiny.fit", tmp_path)
    assert not res["correct"], res["compared"]


def test_idle_gaps_and_busy_union_on_a_hand_built_timeline():
    from benchmark.trace import idle_gaps, union_ns

    device = [(10, 20, "k1"), (15, 30, "k2"), (50, 60, "k3")]
    host = [(0, 100, "outer"), (35, 45, "aten::add_")]
    assert union_ns([d[:2] for d in device], 0, 100) == 30
    gaps = idle_gaps(device, host, (0, 100))
    assert [g[1] for g in gaps] == [40e-9, 20e-9, 10e-9]
    assert [g[0] for g in gaps] == ["outer", "outer", "outer"]
    assert idle_gaps([(0, 10, "k")], [(12, 20, "op")], (0, 20))[0] == ["(no host op)", 10e-9]


def test_the_run_refuses_without_a_card_or_the_program(bench_copy, monkeypatch, capsys):
    _, mod = bench_copy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        mod.main(["--workload", "tiny.fit", "--seed", "1", "--seconds", "1"])
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""
