"""Fixtures of the benchmark's own tests: a tiny cell (the light hand at
64^2, 4 frames, batch 2) added to a temporary copy of the benchmark, found
by name like any other; CPU tests run torch on one thread."""

from __future__ import annotations

import importlib.util
import json
import os
import shutil

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_spec(base: str = "hand_mano_448") -> dict:
    with open(os.path.join(REPO, "benchmark", "configs", base + ".json")) as f:
        spec = json.load(f)
    spec.update(name="tiny_" + spec["model"], density="light", num_frames=4)
    spec["harp_config"].update(img_size=64, focal_length=2000.0 * 64 / 448, texture_size=32,
                               batch_size=2, raster_active_fraction=1.0, raster_cap=2048,
                               raster_span_tiles=4)
    return spec


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with the tiny cell tiny.fit
    (stage 2, 2 epochs) added as data files, and its run module loaded
    from the copy."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(REPO, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    spec = tiny_spec()
    (root / "benchmark" / "configs" / "tiny_hand.json").write_text(json.dumps(spec))
    with open(root / "benchmark" / "traffic" / "fit_stage2.json") as f:
        fit = json.load(f)
    fit.update(stages=[0, 2, 0], warmup_stages=[0, 2, 0])
    (root / "benchmark" / "traffic" / "tiny_fit.json").write_text(json.dumps(fit))
    shutil.copy(root / "benchmark" / "limits" / "hand.fit_stage2.json",
                root / "benchmark" / "limits" / "tiny.fit.json")
    (root / "benchmark" / "metrics" / "tiny.jobs.py").write_text(
        "def read(run):\n    return float(len(run['jobs']))\n")
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_hand", "source": "test", "reduced": [],
                             "file": "benchmark/configs/tiny_hand.json", "why": "test"})
    bench["workloads"].append({"name": "tiny.fit", "config": "tiny_hand", "traffic": "tiny_fit",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "fit_frames_per_s":
            m["workloads"].append("tiny.fit")
    bench["per_layer"].append({"name": "tiny.jobs", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "fit_frames_per_s", "workloads": ["tiny.fit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec_ = importlib.util.spec_from_file_location("benchmark_run_copy",
                                                   root / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return root, mod
