"""harp_tpu_torch.bench and the measuring helpers of
harp_tpu_torch/utils/profiling.py, on the CPU at 32^2 (B = 2, the light
hand): the bench's plumbing, its refusal without a card, its VGG count
against scripts/mfu_roofline.py's and torch's FlopCounterMode, bench.py's
trimmed mean, and the device idle-gap accounting on hand-built timelines.
Times taken here are the CPU's and are never read as the card's."""

import importlib.util
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from harp_tpu_torch import bench
from harp_tpu_torch.utils.profiling import PEAK_BF16_S, idle_gaps, timing_stats, trimmed_mean

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(img=32, texture=64, density="light",
             raster_kw=dict(tile=8, cap=1024, face_chunk=256, faces_per_pixel=16,
                            span_tiles=4, active_fraction=1.0))
RECORD_KEYS = {"frames", "device", "frames_per_s", "trimmed_mean_ms", "median_ms", "min_ms",
               "max_ms", "steps", "busy_ms", "busy_share", "profiled_wall_ms", "peak_gib",
               "budget", "overflow",
               "vgg", "profile", "loss", "launches", "step_flops", "step_conv_flops"}


def _mfu_roofline():
    spec = importlib.util.spec_from_file_location(
        "mfu_roofline", os.path.join(REPO, "scripts", "mfu_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("use_arm,use_vgg", [(False, False), (False, True), (True, False)],
                         ids=["hand", "hand_vgg", "arm"])
def test_measure_on_the_cpu_has_every_key_and_labels_no_device_number(use_arm, use_vgg):
    kw = dict(SMALL, raster_kw=dict(SMALL["raster_kw"], cap=2048)) if use_arm else SMALL
    rec = bench.measure(2, use_arm=use_arm, use_vgg=use_vgg, device="cpu", steps=2, **kw)
    assert set(rec) == RECORD_KEYS
    assert rec["device"] == "cpu" and rec["frames"] == 2 and rec["steps"] == 2
    # Nothing measured on a card: no busy time, share, profile or peak memory.
    assert rec["busy_ms"] is None and rec["busy_share"] is None
    assert rec["profiled_wall_ms"] is None
    assert rec["peak_gib"] is None and rec["profile"] is None
    for k in ("frames_per_s", "trimmed_mean_ms", "median_ms", "min_ms", "max_ms", "loss"):
        assert math.isfinite(rec[k]) and rec[k] > 0, (k, rec[k])
    assert rec["min_ms"] <= rec["trimmed_mean_ms"] <= rec["max_ms"]
    assert len(rec["overflow"]) == 6 and not any(rec["overflow"].values())
    cap = kw["raster_kw"]["cap"]
    assert rec["budget"] == {"active_fraction": 1.0, "span_tiles": 4, "cap": cap}
    assert rec["vgg"] == ({"w_vgg": 1.0, "compute_dtype": "bfloat16", "recompute": True}
                          if use_vgg else None)
    # The step's convolutions are the VGG term's: forward, checkpoint
    # recompute (the CPU's choice) and backward to the input, 3 x the
    # analytic forward.
    want = 3 * bench.vgg_conv_flops_per_frame(32) * 2 if use_vgg else 0
    assert rec["step_conv_flops"] == want and rec["step_flops"] > want


def test_measure_replayed_needs_the_card():
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        bench.measure_replayed(2, device="cpu", steps=1, **SMALL)


def test_components_on_the_cpu_time_every_part():
    rec = bench.components(device="cpu", B=2, iters=1, **SMALL)
    assert list(rec["components_ms"]) == [
        "full_step", "coarse_only_step", "app_only_step", "loss_fwd", "loss_fwd_bwd",
        "fwd_bwd_no_shadow", "coarse_fwd_bwd", "app_fwd_bwd"]
    assert all(math.isfinite(v) and v > 0 for v in rec["components_ms"].values())
    assert rec["device"] == "cpu" and rec["frames"] == 2


@pytest.mark.parametrize("argv", [[], ["--components"], ["--protocol"]],
                         ids=["bench", "components", "protocol"])
def test_main_without_a_card_exits_nonzero_and_prints_no_metric(argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(argv) != 0
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


def test_main_refuses_a_card_whose_peaks_it_does_not_know(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100-SXM4-80GB")
    assert bench.main([]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "A100" in err


@pytest.mark.parametrize("img", [32, 448])
def test_vgg_conv_flops_equal_mfu_rooflines(img):
    assert bench.vgg_conv_flops_per_frame(img) == _mfu_roofline().vgg_conv_flops_per_frame(img)


def test_flop_counter_counts_the_analytic_vgg_forward():
    from torch.utils.flop_counter import FlopCounterMode
    from harp_tpu_torch.losses.perceptual import Vgg16Features

    B = 2
    vgg = Vgg16Features.create(device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(B, 32, 32, 3).astype(np.float32))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        vgg.slices(x)
    counts = fc.get_flop_counts()["Global"]
    assert set(map(str, counts)) == {"aten.convolution"}
    assert fc.get_total_flops() == bench.vgg_conv_flops_per_frame(32) * B


def test_roofline_accounting():
    vgg = {"frames": 18, "trimmed_mean_ms": 90.0, "busy_ms": 63.0, "step_flops": 3.0e13,
           "step_conv_flops": 2.9e13, "vgg": {"recompute": True}}
    novgg = {"frames": 18, "trimmed_mean_ms": 50.0, "busy_ms": 22.0}
    r = bench.roofline(vgg, novgg)
    ops = 3 * bench.vgg_conv_flops_per_frame(448) * 18
    assert r["vgg_step_tflop"] == pytest.approx(ops / 1e12)
    assert r["vgg_delta_ms"] == pytest.approx(40.0)
    assert r["vgg_mfu_pct"] == pytest.approx(100 * ops / 0.040 / PEAK_BF16_S)
    assert r["vgg_min_ms_at_peak"] == pytest.approx(ops / PEAK_BF16_S * 1e3)
    assert r["vgg_delta_busy_ms"] == pytest.approx(41.0)
    assert r["vgg_mfu_busy_pct"] == pytest.approx(100 * ops / 0.041 / PEAK_BF16_S)
    assert r["mfu_step_vgg"] == pytest.approx(100 * 3.0e13 / 0.090 / PEAK_BF16_S)
    assert 0 < r["vgg_mfu_pct"] <= 100 and 0 < r["mfu_step_vgg"] <= 100
    assert r["bytes_accessed"] == "not measured" and r["peak_tflops_used"] == 989.0
    # A VGG step no slower than the step without it has no MFU to give.
    assert bench.roofline(vgg, dict(novgg, trimmed_mean_ms=95.0))["vgg_mfu_pct"] is None
    # A step that kept the forward's activations ran no recompute: 2 x the forward.
    kept = bench.roofline(dict(vgg, vgg={"recompute": False}), novgg)
    assert kept["vgg_step_tflop"] == pytest.approx(2 / 3 * ops / 1e12)


@pytest.mark.parametrize("n", [1, 2, 3, 10])
def test_trimmed_mean_is_bench_pys(n):
    import bench as harp_bench  # the repository's bench.py

    times = list(np.random.RandomState(n).rand(n))
    iters = n
    want = sum(sorted(times)[: max(iters - 2, 1)]) / max(iters - 2, 1)  # bench.py:86-88
    assert trimmed_mean(times) == want
    st = timing_stats(times)
    assert st == {"trimmed_mean": want, "median": float(np.median(times)), "min": min(times),
                  "max": max(times), "n": n}
    assert harp_bench.REFERENCE_FRAMES_PER_SEC_ESTIMATE == bench.REFERENCE_FRAMES_PER_SEC_ESTIMATE


def test_idle_gaps_name_the_innermost_open_host_op():
    # A step span holds two ops; the second holds a synchronise.
    host = [(0, 100, "step"), (5, 40, "aten::mm"), (42, 95, "aten::item"),
            (60, 90, "cudaStreamSynchronize")]
    device = [(10, 20, "k1"), (30, 45, "k2"), (70, 80, "k3")]
    gaps = idle_gaps(device, host, window=(0, 100))
    assert [(g["ms"], g["start_us"], g["host"]) for g in gaps] == [
        (0.025, 45, "aten::item"), (0.02, 80, "cudaStreamSynchronize"),
        (0.01, 0, "step"), (0.01, 20, "aten::mm")]
    # Without a window: only between the first and the last device event;
    # and at most `top`.
    assert [g["start_us"] for g in idle_gaps(device, host)] == [45, 20]
    assert [g["start_us"] for g in idle_gaps(device, host, (0, 100), top=1)] == [45]


def test_idle_gaps_merge_overlapping_device_events():
    device = [(0, 50, "a"), (10, 20, "b"), (40, 60, "c"), (70, 75, "d"), (72, 90, "e")]
    gaps = idle_gaps(device, [(55, 80, "op")], window=(0, 100))
    # Equal lengths keep the timeline's order.
    assert [(g["start_us"], g["ms"], g["host"]) for g in gaps] == [(60, 0.01, "op"),
                                                                   (90, 0.01, None)]


def test_idle_gaps_of_a_busy_timeline_are_none():
    device = [(0, 30, "a"), (30, 60, "b"), (50, 100, "c")]
    assert idle_gaps(device, [(0, 100, "op")], window=(0, 100)) == []
    assert idle_gaps(device, []) == []
    assert idle_gaps([], []) == []
    # No device event in a window: the whole window is one gap.
    assert idle_gaps([], [(0, 10, "op")], window=(0, 10)) == [
        {"ms": 0.01, "start_us": 0, "host": "op"}]


def test_profile_window_reads_its_own_window(monkeypatch):
    """The window's parsing on a CPU trace (no device events): the window
    is one idle gap, named by the op open at its start."""
    import warnings

    from harp_tpu_torch.utils.profiling import profile_window

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    x = torch.ones(64, 64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # CUDA activity on a CPU build
        rec = profile_window(lambda: (x @ x).sum(), kernel_names={"mm": "gemm"})
    assert rec["device_busy_ms"] == 0 and rec["top"] == [] and rec["wall_ms"] > 0
    assert rec["kernel_counts"] == {"mm": 0}
    (gap,) = rec["idle_gaps"]
    assert gap["at_ms"] == 0 and gap["host"] is None  # the window itself names no op
    assert gap["ms"] >= 0.9 * rec["wall_ms"]  # the span holds the timed call


_PROBE = """
import sys
import harp_tpu_torch.bench, harp_tpu_torch.utils.profiling
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "harp_tpu")))
"""


def test_bench_imports_neither_jax_nor_harp_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], env=dict(os.environ, PYTHONPATH=REPO),
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
