"""The yardstick's counts at the flagship shapes."""

from __future__ import annotations

import math

from benchmark.roofline import counts


def test_vgg_forward_count_at_448():
    assert counts.vgg_forward_flops(448, 448) == 111_674_916_864


def test_stage2_step_count_of_18_frames():
    sh = counts.step_shapes(dict(img_size=448, batch_size=18, raster_active_fraction=0.28,
                                 raster_span_tiles=3, texture_size=512), 6152, 3088)
    vgg_only = counts.step_model_flops(sh, 448, True, dict(model_verts=0, joints=0, shape=0,
                                                           pose_feats=0))
    assert vgg_only == 2 * 18 * 111_674_916_864
    assert math.isclose(vgg_only / 1e12, 4.0203, abs_tol=5e-5)
    total = counts.step_model_flops(sh, 448, True, dict(model_verts=781, joints=16, shape=10,
                                                        pose_feats=135))
    assert vgg_only < total < vgg_only * 1.001


def test_kernel_bytes_follow_the_stage():
    sh = counts.step_shapes(dict(img_size=448, batch_size=18, raster_active_fraction=0.28,
                                 raster_span_tiles=3, texture_size=512), 6152, 3088)
    assert (sh["A"], sh["Hl"], sh["A_l"]) == (224, 224, 88)
    both = counts.kernel_bytes(sh, True, True)
    coarse = counts.kernel_bytes(sh, True, False)
    assert set(both) == {"k1_soft", "k1_depth", "k2", "k3", "segment_sum"}
    assert set(coarse) == {"k1_soft", "k2", "segment_sum"}
    # K1's camera pass: face rows and pair lists in, ids, soft ids and sums out.
    B, F, A, P = 18, 6152, 224, 256
    assert both["k1_soft"] == B * F * 9 * 4 + B * F * 9 * 4 + B * A * 12 + B * A * P * 9 * 4 + B * A * P * 4
    assert both["segment_sum"] > coarse["segment_sum"]


def test_the_readers_on_a_hand_made_run():
    import dataclasses

    from benchmark.metrics import _common
    from benchmark.roofline import PEAK_BYTES_S

    @dataclasses.dataclass
    class Cfg:
        img_size: int = 448
        batch_size: int = 18
        raster_active_fraction: float = 0.28
        raster_span_tiles: int = 4
        texture_size: int = 512
        w_vgg: float = 1.0

    run = {"config": Cfg(), "traffic": {"stages": [0, 100, 0]},
           "spec": {"render_mesh": {"faces": 6152, "vertices": 3088}},
           "window_s": 10.0,
           "jobs": [{"work": 3600, "actions_s": [0.01, 0.03], "capture_s": [0.2]},
                    {"work": 3600, "actions_s": [0.02], "capture_s": [0.3]}],
           "trace": {"window_s": 4.0, "busy_s": 3.0, "graph_kernels": {
               "void raster_ids_kernel<true, 8>(float const*)": (0.2, 100),
               "void raster_ids_kernel<false, 0>(float const*)": (0.1, 100),
               "coverage_grad_kernel(float const*)": (0.3, 100),
               "unrelated_kernel": (5.0, 100)}}}
    assert _common.frames_per_s(run) == 720.0
    assert abs(_common.actions_ms(run) - 20.0) < 1e-9
    assert abs(_common.capture_ms(run) - 250.0) < 1e-9
    assert _common.idle_pct(run) == 25.0
    need = counts.kernel_bytes(_common.shapes(run), True, True)
    want = 100 * (need["k1_soft"] + need["k1_depth"] + need["k2"]) / PEAK_BYTES_S / 0.6
    assert abs(_common.roofline_pct(run) - 100 * want) < 1e-9
    run["trace"] = {}
    assert _common.roofline_pct(run) is None and _common.idle_pct(run) is None
