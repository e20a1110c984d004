"""harp_tpu_torch's CUDA kernels vs their plain PyTorch versions on the
test-suite scenes (tile 8: two warps a block). Needs a CUDA card; run on
one with  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
(tests/conftest.py imports JAX). Ids must be
equal; float outputs within the tolerances chip_smoke.py uses. The
segment sum, K3 and the whole train step must give the same bits twice."""

import numpy as np
import pytest
import torch

from harp_tpu_torch.ops import segment as sg
from harp_tpu_torch.render.kernels import pcf_grad_kernel as pk
from harp_tpu_torch.render.kernels import raster_kernel as rk
from harp_tpu_torch.render.rasterizer import RasterConfig, raster_compact

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(seed, n, B=2, spread=4.0):
    rng = np.random.RandomState(seed)
    verts = np.zeros((B, n * 3, 3), np.float32)
    for b in range(B):
        centers = rng.uniform(2, 30, size=(n, 2))
        offsets = rng.uniform(-spread, spread, size=(n, 3, 2))
        verts[b, :, :2] = (centers[:, None] + offsets).reshape(-1, 2)
        verts[b, :, 2] = rng.uniform(0.5, 3.0, size=(n, 1)).repeat(3, 1).reshape(-1)
    return verts, np.arange(n * 3).reshape(n, 3).astype(np.int32)


@pytest.mark.parametrize("need_soft", [True, False])
@pytest.mark.parametrize("n,cap", [(30, 64), (400, 448)])
def test_raster_kernels_match_plain(cuda, need_soft, n, cap):
    verts, faces = _scene(5, n, spread=6.0)
    cfg = RasterConfig(image_size=32, tile=8, cap=cap, faces_per_pixel=8, active_fraction=0.75)
    out = raster_compact(torch.from_numpy(verts).to(cuda), faces, cfg, need_soft=need_soft)
    b = out["bins"]
    args = (b["fv9"], b["s_face"], b["start_a"], b["count_a"], b["act_idx"])
    hard, soft, ssum = rk.raster_ids(*args, cfg, need_soft)
    hard_p, soft_p, ssum_p = rk.raster_ids_plain(*args, cfg, need_soft)
    assert torch.equal(hard, hard_p)
    if need_soft:
        assert torch.equal(soft, soft_p)
        torch.testing.assert_close(ssum, ssum_p, rtol=1e-5, atol=1e-6)
        g = torch.randn(ssum.shape, device=cuda)
        corners = sg.TableOrder.of(faces, verts.shape[1])
        dv = rk.coverage_grad_verts(b, g, corners, cfg)
        dv_p = rk.slot_grads_to_verts(b, rk.coverage_grad_plain(*args, g, cfg), corners)
        assert (dv - dv_p).abs().max() <= 1e-4 * dv_p.abs().max()


def test_pcf_scatter_kernel_matches_plain(cuda):
    rng = np.random.default_rng(7)
    B, Hl, N = 2, 28, 300
    yc = torch.from_numpy(rng.integers(1, Hl + 3, size=(B, N)).astype(np.int32)).to(cuda)
    xc = torch.from_numpy(rng.integers(1, Hl + 3, size=(B, N)).astype(np.int32)).to(cuda)
    upd = torch.from_numpy(rng.normal(size=(B, N, 9)).astype(np.float32)).to(cuda)
    yc[0, :100] = 1  # a run of clamped centres, as the background pixels make
    xc[0, :100] = 1
    got = pk.pcf_scatter(yc, xc, upd, Hl)
    want = pk.pcf_scatter_plain(yc, xc, upd, Hl)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, pk.pcf_scatter(yc, xc, upd, Hl))  # no atomics: same bits


@pytest.mark.parametrize("C", [1, 9, 24])
def test_segment_sum_kernel_matches_plain_and_repeats_bit_equal(cuda, C):
    """Unsorted keys, empty rows and one run of 10^5 entries (~400 chunks),
    against a float64 sum: each row within 1e-5 of its sum of |values|. That
    bounds float32 rounding at this depth: the long run adds ~400 chunk
    partials in sequence (worst case 400 x 6e-8 = 2.4e-5, random signs
    ~20 x 6e-8). The plain version, atomics in another order, is held to
    the same bound. Bit-equal twice."""
    rng = np.random.default_rng(C)
    R, M = 5000, 60_000
    key = rng.integers(0, R, M)
    key = key[key % 5 != 1]
    key = np.concatenate([key[:20_000], np.zeros(100_000, np.int64), key[20_000:]])
    order = sg.SegmentOrder(torch.from_numpy(key).to(cuda), R)
    vals = torch.from_numpy(rng.normal(size=(key.size, C)).astype(np.float32)).to(cuda)
    before = sg.LAUNCHES["segment_sum"]
    got = sg.segment_sum(vals, order)
    again = sg.segment_sum(vals, order)
    plain = sg.segment_sum_plain(vals, order)
    want = sg.segment_sum_plain(vals.double(), order)
    bound = 1e-5 * sg.segment_sum_plain(vals.double().abs(), order)
    assert sg.LAUNCHES["segment_sum"] == before + 2
    assert (got[1::5] == 0).all() and (want[1::5] == 0).all()
    assert ((got.double() - want).abs() <= bound).all()
    assert ((plain.double() - want).abs() <= bound).all()
    assert torch.equal(got, again)
    # No entries: zeros, and no launch is counted.
    empty = sg.SegmentOrder(torch.zeros(0, dtype=torch.int64, device=cuda), R)
    assert not sg.segment_sum(vals[:0], empty).any()
    assert sg.LAUNCHES["segment_sum"] == before + 2


def test_train_step_gradients_repeat_bit_equal(cuda):
    """Two TrainSteps from one state (light hand, 32^2, self-shadow, stage 2)
    give the same gradients and updated parameters, bit for bit."""
    from harp_tpu_torch.assets import build_synthetic_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.fit.driver import make_train_step
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.render import pipeline

    img = 32
    assets = build_synthetic_assets(uv_size=16, density="light")
    config = HarpConfig(img_size=img, focal_length=2000.0 * img / 448, texture_size=16,
                        self_shadow=True, w_vgg=0.0, batch_size=2)
    rcfg = RasterConfig(image_size=img, tile=8, cap=512, faces_per_pixel=16)
    rng = np.random.RandomState(0)
    init = {"pose": 0.2 * rng.randn(2, 45), "rot": 0.05 * rng.randn(2, 3),
            "trans": np.zeros((2, 3)), "shape": 0.1 * rng.randn(2, 10),
            "cam": np.tile([6.0, -0.08, -0.01], (2, 1)), "joints": 10.0 * rng.randn(2, 21, 3)}
    yy, xx = np.mgrid[0:img, 0:img]
    masks = np.stack([((yy - 15.5) ** 2 + (xx - 14.5 - 2 * b) ** 2 < 64) for b in range(2)])
    data = [torch.from_numpy(a.astype(np.float32)).to(cuda)
            for a in (rng.uniform(0, 1, (2, img, img, 3)), masks, masks)]
    fids = torch.arange(2, device=cuda)
    results = []
    for _ in range(2):
        params, aux = init_params(init, assets, config, device=cuda)
        ref = pipeline.mesh_forward(params, fids[:1], assets, config)[0][0].detach()
        step = make_train_step(assets, config, rcfg, params, device=cuda)
        step(aux, fids, *data, ref, coarse_on=True, app_on=True,
             generator=torch.Generator(device=cuda).manual_seed(1))
        results.append({k: (p.grad.clone(), p.detach().clone()) for k, p in params.items()
                        if p.grad is not None})
    for k, (g, p) in results[0].items():
        assert torch.equal(g, results[1][k][0]), f"gradient of {k} differs"
        assert torch.equal(p, results[1][k][1]), f"updated {k} differs"


def test_cuda_tensor_never_takes_the_plain_path(cuda):
    verts, faces = _scene(0, 30)
    cfg = RasterConfig(image_size=32, tile=8, cap=64)
    before = dict(rk.LAUNCHES)
    raster_compact(torch.from_numpy(verts).to(cuda), faces, cfg)
    assert rk.LAUNCHES["raster_ids_soft"] == before["raster_ids_soft"] + 1
    with pytest.raises(ValueError, match="tile"):
        raster_compact(torch.from_numpy(verts).to(cuda), faces,
                       RasterConfig(image_size=36, tile=6, cap=64))
