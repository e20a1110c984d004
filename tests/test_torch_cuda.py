"""harp_tpu_torch's CUDA kernels vs their plain PyTorch versions on the
test-suite scenes (tile 8: two warps a block). Needs a CUDA card; run on
one with  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
(tests/conftest.py imports JAX). Ids must be
equal; float outputs within the tolerances chip_smoke.py uses."""

import numpy as np
import pytest
import torch

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
        dv = rk.coverage_grad_verts(b, g, faces, verts.shape[1], cfg)
        dv_p = rk.slot_grads_to_verts(b, rk.coverage_grad_plain(*args, g, cfg), faces,
                                      verts.shape[1])
        assert (dv - dv_p).abs().max() <= 1e-4 * dv_p.abs().max()


def test_pcf_scatter_kernel_matches_plain(cuda):
    rng = np.random.default_rng(7)
    B, Hl, N = 2, 28, 300
    yc = torch.from_numpy(rng.integers(1, Hl + 3, size=(B, N)).astype(np.int32)).to(cuda)
    xc = torch.from_numpy(rng.integers(1, Hl + 3, size=(B, N)).astype(np.int32)).to(cuda)
    upd = torch.from_numpy(rng.normal(size=(B, N, 9)).astype(np.float32)).to(cuda)
    got = pk.pcf_scatter(yc, xc, upd, Hl)
    want = pk.pcf_scatter_plain(yc, xc, upd, Hl)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_cuda_tensor_never_takes_the_plain_path(cuda):
    verts, faces = _scene(0, 30)
    cfg = RasterConfig(image_size=32, tile=8, cap=64)
    before = dict(rk.LAUNCHES)
    raster_compact(torch.from_numpy(verts).to(cuda), faces, cfg)
    assert rk.LAUNCHES["raster_ids_soft"] == before["raster_ids_soft"] + 1
    with pytest.raises(ValueError, match="tile"):
        raster_compact(torch.from_numpy(verts).to(cuda), faces,
                       RasterConfig(image_size=36, tile=6, cap=64))
