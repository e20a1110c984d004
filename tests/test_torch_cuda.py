"""harp_tpu_torch's CUDA kernels vs their plain PyTorch versions on the
test-suite scenes (tile 8: two warps a block; tile 16: eight). Needs a CUDA
card; run on one with  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
(tests/conftest.py imports JAX). Ids must be
equal; float outputs within the tolerances chip_smoke.py uses. K2, the
segment sum, K3 and the whole train step must give the same bits twice."""

import numpy as np
import pytest
import torch

from harp_tpu_torch.ops import segment as sg
from harp_tpu_torch.render.kernels import pcf_grad_kernel as pk
from harp_tpu_torch.render.kernels import raster_kernel as rk
from harp_tpu_torch.render.rasterizer import RasterConfig, raster_compact
from test_torch_raster_cull import adversarial_scene

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


# name: (scene of a config, cap). "busy" and "dense" give tiles of more than
# one 128-face chunk at tile 16 (and "dense" at tile 8), with faces across
# warp borders; "adversarial" is tests/test_torch_raster_cull.py's scene.
SCENES = {
    "sparse": (lambda cfg: _scene(5, 30, spread=6.0), 64),
    "busy": (lambda cfg: _scene(5, 400, spread=6.0), 448),
    "dense": (lambda cfg: _scene(9, 1500, spread=3.0), 1344),
    "adversarial": (adversarial_scene, 1024),
}


@pytest.mark.parametrize("need_soft", [True, False])
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_raster_kernels_match_plain(cuda, need_soft, tile, scene):
    make, cap = SCENES[scene]
    cfg = RasterConfig(image_size=32, tile=tile, cap=cap, faces_per_pixel=8, active_fraction=0.75)
    verts, faces = make(cfg)
    out = raster_compact(torch.from_numpy(verts).to(cuda), faces, cfg, need_soft=need_soft)
    b = out["bins"]
    args = (b["fv9"], b["s_face"], b["start_a"], b["count_a"], b["act_idx"])
    assert int(b["count_a"].max()) <= cap
    if scene == "dense" or (scene == "busy" and tile == 16):
        assert int(b["count_a"].max()) > 128
    hard, soft, ssum = rk.raster_ids(*args, cfg, need_soft)
    hard_p, soft_p, ssum_p = rk.raster_ids_plain(*args, cfg, need_soft)
    assert torch.equal(hard, hard_p)
    # The kernels' own ballots: exactly the (slot, warp) pairs of the mirror.
    mirror = rk.warp_cull_keep(*args, cfg)
    kernels = ["raster_ids_soft", "coverage_grad"] if need_soft else ["raster_ids_depth"]
    for name in kernels:
        assert torch.equal(rk.kernel_cull_keep(*args, cfg, name), mirror), name
    if need_soft:
        assert torch.equal(soft, soft_p)
        torch.testing.assert_close(ssum, ssum_p, rtol=1e-5, atol=1e-6)
        g = torch.randn(ssum.shape, device=cuda)
        corners = sg.TableOrder.of(faces, verts.shape[1])
        dv = rk.coverage_grad_verts(b, g, corners, cfg)
        dv_p = rk.slot_grads_to_verts(b, rk.coverage_grad_plain(*args, g, cfg), corners)
        assert (dv - dv_p).abs().max() <= 1e-4 * dv_p.abs().max()
        assert torch.equal(dv, rk.coverage_grad_verts(b, g, corners, cfg))


@pytest.mark.parametrize("tile", [8, 16])
def test_raster_ids_many_soft_ids_match_plain(cuda, tile):
    """faces_per_pixel 50 (HarpConfig.reference_exact) takes the kernel's
    global-memory soft-id path. A 3 px blur over the dense scene gives
    pixels with fewer than 50 hits, more than 8, and more than 50."""
    cfg = RasterConfig(image_size=32, tile=tile, cap=1344, faces_per_pixel=50,
                       active_fraction=1.0, blur_radius=9.0 * (2 / 32) ** 2)
    verts, faces = _scene(9, 1500, spread=3.0)
    b = raster_compact(torch.from_numpy(verts).to(cuda), faces, cfg)["bins"]
    args = (b["fv9"], b["s_face"], b["start_a"], b["count_a"], b["act_idx"])
    hard, soft, ssum = rk.raster_ids(*args, cfg)
    hard_p, soft_p, ssum_p = rk.raster_ids_plain(*args, cfg)
    n_ids = (soft_p >= 0).sum(-1)
    assert int(n_ids.max()) == 50 and bool(((n_ids > 8) & (n_ids < 50)).any())
    assert torch.equal(hard, hard_p)
    assert torch.equal(soft, soft_p)
    torch.testing.assert_close(ssum, ssum_p, rtol=1e-5, atol=1e-6)


def _pcf_inputs(cuda, seed, B, Hl, N):
    rng = np.random.default_rng(seed)
    yc = torch.from_numpy(rng.integers(1, Hl + 3, size=(B, N)).astype(np.int32)).to(cuda)
    xc = torch.from_numpy(rng.integers(1, Hl + 3, size=(B, N)).astype(np.int32)).to(cuda)
    upd = torch.from_numpy(rng.normal(size=(B, N, 9)).astype(np.float32)).to(cuda)
    return yc, xc, upd


def _bits(x):
    return x.view(torch.int32)  # NaN != NaN: compare the bits


@pytest.mark.parametrize("Hl,N", [(28, 300), (224, 5000)])
def test_pcf_scatter_kernel_matches_plain(cuda, Hl, N):
    """Bit for bit the fixed-point mirror, within rtol 1e-5 the float32
    plain version, and the same bits twice. N is not a multiple of 256;
    a run of clamped centres, as the background pixels make, fills whole
    warps and part of one."""
    yc, xc, upd = _pcf_inputs(cuda, 7, 2, Hl, N)
    yc[0, :100] = 1
    xc[0, :100] = 1
    yc[1, 40:75] = Hl + 2
    xc[1, 40:75] = Hl + 2
    before = pk.LAUNCHES["pcf_scatter"]
    got = pk.pcf_scatter(yc, xc, upd, Hl)
    assert pk.LAUNCHES["pcf_scatter"] == before + 1
    assert torch.equal(_bits(got), _bits(pk.pcf_scatter_fixed_plain(yc, xc, upd, Hl)))
    torch.testing.assert_close(got, pk.pcf_scatter_plain(yc, xc, upd, Hl), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, pk.pcf_scatter(yc, xc, upd, Hl))


@pytest.mark.parametrize("case", ["zeros", "one_huge", "denormals", "ties", "non_finite"])
def test_pcf_scatter_kernel_scale_rule_matches_mirror(cuda, case):
    """The kernel's rounding from the float's bits equals the mirror's
    rint in double, half to even at exact ties, on every scale."""
    yc, xc, upd = _pcf_inputs(cuda, 3, 2, 28, 700)
    if case == "zeros":
        upd.zero_()
    elif case == "one_huge":
        upd[0, 17, 4] = 1e30 * upd.abs().max()
    elif case == "denormals":
        upd = (upd.double() * 1e-40).float()
    elif case == "ties":  # max 2^10, 9N = 6300 <= 2^13: s = 38, odd * 2^-39 -> k + 1/2
        odd = (torch.arange(upd.numel(), device=cuda) % 401 - 200) * 2 + 1
        upd = (odd.double() * 2.0 ** -39).float().reshape(upd.shape)
        upd[0, 0, 0] = 1024.0
        assert pk.fixed_point_shift(1024.0, 700) == 38
    else:
        yc[0, :2], xc[0, :2] = 9, 9
        upd[0, 0, 4], upd[0, 1, 4], upd[1, 3, 0], upd[1, 9, :] = np.inf, -np.inf, np.nan, -np.inf
    got = pk.pcf_scatter(yc, xc, upd, 28)
    assert torch.equal(_bits(got), _bits(pk.pcf_scatter_fixed_plain(yc, xc, upd, 28)))
    if case == "zeros":
        assert not got.any()
    if case == "non_finite":
        assert bool(torch.isnan(got[0, 9, 9])) and int(torch.isinf(got).sum()) >= 8


@pytest.mark.parametrize("C", [1, 3, 5, 9, 24, 37])
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


def test_debug_nans_checks_a_kernels_outputs_on_the_card(cuda):
    """--debug-nans on the card: the dispatch mode does not see what a
    kernel writes through ctypes, so the wrapper checks its outputs; a NaN
    in segment_sum's values raises naming the kernel, a clean call passes."""
    from harp_tpu_torch.utils.debug_nans import DebugNans

    order = sg.SegmentOrder(torch.tensor([0, 1, 1, 2], device=cuda), 3)
    vals = torch.ones(4, 2, device=cuda)
    bad = vals.clone()
    bad[1, 0] = float("nan")
    with DebugNans():
        assert torch.equal(sg.segment_sum(vals, order)[:, 0].cpu(), torch.tensor([1., 2., 1.]))
        with pytest.raises(FloatingPointError, match="in segment_sum"):
            sg.segment_sum(bad, order)


def _dirty_allocator(cuda, nbytes):
    """Leave NaNs in the caching allocator's next block of this size, so a
    row the kernel fails to write shows."""
    junk = torch.full((nbytes // 4,), float("nan"), device=cuda)
    del junk


@pytest.mark.parametrize("C", [1, 3, 5, 9, 24, 37])
@pytest.mark.parametrize("M", [1, 200, 256, 700])
def test_segment_sum_kernel_writes_every_row(cuda, C, M):
    """The kernel zero-fills the empty rows itself (no memset of out): rows
    below the first key, between keys and above the last, with M below,
    at and above one chunk, and a run across a chunk edge that ends on the
    next. Within the
    float64 bound of the test above; bit-equal twice."""
    rng = np.random.default_rng(M * 100 + C)
    R = 3 * M + 40
    key = np.sort(rng.integers(10, R - 10, M))
    if M > 256:  # a run across the first chunk edge that ends on the second
        key[200:512] = key[200]
        key[512:] = np.maximum(key[512:], key[200] + 2)
    key = np.where(key % 4 == 1, key + 1, key)  # rows 1 mod 4 stay empty
    key = rng.permutation(key)
    order = sg.SegmentOrder(torch.from_numpy(key).to(cuda), R)
    vals = torch.from_numpy(rng.normal(size=(M, C)).astype(np.float32)).to(cuda)
    order.sorted()
    _dirty_allocator(cuda, R * C * 4)
    got = sg.segment_sum(vals, order)
    _dirty_allocator(cuda, R * C * 4)
    again = sg.segment_sum(vals, order)
    want = sg.segment_sum_plain(vals.double(), order)
    bound = 1e-5 * sg.segment_sum_plain(vals.double().abs(), order)
    empty = torch.ones(R, dtype=torch.bool, device=cuda)
    empty[order.key] = False
    assert bool(empty[:10].all() and empty[-9:].all() and empty.sum() > 20)
    assert not got[empty].any()
    assert ((got.double() - want).abs() <= bound).all()
    assert torch.equal(got, again)


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


def _light_fit_scene(cuda, n_frames=2, img=32):
    """The light hand at img^2 (32 unless given) with VGG on (bf16, cached
    GT): its synthetic sequence rendered on the card, config, raster config
    and init."""
    from harp_tpu_torch.assets import build_synthetic_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence

    assets = build_synthetic_assets(uv_size=64, density="light")
    config = HarpConfig(img_size=img, focal_length=2000.0 * img / 448, texture_size=64,
                        self_shadow=True, w_vgg=1.0, batch_size=n_frames,
                        training_stage=(1, 1, 1), total_epoch=3)
    rcfg = RasterConfig(image_size=img, tile=8, cap=1024, faces_per_pixel=16, span_tiles=4)
    images, masks, masks_er, _, init = make_synthetic_sequence(
        assets, config, rcfg, n_frames=n_frames, seed=0, device=cuda)
    return assets, config, rcfg, (images, masks, masks_er), init


def test_vgg_train_step_repeats_bit_equal(cuda):
    """Two stage-2 TrainSteps with the VGG term (bf16, cached GT pyramids,
    remat) from one state give the same gradients and parameters, bit for
    bit: cuDNN held deterministic over the forward, the checkpoint's
    recompute and the backward."""
    from harp_tpu_torch.fit.driver import _key_stream_np, make_train_step
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.losses.perceptual import Vgg16Features, precompute_slices
    from harp_tpu_torch.render import pipeline

    assets, config, rcfg, data, init = _light_fit_scene(cuda)
    vgg = Vgg16Features.create(compute_dtype="bfloat16", device=cuda)
    fids = torch.arange(2, device=cuda)
    results = []
    for _ in range(2):
        params, aux = init_params(init, assets, config, device=cuda)
        aux["vgg_gt"] = precompute_slices(vgg, data[0] * data[2][..., None], chunk=1)
        ref = pipeline.mesh_forward(params, fids[:1], assets, config)[0][0].detach()
        step = make_train_step(assets, config, rcfg, params, device=cuda, vgg=vgg)
        _, br = step(aux, fids, *data, ref, coarse_on=True, app_on=True,
                     key=_key_stream_np(0, 1)[0])
        assert float(br["vgg"]) > 0
        results.append({k: (p.grad.clone(), p.detach().clone()) for k, p in params.items()
                        if p.grad is not None})
    for k, (g, p) in results[0].items():
        assert torch.equal(g, results[1][k][0]), f"gradient of {k} differs"
        assert torch.equal(p, results[1][k][1]), f"updated {k} differs"


def test_three_epoch_fit_repeats_bit_equal(cuda):
    """fit_sequence over stages 1 / 1 / 1 with VGG, twice from one seed:
    the same history and final parameters, bit for bit."""
    from harp_tpu_torch.fit.driver import FitData, fit_sequence
    from harp_tpu_torch.fit.params import init_params

    assets, config, rcfg, data, init = _light_fit_scene(cuda)
    runs = []
    for _ in range(2):
        params, aux = init_params(init, assets, config, device=cuda)
        runs.append(fit_sequence(config, assets, FitData(*data), params, aux, rcfg=rcfg,
                                 device=cuda))
    (p0, h0), (p1, h1) = runs
    assert h0 == h1 and [h["epoch"] for h in h0] == [0, 1, 2]
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_arm_train_step_repeats_bit_equal(cuda):
    """Two stage-2 TrainSteps of the SMPL-X arm (light density, 32^2,
    self-shadow, wrist and global rotation optimised) from one state: the
    same gradients and parameters, bit for bit (the extra joints' repeated
    vertex ids sum through segment_sum)."""
    from harp_tpu_torch.assets import build_synthetic_arm_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.fit.driver import _key_stream_np, make_train_step
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.render import pipeline

    img = 32
    assets = build_synthetic_arm_assets(uv_size=16, density="light")
    config = HarpConfig(img_size=img, focal_length=2000.0 * img / 448, texture_size=16,
                        self_shadow=True, w_vgg=0.0, batch_size=2, use_arm=True,
                        opt_arm_pose=True)
    rcfg = RasterConfig(image_size=img, tile=8, cap=1024, faces_per_pixel=16, span_tiles=4)
    rng = np.random.RandomState(0)
    init = {"pose": 0.2 * rng.randn(2, 45), "rot": 0.05 * rng.randn(2, 3),
            "trans": np.zeros((2, 3)), "shape": 0.1 * rng.randn(2, 10),
            "cam": np.tile([6.0, -0.08, -0.01], (2, 1)), "joints": 10.0 * rng.randn(2, 22, 3)}
    yy, xx = np.mgrid[0:img, 0:img]
    masks = np.stack([((yy - 15.5) ** 2 + (xx - 12.5 - 2 * b) ** 2 < 81) for b in range(2)])
    data = [torch.from_numpy(a.astype(np.float32)).to(cuda)
            for a in (rng.uniform(0, 1, (2, img, img, 3)), masks, masks)]
    fids = torch.arange(2, device=cuda)
    wrist = torch.from_numpy(0.1 * rng.randn(2, 3))
    results = []
    for _ in range(2):
        params, aux = init_params(init, assets, config, device=cuda)
        with torch.no_grad():
            params["wrist_pose"].copy_(wrist)
        ref = pipeline.mesh_forward(params, fids[:1], assets, config)[0][0].detach()
        step = make_train_step(assets, config, rcfg, params, device=cuda)
        step(aux, fids, *data, ref, coarse_on=True, app_on=True, key=_key_stream_np(0, 1)[0])
        results.append({k: (p.grad.clone(), p.detach().clone()) for k, p in params.items()
                        if p.grad is not None})
    assert results[0]["wrist_pose"][0].abs().max() > 0
    for k, (g, p) in results[0].items():
        assert torch.equal(g, results[1][k][0]), f"gradient of {k} differs"
        assert torch.equal(p, results[1][k][1]), f"updated {k} differs"


def test_raster_ids_at_the_arm_shape_match_plain(cuda):
    """K1 on the reference-density arm (4078 render vertices, 8128 faces)
    at 448^2 with harp_tpu's budget (cap 448, span 3, active 0.28; the
    poses of harp_tpu's arm density test, cam 5): camera soft + hard ids and
    the light's depth-only ids equal the plain version's, and no tile
    overflowed."""
    import dataclasses

    from harp_tpu_torch.assets import build_synthetic_arm_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.render import camera as cam_mod
    from harp_tpu_torch.render import pipeline

    assets = build_synthetic_arm_assets(density="reference")
    config = HarpConfig(img_size=448, use_arm=True)
    rng = np.random.RandomState(0)
    B = 2
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=cuda) for k, v in {
        "pose": 0.15 * rng.randn(B, 45), "rot": 0.05 * rng.randn(B, 3),
        "trans": np.zeros((B, 3)), "shape": np.zeros(10),
        "wrist_pose": 0.1 * rng.randn(B, 3), "cam": np.tile([5.0, 0.05, -0.01], (B, 1)),
        "verts_disps": np.zeros((assets.num_render_verts, 1))}.items()}
    fids = torch.arange(B, device=cuda)
    with torch.no_grad():
        verts, _ = pipeline.mesh_forward(params, fids, assets, config)
        R, T = pipeline.camera_for_frames(params, fids, config)
        screen = cam_mod.screen_from_world(verts, R, T, config.focal_length, 448)
    for need_soft, size, cap in ((True, 448, 448), (False, 224, 1344)):
        cfg = RasterConfig(image_size=size, cap=cap, span_tiles=3, active_fraction=0.28)
        out = raster_compact(screen * (size / 448), assets.render_faces, cfg,
                             need_soft=need_soft)
        for k in ("bin_overflow", "active_overflow", "span_overflow"):
            assert int(out[k].sum()) == 0, k
        b = out["bins"]
        args = (b["fv9"], b["s_face"], b["start_a"], b["count_a"], b["act_idx"])
        hard, soft, ssum = rk.raster_ids(*args, cfg, need_soft)
        hard_p, soft_p, ssum_p = rk.raster_ids_plain(
            *args, dataclasses.replace(cfg, face_chunk=64), need_soft)
        assert torch.equal(hard, hard_p)
        if need_soft:
            assert torch.equal(soft, soft_p)
            torch.testing.assert_close(ssum, ssum_p, rtol=1e-5, atol=1e-6)


def test_html_basis_texture_on_the_card_matches_the_cpu(cuda):
    """HTML's texture at the flagship's width (512^2 x 3, 101 coefficients):
    the texture and its coefficient gradient on the card against the CPU,
    rtol 1e-5; two card calls give the same bits."""
    from harp_tpu_torch.models.html import synthetic_texture_basis

    basis = synthetic_texture_basis(size=512, num_coeffs=101)
    rng = np.random.RandomState(0)
    c = (0.5 * rng.randn(101)).astype(np.float32)
    w = torch.from_numpy(rng.randn(512, 512, 3).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda, cuda):
        x = torch.tensor(c, device=dev, requires_grad=True)
        tex = basis.texture(x)
        (tex * w.to(dev)).sum().backward()
        out.setdefault(str(dev), []).append((tex.detach().cpu(), x.grad.cpu()))
    (tex_c, g_c), = out["cpu"]
    (tex_1, g_1), (tex_2, g_2) = out[str(cuda)]
    assert torch.equal(tex_1, tex_2) and torch.equal(g_1, g_2)
    torch.testing.assert_close(tex_1, tex_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g_1, g_c, rtol=1e-5, atol=1e-5 * float(g_c.abs().max()))


def _jpeg_layout(root, n=3, size=64, seed=0):
    """n smooth RGB frames and disc masks written by the port's encoder on
    the card (nvJPEG), with the float frames."""
    from harp_tpu_torch import native

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    imgs, masks, paths = [], [], []
    for i in range(n):
        f = rng.uniform(5, 15, 3)
        img = np.stack([0.5 + 0.35 * np.sin(xx / f[c] + yy / (2 * f[c])) for c in range(3)], -1)
        mask = ((yy - 30) ** 2 + (xx - 34) ** 2 < rng.uniform(10, 20) ** 2).astype(np.float32)
        p = str(root / f"{i:04d}.jpg")
        native.encode_jpeg(torch.from_numpy(img.astype(np.float32)).cuda(), p)
        native.encode_jpeg(torch.from_numpy(mask).cuda(), p.replace(".jpg", "_mask.jpg"))
        imgs.append(img)
        masks.append(mask)
        paths.append(p)
    return paths, np.stack(imgs), np.stack(masks)


def test_nvjpeg_decoder_holds_the_jpeg_bounds(cuda, tmp_path):
    """nvJPEG's batched decode on the card: float frames within a mean of
    0.015 of the float frames written, masks within 0.03 (harp_tpu's
    bounds, tests/test_metro_ingestion.py), on the card, the same bits
    twice."""
    from harp_tpu_torch import native

    paths, imgs, masks = _jpeg_layout(tmp_path)
    got = native.decode_jpeg_batch(paths, device=cuda)
    got_m = native.decode_jpeg_batch([p.replace(".jpg", "_mask.jpg") for p in paths],
                                     gray=True, device=cuda)
    assert got.is_cuda and got.shape == imgs.shape and got_m.shape == masks.shape
    assert float((got.cpu() - torch.from_numpy(imgs)).abs().mean()) < 0.015
    assert float((got_m.cpu() - torch.from_numpy(masks)).abs().mean()) < 0.03
    assert torch.equal(got, native.decode_jpeg_batch(paths, device=cuda))


def test_nvjpeg_decode_of_a_missing_or_bad_file_raises(cuda, tmp_path):
    from harp_tpu_torch import native

    paths, _, _ = _jpeg_layout(tmp_path, n=2)
    with pytest.raises(OSError, match="missing.jpg cannot be opened"):
        native.decode_jpeg_batch(paths + [str(tmp_path / "missing.jpg")], device=cuda)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    with pytest.raises(OSError, match="bad.jpg is not a decodable JPEG"):
        native.decode_jpeg_batch(paths + [str(bad)], device=cuda)


def test_preprocess_on_the_card_matches_the_cpu(cuda):
    """The MANO fit's objective at its start (loss rtol 1e-5, gradient
    within 1e-3 of each leaf's largest entry) and both smoothers at 50
    iterations (within 1e-3 of each leaf's largest entry), on the card and
    on the CPU. The fit's own trajectory is not compared: its first Adam
    steps (lr 0.1) take the sign of a translation gradient that is
    rounding noise at its start, so a 1e-7 change of the targets moves it
    as far (chip_smoke.py, phase preprocess)."""
    from harp_tpu_torch.assets import build_synthetic_hand
    from harp_tpu_torch.models.mano import mano_forward
    from harp_tpu_torch.preprocess import smooth_camera_sequence, smooth_pose_sequence
    from harp_tpu_torch.preprocess.fit import mano_fit_objective

    model = build_synthetic_hand()
    rng = np.random.RandomState(0)
    B = 6
    pose = torch.from_numpy((0.3 * rng.randn(B, 48)).astype(np.float32))
    betas = torch.from_numpy((0.3 * rng.randn(B, 10)).astype(np.float32))
    trans = torch.from_numpy((0.05 * rng.randn(B, 3)).astype(np.float32))
    target, joints = mano_forward(model, pose, betas, trans)
    seq = {"rot": pose[:, :3].numpy(), "pose": pose[:, 3:].numpy(), "shape": betas.numpy(),
           "trans": trans.numpy(), "cam": np.tile([5.0, 0.0, 0.0], (B, 1)).astype(np.float32),
           "joints": joints.numpy() + rng.randn(B, 21, 3).astype(np.float32)}
    runs = {}
    for dev in ("cpu", cuda):
        _, loss_fn, p = mano_fit_objective(model, target, device=dev)
        p = {k: v.requires_grad_(True) for k, v in p.items()}
        loss = loss_fn(p)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        sp = smooth_pose_sequence(model, seq, total_iters=50, device=dev)
        sc = smooth_camera_sequence(model, seq, total_iters=50, device=dev)
        runs[str(dev)] = {"loss": loss.detach(), **{f"grad_{k}": g for k, g in grads.items()},
                          "pose": sp["pose"], "rot": sp["rot"], "cam": sc["cam"]}
        assert all(v.device.type == torch.device(dev).type for v in runs[str(dev)].values())
    want, got = runs["cpu"], {k: v.cpu() for k, v in runs[str(cuda)].items()}
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * float(want["loss"])
    for k in want:
        assert (got[k] - want[k]).abs().max() <= 1e-3 * want[k].abs().max(), k


def test_real_data_fit_with_logs_repeats_bit_equal(cuda, tmp_path, monkeypatch):
    """The CLI's real-data path on the card at 64^2: model files and a
    two-sequence layout written from the synthetic hand at reference
    density, a 2-epoch fit with the image and val logs, twice: the same
    saved parameters, bit for bit, and the logs written."""
    import pickle

    from harp_tpu_torch.assets import build_synthetic_assets, write_hand_model_files
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.data.dataset import write_sequence
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.fit_avatar import main
    from harp_tpu_torch.models.zoo import load_hand_model

    monkeypatch.chdir(tmp_path)
    write_hand_model_files(build_synthetic_assets(uv_size=64, density="reference"),
                           "MANO_RIGHT.pkl", "template/hand/textured_hand.obj",
                           "template/hand/uv_mask.png")
    config = HarpConfig(img_size=64, focal_length=2000.0 * 64 / 448, texture_size=64)
    assets, _ = load_hand_model(config, mano_pkl="MANO_RIGHT.pkl")
    for seq, seed in (("1", 0), ("2", 1)):
        images, masks, _, _, init = make_synthetic_sequence(
            assets, config, config.raster_config(cap=4096), n_frames=4, seed=seed,
            device=cuda)
        write_sequence(str(tmp_path), seq, images, masks, init)
    argv = ["--metro-output-dir", ".", "--image-dir", ".", "--train-list", "1", "--val-list",
            "2", "--mano-pkl", "MANO_RIGHT.pkl", "--img-size", "64", "--texture-size", "64",
            "--stages", "1", "1", "0", "--epochs", "2", "--batch-size", "2",
            "--raster-cap", "4096", "--no-turntables"]
    saved = []
    for run in ("a", "b"):
        main(argv + ["--out", run])
        for name in ("sil_0000.jpg", "0000.jpg", "val_0000.jpg", "uv_0000.jpg",
                     "normal_0000.jpg", "fit_summary.json"):
            assert (tmp_path / run / name).exists(), name
        with open(tmp_path / run / "saved_params.pkl", "rb") as f:
            saved.append(pickle.load(f))
    for k in saved[0]:
        np.testing.assert_array_equal(saved[0][k], saved[1][k], err_msg=k)


def test_world_one_nccl_mesh_fit_equals_the_unsharded_fit(cuda):
    """fit_sequence(mesh=make_mesh(1)) over NCCL at 64^2 (stages 1 / 1 / 1,
    VGG bf16, 2 frames): the same history and final parameters as the fit
    with mesh=None, bit for bit (the one-rank all-reduce and mean are exact)."""
    from harp_tpu_torch.fit.driver import FitData, fit_sequence
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.parallel import make_mesh

    assets, config, rcfg, data, init = _light_fit_scene(cuda, img=64)
    runs = []
    for on_mesh in (False, True):
        params, aux = init_params(init, assets, config, device=cuda)
        if on_mesh:
            with make_mesh(1, device=cuda) as mesh:
                assert mesh.backend == "nccl" and mesh.world_size == 1
                runs.append(fit_sequence(config, assets, FitData(*data), params, aux,
                                         rcfg=rcfg, mesh=mesh))
        else:
            runs.append(fit_sequence(config, assets, FitData(*data), params, aux, rcfg=rcfg,
                                     device=cuda))
    assert not torch.distributed.is_initialized()
    (p0, h0), (p1, h1) = runs
    assert h0 == h1 and [h["epoch"] for h in h0] == [0, 1, 2]
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_orbax_checkpointer_snapshots_cuda_state(cuda, tmp_path):
    """save() copies CUDA parameters and Adam moments to the host before it
    returns: an Adam step taken while the writer is held does not reach
    the checkpoint."""
    import threading

    from harp_tpu_torch.utils.orbax_io import OrbaxCheckpointer

    g = torch.Generator(device=cuda).manual_seed(0)
    params = {"pose": torch.randn(18, 45, device=cuda, generator=g).requires_grad_(True),
              "texture": torch.rand(64, 64, 3, device=cuda, generator=g).requires_grad_(True)}
    opt = torch.optim.Adam(params.values(), lr=0.1)

    def adam_step():
        opt.zero_grad()
        sum((p ** 2).sum() for p in params.values()).backward()
        opt.step()

    adam_step()
    want = {k: v.detach().clone() for k, v in params.items()}
    want_m = opt.state[params["texture"]]["exp_avg"].clone()
    gate = threading.Event()
    with OrbaxCheckpointer(str(tmp_path)) as ckpt:
        ckpt._writer.submit(gate.wait)  # hold the writer while the state moves
        ckpt.save(1, params, {"coarse": opt.state_dict()})
        adam_step()  # in place, on the card
        gate.set()
        ckpt.wait()
        got = ckpt.restore(device=cuda)
    assert got["params"]["pose"].is_cuda
    for k, v in want.items():
        assert torch.equal(got["params"][k], v), k
        assert not torch.equal(params[k].detach(), v), k
    assert torch.equal(got["opt_states"]["coarse"]["state"][1]["exp_avg"], want_m.cpu())


def test_crop_on_the_card_is_the_cpus_bit_for_bit(cuda, tmp_path):
    """Pillow's resample and paste carried over in int64: the same bits on
    the card (down- and up-scaling, portrait and landscape, L and RGB)."""
    from harp_tpu_torch.preprocess import crop as C
    from harp_tpu_torch.utils import viz

    rng = np.random.RandomState(0)
    for h, w in ((190, 97), (61, 150), (20, 16)):
        rgba = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
        path = str(tmp_path / f"{h}_{w}.png")
        with open(path, "wb") as f:
            f.write(viz.encode_png(rgba))
        for res in (16, 48):
            card = C.crop_frame(path, None, res, device=cuda)
            cpu = C.crop_frame(path, None, res, device="cpu")
            assert card[0].is_cuda
            for a, b in zip(card, cpu):
                assert torch.equal(a.cpu(), b)


def test_turntable_on_the_card_in_groups_is_one_view_at_a_time(cuda):
    from harp_tpu_torch.assets import build_synthetic_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.utils import viz

    assets = build_synthetic_assets(uv_size=32, density="light")
    config = HarpConfig(img_size=64, focal_length=2000.0 * 64 / 448, texture_size=32)
    rcfg = RasterConfig(image_size=64, tile=16, cap=1024, span_tiles=4)
    _, _, _, gt, _ = make_synthetic_sequence(assets, config, rcfg, n_frames=1, device=cuda)
    for normal in (False, True):
        one = viz.turntable_views(gt, 0, assets, config, rcfg, normal, 4, chunk=1)
        assert one.is_cuda and one.shape == (8, 64, 64, 3)
        assert torch.equal(viz.turntable_views(gt, 0, assets, config, rcfg, normal, 4,
                                               chunk=8), one)
    one = viz.light_sweep_views(gt, 0, assets, config, rcfg, num=4, chunk=1)
    assert torch.equal(viz.light_sweep_views(gt, 0, assets, config, rcfg, num=4, chunk=4), one)


@pytest.fixture(scope="module")
def scan_fits(tmp_path_factory):
    """fit_sequence(epoch_scan=2) of the light hand at 64^2 (4 frames,
    minibatches of 2, VGG bf16 with the cached GT, stages 2 / 2 / 2: one
    segment of 4 steps a stage, the first a warm-up, then the capture and
    three replays), as CUDA graphs and, under anomaly mode, eagerly."""
    import dataclasses
    import json
    import os

    from harp_tpu_torch.fit.driver import FitData, fit_sequence
    from harp_tpu_torch.fit.params import init_params

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda = torch.device("cuda")
    assets, config, rcfg, data, init = _light_fit_scene(cuda, n_frames=4, img=64)
    config = dataclasses.replace(config, batch_size=2, training_stage=(2, 2, 2), total_epoch=6)
    out = {}
    for name, anomaly in (("graph", False), ("eager", True)):
        params, aux = init_params(init, assets, config, device=cuda)
        out_dir = str(tmp_path_factory.mktemp(name))
        with torch.autograd.set_detect_anomaly(anomaly):
            params, hist = fit_sequence(config, assets, FitData(*data), params, aux, rcfg=rcfg,
                                        out_dir=out_dir, epoch_scan=2)
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            lines = [r for r in map(json.loads, f) if "loss" in r]
        out[name] = (params, hist, lines)
    return out


def test_epoch_scan_replays_are_the_eager_segments_bit_for_bit(scan_fits):
    (pg, hg, _), (pe, he, _) = scan_fits["graph"], scan_fits["eager"]
    assert hg == he and [h["epoch"] for h in hg] == list(range(6))
    for k in pg:
        assert torch.equal(pg[k], pe[k]), k


def test_epoch_scan_captures_every_stage_flag_pair(scan_fits):
    lines = scan_fits["graph"][2]
    ends = [r for r in lines if "segment_s" in r]
    assert [r["epoch"] for r in ends] == [1.0, 3.0, 5.0]
    assert [r["graph"] for r in ends] == [True] * 3
    assert len([r for r in lines if "capture_s" in r]) == 3
    assert [r["graph"] for r in scan_fits["eager"][2] if "segment_s" in r] == [False] * 3
    assert scan_fits["graph"][1][-1]["loss"] < scan_fits["graph"][1][0]["loss"]


def test_a_profiled_scan_fit_stamps_every_replay_and_keeps_its_bits(cuda, monkeypatch):
    """fit_sequence(epoch_scan=2) of the light hand at 64^2, stages 2 / 2 / 2,
    once plainly and once under a recording torch.profiler: each stage's
    CUDA graph has the plain graph's kernel nodes plus its stamp nodes
    (csrc/stamp.cu: nine, eight in stage 1, which has no VGG input to
    mark), the history and parameters are the same bits, and every
    replayed step's stamps split into non-negative parts that sum to the
    step."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from harp_tpu_torch.fit import driver
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.utils import profiling

    assets, config, rcfg, data, init = _light_fit_scene(cuda, n_frames=4, img=64)
    config = dataclasses.replace(config, batch_size=2, training_stage=(2, 2, 2), total_epoch=6)
    nodes = []
    close = driver.EpochScan.close

    def counting_close(self):
        nodes.append(profiling.graph_kernel_counts(self.graph, {"stamp": "stamp_kernel"}))
        close(self)

    monkeypatch.setattr(driver.EpochScan, "close", counting_close)
    runs = []
    for traced in (False, True):
        params, aux = init_params(init, assets, config, device=cuda)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        if traced:
            prof.start()
        params, hist = driver.fit_sequence(config, assets, driver.FitData(*data), params, aux,
                                           rcfg=rcfg, epoch_scan=2)
        torch.cuda.synchronize()
        if traced:
            prof.stop()
        runs.append((params, hist))
    plain, stamped = nodes[:3], nodes[3:]
    assert [c["stamp"] for c, _ in plain] == [0, 0, 0]
    assert [c["stamp"] for c, _ in stamped] == [8, 9, 9]
    assert [n + c["stamp"] for (_, n), (c, _) in zip(plain, stamped)] == [n for _, n in stamped]
    assert runs[0][1] == runs[1][1]
    for k, p in runs[0][0].items():
        assert torch.equal(p, runs[1][0][k]), k
    fit = max((r for r in profiling.spans() if r["name"] == "fit"), key=lambda r: r["id"])
    reads = [r for r in profiling.spans(fit["id"]) if "stamps" in r]
    assert [r["stamps"]["eager"] for r in reads] == [1, 1, 1]
    for r in reads:
        t = r["stamps"]["t"][1:]
        assert t.shape == (3, len(profiling.STAMP_SLOTS)) and (t[:, [0, -1]] > 0).all()
        parts = profiling.step_parts(t)
        assert all((parts[k] >= 0).all() for k in ("geometry", "render", "vgg", "other", "adam"))
        assert (sum(parts[k] for k in ("geometry", "render", "vgg", "other", "adam"))
                == parts["step"]).all()


def test_jpeg_frame_crop_on_the_card_is_within_the_decode_bound(cuda, tmp_path):
    """An RGB frame written as JPEG by nvJPEG and cropped on the card
    (nvJPEG's decode, alpha 255) against the crop of the same frame,
    losslessly, on the CPU: within a mean of 0.015 (harp_tpu's JPEG bound);
    the masks equal (255)."""
    from harp_tpu_torch import native
    from harp_tpu_torch.preprocess import crop as C
    from harp_tpu_torch.utils import viz

    yy, xx = np.mgrid[0:120, 0:90].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / (5 + 3 * c) + yy / 11.0) for c in range(3)], -1)
    arr = (img * 255).astype(np.uint8)
    jpg, png = str(tmp_path / "0000.jpg"), str(tmp_path / "0000.png")
    native.encode_jpeg(torch.from_numpy(arr).to(cuda), jpg, 95)
    with open(png, "wb") as f:
        f.write(viz.encode_png(arr))
    rgb, mask = C.crop_frame(jpg, None, 48, device=cuda)
    want_rgb, want_mask = C.crop_frame(png, None, 48, device="cpu")
    assert rgb.is_cuda and rgb.shape == (48, 48, 3)
    assert torch.equal(mask.cpu(), want_mask) and bool((want_mask == 255).all())
    assert float((rgb.cpu().float() - want_rgb.float()).abs().mean()) / 255.0 < 0.015


def _eval_scene(cuda):
    """4 frames of the light hand at 64^2 with self-shadow, its data and two
    parameter sets (the fit's initial ones, the GT ones)."""
    from harp_tpu_torch.assets import build_synthetic_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.fit.driver import FitData
    from harp_tpu_torch.fit.params import init_params

    assets = build_synthetic_assets(uv_size=32, density="light")
    config = HarpConfig(img_size=64, focal_length=2000.0 * 64 / 448, texture_size=32,
                        self_shadow=True, batch_size=2)
    rcfg = RasterConfig(image_size=64, tile=16, cap=1024, span_tiles=4)
    images, masks, masks_er, gt, init = make_synthetic_sequence(assets, config, rcfg,
                                                                n_frames=4, device=cuda)
    p_init, _ = init_params(init, assets, config, device=cuda)
    p_gt = {k: (gt[k] if k in gt and gt[k].shape == v.shape else v).detach().clone()
            for k, v in p_init.items()}
    return assets, config, rcfg, FitData(images, masks, masks_er), p_init, p_gt


def _same_eval(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))
            and all(torch.equal(a[6][k], b[6][k]) for k in a[6]))


def test_eval_program_graph_is_the_eager_body_bit_for_bit(cuda):
    """make_eval_program's CUDA graph (two groups of two frames) gives the
    same bits as the same program run eagerly, and replays the same bits."""
    from harp_tpu_torch.fit.evaluate import make_eval_program

    assets, config, rcfg, data, p_init, _ = _eval_scene(cuda)
    kw = dict(render_batch=2, device=cuda)
    prog, g = make_eval_program(config, assets, data, rcfg, **kw)
    eager, _ = make_eval_program(config, assets, data, rcfg, graph=False, **kw)
    want = eager(p_init, data.images, data.masks)
    got = prog(p_init, data.images, data.masks)
    assert prog.graph is not None and prog.captures == 1 and prog.capture_s > 0
    assert g == 2 and got[4].shape == (4, 64, 256, 3) and got[4].is_cuda
    assert _same_eval(got, want)
    assert _same_eval(prog(p_init, data.images, data.masks), want)
    assert prog.captures == 1 and not any(int(v) for v in got[6].values())
    prog.close()


def test_eval_program_second_call_copies_in_on_the_card(cuda):
    """A replay with other parameters and other images computes from
    those: what the eager body gives for them, not the captured tensors'."""
    from harp_tpu_torch.fit.evaluate import make_eval_program

    assets, config, rcfg, data, p_init, p_gt = _eval_scene(cuda)
    kw = dict(render_batch=2, device=cuda)
    prog, _ = make_eval_program(config, assets, data, rcfg, **kw)
    eager, _ = make_eval_program(config, assets, data, rcfg, graph=False, **kw)
    first = prog(p_init, data.images, data.masks)
    images, masks = data.images.flip(0).contiguous(), data.masks.flip(0).contiguous()
    second = prog(p_gt, images, masks)
    assert _same_eval(second, eager(p_gt, images, masks))
    assert not torch.equal(first[1], second[1])
    prog.close()


@pytest.mark.parametrize("scene", ["sparse", "busy", "dense"])
def test_dense_raster_api_on_the_card_equals_its_plain_version(cuda, scene):
    """raster_full / get_ids / rasterize_* through K1 on the card: the ids
    of the CPU's plain version, soft_sum within rtol 1e-5, and
    soft_alpha_fast's gradient within 1e-4 of the CPU's largest entry."""
    from harp_tpu_torch.render import rasterizer as R

    make, cap = SCENES[scene]
    cfg = RasterConfig(image_size=32, tile=16, cap=cap, faces_per_pixel=8, active_fraction=0.75)
    verts, faces = make(cfg)
    v_card, v_cpu = torch.from_numpy(verts).to(cuda), torch.from_numpy(verts)
    card, cpu = R.raster_full(v_card, faces, cfg), R.raster_full(v_cpu, faces, cfg)
    for k in ("soft_ids", "hard_ids") + R.OVERFLOW:
        assert torch.equal(card[k].cpu(), cpu[k]), k
    torch.testing.assert_close(card["soft_sum"].cpu(), cpu["soft_sum"], rtol=1e-5, atol=1e-6)
    assert torch.equal(R.rasterize_hard(v_card, faces, cfg).cpu(), cpu["hard_ids"])
    soft, hard = R.get_ids(v_card, faces, cfg)
    assert torch.equal(soft.cpu(), cpu["soft_ids"]) and torch.equal(hard.cpu(), cpu["hard_ids"])
    g = torch.from_numpy(np.random.RandomState(0).normal(size=cpu["soft_sum"].shape)
                         .astype(np.float32))
    grads = []
    for v, out, gg in ((v_card, card, g.to(cuda)), (v_cpu, cpu, g)):
        v = v.clone().requires_grad_(True)
        alpha = R.soft_alpha_fast(out["soft_ids"], out["soft_sum"], v, faces, cfg)
        grads.append(torch.autograd.grad((alpha * gg).sum(), v)[0].cpu())
    assert (grads[0] - grads[1]).abs().max() <= 1e-4 * grads[1].abs().max()
