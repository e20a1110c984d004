"""harp_tpu_torch's dense raster API (raster_full, get_ids, rasterize_soft /
hard, rasterize, soft_alpha_from_ids[_at], soft_alpha_fast[_at],
rasterize_brute) and the pipeline's raster_camera_view / precomputed=, on
the CPU, against harp_tpu's on the same numpy-seeded scenes (harp_tpu's
XLA path, and its Pallas kernel in interpret mode where the budget rounds
alike).

Ids and overflow counters must be exactly equal. The coverage log-sum and
the alpha follow tests/test_torch_raster.py's near-edge rule (XLA:CPU
contracts FMAs, the port does not): at most a NEAR_EDGE fraction of pixels
beyond rtol 1e-5, and those within rtol 2e-4. Gradients with respect to
the screen vertices within 1e-4 of the largest entry of harp_tpu's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.render import rasterizer as JR
from harp_tpu.render.pallas.raster_kernel import pallas_rasterize
from harp_tpu_torch.ops.segment import TableOrder
from harp_tpu_torch.render import rasterizer as R
from test_torch_raster import BASE, _assert_ssum_close, _random_scene

OVERFLOW = ("bin_overflow", "active_overflow", "span_overflow")
GRAD_RTOL = 1e-4  # of the leaf's largest gradient entry


def _crowded_scene():
    """Frame 0: eight thin triangles around the centre of pixel (12, 12),
    one along each axis and diagonal direction, each pointing away from it
    with its apex 2^-8 px along that direction from the centre (the pixel
    lies outside all eight, within the blur radius of every one, at
    distances where d / sigma is 0.6 and 1.2 and the coverage gradient is
    large: more than K = 4 within-blur faces). Every coordinate is a short
    binary fraction, so that the edge distances are exact in float32 and
    both packages compute the same numbers. Frame 1: a random scene of as
    many faces."""
    dirs = [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1)]
    n = len(dirs)
    verts = np.zeros((2, n * 3, 3), np.float32)
    p = np.array([12.5, 12.5])
    for i, d in enumerate(dirs):
        u, w = np.array(d, np.float64), np.array([-d[1], d[0]], np.float64)
        apex = p + u / 256.0
        verts[0, 3 * i:3 * i + 3, :2] = [apex, apex + 3 * u + w, apex + 3 * u - w]
        verts[0, 3 * i:3 * i + 3, 2] = 1.0 + 0.125 * i
    verts[1] = _random_scene(seed=13, n=n, B=1)[0][0]
    return verts, np.arange(n * 3).reshape(n, 3).astype(np.int32)


SCENES = {
    "random": (lambda: _random_scene(seed=0, n=30), {}),
    "active_half": (lambda: _random_scene(seed=3, n=20), dict(active_fraction=0.5)),
    "cap448_chunk256": (lambda: _random_scene(seed=5, n=400, spread=6.0),
                        dict(cap=448, face_chunk=256, faces_per_pixel=8)),
    "cap_truncates": (lambda: _random_scene(seed=7, n=200, spread=6.0), dict(cap=24)),
    "crowded": (_crowded_scene, {}),
}


def _cfgs(over):
    kw = dict(BASE, **over)
    return JR.RasterConfig(**kw), R.RasterConfig(**kw)


def _assert_full_equal(got: dict, want: dict, keys):
    for k in keys:
        if k == "soft_sum":
            _assert_ssum_close(got[k].numpy(), want[k])
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("scene,need", [
    ("random", (True, True)), ("random", (True, False)), ("random", (False, True)),
    ("active_half", (True, True)), ("cap448_chunk256", (True, True)),
    ("cap_truncates", (True, True)), ("crowded", (True, True))])
def test_raster_full_matches_harp_tpu(scene, need):
    """The XLA path (harp_tpu's raster_full off the TPU): both round the
    active budget to 8 tiles here, so every output is comparable."""
    make, over = SCENES[scene]
    verts, faces = make()
    jcfg, cfg = _cfgs(over)
    want = JR.raster_full(jnp.asarray(verts), faces, jcfg, *need)
    got = R.raster_full(torch.from_numpy(verts), faces, cfg, *need)
    keys = (("soft_ids", "soft_sum") if need[0] else ()) + (("hard_ids",) if need[1] else ())
    assert set(got) == set(keys) | set(OVERFLOW)
    _assert_full_equal(got, want, keys + OVERFLOW)
    assert all(got[k].dtype == torch.int32 for k in keys if k != "soft_sum")
    if scene == "cap_truncates":
        assert int(got["bin_overflow"].sum()) > 0


@pytest.mark.parametrize("need_soft", [True, False])
def test_raster_full_matches_the_pallas_kernel_in_interpret_mode(need_soft):
    """harp_tpu's pallas_rasterize (the kernel's full-image scatter, fills
    -1 / 0 / -1), half the tiles active."""
    make, over = SCENES["active_half"]
    verts, faces = make()
    jcfg, cfg = _cfgs(over)
    soft, ssum, hard = pallas_rasterize(jnp.asarray(verts), jnp.asarray(faces), jcfg,
                                        interpret=True, need_soft=need_soft)
    got = R.raster_full(torch.from_numpy(verts), faces, cfg, need_soft=need_soft)
    np.testing.assert_array_equal(got["hard_ids"].numpy(), np.asarray(hard))
    if need_soft:
        np.testing.assert_array_equal(got["soft_ids"].numpy(), np.asarray(soft))
        _assert_ssum_close(got["soft_sum"].numpy(), ssum)
    assert int(got["active_overflow"].sum()) > 0  # occupied tiles left to the fills


@pytest.mark.parametrize("name", ["get_ids", "get_ids_hard", "rasterize_soft",
                                  "rasterize_hard", "rasterize"])
def test_dense_id_functions_match_harp_tpu(name):
    verts, faces = SCENES["random"][0]()
    jcfg, cfg = _cfgs({})
    jv, tv = jnp.asarray(verts), torch.from_numpy(verts)
    if name == "get_ids_hard":
        want = JR.get_ids(jv, faces, jcfg, need_soft=False)
        got = R.get_ids(tv, faces, cfg, need_soft=False)
        assert got[0] is None and want[0] is None
        want, got = want[1:], got[1:]
    else:
        want = getattr(JR, name)(jv, faces, jcfg)
        got = getattr(R, name)(tv, faces, cfg)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _alpha_case(fn: str, verts, faces, jcfg, cfg, seed: int = 1):
    """(port alpha, port grad, harp_tpu alpha, harp_tpu grad) of fn, the
    gradient of sum(alpha * w) for numpy-seeded weights w."""
    jv, tv = jnp.asarray(verts), torch.from_numpy(verts).requires_grad_(True)
    full = JR.raster_full(jv, faces, jcfg, True, False)
    ids, ssum = full["soft_ids"], full["soft_sum"]
    tout = R.raster_full(tv, faces, cfg, True, False)
    np.testing.assert_array_equal(tout["soft_ids"].numpy(), np.asarray(ids))
    compact = fn.endswith("_at")
    if compact:
        jc = JR._rasterize_ids(jv, jnp.asarray(faces), jcfg, True, False, compact=True)
        tc = R.raster_compact(tv, faces, cfg, need_hard=False)
        np.testing.assert_array_equal(tc["act_idx"].numpy(), np.asarray(jc["act_idx"]))
        jpx, jpy = JR.tile_pixel_coords(jc["act_idx"], jcfg)
        px, py = R.tile_pixel_coords(tc["act_idx"], cfg)
        ids, ssum, tids, tssum = jc["soft_ids"], jc["soft_sum"], tc["soft_ids"], tc["soft_sum"]
    else:
        tids, tssum = tout["soft_ids"], tout["soft_sum"]
    w = np.random.RandomState(seed).uniform(-1, 1, np.asarray(ssum).shape).astype(np.float32)

    def jalpha(v):
        if fn == "soft_alpha_from_ids":
            return JR.soft_alpha_from_ids(ids, v, faces, jcfg)
        if fn == "soft_alpha_fast":
            return JR.soft_alpha_fast(ids, ssum, v, faces, jcfg)
        if fn == "soft_alpha_from_ids_at":
            return JR.soft_alpha_from_ids_at(ids, v, faces, jcfg, jpx, jpy)
        return JR.soft_alpha_fast_at(ids, ssum, v, faces, jcfg, jpx, jpy)

    def jloss(v):
        a = jalpha(v)
        return (a * w).sum(), a

    (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jv)
    if fn == "soft_alpha_from_ids":
        got = R.soft_alpha_from_ids(tids, tv, faces, cfg)
    elif fn == "soft_alpha_fast":
        got = R.soft_alpha_fast(tids, tssum, tv, faces, cfg)
    elif fn == "soft_alpha_from_ids_at":
        got = R.soft_alpha_from_ids_at(tids, tv, faces, cfg, px, py)
    else:
        got = R.soft_alpha_fast_at(tids, tssum, tv, faces, cfg, px, py)
    (tgrad,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), tv)
    return got.detach().numpy(), tgrad.numpy(), np.asarray(want), np.asarray(jgrad)


@pytest.mark.parametrize("scene", ["random", "crowded"])
@pytest.mark.parametrize("fn", ["soft_alpha_from_ids", "soft_alpha_fast",
                                "soft_alpha_from_ids_at", "soft_alpha_fast_at"])
def test_soft_alpha_and_its_gradient_match_harp_tpu(fn, scene):
    make, over = SCENES[scene]
    verts, faces = make()
    got, tgrad, want, jgrad = _alpha_case(fn, verts, faces, *_cfgs(over))
    assert got.shape == want.shape
    _assert_ssum_close(got, want)
    assert np.abs(jgrad).max() > 0
    np.testing.assert_allclose(tgrad, jgrad, rtol=0, atol=GRAD_RTOL * np.abs(jgrad).max())


def test_soft_alpha_fast_is_k_truncated_where_k2_is_not():
    """On the crowded pixel (more than K within-blur faces) soft_alpha_fast
    differentiates through the first K ids, as harp_tpu's does, and so
    parts from K2's all-faces gradient (soft_alpha_fast_pack, the step's);
    away from that pixel the two agree."""
    verts, faces = _crowded_scene()
    jcfg, cfg = _cfgs({})
    _, tgrad, _, jgrad = _alpha_case("soft_alpha_fast_at", verts, faces, jcfg, cfg)
    tv = torch.from_numpy(verts).requires_grad_(True)
    out = R.raster_compact(tv, faces, cfg, need_hard=False)
    assert int((out["soft_ids"][0] >= 0).sum(-1).max()) == cfg.faces_per_pixel
    alpha = R.soft_alpha_fast_pack(out["soft_sum"], out["bins"], tv,
                                   TableOrder.of(faces, verts.shape[1]), cfg)
    w = np.random.RandomState(1).uniform(-1, 1, tuple(alpha.shape)).astype(np.float32)
    (k2,) = torch.autograd.grad((alpha * torch.from_numpy(w)).sum(), tv)
    k2 = k2.numpy()
    scale = np.abs(jgrad).max()
    np.testing.assert_allclose(tgrad, jgrad, rtol=0, atol=GRAD_RTOL * scale)
    assert np.abs(k2[0] - tgrad[0]).max() > 0.1 * scale  # the crowded frame
    np.testing.assert_allclose(k2[1], tgrad[1], rtol=0, atol=GRAD_RTOL * scale)


@pytest.mark.parametrize("scene", ["random", "crowded"])
def test_rasterize_brute_matches_harp_tpu_and_the_tiled_ids(scene):
    make, over = SCENES[scene]
    verts, faces = make()
    jcfg, cfg = _cfgs(over)
    tv = torch.from_numpy(verts)
    soft, hard = R.rasterize_brute(tv, faces, cfg)
    brute = jax.jit(JR.rasterize_brute, static_argnames="cfg")
    jsoft, jhard = brute(jnp.asarray(verts), jnp.asarray(faces), cfg=jcfg)
    np.testing.assert_array_equal(soft.numpy(), np.asarray(jsoft))
    np.testing.assert_array_equal(hard.numpy(), np.asarray(jhard))
    tsoft, thard = R.rasterize(tv, faces, cfg)
    assert not any(int(v.sum()) for k, v in R.raster_full(tv, faces, cfg).items()
                   if k in OVERFLOW)
    np.testing.assert_array_equal(tsoft.numpy(), soft.numpy())
    np.testing.assert_array_equal(thard.numpy(), hard.numpy())
    assert (hard >= 0).any() and (soft[..., 1] >= 0).any()


@pytest.fixture(scope="module")
def hand():
    from harp_tpu_torch.assets import build_synthetic_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.render import pipeline

    config = HarpConfig(img_size=32, focal_length=2000.0 * 32 / 448, texture_size=16,
                        self_shadow=False, batch_size=2)
    rcfg = R.RasterConfig(image_size=32, tile=8, cap=1024, faces_per_pixel=8, span_tiles=4)
    assets = build_synthetic_assets(uv_size=16, density="light")
    _, _, _, gt, _ = make_synthetic_sequence(assets, config, rcfg, n_frames=2, seed=0,
                                             device="cpu")
    fids = torch.arange(2)
    with torch.no_grad():
        verts, _ = pipeline.mesh_forward(gt, fids, assets, config)
        Rm, T = pipeline.camera_for_frames(gt, fids, config)
    return dict(config=config, rcfg=rcfg, assets=assets, gt=gt, verts=verts, R=Rm, T=T)


@pytest.mark.parametrize("render", ["rgb", "normal"])
def test_precomputed_renders_equal_the_plain_renders(hand, render):
    """raster_camera_view's hard ids handed to render_rgb / render_normal
    (precomputed=) give the same bits as their own depth-only pass."""
    from harp_tpu_torch.render import pipeline

    h = hand
    args = (h["verts"], h["assets"], h["R"], h["T"], h["config"], h["rcfg"])
    with torch.no_grad():
        screen, out = pipeline.raster_camera_view(*args)
        assert {"soft_ids", "soft_sum", "hard_ids"} <= set(out)
        assert not any(int(out[k].sum()) for k in OVERFLOW)
        if render == "rgb":
            extra = (h["gt"]["texture"], h["gt"]["normal_map"],
                     h["gt"]["light_positions"][:2])
            plain = pipeline.render_rgb(*args, *extra)
            shared = pipeline.render_rgb(*args, *extra, precomputed=(screen, out["hard_ids"]))
        else:
            plain = pipeline.render_normal(*args, h["gt"]["normal_map"])
            shared = pipeline.render_normal(*args, h["gt"]["normal_map"],
                                            precomputed=(screen, out["hard_ids"]))
    assert plain.shape == (2, 32, 32, 3)
    assert (plain != 1.0).any() and (plain == 1.0).any()  # hand and background
    assert torch.equal(plain, shared)


def test_render_package_exports_harp_tpus_names():
    import harp_tpu.render as jrender
    import harp_tpu_torch.render as render

    names = {n for n in dir(jrender) if not n.startswith("_")} - {"pallas"}
    assert names <= set(dir(render))
    assert dataclasses.fields(render.RasterConfig)
