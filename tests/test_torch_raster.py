"""K1's plain PyTorch version (harp_tpu_torch raster_compact on the CPU) vs
harp_tpu's Pallas raster kernel in interpret mode and its XLA tile pass.

Ids, active tiles and overflow counters must be EXACTLY equal; the
coverage log-sum to rtol 1e-5 / atol 1e-6 (both sum the same float32
terms, in another order), with a counted exception: XLA:CPU contracts
a*b + c*d into FMAs, the port does not (nor does its CUDA kernel, built
with -fmad=false). A pixel a hundredth of a pixel inside an edge has a
squared edge distance of ~1e-4 px^2 left after cancellation, and its
coverage term -softplus(-d/sigma) amplifies the last-bit difference of
that distance ~4e4 times. At most a NEAR_EDGE fraction of a scene's
pixels may differ, by at most rtol 2e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.render.pallas.raster_kernel import pallas_raster_compact
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig, _rasterize_ids
from harp_tpu_torch.render.rasterizer import RasterConfig, raster_compact

BASE = dict(image_size=32, tile=8, cap=64, bin_chunk=8, tile_chunk=4,
            face_chunk=16, faces_per_pixel=4)


def _random_scene(seed=0, n=30, B=2, spread=4.0):
    rng = np.random.RandomState(seed)
    verts = np.zeros((B, n * 3, 3), np.float32)
    for b in range(B):
        centers = rng.uniform(2, 30, size=(n, 2))
        offsets = rng.uniform(-spread, spread, size=(n, 3, 2))
        verts[b, :, :2] = (centers[:, None] + offsets).reshape(-1, 2)
        verts[b, :, 2] = rng.uniform(0.5, 3.0, size=(n, 1)).repeat(3, 1).reshape(-1)
    faces = np.arange(n * 3).reshape(n, 3).astype(np.int32)
    return verts, faces


NEAR_EDGE = 0.005


def _assert_ssum_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    off = ~np.isclose(got, want, rtol=1e-5, atol=1e-6)
    assert off.sum() <= NEAR_EDGE * off.size, f"{off.sum()} pixels beyond rtol 1e-5"
    np.testing.assert_allclose(got[off], want[off], rtol=2e-4)


CASES = {
    # name: (scene kwargs, config overrides)
    "random": (dict(seed=0, n=30), {}),
    "active_half": (dict(seed=3, n=20), dict(active_fraction=0.5)),
    # cap 448 with the default face_chunk 256: the plain pass walks a
    # ragged last chunk and must not visit slots 192..255 twice.
    "cap448_chunk256": (dict(seed=5, n=400, spread=6.0),
                        dict(cap=448, face_chunk=256, faces_per_pixel=8)),
    "cap_truncates": (dict(seed=7, n=200, spread=6.0), dict(cap=24)),
}


def _both(verts, faces, over, need_soft=True):
    jcfg = JRasterConfig(**dict(BASE, **over))
    pcfg = RasterConfig(**dict(BASE, **over))
    jo = pallas_raster_compact(jnp.asarray(verts), jnp.asarray(faces), jcfg,
                               interpret=True, need_soft=need_soft)
    po = raster_compact(torch.from_numpy(verts), faces, pcfg, need_soft=need_soft)
    return jcfg, jo, po


@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_plain_matches_pallas_interpret(case):
    scene, over = CASES[case]
    verts, faces = _random_scene(**scene)
    _, jo, po = _both(verts, faces, over)
    for key in ("act_idx", "hard_ids", "soft_ids", "bin_overflow",
                "active_overflow", "span_overflow"):
        np.testing.assert_array_equal(po[key].numpy(), np.asarray(jo[key]), err_msg=key)
    _assert_ssum_close(po["soft_sum"].numpy(), jo["soft_sum"])
    if case == "cap_truncates":
        assert int(po["bin_overflow"].sum()) > 0


def test_k1_depth_only_matches_pallas_interpret():
    verts, faces = _random_scene(seed=3, n=40)
    _, jo, po = _both(verts, faces, {}, need_soft=False)
    assert "soft_ids" not in po and "soft_sum" not in po
    for key in ("act_idx", "hard_ids", "bin_overflow", "active_overflow",
                "span_overflow"):
        np.testing.assert_array_equal(po[key].numpy(), np.asarray(jo[key]), err_msg=key)


@pytest.mark.parametrize("active_fraction", [1.0, 0.5])
def test_k1_plain_matches_xla_tile_pass_on_occupied_tiles(active_fraction):
    """The XLA tile pass rounds the active budget to tile_chunk, not TC;
    both cover every occupied tile, so compare those."""
    verts, faces = _random_scene(seed=11, n=60)
    over = dict(active_fraction=active_fraction, cap=448, face_chunk=256)
    jcfg = JRasterConfig(**dict(BASE, **over))
    xo = _rasterize_ids(jnp.asarray(verts), jnp.asarray(faces), jcfg, True, True,
                        compact=True)
    po = raster_compact(torch.from_numpy(verts), faces,
                        RasterConfig(**dict(BASE, **over)))
    got, want = [], []
    for b in range(verts.shape[0]):
        xa = list(np.asarray(xo["act_idx"][b]))
        for i, t in enumerate(po["act_idx"][b].tolist()):
            if (po["hard_ids"][b, i] >= 0).any() or (po["soft_ids"][b, i] >= 0).any():
                got.append((b, i))
                want.append((b, xa.index(t)))
    assert got, "scene has no occupied tile"
    (pb, pi), (xb, xi) = np.array(got).T, np.array(want).T
    for key in ("hard_ids", "soft_ids"):
        np.testing.assert_array_equal(po[key].numpy()[pb, pi], np.asarray(xo[key])[xb, xi])
    _assert_ssum_close(po["soft_sum"].numpy()[pb, pi], np.asarray(xo["soft_sum"])[xb, xi])
    for key in ("bin_overflow", "span_overflow"):
        np.testing.assert_array_equal(po[key].numpy(), np.asarray(xo[key]))


def test_k1_flagship_budgets_match_pallas_rounding():
    """At 448^2 the camera pass keeps A=224 of 784 tiles and the light pass
    (light_raster_config at scale 0.5) A=88 of 196 at cap 1344."""
    from harp_tpu.render.shadow import light_raster_config as jlight
    from harp_tpu_torch.render.rasterizer import active_budget
    from harp_tpu_torch.render.shadow import light_raster_config

    kw = dict(image_size=448, active_fraction=0.28, cap=448, span_tiles=3)
    cam = RasterConfig(**kw)
    light = light_raster_config(cam, 0.5)
    assert active_budget(cam) == 224
    assert (light.image_size, light.cap, active_budget(light)) == (224, 1344, 88)
    assert dataclasses.asdict(light) == dataclasses.asdict(jlight(JRasterConfig(**kw), 0.5))
