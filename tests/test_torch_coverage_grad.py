"""K2's plain PyTorch version (the coverage log-sum backward, with its face
segment sum and vertex scatter) vs harp_tpu's Pallas kernel in interpret
mode, and vs the all-faces brute-force gradient.

Tolerance: 2e-4 of the largest gradient entry. The sums run in other
orders (per tile slot, then per face, then per vertex), and XLA:CPU
contracts multiply-adds into FMAs where the port does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from harp_tpu.render.pallas.raster_kernel import pallas_coverage_grad, pallas_raster_compact
from harp_tpu.render.rasterizer import (
    RasterConfig as JRasterConfig, _pixel_centers, face_pixel_geometry,
)
from harp_tpu_torch.ops.segment import TableOrder
from harp_tpu_torch.render.kernels.raster_kernel import coverage_grad_verts
from harp_tpu_torch.render.rasterizer import (
    RasterConfig, raster_compact, scatter_tiles, soft_alpha_fast_pack,
)

IMG = 32


def _scene(seed=0, V=30, F=18):
    rng = np.random.RandomState(seed)
    verts = np.stack([rng.uniform(2, 30, V), rng.uniform(2, 30, V),
                      rng.uniform(1.5, 3.0, V)], 1).astype(np.float32)[None]
    faces = rng.choice(V, (F, 3)).astype(np.int32)
    return verts, faces


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)


def test_k2_plain_matches_pallas_interpret():
    kw = dict(image_size=IMG, tile=8, cap=32, faces_per_pixel=4, active_fraction=0.75)
    verts, faces = _scene(seed=1, V=40, F=30)
    verts = np.concatenate([verts, _scene(seed=2, V=40, F=30)[0]], 0)  # B = 2
    jcfg, pcfg = JRasterConfig(**kw), RasterConfig(**kw)
    jo = pallas_raster_compact(jnp.asarray(verts), jnp.asarray(faces), jcfg, interpret=True)
    po = raster_compact(torch.from_numpy(verts), faces, pcfg)
    np.testing.assert_array_equal(po["act_idx"].numpy(), np.asarray(jo["act_idx"]))
    g = np.random.RandomState(3).normal(size=po["soft_sum"].shape).astype(np.float32)
    want = np.asarray(pallas_coverage_grad(jo["pack"], jnp.asarray(g), jnp.asarray(faces),
                                           verts.shape[1], jcfg, interpret=True))
    got = coverage_grad_verts(po["bins"], torch.from_numpy(g),
                              TableOrder.of(faces, verts.shape[1]), pcfg)
    assert np.abs(want).max() > 0
    assert _rel_err(got.numpy(), want) < 2e-4
    # z lanes get exactly zero gradient.
    assert not got[..., 2].any()


def test_k2_plain_matches_all_faces_brute_force():
    """The scene of tests/test_pallas_raster.py's fused-backward check."""
    kw = dict(image_size=IMG, tile=8, cap=32, faces_per_pixel=8, active_fraction=1.0)
    jcfg, pcfg = JRasterConfig(**kw), RasterConfig(**kw)
    verts, faces = _scene()
    target = (np.indices((IMG, IMG)).sum(0) % 2).astype(np.float32)[None]

    def alpha_brute(v):
        fv = v[:, faces]
        px, py = _pixel_centers(jcfg)
        g = face_pixel_geometry(fv[:, :, None, None, :, :], px[None, None],
                                py[None, None], jcfg)
        d_px2 = g["signed_d_ndc2"] / (jcfg.ndc_scale**2)
        hit = g["valid"] & (d_px2 <= jcfg.blur_px2)
        contrib = -jax.nn.softplus(-g["signed_d_ndc2"] / jcfg.sigma)
        return 1.0 - jnp.exp(jnp.where(hit, contrib, 0.0).sum(axis=1))

    def loss_brute(v):
        return jnp.abs(alpha_brute(v) - jnp.asarray(target)).mean()

    v = torch.from_numpy(verts).requires_grad_(True)
    out = raster_compact(v, faces, pcfg)
    alpha_c = soft_alpha_fast_pack(out["soft_sum"], out["bins"], v,
                                   TableOrder.of(faces, verts.shape[1]), pcfg)
    alpha = scatter_tiles(alpha_c, out["act_idx"], pcfg, 0.0)
    loss = (alpha - torch.from_numpy(target)).abs().mean()
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(loss_brute(jnp.asarray(verts))), rtol=1e-6)
    gb = np.asarray(jax.grad(loss_brute)(jnp.asarray(verts)))
    assert _rel_err(v.grad.numpy(), gb) < 2e-4
