"""K3's plain PyTorch version (the PCF light-map gradient scatter) and the
port's pcf_visibility vs harp_tpu's Pallas scatter kernel in interpret mode.

Tolerance: rtol 1e-6 (atol 1e-5 for sums that cancel to ~0) on the
scatter, the tests/test_shading.py bound: both add the same float32 terms
in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.render.pallas.pcf_grad_kernel import fold_pad2 as jfold_pad2, pallas_pcf_scatter
from harp_tpu.render.shadow import pcf_visibility as jpcf_visibility
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.render.kernels.pcf_grad_kernel import fold_pad2, pcf_scatter
from harp_tpu_torch.render.shadow import pcf_visibility


def test_k3_plain_and_fold_match_pallas_interpret():
    rng = np.random.default_rng(7)
    B, Hl, N = 2, 28, 300  # N % 256 != 0
    yc = rng.integers(1, Hl + 3, size=(B, N)).astype(np.int32)
    xc = rng.integers(1, Hl + 3, size=(B, N)).astype(np.int32)
    yc[0, :4] = [1, Hl + 2, 1, Hl + 2]
    xc[0, :4] = [1, 1, Hl + 2, Hl + 2]
    upd = rng.normal(size=(B, N, 9)).astype(np.float32)
    upd[1, :50] = 0.0  # saturated taps carry exactly zero

    want = np.asarray(pallas_pcf_scatter(jnp.asarray(yc), jnp.asarray(xc),
                                         jnp.asarray(upd), Hl, interpret=True))
    t = [torch.from_numpy(a) for a in (yc, xc, upd)]
    got = pcf_scatter(*t, Hl)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(fold_pad2(got).numpy(),
                               np.asarray(jfold_pad2(jnp.asarray(got.numpy()))),
                               rtol=1e-6, atol=1e-6)


def test_pcf_visibility_and_depth_gradient_match_harp_tpu():
    """Values, and gradients w.r.t. the depth map (K3 + fold) and the point
    depths, including clipped out-of-range tap centres."""
    jcfg = JHarpConfig(img_size=32, texture_size=16, pcf_backend="pallas_interpret")
    pcfg = HarpConfig(img_size=32, texture_size=16)
    rng = np.random.default_rng(5)
    B, Hl = 2, 19
    depth = rng.normal(size=(B, Hl, Hl)).astype(np.float32)
    xs = np.concatenate([rng.integers(0, Hl, size=40),
                         [-7, -2, -1, 0, 1, Hl - 2, Hl - 1, Hl, Hl + 1, Hl + 6]])
    ys = np.concatenate([rng.integers(0, Hl, size=40),
                         [Hl + 3, Hl, Hl - 1, 0, -1, -5, 2, Hl - 2, 1, -1]])
    x = np.stack([xs, ys]).astype(np.int32)
    y = np.stack([ys, xs]).astype(np.int32)
    # Depths near the map's so the sigmoid is not saturated everywhere.
    a = (depth[:, 5, 5][:, None] + 0.002 * rng.normal(size=x.shape)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    def jloss(d, aa):
        return (jpcf_visibility(d, jnp.asarray(x), jnp.asarray(y), aa, jcfg) * g).sum()

    jv = np.asarray(jpcf_visibility(jnp.asarray(depth), jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(a), jcfg))
    jd, ja = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(depth), jnp.asarray(a))

    d_t = torch.from_numpy(depth).requires_grad_(True)
    a_t = torch.from_numpy(a).requires_grad_(True)
    v = pcf_visibility(d_t, torch.from_numpy(x), torch.from_numpy(y), a_t, pcfg)
    (v * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(v.detach().numpy(), jv, rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(jd)).max() > 1.0
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a_t.grad.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
