"""harp_tpu_torch's VGG perceptual loss vs harp_tpu's, on CPU.

Two 32^2 frames made from a numpy seed, masked to a rectangle (the raw-image
slice then holds exact ties at 0, where both packages take jnp.abs's +1).
The JAX side runs each function once, unchunked; every chunking and remat
variant of the port is held against that one value, since chunking and
remat are exact rewrites of the same sum.

Tolerances. float32: loss rtol 1e-4; gradient with respect to pred within
1e-4 of its largest entry (convolutions summed in other orders by oneDNN
and XLA:CPU). bfloat16: loss rtol 1e-3; gradient relative L2 error 0.15
and largest-entry error 0.15. The two CPU backends round the bf16
convolutions at other places, so features differ by up to ~0.3% of their
largest entry at relu4_3, and the gradient, which takes the sign of
(pred - gt) per feature, flips where a difference is within that rounding
(measured: loss 1.1e-5 / 5.7e-5 rel, gradient 6.0% L2, 5.7% largest-entry,
0.9% of entries with another sign).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.losses import perceptual as J
from harp_tpu_torch.losses import perceptual as P

B, H = 2, 32


def _images():
    rng = np.random.RandomState(0)
    pred = rng.uniform(0, 1, (B, H, H, 3)).astype(np.float32)
    true = rng.uniform(0, 1, (B, H, H, 3)).astype(np.float32)
    mask = np.zeros((B, H, H, 1), np.float32)
    mask[:, 8:24, 6:26] = 1
    return pred * mask, true * mask


@pytest.fixture(scope="module")
def jax_refs():
    """harp_tpu's loss and gradient w.r.t. pred, per (function, dtype)."""
    pred, true = _images()
    refs = {}
    for dt in ("float32", "bfloat16"):
        jv = J.Vgg16Features.create(compute_dtype=dt)
        gt = J.precompute_slices(jv, jnp.asarray(true))
        fns = {"l1": lambda p: J.vgg_feature_l1(jv, p, jnp.asarray(true)),
               "cached": lambda p: J.vgg_feature_l1_cached(jv, p, gt, jnp.arange(B))}
        for name, fn in fns.items():
            loss, grad = jax.jit(jax.value_and_grad(fn))(jnp.asarray(pred))
            refs[name, dt] = (float(loss), np.asarray(grad))
    return refs


def _port_loss(name, dt, chunk, remat):
    pred, true = _images()
    vgg = P.Vgg16Features.create(compute_dtype=dt, device="cpu")
    p = torch.from_numpy(pred).requires_grad_(True)
    if name == "l1":
        loss = P.vgg_feature_l1(vgg, p, torch.from_numpy(true), chunk=chunk, remat=remat)
    else:
        gt = P.precompute_slices(vgg, torch.from_numpy(true), chunk=chunk)
        loss = P.vgg_feature_l1_cached(vgg, p, gt, torch.arange(B), chunk=chunk, remat=remat)
    loss.backward()
    return float(loss.detach()), p.grad.numpy()


def test_init_weights_equal_harp_tpu():
    ours, theirs = P._init_weights(0), J._init_weights(0)
    assert len(ours) == len(theirs) == 10
    for (w, b), (jw, jb) in zip(ours, theirs):
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(b, jb)
    vgg = P.Vgg16Features.create(device="cpu")
    assert vgg.source == "random" and len(vgg.convs) == P.N_CONVS == 10
    for conv, (w, b) in zip(vgg.convs, theirs):
        np.testing.assert_array_equal(conv.weight.detach().numpy(),
                                      w.astype(np.float32).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(conv.bias.detach().numpy(), b)
        assert not conv.weight.requires_grad


def test_load_vgg16_npz_reads_the_first_ten_convs(tmp_path):
    rng = np.random.RandomState(1)
    arrays, cin = {}, 3
    # All 13 convs of VGG16, as an exported torchvision model holds them.
    for i, cout in enumerate([c for c in J.VGG16_LAYOUT if c != "M"] + [512] * 3):
        arrays[f"w{i}"] = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.05
        arrays[f"b{i}"] = rng.randn(cout).astype(np.float32) * 0.01
        cin = cout
    path = str(tmp_path / "vgg16.npz")
    np.savez(path, **arrays)
    ours, theirs = P.load_vgg16_npz(path), J.load_vgg16_npz(path)
    assert len(ours) == len(theirs) == 10
    for (w, b), (jw, jb) in zip(ours, theirs):
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(b, jb)
    vgg = P.Vgg16Features.create(weights_path=path, device="cpu")
    assert vgg.source == "pretrained"
    pred, _ = _images()
    jv = J.Vgg16Features.create(weights_path=path)
    want = np.asarray(jv.slices(jnp.asarray(pred))[-1])
    got = vgg.slices(torch.from_numpy(pred))[-1].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("chunk", [None, 1])
def test_slices_and_precompute_match_harp_tpu(chunk):
    pred, _ = _images()
    jv = J.Vgg16Features.create()
    vgg = P.Vgg16Features.create(device="cpu")
    want = J.precompute_slices(jv, jnp.asarray(pred), chunk=chunk)
    got = P.precompute_slices(vgg, torch.from_numpy(pred), chunk=chunk)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()  # (N, h, w, C), as harp_tpu caches them
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(np.abs(w).max(), 1e-30))
    assert P._feature_count_per_frame(vgg, H, H) == J._feature_count_per_frame(jv, H, H)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("chunk", [None, 1])
@pytest.mark.parametrize("name", ["l1", "cached"])
def test_vgg_loss_and_gradient_match_harp_tpu_f32(jax_refs, name, chunk, remat):
    want_loss, want_grad = jax_refs[name, "float32"]
    loss, grad = _port_loss(name, "float32", chunk, remat)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    assert np.abs(grad - want_grad).max() <= 1e-4 * np.abs(want_grad).max()


@pytest.mark.parametrize("chunk,remat", [(None, False), (1, True)])
@pytest.mark.parametrize("name", ["l1", "cached"])
def test_vgg_loss_and_gradient_match_harp_tpu_bf16(jax_refs, name, chunk, remat):
    want_loss, want_grad = jax_refs[name, "bfloat16"]
    loss, grad = _port_loss(name, "bfloat16", chunk, remat)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-3)
    assert np.linalg.norm(grad - want_grad) <= 0.15 * np.linalg.norm(want_grad)
    assert np.abs(grad - want_grad).max() <= 0.15 * np.abs(want_grad).max()


def test_bf16_cache_is_stored_in_bf16_and_f32_in_f32():
    pred, _ = _images()
    for dt, torch_dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        vgg = P.Vgg16Features.create(compute_dtype=dt, device="cpu")
        gt = P.precompute_slices(vgg, torch.from_numpy(pred))
        assert all(s.dtype == torch_dt for s in gt)
