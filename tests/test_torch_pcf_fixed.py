"""K3's fixed-point mirror (pcf_scatter_fixed_plain: the kernel's exact
function in int64 tensor code) against a float64 scatter of the same
inputs, against harp_tpu's Pallas scatter in interpret mode, and on the
cases that test its scale rule.

Tolerances. Against float64, per texel: each of its T taps is rounded once
by at most 2^-(s+1), and the total is rounded to double and then to float32:
|got - exact| <= T 2^-(s+1) + (|exact| + T 2^-(s+1)) (2^-24 + 2^-53) + 2^-150.
Against Pallas interpret: rtol 1e-6 / atol 1e-5, the tests/test_torch_pcf.py
bound for float32 sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.render.pallas.pcf_grad_kernel import pallas_pcf_scatter
from harp_tpu_torch.render.kernels.pcf_grad_kernel import (
    fixed_point_shift, pcf_scatter_fixed_plain, pcf_scatter_plain,
)

FLAGSHIP_N = 75_776  # camera pixels a frame at 448^2 (296 active tiles x 256)


def _inputs(seed, B=2, Hl=28, N=300):
    rng = np.random.default_rng(seed)
    yc = rng.integers(1, Hl + 3, size=(B, N)).astype(np.int32)
    xc = rng.integers(1, Hl + 3, size=(B, N)).astype(np.int32)
    upd = rng.normal(size=(B, N, 9)).astype(np.float32)
    return yc, xc, upd, Hl


def _exact(yc, xc, upd, hl):
    """float64 scatter, and the count of taps on each texel."""
    B, N = yc.shape
    hp4 = hl + 4
    out = np.zeros((B, hp4 * hp4))
    taps = np.zeros((B, hp4 * hp4))
    for b in range(B):
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                idx = (yc[b].astype(np.int64) + di) * hp4 + xc[b] + dj
                np.add.at(out[b], idx, upd[b, :, 3 * (di + 1) + (dj + 1)].astype(np.float64))
                np.add.at(taps[b], idx, 1.0)
    return out.reshape(B, hp4, hp4), taps.reshape(B, hp4, hp4)


def _fixed(yc, xc, upd, hl):
    return pcf_scatter_fixed_plain(*(torch.from_numpy(a) for a in (yc, xc, upd)), hl).numpy()


def _assert_within_bound(got, yc, xc, upd, hl):
    exact, taps = _exact(yc, xc, upd, hl)
    m = float(np.abs(upd[np.isfinite(upd)]).max(initial=0.0))
    q = taps * 2.0 ** -(fixed_point_shift(m, yc.shape[1]) + 1)
    bound = q + (np.abs(exact) + q) * (2.0 ** -24 + 2.0 ** -53) + 2.0 ** -150
    assert (np.abs(got.astype(np.float64) - exact) <= bound).all()


def test_fixed_plain_matches_float64_and_pallas_interpret():
    yc, xc, upd, Hl = _inputs(7)  # N = 300, not a multiple of 256
    yc[0, :4] = [1, Hl + 2, 1, Hl + 2]
    xc[0, :4] = [1, 1, Hl + 2, Hl + 2]
    upd[1, :50] = 0.0
    got = _fixed(yc, xc, upd, Hl)
    _assert_within_bound(got, yc, xc, upd, Hl)
    want = np.asarray(pallas_pcf_scatter(jnp.asarray(yc), jnp.asarray(xc),
                                         jnp.asarray(upd), Hl, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", ["zeros", "one_huge", "pile_up", "denormals", "ties"])
def test_fixed_plain_scale_rule(case):
    yc, xc, upd, Hl = _inputs(11)
    if case == "zeros":
        upd[:] = 0.0
    elif case == "one_huge":  # every other update falls below the rounding step
        upd[0, 17, 4] = 1e30 * np.abs(upd).max()
    elif case == "pile_up":  # 10^4 background pixels on one clamped centre
        yc, xc = (np.concatenate([a, np.ones((2, 10_000), np.int32)], 1) for a in (yc, xc))
        upd = np.concatenate([upd, _inputs(12, N=10_000)[2]], 1)
    elif case == "denormals":
        upd = (upd * 1e-40).astype(np.float32)
        assert (np.abs(upd[upd != 0]) < np.finfo(np.float32).tiny).all()
    else:  # max 2^10 and 9N <= 2^12: s = 39, so odd * 2^-40 rounds from k + 1/2
        odd = (np.arange(upd.size) % 401 - 200) * 2 + 1
        upd = (odd * 2.0 ** -40).astype(np.float32).reshape(upd.shape)
        upd[0, 0, 0] = 1024.0
        assert fixed_point_shift(1024.0, upd.shape[1]) == 39
    got = _fixed(yc, xc, upd, Hl)
    _assert_within_bound(got, yc, xc, upd, Hl)
    if case == "zeros":
        assert not got.any()
    if case == "pile_up":
        assert np.abs(got[:, 0:3, 0:3]).max() > 10.0


def test_fixed_plain_non_finite_updates_reach_their_texels():
    """Texels reached by +inf, -inf, NaN or both infinities are what the
    float32 scatter makes them; the finite rest stays within the bound."""
    yc, xc, upd, Hl = _inputs(13)
    yc[0, :4], xc[0, :4] = [3, 10, 20, 20], [3, 10, 20, 20]  # two pixels share a centre
    upd[0, 0, 4], upd[0, 1, 0], upd[0, 2, 8], upd[0, 3, 8] = np.inf, -np.inf, np.nan, np.inf
    upd[1, 5, :] = np.inf
    upd[1, 6, 2] = -np.inf
    got = _fixed(yc, xc, upd, Hl)
    plain = pcf_scatter_plain(*(torch.from_numpy(a) for a in (yc, xc, upd)), Hl).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(plain))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(plain))
    assert np.isnan(got).sum() >= 1 and np.isinf(got).sum() >= 10
    finite = np.isfinite(got)
    clean = np.where(np.isfinite(upd), upd, 0.0).astype(np.float32)
    exact, taps = _exact(yc, xc, clean, Hl)
    q = taps * 2.0 ** -(fixed_point_shift(float(np.abs(clean).max()), yc.shape[1]) + 1)
    bound = q + (np.abs(exact) + q) * (2.0 ** -24 + 2.0 ** -53) + 2.0 ** -150
    assert (np.abs(got - exact)[finite] <= bound[finite]).all()


def test_fixed_point_cannot_overflow_at_the_flagship_size():
    """9N |q| <= 2^62 for every float32 magnitude at the flagship's N, and a
    pile-up of all N pixels of a frame on one centre, every update at the
    largest |q| the scale allows, sums exactly."""
    n = FLAGSHIP_N
    k = (9 * n - 1).bit_length()
    assert 2 ** (k - 1) < 9 * n <= 2 ** k
    for e in range(-148, 129):
        ms = [np.ldexp(np.float32(1.0), e - 1)]  # the least magnitude of exponent e
        if e > -125:  # and the largest, where it is a normal number
            ms.append(np.ldexp(np.float32(1 - 2.0 ** -24), e))
        for m in ms:
            assert np.frexp(m)[1] == e
            s = fixed_point_shift(float(m), n)
            q_max = round(float(m) * 2.0 ** s)
            assert 9 * n * q_max <= 9 * n * 2 ** (e + s) <= 2 ** 62
    m = np.float32(1 - 2.0 ** -24) * np.float32(4.0)  # just below 2^2
    upd = np.full((1, n, 9), -m, np.float32)
    centre = np.full((1, n), 5, np.int32)
    got = _fixed(centre, centre, upd, 28)
    s = fixed_point_shift(float(m), n)
    q = round(float(m) * 2.0 ** s)
    assert q == float(m) * 2.0 ** s and q <= 2 ** (62 - k)
    want = np.float32(float(-n * q) * 2.0 ** -s)
    assert got[0, 5, 5] == want and got[0, 4, 4] == want
    assert got[0, 5, 5] == np.float32(-n * np.float64(m))
