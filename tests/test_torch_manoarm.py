"""harp_tpu_torch's MANOARM (the SMPL+H right-arm model) vs harp_tpu's, on
CPU: the synthetic model equal array for array; manoarm_forward (axis-angle
and PCA hand poses, with body and left-hand poses) at B = 2, vertices and
joints atol 1e-6 m (outputs are in metres), and its gradient through the
repeated gathers (joint 41 at slots 5 and 15; the unused extra joints on
one vertex) rtol 1e-5 of the largest entry; load_manoarm on SMPL+H files
the test writes (npz, and a pickle of chumpy-style arrays) equal to
harp_tpu's. harp_tpu's forward and gradient are read from
tests/golden/harp_tpu_manoarm.npz.
"""

import dataclasses
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.models import manoarm as jmanoarm
from harp_tpu_torch.models import manoarm

import _harp_goldens as goldens

# The parity tolerances of the docstring, which the golden's regenerator reads
# too.
OUT_ATOL = 1e-6  # vertices and joints, in metres
GRAD_TOL = 1e-5  # of the gradient's largest entry


def _assert_same(ours, theirs):
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def _inputs(use_pca, seed=0, B=2):
    rng = np.random.RandomState(seed)
    hand = 6 if use_pca else 45
    return dict(betas=0.3 * rng.randn(B, 10), global_orient=0.2 * rng.randn(B, 3),
                transl=0.05 * rng.randn(B, 3), right_hand_pose=0.3 * rng.randn(B, hand),
                body_pose=0.1 * rng.randn(B, 63), left_hand_pose=0.2 * rng.randn(B, hand))


def _weights(model):
    """Weights of the vertices and joints in the loss whose gradient is held."""
    rng = np.random.RandomState(1)
    return (rng.randn(2, len(model.arm_vert_idx), 3).astype(np.float32),
            rng.randn(2, 22, 3).astype(np.float32))


def _harp_tpu_manoarm() -> dict:
    """harp_tpu's manoarm_forward on _inputs and the gradient of its
    weighted sum to betas and the right-hand pose, with axis-angle (`full`)
    and PCA (`pca`) hand poses: the golden harp_tpu_manoarm.npz."""
    out = {}
    for use_pca in (False, True):
        jm = jmanoarm.build_synthetic_manoarm(use_pca=use_pca)
        kw = {k: jnp.asarray(v.astype(np.float32)) for k, v in _inputs(use_pca).items()}
        wv, wj = _weights(jm)

        def jloss(betas, pose):
            v, j = jmanoarm.manoarm_forward(jm, **dict(kw, betas=betas, right_hand_pose=pose))
            return (v * wv).sum() + (j * wj).sum()

        jv, jj = jmanoarm.manoarm_forward(jm, **kw)
        jg = jax.grad(jloss, argnums=(0, 1))(kw["betas"], kw["right_hand_pose"])
        out["pca" if use_pca else "full"] = {"verts": jv, "joints": jj, "grad_betas": jg[0],
                                              "grad_right_hand_pose": jg[1]}
    return goldens.pack(**out)


@pytest.mark.slow
def test_harp_tpu_golden_of_manoarm_is_current():
    def tolerance(k, want):  # test_manoarm_forward_and_gradient_match_harp_tpu
        if ".grad_" in k:
            return GRAD_TOL * np.abs(want).max()
        return OUT_ATOL

    goldens.assert_current("harp_tpu_manoarm", _harp_tpu_manoarm(), tolerance)


@pytest.mark.parametrize("use_pca", [False, True])
def test_manoarm_forward_and_gradient_match_harp_tpu(use_pca):
    jm = jmanoarm.build_synthetic_manoarm(use_pca=use_pca)
    m = manoarm.build_synthetic_manoarm(use_pca=use_pca)
    _assert_same(m, jm)
    kw = {k: v.astype(np.float32) for k, v in _inputs(use_pca).items()}
    wv, wj = _weights(m)
    theirs = goldens.part(goldens.load("harp_tpu_manoarm"), "pca" if use_pca else "full")
    jv, jj = theirs["verts"], theirs["joints"]
    jg = (theirs["grad_betas"], theirs["grad_right_hand_pose"])
    t = {k: torch.from_numpy(x).requires_grad_(k in ("betas", "right_hand_pose"))
         for k, x in kw.items()}
    v, j = manoarm.manoarm_forward(m, **t)
    assert v.shape == jv.shape and j.shape == jj.shape == (2, 22, 3)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(j.detach().numpy(), np.asarray(jj), rtol=0, atol=OUT_ATOL)
    # The reference's verbatim repeat: slot 15 is joint 41, as slot 5.
    np.testing.assert_array_equal(j[:, 15].detach().numpy(), j[:, 5].detach().numpy())
    ((v * torch.from_numpy(wv)).sum() + (j * torch.from_numpy(wj)).sum()).backward()
    for name, want in zip(("betas", "right_hand_pose"), jg):
        want = np.asarray(want)
        np.testing.assert_allclose(t[name].grad.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max(), err_msg=name)


class _ChumpyLike:
    pass


@pytest.mark.parametrize("fmt", ["npz", "pkl"])
def test_load_manoarm_matches_harp_tpu(tmp_path, fmt):
    m = jmanoarm.build_synthetic_manoarm()
    rng = np.random.RandomState(2)
    data = dict(v_template=m.v_template, shapedirs=rng.randn(m.num_verts, 3, 16),
                posedirs=m.posedirs.reshape(-1, m.posedirs.shape[-1]).T,
                J_regressor=m.J_regressor, weights=m.weights,
                hands_meanl=0.1 * np.ones(45), hands_meanr=-0.1 * np.ones(45),
                hands_componentsl=rng.randn(45, 45), hands_componentsr=rng.randn(45, 45))
    if fmt == "npz":
        path = str(tmp_path / "SMPLH_MALE.npz")
        np.savez(path, **data)
    else:
        path = str(tmp_path / "SMPLH_MALE.pkl")
        fake = types.ModuleType("chumpy.ch")
        fake.Ch = _ChumpyLike
        _ChumpyLike.__module__, _ChumpyLike.__qualname__ = "chumpy.ch", "Ch"
        sys.modules["chumpy"], sys.modules["chumpy.ch"] = types.ModuleType("chumpy"), fake
        try:
            obj = _ChumpyLike()
            obj.x = data["v_template"].astype(np.float64)
            with open(path, "wb") as f:
                pickle.dump(dict(data, v_template=obj), f, protocol=2)
        finally:
            del sys.modules["chumpy"], sys.modules["chumpy.ch"]
            _ChumpyLike.__module__, _ChumpyLike.__qualname__ = __name__, "_ChumpyLike"
    np.save(tmp_path / "arm_vert.npy", m.arm_vert_idx)
    np.save(tmp_path / "arm_face.npy", m.arm_faces)
    args = (path, str(tmp_path / "arm_vert.npy"), str(tmp_path / "arm_face.npy"))
    for kw in (dict(), dict(use_pca=True, num_pca_comps=12, flat_hand_mean=True)):
        _assert_same(manoarm.load_manoarm(*args, **kw), jmanoarm.load_manoarm(*args, **kw))
