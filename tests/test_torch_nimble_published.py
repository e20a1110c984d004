"""NIMBLE at its published widths: harp_tpu_torch/models/nimble.py against
harp_tpu's model and against the benchmark's plain reference model
(benchmark/reference/models/nimble.py), on the CPU:

- the forward (skin vertices, the 25 skeleton joints, the MANO surface and
  its 21 protocol joints) and its gradients to pose, shape, rot and trans,
  on a small model of NIMBLE's structure with seeded random weights, held
  to the reference and to harp_tpu's nimble_forward / nimble_to_mano /
  mano_protocol_joints;
- the reference's published stand-in (the arrays the cell nimble.fit_stage2
  fits): its structure (a 25-joint tree, orthonormal pose directions, 5990
  skin vertices on closed surfaces, convex regression rows), and the
  program's model and assets built from it as the cell builds them, posed
  as the reference poses them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.inputs import program_avatar
from benchmark.reference.models import nimble as ref
from harp_tpu.models import nimble as jnimble
from harp_tpu_torch.models import nimble
from harp_tpu_torch.models.lbs import kinematic_levels
from harp_tpu_torch.models.mano import JOINT_REORDER

PARENTS = ref.nimble_skeleton(*ref._hand_skeleton())[1]


def small_model(seed: int = 0, V: int = 200, Vm: int = 90) -> dict:
    """NIMBLE's structure at V skin vertices with seeded random weights:
    the published 25-joint tree, a 30 x 72 pose basis, 20 shape
    directions, a MANO surface of Vm vertices each regressed from 3 skin
    vertices (the table repeats skin vertices)."""
    rng = np.random.RandomState(seed)
    K = PARENTS.shape[0]
    weights = rng.uniform(0, 1, (V, K)) ** 4
    jreg = rng.uniform(0, 1, (K, V)) * (rng.uniform(0, 1, (K, V)) < 0.05)
    jreg[:, 0] += 1e-3
    vreg_w = rng.uniform(0.1, 1, (Vm, 3))
    mreg = rng.uniform(0, 1, (16, Vm)) * (rng.uniform(0, 1, (16, Vm)) < 0.1)
    mreg[:, 0] += 1e-3
    q, _ = np.linalg.qr(rng.randn(72, 30))
    f32 = np.float32
    return dict(
        v_template=(0.05 * rng.randn(V, 3)).astype(f32),
        shapedirs=(0.003 * rng.randn(V, 3, 20)).astype(f32),
        weights=(weights / weights.sum(1, keepdims=True)).astype(f32),
        faces=rng.randint(0, V, (300, 3)).astype(np.int32),
        J_regressor=(jreg / jreg.sum(1, keepdims=True)).astype(f32),
        parents=PARENTS,
        pose_basis=q.T.astype(f32),
        pose_mean=(q @ (0.05 * rng.randn(30))).astype(f32),
        mano_vreg_idx=rng.randint(0, V, (Vm, 3)).astype(np.int32),
        mano_vreg_w=(vreg_w / vreg_w.sum(1, keepdims=True)).astype(f32),
        mano_J_regressor=(mreg / mreg.sum(1, keepdims=True)).astype(f32),
        mano_tips_idx=rng.choice(Vm, 5, replace=False),
        mano_joint_reorder=JOINT_REORDER,
    )


def _inputs(seed: int, B: int = 3):
    rng = np.random.RandomState(seed + 1)
    return {"pose": torch.tensor(0.4 * rng.randn(B, 30), dtype=torch.float32),
            "rot": torch.tensor(0.3 * rng.randn(B, 3), dtype=torch.float32),
            "trans": torch.tensor(0.05 * rng.randn(B, 3), dtype=torch.float32),
            "shape": torch.tensor(0.5 * rng.randn(20), dtype=torch.float32)}


def _program(model, p):
    fids = torch.arange(p["pose"].shape[0])
    shape = p["shape"][None].expand(fids.shape[0], -1)
    v, j = nimble.nimble_forward(model, torch.cat([p["rot"], p["pose"]], 1), shape, p["trans"])
    m = nimble.nimble_to_mano(model, v)
    return v, j, m, nimble.mano_protocol_joints(model, m)


def _reference(model, p):
    fids = torch.arange(p["pose"].shape[0])
    shape = p["shape"][None].expand(fids.shape[0], -1)
    v, j = ref.nimble_forward(model, torch.cat([p["rot"], p["pose"]], 1), shape, p["trans"])
    m = ref.nimble_to_mano(model, v)
    vp, jp = model.pose_frames(p, fids)
    assert torch.equal(vp, v)
    return v, j, m, jp


def _weights(out):
    """Fixed weights of each output entry: the scalar whose gradients are
    compared is the weighted sum of every output."""
    n = [int(np.prod(o.shape)) for o in out]
    return [w.reshape(o.shape) for w, o in zip(torch.linspace(-1, 1, sum(n)).split(n), out)]


def _program_side(model, seed):
    p = {k: v.clone().requires_grad_(True) for k, v in _inputs(seed).items()}
    out = _program(model, p)
    sum((o * w).sum() for o, w in zip(out, _weights(out))).backward()
    return [o.detach() for o in out], {k: v.grad for k, v in p.items()}


NAMES = ("verts", "joints", "mano_verts", "mano_joints")


@pytest.mark.parametrize("seed", [0, 7])
def test_the_program_follows_the_reference_model(seed):
    """Forward and gradients on a 200-vertex model. Both sides run the same
    float32 operations in the same order (the reference is a plain copy of
    the program's model and of its LBS, rotation and gather code), so the
    tolerances are float32 rounding only: 1e-4 mm on vertices and joints of
    ~100 mm (a few ulps); gradients within 1e-5 of their largest entry."""
    arrays = small_model(seed)
    out, grads = _program_side(nimble.NimbleModel(**arrays), seed)
    p = {k: v.clone().requires_grad_(True) for k, v in _inputs(seed).items()}
    rout = _reference(ref.NimbleModel(**arrays), p)
    sum((o * w).sum() for o, w in zip(rout, _weights(rout))).backward()
    for name, a, b in zip(NAMES, out, rout):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=1e-4, msg=name)
    assert out[1].shape == (3, 25, 3) and out[3].shape == (3, 21, 3)
    for k, h in p.items():
        torch.testing.assert_close(grads[k], h.grad, rtol=0, atol=1e-5 * float(h.grad.abs().max()),
                                   msg=k)


@pytest.mark.parametrize("seed", [0, 7])
def test_the_program_follows_harp_tpu_at_nimbles_widths(seed):
    """The same 200-vertex model of the published structure (25 joints, 6
    levels, a 30 x 72 basis, 20 shape directions, a 3-vertex regression)
    through harp_tpu's forward and jax.grad. XLA fuses and reorders the
    float32 sums (the 25-joint regression, the 72-wide basis product, the
    6-level chain of 3 x 3 products), so the tolerances are
    test_torch_zoo.py's for NIMBLE: 1e-3 mm on vertices and joints of ~100
    mm, gradients within 1e-5 of their largest entry (seen: 3e-5 mm and
    5e-7 of the largest entry)."""
    arrays = small_model(seed)
    out, grads = _program_side(nimble.NimbleModel(**arrays), seed)
    jm = jnimble.NimbleModel(**arrays)
    w = [jnp.asarray(x.numpy()) for x in _weights(out)]

    def forward(pose, rot, trans, shape):
        B = pose.shape[0]
        v, j = jnimble.nimble_forward(jm, jnp.concatenate([rot, pose], 1),
                                      jnp.broadcast_to(shape[None], (B, shape.shape[0])), trans)
        m = jnimble.nimble_to_mano(jm, v)
        return v, j, m, jnimble.mano_protocol_joints(jm, m)

    def scalar(*args):
        return sum((o * wi).sum() for o, wi in zip(forward(*args), w))

    x = {k: jnp.asarray(v.numpy()) for k, v in _inputs(seed).items()}
    args = (x["pose"], x["rot"], x["trans"], x["shape"])
    jout = forward(*args)
    jgrads = dict(zip(("pose", "rot", "trans", "shape"),
                      jax.grad(scalar, argnums=(0, 1, 2, 3))(*args)))
    for name, a, b in zip(NAMES, out, jout):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-3, err_msg=name)
    for k, g in jgrads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max(),
                                   err_msg=k)


@pytest.fixture(scope="module")
def published():
    return {seed: ref.build_published_nimble(seed) for seed in (0, 2**31 - 9)}


@pytest.mark.parametrize("seed", [0, 2**31 - 9])
def test_the_published_stand_in_has_nimbles_structure(published, seed):
    m = published[seed]
    K, V = m.num_joints, m.num_verts
    # 25 joints forming one tree, parents first, 6 levels (wrist, carpal,
    # CMC, MCP, PIP, DIP).
    assert K == 25 and m.parents[0] == -1
    assert all(0 <= m.parents[j] < j for j in range(1, K))
    assert [len(lvl) for lvl in kinematic_levels(m.parents)] == [1, 5, 5, 5, 5, 4]
    # The pose PCA: 30 orthonormal rows over the 24 non-root joints' 72
    # axis-angle dofs, the mean in their span.
    assert m.pose_basis.shape == (30, 72) and m.ncomps == 30
    np.testing.assert_allclose(m.pose_basis @ m.pose_basis.T, np.eye(30), atol=1e-5)
    mean = m.pose_mean.astype(np.float64)
    np.testing.assert_allclose(m.pose_basis.T @ (m.pose_basis @ mean), mean, atol=1e-6)
    # The skin: NIMBLE's 5990 vertices, 6 closed surfaces (every edge in two
    # faces), so 2V - 24 faces; 20 shape directions; convex skinning rows.
    assert V == 5990 and m.faces.shape == (2 * V - 24, 3)
    edges = np.sort(m.faces[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    _, count = np.unique(edges, axis=0, return_counts=True)
    assert (count == 2).all()
    assert m.shapedirs.shape == (V, 3, 20) and m.nshape == 20
    assert m.weights.shape == (V, K) and (m.weights >= 0).all()
    np.testing.assert_allclose(m.weights.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(m.J_regressor.sum(1), 1.0, atol=1e-5)
    # The MANO surface: 781 vertices, each a convex blend of 3 skin vertices.
    assert m.mano_vreg_idx.shape == (781, 3) and m.mano_J_regressor.shape == (16, 781)
    assert (m.mano_vreg_w > 0).all()
    np.testing.assert_allclose(m.mano_vreg_w.sum(1), 1.0, atol=1e-6)


def test_the_program_poses_the_published_stand_in_as_the_reference():
    """The cell's own path (families/nimble.py): the program's AvatarAssets
    from the reference's, unsubdivided, and its model at 5990 vertices
    posed as the reference poses it: the same float32 operations on both
    sides, 1e-4 mm as above."""
    ra = ref.build_published_assets(0, 64)
    assets = program_avatar(ra, nimble.NimbleModel)
    assert assets.subdivision is None and assets.num_render_verts == 5990
    assert assets.render_faces.shape == (11956, 3) and assets.uv_mask.shape == (64, 64)
    p = _inputs(0, B=2)
    out = _program(assets.model, p)
    with torch.no_grad():
        rout = _reference(ra.model, p)
    for name, a, b in zip(NAMES, out, rout):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=1e-4, msg=name)
