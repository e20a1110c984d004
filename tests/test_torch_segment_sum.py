"""The fixed-order segment sum (harp_tpu_torch/ops/segment.py) on the CPU,
where it runs its plain version, and the gathers routed through it against
their harp_tpu counterparts.

Tolerances: the plain segment sum adds in entry order in float32, as
numpy.add.at does, so the two are equal. gather_rows / sum_rows gradients
equal torch's own indexing autograd exactly (the same sums in the same
order on the CPU). Texture sampling and vertex normals against harp_tpu
(JAX on the CPU): rtol 1e-5 / atol 1e-6, float32 arithmetic in other
orders; the uv gradient at uv exactly 0 and 1 (jnp.clip's tie, 1/2) to the
same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.assets import build_synthetic_assets as jbuild
from harp_tpu.ops.mesh import vertex_normals as jvertex_normals
from harp_tpu.render.shading import sample_texture_bilinear as jsample
from harp_tpu_torch.ops.mesh import build_topology, vertex_normals
from harp_tpu_torch.ops.segment import (
    SegmentOrder, TableOrder, gather_rows, segment_sum, sum_rows,
)
from harp_tpu_torch.render.shading import sample_texture_bilinear


def _entries(seed, R=50, M=2000, C=5, run=0):
    """Unsorted keys leaving some rows empty, plus `run` entries on one row."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, R, M)
    key = key[(key % 7) != 3]  # rows 3, 10, 17, ... stay empty
    if run:
        key = np.concatenate([key[: len(key) // 2], np.full(run, 11), key[len(key) // 2:]])
    vals = rng.normal(size=(len(key), C)).astype(np.float32)
    return key, vals, R


@pytest.mark.parametrize("run", [0, 10_000])
def test_segment_sum_plain_matches_numpy_add_at(run):
    key, vals, R = _entries(0, run=run)
    want = np.zeros((R, vals.shape[1]), np.float32)
    np.add.at(want, key, vals)
    got = segment_sum(torch.from_numpy(vals), SegmentOrder(torch.from_numpy(key), R))
    assert (want[3::7] == 0).all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_order_is_a_stable_sort():
    key, _, R = _entries(1, run=300)
    skey, perm = SegmentOrder(torch.from_numpy(key), R).sorted()
    assert skey.dtype == perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.argsort(key, kind="stable"))
    np.testing.assert_array_equal(skey.numpy(), np.sort(key))


def test_segment_sum_rejects_bad_input():
    order = SegmentOrder(torch.arange(6) % 3, 3)
    with pytest.raises(ValueError, match="values must be"):
        segment_sum(torch.zeros(5, 2), order)
    with pytest.raises(ValueError, match="values must be"):
        segment_sum(torch.zeros(6, 2, dtype=torch.int32), order)
    with pytest.raises(ValueError, match="table must be"):
        gather_rows(torch.zeros(4, 2), order)


def test_static_order_equals_a_fresh_sort_of_the_batch():
    """A constant table's order (the face corners, sorted once on the
    topology) with a batch laid on top equals a fresh sort of the batch."""
    faces = jbuild(uv_size=16, density="light").sub_topology.faces
    V = int(faces.max()) + 1
    topo = build_topology(faces, V)
    assert topo.corners is topo.corners  # made once per topology
    order = topo.corners.batched(3, "cpu")
    assert order._sorted is not None  # no sort of its own
    fresh = SegmentOrder(order.key, 3 * V)
    np.testing.assert_array_equal(order.key.numpy(), (np.arange(3)[:, None] * V
                                                      + faces.reshape(-1)).reshape(-1))
    for a, b in zip(order.sorted(), fresh.sorted()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_gather_rows_and_sum_rows_gradients_match_indexing_autograd():
    rng = np.random.default_rng(2)
    R, C = 40, 6
    idx = torch.from_numpy(rng.integers(0, R, (3, 70)))
    idx[1, :30] = 0  # a long run, as the background pixels make
    table = torch.from_numpy(rng.normal(size=(R, C)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3 * 70, C)).astype(np.float32))

    t1 = table.clone().requires_grad_(True)
    rows = gather_rows(t1, SegmentOrder(idx, R))
    (rows * w).sum().backward()
    t2 = table.clone().requires_grad_(True)
    want = t2[idx.reshape(-1)]
    (want * w).sum().backward()
    np.testing.assert_array_equal(rows.detach().numpy(), want.detach().numpy())
    np.testing.assert_array_equal(t1.grad.numpy(), t2.grad.numpy())

    v1 = w.clone().requires_grad_(True)
    s = sum_rows(v1, SegmentOrder(idx, R))
    (s * table).sum().backward()
    v2 = w.clone().requires_grad_(True)
    s2 = torch.zeros(R, C).index_add(0, idx.reshape(-1), v2)
    (s2 * table).sum().backward()
    np.testing.assert_array_equal(s.detach().numpy(), s2.detach().numpy())
    np.testing.assert_array_equal(v1.grad.numpy(), v2.grad.numpy())


@pytest.mark.parametrize("C", [3, 6])
def test_corner_stack_sampling_matches_harp_tpu(C):
    """Values and gradients (texture and uv), on uv inside, clamped beyond
    both borders and exactly on 0 and 1."""
    rng = np.random.default_rng(3 + C)
    H, W = 12, 16
    tex = rng.uniform(0, 1, (H, W, C)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, (2, 40, 2)).astype(np.float32)
    ties = np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0],
                     [0.0, 0.5], [1.0, 0.3], [0.4, 0.0], [0.6, 1.0]], np.float32)
    uv[0, :8] = ties
    g = rng.normal(size=(2, 40, C)).astype(np.float32)

    def jloss(t, u):
        return (jsample(t, u) * g).sum()

    jval = np.asarray(jsample(jnp.asarray(tex), jnp.asarray(uv)))
    jt, ju = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(tex), jnp.asarray(uv))
    t = torch.from_numpy(tex).requires_grad_(True)
    u = torch.from_numpy(uv).requires_grad_(True)
    val = sample_texture_bilinear(t, u)
    (val * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(val.detach().numpy(), jval, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u.grad.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    # u = 0 and v = 1 put x or y exactly on the lower bound, where the uv
    # gradient is half the one-sided one (jnp.clip's tie), not whole
    # (torch.clamp's). On the upper bound both corners are the edge texel
    # and the gradient is 0 either way.
    ju_ties = np.asarray(ju)[0, :8]
    lower = np.stack([ties[:, 0] == 0, ties[:, 1] == 1], -1)
    assert (np.abs(ju_ties[lower]) > 0).all()
    np.testing.assert_allclose(u.grad.numpy()[0, :8], ju_ties, rtol=1e-5, atol=1e-6)


def test_vertex_normals_match_harp_tpu():
    jassets = jbuild(uv_size=16, density="light")
    faces = jassets.sub_topology.faces
    V = jassets.sub_topology.num_verts
    rng = np.random.default_rng(4)
    verts = (rng.normal(size=(2, V, 3)) * 0.05).astype(np.float32)
    want = np.asarray(jvertex_normals(jnp.asarray(verts), faces))
    v = torch.from_numpy(verts).requires_grad_(True)
    got = vertex_normals(v, build_topology(faces, V))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    g = rng.normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda x: (jvertex_normals(x, faces) * g).sum())(jnp.asarray(verts))
    (got * torch.from_numpy(g)).sum().backward()
    scale = np.abs(np.asarray(jg)).max()
    assert np.abs(v.grad.numpy() - np.asarray(jg)).max() <= 1e-5 * scale
