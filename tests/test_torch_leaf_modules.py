"""harp_tpu_torch's leaf modules against harp_tpu, on CPU: the dense
losses, the temporal smoothness losses (also against the reference's
executed goldens, tests/golden/losses_golden.npz), Taubin smoothing,
project_to_rotation, the U-Net with harp_tpu's weights carried over,
opt_utils and fh_utils.

Tolerances: dense losses and their gradients rtol 1e-6; smoothness losses
the golden test's own (value rtol 1e-4, gradients rtol 2e-4) against the
goldens and rtol 1e-5 against harp_tpu; Taubin and project_to_rotation
rtol 1e-5; the U-Net's output and input gradient rtol 1e-4 (float32
convolutions summed in other orders); opt_utils and fh_utils exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.assets import build_synthetic_assets as jbuild
from harp_tpu.losses import basic as JB
from harp_tpu.losses import smooth as JS
from harp_tpu.models.unet import init_unet, unet_forward
from harp_tpu.ops.mesh import taubin_smoothing as jtaubin
from harp_tpu.ops.rotations import project_to_rotation as jproject
from harp_tpu.utils import fh_utils as JFH
from harp_tpu.utils import opt_utils as JOPT
from harp_tpu_torch.convert import assets_from_numpy, unet_params_from_numpy
from harp_tpu_torch.losses import basic as B
from harp_tpu_torch.losses import smooth as S
from harp_tpu_torch.models.unet import UNet
from harp_tpu_torch.ops.mesh import taubin_smoothing
from harp_tpu_torch.ops.rotations import project_to_rotation
from harp_tpu_torch.utils import fh_utils as FH
from harp_tpu_torch.utils import opt_utils as OPT

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.tensor(np.asarray(x), requires_grad=True)


@pytest.mark.parametrize("name", ["l1", "silhouette", "photometric"])
def test_dense_losses_match_harp_tpu(name):
    rng = np.random.RandomState(0)
    a = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    b[0, 0, 0] = a[0, 0, 0]  # a tie: jnp.abs's derivative there is +1
    m = (rng.uniform(0, 1, (2, 8, 8)) > 0.3).astype(np.float32)
    if name == "l1":
        args = (a, b)
        jfn, fn = JB.l1_loss, B.l1_loss
    elif name == "silhouette":
        args = (a[..., 0], b[..., 0])
        jfn, fn = JB.silhouette_loss, B.silhouette_loss
    else:
        args = (a, b, m)
        jfn, fn = JB.photometric_loss, B.photometric_loss
    want, jgrad = jax.value_and_grad(jfn, argnums=(0, 1))(*map(jnp.asarray, args))
    targs = [_t(x) for x in args]
    got = fn(*targs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for t, g in zip(targs[:2], jgrad):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6, atol=1e-12)


def _smooth_case(g):
    """The golden test's stand-in layer: joints = reshape(x @ A^T), x =
    cat(rot, pose, shape, trans)."""
    A = np.asarray(g["smooth_A"], np.float32)
    params = {k: np.asarray(g["smooth_param_" + k], np.float32)
              for k in ("rot", "pose", "shape", "trans", "cam")}
    return A, np.asarray(g["smooth_fid"]), int(g["smooth_nframes"]), \
        float(g["smooth_focal"]), int(g["smooth_res"]), params


def _port_smooth(kind, A, fid, n, focal, res, params):
    p = {k: _t(v) for k, v in params.items()}
    At = torch.tensor(A)
    f = torch.tensor(fid)

    def joints_of(ff):
        x = torch.cat([p["rot"][ff], p["pose"][ff], p["shape"].expand(ff.shape[0], -1),
                       p["trans"][ff]], 1)
        return (x @ At.T).reshape(-1, 21, 3)

    fl, fr = S.neighbor_fids(f, n)
    if kind == "poses":
        loss = S.smooth_poses_loss(joints_of(f), joints_of(fl), joints_of(fr))
    else:
        loss = S.smooth_roots_loss(joints_of(f), joints_of(fl), joints_of(fr), p["cam"][f],
                                   p["cam"][fl], p["cam"][fr], focal, res)
    loss.backward()
    grads = {k: np.zeros(v.shape, np.float32) if v.grad is None else v.grad.numpy()
             for k, v in p.items()}
    return float(loss.detach()), grads


def _jax_smooth(kind, A, fid, n, focal, res, params):
    A, fid = jnp.asarray(A), jnp.asarray(fid)

    def loss(p):
        def joints_of(ff):
            x = jnp.concatenate([p["rot"][ff], p["pose"][ff],
                                 jnp.repeat(p["shape"], ff.shape[0], 0), p["trans"][ff]], 1)
            return (x @ A.T).reshape(-1, 21, 3)

        fl, fr = JS.neighbor_fids(fid, n)
        if kind == "poses":
            return JS.smooth_poses_loss(joints_of(fid), joints_of(fl), joints_of(fr))
        return JS.smooth_roots_loss(joints_of(fid), joints_of(fl), joints_of(fr),
                                    p["cam"][fid], p["cam"][fl], p["cam"][fr], focal, res)

    v, g = jax.value_and_grad(loss)({k: jnp.asarray(x) for k, x in params.items()})
    return float(v), {k: np.asarray(x) for k, x in g.items()}


@pytest.mark.parametrize("kind", ["poses", "roots"])
def test_smooth_losses_match_goldens_and_harp_tpu(kind):
    g = np.load(os.path.join(GOLDEN, "losses_golden.npz"))
    case = _smooth_case(g)
    val, grads = _port_smooth(kind, *case)
    np.testing.assert_allclose(val, g[f"smooth_{kind}_val"], rtol=1e-4)
    atol = 1e-5 if kind == "poses" else 1e-7
    for k, gr in grads.items():
        np.testing.assert_allclose(gr, g[f"smooth_{kind}_grad_{k}"], rtol=2e-4, atol=atol,
                                   err_msg=k)
    jval, jgrads = _jax_smooth(kind, *case)
    np.testing.assert_allclose(val, jval, rtol=1e-5)
    for k, gr in grads.items():
        scale = max(np.abs(jgrads[k]).max(), 1e-30)
        np.testing.assert_allclose(gr, jgrads[k], rtol=1e-5, atol=1e-6 * scale, err_msg=k)


def test_neighbor_fids_clamp_at_sequence_ends():
    left, right = S.neighbor_fids(torch.tensor([0, 3, 4, 5, 9]), 5)
    jl, jr = JS.neighbor_fids(jnp.asarray([0, 3, 4, 5, 9]), 5)
    np.testing.assert_array_equal(left.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(right.numpy(), np.asarray(jr))


def test_taubin_smoothing_matches_harp_tpu():
    jassets = jbuild(uv_size=8, density="light")
    topo = assets_from_numpy(jassets).coarse_topology
    rng = np.random.RandomState(1)
    v = (np.asarray(jassets.model.v_template)[None].repeat(2, 0)
         + rng.normal(0, 2e-3, (2, topo.num_verts, 3))).astype(np.float32)
    want = np.asarray(jtaubin(jnp.asarray(v), jassets.coarse_topology))
    got = taubin_smoothing(torch.tensor(v), topo).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert np.abs(got - v).max() > 1e-4  # it smoothed


def test_project_to_rotation_matches_harp_tpu():
    rng = np.random.RandomState(2)
    m = rng.normal(0, 1, (6, 3, 3)).astype(np.float32)
    assert (np.linalg.det(m) < 0).any()  # the determinant fix flips an axis there
    want = np.asarray(jproject(jnp.asarray(m)))
    got = project_to_rotation(torch.tensor(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(got), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1), np.eye(3)[None].repeat(6, 0),
                               atol=1e-5)


@pytest.mark.parametrize("latent_dim", [0, 4])
def test_unet_with_carried_weights_matches_harp_tpu(latent_dim):
    params = init_unet(in_ch=3, out_ch=2, base=4, latent_dim=latent_dim, seed=3)
    rng = np.random.RandomState(4)
    # Non-zero biases, so that their layout is checked too.
    for blocks in (params["enc"], params["dec"], [params["bott"]]):
        for block in blocks:
            for c in block.values():
                c["b"] = rng.normal(0, 0.1, c["b"].shape).astype(np.float32)
    x = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    z = rng.normal(0, 1, (2, latent_dim)).astype(np.float32) if latent_dim else None
    jz = jnp.asarray(z) if latent_dim else None
    want = np.asarray(unet_forward(params, jnp.asarray(x), jz))
    wgrad = np.asarray(jax.grad(lambda a: (unet_forward(params, a, jz) ** 2).sum())(
        jnp.asarray(x)))

    net = UNet(in_ch=3, out_ch=2, base=4, latent_dim=latent_dim)
    net.load_state_dict(unet_params_from_numpy(params))
    xt = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    out = net(xt, torch.tensor(z) if latent_dim else None)
    (out ** 2).sum().backward()
    got = out.detach().numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 32, 32, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    g = xt.grad.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(g, wgrad, rtol=1e-4, atol=1e-4 * np.abs(wgrad).max())


def test_opt_utils_match_harp_tpu():
    rng = np.random.RandomState(5)
    v = rng.normal(0, 1, (50, 3))
    np.testing.assert_array_equal(OPT.get_vert_colors(v), JOPT.get_vert_colors(v))
    np.testing.assert_array_equal(OPT.min_max_scale(v, axis=1), JOPT.min_max_scale(v, axis=1))
    const = np.ones((4, 3))  # a zero range: divided by 1e-9, not by 0
    np.testing.assert_array_equal(OPT.min_max_scale(const), JOPT.min_max_scale(const))


def test_fh_utils_match_harp_tpu(tmp_path):
    rng = np.random.RandomState(6)
    K = [[500.0, 0, 112.0], [0, 500.0, 112.0], [0, 0, 1.0]]
    xyz = (rng.normal(0, 0.05, (21, 3)) + [0, 0, 0.6]).tolist()
    for name, obj in (("K", [K, K]), ("mano", [[[0.1] * 61]] * 2), ("xyz", [xyz, xyz])):
        with open(tmp_path / f"training_{name}.json", "w") as f:
            json.dump(obj, f)
    assert FH.load_db_annotation(str(tmp_path)) == JFH.load_db_annotation(str(tmp_path))
    uv = FH.project_points(np.asarray(xyz), np.asarray(K))
    np.testing.assert_array_equal(uv, JFH.project_points(np.asarray(xyz), np.asarray(K)))
    np.testing.assert_array_equal(FH.draw_skeleton_mask(uv, 224),
                                  JFH.draw_skeleton_mask(uv, 224))
    assert FH.draw_skeleton_mask(uv, 224).sum() > 21
    assert FH.kp_connections() == JFH.kp_connections()
    for version in FH.SAMPLE_VERSIONS:
        assert FH.sample_version_index(7, version) == JFH.sample_version_index(7, version)
