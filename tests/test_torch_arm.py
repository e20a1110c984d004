"""harp_tpu_torch's SMPL-X arm vs harp_tpu's, on CPU.

- The synthetic arm (model, topologies, UVs, uv mask) equal array for array
  at the light and the reference density.
- smplx_arm_forward and the arm's mesh_forward at light density, B = 2:
  vertices rtol 1e-5 (atol 1e-4 mm), joints atol 1e-3 mm.
- One 32^2 arm train step against harp_tpu's (self-shadow, the wrist and
  global rotation optimised): the loss breakdown, the per-leaf gradients and
  the parameters after the update, at tests/test_torch_step.py's tolerances
  (loss terms rtol 1e-4; gradients within 1e-3 of each leaf's largest
  entry; parameters within 1e-2 * lr). K = 16 soft ids hold every
  within-blur face of the scene (checked), so harp_tpu's K-id silhouette
  gradient and the port's all-faces one (K2) are the same function.
- The repeated-index gather (the extra joints' vertex ids repeat) against a
  float64 sum of its repeats, and bit-equal from run to run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from harp_tpu.assets import build_synthetic_arm_assets as jbuild_arm
from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.fit import init_params as jinit_params
from harp_tpu.fit.driver import compute_losses as jcompute_losses
from harp_tpu.fit.optimizer import build_optimizers as jbuild_optimizers
from harp_tpu.losses.texture_reg import _neighbor_offsets
from harp_tpu.models.smplx_arm import smplx_arm_forward as jsmplx_arm_forward
from harp_tpu.render import pipeline as jpipeline
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu_torch.assets import build_synthetic_arm_assets
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy
from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, make_train_step
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.models.smplx_arm import smplx_arm_forward
from harp_tpu_torch.ops.segment import gather_table
from harp_tpu_torch.render import pipeline
from harp_tpu_torch.render.rasterizer import RasterConfig

import _harp_goldens as goldens

IMG, TEX, K = 32, 16, 16
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=True, w_vgg=0.0, batch_size=2, use_arm=True, opt_arm_pose=True)
RCFG_KW = dict(image_size=IMG, tile=8, cap=1024, face_chunk=256, faces_per_pixel=K,
               span_tiles=4, active_fraction=1.0)

# The step parity tolerances of the docstring, which the golden's regenerator
# reads too.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-7
GRAD_TOL = 1e-3  # of each leaf's largest entry
PARAM_TOL = 1e-2  # of the larger learning rate


def _assert_same_arrays(ours, theirs, path="assets"):
    """Every dataclass field of `theirs` equal in `ours`, recursively."""
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(b):
            _assert_same_arrays(a, b, f"{path}.{f.name}")
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{path}.{f.name}"
        else:
            assert a == b, f"{path}.{f.name}"


@pytest.mark.parametrize("density", ["light", "reference"])
def test_synthetic_arm_arrays_equal_harp_tpu(density):
    ours = build_synthetic_arm_assets(uv_size=64, density=density)
    theirs = jbuild_arm(uv_size=64, density=density)
    _assert_same_arrays(ours, theirs)
    want = {"light": (1174, 2320), "reference": (4078, 8128)}[density]
    assert (ours.num_render_verts, len(ours.render_faces)) == want


def _arm_inputs(B=2, seed=0):
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (0.3 * rng.randn(B, 10), 0.2 * rng.randn(B, 3),
                                           0.05 * rng.randn(B, 3), 0.3 * rng.randn(B, 45),
                                           0.2 * rng.randn(B, 3))]


@pytest.mark.parametrize("return_type", ["mano_w_arm", "mano"])
def test_smplx_arm_forward_matches_harp_tpu(return_type):
    jassets = jbuild_arm(uv_size=16, density="light")
    model = assets_from_numpy(jassets).model
    args = _arm_inputs()
    jv, jj = jsmplx_arm_forward(jassets.model, *map(jnp.asarray, args), return_type=return_type)
    v, j = smplx_arm_forward(model, *map(torch.from_numpy, args), return_type=return_type)
    assert v.shape == jv.shape and j.shape == jj.shape
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=0, atol=1e-3)


def test_arm_mesh_forward_matches_harp_tpu():
    """Pose, subdivide and displace along the normals: the render mesh (m)
    and the 22 joints (mm)."""
    jassets = jbuild_arm(uv_size=16, density="light")
    assets = assets_from_numpy(jassets)
    betas, rot, trans, pose, wrist = _arm_inputs(seed=1)
    rng = np.random.RandomState(2)
    params = {"pose": pose, "rot": rot, "trans": trans, "shape": betas[0], "wrist_pose": wrist,
              "verts_disps": (1e-3 * rng.randn(assets.num_render_verts, 1)).astype(np.float32)}
    fids = np.arange(2)
    jv, jj = jpipeline.mesh_forward({k: jnp.asarray(v) for k, v in params.items()},
                                    jnp.asarray(fids), jassets, JHarpConfig(use_arm=True))
    v, j = pipeline.mesh_forward({k: torch.from_numpy(v) for k, v in params.items()},
                                 torch.from_numpy(fids), assets, HarpConfig(use_arm=True))
    assert v.shape == (2, assets.num_render_verts, 3) and j.shape == (2, 22, 3)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=0, atol=1e-3)


def test_repeated_index_gather_gradient_matches_float64_sum():
    """The extra joints' 21 vertex ids name 6 distinct vertices (the 16
    unused ones one dummy vertex): the gradient of the gather sums each
    vertex's repeats, against the float64 sum; two runs give the same
    bits."""
    model = build_synthetic_arm_assets(uv_size=16, density="reference").model
    ids = model.extra_joint_vertex_ids
    assert len(ids) == 21 and np.unique(ids).size == 6
    rng = np.random.RandomState(3)
    B, V = 2, model.num_verts
    x = rng.randn(B, V, 3).astype(np.float32)
    g = rng.randn(B, len(ids), 3).astype(np.float32)
    grads = []
    for _ in range(2):
        t = torch.from_numpy(x).requires_grad_(True)
        out = gather_table(t, model.extra_order)
        np.testing.assert_array_equal(out.detach().numpy(), x[:, ids])
        out.backward(torch.from_numpy(g))
        grads.append(t.grad.numpy().copy())
    want = np.zeros((B, V, 3), np.float64)
    for b in range(B):
        np.add.at(want[b], ids, g[b].astype(np.float64))
    np.testing.assert_array_equal(grads[0], grads[1])
    np.testing.assert_allclose(grads[0], want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    assert np.abs(want[:, V - 1]).max() > 0  # the repeated vertex took a sum


def _scene():
    rng = np.random.RandomState(0)
    n = 2
    init = {
        "pose": 0.2 * rng.randn(n, 45), "rot": 0.05 * rng.randn(n, 3),
        "trans": np.zeros((n, 3)), "shape": 0.1 * rng.randn(n, 10),
        "cam": np.tile([6.0, -0.08, -0.01], (n, 1)),
        "joints": 10.0 * rng.randn(n, 22, 3),
    }
    yy, xx = np.mgrid[0:IMG, 0:IMG]
    masks = np.stack([((yy - 15.5) ** 2 + (xx - 12.5 - 2 * b) ** 2 < 81).astype(np.float32)
                      for b in range(n)])
    masks_er = np.stack([((yy - 15.5) ** 2 + (xx - 12.5 - 2 * b) ** 2 < 49).astype(np.float32)
                         for b in range(n)])
    images = rng.uniform(0, 1, (n, IMG, IMG, 3)).astype(np.float32)
    appearance = {"texture": rng.uniform(0.3, 0.9, (TEX, TEX, 3)),
                  "normal_map": rng.normal(0, 0.2, (TEX, TEX, 3)) + [0.0, 0.0, 1.0],
                  "wrist_pose": 0.1 * rng.randn(n, 3)}
    return init, images, masks, masks_er, {k: v.astype(np.float32) for k, v in appearance.items()}


def _harp_tpu_arm_step() -> dict:
    """harp_tpu's stage-2 arm step of the scene (its loss, gradient and both
    Adam groups in one jit), the golden harp_tpu_arm_step.npz: the
    texture-reg offsets it draws, its total and loss terms, its gradients
    and the updated parameters."""
    jassets = jbuild_arm(uv_size=TEX, density="light")
    jconfig = JHarpConfig(pcf_backend="pallas_interpret", **CFG_KW)
    jrcfg = JRasterConfig(**RCFG_KW)
    init, images, masks, masks_er, appearance = _scene()

    jparams, jaux = jinit_params(init, jassets, jconfig)
    jparams.update({k: jnp.asarray(v) for k, v in appearance.items()})
    fids = np.arange(2)
    jref = jpipeline.mesh_forward(jparams, jnp.asarray([0]), jassets, jconfig)[0][0]
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    offsets = (np.array(_neighbor_offsets(k1, (TEX, TEX), 1.0)),
               np.array(_neighbor_offsets(k2, (TEX, TEX), 2.0)))
    data = [jnp.asarray(a) for a in (images, masks, masks_er)]
    txs, states, _ = jbuild_optimizers(jparams, jconfig)

    @jax.jit
    def jstep(p, st):
        (total, br), g = jax.value_and_grad(
            lambda q: jcompute_losses(q, jaux, jnp.asarray(fids), *data, jassets, jconfig,
                                      jrcfg, None, jref, key, True, True),
            has_aux=True)(p)
        for group in ("coarse", "app"):
            upd, _ = txs[group].update(g, st[group], p)
            p = optax.apply_updates(p, upd)
        return total, br, g, p

    jtotal, jbr, jgrads, jnew = jstep(jparams, states)
    return goldens.pack(offsets_albedo=offsets[0], offsets_normal=offsets[1], total=jtotal,
                        loss=jbr, grad=jgrads, new=jnew)


@pytest.mark.slow
def test_harp_tpu_golden_of_the_arm_step_is_current():
    config = HarpConfig(**CFG_KW)
    lr = max(config.lr_pose, config.lr_app)

    def tolerance(k, want):  # the three test_arm_step_* parity tests
        if k == "total" or k.startswith("loss."):
            return LOSS_ATOL + LOSS_RTOL * np.abs(want)
        if k.startswith("grad."):
            return GRAD_TOL * max(np.abs(want).max(), 1e-12)
        if k.startswith("new."):
            return PARAM_TOL * lr
        return None

    fresh = _harp_tpu_arm_step()
    goldens.assert_current("harp_tpu_arm_step", fresh, tolerance)


@pytest.fixture(scope="module")
def both():
    """One stage-2 arm step in both packages from one state: harp_tpu's
    stored (_harp_tpu_arm_step), the port's from the same offsets."""
    assets = assets_from_numpy(jbuild_arm(uv_size=TEX, density="light"))
    config = HarpConfig(**CFG_KW)
    rcfg = RasterConfig(**RCFG_KW)
    init, images, masks, masks_er, appearance = _scene()
    theirs = goldens.load("harp_tpu_arm_step")
    offsets = (theirs["offsets_albedo"], theirs["offsets_normal"])
    fids = np.arange(2)

    params, aux = init_params(init, assets, config, device="cpu")
    with torch.no_grad():
        for k, v in appearance.items():
            params[k].copy_(torch.from_numpy(v))
    ref = pipeline.mesh_forward(params, torch.arange(1), assets, config)[0][0].detach()
    fids_t = torch.from_numpy(fids)
    with torch.no_grad():
        verts, _ = pipeline.mesh_forward(params, fids_t, assets, config)
        R, T = pipeline.camera_for_frames(params, fids_t, config)
        _, rout = pipeline.raster_camera_view_compact(verts, assets, R, T, config, rcfg)
    step = make_train_step(assets, config, rcfg, params, device="cpu")
    total, br = step(aux, fids_t, *[torch.from_numpy(a) for a in (images, masks, masks_er)],
                     ref, coarse_on=True, app_on=True,
                     offsets=tuple(torch.from_numpy(o) for o in offsets))
    return dict(jtotal=theirs["total"], jbr=goldens.part(theirs, "loss"),
                jgrads=goldens.part(theirs, "grad"), jnew=goldens.part(theirs, "new"),
                total=total, br=br, params=params, rout=rout, config=config)


def test_arm_step_loss_breakdown_matches_harp_tpu(both):
    assert (both["rout"]["soft_ids"][..., -1] == -1).all(), "K too small for this scene"
    jbr, br = both["jbr"], both["br"]
    assert set(br) == set(jbr) and "kps_anchor" in br and "albedo" in br
    for k in OVERFLOW_KEYS:
        assert float(br[k]) == float(jbr[k]) == 0.0, k
    for k in jbr:
        np.testing.assert_allclose(float(br[k]), float(jbr[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(both["total"]), float(both["jtotal"]), rtol=LOSS_RTOL)
    assert float(br["silhouette"]) > 0 and float(br["photo"]) > 0


def test_arm_step_gradients_match_harp_tpu_per_leaf(both):
    for k, p in both["params"].items():
        want = np.asarray(both["jgrads"][k])
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= GRAD_TOL * scale, k
    assert np.abs(np.asarray(both["jgrads"]["wrist_pose"])).max() > 0


def test_arm_step_parameters_after_update_match_harp_tpu(both):
    lr = max(both["config"].lr_pose, both["config"].lr_app)
    for k, p in both["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(both["jnew"][k]),
                                   rtol=0, atol=PARAM_TOL * lr, err_msg=k)


def test_light_gradient_equals_the_float64_light_cameras():
    """shadow_cameras builds the light camera in float64: the light
    position's gradient is a small difference of large parts there. A
    32^2 arm step's light_positions gradient equals the one with the whole
    light-camera chain in float64 (rtol 1e-6), where float32 inputs to it
    alone would lose digits."""
    from harp_tpu_torch.render import shadow

    assets = build_synthetic_arm_assets(uv_size=TEX, density="light")
    config = HarpConfig(**CFG_KW)
    rcfg = RasterConfig(**RCFG_KW)
    init, images, masks, masks_er, appearance = _scene()
    shadow_cameras = shadow.shadow_cameras

    def all_float64(cam, light, centre, cfg):
        out = shadow_cameras(cam.double(), light.double(), centre.double(), cfg)
        return tuple(t.float() for t in out)

    grads = []
    for cameras in (shadow_cameras, all_float64):
        params, aux = init_params(init, assets, config, device="cpu")
        ref = pipeline.mesh_forward(params, torch.arange(1), assets, config)[0][0].detach()
        step = make_train_step(assets, config, rcfg, params, device="cpu")
        shadow.shadow_cameras = cameras
        try:
            step(aux, torch.arange(2), *[torch.from_numpy(a) for a in (images, masks, masks_er)],
                 ref, coarse_on=True, app_on=True, generator=torch.Generator().manual_seed(0))
        finally:
            shadow.shadow_cameras = shadow_cameras
        grads.append(params["light_positions"].grad.clone())
    assert grads[1].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6 * float(grads[1].abs().max()))
