"""One harp_tpu_torch train step vs one harp_tpu train step, on CPU.

A 2-frame 32^2 scene of the light-density synthetic hand with injected
images and masks, self-shadow on, coarse_on = app_on = True: the port's
step runs the plain twins of all three kernels (K1 camera + light, K2 in
the silhouette backward, K3 in the PCF backward). The raster cap keeps
every overflow counter at zero on both sides.

harp_tpu on CPU differentiates the silhouette through the first K soft
ids (soft_alpha_fast_at), the port through all within-blur faces (K2):
K = 16 is more than any pixel of this scene holds (checked), so the two
gradients are the same function. Texture-reg offsets are drawn on the JAX
side and handed to the port.

Tolerances: loss terms rtol 1e-4; gradients within 1e-3 of each leaf's
largest entry (float32 sums in other orders, and XLA:CPU's FMA
contraction, through ~10 chained ops); parameters after the Adam update
within 1e-2 * lr (the first Adam step is lr * g / (|g| + eps)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from harp_tpu.assets import build_synthetic_assets as jbuild
from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.fit import init_params as jinit_params
from harp_tpu.fit.driver import compute_losses as jcompute_losses
from harp_tpu.fit.optimizer import build_optimizers as jbuild_optimizers
from harp_tpu.losses.texture_reg import _neighbor_offsets
from harp_tpu.render import pipeline as jpipeline
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy
from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, make_train_step, stage_flags
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.render import pipeline
from harp_tpu_torch.render.rasterizer import RasterConfig, raster_compact

import _harp_goldens as goldens

IMG, TEX, K = 32, 16, 16
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=True, w_vgg=0.0, batch_size=2)
RCFG_KW = dict(image_size=IMG, tile=8, cap=512, face_chunk=256, faces_per_pixel=K,
               span_tiles=4, active_fraction=1.0)

# The step parity tolerances of the docstring, which the golden's regenerator
# reads too.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-7
GRAD_TOL = 1e-3  # of each leaf's largest entry
PARAM_TOL = 1e-2  # of the larger learning rate


def _scene():
    rng = np.random.RandomState(0)
    n = 2
    init = {
        "pose": 0.2 * rng.randn(n, 45), "rot": 0.05 * rng.randn(n, 3),
        "trans": np.zeros((n, 3)), "shape": 0.1 * rng.randn(n, 10),
        "cam": np.tile([6.0, -0.08, -0.01], (n, 1)),
        "joints": 10.0 * rng.randn(n, 21, 3),
    }
    yy, xx = np.mgrid[0:IMG, 0:IMG]
    masks = np.stack([((yy - 15.5) ** 2 + (xx - 14.5 - 2 * b) ** 2 < 64).astype(np.float32)
                      for b in range(n)])
    masks_er = np.stack([((yy - 15.5) ** 2 + (xx - 14.5 - 2 * b) ** 2 < 36).astype(np.float32)
                         for b in range(n)])
    images = rng.uniform(0, 1, (n, IMG, IMG, 3)).astype(np.float32)
    # A non-uniform appearance; the "uniform" case keeps harp_tpu's initial
    # maps, where every texture-reg difference is exactly 0 and jnp.abs's
    # subgradient (+1) moves every texel.
    appearance = {"texture": rng.uniform(0.3, 0.9, (TEX, TEX, 3)),
                  "normal_map": rng.normal(0, 0.2, (TEX, TEX, 3)) + [0.0, 0.0, 1.0]}
    return init, images, masks, masks_er, {k: v.astype(np.float32) for k, v in appearance.items()}


def _harp_tpu_step(uniform: bool) -> dict:
    """harp_tpu's train step of the scene (its loss, gradient and both Adam
    groups in one jit), the golden harp_tpu_step.npz (harp_tpu_step_uniform.npz
    from harp_tpu's uniform initial maps): the texture-reg offsets it draws,
    its total and loss terms, its gradients and the updated parameters."""
    jassets = jbuild(uv_size=TEX, density="light")
    jconfig = JHarpConfig(pcf_backend="pallas_interpret", **CFG_KW)
    jrcfg = JRasterConfig(**RCFG_KW)
    init, images, masks, masks_er, appearance = _scene()
    if uniform:
        appearance = {}

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
        # harp_tpu's _grad_step, keeping the gradients: one compile.
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


def _golden_name(uniform: bool) -> str:
    return "harp_tpu_step_uniform" if uniform else "harp_tpu_step"


@pytest.mark.slow
@pytest.mark.parametrize("uniform", [False, True], ids=["maps", "uniform"])
def test_harp_tpu_golden_of_the_step_is_current(uniform):
    config = HarpConfig(**CFG_KW)
    lr = max(config.lr_pose, config.lr_app)

    def tolerance(k, want):  # _check_loss_breakdown, _check_gradients, _check_parameters
        if k == "total" or k.startswith("loss."):
            return LOSS_ATOL + LOSS_RTOL * np.abs(want)
        if k.startswith("grad."):
            return GRAD_TOL * max(np.abs(want).max(), 1e-12)
        if k.startswith("new."):
            return PARAM_TOL * lr
        return None

    fresh = _harp_tpu_step(uniform)
    goldens.assert_current(_golden_name(uniform), fresh, tolerance)


def _run_both(uniform: bool = False):
    """harp_tpu's step (stored, _harp_tpu_step) and the port's from the same
    state, offsets and frames."""
    assets = assets_from_numpy(jbuild(uv_size=TEX, density="light"))
    config = HarpConfig(**CFG_KW)
    rcfg = RasterConfig(**RCFG_KW)
    init, images, masks, masks_er, appearance = _scene()
    if uniform:
        appearance = {}
    theirs = goldens.load(_golden_name(uniform))
    offsets = (theirs["offsets_albedo"], theirs["offsets_normal"])
    fids = np.arange(2)

    params, aux = init_params(init, assets, config, device="cpu")
    with torch.no_grad():
        for k, v in appearance.items():
            params[k].copy_(torch.from_numpy(v))
    old = {k: v.detach().clone() for k, v in params.items()}
    ref = pipeline.mesh_forward(params, torch.arange(1), assets, config)[0][0].detach()
    step = make_train_step(assets, config, rcfg, params, device="cpu")
    t = [torch.from_numpy(a) for a in (images, masks, masks_er)]
    total, br = step(aux, torch.from_numpy(fids), *t, ref, coarse_on=True, app_on=True,
                     offsets=tuple(torch.from_numpy(o) for o in offsets))
    with torch.no_grad():
        verts, _ = pipeline.mesh_forward(old, torch.from_numpy(fids), assets, config)
        R, T = pipeline.camera_for_frames(old, torch.from_numpy(fids), config)
        _, rout = pipeline.raster_camera_view_compact(verts, assets, R, T, config, rcfg)
    return dict(jtotal=theirs["total"], jbr=goldens.part(theirs, "loss"),
                jgrads=goldens.part(theirs, "grad"), jnew=goldens.part(theirs, "new"),
                total=total, br=br, params=params, old=old, rout=rout, config=config)


@pytest.fixture(scope="module")
def both():
    return _run_both()


@pytest.fixture(scope="module")
def both_uniform():
    return _run_both(uniform=True)


def test_step_loss_breakdown_matches(both):
    _check_loss_breakdown(both)


def test_step_gradients_match_per_leaf(both):
    _check_gradients(both)


def test_step_parameters_after_update_match(both):
    _check_parameters(both)


@pytest.mark.parametrize("check", ["losses", "gradients", "parameters"])
def test_step_from_uniform_initial_maps_matches(both_uniform, check):
    """The same step from harp_tpu's own uniform initial texture and normal
    map, where every texture-reg difference is 0 (jnp.abs's tie)."""
    both = both_uniform
    assert np.abs(np.asarray(both["jgrads"]["texture"])).max() > 0
    {"losses": _check_loss_breakdown, "gradients": _check_gradients,
     "parameters": _check_parameters}[check](both)


def _check_loss_breakdown(both):
    assert (both["rout"]["soft_ids"][..., -1] == -1).all(), "K too small for this scene"
    jbr, br = both["jbr"], both["br"]
    assert set(br) == set(jbr)
    for k in OVERFLOW_KEYS:
        assert float(br[k]) == float(jbr[k]) == 0.0, k
    for k in jbr:
        np.testing.assert_allclose(float(br[k]), float(jbr[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(both["total"]), float(both["jtotal"]), rtol=LOSS_RTOL)
    assert float(br["silhouette"]) > 0 and float(br["photo"]) > 0


def _check_gradients(both):
    for k, p in both["params"].items():
        want = np.asarray(both["jgrads"][k])
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= GRAD_TOL * scale, k


def _check_parameters(both):
    lr = max(both["config"].lr_pose, both["config"].lr_app)
    for k, p in both["params"].items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(both["jnew"][k]),
                                   rtol=0, atol=PARAM_TOL * lr, err_msg=k)


@pytest.mark.parametrize("stage", [(True, False), (False, True)], ids=["stage1", "stage3"])
def test_stage_flags_move_only_their_group(both, stage):
    coarse_on, app_on = stage
    config = both["config"]
    assert stage_flags(0, config) == (True, False)
    assert stage_flags(config.training_stage[0], config) == (True, True)
    assert stage_flags(sum(config.training_stage[:2]), config) == (False, True)
    assets = assets_from_numpy(jbuild(uv_size=TEX, density="light"))
    init, images, masks, masks_er, _ = _scene()
    params, aux = init_params(init, assets, config, device="cpu")
    old = {k: v.detach().clone() for k, v in params.items()}
    step = make_train_step(assets, config, RasterConfig(**RCFG_KW), params, device="cpu")
    ref = pipeline.mesh_forward(params, torch.arange(1), assets, config)[0][0].detach()
    gen = torch.Generator().manual_seed(0)
    step(aux, torch.arange(2), *[torch.from_numpy(a) for a in (images, masks, masks_er)],
         ref, coarse_on=coarse_on, app_on=app_on, generator=gen)
    coarse = {"pose", "cam", "shape", "verts_disps"}
    app = {"light_positions", "amb_ratio", "texture", "normal_map"}
    moving = (coarse if coarse_on else set()) | (app if app_on else set())
    for k, p in params.items():
        moved = not torch.equal(p.detach(), old[k])
        assert moved == (k in moving), k
    if not coarse_on:
        # The photometric loss still reaches the pose; the coarse group stays.
        assert params["pose"].grad is not None and params["pose"].grad.abs().max() > 0


def test_abs_subgradient_at_zero_matches_harp_tpu():
    """On harp_tpu's uniform initial texture every albedo-reg difference is
    exactly 0 (or -0.0), where jnp.abs's subgradient is +1 (torch.abs's is
    0): harp_tpu moves every uv-masked texel on the first appearance step,
    and the port, through jnp_abs, does the same."""
    from harp_tpu.losses.texture_reg import albedo_reg as jalbedo_reg
    from harp_tpu_torch.losses.texture_reg import albedo_reg

    offs = np.ones((TEX, TEX, 2), np.int32)
    tex = np.full((TEX, TEX, 3), 0.7, np.float32)
    jg = np.asarray(jax.grad(lambda t: jalbedo_reg(t, None, offsets=jnp.asarray(offs)))(
        jnp.asarray(tex)))
    t = torch.from_numpy(tex).requires_grad_(True)
    albedo_reg(t, offsets=torch.from_numpy(offs)).backward()
    assert np.abs(jg).max() > 0
    np.testing.assert_array_equal(t.grad.numpy(), jg)


def test_plateau_update_matches_harp_tpu():
    from harp_tpu.fit.optimizer import PlateauState as JState, plateau_update as jupdate
    from harp_tpu_torch.fit.optimizer import PlateauState, plateau_update

    losses = [1.0, 0.9, 0.9, 0.89999, 0.95, 0.95, 0.5, 0.5, 0.5, 0.5]
    ours, theirs = PlateauState(), JState()
    for x in losses:
        ours = plateau_update(ours, x, patience=2)
        theirs = jupdate(theirs, x, patience=2)
        assert (ours.best, ours.bad_epochs, ours.scale) == (
            theirs.best, theirs.bad_epochs, theirs.scale)
    assert ours.scale < 1.0
