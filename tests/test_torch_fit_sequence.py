"""harp_tpu_torch's fit_sequence vs harp_tpu's, on CPU, and the port's
checkpoint / resume and key stream.

The parity fit: harp_tpu's synthetic sequence of the light-density hand,
2 frames at 32^2, texture 64^2, self-shadow, VGG on in float32 with the
cached GT pyramids, stages 1 / 1 (one silhouette epoch, one epoch of
everything), harp_tpu with epoch_scan=0 and prefetch_compile=False. Both
packages draw the same minibatch permutations (numpy RandomState) and the
same texture-reg offsets (threefry key stream; the port draws them on the
device from the same subkeys). K = 16 soft ids hold every within-blur
face of this scene (checked), so harp_tpu's K-id silhouette gradient and
the port's all-faces one (K2) are the same function. harp_tpu's fit is
read from tests/golden/harp_tpu_loop_fit.npz (tests/_harp_goldens.py).

Tolerances: per-epoch loss and each term rtol 1e-3; final parameters
within 1e-3 of each leaf's largest entry (float32 sums in other orders and
XLA:CPU's FMA contraction, through two Adam steps).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.assets import build_synthetic_assets as jbuild
from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.data.synthetic import make_synthetic_sequence as jmake_sequence
from harp_tpu.fit import init_params as jinit_params
from harp_tpu.fit.driver import FitData as JFitData
from harp_tpu.fit.driver import _key_stream_host, _key_stream_np as jkey_stream_np
from harp_tpu.fit.driver import fit_sequence as jfit_sequence
from harp_tpu.losses.texture_reg import _neighbor_offsets
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy
from harp_tpu_torch.fit import driver
from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, FitData, fit_sequence
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.render import pipeline
from harp_tpu_torch.render.rasterizer import RasterConfig, raster_compact
from harp_tpu_torch.utils.io import load_checkpoint

import _harp_goldens as goldens

IMG, TEX = 32, 64
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=True, w_vgg=1.0, vgg_compute_dtype="float32", batch_size=2,
              training_stage=(1, 1, 0), total_epoch=2)
RCFG_KW = dict(image_size=IMG, tile=8, cap=1024, face_chunk=256, faces_per_pixel=16,
               span_tiles=4, active_fraction=1.0)

# The parity tolerances of the docstring, which the golden's regenerator reads
# too.
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-7  # each epoch's loss and terms
PARAM_TOL = 1e-3  # of each leaf's largest entry


@pytest.fixture(scope="module")
def scene():
    jassets = jbuild(uv_size=TEX, density="light")
    jconfig = JHarpConfig(**CFG_KW)
    jrcfg = JRasterConfig(**RCFG_KW)
    images, masks, masks_er, _, init = jmake_sequence(jassets, jconfig, jrcfg, n_frames=2,
                                                      seed=0)
    arrays = [np.asarray(a) for a in (images, masks, masks_er)]
    return dict(jassets=jassets, jconfig=jconfig, jrcfg=jrcfg, arrays=arrays, init=init,
                assets=assets_from_numpy(jassets), config=HarpConfig(**CFG_KW),
                rcfg=RasterConfig(**RCFG_KW))


def _port_fit(scene, config=None, **kw):
    config = config or scene["config"]
    params, aux = init_params(scene["init"], scene["assets"], config, device="cpu")
    data = FitData(*[torch.from_numpy(a.copy()) for a in scene["arrays"]])
    return fit_sequence(config, scene["assets"], data, params, aux, rcfg=scene["rcfg"],
                        device="cpu", **kw)


def _harp_tpu_loop_fit(scene) -> dict:
    """harp_tpu's per-step fit of the scene, the golden
    harp_tpu_loop_fit.npz: its history and final parameters."""
    jparams, jaux = jinit_params(scene["init"], scene["jassets"], scene["jconfig"])
    jdata = JFitData(*[jnp.asarray(a) for a in scene["arrays"]])
    jfinal, jhist = jfit_sequence(scene["jconfig"], scene["jassets"], jdata, jparams, jaux,
                                  rcfg=scene["jrcfg"], epoch_scan=0, prefetch_compile=False)
    return goldens.pack(hist=jhist, param=jfinal)


@pytest.mark.slow
def test_harp_tpu_golden_of_the_loop_fit_is_current(scene):
    def tolerance(k, want):  # test_fit_sequence_epoch_losses..., final_parameters...
        if k == "hist":
            return LOSS_ATOL + LOSS_RTOL * np.abs(want)
        if k.startswith("param."):
            return PARAM_TOL * max(np.abs(want).max(), 1e-12)
        return None

    goldens.assert_current("harp_tpu_loop_fit", _harp_tpu_loop_fit(scene), tolerance)


@pytest.fixture(scope="module")
def both(scene, tmp_path_factory):
    """harp_tpu's fit (stored, _harp_tpu_loop_fit) and the port's."""
    theirs = goldens.load("harp_tpu_loop_fit")
    jhist, jfinal = goldens.part(theirs, "hist"), goldens.part(theirs, "param")
    out_dir = str(tmp_path_factory.mktemp("fit"))
    params, hist = _port_fit(scene, out_dir=out_dir)
    return dict(jfinal=jfinal, jhist=jhist, params=params, hist=hist, out_dir=out_dir)


def test_key_stream_matches_harp_tpu():
    ours = driver._key_stream_np(0, 40)
    np.testing.assert_array_equal(ours, jkey_stream_np(0, 40))
    np.testing.assert_array_equal(ours, _key_stream_host(0, 40))
    np.testing.assert_array_equal(driver._key_stream_np(7, 5), jkey_stream_np(7, 5))
    with pytest.raises(ValueError):
        driver._key_stream_np(2 ** 32, 1)


@pytest.mark.parametrize("step", [0, 5, 39])
def test_texture_offsets_equal_jax_random_at_64x48(step):
    sub = driver._key_stream_np(0, 40)[step]
    off_a, off_n = driver.texture_reg_offsets(sub, 64, 48, "cpu")
    k1, k2 = jax.random.split(jnp.asarray(sub))
    np.testing.assert_array_equal(off_a.numpy(), np.asarray(_neighbor_offsets(k1, (64, 48), 1.0)))
    np.testing.assert_array_equal(off_n.numpy(), np.asarray(_neighbor_offsets(k2, (64, 48), 2.0)))


def test_texture_offsets_at_the_flagship_texture_size():
    """512^2 x 2 draws of each std: the port takes erfinv in float64, XLA in
    its float32 polynomial, so an offset may differ where std * z lies
    within ~1e-6 of an integer: at most 5 of 524,288 per draw (measured:
    0 or 1)."""
    subs = driver._key_stream_np(0, 3)
    for sub in subs:
        off_a, off_n = driver.texture_reg_offsets(sub, 512, 512, "cpu")
        k1, k2 = jax.random.split(jnp.asarray(sub))
        for got, key, std in ((off_a, k1, 1.0), (off_n, k2, 2.0)):
            want = np.asarray(_neighbor_offsets(key, (512, 512), std))
            mismatched = got.numpy() != want
            assert mismatched.sum() <= 5
            assert np.abs(got.numpy() - want).max() <= 1


def test_soft_id_depth_holds_every_within_blur_face(scene):
    params, _ = init_params(scene["init"], scene["assets"], scene["config"], device="cpu")
    fids = torch.arange(2)
    verts, _ = pipeline.mesh_forward(params, fids, scene["assets"], scene["config"])
    R, T = pipeline.camera_for_frames(params, fids, scene["config"])
    _, rout = pipeline.raster_camera_view_compact(verts.detach(), scene["assets"], R, T,
                                                  scene["config"], scene["rcfg"])
    assert (rout["soft_ids"][..., -1] == -1).all()


def test_fit_sequence_epoch_losses_match_harp_tpu(both):
    assert len(both["hist"]) == len(both["jhist"]) == 2
    for ours, theirs in zip(both["hist"], both["jhist"]):
        assert set(ours) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(ours[k], float(theirs[k]), rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL, err_msg=f"epoch {theirs['epoch']}: {k}")
    assert both["hist"][1]["vgg"] > 0 and both["hist"][1]["photo"] > 0


def test_fit_sequence_final_parameters_match_harp_tpu(both):
    for k, p in both["params"].items():
        want = np.asarray(both["jfinal"][k])
        got = p.detach().numpy()
        assert np.abs(got - want).max() <= PARAM_TOL * max(np.abs(want).max(), 1e-12), k


def test_fit_sequence_jsonl_has_every_term_and_overflow_counter(both):
    with open(f"{both['out_dir']}/metrics.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    epochs = [r for r in lines if "loss" in r]
    assert [r["epoch"] for r in epochs] == [0.0, 1.0]
    for k in OVERFLOW_KEYS:
        assert epochs[1][k] == 0.0, k
    assert {"silhouette", "photo", "vgg", "albedo", "normal_reg", "lr_scale"} <= set(epochs[1])
    assert lines[0]["step"] == -1 and "setup_total_s" in lines[0]


def test_checkpoint_resume_equals_an_unbroken_fit(scene, tmp_path):
    """Four epochs (stages 1 / 2 / 1) in one go, and the same fit stopped
    after its epoch-1 checkpoint and resumed from it: the same bits (on one
    CPU thread, tests/conftest.py's fixture: PyTorch's CPU backward of a gather
    accumulates in parallel)."""
    assert torch.get_num_threads() == 1
    config = dataclasses.replace(scene["config"], training_stage=(1, 2, 1), total_epoch=4)
    unbroken, hist = _port_fit(scene, config)
    _port_fit(scene, dataclasses.replace(config, total_epoch=2),
              out_dir=str(tmp_path), checkpoint_every=1)
    ck = load_checkpoint(str(tmp_path / "checkpoint.pt"))
    assert ck["epoch"] == 1 and set(ck["opt_states"]) == {"coarse", "app"}
    _, aux = init_params(scene["init"], scene["assets"], config, device="cpu")
    data = FitData(*[torch.from_numpy(a.copy()) for a in scene["arrays"]])
    resumed, rhist = fit_sequence(config, scene["assets"], data, ck["params"], aux,
                                  rcfg=scene["rcfg"], resume=ck, device="cpu")
    assert [h["epoch"] for h in rhist] == [2, 3]
    assert [h["loss"] for h in rhist] == [h["loss"] for h in hist[2:]]
    for k, p in unbroken.items():
        assert torch.equal(p.detach(), resumed[k].detach()), k


def test_fit_sequence_refuses_what_is_not_ported(scene):
    for kw in (dict(prefetch_compile=True), dict(prefetch_extra=[print])):
        with pytest.raises(NotImplementedError):
            _port_fit(scene, **kw)
    with pytest.raises(TypeError, match="Mesh"):  # a mesh is a parallel.Mesh
        _port_fit(scene, mesh=object())


def test_fit_sequence_takes_model_extras(scene):
    """extras are no longer refused: HTML's texture basis drives the
    texture, and its coefficients move while the free texels stay."""
    from harp_tpu_torch.models.html import synthetic_texture_basis

    config = dataclasses.replace(scene["config"], model_type="html", w_vgg=0.0)
    extras = {"texture_basis": synthetic_texture_basis(size=TEX, num_coeffs=101)}
    params, aux = init_params(scene["init"], scene["assets"], config, device="cpu")
    start = {k: v.detach().clone() for k, v in params.items()}
    data = FitData(*[torch.from_numpy(a.copy()) for a in scene["arrays"]])
    params, hist = fit_sequence(config, scene["assets"], data, params, aux, rcfg=scene["rcfg"],
                                extras=extras, device="cpu")
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss"]) and hist[-1]["photo"] > 0
    assert not torch.equal(params["html_texture"], start["html_texture"])
    assert torch.equal(params["texture"], start["texture"])


def test_fit_sequence_without_a_device_raises_when_cuda_is_absent(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, aux = init_params(scene["init"], scene["assets"], scene["config"], device="cpu")
    data = FitData(*[torch.from_numpy(a.copy()) for a in scene["arrays"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_sequence(scene["config"], scene["assets"], data, params, aux, rcfg=scene["rcfg"])


def test_raster_budget_of_the_scene_has_no_overflow(scene):
    params, _ = init_params(scene["init"], scene["assets"], scene["config"], device="cpu")
    fids = torch.arange(2)
    with torch.no_grad():
        verts, _ = pipeline.mesh_forward(params, fids, scene["assets"], scene["config"])
        R, T = pipeline.camera_for_frames(params, fids, scene["config"])
        from harp_tpu_torch.render import camera as cam_mod

        screen = cam_mod.screen_from_world(verts, R, T, scene["config"].focal_length, IMG)
        out = raster_compact(screen, scene["assets"].render_faces, scene["rcfg"])
    for k in ("bin_overflow", "active_overflow", "span_overflow"):
        assert int(out[k].sum()) == 0, k


def test_debug_nans_raises_at_the_first_nan_forward_and_backward(scene):
    """--debug-nans in both packages: a NaN injected into the pose makes
    the 32^2 forward raise FloatingPointError (harp_tpu: jax_debug_nans;
    the port: utils/debug_nans.DebugNans, naming the operation). A clean
    forward whose backward makes a NaN (the norm of a zero vector) raises
    in the backward, naming its operation. Infinities pass; a kernel
    wrapper's check_kernel raises only while the mode is active."""
    from harp_tpu.render import pipeline as jpipeline
    from harp_tpu_torch.utils.debug_nans import DebugNans, check_kernel

    jparams, _ = jinit_params(scene["init"], scene["jassets"], scene["jconfig"])
    jparams = dict(jparams, pose=jparams["pose"].at[0, 0].set(jnp.nan))
    with jax.debug_nans(True), pytest.raises(FloatingPointError):
        jpipeline.mesh_forward(jparams, jnp.arange(2), scene["jassets"], scene["jconfig"])
    params, _ = init_params(scene["init"], scene["assets"], scene["config"], device="cpu")
    with torch.no_grad():
        params["pose"][0, 0] = float("nan")
    with DebugNans(), pytest.raises(FloatingPointError, match=r"encountered in aten\."):
        pipeline.mesh_forward(params, torch.arange(2), scene["assets"], scene["config"])
    params, _ = init_params(scene["init"], scene["assets"], scene["config"], device="cpu")
    disps = params["verts_disps"].requires_grad_(True)  # zeros
    with DebugNans():
        verts, _ = pipeline.mesh_forward(params, torch.arange(2), scene["assets"],
                                         scene["config"])
        loss = verts.sum() + torch.linalg.vector_norm(disps)
        with pytest.raises(FloatingPointError, match=r"encountered in aten\.\w+"):
            loss.backward()
        assert torch.isinf(torch.ones(1) / 0).all()
        with pytest.raises(FloatingPointError, match="in segment_sum"):
            check_kernel(torch.tensor([0.0, float("nan")]), "segment_sum")
    check_kernel(torch.tensor([float("nan")]), "segment_sum")  # inactive: no check


def test_a_clean_fit_under_debug_nans_is_the_same_bits(scene, both):
    from harp_tpu_torch.utils.debug_nans import DebugNans

    with DebugNans():
        params, hist = _port_fit(scene)
    assert [h["loss"] for h in hist] == [h["loss"] for h in both["hist"]]
    for k, v in both["params"].items():
        assert torch.equal(params[k], v), k
