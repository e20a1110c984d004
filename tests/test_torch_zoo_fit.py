"""harp_tpu_torch's fit_sequence with HTML's texture basis in `extras` vs
harp_tpu's, on CPU.

harp_tpu's synthetic HTML sequence (the unsubdivided synthetic hand with
the synthetic 101-coefficient basis), 2 frames at 32^2, texture 16^2,
self-shadow, no VGG, two epochs of stage 2 (every term; one step program
on the JAX side), harp_tpu with epoch_scan=0 and prefetch_compile=False.
Both packages draw the same minibatch permutations and run the same key
stream (HTML draws no texture-reg offsets). K = 16 soft ids hold every
within-blur face of the scene, so harp_tpu's K-id silhouette gradient and
the port's all-faces one (K2) are the same function. harp_tpu's fit is
read from tests/golden/harp_tpu_html_fit.npz (tests/_harp_goldens.py).

Tolerances: per-epoch loss and each term rtol 1e-3 (as
tests/test_torch_fit_sequence.py); final parameters within 1e-3 of each
leaf's largest entry plus 1e-2 * its group's lr per step (tests/test_torch_step.py's
bound on one Adam update): an entry whose gradient is near Adam's eps
moves by a fraction of lr that float32 rounding changes, whatever the
leaf's scale (a hidden vertex's displacement here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.data.synthetic import make_synthetic_sequence as jmake_sequence
from harp_tpu.fit import init_params as jinit_params
from harp_tpu.fit.driver import FitData as JFitData
from harp_tpu.fit.driver import fit_sequence as jfit_sequence
from harp_tpu.models.zoo import load_hand_model as jload_hand_model
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy, extras_from_numpy
from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, FitData, fit_sequence
from harp_tpu_torch.fit.optimizer import group_param_names
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.render.rasterizer import RasterConfig

import _harp_goldens as goldens

IMG, TEX = 32, 16
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=True, w_vgg=0.0, batch_size=2, model_type="html",
              training_stage=(0, 2, 0), total_epoch=2)
RCFG_KW = dict(image_size=IMG, tile=8, cap=1024, face_chunk=256, faces_per_pixel=16,
               span_tiles=4, active_fraction=1.0)

# The parity tolerances of the docstring, which the golden's regenerator reads
# too.
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-7  # each epoch's loss and terms
PARAM_TOL = 1e-3  # of each leaf's largest entry
STEP_TOL = 1e-2  # of its group's lr, per epoch


def _scene():
    jconfig = JHarpConfig(**CFG_KW)
    jassets, jextras = jload_hand_model(jconfig, synthetic=True)
    jrcfg = JRasterConfig(**RCFG_KW)
    images, masks, masks_er, _, init = jmake_sequence(jassets, jconfig, jrcfg, n_frames=2,
                                                      seed=0)
    arrays = [np.asarray(a) for a in (images, masks, masks_er)]
    return jconfig, jassets, jextras, jrcfg, arrays, init


def _harp_tpu_html_fit() -> dict:
    """harp_tpu's HTML fit of the scene, the golden harp_tpu_html_fit.npz:
    its history and final parameters."""
    jconfig, jassets, jextras, jrcfg, arrays, init = _scene()
    jparams, jaux = jinit_params(init, jassets, jconfig)
    jfinal, jhist = jfit_sequence(jconfig, jassets, JFitData(*map(jnp.asarray, arrays)),
                                  jparams, jaux, rcfg=jrcfg, extras=jextras, epoch_scan=0,
                                  prefetch_compile=False)
    return goldens.pack(hist=jhist, param=jfinal)


def _lr(config) -> dict:
    """Each parameter's learning rate."""
    lr = {k: config.lr_pose for k in group_param_names(config)["coarse"]}
    lr.update({k: config.lr_app for k in group_param_names(config)["app"]})
    return lr


def _param_tolerance(config, leaf, want):
    return (PARAM_TOL * max(np.abs(want).max(), 1e-12)
            + config.total_epoch * STEP_TOL * _lr(config).get(leaf, 0.0))


@pytest.mark.slow
def test_harp_tpu_golden_of_the_html_fit_is_current():
    config = HarpConfig(**CFG_KW)

    def tolerance(k, want):  # test_html_fit_sequence_epoch_losses..., final_parameters...
        if k == "hist":
            return LOSS_ATOL + LOSS_RTOL * np.abs(want)
        if k.startswith("param."):
            return _param_tolerance(config, k[len("param."):], want)
        return None

    goldens.assert_current("harp_tpu_html_fit", _harp_tpu_html_fit(), tolerance)


@pytest.fixture(scope="module")
def both():
    """harp_tpu's fit (stored, _harp_tpu_html_fit) and the port's."""
    _, jassets, jextras, _, arrays, init = _scene()
    theirs = goldens.load("harp_tpu_html_fit")
    jhist, jfinal = goldens.part(theirs, "hist"), goldens.part(theirs, "param")

    config, assets = HarpConfig(**CFG_KW), assets_from_numpy(jassets)
    params, aux = init_params(init, assets, config, device="cpu")
    start = {k: v.detach().clone() for k, v in params.items()}
    final, hist = fit_sequence(config, assets, FitData(*(torch.from_numpy(a.copy()) for a in arrays)), params,
                               aux, rcfg=RasterConfig(**RCFG_KW), extras=extras_from_numpy(jextras),
                               device="cpu")
    return dict(jfinal=jfinal, jhist=jhist, final=final, hist=hist, start=start, aux=aux,
                arrays=arrays, assets=assets, extras=extras_from_numpy(jextras))


def test_html_fit_sequence_epoch_losses_match_harp_tpu(both):
    assert len(both["hist"]) == len(both["jhist"]) == 2
    for ours, theirs in zip(both["hist"], both["jhist"]):
        assert set(ours) == set(theirs)
        assert not {"albedo", "normal_reg"} & set(ours)
        for k in OVERFLOW_KEYS:
            assert ours[k] == 0.0, k
        for k in theirs:
            np.testing.assert_allclose(ours[k], float(theirs[k]), rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL, err_msg=f"epoch {theirs['epoch']}: {k}")
    assert both["hist"][1]["photo"] > 0


def test_html_fit_sequence_final_parameters_match_harp_tpu(both):
    config = HarpConfig(**CFG_KW)
    for k, p in both["final"].items():
        want = np.asarray(both["jfinal"][k])
        got = p.detach().numpy()
        assert np.abs(got - want).max() <= _param_tolerance(config, k, want), k
    # The basis coefficients moved; the free texels and the normal map did not.
    moved = {k for k, p in both["final"].items() if not torch.equal(p, both["start"][k])}
    assert "html_texture" in moved and not {"texture", "normal_map"} & moved


def test_html_evaluation_renders_the_basis_texture(both, tmp_path):
    """evaluate_sequence with the extras: the renders and the exported
    texture map take the basis texture at the fitted coefficients, not the
    free texel grid."""
    from harp_tpu_torch.fit.evaluate import evaluate_sequence
    from harp_tpu_torch.utils import viz

    config = HarpConfig(**CFG_KW)
    data = FitData(*(torch.from_numpy(a.copy()) for a in both["arrays"]))
    kw = dict(rcfg=RasterConfig(**RCFG_KW), out_dir=str(tmp_path), device="cpu",
              render_batch=2)
    stats = evaluate_sequence(config, both["assets"], data, both["final"], both["aux"],
                              extras=both["extras"], **kw)
    plain = evaluate_sequence(config, both["assets"], data, both["final"], both["aux"],
                              save_images=False, **kw)
    assert 0.0 < stats["Silhouette IoU"] <= 1.0 and stats["L1"] != plain["L1"]
    with torch.no_grad():
        tex = both["extras"]["texture_basis"].texture(both["final"]["html_texture"])
    want = (np.clip(tex.numpy(), 0, 1) * both["aux"]["uv_mask"].numpy()[..., None] * 255)
    with open(tmp_path / "uv_out" / "texture.png", "rb") as f:
        np.testing.assert_array_equal(viz.decode_png(f.read()), want.astype(np.uint8))
