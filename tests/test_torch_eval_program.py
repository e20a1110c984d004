"""harp_tpu_torch's make_eval_program (the eval pass as one program; on the
CPU its body runs eagerly through the same copy-in) and evaluate_sequence
/ the CLI going through it.

Against harp_tpu's make_eval_program on 4 frames of the 32^2 light hand
(self-shadow, texture 64^2) with render_batch 2, so two groups, from the
same numpy-seeded parameters: g equal, IoU equal, L1 / perceptual /
MS-SSIM rtol 1e-5 (float32 filters summed in other orders, as
tests/test_torch_eval.py), composites within one code (the renders'
near-edge FMA differences), vertices within 1e-5.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.assets import build_synthetic_assets as jbuild
from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.data.synthetic import make_synthetic_sequence as jmake_sequence
from harp_tpu.fit.driver import FitData as JFitData
from harp_tpu.fit.evaluate import make_eval_program as jmake_eval_program
from harp_tpu.losses.perceptual import Vgg16Features as JVgg
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy, params_from_numpy
from harp_tpu_torch.fit.driver import FitData
from harp_tpu_torch.fit.evaluate import EvalProgram, evaluate_sequence, make_eval_program
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.losses.perceptual import Vgg16Features
from harp_tpu_torch.render.rasterizer import RasterConfig
from test_torch_epoch_scan import _host_reads

IMG, TEX, N = 32, 64, 4
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=True, batch_size=2)
RCFG_KW = dict(image_size=IMG, tile=8, cap=1024, face_chunk=256, faces_per_pixel=16,
               span_tiles=4, active_fraction=1.0)


def _perturbed(gt: dict, seed: int) -> dict:
    """GT parameters with the pose, camera and texture moved: the metrics
    are then neither perfect nor trivial."""
    rng = np.random.RandomState(seed)
    p = dict(gt)
    p["pose"] = gt["pose"] + rng.normal(0, 0.15, gt["pose"].shape).astype(np.float32)
    p["cam"] = gt["cam"] * np.float32(1.0 + 0.03 * seed)
    p["texture"] = np.clip(gt["texture"] + rng.normal(0, 0.1, gt["texture"].shape),
                           0, 1).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def scene():
    jassets = jbuild(uv_size=TEX, density="light")
    jconfig, jrcfg = JHarpConfig(**CFG_KW), JRasterConfig(**RCFG_KW)
    images, masks, masks_er, gt, init = jmake_sequence(jassets, jconfig, jrcfg, n_frames=N,
                                                       seed=0)
    arrays = [np.asarray(x) for x in (images, masks, masks_er)]
    gt = {k: np.asarray(v) for k, v in gt.items()}
    return dict(jassets=jassets, jconfig=jconfig, jrcfg=jrcfg, arrays=arrays, gt=gt,
                init=init, assets=assets_from_numpy(jassets), config=HarpConfig(**CFG_KW),
                rcfg=RasterConfig(**RCFG_KW),
                data=FitData(*(torch.from_numpy(a.copy()) for a in arrays)))


def _program(scene, **kw):
    return make_eval_program(scene["config"], scene["assets"], scene["data"], scene["rcfg"],
                             Vgg16Features.create(device="cpu"), device="cpu", **kw)


def _call(prog, scene, params_np):
    d = scene["data"]
    return prog(params_from_numpy(params_np, "cpu"), d.images, d.masks)


def test_eval_program_matches_harp_tpus(scene):
    params = _perturbed(scene["gt"], 1)
    jvgg = JVgg.create()
    jprog, jg = jmake_eval_program(scene["jconfig"], scene["jassets"],
                                   JFitData(*map(jnp.asarray, scene["arrays"])),
                                   scene["jrcfg"], jvgg, render_batch=2)
    want = jprog({k: jnp.asarray(v) for k, v in params.items()},
                 *map(jnp.asarray, scene["arrays"][:2]),
                 tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in jvgg.params))
    want = [np.asarray(x) for x in want]
    prog, g = _program(scene, render_batch=2)
    assert isinstance(prog, EvalProgram) and not prog.use_graph
    assert (g, prog.n // g) == (jg, 2) == (2, 2)
    *got, overflow = _call(prog, scene, params)
    got = [x.numpy() for x in got]
    assert [x.shape for x in got] == [x.shape for x in want]
    assert got[4].dtype == np.uint8 and got[4].shape == (N, IMG, 4 * IMG, 3)
    np.testing.assert_array_equal(got[0], want[0])  # IoU
    assert 0.3 < got[0].min() and got[0].max() < 1.0
    for i in (1, 2, 3):  # L1, perceptual, MS-SSIM
        np.testing.assert_allclose(got[i], want[i], rtol=1e-5, atol=1e-7)
    assert np.abs(got[4].astype(int) - want[4].astype(int)).max() <= 1
    np.testing.assert_allclose(got[5], want[5], rtol=0, atol=1e-5)
    assert set(overflow) >= {"bin_overflow", "light_span_overflow"}
    assert not any(int(v) for v in overflow.values())


def test_a_second_call_reads_the_new_parameters(scene):
    """The copy-in: a call after one with other parameters returns what a
    fresh program gives for its own, and the first call's results stay the
    caller's."""
    prog, _ = _program(scene, render_batch=2)
    first = _call(prog, scene, _perturbed(scene["gt"], 1))
    kept = [x.clone() for x in first[:6]]
    second = _call(prog, scene, _perturbed(scene["gt"], 2))
    fresh = _call(_program(scene, render_batch=2)[0], scene, _perturbed(scene["gt"], 2))
    for a, b in zip(second[:6], fresh[:6]):
        assert torch.equal(a, b)
    assert not torch.equal(second[1], kept[1])  # L1 moved with the parameters
    for a, b in zip(first[:6], kept):
        assert torch.equal(a, b)
    # vgg_params as harp_tpu passes them: the program's own filters give the same bits.
    again = prog(params_from_numpy(_perturbed(scene["gt"], 2), "cpu"), scene["data"].images,
                 scene["data"].masks, prog.vgg.params)
    for a, b in zip(again[:6], fresh[:6]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="frames"):
        prog(params_from_numpy(scene["gt"], "cpu"), scene["data"].images[:2],
             scene["data"].masks[:2])


def test_the_program_body_reads_nothing_from_the_host(scene, monkeypatch):
    """After the first call (the warm-up's constants), the pass makes no
    tensor from host data and reads no value: on the card either would
    copy or synchronise, which the capture refuses."""
    prog, _ = _program(scene, render_batch=2)
    _call(prog, scene, _perturbed(scene["gt"], 1))
    seen = _host_reads(monkeypatch)
    prog._run(range(prog.n // prog.g))
    monkeypatch.undo()
    assert seen == []


def _strip(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if not k.endswith("_s")}


def test_evaluate_sequence_through_a_program_equals_its_own(scene, tmp_path):
    _, aux = init_params(scene["init"], scene["assets"], scene["config"], device="cpu")
    params = params_from_numpy(_perturbed(scene["gt"], 1), "cpu")
    kw = dict(rcfg=scene["rcfg"], save_images=False, device="cpu", render_batch=2)
    own = evaluate_sequence(scene["config"], scene["assets"], scene["data"], params, aux,
                            out_dir=str(tmp_path / "own"), **kw)
    prog, _ = _program(scene, render_batch=2)
    given = evaluate_sequence(scene["config"], scene["assets"], scene["data"], params, aux,
                              out_dir=str(tmp_path / "given"), eval_program=prog, **kw)
    assert _strip(own) == _strip(given)
    assert given["eval_program_s"] > 0 and "eval_capture_s" not in given  # no graph here
    assert 0.3 < own["Silhouette IoU"] < 1.0


def test_a_truncated_render_is_still_refused(scene, tmp_path):
    _, aux = init_params(scene["init"], scene["assets"], scene["config"], device="cpu")
    params = params_from_numpy(scene["gt"], "cpu")
    tight = dataclasses.replace(scene["rcfg"], cap=8)
    prog = make_eval_program(scene["config"], scene["assets"], scene["data"], tight,
                             Vgg16Features.create(device="cpu"), device="cpu")[0]
    with pytest.raises(RuntimeError, match="truncated"):
        evaluate_sequence(scene["config"], scene["assets"], scene["data"], params, aux,
                          rcfg=tight, out_dir=str(tmp_path), save_images=False, device="cpu",
                          eval_program=prog)


def test_make_eval_program_refuses_a_graph_off_cuda(scene):
    with pytest.raises(ValueError, match="CUDA graph"):
        _program(scene, graph=True)


def test_the_cli_hands_its_program_to_evaluate_sequence(monkeypatch, tmp_path):
    """The CLI builds make_eval_program for the fitted sequence before the
    fit and passes it, with its VGG, to evaluate_sequence (the fit and the
    eval are stubbed)."""
    from harp_tpu_torch.fit import driver, evaluate
    from harp_tpu_torch.fit_avatar import main

    seen = []
    monkeypatch.setattr(driver, "fit_sequence", lambda config, assets, data, params, *a, **k:
                        (params, []))

    def evaluate_sequence(config, assets, data, params, aux, **kw):
        seen.append((data.num_frames, kw))
        return {}

    monkeypatch.setattr(evaluate, "evaluate_sequence", evaluate_sequence)
    out = str(tmp_path / "run")
    main(["--synthetic", "--device", "cpu", "--n-frames", "2", "--img-size", "32",
          "--texture-size", "16", "--density", "light", "--no-turntables", "--out", out])
    (n, kw), = seen
    prog = kw["eval_program"]
    assert isinstance(prog, EvalProgram) and prog.n == n == 2
    assert kw["vgg"] is not None and prog.vgg.source == kw["vgg"].source
    assert prog.device == torch.device("cpu") and not prog.use_graph
    with open(os.path.join(out, "fit_summary.json")) as f:
        assert json.load(f)["final_loss"] is None  # the stubbed fit's empty history
