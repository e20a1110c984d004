"""The CLI's real-data path on the CPU against harp_tpu's.

A reference-layout directory at 32^2: MANO_RIGHT.pkl, the hand template
OBJ and uv_mask.png written from the synthetic hand at reference density
(778 vertices, so MANO's fingertip ids exist), a train sequence "1" and a
val sequence "2" rendered from the hand loaded back from those files and
written by the port's encoder.

- The CLI's inputs (the loaded assets, FitData and initial parameters)
  equal harp_tpu's load_sequences(use_native=True), model loaders and
  init_params.
- A 3-epoch fit on the CLI's inputs (its defaults without VGG, the tile
  cap raised to 4096: at 32^2 a 16-pixel tile holds up to ~3000 of the
  6152 faces; K = 16) matches harp_tpu's fit_sequence on the same data and
  config within tests/test_torch_fit_sequence.py's tolerances: epoch
  losses rtol 1e-3, final parameters within 1e-3 of each leaf's largest
  entry; the displacements within 1e-2 of the learning rate, as
  tests/test_torch_step.py holds parameters after Adam (one of 3088 sits
  in Adam's eps regime).
- The image and val logs are written, and the fit with them equals one
  without them bit for bit (one thread).
- --start-from --known-appearance carries the appearance over unchanged.
- The flags of later slices still raise.
"""

import contextlib
import dataclasses
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from harp_tpu.assets import AvatarAssets as JAvatarAssets
from harp_tpu.assets import load_mano_model as jload_mano_model
from harp_tpu.assets import load_obj_with_uv as jload_obj_with_uv
from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.data.dataset import load_sequences as jload_sequences
from harp_tpu.fit import init_params as jinit_params
from harp_tpu.fit.driver import FitData as JFitData
from harp_tpu.fit.driver import fit_sequence as jfit_sequence
from harp_tpu.ops.mesh import build_subdivision as jbuild_subdivision
from harp_tpu.ops.mesh import build_topology as jbuild_topology
from harp_tpu_torch import fit_avatar
from harp_tpu_torch.assets import build_synthetic_assets, write_hand_model_files
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.data.dataset import write_sequence
from harp_tpu_torch.data.synthetic import make_synthetic_sequence
from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, fit_sequence
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.models.zoo import load_hand_model

IMG, TEX = 32, 64
FIT_FLAGS = ["--device", "cpu", "--img-size", str(IMG), "--texture-size", str(TEX),
             "--stages", "1", "1", "1", "--epochs", "3", "--batch-size", "2", "--no-vgg",
             "--raster-cap", "4096", "--no-turntables"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def chdir(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("real")
    write_hand_model_files(build_synthetic_assets(uv_size=TEX, density="reference"),
                           str(root / "MANO_RIGHT.pkl"),
                           str(root / "template/hand/textured_hand.obj"),
                           str(root / "template/hand/uv_mask.png"))
    config = HarpConfig(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX)
    with chdir(root):
        assets, _ = load_hand_model(config, mano_pkl="MANO_RIGHT.pkl")
    rcfg = config.raster_config(cap=2048, span_tiles=4)
    for seq, seed in (("1", 0), ("2", 1)):
        images, masks, _, _, init = make_synthetic_sequence(assets, config, rcfg, n_frames=2,
                                                            seed=seed, device="cpu")
        init = dict(init, verts=np.zeros((2, 1, 3), np.float32))
        write_sequence(str(root), seq, images, masks, init)
    return root


def _argv(root, out, *extra):
    return ["--metro-output-dir", str(root), "--image-dir", str(root), "--train-list", "1",
            "--mano-pkl", "MANO_RIGHT.pkl", *FIT_FLAGS, "--out", str(out), *extra]


def _harp_tpu(root, config_kw):
    """harp_tpu's real-data inputs, as its CLI builds them."""
    with chdir(root):
        model = jload_mano_model("MANO_RIGHT.pkl", flat_hand_mean=False)
        coarse = jbuild_topology(model.faces, model.num_verts)
        sub = jbuild_subdivision(coarse)
        _, _, verts_uvs, faces_uvs = jload_obj_with_uv("template/hand/textured_hand.obj")
        uv_mask = np.asarray(Image.open("template/hand/uv_mask.png").convert("L")
                             ).astype(np.float32) / 255.0
    jassets = JAvatarAssets(model=model, coarse_topology=coarse, subdivision=sub,
                            sub_topology=jbuild_topology(sub.faces, sub.num_verts),
                            verts_uvs=verts_uvs, faces_uvs=faces_uvs, uv_mask=uv_mask)
    jconfig = JHarpConfig(**config_kw)
    input_params, images, masks, masks_er = jload_sequences(str(root), str(root), ["1"],
                                                            use_native=True)
    return jassets, jconfig, input_params, (images, masks, masks_er)


def _config_kw(config):
    keep = {f.name for f in dataclasses.fields(JHarpConfig)}
    return {k: v for k, v in dataclasses.asdict(config).items() if k in keep}


@pytest.fixture(scope="module")
def run(root):
    """The CLI's 3-epoch real-data fit with the val sequence, and its
    inputs rebuilt from the same arguments."""
    out = root / "run"
    with chdir(root):
        stats = fit_avatar.main(_argv(root, out, "--val-list", "2"))
        args = fit_avatar.parse_args(_argv(root, out))
        config = fit_avatar._config(args)
        inputs = fit_avatar.load_inputs(args, config, torch.device("cpu"))
    return dict(out=out, stats=stats, config=config, inputs=inputs)


def test_cli_inputs_equal_harp_tpus(root, run):
    jassets, jconfig, jinput, jframes = _harp_tpu(root, _config_kw(run["config"]))
    inputs = run["inputs"]
    assets = inputs["assets"]
    np.testing.assert_array_equal(assets.verts_uvs, jassets.verts_uvs)
    np.testing.assert_array_equal(assets.faces_uvs, jassets.faces_uvs)
    np.testing.assert_array_equal(assets.uv_mask, jassets.uv_mask)
    np.testing.assert_array_equal(assets.render_faces, np.asarray(jassets.render_faces))
    np.testing.assert_array_equal(assets.model.tips_idx, jassets.model.tips_idx)
    assert set(inputs["input_params"]) == set(jinput)
    for k in jinput:
        np.testing.assert_array_equal(inputs["input_params"][k], jinput[k], err_msg=k)
    data = inputs["data"]
    for got, want in zip((data.images, data.masks, data.masks_eroded), jframes):
        np.testing.assert_array_equal(got.numpy(), want)
    params, aux = init_params(inputs["input_params"], assets, run["config"], device="cpu")
    jparams, jaux = jinit_params(jinput, jassets, jconfig)
    assert set(params) == set(jparams)
    for k in jparams:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(aux["init_joints"].numpy(), np.asarray(jaux["init_joints"]))


def test_cli_fit_matches_harp_tpus_fit_sequence(root, run):
    """Both packages' fit_sequence on the CLI's inputs and config, with
    K = 16 soft ids: at the CLI's K = 8, 13 of the 2048 pixels have more
    within-blur faces than K (the reference-density hand's vertex fans),
    and there harp_tpu's K-id silhouette gradient is not the port's
    all-faces one (K2). test_a_fit_with_logs_equals_one_without ties the
    CLI's own fit to fit_sequence on the same inputs."""
    config = dataclasses.replace(run["config"], raster_faces_per_pixel=16)
    jassets, jconfig, jinput, jframes = _harp_tpu(root, _config_kw(config))
    jparams, jaux = jinit_params(jinput, jassets, jconfig)
    jfinal, jhist = jfit_sequence(jconfig, jassets, JFitData(*map(jnp.asarray, jframes)),
                                  jparams, jaux, rcfg=jconfig.raster_config(), epoch_scan=0,
                                  prefetch_compile=False)
    inputs = run["inputs"]
    params, aux = init_params(inputs["input_params"], inputs["assets"], config, device="cpu")
    params, hist = fit_sequence(config, inputs["assets"], inputs["data"], params, aux,
                                rcfg=config.raster_config(), device="cpu")
    assert len(hist) == len(jhist) == 3
    for ours, theirs in zip(hist, jhist):
        assert set(ours) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(ours[k], float(theirs[k]), rtol=1e-3, atol=1e-7,
                                       err_msg=f"epoch {theirs['epoch']}: {k}")
        assert not any(ours.get(k, 0.0) for k in OVERFLOW_KEYS)
    for k, p in params.items():
        want, got = np.asarray(jfinal[k]), p.detach().numpy()
        if k == "verts_disps":
            # Adam's eps regime: a displacement whose gradient is within a
            # few eps (1e-8) of 0 takes a step set by its gradient's
            # rounding; here 1 of 3088 ends 3.0e-6 (0.3% of a step) from
            # harp_tpu's. Held as tests/test_torch_step.py holds parameters
            # after Adam: within 1e-2 of the learning rate.
            assert np.abs(got - want).max() <= 1e-2 * config.lr_pose, k
            continue
        assert np.abs(got - want).max() <= 1e-3 * max(np.abs(want).max(), 1e-12), k


def test_cli_writes_the_image_and_val_logs_and_evaluates_val(run):
    out, stats = run["out"], run["stats"]
    for name in ("sil_0000.jpg", "0000.jpg", "val_0000.jpg", "uv_0000.jpg", "normal_0000.jpg",
                 "saved_params.pkl", "fit_summary.json", os.path.join("val", "eval_results.txt"),
                 os.path.join("val", "rendered_after_opt", "0001.jpg")):
        assert os.path.exists(out / name), name
    assert not os.path.exists(out / "sil_0001.jpg")  # every 10 epochs
    with open(out / "fit_summary.json") as f:
        summary = json.load(f)
    for k in ("Silhouette IoU", "L1", "MS_SSIM"):
        assert 0.0 <= summary[f"val {k}"] == stats[f"val {k}"]
    assert 0.0 < summary["Silhouette IoU"] <= 1.0


def test_a_fit_with_logs_equals_one_without(run):
    inputs, config = run["inputs"], run["config"]
    params, aux = init_params(inputs["input_params"], inputs["assets"], config, device="cpu")
    params, _ = fit_sequence(config, inputs["assets"], inputs["data"], params, aux,
                             rcfg=config.raster_config(), device="cpu")
    with open(run["out"] / "saved_params.pkl", "rb") as f:
        saved = pickle.load(f)
    for k, p in params.items():
        np.testing.assert_array_equal(p.detach().numpy(), saved[k], err_msg=k)


def test_known_appearance_keeps_the_fitted_appearance(root, run):
    out = root / "known"
    with chdir(root):
        argv = _argv(root, out, "--start-from", str(run["out"]), "--known-appearance")
        argv[argv.index("--train-list") + 1] = "2"
        fit_avatar.main(argv)
    with open(run["out"] / "saved_params.pkl", "rb") as f:
        first = pickle.load(f)
    with open(out / "saved_params_test.pkl", "rb") as f:
        known = pickle.load(f)
    for k in ("texture", "normal_map", "verts_disps", "shape"):
        np.testing.assert_array_equal(known[k], first[k], err_msg=k)
    assert not np.array_equal(known["pose"], first["pose"])
    assert os.path.exists(out / "eval_results_test.txt")


def test_cli_refuses_later_slices_and_missing_data(root, tmp_path, capsys):
    # The epoch scan is ported: --epoch-scan 10 by default, as in harp_tpu.
    assert fit_avatar.parse_args(_argv(root, tmp_path)).epoch_scan == 10
    for n in ("10", "2", "0"):
        assert fit_avatar.parse_args(_argv(root, tmp_path) + ["--epoch-scan", n]).epoch_scan \
            == int(n)
    # The turntables are ported: on by default, as in harp_tpu.
    assert fit_avatar.parse_args([a for a in _argv(root, tmp_path)
                                  if a != "--no-turntables"]).turntables
    assert fit_avatar.parse_args(_argv(root, tmp_path) + ["--turntables"]).turntables
    with pytest.raises(SystemExit):
        fit_avatar.parse_args(["--synthetic", "--mano-pkl", "MANO_RIGHT.pkl"])
    with pytest.raises(SystemExit):
        fit_avatar.parse_args(["--out", str(tmp_path)])
