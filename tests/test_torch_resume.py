"""harp_tpu_torch.fit.resume vs harp_tpu.fit.resume on the CPU.

- interpolate_poses_30: bit for bit.
- prepare_resume_params on a saved_params.pkl written by harp_tpu, with and
  without known_appearance: every leaf equal to harp_tpu's (the mean-pooled
  translation and rotation to float32 rounding of the mean).
- A CLI fit killed after its epoch-2 checkpoint and resumed with
  --resume-orbax from the run directory ends on the same bits as the
  unbroken CLI fit (one thread).
- harp_tpu's Orbax (OCDBT) tree is refused, naming the converter that
  carries it across; the port's own orbax/ tree is read.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.fit.resume import interpolate_poses_30 as jinterpolate_poses_30
from harp_tpu.fit.resume import prepare_resume_params as jprepare_resume_params
from harp_tpu.utils.io import save_result as jsave_result
from harp_tpu_torch import fit_avatar
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.fit.driver import fit_sequence
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.fit.resume import (
    interpolate_poses_30, load_fit_checkpoint, prepare_resume_params,
)

CLI = ["--synthetic", "--device", "cpu", "--n-frames", "2", "--img-size", "32",
       "--texture-size", "32", "--density", "light", "--stages", "1", "2", "2",
       "--epochs", "5", "--raster-cap", "2048", "--no-vgg",
       "--no-turntables"]


def test_interpolate_poses_30_is_exact():
    pose = np.random.RandomState(0).randn(95, 45).astype(np.float32)
    want = np.asarray(jinterpolate_poses_30(jnp.asarray(pose)))
    np.testing.assert_array_equal(interpolate_poses_30(torch.from_numpy(pose)).numpy(), want)
    np.testing.assert_array_equal(interpolate_poses_30(pose).numpy(), want)
    np.testing.assert_array_equal(want[60:], pose[60:])  # n // 30 - 1 blocks only


@pytest.mark.parametrize("known_appearance", [False, True])
def test_prepare_resume_params_equals_harp_tpu(tmp_path, known_appearance):
    rng = np.random.RandomState(1)
    n_old, n = 4, 3
    saved = {"pose": rng.randn(n_old, 45), "rot": rng.randn(n_old, 3),
             "trans": rng.randn(n_old, 3), "shape": rng.randn(10), "cam": rng.randn(n_old, 3),
             "texture": rng.rand(16, 16, 3), "verts_disps": rng.randn(20, 1),
             "light_positions": rng.randn(n_old, 3)}
    jsave_result({k: jnp.asarray(v, jnp.float32) for k, v in saved.items()}, str(tmp_path))
    new = {"pose": rng.randn(n, 45).astype(np.float32), "rot": rng.randn(n, 3).astype(np.float32),
           "trans": rng.randn(n, 3).astype(np.float32), "cam": rng.randn(n, 3).astype(np.float32)}
    kw = dict(texture_size=16, known_appearance=known_appearance, start_from=str(tmp_path))
    want = jprepare_resume_params(str(tmp_path), new, JHarpConfig(**kw))
    got = prepare_resume_params(str(tmp_path), new, HarpConfig(**kw), device="cpu")
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].detach().numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == np.float32, k
        assert got[k].is_leaf and got[k].requires_grad, k
        if k in ("trans", "rot"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    if known_appearance:
        np.testing.assert_array_equal(got["cam"].detach().numpy(), new["cam"])


def test_a_killed_and_resumed_cli_fit_equals_the_unbroken_one(tmp_path):
    unbroken = str(tmp_path / "unbroken")
    fit_avatar.main(CLI + ["--out", unbroken])
    # The same fit killed after epoch 2: its checkpoint, as the CLI would
    # have written it with checkpoint_every=2.
    killed = str(tmp_path / "killed")
    args = fit_avatar.parse_args(CLI + ["--out", killed])
    config = fit_avatar._config(args)
    inputs = fit_avatar.load_inputs(args, config, torch.device("cpu"))
    params, aux = init_params(inputs["input_params"], inputs["assets"], config, device="cpu")
    short = HarpConfig(**{**config.__dict__, "total_epoch": 3})
    fit_sequence(short, inputs["assets"], inputs["data"], params, aux,
                 rcfg=config.raster_config(), out_dir=killed, image_log_every=10,
                 checkpoint_every=2, device="cpu")
    assert load_fit_checkpoint(killed, device="cpu")["epoch"] == 2
    resumed = str(tmp_path / "resumed")
    fit_avatar.main(CLI + ["--resume-orbax", killed, "--out", resumed])
    with open(os.path.join(unbroken, "saved_params.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(resumed, "saved_params.pkl"), "rb") as f:
        got = pickle.load(f)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(os.path.join(resumed, "metrics.jsonl")) as f:
        assert '"epoch": 3' in f.read()


def test_load_fit_checkpoint_refuses_orbax_trees(tmp_path):
    from harp_tpu_torch.utils.orbax_io import OrbaxCheckpointer

    # harp_tpu's layout: orbax/{step}/ with Orbax's metadata and an OCDBT store.
    jax_run = tmp_path / "jax_run"
    os.makedirs(jax_run / "orbax" / "2" / "default" / "ocdbt.process_0")
    (jax_run / "orbax" / "2" / "_CHECKPOINT_METADATA").write_text("{}")
    (jax_run / "orbax" / "2" / "default" / "manifest.ocdbt").write_bytes(b"")
    for path in (jax_run, jax_run / "orbax"):
        with pytest.raises(ValueError, match="opt_states_from_numpy"):
            load_fit_checkpoint(str(path), device="cpu")
    # The port's own tree: the latest step, from the run directory or orbax/.
    params = {"pose": torch.ones(2, 3, requires_grad=True)}
    with OrbaxCheckpointer(str(tmp_path / "run")) as ckpt:
        for step in (1, 2):
            ckpt.save(step, params, {"coarse": {}, "app": {}}, 0.5)
    for path in (tmp_path / "run", tmp_path / "run" / "orbax"):
        payload = load_fit_checkpoint(str(path), device="cpu")
        assert payload["epoch"] == 2 and payload["plateau_scale"] == 0.5
        assert torch.equal(payload["params"]["pose"], params["pose"].detach())
    with pytest.raises(FileNotFoundError):
        load_fit_checkpoint(str(tmp_path / "nothing"), device="cpu")
