"""harp_tpu_torch.utils.orbax_io (the async checkpointer) and the orbax
backend of fit_sequence, the CLI and load_fit_checkpoint, on the CPU.

- Round trip, retention of the newest max_to_keep steps, a write cut short
  never the latest step, and snapshot isolation (save copies the state
  before it returns: the step updates parameters and Adam moments in
  place).
- A fit killed after its orbax checkpoint and resumed is the same bits as
  the unbroken fit (one thread), through fit_sequence and through the CLI's
  --checkpoint-backend orbax / --resume-orbax.
- A harp_tpu Orbax (OCDBT) checkpoint, read by harp_tpu's
  load_fit_checkpoint and carried across with params_from_numpy and
  opt_states_from_numpy, resumes in the port and ends where harp_tpu's
  unbroken fit ends. harp_tpu's OrbaxCheckpointer writes it here from the
  state harp_tpu's fit handed it, stored with the fit (a golden); that the
  fit writes the same checkpoint as it runs is tested only in harp_tpu's
  own suite (tests/test_checkpoint_orbax.py). The scene and tolerances of
  tests/test_torch_fit_sequence.py (light hand, 2 frames at 32^2, texture
  64^2, self-shadow, K = 16; losses rtol 1e-3, parameters within 1e-3 of
  each leaf's largest entry), without VGG.
"""

import dataclasses
import os
import pickle
import threading

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
from harp_tpu.fit.driver import fit_sequence as jfit_sequence
from harp_tpu.fit.resume import load_fit_checkpoint as jload_fit_checkpoint
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu_torch import fit_avatar
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy, opt_states_from_numpy, params_from_numpy
from harp_tpu_torch.fit.driver import FitData, fit_sequence
from harp_tpu_torch.fit.optimizer import build_optimizers
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.fit.resume import load_fit_checkpoint
from harp_tpu_torch.render.rasterizer import RasterConfig
from harp_tpu_torch.utils import orbax_io
from harp_tpu_torch.utils.orbax_io import OrbaxCheckpointer

import _harp_goldens as goldens

IMG, TEX = 32, 64
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=True, w_vgg=0.0, batch_size=2, training_stage=(1, 3, 0),
              total_epoch=4)
RCFG_KW = dict(image_size=IMG, tile=8, cap=1024, face_chunk=256, faces_per_pixel=16,
               span_tiles=4, active_fraction=1.0)

# The parity tolerances of the docstring, which the golden's regenerator reads
# too.
LOSS_RTOL, LOSS_ATOL = 1e-3, 1e-7  # each epoch's loss and terms
PARAM_TOL = 1e-3  # of each leaf's largest entry


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"pose": torch.randn(2, 45, generator=g, requires_grad=True),
              "texture": torch.rand(4, 4, 3, generator=g, requires_grad=True)}
    opt = torch.optim.Adam(params.values(), lr=0.1)
    sum(p.sum() for p in params.values()).backward()
    opt.step()
    return params, {"coarse": opt.state_dict()}


def test_round_trip_and_retention(tmp_path):
    params, opt_states = _state()
    poses = {}
    with OrbaxCheckpointer(str(tmp_path), max_to_keep=3) as ckpt:
        for step in range(1, 6):
            with torch.no_grad():
                params["pose"].add_(1.0)
            poses[step] = params["pose"].detach().clone()
            ckpt.save(step, params, opt_states, plateau_scale=0.5 ** step,
                      extra={"plateau": {"best": 1.0, "bad_epochs": step, "scale": 0.5}})
        ckpt.wait()
        assert ckpt.all_steps() == [3, 4, 5] and ckpt.latest_step() == 5
        latest = ckpt.restore()
        third = ckpt.restore(step=3)
    assert sorted(os.listdir(tmp_path / "orbax")) == ["3", "4", "5"]
    assert latest["epoch"] == 5 and latest["plateau_scale"] == 0.5 ** 5
    assert latest["extra"]["plateau"]["bad_epochs"] == 5
    assert torch.equal(latest["params"]["pose"], params["pose"].detach())
    assert latest["params"]["pose"].requires_grad
    assert torch.equal(third["params"]["pose"], poses[3])
    for k, v in opt_states["coarse"]["state"][0].items():
        assert torch.equal(latest["opt_states"]["coarse"]["state"][0][k], v), k
    with OrbaxCheckpointer(str(tmp_path / "none")) as empty:
        assert empty.latest_step() is None
        with pytest.raises(FileNotFoundError):
            empty.restore()


def test_a_write_cut_short_is_never_the_latest_step(tmp_path, monkeypatch):
    params, opt_states = _state()
    with OrbaxCheckpointer(str(tmp_path)) as ckpt:
        ckpt.save(1, params, opt_states)
        ckpt.wait()
    # A writer killed mid-file leaves only its temporary directory.
    part = tmp_path / "orbax" / ".2.cut"
    part.mkdir()
    (part / orbax_io.PAYLOAD).write_bytes(b"\x80\x02partial")

    def fail(path, *a, **k):
        with open(path, "wb") as f:
            f.write(b"\x80\x02partial")
        raise OSError("disk full")

    ckpt = OrbaxCheckpointer(str(tmp_path))
    monkeypatch.setattr(orbax_io, "save_checkpoint", fail)
    ckpt.save(3, params, opt_states)
    with pytest.raises(OSError, match="disk full"):
        ckpt.close()
    assert ckpt.latest_step() == 1
    assert sorted(os.listdir(tmp_path / "orbax")) == [".2.cut", "1"]  # step 3's removed
    assert load_fit_checkpoint(str(tmp_path), device="cpu")["epoch"] == 1


def test_save_snapshots_the_state_before_it_returns(tmp_path):
    params, opt_states = _state()
    want_p = {k: v.detach().clone() for k, v in params.items()}
    want_m = opt_states["coarse"]["state"][0]["exp_avg"].clone()
    gate = threading.Event()
    with OrbaxCheckpointer(str(tmp_path)) as ckpt:
        ckpt._writer.submit(gate.wait)  # hold the writer until the state has moved
        ckpt.save(7, params, opt_states)
        with torch.no_grad():
            for p in params.values():
                p.mul_(-3.0)
            opt_states["coarse"]["state"][0]["exp_avg"].add_(5.0)  # Adam's in-place update
        gate.set()
        ckpt.wait()
        got = ckpt.restore()
    for k, v in want_p.items():
        assert torch.equal(got["params"][k], v), k
    assert torch.equal(got["opt_states"]["coarse"]["state"][0]["exp_avg"], want_m)


@pytest.fixture(scope="module")
def scene():
    jassets = jbuild(uv_size=TEX, density="light")
    jconfig, jrcfg = JHarpConfig(**CFG_KW), JRasterConfig(**RCFG_KW)
    images, masks, masks_er, _, init = jmake_sequence(jassets, jconfig, jrcfg, n_frames=2,
                                                      seed=0)
    return dict(jassets=jassets, jconfig=jconfig, jrcfg=jrcfg, init=init,
                arrays=[np.asarray(a) for a in (images, masks, masks_er)],
                assets=assets_from_numpy(jassets), config=HarpConfig(**CFG_KW),
                rcfg=RasterConfig(**RCFG_KW))


def _port_fit(scene, config, params=None, **kw):
    p0, aux = init_params(scene["init"], scene["assets"], config, device="cpu")
    data = FitData(*[torch.from_numpy(a.copy()) for a in scene["arrays"]])
    return fit_sequence(config, scene["assets"], data, p0 if params is None else params, aux,
                        rcfg=scene["rcfg"], device="cpu", **kw)


def test_killed_and_resumed_fit_under_orbax_is_the_same_bits(scene, tmp_path):
    config = dataclasses.replace(scene["config"], checkpoint_backend="orbax")
    unbroken, hist = _port_fit(scene, config)
    _port_fit(scene, dataclasses.replace(config, total_epoch=3), out_dir=str(tmp_path),
              checkpoint_every=1)
    assert sorted(os.listdir(tmp_path / "orbax")) == ["1", "2"]
    assert not os.path.exists(tmp_path / "checkpoint.pt")
    ck = load_fit_checkpoint(str(tmp_path / "orbax"), device="cpu")
    assert ck["epoch"] == 2 and set(ck["opt_states"]) == {"coarse", "app"}
    resumed, rhist = _port_fit(scene, config, params=ck["params"], resume=ck)
    assert [h["epoch"] for h in rhist] == [3]
    assert rhist[0]["loss"] == hist[3]["loss"]
    for k, p in unbroken.items():
        assert torch.equal(p.detach(), resumed[k].detach()), k


CLI = ["--synthetic", "--device", "cpu", "--n-frames", "2", "--img-size", "32",
       "--texture-size", "32", "--density", "light", "--stages", "1", "2", "2",
       "--epochs", "5", "--raster-cap", "2048", "--no-vgg",
       "--no-turntables", "--checkpoint-backend", "orbax"]


def test_cli_orbax_backend_and_resume_orbax(tmp_path):
    unbroken = str(tmp_path / "unbroken")
    fit_avatar.main(CLI + ["--out", unbroken])
    # The same fit killed after epoch 2, its checkpoint in orbax/ as the CLI
    # would write it with checkpoint_every=2.
    killed = str(tmp_path / "killed")
    args = fit_avatar.parse_args(CLI + ["--out", killed])
    config = fit_avatar._config(args)
    assert config.checkpoint_backend == "orbax"
    inputs = fit_avatar.load_inputs(args, config, torch.device("cpu"))
    params, aux = init_params(inputs["input_params"], inputs["assets"], config, device="cpu")
    fit_sequence(dataclasses.replace(config, total_epoch=3), inputs["assets"], inputs["data"],
                 params, aux, rcfg=config.raster_config(), out_dir=killed,
                 checkpoint_every=2, device="cpu")
    assert os.listdir(os.path.join(killed, "orbax")) == ["2"]
    resumed = str(tmp_path / "resumed")
    fit_avatar.main(CLI + ["--resume-orbax", killed, "--out", resumed])
    with open(os.path.join(unbroken, "saved_params.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(resumed, "saved_params.pkl"), "rb") as f:
        got = pickle.load(f)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _harp_tpu_orbax_fit(scene, out_dir: str) -> dict:
    """harp_tpu's 4-epoch fit (stages 1 / 3) with its Orbax checkpoint at
    epoch 2, the golden harp_tpu_orbax_fit.npz: the history and final
    parameters, and what the fit handed its checkpointer (`ckpt_epoch`,
    `ckpt_params`, the optimizer states' leaves in tree order `ckpt_opt`,
    `ckpt_scale`, `ckpt_plateau`, `ckpt_ref_verts`)."""
    from harp_tpu.utils.orbax_io import OrbaxCheckpointer as JOrbaxCheckpointer

    saved = []
    original = JOrbaxCheckpointer.save

    def save(self, step, params, opt_states, plateau_scale=1.0, extra=None):
        saved.append(dict(ckpt_epoch=step, ckpt_params=jax.tree.map(np.asarray, params),
                          ckpt_opt={f"{i:03d}": np.asarray(v)
                                    for i, v in enumerate(jax.tree.leaves(opt_states))},
                          ckpt_scale=plateau_scale, ckpt_plateau=dict(extra["plateau"]),
                          ckpt_ref_verts=np.asarray(extra["ref_verts"])))
        return original(self, step, params, opt_states, plateau_scale, extra=extra)

    jconfig = dataclasses.replace(scene["jconfig"], checkpoint_backend="orbax")
    jparams, jaux = jinit_params(scene["init"], scene["jassets"], jconfig)
    jdata = JFitData(*[jnp.asarray(a) for a in scene["arrays"]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JOrbaxCheckpointer, "save", save)
        jfinal, jhist = jfit_sequence(jconfig, scene["jassets"], jdata, jparams, jaux,
                                      rcfg=scene["jrcfg"], out_dir=out_dir, checkpoint_every=2,
                                      epoch_scan=0, prefetch_compile=False)
    assert [s["ckpt_epoch"] for s in saved] == [2]
    return goldens.pack(hist=jhist, param=jfinal, **saved[0])


def _write_harp_tpu_checkpoint(theirs: dict, jparams: dict, jconfig, out_dir: str) -> None:
    """harp_tpu's checkpointer writes the state its fit saved (the golden's
    `ckpt_*`) into out_dir, as the fit's own call did."""
    from harp_tpu.fit.optimizer import build_optimizers as jbuild_optimizers
    from harp_tpu.utils.orbax_io import OrbaxCheckpointer as JOrbaxCheckpointer

    _, states, _ = jbuild_optimizers(jparams, jconfig)
    leaves = goldens.part(theirs, "ckpt_opt")
    opt_states = jax.tree.unflatten(jax.tree.structure(states),
                                    [jnp.asarray(leaves[k]) for k in sorted(leaves)])
    params = {k: jnp.asarray(v) for k, v in goldens.part(theirs, "ckpt_params").items()}
    plateau = {k: v.item() for k, v in goldens.part(theirs, "ckpt_plateau").items()}
    with JOrbaxCheckpointer(out_dir) as ckpt:
        ckpt.save(int(theirs["ckpt_epoch"]), params, opt_states, float(theirs["ckpt_scale"]),
                  extra={"plateau": plateau, "ref_verts": theirs["ckpt_ref_verts"]})


@pytest.mark.slow
def test_harp_tpu_golden_of_the_orbax_fit_is_current(scene, tmp_path):
    def tolerance(k, want):  # test_a_harp_tpu_orbax_checkpoint_resumes_in_the_port's
        if k == "hist":
            return LOSS_ATOL + LOSS_RTOL * np.abs(want)
        if want.dtype.kind == "f" and k.split(".")[0] in ("param", "ckpt_params", "ckpt_opt",
                                                          "ckpt_ref_verts", "ckpt_plateau"):
            return PARAM_TOL * max(np.abs(want).max(), 1e-12)
        return None

    goldens.assert_current("harp_tpu_orbax_fit", _harp_tpu_orbax_fit(scene, str(tmp_path)),
                           tolerance)


def test_a_harp_tpu_orbax_checkpoint_resumes_in_the_port(scene, tmp_path):
    """harp_tpu fits 4 epochs (stages 1 / 3) and hands its Orbax
    checkpointer the state of epoch 2 (tests/test_checkpoint_orbax.py's
    recipe: the state a fit killed after that checkpoint leaves). That state
    is stored with the fit's results (_harp_tpu_orbax_fit), and here
    harp_tpu's checkpointer writes it; the fit's own writing as it runs is
    tested only in harp_tpu's suite. The port resumes from it for epoch 3
    and must end where harp_tpu ended."""
    jconfig = dataclasses.replace(scene["jconfig"], checkpoint_backend="orbax")
    jparams, _ = jinit_params(scene["init"], scene["jassets"], jconfig)
    template = {k: np.asarray(v) for k, v in jparams.items()}
    theirs = goldens.load("harp_tpu_orbax_fit")
    jhist, jfinal = goldens.part(theirs, "hist"), goldens.part(theirs, "param")
    _write_harp_tpu_checkpoint(theirs, jparams, jconfig, str(tmp_path))
    # The port's reader refuses harp_tpu's tree, naming the route below.
    with pytest.raises(ValueError, match="opt_states_from_numpy"):
        load_fit_checkpoint(str(tmp_path), device="cpu")

    payload = jload_fit_checkpoint(str(tmp_path), {k: jnp.asarray(v) for k, v in
                                                   template.items()}, jconfig)
    assert int(payload["epoch"]) == 2
    config = scene["config"]
    params = params_from_numpy({k: np.asarray(v) for k, v in payload["params"].items()}, "cpu")
    resume = {"epoch": int(payload["epoch"]), "plateau_scale": float(payload["plateau_scale"]),
              "opt_states": opt_states_from_numpy(payload["opt_states"], params, config, "cpu"),
              "extra": {"plateau": {k: np.asarray(v) for k, v in
                                    payload["extra"]["plateau"].items()},
                        "ref_verts": np.asarray(payload["extra"]["ref_verts"])}}
    # The converted Adam state: optax's count, mu and nu of each group's
    # leaves (coarse stepped in epochs 0-2, app in 1-2: one step an epoch).
    for g, opt in build_optimizers(params, config).items():
        opt.load_state_dict(resume["opt_states"][g])
        for p in opt.param_groups[0]["params"]:
            assert float(opt.state[p]["step"]) == {"coarse": 3.0, "app": 2.0}[g]
    resumed, rhist = _port_fit(scene, config, params=params, resume=resume)
    assert [h["epoch"] for h in rhist] == [3]
    for k in jhist[3]:
        np.testing.assert_allclose(rhist[0][k], float(jhist[3][k]), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    for k, p in resumed.items():
        want = np.asarray(jfinal[k])
        assert np.abs(p.detach().numpy() - want).max() <= PARAM_TOL * max(np.abs(want).max(),
                                                                           1e-12), k
