"""harp_tpu_torch's epoch scan (fit_sequence(epoch_scan=3)) against
harp_tpu's fused epoch scans, on the CPU, where the port's segment runner
runs its step eagerly (a CUDA graph only differs in the capture:
tests/test_torch_cuda.py, chip_smoke.py).

The scene: harp_tpu's synthetic sequence of the light-density hand, 4
frames at 32^2 in minibatches of 2 (2 steps an epoch), texture 64^2,
self-shadow, VGG in float32 from the cached GT pyramids, stages 2 / 2 / 3
in segments of 3 epochs ([0, 1], [2, 3], [4, 5, 6]: the first two end
with their stages), plateau patience 0 (the float32 plateau on the device
trips inside a segment), image logs and checkpoints every 2 epochs
(deferred to the segments' last epochs: labels 1, 3, 6 and 3, 6).
harp_tpu runs with prefetch_compile=False; its scan fit is read from
tests/golden/harp_tpu_scan_fit.npz (tests/_harp_goldens.py).

Tolerances. Seven epochs part the packages further than the two of the
loop parity test (tests/test_torch_fit_sequence.py, rtol 1e-3): near-edge
coverage pixels differ with XLA:CPU's FMA contraction, and Adam turns a
near-zero gradient's rounding into a whole step. Per-epoch loss and terms
rtol 2e-3 (measured: 1.4e-3 at most, normal_reg in the last epoch; the
loss 1.6e-4); the pose, shape and camera leaves within the loop parity's
1e-3 of their largest entry (measured 6e-5), every leaf within harp_tpu's
own scan-against-loop bound (tests/test_fit_e2e.py: rtol 2e-3, atol
epochs * 2 * lr + 2e-6; normal_map parts by 0.022); lr scales and
plateau trips exactly (the same float32 decisions). The port's own
checks are exact: the scan equals its per-step loop bit for bit while no
plateau trips (no float32 scale enters), a resumed scan fit equals the
unbroken one, and the device texture-reg offsets equal the host's.
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
from harp_tpu.fit import init_params as jinit_params
from harp_tpu.fit.driver import FitData as JFitData
from harp_tpu.fit.driver import fit_sequence as jfit_sequence
from harp_tpu.fit.optimizer import PlateauState as JPlateauState
from harp_tpu.fit.optimizer import plateau_update as jplateau_update
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy
from harp_tpu_torch.fit import driver
from harp_tpu_torch.fit.driver import FitData, fit_sequence, make_epoch_scan
from harp_tpu_torch.fit.optimizer import DevicePlateau, PlateauState, plateau_update_device
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.parallel import workers
from harp_tpu_torch.parallel.launch import launch
from harp_tpu_torch.render.rasterizer import RasterConfig
from harp_tpu_torch.utils.io import load_checkpoint

import _harp_goldens as goldens

IMG, TEX, N = 32, 64, 4
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=True, w_vgg=1.0, vgg_compute_dtype="float32", batch_size=2,
              training_stage=(2, 2, 3), total_epoch=7, plateau_patience=0)
RCFG_KW = dict(image_size=IMG, tile=8, cap=1024, face_chunk=256, faces_per_pixel=16,
               span_tiles=4, active_fraction=1.0)
SCAN = 3
LOGS = dict(image_log_every=2, checkpoint_every=2)

# The parity tolerances of the docstring, which the golden's regenerator reads
# too.
LOSS_RTOL, LOSS_ATOL = 2e-3, 1e-7  # each epoch's loss and terms
SCALE_RTOL = 1e-6  # each epoch's lr scale
PARAM_RTOL = 2e-3  # every leaf, beside _param_atol
CORE_LEAVES, CORE_TOL = ("pose", "shape", "cam"), 1e-3  # of the leaf's largest entry


def _param_atol(config) -> float:
    """harp_tpu's own scan-against-loop bound: two steps of the larger lr an
    epoch."""
    return config.total_epoch * 2 * max(config.lr_pose, config.lr_app) + 2e-6


@pytest.fixture(scope="module")
def scene():
    jassets = jbuild(uv_size=TEX, density="light")
    jconfig = JHarpConfig(**CFG_KW)
    jrcfg = JRasterConfig(**RCFG_KW)
    images, masks, masks_er, _, init = jmake_sequence(jassets, jconfig, jrcfg, n_frames=N,
                                                      seed=0)
    arrays = [np.asarray(a) for a in (images, masks, masks_er)]
    return dict(jassets=jassets, jconfig=jconfig, jrcfg=jrcfg, arrays=arrays, init=init,
                assets=assets_from_numpy(jassets), config=HarpConfig(**CFG_KW),
                rcfg=RasterConfig(**RCFG_KW))


def _data(scene) -> FitData:
    return FitData(*[torch.from_numpy(a.copy()) for a in scene["arrays"]])


def _port_fit(scene, config=None, **kw):
    config = config or scene["config"]
    params, aux = init_params(scene["init"], scene["assets"], config, device="cpu")
    return fit_sequence(config, scene["assets"], _data(scene), params, aux, rcfg=scene["rcfg"],
                        device="cpu", **kw)


def _metrics(out_dir) -> list:
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "loss" in r]


def _recording(labels: list, original):
    """save_checkpoint that also appends each checkpoint's epoch to labels."""
    def save(path, params, opt_states, epoch, *a, **k):
        labels.append(int(epoch))
        return original(path, params, opt_states, epoch, *a, **k)
    return save


def _harp_tpu_scan_fit(scene, out_dir: str) -> dict:
    """harp_tpu's scan fit of the scene, the golden harp_tpu_scan_fit.npz:
    its history and final parameters, the lr scale its metrics.jsonl logs
    for each epoch, its image logs and its checkpoint labels."""
    import harp_tpu.utils.io as jio

    labels = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jio, "save_checkpoint", _recording(labels, jio.save_checkpoint))
        jparams, jaux = jinit_params(scene["init"], scene["jassets"], scene["jconfig"])
        jdata = JFitData(*[jnp.asarray(a) for a in scene["arrays"]])
        jfinal, jhist = jfit_sequence(scene["jconfig"], scene["jassets"], jdata, jparams, jaux,
                                      rcfg=scene["jrcfg"], epoch_scan=SCAN,
                                      prefetch_compile=False, out_dir=out_dir, **LOGS)
    images = sorted(f[:-len(".jpg")] for f in os.listdir(out_dir) if f.endswith(".jpg"))
    return goldens.pack(hist=jhist, param=jfinal,
                        lr_scale=[r["lr_scale"] for r in _metrics(out_dir)], images=images,
                        checkpoint_labels=sorted(labels))


@pytest.mark.slow
def test_harp_tpu_golden_of_the_scan_fit_is_current(scene, tmp_path):
    atol = _param_atol(scene["config"])

    def tolerance(k, want):  # test_scan_epoch_losses..., lr_scales..., final_parameters...
        if k == "hist":
            return LOSS_ATOL + LOSS_RTOL * np.abs(want)
        if k == "lr_scale":
            return SCALE_RTOL * np.abs(want)
        if k[len("param."):] in CORE_LEAVES:
            return CORE_TOL * max(np.abs(want).max(), 1e-12)
        if k.startswith("param."):
            return atol + PARAM_RTOL * np.abs(want)
        return None

    goldens.assert_current("harp_tpu_scan_fit", _harp_tpu_scan_fit(scene, str(tmp_path)),
                           tolerance)


@pytest.fixture(scope="module")
def both(scene, tmp_path_factory):
    """harp_tpu's scan fit (stored, _harp_tpu_scan_fit) and the port's, each
    with its checkpoint labels."""
    import harp_tpu_torch.utils.io as pio

    labels = []
    out = str(tmp_path_factory.mktemp("port_scan"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pio, "save_checkpoint", _recording(labels, pio.save_checkpoint))
        params, hist = _port_fit(scene, epoch_scan=SCAN, out_dir=out, **LOGS)
    theirs = goldens.load("harp_tpu_scan_fit")
    return dict(jfinal=goldens.part(theirs, "param"), jhist=goldens.part(theirs, "hist"),
                jlr_scale=theirs["lr_scale"].tolist(), jimages=theirs["images"].tolist(),
                params=params, hist=hist, out=out,
                labels={"jax": theirs["checkpoint_labels"].tolist(), "port": labels})


def test_scan_epoch_losses_and_terms_match_harp_tpu(both):
    assert [h["epoch"] for h in both["hist"]] == list(range(7))
    assert len(both["jhist"]) == 7
    for ours, theirs in zip(both["hist"], both["jhist"]):
        assert set(ours) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(ours[k], float(theirs[k]), rtol=LOSS_RTOL,
                                       atol=LOSS_ATOL, err_msg=f"epoch {theirs['epoch']}: {k}")


def test_scan_lr_scales_and_plateau_trips_match_harp_tpu(both):
    """The float32 device plateau trips at harp_tpu's epochs, some of them
    inside a segment (not its last epoch), and every epoch logs its scale."""
    ours = [r["lr_scale"] for r in _metrics(both["out"])]
    theirs = both["jlr_scale"]
    assert len(ours) == len(theirs) == 7
    np.testing.assert_allclose(ours, theirs, rtol=SCALE_RTOL)
    trips = [e for e in range(7) if ours[e] != (ours[e - 1] if e else 1.0)]
    assert trips == [e for e in range(7) if theirs[e] != (theirs[e - 1] if e else 1.0)]
    assert set(trips) - {1, 3, 6}, f"no trip inside a segment: {trips}"


def test_scan_final_parameters_match_harp_tpu(both, scene):
    for k, p in both["params"].items():
        want = np.asarray(both["jfinal"][k])
        got = p.detach().numpy()
        np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=_param_atol(scene["config"]),
                                   err_msg=k)
        if k in CORE_LEAVES:
            assert np.abs(got - want).max() <= CORE_TOL * max(np.abs(want).max(), 1e-12), k


def test_scan_defers_logs_and_checkpoints_to_harp_tpus_labels(both):
    def logged(out_dir, ext):
        return sorted(f[:-len(ext)] for f in os.listdir(out_dir) if f.endswith(ext))

    assert logged(both["out"], ".jpg") == both["jimages"] == [
        "0001", "0003", "0006", "sil_0001", "sil_0003", "sil_0006"]
    assert both["labels"]["port"] == sorted(both["labels"]["jax"]) == [3, 6]
    lines = _metrics(both["out"])
    last = [r["epoch"] for r in lines if "segment_s" in r]
    assert last == [1.0, 3.0, 6.0]
    assert all(r["graph"] is False for r in lines if "segment_s" in r)


def test_device_plateau_update_matches_harp_tpus_scan(both):
    """plateau_update_device fed harp_tpu's scan losses (its float32 epoch
    means) gives the lr scales harp_tpu's scan logged, in coarse epochs;
    and on a sweep of losses its decisions equal the host update's."""
    state = DevicePlateau.of(PlateauState(), "cpu")
    theirs = both["jlr_scale"]
    for e, h in enumerate(both["jhist"][:4]):  # epochs 0-3: the coarse stages
        plateau_update_device(state, torch.tensor(np.float32(h["loss"])), patience=0)
        assert float(state.scale) == pytest.approx(theirs[e], rel=1e-6), e
    rng = np.random.RandomState(0)
    losses = np.abs(np.cumsum(rng.randn(200) * 0.01)) + 1.0
    state, host = DevicePlateau.of(PlateauState(), "cpu"), JPlateauState()
    for loss in losses.astype(np.float32):
        plateau_update_device(state, torch.tensor(loss), patience=3, factor=0.5)
        host = jplateau_update(host, float(loss), patience=3, factor=0.5)
        assert int(state.bad_epochs) == host.bad_epochs
        assert float(state.scale) == pytest.approx(host.scale, rel=1e-6)
        assert float(state.best) == pytest.approx(host.best, rel=1e-7)


@pytest.mark.parametrize("step", [0, 7, 13])
def test_device_texture_reg_offsets_equal_the_host_version(step):
    sub = driver._key_stream_np(3, 14)[step]
    host = driver.texture_reg_offsets(sub, 40, 24, "cpu")
    dev = driver.texture_reg_offsets(torch.tensor(sub.astype(np.int64)), 40, 24, "cpu")
    for a, b in zip(host, dev):
        assert torch.equal(a, b)


def test_scan_is_the_per_step_loop_bit_for_bit_without_a_trip(scene):
    """With the default patience nothing trips in 5 epochs: the scan's
    steps, sums and history are the loop's, bit for bit."""
    config = dataclasses.replace(scene["config"], plateau_patience=40, training_stage=(2, 2, 1),
                                 total_epoch=5, w_vgg=0.0)
    loop, lhist = _port_fit(scene, config)
    scan, shist = _port_fit(scene, config, epoch_scan=SCAN)
    assert lhist == shist
    for k, p in loop.items():
        assert torch.equal(p, scan[k]), k


def test_resumed_scan_fit_equals_the_unbroken_one(scene, both, tmp_path):
    """Stopped after its epoch-3 checkpoint and resumed from it: epochs 4
    to 6 in one segment, the same bits as the unbroken scan fit."""
    _port_fit(scene, dataclasses.replace(scene["config"], total_epoch=4), epoch_scan=SCAN,
              out_dir=str(tmp_path), checkpoint_every=2)
    ck = load_checkpoint(str(tmp_path / "checkpoint.pt"))
    assert ck["epoch"] == 3
    _, aux = init_params(scene["init"], scene["assets"], scene["config"], device="cpu")
    resumed, rhist = fit_sequence(scene["config"], scene["assets"], _data(scene), ck["params"],
                                  aux, rcfg=scene["rcfg"], resume=ck, device="cpu",
                                  epoch_scan=SCAN)
    assert [h["epoch"] for h in rhist] == [4, 5, 6]
    assert rhist == both["hist"][4:]
    for k, p in both["params"].items():
        assert torch.equal(p.detach(), resumed[k].detach()), k


def test_a_callback_forces_the_per_step_loop(scene, tmp_path):
    config = dataclasses.replace(scene["config"], training_stage=(1, 1, 1), total_epoch=3,
                                 w_vgg=0.0)
    seen = []
    _, hist = _port_fit(scene, config, epoch_scan=SCAN, out_dir=str(tmp_path),
                        callback=lambda e, p, h: seen.append((e, h["loss"])))
    assert seen == [(h["epoch"], h["loss"]) for h in hist] and len(seen) == 3
    assert not any("segment_s" in r for r in _metrics(tmp_path))


def test_make_epoch_scan_takes_a_graph_on_cuda_only(scene):
    params, aux = init_params(scene["init"], scene["assets"], scene["config"], device="cpu")
    step = driver.make_train_step(scene["assets"], scene["config"], scene["rcfg"], params,
                                  device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        make_epoch_scan(step, _data(scene), aux, None, DevicePlateau.of(PlateauState(), "cpu"),
                        coarse_on=True, app_on=True, epochs=2, steps=2, batch=2, graph=True)


READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__", "__index__",
         "nonzero")


def _host_reads(mp) -> list:
    """Patch torch so that what would copy from the host or read the device
    on a card (and so cannot be captured) is recorded, in the forward and
    the backward alike: a tensor made from host data, a read of a tensor's
    values. Returns the record."""
    seen = []

    def making(name, original):
        def make(data, *a, **k):
            if not isinstance(data, torch.Tensor):
                seen.append(name)
            return original(data, *a, **k)
        return make

    def reading(name, original):
        def read(self, *a, **k):
            seen.append(name)
            return original(self, *a, **k)
        return read

    for name in ("tensor", "as_tensor", "from_numpy"):
        mp.setattr(torch, name, making(name, getattr(torch, name)))

    def new_tensor(self, data, *a, **k):
        seen.append("new_tensor")
        return original_new_tensor(self, data, *a, **k)

    original_new_tensor = torch.Tensor.new_tensor
    mp.setattr(torch.Tensor, "new_tensor", new_tensor)
    for name in READS:
        mp.setattr(torch.Tensor, name, reading(name, getattr(torch.Tensor, name)))
    return seen


def _host_reads_of_a_scan_step(assets, config, rcfg, init, data, flags, extras=None) -> list:
    """What the scan's second step records (_host_reads): forward, backward
    and the lr write, after a warm-up step that puts the constants on the
    device. The Adam update itself is torch's capturable one on the card
    (the CPU's plain Adam reads its step count, so it is left out)."""
    params, aux = init_params(init, assets, config, device="cpu")
    step = driver.make_train_step(assets, config, rcfg, params, device="cpu", extras=extras)
    for opt in step.optimizers.values():
        opt.step = lambda: None
    coarse = step.optimizers["coarse"].param_groups[0]
    coarse["lr"] = torch.tensor(coarse["lr"])  # the card's lr tensor
    with torch.no_grad():
        ref_verts = driver.pipeline.mesh_forward(params, torch.zeros(1, dtype=torch.long),
                                                 assets, config)[0][0]
    scan = make_epoch_scan(step, data, aux, ref_verts, DevicePlateau.of(PlateauState(), "cpu"),
                           coarse_on=flags[0], app_on=flags[1], epochs=1, steps=2, batch=2,
                           graph=False)
    scan.fids_es.copy_(torch.tensor([[0, 1], [1, 0]]))
    scan.keys_es.copy_(torch.from_numpy(driver._key_stream_np(0, 2).astype(np.int64)))
    scan._body()  # the warm-up
    with pytest.MonkeyPatch.context() as mp:
        seen = _host_reads(mp)
        scan._body()
    assert int(scan.cursor) == 2
    return seen


@pytest.mark.parametrize("flags", [(True, False), (True, True), (False, True)])
def test_the_scan_step_reads_nothing_from_the_host(scene, flags):
    """The scan's step makes no tensor from host data and reads no value:
    on the card each would copy or synchronise, which a capture refuses."""
    config = dataclasses.replace(scene["config"], w_vgg=0.0)
    assert _host_reads_of_a_scan_step(scene["assets"], config, scene["rcfg"], scene["init"],
                                      _data(scene), flags) == []


@pytest.mark.parametrize("family", ["arm", "html", "nimble"])
def test_the_scan_step_of_every_model_reads_nothing_from_the_host(family):
    """The same for the SMPL-X arm, HTML (its texture basis in extras) and
    NIMBLE, at stage 2, on their synthetic sequences (2 frames at 32^2)."""
    from harp_tpu_torch.assets import build_synthetic_arm_assets
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.models.zoo import load_hand_model

    config = HarpConfig(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=32,
                        self_shadow=True, w_vgg=0.0, batch_size=2, use_arm=family == "arm",
                        model_type="harp" if family == "arm" else family)
    rcfg = RasterConfig(**dict(RCFG_KW, cap=2048))
    if family == "arm":
        assets, extras = build_synthetic_arm_assets(uv_size=32, density="light"), None
    else:
        assets, extras = load_hand_model(config, synthetic=True)
    images, masks, masks_er, _, init = make_synthetic_sequence(assets, config, rcfg,
                                                              n_frames=2, seed=0, device="cpu")
    assert _host_reads_of_a_scan_step(assets, config, rcfg, init,
                                      FitData(images, masks, masks_er), (True, True),
                                      extras) == []


def test_scan_on_a_two_rank_gloo_mesh_tracks_the_unsharded_scan(scene):
    """fit_sequence(mesh=2 gloo ranks, epoch_scan=2): each rank one frame
    of each minibatch, the segments eager; within the mesh test's bound of
    the unsharded scan fit (tests/test_torch_parallel.py)."""
    config = dataclasses.replace(scene["config"], training_stage=(2, 1, 1), total_epoch=4,
                                 w_vgg=0.0, plateau_patience=40)
    mesh_scene = {"assets": scene["assets"], "config": config, "rcfg": scene["rcfg"],
                  "init": scene["init"], "frames": tuple(scene["arrays"])}
    run = launch(workers.fit_sequence_on_mesh, 2, mesh_scene, 1, 2, devices=["cpu"] * 2)
    run = run["runs"][0]
    want, whist = _port_fit(scene, config, epoch_scan=2)
    assert [h["epoch"] for h in run["history"]] == [0, 1, 2, 3]
    assert [r["graph"] for r in run["segments"]] == [False] * 3  # gloo: eager segments
    for a, b in zip(whist, run["history"]):
        assert set(a) == set(b)
        for k in a:  # loss terms the mean over the ranks, overflow counters the sum
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-8, err_msg=k)
    lr = max(config.lr_pose, config.lr_app)
    for k, w in want.items():
        np.testing.assert_allclose(run["params"][k], w.detach().numpy(), rtol=2e-4,
                                   atol=4 * 2 * 3 * lr + 2e-6, err_msg=k)
