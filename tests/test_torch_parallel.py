"""harp_tpu_torch.parallel on the CPU: meshes of gloo ranks spawned by
parallel.launch (one intra-op thread each).

- make_mesh's layout, global_batch_mesh's (sequences, frames) axes over 4
  ranks, and initialize_distributed's no-op, warning and raise.
- neighbor_shift over 2 and 4 ranks: x[fid - 1] and x[fid + 1], clamped at
  the sequence's ends (harp_tpu's tests/test_parallel.py).
- A shared parameter's gradient averaged over 2 ranks, each on its frames,
  equals the one-process gradient.
- fit_sequence(mesh=2 ranks) tracks the port's unsharded fit: loss rtol
  1e-4, parameters within harp_tpu's bound for a sharded fit (Adam
  normalises each gradient by its RMS, so an element whose gradient is
  rounding noise may step either way: steps * 3 * lr + 2e-6).
- The uneven-batch guard, and the CLI with --mesh-devices 2 --device cpu.

The gloo groups are spawned once per mesh size (module fixtures): each
spawn costs seconds.
"""

import dataclasses
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

from harp_tpu_torch import fit_avatar
from harp_tpu_torch.assets import build_synthetic_assets
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.data.synthetic import make_synthetic_sequence
from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, FitData, fit_sequence
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.parallel import (
    FRAME_AXIS, SEQUENCE_AXIS, Mesh, initialize_distributed, make_mesh,
)
from harp_tpu_torch.parallel import workers
from harp_tpu_torch.parallel.launch import launch
from harp_tpu_torch.render.rasterizer import RasterConfig

N = 4  # frames of the fit, one minibatch
CONFIG = HarpConfig(img_size=32, focal_length=2000.0 * 32 / 448.0, texture_size=32,
                    self_shadow=True, w_vgg=0.0, batch_size=N, total_epoch=3,
                    training_stage=(1, 1, 1))
RCFG = RasterConfig(image_size=32, tile=8, cap=1024, face_chunk=256, faces_per_pixel=8,
                    span_tiles=4, active_fraction=1.0)
X = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
SHARED = np.asarray([0.3, -0.2, 0.5, 0.1], np.float32)
FRAMES = np.arange(N * 4, dtype=np.float32).reshape(N, 4) / 10.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    assets = build_synthetic_assets(uv_size=32, density="light")
    images, masks, masks_er, _, init = make_synthetic_sequence(
        assets, CONFIG, RCFG, n_frames=N, seed=0, device="cpu")
    return {"assets": assets, "config": CONFIG, "rcfg": RCFG, "init": init,
            "frames": tuple(a.numpy() for a in (images, masks, masks_er))}


@pytest.fixture(scope="module")
def two_ranks(scene):
    return launch(workers.run_all, 2, [(workers.neighbor_shift_on_mesh, (X,)),
                                       (workers.shared_gradient_on_mesh, (SHARED, FRAMES)),
                                       (workers.fit_sequence_on_mesh, (scene,))],
                  devices=["cpu"] * 2)


@pytest.fixture(scope="module")
def four_ranks():
    return launch(workers.run_all, 4, [(workers.neighbor_shift_on_mesh, (X,)),
                                       (workers.batch_mesh_layout, (2,))],
                  devices=["cpu"] * 4)


def _clamped(x):
    fid = np.arange(x.shape[0])
    return x[np.maximum(fid - 1, 0)], x[np.minimum(fid + 1, x.shape[0] - 1)]


def test_make_mesh_in_one_process_starts_and_ends_its_group():
    with make_mesh(device="cpu") as mesh:
        assert torch.distributed.is_initialized()
        assert (mesh.world_size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        assert mesh.axis_names == (FRAME_AXIS,) and mesh.shape == (1,)
        assert mesh.device == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="2 processes"):
        make_mesh(2, device="cpu")
    with pytest.raises((RuntimeError, ValueError), match="NCCL"):  # no quiet switch to gloo
        make_mesh(device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()


def test_global_batch_mesh_axes_over_four_ranks(four_ranks):
    layout = four_ranks[1]
    assert [r["axis_names"] for r in layout] == [(SEQUENCE_AXIS, FRAME_AXIS)] * 4
    assert [r["shape"] for r in layout] == [(2, 2)] * 4
    assert [r["coords"] for r in layout] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # Each rank's frame line is its row, its sequence line its column.
    assert [r["lines"][FRAME_AXIS] for r in layout] == [(0, 1), (0, 1), (2, 3), (2, 3)]
    assert [r["lines"][SEQUENCE_AXIS] for r in layout] == [(0, 2), (1, 3), (0, 2), (1, 3)]
    # A frame-axis sum runs inside each row only.
    assert [r["frame_sum"] for r in layout] == [1.0, 1.0, 5.0, 5.0]


def test_initialize_distributed_noop_warning_and_raise(monkeypatch):
    def no_init(*a, **k):
        raise AssertionError("init_process_group called")

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "init_process_group", no_init)
    initialize_distributed()  # a group exists: nothing to do
    monkeypatch.undo()

    for v in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(torch.distributed, "init_process_group", no_init)
    with pytest.warns(RuntimeWarning, match="single-process"):
        initialize_distributed(backend="gloo")
    monkeypatch.undo()

    # A launcher's variables without its rendezvous address: fatal, not one
    # process fitting alone.
    for v in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="WORLD_SIZE"):
            initialize_distributed(backend="gloo")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("ranks", [2, 4])
def test_neighbor_shift_matches_clamped_indexing(ranks, two_ranks, four_ranks):
    left, right = (two_ranks if ranks == 2 else four_ranks)[0]
    want_left, want_right = _clamped(X)
    np.testing.assert_array_equal(left, want_left)
    np.testing.assert_array_equal(right, want_right)


def test_neighbor_shift_on_one_rank_is_the_local_shift():
    with make_mesh(device="cpu") as mesh:
        from harp_tpu_torch.parallel import neighbor_shift

        left, right = neighbor_shift(mesh, torch.from_numpy(X))
    want_left, want_right = _clamped(X)
    np.testing.assert_array_equal(left.numpy(), want_left)
    np.testing.assert_array_equal(right.numpy(), want_right)


def test_shared_gradient_over_ranks_equals_one_process(two_ranks):
    shared = torch.tensor(SHARED, requires_grad=True)
    (torch.sin(torch.from_numpy(FRAMES) * shared).sum() / N).backward()
    np.testing.assert_allclose(two_ranks[1], shared.grad.numpy(), rtol=1e-6)


@pytest.fixture(scope="module")
def unsharded(scene):
    params, aux = init_params(scene["init"], scene["assets"], CONFIG, device="cpu")
    data = FitData(*[torch.from_numpy(a.copy()) for a in scene["frames"]])
    params, hist = fit_sequence(CONFIG, scene["assets"], data, params, aux, rcfg=RCFG,
                                device="cpu")
    return {k: v.detach().numpy() for k, v in params.items()}, hist


def test_fit_sequence_on_two_ranks_tracks_the_unsharded_fit(two_ranks, unsharded):
    run = two_ranks[2]["runs"][0]
    want_params, want_hist = unsharded
    assert len(run["history"]) == len(want_hist) == 3
    for a, b in zip(want_hist, run["history"]):
        assert set(a) == set(b)
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
        for k in OVERFLOW_KEYS:  # summed over the ranks
            assert b.get(k, 0.0) == a.get(k, 0.0) == 0.0, k
    lr = max(CONFIG.lr_pose, CONFIG.lr_app)
    for k, want in want_params.items():
        np.testing.assert_allclose(run["params"][k], want, rtol=2e-4, atol=3 * 3 * lr + 2e-6,
                                   err_msg=f"param {k} diverged on two ranks")
    # Both ranks ran the whole step (the plain versions, on the CPU).
    launches = two_ranks[2]["launches"]
    assert len(launches) == 2 and launches[0] == launches[1]


def test_fit_sequence_mesh_rejects_an_uneven_batch_and_a_foreign_mesh(scene):
    params, aux = init_params(scene["init"], scene["assets"], CONFIG, device="cpu")
    data = FitData(*[torch.from_numpy(a.copy()) for a in scene["frames"]])
    uneven = dataclasses.replace(CONFIG, batch_size=3)
    mesh = Mesh(world_size=4, rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="divisible"):
        fit_sequence(uneven, scene["assets"], data, params, aux, rcfg=RCFG, mesh=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        fit_sequence(CONFIG, scene["assets"], data, params, aux, rcfg=RCFG, mesh=object(),
                     device="cpu")


CLI = ["--synthetic", "--device", "cpu", "--n-frames", "2", "--img-size", "32",
       "--texture-size", "32", "--density", "light", "--stages", "1", "1", "1",
       "--epochs", "3", "--raster-cap", "2048", "--no-vgg", "--batch-size", "2",
       "--no-turntables"]


def test_cli_mesh_devices_on_cpu_ranks(tmp_path):
    one = fit_avatar.main(CLI + ["--out", str(tmp_path / "one")])
    two = fit_avatar.main(CLI + ["--mesh-devices", "2", "--out", str(tmp_path / "two")])
    assert one["ranks"] == 1 and two["ranks"] == 2
    np.testing.assert_allclose(two["final_loss"], one["final_loss"], rtol=1e-4)
    for name in ("config.yaml", "metrics.jsonl", "saved_params.pkl", "fit_summary.json",
                 "eval_results.txt"):
        assert os.path.exists(tmp_path / "two" / name), name
    with open(tmp_path / "one" / "saved_params.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "two" / "saved_params.pkl", "rb") as f:
        got = pickle.load(f)
    lr = max(CONFIG.lr_pose, CONFIG.lr_app)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=3 * 3 * lr + 2e-6,
                                   err_msg=k)
