"""harp_tpu_torch.preprocess vs harp_tpu.preprocess on the CPU.

- remove_spike: the same rows, bit for bit.
- The three fits to vertices (MANO, the SMPL-X arm, NIMBLE) and both
  smoothers at 20 + 20 iterations, from the same targets: every output
  within 1e-3 of its leaf's largest entry. The port's Adam is written out
  as optax's is; float32 sums in other orders (and XLA:CPU's FMA
  contraction) part the two trajectories slowly, so parity is held at a
  short length.
- At harp_tpu's own test lengths (150 / 400, two tries) the MANO fit
  recovers the vertices: fit error under 10 mm^2 and mean error under 3 mm
  (tests/test_preprocess.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.assets import build_synthetic_arm as jbuild_arm
from harp_tpu.assets import build_synthetic_hand as jbuild_hand
from harp_tpu.models.mano import mano_forward as jmano_forward
from harp_tpu.models.nimble import build_synthetic_nimble as jbuild_nimble
from harp_tpu.models.nimble import nimble_forward as jnimble_forward
from harp_tpu.models.nimble import nimble_to_mano as jnimble_to_mano
from harp_tpu.models.smplx_arm import smplx_arm_forward as jsmplx_arm_forward
from harp_tpu import preprocess as jpre
from harp_tpu_torch import preprocess as pre
from harp_tpu_torch.assets import build_synthetic_arm, build_synthetic_hand
from harp_tpu_torch.models.mano import mano_forward
from harp_tpu_torch.models.nimble import build_synthetic_nimble


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours: dict, theirs: dict, keys, rtol=1e-3):
    for k in keys:
        want, got = _np(theirs[k]), _np(ours[k])
        assert got.shape == want.shape, k
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= rtol * scale, (k, np.abs(got - want).max(), scale)


def _mano_targets(model_j, B=2, seed=0):
    rng = np.random.RandomState(seed)
    pose = np.zeros((B, 48), np.float32)
    pose[:, 3:] = 0.3 * rng.randn(B, 45)
    pose[:, :3] = 0.2 * rng.randn(B, 3)
    betas = (0.3 * rng.randn(B, 10)).astype(np.float32)
    trans = (0.05 * rng.randn(B, 3)).astype(np.float32)
    target, _ = jmano_forward(model_j, jnp.asarray(pose), jnp.asarray(betas), jnp.asarray(trans))
    return np.asarray(target)


FIT_KEYS = ("rot", "pose", "shape", "trans", "verts", "joints")


def test_remove_spike_is_exact():
    rng = np.random.RandomState(3)
    pose = (0.2 * rng.randn(12, 45)).astype(np.float32)
    pose[4] += 3.0
    pose[9] -= 2.0
    pose[10] += 0.05
    want = np.asarray(jpre.remove_spike(jnp.asarray(pose)))
    got = pre.remove_spike(torch.from_numpy(pose)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(want[4], pose[4])  # the spike was replaced


def test_fit_mano_to_vertices_matches_harp_tpu():
    target = _mano_targets(jbuild_hand())
    theirs = jpre.fit_mano_to_vertices(jbuild_hand(), jnp.asarray(target), epoch_coarse=20,
                                       epoch_fine=20, max_tries=1)
    ours = pre.fit_mano_to_vertices(build_synthetic_hand(), target, epoch_coarse=20,
                                    epoch_fine=20, max_tries=1, device="cpu")
    _close(ours, theirs, FIT_KEYS)
    assert abs(ours["fit_error"] - theirs["fit_error"]) <= 1e-3 * abs(theirs["fit_error"])


def test_fit_arm_to_vertices_matches_harp_tpu():
    jmodel = jbuild_arm()
    rng = np.random.RandomState(2)
    B = 2
    shape = (0.2 * rng.randn(B, 10)).astype(np.float32)
    rot = (0.15 * rng.randn(B, 3)).astype(np.float32)
    trans = (0.03 * rng.randn(B, 3)).astype(np.float32)
    pose = (0.25 * rng.randn(B, 45)).astype(np.float32)
    target, _ = jsmplx_arm_forward(jmodel, jnp.asarray(shape), jnp.asarray(rot),
                                   jnp.asarray(trans), jnp.asarray(pose), jnp.zeros((B, 3)),
                                   return_type="mano")
    theirs = jpre.fit_arm_to_vertices(jmodel, target, epoch_coarse=20, epoch_fine=20,
                                      max_tries=1)
    ours = pre.fit_arm_to_vertices(build_synthetic_arm(), np.asarray(target), epoch_coarse=20,
                                   epoch_fine=20, max_tries=1, device="cpu")
    _close(ours, theirs, FIT_KEYS)
    assert ours["joints"].shape[1] == np.asarray(theirs["joints"]).shape[1] >= 21


def test_fit_nimble_to_vertices_matches_harp_tpu():
    jmodel = jbuild_nimble()
    rng = np.random.RandomState(4)
    B = 2
    posed = np.zeros((B, 3 + jmodel.ncomps), np.float32)
    posed[:, :3] = 0.15 * rng.randn(B, 3)
    posed[:, 3:] = 0.3 * rng.randn(B, jmodel.ncomps)
    shape = (0.2 * rng.randn(B, jmodel.nshape)).astype(np.float32)
    trans = (0.03 * rng.randn(B, 3)).astype(np.float32)
    skin, _ = jnimble_forward(jmodel, jnp.asarray(posed), jnp.asarray(shape), jnp.asarray(trans))
    target = np.asarray(jnimble_to_mano(jmodel, skin))
    theirs = jpre.fit_nimble_to_vertices(jmodel, jnp.asarray(target), epoch_coarse=20,
                                         epoch_fine=20)
    ours = pre.fit_nimble_to_vertices(build_synthetic_nimble(), target, epoch_coarse=20,
                                      epoch_fine=20, device="cpu")
    _close(ours, theirs, FIT_KEYS)


def _jittery_params(model_j, n=8, seed=1):
    rng = np.random.RandomState(seed)
    base = 0.2 * rng.randn(1, 45)
    params = {
        "rot": (0.1 * rng.randn(n, 3)).astype(np.float32),
        "pose": (base + 0.05 * rng.randn(n, 45)).astype(np.float32),
        "shape": np.zeros((n, 10), np.float32),
        "trans": (0.01 * rng.randn(n, 3)).astype(np.float32),
        "cam": (np.tile([5.0, 0.0, 0.0], (n, 1)) + 0.02 * rng.randn(n, 3)).astype(np.float32),
    }
    _, joints = jmano_forward(model_j, jnp.asarray(np.concatenate(
        [params["rot"], params["pose"]], 1)), jnp.asarray(params["shape"]),
        jnp.asarray(params["trans"]))
    # METRO's joints are not the fitted model's: with joints equal to the
    # forward's, the end frames' anchor gradient would be rounding noise,
    # which Adam normalises into full steps of either sign.
    params["joints"] = np.asarray(joints) + rng.randn(*joints.shape).astype(np.float32)
    return params


def test_smooth_pose_sequence_matches_harp_tpu():
    params = _jittery_params(jbuild_hand())
    theirs = jpre.smooth_pose_sequence(jbuild_hand(), params, total_iters=20)
    ours = pre.smooth_pose_sequence(build_synthetic_hand(), params, total_iters=20,
                                    device="cpu")
    _close(ours, theirs, ("rot", "pose", "shape", "verts", "joints"))
    # The penalty must have moved the poses (parity of a no-op proves little).
    assert np.abs(_np(ours["pose"]) - params["pose"]).max() > 1e-4


def test_smooth_pose_sequence_early_stop_matches_harp_tpu():
    """A relative stop that fires inside the run (the running average
    starts at 1e9 and halves toward the loss: at 5.0 it fires at iteration 30
    here): both packages keep the same parameters, which differ from
    the run without a stop."""
    params = _jittery_params(jbuild_hand(), seed=2)
    theirs = jpre.smooth_pose_sequence(jbuild_hand(), params, total_iters=45,
                                       early_stop_rel=5.0)
    ours = pre.smooth_pose_sequence(build_synthetic_hand(), params, total_iters=45,
                                    early_stop_rel=5.0, device="cpu")
    _close(ours, theirs, ("rot", "pose", "shape"))
    unstopped = pre.smooth_pose_sequence(build_synthetic_hand(), params, total_iters=45,
                                         early_stop_rel=None, device="cpu")
    assert np.abs(_np(unstopped["pose"]) - _np(ours["pose"])).max() > 1e-5


def test_smooth_camera_sequence_matches_harp_tpu():
    params = _jittery_params(jbuild_hand())
    theirs = jpre.smooth_camera_sequence(jbuild_hand(), params, total_iters=20)
    ours = pre.smooth_camera_sequence(build_synthetic_hand(), params, total_iters=20,
                                      device="cpu")
    _close(ours, theirs, ("cam",))
    assert np.abs(_np(ours["cam"]) - params["cam"]).max() > 1e-5


def test_fit_mano_recovers_vertices_at_harp_tpus_test_lengths():
    model = build_synthetic_hand()
    rng = np.random.RandomState(0)
    B = 2
    pose = np.zeros((B, 48), np.float32)
    pose[:, 3:] = 0.3 * rng.randn(B, 45)
    pose[:, :3] = 0.2 * rng.randn(B, 3)
    betas = (0.3 * rng.randn(B, 10)).astype(np.float32)
    trans = (0.05 * rng.randn(B, 3)).astype(np.float32)
    target, _ = mano_forward(model, torch.from_numpy(pose), torch.from_numpy(betas),
                             torch.from_numpy(trans))
    out = pre.fit_mano_to_vertices(model, target, epoch_coarse=150, epoch_fine=400,
                                   max_tries=2, device="cpu")
    assert out["fit_error"] <= 10.0, out["fit_error"]
    assert out["pose"].shape == (B, 45)
    assert (out["verts"] - target).abs().mean() < 3.0


def test_preprocess_entry_points_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pre.fit_mano_to_vertices(build_synthetic_hand(), np.zeros((1, 778, 3)), 1, 1)
