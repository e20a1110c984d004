"""harp_tpu_torch's rotations, MANO, synthetic assets and mesh_forward vs
the reference goldens and harp_tpu.

Goldens at the tolerances of tests/test_golden_parity.py (atol 2e-6 on
rotations, 1e-2 mm on MANO); the synthetic asset arrays must be exactly
equal (both are the same numpy code); mesh_forward to float32 tolerance
(rtol 1e-5, atol 1e-6 m).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.assets import build_synthetic_assets as jbuild
from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.render import pipeline as jpipeline
from harp_tpu_torch.assets import build_synthetic_assets
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy, params_from_numpy
from harp_tpu_torch.models.mano import JOINT_REORDER, TIPS_RIGHT, ManoModel, mano_forward
from harp_tpu_torch.ops.rotations import axis_angle_to_matrix, rot6d_to_matrix
from harp_tpu_torch.render import pipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_rotations_match_goldens():
    g = np.load(os.path.join(GOLDEN, "rotations_golden.npz"))
    got = axis_angle_to_matrix(torch.from_numpy(np.asarray(g["axisang"], np.float32)))
    np.testing.assert_allclose(got.numpy(), g["rodrigues_out"], atol=2e-6)
    got = rot6d_to_matrix(torch.from_numpy(np.asarray(g["ortho6d"], np.float32)))
    np.testing.assert_allclose(got.numpy(), g["rot6d_out"], atol=2e-6)


def test_mano_forward_matches_golden():
    g = np.load(os.path.join(GOLDEN, "mano_golden.npz"))
    for i in range(int(g["n_cases"])):
        config = bytes(g[f"case{i}_config"]).decode()
        use_pca = config.startswith("pca")
        model = ManoModel(
            v_template=g["model_v_template"], shapedirs=g["model_shapedirs"],
            posedirs=g["model_posedirs"], J_regressor=g["model_J_regressor"],
            weights=g["model_weights"], faces=g["model_faces"].astype(np.int32),
            parents=g["model_kintree_parents"],
            hands_components=g["model_hands_components"],
            hands_mean=g["model_hands_mean"], tips_idx=TIPS_RIGHT,
            joint_reorder=JOINT_REORDER, use_pca=use_pca,
            ncomps=6 if use_pca else 45, flat_hand_mean=(config == "aa_flat"))
        t = [torch.from_numpy(np.asarray(g[f"case{i}_{k}"], np.float32))
             for k in ("pose", "betas", "trans")]
        verts, joints = mano_forward(model, *t)
        assert np.abs(verts.numpy() - g[f"case{i}_verts"]).max() < 1e-2, config
        assert np.abs(joints.numpy() - g[f"case{i}_joints"]).max() < 1e-2, config


def _assert_dataclass_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _assert_dataclass_equal(x, y)
        elif isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_reference_density_assets_equal_exactly():
    ours, theirs = build_synthetic_assets(uv_size=64, density="reference"), \
        jbuild(uv_size=64, density="reference")
    assert ours.num_render_verts == theirs.num_render_verts
    assert ours.render_faces.shape == (6152, 3)
    _assert_dataclass_equal(ours, theirs)
    _assert_dataclass_equal(assets_from_numpy(theirs), theirs)


def test_mesh_forward_matches_harp_tpu():
    theirs = jbuild(uv_size=32, density="light")
    assets = assets_from_numpy(theirs)
    n = 3
    rng = np.random.RandomState(4)
    raw = {
        "pose": 0.3 * rng.randn(n, 45), "rot": 0.2 * rng.randn(n, 3),
        "trans": 0.01 * rng.randn(n, 3), "shape": 0.3 * rng.randn(10),
        "cam": np.tile([6.0, -0.08, -0.01], (n, 1)),
        "verts_disps": 0.002 * rng.randn(assets.num_render_verts, 1),
    }
    fids = np.array([2, 0, 1])
    jv, jj = jpipeline.mesh_forward({k: jnp.asarray(v, jnp.float32) for k, v in raw.items()},
                                    jnp.asarray(fids), theirs, JHarpConfig())
    pv, pj = pipeline.mesh_forward(params_from_numpy(raw, "cpu"), torch.from_numpy(fids),
                                   assets, HarpConfig())
    np.testing.assert_allclose(pv.detach().numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pj.detach().numpy(), np.asarray(jj), rtol=1e-5, atol=1e-3)
