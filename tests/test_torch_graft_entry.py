"""harp_tpu_torch.graft_entry against the repository's __graft_entry__.py,
on the CPU.

- The forward (mesh forward, soft silhouette, shadowed RGB render) of the
  flagship scene built by both _build functions at 64^2 and texture 64^2,
  2 frames at reference density: joints rtol 1e-5; alpha and RGB within
  2e-4 of 1 on all but 0.5% of the pixels (XLA:CPU contracts FMAs near
  triangle edges, the port rounds every product: tests/test_torch_raster.py's
  bound), and within 0.05 everywhere.
- entry(device="cpu"): the flagship's 448^2 parameters, as __graft_entry__'s.
- dryrun_multichip(2): the frame-sharded fit over two gloo ranks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as J
from harp_tpu.render import pipeline as jpipeline
from harp_tpu.render.shadow import render_rgb_with_shadow as jrender_rgb_with_shadow
from harp_tpu_torch import graft_entry


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jforward(assets, config, rcfg, params, fids):
    verts, joints = jpipeline.mesh_forward(params, fids, assets, config)
    R, T = jpipeline.camera_for_frames(params, fids, config)
    alpha = jpipeline.render_silhouette(verts, assets, R, T, config, rcfg)
    rgb = jrender_rgb_with_shadow(verts, assets, config, rcfg, params["cam"][fids],
                                  params["light_positions"][fids], params["amb_ratio"],
                                  params["texture"], params["normal_map"])
    return alpha, rgb, joints


def test_forward_matches_harp_tpus_entry_at_64():
    kw = dict(raster_kw=dict(cap=448, span_tiles=4))
    jscene = J._build(64, 64, 2, **kw)
    want = [np.asarray(a) for a in _jforward(*jscene, jnp.asarray([0, 1]))]
    assets, config, rcfg, params = graft_entry._build(64, 64, 2, device="cpu", **kw)
    for k, v in jscene[3].items():
        np.testing.assert_array_equal(params[k].detach().numpy(), np.asarray(v), err_msg=k)
    with torch.no_grad():
        got = [t.numpy() for t in graft_entry.make_forward(assets, config, rcfg)(
            params, torch.arange(2))]
    alpha, rgb, joints = got
    assert alpha.shape == (2, 64, 64) and rgb.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(joints, want[2], rtol=1e-5, atol=1e-4)
    for name, g, w in (("alpha", alpha, want[0]), ("rgb", rgb, want[1])):
        off = np.abs(g - w) > 2e-4 * np.maximum(np.abs(w), 1.0)
        assert off.mean() <= 0.005, (name, off.mean())
        assert np.abs(g - w).max() <= 0.05, (name, np.abs(g - w).max())
    assert 0.01 < alpha.mean() < 0.9


def test_entry_builds_the_flagship_at_448():
    forward, (params, fids) = graft_entry.entry(device="cpu")
    _, config, rcfg, jparams = J._build(448, 512, n_frames=2)
    assert callable(forward) and fids.tolist() == [0, 1]
    assert (config.img_size, rcfg.active_fraction, rcfg.cap, rcfg.span_tiles) == (448, 0.28, 448, 3)
    for k, v in jparams.items():
        np.testing.assert_array_equal(params[k].detach().numpy(), np.asarray(v), err_msg=k)
    assert params["texture"].shape == (512, 512, 3) and params["verts_disps"].shape == (3088, 1)


def test_dryrun_multichip_on_two_gloo_ranks():
    out = graft_entry.dryrun_multichip(2)
    assert [h["epoch"] for h in out["history"]] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["params"]["pose"].shape == (2, 45)


def test_entry_without_a_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
