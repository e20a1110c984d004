"""harp_tpu_torch stands alone: importing every one of its modules
(parallel/, fit/batch.py and utils/orbax_io.py among them) loads neither
jax, orbax nor tensorstore nor anything of harp_tpu, and its entry points
refuse to guess a device when no CUDA card is present."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import harp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(harp_tpu_torch.__path__, "harp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "harp_tpu", "orbax", "tensorstore"))
new = {"harp_tpu_torch.parallel.sharding", "harp_tpu_torch.parallel.halo",
       "harp_tpu_torch.parallel.launch", "harp_tpu_torch.fit.batch",
       "harp_tpu_torch.utils.orbax_io"}
print(len(names) if new <= set(names) else -1, bad)
"""


def test_port_imports_neither_jax_nor_harp_tpu():
    """Every module of the package, imported in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20, out.stdout
    assert bad.strip() == "[]", out.stdout


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    from harp_tpu_torch.assets import build_synthetic_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.fit.driver import make_train_step
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.render.rasterizer import RasterConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assets = build_synthetic_assets(uv_size=8, density="light")
    init = {"pose": np.zeros((1, 45)), "rot": np.zeros((1, 3)), "trans": np.zeros((1, 3)),
            "shape": np.zeros((1, 10)), "cam": np.ones((1, 3)), "joints": np.zeros((1, 21, 3))}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(init, assets, HarpConfig(texture_size=8))
    params, _ = init_params(init, assets, HarpConfig(texture_size=8), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(assets, HarpConfig(), RasterConfig(), params)
    step = make_train_step(assets, HarpConfig(), RasterConfig(), params, device="cpu")
    assert step.device.type == "cpu"
