"""The reference against the program at a tiny size on the CPU, where the
program runs its plain PyTorch versions: the inputs, one step's losses
and gradients."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.inputs import harp_kwargs, make_inputs, port_assets
from benchmark.tests.conftest import tiny_spec

CPU = torch.device("cpu")


@pytest.fixture(scope="module", params=["hand_mano_448", "arm_smplx_448"])
def inputs(request):
    torch.set_num_threads(1)
    spec = tiny_spec(request.param)
    return make_inputs(spec, 12345, CPU, {"stages": [0, 2, 0]})


def test_the_inputs_depend_on_the_seed_alone(inputs):
    again = make_inputs(inputs.spec, 12345, CPU, {"stages": [0, 2, 0]})
    assert torch.equal(again.images, inputs.images)
    for k, v in inputs.input_params.items():
        assert np.array_equal(again.input_params[k], v)
    other = make_inputs(inputs.spec, 12346, CPU, {"stages": [0, 2, 0]})
    assert not torch.equal(other.images, inputs.images)


def test_the_program_builds_the_same_assets_from_the_arrays(inputs):
    a = port_assets(inputs)
    r = inputs.ref_assets
    assert np.array_equal(a.render_faces, r.render_faces)
    assert np.array_equal(a.sub_topology.edges, r.sub_topology.edges)
    assert a.num_render_verts == r.num_render_verts


def test_one_step_matches_the_reference(inputs):
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.fit.driver import make_train_step
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.losses.perceptual import Vgg16Features
    from harp_tpu_torch.render import pipeline

    from benchmark.check import reference_fit

    cfg = HarpConfig(**harp_kwargs(inputs.spec, {"stages": [0, 2, 0]}))
    assets = port_assets(inputs)
    params, aux = init_params(inputs.input_params, assets, cfg, device=CPU)
    vgg = Vgg16Features(inputs.vgg_weights, compute_dtype=cfg.vgg_compute_dtype, device=CPU)
    from harp_tpu_torch.losses.perceptual import precompute_slices

    aux["vgg_gt"] = precompute_slices(vgg, inputs.images * inputs.masks_eroded[..., None],
                                      chunk=cfg.vgg_chunk)
    step = make_train_step(assets, cfg, cfg.raster_config(), params, device=CPU, vgg=vgg)
    with torch.no_grad():
        ref_verts = pipeline.mesh_forward(params, torch.zeros(1, dtype=torch.long), assets,
                                          cfg)[0][0]
    perm = np.random.RandomState(0).permutation(4)
    fids = torch.as_tensor(perm[:2])
    from harp_tpu_torch.fit.driver import _key_stream_np

    total, terms = step(aux, fids, inputs.images[fids], inputs.masks[fids],
                        inputs.masks_eroded[fids], ref_verts, 1.0, coarse_on=True, app_on=True,
                        key=_key_stream_np(0, 4)[0])
    ref = reference_fit(inputs, 1)
    grads = {k: step.optimizers["coarse"].state[p]["exp_avg"] / 0.1
             for k, p in params.items() if p in step.optimizers["coarse"].state}
    for k, g in grads.items():
        torch.testing.assert_close(g, ref["first_grads"][k], rtol=1e-4, atol=1e-6)
    assert set(terms) >= {"silhouette", "photo", "vgg", "arap"}
