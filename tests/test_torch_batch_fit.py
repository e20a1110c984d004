"""harp_tpu_torch.fit.batch vs harp_tpu.fit.batch on the CPU.

- split_key(key, S + 1) equals jax.random.split.
- One batch step is, sequence by sequence, the same bits as a lone
  TrainStep on the same minibatch and key (one thread).
- fit_sequences_batch against harp_tpu's (mesh=None: its vmapped step with
  the XLA backends), S = 2 sequences of 2 frames at 32^2, texture 64^2,
  no self-shadow, stages 1 / 1 / 1, without VGG (both packages compare both
  VGG sides every batch step; that loss is held in
  tests/test_torch_perceptual.py). K = 16 soft ids hold every within-blur
  face of these scenes, so harp_tpu's K-id silhouette gradient and the
  port's all-faces one are the same function
  (tests/test_torch_fit_sequence.py). Tolerances: each epoch's loss rtol
  1e-3; the overflow counters equal; parameters within 1e-3 of each leaf's
  largest entry (float32 sums in other orders through three Adam steps),
  but for at most 0.1% of an appearance leaf's entries, each within two
  Adam steps of lr_app per appearance epoch. Those are entries whose
  gradient is near 0 and takes another sign in the other package (float32
  sums in other orders, harp_tpu's vmapped program under XLA:CPU's FMA
  contraction): Adam normalises each gradient by its RMS and steps such an
  entry a whole lr either way. Sequence 1 has 4 of its 12,288 normal-map
  entries so, up to 0.0071; the port's one-sequence fit of that sequence
  holds 1e-3 everywhere against harp_tpu's.
- Losses drop and the sequences stay independent (harp_tpu's
  tests/test_batch_fit.py); the divisibility guard; HTML refused.
- The batch on 2 gloo ranks (parallel.launch) is the same bits as on one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.assets import build_synthetic_assets as jbuild
from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.data.synthetic import make_synthetic_sequence as jmake_sequence
from harp_tpu.fit import init_params as jinit_params
from harp_tpu.fit.batch import BatchFitData as JBatchFitData
from harp_tpu.fit.batch import fit_sequences_batch as jfit_sequences_batch
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu_torch.assets import build_synthetic_assets
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy
from harp_tpu_torch.data.synthetic import make_synthetic_sequence
from harp_tpu_torch.fit import BatchFitData, fit_sequences_batch
from harp_tpu_torch.fit.batch import make_batch_train_step, stack_params, unstack_params
from harp_tpu_torch.fit.driver import make_train_step, prng_key, split_key, stage_flags
from harp_tpu_torch.fit.optimizer import group_param_names
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.parallel import Mesh, workers
from harp_tpu_torch.parallel.launch import launch
from harp_tpu_torch.render import pipeline
from harp_tpu_torch.render.rasterizer import RasterConfig

import _harp_goldens as goldens

IMG, TEX, S, NF = 32, 64, 2, 2
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=False, w_vgg=0.0, batch_size=NF,
              training_stage=(1, 1, 1), total_epoch=3)
RCFG_KW = dict(image_size=IMG, tile=8, cap=1024, face_chunk=256, faces_per_pixel=16,
               span_tiles=4, active_fraction=1.0)

# The parity tolerances of the docstring, which the golden's regenerator reads
# too (it holds every entry of a leaf to PARAM_TOL).
LOSS_RTOL = 1e-3
PARAM_TOL = 1e-3  # of each leaf's largest entry


@pytest.mark.parametrize("seed,num", [(0, 2), (0, 3), (7, 5), (2 ** 32 - 1, 9)])
def test_split_key_equals_jax_random_split(seed, num):
    key = prng_key(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(split_key(key, num),
                                  np.asarray(jax.random.split(jnp.asarray(key), num)))
    with pytest.raises(ValueError):
        prng_key(2 ** 32)


@pytest.fixture(scope="module")
def scene():
    """S sequences of harp_tpu's synthetic hand (seeds 10, 11), the arrays
    and initial values both packages fit from."""
    jassets = jbuild(uv_size=TEX, density="light")
    jconfig, jrcfg = JHarpConfig(**CFG_KW), JRasterConfig(**RCFG_KW)
    seqs = [jmake_sequence(jassets, jconfig, jrcfg, n_frames=NF, seed=10 + s, perturb=0.2)
            for s in range(S)]
    frames = tuple(np.stack([np.asarray(q[i]) for q in seqs]) for i in range(3))
    return dict(jassets=jassets, jconfig=jconfig, jrcfg=jrcfg, frames=frames,
                inits=[q[4] for q in seqs], assets=assets_from_numpy(jassets),
                config=HarpConfig(**CFG_KW), rcfg=RasterConfig(**RCFG_KW))


def _port_inputs(scene, config=None):
    config = config or scene["config"]
    pairs = [init_params(i, scene["assets"], config, device="cpu") for i in scene["inits"]]
    data = BatchFitData(*[torch.from_numpy(a.copy()) for a in scene["frames"]])
    return data, [p for p, _ in pairs], [a for _, a in pairs]


def _port_batch(scene, config=None, **kw):
    config = config or scene["config"]
    data, params, aux = _port_inputs(scene, config)
    return fit_sequences_batch(config, scene["assets"], data, params, aux, rcfg=scene["rcfg"],
                               device="cpu", **kw)


def test_batch_step_is_each_sequence_s_lone_step(scene):
    config = scene["config"]
    data, params, aux = _port_inputs(scene)
    start = [{k: v.detach().clone() for k, v in p.items()} for p in params]
    fids = [torch.tensor([1, 0]), torch.tensor([0, 1])]
    keys = split_key(prng_key(3), S + 1)[1:]
    with torch.no_grad():
        refs = [pipeline.mesh_forward(p, torch.zeros(1, dtype=torch.long), scene["assets"],
                                      config)[0][0] for p in params]
    seqs = [data.sequence(s) for s in range(S)]
    step = make_batch_train_step(scene["assets"], config, scene["rcfg"], params, device="cpu")
    totals, _ = step(aux, fids, [q.images[f] for q, f in zip(seqs, fids)],
                     [q.masks[f] for q, f in zip(seqs, fids)],
                     [q.masks_eroded[f] for q, f in zip(seqs, fids)], refs, keys, [1.0, 0.5],
                     coarse_on=True, app_on=True)
    for s in range(S):
        lone = {k: v.clone().requires_grad_(True) for k, v in start[s].items()}
        total, _ = make_train_step(scene["assets"], config, scene["rcfg"], lone, device="cpu")(
            aux[s], fids[s], seqs[s].images[fids[s]], seqs[s].masks[fids[s]],
            seqs[s].masks_eroded[fids[s]], refs[s], [1.0, 0.5][s], coarse_on=True,
            app_on=True, key=keys[s])
        assert torch.equal(total, totals[s])
        for k, p in lone.items():
            assert torch.equal(p.detach(), params[s][k].detach()), (s, k)
    stacked = stack_params(params)
    assert stacked["pose"].shape[0] == S
    assert torch.equal(unstack_params(stacked, 1)["texture"], params[1]["texture"].detach())


def _harp_tpu_batch_fit(scene) -> dict:
    """harp_tpu's batch fit of the scene, the golden harp_tpu_batch_fit.npz:
    each sequence's history (hist0, hist1) and final parameters (param0,
    param1)."""
    pairs = [jinit_params(i, scene["jassets"], scene["jconfig"]) for i in scene["inits"]]
    jdata = JBatchFitData(*[jnp.asarray(a) for a in scene["frames"]])
    jparams, jhist = jfit_sequences_batch(scene["jconfig"], scene["jassets"], jdata,
                                          [p for p, _ in pairs], [a for _, a in pairs],
                                          rcfg=scene["jrcfg"], seed=0)
    return goldens.pack(**{f"hist{s}": jhist[s] for s in range(S)},
                        **{f"param{s}": jparams[s] for s in range(S)})


@pytest.mark.slow
def test_harp_tpu_golden_of_the_batch_fit_is_current(scene):
    def tolerance(k, want):  # test_batch_fit_histories..., test_batch_fit_parameters...
        if k in {f"hist{s}" for s in range(S)}:
            return LOSS_RTOL * np.abs(want)
        if k.startswith("param"):
            return PARAM_TOL * max(np.abs(want).max(), 1e-12)
        return None

    goldens.assert_current("harp_tpu_batch_fit", _harp_tpu_batch_fit(scene), tolerance)


@pytest.fixture(scope="module")
def both(scene):
    """harp_tpu's batch fit (stored, _harp_tpu_batch_fit) and the port's."""
    theirs = goldens.load("harp_tpu_batch_fit")
    params, hist = _port_batch(scene, seed=0)
    return dict(jparams=[goldens.part(theirs, f"param{s}") for s in range(S)],
                jhist=[goldens.part(theirs, f"hist{s}") for s in range(S)], params=params,
                hist=hist)


def test_batch_fit_histories_match_harp_tpu(both):
    assert len(both["hist"]) == len(both["jhist"]) == S
    for ours, theirs in zip(both["hist"], both["jhist"]):
        assert [h["epoch"] for h in ours] == [h["epoch"] for h in theirs] == [0, 1, 2]
        for a, b in zip(ours, theirs):
            assert set(a) == set(b) == {"epoch", "loss", "raster_overflow"}
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL, err_msg=str(b))
            assert a["raster_overflow"] == b["raster_overflow"] == 0.0


def test_batch_fit_parameters_match_harp_tpu(both):
    config = HarpConfig(**CFG_KW)
    app_epochs = sum(stage_flags(e, config)[1] for e in range(config.total_epoch))
    groups = group_param_names(config)
    for s in range(S):
        for k, p in both["params"][s].items():
            want = np.asarray(both["jparams"][s][k])
            d = np.abs(p.detach().numpy() - want)
            off = d > PARAM_TOL * max(np.abs(want).max(), 1e-12)
            if off.any():  # an edge pixel covered in one package only (docstring)
                assert k in groups["app"] and off.mean() <= 1e-3, (s, k, int(off.sum()))
                assert d.max() <= 2 * app_epochs * config.lr_app + 1e-6, (s, k, d.max())


def test_batch_fit_losses_drop_and_sequences_stay_independent():
    """harp_tpu's tests/test_batch_fit.py (no shadow or VGG, ten silhouette
    epochs) at 32^2 where it runs 64^2."""
    assets = build_synthetic_assets(uv_size=32, density="light")
    rcfg = RasterConfig(image_size=32, tile=8, cap=256, faces_per_pixel=8)
    config = HarpConfig(img_size=32, focal_length=2000.0 * 32 / 448, texture_size=32,
                        self_shadow=False,
                        total_epoch=10, training_stage=(10, 0, 0), batch_size=2, w_vgg=0.0)
    seqs = [make_synthetic_sequence(assets, config, rcfg, n_frames=2, seed=10 + s,
                                    perturb=0.2, device="cpu") for s in range(2)]
    pairs = [init_params(q[4], assets, config, device="cpu") for q in seqs]
    data = BatchFitData(*[torch.stack([q[i] for q in seqs]) for i in range(3)])
    out, hist = fit_sequences_batch(config, assets, data, [p for p, _ in pairs],
                                    [a for _, a in pairs], rcfg=rcfg, device="cpu")
    assert len(out) == 2
    for h in hist:
        # Allow the first steps' Adam transient; the tail must beat epoch 0.
        assert min(x["loss"] for x in h[3:]) < h[0]["loss"], h
    d = (out[0]["pose"] - out[1]["pose"]).abs().max()
    assert d > 1e-3


def test_batch_fit_divisibility_guard_and_html(scene):
    data, params, aux = _port_inputs(scene)
    mesh = Mesh(world_size=4, rank=0, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="divide"):
        fit_sequences_batch(scene["config"], scene["assets"], data, params, aux,
                            rcfg=scene["rcfg"], mesh=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        fit_sequences_batch(scene["config"], scene["assets"], data, params, aux,
                            rcfg=scene["rcfg"], mesh=object(), device="cpu")
    html = dataclasses.replace(scene["config"], model_type="html")
    with pytest.raises(ValueError, match="HTML"):
        fit_sequences_batch(html, scene["assets"], data, params, aux, rcfg=scene["rcfg"],
                            device="cpu")


def test_batch_fit_on_two_ranks_is_the_same_bits(scene, both):
    config = scene["config"]
    one, one_hist = both["params"], both["hist"]
    two = launch(workers.batch_fit_on_mesh, 2,
                 {"assets": scene["assets"], "config": config, "rcfg": scene["rcfg"],
                  "frames": scene["frames"], "inits": scene["inits"]}, 0,
                 devices=["cpu"] * 2)
    assert two["history"] == one_hist
    for s in range(S):
        for k, p in one[s].items():
            np.testing.assert_array_equal(two["params"][s][k], p.detach().numpy(),
                                          err_msg=f"sequence {s}: {k}")
