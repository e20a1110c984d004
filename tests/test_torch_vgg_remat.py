"""The VGG term's choice between keeping its activations for the backward
and running its forward again there (losses/perceptual.saved_bytes,
recompute; TrainStep.vgg_recompute), on the CPU.

The count of bytes is held to what autograd saves (saved_tensors_hooks),
the choice to the free memory it is given (the CPU has no figure, so a
step there recomputes exactly when config.vgg_remat asks), and both paths
to the same bits: the loss and the input's gradient of the VGG term, and
a whole TrainStep's losses, gradients and updated parameters. The scene is
the bench's (harp_tpu_torch/bench._scene) at 32^2, two frames, VGG from the
cached GT pyramids."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from harp_tpu_torch import bench
from harp_tpu_torch.fit import driver
from harp_tpu_torch.fit.driver import FitData, fit_sequence, make_train_step
from harp_tpu_torch.losses import perceptual as P

SMALL = dict(img=32, texture=64, density="light",
             raster_kw=dict(tile=8, cap=1024, face_chunk=256, faces_per_pixel=16,
                            span_tiles=4, active_fraction=1.0))
KEY = np.array([0, 7], np.uint32)


@pytest.fixture(scope="module")
def scene():
    return bench._scene(2, use_arm=False, use_vgg=True, device="cpu", **SMALL)


def _fresh(params: dict) -> dict:
    return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}


def _with_dtype(sc, dtype: str):
    """(config, vgg, aux) of the scene with the VGG term in `dtype`."""
    if dtype == sc.vgg.compute_dtype:
        return sc.config, sc.vgg, sc.aux
    vgg = sc.vgg.with_dtype(dtype)
    aux = dict(sc.aux, vgg_gt=P.precompute_slices(vgg, sc.images * sc.masks_er[..., None],
                                                  chunk=sc.config.vgg_chunk))
    return dataclasses.replace(sc.config, vgg_compute_dtype=dtype), vgg, aux


def _images(B: int, h: int, w: int):
    g = torch.Generator().manual_seed(0)
    return torch.rand(B, h, w, 3, generator=g), torch.rand(B, h, w, 3, generator=g)


def _loss(name: str, vgg, pred, true, remat: bool, chunk=1):
    if name == "l1":
        return P.vgg_feature_l1(vgg, pred, true, chunk=chunk, remat=remat)
    gt = P.precompute_slices(vgg, true, chunk=chunk)
    return P.vgg_feature_l1_cached(vgg, pred, gt, torch.arange(pred.shape[0]), chunk=chunk,
                                   remat=remat)


@pytest.mark.parametrize("hw", [(32, 24), (30, 22)], ids=["even", "odd"])
@pytest.mark.parametrize("name", ["cached", "l1"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_saved_bytes_is_what_autograd_keeps(dtype, name, hw):
    """saved_bytes equals the bytes of the distinct storages that autograd
    saves during the term's forward without the checkpoint, the tensors
    that were there before it (the input, the GT side, the frame ids, the
    filters) left out; with the checkpoint it saves none of its own."""
    B, (h, w) = 2, hw
    vgg = P.Vgg16Features.create(compute_dtype=dtype, device="cpu")
    pred, true = _images(B, h, w)
    pred.requires_grad_(True)
    gt, fids = P.precompute_slices(vgg, true, chunk=1), torch.arange(B)
    before = {t.untyped_storage().data_ptr()
              for t in [pred, true, fids, *gt, *vgg.parameters()]}

    def kept(remat: bool) -> int:
        storages = {}

        def pack(t):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in before:
                storages[ptr] = t.untyped_storage().nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            if name == "l1":
                P.vgg_feature_l1(vgg, pred, true, chunk=1, remat=remat)
            else:
                P.vgg_feature_l1_cached(vgg, pred, gt, fids, chunk=1, remat=remat)
        return sum(storages.values())

    assert kept(remat=False) == P.saved_bytes(vgg, B, h, w) > 0
    assert kept(remat=True) == 0


def test_saved_bytes_at_the_benchmark_frame():
    """188,059,648 B a 448^2 frame in bf16: ReLU outputs 105,971,712, pool
    outputs 11,239,424 and their indices 44,957,696, the sign mask
    24,686,592 and the input's cast 1,204,224."""
    vgg = P.Vgg16Features.create(compute_dtype="bfloat16", device="cpu")
    assert P.saved_bytes(vgg, 1, 448, 448) == 188_059_648
    assert P.saved_bytes(vgg, 18, 448, 448) == 18 * 188_059_648


@pytest.mark.parametrize("remat,free,want", [
    (True, None, True), (False, None, False),
    (True, "above", False), (True, "below", True),
    (False, "below", False), (False, 0, False),
], ids=["cpu_remat", "cpu_no_remat", "fits", "does_not_fit", "remat_off_below",
        "remat_off_none_free"])
def test_the_choice_follows_the_free_memory(remat, free, want):
    saved = 3_385_073_664
    budget = 2 * saved + P._FIXED_HEADROOM
    free = {"above": budget, "below": budget - 1}.get(free, free)
    assert P.recompute(remat, saved, free) is want


@pytest.mark.parametrize("remat,free,want", [
    (True, "above", False), (True, "below", True), (False, "below", False),
    (True, None, True), (False, None, False),
], ids=["fits", "does_not_fit", "remat_off", "cpu_remat", "cpu_no_remat"])
def test_the_step_checkpoints_only_when_it_chose_to(scene, monkeypatch, remat, free, want):
    """TrainStep weighs saved_bytes of its frames against the free memory
    (here set by the test) at its first VGG step, runs the checkpoint
    only when it chose to recompute, and keeps the choice for its later
    steps of that shape; a step without the appearance stage chooses
    nothing."""
    sc = scene
    saved = P.saved_bytes(sc.vgg, 2, 32, 32)
    budget = 2 * saved + P._FIXED_HEADROOM
    reads, checkpoints = [], []
    monkeypatch.setattr(driver, "free_bytes", lambda dev: reads.append(dev) or (
        {"above": budget, "below": budget - 1}.get(free, free)))
    real = P.checkpoint
    monkeypatch.setattr(P, "checkpoint", lambda *a, **k: checkpoints.append(1) or real(*a, **k))
    config = dataclasses.replace(sc.config, vgg_remat=remat)
    step = make_train_step(sc.assets, config, sc.rcfg, _fresh(sc.params), device="cpu",
                           vgg=sc.vgg)
    args = (sc.aux, sc.fids, sc.images, sc.masks, sc.masks_er, sc.ref_verts)
    step(*args, coarse_on=True, app_on=False, key=KEY)
    assert step.vgg_recompute is None and step.vgg_saved_bytes is None and not reads
    for _ in range(2):
        step(*args, coarse_on=True, app_on=True, key=KEY)
    assert step.vgg_recompute is want and step.vgg_saved_bytes == saved
    assert len(reads) == 1
    chunks = 2 // P._chunk_size(2, config.vgg_chunk)
    assert len(checkpoints) == (2 * chunks if want else 0)


@pytest.mark.parametrize("name", ["cached", "l1"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_term_gives_the_same_bits_with_and_without_recompute(dtype, name):
    vgg = P.Vgg16Features.create(compute_dtype=dtype, device="cpu")
    out = []
    for remat in (True, False):
        pred, true = _images(4, 32, 32)
        pred.requires_grad_(True)
        loss = _loss(name, vgg, pred, true, remat, chunk=2)
        loss.backward()
        out.append((loss.detach(), pred.grad))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1) and torch.equal(g0, g1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_step_gives_the_same_bits_with_and_without_recompute(scene, dtype):
    """Two stage-2 TrainSteps from one state, one recomputing the VGG
    forward and one keeping it: the same losses, every gradient and every
    updated parameter, bit for bit."""
    sc = scene
    config, vgg, aux = _with_dtype(sc, dtype)
    runs = []
    for remat in (True, False):
        params = _fresh(sc.params)
        step = make_train_step(sc.assets, dataclasses.replace(config, vgg_remat=remat),
                               sc.rcfg, params, device="cpu", vgg=vgg)
        total, br = step(aux, sc.fids, sc.images, sc.masks, sc.masks_er, sc.ref_verts,
                         coarse_on=True, app_on=True, key=KEY)
        assert step.vgg_recompute is remat and float(br["vgg"]) > 0
        runs.append((total, br, {k: (p.grad, p.detach()) for k, p in params.items()}))
    (t0, b0, p0), (t1, b1, p1) = runs
    assert torch.equal(t0, t1)
    assert b0.keys() == b1.keys() and all(torch.equal(b0[k], b1[k]) for k in b0)
    for k, (g, p) in p0.items():
        assert (g is None and p1[k][0] is None) or torch.equal(g, p1[k][0]), k
        assert torch.equal(p, p1[k][1]), k


@pytest.mark.parametrize("epoch_scan", [0, 2], ids=["per_step", "epoch_scan"])
def test_a_fit_logs_the_choice_once_a_stage(scene, tmp_path, epoch_scan):
    """metrics.jsonl holds vgg_recompute and vgg_saved_bytes once for each
    stage that runs the VGG term (2 and 3), after the stage's first step
    or segment, none for stage 1."""
    sc = scene
    config = dataclasses.replace(sc.config, training_stage=(1, 2, 1), total_epoch=4)
    aux = {k: v for k, v in sc.aux.items() if k != "vgg_gt"}  # the fit caches it
    fit_sequence(config, sc.assets, FitData(sc.images, sc.masks, sc.masks_er), _fresh(sc.params),
                 aux, rcfg=sc.rcfg, vgg=sc.vgg, out_dir=str(tmp_path), epoch_scan=epoch_scan,
                 device="cpu")
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    logged = [r for r in lines if "vgg_recompute" in r]
    assert [r["step"] for r in logged] == ([1, 3] if epoch_scan == 0 else [2, 3])
    for r in logged:
        assert r["vgg_recompute"] is True  # the CPU: config.vgg_remat
        assert r["vgg_saved_bytes"] == P.saved_bytes(sc.vgg, 2, 32, 32)
