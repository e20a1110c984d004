"""The reference fit: the first epochs of fit_sequence's schedule, step by
step, through the frozen plain step (fit/driver.py's TrainStep over plain
torch.optim.Adam groups) in float32.

The minibatches are fit_sequence's (numpy RandomState(seed) permutations,
one an epoch, the first steps * batch frames), the texture regulariser's
offsets come from harp_tpu's threefry key stream, the ARAP reference is
frame 0 at the initial parameters and the GT VGG pyramids are cached in
the VGG's compute dtype, as the program's fit does. Returns each epoch's
mean loss and terms, the parameters after the last step, and each leaf's
gradient at the first step. extras: the model family's statics, as the
step takes them (HTML's texture basis), or None.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.fit.driver import TrainStep, _key_stream_np, stage_flags
from benchmark.reference.fit.optimizer import PlateauState, plateau_update
from benchmark.reference.losses.perceptual import precompute_slices
from benchmark.reference.render import pipeline


def follow_fit(config, assets, rcfg, images, masks, masks_eroded, params0: dict, aux: dict,
               vgg, epochs: int, seed: int = 0, extras: dict | None = None) -> dict:
    dev = images.device
    n = images.shape[0]
    bs = min(config.batch_size, n)
    steps = max(n // bs, 1)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    aux = dict(aux)
    if vgg is not None and config.vgg_cache_gt and n <= config.vgg_cache_max_frames:
        aux["vgg_gt"] = precompute_slices(vgg, images * masks_eroded[..., None],
                                          chunk=config.vgg_chunk)
    with torch.no_grad():
        ref_verts = pipeline.mesh_forward(
            params, torch.zeros(1, dtype=torch.long, device=dev), assets, config)[0][0]
    step = TrainStep(assets, config, rcfg, params, device=dev, vgg=vgg, extras=extras)
    rng = np.random.RandomState(seed)
    keys = _key_stream_np(seed, config.total_epoch * steps)
    plateau = PlateauState()
    history, first_grads = [], None
    for epoch in range(epochs):
        coarse_on, app_on = stage_flags(epoch, config)
        perm = rng.permutation(n)
        sums = {}
        for s in range(steps):
            fids = torch.as_tensor(perm[s * bs:(s + 1) * bs], device=dev)
            total, terms = step(aux, fids, images[fids], masks[fids], masks_eroded[fids],
                                ref_verts, plateau.scale, coarse_on=coarse_on, app_on=app_on,
                                key=keys[epoch * steps + s])
            if first_grads is None:
                first_grads = {k: (p.grad.detach().clone() if p.grad is not None
                                   else torch.zeros_like(p)) for k, p in params.items()}
            for k, v in [("loss", total)] + list(terms.items()):
                sums[k] = sums.get(k, 0.0) + float(v)
        means = {k: v / steps for k, v in sums.items()}
        if coarse_on:
            plateau = plateau_update(plateau, means["loss"], config.plateau_patience,
                                     config.plateau_factor)
        history.append(means)
    return {"history": history, "params": {k: v.detach() for k, v in params.items()},
            "first_grads": first_grads}
