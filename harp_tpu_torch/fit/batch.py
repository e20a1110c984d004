"""Batch fitting: many sequences in one fit (harp_tpu/fit/batch.py,
BASELINE.json config 5: all of one subject's appearance-variation
sequences at once).

harp_tpu vmaps the single-sequence step over a leading sequence axis S on
one device, pinning its XLA backends because vmap cannot lift the Pallas
kernels, and on a mesh runs a lax.map over each device's sequences under
shard_map. Here the batch step runs the S sequences in turn: one TrainStep
per sequence, each with its own two Adam groups and plateau lr, each
through the same kernels (K1, K2, K3, segment_sum) as the one-sequence
step. On a parallel.Mesh each rank fits its S / world sequences; the
sequences are independent, so there are no collectives in the math, and
the results are gathered so that every rank returns them all.

The streams are harp_tpu's: one numpy RandomState(seed) draws S
permutations per epoch in sequence order, and each step splits the
threefry key into S + 1 (the first carries on), so each sequence sees the
minibatches and texture-regulariser offsets that harp_tpu's batch fit
gives it. All sequences share static shapes (frame count, image size,
topology).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from harp_tpu_torch.device import resolve_device
from harp_tpu_torch.fit.driver import (
    FitData, TrainStep, prng_key, split_key, stage_flags,
)
from harp_tpu_torch.fit.optimizer import PlateauState, plateau_update
from harp_tpu_torch.losses.perceptual import Vgg16Features
from harp_tpu_torch.parallel.sharding import Mesh, all_gather_object
from harp_tpu_torch.render import pipeline
from harp_tpu_torch.render.rasterizer import RasterConfig


@dataclasses.dataclass
class BatchFitData:
    """(S, N, ...) stacked sequence data."""

    images: torch.Tensor  # (S, N, H, W, 3)
    masks: torch.Tensor  # (S, N, H, W)
    masks_eroded: torch.Tensor  # (S, N, H, W)

    @property
    def num_sequences(self) -> int:
        return self.images.shape[0]

    @property
    def num_frames(self) -> int:
        return self.images.shape[1]

    def sequence(self, s: int) -> FitData:
        return FitData(self.images[s], self.masks[s], self.masks_eroded[s])


def stack_params(params_list) -> dict:
    """List of per-sequence parameter dicts -> one dict with a leading S axis."""
    return {k: torch.stack([p[k].detach() for p in params_list]) for k in params_list[0]}


def unstack_params(batched: dict, s: int) -> dict:
    return {k: v[s] for k, v in batched.items()}


class BatchTrainStep:
    """One train step of each of S sequences, in turn: steps[s] is sequence
    s's TrainStep (its parameters, updated in place, and its two Adam
    groups)."""

    def __init__(self, steps: list):
        self.steps = steps

    def __call__(self, aux_S, fids_S, imgs_S, m_S, me_S, ref_verts_S, keys_S, lr_scales_S,
                 *, coarse_on: bool, app_on: bool):
        """Per-sequence lists (or leading-S arrays) in, (totals (S,),
        [breakdown of each sequence]) out."""
        totals, breakdowns = [], []
        for s, step in enumerate(self.steps):
            total, br = step(aux_S[s], fids_S[s], imgs_S[s], m_S[s], me_S[s], ref_verts_S[s],
                             lr_scales_S[s], coarse_on=coarse_on, app_on=app_on, key=keys_S[s])
            totals.append(total)
            breakdowns.append(br)
        return torch.stack(totals), breakdowns


def make_batch_train_step(assets, config, rcfg: RasterConfig, params_list,
                          vgg: Vgg16Features | None = None, device=None) -> BatchTrainStep:
    """The batch step over the sequences' parameter dicts (one TrainStep
    each; the model's extras are None, as in harp_tpu's batch step)."""
    return BatchTrainStep([TrainStep(assets, config, rcfg, p, device=device, vgg=vgg)
                           for p in params_list])


def fit_sequences_batch(config, assets, data: BatchFitData, params_list, aux_list,
                        rcfg: RasterConfig | None = None, vgg: Vgg16Features | None = None,
                        seed: int = 0, mesh: Mesh | None = None, device=None):
    """Fit S sequences at once. Returns (per-sequence params, per-sequence
    histories), a history one {"epoch", "loss", "raster_overflow"} per
    epoch (the overflow counters summed). The parameter dicts of the
    sequences this process fits are updated in place.

    The VGG term compares both sides every step (no GT cache, as in
    harp_tpu's batch fit). The batch fit takes the MANO-topology models:
    HTML, whose texture is its basis's (extras), is refused. mesh: a
    parallel.Mesh; rank r fits sequences [r S / n, (r + 1) S / n), drawing
    the full streams and taking its own part; S must divide by the ranks.
    Runs on CUDA unless device is given (with a mesh: on its device)."""
    if config.model_type == "html":
        raise ValueError("the batch fit takes no model extras, and HTML's texture is its "
                         "basis's: fit HTML sequences one by one with fit_sequence(extras=...)")
    S, n = data.num_sequences, data.num_frames
    lo, hi = 0, S
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a harp_tpu_torch.parallel.Mesh, not {type(mesh)}")
        if S % mesh.world_size:
            raise ValueError(f"S={S} sequences must divide over the {mesh.world_size}-rank "
                             "mesh (pad or bucket the sequence set)")
        per = S // mesh.world_size
        lo, hi = mesh.rank * per, (mesh.rank + 1) * per
        device = mesh.device if device is None else device
    dev = resolve_device(device)
    rcfg = rcfg or config.raster_config()
    if vgg is None and config.w_vgg > 0:
        vgg = Vgg16Features.create(weights_path=config.vgg_weights or None,
                                   compute_dtype=config.vgg_compute_dtype, device=dev)
    bs = min(config.batch_size, n)
    steps = max(n // bs, 1)
    mine = range(lo, hi)
    with torch.no_grad():  # the ARAP reference: frame 0 at each initial state
        ref_verts = [pipeline.mesh_forward(params_list[s], torch.zeros(1, dtype=torch.long,
                                                                       device=dev),
                                           assets, config)[0][0] for s in mine]
    step = make_batch_train_step(assets, config, rcfg, [params_list[s] for s in mine], vgg,
                                 device=dev)
    aux = [aux_list[s] for s in mine]
    seqs = [data.sequence(s) for s in mine]

    rng = np.random.RandomState(seed)
    key = prng_key(seed)
    plateaus = [PlateauState() for _ in mine]
    histories = [[] for _ in mine]
    for epoch in range(config.total_epoch):
        coarse_on, app_on = stage_flags(epoch, config)
        perms = np.stack([rng.permutation(n) for _ in range(S)])
        lr_scales = [p.scale for p in plateaus]
        totals_acc = overflow_acc = None
        for s in range(steps):
            fids = [torch.as_tensor(perms[q, s * bs:(s + 1) * bs], device=dev) for q in mine]
            key, *subs = split_key(key, S + 1)
            totals, breakdowns = step(
                aux, fids, [d.images[f] for d, f in zip(seqs, fids)],
                [d.masks[f] for d, f in zip(seqs, fids)],
                [d.masks_eroded[f] for d, f in zip(seqs, fids)], ref_verts, subs[lo:hi],
                lr_scales, coarse_on=coarse_on, app_on=app_on)
            over = torch.stack([sum(v for k, v in br.items() if k.endswith("overflow"))
                                for br in breakdowns])
            # Summed on the device: one host sync an epoch.
            totals_acc = totals if totals_acc is None else totals_acc + totals
            overflow_acc = over if overflow_acc is None else overflow_acc + over
        host = torch.stack([totals_acc, overflow_acc]).cpu().numpy()
        epoch_losses = host[0] / steps  # float32, as harp_tpu divides its host array
        for i in range(len(mine)):
            if coarse_on:
                plateaus[i] = plateau_update(plateaus[i], float(epoch_losses[i]),
                                             config.plateau_patience, config.plateau_factor)
            histories[i].append({"epoch": epoch, "loss": float(epoch_losses[i]),
                                 "raster_overflow": float(host[1][i])})

    out = [params_list[s] for s in mine]
    if mesh is not None:
        parts = all_gather_object(mesh, ({k: v.detach().cpu() for k, v in stack_params(out).items()},
                                          histories))
        out, histories = [], []
        for stacked, hist in parts:
            out += [{k: v.to(dev) for k, v in unstack_params(stacked, i).items()}
                    for i in range(len(hist))]
            histories += hist
    return out, histories
