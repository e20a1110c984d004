"""The numbers that decide `correct`, each against its limit.

A fit cell compares what its timed path produced with the reference fit
(reference/follow.py) over the same first epochs:

- loss_gap: each epoch's loss and weighted loss terms as the program's
  fit_sequence reports them (its history), against the reference's:
  |program - reference| as a share of that term's reference value or of
  the median term's, whichever is larger (terms such as the displacement
  regulariser start at 0); the median over terms and epochs, which a
  fault of the whole step moves.
- loss_worst: the largest of those gaps, which a fault of one layer
  moves where the median does not.
- first_loss: the first epoch's total loss gap alone: steady from seed
  to seed (its first step starts from the same parameters on both sides),
  so that it catches a small fault of one term (the VGG term weighted 1%
  high) that the largest gap, led by the regularisers' round-off after
  Adam's first steps, does not.
- change_gap: the parameters after the compared steps, leaf by leaf: the
  gap between the norm of the program's change and the norm of the
  reference's, as a share of the reference's norm of that leaf or of the
  median leaf's, whichever is larger; the median over the leaves. (The
  worst leaf swings with one small leaf: the shared light's 3 numbers,
  whose Adam steps follow the signs of nearly cancelling gradient parts,
  read as much as the control does on some seeds; PERF.md gives both
  readings.) Leaves whose first gradient in the reference is under a
  thousandth of the median leaf's are left out (they move under Adam by
  round-off alone), and so are leaves the reference does not move.

A cell compares the numbers that its limits file names.
"""

from __future__ import annotations

import statistics

import torch

OVERFLOW_KEYS = ("bin_overflow", "active_overflow", "span_overflow",
                 "light_bin_overflow", "light_active_overflow", "light_span_overflow")
WEIGHT_OF = {"loss": None, "silhouette": "w_silhouette", "kps_anchor": "w_kps_anchor",
             "vert_disp_reg": "w_vert_disp_reg", "normal": "w_normal",
             "laplacian": "w_laplacian", "arap": "w_arap", "photo": "w_photo",
             "vgg": "w_vgg", "albedo": "w_albedo", "normal_reg": "w_normal_reg"}


def loss_gaps(prog_history: list, ref_history: list, config, epochs: int) -> dict:
    gaps = {}
    for e in range(epochs):
        p, r = prog_history[e], ref_history[e]
        terms = [k for k in r if k not in OVERFLOW_KEYS]
        missing = [k for k in terms if k not in p]
        if missing:
            bad = {"value": float("inf"), "at": f"epoch {e}: {missing} missing", "terms": gaps}
            return {"loss_gap": bad, "loss_worst": bad, "first_loss": bad}
        w = {k: 1.0 if WEIGHT_OF[k] is None else getattr(config, WEIGHT_OF[k]) for k in terms}
        floor = statistics.median(w[k] * abs(r[k]) for k in terms)
        for k in terms:
            gap = w[k] * abs(p[k] - r[k]) / max(w[k] * abs(r[k]), floor, 1e-30)
            gaps[f"epoch {e} {k}"] = gap
    if any(g != g for g in gaps.values()):  # NaN: not a sound run
        bad = {"value": float("inf"), "at": "NaN", "terms": gaps}
        return {"loss_gap": bad, "loss_worst": bad, "first_loss": bad}
    order = sorted(gaps, key=gaps.get)
    at = order[(len(order) - 1) // 2]  # the median term (the lower middle of an even count)
    return {"loss_gap": {"value": gaps[at], "at": at, "terms": gaps},
            "loss_worst": {"value": gaps[order[-1]], "at": order[-1]},
            "first_loss": {"value": gaps["epoch 0 loss"], "at": "epoch 0 loss"}}


def change_gap(params0: dict, prog: dict, ref: dict, ref_grads: dict) -> dict:
    gnorm = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref_grads.items()}
    dref = {k: float(torch.linalg.vector_norm((ref[k].double() - params0[k].double())))
            for k in ref}
    g_med = statistics.median(gnorm.values())
    leaves = [k for k in ref if dref[k] > 0 and gnorm[k] >= 1e-3 * g_med]
    if not leaves:
        return {"value": float("inf"), "at": "no leaf moved", "leaves": []}
    d_med = statistics.median(dref[k] for k in leaves)
    gaps = {}
    for k in leaves:
        dp = float(torch.linalg.vector_norm(prog[k].double().cpu() - params0[k].double().cpu()))
        gaps[k] = abs(dp - dref[k]) / max(dref[k], d_med)
    if any(g != g for g in gaps.values()):  # NaN: not a sound run
        return {"value": float("inf"), "at": "NaN", "leaves": gaps}
    order = sorted(gaps, key=gaps.get)
    at = order[(len(order) - 1) // 2]  # the median leaf (the lower middle of an even count)
    return {"value": gaps[at], "at": at, "worst": order[-1], "leaves": gaps}


def reference_fit(inputs, epochs: int, tf32: bool = False) -> dict:
    """The reference's first `epochs` epochs on the cell's inputs (with tf32
    the control: float32 matrix products and convolutions in TF32), with
    the family's reference-side statics as the step's extras."""
    from benchmark.reference.fit.params import init_params
    from benchmark.reference.losses.perceptual import Vgg16Features
    from benchmark.reference.reference_flags import precision
    from benchmark.reference.follow import follow_fit

    cfg = inputs.ref_config
    with precision(tf32):
        params0, aux = init_params(inputs.input_params, inputs.ref_assets, cfg,
                                   device=inputs.device)
        vgg = (Vgg16Features(inputs.vgg_weights, compute_dtype=cfg.vgg_compute_dtype,
                             device=inputs.device) if cfg.w_vgg > 0 else None)
        # 128 face slots a pass of the plain rasterizer: its (frames, tiles,
        # slots, pixels) tensors then fit beside the step at the arm's 392 tiles.
        out = follow_fit(cfg, inputs.ref_assets, cfg.raster_config(face_chunk=128), inputs.images,
                         inputs.masks, inputs.masks_eroded, params0, aux, vgg, epochs,
                         extras=inputs.family.reference_extras(inputs))
    out["params0"] = {k: v.detach() for k, v in params0.items()}
    return out


def fit_numbers(prog_history: list, prog_params: dict, ref: dict, config, epochs: int) -> dict:
    return {**loss_gaps(prog_history or [], ref["history"], config, epochs),
            "change_gap": change_gap(ref["params0"], prog_params, ref["params"],
                                     ref["first_grads"])}


def run(kind, traffic: dict) -> dict:
    """The cell's compared numbers, each with its limit (benchmark/limits/
    <cell>.json, as the run puts it in the traffic's "limits")."""
    limits = traffic["limits"]
    epochs = kind.warm["epochs"]
    ref = reference_fit(kind.inputs, epochs)
    nums = fit_numbers(kind.first_history, kind.warm["params"], ref, kind.inputs.ref_config,
                       epochs)
    return {k: dict(nums[k], limit=limit) for k, limit in limits.items()}
