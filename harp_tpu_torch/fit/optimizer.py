"""Two Adam groups + plateau LR schedule (harp_tpu/fit/optimizer.py).

- "coarse" (lr_pose, scaled by the plateau schedule): pose, cam, shape,
  verts_disps.
- "app" (lr_app): light_positions, amb_ratio, texture, normal_map (for
  HTML its texture-basis coefficients html_texture in their place).

trans, rot and wrist_pose belong to neither group and never move, as
harp_tpu's optax.masked + set_to_zero leave them. Each group is its own
torch.optim.Adam, stepped only when its stage flag is on: in the
appearance-only stage the pose parameters still receive gradients from the
photometric loss, yet the coarse group must not move.
"""

from __future__ import annotations

import dataclasses

import torch


def group_param_names(config):
    coarse = ["pose", "cam"]
    if config.use_arm and config.opt_arm_pose:
        coarse += ["wrist_pose", "rot"]
    if not config.known_appearance:
        coarse += ["shape"]
        if config.use_vert_disp:
            coarse += ["verts_disps"]
    app = ["light_positions", "amb_ratio"]
    if not config.known_appearance:
        if config.model_type == "html":
            app += ["html_texture"]  # linear basis coefficients, not free texels
        else:
            app += ["texture", "normal_map"]
    return {"coarse": coarse, "app": app}


def build_optimizers(params: dict, config) -> dict:
    """{"coarse": Adam, "app": Adam} over the groups' parameter tensors."""
    lrs = {"coarse": config.lr_pose, "app": config.lr_app}
    return {g: torch.optim.Adam([params[k] for k in names], lr=lrs[g])
            for g, names in group_param_names(config).items()}


@dataclasses.dataclass
class PlateauState:
    best: float = float("inf")
    bad_epochs: int = 0
    scale: float = 1.0


def plateau_update(state: PlateauState, epoch_loss: float, patience: int = 40,
                   factor: float = 0.1, threshold: float = 1e-4) -> PlateauState:
    """torch ReduceLROnPlateau(mode=min, threshold_mode=rel) semantics."""
    if epoch_loss < state.best * (1.0 - threshold):
        return PlateauState(best=epoch_loss, bad_epochs=0, scale=state.scale)
    bad = state.bad_epochs + 1
    if bad > patience:
        return PlateauState(best=state.best, bad_epochs=0, scale=state.scale * factor)
    return PlateauState(best=state.best, bad_epochs=bad, scale=state.scale)
