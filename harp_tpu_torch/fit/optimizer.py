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

On CUDA both Adams are capturable (step counts and bias corrections on the
device), so that a CUDA graph holds the step (fit/driver.make_epoch_scan),
and the coarse group's lr is a 0-dim device tensor that the step writes in
place from the plateau scale. PyTorch refuses capturable Adams for CPU
parameters: there they are plain Adams with a float lr.

The plateau schedule runs on the host in the per-step loop
(plateau_update, float64) and on the device in the epoch scan
(DevicePlateau, plateau_update_device: float32, as harp_tpu's scan carries
it).
"""

from __future__ import annotations

import dataclasses

import numpy as np
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
    """{"coarse": Adam, "app": Adam} over the groups' parameter tensors:
    capturable, the coarse lr a device tensor, on CUDA; plain on the CPU."""
    lrs = {"coarse": config.lr_pose, "app": config.lr_app}
    out = {}
    for g, names in group_param_names(config).items():
        ps = [params[k] for k in names]
        if ps[0].is_cuda:
            lr = (torch.tensor(lrs[g], dtype=torch.float32, device=ps[0].device)
                  if g == "coarse" else lrs[g])
            out[g] = torch.optim.Adam(ps, lr=lr, capturable=True, foreach=True)
        else:
            out[g] = torch.optim.Adam(ps, lr=lrs[g])
    return out


def load_optimizer_state(opt: torch.optim.Optimizer, state: dict) -> None:
    """opt.load_state_dict(state), keeping opt's own settings. torch takes
    each group's lr and flags from the saved state: a state saved on the
    CPU, or before the Adams were capturable, would make a CUDA Adam plain
    and its lr a float. A capturable Adam's step counts go to the
    parameters' device."""
    own = [{k: v for k, v in g.items() if k != "params"} for g in opt.param_groups]
    opt.load_state_dict(state)
    for group, settings in zip(opt.param_groups, own):
        group.update(settings)
        if not settings.get("capturable"):
            continue
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(device=p.device, dtype=torch.float32)


@dataclasses.dataclass
class PlateauState:
    best: float = float("inf")
    bad_epochs: int = 0
    scale: float = 1.0


def plateau_update(state: PlateauState, epoch_loss: float, patience: int = 40,
                   factor: float = 0.1, threshold: float = 1e-4) -> PlateauState:
    """torch ReduceLROnPlateau(mode=min, threshold_mode=rel) semantics, on
    the host."""
    if epoch_loss < state.best * (1.0 - threshold):
        return PlateauState(best=epoch_loss, bad_epochs=0, scale=state.scale)
    bad = state.bad_epochs + 1
    if bad > patience:
        return PlateauState(best=state.best, bad_epochs=0, scale=state.scale * factor)
    return PlateauState(best=state.best, bad_epochs=bad, scale=state.scale)


@dataclasses.dataclass
class DevicePlateau:
    """PlateauState on the device, as harp_tpu's epoch scan carries it:
    best and scale float32, bad_epochs int32, 0-dim tensors updated in
    place (a CUDA graph reads the scale at a fixed address)."""

    best: torch.Tensor
    bad_epochs: torch.Tensor
    scale: torch.Tensor

    @classmethod
    def of(cls, state: PlateauState, device) -> "DevicePlateau":
        return cls(torch.tensor(state.best, dtype=torch.float32, device=device),
                   torch.tensor(state.bad_epochs, dtype=torch.int32, device=device),
                   torch.tensor(state.scale, dtype=torch.float32, device=device))

    def stacked(self) -> torch.Tensor:
        """(best, bad_epochs, scale) as one float32 (3,) tensor, for one read."""
        return torch.stack([self.best, self.bad_epochs.float(), self.scale])


def plateau_update_device(state: DevicePlateau, epoch_loss: torch.Tensor, patience: int = 40,
                          factor: float = 0.1, threshold: float = 1e-4) -> None:
    """plateau_update in float32 on the device, in place, as harp_tpu's
    epoch scan computes it (harp_tpu/fit/driver.py make_epoch_scan):
    improved = loss < best * (1 - threshold), then bad, trip and
    scale * factor, every product rounded to float32. epoch_loss: a 0-dim
    float32 tensor. Decisions agree with the host's float64 update except
    within ~1e-7 (relative) of the threshold."""
    keep = float(np.float32(1.0) - np.float32(threshold))
    improved = epoch_loss < state.best * keep
    bad = torch.where(improved, torch.zeros_like(state.bad_epochs), state.bad_epochs + 1)
    trip = bad > patience
    state.best.copy_(torch.where(improved, epoch_loss, state.best))
    state.scale.copy_(torch.where(trip, state.scale * float(np.float32(factor)), state.scale))
    state.bad_epochs.copy_(torch.where(trip, torch.zeros_like(bad), bad))
