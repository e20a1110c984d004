"""Carry harp_tpu's assets, fit parameters and optimizer states over to
this package.

All take plain arrays (harp_tpu's asset dataclasses hold numpy arrays;
its parameters convert with np.asarray), so nothing of harp_tpu is
imported: the objects are read field by field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from harp_tpu_torch.assets import AvatarAssets
from harp_tpu_torch.models.html import TextureBasis
from harp_tpu_torch.models.mano import ManoModel
from harp_tpu_torch.models.manoarm import ManoArmModel
from harp_tpu_torch.models.nimble import NimbleModel
from harp_tpu_torch.models.smplx_arm import SmplxArmModel
from harp_tpu_torch.ops.mesh import MeshTopology, Subdivision

# Model classes by the source class's name (harp_tpu's carry the same names).
_MODELS = {cls.__name__: cls for cls in (ManoModel, SmplxArmModel, NimbleModel, ManoArmModel)}


def _fields(obj, cls):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls) if f.init
            and not f.name.startswith("_")}


def _topology(t) -> MeshTopology:
    return MeshTopology(**_fields(t, MeshTopology))


def assets_from_numpy(src) -> AvatarAssets:
    """This package's AvatarAssets from an object with harp_tpu's
    AvatarAssets fields (model arrays, topologies, subdivision, UVs,
    uv_mask). The model's class is chosen by the source model's class name:
    ManoModel, SmplxArmModel, NimbleModel or ManoArmModel."""
    name = type(src.model).__name__
    if name not in _MODELS:
        raise TypeError(f"no counterpart of model class {name}; one of {sorted(_MODELS)}")
    cls = _MODELS[name]
    model = cls(**_fields(src.model, cls))
    sub = None
    if src.subdivision is not None:
        sub = Subdivision(coarse=_topology(src.subdivision.coarse),
                          edge_src=src.subdivision.edge_src,
                          faces=src.subdivision.faces,
                          num_verts=src.subdivision.num_verts)
    return AvatarAssets(
        model=model,
        coarse_topology=_topology(src.coarse_topology),
        subdivision=sub,
        sub_topology=_topology(src.sub_topology),
        verts_uvs=np.asarray(src.verts_uvs),
        faces_uvs=np.asarray(src.faces_uvs),
        uv_mask=np.asarray(src.uv_mask),
    )


def extras_from_numpy(extras: dict | None) -> dict:
    """A fit's model-family extras (harp_tpu's {"texture_basis":
    TextureBasis}) as this package's objects."""
    out = {}
    for k, v in (extras or {}).items():
        if type(v).__name__ != "TextureBasis":
            raise TypeError(f"extras[{k!r}]: no counterpart of {type(v).__name__}")
        out[k] = TextureBasis(**_fields(v, TextureBasis))
    return out


def params_from_numpy(params: dict, device) -> dict:
    """Fit-parameter dict of arrays -> float32 leaf tensors with
    requires_grad on `device`."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device,
                            requires_grad=True)
            for k, v in params.items()}


def _adam_state(tree):
    """(count, mu, nu) of the one Adam state in an optax state tree:
    named tuples (optax's own classes, as harp_tpu restores them) or the
    dicts and lists an untyped restore gives."""
    if isinstance(tree, dict) and {"count", "mu", "nu"} <= set(tree):
        return tree["count"], tree["mu"], tree["nu"]
    fields = getattr(tree, "_fields", ())
    if {"count", "mu", "nu"} <= set(fields):
        return tree.count, tree.mu, tree.nu
    children = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def opt_states_from_numpy(opt_states: dict, params: dict, config, device) -> dict:
    """harp_tpu's optax states of the "coarse" and "app" groups (each
    chain(masked(adam), masked(set_to_zero))) -> this package's
    {"coarse": Adam.state_dict(), "app": ...} for fit_sequence's resume:
    optax's count, then mu and nu of the group's (unmasked) leaves, become
    each parameter's step, exp_avg and exp_avg_sq. params: this package's
    parameters (params_from_numpy of the same checkpoint)."""
    from harp_tpu_torch.fit.optimizer import build_optimizers, group_param_names

    names = group_param_names(config)
    out = {}
    for g, opt in build_optimizers(params, config).items():
        found = _adam_state(opt_states[g])
        if found is None:
            raise ValueError(f"opt_states[{g!r}] holds no Adam state (count, mu, nu)")
        count, mu, nu = found
        for name, p in zip(names[g], opt.param_groups[0]["params"]):
            opt.state[p] = {
                "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
                "exp_avg": torch.tensor(np.asarray(mu[name], np.float32), device=device),
                "exp_avg_sq": torch.tensor(np.asarray(nu[name], np.float32), device=device),
            }
        out[g] = opt.state_dict()
    return out


def unet_params_from_numpy(params: dict) -> dict:
    """harp_tpu's init_unet pytree ({"enc": [...], "bott", "dec": [...],
    "head"}, HWIO kernels) -> a state dict of models.unet.UNet (OIHW)."""
    def conv(prefix, p):
        w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)
        return {f"{prefix}.weight": torch.tensor(w),
                f"{prefix}.bias": torch.tensor(np.asarray(p["b"], np.float32))}

    state = {}
    for group in ("enc", "dec"):
        for i, block in enumerate(params[group]):
            for c in ("c1", "c2"):
                state.update(conv(f"{group}.{i}.{c}", block[c]))
    for c in ("c1", "c2"):
        state.update(conv(f"bott.{c}", params["bott"][c]))
    state.update(conv("head", params["head"]))
    return state
