"""Carry harp_tpu's assets and fit parameters over to this package.

Both take plain arrays (harp_tpu's asset dataclasses hold numpy arrays;
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
