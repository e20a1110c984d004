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
from harp_tpu_torch.models.mano import ManoModel
from harp_tpu_torch.ops.mesh import MeshTopology, Subdivision


def _fields(obj, cls):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def _topology(t) -> MeshTopology:
    return MeshTopology(**_fields(t, MeshTopology))


def assets_from_numpy(src) -> AvatarAssets:
    """This package's AvatarAssets from an object with harp_tpu's
    AvatarAssets fields (MANO model arrays, topologies, subdivision, UVs,
    uv_mask)."""
    model = ManoModel(**_fields(src.model, ManoModel))
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


def params_from_numpy(params: dict, device) -> dict:
    """Fit-parameter dict of arrays -> float32 leaf tensors with
    requires_grad on `device`."""
    return {k: torch.tensor(np.asarray(v, np.float32), device=device,
                            requires_grad=True)
            for k, v in params.items()}
