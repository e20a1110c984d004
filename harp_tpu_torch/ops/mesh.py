"""Static mesh topology + differentiable mesh operators (harp_tpu/ops/mesh.py).

Topology (edges, neighbour lists, subdivision pattern, edge-adjacent face
pairs) is built once in numpy with pytorch3d's edge and 4-way subdivision
ordering; the per-step operators are gathers and fixed-order segment sums
on tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from harp_tpu_torch.ops.numerics import safe_norm, safe_normalize
from harp_tpu_torch.ops.segment import TableOrder, sum_rows


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Static topology of one triangle mesh (numpy arrays).

    faces (F, 3); edges (E, 2) rows (min, max) sorted lexicographically;
    faces_to_edges (F, 3) edge ids [e12, e20, e01] (edge i opposite vertex
    i); neighbors (V, D) padded adjacency (pad = own index) with
    neighbor_mask (V, D); edge_face_pairs (P, 2) faces sharing an edge.
    corners: the face table's corners and their stable sort, made at first
    use and kept, for the fixed-order sums of face values onto vertices.
    """

    num_verts: int
    faces: np.ndarray
    edges: np.ndarray
    faces_to_edges: np.ndarray
    neighbors: np.ndarray
    neighbor_mask: np.ndarray
    edge_face_pairs: np.ndarray

    @functools.cached_property
    def corners(self) -> TableOrder:
        return TableOrder.of(self.faces, self.num_verts)


def build_topology(faces: np.ndarray, num_verts: int) -> MeshTopology:
    faces = np.asarray(faces, dtype=np.int64)
    v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]
    raw = np.concatenate(
        [np.stack([v1, v2], 1), np.stack([v2, v0], 1), np.stack([v0, v1], 1)], 0
    )
    raw.sort(axis=1)
    ehash = raw[:, 0] * num_verts + raw[:, 1]
    uniq, inverse = np.unique(ehash, return_inverse=True)
    edges = np.stack([uniq // num_verts, uniq % num_verts], 1)
    faces_to_edges = inverse.reshape(3, -1).T

    deg = np.zeros(num_verts, dtype=np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    max_deg = max(int(deg.max()), 1)
    neighbors = np.tile(np.arange(num_verts)[:, None], (1, max_deg))
    mask = np.zeros((num_verts, max_deg), dtype=bool)
    cursor = np.zeros(num_verts, dtype=np.int64)
    for a, b in edges:
        neighbors[a, cursor[a]] = b
        mask[a, cursor[a]] = True
        cursor[a] += 1
        neighbors[b, cursor[b]] = a
        mask[b, cursor[b]] = True
        cursor[b] += 1

    edge_faces: dict[int, list[int]] = {}
    for fi in range(faces.shape[0]):
        for ei in faces_to_edges[fi]:
            edge_faces.setdefault(int(ei), []).append(fi)
    pairs = []
    for ei, fl in edge_faces.items():
        for i in range(len(fl)):
            for j in range(i + 1, len(fl)):
                pairs.append((fl[i], fl[j]))
    edge_face_pairs = (
        np.asarray(pairs, dtype=np.int64) if pairs else np.zeros((0, 2), np.int64)
    )

    return MeshTopology(
        num_verts=num_verts,
        faces=faces.astype(np.int32),
        edges=edges.astype(np.int32),
        faces_to_edges=faces_to_edges.astype(np.int32),
        neighbors=neighbors.astype(np.int32),
        neighbor_mask=mask,
        edge_face_pairs=edge_face_pairs.astype(np.int32),
    )


@dataclasses.dataclass(frozen=True)
class Subdivision:
    """One pytorch3d-ordered 4-way (midpoint) subdivision step: edge
    midpoints are appended after the original verts in edge order; faces
    are the blocks (v0,e01,e20), (v1,e12,e01), (v2,e20,e12), (e12,e20,e01)."""

    coarse: MeshTopology
    edge_src: np.ndarray  # (E, 2) endpoints of each new vertex
    faces: np.ndarray  # (4F, 3)
    num_verts: int  # V + E


def build_subdivision(topology: MeshTopology) -> Subdivision:
    V = topology.num_verts
    faces = topology.faces.astype(np.int64)
    fe = topology.faces_to_edges.astype(np.int64) + V
    f0 = np.stack([faces[:, 0], fe[:, 2], fe[:, 1]], 1)
    f1 = np.stack([faces[:, 1], fe[:, 0], fe[:, 2]], 1)
    f2 = np.stack([faces[:, 2], fe[:, 1], fe[:, 0]], 1)
    new_faces = np.concatenate([f0, f1, f2, fe], 0).astype(np.int32)
    return Subdivision(
        coarse=topology,
        edge_src=topology.edges.copy(),
        faces=new_faces,
        num_verts=V + topology.edges.shape[0],
    )


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def apply_subdivision(sub: Subdivision, verts: torch.Tensor) -> torch.Tensor:
    """(..., V, 3) -> (..., V+E, 3): append edge midpoints."""
    e = _index(sub.edge_src, verts.device)
    mids = 0.5 * (verts[..., e[:, 0], :] + verts[..., e[:, 1], :])
    return torch.cat([verts, mids], dim=-2)


def face_normals(verts: torch.Tensor, faces) -> torch.Tensor:
    """Unnormalised (area-weighted) face normals, (..., F, 3)."""
    f = _index(faces, verts.device)
    p0 = verts[..., f[:, 0], :]
    p1 = verts[..., f[:, 1], :]
    p2 = verts[..., f[:, 2], :]
    return torch.linalg.cross(p1 - p0, p2 - p0, dim=-1)


def vertex_normals(verts: torch.Tensor, topology: MeshTopology) -> torch.Tensor:
    """Area-weighted vertex normals (pytorch3d verts_normals), (..., V, 3).
    Each face's normal is added at its three corners by a fixed-order
    segment sum over the topology's corner order (sorted once), so the sum
    is the same bits from run to run; its backward is a gather."""
    lead, V = verts.shape[:-2], verts.shape[-2]
    if V != topology.num_verts:
        raise ValueError(f"verts have {V} vertices, the topology {topology.num_verts}")
    n = math.prod(lead)
    fn = face_normals(verts, topology.faces)  # (..., F, 3)
    F = fn.shape[-2]
    corners = fn.reshape(n, F, 1, 3).expand(n, F, 3, 3).reshape(n * F * 3, 3)
    acc = sum_rows(corners, topology.corners.batched(n, verts.device))
    return safe_normalize(acc.reshape(lead + (V, 3)))


def laplacian_smoothing_loss(verts: torch.Tensor, topology: MeshTopology) -> torch.Tensor:
    """Uniform-weight Laplacian magnitude, mean over verts and batch
    (pytorch3d mesh_laplacian_smoothing, method='uniform')."""
    nbr = _index(topology.neighbors, verts.device)
    mask = torch.as_tensor(topology.neighbor_mask, dtype=verts.dtype,
                           device=verts.device)
    gathered = verts[..., nbr, :]  # (..., V, D, 3)
    deg = mask.sum(-1, keepdim=True).clamp(min=1.0)
    mean_nbr = (gathered * mask[..., None]).sum(-2) / deg
    return safe_norm(mean_nbr - verts, dim=-1).mean()


def normal_consistency_loss(verts: torch.Tensor, topology: MeshTopology) -> torch.Tensor:
    """1 - cos between normals of faces sharing an edge, averaged."""
    pairs = _index(topology.edge_face_pairs, verts.device)
    fn = face_normals(verts, topology.faces)
    n0 = fn[..., pairs[:, 0], :]
    n1 = fn[..., pairs[:, 1], :]
    cos = (n0 * n1).sum(-1) / (safe_norm(n0, dim=-1) * safe_norm(n1, dim=-1))
    return (1.0 - cos).mean()


def edge_lengths(verts: torch.Tensor, topology: MeshTopology) -> torch.Tensor:
    """(..., E) edge lengths."""
    e = _index(topology.edges, verts.device)
    return safe_norm(verts[..., e[:, 0], :] - verts[..., e[:, 1], :], dim=-1)
