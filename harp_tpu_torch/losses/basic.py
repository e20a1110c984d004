"""Core fitting losses (harp_tpu/losses/basic.py)."""

from __future__ import annotations

import torch

from harp_tpu_torch.ops.mesh import MeshTopology, edge_lengths


def kps_anchor_loss(gt_joints_mm: torch.Tensor, pred_joints_mm: torch.Tensor,
                    use_arm: bool = False) -> torch.Tensor:
    """Root-aligned squared joint error in (mm/100)^2; inputs (B, J, 3) mm,
    computed without a sqrt so the root row's gradient is finite."""
    if use_arm:
        pred_joints_mm = pred_joints_mm[:, :21]
        gt_joints_mm = gt_joints_mm[:, :21]
    gt = gt_joints_mm - gt_joints_mm[:, 0:1]
    pred = pred_joints_mm - pred_joints_mm[:, 0:1]
    return (((gt - pred) ** 2).sum(-1) / 1e4).mean()


def vert_disp_reg(disps: torch.Tensor) -> torch.Tensor:
    """sum(d^2) for 1-D normal displacements, sum(|d|^2) for 3-D."""
    return torch.sum(disps ** 2.0)


def arap_loss(verts: torch.Tensor, ref_verts: torch.Tensor,
              topology: MeshTopology) -> torch.Tensor:
    """Edge-length preservation vs a reference mesh, lengths in mm:
    verts (B, V, 3) and ref_verts (V, 3) or (1, V, 3) in metres."""
    if ref_verts.dim() == 2:
        ref_verts = ref_verts[None]
    e = edge_lengths(verts, topology) * 1000.0
    e_ref = edge_lengths(ref_verts, topology) * 1000.0
    return ((e - e_ref) ** 2.0).mean()
