"""Frozen plain copy of harp_tpu_torch/models/lbs.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

Linear blend skinning (harp_tpu/models/lbs.py).

The kinematic chain is composed level by level (joints grouped by tree depth
in numpy), one batched (B, L, 3, 3) product per level.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.device import constant


def kinematic_levels(parents: np.ndarray) -> list[np.ndarray]:
    """Joint indices grouped by depth in the kinematic tree; level 0 is [0]."""
    parents = np.asarray(parents)
    K = parents.shape[0]
    depth = np.zeros(K, dtype=np.int64)
    for j in range(1, K):
        depth[j] = depth[parents[j]] + 1
    return [np.nonzero(depth == d)[0] for d in range(int(depth.max()) + 1)]


def forward_kinematics(rotmats: torch.Tensor, joints_rest: torch.Tensor,
                       parents: np.ndarray, levels=None):
    """Local rotations (B, K, 3, 3) + rest joints (B, K, 3) -> global
    transforms (R_global (B, K, 3, 3), t_global (B, K, 3)); t_global[j] is
    the posed joint location."""
    parents = np.asarray(parents)
    if levels is None:
        levels = kinematic_levels(parents)
    dev = joints_rest.device
    par = constant(np.maximum(parents, 0), dev)
    has_parent = constant(parents >= 0, dev)[None, :, None]
    t_local = joints_rest - torch.where(
        has_parent, joints_rest[:, par], torch.zeros_like(joints_rest))

    R_g = rotmats
    t_g = t_local
    for lvl in levels[1:]:
        li = constant(lvl, dev)
        pi = constant(parents[lvl], dev)
        Rp = R_g[:, pi]
        tp = t_g[:, pi]
        Rl = rotmats[:, li]
        tl = t_local[:, li]
        R_new = (Rp[..., :, :, None] * Rl[..., None, :, :]).sum(-2)
        t_new = (Rp * tl[..., None, :]).sum(-1) + tp
        R_g = R_g.index_copy(1, li, R_new)
        t_g = t_g.index_copy(1, li, t_new)
    return R_g, t_g


def linear_blend_skinning(R_global, t_global, joints_rest, weights, v_posed):
    """v_out = (sum_k w R_k) v + sum_k w (t_k - R_k j_k); weights (V, K),
    v_posed (B, V, 3) -> (B, V, 3)."""
    t_rel = t_global - torch.einsum("bkij,bkj->bki", R_global, joints_rest)
    R_v = torch.einsum("vk,bkij->bvij", weights, R_global)
    t_v = torch.einsum("vk,bki->bvi", weights, t_rel)
    return torch.einsum("bvij,bvj->bvi", R_v, v_posed) + t_v
