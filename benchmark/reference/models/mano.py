"""Frozen plain copy of harp_tpu_torch/models/mano.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

MANO hand model (harp_tpu/models/mano.py).

    verts, joints = mano_forward(model, pose48, betas10, trans3)

pose48 = [global_rot(3), hand_pose(45 axis-angle or ncomps PCA coeffs)];
vertices (B, V, 3) and 21 joints (B, 21, 3) in millimetres, joints in the
visualisation order used throughout HARP.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.device import constant
from benchmark.reference.ops.rotations import axis_angle_to_matrix, flat_pose_map
from benchmark.reference.models.lbs import (
    kinematic_levels,
    forward_kinematics,
    linear_blend_skinning,
)

TIPS_RIGHT = np.array([745, 317, 444, 556, 673])
TIPS_LEFT = np.array([745, 317, 445, 556, 673])
JOINT_REORDER = np.array(
    [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19, 7, 8, 9, 20]
)


@dataclasses.dataclass(frozen=True)
class ManoModel:
    """Static MANO assets (numpy)."""

    v_template: np.ndarray  # (V, 3)
    shapedirs: np.ndarray  # (V, 3, S)
    posedirs: np.ndarray  # (V, 3, 9*(K-1))
    J_regressor: np.ndarray  # (K, V) dense
    weights: np.ndarray  # (V, K)
    faces: np.ndarray  # (F, 3) int32
    parents: np.ndarray  # (K,)
    hands_components: np.ndarray  # (45, 45) PCA basis (rows = components)
    hands_mean: np.ndarray  # (45,)
    tips_idx: np.ndarray  # (5,) fingertip vertex ids
    joint_reorder: np.ndarray  # (21,)
    use_pca: bool = False
    ncomps: int = 45
    flat_hand_mean: bool = False

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    def pose_frames(self, params: dict, fids: torch.Tensor):
        """The fit's parameters at frames fids posed: (verts (B, V, 3) mm,
        joints (B, 21, 3) mm in MANO order)."""
        shape = params["shape"][None].expand(fids.shape[0], -1)
        return mano_forward(self, torch.cat([params["rot"][fids], params["pose"][fids]], 1),
                            shape, params["trans"][fids])


def mano_forward(model: ManoModel, pose_coeffs: torch.Tensor,
                 betas: torch.Tensor, trans: torch.Tensor):
    """pose_coeffs (B, 3 + ncomps), betas (B, S), trans (B, 3) metres ->
    (verts (B, V, 3) mm, joints (B, 21, 3) mm)."""
    f32 = torch.float32
    dev = pose_coeffs.device
    pose_coeffs = pose_coeffs.to(f32)
    betas = betas.to(f32)
    trans = trans.to(f32)
    B = pose_coeffs.shape[0]
    K = model.num_joints

    def const(a):
        return constant(a, dev, np.float32)

    hand_coeffs = pose_coeffs[:, 3:3 + model.ncomps]
    if model.use_pca:
        hand_pose = hand_coeffs @ const(model.hands_components[: model.ncomps])
    else:
        hand_pose = hand_coeffs
    if not model.flat_hand_mean:
        hand_pose = hand_pose + const(model.hands_mean)

    full_pose = torch.cat([pose_coeffs[:, :3], hand_pose], dim=1)
    rotmats = axis_angle_to_matrix(full_pose.reshape(B, K, 3))
    pose_map = flat_pose_map(rotmats[:, 1:])

    v_shaped = const(model.v_template) + torch.einsum(
        "vcs,bs->bvc", const(model.shapedirs), betas)
    joints_rest = torch.einsum("kv,bvc->bkc", const(model.J_regressor), v_shaped)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", const(model.posedirs), pose_map)

    levels = kinematic_levels(model.parents)
    R_g, t_g = forward_kinematics(rotmats, joints_rest, model.parents, levels)
    verts = linear_blend_skinning(R_g, t_g, joints_rest, const(model.weights), v_posed)

    tips = verts[:, constant(model.tips_idx, dev, np.int64)]
    joints = torch.cat([t_g, tips], dim=1)
    joints = joints[:, constant(model.joint_reorder, dev, np.int64)]

    verts = (verts + trans[:, None, :]) * 1000.0
    joints = (joints + trans[:, None, :]) * 1000.0
    return verts, joints
