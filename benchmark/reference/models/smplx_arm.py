"""Frozen plain copy of harp_tpu_torch/models/smplx_arm.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

SMPL-X right-arm hand model, HARP's SMPLXARM (harp_tpu/models/smplx_arm.py).

- full 55-joint SMPL-X LBS (shape + expression blendshapes, pose correctives);
- the right-wrist axis-angle is body_pose dims 60:63 (joint 21);
- the output is wrist-centred (joint 21 subtracted) before translation;
- extra "joints" are fingertip vertices appended after the 55 skeleton
  joints (smplx's VertexJointSelector); the arm correspondence
  (template/arm/smplx_arm_corr.pkl) selects the right-arm submesh, its MANO
  subset and the 22 output joints (21 in MANO order + the right elbow);
- outputs in millimetres.

The extra joints' vertex ids repeat (the unused ones all name one vertex),
so that gather goes through ops.segment.gather_rows: its backward sums the
repeats in an order fixed once per model (`extra_order`), the same bits
from run to run.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from benchmark.reference.device import constant
from benchmark.reference.models.lbs import forward_kinematics, kinematic_levels, linear_blend_skinning
from benchmark.reference.ops.rotations import axis_angle_to_matrix, flat_pose_map
from benchmark.reference.ops.segment import TableOrder, gather_table

# Standard SMPL-X kinematic tree (55 joints: 22 body, jaw, 2 eyes, 2x15 hand).
SMPLX_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19, 15, 15, 15,
     20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,  # left hand
     21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53]  # right hand
)
RIGHT_WRIST_JOINT = 21
RIGHT_ELBOW_JOINT = 19
NUM_JOINTS = 55
NUM_BODY_JOINTS = 21  # body_pose covers joints 1..21 (63 dof)

# VertexJointSelector extra-joint order, appended after the 55 skeleton
# joints -> indices 55..75.
EXTRA_JOINT_NAMES = [
    "nose", "reye", "leye", "rear", "lear",
    "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
    "lthumb", "lindex", "lmiddle", "lring", "lpinky",
    "rthumb", "rindex", "rmiddle", "rring", "rpinky",
]


@dataclasses.dataclass(frozen=True)
class SmplxArmModel:
    """Static SMPL-X assets + arm correspondence (numpy)."""

    v_template: np.ndarray  # (V, 3)
    shapedirs: np.ndarray  # (V, 3, S_betas)
    expr_dirs: np.ndarray  # (V, 3, S_expr)
    posedirs: np.ndarray  # (V, 3, 9*(K-1))
    J_regressor: np.ndarray  # (55, V)
    weights: np.ndarray  # (V, 55)
    parents: np.ndarray  # (55,)
    pose_mean: np.ndarray  # (165,)
    extra_joint_vertex_ids: np.ndarray  # (21,) fingertip/face vertex ids
    # Arm correspondence (smplx_arm_corr.pkl layout):
    arm_vert_idx: np.ndarray  # (1026,) right-arm submesh vertex ids
    mano_vert_from_arm: np.ndarray  # (778,) MANO verts within the arm mesh
    arm_faces: np.ndarray  # (2032, 3) faces over the arm submesh
    mano_faces: np.ndarray  # (1538, 3)
    joint_idx: np.ndarray  # (22,) output joints in MANO viz order + elbow

    def __post_init__(self):
        self.extra_order  # the repeated gather's sort, made with the model

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @functools.cached_property
    def extra_order(self) -> TableOrder:
        return TableOrder.of(self.extra_joint_vertex_ids, self.num_verts)

    def pose_frames(self, params: dict, fids: torch.Tensor):
        """The fit's parameters at frames fids posed: (the arm submesh's
        verts (B, V, 3) mm, joints (B, 22, 3) mm: MANO order, then the
        elbow)."""
        shape = params["shape"][None].expand(fids.shape[0], -1)
        return smplx_arm_forward(self, shape, params["rot"][fids], params["trans"][fids],
                                 params["pose"][fids], params["wrist_pose"][fids])


def smplx_arm_forward(model: SmplxArmModel, betas: torch.Tensor,
                      global_orient: torch.Tensor, transl: torch.Tensor,
                      right_hand_pose: torch.Tensor,
                      right_wrist_pose: torch.Tensor | None = None,
                      expression: torch.Tensor | None = None,
                      return_type: str = "mano_w_arm"):
    """SMPLXARM.forward. Args (B-batched): betas (B, S), global_orient
    (B, 3), transl (B, 3), right_hand_pose (B, 45) axis-angle,
    right_wrist_pose (B, 3). Returns (verts_mm, joints_mm): the arm submesh
    (or its MANO subset for return_type='mano') and 22 joints (21)."""
    f32 = torch.float32
    dev = betas.device
    B = betas.shape[0]
    K = NUM_JOINTS

    def const(a):
        return constant(a, dev, np.float32)

    def index(a):
        return constant(a, dev, np.int64)

    # body_pose is zero but for the right wrist, dims 60:63 (a new tensor:
    # no in-place write into one autograd still needs).
    wrist = (right_wrist_pose.to(f32) if right_wrist_pose is not None
             else torch.zeros(B, 3, dtype=f32, device=dev))
    body_pose = torch.cat([torch.zeros(B, 60, dtype=f32, device=dev), wrist], 1)
    zeros3 = torch.zeros(B, 3, dtype=f32, device=dev)
    left_hand = torch.zeros(B, 45, dtype=f32, device=dev)
    full_pose = torch.cat([global_orient.to(f32), body_pose, zeros3, zeros3, zeros3,
                           left_hand, right_hand_pose.to(f32)], 1) + const(model.pose_mean)

    if expression is None:
        expression = torch.zeros(B, model.expr_dirs.shape[-1], dtype=f32, device=dev)
    shape_comp = torch.cat([betas.to(f32), expression.to(f32)], 1)
    shapedirs = torch.cat([const(model.shapedirs), const(model.expr_dirs)], -1)

    rotmats = axis_angle_to_matrix(full_pose.reshape(B, K, 3))
    pose_map = flat_pose_map(rotmats[:, 1:])

    v_shaped = const(model.v_template) + torch.einsum("vcs,bs->bvc", shapedirs, shape_comp)
    joints_rest = torch.einsum("kv,bvc->bkc", const(model.J_regressor), v_shaped)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", const(model.posedirs), pose_map)

    levels = kinematic_levels(model.parents)
    R_g, t_g = forward_kinematics(rotmats, joints_rest, model.parents, levels)
    verts = linear_blend_skinning(R_g, t_g, joints_rest, const(model.weights), v_posed)
    joints = t_g

    # Wrist-centring.
    wrist_j = joints[:, RIGHT_WRIST_JOINT:RIGHT_WRIST_JOINT + 1]
    verts = verts - wrist_j
    joints = joints - wrist_j

    # VertexJointSelector extras, then translation.
    extra = gather_table(verts, model.extra_order)
    joints_ext = torch.cat([joints, extra], 1)
    verts = verts + transl.to(f32)[:, None]
    joints_ext = joints_ext + transl.to(f32)[:, None]

    arm_verts = verts[:, index(model.arm_vert_idx)] * 1000.0
    out_joints = joints_ext[:, index(model.joint_idx)] * 1000.0
    if return_type == "mano":
        return arm_verts[:, index(model.mano_vert_from_arm)], out_joints[:, :21]
    return arm_verts, out_joints


