"""MANOARM: HARP's SMPL+H-based right-arm hand model
(harp_tpu/models/manoarm.py). Differences from SMPLXARM (smplx_arm.py):

- 52-joint SMPL+H skeleton (22 body, 2x15 hands), 156-dof full pose =
  [global 3 | body 63 | left hand 45 | right hand 45] + pose_mean, hand
  poses optionally through the per-side PCA components;
- no right-wrist override and no wrist-centring;
- outputs stay in metres;
- vertices sliced to the right-arm submesh (template/arm/arm_vert.npy),
  joints by REL_JOINT_IDX: wrist, right-hand chain joints, right
  fingertips, right elbow, with the reference's literal repeat of joint 41
  at slot 15, kept so that outputs are interchangeable.

Both index tables repeat entries (the joint-41 repeat; the unused extra
joints all name one vertex), so both gathers go through
ops.segment.gather_table: the backward sums the repeats in an order fixed
once per model.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from harp_tpu_torch.models.lbs import forward_kinematics, kinematic_levels, linear_blend_skinning
from harp_tpu_torch.ops.rotations import axis_angle_to_matrix, flat_pose_map
from harp_tpu_torch.ops.segment import TableOrder, gather_table

# SMPL+H kinematic tree: SMPL body joints 0..21, then 15 left-hand joints
# (parented from wrist 20), then 15 right-hand joints (from wrist 21).
SMPLH_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18,
     19,
     20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,  # left hand
     21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50]  # right hand
)
NUM_JOINTS = 52
NUM_BODY_JOINTS = 21  # body_pose covers joints 1..21 (63 dof)
RIGHT_WRIST_JOINT = 21
RIGHT_ELBOW_JOINT = 19

# VertexJointSelector extra-joint order (as SMPL-X's), appended after the
# 52 skeleton joints -> indices 52..72; right fingertips at 68..72.
EXTRA_JOINT_NAMES = [
    "nose", "reye", "leye", "rear", "lear",
    "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
    "lthumb", "lindex", "lmiddle", "lring", "lpinky",
    "rthumb", "rindex", "rmiddle", "rring", "rpinky",
]

# The reference's output-joint selection: wrist, right-hand chain, right
# tips, elbow, with the verbatim joint-41 repeat.
REL_JOINT_IDX = np.array(
    [21, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 41,
     68, 69, 70, 71, 72, 19]
)


@dataclasses.dataclass(frozen=True)
class ManoArmModel:
    """Static SMPL+H assets + right-arm slicing (numpy)."""

    v_template: np.ndarray  # (V, 3)
    shapedirs: np.ndarray  # (V, 3, S)
    posedirs: np.ndarray  # (V, 3, 9*(K-1))
    J_regressor: np.ndarray  # (52, V)
    weights: np.ndarray  # (V, 52)
    parents: np.ndarray  # (52,)
    pose_mean: np.ndarray  # (156,)
    hands_components_l: np.ndarray  # (45, 45) PCA basis rows
    hands_components_r: np.ndarray  # (45, 45)
    extra_joint_vertex_ids: np.ndarray  # (21,)
    arm_vert_idx: np.ndarray  # right-arm submesh vertex ids
    arm_faces: np.ndarray  # faces over the arm submesh
    joint_idx: np.ndarray  # (22,) REL_JOINT_IDX
    use_pca: bool = False
    num_pca_comps: int = 6

    def __post_init__(self):
        self.extra_order, self.joint_order  # the repeated gathers' sorts

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @functools.cached_property
    def extra_order(self) -> TableOrder:
        return TableOrder.of(self.extra_joint_vertex_ids, self.num_verts)

    @functools.cached_property
    def joint_order(self) -> TableOrder:
        return TableOrder.of(self.joint_idx, NUM_JOINTS + len(self.extra_joint_vertex_ids))


def manoarm_forward(model: ManoArmModel, betas: torch.Tensor, global_orient: torch.Tensor,
                    transl: torch.Tensor, right_hand_pose: torch.Tensor,
                    body_pose: torch.Tensor | None = None,
                    left_hand_pose: torch.Tensor | None = None):
    """MANOARM.forward. Args (B-batched): betas (B, S), global_orient (B, 3),
    transl (B, 3), right_hand_pose (B, 45) axis-angle or (B, num_pca_comps)
    PCA when model.use_pca. Returns (verts, joints) in metres: the
    right-arm submesh and the 22 REL_JOINT_IDX joints."""
    f32 = torch.float32
    dev = betas.device
    B = betas.shape[0]
    K = NUM_JOINTS

    def const(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    if body_pose is None:
        body_pose = torch.zeros(B, NUM_BODY_JOINTS * 3, dtype=f32, device=dev)
    if left_hand_pose is None:
        dim = model.num_pca_comps if model.use_pca else 45
        left_hand_pose = torch.zeros(B, dim, dtype=f32, device=dev)
    if model.use_pca:
        left_hand_pose = left_hand_pose @ const(model.hands_components_l[: model.num_pca_comps])
        right_hand_pose = right_hand_pose @ const(model.hands_components_r[: model.num_pca_comps])

    full_pose = torch.cat([global_orient, body_pose, left_hand_pose, right_hand_pose],
                          1).to(f32) + const(model.pose_mean)

    rotmats = axis_angle_to_matrix(full_pose.reshape(B, K, 3))
    pose_map = flat_pose_map(rotmats[:, 1:])

    v_shaped = const(model.v_template) + torch.einsum("vcs,bs->bvc", const(model.shapedirs),
                                                      betas.to(f32))
    joints_rest = torch.einsum("kv,bvc->bkc", const(model.J_regressor), v_shaped)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", const(model.posedirs), pose_map)

    levels = kinematic_levels(model.parents)
    R_g, t_g = forward_kinematics(rotmats, joints_rest, model.parents, levels)
    verts = linear_blend_skinning(R_g, t_g, joints_rest, const(model.weights), v_posed)

    # VertexJointSelector extras, then translation: no wrist-centring and
    # no millimetre scaling.
    extra = gather_table(verts, model.extra_order)
    joints_ext = torch.cat([t_g, extra], 1)
    verts = verts + transl.to(f32)[:, None]
    joints_ext = joints_ext + transl.to(f32)[:, None]

    arm_verts = verts[:, torch.as_tensor(np.asarray(model.arm_vert_idx, np.int64), device=dev)]
    out_joints = gather_table(joints_ext, model.joint_order)
    return arm_verts, out_joints


def load_manoarm(smplh_path: str, arm_vert_npy: str, arm_face_npy: str,
                 num_betas: int = 10, use_pca: bool = False, num_pca_comps: int = 6,
                 flat_hand_mean: bool = False) -> ManoArmModel:
    """SMPLH_*.pkl / .npz + template/arm/arm_vert.npy / arm_face.npy ->
    ManoArmModel."""
    if smplh_path.endswith(".npz"):
        data = dict(np.load(smplh_path, allow_pickle=True))
    else:
        from harp_tpu_torch.assets import _load_pickle_no_chumpy, _to_numpy

        raw = _load_pickle_no_chumpy(smplh_path)
        data = {k: _to_numpy(v) for k, v in raw.items()}

    posedirs = np.asarray(data["posedirs"], np.float32)
    if posedirs.ndim == 2:  # (9*(K-1), V*3) layout
        posedirs = posedirs.T.reshape(-1, 3, posedirs.shape[0])
    pose_mean = np.zeros(156, np.float32)
    if not flat_hand_mean:
        pose_mean[66:111] = np.asarray(data["hands_meanl"], np.float32)
        pose_mean[111:156] = np.asarray(data["hands_meanr"], np.float32)

    # smplx's vertex_ids['smplh'] table (public constants).
    vertex_ids = {
        "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
        "LBigToe": 3216, "LSmallToe": 3226, "LHeel": 3387,
        "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
        "lthumb": 2746, "lindex": 2319, "lmiddle": 2445, "lring": 2556,
        "lpinky": 2673,
        "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
        "rpinky": 6133,
    }
    extra_ids = np.array([vertex_ids[n] for n in EXTRA_JOINT_NAMES])

    return ManoArmModel(
        v_template=np.asarray(data["v_template"], np.float32),
        shapedirs=np.asarray(data["shapedirs"], np.float32)[:, :, :num_betas],
        posedirs=posedirs,
        J_regressor=np.asarray(data["J_regressor"], np.float32),
        weights=np.asarray(data["weights"], np.float32),
        parents=SMPLH_PARENTS.copy(),
        pose_mean=pose_mean,
        hands_components_l=np.asarray(data["hands_componentsl"], np.float32),
        hands_components_r=np.asarray(data["hands_componentsr"], np.float32),
        extra_joint_vertex_ids=extra_ids,
        arm_vert_idx=np.load(arm_vert_npy).astype(np.int64),
        arm_faces=np.load(arm_face_npy).astype(np.int32),
        joint_idx=REL_JOINT_IDX.copy(),
        use_pca=use_pca,
        num_pca_comps=num_pca_comps,
    )


def build_synthetic_manoarm(n_ring: int = 8, seed: int = 0,
                            use_pca: bool = False) -> ManoArmModel:
    """A synthetic ManoArmModel: the procedural hand + forearm geometry on
    the 52-joint SMPL+H skeleton (right-hand chain joints 37..51, wrist 21,
    elbow 19), without the registration-gated SMPLH pkl."""
    from harp_tpu_torch.assets import _resample_polyline, _tube, build_synthetic_hand

    rng = np.random.RandomState(seed + 23)
    hand = build_synthetic_hand(n_ring=n_ring, seed=seed)
    n_hand = hand.num_verts

    chain = np.stack(
        [np.array([-0.26, 0.0, 0.0]), np.array([-0.17, 0.0, 0.0]),
         np.array([-0.08, 0.0, 0.0]), np.array([0.01, 0.0, 0.0])], 0
    )
    radii = np.array([0.030, 0.032, 0.034, 0.036])
    fa_verts, fa_faces, _ = _tube(chain, radii, n_ring + 2)
    n_fore = fa_verts.shape[0]
    dummy = np.array([[0.0, -0.8, 0.0], [0.1, -0.8, 0.0], [0.0, -0.9, 0.1]], np.float32)
    v_template = np.concatenate([hand.v_template, fa_verts, dummy], 0)
    V = v_template.shape[0]
    K = NUM_JOINTS

    # Hand skinning columns: wrist 0 -> 21, finger joint j in 1..15 -> 36+j.
    weights = np.zeros((V, K), np.float32)
    weights[:n_hand, 21] = hand.weights[:, 0]
    for j in range(1, 16):
        weights[:n_hand, 36 + j] = hand.weights[:, j]
    t = np.clip((fa_verts[:, 0] + 0.26) / 0.27, 0, 1)
    weights[n_hand:n_hand + n_fore, 19] = 1 - t
    weights[n_hand:n_hand + n_fore, 21] = t
    weights[n_hand + n_fore:, 0] = 1.0
    weights /= weights.sum(1, keepdims=True)

    J_reg = np.zeros((K, V), np.float32)
    J_reg[21, :n_hand] = hand.J_regressor[0]
    for j in range(1, 16):
        J_reg[36 + j, :n_hand] = hand.J_regressor[j]
    J_reg[19, n_hand:n_hand + n_ring + 2] = 1.0 / (n_ring + 2)
    for j in (0, 3, 6, 9, 14, 17):
        J_reg[j, n_hand + n_fore] = 1.0

    S = 10
    shapedirs = np.zeros((V, 3, S), np.float32)
    shapedirs[:, :, 0] = v_template - v_template.mean(0)
    for s in range(1, S):
        freq = rng.uniform(10.0, 40.0, size=3)
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        shapedirs[:, :, s] = 0.003 * np.sin(v_template @ freq)[:, None] * axis
    posedirs = (0.0001 * rng.randn(V, 3, 9 * (K - 1))).astype(np.float32)

    tip_map = {"rthumb": 0, "rindex": 1, "rmiddle": 2, "rring": 3, "rpinky": 4}
    extra_ids = np.zeros(len(EXTRA_JOINT_NAMES), np.int64) + (V - 1)
    for name, k in tip_map.items():
        extra_ids[EXTRA_JOINT_NAMES.index(name)] = hand.tips_idx[k]

    arm_vert_idx = np.arange(n_hand + n_fore)
    arm_faces = np.concatenate([hand.faces, fa_faces + n_hand], 0).astype(np.int32)

    return ManoArmModel(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        J_regressor=J_reg,
        weights=weights,
        parents=SMPLH_PARENTS.copy(),
        pose_mean=np.zeros(156, np.float32),
        hands_components_l=np.eye(45, dtype=np.float32),
        hands_components_r=np.eye(45, dtype=np.float32),
        extra_joint_vertex_ids=extra_ids,
        arm_vert_idx=arm_vert_idx,
        arm_faces=arm_faces,
        joint_idx=REL_JOINT_IDX.copy(),
        use_pca=use_pca,
    )
