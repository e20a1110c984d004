"""Frozen plain copy of harp_tpu_torch/models/nimble.py's skin layer: the
benchmark's reference, independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

NIMBLE hand model (Li et al., SIGGRAPH 2022, https://nimblehand.github.io;
harp_tpu/models/nimble.py), its skin layer: 25 joints, a 30-component PCA
pose space and a 20-component shape space.

- `NimbleModel`: the numpy asset struct (the skin, the skeleton, the pose
  PCA and the MANO-surface regression; no muscle or bone layer: the fit
  renders the skin);
- `nimble_forward`: PCA pose -> axis-angle of the 24 non-root joints ->
  FK -> LBS of the skin, the shape blend first;
- `nimble_to_mano`: the MANO-topology surface regressed from the skin
  vertices (NIMBLE_MANO_VREG), through ops.segment.gather_table (the
  table repeats skin vertices);
- `mano_protocol_joints`: the 21 MANO-protocol joints of that surface;
- `build_published_nimble`: the procedural stand-in at NIMBLE's published
  widths, from the reference's assets helpers. It lives here alone: the
  cell hands its arrays to the program's NimbleModel (families/nimble.py).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from benchmark.reference import assets as ref_assets
from benchmark.reference.device import constant
from benchmark.reference.models.lbs import forward_kinematics, kinematic_levels, linear_blend_skinning
from benchmark.reference.models.mano import JOINT_REORDER
from benchmark.reference.ops.rotations import axis_angle_to_matrix
from benchmark.reference.ops.segment import TableOrder, gather_table


@dataclasses.dataclass(frozen=True)
class NimbleModel:
    """Static NIMBLE assets (numpy), the skin layer."""

    v_template: np.ndarray  # (V, 3)
    shapedirs: np.ndarray  # (V, 3, S) shape PCA (S=20)
    weights: np.ndarray  # (V, K) skinning weights
    faces: np.ndarray  # (F, 3)
    J_regressor: np.ndarray  # (K, V) joints from skin verts
    parents: np.ndarray  # (K,)
    pose_basis: np.ndarray  # (P, (K-1)*3), rows = components
    pose_mean: np.ndarray  # ((K-1)*3,)
    # mano_vert[i] = sum_j vreg_w[i, j] * skin_v[vreg_idx[i, j]].
    mano_vreg_idx: np.ndarray  # (Vm, nk) int
    mano_vreg_w: np.ndarray  # (Vm, nk)
    mano_J_regressor: np.ndarray  # (16, Vm)
    mano_tips_idx: np.ndarray  # (5,)
    mano_joint_reorder: np.ndarray  # (21,)
    ncomps: int = 30
    nshape: int = 20

    def __post_init__(self):
        self.vreg_order  # the regression gather's sort, made with the model

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @functools.cached_property
    def vreg_order(self) -> TableOrder:
        return TableOrder.of(self.mano_vreg_idx, self.num_verts)

    def pose_frames(self, params: dict, fids: torch.Tensor):
        """The fit's parameters at frames fids posed: (skin verts (B, V, 3)
        mm, the 21 MANO-protocol joints (B, 21, 3) mm of the regressed MANO
        surface)."""
        shape = params["shape"][None].expand(fids.shape[0], -1)
        verts, _ = nimble_forward(self, torch.cat([params["rot"][fids], params["pose"][fids]], 1),
                                  shape, params["trans"][fids])
        return verts, mano_protocol_joints(self, nimble_to_mano(self, verts))


def nimble_forward(model: NimbleModel, pose_coeffs: torch.Tensor, betas: torch.Tensor,
                   trans: torch.Tensor):
    """pose_coeffs (B, 3 + ncomps) [global rot axis-angle | pose PCA
    coeffs], betas (B, nshape), trans (B, 3) metres -> (skin verts (B, V,
    3) mm, joints (B, K, 3) mm)."""
    f32 = torch.float32
    dev = pose_coeffs.device
    pose_coeffs = pose_coeffs.to(f32)
    betas = betas.to(f32)
    trans = trans.to(f32)
    B = pose_coeffs.shape[0]
    K = model.num_joints

    def const(a):
        return constant(a, dev, np.float32)

    coeffs = pose_coeffs[:, 3:3 + model.ncomps]
    body_pose = coeffs @ const(model.pose_basis[: model.ncomps]) + const(model.pose_mean)
    full_pose = torch.cat([pose_coeffs[:, :3], body_pose], 1)
    rotmats = axis_angle_to_matrix(full_pose.reshape(B, K, 3))

    v_shaped = const(model.v_template) + torch.einsum("vcs,bs->bvc", const(model.shapedirs),
                                                      betas)
    joints_rest = torch.einsum("kv,bvc->bkc", const(model.J_regressor), v_shaped)

    levels = kinematic_levels(model.parents)
    R_g, t_g = forward_kinematics(rotmats, joints_rest, model.parents, levels)
    verts = linear_blend_skinning(R_g, t_g, joints_rest, const(model.weights), v_shaped)

    verts = (verts + trans[:, None, :]) * 1000.0
    joints = (t_g + trans[:, None, :]) * 1000.0
    return verts, joints


def nimble_to_mano(model: NimbleModel, skin_verts: torch.Tensor) -> torch.Tensor:
    """The MANO-topology surface (B, Vm, 3) regressed from skin vertices
    (B, V, 3)."""
    Vm, nk = model.mano_vreg_idx.shape
    rows = gather_table(skin_verts, model.vreg_order).reshape(-1, Vm, nk, 3)
    w = constant(model.mano_vreg_w, skin_verts.device, skin_verts.dtype)
    return torch.einsum("bvkc,vk->bvc", rows, w)


def mano_protocol_joints(model: NimbleModel, mano_verts: torch.Tensor) -> torch.Tensor:
    """21 MANO-protocol joints (16 skeleton + 5 fingertips, reordered) of
    the regressed MANO surface."""
    dev = mano_verts.device
    J = torch.einsum("kv,bvc->bkc",
                     constant(model.mano_J_regressor, dev, mano_verts.dtype), mano_verts)
    tips = mano_verts[:, constant(model.mano_tips_idx, dev, np.int64)]
    joints = torch.cat([J, tips], 1)
    return joints[:, constant(model.mano_joint_reorder, dev, np.int64)]


# The published skin's procedural mesh: finger tubes of 16 x 41 and a palm
# of 71 x 38 vertices, 5990 in all, 11956 faces.
PUBLISHED_SKIN = dict(n_ring=16, chain_pts=41, palm_res=(71, 40))
CARPAL_AT, CMC_AT, THUMB_CMC_AT = 0.25, 0.6, 0.5
STIFF_JOINTS = (1, 2, 3, 4, 5, 9, 13, 17)  # the 4 carpals, the 4 finger CMCs


def _hand_skeleton():
    """The procedural hand's MANO skeleton, as assets.build_synthetic_hand
    places it: (joints (16, 3) float32 metres, {ray: ([its 3 joint ids],
    tip position)}, the rays in MANO's order)."""
    finger_dirs = {
        "index": np.array([1.0, 0.0, 0.0]),
        "middle": np.array([1.0, 0.0, 0.0]),
        "pinky": np.array([1.0, 0.0, 0.0]),
        "ring": np.array([1.0, 0.0, 0.0]),
        "thumb": np.array([0.62, 0.75, 0.0]),
    }
    finger_y = {"index": 0.030, "middle": 0.010, "pinky": -0.030, "ring": -0.010, "thumb": 0.045}
    base_x = {"index": 0.090, "middle": 0.092, "pinky": 0.082, "ring": 0.088, "thumb": 0.022}
    seg_lens = {
        "index": [0.032, 0.024, 0.020],
        "middle": [0.036, 0.027, 0.021],
        "pinky": [0.026, 0.018, 0.016],
        "ring": [0.033, 0.025, 0.020],
        "thumb": [0.036, 0.030, 0.024],
    }
    order = ["index", "middle", "pinky", "ring", "thumb"]
    joints = [np.zeros(3)]
    rays = {}
    for name in order:
        d = finger_dirs[name] / np.linalg.norm(finger_dirs[name])
        p = np.array([base_x[name], finger_y[name], 0.0])
        ids = []
        for s in seg_lens[name]:
            ids.append(len(joints))
            joints.append(p.copy())
            p = p + d * s
        rays[name] = (ids, p.copy())
    return np.asarray(joints, np.float32), rays, order


def nimble_skeleton(mano_joints: np.ndarray, rays: dict, order: list):
    """NIMBLE's 25-joint tree on the procedural hand's rays: the wrist (0),
    a carpal joint on each ray but the thumb's (1-4), then CMC, MCP, PIP
    and DIP on each ray (5 + 4r ... 8 + 4r). Returns (joints (25, 3),
    parents (25,), bone ends (25, 3))."""
    joints, parents = [np.zeros(3)], [-1]
    for r in order[:4]:
        joints.append(CARPAL_AT * mano_joints[rays[r][0][0]])
        parents.append(0)
    for i, r in enumerate(order):
        ids, _ = rays[r]
        mcp = mano_joints[ids[0]]
        cmc = CMC_AT * mcp if i < 4 else THUMB_CMC_AT * mcp
        for k, p in enumerate([cmc] + [mano_joints[j] for j in ids]):
            parents.append((1 + i if i < 4 else 0) if k == 0 else len(joints) - 1)
            joints.append(p)
    joints = np.asarray(joints, np.float32)
    parents = np.asarray(parents, np.int64)
    ends = []
    for j in range(len(joints)):
        children = np.nonzero(parents == j)[0]
        ends.append(joints[children].mean(0) if len(children) else rays[order[(j - 5) // 4]][1])
    return joints, parents, np.asarray(ends, np.float32)


def build_published_nimble(seed: int) -> NimbleModel:
    """NIMBLE's published structure on the procedural hand: a 5990-vertex
    skin (not subdivided), the 25-joint tree with top-2 distance-based
    skinning, a joint regressor over the skin vertices within 3 mm of each
    joint's nearest, 30 orthonormal pose directions of the 72 dofs with the
    mean in their span, 20 smooth shape directions, and the 781-vertex
    MANO surface as convex blends of 3 nearest skin vertices."""
    skin = ref_assets.build_synthetic_hand(seed=seed, **PUBLISHED_SKIN)
    mano = ref_assets.build_synthetic_hand(seed=seed, **ref_assets.HAND_DENSITY["reference"])
    joints, parents, ends = nimble_skeleton(*_hand_skeleton())
    v = skin.v_template
    V, K = v.shape[0], joints.shape[0]
    rng = np.random.RandomState(seed + 101)

    dists = np.stack([ref_assets._segment_distance(v, joints[j], ends[j]) for j in range(K)], 1)
    w = np.exp(-((dists / 0.012) ** 2))
    top2 = np.argsort(-w, axis=1)[:, :2]
    keep = np.zeros_like(w)
    np.put_along_axis(keep, top2, np.take_along_axis(w, top2, 1), 1)
    keep += 1e-8 * (np.arange(K) == 0)
    weights = (keep / keep.sum(1, keepdims=True)).astype(np.float32)

    J_reg = np.zeros((K, V), np.float32)
    for j in range(K):
        d = np.linalg.norm(v - joints[j], axis=1)
        idx = np.nonzero(d <= d.min() + 0.003)[0]
        wj = 1.0 / (d[idx] + 1e-4)
        J_reg[j, idx] = wj / wj.sum()

    # The rays' carpal and CMC joints move little in a hand: their dofs
    # carry a tenth of the basis's weight.
    stiff = np.repeat(np.isin(np.arange(1, K), STIFF_JOINTS), 3)
    q, _ = np.linalg.qr(rng.randn(3 * (K - 1), 30) * np.where(stiff, 0.1, 1.0)[:, None])
    pose_basis = q.T.astype(np.float32)
    pose_mean = (pose_basis.T @ (0.05 * rng.randn(30))).astype(np.float32)

    extra = np.zeros((V, 3, 10), np.float32)
    for s in range(10):
        freq = rng.uniform(10.0, 40.0, size=3)
        phase = rng.uniform(0, 2 * np.pi)
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        extra[:, :, s] = 0.003 * np.sin(v @ freq + phase)[:, None] * axis
    shapedirs = np.concatenate([skin.shapedirs, extra], axis=2)

    d = np.linalg.norm(mano.v_template[:, None, :] - v[None], axis=2)
    vreg_idx = np.argsort(d, axis=1, kind="stable")[:, :3]
    wv = 1.0 / (np.take_along_axis(d, vreg_idx, 1) + 1e-4)
    vreg_w = (wv / wv.sum(1, keepdims=True)).astype(np.float32)

    return NimbleModel(
        v_template=v, shapedirs=shapedirs, weights=weights, faces=skin.faces,
        J_regressor=J_reg, parents=parents, pose_basis=pose_basis, pose_mean=pose_mean,
        mano_vreg_idx=vreg_idx.astype(np.int32), mano_vreg_w=vreg_w,
        mano_J_regressor=mano.J_regressor, mano_tips_idx=mano.tips_idx,
        mano_joint_reorder=JOINT_REORDER, ncomps=30, nshape=20)


def build_published_assets(seed: int, uv_size: int):
    """The published stand-in as the reference's AvatarAssets, not
    subdivided, its UV atlas and uv mask made as the hand's are."""
    model = build_published_nimble(seed)
    return ref_assets._synthetic_avatar(model, model.faces, model.num_verts, model.v_template,
                                        uv_size, subdivide=False)
