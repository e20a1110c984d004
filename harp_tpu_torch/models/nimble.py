"""NIMBLE hand model (harp_tpu/models/nimble.py).

NIMBLE is a three-layer anatomical hand model: bone, muscle and skin
meshes driven by one 25-joint skeleton, with a 30-component PCA pose
space and a 20-component shape space. This module reads the release's
files (NIMBLE_DICT_9137.pkl / NIMBLE_MANO_VREG.pkl, registration-gated):

- `NimbleModel`: the numpy asset struct;
- `nimble_forward`: PCA pose -> axis-angle -> FK -> LBS of the skin (or
  muscle or bone) layer, on the shared LBS engine of models/lbs.py;
- `nimble_to_mano`: the MANO-topology surface regressed from the skin
  vertices (NIMBLE_MANO_VREG); every skin vertex feeds several MANO
  vertices, so the gather goes through ops.segment.gather_table (its
  backward sums the repeats in an order fixed once per model);
- `mano_protocol_joints`: the 21 MANO-protocol joints of that surface;
- `build_synthetic_nimble`: a procedural stand-in of the same structure.

The fit renders the skin layer only.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from harp_tpu_torch.device import constant
from harp_tpu_torch.models.lbs import forward_kinematics, kinematic_levels, linear_blend_skinning
from harp_tpu_torch.ops.rotations import axis_angle_to_matrix
from harp_tpu_torch.ops.segment import TableOrder, gather_table


@dataclasses.dataclass(frozen=True)
class NimbleModel:
    """Static NIMBLE assets (numpy)."""

    # Skin layer (the rendered surface).
    v_template: np.ndarray  # (V, 3)
    shapedirs: np.ndarray  # (V, 3, S) shape PCA (S=20 in the release)
    weights: np.ndarray  # (V, K) skinning weights
    faces: np.ndarray  # (F, 3)
    # Skeleton.
    J_regressor: np.ndarray  # (K, V) joints from skin verts
    parents: np.ndarray  # (K,)
    # Pose PCA: coeffs (P,) -> axis-angle of the K-1 non-root joints.
    pose_basis: np.ndarray  # (P, (K-1)*3), rows = components
    pose_mean: np.ndarray  # ((K-1)*3,)
    # Optional anatomical layers (same skeleton, own verts/weights).
    muscle_v_template: np.ndarray | None = None
    muscle_weights: np.ndarray | None = None
    bone_v_template: np.ndarray | None = None
    bone_weights: np.ndarray | None = None
    # MANO-surface regression (NIMBLE_MANO_VREG): mano_vert[i] =
    # sum_j vreg_w[i, j] * skin_v[vreg_idx[i, j]].
    mano_vreg_idx: np.ndarray | None = None  # (Vm, nk) int
    mano_vreg_w: np.ndarray | None = None  # (Vm, nk)
    # MANO-protocol joint extraction from the regressed surface.
    mano_J_regressor: np.ndarray | None = None  # (16, Vm)
    mano_tips_idx: np.ndarray | None = None  # (5,)
    mano_joint_reorder: np.ndarray | None = None  # (21,)
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
    def vreg_order(self) -> TableOrder | None:
        if self.mano_vreg_idx is None:
            return None
        return TableOrder.of(self.mano_vreg_idx, self.num_verts)


def nimble_forward(model: NimbleModel, pose_coeffs: torch.Tensor, betas: torch.Tensor,
                   trans: torch.Tensor, global_scale=None, layer: str = "skin"):
    """pose_coeffs (B, 3 + ncomps) [global rot axis-angle | pose PCA
    coeffs], betas (B, nshape), trans (B, 3) metres, optional global_scale
    (B,) or scalar about the root, `layer` the anatomical layer to skin ->
    (verts (B, V_layer, 3) mm, joints (B, K, 3) mm)."""
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

    if layer == "skin":
        v_rest, weights = v_shaped, model.weights
    elif layer in ("muscle", "bone"):
        template = getattr(model, f"{layer}_v_template")
        if template is None:
            raise ValueError(f"no {layer} layer loaded")
        v_rest = const(template)[None].expand((B,) + template.shape)
        weights = getattr(model, f"{layer}_weights")
    else:
        raise ValueError(f"unknown layer {layer!r}")

    verts = linear_blend_skinning(R_g, t_g, joints_rest, const(weights), v_rest)
    joints = t_g

    if global_scale is not None:
        s = torch.as_tensor(global_scale, dtype=f32, device=dev).reshape(-1, 1, 1)
        root = joints[:, :1]
        verts = root + (verts - root) * s
        joints = root + (joints - root) * s

    verts = (verts + trans[:, None, :]) * 1000.0
    joints = (joints + trans[:, None, :]) * 1000.0
    return verts, joints


def nimble_to_mano(model: NimbleModel, skin_verts: torch.Tensor) -> torch.Tensor:
    """The MANO-topology surface (B, Vm, 3) regressed from skin vertices
    (B, V, 3)."""
    if model.vreg_order is None:
        raise ValueError("model has no MANO regression")
    Vm, nk = model.mano_vreg_idx.shape
    rows = gather_table(skin_verts, model.vreg_order).reshape(-1, Vm, nk, 3)
    w = constant(model.mano_vreg_w, skin_verts.device, skin_verts.dtype)
    return torch.einsum("bvkc,vk->bvc", rows, w)


def mano_protocol_joints(model: NimbleModel, mano_verts: torch.Tensor) -> torch.Tensor:
    """21 MANO-protocol joints (16 skeleton + 5 fingertips, reordered) of
    the regressed MANO surface: the joint convention of the keypoint loss
    for every model family."""
    dev = mano_verts.device
    J = torch.einsum("kv,bvc->bkc",
                     constant(model.mano_J_regressor, dev, mano_verts.dtype),
                     mano_verts)
    tips = mano_verts[:, constant(model.mano_tips_idx, dev, np.int64)]
    joints = torch.cat([J, tips], 1)
    return joints[:, constant(model.mano_joint_reorder, dev, np.int64)]


def load_nimble_model(pm_dict_pkl: str, vreg_pkl: str | None = None) -> NimbleModel:
    """The NIMBLE release files -> NimbleModel. NIMBLE_DICT_9137.pkl's keys:
    vert (skin template), skin_f, shape_basis, pose_basis, pose_mean, sw
    (skinning weights), jreg (joint regressor), parent (other spellings
    accepted); NIMBLE_MANO_VREG.pkl: per-vertex (index, weight) arrays.
    A missing key raises a KeyError that names it."""
    import pickle

    with open(pm_dict_pkl, "rb") as f:
        d = pickle.load(f, encoding="latin1")

    def need(*names):
        for n in names:
            if n in d:
                return np.asarray(d[n])
        raise KeyError(f"NIMBLE dict is missing {names}; available: {sorted(d)[:20]}")

    v = need("vert", "skin_v_sealed", "skin_v").astype(np.float32)
    kwargs: dict = {}
    if vreg_pkl is not None:
        with open(vreg_pkl, "rb") as f:
            vr = pickle.load(f, encoding="latin1")
        kwargs["mano_vreg_idx"] = np.asarray(
            vr["idx"] if "idx" in vr else vr["lmk_faces_idx"]).astype(np.int32)
        kwargs["mano_vreg_w"] = np.asarray(
            vr["weight"] if "weight" in vr else vr["lmk_bary_coords"]).astype(np.float32)
    return NimbleModel(
        v_template=v,
        shapedirs=need("shape_basis", "shapedirs").astype(np.float32),
        weights=need("sw", "weights").astype(np.float32),
        faces=need("skin_f", "faces").astype(np.int32),
        J_regressor=need("jreg", "J_regressor").astype(np.float32),
        parents=need("parent", "parents").astype(np.int64).reshape(-1),
        pose_basis=need("pose_basis").astype(np.float32),
        pose_mean=need("pose_mean").astype(np.float32).reshape(-1),
        **kwargs,
    )


def build_synthetic_nimble(seed: int = 0) -> NimbleModel:
    """A NIMBLE-structured model from the synthetic hand: its mesh is the
    skin layer, shrunken copies the muscle and bone layers, the pose PCA 30
    random orthogonal directions of the 45-dof axis-angle space, 20 smooth
    shape directions, and each "MANO" vertex a blend of 2 skin vertices."""
    from harp_tpu_torch.assets import build_synthetic_hand
    from harp_tpu_torch.models.mano import JOINT_REORDER

    m = build_synthetic_hand(n_ring=8, seed=seed)
    rng = np.random.RandomState(seed + 101)
    V = m.v_template.shape[0]

    q, _ = np.linalg.qr(rng.randn(45, 45))
    pose_basis = q[:30].astype(np.float32)  # (30, 45)
    # Mean inside the basis span: the identity pose is then exactly
    # representable by PCA coefficients.
    pose_mean = (pose_basis.T @ (0.05 * rng.randn(30))).astype(np.float32)

    extra = 0.002 * rng.randn(V, 3, 10).astype(np.float32)
    shapedirs = np.concatenate([m.shapedirs, extra], axis=2).astype(np.float32)

    centroid = m.v_template.mean(0, keepdims=True)
    bone_v = (centroid + 0.6 * (m.v_template - centroid)).astype(np.float32)

    vreg_idx = np.stack([np.arange(V), (np.arange(V) + 1) % V], axis=1).astype(np.int32)
    w = rng.uniform(0.7, 1.0, (V, 1)).astype(np.float32)
    vreg_w = np.concatenate([w, 1.0 - w], axis=1)

    return NimbleModel(
        v_template=m.v_template,
        shapedirs=shapedirs,
        weights=m.weights,
        faces=m.faces,
        J_regressor=m.J_regressor,
        parents=m.parents,
        pose_basis=pose_basis,
        pose_mean=pose_mean,
        muscle_v_template=(centroid + 0.8 * (m.v_template - centroid)).astype(np.float32),
        muscle_weights=m.weights,
        bone_v_template=bone_v,
        bone_weights=m.weights,
        mano_vreg_idx=vreg_idx,
        mano_vreg_w=vreg_w,
        mano_J_regressor=m.J_regressor,
        mano_tips_idx=m.tips_idx,
        mano_joint_reorder=JOINT_REORDER,
        ncomps=30,
        nshape=20,
    )
