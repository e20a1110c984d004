"""Assets (harp_tpu/assets.py): model-file loaders and synthetic stand-ins.

The loaders read MANO pickles (chumpy objects replaced by stubs, no chumpy
needed), OBJ templates with wedge UVs and the SMPL-X arm correspondence
pickle into numpy. The build_synthetic_* functions make a procedural, deterministic
articulated hand (finger tubes + ellipsoid palm) with the MANO structure
(16-joint skeleton, blendshapes, skinning weights, UVs) and the SMPL-X arm
around it (the hand plus a forearm tube on the 55-joint skeleton). The
numpy code is a copy of harp_tpu's, so the arrays are identical.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np

from harp_tpu_torch.ops.mesh import MeshTopology, Subdivision, build_topology, build_subdivision
from harp_tpu_torch.models.mano import ManoModel, TIPS_LEFT, TIPS_RIGHT, JOINT_REORDER

MANO_PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14])


# ---------------------------------------------------------------------------
# Model-file loaders
# ---------------------------------------------------------------------------


def _load_pickle_no_chumpy(path: str):
    """Unpickle a file that may contain chumpy objects, without chumpy:
    chumpy classes become stubs whose state `_to_numpy` reads."""

    class _ChStub:
        def __setstate__(self, state):
            if isinstance(state, dict):
                self.__dict__.update(state)

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("chumpy"):
                return type(name, (_ChStub,), {})
            return super().find_class(module, name)

    with open(path, "rb") as f:
        return _Unpickler(f, encoding="latin1").load()


def _to_numpy(x) -> np.ndarray:
    """An ndarray, a scipy sparse matrix (densified) or a chumpy stub (the
    array in its state, chumpy keeps it under `x`) -> ndarray."""
    import scipy.sparse as sp

    if isinstance(x, np.ndarray):
        return x
    if sp.issparse(x):
        return np.asarray(x.todense())
    if hasattr(x, "__dict__"):
        d = x.__dict__
        for key in ("x", "a", "v"):
            if key in d:
                return _to_numpy(d[key])
        for v in d.values():
            if isinstance(v, np.ndarray) and v.size > 1:
                return v
    return np.asarray(x)


def load_mano_model(path: str, side: str = "right", use_pca: bool = False,
                    ncomps: int = 45, flat_hand_mean: bool = False) -> ManoModel:
    """MANO_RIGHT.pkl / MANO_LEFT.pkl -> ManoModel."""
    dd = _load_pickle_no_chumpy(path)
    parents = np.asarray(dd["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    return ManoModel(
        v_template=_to_numpy(dd["v_template"]).astype(np.float32),
        shapedirs=_to_numpy(dd["shapedirs"]).astype(np.float32),
        posedirs=_to_numpy(dd["posedirs"]).astype(np.float32),
        J_regressor=_to_numpy(dd["J_regressor"]).astype(np.float32),
        weights=_to_numpy(dd["weights"]).astype(np.float32),
        faces=np.asarray(dd["f"]).astype(np.int32),
        parents=parents,
        hands_components=_to_numpy(dd["hands_components"]).astype(np.float32),
        hands_mean=_to_numpy(dd["hands_mean"]).astype(np.float32),
        tips_idx=TIPS_RIGHT if side == "right" else TIPS_LEFT,
        joint_reorder=JOINT_REORDER,
        use_pca=use_pca,
        ncomps=ncomps if use_pca else 45,
        flat_hand_mean=flat_hand_mean,
    )


def load_obj_with_uv(path: str):
    """An OBJ with UVs -> (verts, faces, verts_uvs, faces_uvs): faces index
    the positions, faces_uvs the wedge UVs (pytorch3d load_obj's layout)."""
    verts, uvs, faces, faces_uvs = [], [], [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "vt":
                uvs.append([float(t[1]), float(t[2])])
            elif t[0] == "f":
                vi, ti = [], []
                for w in t[1:4]:
                    parts = w.split("/")
                    vi.append(int(parts[0]) - 1)
                    ti.append(int(parts[1]) - 1 if len(parts) > 1 and parts[1] else 0)
                faces.append(vi)
                faces_uvs.append(ti)
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
        np.asarray(uvs, np.float32),
        np.asarray(faces_uvs, np.int32),
    )


def load_arm_correspondence(path: str) -> dict:
    """smplx_arm_corr.pkl (the arm submesh and its MANO subset) -> dict of
    arrays."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return {k: np.asarray(v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# Synthetic hand (procedural, deterministic)
# ---------------------------------------------------------------------------


def _tube(centers: np.ndarray, radii: np.ndarray, n_ring: int = 8):
    """Closed tube along a polyline: rings + start/end cap vertices."""
    n = centers.shape[0]
    # Parallel-transport-ish frames: tangent + fixed helper axis.
    tangents = np.gradient(centers, axis=0)
    tangents /= np.linalg.norm(tangents, axis=1, keepdims=True) + 1e-9
    helper = np.array([0.0, 0.0, 1.0])
    verts = []
    for i in range(n):
        t = tangents[i]
        u = np.cross(helper, t)
        if np.linalg.norm(u) < 1e-6:
            u = np.cross(np.array([0.0, 1.0, 0.0]), t)
        u /= np.linalg.norm(u)
        w = np.cross(t, u)
        ang = 2 * np.pi * np.arange(n_ring) / n_ring
        ring = centers[i] + radii[i] * (np.cos(ang)[:, None] * u + np.sin(ang)[:, None] * w)
        verts.append(ring)
    start_cap = centers[0] - tangents[0] * radii[0]
    end_cap = centers[-1] + tangents[-1] * radii[-1]
    verts = np.concatenate(verts + [start_cap[None], end_cap[None]], 0)
    faces = []
    for i in range(n - 1):
        for j in range(n_ring):
            a = i * n_ring + j
            b = i * n_ring + (j + 1) % n_ring
            c = (i + 1) * n_ring + j
            d = (i + 1) * n_ring + (j + 1) % n_ring
            faces.append([a, c, b])
            faces.append([b, c, d])
    sc = n * n_ring
    ec = n * n_ring + 1
    for j in range(n_ring):
        faces.append([sc, j, (j + 1) % n_ring])
        faces.append([ec, (n - 1) * n_ring + (j + 1) % n_ring, (n - 1) * n_ring + j])
    return verts.astype(np.float32), np.asarray(faces, np.int64), ec


def _ellipsoid(center, radii, n_u: int = 10, n_v: int = 7):
    us = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    vs = np.linspace(0, np.pi, n_v)
    verts = []
    for v in vs[1:-1]:
        for u in us:
            verts.append(
                center
                + radii * np.array([np.sin(v) * np.cos(u), np.sin(v) * np.sin(u), np.cos(v)])
            )
    top = center + radii * np.array([0, 0, 1.0])
    bot = center - radii * np.array([0, 0, 1.0])
    verts = np.asarray(verts + [top, bot], np.float32)
    faces = []
    rows = n_v - 2
    for r in range(rows - 1):
        for u in range(n_u):
            a = r * n_u + u
            b = r * n_u + (u + 1) % n_u
            c = (r + 1) * n_u + u
            d = (r + 1) * n_u + (u + 1) % n_u
            faces.append([a, b, c])
            faces.append([b, d, c])
    ti = rows * n_u
    bi = rows * n_u + 1
    for u in range(n_u):
        faces.append([ti, (u + 1) % n_u, u])
        faces.append([bi, (rows - 1) * n_u + u, (rows - 1) * n_u + (u + 1) % n_u])
    return verts, np.asarray(faces, np.int64)


def _segment_distance(p: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance from points p (N,3) to segment a-b."""
    ab = b - a
    t = np.clip(((p - a) @ ab) / (ab @ ab + 1e-12), 0.0, 1.0)
    proj = a + t[:, None] * ab
    return np.linalg.norm(p - proj, axis=1)


def _resample_polyline(centers: np.ndarray, radii: np.ndarray, n: int):
    """Resample a polyline (+ per-point radii) to n arclength-uniform points."""
    if n == centers.shape[0]:
        return centers, radii
    d = np.linalg.norm(np.diff(centers, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(d)])
    t = np.linspace(0.0, s[-1], n)
    out_c = np.stack([np.interp(t, s, centers[:, i]) for i in range(3)], 1)
    return out_c.astype(centers.dtype), np.interp(t, s, radii)


# Mesh-density presets for the synthetic assets. "light" is the fast
# test-suite mesh; "reference" matches the reference workload's render-mesh
# density (hand 3093 verts / 6152 faces after 4-way subdivision from 778,
# arm 4083 / 8128): the procedural mesh lands at 3088 v / 6152 f (hand) and
# 4078 v / 8128 f (arm), the closed-manifold-reachable counts nearest the
# reference's.
HAND_DENSITY = {
    "light": dict(n_ring=8, chain_pts=5, palm_res=(10, 7)),
    "reference": dict(n_ring=12, chain_pts=10, palm_res=(13, 15)),
}
ARM_FOREARM_DENSITY = {
    # (ring verts, chain points) of the forearm tube.
    "light": dict(fore_ring=10, fore_pts=4),
    "reference": dict(fore_ring=19, fore_pts=13),
}


def build_synthetic_hand(n_ring: int = 8, seed: int = 0, chain_pts: int = 5,
                         palm_res: tuple = (10, 7)) -> ManoModel:
    """A deterministic articulated hand with MANO-compatible structure.

    16-joint MANO skeleton (wrist; index/middle/pinky/ring/thumb x 3), tube
    fingers + ellipsoid palm, distance-based skinning weights, 10 smooth shape
    blendshapes, small smooth pose-corrective blendshapes. Scale: meters,
    hand length ~0.19.
    """
    rng = np.random.RandomState(seed)

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
    # MANO joint order: wrist, index(1-3), middle(4-6), pinky(7-9), ring(10-12), thumb(13-15)
    order = ["index", "middle", "pinky", "ring", "thumb"]
    joints = [np.zeros(3)]
    finger_joint_ids = {}
    for fi, name in enumerate(order):
        d = finger_dirs[name] / np.linalg.norm(finger_dirs[name])
        base = np.array([base_x[name], finger_y[name], 0.0])
        ids = []
        p = base
        for s in seg_lens[name]:
            ids.append(len(joints))
            joints.append(p.copy())
            p = p + d * s
        finger_joint_ids[name] = (ids, p.copy())  # p = tip position
    joints = np.asarray(joints, np.float32)  # (16, 3)

    # Mesh: per-finger tube from palm edge through joints to tip + palm.
    all_verts, all_faces = [], []
    tip_vertex = {}
    offset = 0
    for name in order:
        ids, tip = finger_joint_ids[name]
        chain = np.stack(
            [joints[ids[0]] * 0.45 + np.array([0.02, 0, 0]) * 0.0]
            + [joints[i] for i in ids]
            + [tip],
            0,
        )
        chain[0] = joints[ids[0]] - (joints[ids[1]] - joints[ids[0]])  # palm-side stub
        radii = np.linspace(0.0085, 0.0055, chain.shape[0])
        if name == "thumb":
            radii *= 1.25
        chain, radii = _resample_polyline(chain, radii, chain_pts)
        v, f, end_cap = _tube(chain, radii, n_ring)
        all_verts.append(v)
        all_faces.append(f + offset)
        tip_vertex[name] = offset + end_cap
        offset += v.shape[0]
    pv, pf = _ellipsoid(np.array([0.045, 0.0, 0.0]), np.array([0.058, 0.042, 0.016]),
                        n_u=palm_res[0], n_v=palm_res[1])
    all_verts.append(pv)
    all_faces.append(pf + offset)

    v_template = np.concatenate(all_verts, 0).astype(np.float32)
    faces = np.concatenate(all_faces, 0).astype(np.int32)
    V, K = v_template.shape[0], 16

    # Skinning: bone j spans joint j -> its child (or tip); root bone = palm.
    bone_a, bone_b = [], []
    for j in range(K):
        if j == 0:
            bone_a.append(np.array([0.0, 0, 0]))
            bone_b.append(np.array([0.085, 0, 0]))
            continue
        child = [c for c in range(K) if MANO_PARENTS[c] == j]
        a = joints[j]
        if child:
            b = joints[child[0]]
        else:
            name = order[(j - 1) // 3]
            b = finger_joint_ids[name][1]
        bone_a.append(a)
        bone_b.append(b)
    dists = np.stack(
        [_segment_distance(v_template, bone_a[j], bone_b[j]) for j in range(K)], 1
    )  # (V, K)
    w = np.exp(-((dists / 0.012) ** 2))
    # keep top-2 bones per vertex
    top2 = np.argsort(-w, axis=1)[:, :2]
    keep = np.zeros_like(w)
    np.put_along_axis(keep, top2, np.take_along_axis(w, top2, 1), 1)
    keep += 1e-8 * (np.arange(K) == 0)  # fall back to root
    weights = (keep / keep.sum(1, keepdims=True)).astype(np.float32)

    # Joint regressor: inverse-distance over 8 nearest verts.
    J_reg = np.zeros((K, V), np.float32)
    for j in range(K):
        d = np.linalg.norm(v_template - joints[j], axis=1)
        idx = np.argsort(d)[:8]
        wj = 1.0 / (d[idx] + 1e-4)
        J_reg[j, idx] = wj / wj.sum()

    # Blendshapes: mode0 = global scale; others smooth sinusoids.
    S = 10
    shapedirs = np.zeros((V, 3, S), np.float32)
    centroid = v_template.mean(0)
    shapedirs[:, :, 0] = v_template - centroid
    for s in range(1, S):
        freq = rng.uniform(10.0, 40.0, size=3)
        phase = rng.uniform(0, 2 * np.pi, size=3)
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        field = np.sin(v_template @ freq + phase[0])
        shapedirs[:, :, s] = 0.003 * field[:, None] * axis
    P = 9 * (K - 1)
    posedirs = (0.0002 * rng.randn(V, 3, P)).astype(np.float32)

    tips_idx = np.array(
        [tip_vertex["thumb"], tip_vertex["index"], tip_vertex["middle"],
         tip_vertex["ring"], tip_vertex["pinky"]]
    )

    return ManoModel(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        J_regressor=J_reg,
        weights=weights,
        faces=faces,
        parents=MANO_PARENTS.copy(),
        hands_components=np.eye(45, dtype=np.float32),
        hands_mean=np.zeros(45, np.float32),
        tips_idx=tips_idx,
        joint_reorder=JOINT_REORDER,
        use_pca=False,
        ncomps=45,
        flat_hand_mean=True,
    )



@dataclasses.dataclass(frozen=True)
class AvatarAssets:
    """Everything static the forward renderer needs."""

    model: ManoModel
    coarse_topology: MeshTopology
    subdivision: Subdivision | None
    sub_topology: MeshTopology  # topology of the render mesh (post-subdiv)
    verts_uvs: np.ndarray  # (U, 2) wedge UV coordinates
    faces_uvs: np.ndarray  # (F_render, 3) into verts_uvs
    uv_mask: np.ndarray  # (H_uv, W_uv) float mask of valid texture area

    @property
    def num_render_verts(self) -> int:
        return self.sub_topology.num_verts

    @property
    def render_faces(self) -> np.ndarray:
        return self.sub_topology.faces


def _planar_uv_atlas(verts: np.ndarray, faces: np.ndarray, components: list[np.ndarray],
                     grid=(3, 2)) -> np.ndarray:
    """Per-vertex UVs: planar-project each component into an atlas cell."""
    uvs = np.zeros((verts.shape[0], 2), np.float32)
    gx, gy = grid
    for ci, vid in enumerate(components):
        cell = (ci % gx, ci // gx)
        p = verts[vid][:, :2]
        lo, hi = p.min(0), p.max(0)
        span = np.maximum(hi - lo, 1e-6)
        local = (p - lo) / span  # [0,1]^2
        margin = 0.06
        local = margin + local * (1 - 2 * margin)
        uvs[vid, 0] = (cell[0] + local[:, 0]) / gx
        uvs[vid, 1] = (cell[1] + local[:, 1]) / gy
    return uvs


def _connected_components(num_verts: int, faces: np.ndarray) -> list[np.ndarray]:
    parent = np.arange(num_verts)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for f in faces:
        a = find(f[0])
        for b in (f[1], f[2]):
            rb = find(b)
            parent[rb] = a
    roots = np.array([find(i) for i in range(num_verts)])
    return [np.nonzero(roots == r)[0] for r in np.unique(roots)]


def _synthetic_avatar(model, faces, num_verts: int, template: np.ndarray,
                      uv_size: int, subdivide: bool) -> AvatarAssets:
    """A synthetic model wrapped as AvatarAssets: the coarse mesh `faces`
    over `num_verts` vertices (rest positions `template`), subdivided or
    not, with a planar UV atlas per connected component and a uv mask that
    marks the texels under each face's UV box."""
    coarse = build_topology(faces, num_verts)
    if subdivide:
        sub = build_subdivision(coarse)
        render_faces = sub.faces
        num_render_verts = sub.num_verts
        # Subdivided template verts for UV generation.
        verts_sub = np.concatenate(
            [template, 0.5 * (template[sub.edge_src[:, 0]] + template[sub.edge_src[:, 1]])],
            0,
        )
    else:
        sub = None
        render_faces = faces
        num_render_verts = num_verts
        verts_sub = template
    sub_topology = build_topology(render_faces, num_render_verts)
    comps = _connected_components(num_render_verts, render_faces)
    verts_uvs = _planar_uv_atlas(verts_sub, render_faces, comps)
    faces_uvs = render_faces.copy()

    # UV mask: mark texels covered by any face (coarse splat of face bboxes).
    mask = np.zeros((uv_size, uv_size), np.float32)
    tri = verts_uvs[faces_uvs]  # (F, 3, 2)
    lo = np.clip((tri.min(1) * uv_size).astype(int), 0, uv_size - 1)
    hi = np.clip(np.ceil(tri.max(1) * uv_size).astype(int), 1, uv_size)
    for (x0, y0), (x1, y1) in zip(lo, hi):
        # uv origin bottom-left -> texture row index flips v
        mask[uv_size - y1 : uv_size - y0, x0:x1] = 1.0

    return AvatarAssets(
        model=model,
        coarse_topology=coarse,
        subdivision=sub,
        sub_topology=sub_topology,
        verts_uvs=verts_uvs,
        faces_uvs=faces_uvs,
        uv_mask=mask,
    )


def build_synthetic_assets(n_ring: int = 8, seed: int = 0, uv_size: int = 128,
                           subdivide: bool = True,
                           density: str | None = None) -> AvatarAssets:
    """Synthetic hand + subdivision + planar UV atlas + uv mask.

    density: "light" (test mesh, 1012 render verts / 2000 faces) or
    "reference" (3088 / 6152 — the reference workload density, the
    bench/entry/protocol default). None keeps the explicit n_ring."""
    kw = dict(HAND_DENSITY[density]) if density else dict(n_ring=n_ring)
    model = build_synthetic_hand(seed=seed, **kw)
    return _synthetic_avatar(model, model.faces, model.num_verts, model.v_template,
                             uv_size, subdivide)


# ---------------------------------------------------------------------------
# Synthetic SMPL-X arm (hand + forearm on the 55-joint skeleton)
# ---------------------------------------------------------------------------


def build_synthetic_arm(n_ring: int = 8, seed: int = 0, density: str | None = None):
    """A synthetic SmplxArmModel: the procedural hand + a forearm tube placed
    on the 55-joint SMPL-X skeleton (only the right-arm chain is
    geometrically meaningful; other joints are inert). It runs the arm's
    code path without the registration-gated SMPLX_NEUTRAL.npz."""
    from harp_tpu_torch.models.smplx_arm import (
        EXTRA_JOINT_NAMES, NUM_JOINTS, SMPLX_PARENTS, SmplxArmModel,
    )

    rng = np.random.RandomState(seed + 17)
    hand_kw = dict(HAND_DENSITY[density]) if density else dict(n_ring=n_ring)
    hand = build_synthetic_hand(seed=seed, **hand_kw)
    n_hand = hand.num_verts

    # Forearm: tube from just behind the wrist toward -x (elbow at -0.26).
    chain = np.stack(
        [np.array([-0.26, 0.0, 0.0]), np.array([-0.17, 0.0, 0.0]),
         np.array([-0.08, 0.0, 0.0]), np.array([0.01, 0.0, 0.0])], 0
    )
    radii = np.array([0.030, 0.032, 0.034, 0.036])
    if density:
        fkw = ARM_FOREARM_DENSITY[density]
        fore_ring, fore_pts = fkw["fore_ring"], fkw["fore_pts"]
    else:
        fore_ring, fore_pts = n_ring + 2, 4
    chain, radii = _resample_polyline(chain, radii, fore_pts)
    fa_verts, fa_faces, _ = _tube(chain, radii, fore_ring)
    n_fore = fa_verts.shape[0]

    # Dummy "rest of body" verts (excluded from the arm submesh).
    dummy = np.array([[0.0, -0.8, 0.0], [0.1, -0.8, 0.0], [0.0, -0.9, 0.1]], np.float32)
    v_template = np.concatenate([hand.v_template, fa_verts, dummy], 0)
    V = v_template.shape[0]
    K = NUM_JOINTS

    # Skinning: hand weights map onto SMPL-X columns (wrist 0 -> 21,
    # finger joint j in 1..15 -> 39 + j, same finger ordering).
    weights = np.zeros((V, K), np.float32)
    weights[:n_hand, 21] = hand.weights[:, 0]
    for j in range(1, 16):
        weights[:n_hand, 39 + j] = hand.weights[:, j]
    # Forearm: blend elbow(19) <-> wrist(21) along x.
    t = np.clip((fa_verts[:, 0] + 0.26) / 0.27, 0, 1)
    weights[n_hand : n_hand + n_fore, 19] = 1 - t
    weights[n_hand : n_hand + n_fore, 21] = t
    weights[n_hand + n_fore :, 0] = 1.0
    weights /= weights.sum(1, keepdims=True)

    # Joint regressor.
    J_reg = np.zeros((K, V), np.float32)
    J_reg[21, :n_hand] = hand.J_regressor[0]
    for j in range(1, 16):
        J_reg[39 + j, :n_hand] = hand.J_regressor[j]
    # Elbow: mean of the first forearm ring.
    J_reg[19, n_hand : n_hand + fore_ring] = 1.0 / fore_ring
    # Pelvis / shoulder chain anchored at the dummies (inert but defined).
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
    expr_dirs = np.zeros((V, 3, 10), np.float32)
    posedirs = (0.0001 * rng.randn(V, 3, 9 * (K - 1))).astype(np.float32)

    # Extra joints: right-hand tips of the synthetic hand; the rest point at
    # a dummy vertex (never selected by joint_idx).
    tip_map = {"rthumb": 0, "rindex": 1, "rmiddle": 2, "rring": 3, "rpinky": 4}
    extra_ids = np.zeros(len(EXTRA_JOINT_NAMES), np.int64) + (V - 1)
    for name, k in tip_map.items():
        extra_ids[EXTRA_JOINT_NAMES.index(name)] = hand.tips_idx[k]

    arm_vert_idx = np.arange(n_hand + n_fore)
    mano_vert_from_arm = np.arange(n_hand)
    arm_faces = np.concatenate([hand.faces, fa_faces + n_hand], 0).astype(np.int32)
    # Output joints in MANO viz order + tips + elbow (the real
    # smplx_arm_corr.pkl 'mano_joint' layout).
    joint_idx = np.array(
        [21, 52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45, 73,
         49, 50, 51, 74, 46, 47, 48, 75, 19]
    )

    return SmplxArmModel(
        v_template=v_template,
        shapedirs=shapedirs,
        expr_dirs=expr_dirs,
        posedirs=posedirs,
        J_regressor=J_reg,
        weights=weights,
        parents=SMPLX_PARENTS.copy(),
        pose_mean=np.zeros(165, np.float32),
        extra_joint_vertex_ids=extra_ids,
        arm_vert_idx=arm_vert_idx,
        mano_vert_from_arm=mano_vert_from_arm,
        arm_faces=arm_faces,
        mano_faces=hand.faces.copy(),
        joint_idx=joint_idx,
    )


def build_synthetic_arm_assets(n_ring: int = 8, seed: int = 0, uv_size: int = 128,
                               subdivide: bool = True,
                               density: str | None = None) -> AvatarAssets:
    """The synthetic arm as renderable AvatarAssets (the use_arm path).

    density: "light" (test mesh) or "reference" (4078 render verts / 8128
    faces — the reference arm workload density)."""
    model = build_synthetic_arm(n_ring=n_ring, seed=seed, density=density)
    n_arm = model.arm_vert_idx.shape[0]
    return _synthetic_avatar(model, model.arm_faces, n_arm,
                             model.v_template[model.arm_vert_idx], uv_size, subdivide)
