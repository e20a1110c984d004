"""FreiHAND helpers (harp_tpu/utils/fh_utils.py): annotation loading, the
dataset's pinhole projection, sample-version indices and a skeleton mask
drawn without matplotlib."""

from __future__ import annotations

import json
import os

import numpy as np

SAMPLE_VERSIONS = {"gs": 0, "hom": 1, "sample": 2, "auto": 3}
DB_SIZE = 32560  # FreiHAND training split size per version


def load_db_annotation(base_path: str, set_name: str = "training"):
    """(K, mano, xyz) triples from {set_name}_K / _mano / _xyz.json."""
    def _json(name):
        with open(os.path.join(base_path, f"{set_name}_{name}.json")) as f:
            return json.load(f)

    return list(zip(_json("K"), _json("mano"), _json("xyz")))


def project_points(xyz: np.ndarray, K: np.ndarray) -> np.ndarray:
    """3D points (N, 3) -> pixels (N, 2) through the intrinsic matrix K."""
    uv = (np.asarray(K) @ np.asarray(xyz).T).T
    return uv[:, :2] / uv[:, 2:3]


def sample_version_index(idx: int, version: str = "gs") -> int:
    """The index of base sample `idx` in a rendered sample version."""
    return SAMPLE_VERSIONS[version] * DB_SIZE + idx


def kp_connections():
    """Hand skeleton edges in the FreiHAND / MANO 21-keypoint order."""
    return [(0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
            (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15), (15, 16),
            (0, 17), (17, 18), (18, 19), (19, 20)]


def draw_skeleton_mask(uv: np.ndarray, image_size: int, radius: int = 2) -> np.ndarray:
    """Keypoints as (2 radius + 1)^2 squares and bones as 32 samples each,
    drawn into a binary float32 image."""
    img = np.zeros((image_size, image_size), np.float32)
    uv = np.asarray(uv)

    def disk(cx, cy):
        x0, x1 = int(max(cx - radius, 0)), int(min(cx + radius + 1, image_size))
        y0, y1 = int(max(cy - radius, 0)), int(min(cy + radius + 1, image_size))
        img[y0:y1, x0:x1] = 1.0

    for u, v in uv:
        if 0 <= u < image_size and 0 <= v < image_size:
            disk(u, v)
    for a, b in kp_connections():
        pa, pb = uv[a], uv[b]
        for t in np.linspace(0, 1, 32):
            p = pa * (1 - t) + pb * t
            if 0 <= p[0] < image_size and 0 <= p[1] < image_size:
                img[int(p[1]), int(p[0])] = 1.0
    return img
