"""Camera model (harp_tpu/render/camera.py): weak-perspective METRO cameras
-> screen-space projection.

world -> view: X_v = X_w @ R + T (row vectors), R = diag(-1, -1, 1),
T = (-tx, -ty, 2f / (size*s)); view -> screen: u = f*x/z + size/2,
v = f*y/z + size/2 (pixel centres at +0.5).
"""

from __future__ import annotations

import numpy as np
import torch

from harp_tpu_torch.ops.numerics import safe_norm, safe_normalize

OPENCV_TO_P3D_R = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)


def weak_perspective_to_translation(cam: torch.Tensor, focal: float,
                                    image_size: int) -> torch.Tensor:
    """(B, 3) METRO cam (s, tx, ty) -> (B, 3) camera translation T."""
    s, tx, ty = cam[:, 0], cam[:, 1], cam[:, 2]
    tz = 2.0 * focal / (image_size * s + 1e-9)
    return torch.stack([-tx, -ty, tz], dim=1)


def world_to_view(verts: torch.Tensor, R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) @ (B, 3, 3) + (B, 3), row-vector convention."""
    return torch.einsum("bvj,bjk->bvk", verts, R) + T[:, None, :]


def view_to_screen(view: torch.Tensor, focal: float, image_size: int) -> torch.Tensor:
    """(B, V, 3) view -> (B, V, 3) (u_px, v_px, z_view)."""
    z = view[..., 2]
    half = image_size / 2.0
    u = focal * view[..., 0] / z + half
    v = focal * view[..., 1] / z + half
    return torch.stack([u, v, z], dim=-1)


def screen_from_world(verts, R, T, focal: float, image_size: int) -> torch.Tensor:
    return view_to_screen(world_to_view(verts, R, T), focal, image_size)


def look_at_rotation(camera_position: torch.Tensor, at: torch.Tensor,
                     up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """(B, 3) positions -> (B, 3, 3) R whose columns are the camera axes
    (pytorch3d look_at_rotation)."""
    up = torch.as_tensor(up, dtype=camera_position.dtype,
                         device=camera_position.device).expand_as(camera_position)
    z = at - camera_position
    z = z / torch.clamp(safe_norm(z, dim=-1, keepdim=True), min=1e-5)
    x = torch.linalg.cross(up, z, dim=-1)
    xn = safe_norm(x, dim=-1, keepdim=True)
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=z.dtype, device=z.device)
    x = torch.where(xn < 1e-5, x_axis, x / torch.clamp(xn, min=1e-12))
    y = safe_normalize(torch.linalg.cross(z, x, dim=-1))
    return torch.stack([x, y, z], dim=-1)


def translation_for_position(R: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
    """T such that world_to_view(X) = (X - position) @ R."""
    return -torch.einsum("bj,bjk->bk", position, R)


def camera_center(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """World-space camera centre: C = -T @ R^T."""
    return -torch.einsum("bj,bkj->bk", T, R)
