"""Frozen plain copy of harp_tpu_torch/ops/rotations.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

Rotation representations (harp_tpu/ops/rotations.py), batched over
leading axes and differentiable."""

from __future__ import annotations

import torch


def axis_angle_to_quaternion(axisang: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 4) quaternion (w, x, y, z); the angle is
    the norm of (v + 1e-8), as the MANO layer's Rodrigues path does."""
    angle = torch.linalg.vector_norm(axisang + 1e-8, dim=-1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z) -> (..., 3, 3), normalised first."""
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = quat.unbind(-1)
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def axis_angle_to_matrix(axisang: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation matrix (quaternion path)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axisang))


def flat_pose_map(rotmats: torch.Tensor) -> torch.Tensor:
    """(..., K, 3, 3) -> (..., K*9) of (R - I): the pose-corrective feature."""
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    delta = rotmats - eye
    return delta.reshape(delta.shape[:-3] + (-1,))

