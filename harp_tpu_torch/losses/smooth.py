"""Temporal smoothness losses (harp_tpu/losses/smooth.py): the 3-frame
interpolation of root-aligned joints and of camera-relative roots, with
the interpolation (and the roots' joint offset) detached."""

from __future__ import annotations

import torch


def neighbor_fids(fids: torch.Tensor, n_frames: int):
    """fid - 1 / fid + 1, clamped at the sequence's ends."""
    left = torch.where(fids % n_frames == 0, fids, fids - 1)
    right = torch.where(fids % n_frames == n_frames - 1, fids, fids + 1)
    return left, right


def smooth_poses_loss(joints, joints_left, joints_right):
    """Root-aligned joints (B, J, 3) mm against their detached 3-frame mean."""
    def root_align(j):
        return j - j[:, 0:1]

    j = root_align(joints)
    interp = ((root_align(joints_left) + j + root_align(joints_right)) / 3.0).detach()
    return torch.sum((j - interp) ** 2) / joints.shape[0]


def smooth_roots_loss(joints, joints_left, joints_right, cam, cam_left, cam_right,
                      focal_length: float, image_size: int):
    """Camera-relative roots against their detached 3-frame mean. As in the
    reference, the weak-perspective (tx, ty) enter un-negated."""
    def cam_rel(c, j):
        t = torch.stack([c[:, 1], c[:, 2],
                         2 * focal_length / (image_size * c[:, 0] + 1e-9)], 1)
        return t + j[:, 0].detach() / 1000.0

    r = cam_rel(cam, joints)
    interp = ((cam_rel(cam_left, joints_left) + r + cam_rel(cam_right, joints_right))
              / 3.0).detach()
    return torch.sum((r - interp) ** 2) / joints.shape[0]
