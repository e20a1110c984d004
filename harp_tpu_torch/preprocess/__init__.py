"""Preprocessing of METRO's output (harp_tpu/preprocess without crop.py,
whose PIL resize and paste are not ported yet)."""

from harp_tpu_torch.preprocess.fit import (
    fit_arm_to_vertices,
    fit_mano_to_vertices,
    fit_nimble_to_vertices,
    remove_spike,
    smooth_camera_sequence,
    smooth_pose_sequence,
)
