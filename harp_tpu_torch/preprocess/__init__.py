"""Preprocessing (harp_tpu/preprocess): the Unscreen crop of raw frames,
and the fits to METRO's output and its smoothers."""

from harp_tpu_torch.preprocess.crop import (
    crop_frame,
    crop_unscreen_sequence,
    resize_center_crop,
)
from harp_tpu_torch.preprocess.fit import (
    fit_arm_to_vertices,
    fit_mano_to_vertices,
    fit_nimble_to_vertices,
    remove_spike,
    smooth_camera_sequence,
    smooth_pose_sequence,
)
