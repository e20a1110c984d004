"""Frozen plain copy of harp_tpu_torch/fit/params.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

Parameter initialisation (harp_tpu/fit/params.py): per-frame parameters
are stacked (N, ...) leaf tensors with requires_grad."""

from __future__ import annotations

import numpy as np
import torch


SKIN_COLOR = np.array([232, 190, 172], np.float32) / 255.0


def init_params(input_params: dict, assets, config, device=None):
    """(params, aux) from the preprocessing output: per-frame 'trans' (N, 3),
    'pose' (N, 45), 'rot' (N, 3), 'shape' (N, 10), 'cam' (N, 3), 'joints'
    (N, 21, 3). The shape is shared: the mean of the per-frame estimates."""
    dev = torch.device(device)
    n = int(np.asarray(input_params["pose"]).shape[0])
    V = assets.num_render_verts
    ts = config.texture_size

    def t(a):
        return torch.tensor(np.array(a, np.float32), device=dev)

    params = {
        "trans": t(input_params["trans"]),
        "pose": t(input_params["pose"]),
        "rot": t(input_params["rot"]),
        "shape": t(np.asarray(input_params["shape"], np.float32).mean(0)),
        "wrist_pose": t(np.zeros((n, 3))),
        "cam": t(input_params["cam"]),
        "verts_disps": t(np.zeros((V, 1 if config.vert_disp_normals else 3))),
        "texture": t(np.broadcast_to(SKIN_COLOR, (ts, ts, 3))),
        "normal_map": t(np.broadcast_to([0.0, 0.0, 1.0], (ts, ts, 3))),
        "light_positions": t(np.broadcast_to([-0.5, -0.5, -0.5], (n, 3))),
        "amb_ratio": t(0.4),
    }
    if config.model_type == "html":
        # HTML's appearance: the 101 coefficients of its texture basis.
        params["html_texture"] = t(np.zeros(101))
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    aux = {
        "init_joints": t(input_params["joints"]),
        "uv_mask": t(_resize_mask(assets.uv_mask, (ts, ts))),
    }
    return params, aux


def _resize_mask(mask: np.ndarray, size) -> np.ndarray:
    """Nearest-neighbour resize of the uv mask to the texture resolution."""
    H, W = size
    ys = (np.arange(H) * mask.shape[0] / H).astype(int)
    xs = (np.arange(W) * mask.shape[1] / W).astype(int)
    return mask[ys][:, xs]
