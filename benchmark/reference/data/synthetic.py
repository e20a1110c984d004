"""Frozen plain copy of harp_tpu_torch/data/synthetic.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

Synthetic ground-truth sequences (harp_tpu/data/synthetic.py).

Renders the model with known parameters through the plain pipeline, a
group of frames at a time, and returns a perturbed initialisation,
standing in for the preprocessing output. The parameters come from the
program's numpy RandomState stream, drawn as the program draws them.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.render import pipeline
from benchmark.reference.render.rasterizer import RasterConfig


def erode_mask(mask: torch.Tensor, iterations: int = 2) -> torch.Tensor:
    """3x3 min-filter erosion of (N, H, W) masks (cv2.erode, ones(3, 3));
    the border counts as unmasked-neutral, as a 'SAME' min window does."""
    m = mask[:, None]
    for _ in range(iterations):
        m = -torch.nn.functional.max_pool2d(-m, 3, stride=1, padding=1)
    return m[:, 0]


def make_synthetic_sequence(assets, config, rcfg: RasterConfig,
                            n_frames: int = 4, seed: int = 0,
                            perturb: float = 0.15, cam=(6.0, -0.08, -0.01),
                            shape_seed: int | None = None, device=None,
                            render_batch: int = 6):
    """(images, masks, masks_eroded, gt_params, init_params_dict); images
    (N, H, W, 3), masks (N, H, W) on `device`; init is a numpy dict.
    shape_seed: the GT hand shape from its own RandomState(shape_seed), so
    two sequences of different `seed` show one identity; the main stream
    is drawn unchanged."""
    dev = torch.device(device)
    rng = np.random.RandomState(seed)
    ts = config.texture_size
    V = assets.num_render_verts
    # Parameter widths follow the model family: MANO and the arm 45-dof
    # pose / 10 shape, NIMBLE 30 PCA pose / 20 shape.
    P = getattr(assets.model, "ncomps", 45)
    S = assets.model.shapedirs.shape[2]

    t = np.linspace(0, 1, n_frames)[:, None]
    base_pose = 0.25 * rng.randn(1, P)
    drift = 0.2 * np.sin(2 * np.pi * t + rng.uniform(0, 6.28, (1, P)))
    tex = np.tile(np.array([0.8, 0.62, 0.55], np.float32), (ts, ts, 1))
    yy, xx = np.mgrid[0:ts, 0:ts]
    tex[..., 0] += 0.1 * np.sin(xx / 6.0)
    tex[..., 1] += 0.1 * np.cos(yy / 9.0)

    def t32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    gt = {
        "pose": t32(base_pose + drift),
        "rot": t32(0.1 * rng.randn(n_frames, 3) * 0 + 0.05 * t),
        "trans": t32(np.zeros((n_frames, 3))),
        "shape": t32(0.3 * rng.randn(S)),
        "wrist_pose": t32(np.zeros((n_frames, 3))),
        "cam": t32(np.tile(cam, (n_frames, 1))),
        "verts_disps": t32(np.zeros((V, 1))),
        "texture": t32(np.clip(tex, 0, 1)),
        "normal_map": t32(np.broadcast_to([0.0, 0.0, 1.0], (ts, ts, 3))),
        "light_positions": t32(np.tile([-0.5, -0.5, -0.5], (n_frames, 1))),
        "amb_ratio": t32(0.4),
    }

    if shape_seed is not None:
        gt["shape"] = t32(0.3 * np.random.RandomState(shape_seed).randn(S))

    with torch.no_grad():
        # Rendered render_batch frames at a time: the plain rasterizer's
        # per-(tile, face, pixel) tensors would not fit for the whole sequence.
        parts = []
        for s in range(0, n_frames, render_batch):
            fids = torch.arange(s, min(s + render_batch, n_frames), device=dev)
            verts, joints = pipeline.mesh_forward(gt, fids, assets, config)
            R, T = pipeline.camera_for_frames(gt, fids, config)
            alpha = pipeline.render_silhouette(verts, assets, R, T, config, rcfg)
            images = pipeline.render_rgb(verts, assets, R, T, config, rcfg,
                                         gt["texture"], gt["normal_map"],
                                         gt["light_positions"][fids])
            parts.append((joints, images, (alpha > 0.5).float()))
        joints, images, masks = (torch.cat(p) for p in zip(*parts))
        masks_eroded = erode_mask(masks)

    init = {
        "pose": gt["pose"].cpu().numpy() + perturb * rng.randn(n_frames, P).astype(np.float32),
        "rot": gt["rot"].cpu().numpy() + 0.3 * perturb * rng.randn(n_frames, 3).astype(np.float32),
        "trans": gt["trans"].cpu().numpy(),
        "shape": np.tile(gt["shape"].cpu().numpy(), (n_frames, 1))
        + 0.5 * perturb * rng.randn(n_frames, S).astype(np.float32),
        "cam": gt["cam"].cpu().numpy(),
        "joints": joints.cpu().numpy(),
    }
    return images, masks, masks_eroded, gt, init
