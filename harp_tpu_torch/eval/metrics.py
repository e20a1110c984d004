"""Evaluation metrics (harp_tpu/eval/metrics.py).

- Silhouette IoU, image L1 (the reference's eval_util.py).
- SSIM / MS-SSIM in pytorch_msssim's formulation: data_range 1, 11x11
  Gaussian of sigma 1.5, K = (0.01, 0.03), MS weights [0.0448, 0.2856,
  0.3001, 0.2363, 0.1333]; scales whose image no longer holds the window
  are dropped and the weights renormalised, as harp_tpu does.
- perceptual_per_frame: an LPIPS-style distance over the VGG16 features
  (unit-normalised per channel vector, mean squared difference per layer,
  uniform layer weights), in float32.
- align_w_scale / EvalUtil / procrustes_joint_error: numpy and scipy.

Images are (B, H, W, C) tensors, as in harp_tpu. The filters are cuDNN
convolutions on the card: evaluate_sequence runs them with TF32 off. The
per-frame metrics take their constant tables through device.constant, so
that the eval program's CUDA graph (fit/evaluate.make_eval_program) holds
no copy from the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from harp_tpu_torch.device import constant
from harp_tpu_torch.losses.perceptual import Vgg16Features


def iou_per_frame(ref_masks: torch.Tensor, pred_masks: torch.Tensor) -> torch.Tensor:
    """(B, H, W) masks -> (B,) IoU at the 0.5 threshold."""
    ref_b = ref_masks >= 0.5
    pred_b = pred_masks >= 0.5
    union = (ref_b | pred_b).sum(dim=(1, 2))
    inter = (ref_b & pred_b).sum(dim=(1, 2))
    return inter.float() / union.clamp(min=1).float()


def l1_per_frame(ref_images: torch.Tensor, pred_images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B,) mean absolute difference per frame."""
    return (ref_images - pred_images).abs().mean(dim=(1, 2, 3))


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def sil_iou(ref_masks, pred_masks) -> float:
    return float(iou_per_frame(_t(ref_masks), _t(pred_masks)).mean())


def l1_diff(ref_images, pred_images) -> float:
    return float(np.abs(np.asarray(ref_images) - np.asarray(pred_images)).mean())


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2d(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise valid-mode 2-D filter of (B, C, H, W)."""
    C = img.shape[1]
    return F.conv2d(img, win[None, None].expand(C, 1, -1, -1), groups=C)


def _ssim_parts(x, y, data_range=1.0, win_size=11, sigma=1.5, k1=0.01, k2=0.03):
    """x, y (B, C, H, W) -> per-frame (ssim, cs) means."""
    win = constant(_gaussian_window(win_size, sigma), x.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _filter2d(x, win)
    mu_y = _filter2d(y, win)
    sxx = _filter2d(x * x, win) - mu_x ** 2
    syy = _filter2d(y * y, win) - mu_y ** 2
    sxy = _filter2d(x * y, win) - mu_x * mu_y
    cs = (2 * sxy + c2) / (sxx + syy + c2)
    ssim_map = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) * cs
    return ssim_map.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def ssim(x, y, data_range: float = 1.0) -> float:
    """x, y: (B, H, W, C) in [0, data_range]."""
    s, _ = _ssim_parts(_t(x).float().permute(0, 3, 1, 2), _t(y).float().permute(0, 3, 1, 2),
                       data_range)
    return float(s.mean())


MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim_per_frame(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
                      weights=MS_SSIM_WEIGHTS, win_size: int = 11) -> torch.Tensor:
    """(B, H, W, C) -> (B,) MS-SSIM."""
    x = _t(x).float().permute(0, 3, 1, 2)
    y = _t(y).float().permute(0, 3, 1, 2)
    min_side = min(x.shape[2], x.shape[3])
    n_scales = 1
    while n_scales < len(weights) and (min_side >> n_scales) >= win_size:
        n_scales += 1
    if n_scales < len(weights):
        w = np.asarray(weights[:n_scales])
        weights = tuple(w / w.sum())
    vals = []
    for i in range(len(weights)):
        s, cs = _ssim_parts(x, y, data_range)
        vals.append(s if i == len(weights) - 1 else cs)
        if i < len(weights) - 1:
            x = F.avg_pool2d(x, 2, 2)
            y = F.avg_pool2d(y, 2, 2)
    vals = torch.relu(torch.stack(vals))  # (L, B)
    w = constant(np.asarray(weights, np.float32), vals.device)
    return torch.prod(vals ** w[:, None], dim=0)


def ms_ssim(x, y, data_range: float = 1.0, weights=MS_SSIM_WEIGHTS,
            win_size: int = 11) -> float:
    return float(ms_ssim_per_frame(x, y, data_range, weights, win_size).mean())


def perceptual_per_frame(vgg: Vgg16Features, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B,) LPIPS-style distance through the float32 VGG:
    features unit-normalised over channels, squared difference summed over
    channels and averaged over pixels, summed over the four layers."""
    vgg = vgg.with_dtype("float32")
    total = 0.0
    for a, b in zip(vgg.slices(x)[1:], vgg.slices(y)[1:]):
        an = a / a.norm(dim=1, keepdim=True).clamp(min=1e-10)
        bn = b / b.norm(dim=1, keepdim=True).clamp(min=1e-10)
        total = total + ((an - bn) ** 2).sum(1).mean(dim=(1, 2))
    return total


def perceptual_distance(vgg: Vgg16Features, x, y, chunk: int = 8) -> float:
    """Mean LPIPS-style distance over the batch, in `chunk`-frame groups
    (exact: a mean of per-frame values)."""
    x, y = _t(x), _t(y)
    with torch.no_grad():
        per_frame = [perceptual_per_frame(vgg, x[s:s + chunk], y[s:s + chunk])
                     for s in range(0, x.shape[0], max(int(chunk), 1))]
    return float(torch.cat(per_frame).mean())


def image_eval(images_for_eval: dict, vgg: Vgg16Features | None = None) -> dict:
    """{"ref_image", "pred_image", "ref_mask", "pred_mask"} (each an array
    or a list of batches) -> the metric dict (reference eval_util.image_eval).
    The perceptual metric is "LPIPS" only with pretrained VGG weights,
    "LPIPS_proxy" with random filters."""
    def cat(v):
        if isinstance(v, list):
            return torch.cat([_t(b) for b in v], 0)
        return _t(v)

    ref_img, pred_img, ref_mask, pred_mask = (
        cat(images_for_eval[k]) for k in ("ref_image", "pred_image", "ref_mask", "pred_mask"))
    if vgg is None:
        vgg = Vgg16Features.create(device=ref_img.device)
    perc_key = "LPIPS" if vgg.source == "pretrained" else "LPIPS_proxy"
    return {
        "Silhouette IoU": sil_iou(ref_mask, pred_mask),
        "L1": float((ref_img - pred_img).abs().mean()),
        perc_key: perceptual_distance(vgg, ref_img, pred_img),
        "MS_SSIM": ms_ssim(ref_img, pred_img),
    }


# ---------------------------------------------------------------------------
# Procrustes alignment + PCK / AUC (numpy, reference eval_util.py:73-235)
# ---------------------------------------------------------------------------


def align_w_scale(mtx1: np.ndarray, mtx2: np.ndarray, return_trafo: bool = False):
    """Similarity-align mtx2 to mtx1 (scale + rotation + translation)."""
    from scipy.linalg import orthogonal_procrustes

    t1, t2 = mtx1.mean(0), mtx2.mean(0)
    mtx1_t = mtx1 - t1
    mtx2_t = mtx2 - t2
    s1 = np.linalg.norm(mtx1_t) + 1e-8
    mtx1_t = mtx1_t / s1
    s2 = np.linalg.norm(mtx2_t) + 1e-8
    mtx2_t = mtx2_t / s2
    R, s = orthogonal_procrustes(mtx1_t, mtx2_t)
    if return_trafo:
        return R, s, s1, t1 - t2
    return (mtx2_t @ R.T) * s * s1 + t1


def align_by_trafo(mtx: np.ndarray, trafo):
    t2 = mtx.mean(0)
    R, s, s1, t1 = trafo
    return ((mtx - t2) @ R.T) * s * s1 + t1 + t2


class EvalUtil:
    """Keypoint PCK / AUC / EPE accumulator."""

    def __init__(self, num_kp: int = 21):
        self.data = [[] for _ in range(num_kp)]
        self.num_kp = num_kp

    def feed(self, keypoint_gt, keypoint_vis, keypoint_pred):
        keypoint_gt = np.squeeze(keypoint_gt)
        keypoint_pred = np.squeeze(keypoint_pred)
        keypoint_vis = np.squeeze(keypoint_vis).astype(bool)
        dist = np.linalg.norm(keypoint_gt - keypoint_pred, axis=1)
        for i in range(self.num_kp):
            if keypoint_vis[i]:
                self.data[i].append(dist[i])

    def get_measures(self, val_min: float, val_max: float, steps: int):
        thresholds = np.linspace(val_min, val_max, steps)
        norm = np.trapezoid(np.ones_like(thresholds), thresholds)
        epe_mean, epe_median, auc_all, pck_curves = [], [], [], []
        for part in self.data:
            if not part:
                continue
            arr = np.asarray(part)
            epe_mean.append(arr.mean())
            epe_median.append(np.median(arr))
            pck = np.asarray([(arr <= t).mean() for t in thresholds])
            pck_curves.append(pck)
            auc_all.append(np.trapezoid(pck, thresholds) / norm)
        return (float(np.mean(epe_mean)), float(np.mean(epe_median)),
                float(np.mean(auc_all)), np.mean(pck_curves, 0), thresholds)


def procrustes_joint_error(gt_joints_mm: np.ndarray, pred_joints_mm: np.ndarray,
                           valid=None) -> float:
    """Mean Procrustes-aligned joint error (mm) of one frame: root-align,
    drop invalid joints, similarity-align, mean euclidean error."""
    gt = np.asarray(gt_joints_mm)
    pred = np.asarray(pred_joints_mm)
    gt = gt - gt[0:1]
    pred = pred - pred[0:1]
    if valid is not None:
        v = np.asarray(valid).astype(bool)
        gt, pred = gt[v], pred[v]
    if len(gt) == 0:
        return float("nan")
    aligned = align_w_scale(gt, pred)
    return float(np.linalg.norm(gt - aligned, axis=1).mean())
