"""Raw-frame crop and mask extraction (harp_tpu/preprocess/crop.py): the
Unscreen step before METRO. Frames arrive as RGBA PNGs whose alpha is the
segmentation mask (a JPEG frame has alpha 255, as Pillow reads it); each
is resized so that its short side is 448, centre-cropped to 448^2, and
its RGB composited onto white through the resized soft mask. The outputs land in the layout data/dataset.py reads:

  {out_root}/unscreen_cropped/%04d.jpg   white-background cropped RGB
  {out_root}/mask/%04d_mask.jpg          cropped 8-bit mask

harp_tpu does this with Pillow. The port reads frames itself (any PNG as
Pillow converts it, through utils/viz.py; JPEGs through native/) and
carries Pillow 12's arithmetic over itself, in integers (int64
tensors): Image.resize(BILINEAR) as Resample.c computes it (separable
triangle filter, support scaled by the shrink factor, weights in double
rounded to 22-bit fixed point, horizontal pass then vertical, each
clipped to uint8) and paste(mask=L) as Paste.c blends. The same bits
come out on the CPU and on the card.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from harp_tpu_torch.device import resolve_device

RESOLUTION = 448  # the reference's crop size (end2end_inference_handmesh.py:54)
PRECISION_BITS = 22  # Resample.c: 32 - 8 - 2


def _coeffs(in_size: int, out_size: int):
    """Resample.c's precompute_coeffs + normalize_coeffs_8bpc for the
    bilinear filter over the whole input: (xmin (out,), weights (out, k)
    int64 fixed point, zero beyond each output's taps)."""
    scale = float(np.float32(in_size)) / out_size  # (double)(in1 - in0) / outSize
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    k = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # (int) truncates
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(k)[None, :]
    arg = ((x + xmin[:, None]).astype(np.float64) - center[:, None] + 0.5) * (1.0 / filterscale)
    w = np.where(np.abs(arg) < 1.0, 1.0 - np.abs(arg), 0.0)
    w = np.where(x < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(k):  # summed left to right, as the C loop does
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.floor(0.5 + w * (1 << PRECISION_BITS)).astype(np.int64)  # weights >= 0
    return xmin, fixed


def _resample_axis(img: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """One pass of Pillow's 8-bit resample along `axis` (0 rows, 1
    columns) of an (H, W[, C]) uint8 tensor."""
    in_size = img.shape[axis]
    xmin, fixed = _coeffs(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(fixed.shape[1])[None, :], in_size - 1)
    dev = img.device
    idx_t = torch.as_tensor(idx, device=dev)
    w_t = torch.as_tensor(fixed, device=dev)
    src = img.long()
    acc = torch.full((), 1 << (PRECISION_BITS - 1), dtype=torch.int64, device=dev)
    shape = [1] * img.dim()
    shape[axis] = out_size
    for j in range(fixed.shape[1]):
        acc = acc + src.index_select(axis, idx_t[:, j]) * w_t[:, j].reshape(shape)
    return torch.clamp(acc >> PRECISION_BITS, 0, 255).to(torch.uint8)


def resize_bilinear(img: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Image.resize((width, height), BILINEAR) of an (H, W) ("L") or
    (H, W, 3) ("RGB") uint8 tensor: the horizontal pass first, each pass
    only where its size changes, as ImagingResample does."""
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img


def resize_center_crop(img, res: int = RESOLUTION):
    """torchvision's Resize(res) + CenterCrop(res) over Pillow's bilinear
    resize: the short side to `res`, the long side to int(res * long /
    short), then a centred crop at int(round((size - res) / 2)). img: an
    (H, W) or (H, W, 3) uint8 array or tensor; returns the same kind."""
    as_numpy = not isinstance(img, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(img)) if as_numpy else img
    h, w = t.shape[:2]
    if w <= h:
        nw, nh = res, int(res * h / w)
    else:
        nw, nh = int(res * w / h), res
    t = resize_bilinear(t, nw, nh)
    left = int(round((nw - res) / 2.0))
    top = int(round((nh - res) / 2.0))
    t = t[top:top + res, left:left + res]
    return t.numpy() if as_numpy else t


def fill_img_background(rgb, mask):
    """White background pasted with `rgb` through the 8-bit soft `mask`:
    Paste.c's blend DIV255(dst * (255 - m) + src * m) with DIV255(v) =
    ((v + 128 >> 8) + v + 128) >> 8. rgb (H, W, 3), mask (H, W) uint8
    arrays or tensors; returns the kind of `rgb`."""
    as_numpy = not isinstance(rgb, torch.Tensor)
    src = torch.from_numpy(np.asarray(rgb)) if as_numpy else rgb
    m = torch.from_numpy(np.asarray(mask)) if as_numpy else mask
    src, m = src.long(), m.long()[..., None]
    t = 255 * (255 - m) + src * m + 128
    out = (((t >> 8) + t) >> 8).to(torch.uint8)
    return out.numpy() if as_numpy else out


def list_frames(image_dir: str) -> list[str]:
    """The .png / .jpg frames of `image_dir` whose names hold neither
    'pred' nor 'mask', sorted."""
    out = [os.path.join(image_dir, f) for f in os.listdir(image_dir)
           if (f.endswith(".png") or f.endswith(".jpg")) and "pred" not in f and "mask" not in f]
    out.sort()
    return out


def frame_index(path: str) -> int:
    """The frame number, int(basename[-8:-4])."""
    return int(os.path.basename(path)[-8:-4])


def _read_frame(path: str, device, mode: str) -> torch.Tensor:
    """A frame as (H, W, 4) uint8 RGBA or (H, W, 3) RGB on `device`, as
    Image.open(path).convert(mode) gives it. A JPEG decodes through
    native.decode_jpeg_batch (libjpeg on the CPU, nvJPEG on the card),
    gaining alpha 255; a PNG of any bit depth, colour type or interlace
    through utils/viz.read_rgba / read_rgb on the host."""
    from harp_tpu_torch.native import decode_jpeg_batch
    from harp_tpu_torch.utils import viz

    if path.lower().endswith((".jpg", ".jpeg")):
        rgb = torch.round(decode_jpeg_batch([path], device=device)[0] * 255.0).to(torch.uint8)
        return torch.cat([rgb, torch.full_like(rgb[..., :1], 255)], 2) if mode == "RGBA" else rgb
    if not path.lower().endswith(".png"):
        raise ValueError(f"crop reads PNG and JPEG frames only: {path}")
    img = viz.read_rgba(path) if mode == "RGBA" else viz.read_rgb(path)
    return torch.from_numpy(img).to(device)


def crop_frame(unscreen_path: str, ori_path: str | None = None, res: int = RESOLUTION,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One frame: an unscreen PNG or JPEG, as RGBA -> (cropped
    white-background RGB (res, res, 3), cropped mask (res, res)), uint8
    tensors on `device` (CUDA unless given). The RGB comes from ori_path
    (the original full-size frame) where that file exists, else from the
    unscreen frame itself."""
    dev = resolve_device(device)
    rgba = _read_frame(unscreen_path, dev, "RGBA")
    mask = resize_center_crop(rgba[..., 3].contiguous(), res)
    if ori_path is not None and os.path.exists(ori_path):
        full = _read_frame(ori_path, dev, "RGB")
    else:
        full = rgba[..., :3]
    rgb = fill_img_background(resize_center_crop(full.contiguous(), res), mask)
    return rgb, mask


def crop_unscreen_sequence(unscreen_dir: str, out_root: str, ori_img_dir: str | None = None,
                           res: int = RESOLUTION, skip_if_done: bool = True,
                           device=None) -> int:
    """Crop a sequence into the ingest layout; returns its frame count.
    JPEGs at quality 95 through native.encode_jpeg: nvJPEG on the card
    (the default device), Pillow's bytes with device="cpu". With
    skip_if_done a non-empty unscreen_cropped/ is left as it is."""
    from harp_tpu_torch.native import encode_jpeg

    cropped_dir = os.path.join(out_root, "unscreen_cropped")
    mask_dir = os.path.join(out_root, "mask")
    if skip_if_done and os.path.isdir(cropped_dir) and os.listdir(cropped_dir):
        return len(os.listdir(cropped_dir))
    dev = resolve_device(device)
    os.makedirs(cropped_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    frames = list_frames(unscreen_dir)
    for path in frames:
        idx = frame_index(path)
        ori = os.path.join(ori_img_dir, "%04d.png" % idx) if ori_img_dir else None
        rgb, mask = crop_frame(path, ori, res, dev)
        encode_jpeg(rgb, os.path.join(cropped_dir, "%04d.jpg" % idx), 95)
        encode_jpeg(mask, os.path.join(mask_dir, "%04d_mask.jpg" % idx), 95)
    return len(frames)
