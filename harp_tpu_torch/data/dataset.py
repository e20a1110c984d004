"""Real sequences in the reference's directory layout
(harp_tpu/data/dataset.py):

  {metro_output_dir}/{seq}/metro_mano[_smooth]/%04d_mano.pkl
      keys: joints, verts, rot, pose, shape, trans, cam
  {image_dir}/{seq}/unscreen_cropped/%04d.jpg
  {image_dir}/{seq}/mask/%04d_mask.jpg

A sequence is decoded once into stacked tensors on the device (libjpeg on
the host for a CPU device, nvJPEG on the card for a CUDA device:
harp_tpu_torch/native), so minibatching is a gather on the device.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from harp_tpu_torch.data.synthetic import erode_mask
from harp_tpu_torch.device import resolve_device
from harp_tpu_torch.native import decode_jpeg_batch, encode_jpeg


def load_frame_pkl(path: str) -> dict:
    with open(path, "rb") as f:
        d = pickle.load(f)
    return {k: np.asarray(v) for k, v in d.items() if k != "seq"}


def save_frame_pkl(path: str, params: dict, idx: int) -> None:
    """Write one frame's parameters in the reference's per-frame schema
    (hand_utils.write_pkl): batch-1 arrays except 'cam'. Values may be
    numpy arrays or tensors."""
    out = {}
    for k, v in params.items():
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        out[k] = v[idx] if k == "cam" else v[idx, None]
    with open(path, "wb") as f:
        pickle.dump(out, f)


def write_sequence(root: str, seq: str, images, masks, params: dict,
                   quality: int = 95, use_smooth_seq: bool = True) -> None:
    """Write one sequence in the reference's layout under `root` (as
    metro_output_dir and image_dir both): frames and masks as JPEG at
    `quality` through the port's encoder (nvJPEG for CUDA tensors, else
    native/jpeg_codec.cpp: Pillow's bytes), and one per-frame pkl of
    `params` each."""
    folder = "metro_mano_smooth" if use_smooth_seq else "metro_mano"
    dirs = [os.path.join(root, str(seq), d) for d in ("unscreen_cropped", "mask", folder)]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    for i in range(len(images)):
        encode_jpeg(images[i], os.path.join(dirs[0], "%04d.jpg" % i), quality)
        encode_jpeg(masks[i], os.path.join(dirs[1], "%04d_mask.jpg" % i), quality)
        save_frame_pkl(os.path.join(dirs[2], "%04d_mano.pkl" % i), params, i)


def load_sequences(metro_output_dir: str, image_dir: str, seq_list,
                   use_smooth_seq: bool = True, average_cam_sequence: bool = False,
                   model_type: str = "harp", device=None):
    """Load and stack a list of sequences -> (params, images, masks,
    masks_eroded): params a dict of float32 numpy arrays stacked over the
    concatenated frame axis (the reference's combine_dict_to_batch
    layout), images (N, H, W, 3), masks and eroded masks (N, H, W) float32
    tensors on `device` (CUDA unless given).

    Frames are ordered by the (sequence, name) strings, so sequence "10"
    comes before "2"; with average_cam_sequence each frame takes its
    sequence's mean camera."""
    dev = resolve_device(device)
    folder = "metro_mano_smooth" if use_smooth_seq else "metro_mano"
    if model_type == "nimble":
        folder = "nimble_" + folder

    entries = []
    for seq in seq_list:
        d = os.path.join(metro_output_dir, str(seq), folder)
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".pkl"):
                entries.append((str(seq), fn[:-9]))  # strip "_mano.pkl"
    entries.sort()

    frames, img_paths, mask_paths, cam_by_seq = [], [], [], {}
    for seq, name in entries:
        p = load_frame_pkl(os.path.join(metro_output_dir, seq, folder, name + "_mano.pkl"))
        cam_by_seq.setdefault(seq, []).append(p["cam"])
        frames.append((seq, p))
        img_paths.append(os.path.join(image_dir, seq, "unscreen_cropped", name + ".jpg"))
        mask_paths.append(os.path.join(image_dir, seq, "mask", name + "_mask.jpg"))

    if average_cam_sequence:
        avg = {s: np.mean(np.stack(v), axis=0) for s, v in cam_by_seq.items()}
        for seq, p in frames:
            p["cam"] = avg[seq]

    params = {k: np.stack([p[k] if k == "cam" else np.asarray(p[k]).squeeze(0)
                           for _, p in frames]).astype(np.float32)
              for k in frames[0][1]}
    images = decode_jpeg_batch(img_paths, device=dev)
    masks = decode_jpeg_batch(mask_paths, gray=True, device=dev)
    return params, images, masks, erode_mask(masks, iterations=2)
