"""Visual outputs (harp_tpu/utils/viz.py): image grids, red/blue
silhouette overlays, per-frame GT | pred | normal | overlay composites and
the texture-map export, written as PNG by a small writer on zlib and
struct, and read back (UV masks) by a small PNG reader: no imaging library
is needed.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _to_uint8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:  # already quantised (e.g. on the device)
        return img
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> PNG bytes (8 bits, no
    interlace, filter 0 on every row)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3), got {arr.shape}")
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters (None, Sub, Up, Average, Paeth) of h rows
    of w * bpp bytes, each led by its filter byte."""
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for y in range(h):
        ftype, line = raw[pos], np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int64)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per byte lane
            cur = np.cumsum(line.reshape(w, bpp), 0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            cur = line.tolist()
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            cur = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) grey, (H, W, 2) grey + alpha, (H, W, 3) RGB or
    (H, W, 4) RGBA uint8: 8 bits per sample, no palette, no interlace."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 4: 2, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"PNG with bit depth {depth}, colour type {color}, interlace "
                         f"{interlace}: only 8-bit grey / RGB(A), not interlaced")
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w, channels)
    return pix.reshape(h, w) if channels == 1 else pix.reshape(h, w, channels)


def read_grey(path: str) -> np.ndarray:
    """A PNG as one grey channel in [0, 1], float32: grey as it is, colour
    by PIL's convert("L") (ITU-R 601-2 luma, 16-bit fixed point; alpha
    ignored)."""
    with open(path, "rb") as f:
        img = decode_png(f.read()).astype(np.int64)
    if img.ndim == 3:
        if img.shape[2] <= 2:
            img = img[..., 0]
        else:
            img = (img[..., 0] * 19595 + img[..., 1] * 38470 + img[..., 2] * 7471
                   + 0x8000) >> 16
    return img.astype(np.float32) / 255.0


def save_image(img, path: str) -> None:
    """A float image in [0, 1] or a uint8 image as PNG; `path` must end in
    .png."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"save_image writes PNG only: {path}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(_to_uint8(img)))


def save_images_parallel(items, workers: int = 8) -> None:
    """Write many (image, path) pairs on a thread pool (zlib releases the
    interpreter lock while it compresses)."""
    from concurrent.futures import ThreadPoolExecutor

    items = list(items)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for fut in [ex.submit(save_image, im, p) for im, p in items]:
            fut.result()


def sil_overlay(true_mask, pred_mask) -> np.ndarray:
    """GT in the red channel, prediction in blue."""
    h, w = np.asarray(true_mask).shape[:2]
    out = np.zeros((h, w, 3), np.float32)
    out[:, :, 0] = np.asarray(true_mask)
    out[:, :, 2] = np.asarray(pred_mask)
    return out


def image_grid(images, rows: int = 3, cols: int = 3) -> np.ndarray:
    """Tile up to rows * cols images into one grid (black padding)."""
    images = [np.asarray(im) for im in images[: rows * cols]]
    h, w = images[0].shape[:2]
    grid = np.zeros((rows * h, cols * w, 3), np.float32)
    for i, im in enumerate(images):
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im[..., :3]
    return grid


def frame_composite(img_true, img_pred, img_normal, mask_true, mask_pred) -> np.ndarray:
    """GT | prediction | normal render | silhouette overlay, side by side."""
    return np.concatenate([np.asarray(img_true), np.asarray(img_pred),
                           np.asarray(img_normal), sil_overlay(mask_true, mask_pred)],
                          axis=1)


def save_texture_maps(params, uv_mask, out_dir: str, texture=None) -> None:
    """The fitted albedo (params["texture"], or `texture` where given: a
    texture basis's) and normal map as uv_out/texture.png and
    uv_out/normal_map.png, masked by the uv mask."""
    out = os.path.join(out_dir, "uv_out")
    mask = np.asarray(uv_mask.cpu() if hasattr(uv_mask, "cpu") else uv_mask) \
        if uv_mask is not None else None
    tex = params["texture"] if texture is None else texture
    tex = np.clip(tex.detach().cpu().numpy(), 0, 1)
    if mask is not None:
        tex = tex * mask[..., None]
    save_image(tex, os.path.join(out, "texture.png"))
    if "normal_map" in params:
        nm = params["normal_map"].detach().cpu().numpy()
        nm = nm / np.maximum(np.linalg.norm(nm, axis=-1, keepdims=True), 1e-9)
        nm = nm / 2.0 + 0.5
        if mask is not None:
            nm = nm * mask[..., None]
        save_image(np.clip(nm, 0, 1), os.path.join(out, "normal_map.png"))
