"""Visual outputs (harp_tpu/utils/viz.py): image grids, red/blue
silhouette overlays, per-frame GT | pred | normal | overlay composites,
the texture-map export, and the eval's turntables (render_360), light
sweep (render_360_light), side-by-side concatenation and GIFs. Images are
written as PNG by a small writer on zlib and struct and read back by a
small PNG reader; GIFs by a GIF89a writer with a median-cut palette per
frame and an LZW encoder (native.gif_lzw): no imaging library is needed.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib

import numpy as np
import torch


def _to_uint8(img) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:  # already quantised (e.g. on the device)
        return img
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) grey, (H, W, 2) grey + alpha, (H, W, 3) RGB or (H, W, 4)
    RGBA uint8 -> PNG bytes (8 bits, no interlace, filter 0 on every row)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    color = 0 if arr.ndim == 2 else {2: 4, 3: 2, 4: 6}.get(arr.shape[2]) if arr.ndim == 3 else None
    if color is None:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 2 | 3 | 4), got {arr.shape}")
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


def save_pair_grid(pred, true, path: str, silhouette: bool = False) -> None:
    """A 3x3 grid of the first predictions as a PNG; with `silhouette`,
    of the red (GT) / blue (prediction) overlays. As in harp_tpu, the
    plain grid shows the predictions alone."""
    if silhouette:
        imgs = [sil_overlay(t, p) for p, t in zip(pred, true)]
    else:
        imgs = list(np.asarray(pred))
    save_image(image_grid(imgs), path)


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


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------


def _median_cut(colors: np.ndarray, counts: np.ndarray, n: int) -> tuple:
    """Median cut of unique colours (U, 3) weighted by pixel counts into at
    most n boxes: each round splits the boxes of the most pixels (as many
    as are still wanted, of those holding two colours or more) along their
    widest channel at their pixel median, as Pillow's quantize splits the
    fullest box first. Returns (box of each colour (U,), number of boxes)."""
    label = np.zeros(len(colors), np.int64)
    nbox = 1
    while nbox < n:
        order = np.argsort(label, kind="stable")
        lab, col = label[order], colors[order]
        starts = np.flatnonzero(np.r_[True, lab[1:] != lab[:-1]])
        span = np.maximum.reduceat(col, starts) - np.minimum.reduceat(col, starts)
        weight = np.add.reduceat(counts[order], starts)
        can = np.flatnonzero(span.max(1) > 0)
        if not len(can):
            break
        pick = can[np.argsort(-weight[can], kind="stable")][:n - nbox]
        new_id = np.full(nbox, -1)
        new_id[pick] = nbox + np.arange(len(pick))
        # Members of the picked boxes, sorted by box then by the box's widest channel.
        member = np.flatnonzero(new_id[label] >= 0)
        axis = np.argmax(span, 1)[label[member]]
        key = label[member] * 256 + colors[member, axis]
        member = member[np.argsort(key, kind="stable")]
        box = label[member]
        first = np.r_[True, box[1:] != box[:-1]]
        last = np.r_[box[1:] != box[:-1], True]
        cum = np.cumsum(counts[member])
        before = cum - counts[member]  # pixels ahead of each member, from the run start
        run_start = np.maximum.accumulate(np.where(first, before, 0))
        excl = before - run_start
        total = weight[box]
        right = (excl * 2 >= total) & ~first
        right |= last & (np.bincount(box, minlength=nbox)[box] > 1)
        label[member[right]] = new_id[box[right]]
        nbox += len(pick)
    return label, nbox


def quantize(rgb: np.ndarray) -> tuple:
    """(H, W, 3) uint8 -> (palette (256, 3) uint8, indices (H, W) uint8):
    the frame's own colours when it has at most 256, else the weighted
    means of 256 median-cut boxes with each pixel mapped to its nearest
    palette colour."""
    flat = rgb.reshape(-1, 3).astype(np.int32)
    keys = (flat[:, 0] << 16) | (flat[:, 1] << 8) | flat[:, 2]
    uniq, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    colors = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1).astype(np.int64)
    palette = np.zeros((256, 3), np.uint8)
    if len(uniq) <= 256:
        palette[:len(uniq)] = colors
        return palette, inv.reshape(rgb.shape[:2]).astype(np.uint8)
    label, nbox = _median_cut(colors, counts, 256)
    w = np.bincount(label, counts, minlength=nbox)
    for c in range(3):
        palette[:nbox, c] = np.floor(np.bincount(label, counts * colors[:, c], nbox) / w + 0.5)
    pal = palette[:nbox].astype(np.float32)
    pal_sq = (pal * pal).sum(1)[None, :]
    nearest = np.empty(len(colors), np.uint8)
    for s in range(0, len(colors), 16384):  # (colours, 256) distances a block
        c = colors[s:s + 16384].astype(np.float32)
        nearest[s:s + 16384] = np.argmin(pal_sq - 2.0 * c @ pal.T, axis=1)
    return palette, nearest[inv].reshape(rgb.shape[:2])


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _gif_frame(rgb: np.ndarray, delay_cs: int) -> bytes:
    """One frame: graphic control extension (delay), image descriptor
    with a 256-colour local table, LZW image data."""
    from harp_tpu_torch.native import gif_lzw

    palette, idx = quantize(rgb)
    h, w = idx.shape
    return (b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs) + b"\x00\x00"
            + b"\x2c" + struct.pack("<HHHH", 0, 0, w, h) + b"\x87" + palette.tobytes()
            + b"\x08" + _sub_blocks(gif_lzw(idx)))


def _read_rgb(path: str, device=None) -> np.ndarray:
    """A PNG (decode_png) or JPEG (native's decoder: libjpeg on the host
    for a CPU device, nvJPEG on the card) as (H, W, 3) uint8."""
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            img = decode_png(f.read())
        if img.ndim == 2:
            img = img[..., None]
        return np.repeat(img[..., :1], 3, 2) if img.shape[2] <= 2 else img[..., :3]
    from harp_tpu_torch.native import decode_jpeg_batch

    x = decode_jpeg_batch([path], device=device)[0]
    return torch.round(x * 255.0).to(torch.uint8).cpu().numpy()


def write_gif(frames, out_path: str, duration_ms: int = 100) -> None:
    """(N, H, W, 3) uint8 frames as a looping GIF89a at duration_ms a
    frame, quantised and encoded on a thread pool."""
    from concurrent.futures import ThreadPoolExecutor

    delay = int(duration_ms / 10)
    with ThreadPoolExecutor(max_workers=8) as ex:
        blocks = list(ex.map(lambda f: _gif_frame(f, delay), frames))
    h, w = frames[0].shape[:2]
    head = (b"GIF89a" + struct.pack("<HH", w, h) + b"\x00\x00\x00"
            + b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00")
    with open(out_path, "wb") as f:
        f.write(head + b"".join(blocks) + b"\x3b")


def save_gif(in_dir: str, out_path: str, duration_ms: int = 100) -> None:
    """The sorted *.png frames of in_dir as a looping GIF89a at
    duration_ms a frame (nothing when there are none)."""
    paths = sorted(glob.glob(os.path.join(in_dir, "*.png")))
    if paths:
        write_gif([_read_rgb(p) for p in paths], out_path, duration_ms)


def concat_image_dirs(dir1: str, dir2: str, out_dir: str, device=None) -> None:
    """Side by side, the i-th sorted .jpg / .png of dir1 and of dir2, as
    out_dir/%04d.png, and their GIF out_dir/out.gif. device: where a .jpg
    is decoded (native.decode_jpeg_batch)."""
    os.makedirs(out_dir, exist_ok=True)

    def listing(d):
        return sorted(p for p in glob.glob(os.path.join(d, "*")) if p.endswith((".jpg", ".png")))

    frames = [np.concatenate([_read_rgb(a, device), _read_rgb(b, device)], 1)
              for a, b in zip(listing(dir1), listing(dir2))]
    save_images_parallel((f, os.path.join(out_dir, "%04d.png" % i)) for i, f in enumerate(frames))
    if frames:
        write_gif(frames, os.path.join(out_dir, "out.gif"))


# ---------------------------------------------------------------------------
# Turntables and the light sweep
# ---------------------------------------------------------------------------


def _rotation(axis: str, degrees: float, device) -> torch.Tensor:
    """The rotation matrix of `degrees` about one axis, from the float32
    axis-angle np.deg2rad(degrees)."""
    from harp_tpu_torch.ops.rotations import axis_angle_to_matrix

    aa = np.zeros(3, np.float32)
    aa[{"X": 0, "Y": 1, "Z": 2}[axis]] = np.deg2rad(degrees)
    return axis_angle_to_matrix(torch.from_numpy(aa[None]).to(device))[0]


def _rotate_about_center(verts: torch.Tensor, axis: str, degrees: float) -> torch.Tensor:
    """(B, V, 3) vertices rotated by `degrees` about `axis` through their
    mean: (v - c) @ R^T + c."""
    center = verts.mean(dim=1, keepdim=True)
    R = _rotation(axis, degrees, verts.device)
    return (verts - center) @ R.T + center


def _quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """Float renders in [0, 1] -> uint8, clip then * 255 truncated."""
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


OVERFLOW = ("bin_overflow", "active_overflow", "span_overflow")


def _check_counters(counters: dict, what: str, into: dict | None) -> None:
    counts = {k: int(v) for k, v in counters.items()}
    if into is not None:
        for k, v in counts.items():
            into[k] = into.get(k, 0) + v
    if any(counts.get(k, 0) for k in OVERFLOW):
        raise RuntimeError(f"{what}: a raster pass truncated the render: {counts}")


def _complete(render, rcfg, num_faces: int):
    """render(rcfg, counters) -> image, with the tile capacity doubled (up
    to the face count) while a tile held more faces than it, and the face
    span doubled (up to the tiles across) while a face spanned more tiles:
    a turned mesh can pile its faces into fewer tiles than any fitted
    frame. Complete renders do not depend on the budget, so the result is
    the same bits whichever group a view is rendered in. Returns (image,
    the last render's counters and rerenders: the renders it took beyond
    the first)."""
    import dataclasses

    across = rcfg.image_size // rcfg.tile
    rerenders = -1
    while True:
        rerenders += 1
        counters: dict = {}
        img = render(rcfg, counters)
        counts = {k: int(v) for k, v in counters.items()}
        if counts["bin_overflow"] and rcfg.cap < num_faces:
            rcfg = dataclasses.replace(rcfg, cap=min(2 * rcfg.cap, num_faces))
        elif counts["span_overflow"] and rcfg.span_tiles < across:
            rcfg = dataclasses.replace(rcfg, span_tiles=min(2 * rcfg.span_tiles, across))
        else:
            return img, dict(counts, rerenders=rerenders)


def turntable_verts(params, fid, assets, config, views_per_axis: int = 36) -> torch.Tensor:
    """(2 views_per_axis, V, 3): frame `fid`'s mesh turned views_per_axis
    times by 360 / views_per_axis degrees about Y, then as often about X
    from where Y left it; each view's vertices are the previous view's
    rotated (the float32 carry of harp_tpu's scan)."""
    from harp_tpu_torch.render import pipeline

    with torch.no_grad():
        fids = torch.tensor([int(fid)], device=params["pose"].device)
        v, _ = pipeline.mesh_forward(params, fids, assets, config)
        views = []
        for axis in "YX":
            for _ in range(views_per_axis):
                v = _rotate_about_center(v, axis, 360.0 / views_per_axis)
                views.append(v)
    return torch.cat(views)


def render_views(params, fid, verts, assets, config, rcfg, render_normal: bool = False,
                 lights=None, chunk: int = 8, counters: dict | None = None,
                 extras: dict | None = None) -> torch.Tensor:
    """(N, H, W, 3) uint8: the meshes verts (N, V, 3) seen by frame `fid`'s
    camera, `chunk` a render, as normals or in colour (params' texture or
    the model family's, the normal map, lights (N, 3) or frame fid's
    light), each render with a budget that truncates nothing (_complete).
    counters: the renders' overflow counters and rerenders (the renders
    that widened a budget) are added to it."""
    from harp_tpu_torch.fit.driver import appearance_texture
    from harp_tpu_torch.render import pipeline

    with torch.no_grad():
        fids = torch.tensor([int(fid)], device=verts.device)
        R, T = pipeline.camera_for_frames(params, fids, config)
        if lights is None:
            lights = params["light_positions"][fids].expand(verts.shape[0], 3)
        texture = appearance_texture(params, config, extras)
        out = []
        for s in range(0, verts.shape[0], chunk):
            vb = verts[s:s + chunk]
            b = vb.shape[0]
            Rb, Tb = R.expand(b, 3, 3), T.expand(b, 3)
            if render_normal:
                def render(rc, c):
                    return pipeline.render_normal(vb, assets, Rb, Tb, config, rc, counters=c)
            else:
                def render(rc, c):
                    return pipeline.render_rgb(vb, assets, Rb, Tb, config, rc, texture,
                                               params["normal_map"], lights[s:s + chunk], c)
            img, counts = _complete(render, rcfg, len(assets.render_faces))
            if counters is not None:
                for k, v in counts.items():
                    counters[k] = counters.get(k, 0) + v
            out.append(_quantize_u8(img))
        return torch.cat(out)


def turntable_views(params, fid, assets, config, rcfg, render_normal: bool = False,
                    views_per_axis: int = 36, chunk: int = 8, counters: dict | None = None,
                    extras: dict | None = None) -> torch.Tensor:
    """(2 views_per_axis, H, W, 3) uint8 on the parameters' device: the
    turntable_verts views rendered in colour or as normals (render_views)."""
    verts = turntable_verts(params, fid, assets, config, views_per_axis)
    return render_views(params, fid, verts, assets, config, rcfg, render_normal, None, chunk,
                        counters, extras)


def sweep_lights(num: int = 40, z_range=(-5.0, 5.0), device=None) -> torch.Tensor:
    """(num, 3) lights (1, 1, z), z = z0 + (z1 - z0) / num * i in Python
    floats, then float32."""
    z = torch.tensor([z_range[0] + (z_range[1] - z_range[0]) / num * i for i in range(num)],
                     dtype=torch.float32, device=device)
    return torch.stack([torch.ones_like(z), torch.ones_like(z), z], 1)


def light_sweep_views(params, fid, assets, config, rcfg, num: int = 40, z_range=(-5.0, 5.0),
                      chunk: int = 8, counters: dict | None = None,
                      extras: dict | None = None) -> torch.Tensor:
    """(num, H, W, 3) uint8: frame `fid` in colour under the sweep_lights."""
    from harp_tpu_torch.render import pipeline

    dev = params["pose"].device
    with torch.no_grad():
        v, _ = pipeline.mesh_forward(params, torch.tensor([int(fid)], device=dev), assets,
                                     config)
    return render_views(params, fid, v.expand(num, -1, -1), assets, config, rcfg, False,
                        sweep_lights(num, z_range, dev), chunk, counters, extras)


def render_360(params, fid, assets, config, rcfg, out_dir: str, render_normal: bool = False,
               use_shadow: bool = False, views_per_axis: int = 36, chunk: int = 8,
               counters: dict | None = None, extras: dict | None = None) -> str:
    """The turntable (turntable_views) as {out_dir}/render_360[_normal]/
    %04d.png (about Y) and h_%04d.png (about X) plus out.gif; returns
    that directory. use_shadow is accepted and unused, as in harp_tpu: the
    turntable renders without shadow. Raises if a raster pass still
    truncated a view; counters, when given, receives the overflow counts
    and the rerenders."""
    sub = "render_360_normal" if render_normal else "render_360"
    out = os.path.join(out_dir, sub)
    local: dict = {}
    imgs = turntable_views(params, fid, assets, config, rcfg, render_normal, views_per_axis,
                           chunk, local, extras).cpu().numpy()
    _check_counters(local, "render_360", counters)
    save_images_parallel(
        (imgs[i], os.path.join(out, ("" if i < views_per_axis else "h_")
                               + "%04d.png" % (i % views_per_axis)))
        for i in range(2 * views_per_axis))
    write_gif(imgs, os.path.join(out, "out.gif"))
    return out


def render_360_light(params, fid, assets, config, rcfg, out_dir: str, num: int = 40,
                     z_range=(-5.0, 5.0), chunk: int = 8, counters: dict | None = None,
                     extras: dict | None = None) -> str:
    """The light sweep (light_sweep_views) as {out_dir}/render_360_light/
    %04d.png plus out.gif; returns that directory. Raises and counts as
    render_360 does."""
    out = os.path.join(out_dir, "render_360_light")
    local: dict = {}
    imgs = light_sweep_views(params, fid, assets, config, rcfg, num, z_range, chunk, local,
                             extras).cpu().numpy()
    _check_counters(local, "render_360_light", counters)
    save_images_parallel((imgs[i], os.path.join(out, "%04d.png" % i)) for i in range(num))
    write_gif(imgs, os.path.join(out, "out.gif"))
    return out
