"""Visual outputs (harp_tpu/utils/viz.py): image grids, red/blue
silhouette overlays, per-frame GT | pred | normal | overlay composites,
the texture-map export, and the eval's turntables (render_360), light
sweep (render_360_light), side-by-side concatenation and GIFs.

Images are written by extension with the bytes harp_tpu's Pillow writes:
.jpg through native.jpeg_bytes (Pillow's default quality 75), .png
through encode_png (Pillow's row filters and deflate settings, on zlib). PNGs are read
as Pillow opens and converts them (decode_png, read_rgba / read_rgb /
read_grey: every bit depth, colour type, palette, tRNS and Adam7), with
the pixel loops in native.png_pixels; JPEGs through native.decode_jpeg
(libjpeg's pixels). GIFs are written by a GIF89a writer with a median-cut
palette per frame and an LZW encoder (native.gif_lzw). No imaging library
is needed.
"""

from __future__ import annotations

import glob
import os
import struct
import zlib

import numpy as np
import torch

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples a pixel of each PNG colour type, and the bit depths it allows.
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


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
    RGBA uint8 -> the PNG file Pillow's Image.fromarray(arr).save(f, "PNG")
    writes, byte for byte (8 bits, no interlace): each row takes the first
    of the filters None, Up, Sub, Paeth whose bytes, read as signed, have
    the least sum of magnitudes (ZipEncode.c's adaptive choice, which does
    not try Average); deflate at level 6, memLevel 9, Z_FILTERED; IDAT
    chunks of max(65536, 4 W) bytes (ImageFile's buffer)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    color = 0 if arr.ndim == 2 else {2: 4, 3: 2, 4: 6}.get(arr.shape[2]) if arr.ndim == 3 else None
    if color is None:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 2 | 3 | 4), got {arr.shape}")
    h, w = arr.shape[:2]
    bpp = _PNG_CHANNELS[color]
    x = arr.reshape(h, w * bpp).astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    corner = np.zeros_like(x)
    corner[1:, bpp:] = x[:-1, :-bpp]
    p = left + up - corner
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - corner)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, corner))
    cands = np.stack([x, x - up, x - left, x - paeth]) & 0xFF  # None, Up, Sub, Paeth
    cost = np.minimum(cands, 256 - cands).sum(-1, dtype=np.int64)
    pick = np.argmin(cost, 0)  # the first least: Pillow keeps a filter unless one is better
    rows = np.concatenate([np.array([0, 2, 1, 4], np.int16)[pick][:, None],
                           cands[pick, np.arange(h)]], 1).astype(np.uint8)
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = z.compress(rows.tobytes()) + z.flush()
    step = max(65536, 4 * w)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + b"".join(_chunk(b"IDAT", data[i:i + step]) for i in range(0, len(data), step))
            + _chunk(b"IEND", b""))


def _png_chunks(data: bytes) -> tuple:
    """(IHDR fields, PLTE, tRNS, the joined IDAT bytes) of a PNG file, with
    Pillow's checks: the signature, a known bit depth and colour type, and
    the CRC of each chunk before the first IDAT (Pillow reads the image
    data and the chunks after it without their CRCs)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        if not idat and kind != b"IDAT":
            crc = data[pos + 8 + n:pos + 12 + n]
            if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
                raise ValueError(f"broken PNG file (bad checksum in {kind!r})")
        pos += 12 + n
        if kind == b"IHDR":
            if n < 13:
                raise ValueError("truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    _, _, depth, color, _, filt, _ = header
    if depth not in _PNG_DEPTHS.get(color, ()):
        raise ValueError(f"PNG with bit depth {depth} and colour type {color}: not a PNG mode")
    if filt:
        raise ValueError("PNG with an unknown filter method")
    if not idat:
        raise ValueError("PNG without image data")
    return header, plte, trns, b"".join(idat)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> its samples, as stored: (H, W) for grey or palette
    indices, (H, W, 2 | 3 | 4) for grey + alpha, RGB, RGBA; uint8 holding
    the sample values of a 1-, 2-, 4- or 8-bit file (not scaled), uint16
    for a 16-bit one. Every bit depth, colour type and interlace, through
    native.png_pixels; read_rgba / read_rgb / read_grey give the pixels
    as Pillow converts them."""
    header, _, _, idat = _png_chunks(data)
    return _png_samples(header, idat)


def _png_samples(header: tuple, idat: bytes) -> np.ndarray:
    from harp_tpu_torch.native import png_pixels

    w, h, depth, color, _, _, interlace = header
    try:
        raw = zlib.decompressobj().decompress(idat)
    except zlib.error as e:
        raise ValueError(f"PNG image data is corrupt: {e}") from e
    pix = png_pixels(raw, h, w, depth, _PNG_CHANNELS[color], interlace)
    return pix[..., 0] if pix.shape[2] == 1 else pix


def _open_png(data: bytes) -> tuple:
    """(mode, pixels, palette, transparency) of a PNG as Pillow 12 opens it
    (PngImagePlugin): mode "1" (0 / 255), "L" (sub-byte samples scaled to
    0..255), "I;16", "RGB", "P", "LA" or "RGBA", where 16-bit colour keeps
    each sample's high byte and 16-bit grey + alpha opens as RGBA. palette:
    (256, 4) RGBA for "P" (the PLTE entries, alpha from tRNS, the entries
    past PLTE black and opaque). transparency: tRNS's key for "1" (0 or
    255), "L", "I;16" (an int) and "RGB" (a tuple of three); None without
    one, and for the other modes."""
    header, plte, trns, idat = _png_chunks(data)
    depth, color = header[2:4]
    pix = _png_samples(header, idat)
    key = None
    if color == 3:
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        if plte:
            entries = np.frombuffer(plte[:3 * min(len(plte) // 3, 256)], np.uint8)
            palette[:len(entries) // 3, :3] = entries.reshape(-1, 3)
        if trns:
            alpha = np.frombuffer(trns[:256], np.uint8)
            palette[:len(alpha), 3] = alpha
        return "P", pix, palette, None
    if trns is not None and color in (0, 2) and len(trns) >= 2 * _PNG_CHANNELS[color]:
        vals = struct.unpack(">%dH" % _PNG_CHANNELS[color], trns[:2 * _PNG_CHANNELS[color]])
        key = vals[0] if color == 0 else vals
    if color == 0:
        if depth == 1:
            return "1", pix * np.uint8(255), None, key if key is None else 255 * (key != 0)
        if depth == 16:
            return "I;16", pix, None, key
        return "L", pix * np.uint8(255 // (2 ** depth - 1)), None, key
    hi = (pix >> 8).astype(np.uint8) if depth == 16 else pix
    if color == 2:
        return "RGB", hi, None, key
    if color == 4 and depth == 16:  # opens as RGBA: grey to R, G and B
        return "RGBA", np.concatenate([np.repeat(hi[..., :1], 3, 2), hi[..., 1:]], 2), None, None
    if color == 4:
        return "LA", hi, None, None
    return "RGBA", hi, None, None


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's convert("L") of RGB: ITU-R 601-2 luma in 16-bit fixed point."""
    rgb = rgb.astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _png_convert(data: bytes, to: str) -> np.ndarray:
    """A PNG's pixels as Pillow 12's Image.open(f).convert(to) gives them,
    to "RGBA" (H, W, 4), "RGB" (H, W, 3) or "L" (H, W), uint8. A key colour
    (tRNS of grey or RGB) makes alpha 0 where the pixel, as converted to
    8 bits, equals the key's low byte(s), as Pillow's convert_transparent
    compares them."""
    mode, pix, palette, key = _open_png(data)
    if mode == "P":
        rgba = palette[pix]
        return rgba if to == "RGBA" else rgba[..., :3] if to == "RGB" else _luma(rgba)
    if mode == "I;16":
        mode, pix = "L", np.minimum(pix, 255).astype(np.uint8)
    if mode in ("1", "L"):
        if to == "L":
            return pix
        rgb = np.repeat(pix[..., None], 3, 2)
    elif mode == "LA":
        if to == "L":
            return pix[..., 0]
        rgb = np.repeat(pix[..., :1], 3, 2)
    else:
        if to == "L":
            return _luma(pix)
        rgb = pix[..., :3]
    if to == "RGB":
        return np.ascontiguousarray(rgb)
    if mode == "RGBA":
        return pix
    if mode == "LA":
        alpha = pix[..., 1]
    elif key is not None:
        want = np.asarray(key if isinstance(key, tuple) else (key,) * 3) & 0xFF
        alpha = np.where((rgb == want).all(-1), 0, 255).astype(np.uint8)
    else:
        alpha = np.full(rgb.shape[:2], 255, np.uint8)
    return np.concatenate([rgb, alpha[..., None]], 2)


def _read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _is_jpeg(path) -> bool:
    return os.fspath(path).lower().endswith((".jpg", ".jpeg"))


def read_rgba(path) -> np.ndarray:
    """A PNG or JPEG file as (H, W, 4) uint8, as Pillow's
    Image.open(path).convert("RGBA") gives it (a JPEG: libjpeg's pixels,
    alpha 255)."""
    if _is_jpeg(path):
        rgb = read_rgb(path)
        return np.concatenate([rgb, np.full_like(rgb[..., :1], 255)], 2)
    return _png_convert(_read_bytes(path), "RGBA")


def read_rgb(path) -> np.ndarray:
    """A PNG or JPEG file as (H, W, 3) uint8, as Pillow's
    Image.open(path).convert("RGB") gives it (a JPEG through
    native.decode_jpeg, libjpeg's pixels)."""
    if _is_jpeg(path):
        from harp_tpu_torch.native import decode_jpeg

        img = decode_jpeg(_read_bytes(path))
        return np.repeat(img[..., None], 3, 2) if img.ndim == 2 else img
    return _png_convert(_read_bytes(path), "RGB")


def read_grey(path) -> np.ndarray:
    """A PNG as one channel in [0, 1], float32: Pillow's convert("L")
    (ITU-R 601-2 luma of colour, 16-bit fixed point; alpha ignored) over
    255, as harp_tpu reads its uv masks."""
    return _png_convert(_read_bytes(path), "L").astype(np.float32) / 255.0


def save_image(img, path: str) -> None:
    """A float image in [0, 1] (clipped, then * 255 truncated) or a uint8
    image, (H, W) grey stacked to RGB as harp_tpu stacks it, written by
    the path's extension as harp_tpu's Pillow writes it: .jpg / .jpeg as
    Pillow's default JPEG (quality 75, the same bytes), .png as PNG."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".jpg", ".jpeg", ".png"):
        raise ValueError(f"save_image writes .jpg and .png: {path}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = _to_uint8(img)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    if ext == ".png":
        data = encode_png(arr)
    else:
        from harp_tpu_torch.native import jpeg_bytes

        data = jpeg_bytes(arr, 75)
    with open(path, "wb") as f:
        f.write(data)


def save_images_parallel(items, workers: int = 8) -> None:
    """Write many (image, path) pairs on a thread pool (the JPEG codec,
    called through ctypes, and zlib release the interpreter lock while
    they encode)."""
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
    """The sorted *.jpg frames of in_dir, decoded as Pillow decodes them
    (native.decode_jpeg), as a looping GIF89a at duration_ms a frame
    (nothing when there are none), as harp_tpu builds its GIFs."""
    paths = sorted(glob.glob(os.path.join(in_dir, "*.jpg")))
    if paths:
        write_gif([read_rgb(p) for p in paths], out_path, duration_ms)


def concat_image_dirs(dir1: str, dir2: str, out_dir: str) -> None:
    """Side by side, the i-th sorted .jpg / .png of dir1 and of dir2 (read
    on the host as Pillow's convert("RGB") reads them), as
    out_dir/%04d.jpg, and the GIF of those JPEGs, out_dir/out.gif."""
    os.makedirs(out_dir, exist_ok=True)

    def listing(d):
        return sorted(p for p in glob.glob(os.path.join(d, "*")) if p.endswith((".jpg", ".png")))

    save_images_parallel((np.concatenate([read_rgb(a), read_rgb(b)], 1),
                          os.path.join(out_dir, "%04d.jpg" % i))
                         for i, (a, b) in enumerate(zip(listing(dir1), listing(dir2))))
    save_gif(out_dir, os.path.join(out_dir, "out.gif"))


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
    %04d.jpg (about Y) and h_%04d.jpg (about X) plus out.gif, the GIF of
    those JPEGs; returns that directory. use_shadow is accepted and
    unused, as in harp_tpu: the turntable renders without shadow. Raises
    if a raster pass still truncated a view; counters, when given,
    receives the overflow counts and the rerenders."""
    sub = "render_360_normal" if render_normal else "render_360"
    out = os.path.join(out_dir, sub)
    local: dict = {}
    imgs = turntable_views(params, fid, assets, config, rcfg, render_normal, views_per_axis,
                           chunk, local, extras).cpu().numpy()
    _check_counters(local, "render_360", counters)
    save_images_parallel(
        (imgs[i], os.path.join(out, ("" if i < views_per_axis else "h_")
                               + "%04d.jpg" % (i % views_per_axis)))
        for i in range(2 * views_per_axis))
    save_gif(out, os.path.join(out, "out.gif"))
    return out


def render_360_light(params, fid, assets, config, rcfg, out_dir: str, num: int = 40,
                     z_range=(-5.0, 5.0), chunk: int = 8, counters: dict | None = None,
                     extras: dict | None = None) -> str:
    """The light sweep (light_sweep_views) as {out_dir}/render_360_light/
    %04d.jpg plus out.gif, the GIF of those JPEGs; returns that directory.
    Raises and counts as render_360 does."""
    out = os.path.join(out_dir, "render_360_light")
    local: dict = {}
    imgs = light_sweep_views(params, fid, assets, config, rcfg, num, z_range, chunk, local,
                             extras).cpu().numpy()
    _check_counters(local, "render_360_light", counters)
    save_images_parallel((imgs[i], os.path.join(out, "%04d.jpg" % i)) for i in range(num))
    save_gif(out, os.path.join(out, "out.gif"))
    return out
