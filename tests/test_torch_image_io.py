"""The port's image files and readers against harp_tpu's Pillow 12, on the
CPU (harp_tpu_torch.utils.viz, harp_tpu_torch.native):

- save_image: the .jpg and .png bytes equal harp_tpu's save_image's for
  float, uint8 and 2-D inputs (native/jpeg_codec.cpp at quality 75 and
  encode_png carry Pillow's arithmetic over), exactly. The codec's JPEGs
  at quality 95 and grey equal Pillow's too, and native.decode_jpeg
  equals Pillow's decode of 4:4:4, 4:2:2, 4:2:0 and grey JPEGs, with
  optimised Huffman tables and restart markers; a progressive JPEG is
  refused.
- The PNG sweep: every legal colour type x bit depth x interlace 0 / 1 x
  with and without tRNS (where PNG allows one), every filter type forced
  on some rows, odd sizes (13 x 11: Adam7 leaves passes empty), written by
  this file's own encoder (Pillow writes neither interlace nor chosen
  filters); read_rgba, read_rgb and read_grey equal Pillow's
  convert("RGBA" | "RGB" | "L") bit for bit. Files Pillow refuses are
  refused.
- A 1920 x 1080 RGBA frame whose every row is Paeth-filtered (the
  pattern of chip_smoke.png_all_paeth) reads as Pillow reads it.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from harp_tpu.utils import viz as jviz
from harp_tpu_torch import native
from harp_tpu_torch.utils import viz

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack_row(samples, depth):
    """One row of (W, C) sample values as PNG bytes: big-endian 16-bit, or
    sub-byte samples packed from the most significant bit."""
    if depth == 16:
        return samples.astype(">u2").tobytes()
    flat = samples.reshape(-1).astype(np.int64)
    if depth == 8:
        return flat.astype(np.uint8).tobytes()
    out = np.zeros((len(flat) * depth + 7) // 8, np.int64)
    bit = np.arange(len(flat)) * depth
    np.add.at(out, bit // 8, flat << (8 - depth - bit % 8))
    return out.astype(np.uint8).tobytes()


def _filter_rows(rows, bpp, ftypes):
    """PNG row filtering, row i with filter ftypes[i % len(ftypes)]."""
    out, prev = [], None
    for i, r in enumerate(rows):
        x = np.frombuffer(r, np.uint8).astype(np.int64)
        b = np.zeros_like(x) if prev is None else prev
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])[:len(x)]
        c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])[:len(x)]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftypes[i % len(ftypes)]
        pred = (0 * x, a, b, (a + b) // 2, paeth)[f]
        out.append(bytes([f]) + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x
    return out


def make_png(samples, depth, color, interlace=0, ftypes=(0, 1, 2, 3, 4), plte=None,
             trns=None):
    """A PNG of (H, W[, C]) sample values: the given filters row by row
    (each Adam7 pass on its own), optionally interlaced, PLTE and tRNS."""
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            raw += b"".join(_filter_rows([_pack_row(r, depth) for r in sub], bpp, ftypes))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                                               0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _sweep():
    cases = []
    for color, depths in DEPTHS.items():
        for depth in depths:
            for interlace in (0, 1):
                for trns in ((False, True) if color in (0, 2, 3) else (False,)):
                    cases.append((color, depth, interlace, trns))
    return cases


def _sweep_png(color, depth, interlace, with_trns):
    rng = np.random.RandomState(color * 100 + depth * 10 + interlace * 2 + with_trns)
    h, w = (13, 11) if interlace else (11, 13)
    top = 2 ** depth
    plte = trns = None
    if color == 3:
        n = min(top, 200)
        s = rng.randint(0, n, (h, w))
        plte = rng.randint(0, 256, 3 * n).astype(np.uint8).tobytes()
        if with_trns:  # alphas for the palette's first half + 1 entries, the rest opaque
            trns = rng.randint(0, 256, n // 2 + 1).astype(np.uint8).tobytes()
    else:
        s = rng.randint(0, top, (h, w, CHANNELS[color]))
        if with_trns:  # a key colour present in the image
            trns = b"".join(int(v).to_bytes(2, "big") for v in s[0, 0])
    return make_png(s.astype(np.uint16 if depth == 16 else np.uint8), depth, color, interlace,
                    plte=plte, trns=trns)


@pytest.mark.parametrize("color,depth,interlace,trns", _sweep())
def test_png_readers_equal_pillows_conversions(tmp_path, color, depth, interlace, trns):
    path = tmp_path / "f.png"
    path.write_bytes(_sweep_png(color, depth, interlace, trns))
    im = Image.open(path)
    np.testing.assert_array_equal(viz.read_rgba(path), np.asarray(im.convert("RGBA")))
    np.testing.assert_array_equal(viz.read_rgb(path), np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(
        viz.read_grey(path), np.asarray(im.convert("L")).astype(np.float32) / 255.0)


def test_png_samples_are_the_written_ones():
    """decode_png gives each sample as written, sub-byte values unscaled."""
    rng = np.random.RandomState(0)
    for depth, color in ((1, 0), (2, 3), (4, 0), (16, 2), (8, 6)):
        s = rng.randint(0, 2 ** depth, (9, 7, CHANNELS[color]))
        s = s.astype(np.uint16 if depth == 16 else np.uint8)
        for interlace in (0, 1):
            got = viz.decode_png(make_png(s, depth, color, interlace,
                                          plte=bytes(3 * 16) if color == 3 else None))
            np.testing.assert_array_equal(got, s[..., 0] if s.shape[2] == 1 else s)


def test_pngs_pillow_refuses_are_refused(tmp_path):
    good = make_png(np.zeros((4, 4), np.uint8), 8, 0)
    bad_crc = bytearray(good)
    bad_crc[29] ^= 1  # IHDR's CRC
    bad = {"depth 4, colour 2": b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 4, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(bytes(8))) + _chunk(b"IEND", b""),
           "IHDR checksum": bytes(bad_crc),
           "truncated": good[:good.index(b"IDAT") + 8],
           "not a PNG": b"GIF89a"}
    for what, data in bad.items():
        with pytest.raises(Exception):
            Image.open(io.BytesIO(data)).convert("RGB")
        path = tmp_path / "bad.png"
        path.write_bytes(data)
        with pytest.raises(ValueError):
            viz.read_rgb(path)


def test_an_all_paeth_full_hd_frame_reads_as_pillow_reads_it(tmp_path):
    yy, xx = np.mgrid[:1920, :1080]
    arr = np.stack([xx * 255 // 1079, yy * 255 // 1919, (xx + yy) % 256, (xx * yy) % 256],
                   -1).astype(np.uint8)
    path = tmp_path / "paeth.png"
    path.write_bytes(make_png(arr, 8, 6, ftypes=(4,)))
    np.testing.assert_array_equal(viz.read_rgba(path), np.asarray(Image.open(path)))
    np.testing.assert_array_equal(viz.decode_png(path.read_bytes()), arr)


def _frames():
    rng = np.random.RandomState(4)
    yy, xx = np.mgrid[:37, :53]
    smooth = np.stack([np.sin(xx / 6.0), np.cos(yy / 4.0), np.sin((xx + yy) / 9.0)], -1)
    img = (smooth * 0.4 + 0.5).astype(np.float32)
    img[:, 30:] = rng.uniform(0, 1, (37, 23, 3))
    img[0, 0] = (-0.2, 1.3, 0.5)  # clipped
    return {"float": img, "uint8": (img.clip(0, 1) * 255).astype(np.uint8),
            "grey": img[..., 1]}


@pytest.mark.parametrize("ext", ["jpg", "png"])
@pytest.mark.parametrize("kind", ["float", "uint8", "grey"])
def test_save_image_writes_harp_tpus_bytes(tmp_path, ext, kind):
    img = _frames()[kind]
    viz.save_image(img, str(tmp_path / f"port.{ext}"))
    jviz.save_image(img, str(tmp_path / f"jax.{ext}"))
    assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()


def test_save_image_refuses_other_formats(tmp_path):
    with pytest.raises(ValueError, match=".jpg and .png"):
        viz.save_image(np.zeros((2, 2, 3)), str(tmp_path / "frame.bmp"))


def _pil_jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def test_jpeg_codec_equals_libjpeg_through_pillow():
    """Sizes that leave partial MCUs and odd chroma rows and columns."""
    rng = np.random.RandomState(1)
    for h, w in ((1, 1), (2, 3), (8, 8), (17, 33), (31, 7), (100, 77)):
        yy, xx = np.mgrid[:h, :w]
        img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                        (xx + yy) * 7 % 256], -1).astype(np.uint8)
        img[h // 2:] = rng.randint(0, 256, img[h // 2:].shape)
        for q in (75, 95):
            for arr in (img, np.ascontiguousarray(img[..., 1])):
                want = _pil_jpeg(arr, quality=q)
                assert native.jpeg_bytes(arr, q) == want, (h, w, q, arr.ndim)
                got = native.decode_jpeg(want)
                np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(want))))
        for kw in ({"subsampling": 0}, {"subsampling": 1}, {"optimize": True},
                   {"restart_marker_blocks": 2}):
            data = _pil_jpeg(img, quality=85, **kw)
            np.testing.assert_array_equal(native.decode_jpeg(data),
                                          np.asarray(Image.open(io.BytesIO(data))))
    with pytest.raises(ValueError, match="progressive"):
        native.decode_jpeg(_pil_jpeg(img, progressive=True))
