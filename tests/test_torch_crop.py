"""harp_tpu_torch.preprocess.crop against harp_tpu's (Pillow 12) on CPU:
the bilinear resize, the centre crop, the white-background paste, one
frame, and a whole sequence written as JPEG. Every array is held bit for
bit, over a hypothesis sweep of sizes (up- and down-scaling, portrait and
landscape, odd sizes) and both modes ("L" and "RGB"); the JPEG files too
(quality 95: Pillow's libjpeg and the port's jpeg_codec.cpp write the same
bytes). Frames of any PNG mode (palette, 16-bit, interlaced) crop as
harp_tpu crops them.
"""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from harp_tpu.preprocess import crop as JC
from harp_tpu_torch.preprocess import crop as C
from harp_tpu_torch.preprocess import crop_frame, crop_unscreen_sequence, resize_center_crop
from harp_tpu_torch.utils import viz


def _image(h, w, channels, seed):
    """Half noise, half smooth gradients: both kinds of rounding."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    smooth = (np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128
    noise = rng.randint(0, 256, (h, w))
    base = np.where(xx < w // 2, smooth, noise).astype(np.uint8)
    if channels == 1:
        return base
    return np.stack([base, 255 - base, np.roll(base, 3, 1)][:channels], -1)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(h=st.integers(1, 160), w=st.integers(1, 160), ow=st.integers(1, 160),
       oh=st.integers(1, 160), rgb=st.booleans())
def test_bilinear_resize_is_pillows_bit_for_bit(h, w, ow, oh, rgb):
    arr = _image(h, w, 3 if rgb else 1, h * 1000 + w)
    want = np.asarray(Image.fromarray(arr).resize((ow, oh), Image.BILINEAR))
    got = C.resize_bilinear(torch.from_numpy(arr), ow, oh).numpy()
    np.testing.assert_array_equal(got, want)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(h=st.integers(20, 400), w=st.integers(20, 400), res=st.sampled_from([16, 33, 64]),
       rgb=st.booleans())
def test_resize_center_crop_and_fill_match_harp_tpu(h, w, res, rgb):
    arr = _image(h, w, 3 if rgb else 1, 7 * h + w)
    want = np.asarray(JC.resize_center_crop(Image.fromarray(arr), res))
    got = resize_center_crop(arr, res)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(resize_center_crop(torch.from_numpy(arr), res).numpy(), want)
    if rgb:
        mask = resize_center_crop(_image(h, w, 1, h + 3 * w), res)
        filled = JC.fill_img_background(Image.fromarray(want), Image.fromarray(mask))
        np.testing.assert_array_equal(C.fill_img_background(got, mask), np.asarray(filled))


def test_fill_img_background_blends_every_pair_as_pillow():
    """Every (source value, mask value) pair of 0..255 once."""
    src = np.repeat(np.arange(256, dtype=np.uint8)[:, None, None], 256, 1).repeat(3, 2)
    mask = np.repeat(np.arange(256, dtype=np.uint8)[None, :], 256, 0)
    want = JC.fill_img_background(Image.fromarray(src), Image.fromarray(mask))
    np.testing.assert_array_equal(C.fill_img_background(src, mask), np.asarray(want))


def _soft_alpha(h, w, seed):
    yy, xx = np.mgrid[:h, :w]
    d = np.hypot(yy - h * 0.55, xx - w * 0.4) / (0.3 * min(h, w))
    return (np.clip(1.5 - d, 0, 1) * 255).astype(np.uint8)


def _write_frames(tmp_path, sizes, pil_writer: bool):
    """RGBA unscreen frames (soft alpha) and their RGB originals, written by
    PIL or by the port's encode_png (which writes PIL's bytes)."""
    un, ori = tmp_path / "unscreen", tmp_path / "ori"
    un.mkdir()
    ori.mkdir()
    for i, (h, w) in enumerate(sizes):
        rgba = np.concatenate([_image(h, w, 3, i), _soft_alpha(h, w, i)[..., None]], 2)
        orig = _image(h, w, 3, 100 + i)
        for arr, path in ((rgba, un / f"{i:04d}.png"), (orig, ori / f"{i:04d}.png")):
            if pil_writer:
                Image.fromarray(arr).save(path)
            else:
                path.write_bytes(viz.encode_png(arr))
    (un / "0000_mask.png").write_bytes(viz.encode_png(np.zeros((4, 4), np.uint8)))
    (un / "0001_pred.png").write_bytes(viz.encode_png(np.zeros((4, 4), np.uint8)))
    return str(un), str(ori)


@pytest.mark.parametrize("pil_writer", [True, False])
def test_crop_frame_matches_harp_tpu(tmp_path, pil_writer):
    un, ori = _write_frames(tmp_path, [(90, 60), (50, 77)], pil_writer)
    frames = C.list_frames(un)
    assert frames == JC.list_frames(un) and len(frames) == 2
    assert [C.frame_index(p) for p in frames] == [JC.frame_index(p) for p in frames] == [0, 1]
    for path in frames:
        for ori_path in (None, os.path.join(ori, os.path.basename(path))):
            want_rgb, want_mask = JC.crop_frame(path, ori_path, 32)
            rgb, mask = crop_frame(path, ori_path, 32, device="cpu")
            np.testing.assert_array_equal(rgb.numpy(), want_rgb)
            np.testing.assert_array_equal(mask.numpy(), want_mask)
            assert 0 < mask.float().mean() < 255


def test_crop_reads_rgb_and_grey_frames_as_pillows_rgba(tmp_path):
    img = _image(40, 30, 3, 5)
    for arr in (img, img[..., 0], np.stack([img[..., 0], img[..., 1]], -1)):
        path = str(tmp_path / f"{arr.ndim}_{arr.shape[-1]}.png")
        Image.fromarray(arr).save(path)
        want_rgb, want_mask = JC.crop_frame(path, None, 16)
        rgb, mask = crop_frame(path, None, 16, device="cpu")
        np.testing.assert_array_equal(rgb.numpy(), want_rgb)
        np.testing.assert_array_equal(mask.numpy(), want_mask)


def test_crop_unscreen_sequence_writes_harp_tpus_files(tmp_path):
    """Pillow's libjpeg and jpeg_codec.cpp at quality 95: the same bytes."""
    un, ori = _write_frames(tmp_path, [(80, 56)] * 3, pil_writer=True)
    n_want = JC.crop_unscreen_sequence(un, str(tmp_path / "want"), ori_img_dir=ori, res=32)
    n_got = crop_unscreen_sequence(un, str(tmp_path / "got"), ori_img_dir=ori, res=32,
                                   device="cpu")
    assert n_got == n_want == 3
    for sub, names in (("unscreen_cropped", ["%04d.jpg" % i for i in range(3)]),
                       ("mask", ["%04d_mask.jpg" % i for i in range(3)])):
        assert sorted(os.listdir(tmp_path / "got" / sub)) == names
        for name in names:
            got = (tmp_path / "got" / sub / name).read_bytes()
            assert got == (tmp_path / "want" / sub / name).read_bytes(), name
    # A non-empty output is left alone, as harp_tpu leaves it.
    assert crop_unscreen_sequence(un, str(tmp_path / "got"), res=32, device="cpu") == 3


def test_crop_reads_palette_deep_and_interlaced_pngs_and_refuses_what_pillow_cannot(
        tmp_path):
    """A palette frame (with tRNS: its alpha is the mask), a 16-bit grey
    frame and 16-bit RGBA original, and an interlaced RGBA frame: the same
    bits as harp_tpu's crop_frame. A PNG with a broken IHDR checksum is
    refused, as Pillow refuses it; so is a file that is neither PNG nor
    JPEG (the port's own limit: Pillow would read a BMP)."""
    from test_torch_image_io import make_png

    img = _image(30, 22, 3, 0)
    alpha = _soft_alpha(30, 22, 0)
    pal = Image.fromarray(img).quantize(64)
    pal.info["transparency"] = bytes(np.arange(0, 256, 4, dtype=np.uint8))
    pal.save(tmp_path / "pal.png")
    Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(tmp_path / "deep.png")
    deep_rgba = np.concatenate([img, alpha[..., None]], 2).astype(np.uint16) * 257 + 3
    (tmp_path / "deep_rgba.png").write_bytes(make_png(deep_rgba, 16, 6))
    (tmp_path / "inter.png").write_bytes(
        make_png(np.concatenate([img, alpha[..., None]], 2), 8, 6, interlace=1))
    for name, ori in (("pal.png", None), ("deep.png", "deep_rgba.png"), ("inter.png", None),
                      ("inter.png", "pal.png")):
        path, ori_path = str(tmp_path / name), ori and str(tmp_path / ori)
        want_rgb, want_mask = JC.crop_frame(path, ori_path, 16)
        rgb, mask = crop_frame(path, ori_path, 16, device="cpu")
        np.testing.assert_array_equal(rgb.numpy(), want_rgb, err_msg=name)
        np.testing.assert_array_equal(mask.numpy(), want_mask, err_msg=name)
    broken = bytearray(viz.encode_png(img))
    broken[29] ^= 1  # IHDR's CRC
    (tmp_path / "broken.png").write_bytes(bytes(broken))
    with pytest.raises(Exception):
        JC.crop_frame(str(tmp_path / "broken.png"), None, 8)
    Image.fromarray(img).save(tmp_path / "frame.bmp")
    for name, match in (("broken.png", "bad checksum"),
                        ("frame.bmp", "PNG and JPEG frames only")):
        with pytest.raises(ValueError, match=match):
            crop_frame(str(tmp_path / name), None, 8, device="cpu")


@pytest.mark.parametrize("pil_writer", [True, False])
def test_crop_reads_jpeg_frames_as_pillows_rgba(tmp_path, pil_writer):
    """A .jpg unscreen frame (list_frames returns them) and a .jpg original,
    RGB and grey: decoded by libjpeg with alpha 255, as Pillow's
    convert("RGBA") reads them; the same bits as harp_tpu's crop_frame.
    The JPEGs are Pillow's or the port's own (quality 95)."""
    from harp_tpu_torch.native import encode_jpeg

    un = tmp_path / "unscreen"
    un.mkdir()
    frames = {"0000.jpg": _image(70, 45, 3, 1), "0001.jpg": _image(40, 90, 1, 2),
              "0002.png": np.concatenate([_image(50, 50, 3, 3),
                                          _soft_alpha(50, 50, 3)[..., None]], 2)}
    for name, arr in frames.items():
        if pil_writer or name.endswith(".png"):
            Image.fromarray(arr).save(un / name, quality=95)
        else:
            encode_jpeg(torch.from_numpy(arr), str(un / name), 95)
    ori = tmp_path / "ori.jpg"
    Image.fromarray(_image(50, 50, 3, 4)).save(ori, quality=90)
    paths = C.list_frames(str(un))
    assert paths == JC.list_frames(str(un)) and len(paths) == 3
    for path in paths:
        for ori_path in (None, str(ori)):
            want_rgb, want_mask = JC.crop_frame(path, ori_path, 24)
            rgb, mask = crop_frame(path, ori_path, 24, device="cpu")
            np.testing.assert_array_equal(rgb.numpy(), want_rgb, err_msg=path)
            np.testing.assert_array_equal(mask.numpy(), want_mask, err_msg=path)
        if path.endswith(".jpg"):
            assert (mask == 255).all()
