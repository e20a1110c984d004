"""harp_tpu_torch.data.dataset and the host frame decoder vs harp_tpu on
the CPU, on sequences written in the reference's layout
({seq}/metro_mano_smooth/%04d_mano.pkl, {seq}/unscreen_cropped/%04d.jpg,
{seq}/mask/%04d_mask.jpg) by PIL and by the port's own encoder.

On the CPU the port decodes with libjpeg, as harp_tpu's native loader does:
parameters, frames, masks and eroded masks are held equal bit for bit to
harp_tpu's load_sequences(use_native=True), and within 0.05 of its PIL
path (tests/test_metro_ingestion.py bounds the two there). The frames stay
within harp_tpu's JPEG bounds of the float frames: a mean of 0.015 for the
images and 0.03 for the masks (tests/test_metro_ingestion.py:75-76).
"""

import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from harp_tpu.data.dataset import load_frame_pkl as jload_frame_pkl
from harp_tpu.data.dataset import load_sequences as jload_sequences
from harp_tpu.data.dataset import save_frame_pkl as jsave_frame_pkl
from harp_tpu_torch import native
from harp_tpu_torch.data.dataset import load_frame_pkl, load_sequences, save_frame_pkl

SIZE = 48


def _frames(n, seed):
    """Smooth colour frames and disc masks, float32 in [0, 1]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    imgs, masks = [], []
    for _ in range(n):
        f = rng.uniform(4, 12, 3)
        ph = rng.uniform(0, 6.28, 3)
        imgs.append(np.stack([0.5 + 0.35 * np.sin(xx / f[c] + yy / (2 * f[c]) + ph[c])
                              for c in range(3)], -1))
        cy, cx, r = rng.uniform(18, 30), rng.uniform(18, 30), rng.uniform(8, 14)
        masks.append(((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.float32))
    return np.stack(imgs).astype(np.float32), np.stack(masks)


def _params(n, seed):
    rng = np.random.RandomState(seed)
    return {"joints": rng.randn(n, 21, 3).astype(np.float32),
            "verts": rng.randn(n, 778, 3).astype(np.float32),
            "rot": rng.randn(n, 3).astype(np.float32),
            "pose": rng.randn(n, 45).astype(np.float32),
            "shape": rng.randn(n, 10).astype(np.float32),
            "trans": rng.randn(n, 3).astype(np.float32),
            "cam": (np.array([5.0, 0.0, 0.0]) + 0.1 * rng.randn(n, 3)).astype(np.float32)}


def _pil_write(frame, path):
    arr = (np.asarray(frame) * 255).astype(np.uint8)
    Image.fromarray(arr, mode="L" if arr.ndim == 2 else "RGB").save(path, quality=95)


WRITERS = {"pil": _pil_write, "port": native.encode_jpeg}


def write_layout(root, seq, images, masks, params, writer):
    dirs = [os.path.join(root, seq, d) for d in ("unscreen_cropped", "mask", "metro_mano_smooth")]
    for d in dirs:
        os.makedirs(d)
    for i in range(images.shape[0]):
        writer(images[i], os.path.join(dirs[0], "%04d.jpg" % i))
        writer(masks[i], os.path.join(dirs[1], "%04d_mask.jpg" % i))
        save_frame_pkl(os.path.join(dirs[2], "%04d_mano.pkl" % i), params, i)


@pytest.fixture(scope="module", params=sorted(WRITERS))
def layout(request, tmp_path_factory):
    """Two sequences, "2" (3 frames) and "10" (2 frames), so the (seq,
    name) string sort puts "10" first."""
    root = str(tmp_path_factory.mktemp(f"layout_{request.param}"))
    seqs = {}
    for seq, n, seed in (("2", 3, 0), ("10", 2, 1)):
        images, masks = _frames(n, seed)
        params = _params(n, seed)
        write_layout(root, seq, images, masks, params, WRITERS[request.param])
        seqs[seq] = (images, masks, params)
    return root, seqs


def test_load_sequences_equals_harp_tpus_native_path(layout):
    root, seqs = layout
    params, images, masks, eroded = load_sequences(root, root, ["2", "10"], device="cpu")
    jparams, jimages, jmasks, jeroded = jload_sequences(root, root, ["2", "10"], use_native=True)
    assert list(params) == list(jparams)
    for k in jparams:
        np.testing.assert_array_equal(params[k], jparams[k], err_msg=k)
    for got, want in ((images, jimages), (masks, jmasks), (eroded, jeroded)):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    # "10" sorts before "2"; each frame keeps its own parameters.
    want_pose = np.concatenate([seqs["10"][2]["pose"], seqs["2"][2]["pose"]])
    np.testing.assert_array_equal(params["pose"], want_pose)
    # Within harp_tpu's JPEG bounds of the float frames.
    float_images = np.concatenate([seqs["10"][0], seqs["2"][0]])
    float_masks = np.concatenate([seqs["10"][1], seqs["2"][1]])
    assert np.abs(images.numpy() - float_images).mean() < 0.015
    assert np.abs(masks.numpy() - float_masks).mean() < 0.03


def test_decode_is_within_005_of_harp_tpus_pil_path(layout):
    root, _ = layout
    _, images, masks, eroded = load_sequences(root, root, ["2"], device="cpu")
    _, jimages, jmasks, jeroded = jload_sequences(root, root, ["2"], use_native=False)
    assert np.abs(images.numpy() - jimages).max() < 0.05
    assert np.abs(masks.numpy() - jmasks).max() < 0.05
    assert np.abs(eroded.numpy() - jeroded).mean() < 0.02


def test_average_cam_sequence_equals_harp_tpu(layout):
    root, seqs = layout
    params, *_ = load_sequences(root, root, ["10", "2"], average_cam_sequence=True,
                                device="cpu")
    jparams, *_ = jload_sequences(root, root, ["10", "2"], average_cam_sequence=True)
    np.testing.assert_array_equal(params["cam"], jparams["cam"])
    np.testing.assert_array_equal(params["cam"][:2],
                                  np.tile(seqs["10"][2]["cam"].mean(0), (2, 1)))


def test_frame_pkls_cross_read(tmp_path):
    params = _params(3, 5)
    save_frame_pkl(str(tmp_path / "port.pkl"), {k: torch.from_numpy(v) for k, v in
                                                params.items()}, 1)
    jsave_frame_pkl(str(tmp_path / "jax.pkl"), params, 1)
    for ours, theirs in ((load_frame_pkl(str(tmp_path / "jax.pkl")),
                          jload_frame_pkl(str(tmp_path / "port.pkl"))),):
        assert set(ours) == set(theirs) == set(params)
        for k in params:
            want = params[k][1] if k == "cam" else params[k][1:2]
            np.testing.assert_array_equal(ours[k], want)
            np.testing.assert_array_equal(theirs[k], want)
    with open(tmp_path / "port.pkl", "rb") as f:
        raw = pickle.load(f)
    assert raw["cam"].shape == (3,) and raw["pose"].shape == (1, 45)


def test_port_encoder_writes_what_pil_reads(tmp_path):
    images, masks = _frames(1, 7)
    native.encode_jpeg(images[0], tmp_path / "a.jpg")
    native.encode_jpeg(torch.from_numpy(masks[0]), tmp_path / "m.jpg")
    a, m = Image.open(tmp_path / "a.jpg"), Image.open(tmp_path / "m.jpg")
    assert (a.mode, a.size, m.mode, m.size) == ("RGB", (SIZE, SIZE), "L", (SIZE, SIZE))
    assert np.abs(np.asarray(a) / 255.0 - images[0]).mean() < 0.015
    assert np.abs(np.asarray(m) / 255.0 - masks[0]).mean() < 0.03


def test_missing_corrupt_or_wrong_size_frames_raise_with_their_path(tmp_path):
    images, masks = _frames(2, 3)
    good = [str(tmp_path / f"{i}.jpg") for i in range(2)]
    for img, p in zip(images, good):
        native.encode_jpeg(img, p)
    small = str(tmp_path / "small.jpg")
    native.encode_jpeg(images[0][:40], small)
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"not a jpeg")
    missing = str(tmp_path / "missing.jpg")
    for paths, what in ((good + [missing], "missing.jpg cannot be opened"),
                        (good + [small], "small.jpg has another size"),
                        (good + [bad], "bad.jpg is not a decodable JPEG"),
                        ([missing] + good, "missing.jpg cannot be opened")):
        with pytest.raises(OSError, match=what):
            native.decode_jpeg_batch(paths, device="cpu")
    assert native.decode_jpeg_batch(good, device="cpu").shape == (2, SIZE, SIZE, 3)


def test_decode_needs_a_device(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        native.decode_jpeg_batch([str(tmp_path / "0.jpg")])
