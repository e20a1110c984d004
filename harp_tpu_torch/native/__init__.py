"""JPEG frames in and out (harp_tpu/native): the decoder that ingests a
sequence, and the encoder that writes one.

Two libraries, each built at first use into harp_tpu_torch/_build/ under a
name that hashes its source and flags, and bound through ctypes:

- frameloader.cpp, on libjpeg (g++ -ljpeg): the host path, taken for a CPU
  device. It decodes any JPEG libjpeg reads on a pool of threads into one
  float32 array, bit for bit as harp_tpu's native loader does against the
  same libjpeg.
- frameloader_nvjpeg.cu, on nvJPEG (nvcc -lnvjpeg, csrc/build.py): the
  card path, taken for a CUDA device. One batched decode writes uint8
  frames into device memory, scaled by 1/255 there.

Either way a sequence's frames arrive as one tensor on the device, made
once: the fit has no per-step loader. There is no fallback between the
two: a missing library raises an error that names it, and a file that is
missing, is no JPEG or has another size than the first raises with its
path.

Three more host libraries need no other library, so they build wherever
g++ is, the card's machine included, and give the same bytes there:

- jpeg_codec.cpp: the JPEG writer of the port's images (utils/viz.py
  save_image) and of encode_jpeg on the host, with Pillow's (libjpeg's)
  bytes, and the reader of the JPEGs the port writes (decode_jpeg), with
  libjpeg's pixels;
- png_decode.cpp: the row filters, interlace and sample unpacking of the
  port's PNG reader (utils/viz.py decode_png): png_pixels();
- gif_lzw.cpp: the LZW loop of the port's GIF writer (utils/viz.py
  save_gif): gif_lzw().
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
HOST_SOURCE = _HERE / "frameloader.cpp"
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
HOST_LIBS = ["-ljpeg"]
GIF_SOURCE = _HERE / "gif_lzw.cpp"
JPEG_SOURCE = _HERE / "jpeg_codec.cpp"
PNG_SOURCE = _HERE / "png_decode.cpp"
_BUILD_LOCK = threading.Lock()
_STATUS = {1: "cannot be opened", 2: "is not a decodable JPEG", 3: "has another size",
           4: "cannot be written"}


def _build_host(source: Path, libs: list, what: str, needs: str) -> ctypes.CDLL:
    """The shared library of a host C++ source, built by g++ ($CXX) into
    BUILD_DIR first if needed, under a name hashing source and flags.
    Raises, naming `needs`, when the compiler or a library is absent."""
    h = hashlib.sha256(source.read_bytes() + " ".join(HOST_FLAGS + libs).encode()).hexdigest()[:12]
    path = BUILD_DIR / f"lib{source.stem}_{h}.so"
    with _BUILD_LOCK:  # one build at a time in this process (the GIF writer's threads)
        if not path.exists():
            _compile_host(source, libs, what, needs, path)
    return ctypes.CDLL(str(path))


def _compile_host(source: Path, libs: list, what: str, needs: str, path: Path) -> None:
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(f"{what} needs a C++ compiler ({cxx}){needs}; no compiler is found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *HOST_FLAGS, str(source), *libs, "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} needs a C++ compiler{needs}; building {source.name} "
                           "failed:\n" + proc.stdout + proc.stderr)
    os.replace(tmp, path)


@functools.cache
def _host() -> ctypes.CDLL:
    """The libjpeg library, built first if needed. Raises, naming libjpeg,
    when the compiler or the library is absent."""
    lib = _build_host(HOST_SOURCE, HOST_LIBS, "the host frame decoder",
                      " and libjpeg (jpeglib.h and libjpeg.so)")
    lib.hf_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int)]
    lib.hf_probe.restype = ctypes.c_int
    lib.hf_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p]
    lib.hf_decode_batch.restype = ctypes.c_long
    return lib


@functools.cache
def _card() -> ctypes.CDLL:
    from harp_tpu_torch.csrc import build

    try:
        lib = build.load("nvjpeg")
    except RuntimeError as e:
        raise RuntimeError("the card's frame decoder needs nvJPEG (nvjpeg.h and "
                           f"libnvjpeg.so of the CUDA toolkit): {e}") from e
    vp, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    lib.hn_info.argtypes = [ctypes.c_char_p, sz, ctypes.POINTER(i), ctypes.POINTER(i),
                            ctypes.POINTER(i)]
    lib.hn_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(sz), i, i,
                                    vp, i, i, vp]
    lib.hn_encode_bound.argtypes = [i, i, i, i, ctypes.POINTER(sz)]
    lib.hn_encode.argtypes = [vp, i, i, i, i, vp, vp, sz, ctypes.POINTER(sz)]
    for f in (lib.hn_info, lib.hn_decode_batch, lib.hn_encode_bound, lib.hn_encode):
        f.restype = i
    return lib


def _nvjpeg_check(st: int, what: str) -> None:
    if st != 0:
        raise RuntimeError(f"nvJPEG: {what} failed with status {st}")


def _read_all(paths) -> list[bytes]:
    out = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                out.append(f.read())
        except OSError as e:
            raise OSError(f"frame {p} cannot be opened: {e}") from e
    return out


def _decode_host(paths: list[str], gray: bool) -> torch.Tensor:
    lib = _host()
    h, w = ctypes.c_int(), ctypes.c_int()
    st = lib.hf_probe(paths[0].encode(), ctypes.byref(h), ctypes.byref(w))
    if st:
        raise OSError(f"frame {paths[0]} {_STATUS[st]}")
    n = len(paths)
    out = np.empty((n, h.value, w.value) + (() if gray else (3,)), np.float32)
    status = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    bad = lib.hf_decode_batch(c_paths, n, h.value, w.value, int(gray), 0,  # 0: every core
                              out.ctypes.data, status.ctypes.data)
    if bad >= 0:
        raise OSError(f"frame {paths[bad]} {_STATUS[int(status[bad])]}"
                      + (f" than {paths[0]} ({h.value}x{w.value})" if status[bad] == 3 else ""))
    return torch.from_numpy(out)


def _decode_card(paths: list[str], gray: bool, device: torch.device) -> torch.Tensor:
    lib = _card()
    blobs = _read_all(paths)
    dims = None
    for p, b in zip(paths, blobs):
        comps, w, h = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        st = lib.hn_info(b, len(b), ctypes.byref(comps), ctypes.byref(w), ctypes.byref(h))
        if st != 0:
            raise OSError(f"frame {p} is not a decodable JPEG (nvJPEG status {st})")
        if dims is None:
            dims = (h.value, w.value)
        elif (h.value, w.value) != dims:
            raise OSError(f"frame {p} has another size ({h.value}x{w.value}) than "
                          f"{paths[0]} ({dims[0]}x{dims[1]})")
    n, (H, W) = len(paths), dims
    out = torch.empty((n, H, W) + (() if gray else (3,)), dtype=torch.uint8, device=device)
    c_data = (ctypes.c_char_p * n)(*blobs)
    c_lens = (ctypes.c_size_t * n)(*[len(b) for b in blobs])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _nvjpeg_check(lib.hn_decode_batch(c_data, c_lens, n, int(gray), out.data_ptr(), H, W,
                                          stream), f"the batched decode of {n} frames")
        # The bitstreams are host buffers of this call: keep them alive
        # until the decode that reads them has finished.
        torch.cuda.current_stream(device).synchronize()
    return out


def decode_jpeg_batch(paths, gray: bool = False, device=None) -> torch.Tensor:
    """Same-size JPEG files -> float32 in [0, 1] on `device`: (N, H, W, 3),
    or (N, H, W) with `gray` (the luma plane). A CPU device decodes with
    libjpeg on one thread per core; a CUDA device with nvJPEG on the card.
    Runs on CUDA unless the caller names a device."""
    from harp_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    paths = [os.fspath(p) for p in paths]
    if not paths:
        raise ValueError("decode_jpeg_batch: no frames")
    if dev.type == "cuda":
        # v * (1/255) in float32, the host decoder's rounding (the double
        # 1/255 rounds to 1.0f/255.0f).
        return _decode_card(paths, gray, dev).float() * (1.0 / 255.0)
    return _decode_host(paths, gray).to(dev)


def encode_jpeg(frame, path, quality: int = 95) -> None:
    """One frame -> a baseline JPEG file at `quality`, as Pillow's
    Image.save(path, quality=quality) writes it: (H, W, 3) RGB or (H, W)
    grey, uint8 or float in [0, 1] (quantised as harp_tpu's writers do:
    (x * 255).astype(uint8)). A CPU tensor or numpy array goes through
    jpeg_codec.cpp (Pillow's bytes on any machine), a CUDA tensor through
    nvJPEG's encoder."""
    path = os.fspath(path)
    if isinstance(frame, torch.Tensor) and frame.device.type == "cuda":
        x = frame if frame.dtype == torch.uint8 else (frame * 255).to(torch.uint8)
        x = x.contiguous()
        h, w = x.shape[:2]
        c = 1 if x.dim() == 2 else x.shape[2]
        lib = _card()
        cap = ctypes.c_size_t()
        _nvjpeg_check(lib.hn_encode_bound(h, w, c, quality, ctypes.byref(cap)),
                      "the encoder's buffer size")
        buf = ctypes.create_string_buffer(cap.value)
        n = ctypes.c_size_t()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            _nvjpeg_check(lib.hn_encode(x.data_ptr(), h, w, c, quality, stream, buf,
                                        cap.value, ctypes.byref(n)), f"encoding {path}")
        data = buf.raw[:n.value]
    else:
        a = frame.detach().cpu().numpy() if isinstance(frame, torch.Tensor) else np.asarray(frame)
        if a.dtype != np.uint8:
            a = (a * 255).astype(np.uint8)
        data = jpeg_bytes(a, quality)
    try:
        with open(path, "wb") as f:
            f.write(data)
    except OSError as e:
        raise OSError(f"frame {path} {_STATUS[4]}: {e}") from e


@functools.cache
def _codec() -> ctypes.CDLL:
    lib = _build_host(JPEG_SOURCE, [], "the host JPEG codec", "")
    u8p, i = ctypes.c_void_p, ctypes.c_int
    lib.hj_encode.argtypes = [u8p, i, i, i, i, u8p, ctypes.c_long]
    lib.hj_encode.restype = ctypes.c_long
    lib.hj_info.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(i), ctypes.POINTER(i),
                            ctypes.POINTER(i), ctypes.c_char_p, i]
    lib.hj_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, u8p, i, i, i, ctypes.c_char_p, i]
    lib.hj_info.restype = lib.hj_decode.restype = i
    return lib


def jpeg_bytes(img: np.ndarray, quality: int = 75) -> bytes:
    """(H, W, 3) RGB or (H, W) grey uint8 -> the JPEG file Pillow's
    Image.fromarray(img).save(f, "JPEG", quality=quality) writes (4:2:0
    for colour), byte for byte."""
    a = np.ascontiguousarray(img, np.uint8)
    if a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] != 3) or 0 in a.shape:
        raise ValueError(f"jpeg_bytes takes (H, W) or (H, W, 3) uint8, got {a.shape}")
    c = 1 if a.ndim == 2 else 3
    h16, w16 = -(-a.shape[0] // 16) * 16, -(-a.shape[1] // 16) * 16
    cap = 8 * h16 * w16 * c + 4096  # > 6.6 bytes a sample, the worst case with stuffing
    out = np.empty(cap, np.uint8)
    n = _codec().hj_encode(a.ctypes.data, a.shape[0], a.shape[1], c, quality, out.ctypes.data,
                           cap)
    if n < 0:
        raise RuntimeError("jpeg_bytes: the output buffer is too short")
    return out[:n].tobytes()


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline or extended sequential JPEG's bytes -> uint8 pixels as
    libjpeg decodes them by default (the accurate integer IDCT, fancy
    upsampling), as Pillow's Image.open gives them: (H, W) grey or
    (H, W, 3) RGB. Raises ValueError with the reason for a file it cannot
    read (progressive, arithmetic-coded, 12-bit, CMYK, corrupt)."""
    lib = _codec()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if lib.hj_info(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c), err,
                   256):
        raise ValueError(f"JPEG: {err.value.decode()}")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.hj_decode(data, len(data), out.ctypes.data, h.value, w.value, c.value, err, 256):
        raise ValueError(f"JPEG: {err.value.decode()}")
    return out[..., 0] if c.value == 1 else out


@functools.cache
def _png() -> ctypes.CDLL:
    lib = _build_host(PNG_SOURCE, [], "the PNG reader", "")
    i = ctypes.c_int
    lib.hp_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, i, i, i, i, i, ctypes.c_void_p]
    lib.hp_decode.restype = i
    return lib


def png_pixels(raw: bytes, h: int, w: int, depth: int, channels: int,
               interlace: bool) -> np.ndarray:
    """A PNG's inflated image data -> its samples (H, W, channels): the row
    filters undone, Adam7 passes put in place when `interlace`, 1-, 2- and
    4-bit samples unpacked (values 0 .. 2^depth - 1, not scaled); uint8,
    or uint16 at depth 16. Raises ValueError when raw is short or a row
    has an unknown filter type."""
    out = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    st = _png().hp_decode(raw, len(raw), w, h, depth, channels, int(bool(interlace)),
                          out.ctypes.data)
    if st == 1:
        raise ValueError("PNG image data is truncated")
    if st:
        raise ValueError(f"PNG row with unknown filter type {st - 2}")
    return out


@functools.cache
def _gif() -> ctypes.CDLL:
    lib = _build_host(GIF_SOURCE, [], "the GIF writer's LZW encoder", "")
    lib.hg_lzw.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
    lib.hg_lzw.restype = ctypes.c_long
    return lib


def gif_lzw(indices: np.ndarray) -> bytes:
    """GIF's LZW code stream (minimum code size 8, least significant bit
    first, not cut into sub-blocks) of uint8 palette indices."""
    idx = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    cap = 2 * idx.size + 64  # 12 bits a pixel, clear codes and the end code
    out = np.empty(cap, np.uint8)
    n = _gif().hg_lzw(idx.ctypes.data, idx.size, out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("gif_lzw: the output buffer is too short")
    return out[:n].tobytes()
