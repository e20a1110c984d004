"""K1 and K2: the tile rasterizer and its coverage backward on Hopper.

Replaces harp_tpu/render/pallas/raster_kernel.py:
  - raster_ids (K1) <- _kernel (:65-198), launched by pallas_raster_compact.
  - coverage_grad (K2) <- _coverage_grad_kernel (:364-458), launched by
    pallas_coverage_grad; coverage_grad_verts adds the face segment sum and
    the vertex scatter (:508-524).

What bounds them on this card: operations, not bytes. At the flagship
shapes a frame's camera pass reads ~0.4 MB of face rows and face lists and
writes ~3 MB of ids, but every (pixel, binned face) pair costs FP32 edge
functions (and in soft mode three clipped edge distances) on CUDA cores.
csrc/raster.cu cuts the pairs and their cost: one block per (tile, frame),
each warp an 8x4 pixel rectangle that skips the faces whose padded box
misses it (warp_cull_keep mirrors that test; kernel_cull_keep reads the
kernel's own ballots), a per-face setup in shared memory, coverage tests by
sign (quotient_nonneg mirrors them), soft ids in registers where K <= 8 (in
global memory for a larger K), and the next chunk's face rows prefetched
with cp.async. The
TPU's packed (B, A, cap, 16) pre-gather with the face id as a float lane is
not carried over: each block reads its list straight from the sorted pair
runs.

K2 keeps the per-(tile, slot) gradient buffer (B, A, cap, 9) of the TPU
design: a warp-shuffle then shared-memory sum over the tile's pixels in a
fixed order, so the result does not depend on scheduling. The face segment
sum and the vertex scatter are in a fixed order (a permutation scatter, a
sum over each face's pairs, and the segment sum of ops/segment.py over the
face table), not atomics: the gradient is the same from run to run.

On a CPU tensor each wrapper runs its plain PyTorch version, which repeats
the kernel's arithmetic in the same order (the CPU tests hold it against
harp_tpu); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from harp_tpu_torch.ops.segment import TableOrder, segment_sum
from harp_tpu_torch.csrc import build
from harp_tpu_torch.utils import debug_nans
from harp_tpu_torch.render.rasterizer import (
    RasterConfig, f32, face_pixel_geometry, softplus, tile_pixel_coords,
)

# Host launches of each kernel, counted by its wrapper: a replayed CUDA graph
# (the epoch scan's step, the eval program) launches its kernels without the
# wrapper, so replays are not in these counts.
LAUNCHES = {"raster_ids_soft": 0, "raster_ids_depth": 0, "coverage_grad": 0}

RECT_W, RECT_H = 8, 4  # the pixel rectangle of one warp

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib():
    lib = build.load("raster")
    if not getattr(lib, "_typed", False):
        lib.raster_ids.argtypes = ([_P] * 5 + [_I] * 7 + [_F] * 5 + [_I] + [_P] * 3
                                   + [_I] + [_P] * 2)
        lib.raster_ids.restype = _I
        lib.coverage_grad.argtypes = [_P] * 6 + [_I] * 7 + [_F] * 5 + [_P] * 3
        lib.coverage_grad.restype = _I
        lib.raster_blocks_per_sm.argtypes = [_I, _P]
        lib.raster_blocks_per_sm.restype = _I
        lib._typed = True
    return lib


def _consts(cfg: RasterConfig):
    return (f32(cfg.blur_px2), f32(cfg.znear), f32(cfg.ndc_scale**2),
            f32(1.0 / cfg.sigma))


def cull_pad(cfg: RasterConfig) -> float:
    """The kernels' face-box pad: the binning's pad sqrt(blur_px2) + 1e-3
    (rasterizer.bin_pairs) plus a 1 px margin over float rounding."""
    return f32(math.sqrt(max(cfg.blur_px2, 0.0)) + 1e-3 + 1.0)


def blocks_per_sm(tile: int) -> dict:
    """Resident blocks per SM of each kernel at tile * tile threads, as the
    CUDA occupancy calculator gives them (needs the card)."""
    out = (ctypes.c_int * 3)()
    build.check(_lib().raster_blocks_per_sm(tile, ctypes.addressof(out)),
                "raster_blocks_per_sm")
    return {"raster_ids_soft": out[0], "raster_ids_depth": out[1], "coverage_grad": out[2]}


def _check_inputs(fv9, s_face, start_a, count_a, act_idx, cfg: RasterConfig):
    dev = fv9.device
    if fv9.dtype != torch.float32 or fv9.dim() != 3 or fv9.shape[2] != 9:
        raise ValueError(f"fv9 must be (B, F, 9) float32, got {tuple(fv9.shape)} {fv9.dtype}")
    B = fv9.shape[0]
    A = act_idx.shape[1] if act_idx.dim() == 2 else -1
    for name, t, shape in (("s_face", s_face, (B, s_face.shape[-1])),
                           ("start_a", start_a, (B, A)),
                           ("count_a", count_a, (B, A)),
                           ("act_idx", act_idx, (B, A))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, fv9 on {dev}")
    if dev.type == "cuda":
        P = cfg.tile * cfg.tile
        if P % 32 or P > 256:
            raise ValueError(f"the CUDA raster kernels take tile * tile a multiple "
                             f"of 32 and at most 256, got tile={cfg.tile}")
        for name, t in (("fv9", fv9), ("s_face", s_face), ("start_a", start_a),
                        ("count_a", count_a), ("act_idx", act_idx)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return B, A


def _slot_faces(s_face, start_a, count_a, r):
    """Face ids of list slots r (a 1-D range) of every active tile:
    (B, A, len(r)) int64, -1 beyond the tile's count."""
    B, n = s_face.shape
    pos = start_a.long()[..., None] + r
    ok = r < count_a.long()[..., None]
    ids = torch.gather(s_face.long(), 1, pos.clamp(max=n - 1).reshape(B, -1))
    return torch.where(ok, ids.reshape(pos.shape), -1)


def _tile_geometry(fv9, ids, px, py, cfg: RasterConfig, need_dist: bool):
    """face_pixel_geometry of (B, A, fc) face slots against (B, A, P)
    pixels, laid out (B, A, fc, P); empty slots are not valid."""
    B = fv9.shape[0]
    safe = ids.clamp(min=0).reshape(B, -1, 1).expand(-1, -1, 9)
    fv = torch.gather(fv9, 1, safe).reshape(ids.shape + (1, 3, 3))
    g = face_pixel_geometry(fv, px[:, :, None, :], py[:, :, None, :], cfg, need_dist)
    live = (ids >= 0)[..., None]
    g["valid"] = g["valid"] & live
    g["inside"] = g["inside"] & live
    g["v"] = tuple(fv[..., i, c] for i in range(3) for c in range(2))
    g["px"], g["py"] = px[:, :, None, :], py[:, :, None, :]
    return g


# ---------------------------------------------------------------------------
# K1: raster_ids
# ---------------------------------------------------------------------------


def _ballot_words(keep, B, A, cfg: RasterConfig, dev):
    """keep's data pointer (None for None): the (B, A, ceil(cap / 32),
    warps) int32 words into which the CUDA kernel writes its cull ballots."""
    if keep is None:
        return None
    shape = (B, A, -(-cfg.cap // 32), cfg.tile * cfg.tile // 32)
    if (dev.type != "cuda" or keep.dtype != torch.int32 or tuple(keep.shape) != shape
            or keep.device != dev or not keep.is_contiguous()):
        raise ValueError(f"keep must be a contiguous int32 {shape} tensor on the CUDA "
                         f"device of fv9: the ballots are the CUDA kernel's own")
    return keep.data_ptr()


def raster_ids(fv9, s_face, start_a, count_a, act_idx, cfg: RasterConfig,
               need_soft: bool = True, keep=None):
    """Per active tile and pixel: (hard (B, A, P) int32, soft (B, A, P, K)
    int32 or None, soft_sum (B, A, P) f32 or None).

    fv9 (B, F, 9) screen-space face vertices; s_face (B, n) the sorted pair
    runs; start_a / count_a (B, A) each active tile's run start and length
    (count already capped); act_idx (B, A) the active tiles. keep (checks
    only, see kernel_cull_keep): zeroed words for the warps' cull ballots."""
    B, A = _check_inputs(fv9, s_face, start_a, count_a, act_idx, cfg)
    words = _ballot_words(keep, B, A, cfg, fv9.device)
    if fv9.device.type == "cpu":
        return raster_ids_plain(fv9, s_face, start_a, count_a, act_idx, cfg, need_soft)
    P, K = cfg.tile * cfg.tile, cfg.faces_per_pixel
    dev = fv9.device
    hard = torch.empty(B, A, P, dtype=torch.int32, device=dev)
    soft = torch.empty(B, A, P, K if need_soft else 0, dtype=torch.int32, device=dev)
    ssum = torch.empty(B, A, P if need_soft else 0, dtype=torch.float32, device=dev)
    rc = _lib().raster_ids(
        fv9.data_ptr(), s_face.data_ptr(), start_a.data_ptr(), count_a.data_ptr(),
        act_idx.data_ptr(), B, fv9.shape[1], s_face.shape[1], A,
        cfg.image_size // cfg.tile, cfg.tile, K, *_consts(cfg), cull_pad(cfg), int(need_soft),
        hard.data_ptr(), soft.data_ptr(), ssum.data_ptr(), -(-cfg.cap // 32), words,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "raster_ids")
    LAUNCHES["raster_ids_soft" if need_soft else "raster_ids_depth"] += 1
    debug_nans.check_kernel(ssum, "raster_ids")
    return hard, (soft if need_soft else None), (ssum if need_soft else None)


def raster_ids_plain(fv9, s_face, start_a, count_a, act_idx, cfg: RasterConfig,
                     need_soft: bool = True):
    """K1's plain PyTorch version: the XLA tile pass's arithmetic
    (harp_tpu rasterizer._rasterize_ids(compact=True)), walking the face
    slots cfg.face_chunk at a time (the last step is ragged, never
    clamped: no slot is visited twice)."""
    B, A = act_idx.shape
    P, K = cfg.tile * cfg.tile, cfg.faces_per_pixel
    dev = fv9.device
    px, py = tile_pixel_coords(act_idx, cfg)
    blur_px2, _, ndc2, inv_sigma = _consts(cfg)
    hard_z = torch.full((B, A, P), float("inf"), device=dev)
    hard = torch.full((B, A, P), -1, dtype=torch.int64, device=dev)
    soft = torch.full((B, A, P, K + 1), -1, dtype=torch.int64, device=dev)
    base = torch.zeros(B, A, P, dtype=torch.int64, device=dev)
    ssum = torch.zeros(B, A, P, device=dev)
    fc = min(cfg.face_chunk, cfg.cap)
    for c0 in range(0, cfg.cap, fc):
        r = torch.arange(c0, min(c0 + fc, cfg.cap), device=dev)
        ids = _slot_faces(s_face, start_a, count_a, r)  # (B, A, fc)
        g = _tile_geometry(fv9, ids, px, py, cfg, need_soft)
        cand = torch.where(g["inside"], g["z"], float("inf"))
        zmin, amin = cand.min(dim=2)
        zid = torch.gather(ids, 2, amin)
        better = zmin < hard_z
        hard_z = torch.where(better, zmin, hard_z)
        hard = torch.where(better, zid, hard)
        if need_soft:
            e01, e12, e20 = g["edges"]
            d2 = torch.minimum(torch.minimum(e01, e12), e20)
            s = torch.where(g["inside"], -d2, d2)
            hit = g["valid"] & (s <= blur_px2)  # (B, A, fc, P)
            pos = base[:, :, None, :] + torch.cumsum(hit.long(), dim=2) - 1
            slot = torch.where(hit & (pos < K), pos, K)
            idx = ids[..., None].expand_as(slot)
            # First K hits in slot order; slot K collects the rest and is dropped.
            soft.scatter_(3, slot.permute(0, 1, 3, 2), idx.permute(0, 1, 3, 2))
            base = base + hit.sum(2)
            contrib = -softplus(-(s * ndc2) * inv_sigma)
            ssum = ssum + torch.where(hit, contrib, 0.0).sum(2)
    hard = hard.to(torch.int32)
    if not need_soft:
        return hard, None, None
    return hard, soft[..., :K].to(torch.int32), ssum


# ---------------------------------------------------------------------------
# Plain mirrors of what the kernels decide (tests only; off the main path)
# ---------------------------------------------------------------------------


def warp_of_pixel(cfg: RasterConfig) -> torch.Tensor:
    """(P,) the warp that owns tile pixel p = row * tile + col: warp w
    covers the RECT_W x RECT_H rectangle at (w % (tile / RECT_W),
    w // (tile / RECT_W)) of the tile."""
    ts = cfg.tile
    p = torch.arange(ts * ts)
    return (p // ts // RECT_H) * (ts // RECT_W) + (p % ts) // RECT_W


def warp_cull_keep(fv9, s_face, start_a, count_a, act_idx, cfg: RasterConfig):
    """(B, A, cap, W) bool: list slot s of active tile a is evaluated by
    warp w. The kernels' test in their float32 expressions: the face is
    valid and its box, padded by cull_pad, touches the warp's rectangle of
    pixel centres (ends included). Empty slots are False."""
    B, A = act_idx.shape
    ts, nt = cfg.tile, cfg.image_size // cfg.tile
    ids = _slot_faces(s_face, start_a, count_a, torch.arange(cfg.cap, device=fv9.device))
    v = torch.gather(fv9, 1, ids.clamp(min=0).reshape(B, -1, 1).expand(-1, -1, 9))
    v = v.reshape(B, A, cfg.cap, 1, 9)
    x0, y0, z0, x1, y1, z1, x2, y2, z2 = v.unbind(-1)
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    znear = f32(cfg.znear)
    valid = ((torch.abs(area2) > f32(1e-10)) & (z0 > znear) & (z1 > znear)
             & (z2 > znear) & (ids >= 0)[..., None])
    pad = cull_pad(cfg)
    bx0 = torch.minimum(torch.minimum(x0, x1), x2) - pad
    bx1 = torch.maximum(torch.maximum(x0, x1), x2) + pad
    by0 = torch.minimum(torch.minimum(y0, y1), y2) - pad
    by1 = torch.maximum(torch.maximum(y0, y1), y2) + pad
    rpr = ts // RECT_W
    w = torch.arange(ts * ts // 32, device=fv9.device)
    t = act_idx.long()[..., None]  # (B, A, 1)
    cx = (t % nt) * ts + (w % rpr) * RECT_W  # (B, A, W) first column
    cy = (t // nt) * ts + (w // rpr) * RECT_H
    rx0, rx1 = (cx.float() + 0.5)[:, :, None], ((cx + RECT_W - 1).float() + 0.5)[:, :, None]
    ry0, ry1 = (cy.float() + 0.5)[:, :, None], ((cy + RECT_H - 1).float() + 0.5)[:, :, None]
    return valid & (bx0 <= rx1) & (bx1 >= rx0) & (by0 <= ry1) & (by1 >= ry0)


def kernel_cull_keep(fv9, s_face, start_a, count_a, act_idx, cfg: RasterConfig,
                     kernel: str):
    """What the CUDA kernel `kernel` ("raster_ids_soft", "raster_ids_depth"
    or "coverage_grad") kept, from the ballots it writes when asked: (B, A,
    cap, W) bool in warp_cull_keep's layout. One launch of that kernel
    (counted); CUDA tensors only."""
    B, A = act_idx.shape
    W = cfg.tile * cfg.tile // 32
    words = torch.zeros(B, A, -(-cfg.cap // 32), W, dtype=torch.int32, device=fv9.device)
    args = (fv9, s_face, start_a, count_a, act_idx)
    if kernel == "coverage_grad":
        g = torch.zeros(B, A, cfg.tile * cfg.tile, device=fv9.device)
        coverage_grad(*args, g, cfg, keep=words)
    elif kernel in ("raster_ids_soft", "raster_ids_depth"):
        raster_ids(*args, cfg, kernel == "raster_ids_soft", keep=words)
    else:
        raise ValueError(f"unknown kernel {kernel!r}")
    bits = (words[..., None] >> torch.arange(32, device=fv9.device, dtype=torch.int32)) & 1
    return bits.transpose(3, 4).reshape(B, A, -1, W)[:, :, :cfg.cap].bool()


def quotient_nonneg(w: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """w / denom >= 0 decided as the kernels decide it, without dividing
    (raster.cu quot_nonneg): w * sign(denom) >= -RD(|denom| * 2^-150).
    Float32 w and finite nonzero float32 denom."""
    x = denom.double().abs() * 2.0**-150  # exact
    t = x.float()
    t = torch.where(t.double() > x, torch.nextafter(t, torch.zeros_like(t)), t)
    sgn = torch.where(denom > 0, 1.0, -1.0)
    return w * sgn >= -t


# ---------------------------------------------------------------------------
# K2: coverage_grad
# ---------------------------------------------------------------------------


def coverage_grad(fv9, s_face, start_a, count_a, act_idx, g, cfg: RasterConfig,
                  keep=None):
    """Per (frame, active tile, slot) the 9 screen-coordinate gradients of
    sum over the tile's pixels of g * coverage log-sum: (B, A, cap, 9) f32.
    Slots at or beyond a tile's count are left unwritten (zeros under
    --debug-nans). keep: as in raster_ids."""
    B, A = _check_inputs(fv9, s_face, start_a, count_a, act_idx, cfg)
    words = _ballot_words(keep, B, A, cfg, fv9.device)
    P = cfg.tile * cfg.tile
    if g.dtype != torch.float32 or tuple(g.shape) != (B, A, P) or g.device != fv9.device:
        raise ValueError(f"g must be float32 {(B, A, P)} on {fv9.device}")
    if fv9.device.type == "cpu":
        return coverage_grad_plain(fv9, s_face, start_a, count_a, act_idx, g, cfg)
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    dev = fv9.device
    # Under --debug-nans the slots the kernel leaves unwritten are zeros, so
    # that no stale memory meets the NaN checks (this one, and the gathers
    # of slot_grads_to_verts, which read such slots before masking them).
    alloc = torch.zeros if debug_nans.active() else torch.empty
    out = alloc(B, A, cfg.cap, 9, dtype=torch.float32, device=dev)
    rc = _lib().coverage_grad(
        fv9.data_ptr(), s_face.data_ptr(), start_a.data_ptr(), count_a.data_ptr(),
        act_idx.data_ptr(), g.data_ptr(), B, fv9.shape[1], s_face.shape[1], A,
        cfg.image_size // cfg.tile, cfg.tile, cfg.cap, *_consts(cfg), cull_pad(cfg),
        out.data_ptr(), words, torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "coverage_grad")
    LAUNCHES["coverage_grad"] += 1
    debug_nans.check_kernel(out, "coverage_grad")
    return out


def _min_w(a, b):
    """jnp.minimum's gradient share of `a` in min(a, b)."""
    return torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0))


def _seg_grad(px, py, ax, ay, bx, by, gD):
    """d(gD * squared point-segment distance) / d(ax, ay, bx, by), with
    jnp.clip's half-gradient ties at the segment ends."""
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    dn = abx * abx + aby * aby + 1e-12
    v = (apx * abx + apy * aby) / dn
    m = torch.clamp(v, min=0.0)
    dm = torch.where(v > 0, 1.0, torch.where(v == 0, 0.5, 0.0))
    t = torch.clamp(m, max=1.0)
    dt = torch.where(m < 1, 1.0, torch.where(m == 1, 0.5, 0.0))
    dx = apx - t * abx
    dy = apy - t * aby
    gdx = 2.0 * dx * gD
    gdy = 2.0 * dy * gD
    gv = -(gdx * abx + gdy * aby) * dt * dm
    gnum = gv / dn
    gdn = -gv * v / dn
    g_apx = gdx + gnum * abx
    g_apy = gdy + gnum * aby
    g_abx = -gdx * t + gnum * apx + 2.0 * abx * gdn
    g_aby = -gdy * t + gnum * apy + 2.0 * aby * gdn
    return -g_apx - g_abx, -g_apy - g_aby, g_abx, g_aby


def coverage_grad_plain(fv9, s_face, start_a, count_a, act_idx, g, cfg: RasterConfig):
    """K2's plain PyTorch version: the same hand-derived gradient, per
    chunk of face slots, summed over the tile's pixels."""
    B, A = act_idx.shape
    dev = fv9.device
    px, py = tile_pixel_coords(act_idx, cfg)
    blur_px2, _, ndc2, inv_sigma = _consts(cfg)
    out = torch.zeros(B, A, cfg.cap, 9, device=dev)
    gp = g[:, :, None, :]
    fc = min(cfg.face_chunk, cfg.cap)
    for c0 in range(0, cfg.cap, fc):
        r = torch.arange(c0, min(c0 + fc, cfg.cap), device=dev)
        ids = _slot_faces(s_face, start_a, count_a, r)
        geo = _tile_geometry(fv9, ids, px, py, cfg, True)
        e01, e12, e20 = geo["edges"]
        m1 = torch.minimum(e01, e12)
        d2 = torch.minimum(m1, e20)
        inside = geo["inside"]
        s = torch.where(inside, -d2, d2)
        hit = geo["valid"] & (s <= blur_px2)
        x = -(s * ndc2) * inv_sigma
        sig = torch.sigmoid(x)
        sign = torch.where(inside, -1.0, 1.0)
        gd2 = torch.where(hit, gp * sig * ndc2 * inv_sigma * sign, 0.0)
        wm = _min_w(m1, e20)
        w = (_min_w(e01, e12) * wm, _min_w(e12, e01) * wm, _min_w(e20, m1))
        x0, y0, x1, y1, x2, y2 = geo["v"]
        qx, qy = geo["px"], geo["py"]
        verts = ((x0, y0), (x1, y1), (x2, y2))
        grads = [[0.0, 0.0] for _ in range(3)]
        for e, (i, j) in enumerate(((0, 1), (1, 2), (2, 0))):
            gax, gay, gbx, gby = _seg_grad(qx, qy, *verts[i], *verts[j], gd2 * w[e])
            grads[i][0] = grads[i][0] + gax
            grads[i][1] = grads[i][1] + gay
            grads[j][0] = grads[j][0] + gbx
            grads[j][1] = grads[j][1] + gby
        zero = torch.zeros_like(gd2)
        lanes = [grads[k][c] if c < 2 else zero for k in range(3) for c in range(3)]
        out[:, :, c0:c0 + r.numel()] = torch.stack(lanes, -1).sum(3)
    return out


def coverage_grad_verts(bins: dict, g_ssum, corners: TableOrder, cfg: RasterConfig):
    """d(sum over pixels of g_ssum * coverage log-sum) / d verts_px:
    (B, V, 3): K2 per (tile, slot), then slot_grads_to_verts. corners: the
    face table's corner order (MeshTopology.corners), V its rows."""
    slot_g = coverage_grad(bins["fv9"], bins["s_face"], bins["start_a"],
                           bins["count_a"], bins["act_idx"], g_ssum, cfg)
    return slot_grads_to_verts(bins, slot_g, corners)


def slot_grads_to_verts(bins: dict, slot_g, corners: TableOrder):
    """Per-(tile, slot) gradients (B, A, cap, 9) -> (B, V, 3): the face
    segment sum and the vertex scatter over the corner order, in a fixed
    order."""
    fv9 = bins["fv9"]
    B, F = fv9.shape[0], fv9.shape[1]
    A, cap = slot_g.shape[1], slot_g.shape[2]
    dev = fv9.device
    T = bins["start"].shape[1]
    n = bins["s_face"].shape[1]
    # Sorted pair j -> (active slot a, list slot) of its tile.
    tile2act = torch.full((B, T + 1), -1, dtype=torch.int64, device=dev)
    tile2act.scatter_(1, bins["act_idx"].long(),
                      torch.arange(A, device=dev).expand(B, A).contiguous())
    s_tile = bins["s_tile"]
    a_j = torch.gather(tile2act, 1, s_tile)
    start_ext = torch.cat([bins["start"], torch.zeros(B, 1, dtype=torch.int64, device=dev)], 1)
    slot_j = torch.arange(n, device=dev) - torch.gather(start_ext, 1, s_tile)
    ok = (a_j >= 0) & (slot_j < cap)
    flat = a_j.clamp(min=0) * cap + slot_j.clamp(0, cap - 1)
    g_j = torch.gather(slot_g.reshape(B, A * cap, 9), 1, flat[..., None].expand(-1, -1, 9))
    g_j = torch.where(ok[..., None], g_j, 0.0)
    # Back to pair order (a permutation: every target written once), then
    # each face's S^2 pairs summed in a fixed order.
    per_pair = torch.zeros_like(g_j).scatter_(1, bins["order"][..., None].expand(-1, -1, 9), g_j)
    per_face = per_pair.reshape(B, F, n // F, 9).sum(2)
    # Face corners -> vertices: the fixed-order segment sum over the face table.
    dv = segment_sum(per_face.reshape(B * F * 3, 3), corners.batched(B, dev))
    return dv.reshape(B, corners.num_rows, 3)
