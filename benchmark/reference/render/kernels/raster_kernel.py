"""Frozen plain copy of harp_tpu_torch/render/kernels/raster_kernel.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

K1 and K2: the tile rasterizer and its coverage backward on Hopper.

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


import torch

from benchmark.reference.ops.segment import TableOrder, segment_sum
from benchmark.reference.render.rasterizer import (
    RasterConfig, f32, face_pixel_geometry, softplus, tile_pixel_coords,
)

RECT_W, RECT_H = 8, 4  # the pixel rectangle of one warp

def _consts(cfg: RasterConfig):
    return (f32(cfg.blur_px2), f32(cfg.znear), f32(cfg.ndc_scale**2),
            f32(1.0 / cfg.sigma))


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


def raster_ids(fv9, s_face, start_a, count_a, act_idx, cfg: RasterConfig,
               need_soft: bool = True):
    """K1's plain version on every device."""
    _check_inputs(fv9, s_face, start_a, count_a, act_idx, cfg)
    return raster_ids_plain(fv9, s_face, start_a, count_a, act_idx, cfg, need_soft)


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
# K2: coverage_grad
# ---------------------------------------------------------------------------


def coverage_grad(fv9, s_face, start_a, count_a, act_idx, g, cfg: RasterConfig):
    """K2's plain version on every device: (B, A, cap, 9) f32."""
    _check_inputs(fv9, s_face, start_a, count_a, act_idx, cfg)
    return coverage_grad_plain(fv9, s_face, start_a, count_a, act_idx, g, cfg)


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
