"""Frozen plain copy of harp_tpu_torch/render/rasterizer.py: the benchmark's reference,
independent of later changes to the program. No CUDA kernel: every
kernel wrapper runs its plain PyTorch version on any device.

Tile-binned differentiable rasterizer (harp_tpu/render/rasterizer.py).

1. Binning (integer): every face emits one (tile, face) pair per tile of
   its blur-padded bbox (at most span_tiles^2); one sort per frame gives each
   tile's face list as a contiguous ascending run.
2. Active tiles: the A most-loaded tiles per frame (stable descending sort
   of the counts, lower tile index first on ties, as jax.lax.top_k).
3. Tile pass (K1, render/kernels/raster_kernel.py): per active tile and
   pixel, the hard id, the first K soft ids and the coverage log-sum.
4. Differentiable recompute from the ids: barycentrics and depths in plain
   PyTorch; the silhouette alpha's backward is K2.

Signed squared distances are in pixels^2 (negative inside); the blur test
uses them directly, and coverage converts to NDC^2 by ndc_scale^2.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference.device import constant
from benchmark.reference.ops.segment import SegmentOrder, gather_rows

TC = 8  # active-tile budget granularity (harp_tpu's Pallas TC)


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    image_size: int = 448
    # Soft-rasterizer constants in NDC units (reference renderer_helper.py:37-48).
    sigma: float = 1e-7
    gamma: float = 1e-1
    blur_radius: float = float(np.log(1.0 / 1e-4 - 1.0) * 1e-7)  # NDC^2
    faces_per_pixel: int = 8  # K for the soft id list
    tile: int = 16
    cap: int = 256  # max faces rasterized per tile
    bin_chunk: int = 128  # harp_tpu's dense-binning chunk (unused here)
    span_tiles: int = 4
    tile_chunk: int = 8  # harp_tpu's XLA tile-pass chunk (unused here)
    face_chunk: int = 256  # faces per step of the plain tile pass
    znear: float = 1e-6
    active_fraction: float = 1.0
    # harp_tpu's backend switch; the port dispatches by tensor device.
    backend: str = "auto"

    @property
    def ndc_scale(self) -> float:
        """Pixel -> NDC length factor (square images)."""
        return 2.0 / self.image_size

    @property
    def blur_px2(self) -> float:
        """Blur radius in squared pixel units."""
        return self.blur_radius / (self.ndc_scale**2)


def f32(x: float) -> float:
    """x rounded to float32: the constants the kernels and the plain
    versions compare against must be the same float32 number."""
    return float(np.float32(x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as jnp.logaddexp(x, 0) computes it (no threshold)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def as_faces(faces, device) -> torch.Tensor:
    """Face table as an int64 index tensor on `device`."""
    if isinstance(faces, torch.Tensor):
        return faces.to(device=device, dtype=torch.int64)
    return constant(faces, device, np.int64)


def num_tiles(cfg: RasterConfig) -> int:
    return (cfg.image_size // cfg.tile) ** 2


def active_budget(cfg: RasterConfig) -> int:
    """Active tiles per frame: the fraction of all tiles rounded up to a
    multiple of TC (harp_tpu's Pallas rounding), at most all tiles."""
    T = num_tiles(cfg)
    if cfg.active_fraction >= 1.0:
        return T
    return min(max(-(-int(T * cfg.active_fraction) // TC), 1) * TC, T)


# ---------------------------------------------------------------------------
# Shared geometry (differentiable)
# ---------------------------------------------------------------------------


def _seg_dist2(px, py, ax, ay, bx, by):
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = abx * abx + aby * aby + 1e-12
    t = torch.minimum(torch.maximum((apx * abx + apy * aby) / denom,
                                    torch.zeros_like(denom)),
                      torch.ones_like(denom))
    dx = apx - t * abx
    dy = apy - t * aby
    return dx * dx + dy * dy


def face_pixel_geometry(fv: torch.Tensor, px, py, cfg: RasterConfig,
                        need_dist: bool = True):
    """Per (face, pixel) quantities, in the CUDA kernels' operation order;
    fv (..., 3, 3) screen-space face vertices (u, v, z), px / py pixel
    centres broadcastable against (...).

    Returns valid (face neither degenerate nor behind znear), inside, z
    (interpolated depth), bary (b0, b1, b2) and, with need_dist, edges: the
    squared pixel distances to the segments (v0 v1, v1 v2, v2 v0)."""
    x0, y0, z0 = fv[..., 0, 0], fv[..., 0, 1], fv[..., 0, 2]
    x1, y1, z1 = fv[..., 1, 0], fv[..., 1, 1], fv[..., 1, 2]
    x2, y2, z2 = fv[..., 2, 0], fv[..., 2, 1], fv[..., 2, 2]

    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    w0 = (x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)
    w1 = (x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)
    w2 = (x0 - px) * (y1 - py) - (x1 - px) * (y0 - py)
    eps = f32(1e-10)
    big = torch.abs(area2) > eps
    denom = torch.where(big, area2, torch.where(area2 >= 0, eps, -eps))
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom

    znear = f32(cfg.znear)
    valid = big & (z0 > znear) & (z1 > znear) & (z2 > znear)
    out = {
        "valid": valid,
        "inside": (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & valid,
        "z": b0 * z0 + b1 * z1 + b2 * z2,
        "bary": (b0, b1, b2),
    }
    if need_dist:
        out["edges"] = (_seg_dist2(px, py, x0, y0, x1, y1),
                        _seg_dist2(px, py, x1, y1, x2, y2),
                        _seg_dist2(px, py, x2, y2, x0, y0))
    return out


# ---------------------------------------------------------------------------
# Binning (non-differentiable, id-producing)
# ---------------------------------------------------------------------------


def bin_pairs(fv: torch.Tensor, cfg: RasterConfig) -> dict:
    """Sorted (tile, face) pair runs (harp_tpu rasterizer._bin_pairs).

    fv (B, F, 3, 3). Returns s_face (B, n) face ids sorted by (tile, face)
    with invalid pairs last, s_tile (B, n) their tiles (T = invalid), order
    (B, n) the pair index f * S^2 + k each sorted entry came from, start
    (B, T) exclusive per-tile prefix, counts (B, T) per-tile run lengths,
    counts_rep (B, T) reporting counts with the span-truncation bump, and
    span_cnt (B,) the number of span-truncated faces."""
    B, F = fv.shape[0], fv.shape[1]
    dev = fv.device
    ts = cfg.tile
    nt = cfg.image_size // ts
    T = nt * nt
    S = cfg.span_tiles
    if T * F >= 2**30:
        raise ValueError(f"binning key overflow: tiles ({T}) * faces ({F}) >= 2^30")
    pad = math.sqrt(max(cfg.blur_px2, 0.0)) + 1e-3

    umin = fv[..., 0].amin(-1) - pad
    umax = fv[..., 0].amax(-1) + pad
    vmin = fv[..., 1].amin(-1) - pad
    vmax = fv[..., 1].amax(-1) + pad
    live = ~((fv[..., 2] <= f32(cfg.znear)).any(-1))

    i32 = torch.int32
    tx0 = torch.ceil((umin + 0.5 - ts) / ts).to(i32)
    ty0 = torch.ceil((vmin + 0.5 - ts) / ts).to(i32)
    tx1 = torch.floor((umax - 0.5) / ts).to(i32)
    ty1 = torch.floor((vmax - 0.5) / ts).to(i32)
    tx0c = tx0.clamp(0, nt - 1)
    ty0c = ty0.clamp(0, nt - 1)
    tx1c = tx1.clamp(max=nt - 1)
    ty1c = ty1.clamp(max=nt - 1)
    span_trunc = live & ((tx1c - tx0c >= S) | (ty1c - ty0c >= S))

    di = torch.arange(S, dtype=i32, device=dev)
    cx = tx0c[..., None] + di
    cy = ty0c[..., None] + di
    vx = (cx <= tx1c[..., None]) & (cx >= tx0[..., None])
    vy = (cy <= ty1c[..., None]) & (cy >= ty0[..., None])
    tile_of = (cy[:, :, :, None] * nt + cx[:, :, None, :]).reshape(B, F, S * S)
    pair_ok = (vy[:, :, :, None] & vx[:, :, None, :]).reshape(B, F, S * S)
    pair_ok = pair_ok & live[..., None]

    fid = torch.arange(F, dtype=torch.int64, device=dev)
    key = torch.where(pair_ok, tile_of.long() * F + fid[None, :, None],
                      torch.full_like(tile_of, 2**30, dtype=torch.int64))
    skey, order = torch.sort(key.reshape(B, F * S * S), dim=-1, stable=True)
    s_tile = torch.where(skey < 2**30, skey // F, torch.full_like(skey, T))
    s_face = skey - s_tile * F

    counts = torch.zeros(B, T + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, s_tile, torch.ones_like(s_tile))
    counts = counts[:, :T]
    start = torch.cumsum(counts, dim=-1) - counts
    first_tile = (ty0c * nt + tx0c).long()
    bump = torch.where(span_trunc, cfg.cap + 1, 0).long()
    counts_rep = counts.scatter_add(1, first_tile, bump)
    return {
        "s_face": s_face.to(i32).contiguous(),
        "s_tile": s_tile,
        "order": order,
        "start": start,
        "counts": counts,
        "counts_rep": counts_rep,
        "span_cnt": span_trunc.sum(-1).to(i32),
    }


def active_tiles(counts_rep: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(B, A) int32 tile indices, most loaded first, lower index on ties."""
    A = active_budget(cfg)
    idx = torch.sort(counts_rep, dim=1, descending=True, stable=True).indices
    return idx[:, :A].to(torch.int32).contiguous()


def raster_compact(verts_px: torch.Tensor, faces, cfg: RasterConfig,
                   need_soft: bool = True, need_hard: bool = True) -> dict:
    """Compact active-tile rasterization (harp_tpu raster_compact): dict
    with act_idx (B, A), soft_ids (B, A, P, K), soft_sum (B, A, P),
    hard_ids (B, A, P), bin_overflow / active_overflow / span_overflow
    (B,), and "bins": the binning and K1's inputs, which K2 reads in the
    silhouette backward.

    need_soft=False runs K1's depth-only mode (hard ids only). A CUDA
    tensor goes to the kernel, a CPU tensor to its plain version."""
    from benchmark.reference.render.kernels import raster_kernel

    verts_px = verts_px.detach().float()
    B = verts_px.shape[0]
    f = as_faces(faces, verts_px.device)
    F = f.shape[0]
    fv = verts_px[:, f]  # (B, F, 3, 3)
    bins = bin_pairs(fv, cfg)
    act_idx = active_tiles(bins["counts_rep"], cfg)
    A = act_idx.shape[1]
    a64 = act_idx.long()
    start_a = torch.gather(bins["start"], 1, a64).to(torch.int32).contiguous()
    count_a = torch.gather(bins["counts"], 1, a64).clamp(max=cfg.cap).to(torch.int32).contiguous()
    fv9 = fv.reshape(B, F, 9).contiguous()

    hard, soft, ssum = raster_kernel.raster_ids(
        fv9, bins["s_face"], start_a, count_a, act_idx, cfg, need_soft)
    counts_rep = bins["counts_rep"]
    out = {
        "act_idx": act_idx,
        "bin_overflow": (counts_rep > cfg.cap).sum(-1),
        "active_overflow": torch.clamp((counts_rep > 0).sum(-1) - A, min=0),
        "span_overflow": bins["span_cnt"],
    }
    if need_hard:
        out["hard_ids"] = hard
    if need_soft:
        out["soft_ids"] = soft
        out["soft_sum"] = ssum
    out["bins"] = dict(bins, fv9=fv9, start_a=start_a, count_a=count_a,
                       act_idx=act_idx)
    return out


# ---------------------------------------------------------------------------
# Compact tile layout helpers
# ---------------------------------------------------------------------------


def _untile(x: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(B, T, P, ...) -> (B, H, W, ...)."""
    ts = cfg.tile
    nt = cfg.image_size // ts
    trailing = x.shape[3:]
    x = x.reshape((x.shape[0], nt, nt, ts, ts) + trailing)
    x = x.movedim(3, 2)
    return x.reshape((x.shape[0], cfg.image_size, cfg.image_size) + trailing)


def _retile(x: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """(B, H, W, ...) -> (B, T, P, ...)."""
    ts = cfg.tile
    nt = cfg.image_size // ts
    trailing = x.shape[3:]
    x = x.reshape((x.shape[0], nt, ts, nt, ts) + trailing)
    x = x.movedim(2, 3)
    return x.reshape((x.shape[0], nt * nt, ts * ts) + trailing)


def tile_pixel_coords(act_idx: torch.Tensor, cfg: RasterConfig):
    """Pixel-centre coordinates of compact tiles: (B, A, P) px / py."""
    ts = cfg.tile
    nt = cfg.image_size // ts
    j = torch.arange(ts * ts, dtype=torch.float32, device=act_idx.device)
    pu = (j % ts) + 0.5
    pv = torch.div(j, ts, rounding_mode="floor") + 0.5
    a = act_idx.long()
    ou = ((a % nt) * ts).float()
    ov = (torch.div(a, nt, rounding_mode="floor") * ts).float()
    return ou[..., None] + pu, ov[..., None] + pv


def gather_tiles(img: torch.Tensor, act_idx: torch.Tensor, cfg: RasterConfig):
    """Full image (B, H, W, ...) -> compact (B, A, P, ...)."""
    x = _retile(img, cfg)
    b = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[b, act_idx.long()]


def scatter_tiles(x: torch.Tensor, act_idx: torch.Tensor, cfg: RasterConfig, fill):
    """Compact (B, A, P, ...) -> full image (B, H, W, ...), `fill` elsewhere
    (a scalar or a tensor broadcastable to the trailing dims)."""
    B, A, P = x.shape[:3]
    T = num_tiles(cfg)
    fill = (fill.to(device=x.device, dtype=x.dtype) if isinstance(fill, torch.Tensor)
            else constant(fill, x.device, x.dtype))
    full = fill.expand((B, T, P) + x.shape[3:])
    b = torch.arange(B, device=x.device)[:, None]
    full = full.index_put((b, act_idx.long()), x)
    return _untile(full, cfg)


def face_row_order(ids: torch.Tensor, num_faces: int) -> SegmentOrder:
    """SegmentOrder of the per-pixel face rows b * F + max(id, 0) of (B, ...)
    ids: the face-row and packed-attribute gathers by one set of ids share
    it, and so one sort."""
    B = ids.shape[0]
    b = torch.arange(B, device=ids.device).reshape((B,) + (1,) * (ids.dim() - 1))
    return SegmentOrder(b * num_faces + ids.long().clamp(min=0), B * num_faces)


def _face_rows(verts_px: torch.Tensor, faces, ids: torch.Tensor,
               order: SegmentOrder | None = None) -> torch.Tensor:
    """(..., 3, 3) vertices of face `ids` (clamped at 0) per pixel; the
    gather's backward is the fixed-order segment sum."""
    B = verts_px.shape[0]
    f = as_faces(faces, verts_px.device)
    fv9 = verts_px[:, f].reshape(B * f.shape[0], 9)
    if order is None:
        order = face_row_order(ids, f.shape[0])
    return gather_rows(fv9, order).reshape(ids.shape + (3, 3))


def barycentrics_of_at(ids, verts_px, faces, cfg: RasterConfig, px, py,
                       order: SegmentOrder | None = None):
    """Differentiable (bary (..., 3), z, mask) for hard ids at pixel
    coordinates px / py (compact or full layout); order as in _face_rows."""
    g = face_pixel_geometry(_face_rows(verts_px, faces, ids, order), px, py, cfg,
                            need_dist=False)
    return torch.stack(g["bary"], dim=-1), g["z"], ids >= 0


class _SoftAlphaPack(torch.autograd.Function):
    """Silhouette alpha with the forward taken from the coverage log-sum and
    the exact all-faces backward of K2 (harp_tpu soft_alpha_fast_pack)."""

    @staticmethod
    def forward(ctx, verts_px, soft_sum, bins, corners, cfg):
        ctx.save_for_backward(soft_sum)
        ctx.bins, ctx.corners, ctx.cfg = bins, corners, cfg
        return 1.0 - torch.exp(soft_sum)

    @staticmethod
    def backward(ctx, g):
        from benchmark.reference.render.kernels.raster_kernel import coverage_grad_verts

        (soft_sum,) = ctx.saved_tensors
        g_ssum = (-torch.exp(soft_sum) * g).contiguous()
        dv = coverage_grad_verts(ctx.bins, g_ssum, ctx.corners, ctx.cfg)
        return dv, None, None, None, None


def soft_alpha_fast_pack(soft_sum, bins, verts_px, corners, cfg: RasterConfig):
    """Compact silhouette alpha (B, A, P); its gradient w.r.t. verts_px is
    the exact gradient over all within-blur faces (K2). corners: the
    rasterized face table's corner order (MeshTopology.corners)."""
    if verts_px.shape[1] != corners.num_rows:
        raise ValueError(f"verts_px has {verts_px.shape[1]} vertices, the face "
                         f"table {corners.num_rows}")
    return _SoftAlphaPack.apply(verts_px, soft_sum.detach(), bins, corners, cfg)


# ---------------------------------------------------------------------------
# Full-image interface: the dense API (harp_tpu's rasterize_soft / hard,
# get_ids, raster_full, soft_alpha_*). Each is the compact pass (K1) with
# its tiles scattered to the image; harp_tpu's private helpers (_bin_faces,
# _bin_faces_dense, _gather_tile_ids, _use_pallas,
# _pallas_pregather_too_large) have no counterpart: the port bins through
# bin_pairs and picks the kernel or its plain version by the tensor's device.
# ---------------------------------------------------------------------------

OVERFLOW = ("bin_overflow", "active_overflow", "span_overflow")


def _pixel_centers(cfg: RasterConfig, device):
    r = torch.arange(cfg.image_size, dtype=torch.float32, device=device) + 0.5
    return r[None, :].expand(cfg.image_size, -1), r[:, None].expand(-1, cfg.image_size)


def add_overflow(counters: dict | None, out: dict, prefix: str = "") -> None:
    """Add a raster pass's overflow counters, summed over its frames, into
    `counters` under prefix + name (nothing when counters is None). A
    full-image render scatters the compact pass back and drops whatever it
    truncated; its callers read these to refuse such a render."""
    if counters is None:
        return
    for k in OVERFLOW:
        counters[prefix + k] = counters.get(prefix + k, 0) + out[k].sum()


def raster_full(verts_px, faces, cfg: RasterConfig, need_soft: bool = True,
                need_hard: bool = True) -> dict:
    """Full-image rasterization (harp_tpu raster_full): a dict with soft_ids
    (B, H, W, K) int32 (-1 empty), soft_sum (B, H, W) f32 (0 off the active
    tiles), hard_ids (B, H, W) int32 (-1 background), each when requested,
    and the three overflow counters (B,). raster_compact scattered to the
    image; need_soft=False runs K1's depth-only mode."""
    out = raster_compact(verts_px, faces, cfg, need_soft=need_soft, need_hard=need_hard)
    act = out["act_idx"]
    full = {k: out[k] for k in OVERFLOW}
    if need_soft:
        full["soft_ids"] = scatter_tiles(out["soft_ids"], act, cfg, -1)
        full["soft_sum"] = scatter_tiles(out["soft_sum"], act, cfg, 0.0)
    if need_hard:
        full["hard_ids"] = scatter_tiles(out["hard_ids"], act, cfg, -1)
    return full


def get_ids(verts_px, faces, cfg: RasterConfig, need_soft: bool = True,
            need_hard: bool = True):
    """(soft_ids (B, H, W, K) | None, hard_ids (B, H, W) | None)."""
    out = raster_full(verts_px, faces, cfg, need_soft, need_hard)
    return out.get("soft_ids"), out.get("hard_ids")


def rasterize_soft(verts_px, faces, cfg: RasterConfig) -> torch.Tensor:
    """(B, H, W, K) int32: the first K faces (bin-list order, i.e. ascending
    face id) within the blur radius of each pixel; -1 for empty slots."""
    return raster_full(verts_px, faces, cfg, True, False)["soft_ids"]


def rasterize_hard(verts_px, faces, cfg: RasterConfig) -> torch.Tensor:
    """(B, H, W) int32 id of the nearest covering face, -1 for background."""
    return raster_full(verts_px, faces, cfg, False, True)["hard_ids"]


def rasterize(verts_px, faces, cfg: RasterConfig):
    """(soft_ids, hard_ids) from one pass."""
    return get_ids(verts_px, faces, cfg, True, True)


def get_hard_ids(verts_px, faces, cfg: RasterConfig, counters: dict | None = None,
                 prefix: str = "") -> torch.Tensor:
    """rasterize_hard with its overflow counters added to `counters` (see
    add_overflow)."""
    out = raster_full(verts_px, faces, cfg, need_soft=False)
    add_overflow(counters, out, prefix)
    return out["hard_ids"]


def barycentrics_of(ids, verts_px, faces, cfg: RasterConfig):
    """Full-image (bary (B, H, W, 3), z (B, H, W), mask) for hard ids."""
    px, py = _pixel_centers(cfg, verts_px.device)
    return barycentrics_of_at(ids, verts_px, faces, cfg, px, py)


def soft_alpha_from_ids_at(ids, verts_px, faces, cfg: RasterConfig, px, py):
    """Differentiable silhouette alpha 1 - prod_k (1 - sigmoid(-d_k / sigma))
    over the K recorded faces `ids` (..., K) at pixel centres px / py
    (broadcastable against ids' leading dims: (B, A, P) compact tiles, or
    (H, W) for the full image). harp_tpu's operations in its order: d the
    signed squared distance in NDC^2, a face counted when listed, valid
    and d <= blur_radius, its log(1 - p) = -softplus(-d / sigma) summed
    over k in order. The face-row gather's backward is the fixed-order
    segment sum."""
    fv = _face_rows(verts_px, faces, ids)  # (..., K, 3, 3)
    g = face_pixel_geometry(fv, px[..., None], py[..., None], cfg)
    e01, e12, e20 = g["edges"]
    d2 = torch.minimum(torch.minimum(e01, e12), e20)
    d = torch.where(g["inside"], -d2, d2) * f32(cfg.ndc_scale**2)
    ok = (ids >= 0) & g["valid"] & (d <= f32(cfg.blur_radius))
    contrib = torch.where(ok, -softplus(-d / f32(cfg.sigma)), 0.0)
    acc = contrib[..., 0]
    for k in range(1, ids.shape[-1]):
        acc = acc + contrib[..., k]
    return 1.0 - torch.exp(acc)


class _SoftAlphaIds(torch.autograd.Function):
    """Alpha with the forward taken from the coverage log-sum and the
    backward of soft_alpha_from_ids_at over the K recorded ids."""

    @staticmethod
    def forward(ctx, verts_px, ids, soft_sum, faces, cfg, px, py):
        ctx.save_for_backward(verts_px.detach(), ids, px, py)
        ctx.faces, ctx.cfg = faces, cfg
        return 1.0 - torch.exp(soft_sum)

    @staticmethod
    def backward(ctx, g):
        verts_px, ids, px, py = ctx.saved_tensors
        with torch.enable_grad():
            v = verts_px.detach().requires_grad_(True)
            alpha = soft_alpha_from_ids_at(ids, v, ctx.faces, ctx.cfg, px, py)
            (dv,) = torch.autograd.grad(alpha, v, g)
        return dv, None, None, None, None, None, None


def soft_alpha_fast_at(ids, soft_sum, verts_px, faces, cfg: RasterConfig, px, py):
    """Compact silhouette alpha (B, A, P): forward 1 - exp(soft_sum), the
    backward soft_alpha_from_ids_at's over the K ids (harp_tpu's
    K-truncated gradient; soft_alpha_fast_pack's K2 takes every
    within-blur face, and the two differ where a pixel has more than K)."""
    return _SoftAlphaIds.apply(verts_px, ids.detach(), soft_sum.detach(), faces, cfg,
                               px, py)


def soft_alpha_fast(ids, soft_sum, verts_px, faces, cfg: RasterConfig):
    """soft_alpha_fast_at on the full image: ids (B, H, W, K) and soft_sum
    (B, H, W) from raster_full -> alpha (B, H, W)."""
    px, py = _pixel_centers(cfg, verts_px.device)
    return soft_alpha_fast_at(ids, soft_sum, verts_px, faces, cfg, px, py)

