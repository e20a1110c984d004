"""What csrc/raster.cu decides in its own way, held against the plain
versions on the CPU (no card needed):

- the warp cull (raster_kernel.warp_cull_keep, the kernels' float32 test):
  every (pixel, slot) pair that the plain tile pass marks inside or within
  blur lies in a (slot, warp) the cull keeps, at 32^2 with tile 8 and 16,
  on random scenes and adversarial faces, at the default blur and at a blur
  of ~1 px; and the ids of the plain pass restricted to the kept pairs,
  with the sign test for inside, equal the plain ids;
- the division-free sign test (raster_kernel.quotient_nonneg) equals
  w / denom >= 0 elementwise, against numpy's IEEE float32 division.
"""

import dataclasses

import numpy as np
import pytest
import torch

from harp_tpu_torch.render.kernels import raster_kernel as rk
from harp_tpu_torch.render.rasterizer import RasterConfig, raster_compact, tile_pixel_coords

IMG = 32
BLUR_1PX = 4e-3  # blur_radius (NDC^2) of blur_px2 ~ 1 px^2 at 32^2


def random_scene(seed, n, B=2, spread=4.0):
    rng = np.random.RandomState(seed)
    verts = np.zeros((B, n * 3, 3), np.float32)
    for b in range(B):
        centers = rng.uniform(2, 30, size=(n, 2))
        offsets = rng.uniform(-spread, spread, size=(n, 3, 2))
        verts[b, :, :2] = (centers[:, None] + offsets).reshape(-1, 2)
        verts[b, :, 2] = rng.uniform(0.5, 3.0, size=(n, 1)).repeat(3, 1).reshape(-1)
    return verts, np.arange(n * 3).reshape(n, 3).astype(np.int32)


def _f32_sum_hits(target, pad):
    """A float32 x with f32(x + pad) == target, or None where the float32
    grid near target - pad has none."""
    x, pad, target = np.float32(target - pad), np.float32(pad), np.float32(target)
    for x in (np.nextafter(x, np.float32(-np.inf)), x, np.nextafter(x, np.float32(np.inf))):
        if x + pad == target:
            return x
    return None


def adversarial_scene(cfg: RasterConfig, seed=0):
    """Faces at the edges of what the kernels decide, as one frame: slivers,
    faces with a vertex on a pixel centre, faces whose padded box ends
    exactly on a warp rectangle's first or last pixel centre, faces with a
    vertex on a border between two warps, degenerate faces (|area2| <=
    1e-10) and faces behind znear; plus random small faces around them."""
    rng = np.random.RandomState(seed)
    pad = np.float32(rk.cull_pad(cfg))
    tris = []
    z = [1.0, 1.5, 2.0]  # depths of every face but those behind znear
    for _ in range(12):  # slivers, a thousandth of a pixel wide, up to 20 px long
        a = rng.uniform(2, 30, 2)
        d = rng.normal(size=2)
        b = np.clip(a + rng.uniform(3, 20) * d / np.linalg.norm(d), 0.5, 31.5)
        c = b + 1e-3 * np.array([-d[1], d[0]]) / np.linalg.norm(d)
        tris.append([a, b, c])
    for _ in range(12):  # a vertex on a pixel centre
        a = rng.randint(0, IMG, 2) + 0.5
        tris.append([a, a + rng.uniform(-3, 3, 2), a + rng.uniform(-3, 3, 2)])
    # Padded box ends exactly on a rectangle's centre span: xmax + pad == rx0,
    # xmin - pad == rx1 (and the same in y), where float32 allows it.
    for r0 in range(0, IMG, rk.RECT_W):
        y = rng.uniform(4, 28)
        xmax, xmin = _f32_sum_hits(r0 + 0.5, pad), _f32_sum_hits(r0 + rk.RECT_W - 0.5, -pad)
        if xmax is not None:
            tris.append([[xmax, y], [xmax - 2.0, y + 1.5], [xmax - 1.0, y - 1.5]])
        if xmin is not None:
            tris.append([[xmin, y], [xmin + 2.0, y + 1.5], [xmin + 1.0, y - 1.5]])
    for r0 in range(0, IMG, rk.RECT_H):
        x = rng.uniform(4, 28)
        ymax, ymin = _f32_sum_hits(r0 + 0.5, pad), _f32_sum_hits(r0 + rk.RECT_H - 0.5, -pad)
        if ymax is not None:
            tris.append([[x, ymax], [x + 1.5, ymax - 2.0], [x - 1.5, ymax - 1.0]])
        if ymin is not None:
            tris.append([[x, ymin], [x + 1.5, ymin + 2.0], [x - 1.5, ymin + 1.0]])
    # A vertex or an edge on a pixel border between two warps' rectangles.
    for bx in range(rk.RECT_W, IMG, rk.RECT_W):
        y = rng.uniform(3, 29)
        tris.append([[bx, y], [bx - 1.7, y + 0.9], [bx - 0.6, y - 1.3]])
        tris.append([[bx, y - 2.0], [bx, y + 2.0], [bx + 0.7, y]])
    for by in range(rk.RECT_H, IMG, rk.RECT_H):
        x = rng.uniform(3, 29)
        tris.append([[x, by], [x + 0.9, by - 1.7], [x - 1.3, by - 0.6]])
        tris.append([[x - 2.0, by], [x + 2.0, by], [x, by + 0.7]])
    for _ in range(6):  # degenerate: exactly collinear, or |area2| ~1e-12
        a = rng.randint(4, 28, 2) + 0.25
        d = rng.randint(-3, 4, 2) * 0.5
        tris.append([a, a + d, a + 2 * d])
        tris.append([a, a + [1e-6, 0.0], a + [0.0, 1e-6]])
    for _ in range(6):  # tiny but valid: |area2| ~4e-10
        a = rng.uniform(4, 28, 2)
        tris.append([a, a + [2e-5, 0.0], a + [0.0, 2e-5]])
    zs = [z] * len(tris)
    for zb in (1e-7, -0.5, np.float32(cfg.znear), 0.0):  # a vertex at or behind znear
        a = rng.uniform(6, 26, 2)
        tris.append([a, a + [3.0, 0.5], a + [0.5, 3.0]])
        zs.append([1.0, zb, 1.0])
    tris = np.asarray(tris, np.float64)
    zs = np.asarray(zs, np.float64)
    small, _ = random_scene(seed + 1, 40, B=1, spread=1.5)
    verts = np.concatenate([np.concatenate([tris, zs[..., None]], -1).reshape(-1, 3),
                            small[0]]).astype(np.float32)[None]
    return verts, np.arange(verts.shape[1]).reshape(-1, 3).astype(np.int32)


def _config(tile, blur):
    kw = dict(image_size=IMG, tile=tile, cap=1024, faces_per_pixel=8, face_chunk=64)
    if blur:
        kw["blur_radius"] = BLUR_1PX
    return RasterConfig(**kw)


def _edge_functions(fv9, ids, px, py):
    """w0, w1, w2 and denom of (B, A, cap) slots against (B, A, P) pixels,
    in face_pixel_geometry's expressions."""
    B = fv9.shape[0]
    v = torch.gather(fv9, 1, ids.clamp(min=0).reshape(B, -1, 1).expand(-1, -1, 9))
    v = v.reshape(ids.shape + (1, 9))
    x0, y0, _, x1, y1, _, x2, y2, _ = v.unbind(-1)
    px, py = px[:, :, None, :], py[:, :, None, :]
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    w0 = (x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)
    w1 = (x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)
    w2 = (x0 - px) * (y1 - py) - (x1 - px) * (y0 - py)
    eps = np.float32(1e-10)
    denom = torch.where(torch.abs(area2) > eps, area2, torch.where(area2 >= 0, eps, -eps))
    return (w0, w1, w2), denom


def _check_cull(verts, faces, cfg):
    """The cull keeps every covered pair, and the plain pass restricted to
    kept pairs (inside by the sign test) gives the plain ids. Returns
    (covered pairs, kept pairs, live pairs) over all pixels."""
    out = raster_compact(torch.from_numpy(verts), faces, cfg)
    b = out["bins"]
    args = (b["fv9"], b["s_face"], b["start_a"], b["count_a"], b["act_idx"])
    assert int(b["count_a"].max()) < cfg.cap
    ids = rk._slot_faces(b["s_face"], b["start_a"], b["count_a"], torch.arange(cfg.cap))
    px, py = tile_pixel_coords(b["act_idx"], cfg)
    g = rk._tile_geometry(b["fv9"], ids, px, py, cfg, True)  # (B, A, cap, P)
    blur_px2 = rk._consts(cfg)[0]
    d2 = torch.minimum(torch.minimum(g["edges"][0], g["edges"][1]), g["edges"][2])
    s = torch.where(g["inside"], -d2, d2)
    hit = g["valid"] & (s <= blur_px2)
    covered = hit | g["inside"]
    keep = rk.warp_cull_keep(*args, cfg)[..., rk.warp_of_pixel(cfg)]  # (B, A, cap, P)
    missed = covered & ~keep
    assert not missed.any(), f"{int(missed.sum())} covered pairs culled"

    # The kernel's walk: kept pairs only, inside by the sign test.
    w, denom = _edge_functions(b["fv9"], ids, px, py)
    inside = keep & g["valid"]
    for wi in w:
        inside = inside & rk.quotient_nonneg(wi, denom)
    assert torch.equal(inside, g["inside"])
    z = torch.where(inside, g["z"], float("inf"))
    zmin, first = z.min(dim=2)  # the lowest slot among equal depths
    hard = torch.where(torch.isfinite(zmin), torch.gather(ids, 2, first), -1)
    hard_p, soft_p, _ = rk.raster_ids_plain(*args, cfg)
    assert torch.equal(hard.to(torch.int32), hard_p)
    hit_k = keep & g["valid"] & (torch.where(inside, -d2, d2) <= blur_px2)
    assert torch.equal(hit_k, hit)
    rank = torch.cumsum(hit_k.long(), dim=2) - 1
    K = cfg.faces_per_pixel
    soft = torch.full(soft_p.shape, -1, dtype=torch.int64)
    for k in range(K):
        sel = hit_k & (rank == k)
        soft[..., k] = torch.where(sel.any(2), (ids[..., None] * sel).sum(2), -1)
    assert torch.equal(soft.to(torch.int32), soft_p)
    live = int((ids >= 0).sum()) * cfg.tile ** 2
    return int(covered.sum()), int(keep.sum()), live


@pytest.mark.parametrize("blur", [False, True], ids=["blur_default", "blur_1px"])
@pytest.mark.parametrize("tile", [8, 16])
def test_cull_keeps_every_covered_pair_random(tile, blur):
    cfg = _config(tile, blur)
    total = [0, 0, 0]
    for seed, n, spread in ((5, 60, 4.0), (6, 300, 1.5)):
        verts, faces = random_scene(seed, n, spread=spread)
        total = [t + c for t, c in zip(total, _check_cull(verts, faces, cfg))]
    covered, kept, live = total
    assert 0 < covered <= kept < live  # the cull drops pairs, never a covered one


@pytest.mark.parametrize("blur", [False, True], ids=["blur_default", "blur_1px"])
@pytest.mark.parametrize("tile", [8, 16])
def test_cull_keeps_every_covered_pair_adversarial(tile, blur):
    cfg = _config(tile, blur)
    verts, faces = adversarial_scene(cfg)
    covered, kept, live = _check_cull(verts, faces, cfg)
    assert 0 < covered <= kept < live


def test_adversarial_scene_has_its_cases():
    """Box ends on rectangle borders hold exactly in float32; degenerate and
    behind-znear faces are invalid, and the cull drops them everywhere."""
    cfg = _config(16, False)
    verts, faces = adversarial_scene(cfg)
    pad = np.float32(rk.cull_pad(cfg))
    fv = verts[0][faces]  # (F, 3, 3)
    for lo, hi, axis in ((0.5, rk.RECT_W - 0.5, 0), (0.5, rk.RECT_H - 0.5, 1)):
        step = rk.RECT_W if axis == 0 else rk.RECT_H
        ends = np.concatenate([fv[..., axis].max(1) + pad, fv[..., axis].min(1) - pad])
        for first in (lo, hi):  # a box ends on a rectangle's first / last centre
            assert np.isin(np.arange(0, IMG, step) + np.float32(first), ends).any()
    out = raster_compact(torch.from_numpy(verts), faces, cfg)
    b = out["bins"]
    keep = rk.warp_cull_keep(b["fv9"], b["s_face"], b["start_a"], b["count_a"],
                             b["act_idx"], cfg)
    ids = rk._slot_faces(b["s_face"], b["start_a"], b["count_a"], torch.arange(cfg.cap))
    x0, y0, z0, x1, y1, z1, x2, y2, z2 = torch.from_numpy(fv.reshape(-1, 9)).unbind(-1)
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    invalid = (area2.abs() <= np.float32(1e-10)) | (torch.stack([z0, z1, z2]).amin(0)
                                                    <= np.float32(cfg.znear))
    assert int(invalid.sum()) >= 16
    slot_invalid = invalid[ids.clamp(min=0)] & (ids >= 0)
    assert slot_invalid.any() and not keep[slot_invalid].any()


def _rd_threshold(d):
    """RD(|d| * 2^-150) in float32, computed apart from the mirror."""
    x = np.abs(d).astype(np.float64) * 2.0**-150
    t = x.astype(np.float32)
    return np.where(t.astype(np.float64) > x, np.nextafter(t, np.float32(0)), t)


def test_sign_test_equals_division():
    rng = np.random.default_rng(0)
    f = np.float32
    tiny = f(2.0**-149)
    specials = np.array([0.0, -0.0, tiny, -tiny, 3 * tiny, -3 * tiny, 1e-40, -1e-40,
                         2.0**-126, -(2.0**-126), 1e-30, -1e-30, 0.5, -0.5, 1.0, -1.0,
                         2e5, -2e5, 448.0**2, -(448.0**2), 4e10, -4e10,
                         np.inf, -np.inf, np.nan], f)
    dens = np.array([1e-10, -1e-10, 2e-10, 1.5, -1.5, 2.0, -2.0, 3.0, -3.0, 100.0,
                     -100.0, 448.0**2, -(448.0**2), 4e10, -4e10, 1e30, -1e30], f)
    W, D = np.meshgrid(specials, dens)
    mag = lambda k, lo, hi: f(10.0) ** rng.uniform(lo, hi, k).astype(f)
    sign = lambda k: np.where(rng.random(k) < 0.5, f(-1), f(1))
    k = 200_000
    d_r = sign(k) * mag(k, -10, 10.6)
    w_r = sign(k) * np.concatenate([mag(k // 2, -45, 12), mag(k - k // 2, -45, -36)])
    # At the threshold: w = -sgn * t and its float neighbours, d >= 2.
    d_b = sign(k) * mag(k, 0.31, 38)
    t = _rd_threshold(d_b)
    w_b = -np.sign(d_b) * np.stack([t, np.nextafter(t, f(np.inf)),
                                    np.nextafter(t, f(0))]).astype(f)
    w = np.concatenate([W.ravel(), w_r, w_b.ravel()]).astype(f)
    d = np.concatenate([D.ravel(), d_r, np.tile(d_b, 3)]).astype(f)
    with np.errstate(all="ignore"):
        want = (w / d) >= 0
    got = rk.quotient_nonneg(torch.from_numpy(w), torch.from_numpy(d)).numpy()
    assert want[-3 * k:].any() and not want[-3 * k:].all()  # both sides of the threshold
    np.testing.assert_array_equal(got, want)


def test_cull_pad_is_the_binning_pad_plus_one_pixel():
    cfg = RasterConfig(image_size=448)
    assert abs(rk.cull_pad(cfg) - (np.sqrt(cfg.blur_px2) + 1e-3 + 1.0)) < 1e-6
    assert rk.cull_pad(dataclasses.replace(cfg, blur_radius=0.0)) == np.float32(1.001)


def test_ballots_are_only_the_cuda_kernels_own():
    """The cull's ballots come from the CUDA kernel alone: a CPU call that
    asks for them raises instead of returning the mirror's."""
    cfg = _config(8, False)
    verts, faces = random_scene(5, 60)
    b = raster_compact(torch.from_numpy(verts), faces, cfg)["bins"]
    args = (b["fv9"], b["s_face"], b["start_a"], b["count_a"], b["act_idx"])
    words = torch.zeros(2, b["act_idx"].shape[1], cfg.cap // 32, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="ballots"):
        rk.raster_ids(*args, cfg, keep=words)
    with pytest.raises(ValueError, match="ballots"):
        rk.coverage_grad(*args, torch.zeros(2, b["act_idx"].shape[1], 64), cfg, keep=words)
