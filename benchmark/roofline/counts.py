"""Operations and bytes of the fit step, from the cell's shapes.

- vgg_forward_flops(h, w): 2 * h * w * Cin * Cout * 9 summed over VGG16's
  convolutions through relu4_3 at their resolutions (multiply and add
  counted as two operations; pools, ReLUs and the L1 not counted).
  111.674916864 GFLOP a 448^2 frame.
- step_model_flops: the model operations of one step: the VGG term's
  forward and its gradient to the input (2x the forward; the filters take
  no gradient, and the GT pyramids are cached, so no GT forward), counted
  once whatever recompute the program does, plus the mesh's blend-shape,
  joint-regressor and skinning products, forward and gradient (2x).
- kernel_bytes: the bytes each hand-written kernel's function needs, each
  input read once and each output written once: K1 (camera soft pass and
  light depth pass) reads the face rows and the tiles' pair lists and
  writes its per-pixel ids (and soft ids and coverage sums); K2 reads the
  same plus the upstream gradient of the coverage sums and writes the
  gradient of each face's 9 screen coordinates; K3 reads the tap centres
  and the 9 tap gradients of every camera pixel and writes the padded
  light-map gradient; each segment sum reads its values and its sorted
  keys and permutation and writes its rows. The least time of a kernel is
  these bytes over the peak bandwidth. No operation count is used: what
  the rasterizer's pairs need depends on the data, and counting the
  kernel's own culling work would move with the kernel.
"""

from __future__ import annotations

VGG_CONVS = [(3, 64, 0), (64, 64, 0), (64, 128, 1), (128, 128, 1), (128, 256, 2),
             (256, 256, 2), (256, 256, 2), (256, 512, 3), (512, 512, 3), (512, 512, 3)]
F32, I32 = 4, 4


def vgg_forward_flops(h: int, w: int) -> int:
    return sum(2 * (h >> s) * (w >> s) * cin * cout * 9 for cin, cout, s in VGG_CONVS)


def mesh_flops(model_verts: int, joints: int, shape: int, pose_feats: int) -> int:
    """One frame's blend shapes (shape and pose-corrective), joint
    regressor and linear blend skinning (4x4 transforms weighted per
    vertex, then applied), forward."""
    v3 = 3 * model_verts
    return 2 * (v3 * shape + v3 * pose_feats + joints * v3 + model_verts * joints * 16
                + model_verts * 16)


def active_budget(tiles: int, fraction: float, granule: int = 8) -> int:
    if fraction >= 1.0:
        return tiles
    return min(max(-(-int(tiles * fraction) // granule), 1) * granule, tiles)


def step_shapes(config: dict, faces: int, verts: int) -> dict:
    """The step's shapes from the configuration's fields (a HarpConfig's
    as a dict) and the render mesh."""
    img, tile = config["img_size"], 16
    tiles = (img // tile) ** 2
    light = max(tile, int(round(img * config.get("shadow_map_scale", 0.5) / tile)) * tile)
    af = config["raster_active_fraction"]
    af_l = min(1.0, af * 1.5) if af < 1.0 else af
    return {"B": config["batch_size"], "F": faces, "V": verts, "P": tile * tile,
            "K": config.get("raster_faces_per_pixel", 8), "S": config["raster_span_tiles"],
            "A": active_budget(tiles, af), "Hl": light,
            "A_l": active_budget((light // tile) ** 2, af_l), "tex": config["texture_size"]}


def step_model_flops(sh: dict, img: int, vgg: bool, mesh: dict) -> float:
    per_frame = 2 * mesh_flops(**mesh)
    if vgg:
        per_frame += 2 * vgg_forward_flops(img, img)
    return float(sh["B"] * per_frame)


def _segment_sum(m: int, c: int, r: int) -> int:
    return m * c * F32 + 2 * m * I32 + r * c * F32


def kernel_bytes(sh: dict, coarse_on: bool, app_on: bool) -> dict:
    """{kernel: bytes of one step's launches} for the stage's flags."""
    B, F, V, P, K, S, A = (sh[k] for k in "B F V P K S A".split())
    faces_in = B * F * 9 * F32 + B * F * S * S * I32
    out = {}
    if coarse_on:
        out["k1_soft"] = (faces_in + B * A * 3 * I32 + B * A * P * (1 + K) * I32
                          + B * A * P * F32)
        out["k2"] = faces_in + B * A * 3 * I32 + B * A * P * F32 + B * F * 9 * F32
    sites = [(B * F * 3, 3, B * V)] * (2 if coarse_on else 1)  # vertex normals; K2's scatter
    if app_on:
        A_l, Hl, T = sh["A_l"], sh["Hl"], sh["tex"] ** 2
        out["k1_depth"] = (B * F * 9 * F32 + B * F * S * S * I32 + B * A_l * 3 * I32
                           + B * A_l * P * I32)
        n = A * P
        out["k3"] = B * n * 2 * I32 + B * n * 9 * F32 + B * (Hl + 4) ** 2 * F32
        sites += [(B * F * 3, 3, B * V), (T, 3, T), (T, 3, T), (B * n, 24, T),
                  (B * A_l * P, 9, B * F), (B * n, 24, B * F), (B * n, 9, B * F)]
    out["segment_sum"] = sum(_segment_sum(*s) for s in sites)
    return out
