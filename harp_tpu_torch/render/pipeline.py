"""Forward model (harp_tpu/render/pipeline.py): parameters -> posed mesh
-> rendered images, on the full image (ground-truth render) and on compact
active tiles (the train step)."""

from __future__ import annotations

import torch

from harp_tpu_torch.device import constant
from harp_tpu_torch.models.mano import mano_forward
from harp_tpu_torch.models.nimble import mano_protocol_joints, nimble_forward, nimble_to_mano
from harp_tpu_torch.models.smplx_arm import smplx_arm_forward
from harp_tpu_torch.ops.mesh import apply_subdivision, vertex_normals
from harp_tpu_torch.ops.numerics import safe_normalize
from harp_tpu_torch.render import camera as cam_mod
from harp_tpu_torch.render import shading
from harp_tpu_torch.render.rasterizer import (
    RasterConfig, add_overflow, barycentrics_of, barycentrics_of_at, face_row_order,
    get_hard_ids, raster_compact, raster_full, scatter_tiles, soft_alpha_fast_pack,
    tile_pixel_coords,
)
from harp_tpu_torch.utils.profiling import mark, stamp


def mesh_forward(params: dict, fids: torch.Tensor, assets, config, stamps=None):
    """Pose the model (NIMBLE, the SMPL-X arm or MANO), subdivide, displace
    along the vertex normals. Returns (verts (B, V_render, 3) metres,
    joints (B, J, 3) mm: 21 in MANO order, 22 for the arm with its elbow).
    stamps (utils/profiling.StepStamps or None): "posed" after the model's
    forward, and a marker on its vertices whose backward stamps
    "posed_grad"."""
    B = fids.shape[0]
    pose = params["pose"][fids]
    rot = params["rot"][fids]
    trans = params["trans"][fids]
    shape = params["shape"][None].expand(B, -1)
    if config.model_type == "nimble":
        verts_mm, _ = nimble_forward(assets.model, torch.cat([rot, pose], 1), shape, trans)
        # The keypoint convention of every family: MANO joints of the
        # regressed MANO surface.
        joints_mm = mano_protocol_joints(assets.model, nimble_to_mano(assets.model, verts_mm))
    elif config.use_arm:
        verts_mm, joints_mm = smplx_arm_forward(assets.model, shape, rot, trans, pose,
                                                params["wrist_pose"][fids])
    else:
        verts_mm, joints_mm = mano_forward(assets.model, torch.cat([rot, pose], 1),
                                           shape, trans)
    stamp(stamps, "posed")
    verts = mark(stamps, verts_mm, "posed_grad") / 1000.0
    if assets.subdivision is not None:
        verts = apply_subdivision(assets.subdivision, verts)
    disps = params.get("verts_disps")
    if disps is not None:
        if disps.shape[-1] == 1:
            verts = verts + vertex_normals(verts, assets.sub_topology) * disps[None]
        else:
            verts = verts + disps[None]
    return verts, joints_mm


def camera_for_frames(params: dict, fids: torch.Tensor, config):
    """(R, T) of the OpenCV-flip camera from the weak-perspective params."""
    cam = params["cam"][fids]
    T = cam_mod.weak_perspective_to_translation(cam, config.focal_length, config.img_size)
    R = constant(cam_mod.OPENCV_TO_P3D_R, cam.device).expand(fids.shape[0], 3, 3)
    return R, T


def render_silhouette(verts, assets, R, T, config, raster_cfg: RasterConfig,
                      counters: dict | None = None):
    """Soft silhouette alpha (B, H, W): the compact alpha (forward from the
    coverage log-sum, backward K2) scattered to the image, 0 elsewhere.
    counters: see rasterizer.add_overflow (also for the renders below).

    The forward is harp_tpu's. The gradient is not quite: harp_tpu's
    render_silhouette differentiates through the first K recorded ids
    (soft_alpha_fast), K2 through every within-blur face, so the two part
    at pixels with more than K within-blur faces (rasterizer.soft_alpha_fast
    is harp_tpu's)."""
    screen = cam_mod.screen_from_world(verts, R, T, config.focal_length, config.img_size)
    out = raster_compact(screen, assets.render_faces, raster_cfg, need_hard=False)
    add_overflow(counters, out)
    alpha = soft_alpha_fast_pack(out["soft_sum"], out["bins"], screen,
                                 assets.sub_topology.corners, raster_cfg)
    return scatter_tiles(alpha, out["act_idx"], raster_cfg, 0.0)


def _shade(points, pixel_normals, uv, mask, R, T, config, texture, normal_map,
           light_positions, ambient_color, diffuse_color, specular_color,
           vis_map=None, shininess: float = 0.0):
    """Phong shading of interpolated pixel attributes, composited over the
    background where `mask` is false."""
    if normal_map is not None:
        packed = torch.cat([texture, safe_normalize(normal_map)], -1)
        sampled = shading.sample_texture_bilinear(packed, uv)
        texels = sampled[..., 0:3]
        pixel_normals = shading.apply_normal_map(pixel_normals, sampled[..., 3:6])
    else:
        texels = shading.sample_texture_bilinear(texture, uv)
    amb, diff, spec = shading.phong_lighting(
        points, pixel_normals, light_positions, cam_mod.camera_center(R, T),
        ambient_color, diffuse_color, specular_color, shininess=shininess)
    if vis_map is not None:
        colors = (amb + diff * vis_map[..., None]) * texels + spec
    else:
        colors = (amb + diff) * texels + spec
    return shading.composite_hard(colors, mask, config.background_color)


def _shade_pixels(verts, ids, bary, mask, assets, R, T, config, texture,
                  normal_map, light_positions, ambient_color, diffuse_color,
                  specular_color, vis_map=None, shininess: float = 0.0):
    """Phong shading of a full-image hard rasterization (B, H, W, 3): one
    packed gather of (position | normal | uv), composited over the
    background."""
    attrs = shading.interpolate_packed_attrs(
        verts, vertex_normals(verts, assets.sub_topology), assets.render_faces,
        assets.verts_uvs, assets.faces_uvs, ids, bary)
    return _shade(attrs[..., 0:3], attrs[..., 3:6], attrs[..., 6:8], mask, R, T,
                  config, texture, normal_map, light_positions, ambient_color,
                  diffuse_color, specular_color, vis_map=vis_map, shininess=shininess)


def raster_camera_view(verts, assets, R, T, config, raster_cfg: RasterConfig,
                       need_soft=True, need_hard=True):
    """One full-image camera rasterization shared by the silhouette and the
    colour renders: (screen, rasterizer.raster_full's dict)."""
    screen = cam_mod.screen_from_world(verts, R, T, config.focal_length, config.img_size)
    return screen, raster_full(screen, assets.render_faces, raster_cfg, need_soft, need_hard)


def _camera_hard_ids(verts, assets, R, T, config, raster_cfg, counters, precomputed):
    """(screen, hard ids): precomputed (from raster_camera_view, whose
    counters its caller holds), else a depth-only pass of its own."""
    if precomputed is not None:
        return precomputed
    screen = cam_mod.screen_from_world(verts, R, T, config.focal_length, config.img_size)
    return screen, get_hard_ids(screen, assets.render_faces, raster_cfg, counters)


def render_rgb(verts, assets, R, T, config, raster_cfg: RasterConfig,
               texture, normal_map, light_positions, counters: dict | None = None,
               precomputed=None):
    """Phong colour render without shadows (B, H, W, 3). precomputed:
    (screen, hard_ids) from raster_camera_view, to share its pass."""
    screen, ids = _camera_hard_ids(verts, assets, R, T, config, raster_cfg, counters,
                                   precomputed)
    bary, _, mask = barycentrics_of(ids, screen, assets.render_faces, raster_cfg)
    return _shade_pixels(verts, ids, bary, mask, assets, R, T, config, texture,
                         normal_map, light_positions, config.ambient_color,
                         config.diffuse_color, config.specular_color,
                         shininess=config.shininess)


def render_normal(verts, assets, R, T, config, raster_cfg: RasterConfig,
                  normal_map=None, counters: dict | None = None, precomputed=None):
    """Normals as colours (B, H, W, 3), SoftPhongNormalShader semantics:
    interpolated (and, with a normal map, normal-mapped) normals, y and z
    negated, mapped to [0, 1], over the background. precomputed: as in
    render_rgb."""
    faces = assets.render_faces
    screen, ids = _camera_hard_ids(verts, assets, R, T, config, raster_cfg, counters,
                                   precomputed)
    bary, _, mask = barycentrics_of(ids, screen, faces, raster_cfg)
    pixel_normals = shading.interpolate_face_vertex_attrs(
        vertex_normals(verts, assets.sub_topology), faces, ids, bary)
    if normal_map is not None:
        uv = shading.pixel_uvs(ids, bary, assets.verts_uvs, assets.faces_uvs)
        nm_px = shading.sample_texture_bilinear(safe_normalize(normal_map), uv)
        pixel_normals = shading.apply_normal_map(pixel_normals, nm_px)
    flipped = pixel_normals * constant((1.0, -1.0, -1.0), pixel_normals.device,
                                       pixel_normals.dtype)
    return shading.composite_hard((flipped + 1.0) / 2.0, mask, config.background_color)


def raster_camera_view_compact(verts, assets, R, T, config,
                               raster_cfg: RasterConfig, need_soft=True,
                               need_hard=True):
    """One camera rasterization on compact tiles: (screen, raster dict)."""
    screen = cam_mod.screen_from_world(verts, R, T, config.focal_length, config.img_size)
    return screen, raster_compact(screen, assets.render_faces, raster_cfg,
                                  need_soft, need_hard)


def pixel_geometry_compact(verts, screen, rout, assets, raster_cfg: RasterConfig):
    """One barycentric recompute + one packed attribute gather shared by
    the shadow reprojection and the shading: dict(points, normals, uv,
    mask), each (B, A, P, ...)."""
    faces = assets.render_faces
    px, py = tile_pixel_coords(rout["act_idx"], raster_cfg)
    ids = rout["hard_ids"]
    order = face_row_order(ids, len(faces))  # one sort for both gathers
    bary, _, mask = barycentrics_of_at(ids, screen, faces, raster_cfg, px, py, order)
    attrs = shading.interpolate_packed_attrs(
        verts, vertex_normals(verts, assets.sub_topology), faces, assets.verts_uvs,
        assets.faces_uvs, ids, bary, order)
    return {"points": attrs[..., 0:3], "normals": attrs[..., 3:6],
            "uv": attrs[..., 6:8], "mask": mask}


def shade_pixels_compact(geom, R, T, config, texture, normal_map,
                         light_positions, ambient_color, diffuse_color,
                         specular_color, vis_map=None, shininess: float = 0.0):
    """Phong shading on compact tiles -> (colors (B, A, P, 3), mask)."""
    colors = _shade(geom["points"], geom["normals"], geom["uv"], geom["mask"],
                    R, T, config, texture, normal_map, light_positions,
                    ambient_color, diffuse_color, specular_color,
                    vis_map=vis_map, shininess=shininess)
    return colors, geom["mask"]
