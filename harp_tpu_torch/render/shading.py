"""Shading (harp_tpu/render/shading.py): UV texture sampling, normal
mapping in a Pixar tangent frame, point-light Phong terms.

- texture sampling: bilinear, align_corners=True, border clamp, v flipped
  (uv origin bottom-left; texture row 0 is the top of the map)
- point light: ambient + diffuse * relu(n.l) + specular * relu(v.r)^shininess
"""

from __future__ import annotations

import torch

from harp_tpu_torch.ops.numerics import jnp_clip, safe_normalize
from harp_tpu_torch.ops.segment import SegmentOrder, gather_rows
from harp_tpu_torch.render.rasterizer import as_faces, face_row_order


def texel_corner_rows(uv: torch.Tensor, H: int, W: int):
    """Bilinear weights and the top-left texel of (..., 2) uv on an (H, W)
    map: (fx (..., 1), fy (..., 1), row (...) = y0 * W + x0 int64)."""
    x = jnp_clip(uv[..., 0] * (W - 1), 0.0, W - 1)
    y = jnp_clip((1.0 - uv[..., 1]) * (H - 1), 0.0, H - 1)
    x0 = torch.clamp(torch.floor(x), 0, W - 1)
    y0 = torch.clamp(torch.floor(y), 0, H - 1)
    return (x - x0)[..., None], (y - y0)[..., None], y0.long() * W + x0.long()


def sample_texture_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W, C) texture at (..., 2) uv in [0, 1]^2 -> (..., C).

    The four corners come from ONE row gather of a corner stack (H*W, 4C),
    as in harp_tpu: plane (dy, dx) at (y0, x0) is tex[min(y0 + dy, H - 1),
    min(x0 + dx, W - 1)]. Its backward is one fixed-order segment sum. The
    edge pad is a concatenation: the backward of a replicate pad adds with
    atomics on the card. The uv clamp has jnp.clip's derivative (1/2 on a
    bound)."""
    H, W, C = tex.shape
    fx, fy, row = texel_corner_rows(uv, H, W)
    padded = torch.cat([tex, tex[-1:]], 0)
    padded = torch.cat([padded, padded[:, -1:]], 1)
    stack = torch.cat([padded[dy:dy + H, dx:dx + W] for dy in (0, 1) for dx in (0, 1)],
                      -1).reshape(H * W, 4 * C)
    rows = gather_rows(stack, SegmentOrder(row, H * W))
    t00, t01, t10, t11 = rows.reshape(uv.shape[:-1] + (4 * C,)).split(C, -1)
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def interpolate_packed_attrs(verts, normals_v, faces, verts_uvs, faces_uvs,
                             ids, bary, order=None) -> torch.Tensor:
    """One-gather interpolation of (position | normal | uv) -> (..., 8).
    order: the face_row_order of ids, when another gather shares its sort."""
    B = verts.shape[0]
    dev = verts.device
    f = as_faces(faces, dev)
    F = f.shape[0]
    vuv = torch.as_tensor(verts_uvs, dtype=verts.dtype, device=dev)
    fuv = vuv[as_faces(faces_uvs, dev)]  # (F, 3, 2)
    packed = torch.cat([verts[:, f], normals_v[:, f], fuv.expand(B, -1, -1, -1)], -1)
    if order is None:
        order = face_row_order(ids, F)
    g = gather_rows(packed.reshape(B * F, 24), order).reshape(ids.shape + (3, 8))
    return (g * bary[..., None]).sum(-2)


def pixar_tangent_frame(normals: torch.Tensor):
    """(..., 3) unit normals -> tangents (u, v), each (..., 3) ('Building an
    orthonormal basis, revisited', Pixar 2017)."""
    x, y, z = normals.unbind(-1)
    s = 2.0 * (z >= 0).to(normals.dtype) - 1.0
    a = -1.0 / (s + z)
    b = x * y * a
    u = torch.stack([1 + s * x * x * a, s * b, -s * x], dim=-1)
    v = torch.stack([b, s + y * y * a, -y], dim=-1)
    return u, v


def apply_normal_map(pixel_normals: torch.Tensor, sampled_nm: torch.Tensor) -> torch.Tensor:
    """normalize(-u*nx - v*ny + n*nz): TBN rows (-u, -v, n)."""
    u, v = pixar_tangent_frame(pixel_normals)
    nx, ny, nz = sampled_nm[..., 0:1], sampled_nm[..., 1:2], sampled_nm[..., 2:3]
    return safe_normalize(-u * nx - v * ny + pixel_normals * nz)


def phong_lighting(points, normals, light_position, camera_position,
                   ambient_color, diffuse_color, specular_color,
                   shininess: float = 0.0):
    """Point-light Phong terms; points / normals (B, ..., 3), light and
    camera positions (B, 3). Returns (ambient, diffuse, specular)."""
    B = points.shape[0]
    extra = (1,) * (points.dim() - 2)
    dev, dt = points.device, points.dtype

    def col(c):
        return torch.as_tensor(c, dtype=dt, device=dev)

    nrm = safe_normalize(normals)
    ldir = safe_normalize(light_position.reshape((B,) + extra + (3,)) - points)
    cos = (nrm * ldir).sum(-1, keepdim=True)
    amb = col(ambient_color).expand((B,) + extra + (3,))
    diff = col(diffuse_color) * torch.relu(cos)
    vdir = safe_normalize(camera_position.reshape((B,) + extra + (3,)) - points)
    reflect = -ldir + 2.0 * cos * nrm
    alpha = torch.relu((vdir * reflect).sum(-1, keepdim=True)) * (cos > 0).to(dt)
    if isinstance(shininess, (int, float)) and float(shininess) == 0.0:
        spec = col(specular_color) * torch.ones_like(alpha)
    else:
        spec = col(specular_color) * torch.pow(alpha, shininess)
    return amb, diff, spec
