"""Shading (harp_tpu/render/shading.py): UV texture sampling, normal
mapping in a Pixar tangent frame, point-light Phong terms.

- texture sampling: bilinear, align_corners=True, border clamp, v flipped
  (uv origin bottom-left; texture row 0 is the top of the map)
- point light: ambient + diffuse * relu(n.l) + specular * relu(v.r)^shininess
"""

from __future__ import annotations

import torch

from harp_tpu_torch.ops.numerics import safe_normalize
from harp_tpu_torch.render.rasterizer import as_faces


def sample_texture_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W, C) texture at (..., 2) uv in [0, 1]^2 -> (..., C)."""
    H, W = tex.shape[0], tex.shape[1]
    x = torch.clamp(uv[..., 0] * (W - 1), 0.0, W - 1)
    y = torch.clamp((1.0 - uv[..., 1]) * (H - 1), 0.0, H - 1)
    x0 = torch.clamp(torch.floor(x), 0, W - 1)
    y0 = torch.clamp(torch.floor(y), 0, H - 1)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = (x0i + 1).clamp(max=W - 1), (y0i + 1).clamp(max=H - 1)
    t00, t01 = tex[y0i, x0i], tex[y0i, x1i]
    t10, t11 = tex[y1i, x0i], tex[y1i, x1i]
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def interpolate_packed_attrs(verts, normals_v, faces, verts_uvs, faces_uvs,
                             ids, bary) -> torch.Tensor:
    """One-gather interpolation of (position | normal | uv) -> (..., 8)."""
    B = verts.shape[0]
    dev = verts.device
    f = as_faces(faces, dev)
    vuv = torch.as_tensor(verts_uvs, dtype=verts.dtype, device=dev)
    fuv = vuv[as_faces(faces_uvs, dev)]  # (F, 3, 2)
    packed = torch.cat([verts[:, f], normals_v[:, f], fuv.expand(B, -1, -1, -1)], -1)
    safe = ids.long().clamp(min=0).reshape(B, -1, 1).expand(-1, -1, 24)
    g = torch.gather(packed.reshape(B, -1, 24), 1, safe).reshape(ids.shape + (3, 8))
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
