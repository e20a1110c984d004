"""Camera, tile-binned rasterizer, shading, shadow and the compact pipeline;
the names harp_tpu.render exports."""

from harp_tpu_torch.render.camera import (
    OPENCV_TO_P3D_R,
    camera_center,
    look_at_rotation,
    screen_from_world,
    view_to_screen,
    weak_perspective_to_translation,
    world_to_view,
)
from harp_tpu_torch.render.rasterizer import (
    RasterConfig,
    barycentrics_of,
    rasterize_hard,
    rasterize_soft,
    soft_alpha_from_ids,
)
