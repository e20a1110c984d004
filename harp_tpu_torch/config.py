"""Configuration for harp_tpu_torch: a field-for-field copy of harp_tpu's
HarpConfig, so a config.yaml written by either package loads in the other.

Fields that select a harp_tpu backend or a part not ported
(pcf_backend, pcf_grad_tiles, checkpoint_backend) are carried for that
parity; the port's dispatch is by tensor device (see render/kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import yaml

from harp_tpu_torch.render.rasterizer import RasterConfig


@dataclasses.dataclass(frozen=True)
class HarpConfig:
    # Model
    use_arm: bool = False
    model_type: str = "harp"  # ["harp", "html", "nimble"] — harp is primary
    use_vert_disp: bool = True
    vert_disp_normals: bool = True  # 1-D displacement along vertex normals

    # Camera / images
    img_size: int = 448
    focal_length: float = 2000.0

    # Rendering
    self_shadow: bool = True
    share_light_position: bool = True
    texture_size: int = 512
    background_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # Phong light colors (renderer_helper.py:70-73)
    ambient_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    diffuse_color: Tuple[float, float, float] = (0.4, 0.4, 0.4)
    specular_color: Tuple[float, float, float] = (0.1, 0.1, 0.1)
    # Specular exponent of the NON-shadow phong path: the reference uses
    # default pytorch3d Materials (renderer_helper.py:264) whose shininess
    # is 64 (pbr_materials.py:18). The shadow path zeroes specular entirely
    # (renderer_helper.py:441) and never sees this.
    shininess: float = 64.0
    # Raster tile budget (1.0 = all tiles). Large-image hand fits can set
    # ~0.5: the subject occupies a minority of tiles (overflow reported).
    raster_active_fraction: float = 1.0
    # Per-tile face-list capacity (overflow is counted in bin_overflow).
    raster_cap: int = 448
    # Pair-expansion span: 3 is exact for the reference-density meshes
    # (probed zero truncation, triangles ~8 px) and ~2x cheaper binning
    # sorts than 4; truncation is loud via bin_overflow if a scene ever
    # needs more.
    raster_span_tiles: int = 3
    # Soft-id list depth K. 8 is gradient-exact to 3.3e-5 vs an all-faces
    # brute force (tests/test_grad_fidelity.py); the reference uses
    # K=50 (renderer_helper.py:47) — reference_exact() restores that.
    raster_faces_per_pixel: int = 8
    shadow_bias: float = 0.008
    # Light-view depth-map resolution relative to the image (1.0 = the
    # reference's full-resolution shadow pass).
    shadow_map_scale: float = 0.5
    shadow_sharpness: float = 1000.0
    # harp_tpu's band-compacted PCF backward budget; 0 = dense scatter, the
    # only mode the port has (render/kernels/pcf_grad_kernel.py).
    pcf_grad_tiles: int = 0
    # harp_tpu's PCF backend switch; the port dispatches by tensor device.
    pcf_backend: str = "auto"
    shadow_light_radius: float = 1.5

    # Optimization (reference driver defaults)
    total_epoch: int = 301
    training_stage: Tuple[int, int, int] = (100, 100, 100)
    batch_size: int = 18
    known_appearance: bool = False
    pose_already_opt: bool = False
    opt_arm_pose: bool = False
    lr_pose: float = 1.0e-3
    lr_app: float = 1.0e-2
    plateau_patience: int = 40
    plateau_factor: float = 0.1

    # Loss weights (optimize_sequence.py:411-422)
    w_silhouette: float = 7.0
    w_kps_anchor: float = 10.0
    w_vert_disp_reg: float = 2.0
    w_normal: float = 0.1
    w_laplacian: float = 4.0
    w_arap: float = 0.2
    w_photo: float = 1.0
    w_vgg: float = 1.0
    w_albedo: float = 0.5
    w_normal_reg: float = 0.1
    # VGG perceptual loss settings (losses/perceptual.py; the GT pyramid
    # cache is made once per sequence by fit_sequence). vgg_remat: False
    # never runs the VGG forward again in the backward; True runs it again
    # where memory requires it: on a CUDA device where what the backward
    # would keep does not fit in the free memory with its headroom
    # (perceptual.recompute, chosen by the TrainStep), and always where no
    # free-memory figure can be read (the CPU). The same bits either way.
    vgg_weights: str = ""
    vgg_chunk: int = 6
    vgg_compute_dtype: str = "bfloat16"
    vgg_remat: bool = True
    vgg_cache_gt: bool = True
    vgg_cache_max_frames: int = 48
    checkpoint_backend: str = "pickle"

    # Data / paths
    metro_output_dir: str = ""
    image_dir: str = ""
    base_output_dir: str = "exp/out/"
    start_from: str = ""
    use_smooth_seq: bool = True
    average_cam_sequence: bool = False
    eval_mesh: bool = False
    gt_mesh_dir: str = ""

    def raster_config(self, **overrides) -> RasterConfig:
        kw = dict(
            image_size=self.img_size,
            active_fraction=self.raster_active_fraction,
            cap=self.raster_cap,
            span_tiles=self.raster_span_tiles,
            faces_per_pixel=self.raster_faces_per_pixel,
        )
        kw.update(overrides)
        return RasterConfig(**kw)

    @classmethod
    def reference_exact(cls, **overrides) -> "HarpConfig":
        """One-flag reproduction of the reference's numeric semantics.

        The fast-path defaults deviate from the reference in five measured,
        individually-toggleable ways; this constructor flips them all back
        in one place (each cited to the reference constant it restores):

        - shadow_map_scale=1.0 — full-resolution light-view depth map
          (renderer_helper.py renders the light pass at image size).
        - vgg_compute_dtype="float32" + vgg_cache_gt=False — the f32 torch
          VGG16 forward on BOTH sides, recomputed every step
          (model/vgg.py; optimize_sequence.py:546-547).
        - raster_faces_per_pixel=50 — the soft-id list depth
          (renderer_helper.py:47, faces_per_pixel=50).
        - raster_span_tiles=4 — the conservative binning span (no
          known-small-triangle assumption).
        - raster_active_fraction=1.0 — every tile rasterized, no
          occupancy budget.

        The tile cap stays at its default: it is an exactness-preserving
        buffer bound (overflow is loud), not a semantic deviation.
        """
        kw = dict(
            shadow_map_scale=1.0,
            vgg_compute_dtype="float32",
            vgg_cache_gt=False,
            raster_faces_per_pixel=50,
            raster_span_tiles=4,
            raster_active_fraction=1.0,
        )
        kw.update(overrides)
        return cls(**kw)

    def to_yaml(self, path: str) -> None:
        # Tuples must dump as plain YAML lists: yaml.dump would tag them
        # !!python/tuple, which from_yaml's safe_load (correctly) refuses —
        # a dumped config.yaml would be unreadable by its own loader.
        d = {k: list(v) if isinstance(v, tuple) else v
             for k, v in dataclasses.asdict(self).items()}
        with open(path, "w") as f:
            yaml.dump(d, f)

    @classmethod
    def from_yaml(cls, path: str) -> "HarpConfig":
        with open(path) as f:
            d = yaml.safe_load(f)
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**d)
