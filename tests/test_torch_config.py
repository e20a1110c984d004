"""harp_tpu_torch's HarpConfig / RasterConfig equal harp_tpu's field by
field, and a config.yaml written by either package loads in the other."""

import dataclasses

import pytest

from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.render.rasterizer import RasterConfig


@pytest.mark.parametrize("pair", [(HarpConfig, JHarpConfig), (RasterConfig, JRasterConfig)],
                         ids=["HarpConfig", "RasterConfig"])
def test_defaults_equal_field_by_field(pair):
    ours, theirs = pair
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_derived_values_equal():
    ours, theirs = HarpConfig.reference_exact(), JHarpConfig.reference_exact()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    kw = dict(active_fraction=0.28, cap=448, span_tiles=3)
    r, j = HarpConfig().raster_config(**kw), JHarpConfig().raster_config(**kw)
    assert dataclasses.asdict(r) == dataclasses.asdict(j)
    assert (r.ndc_scale, r.blur_px2) == (j.ndc_scale, j.blur_px2)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_yaml_round_trip_across_packages(tmp_path, direction):
    kw = dict(img_size=64, training_stage=(3, 2, 1), background_color=(0.0, 0.5, 1.0),
              shadow_map_scale=1.0, w_vgg=0.0)
    src, dst = (JHarpConfig, HarpConfig) if direction == "jax_to_torch" else (HarpConfig, JHarpConfig)
    path = str(tmp_path / "config.yaml")
    src(**kw).to_yaml(path)
    loaded = dst.from_yaml(path)
    assert dataclasses.asdict(loaded) == dataclasses.asdict(dst(**kw))
