"""The hand (a configuration's "model": "hand"): the program's procedural
MANO-structured hand at the configuration's "density", as ManoModel on
both sides. No statics beyond the assets."""

from benchmark.inputs import program_avatar
from benchmark.reference import assets as ref_assets


def reference_assets(spec: dict, seed: int, uv_size: int):
    return ref_assets.build_synthetic_assets(seed=seed, uv_size=uv_size, density=spec["density"])


def program_assets(inputs):
    from harp_tpu_torch.models.mano import ManoModel

    return program_avatar(inputs.ref_assets, ManoModel)


def reference_extras(inputs):
    return None


def program_extras(inputs):
    return None
