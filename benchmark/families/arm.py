"""The arm (a configuration's "model": "arm"): the program's procedural
SMPL-X right arm at the configuration's "density", as SmplxArmModel on
both sides. No statics beyond the assets."""

from benchmark.inputs import program_avatar
from benchmark.reference import assets as ref_assets


def reference_assets(spec: dict, seed: int, uv_size: int):
    return ref_assets.build_synthetic_arm_assets(seed=seed, uv_size=uv_size,
                                                 density=spec["density"])


def program_assets(inputs):
    from harp_tpu_torch.models.smplx_arm import SmplxArmModel

    return program_avatar(inputs.ref_assets, SmplxArmModel)


def reference_extras(inputs):
    return None


def program_extras(inputs):
    return None
