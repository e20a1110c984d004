"""NIMBLE (a configuration's "model": "nimble"): the reference's procedural
stand-in at NIMBLE's published widths (a 5990-vertex skin, 25 joints, 30
pose and 20 shape components, the regression to MANO's surface), not
subdivided, its arrays in the reference's and the program's NimbleModel.
No statics beyond the assets."""

from benchmark.inputs import program_avatar
from benchmark.reference.models import nimble


def reference_assets(spec: dict, seed: int, uv_size: int):
    return nimble.build_published_assets(seed, uv_size)


def program_assets(inputs):
    from harp_tpu_torch.models.nimble import NimbleModel

    return program_avatar(inputs.ref_assets, NimbleModel)


def reference_extras(inputs):
    return None


def program_extras(inputs):
    return None
