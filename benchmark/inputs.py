"""What a cell runs on, made from --seed and handed to both sides.

From the seed (numpy SeedSequence: any whole number): the model's arrays
(its family's reference constructors), its UV atlas and UV mask, the
36-frame sequence rendered by the reference's plain renderer, the
perturbed initial parameters (the preprocessing output's stand-in) and
the VGG16 filters (drawn on the device). The program builds its own
assets from the arrays through its public constructors
(ops.mesh.build_topology / build_subdivision, the model dataclasses,
AvatarAssets) and its own parameters through fit.params.init_params; the
reference does the same with its frozen copies. The frames, masks and
filters are the same tensors on both sides.

The model family is a file: families/<model>.py, <model> the
configuration's "model" value, loaded by path from the families/ beside
the run module (load_family). It defines

- reference_assets(spec, seed, uv_size): the reference's AvatarAssets;
- program_assets(inputs): the program's AvatarAssets from
  inputs.ref_assets (program_avatar builds them around a model class);
- reference_extras(inputs), program_extras(inputs): the family's statics
  that each side's train step takes as `extras` (HTML's texture basis),
  or None.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np
import torch

from benchmark.reference.config import HarpConfig as RefConfig
from benchmark.reference.data.synthetic import make_synthetic_sequence
from benchmark.reference.losses.perceptual import VGG16_LAYOUT

FAMILIES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "families")


@dataclasses.dataclass
class Inputs:
    spec: dict
    seed: int
    device: torch.device
    family: object  # the module of families/<model>.py
    ref_assets: object
    ref_config: object
    images: torch.Tensor
    masks: torch.Tensor
    masks_eroded: torch.Tensor
    input_params: dict  # numpy: pose, rot, trans, shape, cam, joints
    gt_params: dict  # the parameters the frames were rendered from (tensors)
    vgg_weights: list  # [(w HWIO float32 numpy, b)]


def sub_seeds(seed: int, n: int) -> list:
    """n independent 31-bit seeds from any whole number."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n) >> 1]


def harp_kwargs(spec: dict, traffic: dict | None = None) -> dict:
    """HarpConfig's fields for the cell: the configuration's, with the
    traffic's stages (total_epoch their sum)."""
    kw = dict(spec["harp_config"])
    kw["training_stage"] = tuple(kw.get("training_stage", (100, 100, 100)))
    if traffic is not None and "stages" in traffic:
        kw["training_stage"] = tuple(traffic["stages"])
        kw["total_epoch"] = sum(traffic["stages"])
    return kw


def load_family(model: str, under: str = FAMILIES):
    """The model family `model`: the module of <under>/<model>.py, loaded by
    path (a package import would find whichever benchmark/ was imported
    first)."""
    path = os.path.join(under, model + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"no model family {model!r}: write {path}, defining reference_assets, "
                         "program_assets, reference_extras and program_extras")
    spec = importlib.util.spec_from_file_location("benchmark_family_" + model.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def vgg_weights(seed: int, device) -> list:
    """He-scaled VGG16 filters through relu4_3 in harp_tpu's HWIO layout,
    drawn in one call on the device and copied to the host once (the
    program's Vgg16Features takes numpy pairs); zero biases, as the
    program's random filters have."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shapes, cin = [], 3
    for item in VGG16_LAYOUT:
        if item != "M":
            shapes.append((3, 3, cin, int(item)))
            cin = int(item)
    sizes = [int(np.prod(s)) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device).cpu().numpy()
    out, o = [], 0
    for s, n in zip(shapes, sizes):
        w = flat[o:o + n].reshape(s) * np.float32(np.sqrt(2.0 / (9 * s[2])))
        out.append((w.astype(np.float32), np.zeros(s[3], np.float32)))
        o += n
    return out


def make_inputs(spec: dict, seed: int, device, traffic: dict | None = None,
                families: str = FAMILIES) -> Inputs:
    """The cell's inputs from `seed` on `device`. spec: the configuration
    file's dict; families: the directory of the family files."""
    device = torch.device(device)
    model_seed, seq_seed, vgg_seed = sub_seeds(seed, 3)
    kw = harp_kwargs(spec, traffic)
    config = RefConfig(**kw)
    family = load_family(spec["model"], families)
    assets = family.reference_assets(spec, model_seed, config.texture_size)
    # The ground truth is rendered with every tile (nothing truncated).
    gt_rcfg = config.raster_config(active_fraction=1.0, span_tiles=8)
    images, masks, masks_er, gt, init = make_synthetic_sequence(
        assets, config, gt_rcfg, n_frames=spec["num_frames"], seed=seq_seed,
        device=device, **spec.get("sequence", {}))
    return Inputs(spec, seed, device, family, assets, config, images.contiguous(),
                  masks.contiguous(), masks_er.contiguous(), init, gt,
                  vgg_weights(vgg_seed, device))


def port_assets(inputs: Inputs):
    """The program's AvatarAssets from the same arrays, through its public
    constructors (as its model loaders build them from model files)."""
    return inputs.family.program_assets(inputs)


def program_avatar(ra, model_class):
    """The program's AvatarAssets around model_class, built from the
    reference's AvatarAssets `ra`: the model from the same arrays, the
    topologies and the subdivision through the program's constructors."""
    from harp_tpu_torch.assets import AvatarAssets
    from harp_tpu_torch.ops.mesh import build_subdivision, build_topology

    m = ra.model
    model = model_class(**{f.name: getattr(m, f.name) for f in dataclasses.fields(m)})
    coarse = build_topology(ra.coarse_topology.faces, ra.coarse_topology.num_verts)
    if ra.subdivision is not None:
        sub = build_subdivision(coarse)
        render_faces, n_render = sub.faces, sub.num_verts
    else:
        sub, render_faces, n_render = None, coarse.faces, coarse.num_verts
    return AvatarAssets(model=model, coarse_topology=coarse, subdivision=sub,
                        sub_topology=build_topology(render_faces, n_render),
                        verts_uvs=ra.verts_uvs.copy(), faces_uvs=ra.faces_uvs.copy(),
                        uv_mask=ra.uv_mask.copy())
