"""Model-zoo switch (harp_tpu/models/zoo.py): AvatarAssets for each model
family, and the family's extras.

- "harp" (primary): the MANO hand or the SMPL-X arm, subdivided, with UVs;
- "html": MANO + HTML's linear texture basis (extras["texture_basis"]),
  not subdivided;
- "nimble": the NIMBLE skin layer, not subdivided (it is dense already).

The real model files are registration-gated and not in the repository;
`synthetic=True` builds the procedural stand-ins. UV masks are PNGs, read
without an imaging library (utils/viz.read_grey).
"""

from __future__ import annotations

import dataclasses
import os

from harp_tpu_torch.assets import (
    AvatarAssets, build_synthetic_arm_assets, build_synthetic_assets, load_mano_model,
    load_obj_with_uv,
)
from harp_tpu_torch.ops.mesh import build_subdivision, build_topology
from harp_tpu_torch.utils.viz import read_grey


def _assets_from_model(model, faces, num_verts, template_obj: str, uv_mask_path: str,
                       subdivide: bool = True) -> AvatarAssets:
    coarse = build_topology(faces, num_verts)
    if subdivide:
        sub = build_subdivision(coarse)
        render_faces, n_render = sub.faces, sub.num_verts
    else:
        sub, render_faces, n_render = None, coarse.faces, num_verts
    _, _, verts_uvs, faces_uvs = load_obj_with_uv(template_obj)
    return AvatarAssets(
        model=model, coarse_topology=coarse, subdivision=sub,
        sub_topology=build_topology(render_faces, n_render), verts_uvs=verts_uvs,
        faces_uvs=faces_uvs, uv_mask=read_grey(uv_mask_path),
    )


def load_hand_model(config, *, synthetic: bool = False,
                    mano_pkl: str = "mano/models/MANO_RIGHT.pkl",
                    smplx_npz: str = "models/SMPLX_NEUTRAL.npz",
                    arm_corr: str = "template/arm/smplx_arm_corr.pkl",
                    hand_template: str = "template/hand/textured_hand.obj",
                    arm_template: str = "template/arm/arm_template.obj",
                    hand_uv_mask: str = "template/hand/uv_mask.png",
                    arm_uv_mask: str = "template/arm/uv_mask.png",
                    html_tex_model: str = "htmlpth/TextureBasis/model_sr/model.pkl",
                    nimble_dict: str = "nimble/assets/NIMBLE_DICT_9137.pkl",
                    nimble_vreg: str = "nimble/assets/NIMBLE_MANO_VREG.pkl",
                    nimble_template: str = "template/nimble/rand_1_skin.obj"):
    """(assets, extras) of config.model_type (and config.use_arm); extras
    carries the family's statics (HTML's texture basis). A missing model
    file raises FileNotFoundError."""
    extras = {}
    if config.model_type == "nimble":
        from harp_tpu_torch.models.nimble import build_synthetic_nimble, load_nimble_model

        if synthetic:
            # The stand-in shares the synthetic hand's skin topology and
            # UVs; only the driving model differs.
            base = build_synthetic_assets(uv_size=config.texture_size, subdivide=False)
            return dataclasses.replace(base, model=build_synthetic_nimble()), extras
        if not os.path.exists(nimble_dict):
            raise FileNotFoundError(
                f"NIMBLE release not found at {nimble_dict!r} "
                "(registration-gated, https://nimblehand.github.io); pass "
                "nimble_dict/nimble_vreg/nimble_template paths, or use "
                "synthetic=True for the structural stand-in.")
        model = load_nimble_model(nimble_dict, nimble_vreg)
        assets = _assets_from_model(model, model.faces, model.num_verts, nimble_template,
                                    hand_uv_mask, subdivide=False)
        return assets, extras

    if config.model_type == "html":
        from harp_tpu_torch.models.html import load_html_basis, synthetic_texture_basis

        if synthetic:
            assets = build_synthetic_assets(uv_size=config.texture_size, subdivide=False)
            extras["texture_basis"] = synthetic_texture_basis(size=config.texture_size,
                                                              num_coeffs=101)
        else:
            model = load_mano_model(mano_pkl, flat_hand_mean=False)
            assets = _assets_from_model(model, model.faces, model.num_verts, hand_template,
                                        hand_uv_mask, subdivide=False)
            extras["texture_basis"] = load_html_basis(html_tex_model)
        return assets, extras

    # model_type == "harp"
    if synthetic:
        build = build_synthetic_arm_assets if config.use_arm else build_synthetic_assets
        return build(uv_size=config.texture_size), extras
    if config.use_arm:
        from harp_tpu_torch.models.smplx_arm import load_smplx_arm

        model = load_smplx_arm(smplx_npz, arm_corr)
        assets = _assets_from_model(model, model.arm_faces, int(model.arm_vert_idx.shape[0]),
                                    arm_template, arm_uv_mask)
    else:
        model = load_mano_model(mano_pkl, flat_hand_mean=False)
        assets = _assets_from_model(model, model.faces, model.num_verts, hand_template,
                                    hand_uv_mask)
    return assets, extras
