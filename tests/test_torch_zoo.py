"""harp_tpu_torch's model zoo (HTML's texture basis, NIMBLE, load_hand_model
and the model-file loaders) vs harp_tpu's, on CPU.

- TextureBasis.texture and its gradient: rtol 1e-5 (101 coefficients
  summed in another order).
- nimble_forward (skin, muscle, bone; with a global scale), nimble_to_mano
  and mano_protocol_joints: vertices and joints atol 1e-3 mm; the gradient
  of the regression (every skin vertex feeds two MANO vertices) rtol 1e-5.
- load_hand_model(synthetic=True) for harp, the arm, HTML and NIMBLE: every
  array equal.
- One 32^2 HTML step and one 32^2 NIMBLE step against harp_tpu's: loss
  breakdown rtol 1e-4, gradients within 1e-3 of each leaf's largest entry,
  parameters after the update within 1e-2 * lr (tests/test_torch_step.py's
  tolerances). K = 16 soft ids hold every within-blur face (checked).
  harp_tpu's steps are read from tests/golden/harp_tpu_zoo_step_*.npz.
- The registration-gated files missing: FileNotFoundError, as harp_tpu.
- Every loader on files the test writes (a MANO pickle holding
  chumpy-style objects, OBJs with UVs, an SMPL-X npz and its arm
  correspondence pickle, HTML's texture pickle, NIMBLE's dict and
  regression pickles, PNG uv masks): the same arrays as harp_tpu's; the PNG
  reader equal to PIL's read.
"""

import dataclasses
import io
import os
import pickle
import struct
import sys
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.fit import init_params as jinit_params
from harp_tpu.fit.driver import compute_losses as jcompute_losses
from harp_tpu.fit.optimizer import build_optimizers as jbuild_optimizers
from harp_tpu.models import html as jhtml
from harp_tpu.models import nimble as jnimble
from harp_tpu.models.zoo import load_hand_model as jload_hand_model
from harp_tpu.render import pipeline as jpipeline
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy, extras_from_numpy
from harp_tpu_torch.fit.driver import OVERFLOW_KEYS, make_train_step
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.models import html, nimble
from harp_tpu_torch.models.zoo import load_hand_model
from harp_tpu_torch.render import pipeline
from harp_tpu_torch.render.rasterizer import RasterConfig
from harp_tpu_torch.utils import viz

import _harp_goldens as goldens

IMG, TEX, K = 32, 16, 16
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=True, w_vgg=0.0, batch_size=2)
RCFG_KW = dict(image_size=IMG, tile=8, cap=1024, face_chunk=256, faces_per_pixel=K,
               span_tiles=4, active_fraction=1.0)

# The step parity tolerances of the docstring, which the golden's regenerator
# reads too.
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-7
GRAD_TOL = 1e-3  # of each leaf's largest entry
PARAM_TOL = 1e-2  # of the larger learning rate


def _assert_same(ours, theirs, path="x"):
    """Every dataclass field of `theirs` equal in `ours`, recursively."""
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(b):
            _assert_same(a, b, f"{path}.{f.name}")
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{path}.{f.name}"
        else:
            assert a == b, f"{path}.{f.name}"


def test_texture_basis_texture_and_gradient_match_harp_tpu():
    jb = jhtml.synthetic_texture_basis(size=32, num_coeffs=101)
    b = html.synthetic_texture_basis(size=32, num_coeffs=101)
    _assert_same(b, jb)
    rng = np.random.RandomState(0)
    c = (0.5 * rng.randn(101)).astype(np.float32)
    w = rng.randn(32, 32, 3).astype(np.float32)
    jtex, jg = np.asarray(jb.texture(jnp.asarray(c))), np.asarray(
        jax.grad(lambda x: (jb.texture(x) * w).sum())(jnp.asarray(c)))
    t = torch.from_numpy(c).requires_grad_(True)
    tex = b.texture(t)
    (tex * torch.from_numpy(w)).sum().backward()
    assert tex.shape == (32, 32, 3)
    np.testing.assert_allclose(tex.detach().numpy(), jtex, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())
    batched = b.texture(torch.from_numpy(np.stack([c, -c])))
    assert batched.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(batched[1].detach().numpy(), np.asarray(
        jb.texture(-jnp.asarray(c))), rtol=1e-5, atol=1e-6)


NIMBLE_J = jnimble.build_synthetic_nimble()


@pytest.fixture(scope="module")
def nimble_model():
    model = nimble.build_synthetic_nimble()
    _assert_same(model, NIMBLE_J)
    return model


@pytest.mark.parametrize("layer,scale", [("skin", None), ("muscle", None), ("bone", None),
                                         ("skin", 1.3)])
def test_nimble_forward_matches_harp_tpu(nimble_model, layer, scale):
    rng = np.random.RandomState(1)
    pose = (0.3 * rng.randn(2, 33)).astype(np.float32)
    betas = (0.5 * rng.randn(2, 20)).astype(np.float32)
    trans = (0.05 * rng.randn(2, 3)).astype(np.float32)
    jv, jj = jnimble.nimble_forward(NIMBLE_J, jnp.asarray(pose), jnp.asarray(betas),
                                    jnp.asarray(trans), global_scale=scale, layer=layer)
    v, j = nimble.nimble_forward(nimble_model, torch.from_numpy(pose), torch.from_numpy(betas),
                                 torch.from_numpy(trans), global_scale=scale, layer=layer)
    assert v.shape == jv.shape and j.shape == jj.shape == (2, 16, 3)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-3)
    np.testing.assert_allclose(j.numpy(), np.asarray(jj), rtol=0, atol=1e-3)


def test_nimble_to_mano_and_protocol_joints_match_harp_tpu(nimble_model):
    rng = np.random.RandomState(2)
    skin = (100.0 * rng.randn(2, nimble_model.num_verts, 3)).astype(np.float32)
    w = rng.randn(2, 21, 3).astype(np.float32)

    def jloss(s):
        return (jnimble.mano_protocol_joints(NIMBLE_J, jnimble.nimble_to_mano(NIMBLE_J, s))
                * w).sum()

    jm = np.asarray(jnimble.nimble_to_mano(NIMBLE_J, jnp.asarray(skin)))
    jj = np.asarray(jnimble.mano_protocol_joints(NIMBLE_J, jnp.asarray(jm)))
    jg = np.asarray(jax.grad(jloss)(jnp.asarray(skin)))
    s = torch.from_numpy(skin).requires_grad_(True)
    m = nimble.nimble_to_mano(nimble_model, s)
    j = nimble.mano_protocol_joints(nimble_model, m)
    (j * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(m.detach().numpy(), jm, rtol=0, atol=1e-3)
    np.testing.assert_allclose(j.detach().numpy(), jj, rtol=0, atol=1e-3)
    np.testing.assert_allclose(s.grad.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("family", ["harp", "arm", "html", "nimble"])
def test_load_hand_model_synthetic_equals_harp_tpu(family):
    kw = dict(texture_size=32, use_arm=family == "arm",
              model_type=family if family in ("html", "nimble") else "harp")
    assets, extras = load_hand_model(HarpConfig(**kw), synthetic=True)
    jassets, jextras = jload_hand_model(JHarpConfig(**kw), synthetic=True)
    assert type(assets.model).__name__ == type(jassets.model).__name__
    _assert_same(assets, jassets)
    assert set(extras) == set(jextras)
    for k in jextras:
        _assert_same(extras[k], jextras[k])
    if family in ("html", "nimble"):
        assert assets.subdivision is None


def _scene(pose_dim, shape_dim):
    rng = np.random.RandomState(0)
    n = 2
    init = {
        "pose": 0.2 * rng.randn(n, pose_dim), "rot": 0.05 * rng.randn(n, 3),
        "trans": np.zeros((n, 3)), "shape": 0.1 * rng.randn(n, shape_dim),
        "cam": np.tile([6.0, -0.08, -0.01], (n, 1)),
        "joints": 10.0 * rng.randn(n, 21, 3),
    }
    yy, xx = np.mgrid[0:IMG, 0:IMG]
    masks = np.stack([((yy - 15.5) ** 2 + (xx - 14.5 - 2 * b) ** 2 < 64).astype(np.float32)
                      for b in range(n)])
    masks_er = np.stack([((yy - 15.5) ** 2 + (xx - 14.5 - 2 * b) ** 2 < 36).astype(np.float32)
                         for b in range(n)])
    images = rng.uniform(0, 1, (n, IMG, IMG, 3)).astype(np.float32)
    appearance = {"normal_map": rng.normal(0, 0.2, (TEX, TEX, 3)) + [0.0, 0.0, 1.0],
                  "html_texture": 0.3 * rng.randn(101)}
    return init, images, masks, masks_er, {k: v.astype(np.float32) for k, v in appearance.items()}


def _zoo_scene(family):
    jconfig = JHarpConfig(pcf_backend="pallas_interpret", model_type=family, **CFG_KW)
    jassets, jextras = jload_hand_model(jconfig, synthetic=True)
    model = jassets.model
    init, images, masks, masks_er, appearance = _scene(
        getattr(model, "ncomps", 45), model.shapedirs.shape[2])
    appearance = {k: v for k, v in appearance.items() if family == "html" or k != "html_texture"}
    return jconfig, jassets, jextras, init, images, masks, masks_er, appearance


def _harp_tpu_zoo_step(family) -> dict:
    """harp_tpu's stage-2 step of `family` (its loss, gradient and both Adam
    groups in one jit), the golden harp_tpu_zoo_step_<family>.npz: its
    total and loss terms, its gradients and the updated parameters."""
    jconfig, jassets, jextras, init, images, masks, masks_er, appearance = _zoo_scene(family)
    jrcfg = JRasterConfig(**RCFG_KW)
    jparams, jaux = jinit_params(init, jassets, jconfig)
    jparams.update({k: jnp.asarray(v) for k, v in appearance.items()})
    fids = np.arange(2)
    jref = jpipeline.mesh_forward(jparams, jnp.asarray([0]), jassets, jconfig)[0][0]
    key = jax.random.PRNGKey(3)
    data = [jnp.asarray(a) for a in (images, masks, masks_er)]
    txs, states, _ = jbuild_optimizers(jparams, jconfig)

    @jax.jit
    def jstep(p, st):
        (total, br), g = jax.value_and_grad(
            lambda q: jcompute_losses(q, jaux, jnp.asarray(fids), *data, jassets, jconfig,
                                      jrcfg, None, jref, key, True, True, jextras),
            has_aux=True)(p)
        for group in ("coarse", "app"):
            upd, _ = txs[group].update(g, st[group], p)
            p = optax.apply_updates(p, upd)
        return total, br, g, p

    jtotal, jbr, jgrads, jnew = jstep(jparams, states)
    return goldens.pack(total=jtotal, loss=jbr, grad=jgrads, new=jnew)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["html", "nimble"])
def test_harp_tpu_golden_of_the_zoo_step_is_current(family):
    config = HarpConfig(model_type=family, **CFG_KW)
    lr = max(config.lr_pose, config.lr_app)

    def tolerance(k, want):  # test_zoo_step_matches_harp_tpu's three checks
        if k == "total" or k.startswith("loss."):
            return LOSS_ATOL + LOSS_RTOL * np.abs(want)
        if k.startswith("grad."):
            return GRAD_TOL * max(np.abs(want).max(), 1e-12)
        if k.startswith("new."):
            return PARAM_TOL * lr
        return None

    fresh = _harp_tpu_zoo_step(family)
    goldens.assert_current(f"harp_tpu_zoo_step_{family}", fresh, tolerance)


def _step_both(family):
    """One stage-2 step of `family` in both packages from one state:
    harp_tpu's stored (_harp_tpu_zoo_step), the port's from its key."""
    _, jassets, jextras, init, images, masks, masks_er, appearance = _zoo_scene(family)
    config = HarpConfig(model_type=family, **CFG_KW)
    assets, extras = assets_from_numpy(jassets), extras_from_numpy(jextras)
    rcfg = RasterConfig(**RCFG_KW)
    theirs = goldens.load(f"harp_tpu_zoo_step_{family}")
    fids = np.arange(2)
    key = jax.random.PRNGKey(3)

    params, aux = init_params(init, assets, config, device="cpu")
    with torch.no_grad():
        for k, v in appearance.items():
            params[k].copy_(torch.from_numpy(v))
    ref = pipeline.mesh_forward(params, torch.arange(1), assets, config)[0][0].detach()
    fids_t = torch.from_numpy(fids)
    with torch.no_grad():
        verts, _ = pipeline.mesh_forward(params, fids_t, assets, config)
        R, T = pipeline.camera_for_frames(params, fids_t, config)
        _, rout = pipeline.raster_camera_view_compact(verts, assets, R, T, config, rcfg)
    old = {k: v.detach().clone() for k, v in params.items()}
    step = make_train_step(assets, config, rcfg, params, device="cpu", extras=extras)
    total, br = step(aux, fids_t, *[torch.from_numpy(a) for a in (images, masks, masks_er)],
                     ref, coarse_on=True, app_on=True, key=np.asarray(key, np.uint32))
    return dict(jtotal=theirs["total"], jbr=goldens.part(theirs, "loss"),
                jgrads=goldens.part(theirs, "grad"), jnew=goldens.part(theirs, "new"),
                total=total, br=br, params=params, old=old, rout=rout, config=config)


@pytest.fixture(scope="module")
def html_step():
    return _step_both("html")


@pytest.fixture(scope="module")
def nimble_step():
    return _step_both("nimble")


@pytest.mark.parametrize("check", ["losses", "gradients", "parameters"])
@pytest.mark.parametrize("family", ["html", "nimble"])
def test_zoo_step_matches_harp_tpu(request, family, check):
    both = request.getfixturevalue(f"{family}_step")
    if check == "losses":
        assert (both["rout"]["soft_ids"][..., -1] == -1).all(), "K too small for this scene"
        jbr, br = both["jbr"], both["br"]
        assert set(br) == set(jbr)
        assert not {"albedo", "normal_reg"} & set(br)  # neither family has them
        assert ("kps_anchor" in br) == (family == "html")  # NIMBLE has no anchor
        for k in OVERFLOW_KEYS:
            assert float(br[k]) == float(jbr[k]) == 0.0, k
        for k in jbr:
            np.testing.assert_allclose(float(br[k]), float(jbr[k]), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=k)
        np.testing.assert_allclose(float(both["total"]), float(both["jtotal"]), rtol=LOSS_RTOL)
        assert float(br["silhouette"]) > 0 and float(br["photo"]) > 0
    elif check == "gradients":
        for k, p in both["params"].items():
            want = np.asarray(both["jgrads"][k])
            got = p.grad.numpy() if p.grad is not None else np.zeros_like(want)
            assert np.abs(got - want).max() <= GRAD_TOL * max(np.abs(want).max(), 1e-12), k
        if family == "html":
            assert np.abs(np.asarray(both["jgrads"]["html_texture"])).max() > 0
    else:
        lr = max(both["config"].lr_pose, both["config"].lr_app)
        for k, p in both["params"].items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(both["jnew"][k]),
                                       rtol=0, atol=PARAM_TOL * lr, err_msg=k)
        moved = {k for k, p in both["params"].items() if not torch.equal(p, both["old"][k])}
        assert ("html_texture" in moved) == (family == "html")
        assert ("texture" in moved) == (family == "nimble")  # HTML's texels stay


@pytest.mark.parametrize("family", ["harp", "arm", "html", "nimble"])
def test_gated_real_files_raise_file_not_found_as_harp_tpu(tmp_path, family):
    kw = dict(use_arm=family == "arm",
              model_type=family if family in ("html", "nimble") else "harp")
    paths = dict(mano_pkl=str(tmp_path / "MANO_RIGHT.pkl"),
                 smplx_npz=str(tmp_path / "SMPLX_NEUTRAL.npz"),
                 nimble_dict=str(tmp_path / "NIMBLE_DICT_9137.pkl"))
    with pytest.raises(FileNotFoundError) as theirs:
        jload_hand_model(JHarpConfig(**kw), **paths)
    with pytest.raises(FileNotFoundError) as ours:
        load_hand_model(HarpConfig(**kw), **paths)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Loaders on files the test writes
# ---------------------------------------------------------------------------


def _png_rows(arr: np.ndarray, filters) -> bytes:
    """An 8-bit grey / RGB(A) PNG whose rows use the given filter types
    (cycled): Average and Paeth, which PIL's writer may not pick, too."""
    h, w = arr.shape[:2]
    bpp = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    prev = np.zeros(w * bpp, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            out = cur
        elif f == 1:
            out = cur - left
        elif f == 2:
            out = cur - prev
        elif f == 3:
            out = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            out = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([f]) + bytes((out & 0xFF).astype(np.uint8))
        prev = cur
    color = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_reads_as_pil_does(tmp_path, channels):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(channels)
    shape = (19, 23) if channels == 1 else (19, 23, channels)
    arr = (np.cumsum(rng.randint(0, 40, shape), 0) % 256).astype(np.uint8)
    for k, data in enumerate([_png_rows(arr, [0, 1, 2, 3, 4])]
                             + ([viz.encode_png(arr)] if channels in (1, 3) else [])):
        path = str(tmp_path / f"m{k}.png")
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(viz.decode_png(data), arr)
        want = np.asarray(Image.open(path).convert("L")).astype(np.float32) / 255.0
        np.testing.assert_array_equal(viz.read_grey(path), want)
    buf = io.BytesIO()  # and what PIL itself writes (its own filter choice)
    Image.fromarray(arr).save(buf, format="PNG")
    np.testing.assert_array_equal(viz.decode_png(buf.getvalue()), arr)


class _ChumpyLike:
    """Pickled under a module named chumpy.ch, as MANO's release pickles
    its arrays; neither package can import that module."""


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """The model files of all four families, written from the synthetic
    models: MANO pickle (chumpy-style arrays, a sparse regressor), hand /
    arm / NIMBLE OBJs with UVs, SMPL-X npz + arm correspondence, HTML's
    texture pickle, NIMBLE's dict and regression pickles, PNG uv masks."""
    import scipy.sparse as sp

    from harp_tpu.assets import build_synthetic_arm, build_synthetic_assets

    d = tmp_path_factory.mktemp("models")
    hand = build_synthetic_assets(uv_size=16, density="light")
    m = hand.model

    fake = types.ModuleType("chumpy.ch")
    fake.Ch = _ChumpyLike
    _ChumpyLike.__module__, _ChumpyLike.__qualname__ = "chumpy.ch", "Ch"
    sys.modules["chumpy"], sys.modules["chumpy.ch"] = types.ModuleType("chumpy"), fake
    try:
        def ch(a):
            obj = _ChumpyLike()
            obj.x = np.asarray(a, np.float64)
            return obj

        mano = {"v_template": ch(m.v_template), "shapedirs": ch(m.shapedirs),
                "posedirs": m.posedirs.astype(np.float64),
                "J_regressor": sp.csc_matrix(m.J_regressor.astype(np.float64)),
                "weights": ch(m.weights), "f": m.faces.astype(np.uint32),
                "kintree_table": np.stack([np.r_[4294967295, m.parents[1:]], np.arange(16)]),
                "hands_components": ch(np.eye(45)), "hands_mean": 0.1 * np.ones(45)}
        with open(d / "MANO_RIGHT.pkl", "wb") as f:
            pickle.dump(mano, f, protocol=2)
    finally:
        del sys.modules["chumpy"], sys.modules["chumpy.ch"]
        _ChumpyLike.__module__, _ChumpyLike.__qualname__ = __name__, "_ChumpyLike"

    def write_obj(path, verts, faces, uvs):
        with open(path, "w") as f:
            f.write("# test mesh\n")
            f.writelines(f"v {x} {y} {z}\n" for x, y, z in verts)
            f.writelines(f"vt {u} {v}\n" for u, v in uvs)
            f.writelines(f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}\n"
                         for a, b, c in faces)

    write_obj(d / "hand.obj", m.v_template, m.faces, hand.verts_uvs[:m.num_verts])
    arm = build_synthetic_arm(density="light")
    n_arm = len(arm.arm_vert_idx)
    rng = np.random.RandomState(5)
    write_obj(d / "arm.obj", arm.v_template[arm.arm_vert_idx], arm.arm_faces,
              rng.uniform(0, 1, (n_arm, 2)))
    shapedirs = np.zeros((arm.num_verts, 3, 310), np.float32)
    shapedirs[:, :, :10] = arm.shapedirs
    shapedirs[:, :, 300:310] = rng.randn(arm.num_verts, 3, 10)
    np.savez(d / "SMPLX_NEUTRAL.npz", v_template=arm.v_template, shapedirs=shapedirs,
             posedirs=arm.posedirs.reshape(-1, arm.posedirs.shape[-1]).T,
             J_regressor=arm.J_regressor, weights=arm.weights,
             hands_meanl=0.1 * np.ones(45), hands_meanr=-0.1 * np.ones(45))
    with open(d / "corr.pkl", "wb") as f:
        pickle.dump({"arm_vert": arm.arm_vert_idx, "mano_vert_from_arm": arm.mano_vert_from_arm,
                     "face": arm.arm_faces, "mano_face": arm.mano_faces,
                     "mano_joint": arm.joint_idx}, f)
    with open(d / "html.pkl", "wb") as f:
        pickle.dump({"mean": rng.rand(8 * 8 * 3), "basis": rng.randn(120, 8 * 8 * 3)}, f)
    nm = jnimble.build_synthetic_nimble()
    with open(d / "nimble.pkl", "wb") as f:
        pickle.dump({"vert": nm.v_template, "skin_f": nm.faces, "shape_basis": nm.shapedirs,
                     "pose_basis": nm.pose_basis, "pose_mean": nm.pose_mean, "sw": nm.weights,
                     "jreg": nm.J_regressor, "parent": nm.parents}, f)
    with open(d / "vreg.pkl", "wb") as f:
        pickle.dump({"lmk_faces_idx": nm.mano_vreg_idx, "lmk_bary_coords": nm.mano_vreg_w}, f)
    with open(d / "uv_grey.png", "wb") as f:
        f.write(_png_rows((hand.uv_mask * 255).astype(np.uint8), [0, 1, 2, 3, 4]))
    with open(d / "uv_rgb.png", "wb") as f:
        f.write(_png_rows(rng.randint(0, 256, (16, 16, 3)).astype(np.uint8), [4, 3]))
    return d


@pytest.mark.parametrize("family", ["harp", "arm", "html", "nimble"])
def test_load_hand_model_from_files_equals_harp_tpu(model_files, family):
    pytest.importorskip("PIL.Image")  # harp_tpu reads the uv mask with PIL
    d = model_files
    kw = dict(texture_size=16, use_arm=family == "arm",
              model_type=family if family in ("html", "nimble") else "harp")
    paths = dict(mano_pkl=str(d / "MANO_RIGHT.pkl"), smplx_npz=str(d / "SMPLX_NEUTRAL.npz"),
                 arm_corr=str(d / "corr.pkl"), hand_template=str(d / "hand.obj"),
                 arm_template=str(d / "arm.obj"), nimble_template=str(d / "hand.obj"),
                 hand_uv_mask=str(d / "uv_grey.png"), arm_uv_mask=str(d / "uv_rgb.png"),
                 html_tex_model=str(d / "html.pkl"), nimble_dict=str(d / "nimble.pkl"),
                 nimble_vreg=str(d / "vreg.pkl"))
    assets, extras = load_hand_model(HarpConfig(**kw), **paths)
    jassets, jextras = jload_hand_model(JHarpConfig(**kw), **paths)
    assert type(assets.model).__name__ == type(jassets.model).__name__
    _assert_same(assets, jassets)
    assert set(extras) == set(jextras)
    for k in jextras:
        _assert_same(extras[k], jextras[k])
    if family == "harp":  # the chumpy stubs, the sparse regressor, the parents
        assert np.array_equal(assets.model.J_regressor, jassets.model.J_regressor)
        assert assets.model.parents[0] == -1 and assets.model.hands_mean[0] == np.float32(0.1)
    if family == "arm":
        assert assets.num_render_verts > assets.model.arm_vert_idx.shape[0]  # subdivided
