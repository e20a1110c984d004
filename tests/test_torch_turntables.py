"""The eval's turntables and light sweep (harp_tpu_torch.utils.viz:
render_360, render_360_light, concat_image_dirs, save_gif) against
harp_tpu's, on CPU, at 32^2 with the light-density hand, 3 views per axis
and 2 lights.

- Files: harp_tpu's listings exactly (JPEG frames and out.gif); a frame
  whose uint8 array is the same in both packages is the same bytes; the
  combination's frames are the JPEGs of the two views as decoded side by
  side.
- Chunked renders (several views a render) are the same bits as one view
  at a time.
- Renders: each view's vertices are the previous view's rotated (harp_tpu's
  float32 scan carry), so the two packages' rotations round apart over
  the views and hard ids may flip at the silhouette. Bound, as
  tests/test_torch_raster.py bounds FMA: per view, at most 0.5% of pixels
  further than 1e-4 from harp_tpu's float render (and of pixels whose
  uint8 codes differ from its view's); every other pixel within 1e-4.
  Views 0, 2, h_0 and h_2 (the first and last of each axis); measured: no
  pixel beyond 1e-4 (largest 5.2e-5), every code equal.
- The GIF, built from the written JPEGs as harp_tpu's save_gif builds its
  own: PIL reads it with the frame count, 100 ms and loop 0; each frame's
  mean abs error to its decoded JPEG is at most that of harp_tpu's GIF of
  the same files (Pillow's quantiser) plus 0.5 codes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from harp_tpu.assets import build_synthetic_assets as jbuild
from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.data.synthetic import make_synthetic_sequence as jmake_sequence
from harp_tpu.render import pipeline as jpipeline
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu.utils import viz as jviz
from harp_tpu_torch import native
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy, params_from_numpy
from harp_tpu_torch.render import pipeline
from harp_tpu_torch.render.rasterizer import RasterConfig
from harp_tpu_torch.utils import viz

IMG, TEX, VIEWS, LIGHTS = 32, 64, 3, 2
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=False)
RCFG_KW = dict(image_size=IMG, tile=8, cap=1024, face_chunk=256, faces_per_pixel=8,
               span_tiles=4, active_fraction=1.0)
SHARE = 0.005  # of a view's pixels that may part from harp_tpu's
HELD = (0, VIEWS - 1, VIEWS, 2 * VIEWS - 1)  # views 0, 2, h_0, h_2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    jassets = jbuild(uv_size=TEX, density="light")
    jconfig, jrcfg = JHarpConfig(**CFG_KW), JRasterConfig(**RCFG_KW)
    _, _, _, gt, _ = jmake_sequence(jassets, jconfig, jrcfg, n_frames=2, seed=0)
    gt = {k: np.asarray(v) for k, v in gt.items()}
    rng = np.random.RandomState(3)  # a texture and a normal map that are not flat
    gt["texture"] = np.clip(gt["texture"] + rng.uniform(-0.2, 0.2, (TEX, TEX, 3)),
                            0, 1).astype(np.float32)
    gt["normal_map"] = gt["normal_map"] + rng.normal(0, 0.2, (TEX, TEX, 3)).astype(np.float32)
    return dict(jassets=jassets, jconfig=jconfig, jrcfg=jrcfg, gt=gt,
                jgt={k: jnp.asarray(v) for k, v in gt.items()},
                assets=assets_from_numpy(jassets), config=HarpConfig(**CFG_KW),
                rcfg=RasterConfig(**RCFG_KW), params=params_from_numpy(gt, "cpu"))


def _jax_float_views(s, render_normal):
    """harp_tpu's turntable before quantisation: its _rotate_about_center
    carry and its renders, one view at a time."""
    fids = jnp.asarray([0])
    v, _ = jpipeline.mesh_forward(s["jgt"], fids, s["jassets"], s["jconfig"])
    R, T = jpipeline.camera_for_frames(s["jgt"], fids, s["jconfig"])
    light = s["jgt"]["light_positions"][fids]

    @jax.jit
    def render(v):
        if render_normal:
            return jpipeline.render_normal(v, s["jassets"], R, T, s["jconfig"], s["jrcfg"])
        return jpipeline.render_rgb(v, s["jassets"], R, T, s["jconfig"], s["jrcfg"],
                                    s["jgt"]["texture"], s["jgt"]["normal_map"], light)

    out = []
    for axis in "YX":
        rotate = jax.jit(lambda v, axis=axis: jviz._rotate_about_center(v, axis, 360.0 / VIEWS))
        for _ in range(VIEWS):
            v = rotate(v)
            out.append(np.asarray(render(v)[0]))
    return np.stack(out)


def _port_float_views(s, render_normal):
    """The port's turntable before quantisation, one view at a time."""
    p, assets, config, rcfg = s["params"], s["assets"], s["config"], s["rcfg"]
    fids = torch.tensor([0])
    out = []
    with torch.no_grad():
        v, _ = pipeline.mesh_forward(p, fids, assets, config)
        R, T = pipeline.camera_for_frames(p, fids, config)
        for axis in "YX":
            for _ in range(VIEWS):
                v = viz._rotate_about_center(v, axis, 360.0 / VIEWS)
                if render_normal:
                    img = pipeline.render_normal(v, assets, R, T, config, rcfg)
                else:
                    img = pipeline.render_rgb(v, assets, R, T, config, rcfg, p["texture"],
                                              p["normal_map"], p["light_positions"][fids])
                out.append(img[0])
    return torch.stack(out)


def test_rotate_about_center_matches_harp_tpu(scene):
    rng = np.random.RandomState(0)
    v = rng.normal(0, 0.05, (2, 50, 3)).astype(np.float32)
    for axis in "XYZ":
        want = np.asarray(jviz._rotate_about_center(jnp.asarray(v), axis, 10.0))
        got = viz._rotate_about_center(torch.from_numpy(v), axis, 10.0).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("render_normal", [False, True])
def test_turntable_matches_harp_tpu_within_the_carry_bound(scene, render_normal):
    s = scene
    ours = _port_float_views(s, render_normal)
    views = viz.turntable_views(s["params"], 0, s["assets"], s["config"], s["rcfg"],
                                render_normal, VIEWS, chunk=1)
    assert torch.equal(viz._quantize_u8(ours), views)  # the same computation
    ours = ours.numpy()
    want = _jax_float_views(s, render_normal)
    want_u8 = np.asarray(jviz._turntable_fn(s["jassets"], s["jconfig"], s["jrcfg"], 0,
                                            render_normal, VIEWS)(s["jgt"]))
    assert ours.shape == want.shape == (2 * VIEWS, IMG, IMG, 3)
    for i in HELD:
        off = np.abs(ours[i] - want[i]).max(-1) > 1e-4
        assert off.mean() <= SHARE, (i, off.mean())
        np.testing.assert_allclose(ours[i][~off], want[i][~off], rtol=0, atol=1e-4)
        codes = (views[i].numpy() != want_u8[i]).any(-1)
        assert codes.mean() <= SHARE, (i, codes.mean())
    # The views differ from one another, and show the hand over the background.
    u8 = views.numpy()
    assert all(not np.array_equal(u8[i], u8[i + 1]) for i in range(2 * VIEWS - 1))
    assert (u8 == 255).any() and (u8 < 250).any()


def test_chunked_renders_are_one_view_at_a_time(scene):
    s = scene
    args = (s["params"], 0, s["assets"], s["config"], s["rcfg"])
    for normal in (False, True):
        one = viz.turntable_views(*args, normal, VIEWS, chunk=1)
        for chunk in (4, 2 * VIEWS):
            assert torch.equal(viz.turntable_views(*args, normal, VIEWS, chunk=chunk), one)
    one = viz.light_sweep_views(*args, num=LIGHTS, chunk=1)
    assert torch.equal(viz.light_sweep_views(*args, num=LIGHTS, chunk=LIGHTS), one)
    assert not torch.equal(one[0], one[1])


def test_light_sweep_matches_harp_tpu(scene):
    s = scene
    ours = viz.light_sweep_views(s["params"], 0, s["assets"], s["config"], s["rcfg"],
                                 num=LIGHTS).numpy()
    want = np.asarray(jviz._light_sweep_fn(s["jassets"], s["jconfig"], s["jrcfg"], 0, LIGHTS,
                                           (-5.0, 5.0))(s["jgt"]))
    assert ours.shape == want.shape == (LIGHTS, IMG, IMG, 3)
    for i in range(LIGHTS):
        assert (ours[i] != want[i]).any(-1).mean() <= SHARE, i


def test_render_360_writes_harp_tpus_files_and_gifs(scene, tmp_path):
    s = scene
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    counters = {}
    outs, same = [], 0
    for normal in (False, True):
        want = jviz.render_360(s["jgt"], 0, s["jassets"], s["jconfig"], s["jrcfg"], jdir,
                               render_normal=normal, views_per_axis=VIEWS)
        got = viz.render_360(s["params"], 0, s["assets"], s["config"], s["rcfg"], pdir,
                             render_normal=normal, views_per_axis=VIEWS, counters=counters)
        assert os.path.basename(got) == os.path.basename(want)
        assert sorted(os.listdir(got)) == sorted(os.listdir(want))
        # Where the two packages' uint8 views are equal, so are the files.
        ours = viz.turntable_views(s["params"], 0, s["assets"], s["config"], s["rcfg"],
                                   normal, VIEWS).numpy()
        theirs = np.asarray(jviz._turntable_fn(s["jassets"], s["jconfig"], s["jrcfg"], 0,
                                               normal, VIEWS)(s["jgt"]))
        for i in range(2 * VIEWS):
            name = ("" if i < VIEWS else "h_") + "%04d.jpg" % (i % VIEWS)
            with open(os.path.join(got, name), "rb") as f, open(os.path.join(want, name),
                                                                 "rb") as g:
                if np.array_equal(ours[i], theirs[i]):
                    assert f.read() == g.read(), name
                    same += 1
        outs.append(got)
    assert same >= 2 * VIEWS  # the measured case: every view's codes equal
    assert counters and not any(counters.values())
    jviz.concat_image_dirs(*[os.path.join(jdir, os.path.basename(o)) for o in outs],
                           os.path.join(jdir, "render_360_combine"))
    viz.concat_image_dirs(*outs, os.path.join(pdir, "render_360_combine"))
    want_l = jviz.render_360_light(s["jgt"], 0, s["jassets"], s["jconfig"], s["jrcfg"], jdir,
                                   num=LIGHTS)
    got_l = viz.render_360_light(s["params"], 0, s["assets"], s["config"], s["rcfg"], pdir,
                                 num=LIGHTS)
    for sub in ("render_360_combine", "render_360_light"):
        assert sorted(os.listdir(os.path.join(pdir, sub))) == sorted(
            os.listdir(os.path.join(jdir, sub)))
    assert got_l.endswith("render_360_light") and want_l.endswith("render_360_light")
    # The combination: the two views' JPEGs decoded side by side, encoded
    # again; harp_tpu's bytes wherever its two inputs are the port's bytes.
    for i, name in enumerate(["0000.jpg", "0001.jpg", "0002.jpg", "h_0000.jpg"]):
        comb = os.path.join("render_360_combine", "%04d.jpg" % i)
        with open(os.path.join(pdir, comb), "rb") as f:
            data = f.read()
        parts = [viz.read_rgb(os.path.join(o, name)) for o in outs]
        assert data == native.jpeg_bytes(np.concatenate(parts, 1), 75)
        inputs = [os.path.join(d, os.path.basename(o), name) for o in outs
                  for d in (pdir, jdir)]
        if all(open(a, "rb").read() == open(b, "rb").read()
               for a, b in zip(inputs[::2], inputs[1::2])):
            with open(os.path.join(jdir, comb), "rb") as f:
                assert data == f.read(), comb


def _gif_errors(path, frames):
    g = Image.open(path)
    assert g.n_frames == len(frames)
    errs = []
    for i, frame in enumerate(frames):
        g.seek(i)
        assert g.info["duration"] == 100 and g.info["loop"] == 0
        errs.append(np.abs(np.asarray(g.convert("RGB")).astype(float) - frame).mean())
    return np.asarray(errs)


@pytest.mark.parametrize("kind", ["render", "many_colours"])
def test_gif_is_within_pils_own_error(scene, tmp_path, kind):
    """Rendered views (a decoded JPEG of at most 256 colours is held
    exactly), and large frames of many colours (median cut; codes of 9 to
    12 bits and clear codes in the LZW stream)."""
    d = tmp_path / "frames"
    if kind == "render":
        frames = viz.turntable_views(scene["params"], 0, scene["assets"], scene["config"],
                                     scene["rcfg"], views_per_axis=VIEWS).numpy()
    else:
        yy, xx = np.mgrid[:160, :200]
        rng = np.random.RandomState(1)
        frames = np.stack([np.stack([(xx + 9 * i) % 256, yy % 256, (xx * yy >> 5) % 256], -1)
                           + rng.randint(0, 8, (160, 200, 3)) for i in range(3)])
        frames = np.clip(frames, 0, 255).astype(np.uint8)
        frames[:, 100:, 100:] = 255  # a flat region: long LZW strings
    for i, f in enumerate(frames):
        viz.save_image(f, str(d / f"{i:04d}.jpg"))
    decoded = np.stack([np.asarray(Image.open(d / f"{i:04d}.jpg")) for i in range(len(frames))])
    np.testing.assert_array_equal(decoded, np.stack([viz.read_rgb(str(d / f"{i:04d}.jpg"))
                                                     for i in range(len(frames))]))
    viz.save_gif(str(d), str(tmp_path / "port.gif"))
    jviz.save_gif(str(d), str(tmp_path / "pil.gif"))
    ours = _gif_errors(tmp_path / "port.gif", decoded.astype(float))
    theirs = _gif_errors(tmp_path / "pil.gif", decoded.astype(float))
    assert np.all(ours <= theirs + 0.5), (ours, theirs)
    few = [len(np.unique(f.reshape(-1, 3), axis=0)) <= 256 for f in decoded]
    # JPEG-decoded views: some keep at most 256 colours (held exactly), none
    # of the many-colour frames does (median cut).
    assert any(few) == (kind == "render")
    assert ours[few].max(initial=0.0) == 0.0
