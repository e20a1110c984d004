"""harp_tpu_torch's eval metrics, eval renders, evaluate_sequence (and its
files against harp_tpu's), PNG writer, CLI and --debug-nans, on CPU.

Metrics and renders take the same numpy-seeded inputs in both packages.
Tolerances: IoU equal; L1, SSIM, MS-SSIM and the perceptual proxy rtol
1e-5 (float32 filters summed in other orders); renders (normal and
shadowed colour, 32^2 light-density hand, 2 frames, texture 64^2) within
1e-4 (measured 6.4e-6: the ids are equal, XLA:CPU contracts FMAs;
harp_tpu's renders are read from tests/golden/harp_tpu_eval_renders.npz);
Procrustes and PCK in float64, rtol 1e-10.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harp_tpu.assets import build_synthetic_assets as jbuild
from harp_tpu.config import HarpConfig as JHarpConfig
from harp_tpu.data.synthetic import make_synthetic_sequence as jmake_sequence
from harp_tpu.eval import metrics as JM
from harp_tpu.losses.perceptual import Vgg16Features as JVgg
from harp_tpu.render import pipeline as jpipeline
from harp_tpu.render.rasterizer import RasterConfig as JRasterConfig
from harp_tpu.render.shadow import render_rgb_with_shadow as jrender_rgb_with_shadow
from harp_tpu_torch.config import HarpConfig
from harp_tpu_torch.convert import assets_from_numpy, params_from_numpy
from harp_tpu_torch.eval import metrics as M
from harp_tpu_torch.fit.driver import FitData
from harp_tpu_torch.fit.evaluate import evaluate_sequence
from harp_tpu_torch.fit.params import init_params
from harp_tpu_torch.losses.perceptual import Vgg16Features
from harp_tpu_torch.render import pipeline
from harp_tpu_torch.render.rasterizer import RasterConfig
from harp_tpu_torch.render.shadow import render_rgb_with_shadow
from harp_tpu_torch.utils import viz

import _harp_goldens as goldens

IMG, TEX = 32, 64
CFG_KW = dict(img_size=IMG, focal_length=2000.0 * IMG / 448, texture_size=TEX,
              self_shadow=True, batch_size=2)
RCFG_KW = dict(image_size=IMG, tile=8, cap=1024, face_chunk=256, faces_per_pixel=16,
               span_tiles=4, active_fraction=1.0)
RENDER_ATOL = 1e-4  # the renders' parity tolerance, which the golden's regenerator reads too


def _images(size, seed=0, n=2):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    return x, y


def _masks(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, 1, (2, IMG, IMG)).astype(np.float32),
            rng.uniform(0, 1, (2, IMG, IMG)).astype(np.float32))


def _metric(name):
    x, y = _images(IMG)
    ma, mb = _masks()
    t = torch.from_numpy
    if name == "iou":
        return M.iou_per_frame(t(ma), t(mb)).numpy(), np.asarray(JM.iou_per_frame(ma, mb))
    if name == "l1":
        return M.l1_per_frame(t(x), t(y)).numpy(), np.asarray(JM.l1_per_frame(x, y))
    if name == "ssim":
        return M.ssim(x, y), JM.ssim(x, y)
    if name == "ms_ssim_32":  # 2 scales, weights renormalised
        return M.ms_ssim_per_frame(t(x), t(y)).numpy(), np.asarray(JM.ms_ssim_per_frame(x, y))
    if name == "ms_ssim_176":  # all 5 scales
        x, y = _images(176, seed=1)
        return M.ms_ssim_per_frame(t(x), t(y)).numpy(), np.asarray(JM.ms_ssim_per_frame(x, y))
    if name == "perceptual":
        with torch.no_grad():
            got = M.perceptual_per_frame(Vgg16Features.create(device="cpu"), t(x), t(y))
        return got.numpy(), np.asarray(JM.perceptual_per_frame(JVgg.create(), x, y))
    if name == "image_eval":
        batch = {"ref_image": [x[:1], x[1:]], "pred_image": y, "ref_mask": ma, "pred_mask": mb}
        ours = M.image_eval(batch, Vgg16Features.create(device="cpu"))
        theirs = JM.image_eval(batch, JVgg.create())
        assert set(ours) == set(theirs) == {"Silhouette IoU", "L1", "LPIPS_proxy", "MS_SSIM"}
        return [ours[k] for k in sorted(theirs)], [theirs[k] for k in sorted(theirs)]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["iou", "l1", "ssim", "ms_ssim_32", "ms_ssim_176",
                                  "perceptual", "image_eval"])
def test_image_metric_matches_harp_tpu(name):
    got, want = _metric(name)
    if name == "iou":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_procrustes_and_pck_match_harp_tpu():
    rng = np.random.RandomState(4)
    a = rng.randn(21, 3)
    b = 1.3 * a @ np.linalg.qr(rng.randn(3, 3))[0].T + 0.5 + 0.01 * rng.randn(21, 3)
    np.testing.assert_allclose(M.align_w_scale(a, b), JM.align_w_scale(a, b), rtol=1e-10)
    tr = M.align_w_scale(a, b, return_trafo=True)
    np.testing.assert_allclose(M.align_by_trafo(b, tr),
                               JM.align_by_trafo(b, JM.align_w_scale(a, b, return_trafo=True)),
                               rtol=1e-10)
    valid = rng.uniform(size=21) > 0.2
    assert M.procrustes_joint_error(a, b, valid) == pytest.approx(
        JM.procrustes_joint_error(a, b, valid), rel=1e-10)
    ours, theirs = M.EvalUtil(), JM.EvalUtil()
    for _ in range(3):
        gt, pred, vis = rng.randn(21, 3), rng.randn(21, 3), rng.uniform(size=21) > 0.1
        ours.feed(gt, vis, pred)
        theirs.feed(gt, vis, pred)
    for o, t in zip(ours.get_measures(0.0, 3.0, 20), theirs.get_measures(0.0, 3.0, 20)):
        np.testing.assert_allclose(o, t, rtol=1e-10)


@pytest.fixture(scope="module")
def scene():
    jassets = jbuild(uv_size=TEX, density="light")
    jconfig, jrcfg = JHarpConfig(**CFG_KW), JRasterConfig(**RCFG_KW)
    _, _, _, gt, _ = jmake_sequence(jassets, jconfig, jrcfg, n_frames=2, seed=0)
    gt = {k: np.asarray(v) for k, v in gt.items()}
    rng = np.random.RandomState(3)  # a normal map that is not flat
    gt["normal_map"] = gt["normal_map"] + rng.normal(0, 0.2, (TEX, TEX, 3)).astype(np.float32)
    return dict(jassets=jassets, jconfig=jconfig, jrcfg=jrcfg, gt=gt,
                assets=assets_from_numpy(jassets), config=HarpConfig(**CFG_KW),
                rcfg=RasterConfig(**RCFG_KW))


def _harp_tpu_eval_renders(scene) -> dict:
    """harp_tpu's eval renders of the scene's GT parameters (2 frames), the
    golden harp_tpu_eval_renders.npz: `normal` and `rgb_with_shadow`."""
    jgt = {k: jnp.asarray(v) for k, v in scene["gt"].items()}
    fids = jnp.arange(2)
    jassets, jconfig, jrcfg = scene["jassets"], scene["jconfig"], scene["jrcfg"]
    verts, _ = jpipeline.mesh_forward(jgt, fids, jassets, jconfig)
    R, T = jpipeline.camera_for_frames(jgt, fids, jconfig)
    light = jnp.broadcast_to(jgt["light_positions"][0], (2, 3))
    return goldens.pack(
        normal=jpipeline.render_normal(verts, jassets, R, T, jconfig, jrcfg, jgt["normal_map"]),
        rgb_with_shadow=jrender_rgb_with_shadow(verts, jassets, jconfig, jrcfg, jgt["cam"][fids],
                                                light, jgt["amb_ratio"], jgt["texture"],
                                                jgt["normal_map"]))


@pytest.mark.slow
def test_harp_tpu_golden_of_the_eval_renders_is_current(scene):
    goldens.assert_current("harp_tpu_eval_renders", _harp_tpu_eval_renders(scene),
                           lambda k, want: RENDER_ATOL)


@pytest.mark.parametrize("render", ["normal", "rgb_with_shadow"])
def test_eval_render_matches_harp_tpu(scene, render):
    gt = scene["gt"]
    p = params_from_numpy(gt, "cpu")
    tf = torch.arange(2)
    counters = {}
    with torch.no_grad():
        v, _ = pipeline.mesh_forward(p, tf, scene["assets"], scene["config"])
        R2, T2 = pipeline.camera_for_frames(p, tf, scene["config"])
        if render == "normal":
            got = pipeline.render_normal(v, scene["assets"], R2, T2, scene["config"],
                                         scene["rcfg"], p["normal_map"], counters)
        else:
            got = render_rgb_with_shadow(v, scene["assets"], scene["config"], scene["rcfg"],
                                         p["cam"][tf], p["light_positions"][0].expand(2, 3),
                                         p["amb_ratio"], p["texture"], p["normal_map"],
                                         counters)
    want = goldens.load("harp_tpu_eval_renders")[render]
    assert got.shape == want.shape == (2, IMG, IMG, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RENDER_ATOL)
    assert (want != 1.0).any() and (want == 1.0).any()  # hand and background
    assert counters and not any(int(c) for c in counters.values())


def _port_sequence(scene):
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence

    images, masks, masks_er, gt, init = make_synthetic_sequence(
        scene["assets"], scene["config"], scene["rcfg"], n_frames=2, seed=0, device="cpu")
    return FitData(images, masks, masks_er), gt, init


def test_evaluate_sequence_on_gt_params(scene, tmp_path):
    """GT parameters against their own renders, with GT meshes (the
    reference's {500 + f + 1}_manov.xyz in mm) for the Procrustes error."""
    import dataclasses

    data, gt, init = _port_sequence(scene)
    _, aux = init_params(init, scene["assets"], scene["config"], device="cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in gt.items()}
    with torch.no_grad():
        verts, _ = pipeline.mesh_forward(params, torch.arange(2), scene["assets"],
                                         scene["config"])
    mesh_dir = tmp_path / "gt_mesh"
    mesh_dir.mkdir()
    for f in range(2):
        np.savetxt(mesh_dir / f"{501 + f}_manov.xyz", verts[f].double().numpy() * 1000.0)
    config = dataclasses.replace(scene["config"], eval_mesh=True, gt_mesh_dir=str(mesh_dir))
    stats = evaluate_sequence(config, scene["assets"], data, params, aux,
                              rcfg=scene["rcfg"], out_dir=str(tmp_path), device="cpu")
    assert stats["Procrustes-aligned vertex error (mm)"] < 1e-3
    assert {"Silhouette IoU", "L1", "LPIPS_proxy", "MS_SSIM", "bin_overflow",
            "light_span_overflow"} <= set(stats)
    assert stats["Silhouette IoU"] > 0.9
    assert stats["L1"] < 0.01 and stats["MS_SSIM"] > 0.9
    names = sorted(os.listdir(tmp_path / "rendered_after_opt"))
    assert names == ["0000.jpg", "0001.jpg"]
    assert (tmp_path / "uv_out" / "texture.png").exists()
    assert (tmp_path / "uv_out" / "final_mesh.obj").exists()
    assert (tmp_path / "eval_results.txt").exists()


def test_evaluate_sequence_of_the_arm_takes_its_mano_vertices(tmp_path):
    """With use_arm the Procrustes error aligns the GT MANO mesh with the
    arm mesh's MANO vertices (mano_vert_from_arm, here in reverse order),
    not with the first vertices of the render mesh."""
    import dataclasses

    from harp_tpu_torch.assets import build_synthetic_arm_assets
    from harp_tpu_torch.config import HarpConfig as PortConfig
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence

    assets = build_synthetic_arm_assets(uv_size=16, density="light")
    n_hand = len(assets.model.mano_vert_from_arm)
    model = dataclasses.replace(assets.model,
                                mano_vert_from_arm=np.arange(n_hand)[::-1].copy())
    assets = dataclasses.replace(assets, model=model)
    config = PortConfig(img_size=32, focal_length=2000.0 * 32 / 448, texture_size=16,
                        self_shadow=False, batch_size=2, use_arm=True)
    rcfg = RasterConfig(image_size=32, tile=8, cap=2048, faces_per_pixel=8, span_tiles=4)
    images, masks, masks_er, gt, init = make_synthetic_sequence(assets, config, rcfg,
                                                                n_frames=2, device="cpu")
    with torch.no_grad():
        verts, _ = pipeline.mesh_forward(gt, torch.arange(2), assets, config)
    mesh_dir = tmp_path / "gt_mesh"
    mesh_dir.mkdir()
    for f in range(2):
        np.savetxt(mesh_dir / f"{501 + f}_manov.xyz",
                   verts[f, model.mano_vert_from_arm].double().numpy() * 1000.0)
    _, aux = init_params(init, assets, config, device="cpu")
    config = dataclasses.replace(config, eval_mesh=True, gt_mesh_dir=str(mesh_dir))
    stats = evaluate_sequence(config, assets, FitData(images, masks, masks_er), gt, aux,
                              rcfg=rcfg, out_dir=str(tmp_path), save_images=False,
                              device="cpu")
    assert stats["Procrustes-aligned vertex error (mm)"] < 1e-3


def test_evaluate_sequence_refuses_a_truncated_render(scene, tmp_path):
    import dataclasses

    data, gt, init = _port_sequence(scene)
    _, aux = init_params(init, scene["assets"], scene["config"], device="cpu")
    tight = dataclasses.replace(scene["rcfg"], cap=8)
    with pytest.raises(RuntimeError, match="truncated"):
        evaluate_sequence(scene["config"], scene["assets"], data, gt, aux, rcfg=tight,
                          out_dir=str(tmp_path), save_images=False, device="cpu")


def test_png_writer_reads_back():
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(0)
    for arr in (rng.randint(0, 256, (7, 5, 3), dtype=np.uint8),
                rng.randint(0, 256, (4, 9), dtype=np.uint8)):
        import io

        back = np.asarray(PIL.open(io.BytesIO(viz.encode_png(arr))))
        np.testing.assert_array_equal(back, arr)
    with pytest.raises(ValueError):
        viz.save_image(np.zeros((2, 2, 3)), "frame.gif")


def test_evaluate_sequence_writes_harp_tpus_files(scene, tmp_path):
    """harp_tpu's evaluate_sequence and the port's on the same GT sequence
    (self-shadowed): the same tree of files; each composite the bytes
    harp_tpu's save_image writes of the port's uint8 composite; the
    texture maps (the same arrays in both packages) the same bytes."""
    import dataclasses

    from harp_tpu.fit import evaluate as JE
    from harp_tpu.fit.driver import FitData as JFitData
    from harp_tpu.fit.params import init_params as jinit_params
    from harp_tpu.utils import viz as jviz
    from harp_tpu_torch.fit.evaluate import make_eval_program

    jconfig = dataclasses.replace(scene["jconfig"], self_shadow=True)
    config = dataclasses.replace(scene["config"], self_shadow=True)
    images, masks, masks_er, jgt, jinit = jmake_sequence(scene["jassets"], jconfig,
                                                         scene["jrcfg"], n_frames=2, seed=0)
    _, jaux = jinit_params(jinit, scene["jassets"], jconfig)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    JE.evaluate_sequence(jconfig, scene["jassets"], JFitData(images, masks, masks_er), jgt,
                         jaux, rcfg=scene["jrcfg"], out_dir=str(jdir))
    data = FitData(*(torch.from_numpy(np.array(x)) for x in (images, masks, masks_er)))
    params = params_from_numpy({k: np.asarray(v) for k, v in jgt.items()}, "cpu")
    _, aux = init_params({k: np.asarray(v) for k, v in jinit.items()}, scene["assets"], config,
                         device="cpu")
    evaluate_sequence(config, scene["assets"], data, params, aux, rcfg=scene["rcfg"],
                      out_dir=str(pdir), device="cpu")

    def tree(d):
        return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
                      for f in fs)

    assert tree(pdir) == tree(jdir)
    prog, _ = make_eval_program(config, scene["assets"], data, scene["rcfg"], device="cpu")
    comps = prog(params, data.images, data.masks)[4].numpy()
    for f in range(2):
        name = os.path.join("rendered_after_opt", "%04d.jpg" % f)
        jviz.save_image(comps[f], str(tmp_path / "want.jpg"))
        assert (pdir / name).read_bytes() == (tmp_path / "want.jpg").read_bytes(), name
    for name in ("texture.png", "normal_map.png"):
        assert (pdir / "uv_out" / name).read_bytes() == (jdir / "uv_out" / name).read_bytes()


def test_viz_helpers_lay_out_images():
    a = np.full((4, 5, 3), 0.5, np.float32)
    m = np.ones((4, 5), np.float32)
    grid = viz.image_grid([a, m], rows=1, cols=3)
    assert grid.shape == (4, 15, 3) and grid[:, 10:].max() == 0
    comp = viz.frame_composite(a, a, a, m, 0 * m)
    assert comp.shape == (4, 20, 3)
    np.testing.assert_array_equal(comp[:, 15:, 0], 1.0)
    np.testing.assert_array_equal(comp[:, 15:, 2], 0.0)


def test_cli_runs_a_tiny_synthetic_fit_on_cpu(tmp_path):
    from harp_tpu_torch.fit_avatar import main

    out = str(tmp_path / "run")
    stats = main(["--synthetic", "--device", "cpu", "--n-frames", "2", "--img-size", "32",
                  "--texture-size", "64", "--density", "light", "--stages", "1", "1", "1",
                  "--epochs", "3", "--raster-cap", "2048", "--out", out])
    with open(os.path.join(out, "fit_summary.json")) as f:
        summary = json.load(f)
    assert summary["final_loss"] == stats["final_loss"] and np.isfinite(stats["final_loss"])
    assert 0.0 < summary["Silhouette IoU"] <= 1.0 and summary["device"] == "cpu"
    for name in ("config.yaml", "metrics.jsonl", "saved_params.pkl", "eval_results.txt"):
        assert os.path.exists(os.path.join(out, name)), name
    # The turntables are on by default, as in harp_tpu's CLI.
    views = [f"{p}{i:04d}.jpg" for p in ("", "h_") for i in range(36)]
    for sub, names in (("render_360", views), ("render_360_normal", views),
                       ("render_360_combine", [f"{i:04d}.jpg" for i in range(72)]),
                       ("render_360_light", [f"{i:04d}.jpg" for i in range(40)])):
        assert sorted(os.listdir(os.path.join(out, sub))) == sorted(names + ["out.gif"]), sub
    assert stats["eval_turntables_s"] > 0 and stats["turntable_bin_overflow"] == 0


def test_cli_runs_a_tiny_synthetic_arm_fit_on_cpu(tmp_path):
    """--use-arm is no longer refused with --synthetic: the SMPL-X arm fits
    and evaluates with its own raster budget, and its outputs are written."""
    from harp_tpu_torch.fit_avatar import main

    out = str(tmp_path / "arm")
    stats = main(["--synthetic", "--use-arm", "--device", "cpu", "--n-frames", "2",
                  "--img-size", "32", "--texture-size", "64", "--density", "light",
                  "--stages", "1", "1", "1", "--epochs", "3", "--raster-cap", "2048",
                  "--no-vgg", "--no-turntables", "--out", out])
    with open(os.path.join(out, "fit_summary.json")) as f:
        summary = json.load(f)
    assert summary["final_loss"] == stats["final_loss"] and np.isfinite(stats["final_loss"])
    assert 0.0 < summary["Silhouette IoU"] <= 1.0
    with open(os.path.join(out, "config.yaml")) as f:
        cfg = f.read()
    assert "use_arm: true" in cfg and "raster_span_tiles: 4" in cfg  # the arm's budget
    for name in ("metrics.jsonl", "saved_params.pkl", "eval_results.txt",
                 os.path.join("rendered_after_opt", "0001.jpg")):
        assert os.path.exists(os.path.join(out, name)), name


def test_cli_debug_nans_fits_under_anomaly_mode(monkeypatch, tmp_path):
    """--debug-nans: the fit runs under utils/debug_nans.DebugNans and,
    beside it, torch's anomaly mode with its NaN check; the eval runs under
    DebugNans, eagerly, and finds no NaN in a clean eval. Without the flag,
    neither mode."""
    from harp_tpu_torch.fit import driver, evaluate
    from harp_tpu_torch.fit_avatar import main
    from harp_tpu_torch.utils import debug_nans

    seen = []
    real_eval = evaluate.evaluate_sequence

    def fit_sequence(config, assets, data, params, *args, **kwargs):
        seen.append((torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled(),
                     debug_nans.active()))
        if not debug_nans.active():
            raise KeyboardInterrupt  # stop before the fit
        return params, []

    def evaluate_sequence(*args, **kwargs):
        seen.append(("eval", debug_nans.active(), kwargs["eval_program"].use_graph))
        return real_eval(*args, **kwargs)

    monkeypatch.setattr(driver, "fit_sequence", fit_sequence)
    monkeypatch.setattr(evaluate, "evaluate_sequence", evaluate_sequence)
    argv = ["--synthetic", "--device", "cpu", "--n-frames", "2", "--img-size", "32",
            "--texture-size", "16", "--density", "light", "--raster-cap", "2048",
            "--no-turntables",
            "--out", str(tmp_path)]
    stats = main(argv + ["--debug-nans"])
    assert 0.0 < stats["Silhouette IoU"] <= 1.0
    with pytest.raises(KeyboardInterrupt):
        main(argv)
    assert seen == [(True, True, True), ("eval", True, False), (False, True, False)]
    assert not torch.is_anomaly_enabled() and not debug_nans.active()


def test_cli_refuses_what_is_not_ported_and_needs_a_device(monkeypatch, tmp_path):
    from harp_tpu_torch.fit_avatar import main

    for flags in (["--use-arm", "--smplx-npz", "SMPLX_NEUTRAL.npz"], []):
        with pytest.raises(SystemExit):
            main((["--synthetic"] if flags else []) + flags + ["--device", "cpu"])
    # --epoch-scan is ported (default 10, harp_tpu's) and reaches the fit.
    seen = []

    def fit_sequence(*args, **kwargs):
        seen.append(kwargs["epoch_scan"])
        raise KeyboardInterrupt  # stop before the fit

    from harp_tpu_torch.fit import driver

    monkeypatch.setattr(driver, "fit_sequence", fit_sequence)
    argv = ["--synthetic", "--device", "cpu", "--n-frames", "2", "--img-size", "32",
            "--texture-size", "16", "--density", "light", "--out", str(tmp_path)]
    for flags in (["--epoch-scan", "2"], []):
        with pytest.raises(KeyboardInterrupt):
            main(argv + flags)
    assert seen == [2, 10]
    monkeypatch.undo()
    # --mesh-devices beyond the visible CUDA devices raises: no fewer ranks,
    # no quiet fall-back to the CPU.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"device_count\(\) is 1"):
        main(["--synthetic", "--mesh-devices", "2", "--out", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--synthetic", "--out", str(tmp_path)])
