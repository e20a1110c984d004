"""Fit a personalised hand avatar to a video sequence on the card.

The port's counterpart of harp_tpu's fit_avatar.py, with its defaults. Two
data paths:

- real data, in the reference's layout: the METRO output under
  --metro-output-dir ({seq}/metro_mano_smooth/%04d_mano.pkl), the frames
  and masks under --image-dir ({seq}/unscreen_cropped/%04d.jpg,
  {seq}/mask/%04d_mask.jpg), the MANO model from --mano-pkl and the hand
  template (template/hand/textured_hand.obj, template/hand/uv_mask.png,
  relative to the working directory); with --use-arm the SMPL-X arm from
  --smplx-npz, --arm-corr and template/arm/. --val-list sequences are
  logged during the fit and evaluated after it with their own
  preprocessing pose and camera (under val/). --start-from a previous run
  (with --known-appearance: its fitted appearance on a new sequence), or
  --resume-orbax a run directory's checkpoint mid-protocol (its
  checkpoint.pt, or the latest step of its orbax/ tree);
- --synthetic: a procedural MANO-topology hand (with --use-arm the SMPL-X
  arm around it) rendered at known parameters and fitted from a perturbed
  start.

Runs on CUDA unless --device names another device. --mesh-devices N fits
the sequence frame-parallel on N ranks (one process each: CUDA devices
0..N-1 over NCCL, or with --device cpu N gloo ranks); rank 0 writes and
prints the outputs. --checkpoint-backend orbax writes the checkpoints
through the async checkpointer (utils/orbax_io.py) under --out/orbax/.

    python -m harp_tpu_torch.fit_avatar --metro-output-dir data --image-dir data \\
        --train-list 1 --val-list 2 --mano-pkl mano/models/MANO_RIGHT.pkl --out exp/run
    python -m harp_tpu_torch.fit_avatar --metro-output-dir data --image-dir data \\
        --train-list 2 --start-from exp/run --known-appearance --out exp/run2
    python -m harp_tpu_torch.fit_avatar --synthetic --n-frames 36 --out exp/syn
    python -m harp_tpu_torch.fit_avatar --synthetic --mesh-devices 2 --out exp/mesh

Writes config.yaml, metrics.jsonl, the image logs every 10 epochs,
saved_params.pkl, checkpoint.pt (or orbax/), the eval composites and maps,
eval_results.txt, frame 0's turntables (render_360/, render_360_normal/,
render_360_combine/, render_360_light/: JPEG frames and out.gif; on by
default as in harp_tpu, --no-turntables skips them) and fit_summary.json
under --out, and prints the summary. --epoch-scan N (10, harp_tpu's
default) runs the fit in segments of N epochs, each step a replay of a
CUDA graph of the train step (fit_sequence(epoch_scan=N)); 0 or 1 runs the
per-step loop. --debug-nans runs the fit and the eval under
utils/debug_nans.DebugNans, as harp_tpu's jax_debug_nans: every operation's
floating outputs, forward and backward, and every hand-written kernel's,
are checked for NaN, and the first NaN raises FloatingPointError naming
the operation; torch's anomaly mode runs beside it, for the forward
traceback of a failing backward. The checks read the card from the host,
so the epoch scan's segments and the eval then run eagerly
(metrics.jsonl: "graph": false).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--synthetic", action="store_true",
                   help="fit a synthetic GT sequence (no data or model files needed)")
    p.add_argument("--device", default=None,
                   help="torch device; default CUDA (no card: an error)")
    p.add_argument("--img-size", type=int, default=448)
    p.add_argument("--texture-size", type=int, default=512)
    p.add_argument("--epochs", type=int, default=301)
    p.add_argument("--stages", type=int, nargs=3, default=[100, 100, 100])
    p.add_argument("--batch-size", type=int, default=18)
    p.add_argument("--no-shadow", action="store_true")
    p.add_argument("--no-vgg", action="store_true")
    p.add_argument("--known-appearance", action="store_true")
    p.add_argument("--start-from", default="",
                   help="a previous run directory: fit from its saved_params.pkl")
    p.add_argument("--out", default="exp/out/")
    p.add_argument("--n-frames", type=int, default=8, help="synthetic frames")
    p.add_argument("--use-arm", action="store_true",
                   help="the SMPL-X arm (hand + forearm) in place of the MANO hand")
    p.add_argument("--density", default="reference", choices=["light", "reference"],
                   help="synthetic mesh density ('reference': 3088 verts / 6152 faces, "
                        "the arm 4078 / 8128)")
    p.add_argument("--raster-cap", type=int, default=None,
                   help="per-tile face capacity (default 448 at reference density, 256 light)")
    p.add_argument("--active-tiles", type=float, default=None,
                   help="raster tile budget fraction; default 0.28 at >= 256 px (the "
                        "synthetic arm 0.5), else 1.0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shape-seed", type=int, default=None,
                   help="synthetic GT identity seed (one hand under two --seed motions)")
    # Real data in the reference's layout, and the model files.
    p.add_argument("--metro-output-dir", default="")
    p.add_argument("--image-dir", default="")
    p.add_argument("--train-list", nargs="*", default=["1"])
    p.add_argument("--val-list", nargs="*", default=[])
    p.add_argument("--use-smooth-seq", action="store_true", default=True)
    p.add_argument("--mano-pkl", default="", help="MANO_RIGHT.pkl path")
    p.add_argument("--smplx-npz", default="", help="SMPLX_NEUTRAL.npz path")
    p.add_argument("--arm-corr", default="template/arm/smplx_arm_corr.pkl")
    p.add_argument("--resume-orbax", default="",
                   help="resume mid-protocol from a checkpoint.pt or a run directory "
                        "holding one or an orbax/ tree (params, optimizer, epoch, plateau "
                        "state)")
    p.add_argument("--uint8-frames", action="store_true",
                   help="store frames and masks as uint8 on the device (decoded per minibatch)")
    p.add_argument("--reference-exact", action="store_true",
                   help="HarpConfig.reference_exact(): the reference's numeric semantics")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="fit frame-parallel on this many ranks (CUDA devices 0..N-1, or "
                        "N gloo ranks with --device cpu); 0: one process")
    p.add_argument("--checkpoint-backend", default="pickle", choices=["pickle", "orbax"],
                   help="checkpoint.pt, or the async checkpointer's orbax/ tree")
    p.add_argument("--turntables", action=argparse.BooleanOptionalAction, default=True,
                   help="render frame 0's turntables and light sweep after the eval")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first operation that yields a "
                        "NaN, in the fit and the eval (the epoch scan's segments and the "
                        "eval then run eagerly: the checks read the card from the host, "
                        "which a CUDA graph cannot)")
    p.add_argument("--epoch-scan", type=int, default=10,
                   help="epochs a segment: the steps of each run as replays of a CUDA graph "
                        "of the train step, logs and checkpoints at the segment's end; 0 or "
                        "1: the per-step loop")
    args = p.parse_args(argv)
    if args.synthetic:
        files = [name for name, on in (
            ("--metro-output-dir", args.metro_output_dir), ("--image-dir", args.image_dir),
            ("--mano-pkl", args.mano_pkl), ("--smplx-npz", args.smplx_npz)) if on]
        if files:
            p.error(f"--synthetic builds its own sequence and model: {', '.join(files)} "
                    "would be ignored")
    elif not args.metro_output_dir:
        p.error("give --metro-output-dir (and --image-dir) for real data, or --synthetic")
    return args


def _config(args):
    from harp_tpu_torch.config import HarpConfig

    make_config = HarpConfig.reference_exact if args.reference_exact else HarpConfig
    cfg_kw = dict(
        use_arm=args.use_arm, img_size=args.img_size, focal_length=2000.0 * args.img_size / 448.0,
        texture_size=args.texture_size, total_epoch=args.epochs,
        training_stage=tuple(args.stages), batch_size=args.batch_size,
        self_shadow=not args.no_shadow, w_vgg=0.0 if args.no_vgg else 1.0,
        known_appearance=args.known_appearance,
        raster_cap=(args.raster_cap if args.raster_cap is not None
                    else (448 if args.density == "reference" else 256)),
        start_from=args.start_from, base_output_dir=args.out,
        metro_output_dir=args.metro_output_dir, image_dir=args.image_dir,
        use_smooth_seq=args.use_smooth_seq, checkpoint_backend=args.checkpoint_backend,
    )
    synthetic_arm = args.use_arm and args.synthetic
    if synthetic_arm and not args.reference_exact:
        # harp_tpu's budget (0.28, span 3) truncates the synthetic arm's
        # sequence: its forearm takes up to 329 of 784 tiles at 448^2, and
        # faces span 4 tiles (chip_smoke.py, phase arm_budget).
        cfg_kw["raster_span_tiles"] = 4
    if args.active_tiles is not None:
        cfg_kw["raster_active_fraction"] = args.active_tiles
    elif not args.reference_exact:
        cfg_kw["raster_active_fraction"] = ((0.5 if synthetic_arm else 0.28)
                                            if args.img_size >= 256 else 1.0)
    return make_config(**cfg_kw)


def load_inputs(args, config, dev) -> dict:
    """What the fit starts from: {"assets", "extras", "input_params" (the
    preprocessing output, numpy), "data" (FitData on the device), "val"
    ((val preprocessing output, FitData) or None)}. Real data goes through
    load_sequences and the model-file loaders (template paths relative to
    the working directory), --synthetic through make_synthetic_sequence."""
    import torch

    from harp_tpu_torch.fit.driver import FitData

    val = None
    if args.synthetic:
        from harp_tpu_torch.assets import build_synthetic_arm_assets, build_synthetic_assets
        from harp_tpu_torch.data.synthetic import make_synthetic_sequence

        build = build_synthetic_arm_assets if args.use_arm else build_synthetic_assets
        assets, extras = build(uv_size=args.texture_size, density=args.density), {}
        images, masks, masks_er, _, input_params = make_synthetic_sequence(
            assets, config, config.raster_config(), n_frames=args.n_frames, seed=args.seed,
            shape_seed=args.shape_seed, device=dev)
    else:
        from harp_tpu_torch.data.dataset import load_sequences
        from harp_tpu_torch.models.zoo import load_hand_model

        files = dict(smplx_npz=args.smplx_npz, arm_corr=args.arm_corr)
        if args.mano_pkl:
            files["mano_pkl"] = args.mano_pkl
        assets, extras = load_hand_model(config, **{k: v for k, v in files.items() if v})
        input_params, images, masks, masks_er = load_sequences(
            config.metro_output_dir, config.image_dir, args.train_list,
            use_smooth_seq=args.use_smooth_seq, device=dev)
        if args.val_list:
            v_params, *v_frames = load_sequences(
                config.metro_output_dir, config.image_dir, args.val_list,
                use_smooth_seq=args.use_smooth_seq, device=dev)
            val = (v_params, FitData(*v_frames))
    frames = (images, masks, masks_er)
    if args.uint8_frames:
        frames = [torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.uint8) for x in frames]
    return {"assets": assets, "extras": extras or None, "input_params": input_params,
            "data": FitData(*frames), "val": val}


def main(argv=None) -> dict:
    """Parse, fit, evaluate and print the summary (returned; with
    --mesh-devices, rank 0's)."""
    args = parse_args(argv)
    if not args.mesh_devices:
        return _run(args)
    import torch

    from harp_tpu_torch import fit_avatar  # _rank_main by its module's name, under -m too
    from harp_tpu_torch.parallel.launch import launch

    n = args.mesh_devices
    if args.device is None or torch.device(args.device).type == "cuda":
        if n > torch.cuda.device_count():
            raise ValueError(f"--mesh-devices {n} needs {n} CUDA devices; "
                             f"torch.cuda.device_count() is {torch.cuda.device_count()}")
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        devices = [args.device] * n
    return launch(fit_avatar._rank_main, n, args, devices=devices)


def _rank_main(mesh, args) -> dict | None:
    """One rank of a --mesh-devices fit, on the mesh's device."""
    args.device = str(mesh.device)
    return _run(args, mesh)


def _run(args, mesh=None) -> dict | None:
    """The fit, its eval and the summary. With a mesh every rank fits its
    rows of each minibatch; rank 0 writes, evaluates and prints."""
    import torch

    from harp_tpu_torch.device import resolve_device
    from harp_tpu_torch.fit.driver import fit_sequence
    from harp_tpu_torch.fit.evaluate import evaluate_sequence, make_eval_program
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.fit.resume import load_fit_checkpoint, prepare_resume_params
    from harp_tpu_torch.losses.perceptual import Vgg16Features
    from harp_tpu_torch.utils.debug_nans import DebugNans
    from harp_tpu_torch.utils.io import save_result
    from harp_tpu_torch.utils.profiling import Timer

    dev = resolve_device(args.device)
    config = _config(args)
    lead = mesh is None or mesh.rank == 0
    if lead:
        os.makedirs(config.base_output_dir, exist_ok=True)
        config.to_yaml(os.path.join(config.base_output_dir, "config.yaml"))
    rcfg = config.raster_config()

    inputs = load_inputs(args, config, dev)
    assets, extras, data, val = inputs["assets"], inputs["extras"], inputs["data"], inputs["val"]
    params, aux = init_params(inputs["input_params"], assets, config, device=dev)
    if config.start_from:
        params = prepare_resume_params(config.start_from, inputs["input_params"], config,
                                       device=dev)
    resume = None
    if args.resume_orbax:
        resume = load_fit_checkpoint(args.resume_orbax, device=dev)
        params = resume["params"]
        if lead:
            print(f"resuming at epoch {int(resume['epoch']) + 1} from {args.resume_orbax}")
    val_kwargs = {}
    if val is not None:
        val_kwargs = dict(val_data=val[1], val_params={
            k: torch.tensor(v, device=dev) for k, v in val[0].items()})
    eval_prog = eval_vgg = None
    if lead:  # the fused eval pass of the fitted sequence, as harp_tpu's CLI builds it
        eval_vgg = Vgg16Features.create(weights_path=config.vgg_weights or None, device=dev)
        eval_prog, _ = make_eval_program(config, assets, data, rcfg, eval_vgg, device=dev,
                                         extras=extras, graph=dev.type == "cuda"
                                         and not args.debug_nans)
    nan_checks = DebugNans if args.debug_nans else contextlib.nullcontext

    with nan_checks(), Timer(dev) as t_fit, torch.autograd.set_detect_anomaly(
            args.debug_nans, check_nan=True):
        params, history = fit_sequence(config, assets, data, params, aux, rcfg=rcfg,
                                       out_dir=config.base_output_dir, image_log_every=10,
                                       resume=resume, extras=extras, device=dev, mesh=mesh,
                                       epoch_scan=args.epoch_scan, **val_kwargs)
    if not lead:
        return None
    save_result(params, config.base_output_dir, test=config.known_appearance)
    with nan_checks(), Timer(dev) as t_eval:
        stats = evaluate_sequence(config, assets, data, params, aux, rcfg=rcfg, device=dev,
                                  extras=extras, turntables=args.turntables, vgg=eval_vgg,
                                  eval_program=eval_prog)
        eval_prog.close()
        if val is not None:
            # The validation sequences: the fitted shared appearance with
            # their own preprocessing pose and camera.
            v_input, v_data = val
            v_fit = dict(params)
            for k in ("pose", "rot", "trans", "cam"):
                v_fit[k] = torch.tensor(v_input[k], dtype=torch.float32, device=dev)
            n_val = v_fit["pose"].shape[0]
            v_fit["wrist_pose"] = torch.zeros((n_val, 3), device=dev)
            v_fit["light_positions"] = params["light_positions"][0].detach().expand(n_val, 3)
            val_stats = evaluate_sequence(
                config, assets, v_data, v_fit, aux, rcfg=rcfg, device=dev, extras=extras,
                out_dir=os.path.join(config.base_output_dir, "val"))
            stats.update({f"val {k}": v for k, v in val_stats.items()})
    stats["fit_wall_s"] = t_fit.elapsed
    stats["eval_wall_s"] = t_eval.elapsed
    stats["final_loss"] = history[-1]["loss"] if history else None
    stats["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev))
    stats["ranks"] = 1 if mesh is None else mesh.world_size
    print(json.dumps(stats, indent=2))
    with open(os.path.join(config.base_output_dir, "fit_summary.json"), "w") as f:
        json.dump(stats, f, indent=2)
    return stats


if __name__ == "__main__":
    main()
