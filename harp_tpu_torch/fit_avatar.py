"""Fit a personalised hand avatar to a synthetic sequence on the card.

The port's counterpart of harp_tpu's fit_avatar.py --synthetic, with its
defaults: a procedural MANO-topology hand (with --use-arm the SMPL-X arm
around it) rendered at known parameters, fitted from a perturbed start
through the staged protocol, then evaluated. Runs on CUDA unless --device
names another device.

    python -m harp_tpu_torch.fit_avatar --synthetic --n-frames 36 --out exp/run
    python -m harp_tpu_torch.fit_avatar --synthetic --use-arm --out exp/arm
    python -m harp_tpu_torch.fit_avatar --synthetic --device cpu --img-size 32 \\
        --texture-size 64 --density light --n-frames 2 --stages 1 1 1 --epochs 3

Writes config.yaml, metrics.jsonl, saved_params.pkl, checkpoint.pt, the
eval composites and maps, eval_results.txt and fit_summary.json under
--out, and prints the summary. Real-data ingestion (the model-file flags
with it), multi-device fits, epoch scans, Orbax checkpoints and
turntables are not ported: their flags raise.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--synthetic", action="store_true",
                   help="fit a synthetic GT sequence (the only data path ported)")
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
                   help="raster tile budget fraction; default 0.28 at >= 256 px (the arm "
                        "0.5), else 1.0")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shape-seed", type=int, default=None,
                   help="synthetic GT identity seed (one hand under two --seed motions)")
    p.add_argument("--uint8-frames", action="store_true",
                   help="store frames and masks as uint8 on the device (decoded per minibatch)")
    p.add_argument("--reference-exact", action="store_true",
                   help="HarpConfig.reference_exact(): the reference's numeric semantics")
    # harp_tpu flags whose parts are not ported: refused unless left off.
    p.add_argument("--start-from", default="")
    p.add_argument("--metro-output-dir", default="")
    p.add_argument("--image-dir", default="")
    p.add_argument("--mano-pkl", default="")
    p.add_argument("--smplx-npz", default="")
    p.add_argument("--mesh-devices", type=int, default=0)
    p.add_argument("--epoch-scan", type=int, default=0)
    p.add_argument("--resume-orbax", default="")
    p.add_argument("--checkpoint-backend", default="pickle", choices=["pickle", "orbax"])
    p.add_argument("--turntables", action="store_true")
    args = p.parse_args(argv)
    refused = [name for name, on in (
        ("--start-from", args.start_from),
        ("--metro-output-dir", args.metro_output_dir), ("--image-dir", args.image_dir),
        ("--mano-pkl", args.mano_pkl), ("--smplx-npz", args.smplx_npz),
        ("--mesh-devices", args.mesh_devices),
        ("--epoch-scan", args.epoch_scan > 1), ("--resume-orbax", args.resume_orbax),
        ("--checkpoint-backend orbax", args.checkpoint_backend == "orbax"),
        ("--turntables", args.turntables), ("no --synthetic", not args.synthetic)) if on]
    if refused:
        p.error(f"not ported yet: {', '.join(refused)} (harp_tpu_torch fits "
                "synthetic sequences of the MANO hand and the SMPL-X arm on one device)")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from harp_tpu_torch.assets import build_synthetic_arm_assets, build_synthetic_assets
    from harp_tpu_torch.config import HarpConfig
    from harp_tpu_torch.data.synthetic import make_synthetic_sequence
    from harp_tpu_torch.device import resolve_device
    from harp_tpu_torch.fit.driver import FitData, fit_sequence
    from harp_tpu_torch.fit.evaluate import evaluate_sequence
    from harp_tpu_torch.fit.params import init_params
    from harp_tpu_torch.utils.io import save_result
    from harp_tpu_torch.utils.profiling import Timer

    dev = resolve_device(args.device)
    make_config = HarpConfig.reference_exact if args.reference_exact else HarpConfig
    cfg_kw = dict(
        use_arm=args.use_arm, img_size=args.img_size, focal_length=2000.0 * args.img_size / 448.0,
        texture_size=args.texture_size, total_epoch=args.epochs,
        training_stage=tuple(args.stages), batch_size=args.batch_size,
        self_shadow=not args.no_shadow, w_vgg=0.0 if args.no_vgg else 1.0,
        known_appearance=args.known_appearance,
        raster_cap=(args.raster_cap if args.raster_cap is not None
                    else (448 if args.density == "reference" else 256)),
        base_output_dir=args.out,
    )
    if args.use_arm and not args.reference_exact:
        # harp_tpu's budget (0.28, span 3) truncates the synthetic arm's
        # sequence: its forearm takes up to 329 of 784 tiles at 448^2, and
        # faces span 4 tiles (chip_smoke.py, phase arm_budget).
        cfg_kw["raster_span_tiles"] = 4
    if args.active_tiles is not None:
        cfg_kw["raster_active_fraction"] = args.active_tiles
    elif not args.reference_exact:
        cfg_kw["raster_active_fraction"] = ((0.5 if args.use_arm else 0.28)
                                            if args.img_size >= 256 else 1.0)
    config = make_config(**cfg_kw)
    os.makedirs(config.base_output_dir, exist_ok=True)
    config.to_yaml(os.path.join(config.base_output_dir, "config.yaml"))
    rcfg = config.raster_config()

    build = build_synthetic_arm_assets if args.use_arm else build_synthetic_assets
    assets = build(uv_size=args.texture_size, density=args.density)
    images, masks, masks_er, _, input_params = make_synthetic_sequence(
        assets, config, rcfg, n_frames=args.n_frames, seed=args.seed,
        shape_seed=args.shape_seed, device=dev)
    if args.uint8_frames:
        images, masks, masks_er = (torch.round(x.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
                                   for x in (images, masks, masks_er))
    data = FitData(images=images, masks=masks, masks_eroded=masks_er)
    params, aux = init_params(input_params, assets, config, device=dev)

    with Timer(dev) as t_fit:
        params, history = fit_sequence(config, assets, data, params, aux, rcfg=rcfg,
                                       out_dir=config.base_output_dir, device=dev)
    save_result(params, config.base_output_dir, test=config.known_appearance)
    with Timer(dev) as t_eval:
        stats = evaluate_sequence(config, assets, data, params, aux, rcfg=rcfg, device=dev)
    stats["fit_wall_s"] = t_fit.elapsed
    stats["eval_wall_s"] = t_eval.elapsed
    stats["final_loss"] = history[-1]["loss"] if history else None
    stats["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev))
    print(json.dumps(stats, indent=2))
    with open(os.path.join(config.base_output_dir, "fit_summary.json"), "w") as f:
        json.dump(stats, f, indent=2)
    return stats


if __name__ == "__main__":
    main()
