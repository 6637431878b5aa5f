"""Command line of the port: `python -m tnerf_torch.cli train|eval|render`.

Trains the fused frequency-MLP model, and serves a checkpoint written by
this port or by the reference package (`tnerf.cli train`), on the card
(`--device cuda`, the default) or through the plain PyTorch versions on
the CPU (`--device cpu`).  Configs are the reference's JSON files; options
this port does not run yet are refused (`train_loop.validate_ported`).

    python -m tnerf_torch.cli train --config runs/suite_rehearsal/prims/config.json \\
        --out runs/prims_torch
    python -m tnerf_torch.cli eval --config runs/suite_rehearsal/prims/config.json \\
        --checkpoint runs/suite_rehearsal/prims/checkpoints
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tnerf_torch.config import Config


def _load_cfg(args) -> Config:
    cfg = Config.from_json_file(args.config) if args.config else Config()
    if args.override:
        cfg = cfg.apply_overrides(args.override)
    if args.cmd == "train" and args.out:
        cfg = cfg.apply_overrides([f"logging.out_dir={args.out}"])
    return cfg


def _ray_compact_guard(cfg: Config):
    """(eligible, pool_res, n_mid) of the ray-compaction capacity guard
    (`tnerf/cli.py:35`, fused branch): whether the configured renderer
    compacts rays at all, and the pooling resolution and midpoint count
    of its keep rule.  Uniform placement keeps a ray with an occupied
    midpoint sample on the kernel's coarse bitfield; CDF placement keeps
    a ray with an occupied bin on the bin-probe pooling."""
    from tnerf_torch.render.fused import select_bin_pool_res, select_coarse_res

    if not (cfg.render.ray_compact and cfg.render.fused_tighten):
        return False, None, None
    res = cfg.grid.resolution
    if cfg.sampler.placement == "occupancy_cdf":
        return True, select_bin_pool_res(res), cfg.sampler.cdf_bins
    return True, select_coarse_res(cfg.render, res), cfg.sampler.samples_per_ray


def ray_keep_fraction(rays, occupancy, cfg: Config, pool_res: int, n_mid: int) -> float:
    """The share of `rays` ([H, W] or flat) that the compacting renderer
    keeps, by the rule it runs: `tighten_sample_mask` on the occupancy
    pooled to pool_res, any of the n_mid midpoints occupied."""
    from tnerf_torch.grid.tighten import tighten_sample_mask
    from tnerf_torch.grid.traversal import make_coarse_occupancy, ray_aabb

    res = cfg.grid.resolution
    o = rays.origins.reshape(-1, 3).float().contiguous()
    d = rays.directions.reshape(-1, 3).float().contiguous()
    te, tx = ray_aabb(o, d, cfg.grid.aabb_min, cfg.grid.aabb_max)
    te = torch.clamp_min(te, float(cfg.sampler.near))
    tx = torch.maximum(tx, te)
    occ_c = make_coarse_occupancy(occupancy.reshape(res, res, res), res // pool_res)
    _, _, mask = tighten_sample_mask(o, d, te, tx, occ_c, n_mid, cfg.grid)
    return float(mask.any(dim=1).float().mean())


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tnerf_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--config", help="JSON config file")
        sp.add_argument("--override", "-o", action="append", default=[],
                        help="config override key.path=value (repeatable)")
        sp.add_argument("--checkpoint", help="checkpoint dir (default: out_dir/checkpoints)")
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where to run (default cuda; cpu runs the plain versions)")

    sp = sub.add_parser("train", help="train a radiance field")
    common(sp)
    sp.add_argument("--out", help="output directory (overrides logging.out_dir)")

    sp = sub.add_parser("render", help="render one view (or an orbit) from a checkpoint")
    common(sp)
    sp.add_argument("--pose-index", type=int, default=0)
    sp.add_argument("--split", default="test")
    sp.add_argument("--out", default="render.png",
                    help="output PNG; with --orbit, a directory of orbit_###.png frames")
    sp.add_argument("--orbit", type=int, default=0, metavar="N",
                    help="render N novel views on a circular orbit instead of a dataset pose")
    sp.add_argument("--orbit-elevation", type=float, default=None, metavar="RAD",
                    help="orbit elevation in radians (default: the split cameras' mean)")
    sp.add_argument("--channels", default="rgb", metavar="LIST",
                    help="comma list of rgb, depth, acc; extra channels get a _depth/_acc suffix")

    sp = sub.add_parser("eval", help="PSNR/SSIM over the val and test splits from a checkpoint")
    common(sp)
    sp.add_argument("--out", default=None, help="also write the metrics JSON to this file")
    sp.add_argument("--save-renders", default=None, metavar="DIR",
                    help="also write each evaluated view's render as DIR/<split>_###.png")
    return p


def _channel_image(res, ch, depth_range=(None, None)):
    from tnerf_torch.eval import acc_image, depth_image

    if ch == "rgb":
        return res.rgb
    if ch == "depth":
        return depth_image(res.depth, res.acc, near=depth_range[0], far=depth_range[1])
    return acc_image(res.acc)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cfg = _load_cfg(args)

    if args.cmd == "train":
        from tnerf_torch.train_loop import run_training

        print(json.dumps(run_training(cfg, device=args.device), indent=2))
        return 0

    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs, validate_scene_background
    from tnerf_torch.device import resolve_device
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.train_loop import build_renderer, resolve_near_far, validate_ported
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    validate_ported(cfg)
    validate_scene_background(cfg.scene.kind, cfg.scene.name, cfg.scene.white_background)
    dev = resolve_device(args.device)
    channels = []
    if args.cmd == "render":
        channels = [c.strip() for c in args.channels.split(",") if c.strip()]
        bad = [c for c in channels if c not in ("rgb", "depth", "acc")]
        if bad or not channels:
            print(f"error: unknown --channels {bad or args.channels!r} "
                  "(choose from rgb, depth, acc)", file=sys.stderr)
            return 1
    splits = ("val", "test") if args.cmd == "eval" else (args.split,)
    datasets = load_data(cfg.scene.kind, cfg.scene.name, splits=splits,
                         proc=scene_proc_kwargs(cfg.scene), device=dev)
    if not datasets:
        print(f"error: the scene has none of the splits {splits}", file=sys.stderr)
        return 1
    cfg = resolve_near_far(cfg, next(iter(datasets.values())))
    ckpt_dir = args.checkpoint or os.path.join(cfg.logging.out_dir, "checkpoints")
    step, params, occ = load_jax_checkpoint(ckpt_dir, device=dev)
    print(f"restored step {step} from {ckpt_dir}", file=sys.stderr)
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    renderer = build_renderer(cfg, for_eval=True)
    # Capacity guard: the keep fraction depends on the restored occupancy
    # (a trained grid is fatter than an analytic one), and kept rays beyond
    # render.ray_compact_fraction render as background without a word.
    guard_on, guard_pool, guard_mid = _ray_compact_guard(cfg)
    if guard_on and payload is not None and step > 0:
        from tnerf_torch.cameras import camera_rays

        ds0 = next(iter(datasets.values()))
        probe_rays = camera_rays(ds0.poses[0], ds0.width, ds0.height, ds0.camera,
                                 cfg.scene.scene_scale, device=dev)
        kf = ray_keep_fraction(probe_rays, payload, cfg, guard_pool, guard_mid)
        if kf > cfg.render.ray_compact_fraction:
            print(
                f"WARNING: ray-compaction keep fraction {kf:.3f} on the "
                f"probe view exceeds render.ray_compact_fraction="
                f"{cfg.render.ray_compact_fraction} — over-capacity rays "
                f"will render as background. Raise the fraction (or set "
                f"render.ray_compact=false).",
                file=sys.stderr,
            )

    if args.cmd == "eval":
        from tnerf_torch.eval import evaluate

        out = {}
        for split in splits:
            if split in datasets:
                out.update(evaluate(
                    renderer, params, datasets[split], cfg.scene.scene_scale,
                    white_background=cfg.scene.white_background, save_dir=args.save_renders,
                    chunk_size=cfg.render.chunk_size, occupancy=payload, device=dev,
                ))
        text = json.dumps(out, indent=2)
        print(text)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(text + "\n")
        return 0

    from tnerf_torch.data.png_io import write_png, write_png_batch
    from tnerf_torch.eval import hit_depths, render_pose_result

    ds = datasets[args.split]
    if args.orbit > 0:
        from tnerf_torch.data.procedural import orbit_poses

        # orbit at the split cameras' mean radius / elevation, as the
        # reference does, so the novel path stays inside the trained views
        eyes = np.asarray(ds.poses)[:, :3, 3]
        norms = np.linalg.norm(eyes, axis=1)
        radius = float(norms.mean())
        elev = (args.orbit_elevation if args.orbit_elevation is not None else
                float(np.arcsin(np.clip(eyes[:, 2] / np.maximum(norms, 1e-9), -1, 1)).mean()))
        poses = list(orbit_poses(args.orbit, radius, elev))
        os.makedirs(args.out, exist_ok=True)
        results, ms = [], []
        for pose in poses:
            _sync(dev)
            t0 = time.perf_counter()
            results.append(render_pose_result(
                renderer, params, pose, ds.width, ds.height, ds.camera, cfg.scene.scene_scale,
                chunk_size=cfg.render.chunk_size, occupancy=payload, device=dev))
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        depth_range = (None, None)
        if "depth" in channels:
            # one exposure for the whole sequence, so frames do not flicker
            spans = []
            for res in results:
                hit, th = hit_depths(res.depth, res.acc)
                if hit.any():
                    spans.append((float(th[hit].min()), float(th[hit].max())))
            depth_range = ((min(a for a, _ in spans), max(b for _, b in spans))
                           if spans else (0.0, 1.0))
        for ch in channels:
            suffix = "" if ch == "rgb" or len(channels) == 1 else f"_{ch}"
            write_png_batch([os.path.join(args.out, f"orbit_{i:03d}{suffix}.png")
                             for i in range(len(poses))],
                            [_channel_image(r, ch, depth_range) for r in results])
        print(f"wrote {len(poses)} orbit frames ({','.join(channels)}) to {args.out}/")
        print(json.dumps({"frames": len(poses), "width": ds.width, "height": ds.height,
                          "device": str(dev), "ms_per_frame": float(np.mean(ms)),
                          "ms": ms}))
        return 0

    res = render_pose_result(renderer, params, ds.poses[args.pose_index], ds.width, ds.height,
                             ds.camera, cfg.scene.scene_scale,
                             chunk_size=cfg.render.chunk_size, occupancy=payload, device=dev)
    base, ext = os.path.splitext(args.out)
    for ch in channels:
        path = args.out if ch == "rgb" or len(channels) == 1 else f"{base}_{ch}{ext or '.png'}"
        write_png(path, _channel_image(res, ch))
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
