"""Command line of the port: `python -m tnerf_torch.cli
train|eval|render|suite|mesh|bake|config`.

Trains a field through the pipeline its config names (`render.pipeline`:
fused, grid_march, grid_intervals or uniform) on the scene it names
(`scene.kind`: procedural, nerf_synthetic, llff or colmap; `scene.ndc`
warps forward-facing rays into NDC; `train.optimize_poses` refines the
training poses), and serves a checkpoint written by this port or by the
reference package (`tnerf.cli train`), on the card (`--device cuda`, the
default) or through the plain PyTorch versions on the CPU (`--device
cpu`): `eval` and `render` (`--orbit N --gif` adds an animated GIF) read
the weight EMA where the config keeps one (`train.param_ema`); `suite`
evaluates <out_dir>/<scene>/checkpoints of several scenes; `mesh` extracts
the density isosurface of a checkpoint as an OBJ (marching tetrahedra,
`--vertex-colors` from the field); `bake` evaluates the field into a dense
lookup grid (an npz) and with `--eval` renders the test split through it
against the march render of the same checkpoint; `config [--diff]` prints
the resolved config (or the overrides that make it).
Configs are the reference's JSON files; options this port does not run yet
are refused (`train_loop.validate_ported`).

    python -m tnerf_torch.cli train --config runs/suite_rehearsal/prims/config.json \\
        --out runs/prims_torch
    python -m tnerf_torch.cli eval --config runs/suite_rehearsal/prims/config.json \\
        --checkpoint runs/suite_rehearsal/prims/checkpoints
    python -m tnerf_torch.cli train --config runs/colmap_rehearsal/config.json \\
        -o scene.root=data/colmap --out runs/colmap_torch
    python -m tnerf_torch.cli suite --config runs/suite_rehearsal/prims/config.json \\
        -o logging.out_dir=runs/suite_rehearsal --scenes prims,rings,layers
    python -m tnerf_torch.cli mesh --config runs/suite_rehearsal/prims/config.json \
        --checkpoint runs/suite_rehearsal/prims/checkpoints --out prims.obj --vertex-colors
    python -m tnerf_torch.cli bake --config runs/suite_rehearsal/prims/config.json \
        --checkpoint runs/suite_rehearsal/prims/checkpoints --bake-res 256 --eval \
        -o logging.out_dir=runs/prims_baked
    python -m tnerf_torch.cli config --config configs/procedural_hard_30db.json --diff
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
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
    (`tnerf/cli.py:35`): whether the configured renderer compacts rays at
    all, and the pooling resolution and midpoint count of its keep rule.
    Fused, uniform placement: a ray is kept for an occupied midpoint sample
    on the kernel's coarse bitfield; fused, CDF placement: for an occupied
    bin on the bin-probe pooling.  grid_march compacts only where its eval
    runs kernel B4 (tighten on, sampler.tighten_res < the grid's and <= 32,
    a mask resolution no coarser): it pools at sampler.tighten_res and
    probes cdf_bins midpoints under either CDF placement, else
    samples_per_ray (`tnerf/render/grid_renderer.py:158-219`)."""
    from tnerf_torch.render.fused import select_bin_pool_res, select_coarse_res

    if not cfg.render.ray_compact:
        return False, None, None
    res = cfg.grid.resolution
    if cfg.render.pipeline == "fused" and cfg.render.fused_tighten:
        if cfg.sampler.placement == "occupancy_cdf":
            return True, select_bin_pool_res(res), cfg.sampler.cdf_bins
        return True, select_coarse_res(cfg.render, res), cfg.sampler.samples_per_ray
    t_res = min(cfg.sampler.tighten_res or res, res)
    m_res = min(cfg.sampler.occupancy_mask_res or res, res)
    if cfg.render.pipeline == "grid_march" and cfg.sampler.tighten and m_res >= t_res \
            and t_res < res and t_res <= 32:
        cdf = cfg.sampler.placement in ("occupancy_cdf", "density_cdf")
        return True, t_res, cfg.sampler.cdf_bins if cdf else cfg.sampler.samples_per_ray
    return False, None, None


def ray_keep_fraction(rays, occupancy, cfg: Config, pool_res: int, n_mid: int) -> float:
    """The share of `rays` ([H, W] or flat) that the compacting renderer
    keeps, by the rule it runs: `tighten_sample_mask` on the occupancy
    bitfield pooled to pool_res (256 tighten probes on the fused pipeline,
    sampler.tighten_probes on grid_march), any of the n_mid midpoints
    occupied."""
    from tnerf_torch.grid.tighten import tighten_sample_mask
    from tnerf_torch.grid.traversal import make_coarse_occupancy, ray_aabb

    res = cfg.grid.resolution
    o = rays.origins.reshape(-1, 3).float().contiguous()
    d = rays.directions.reshape(-1, 3).float().contiguous()
    te, tx = ray_aabb(o, d, cfg.grid.aabb_min, cfg.grid.aabb_max)
    te = torch.clamp_min(te, float(cfg.sampler.near))
    tx = torch.maximum(tx, te)
    occ_c = make_coarse_occupancy(occupancy.reshape(res, res, res), res // pool_res)
    probes = cfg.sampler.tighten_probes if cfg.render.pipeline == "grid_march" else 256
    _, _, mask = tighten_sample_mask(o, d, te, tx, occ_c, n_mid, cfg.grid, probes=probes)
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
                    help="output PNG; with --orbit / --path, a directory of orbit_###.png / "
                    "path_###.png frames")
    sp.add_argument("--orbit", type=int, default=0, metavar="N",
                    help="render N novel views on a circular orbit instead of a dataset pose")
    sp.add_argument("--path", default=None, metavar="POSES_JSON",
                    help="render a camera path: a JSON list of 4x4 (or 3x4) camera-to-world "
                    "matrices, or {\"poses\": [...]} (not with --orbit)")
    sp.add_argument("--refined-poses", action="store_true",
                    help="apply the checkpoint's learned pose delta of --pose-index "
                    "(train.optimize_poses checkpoints, --split train only)")
    sp.add_argument("--orbit-elevation", type=float, default=None, metavar="RAD",
                    help="orbit elevation in radians (default: the split cameras' mean)")
    sp.add_argument("--channels", default="rgb", metavar="LIST",
                    help="comma list of rgb, depth, acc; extra channels get a _depth/_acc suffix")
    sp.add_argument("--gif", action="store_true",
                    help="with --orbit / --path: also write the frames as an animated "
                    "<out>/orbit.gif (or path.gif), 10 frames a second (rgb, else the first "
                    "channel)")

    sp = sub.add_parser("eval", help="PSNR/SSIM over the val and test splits from a checkpoint")
    common(sp)
    sp.add_argument("--out", default=None, help="also write the metrics JSON to this file")
    sp.add_argument("--save-renders", default=None, metavar="DIR",
                    help="also write each evaluated view's render as DIR/<split>_###.png")

    sp = sub.add_parser("suite", help="test-set eval of several scenes, each from "
                        "<out_dir>/<scene>/checkpoints (renders to "
                        "<out_dir>/<scene>/suite_renders)")
    common(sp)
    sp.add_argument("--scenes", default="chair,drums,ficus,hotdog,lego,materials,mic,ship",
                    help="comma-separated scene names (scene.name of each)")

    sp = sub.add_parser("mesh", help="extract the density isosurface of a checkpoint as an OBJ "
                        "(marching tetrahedra; no dataset needed)")
    common(sp)
    sp.add_argument("--out", default="mesh.obj")
    sp.add_argument("--resolution", type=int, default=128,
                    help="density sampling cells per AABB axis (the vertex grid is N+1)")
    sp.add_argument("--threshold", type=float, default=None,
                    help="density iso level (default: grid.density_threshold)")
    sp.add_argument("--vertex-colors", action="store_true",
                    help="per-vertex RGB from the field, seen along the inward surface normal "
                    "(written as the `v x y z r g b` OBJ vertex-colour extension)")

    sp = sub.add_parser("bake", help="bake a checkpoint's field into a dense RGB + density grid "
                        "for lookup-only rendering (render/baked.py)")
    common(sp)
    sp.add_argument("--out", default=None,
                    help="output npz (default <out_dir>/baked/baked_<res>.npz)")
    sp.add_argument("--bake-res", type=int, default=256,
                    help="vertex-grid resolution per axis (memory: res^3 * 16 B)")
    sp.add_argument("--mode", default="trilinear_brick",
                    choices=("nearest", "trilinear", "trilinear_brick"),
                    help="lookup mode of the --eval render (the npz stores the unpacked "
                    "[R^3, 4] table)")
    sp.add_argument("--eval", action="store_true",
                    help="render the test split through the bake and write "
                    "<out_dir>/baked_parity.json: its PSNR against the grid_march render of "
                    "the same checkpoint")

    sp = sub.add_parser("config", help="print the resolved config JSON")
    sp.add_argument("--config", help="JSON config file")
    sp.add_argument("--override", "-o", action="append", default=[],
                    help="config override key.path=value (repeatable)")
    sp.add_argument("--diff", action="store_true",
                    help="print only the overrides that differ from the defaults, one "
                    "section.key=value a line (usable as -o arguments)")
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

    if args.cmd == "config":
        for line in cfg.diff_overrides() if args.diff else [cfg.to_json()]:
            print(line)
        return 0
    if args.cmd == "train":
        from tnerf_torch.parallel import comm
        from tnerf_torch.train_loop import run_training

        final = run_training(cfg, device=args.device)
        if comm.global_rank() == 0:
            print(json.dumps(final, indent=2))
        return 0
    if args.cmd == "suite":
        return _run_suite(cfg, args.scenes.split(","), args.device)
    if args.cmd == "mesh":
        return _run_mesh(args, cfg)
    if args.cmd == "bake":
        # before the config's renderer is validated and built: a bake needs
        # only the field (its renderer is the march one), so e.g. a fused
        # refusal must not stop a bake that never runs the fused path
        return _run_bake(args, cfg)

    from tnerf_torch.device import resolve_device
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.train_loop import (
        build_renderer,
        load_datasets,
        ndc_near_or_none,
        resolve_near_far,
        validate_ported,
    )
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    validate_ported(cfg)
    dev, mesh = _eval_mesh(cfg, resolve_device(args.device))
    main = mesh is None or mesh.rank == 0
    channels = []
    if args.cmd == "render":
        channels = [c.strip() for c in args.channels.split(",") if c.strip()]
        bad = [c for c in channels if c not in ("rgb", "depth", "acc")]
        if bad or not channels:
            print(f"error: unknown --channels {bad or args.channels!r} "
                  "(choose from rgb, depth, acc)", file=sys.stderr)
            return 1
        if args.orbit > 0 and args.path:
            print("error: --orbit and --path are mutually exclusive", file=sys.stderr)
            return 1
        if args.orbit > 0 and cfg.scene.ndc:
            print("error: --orbit renders a full turntable, but scene.ndc "
                  "only covers the forward-facing frustum — render a "
                  "forward-facing sequence with --path poses.json instead", file=sys.stderr)
            return 1
    seq_poses = None
    if args.cmd == "render" and args.path:
        seq_poses = _read_path(args.path)
        if isinstance(seq_poses, str):
            print(f"error: {seq_poses}", file=sys.stderr)
            return 1
    splits = ("val", "test") if args.cmd == "eval" else (args.split,)
    datasets = load_datasets(cfg, splits=splits, device=dev)
    if not any(sp in datasets for sp in splits):
        print(f"error: the scene has none of the splits {splits}", file=sys.stderr)
        return 1
    # sampler.near/far = -1 (auto) resolves from the depth bounds of the
    # first split the loader returns, as the reference's CLI does
    cfg = resolve_near_far(cfg, next(iter(datasets.values())))
    ndc = ndc_near_or_none(cfg)
    ckpt_dir = args.checkpoint or os.path.join(cfg.logging.out_dir, "checkpoints")
    step, params, occ = load_jax_checkpoint(ckpt_dir, device=dev, ema=cfg.train.param_ema > 0)
    if main:
        print(f"restored step {step} from {ckpt_dir}", file=sys.stderr)
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    renderer = build_renderer(cfg, for_eval=True)
    # Capacity guards: the keep fraction depends on the restored occupancy
    # (a trained grid is fatter than an analytic one); kept rays beyond
    # render.ray_compact_fraction render as background, and kept samples
    # beyond render.compact_fraction are dropped, without a word.
    trained_grid = occ is not None and step > 0
    guard_on, guard_pool, guard_mid = _ray_compact_guard(cfg) if trained_grid \
        else (False, None, None)
    cdf_guard = (trained_grid and cfg.sampler.placement in ("occupancy_cdf", "density_cdf")
                 and cfg.render.compact and cfg.render.pipeline == "grid_march")
    if guard_on or cdf_guard:
        from tnerf_torch.cameras import camera_rays, ndc_warp

        ds0 = next(iter(datasets.values()))
        probe_rays = camera_rays(ds0.poses[0], ds0.width, ds0.height, ds0.camera,
                                 cfg.scene.scene_scale, device=dev)
        if ndc is not None:
            probe_rays = ndc_warp(probe_rays, ds0.width, ds0.height, ds0.camera, ndc, eager=True)
    kf = 1.0
    if guard_on:
        kf = ray_keep_fraction(probe_rays, occ.bitfield, cfg, guard_pool, guard_mid)
        if kf > cfg.render.ray_compact_fraction and main:
            print(
                f"WARNING: ray-compaction keep fraction {kf:.3f} on the "
                f"probe view exceeds render.ray_compact_fraction="
                f"{cfg.render.ray_compact_fraction} — over-capacity rays "
                f"will render as background. Raise the fraction (or set "
                f"render.ray_compact=false).",
                file=sys.stderr,
            )
    if cdf_guard:
        from tnerf_torch.render.grid_renderer import cdf_occupied_sample_fraction

        sf = float(cdf_occupied_sample_fraction(probe_rays, payload, cfg.grid, cfg.sampler))
        needed = sf / max(kf, 1e-6) if guard_on else sf
        if needed > cfg.render.compact_fraction and main:
            print(
                f"WARNING: occupancy-CDF occupied-sample fraction "
                f"{needed:.3f} (probe view, per kept ray) exceeds "
                f"render.compact_fraction={cfg.render.compact_fraction}"
                f" — over-capacity samples will be dropped. Raise the "
                f"fraction (or set render.compact=false).",
                file=sys.stderr,
            )

    if args.cmd == "eval":
        from tnerf_torch.eval import evaluate

        out = {}
        for split in splits:
            if split in datasets:
                out.update(evaluate(
                    renderer, params, datasets[split], cfg.scene.scene_scale,
                    white_background=cfg.scene.white_background,
                    save_dir=args.save_renders if main else None,
                    chunk_size=cfg.render.chunk_size, occupancy=payload, device=dev,
                    ndc_near=ndc, mesh=mesh,
                ))
        if not main:
            return 0
        text = json.dumps(out, indent=2)
        print(text)
        if args.out:
            with open(args.out, "w") as fh:
                fh.write(text + "\n")
        return 0

    from tnerf_torch.data.png_io import write_png, write_png_batch
    from tnerf_torch.eval import hit_depths, render_pose_result

    if args.split not in datasets:
        print(f"error: the scene has no {args.split!r} split", file=sys.stderr)
        return 1
    ds = datasets[args.split]
    seq_tag = "path"
    if args.orbit > 0:
        from tnerf_torch.data.procedural import orbit_poses

        # orbit at the split cameras' mean radius / elevation, as the
        # reference does, so the novel path stays inside the trained views
        eyes = np.asarray(ds.poses)[:, :3, 3]
        norms = np.linalg.norm(eyes, axis=1)
        radius = float(norms.mean())
        elev = (args.orbit_elevation if args.orbit_elevation is not None else
                float(np.arcsin(np.clip(eyes[:, 2] / np.maximum(norms, 1e-9), -1, 1)).mean()))
        seq_poses, seq_tag = list(orbit_poses(args.orbit, radius, elev)), "orbit"
    if seq_poses is not None:
        if main:
            os.makedirs(args.out, exist_ok=True)
        results, ms = [], []
        for pose in seq_poses:
            _sync(dev)
            t0 = time.perf_counter()
            results.append(render_pose_result(
                renderer, params, pose, ds.width, ds.height, ds.camera, cfg.scene.scene_scale,
                chunk_size=cfg.render.chunk_size, occupancy=payload, device=dev, ndc_near=ndc,
                mesh=mesh))
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        if not main:
            return 0
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
        frames = {ch: [_channel_image(r, ch, depth_range) for r in results] for ch in channels}
        for ch in channels:
            suffix = "" if ch == "rgb" or len(channels) == 1 else f"_{ch}"
            write_png_batch([os.path.join(args.out, f"{seq_tag}_{i:03d}{suffix}.png")
                             for i in range(len(seq_poses))], frames[ch])
        print(f"wrote {len(seq_poses)} {seq_tag} frames ({','.join(channels)}) to {args.out}/")
        if args.gif:
            from tnerf_torch.data.gif_io import write_gif

            gif = os.path.join(args.out, f"{seq_tag}.gif")
            write_gif(gif, [np.asarray(torch.as_tensor(f).cpu()) for f in
                            frames["rgb" if "rgb" in channels else channels[0]]])
            print(f"wrote {gif}")
        print(json.dumps({"frames": len(seq_poses), "width": ds.width, "height": ds.height,
                          "device": str(dev), "ms_per_frame": float(np.mean(ms)),
                          "ms": ms}))
        return 0

    pose_delta = None
    if args.refined_poses:
        if "pose_deltas" not in params:
            print("error: --refined-poses needs a train.optimize_poses checkpoint (no "
                  "pose_deltas leaf restored)", file=sys.stderr)
            return 1
        if args.split != "train":
            print(f"error: --refined-poses applies per-TRAIN-image deltas; --split "
                  f"{args.split} poses were never refined", file=sys.stderr)
            return 1
        if params["pose_deltas"].shape[0] != len(ds):
            print(f"error: the checkpoint holds {params['pose_deltas'].shape[0]} pose deltas "
                  f"for {len(ds)} training views", file=sys.stderr)
            return 1
        pose_delta = params["pose_deltas"][args.pose_index]
    res = render_pose_result(renderer, params, ds.poses[args.pose_index], ds.width, ds.height,
                             ds.camera, cfg.scene.scene_scale,
                             chunk_size=cfg.render.chunk_size, occupancy=payload, device=dev,
                             ndc_near=ndc, pose_delta=pose_delta, mesh=mesh)
    if not main:
        return 0
    base, ext = os.path.splitext(args.out)
    for ch in channels:
        path = args.out if ch == "rgb" or len(channels) == 1 else f"{base}_{ch}{ext or '.png'}"
        write_png(path, _channel_image(res, ch))
        print(f"wrote {path}")
    return 0


def _run_mesh(args, cfg: Config) -> int:
    """`mesh` (`tnerf/cli.py:244-313`): the density of the checkpoint's eval
    parameters (the weight EMA's where the config keeps one) sampled on a
    (resolution+1)^3 vertex grid over the AABB on the device, the
    isosurface at --threshold by marching tetrahedra, written as an OBJ;
    with --vertex-colors each vertex's RGB from the field seen along its
    inward normal, 65,536 vertices a chunk.  No dataset is read: the
    checkpoint's treedef gives its layout, a pose-refinement one's
    included.  Exit status 1 on an empty isosurface."""
    from tnerf_torch.cameras import viewdirs_to_thetaphi
    from tnerf_torch.device import resolve_device
    from tnerf_torch.fields.nerf_field import NeRFField, apply_field
    from tnerf_torch.grid.marching import extract_density_mesh, save_obj, vertex_normals
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = resolve_device(args.device)
    ckpt_dir = args.checkpoint or os.path.join(cfg.logging.out_dir, "checkpoints")
    step, params, _ = load_jax_checkpoint(ckpt_dir, device=dev, ema=cfg.train.param_ema > 0)
    print(f"restored step {step} from {ckpt_dir}", file=sys.stderr)
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator()).to(dev)
    verts, faces = extract_density_mesh(lambda x: field.density(x, params), cfg.grid,
                                        resolution=args.resolution, level=args.threshold,
                                        device=dev)
    if faces.shape[0] == 0:
        print("error: empty isosurface — is --threshold above the field's max density?",
              file=sys.stderr)
        return 1
    colors = None
    if args.vertex_colors:
        nrm = vertex_normals(verts, faces)
        chunk = 1 << 16
        cols = []
        with torch.no_grad():
            for s in range(0, len(verts), chunk):
                v = torch.from_numpy(verts[s:s + chunk]).to(dev)
                tp = viewdirs_to_thetaphi(torch.from_numpy(-nrm[s:s + chunk]).to(dev))
                rgb, _ = apply_field(params, cfg.field_, cfg.grid, v, tp)
                cols.append(rgb.float().cpu().numpy())
        colors = np.concatenate(cols)
    save_obj(args.out, verts, faces, colors)
    tag = " (vertex colors)" if colors is not None else ""
    print(f"wrote {args.out}: {len(verts)} vertices, {len(faces)} faces{tag}")
    return 0


def _run_bake(args, cfg: Config) -> int:
    """`bake` (`tnerf/cli.py:749-820`): the checkpoint's eval parameters
    evaluated into a dense [R^3, 4] grid on the device
    (`render/baked.bake_field`: inward radial views, log1p density, the
    vertices outside the occupancy's 6-neighbourhood zeroed), saved as an
    npz (`table` float16, `bake_res`); with --eval the test split rendered
    through the bake (`make_baked_renderer`, the march renderer with the
    table lookup as its shade stage) and through render.pipeline=grid_march
    on the field itself, both with the checkpoint's occupancy, written to
    <out_dir>/baked_parity.json with the reference's keys and rounding."""
    from tnerf_torch.device import resolve_device
    from tnerf_torch.eval import evaluate
    from tnerf_torch.fields.nerf_field import apply_field
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.render.baked import bake_field, make_baked_renderer
    from tnerf_torch.train_loop import (
        build_renderer,
        load_datasets,
        ndc_near_or_none,
        resolve_near_far,
    )
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = resolve_device(args.device)
    datasets = load_datasets(cfg, splits=("test",), device=dev) if args.eval else {}
    if args.eval:
        if "test" not in datasets:
            print("error: bake --eval needs the scene's test split", file=sys.stderr)
            return 1
        cfg = resolve_near_far(cfg, datasets["test"])
    ndc = ndc_near_or_none(cfg)
    ckpt_dir = args.checkpoint or os.path.join(cfg.logging.out_dir, "checkpoints")
    step, params, occ = load_jax_checkpoint(ckpt_dir, device=dev, ema=cfg.train.param_ema > 0)
    print(f"restored step {step} from {ckpt_dir}", file=sys.stderr)
    _sync(dev)
    t0 = time.perf_counter()
    table = bake_field(lambda p, x, v: apply_field(p, cfg.field_, cfg.grid, x, v), params,
                       cfg.grid, bake_res=args.bake_res,
                       occupancy=None if occ is None else occ.bitfield, device=dev)
    _sync(dev)
    bake_s = time.perf_counter() - t0
    out_npz = args.out or os.path.join(cfg.logging.out_dir, "baked", f"baked_{args.bake_res}.npz")
    os.makedirs(os.path.dirname(out_npz) or ".", exist_ok=True)
    # the compression runs on the host beside the evals (zlib lets go of the
    # interpreter while it compresses)
    writer = threading.Thread(target=np.savez_compressed, args=(out_npz,), kwargs=dict(
        table=table.cpu().numpy().astype(np.float16), bake_res=args.bake_res))
    writer.start()

    def written() -> None:
        writer.join()
        print(f"baked {args.bake_res}^3 grid in {bake_s:.1f}s -> {out_npz} "
              f"({os.path.getsize(out_npz) / 1e6:.0f} MB)", file=sys.stderr)

    if not args.eval:
        written()
        return 0
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    test = datasets["test"]
    kw = dict(white_background=cfg.scene.white_background, chunk_size=cfg.render.chunk_size,
              occupancy=payload, device=dev, ndc_near=ndc)
    brend = make_baked_renderer(table, args.bake_res, cfg.grid, cfg.sampler, cfg.render,
                                mode=args.mode)
    del table
    mb = evaluate(brend, brend.params, test, cfg.scene.scene_scale, **kw)
    # the parity reference: the same checkpoint rendered through the march
    # pipeline at the config's own quadrature
    drend = build_renderer(cfg.apply_overrides(["render.pipeline=grid_march"]), for_eval=True)
    md = evaluate(drend, params, test, cfg.scene.scene_scale, **kw)
    written()
    print(f"render_ms_test: baked {mb['render_ms_test']:.2f}, march {md['render_ms_test']:.2f}",
          file=sys.stderr)
    keys = ("psnr_test", "psnr_test_min", "ssim_test", "n_views_test")  # the reference's
    art = {
        "bake_res": args.bake_res, "mode": args.mode,
        "bake_seconds": round(bake_s, 1),
        "baked": {k: round(float(mb[k]), 4) for k in keys},
        "march": {k: round(float(md[k]), 4) for k in keys},
        "parity_db": round(abs(float(md["psnr_test"]) - float(mb["psnr_test"])), 4),
        "checkpoint_step": step,
    }
    os.makedirs(cfg.logging.out_dir, exist_ok=True)
    with open(os.path.join(cfg.logging.out_dir, "baked_parity.json"), "w") as fh:
        json.dump(art, fh, indent=2)
    print(json.dumps(art, indent=2))
    return 0


def _eval_mesh(cfg: Config, dev):
    """(this rank's device, the eval's data-parallel mesh or None) of
    `eval`, `render` and `suite` (`tnerf/cli.py:436-444`): launched by
    `python -m torch.distributed.run`, every chunk's rays split over
    parallel.data_parallel ranks (-1: every rank), rank 0 writing; not
    launched, parallel.data_parallel = -1 is one device and no mesh."""
    from tnerf_torch.parallel import comm
    from tnerf_torch.parallel.mesh import make_mesh

    rank_dev = comm.init_from_env(dev)
    dev = dev if rank_dev is None else rank_dev
    n_dp = cfg.parallel.data_parallel
    n_dp = comm.world_size() if n_dp == -1 else n_dp
    if rank_dev is None and n_dp == 1:
        return dev, None
    return dev, make_mesh(n_dp, cfg.parallel.axis_name, device=dev)


def _run_suite(cfg: Config, scenes, device) -> int:
    """`suite` (`tnerf/cli.py:824`): the test split of each scene evaluated
    from <out_dir>/<scene>/checkpoints (the eval parameters: the weight EMA
    where the config keeps one), its renders written to
    <out_dir>/<scene>/suite_renders; a scene without data or without a
    checkpoint is skipped with a word on standard error.  Prints {"scenes":
    per-scene metrics, "mean_psnr_test"}; exit status 1 when no scene
    produced results."""
    from tnerf_torch.device import resolve_device
    from tnerf_torch.eval import evaluate
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.train_loop import (
        build_renderer,
        load_datasets,
        ndc_near_or_none,
        resolve_near_far,
    )
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev, mesh = _eval_mesh(cfg, resolve_device(device))
    main = mesh is None or mesh.rank == 0
    results = {}
    for scene in scenes:
        scene = scene.strip()
        scfg = cfg.apply_overrides([
            f"scene.name={scene}",
            f"logging.out_dir={os.path.join(cfg.logging.out_dir, scene)}",
        ])
        try:
            datasets = load_datasets(scfg, splits=("test",), device=dev)
        except (FileNotFoundError, ValueError) as e:
            print(f"{scene}: SKIP (no data: {e})", file=sys.stderr)
            continue
        scfg = resolve_near_far(scfg, datasets["test"])
        ckpt_dir = os.path.join(scfg.logging.out_dir, "checkpoints")
        renderer = build_renderer(scfg, for_eval=True, compact=False)
        try:
            _, params, occ = load_jax_checkpoint(ckpt_dir, device=dev,
                                                 ema=scfg.train.param_ema > 0)
        except FileNotFoundError:
            print(f"{scene}: SKIP (no checkpoint found in {ckpt_dir})", file=sys.stderr)
            continue
        results[scene] = evaluate(
            renderer, params, datasets["test"], scfg.scene.scene_scale,
            white_background=scfg.scene.white_background,
            save_dir=os.path.join(scfg.logging.out_dir, "suite_renders") if main else None,
            chunk_size=scfg.render.chunk_size,
            occupancy=renderer_payload(occ, scfg.sampler, scfg.grid), device=dev,
            ndc_near=ndc_near_or_none(scfg), mesh=mesh,
        )
        if main:
            print(f"{scene}: {results[scene]}", file=sys.stderr)
    if results and not main:
        return 0
    if results:
        mean_psnr = sum(r["psnr_test"] for r in results.values()) / len(results)
        print(json.dumps({"scenes": results, "mean_psnr_test": mean_psnr}, indent=2))
        return 0
    print("error: no scene produced results", file=sys.stderr)
    return 1


def _read_path(path: str):
    """The camera path of `render --path` (`tnerf/cli.py:500`): a JSON list
    of 4x4 or 3x4 camera-to-world matrices, or {"poses": [...]} -> a list
    of [4, 4] float32 arrays; an error message (a str) otherwise."""
    try:
        with open(path) as fh:
            d = json.load(fh)
    except (OSError, ValueError) as e:
        return f"cannot read poses from {path}: {e}"
    pose_list = d.get("poses") if isinstance(d, dict) else d
    if not isinstance(pose_list, list):
        return f'{path} must be a JSON list of poses or {{"poses": [...]}}'
    poses = []
    for i, p in enumerate(pose_list):
        try:
            m = np.asarray(p, np.float32)
        except (ValueError, TypeError):
            m = np.zeros((0,), np.float32)  # ragged: the shape error below
        if m.shape == (3, 4):
            m = np.concatenate([m, np.asarray([[0, 0, 0, 1]], np.float32)])
        if m.shape != (4, 4):
            return f"pose {i} in {path} has shape {m.shape}; expected 4x4 or 3x4 c2w"
        poses.append(m)
    if not poses:
        return f"{path} contains no poses"
    return poses


if __name__ == "__main__":
    sys.exit(main())
