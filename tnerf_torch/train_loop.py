"""High-level training orchestration and renderer construction
(counterpart of `tnerf/train_loop.py`, single device: `_run_training_single`,
:514-1034, and `build_renderer`, :70)."""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tnerf_torch.config import Config
from tnerf_torch.data.dataset import (
    ImageDataset,
    load_data,
    scene_llff_kwargs,
    scene_proc_kwargs,
    validate_scene_background,
)
from tnerf_torch.device import resolve_device
from tnerf_torch.eval import evaluate
from tnerf_torch.fields.hashgrid import resolve_gather_mode
from tnerf_torch.fields.nerf_field import TABLE_ENCODINGS, NeRFField
from tnerf_torch.fields.triplane import resolve_cp_mode, resolve_tri_mode, upsample_triplane
from tnerf_torch.grid.occupancy import (
    init_occupancy,
    occupancy_fraction,
    renderer_payload,
    update_occupancy,
)
from tnerf_torch.render.fused import make_fused_renderer
from tnerf_torch.render.grid_renderer import cdf_occupied_sample_fraction, make_grid_renderer
from tnerf_torch.render.renderer import make_uniform_renderer
from tnerf_torch.train import (
    Optimizer,
    PixelSampler,
    eval_params,
    init_train_state,
    make_train_step,
    pose_extra_params,
)
from tnerf_torch.utils.checkpoint import (
    latest_checkpoint,
    load_jax_checkpoint,
    read_train_checkpoint,
    save_checkpoint,
    save_train_state,
)
from tnerf_torch.utils.metrics import MetricsWriter, get_logger, maybe_profile


PIPELINES = ("fused", "grid_march", "grid_intervals", "uniform")


def validate_ported(cfg: Config, for_eval: bool = True) -> None:
    """Refuse every option this port does not run, rather than running
    another path in its place.  for_eval=False checks a training run."""
    p = cfg.render.pipeline
    f = cfg.field_
    if p not in PIPELINES:
        raise ValueError(f"unknown render pipeline {p!r}")
    if f.encoding not in ("frequency",) + TABLE_ENCODINGS:
        raise ValueError(f"unknown encoding {f.encoding!r}")
    if f.view_encoding not in ("frequency", "sh"):
        raise ValueError(f"unknown view_encoding {f.view_encoding!r}")
    if f.view_param not in ("thetaphi", "unit"):
        raise ValueError(f"unknown view_param {f.view_param!r}")
    if f.encoding == "hashgrid":  # the lookup modes: "pallas" and unknown ones raise
        resolve_gather_mode(f)
    elif f.encoding == "triplane":
        resolve_tri_mode(f)
    elif f.encoding == "cp":
        resolve_cp_mode(f)
    if p == "fused" and f.encoding != "frequency":
        raise ValueError(
            "render.pipeline=fused bakes the frequency encoding into "
            f"the kernel; field_.encoding={f.encoding!r} needs "
            "render.pipeline=grid_march (hashgrid runs as MXU one-hot "
            "matmuls there — see configs/procedural_hard_hashgrid.json)"
        )
    if p == "fused" and f.view_encoding != "frequency":
        raise ValueError(
            "render.pipeline=fused bakes the frequency VIEW encoding "
            "into the kernel (gamma/beta algebra); "
            f"field_.view_encoding={f.view_encoding!r} needs "
            "render.pipeline=grid_march"
        )
    if p == "fused" and f.view_encoding == "frequency" and f.view_param == "unit":
        # the reference's kernel packs (x, y, z, theta, phi) and fails at its
        # first render, when layer 0's 3-wide view columns meet its 2-wide
        # view encoding (`tnerf/render/pallas_fused2.py:89`)
        raise ValueError(
            "render.pipeline=fused bakes the (theta, phi) frequency view "
            "encoding into the kernel; field_.view_param='unit' needs "
            "render.pipeline=grid_march, grid_intervals or uniform"
        )
    validate_ndc(cfg)
    if cfg.sampler.placement not in ("uniform", "occupancy_cdf", "density_cdf"):
        raise ValueError(f"sampler.placement={cfg.sampler.placement!r} must be uniform, "
                         "occupancy_cdf or density_cdf")
    if cfg.sampler.placement != "uniform" and p not in ("grid_march", "fused"):
        raise ValueError(
            f"sampler.placement={cfg.sampler.placement!r} needs "
            f"render.pipeline='grid_march' or 'fused' (got {p!r}): "
            "grid_intervals places samples per traversal interval"
        )
    if cfg.sampler.placement == "density_cdf" and p == "fused":
        raise ValueError(
            "sampler.placement='density_cdf' is a grid_march quadrature: "
            "the fused kernel's CDF fold probes binary occupancy bins "
            "(occupancy_cdf); density-weighted placement needs the "
            "density-EMA probes of the march path"
        )
    if cfg.sampler.placement == "occupancy_cdf" and p == "fused" \
            and not cfg.render.fused_tighten:
        raise ValueError(
            "fused occupancy_cdf placement needs render.fused_tighten="
            "true (bin weights come from the tighten+sample-mask kernel)"
        )
    if for_eval:
        return
    t = cfg.train
    validate_parallel(cfg)
    if t.freq_anneal_steps > 0:  # `tnerf/train_loop.py:667-681`
        if f.encoding != "frequency":
            raise ValueError(
                "train.freq_anneal_steps anneals the frequency positional "
                "encoding (the grid families have their own coarse-to-fine:"
                " hash_nearest_levels / tri_upsample_steps); "
                f"field_.encoding={f.encoding!r}"
            )
        if p == "fused":
            raise ValueError(
                "train.freq_anneal_steps needs the XLA field path; the "
                "fused kernel bakes the full-frequency encoding algebra "
                "— use grid_march, grid_intervals or uniform"
            )
    if t.table_tv_weight > 0.0 and f.encoding != "triplane":
        raise ValueError(
            "train.table_tv_weight is the triplane family's smoothness "
            "prior (hash tables have no spatial adjacency); "
            f"field_.encoding={f.encoding!r}"
        )
    if t.optimize_poses:
        _validate_pose_opt(cfg)
    if f.tri_upsample_steps:
        _tri_stage_plan(cfg)
    if t.shuffle not in ("random", "epoch"):
        raise ValueError(f"train.shuffle must be random or epoch, got {t.shuffle!r}")
    if t.distortion_weight > 0.0:
        if p == "fused":
            raise ValueError(
                "train.distortion_weight needs per-sample compositing "
                "weights; the fused kernel composites on-chip and never "
                "materializes them — use grid_march, grid_intervals or "
                "uniform"
            )
        if p == "grid_march" and cfg.render.compact:
            raise ValueError(
                "train.distortion_weight does not compose with "
                "render.compact on grid_march (the packed-compaction "
                "compositor returns no per-sample weights) — set "
                "render.compact=false"
            )


def validate_parallel(cfg: Config) -> None:
    """The parallel axes' preconditions (`tnerf/train_loop.py:558-574`,
    `:653-659`, `:755-759`): sample parallelism shards grid_intervals'
    samples of whole-ray quadratures, table parallelism hash-grid levels
    or triplane features, and the two compose on the hash grid only."""
    n_sp, n_tp = cfg.parallel.sample_parallel, cfg.parallel.table_parallel
    if n_sp > 1 and cfg.render.pipeline != "grid_intervals":
        raise ValueError(
            "parallel.sample_parallel shards the grid_intervals sample "
            f"axis; render.pipeline={cfg.render.pipeline!r}"
        )
    if n_tp > 1 and cfg.field_.encoding not in ("hashgrid", "triplane"):
        raise ValueError(
            "parallel.table_parallel shards hash-grid level tables or "
            f"triplane features; field_.encoding={cfg.field_.encoding!r}"
        )
    if n_tp > 1 and n_sp > 1 and cfg.field_.encoding != "hashgrid":
        raise ValueError(
            "sample-parallel x table-parallel composition folds the "
            "table-sharded encode into the SP shard_map (tp_encode_local)"
            " — hashgrid only; "
            f"field_.encoding={cfg.field_.encoding!r}"
        )
    if n_sp > 1 and cfg.train.random_background:
        raise ValueError(
            "train.random_background does not compose with "
            "parallel.sample_parallel yet (the SP renderer is built "
            "once with the configured background)"
        )
    if n_sp > 1 and cfg.train.distortion_weight > 0.0:
        raise ValueError(
            "train.distortion_weight needs whole-ray weight "
            "distributions; parallel.sample_parallel shards the "
            "sample axis across chips"
        )


def build_mesh(cfg: Config, device, log):
    """The run's mesh (`tnerf/train_loop.py:552-608`), or None: a mesh
    wherever a process group is formed (a launched group of one included)
    or a parallel axis above 1 is asked for.  parallel.data_parallel = -1 takes
    world_size // (sample_parallel * table_parallel) ranks.  Raises where
    the batch or the chunk does not divide, and where the mesh asks for
    more ranks than were launched."""
    import torch.distributed as dist

    from tnerf_torch.parallel import comm
    from tnerf_torch.parallel.mesh import make_mesh

    par = cfg.parallel
    n_sp, n_tp = par.sample_parallel, par.table_parallel
    extra_axis, n_extra = None, 1
    extra_axis2, n_extra2 = None, 1
    if n_sp > 1:
        extra_axis, n_extra = par.sample_axis_name, n_sp
        if n_tp > 1:
            extra_axis2, n_extra2 = par.table_axis_name, n_tp
    elif n_tp > 1:
        extra_axis, n_extra = par.table_axis_name, n_tp
    n_dp = par.data_parallel
    n_dp = max(1, comm.world_size() // (n_extra * n_extra2)) if n_dp == -1 else n_dp
    if not (dist.is_initialized() or n_dp > 1 or n_extra > 1 or n_extra2 > 1):
        return None
    if cfg.train.batch_size % n_dp != 0:
        raise ValueError(
            f"train.batch_size={cfg.train.batch_size} not divisible by "
            f"parallel.data_parallel={n_dp}"
        )
    if n_sp > 1 and cfg.render.chunk_size % n_dp != 0:
        raise ValueError(
            f"render.chunk_size={cfg.render.chunk_size} not divisible "
            f"by parallel.data_parallel={n_dp} (the sample-parallel "
            "renderer shards eval chunks over the data axis)"
        )
    mesh = make_mesh(n_dp, par.axis_name, extra_axis, n_extra, extra_axis2, n_extra2,
                     device=device, sample_axis=par.sample_axis_name,
                     model_axis=par.table_axis_name)
    log.info("mesh: %s", mesh.shape)
    return mesh


def jitter_generator(cfg: Config, mesh, gen: torch.Generator) -> torch.Generator:
    """The generator of the renderers' sample jitter.  Off a mesh, and on a
    mesh of one "data" rank, it is `gen`, which also draws the batches and
    the occupancy probes.  With more "data" ranks it is one stream per
    "data" shard, seeded from train.seed and the shard's coordinate, which
    the ranks that hold that shard's rays draw alike, so that the shards do
    not repeat each other's jitter."""
    if mesh is None or mesh.size(mesh.data_axis) == 1:
        return gen
    g = torch.Generator(device=gen.device)
    g.manual_seed(int(np.random.SeedSequence(
        [cfg.train.seed + 1, mesh.coord(mesh.data_axis)]).generate_state(1)[0]))
    return g


def build_renderer(cfg: Config, for_eval: bool = True, compact: Optional[bool] = None):
    """The renderer of `cfg.render.pipeline` (`tnerf/train_loop.py:70`):
    render(params, rays, occupancy=None, generator=None) -> RenderResult.

    fused: for_eval=False builds the training renderer, whose backward runs
    kernel B2 and which never compacts rays (render.ray_compact is an
    eval-only option there, `:146`).  grid_march: `compact` overrides
    render.compact (training marches densely while the occupancy grid is
    still dense and switches to the compacted variant once it has pruned,
    see `run_training`).  The unfused renderers are the same for training
    and eval: what differs is whether they are given a generator."""
    if cfg.scene.white_background != cfg.render.white_background:
        raise ValueError(
            "scene.white_background and render.white_background disagree "
            f"({cfg.scene.white_background} vs {cfg.render.white_background}): "
            "set both to the same value"
        )
    validate_ported(cfg, for_eval)
    p = cfg.render.pipeline
    if p == "uniform":
        return make_uniform_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render)
    if p == "grid_march":
        return make_grid_renderer(
            cfg.field_, cfg.grid, cfg.sampler, cfg.render, strategy="march",
            compact=cfg.render.compact if compact is None else compact,
            compact_fraction=cfg.render.compact_fraction)
    if p == "grid_intervals":
        return make_grid_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render,
                                  strategy="intervals")
    return make_fused_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render,
                               tighten=cfg.render.fused_tighten, for_eval=for_eval)


def validate_ndc(cfg: Config) -> None:
    """scene.ndc's preconditions (`tnerf/train_loop.py:151`): the warp
    projects along world -z from a recentred forward-facing capture, so a
    configuration that cannot mean that is refused."""
    if not cfg.scene.ndc:
        return
    if cfg.scene.kind == "nerf_synthetic":
        raise ValueError(
            "scene.ndc is the forward-facing (LLFF) parameterization; "
            "nerf_synthetic scenes are inward-facing 360 captures — "
            "rays behind the mean view direction cannot be warped"
        )
    if cfg.scene.kind in ("llff", "colmap") and not cfg.scene.llff_recenter:
        raise ValueError(
            "scene.ndc needs poses recentered to the mean camera frame: "
            "set scene.llff_recenter=true (and usually "
            "scene.llff_bd_rescale=0.75)"
        )
    if cfg.grid.mesh_path:
        raise ValueError(
            "grid.mesh_path voxelizes a WORLD-space mesh; under scene.ndc "
            "the grid lives in warped NDC coordinates — unset one of them"
        )
    if cfg.scene.ndc_near <= 0:
        raise ValueError(f"scene.ndc_near must be > 0, got {cfg.scene.ndc_near}")
    nf = (cfg.sampler.near, cfg.sampler.far)
    if nf not in ((-1.0, -1.0), (0.0, 1.0)):
        raise ValueError(
            "under scene.ndc the warped ray runs over t in [0, 1] (near "
            "plane to infinity): set sampler.near=-1 sampler.far=-1 "
            f"(auto) or exactly (0, 1); got {nf} — the world-space near "
            "plane is scene.ndc_near"
        )


def ndc_near_or_none(cfg: Config) -> Optional[float]:
    """The NDC warp's near plane for every site that makes rays, None
    where scene.ndc is off (`tnerf/train_loop.py:188`)."""
    return cfg.scene.ndc_near if cfg.scene.ndc else None


def _validate_pose_opt(cfg: Config) -> None:
    """Pose refinement needs the loss's gradient to reach the ray geometry
    (`tnerf/train_loop.py:470`): a configuration whose backward treats
    positions as constants is refused rather than learning nothing."""
    if cfg.render.pipeline == "fused":
        raise ValueError(
            "train.optimize_poses needs ray-geometry gradients; the "
            "fused kernel's VJP treats rays as non-differentiable — "
            "use grid_march, grid_intervals or uniform"
        )
    enc = cfg.field_.encoding
    mode = {"hashgrid": resolve_gather_mode, "cp": resolve_cp_mode,
            "triplane": resolve_tri_mode}.get(enc)
    if mode is not None and mode(cfg.field_) != "gather":
        name = {"hashgrid": "hash grid's", "cp": "CP", "triplane": "triplane"}[enc]
        knob = "hash_gather_mode" if enc == "hashgrid" else "tri_gather_mode"
        raise ValueError(
            "train.optimize_poses needs position gradients, but the "
            f"{name} onehot path returns zero position cotangents — set "
            f"field_.{knob}=gather"
        )


def resolve_near_far(cfg: Config, dataset: ImageDataset) -> Config:
    """Resolve sampler.near/far = -1 (auto) (`tnerf/train_loop.py:201`):
    under scene.ndc the warped ray spans [0, 1] by construction; else from
    the dataset's per-view depth bounds, near = 0.9 min, far = 1.1 max, in
    scene_scale units.  No-op when both are explicit."""
    if cfg.scene.ndc and (cfg.sampler.near < 0 or cfg.sampler.far < 0):
        return dataclasses.replace(cfg, sampler=dataclasses.replace(cfg.sampler, near=0.0,
                                                                    far=1.0))
    if cfg.sampler.near >= 0 and cfg.sampler.far >= 0:
        return cfg
    if dataset.near_far is None:
        raise ValueError(
            "sampler.near/far=-1 (auto) needs a dataset with per-view depth "
            "bounds; this scene has none — set explicit sampler.near and sampler.far"
        )
    lo = float(np.min(dataset.near_far)) * cfg.scene.scene_scale
    hi = float(np.max(dataset.near_far)) * cfg.scene.scene_scale
    near = 0.9 * lo if cfg.sampler.near < 0 else cfg.sampler.near
    far = 1.1 * hi if cfg.sampler.far < 0 else cfg.sampler.far
    return dataclasses.replace(cfg, sampler=dataclasses.replace(cfg.sampler, near=near, far=far))


def load_datasets(cfg: Config, splits=("train", "val", "test"), device="cuda"
                  ) -> Dict[str, ImageDataset]:
    """The scene of cfg.scene, checked (`tnerf/train_loop.py:_load_datasets`):
    its background, scene.ndc's preconditions; `splits` as `load_data`
    takes them; a procedural scene's ground truth is rendered on `device`."""
    validate_scene_background(cfg.scene.kind, cfg.scene.name, cfg.scene.white_background)
    validate_ndc(cfg)
    return load_data(cfg.scene.kind, cfg.scene.name, root=cfg.scene.root,
                     srgb_to_linear=cfg.scene.srgb_to_linear, downscale=cfg.scene.downscale,
                     splits=splits, proc=scene_proc_kwargs(cfg.scene),
                     llff=scene_llff_kwargs(cfg.scene), device=device)


def _eval(cfg, renderer, state, occ, datasets, step, log, metrics, device,
          save_images: bool = False, mesh=None) -> Dict[str, float]:
    """Eval of `eval_params(state)`: two views of each of the val and test
    splits, or with save_images every view, its render written (by rank 0
    of a mesh, over which every chunk's rays are split)."""
    out: Dict[str, float] = {}
    bits = renderer_payload(occ, cfg.sampler, cfg.grid)
    for split in ("val", "test"):
        if split not in datasets or len(datasets[split]) == 0:
            continue
        save_dir = os.path.join(cfg.logging.out_dir, f"renders_{step}") \
            if save_images and (mesh is None or mesh.rank == 0) else None
        m = evaluate(
            renderer, eval_params(state), datasets[split], cfg.scene.scene_scale,
            white_background=cfg.scene.white_background,
            max_views=None if save_images else 2, save_dir=save_dir,
            chunk_size=cfg.render.chunk_size, occupancy=bits, device=device,
            ndc_near=ndc_near_or_none(cfg), mesh=mesh,
        )
        out.update(m)
        log.info("eval step %d: %s", step, m)
        metrics.write(step, **m)
    return out


def _replicate_state(state, occ, mesh) -> None:
    """`parallel.mesh.replicate` of a train state initialised or resumed on
    every rank: the leaves every rank holds alike from rank 0, a
    table-parallel rank's blocks (and the optimizer's flat moments, which
    hold them) from the first rank of its "model" coordinate."""
    from tnerf_torch.parallel.mesh import replicate
    from tnerf_torch.parallel.table_parallel import tp_state_sharding

    sharded = tp_state_sharding(state.params) if mesh.size(mesh.model_axis) > 1 else {}
    trees = [state.params] + ([] if state.ema is None else [state.ema])
    for tree in trees:
        replicate([v for k, v in tree.items() if k not in sharded], mesh)
        replicate([v for k, v in tree.items() if k in sharded], mesh, mesh.replica)
    opt = state.optimizer
    flat = [opt.mu, opt.nu] + ([opt.acc] if opt.accum > 1 else [])
    replicate(flat, mesh, mesh.replica if sharded else None)
    replicate([v for v in opt.state.values() if isinstance(v, torch.Tensor)], mesh)
    if occ is not None:
        replicate(list(occ), mesh)


def _restore_best_psnr(cfg: Config, start_step: int, log) -> float:
    """The train.keep_best tracker of a resumed run
    (`tnerf/train_loop.py:1038`): the largest finite `best_psnr` in the
    run's metrics stream, so that a worse eval after the resume does not
    write a higher-step file into checkpoints_best; -inf for a fresh run,
    with keep_best off, or without a metrics file."""
    if not (cfg.train.keep_best and start_step > 0):
        return -np.inf
    path = os.path.join(cfg.logging.out_dir, cfg.logging.metrics_file)
    best = -np.inf
    try:
        with open(path) as fh:
            for line in fh:
                try:
                    v = json.loads(line).get("best_psnr")
                except ValueError:
                    continue
                if v is not None and np.isfinite(v):
                    best = max(best, float(v))
    except OSError:
        return best
    if np.isfinite(best):
        log.info("keep_best resumed: best so far %.2f dB", best)
    return best


def _maybe_keep_best(cfg: Config, eval_metrics, save, step: int, best: float, log,
                     metrics, mesh=None) -> float:
    """train.keep_best (`tnerf/train_loop.py:1063`): where this eval's PSNR
    (the val split's, else the test split's) improves on `best`, save the
    state into <out_dir>/checkpoints_best as step_<step> (each improvement
    a higher step, so its newest file is the best) and record best_psnr /
    best_step; returns the new best.  On a mesh rank 0's PSNR decides for
    every rank (the save is a collective under table parallelism)."""
    if not cfg.train.keep_best:
        return best
    v = eval_metrics.get("psnr_val", eval_metrics.get("psnr_test"))
    if mesh is not None and v is not None:
        v = mesh.from_rank0(v)
    if v is None or not np.isfinite(v) or v <= best:
        return best
    bdir = os.path.join(cfg.logging.out_dir, "checkpoints_best")
    save(step, bdir)
    metrics.write(step - 1, best_psnr=float(v), best_step=step)
    log.info("new best checkpoint: step %d (%.2f dB) -> %s", step, v, bdir)
    return v


def run_training(cfg: Config, datasets: Optional[Dict[str, ImageDataset]] = None,
                 device="cuda") -> Dict[str, float]:
    """Train a field per `cfg` on `device`; returns the final metrics.  With
    field_.tri_upsample_steps the triplane trains in stages
    (`_run_progressive`), each of them a run of `_run_training_single`.

    Launched by `python -m torch.distributed.run`, each process is one rank
    of the run's mesh (`build_mesh`) on cuda:(LOCAL_RANK % cards), or on the
    CPU for device="cpu" (`parallel.comm.init_group`); every rank runs this
    alike and rank 0 writes the config, the metrics, the images and the
    checkpoints."""
    from tnerf_torch.parallel import comm

    rank_dev = comm.init_from_env(resolve_device(device), get_logger(level=cfg.logging.level))
    if rank_dev is not None:
        device = rank_dev
    if cfg.field_.tri_upsample_steps:
        return _run_progressive(cfg, datasets, device)
    return _run_training_single(cfg, datasets, device)


def _tri_stage_plan(cfg: Config):
    """[(end_step, resolution)] of the progressive triplane's stages
    (`tnerf/train_loop.py:260`): a log-linear ladder of resolutions from
    tri_init_resolution to tri_resolution, strictly increasing."""
    ms = cfg.field_.tri_upsample_steps
    r0, rf = cfg.field_.tri_init_resolution, cfg.field_.tri_resolution
    if cfg.field_.encoding != "triplane":
        raise ValueError(
            "field_.tri_upsample_steps is the triplane family's "
            f"progressive schedule; field_.encoding={cfg.field_.encoding!r}"
        )
    if cfg.train.optimize_poses:
        raise ValueError(
            "train.optimize_poses does not compose with progressive "
            "triplane stages (the stage upsample rewrite does not "
            "thread the pose leaves)"
        )
    if not (0 < r0 < rf):
        raise ValueError(
            "progressive triplane needs 0 < tri_init_resolution < "
            f"tri_resolution, got {r0} vs {rf}"
        )
    if list(ms) != sorted(set(ms)) or ms[0] <= 0 or ms[-1] >= cfg.train.steps:
        raise ValueError(
            f"tri_upsample_steps must be strictly increasing within "
            f"(0, train.steps={cfg.train.steps}), got {ms}"
        )
    n = len(ms)
    if rf - r0 < n:
        raise ValueError(
            f"{n + 1} progressive stages need {n + 1} distinct "
            f"resolutions in [{r0}, {rf}] — fewer milestones or a wider "
            "resolution range"
        )
    res = [max(2, round(math.exp(math.log(r0) + (math.log(rf) - math.log(r0)) * k / n)))
           for k in range(n)] + [rf]
    for k in range(1, n):
        res[k] = max(res[k], res[k - 1] + 1)
    for k in range(n - 1, -1, -1):
        res[k] = min(res[k], res[k + 1] - 1)
    return list(zip(list(ms) + [cfg.train.steps], res))


def _run_progressive(cfg: Config, datasets, device) -> Dict[str, float]:
    """The progressive triplane (`tnerf/train_loop.py:314`): stage k trains
    steps [end_{k-1}, end_k) at its resolution, resuming the run's
    checkpoint; between stages the checkpoint is rewritten in place with the
    planes and lines upsampled and a fresh optimizer (TensoRF resets it, and
    each stage's schedule spans the stage).  The acceptance gate and
    train.keep_best apply to the last stage only: an earlier stage's
    checkpoint has smaller tables and does not restore under the final
    config."""
    from tnerf_torch.parallel import comm

    validate_ported(cfg, for_eval=False)
    log = get_logger(level=cfg.logging.level)
    plan = _tri_stage_plan(cfg)
    out_dir = cfg.logging.out_dir
    os.makedirs(out_dir, exist_ok=True)
    main = comm.global_rank() == 0
    prov = os.path.join(out_dir, "config.json")
    if main and not (cfg.train.resume and os.path.exists(prov)):
        with open(prov, "w") as fh:
            fh.write(cfg.apply_overrides(["train.resume=false"]).to_json())
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    prev_ends = [0] + [end for end, _ in plan[:-1]]

    def stage_cfg(k: int) -> Config:
        end, res = plan[k]
        last = k == len(plan) - 1
        field_ = dataclasses.replace(cfg.field_, tri_resolution=res, tri_upsample_steps=(),
                                     tri_init_resolution=0)
        train = dataclasses.replace(
            cfg.train, steps=end, resume=True, schedule_total_steps=end - prev_ends[k],
            keep_best=cfg.train.keep_best and last,
            assert_test_psnr_min=cfg.train.assert_test_psnr_min if last else 0.0)
        return dataclasses.replace(cfg, field_=field_, train=train)

    try:
        step_got, _ = latest_checkpoint(ckpt_dir)
    except FileNotFoundError:
        step_got = None
    start_k = 0
    if step_got is not None and not cfg.train.resume:
        raise ValueError(
            f"{ckpt_dir} already has checkpoints: progressive training "
            "resumes via the checkpoint stream — pass train.resume=true "
            "to continue that run, or use a fresh out_dir"
        )
    if step_got is not None:
        # the tables' resolution, not the step, decides the stage: a run
        # stopped between a stage's last save and the rewrite holds the old
        # resolution at the milestone step
        _, params, _ = load_jax_checkpoint(ckpt_dir, device="cpu")
        got = params["triplane.lines"].shape[1]
        matched = [k for k, (_, res) in enumerate(plan) if res == got]
        if not matched:
            raise ValueError(f"the checkpoint in {ckpt_dir} (R={got}) matches no progressive "
                             "stage of this config")
        start_k = matched[0]
        if step_got >= plan[start_k][0] and start_k < len(plan) - 1:
            if main:
                _upsample_checkpoint(stage_cfg(start_k + 1), ckpt_dir, log)
            comm.barrier(device)
            start_k += 1
        log.info("progressive resume: stage %d/%d", start_k + 1, len(plan))
    final_metrics: Dict[str, float] = {}
    for k in range(start_k, len(plan)):
        log.info("progressive stage %d/%d: R=%d until step %d", k + 1, len(plan), plan[k][1],
                 plan[k][0])
        final_metrics = _run_training_single(stage_cfg(k), datasets, device)
        if k < len(plan) - 1:
            if main:
                _upsample_checkpoint(stage_cfg(k + 1), ckpt_dir, log)
            comm.barrier(device)
    return final_metrics


def _upsample_checkpoint(scfg_new: Config, ckpt_dir: str, log) -> None:
    """Rewrite the newest checkpoint at the next stage's resolution
    (`tnerf/train_loop.py:425`): planes and lines upsampled, a fresh
    optimizer state under the next stage's schedule, the occupancy and the
    step carried over."""
    step, params, _, occ, ema = read_train_checkpoint(ckpt_dir, device="cpu")
    r_old = params["triplane.lines"].shape[1]
    r_new = scfg_new.field_.tri_resolution

    def upsampled(tree):
        tree = dict(tree)
        tree["triplane.planes"], tree["triplane.lines"] = upsample_triplane(
            tree["triplane.planes"], tree["triplane.lines"], r_new)
        return tree

    params = upsampled(params)
    fresh = Optimizer(scfg_new.train, params)
    save_checkpoint(ckpt_dir, step, params, fresh.state, occ, scfg_new.train,
                    ema=None if ema is None else upsampled(ema))
    log.info("upsampled triplane %d -> %d at step %d (optimizer reset)", r_old, r_new, step)


def _run_training_single(cfg: Config, datasets: Optional[Dict[str, ImageDataset]] = None,
                         device="cuda") -> Dict[str, float]:
    """Train a field per `cfg` on `device` (one resolution stage); returns
    the final metrics.

    procedural scene -> PixelSampler -> the renderer of render.pipeline
    (fused: B3 tighten, or under occupancy-CDF placement B4 and jittered
    inverse-CDF samples, B1 forward, B2 backward; grid_intervals: the B5
    walk, per-interval samples, field, composite; grid_march and uniform:
    jittered samples, field, composite) -> photometric loss (+
    train.distortion_weight / (far - near) times the mean distortion, +
    the table priors) -> Adam (train.table_lr_mult scaling the tables'
    updates); every grid.update_every steps after grid.warmup_steps the
    occupancy grid is refreshed from the field's density (the uniform
    pipeline keeps none), inside the static mask of grid.mesh_path where
    one is set (`grid/mesh.mesh_occupancy_mask`, rebuilt from the config
    on resume).  grid_march with render.compact trains and evals
    densely until the grid has pruned and then on the occupied samples
    only: the switch reads the occupied share on the host at each
    occupancy update.  Checkpoints are in the reference's layout
    (train.resume continues one, the reference's included); the run ends
    with an eval of every val and test view, images written, and the
    train.assert_test_psnr_min gate on the worst test view.

    The training options of `tnerf/train.py:make_train_step` ride on the
    step (grad accumulation in the optimizer, the weight EMA, remat, the
    BARF window, random background: the training renderers are then built
    background-free and the eval renderers as configured); every eval reads
    `eval_params`; train.keep_best keeps the best eval's state under
    <out_dir>/checkpoints_best; logging.profile traces the loop with
    torch.profiler into <out_dir>/profile; logging.debug_nans stops at
    the first non-finite loss or gradient.

    On a mesh (`build_mesh`, the reference's `:552-866`): every rank draws
    the same batch from one generator seeded alike and trains on its "data"
    shard (`train.make_train_step(mesh=)`), the gradients reduced before
    the update; its sample jitter comes from `jitter_generator`.
    sample_parallel > 1 trains and evals through the
    sample-parallel renderer (no compaction); table_parallel > 1 holds each
    rank's block of the tables and their optimizer state and checkpoints
    the full layout from rank 0; the occupancy refresh probes its cells
    sharded over the ranks (replicated under table parallelism); each
    eval chunk's rays split over "data".  Every host decision (the
    dense-to-compact switch, keep_best) is rank 0's, broadcast; the
    non-finite skip and debug_nans decide on every rank's gradients."""
    dev = resolve_device(device)
    validate_ported(cfg, for_eval=False)
    log = get_logger(level=cfg.logging.level)
    mesh = build_mesh(cfg, dev, log)
    main = mesh is None or mesh.rank == 0
    if not main:
        log.setLevel("WARNING")
    par = cfg.parallel
    n_sp = par.sample_parallel if mesh is not None else 1
    n_tp = par.table_parallel if mesh is not None else 1
    out_dir = cfg.logging.out_dir
    os.makedirs(out_dir, exist_ok=True)
    # Provenance: the resolved config rides with the run; resume is run
    # state, not part of the experiment, and a resumed run keeps the file.
    prov = os.path.join(out_dir, "config.json")
    if main and not (cfg.train.resume and os.path.exists(prov)):
        with open(prov, "w") as fh:
            fh.write(cfg.apply_overrides(["train.resume=false"]).to_json())
    metrics = MetricsWriter(os.path.join(out_dir, cfg.logging.metrics_file) if main else None)

    if datasets is None:
        t0 = time.perf_counter()
        datasets = load_datasets(cfg, device=dev)
        log.info("loaded the scene in %.3f s", time.perf_counter() - t0)
    train_ds = datasets["train"]
    log.info("scene=%s/%s: %d train views %dx%d focal=%.2f", cfg.scene.kind, cfg.scene.name,
             len(train_ds), train_ds.width, train_ds.height, train_ds.focal)
    if cfg.sampler.near < 0 or cfg.sampler.far < 0:
        cfg = resolve_near_far(cfg, train_ds)
        log.info("auto near/far: [%.3f, %.3f]", cfg.sampler.near, cfg.sampler.far)

    init_gen = torch.Generator()  # parameters are drawn on the host, then moved
    init_gen.manual_seed(cfg.train.seed)
    field = NeRFField(cfg.field_, cfg.grid, init_gen).to(dev)
    shard = None
    cfg_r = cfg  # the renderers' config: under table parallelism its sharded field config
    if n_tp > 1:
        from tnerf_torch.parallel.table_parallel import shard_field

        shard = shard_field(field, mesh, par.table_axis_name)
        cfg_r = dataclasses.replace(cfg, field_=field.config)
    # Dense variant while the occupancy grid is still mostly occupied (the
    # compaction capacity would overflow and drop samples); compacted
    # variant once the grid has pruned below the capacity with headroom.
    # Training and eval switch together.  Only grid_march compacts samples.
    switching = cfg.render.pipeline == "grid_march" and cfg.render.compact
    # train.random_background: the training renderers add no background
    # (the step composites prediction and ground truth over one random
    # colour per ray); the eval renderers keep the configured one
    cfg_train_r = cfg_r
    if cfg.train.random_background:
        cfg_train_r = dataclasses.replace(
            cfg_r, scene=dataclasses.replace(cfg.scene, white_background=False),
            render=dataclasses.replace(cfg.render, white_background=False))
    if n_sp > 1:  # the sample-parallel renderer trains and evals; it never compacts
        from tnerf_torch.parallel.sample_parallel import make_sp_interval_renderer

        renderer_dense = make_sp_interval_renderer(
            cfg_r.field_, cfg.grid, cfg.sampler, cfg.render, mesh,
            sample_axis=par.sample_axis_name,
            model_axis=par.table_axis_name if n_tp > 1 else None)
    else:
        renderer_dense = build_renderer(cfg_train_r, for_eval=False, compact=False)
    renderer_compact = build_renderer(cfg_train_r, for_eval=False, compact=True) if switching \
        else renderer_dense
    eval_dense, eval_compact = renderer_dense, renderer_compact
    if cfg.train.random_background:
        eval_dense = build_renderer(cfg_r, for_eval=False, compact=False)
        eval_compact = build_renderer(cfg_r, for_eval=False, compact=True) if switching \
            else eval_dense
    renderer = eval_dense
    state = init_train_state(field, cfg.train, pose_extra_params(cfg, len(train_ds), dev))
    n_params = sum(p.numel() for p in field.parameters())
    log.info("field=%s/%s params=%.2fM pipeline=%s device=%s", cfg.field_.encoding, field.arch,
             n_params / 1e6, cfg.render.pipeline, dev)
    use_grid = cfg.render.pipeline != "uniform"
    # A mesh-bounded scene (grid.mesh_path): the voxelized mesh is a static
    # mask; the bitfield starts at it and every refresh prunes within it.
    # It is rebuilt from the config, never checkpointed.
    occ_mask = None
    if use_grid and cfg.grid.mesh_path:
        from tnerf_torch.grid.mesh import mesh_occupancy_mask

        occ_mask = torch.as_tensor(mesh_occupancy_mask(cfg.grid), device=dev)
        log.info("mesh bound %s: %.1f%% of cells occupied at init", cfg.grid.mesh_path,
                 100.0 * float(occ_mask.float().mean()))
    occ = init_occupancy(cfg.grid, dev, occ_mask) if use_grid else None

    ckpt_dir = os.path.join(out_dir, "checkpoints")
    start_step = 0
    if cfg.train.resume:
        try:
            latest_checkpoint(ckpt_dir)
        except FileNotFoundError:
            log.info("train.resume: no checkpoint in %s, starting from step 0", ckpt_dir)
        else:
            start_step, params, opt_state, occ, ema = read_train_checkpoint(ckpt_dir, dev)
            if shard is not None:  # the full layout, cut to this rank's blocks
                from tnerf_torch.parallel.table_parallel import shard_tree

                params = shard_tree(params, shard)
                opt_state = {k: shard_tree(v, shard) if isinstance(v, dict) else v
                             for k, v in opt_state.items()}
                ema = None if ema is None else shard_tree(ema, shard)
            if (ema is None) != (state.ema is None):
                raise ValueError(f"{ckpt_dir}: the checkpoint "
                                 f"{'has no' if ema is None else 'holds a'} weight EMA, but "
                                 f"train.param_ema is {cfg.train.param_ema}")
            state.load_params(params)
            state.optimizer.load_state(opt_state)
            if ema is not None:
                with torch.no_grad():
                    for k, v in state.ema.items():
                        v.copy_(ema[k])
            state.step = start_step
            log.info("resumed from step %d", start_step)

    if mesh is not None:
        _replicate_state(state, occ, mesh)

    def save(step: int, where: str = ckpt_dir) -> None:
        save_train_state(where, step, state.params, state.optimizer.state, occ, cfg.train,
                         ema=state.ema, mesh=mesh, shard=shard)

    sampler = PixelSampler(train_ds, cfg.scene.scene_scale, cfg.scene.white_background, dev,
                           ndc_near=ndc_near_or_none(cfg),
                           random_background=cfg.train.random_background)
    poses = cfg.train.optimize_poses
    # span-normalized: raw-t distortion scales with the sampled range
    loss_kw = dict(loss=cfg.train.loss, huber_delta=cfg.train.huber_delta,
                   distortion=cfg.train.distortion_weight
                   / max(cfg.sampler.far - cfg.sampler.near, 1e-6),
                   table_l1_weight=cfg.train.table_l1_weight,
                   table_tv_weight=cfg.train.table_tv_weight,
                   pose_setup=sampler if poses else None, remat=cfg.train.remat,
                   random_bg=cfg.train.random_background, param_ema=cfg.train.param_ema,
                   freq_anneal=cfg.train.freq_anneal_steps,
                   debug_nans=cfg.logging.debug_nans)
    if mesh is not None:
        loss_kw["mesh"] = mesh
    step_dense = make_train_step(renderer_dense, **loss_kw)
    step_compact = make_train_step(renderer_compact, **loss_kw) if switching else step_dense
    train_step = step_dense
    # Switch once the occupied share fits the capacity with 40% headroom.
    # Under CDF placement the occupied-cell share says nothing (samples sit
    # in occupied cells by design): plan from the occupied-sample share.
    compact_switch_frac = cfg.render.compact_fraction * 0.6
    cdf_switch = switching and cfg.sampler.placement in ("occupancy_cdf", "density_cdf")
    gen = torch.Generator(device=dev)  # batches, sample jitter and occupancy probes
    gen.manual_seed(cfg.train.seed + 1)
    render_gen = jitter_generator(cfg, mesh, gen)
    density = lambda x: field.density(x, state.params)
    if mesh is not None and n_tp == 1:
        from tnerf_torch.parallel.occupancy import sharded_density

        density = sharded_density(density, mesh)
    update_occ = lambda o: update_occupancy(o, density, cfg.grid, generator=gen, mask=occ_mask)
    rays_per_step = cfg.train.batch_size
    steps_per_epoch = max(1, len(train_ds) * train_ds.height * train_ds.width // rays_per_step)
    final_metrics: Dict[str, float] = {}
    occ_payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    best_psnr = _restore_best_psnr(cfg, start_step, log)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Steps are enqueued without waiting for the device; the host reads a
    # value only at log points, evals and checkpoints, so rays/s is
    # measured per window of steps between two such points.
    sync()
    window_t0 = time.perf_counter()
    window_steps = 0
    with maybe_profile(cfg.logging.profile and main, os.path.join(out_dir, "profile")):
        try:
            for step in range(start_step, cfg.train.steps):
                if cfg.train.shuffle == "epoch":
                    batch = sampler.sample_epoch(cfg.train.seed + step // steps_per_epoch,
                                                 step % steps_per_epoch, rays_per_step, meta=poses)
                else:
                    batch = sampler.sample(gen, rays_per_step, meta=poses)
                aux = train_step(state, batch, occ_payload, render_gen)
                window_steps += 1
                if use_grid and step >= cfg.grid.warmup_steps and step % cfg.grid.update_every == 0:
                    occ = update_occ(occ)
                    occ_payload = renderer_payload(occ, cfg.sampler, cfg.grid)
                    if switching:
                        with torch.no_grad():
                            # a PoseBatch has no rays: the probe needs only their
                            # geometry, so the dataset poses (zero deltas) stand in
                            probe = sampler.regen_rays(batch) if poses else batch.rays
                            frac = cdf_occupied_sample_fraction(probe, occ_payload, cfg.grid,
                                                                cfg.sampler) \
                                if cdf_switch else occupancy_fraction(occ)
                        frac = float(frac)  # waits for the device
                        if mesh is not None:
                            frac = mesh.from_rank0(frac)
                        compacted = frac < compact_switch_frac
                        train_step = step_compact if compacted else step_dense
                        renderer = eval_compact if compacted else eval_dense

                if step % cfg.train.log_every == 0 or step == cfg.train.steps - 1:
                    loss_host = float(aux["loss"])  # waits for the device
                    sec = (time.perf_counter() - window_t0) / max(window_steps, 1)
                    m = {
                        "loss": loss_host,
                        "train_psnr": float(aux["psnr"]),
                        "acc_mean": float(aux["acc_mean"]),
                        "rays_per_sec": rays_per_step / max(sec, 1e-9),
                        "step_seconds": sec,
                        "skipped_steps": float(state.optimizer.total_notfinite)
                        if cfg.train.skip_nonfinite else 0.0,
                    }
                    if occ is not None:
                        m["occupancy_frac"] = float(occupancy_fraction(occ))
                    if "distortion" in aux:
                        m["distortion"] = float(aux["distortion"])
                    if "pose_delta_norm" in aux:
                        m["pose_delta_norm"] = float(aux["pose_delta_norm"])
                    metrics.write(step, **m)
                    log.info("step %d loss=%.5f psnr=%.2f rays/s=%.0f occ=%.2f", step, m["loss"],
                             m["train_psnr"], m["rays_per_sec"], m.get("occupancy_frac", 1.0))
                    if not np.isfinite(loss_host):
                        log.warning("non-finite loss at step %d (update was skipped)", step)
                    window_t0 = time.perf_counter()
                    window_steps = 0

                did_barrier = False
                if cfg.train.eval_every and (step + 1) % cfg.train.eval_every == 0:
                    em = _eval(cfg, renderer, state, occ, datasets, step, log, metrics, dev,
                               mesh=mesh)
                    final_metrics.update(em)
                    best_psnr = _maybe_keep_best(cfg, em, save, step + 1, best_psnr, log, metrics,
                                                 mesh)
                    did_barrier = True
                if cfg.train.checkpoint_every and (step + 1) % cfg.train.checkpoint_every == 0:
                    save(step + 1)
                    did_barrier = True
                if did_barrier:  # eval / checkpoint time must not count as training time
                    sync()
                    window_t0 = time.perf_counter()
                    window_steps = 0
        except KeyboardInterrupt:
            # the state holds the last completed step: persist it, so that
            # train.resume continues from the interrupted step
            save(state.step)
            log.warning("interrupted at step %d: checkpoint saved to %s (continue with "
                        "train.resume=true)", state.step, ckpt_dir)
            metrics.close()
            raise
    save(cfg.train.steps)
    em = _eval(cfg, renderer, state, occ, datasets, cfg.train.steps, log, metrics, dev,
               save_images=True, mesh=mesh)
    final_metrics.update(em)
    _maybe_keep_best(cfg, em, save, cfg.train.steps, best_psnr, log, metrics, mesh)
    metrics.close()
    floor = cfg.train.assert_test_psnr_min
    if floor > 0 and "psnr_test_min" in final_metrics:
        got = final_metrics["psnr_test_min"]
        if got < floor:
            raise RuntimeError(
                f"acceptance gate failed: psnr_test_min={got:.2f} dB < "
                f"train.assert_test_psnr_min={floor} (mean "
                f"{final_metrics.get('psnr_test', float('nan')):.2f})"
            )
    return final_metrics
