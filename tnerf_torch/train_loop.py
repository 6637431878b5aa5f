"""High-level training orchestration and renderer construction
(counterpart of `tnerf/train_loop.py`, single device: `_run_training_single`,
:514-1034, and `build_renderer`, :70)."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tnerf_torch.config import Config
from tnerf_torch.data.dataset import (
    ImageDataset,
    load_data,
    scene_proc_kwargs,
    validate_scene_background,
)
from tnerf_torch.device import resolve_device
from tnerf_torch.eval import evaluate
from tnerf_torch.fields.nerf_field import NeRFField
from tnerf_torch.grid.occupancy import (
    init_occupancy,
    occupancy_fraction,
    renderer_payload,
    update_occupancy,
)
from tnerf_torch.render.fused import MAX_BWD_LAYERS, make_fused_renderer
from tnerf_torch.render.grid_renderer import cdf_occupied_sample_fraction, make_grid_renderer
from tnerf_torch.render.renderer import make_uniform_renderer
from tnerf_torch.train import PixelSampler, init_train_state, make_train_step
from tnerf_torch.utils.checkpoint import (
    latest_checkpoint,
    load_train_checkpoint,
    save_checkpoint,
)
from tnerf_torch.utils.metrics import MetricsWriter, get_logger


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to tnerf_torch, see ROADMAP.md")


PIPELINES = ("fused", "grid_march", "grid_intervals", "uniform")


def validate_ported(cfg: Config, for_eval: bool = True) -> None:
    """Refuse every option this port does not run, rather than running
    another path in its place.  for_eval=False checks a training run."""
    p = cfg.render.pipeline
    if p not in PIPELINES:
        raise ValueError(f"unknown render pipeline {p!r}")
    if cfg.field_.encoding != "frequency":
        raise _not_ported(f"field_.encoding={cfg.field_.encoding!r} (frequency only)")
    if cfg.field_.view_encoding != "frequency":
        raise _not_ported(f"field_.view_encoding={cfg.field_.view_encoding!r} (frequency only)")
    if cfg.scene.kind != "procedural":
        raise _not_ported(f"scene.kind={cfg.scene.kind!r} (procedural scenes only)")
    if cfg.scene.ndc:
        raise _not_ported("scene.ndc=true")
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
    t, par = cfg.train, cfg.parallel
    refused = {
        "train.grad_accum_steps > 1": t.grad_accum_steps > 1,
        "train.param_ema > 0": t.param_ema > 0,
        "train.random_background=true": t.random_background,
        "train.optimize_poses=true": t.optimize_poses,
        "train.keep_best=true": t.keep_best,
        "train.table_lr_mult / pose_lr_mult != 1": t.table_lr_mult != 1.0 or t.pose_lr_mult != 1.0,
        "train.table_l1_weight / table_tv_weight > 0":
            t.table_l1_weight > 0 or t.table_tv_weight > 0,
        "train.freq_anneal_steps > 0": t.freq_anneal_steps > 0,
        "train.remat=true": t.remat,
        "grid.mesh_path": bool(cfg.grid.mesh_path),
        "parallel.data_parallel > 1": par.data_parallel > 1,
        "parallel.sample_parallel > 1": par.sample_parallel > 1,
        "parallel.table_parallel > 1": par.table_parallel > 1,
        "logging.profile=true": cfg.logging.profile,
        "logging.debug_nans=true": cfg.logging.debug_nans,
    }
    for what, hit in refused.items():
        if hit:
            raise _not_ported(what)
    if p == "fused" and cfg.field_.hidden_layers + 1 > MAX_BWD_LAYERS:
        raise ValueError(
            f"field_.hidden_layers={cfg.field_.hidden_layers}: fused training runs at most "
            f"{MAX_BWD_LAYERS - 1} hidden layers (the backward kernel keeps every layer's input "
            f"of a tile in shared memory, which holds {MAX_BWD_LAYERS} layers); a deeper model "
            "is served on the fused path and trains on grid_march or grid_intervals"
        )
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


def resolve_near_far(cfg: Config, dataset: ImageDataset) -> Config:
    """Resolve sampler.near/far = -1 (auto) from the dataset's per-view
    depth bounds: near = 0.9 min, far = 1.1 max, in scene_scale units
    (`tnerf/train_loop.py:194`).  No-op when both are explicit."""
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


def _eval(cfg, renderer, state, occ, datasets, step, log, metrics, device,
          save_images: bool = False) -> Dict[str, float]:
    out: Dict[str, float] = {}
    bits = renderer_payload(occ, cfg.sampler, cfg.grid)
    for split in ("val", "test"):
        if split not in datasets or len(datasets[split]) == 0:
            continue
        save_dir = os.path.join(cfg.logging.out_dir, f"renders_{step}") if save_images else None
        m = evaluate(
            renderer, state.params, datasets[split], cfg.scene.scene_scale,
            white_background=cfg.scene.white_background,
            max_views=None if save_images else 2, save_dir=save_dir,
            chunk_size=cfg.render.chunk_size, occupancy=bits, device=device,
        )
        out.update(m)
        log.info("eval step %d: %s", step, m)
        metrics.write(step, **m)
    return out


def run_training(cfg: Config, datasets: Optional[Dict[str, ImageDataset]] = None,
                 device="cuda") -> Dict[str, float]:
    """Train a field per `cfg` on `device`; returns the final metrics.

    procedural scene -> PixelSampler -> the renderer of render.pipeline
    (fused: B3 tighten, or under occupancy-CDF placement B4 and jittered
    inverse-CDF samples, B1 forward, B2 backward; grid_intervals: the B5
    walk, per-interval samples, field, composite; grid_march and uniform:
    jittered samples, field, composite) -> photometric loss (+
    train.distortion_weight / (far - near) times the mean distortion) ->
    Adam; every grid.update_every steps after grid.warmup_steps the
    occupancy grid is refreshed from the field's density (the uniform
    pipeline keeps none).  grid_march with render.compact trains and evals
    densely until the grid has pruned and then on the occupied samples
    only: the switch reads the occupied share on the host at each
    occupancy update.  Checkpoints are in the reference's layout
    (train.resume continues one, the reference's included); the run ends
    with an eval of every val and test view, images written, and the
    train.assert_test_psnr_min gate on the worst test view."""
    dev = resolve_device(device)
    validate_ported(cfg, for_eval=False)
    log = get_logger(level=cfg.logging.level)
    out_dir = cfg.logging.out_dir
    os.makedirs(out_dir, exist_ok=True)
    # Provenance: the resolved config rides with the run; resume is run
    # state, not part of the experiment, and a resumed run keeps the file.
    prov = os.path.join(out_dir, "config.json")
    if not (cfg.train.resume and os.path.exists(prov)):
        with open(prov, "w") as fh:
            fh.write(cfg.apply_overrides(["train.resume=false"]).to_json())
    metrics = MetricsWriter(os.path.join(out_dir, cfg.logging.metrics_file))

    if datasets is None:
        validate_scene_background(cfg.scene.kind, cfg.scene.name, cfg.scene.white_background)
        datasets = load_data(cfg.scene.kind, cfg.scene.name,
                             proc=scene_proc_kwargs(cfg.scene), device=dev)
    train_ds = datasets["train"]
    log.info("scene=%s/%s: %d train views %dx%d focal=%.2f", cfg.scene.kind, cfg.scene.name,
             len(train_ds), train_ds.width, train_ds.height, train_ds.focal)
    cfg = resolve_near_far(cfg, train_ds)

    init_gen = torch.Generator()  # parameters are drawn on the host, then moved
    init_gen.manual_seed(cfg.train.seed)
    field = NeRFField(cfg.field_, cfg.grid, init_gen).to(dev)
    # Dense variant while the occupancy grid is still mostly occupied (the
    # compaction capacity would overflow and drop samples); compacted
    # variant once the grid has pruned below the capacity with headroom.
    # Training and eval switch together.  Only grid_march compacts samples.
    switching = cfg.render.pipeline == "grid_march" and cfg.render.compact
    renderer_dense = build_renderer(cfg, for_eval=False, compact=False)
    renderer_compact = build_renderer(cfg, for_eval=False, compact=True) if switching \
        else renderer_dense
    renderer = renderer_dense
    state = init_train_state(field, cfg.train)
    n_params = sum(p.numel() for p in field.parameters())
    log.info("field=%s params=%.2fM pipeline=%s device=%s", cfg.field_.encoding,
             n_params / 1e6, cfg.render.pipeline, dev)
    use_grid = cfg.render.pipeline != "uniform"
    occ = init_occupancy(cfg.grid, dev) if use_grid else None

    ckpt_dir = os.path.join(out_dir, "checkpoints")
    start_step = 0
    if cfg.train.resume:
        try:
            latest_checkpoint(ckpt_dir)
        except FileNotFoundError:
            log.info("train.resume: no checkpoint in %s, starting from step 0", ckpt_dir)
        else:
            start_step, params, opt_state, occ = load_train_checkpoint(ckpt_dir, dev)
            field.load_state_dict(params)
            state.optimizer.load_state(opt_state)
            state.step = start_step
            log.info("resumed from step %d", start_step)

    def save(step: int) -> None:
        save_checkpoint(ckpt_dir, step, state.params, state.optimizer.state, occ, cfg.train)

    sampler = PixelSampler(train_ds, cfg.scene.scene_scale, cfg.scene.white_background, dev)
    # span-normalized: raw-t distortion scales with the sampled range
    loss_kw = dict(loss=cfg.train.loss, huber_delta=cfg.train.huber_delta,
                   distortion=cfg.train.distortion_weight
                   / max(cfg.sampler.far - cfg.sampler.near, 1e-6))
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
    rays_per_step = cfg.train.batch_size
    steps_per_epoch = max(1, len(train_ds) * train_ds.height * train_ds.width // rays_per_step)
    final_metrics: Dict[str, float] = {}
    occ_payload = renderer_payload(occ, cfg.sampler, cfg.grid)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Steps are enqueued without waiting for the device; the host reads a
    # value only at log points, evals and checkpoints, so rays/s is
    # measured per window of steps between two such points.
    sync()
    window_t0 = time.perf_counter()
    window_steps = 0
    try:
        for step in range(start_step, cfg.train.steps):
            if cfg.train.shuffle == "epoch":
                batch = sampler.sample_epoch(cfg.train.seed + step // steps_per_epoch,
                                             step % steps_per_epoch, rays_per_step)
            else:
                batch = sampler.sample(gen, rays_per_step)
            aux = train_step(state, batch, occ_payload, gen)
            window_steps += 1
            if use_grid and step >= cfg.grid.warmup_steps and step % cfg.grid.update_every == 0:
                occ = update_occupancy(occ, field.density, cfg.grid, generator=gen)
                occ_payload = renderer_payload(occ, cfg.sampler, cfg.grid)
                if switching:
                    with torch.no_grad():
                        frac = cdf_occupied_sample_fraction(batch.rays, occ_payload, cfg.grid,
                                                            cfg.sampler) \
                            if cdf_switch else occupancy_fraction(occ)
                    compacted = float(frac) < compact_switch_frac  # waits for the device
                    train_step = step_compact if compacted else step_dense
                    renderer = renderer_compact if compacted else renderer_dense

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
                metrics.write(step, **m)
                log.info("step %d loss=%.5f psnr=%.2f rays/s=%.0f occ=%.2f", step, m["loss"],
                         m["train_psnr"], m["rays_per_sec"], m.get("occupancy_frac", 1.0))
                if not np.isfinite(loss_host):
                    log.warning("non-finite loss at step %d (update was skipped)", step)
                window_t0 = time.perf_counter()
                window_steps = 0

            did_barrier = False
            if cfg.train.eval_every and (step + 1) % cfg.train.eval_every == 0:
                final_metrics.update(_eval(cfg, renderer, state, occ, datasets, step, log,
                                           metrics, dev))
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
    final_metrics.update(_eval(cfg, renderer, state, occ, datasets, cfg.train.steps, log, metrics,
                               dev, save_images=True))
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
