"""Typed configuration tree with JSON / CLI overrides.

The port's own copy of the reference package's `tnerf/config.py`: the
same sections, keys and defaults, so every `configs/*.json` and
`runs/**/config.json` means the same thing to both packages
(`tests/test_torch_config_data.py` holds the two `to_dict()` equal).
Options this port does not run yet are refused where a renderer is
built (`tnerf_torch.train_loop.build_renderer`), never here.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Tuple


@dataclass(frozen=True)
class SceneConfig:
    """Which scene to load and how to map it into grid space.

    Replaces the hardcoded `load_data(SYNTHETIC, LEGO)` call
    (reference main.cu:358) and the /10 origin hack
    (reference rtx/src/optixPrograms.cu:76-78, defect D9) with an explicit
    scene-to-grid transform.
    """

    kind: str = "nerf_synthetic"  # nerf_synthetic | llff | colmap | procedural
    name: str = "lego"            # chair|drums|ficus|hotdog|lego|materials|mic|ship
    root: str = "./data/nerf_synthetic"
    # Explicit scene scale applied to camera origins (and implicitly all
    # geometry): world * scene_scale must land inside the grid AABB.
    scene_scale: float = 0.33
    white_background: bool = True
    # stbi_loadf applies a gamma 2.2 decode by default; the NeRF convention
    # is a plain /255.  Expose both, default NeRF (SURVEY §2.2 stb note).
    srgb_to_linear: bool = False
    # Downscale factor applied to images on load (1 = native 800x800).
    downscale: int = 1
    # Procedural-scene generation (scene.kind="procedural" only): image
    # size, split view counts, and the analytic GT ray-march quadrature
    # (data/procedural.py generate_procedural_scene).  0 = that
    # parameter's library default (128x128, 24/4/8 views, 384 samples).
    proc_width: int = 0
    proc_height: int = 0
    proc_n_train: int = 0
    proc_n_val: int = 0
    proc_n_test: int = 0
    proc_n_samples: int = 0
    # NDC ray parameterization for forward-facing (LLFF-style) captures:
    # rays warp into the perspective cube [-1,1]^3 (cameras.ndc_warp) so
    # the occupancy grid spans the camera frustum from the near plane to
    # infinity.  Requires recentered poses (llff_recenter below, or an
    # equivalently captured procedural/LLFF scene) and pins
    # sampler.near/far to (0, 1) — see train_loop.validate_ndc.
    ndc: bool = False
    # World-space distance of the NDC near plane (in scene_scale units).
    ndc_near: float = 1.0
    # Pose preprocessing (scene.kind="llff" or "colmap"): rigidly
    # recenter the poses so the average camera frame is the world
    # identity (required for ndc), and/or apply the classic bd_factor
    # rescale — scale translations + depth bounds by
    # 1/(min_bound * llff_bd_rescale), so the closest content lands at
    # depth 1/llff_bd_rescale (standard value 0.75 -> 1.33, beyond an
    # NDC near plane at 1.0).  0 = off.
    llff_recenter: bool = False
    llff_bd_rescale: float = 0.0


@dataclass(frozen=True)
class GridConfig:
    """Occupancy grid geometry.

    The reference covers [-1,1]^3 with a dense res^3 = 8^3 AABB grid baked
    into an OptiX GAS (reference main.cu:154-174,394-399; that value lives
    in the reference package's reference_parity_config).  MAX_HITS per ray is the reference's own
    structural bound 3*res (main.cu:486).  The default is the measured
    round-3 flagship: 64^3 (the hard-gate resolution).
    """

    resolution: int = 64
    aabb_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    aabb_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # Per-ray traversal interval capacity; reference uses 3*grid_res.
    max_hits: int = 0  # 0 => auto: 3 * resolution
    # Occupancy update schedule (capability the reference lacks but the
    # north star requires: periodic occupancy-grid updates from density).
    update_every: int = 16
    warmup_steps: int = 256
    density_threshold: float = 0.01
    ema_decay: float = 0.95
    # Mesh-bounded scenes (the capability behind the reference's dead
    # triangle-GAS path, rtxFunctions.cpp:354-452 + volume_reader.h:37-84):
    # path to a .obj triangle mesh or a reference-format tet file.  The
    # mesh voxelizes into a STATIC occupancy mask — marching starts from
    # it instead of the dense all-ones grid, and density-driven updates
    # prune within it but can never escape it.  "" = unbounded (default).
    mesh_path: str = ""
    # Fill the mesh interior (solid bound) vs keep only the surface shell.
    mesh_solid: bool = True
    # Conservative dilation of the voxelized mask, in cells.
    mesh_dilate: int = 1


@dataclass(frozen=True)
class SamplerConfig:
    """Interval -> sample-point generation.

    Mirrors reference sampler/sampler.h:4-9: 32 samples per interval and
    three modes (REGULAR, STRATIFIED_JITTERING, UNIFORM) — with a working
    per-ray RNG instead of the broken shared thrust engine (defect D10).
    """

    samples_per_interval: int = 32
    mode: str = "regular"  # regular | stratified | uniform
    # Fixed-count ray-marching path (the reference's dead "ray sample"
    # OptiX pipeline #2 intended exactly this fusion).
    samples_per_ray: int = 96
    # Ray t-range.  -1 = derive from the dataset's per-view depth
    # bounds (LLFF poses_bounds): near = 0.9*min, far = 1.1*max, in
    # scene_scale units — the standard LLFF recipe
    # (train_loop.resolve_near_far).  Scenes without bounds reject -1.
    near: float = 0.05
    far: float = 4.0
    # Occupancy-aware per-ray range tightening (grid_march): probe the
    # bitfield and concentrate the sample budget on the occupied t-span.
    tighten: bool = True
    tighten_probes: int = 64
    # Resolution of the (max-pooled) occupancy grid the tighten probes
    # consult (march pipeline).  0 = fine (grid.resolution).  A pooled
    # res <= 32 enables the fused tighten+mask kernel (B4) at eval; train
    # and eval probe the same pooled grid, so their spans agree exactly.
    tighten_res: int = 16
    # Per-sample occupancy-mask resolution for the march pipeline:
    # 0 = fine (grid.resolution); a pooled res <= 32 moves the eval-time
    # mask into the tighten+mask kernel.  Train-time masking uses the same
    # pooled grid (exact at jittered positions).
    occupancy_mask_res: int = 16
    # Sample PLACEMENT inside the (tightened) span, march pipeline only:
    # "uniform" = equal strata (march_samples_t); "occupancy_cdf" =
    # inverse-CDF stratified placement over cdf_bins occupancy probes
    # (sampling.cdf_ray_samples) — concentrates the budget on occupied
    # sub-segments (only ~16% of tightened-span samples hit occupied
    # cells on the hard gate; docs/KERNEL_NOTES.md); "density_cdf" =
    # transmittance-scaled per-bin alphas from the occupancy grid's
    # density EMA (the classic NeRF coarse-pass hierarchical weighting
    # at zero field cost — bins behind an opaque surface get almost no
    # budget; grid_renderer.cdf_bin_weights).  Part of the quadrature
    # contract: train and eval must use the same placement.
    placement: str = "uniform"  # uniform | occupancy_cdf | density_cdf
    cdf_bins: int = 64
    # Weight added to every CDF bin (occupied bins weigh 1): keeps
    # support everywhere the conservative occupancy mask might err and
    # bounds the mass spent on empty space at floor*P/(K + floor*P).
    cdf_floor: float = 0.01


@dataclass(frozen=True)
class FieldConfig:
    """Radiance field: encoding + MLP.

    Defaults mirror the reference tcnn config (main.cu:35-69): composite
    Frequency encoding (n_frequencies=10 over 3 spatial dims, frequency
    over 2 view dims), FullyFusedMLP with ReLU hidden, Sigmoid RGB output,
    128 neurons, 8 hidden layers, 5-D input -> 4-D RGBsigma output.
    """

    encoding: str = "frequency"  # frequency | hashgrid | triplane
    n_frequencies: int = 10
    n_frequencies_view: int = 4
    # Viewing-direction parameterization: "thetaphi" matches the reference
    # (optixPrograms.cu:71-73); "unit" uses the normalized 3-vector.
    view_param: str = "thetaphi"
    # View-direction encoding: "frequency" (reference parity — frequency
    # encoding over the view dims, main.cu:47-59) or "sh" (real spherical
    # harmonics over the unit direction, sh_degree bands = sh_degree^2
    # features — the role of tcnn's SphericalHarmonics / the standard
    # Instant-NGP view branch).
    view_encoding: str = "frequency"
    sh_degree: int = 4
    hidden_width: int = 128
    hidden_layers: int = 8
    # Hash-grid (Instant-NGP) settings, used when encoding == "hashgrid".
    hash_levels: int = 16
    hash_features_per_level: int = 2
    # The reference package's default T=2^14 (tcnn's is 2^19, reference
    # main.cu:35-69 schema).
    hash_log2_table_size: int = 14
    hash_base_resolution: int = 16
    hash_max_resolution: int = 2048
    # Table lookup strategy of the reference package: "gather", "onehot"
    # (matmul-gather, needs hash_log2_table_size <= 15), or "auto".
    hash_gather_mode: str = "auto"
    # Interpolation of the first K levels is nearest-corner (piecewise
    # constant) instead of trilinear — the role of tcnn's "Nearest"
    # interpolation mode (the reference schema's HashGrid supports
    # Nearest/Linear, main.cu:35-69 context).  One corner lookup instead
    # of 8 cuts encode FLOPs ~(L - 7/8*K)/L on the MXU one-hot path;
    # coarse levels lose least from the blockiness (cells are refined by
    # the linear fine levels).  0 = all-linear (tcnn default).
    hash_nearest_levels: int = 0
    # With hashgrid, Instant-NGP uses a shallow MLP.
    hash_hidden_width: int = 64
    hash_hidden_layers: int = 2
    # Triplane / vector-matrix (TensoRF-style VM) settings, used when
    # encoding == "triplane": three R x R feature planes times three
    # R-entry feature lines, F features per plane-line pair (feature dim
    # 3*F into a shallow MLP).  tri_gather_mode mirrors hash_gather_mode
    # ("auto" = MXU one-hot matmuls on TPU while R*R <= 2^15, XLA gather
    # otherwise — tnerf/fields/triplane.py:resolve_tri_mode).
    # encoding == "cp" (TensoRF's CP ablation family) reuses the same
    # knobs: rank-F product of three R-entry LINE factors only (feature
    # dim F; O(3*R*F) params — the lightest grid family).
    tri_resolution: int = 128
    tri_features: int = 16
    tri_gather_mode: str = "auto"
    tri_hidden_width: int = 64
    tri_hidden_layers: int = 2
    # TensoRF's progressive (coarse-to-fine) grid growth: train at
    # tri_init_resolution, then at each global step in
    # tri_upsample_steps resample the planes/lines onto a finer vertex
    # grid (log-linear ladder from init to tri_resolution; align-corners
    # — tnerf/fields/triplane.py:upsample_triplane) and re-initialize
    # the optimizer (TensoRF's lr_upsample_reset: the per-stage LR
    # schedule restarts).  () = train at tri_resolution from step 0.
    # tri_init_resolution is required (>0) when milestones are set.
    tri_upsample_steps: Tuple[int, ...] = ()
    tri_init_resolution: int = 0
    # Compute dtype for matmuls ("bfloat16": the analog of tcnn's fp16
    # tensor-core path, main.cu:328-353).
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class RenderConfig:
    """Volume-rendering quadrature + image assembly."""

    # Rendering pipeline: "uniform" (no grid, BASELINE config 1),
    # "grid_march" (occupancy-masked fixed-step marching; required for
    # field_.encoding=hashgrid), "grid_intervals" (DDA interval lists +
    # 32 samples/interval — reference-parity pipeline shape), "fused"
    # (march + frequency-encode + MLP + composite in ONE kernel,
    # trainable via its backward kernel; the default).
    pipeline: str = "fused"
    # Compact occupied samples across the batch before the MLP
    # (grid_march only) — the static-shape replacement for the
    # reference's thrust-scan batch compaction.  Default off.
    compact: bool = False
    # Compaction buffer capacity as a fraction of batch*samples;
    # overflowing samples are dropped.
    compact_fraction: float = 0.25
    # RAY-level compaction at eval (grid_march + pooled tighten/mask
    # kernel only): rays whose tightened span contains no occupied
    # sample are dropped before the field runs — background pixels never
    # pay encoding/MLP FLOPs.  render_image interleaves chunks across
    # the image so each chunk sees ~the global object fraction.
    ray_compact: bool = False
    # Kept-ray capacity as a fraction of the chunk; rays beyond it
    # render as background (see grid_renderer docstring).
    ray_compact_fraction: float = 0.5
    # Transmittance below this is treated as terminated (early ray
    # termination).
    transmittance_threshold: float = 1e-4
    # Rays per device per render chunk (static shape per compile).
    chunk_size: int = 65536
    white_background: bool = True
    # Fused pipeline only: rays packed per 128-lane row of the TPU
    # kernel for eval/render.  The quadrature does not depend on it, and
    # tnerf_torch (each ray's samples contiguous) does not read it.
    fused_rpc: int = 2
    # The same packing for TRAINING steps of the TPU kernels.
    fused_train_rpc: int = 2
    # Fused pipeline: shrink each ray's t-span to the occupied range
    # with the probe kernel (B3) before sampling.
    fused_tighten: bool = True
    # Fused pipeline: resolution of the IN-KERNEL coarse occupancy
    # bitfield (pooled to min(fused_coarse_res, grid.resolution)).
    # 32 (default) packs 32^3 bits into all 8 lane-rows of the [8,128]
    # i32 words buffer (row-selected lookups); 16 is the round-4
    # single-row bitfield.  Finer shrinks the coarse-vs-fine mask
    # divergence that bounded round-4's fused/march render parity at
    # tight budgets (docs/ROUND4.md turbo 0.803 dB).  Max 32 (the words
    # buffer holds 8*128*32 = 32^3 bits).
    fused_coarse_res: int = 32


@dataclass(frozen=True)
class TrainConfig:
    """Optimization loop.

    Defaults mirror reference main.cu:39-46,185-186,344: L2 loss,
    Adam(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8), seed 1337,
    10 epochs, 45,056-ray batches.
    """

    batch_size: int = 8192
    steps: int = 2000
    # Photometric loss over per-pixel RGB error: "l2" (the reference's
    # hardcoded choice, main.cu:39), "l1", or "huber" (quadratic within
    # huber_delta, linear beyond — robust to the occasional saturated /
    # mislabeled pixel).  PSNR is always reported from the MSE so the
    # metric stays comparable across loss choices.
    loss: str = "l2"  # l2 | l1 | huber
    huber_delta: float = 0.1
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    # Exponential LR decay to this fraction of lr over `steps` (1.0 = off).
    lr_final_fraction: float = 1.0
    # Linear LR warmup from 0 over this many steps, then the configured
    # schedule (0 = off).  Stabilizes the first Adam updates at large
    # batch sizes / aggressive lr.
    lr_warmup_steps: int = 0
    # Accumulate gradients over k loop steps before one optimizer update
    # (optax.MultiSteps, grad mean): effective batch = k * batch_size at
    # the activation memory of one microbatch.  LR-schedule knobs stay in
    # units of loop steps (lengths are divided by k internally).  Note
    # the optimizer state gains accumulation buffers, so checkpoints are
    # only restorable under the same setting.
    grad_accum_steps: int = 1
    # Global-norm gradient clipping applied before Adam (0 = off):
    # caps the occasional exploding batch (saturated pixels, a bad
    # occupancy refresh) without touching well-behaved steps.  Changes
    # the optimizer-state layout (an extra chain slot), so checkpoints
    # are only restorable under the same setting.
    grad_clip: float = 0.0
    # Polyak weight EMA decay (0 = off, typical 0.999): a shadow copy
    # of the params updated ema = d*ema + (1-d)*params each step; eval,
    # keep_best and render/eval CLI read the shadow.  Adds an
    # ema subtree to the train state (checkpoints restorable only under
    # the same setting).
    param_ema: float = 0.0
    # LR multiplier for feature-TABLE params (hashgrid "tables", triplane
    # "planes"/"lines") relative to train.lr — Instant-NGP and TensoRF
    # both train their grids ~10x hotter than the MLP.  Implemented as a
    # post-Adam masked update scale, which is exactly an LR multiplier.
    # 1.0 = off (default; keeps the optimizer-state layout of existing
    # checkpoints unchanged — any other value adds a masked-scale link,
    # so checkpoints are only restorable under the same setting).
    table_lr_mult: float = 1.0
    # L1 penalty weight on feature-table params (mean |entry| per table,
    # summed over hashgrid/triplane subtrees) — TensoRF's sparsity prior:
    # unobserved entries shrink to zero instead of keeping init noise
    # (suppresses free-space floaters).  0 = off.
    table_l1_weight: float = 0.0
    # TV (total-variation) penalty weight on the triplane VM factors
    # (mean squared adjacent-vertex difference per plane axis + lines) —
    # TensoRF's smoothness prior.  Triplane-only: hash tables have no
    # spatial adjacency.  0 = off.
    table_tv_weight: float = 0.0
    # mip-NeRF 360 distortion loss (eq. 15): penalizes the spread of
    # each ray's compositing-weight distribution — the standard floater
    # / background-collapse suppressor for real captures (pairs with
    # scene.ndc).  Applied span-normalized (weight / (far - near)), so
    # the knob is scale-free; typical values 1e-3..1e-2.  Needs a
    # pipeline that materializes per-sample weights: uniform /
    # grid_march / grid_intervals with render.compact=false and no
    # sample-parallelism (validated at config time).
    distortion_weight: float = 0.0
    # instant-ngp-style alpha supervision: every training ray draws a
    # RANDOM background color, composites the GT's alpha over it, and
    # composites the prediction over the same color via the renderer's
    # accumulated opacity (pred = rgb + (1-acc)*bg) — so free space must
    # learn sigma=0 instead of painting the background color onto
    # geometry.  Needs GT alpha (a 4-channel dataset: NeRF-synthetic /
    # LLFF RGBA); eval still renders on the configured background.
    random_background: bool = False
    # Camera-pose refinement (BARF/nerfstudio-style): learn a per-
    # training-image SE(3) delta (params["pose_deltas"], [N, 6] se3,
    # zero-init) composed world-frame onto the dataset poses; rays are
    # regenerated inside the differentiated loss so photometric
    # gradients reach the deltas.  Requires an encoding with position
    # gradients (frequency, or gather-mode hashgrid/triplane) and a
    # non-fused pipeline.  Eval uses the dataset poses unchanged.
    optimize_poses: bool = False
    # BARF coarse-to-fine frequency annealing (Lin et al., ICCV 2021):
    # positional-encoding bands fade in smoothly over the first K steps
    # (band weights from fields/encodings.barf_window; the raw-input
    # passthrough and the view encoding stay full).  The key enabler for
    # METRIC pose recovery under optimize_poses — full-frequency
    # encodings trap joint pose+field optimization in local minima —
    # but usable on its own as a training regularizer.  frequency
    # encoding + non-fused pipelines only.  0 = off.
    freq_anneal_steps: int = 0
    # LR multiplier for the pose deltas relative to train.lr (poses
    # want a much colder step than the field; 1.0 keeps the optimizer
    # state layout of existing checkpoints).
    pose_lr_mult: float = 1.0
    # LR-schedule horizon in steps; 0 = train.steps.  Set when the
    # schedule should span a different window than the loop bound (the
    # progressive-triplane stage driver gives each stage its own decay
    # over the stage's length — TensoRF's lr_upsample_reset).
    schedule_total_steps: int = 0
    weight_decay: float = 0.0
    seed: int = 1337
    # Ray batching: "random" = iid with replacement; "epoch" = device-side
    # permutation of all pixels sliced per step (the reference's epoch
    # shuffle, main.cu:615, minus its D11 ragged-batch overrun).
    shuffle: str = "random"
    eval_every: int = 500
    # Additionally keep the best checkpoint by eval PSNR (psnr_val when a
    # val split exists, else psnr_test) under <out_dir>/checkpoints_best.
    # Saved only when a periodic or final eval improves on the best so
    # far; restore with `--checkpoint <out_dir>/checkpoints_best`.
    keep_best: bool = False
    checkpoint_every: int = 1000
    checkpoint_dir: str = "./checkpoints"
    resume: bool = False
    # Skip the optimizer update when the loss is non-finite (fail-safe the
    # reference lacks, SURVEY §5 failure detection).
    skip_nonfinite: bool = True
    # Rematerialize the renderer in backward (jax.checkpoint): trades
    # recompute FLOPs for activation memory -> larger ray batches.
    remat: bool = False
    log_every: int = 50
    # Acceptance gate on the FINAL eval's worst test view (0 = off): a
    # run whose psnr_test_min lands below this raises after saving its
    # checkpoint/metrics — the mean can hide a regressing view
    # (round-2 verdict weak-#9; the hard-gate configs assert 30).
    assert_test_psnr_min: float = 0.0


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh / sharding layout (absent in reference — SURVEY §2.4)."""

    # Data-parallel axis over rays; -1 = all available devices.
    data_parallel: int = -1
    axis_name: str = "data"
    # Sample-parallel axis: shards the samples-per-ray quadrature of the
    # grid_intervals pipeline across chips (segmented compositing with
    # per-ray transmittance offsets — tnerf/parallel/sample_parallel.py).
    # Composes with DP on a ("data", "sample") mesh; the total device
    # count is data_parallel * sample_parallel.
    sample_parallel: int = 1
    sample_axis_name: str = "sample"
    # Table-parallel axis: shards the hash-grid LEVEL tables (and their
    # optimizer state) across chips, megatron-embedding style — each
    # chip stores/updates L/n tables; only the small feature matrix is
    # gathered (tnerf/parallel/table_parallel.py).  Requires the
    # hashgrid encoding (gather formulation) with hash_nearest_levels=0.
    table_parallel: int = 1
    table_axis_name: str = "model"


@dataclass(frozen=True)
class LoggingConfig:
    out_dir: str = "./runs/default"
    metrics_file: str = "metrics.jsonl"
    level: str = "INFO"
    profile: bool = False
    # Dev-mode numerics sanitizer (SURVEY §5 race-detection/sanitizers
    # row): jax_debug_nans/jax_debug_infs raise at the op that produced
    # the first non-finite value. Costly; off by default.
    debug_nans: bool = False


@dataclass(frozen=True)
class Config:
    scene: SceneConfig = field(default_factory=SceneConfig)
    grid: GridConfig = field(default_factory=GridConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    field_: FieldConfig = field(default_factory=FieldConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)

    # ---- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Strict: unknown sections/keys raise — a typoed knob must not
        silently fall back to the default (same philosophy as the
        placement/pipeline enum validation).  Missing keys keep their
        defaults, so configs written by older versions still load."""
        sections = {f.name: f for f in fields(cls)}
        bad_sections = set(d) - set(sections)
        if bad_sections:
            raise ValueError(
                f"unknown config section(s) {sorted(bad_sections)}; "
                f"have {sorted(sections)}"
            )
        kwargs = {}
        for f in fields(cls):
            sub = d.get(f.name, {})
            subcls = f.default_factory  # type: ignore[union-attr]
            valid = {sf.name for sf in fields(subcls)}
            bad = set(sub) - valid
            if bad:
                raise ValueError(
                    f"unknown key(s) {sorted(bad)} in config section "
                    f"{f.name!r}; have {sorted(valid)}"
                )
            kwargs[f.name] = subcls(**{k: _tupleize(v) for k, v in sub.items()})
        return cls(**kwargs)

    @classmethod
    def from_json_file(cls, path: str) -> "Config":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))

    # ---- CLI overrides -----------------------------------------------------
    def apply_overrides(self, overrides: list[str]) -> "Config":
        """Apply `section.key=value` strings, returning a new Config."""
        d = self.to_dict()
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override must be key.path=value, got {ov!r}")
            path, value = ov.split("=", 1)
            parts = path.split(".")
            node = d
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"unknown config section {p!r} in {ov!r}")
                node = node[p]
            key = parts[-1]
            if key not in node:
                raise KeyError(f"unknown config key {path!r}")
            cur = node[key]
            if isinstance(cur, bool):
                node[key] = value.lower() in ("1", "true", "yes", "on")
            elif isinstance(cur, int):
                node[key] = int(value)
            elif isinstance(cur, float):
                node[key] = float(value)
            elif isinstance(cur, str):
                node[key] = value
            else:
                node[key] = _tupleize(json.loads(value))
        return Config.from_dict(d)


def _tupleize(v):
    return tuple(v) if isinstance(v, list) else v
