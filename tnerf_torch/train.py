"""Training: optimizer, ray batching, train step (counterpart of
`tnerf/train.py`, the plain single-device branch).

The reference jits one pure step; here the step runs eagerly and updates
the parameters and the optimizer state in place (nothing else holds
them).  As there, nothing in a step waits for the device: the schedule,
the bias corrections and the non-finite skip are tensor arithmetic, so
the host only synchronizes where the loop reads a value (log points,
occupancy updates, eval, checkpoints).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from tnerf_torch import sampling
from tnerf_torch.cameras import Rays, compose_pose, ndc_warp, pixel_rays, se3_exp
from tnerf_torch.data.dataset import ImageDataset
from tnerf_torch.fields.nerf_field import TABLE_ENCODINGS
from tnerf_torch.fields.triplane import triplane_tv

MAX_CONSECUTIVE_ERRORS = 1000  # non-finite steps in a row after which an update is let through


class RayBatch(NamedTuple):
    rays: Rays
    gt_rgb: torch.Tensor  # [B, 3] (straight RGBA [B, 4] under train.random_background)


class PoseBatch(NamedTuple):
    """A batch before its rays (`tnerf/train.py:56`), for pose refinement:
    the train step makes the rays from the refined poses itself, so that
    the loss reaches the per-image pose deltas."""

    img: torch.Tensor     # [B] int64 training-image index
    pix: torch.Tensor     # [B, 2] f32 pixel (x, y)
    gt_rgb: torch.Tensor  # [B, 3]


class Optimizer:
    """Adam / AdamW with linear warmup, exponential decay, global-norm
    clipping, gradient accumulation and the non-finite skip, as
    `tnerf.train.create_optimizer` (:66) composes them from optax: clip the
    raw gradients, Adam with bias correction, decoupled weight decay, the
    scheduled step size, all of it applied only if every gradient is
    finite (or after MAX_CONSECUTIVE_ERRORS rejected steps in a row).

    With train.grad_accum_steps = k > 1 the update is `optax.MultiSteps`'
    (`optax/transforms/_accumulation.py`): each loop step folds its
    gradient into a running mean, acc + (g - acc) / (mini_step + 1); the
    inner Adam sees that mean, its state advances and the update is
    applied only on the k-th mini-step (the update of every other one is
    zero), and schedule lengths are counted in updates (horizon // k,
    warmup // k).  The non-finite skip wraps outside the accumulation: a
    non-finite microbatch leaves the window as it was.

    The moments live in one flat buffer each; `state` exposes them per
    parameter in the reference checkpoint's leaf layout.  `step(grads)`
    updates `params` in place and makes no host synchronization."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor]):
        self.cfg = cfg
        self.names = list(params)
        self.params = [params[k] for k in self.names]
        dev = self.params[0].device
        self.sizes = [p.numel() for p in self.params]
        # train.table_lr_mult scales the final update of the feature tables,
        # train.pose_lr_mult that of the pose deltas (`tnerf/train.py:111`,
        # `:132`: masked post-Adam scales, learning-rate multipliers)
        self.table_scale = None
        if cfg.table_lr_mult != 1.0 or cfg.pose_lr_mult != 1.0:
            def mult(k):
                if k.split(".")[0] in TABLE_ENCODINGS:
                    return cfg.table_lr_mult
                return cfg.pose_lr_mult if k == "pose_deltas" else 1.0

            self.table_scale = torch.cat([
                torch.full((n,), mult(k), dtype=torch.float32, device=dev)
                for k, n in zip(self.names, self.sizes)])
        i32 = dict(dtype=torch.int32, device=dev)
        self.mu = torch.zeros(sum(self.sizes), dtype=torch.float32, device=dev)
        self.nu = torch.zeros_like(self.mu)
        self.count = torch.zeros((), **i32)
        self.accum = max(cfg.grad_accum_steps, 1)
        if self.accum > 1:
            self.mini_step = torch.zeros((), **i32)
            self.gradient_step = torch.zeros((), **i32)
            self.acc = torch.zeros_like(self.mu)
        horizon = cfg.schedule_total_steps or cfg.steps
        self.warmup = cfg.lr_warmup_steps // self.accum
        self.decay_steps = max(max(horizon // self.accum, 1) - self.warmup, 1)
        # a schedule carries its own step count; a constant rate has none
        self.scheduled = cfg.lr_final_fraction != 1.0 or self.warmup > 0
        self.sched_count = torch.zeros((), **i32) if self.scheduled else None
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        self._b1, self._b2, self._rate = f32(cfg.beta1), f32(cfg.beta2), f32(cfg.lr_final_fraction)
        self.skip_nonfinite = cfg.skip_nonfinite
        if self.skip_nonfinite:
            self.notfinite_count = torch.zeros((), **i32)
            self.last_finite = torch.ones((), dtype=torch.bool, device=dev)
            self.total_notfinite = torch.zeros((), **i32)

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """The schedule at update `count` (an int32 tensor), float32."""
        cfg = self.cfg
        c = count.to(torch.float32)
        base_c = torch.clamp_min(c - self.warmup, 0.0)
        if cfg.lr_final_fraction != 1.0:
            lr = cfg.lr * torch.pow(self._rate, base_c / self.decay_steps)
        else:
            lr = torch.full_like(c, cfg.lr)
        if self.warmup > 0:
            lr = torch.where(c < self.warmup, cfg.lr * c / self.warmup, lr)
        return lr

    def step(self, grads: List[torch.Tensor]) -> None:
        """One loop step from gradients in parameter order."""
        self.step_flat(torch.cat([x.reshape(-1) for x in grads]).to(torch.float32))

    @torch.no_grad()
    def step_flat(self, g: torch.Tensor, sync=None) -> None:
        """One loop step from the gradients flattened in parameter order
        (float32).  sync: the mesh's `parallel.mesh.GradSync` where the
        gradients were reduced across ranks: the clip's norm is then the
        whole gradient's, and the finite check one decision on every
        rank."""
        cfg = self.cfg
        finite = torch.isfinite(g).all()
        emit = None  # every step emits an update without accumulation
        if self.accum > 1:
            g = self.acc + (g - self.acc) / (self.mini_step + 1).to(torch.float32)
            acc = g
            emit = self.mini_step == self.accum - 1
        sq = None
        if sync is not None:
            sq, finite = sync.norm_sq_and_finite(finite, g if cfg.grad_clip > 0.0 else None)
        if cfg.grad_clip > 0.0:
            norm = torch.sqrt(torch.sum(g * g) if sq is None else sq)
            g = torch.where(norm < cfg.grad_clip, g, (g / norm) * cfg.grad_clip)
        mu = (1 - cfg.beta1) * g + cfg.beta1 * self.mu
        nu = (1 - cfg.beta2) * (g * g) + cfg.beta2 * self.nu
        count = self.count + 1
        cf = count.to(torch.float32)
        update = (mu / (1 - torch.pow(self._b1, cf))) \
            / (torch.sqrt(nu / (1 - torch.pow(self._b2, cf))) + cfg.eps)
        if cfg.weight_decay > 0.0:
            update = update + cfg.weight_decay * torch.cat([p.reshape(-1) for p in self.params])
        lr = self.learning_rate(self.sched_count) if self.scheduled else cfg.lr
        update = -lr * update
        if self.table_scale is not None:
            update = update * self.table_scale
        if emit is not None:
            update = update * emit.to(torch.float32)
        apply = None
        if self.skip_nonfinite:
            notfinite = torch.where(finite, torch.zeros_like(self.notfinite_count),
                                    self.notfinite_count + 1)
            apply = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
            update = torch.where(apply, update, torch.zeros_like(update))
            self.total_notfinite.add_((~finite).to(torch.int32))
            self.notfinite_count.copy_(notfinite)
            self.last_finite.copy_(finite)
        # the inner state advances where an update is emitted and applied
        advance = emit if apply is None else apply if emit is None else apply & emit
        if advance is None:
            self.mu.copy_(mu)
            self.nu.copy_(nu)
            self.count.copy_(count)
            if self.scheduled:
                self.sched_count.add_(1)
        else:
            self.mu.copy_(torch.where(advance, mu, self.mu))
            self.nu.copy_(torch.where(advance, nu, self.nu))
            self.count.copy_(torch.where(advance, count, self.count))
            if self.scheduled:
                self.sched_count.copy_(torch.where(advance, self.sched_count + 1,
                                                   self.sched_count))
        if emit is not None:
            # MultiSteps' own counters and window, kept as they were where
            # the non-finite skip rejected the step
            keep = torch.ones_like(finite) if apply is None else apply
            acc = acc * (~emit).to(torch.float32)
            self.acc.copy_(torch.where(keep, acc, self.acc))
            self.gradient_step.copy_(torch.where(keep & emit, self.gradient_step + 1,
                                                 self.gradient_step))
            self.mini_step.copy_(torch.where(keep, (self.mini_step + 1) % self.accum,
                                             self.mini_step))
        torch._foreach_add_(self.params, [u.reshape(p.shape) for u, p in
                                          zip(torch.split(update, self.sizes), self.params)])

    def _per_param(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: v.reshape(p.shape) for k, v, p in
                zip(self.names, torch.split(flat, self.sizes), self.params)}

    @property
    def state(self) -> dict:
        """The optimizer state by the names of the reference's leaves, in
        its flatten order: the three non-finite counters (if on),
        MultiSteps' `mini_step` and `gradient_step` (with accumulation),
        `count`, `mu` / `nu` per parameter (views of the flat buffers),
        `sched_count` (if a schedule is on) and the accumulated gradient
        `acc` per parameter (with accumulation)."""
        out = {}
        if self.skip_nonfinite:
            out.update(notfinite_count=self.notfinite_count, last_finite=self.last_finite,
                       total_notfinite=self.total_notfinite)
        if self.accum > 1:
            out.update(mini_step=self.mini_step, gradient_step=self.gradient_step)
        out.update(count=self.count, mu=self._per_param(self.mu), nu=self._per_param(self.nu))
        if self.scheduled:
            out["sched_count"] = self.sched_count
        if self.accum > 1:
            out["acc"] = self._per_param(self.acc)
        return out

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """Copy a `state`-shaped dict (tensors on any device) in."""
        mine = self.state
        if set(state) != set(mine):
            raise ValueError(f"optimizer state has {sorted(state)}, this configuration keeps "
                             f"{sorted(mine)}")
        for k, v in mine.items():
            if isinstance(v, dict):
                for name, t in v.items():
                    t.copy_(state[k][name])
            else:
                v.copy_(state[k])


def create_optimizer(cfg, params: Dict[str, torch.Tensor]) -> Optimizer:
    """The optimizer of a TrainConfig over `params` (name -> leaf tensor)."""
    return Optimizer(cfg, params)


class PixelSampler:
    """Draws random (image, pixel) ray batches on the device
    (`tnerf/train.py:155`): the training images and poses live there, and
    a draw is three randints, a gather and the rays' arithmetic, warped
    into NDC where ndc_near is set (scene.ndc).  meta=True draws a
    PoseBatch instead (pose refinement: the step makes the rays).  With
    random_background the images stay straight RGBA [N, H, W, 4]: the
    train step composites them over each ray's random colour itself."""

    def __init__(self, dataset: ImageDataset, scene_scale: float, white_background: bool,
                 device="cuda", ndc_near: Optional[float] = None,
                 random_background: bool = False):
        self.device = torch.device(device)
        if random_background:
            if dataset.channels != 4:
                raise ValueError(
                    "train.random_background needs GT alpha; this "
                    f"dataset has {dataset.channels} channels"
                )
            images = dataset.images
        else:
            images = dataset.composited(white_background)
        self.images = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        self.poses = torch.as_tensor(dataset.poses, dtype=torch.float32).to(self.device)
        self.width = dataset.width
        self.height = dataset.height
        self.camera = dataset.camera
        self.scene_scale = float(scene_scale)
        self.ndc_near = None if ndc_near is None else float(ndc_near)
        self._perm_seed: Optional[int] = None
        self._perm: Optional[torch.Tensor] = None

    def sample(self, generator: torch.Generator, batch_size: int, meta: bool = False):
        """IID pixel draw with replacement; `generator` lives on the
        sampler's device."""
        draw = lambda high: torch.randint(0, high, (batch_size,), generator=generator,
                                          device=self.device)
        return self._gather(draw(self.images.shape[0]), draw(self.width), draw(self.height),
                            meta)

    def sample_epoch(self, epoch_seed: int, step_in_epoch: int, batch_size: int,
                     meta: bool = False):
        """Epoch-shuffled batching without replacement: one permutation of
        all pixels per epoch (cached on the epoch's seed), sliced per step;
        batches wrap around the permutation."""
        if self._perm_seed != epoch_seed:
            n, h, w = self.images.shape[:3]
            gen = torch.Generator(device=self.device)
            gen.manual_seed(epoch_seed)
            self._perm = torch.randperm(n * h * w, generator=gen, device=self.device)
            self._perm_seed = epoch_seed
        total = self._perm.shape[0]
        start = (step_in_epoch * batch_size) % total
        idx = self._perm[(start + torch.arange(batch_size, device=self.device)) % total]
        hw = self.height * self.width
        rem = idx % hw
        return self._gather(idx // hw, rem % self.width, rem // self.width, meta)

    def _gather(self, img, x, y, meta: bool = False):
        pix = torch.stack([x.to(torch.float32), y.to(torch.float32)], dim=-1)
        gt = self.images[img, y, x]
        if meta:
            return PoseBatch(img=img, pix=pix, gt_rgb=gt)
        return RayBatch(rays=self.rays(self.poses[img], pix), gt_rgb=gt)

    def rays(self, poses: torch.Tensor, pix: torch.Tensor) -> Rays:
        """Rays of per-ray poses [B, 4, 4] and pixels [B, 2], NDC-warped
        when the sampler warps (the reference's jitted step, `_divider`)."""
        rays = pixel_rays(poses, pix, self.width, self.height, self.camera, self.scene_scale)
        if self.ndc_near is not None:
            rays = ndc_warp(rays, self.width, self.height, self.camera, self.ndc_near)
        return rays

    def regen_rays(self, batch: PoseBatch) -> Rays:
        """A PoseBatch's rays from the dataset poses (zero deltas): what
        the capacity probe of the dense-to-compact switch reads."""
        return self.rays(self.poses[batch.img], batch.pix)


def photometric_loss(err: torch.Tensor, kind: str = "l2", huber_delta: float = 0.1) -> torch.Tensor:
    """Scalar photometric loss from per-pixel RGB error [..., 3]: "l2",
    "l1", or "huber" (quadratic within delta, linear beyond)."""
    if kind == "l2":
        return torch.mean(torch.square(err))
    if kind == "l1":
        return torch.mean(torch.abs(err))
    if kind == "huber":
        a = torch.abs(err)
        return torch.mean(torch.where(a <= huber_delta, 0.5 * torch.square(err),
                                      huber_delta * (a - 0.5 * huber_delta)))
    raise ValueError(f"train.loss must be l2, l1 or huber, got {kind!r}")


class TrainState:
    """What a checkpoint holds of the model: the field (its parameters),
    the parameters beyond the field (`extra`: the pose deltas under
    train.optimize_poses, the BARF window's `freq_alpha` under
    train.freq_anneal_steps), the optimizer (its state), the number of
    steps taken and, under train.param_ema, the Polyak shadow `ema` of
    every parameter (`tnerf/train.py:38`)."""

    def __init__(self, field, optimizer: Optimizer, step: int = 0,
                 extra: Optional[Dict[str, torch.Tensor]] = None,
                 ema: Optional[Dict[str, torch.Tensor]] = None):
        self.field = field
        self.optimizer = optimizer
        self.step = step
        self.extra = extra or {}
        self.ema = ema

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return {**self.field.params(), **self.extra}

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy a checkpoint's parameters in: the field's and the extras."""
        if set(params) != set(self.params):
            raise ValueError(f"the checkpoint holds the parameters {sorted(params)}, this "
                             f"configuration trains {sorted(self.params)}")
        self.field.load_state_dict({k: v for k, v in params.items() if k not in self.extra})
        for k, v in self.extra.items():
            v.copy_(params[k])


def eval_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The parameters eval, checkpoints_best and the CLI read
    (`tnerf/train.py:496`): the EMA shadow under train.param_ema, else the
    live parameters."""
    return state.params if state.ema is None else state.ema


def pose_extra_params(cfg, n_train_images: int, device="cpu") -> Optional[Dict[str, torch.Tensor]]:
    """The parameters beyond the field's (`tnerf/train.py:458`), each with
    its Adam moments: under train.optimize_poses the per-training-image
    SE(3) deltas, [N, 6] zeros ("pose_deltas"); under
    train.freq_anneal_steps the BARF window's scalar "freq_alpha" (set by
    the train step, never learned).  None when there are none."""
    extra = {}
    if cfg.train.optimize_poses:
        extra["pose_deltas"] = torch.zeros((n_train_images, 6), dtype=torch.float32,
                                           device=device, requires_grad=True)
    if cfg.train.freq_anneal_steps > 0:
        extra["freq_alpha"] = torch.zeros((), dtype=torch.float32, device=device,
                                          requires_grad=True)
    return extra or None


def init_train_state(field, train_cfg, extra: Optional[Dict[str, torch.Tensor]] = None
                     ) -> TrainState:
    """A fresh TrainState around `field` (already on its device) and the
    extra parameters (on the same device); under train.param_ema its
    shadow starts as a copy of the initial parameters."""
    params = {**field.params(), **(extra or {})}
    ema = ({k: v.detach().clone() for k, v in params.items()} if train_cfg.param_ema > 0
           else None)
    return TrainState(field, create_optimizer(train_cfg, params), 0, extra, ema)


def table_l1(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """TensoRF's sparsity prior on the feature tables (`tnerf/train.py:383`):
    the mean |entry| of each table leaf, summed in the reference's leaf
    order (0 for a field without tables)."""
    total = 0
    for k in sorted(k for k in params if k.split(".")[0] in TABLE_ENCODINGS):
        total = total + torch.abs(params[k]).mean()
    return total


def rematerialized(renderer: Callable) -> Callable:
    """train.remat (`tnerf/train.py:344`, jax.checkpoint there): the
    renderer under `torch.utils.checkpoint` (non-reentrant), which keeps
    none of its activations and runs it again in the backward pass (on
    the fused path: kernel B1 once more before B2).  The recomputation
    replays the forward's draws from `generator` (CDF jitter) and then
    puts the generator back where the step left it, so that the rerun
    sees the same samples and the step's later draws are unchanged."""

    def render(params, rays, occupancy=None, generator=None):
        start = None if generator is None else generator.get_state()
        runs = []

        def run(params, rays, occupancy):
            if runs and start is not None:  # the backward pass's rerun
                now = generator.get_state()
                generator.set_state(start)
                try:
                    return renderer(params, rays, occupancy, generator)
                finally:
                    generator.set_state(now)
            runs.append(1)
            return renderer(params, rays, occupancy, generator)

        return torch.utils.checkpoint.checkpoint(run, params, rays, occupancy,
                                                 use_reentrant=False)

    return render


def freq_alpha(step: int, anneal_steps: int) -> float:
    """The BARF window's alpha of loop step `step` (0-based), clip(step /
    anneal_steps, 0, 1) in float32 as the reference's step computes it
    (`tnerf/train.py:431`)."""
    return float(np.clip(np.float32(step) / np.float32(anneal_steps), 0.0, 1.0))


def make_train_step(renderer: Callable, loss: str = "l2", huber_delta: float = 0.1,
                    distortion: float = 0.0, table_l1_weight: float = 0.0,
                    table_tv_weight: float = 0.0,
                    pose_setup: Optional[PixelSampler] = None, remat: bool = False,
                    random_bg: bool = False, param_ema: float = 0.0, freq_anneal: int = 0,
                    debug_nans: bool = False, mesh=None) -> Callable:
    """train_step(state, batch, occupancy, generator=None) -> aux:
    photometric loss through the renderer (plus `distortion` times the
    rays' mean distortion term, where > 0: the caller has divided the
    weight by the sampled range; plus table_l1_weight times `table_l1` and
    table_tv_weight times the triplane's `triplane_tv`, where > 0),
    gradients onto the state's parameters,
    one optimizer update, `state.step` advanced; aux = {"loss", "psnr"
    (always from the MSE), "acc_mean"} and, with the regularizer on,
    "distortion", as device scalars nobody has waited for.  `generator` (on the batch's device) is the renderer's
    source of sample jitter, the counterpart of the reference step's key;
    a renderer with uniform placement draws nothing from it.

    pose_setup (the PixelSampler of the training views) turns on pose refinement
    (`tnerf/train.py:347`): the batch is a PoseBatch, and the rays are made
    inside the loss from exp(pose_deltas[img]) composed onto the dataset
    pose (`sampler.rays`, NDC-warped where the sampler warps), so that the
    loss reaches the deltas through the ray geometry; aux adds
    "pose_delta_norm", the deltas' mean norm.

    The options of `tnerf/train.py:305`: remat runs the renderer under
    `rematerialized`; random_bg (train.random_background; the renderer is
    built background-free and the batch holds straight RGBA) composites
    prediction and ground truth over one uniform colour per ray, drawn
    from `generator` after the renderer's draws (`sampling.draw_uniform`);
    param_ema > 0 updates the state's shadow as d e + (1 - d) p after
    every step; freq_anneal > 0 sets the `freq_alpha` leaf to this step's
    window (`freq_alpha`) before the loss and again after the update, so
    that no optimizer moves it; debug_nans (logging.debug_nans) waits for
    the device every step and raises FloatingPointError at the first
    non-finite loss or gradient, before its update.

    mesh (`parallel.mesh.make_mesh`): the step of one rank of a parallel
    run: it takes the full batch that every rank draws alike and trains on
    this rank's shard of it (`parallel.mesh.shard_batch`), through a
    renderer of its place in the mesh.  The gradient of each leaf
    is the world-size-1 loss's, formed before the update (`GradSync`):
    summed over the ranks that hold the same copy of the leaf (every axis
    but "model") and divided by the "data" size.  The table priors, which
    every rank of a sample group computes alike, enter the differentiated
    objective divided by the "sample" size, and a "model" rank's prior of
    its table block by the "model" size.  aux is the global one, reduced
    over every rank; debug_nans and the non-finite skip decide once for
    every rank."""
    photometric_loss(torch.zeros((1, 3)), loss, huber_delta)  # validate early
    if remat:
        renderer = rematerialized(renderer)
    if param_ema > 0.0:
        decay = np.float32(param_ema)
        keep, take = float(decay), float(np.float32(1.0) - decay)
    n_sp = n_tp = 1
    if mesh is not None:
        from tnerf_torch.parallel.mesh import GradSync, reduce_aux, shard_batch
        from tnerf_torch.parallel.table_parallel import tp_state_sharding

        n_sp, n_tp = mesh.size(mesh.sample_axis), mesh.size(mesh.model_axis)
        syncs = {}
    # the priors' share of this rank's differentiated objective (1 off a mesh)
    prior_share = 1.0 / (n_sp * n_tp)

    def train_step(state: TrainState, batch, occupancy=None,
                   generator: Optional[torch.Generator] = None) -> dict:
        params = state.params
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        if freq_anneal > 0:
            alpha = freq_alpha(state.step, freq_anneal)
            with torch.no_grad():
                params["freq_alpha"].fill_(alpha)
        if pose_setup is not None:
            delta = se3_exp(params["pose_deltas"][batch.img])
            rays = pose_setup.rays(compose_pose(delta, pose_setup.poses[batch.img]), batch.pix)
        else:
            rays = batch.rays
        res = renderer(params, rays, occupancy, generator)
        if random_bg:
            bg = sampling.draw_uniform(generator, (*res.acc.shape, 3), res.acc.device)
            a = batch.gt_rgb[..., 3:4]
            gt = batch.gt_rgb[..., :3] * a + bg * (1.0 - a)
            err = (res.rgb + (1.0 - res.acc)[..., None] * bg) - gt
        else:
            err = res.rgb - batch.gt_rgb
        mse = torch.mean(torch.square(err))
        obj = photo = mse if loss == "l2" else photometric_loss(err, loss, huber_delta)
        prior = None
        if table_l1_weight > 0.0:
            prior = table_l1_weight * table_l1(params)
            obj = obj + (prior if mesh is None else prior * prior_share)
        if table_tv_weight > 0.0:
            tv = table_tv_weight * triplane_tv(params["triplane.planes"], params["triplane.lines"])
            obj = obj + (tv if mesh is None else tv * prior_share)
            prior = tv if prior is None else prior + tv
        if distortion > 0.0:
            dist = torch.mean(res.distortion)
            obj = obj + distortion * dist
        names = state.optimizer.names
        leaves = [params[k] for k in names]
        # the window's alpha reaches the field with its gradient cut
        grads = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1) for g, p in zip(
            torch.autograd.grad(obj, leaves, allow_unused=freq_anneal > 0), leaves)]
                          ).to(torch.float32)
        sync = None
        if mesh is not None:
            sync = syncs.get(id(state.optimizer))
            if sync is None:
                sharded = tp_state_sharding(names) if n_tp > 1 else {}
                sync = syncs[id(state.optimizer)] = GradSync(mesh, names, state.optimizer.sizes,
                                                             sharded)
            grads = sync.reduce(grads)
        if debug_nans:
            ok = torch.isfinite(obj) & torch.isfinite(grads).all()
            if not bool(ok if sync is None else sync.decide(ok)):
                bad = [k for k, g in zip(names, torch.split(grads, state.optimizer.sizes))
                       if not bool(torch.isfinite(g).all())]
                raise FloatingPointError(
                    f"logging.debug_nans: non-finite loss ({float(obj.detach())}) or gradient "
                    f"({', '.join(bad) or 'none'}) at step {state.step}")
        state.optimizer.step_flat(grads, sync)
        if freq_anneal > 0:
            with torch.no_grad():
                params["freq_alpha"].fill_(alpha)
        if param_ema > 0.0:
            with torch.no_grad():
                ema = [state.ema[k] for k in state.optimizer.names]
                torch._foreach_mul_(ema, keep)
                torch._foreach_add_(ema, torch._foreach_mul(leaves, take))
        state.step += 1
        acc_mean = res.acc.detach().mean()
        if mesh is not None:
            # the means over the world's ranks (alike within a sample or model
            # group) are the means over the data shards; a prior's pieces sum
            # over "model"
            vals = {"photo": photo, "mse": mse, "acc": acc_mean}
            if prior is not None:
                vals["prior"] = prior / n_tp
            if distortion > 0.0:
                vals["dist"] = dist
            g = reduce_aux(vals, {k: 1.0 / mesh.n_ranks if k != "prior"
                                  else n_tp / mesh.n_ranks for k in vals}, mesh)
            obj, mse, acc_mean = g["photo"], g["mse"], g["acc"]
            if prior is not None:
                obj = obj + g["prior"]
            if distortion > 0.0:
                dist = g["dist"]
                obj = obj + distortion * dist
        aux = {
            "loss": obj.detach(),
            "psnr": -10.0 * torch.log10(torch.clamp_min(mse.detach(), 1e-10)),
            "acc_mean": acc_mean,
        }
        if distortion > 0.0:
            aux["distortion"] = dist.detach()
        if pose_setup is not None:
            aux["pose_delta_norm"] = torch.linalg.norm(params["pose_deltas"].detach(),
                                                       dim=-1).mean()
        return aux

    return train_step
