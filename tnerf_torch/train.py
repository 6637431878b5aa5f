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

import torch

from tnerf_torch.cameras import Rays, pixel_rays
from tnerf_torch.data.dataset import ImageDataset

MAX_CONSECUTIVE_ERRORS = 1000  # non-finite steps in a row after which an update is let through


class RayBatch(NamedTuple):
    rays: Rays
    gt_rgb: torch.Tensor  # [B, 3]


class Optimizer:
    """Adam / AdamW with linear warmup, exponential decay, global-norm
    clipping and the non-finite skip, as `tnerf.train.create_optimizer`
    (:66) composes them from optax: clip the raw gradients, Adam with bias
    correction, decoupled weight decay, the scheduled step size, all of it
    applied only if every gradient is finite (or after
    MAX_CONSECUTIVE_ERRORS rejected steps in a row).

    The moments live in one flat buffer each; `state` exposes them per
    parameter in the reference checkpoint's leaf layout.  `step(grads)`
    updates `params` in place and makes no host synchronization."""

    def __init__(self, cfg, params: Dict[str, torch.Tensor]):
        if cfg.grad_accum_steps > 1 or cfg.table_lr_mult != 1.0 or cfg.pose_lr_mult != 1.0:
            raise NotImplementedError(
                "train.grad_accum_steps > 1 / table_lr_mult / pose_lr_mult are not yet ported "
                "to tnerf_torch, see ROADMAP.md")
        self.cfg = cfg
        self.names = list(params)
        self.params = [params[k] for k in self.names]
        dev = self.params[0].device
        self.sizes = [p.numel() for p in self.params]
        i32 = dict(dtype=torch.int32, device=dev)
        self.mu = torch.zeros(sum(self.sizes), dtype=torch.float32, device=dev)
        self.nu = torch.zeros_like(self.mu)
        self.count = torch.zeros((), **i32)
        horizon = cfg.schedule_total_steps or cfg.steps
        self.warmup = cfg.lr_warmup_steps
        self.decay_steps = max(max(horizon, 1) - self.warmup, 1)
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

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One update from gradients in parameter order."""
        cfg = self.cfg
        g = torch.cat([x.reshape(-1) for x in grads]).to(torch.float32)
        finite = torch.isfinite(g).all()
        if cfg.grad_clip > 0.0:
            norm = torch.sqrt(torch.sum(g * g))
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
        if self.skip_nonfinite:
            notfinite = torch.where(finite, torch.zeros_like(self.notfinite_count),
                                    self.notfinite_count + 1)
            apply = finite | (notfinite > MAX_CONSECUTIVE_ERRORS)
            update = torch.where(apply, update, torch.zeros_like(update))
            self.mu.copy_(torch.where(apply, mu, self.mu))
            self.nu.copy_(torch.where(apply, nu, self.nu))
            self.count.copy_(torch.where(apply, count, self.count))
            if self.scheduled:
                self.sched_count.copy_(torch.where(apply, self.sched_count + 1, self.sched_count))
            self.total_notfinite.add_((~finite).to(torch.int32))
            self.notfinite_count.copy_(notfinite)
            self.last_finite.copy_(finite)
        else:
            self.mu.copy_(mu)
            self.nu.copy_(nu)
            self.count.copy_(count)
            if self.scheduled:
                self.sched_count.add_(1)
        torch._foreach_add_(self.params, [u.reshape(p.shape) for u, p in
                                          zip(torch.split(update, self.sizes), self.params)])

    def _per_param(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {k: v.reshape(p.shape) for k, v, p in
                zip(self.names, torch.split(flat, self.sizes), self.params)}

    @property
    def state(self) -> dict:
        """The optimizer state by the names of the reference's leaves: the
        three non-finite counters (if on), `count`, `mu` / `nu` per
        parameter (views of the flat buffers) and `sched_count` (if a
        schedule is on)."""
        out = {}
        if self.skip_nonfinite:
            out.update(notfinite_count=self.notfinite_count, last_finite=self.last_finite,
                       total_notfinite=self.total_notfinite)
        out.update(count=self.count, mu=self._per_param(self.mu), nu=self._per_param(self.nu))
        if self.scheduled:
            out["sched_count"] = self.sched_count
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
    a draw is three randints, a gather and the rays' arithmetic."""

    def __init__(self, dataset: ImageDataset, scene_scale: float, white_background: bool,
                 device="cuda"):
        self.device = torch.device(device)
        self.images = torch.as_tensor(dataset.composited(white_background),
                                      dtype=torch.float32).to(self.device)  # [N, H, W, 3]
        self.poses = torch.as_tensor(dataset.poses, dtype=torch.float32).to(self.device)
        self.width = dataset.width
        self.height = dataset.height
        self.camera = dataset.camera
        self.scene_scale = float(scene_scale)
        self._perm_seed: Optional[int] = None
        self._perm: Optional[torch.Tensor] = None

    def sample(self, generator: torch.Generator, batch_size: int) -> RayBatch:
        """IID pixel draw with replacement; `generator` lives on the
        sampler's device."""
        draw = lambda high: torch.randint(0, high, (batch_size,), generator=generator,
                                          device=self.device)
        return self._gather(draw(self.images.shape[0]), draw(self.width), draw(self.height))

    def sample_epoch(self, epoch_seed: int, step_in_epoch: int, batch_size: int) -> RayBatch:
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
        return self._gather(idx // hw, rem % self.width, rem // self.width)

    def _gather(self, img, x, y) -> RayBatch:
        pix = torch.stack([x.to(torch.float32), y.to(torch.float32)], dim=-1)
        rays = pixel_rays(self.poses[img], pix, self.width, self.height, self.camera,
                          self.scene_scale)
        return RayBatch(rays=rays, gt_rgb=self.images[img, y, x])


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
    the optimizer (its state) and the number of steps taken."""

    def __init__(self, field, optimizer: Optimizer, step: int = 0):
        self.field = field
        self.optimizer = optimizer
        self.step = step

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.field.params()


def init_train_state(field, train_cfg) -> TrainState:
    """A fresh TrainState around `field` (already on its device)."""
    return TrainState(field, create_optimizer(train_cfg, field.params()), 0)


def make_train_step(renderer: Callable, loss: str = "l2", huber_delta: float = 0.1) -> Callable:
    """train_step(state, batch, occupancy, generator=None) -> aux:
    photometric loss through the renderer, gradients onto the field's
    parameters, one optimizer update, `state.step` advanced; aux = {"loss",
    "psnr" (always from the MSE), "acc_mean"} as device scalars nobody has
    waited for.  `generator` (on the batch's device) is the renderer's
    source of sample jitter, the counterpart of the reference step's key;
    a renderer with uniform placement draws nothing from it."""
    photometric_loss(torch.zeros((1, 3)), loss, huber_delta)  # validate early

    def train_step(state: TrainState, batch: RayBatch, occupancy=None,
                   generator: Optional[torch.Generator] = None) -> dict:
        params = state.params
        res = renderer(params, batch.rays, occupancy, generator)
        err = res.rgb - batch.gt_rgb
        mse = torch.mean(torch.square(err))
        obj = mse if loss == "l2" else photometric_loss(err, loss, huber_delta)
        grads = torch.autograd.grad(obj, [params[k] for k in state.optimizer.names])
        state.optimizer.step(list(grads))
        state.step += 1
        return {
            "loss": obj.detach(),
            "psnr": -10.0 * torch.log10(torch.clamp_min(mse.detach(), 1e-10)),
            "acc_mean": res.acc.detach().mean(),
        }

    return train_step
