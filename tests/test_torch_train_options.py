"""The training options of `tnerf/train.py` and `tnerf/train_loop.py` in the
port, each against the reference package on the CPU at a small size:

- gradient accumulation (train.grad_accum_steps) against optax
  `MultiSteps` inside `apply_if_finite`: six loop steps with a non-finite
  microbatch in the middle of a window, parameters and every state leaf
  within 1e-6 relative (float32 arithmetic in another order); the
  reference's own cases (tests/test_train_ergonomics.py:26, :57, :85, :102);
- the weight EMA (train.param_ema): its start, its update bit-equal to the
  reference's d e + (1 - d) p, eval reading the shadow
  (tests/test_ema_clip.py:51, :100, :119);
- random background: the sampler's straight RGBA, the step's compositing
  bit-equal to the reference's on the colours the reference's key draws,
  the refusals (tests/test_random_background.py:53, :133);
- the BARF window (train.freq_anneal_steps) bit-equal, freq_alpha pinned
  under AdamW, the validation (tests/test_pose_opt.py:207, :233, :331);
- field_.view_param=unit against the reference's field (1e-5), refused
  on the fused pipeline, where the reference cannot run it;
- remat: the same step with and without (bit-equal on the CPU, the fused
  pipeline's plain kernels and a CDF renderer's replayed jitter);
- checkpoints of the new layouts both ways, with the reference's treedef;
- keep_best with its resume tracker, debug_nans, profile.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tnerf.config import Config as JConfig, TrainConfig as JTrain
from tnerf_torch.config import Config, TrainConfig

torch.set_num_threads(2)

SHAPES = {"b0": (16,), "b1": (4,), "w0": (9, 16), "w1": (16, 4)}
SMALL = ["scene.kind=procedural", "scene.name=prims", "scene.scene_scale=1.0",
         "scene.proc_width=24", "scene.proc_height=24", "scene.proc_n_train=3",
         "scene.proc_n_val=1", "scene.proc_n_test=1", "scene.proc_n_samples=32",
         "render.pipeline=grid_march", "sampler.samples_per_ray=16", "sampler.near=2.0",
         "sampler.far=5.5", "field_.hidden_width=16", "field_.hidden_layers=1",
         "field_.n_frequencies=2", "grid.resolution=8", "grid.warmup_steps=5",
         "grid.update_every=5", "train.batch_size=128", "train.checkpoint_every=0",
         "train.log_every=10", "render.chunk_size=576"]


def _close(a, b, what, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=1e-9, err_msg=what)


# ---- gradient accumulation --------------------------------------------------

ACCUM = {
    "k2": dict(grad_accum_steps=2),
    "k3_schedule_clip_decay": dict(grad_accum_steps=3, lr_final_fraction=0.1, lr_warmup_steps=4,
                                   steps=30, grad_clip=0.5, weight_decay=0.01),
    "k2_no_skip": dict(grad_accum_steps=2, skip_nonfinite=False, lr_final_fraction=0.1),
    "k2_lr_mults": dict(grad_accum_steps=2, pose_lr_mult=0.5, lr_final_fraction=0.1),
}


@pytest.mark.parametrize("case", sorted(ACCUM))
def test_accumulated_updates_match_optax_multisteps(case):
    """Six loop steps through both optimizers, the fourth microbatch
    non-finite where the skip is on (the middle of the second window):
    parameters after every step and the state leaves in the reference's
    flatten order within 1e-6 relative; the rejected microbatch changes
    nothing, a mini-step's update is zero."""
    from tnerf.train import create_optimizer as j_create
    from tnerf_torch.train import create_optimizer

    kw = ACCUM[case]
    shapes = dict(SHAPES, pose_deltas=(3, 6)) if "pose_lr_mult" in kw else SHAPES
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 2.0, s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(6)]
    bad = 3 if kw.get("skip_nonfinite", True) else None
    if bad is not None:
        grads[bad]["w0"][2, 5] = np.nan
    jopt = j_create(JTrain(**kw))
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = create_optimizer(TrainConfig(**kw), params)
    k = kw["grad_accum_steps"]
    mini = 0
    for i, g in enumerate(grads):
        updates, jstate = jopt.update({n: jnp.asarray(v) for n, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {n: v.clone() for n, v in params.items()}
        opt.step([torch.from_numpy(g[n]) for n in opt.names])
        for n in shapes:
            _close(params[n], jparams[n], f"{case}: step {i}, {n}")
        moved = any(not torch.equal(params[n], before[n]) for n in shapes)
        if i == bad:
            assert not moved  # skipped: the window is as it was
            continue
        mini += 1
        if mini % k:  # a mini-step: its update is zero
            assert not moved, (i, mini)
    st = opt.state
    mine = [st[n] for n in ("notfinite_count", "last_finite", "total_notfinite", "mini_step",
                            "gradient_step", "count") if n in st]
    mine += [st["mu"][n] for n in sorted(shapes)] + [st["nu"][n] for n in sorted(shapes)]
    mine += [st["sched_count"]] if "sched_count" in st else []
    mine += [st["acc"][n] for n in sorted(shapes)]
    theirs = jax.tree.leaves(jstate)
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[1] == str(b.dtype), i
        _close(a.numpy(), b, f"{case}: state leaf {i}")
    assert int(st["mini_step"]) == mini % k and int(st["gradient_step"]) == mini // k


def _toy_grads(params, data):
    """The gradient of mean((data @ w)^2) for a torch parameter dict {w}."""
    w = params["w"].detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.mean((torch.from_numpy(data) @ w) ** 2), [w])
    return [g]


def test_accumulation_over_slices_equals_the_big_batch_step():
    """tests/test_train_ergonomics.py:26: two microbatches of half a batch
    give the update of one step on the whole batch; the mini-step's update
    is zero."""
    from tnerf_torch.train import create_optimizer

    data = np.random.default_rng(0).normal(0, 1, (8, 4)).astype(np.float32)
    big = {"w": torch.ones(4)}
    create_optimizer(TrainConfig(steps=10), big).step(_toy_grads(big, data))
    acc = {"w": torch.ones(4)}
    opt = create_optimizer(TrainConfig(steps=10, grad_accum_steps=2), acc)
    opt.step(_toy_grads(acc, data[:4]))
    assert torch.equal(acc["w"], torch.ones(4))
    opt.step(_toy_grads(acc, data[4:]))
    _close(acc["w"], big["w"], "two microbatches against the big batch")
    assert float((acc["w"] - 1).abs().sum()) > 0


def test_nonfinite_microbatch_is_skipped_without_poisoning_the_window():
    """tests/test_train_ergonomics.py:57: a NaN microbatch first, then two
    good ones: the big-batch update."""
    from tnerf_torch.train import create_optimizer

    data = np.random.default_rng(1).normal(0, 1, (8, 4)).astype(np.float32)
    p = {"w": torch.ones(4)}
    opt = create_optimizer(TrainConfig(steps=10, grad_accum_steps=2, skip_nonfinite=True), p)
    opt.step([torch.full((4,), float("nan"))])
    assert torch.equal(p["w"], torch.ones(4)) and int(opt.mini_step) == 0
    for sl in (data[:4], data[4:]):
        opt.step(_toy_grads(p, sl))
    big = {"w": torch.ones(4)}
    create_optimizer(TrainConfig(steps=10), big).step(_toy_grads(big, data))
    _close(p["w"], big["w"], "after a skipped NaN microbatch")
    assert int(opt.total_notfinite) == 1


def test_warmup_and_decay_count_updates_under_accumulation():
    """tests/test_train_ergonomics.py:85 / :102 with k = 2: the schedule of
    updates, warmup // k and horizon // k long (`tnerf/train.py:76-80`):
    the first update moves nothing, the rate reaches lr at the end of the
    warmup and lr * lr_final_fraction at the last update, as optax's joined
    schedule gives it."""
    from tnerf_torch.train import create_optimizer

    cfg = TrainConfig(steps=200, lr=1e-3, lr_warmup_steps=40, lr_final_fraction=0.1,
                      grad_accum_steps=2)
    p = {"w": torch.ones(4)}
    opt = create_optimizer(cfg, p)
    assert (opt.warmup, opt.decay_steps) == (20, 80)
    sched = optax.join_schedules([optax.linear_schedule(0.0, cfg.lr, 20),
                                  optax.exponential_decay(cfg.lr, 80, 0.1)], [20])
    for c in (0, 1, 19, 20, 57, 100):
        _close(opt.learning_rate(torch.tensor(c, dtype=torch.int32)), sched(c), f"update {c}")
    for _ in range(2):
        opt.step([torch.ones(4)])
    assert torch.equal(p["w"], torch.ones(4))  # the first emitted update has rate 0
    for _ in range(4):
        opt.step([torch.ones(4)])
    assert float((p["w"] - 1).abs().sum()) > 0


# ---- train steps with a stand-in renderer -----------------------------------

def _fake_renderers(width=3):
    """(reference renderer, port renderer): rgb = sigmoid of the first three
    weights for every ray, acc = sigmoid of the fourth, as functions of the
    params (the reference's tests use such stand-ins)."""

    def jrender(params, rays, key, occupancy=None):
        w = params["w"]
        n = rays.origins.shape[0]
        return SimpleNamespace(rgb=jnp.broadcast_to(jax.nn.sigmoid(w[:3]), (n, 3)),
                               acc=jnp.broadcast_to(jax.nn.sigmoid(w[3]), (n,)))

    def render(params, rays, occupancy=None, generator=None):
        w = params["w"]
        n = rays.origins.shape[0]
        return SimpleNamespace(rgb=torch.sigmoid(w[:3]).expand(n, 3),
                               acc=torch.sigmoid(w[3]).expand(n))

    return jrender, render


class _Field(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))

    def params(self):
        return dict(self.named_parameters())


def _batches(n, with_alpha=False):
    from tnerf.cameras import Rays as JRays
    from tnerf.train import RayBatch as JBatch
    from tnerf_torch.cameras import Rays
    from tnerf_torch.train import RayBatch

    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        gt = rng.uniform(0, 1, (6, 4 if with_alpha else 3)).astype(np.float32)
        if with_alpha:
            gt[:, 3] = rng.integers(0, 2, 6)
        z = np.zeros((6, 3), np.float32)
        out.append((JBatch(JRays(jnp.asarray(z), jnp.asarray(z), jnp.zeros((6, 2))),
                           jnp.asarray(gt)),
                    RayBatch(Rays(torch.from_numpy(z), torch.from_numpy(z), torch.zeros(6, 2)),
                             torch.from_numpy(gt))))
    return out


W0 = np.asarray([0.3, -0.2, 0.5, 0.1, 0.7], np.float32)


def test_param_ema_starts_as_the_params_and_updates_as_the_reference():
    """tests/test_ema_clip.py:51: the shadow starts as a copy of the initial
    params; after each step it is d e + (1 - d) p of the step's new params,
    bit-equal to the reference's expression (jitted, as its step runs it);
    three steps of both packages agree to 1e-6."""
    from tnerf.train import (
        TrainState as JState,
        create_optimizer as j_create,
        eval_params as j_eval_params,
        make_train_step as j_make,
    )
    from tnerf_torch.train import eval_params, init_train_state, make_train_step

    d = 0.9
    jrender, render = _fake_renderers()
    jopt = j_create(JTrain())
    jp = {"w": jnp.asarray(W0)}
    jst = JState(jp, jopt.init(jp), jnp.zeros((), jnp.int32), {"w": jnp.asarray(W0)})
    jstep = j_make(jrender, jopt, param_ema=d)
    state = init_train_state(_Field(W0), TrainConfig(param_ema=d))
    assert torch.equal(state.ema["w"], state.params["w"].detach())
    assert eval_params(state) is state.ema and state.ema["w"] is not state.params["w"]
    step = make_train_step(render, param_ema=d)
    blend = jax.jit(lambda e, p: jnp.float32(d) * e + (1.0 - jnp.float32(d)) * p)
    for i, (jb, b) in enumerate(_batches(3)):
        e0 = state.ema["w"].clone()
        jst, _ = jstep(jst, jb, jax.random.PRNGKey(i))
        step(state, b)
        p1 = state.params["w"].detach()
        want = np.asarray(blend(jnp.asarray(e0.numpy()), jnp.asarray(p1.numpy())))
        np.testing.assert_array_equal(state.ema["w"].numpy(), want)
        _close(state.ema["w"], j_eval_params(jst)["w"], f"step {i}: ema")
        _close(p1, jst.params["w"], f"step {i}: params")
    st_off = init_train_state(_Field(W0), TrainConfig())
    assert st_off.ema is None and eval_params(st_off) is not None


def test_random_background_compositing_matches_the_reference():
    """tests/test_random_background.py's step: prediction and ground truth
    over the colours the reference's key draws (fed to the port in place of
    its own draw, `sampling.draw_uniform`): the composited error bit-equal
    to the reference's expression, and the step's loss and update the
    reference's within 1e-6."""
    from tnerf.train import TrainState as JState, create_optimizer as j_create
    from tnerf.train import make_train_step as j_make
    from tnerf_torch import sampling
    from tnerf_torch.train import init_train_state, make_train_step

    jrender, render = _fake_renderers()
    (jb, b), = _batches(1, with_alpha=True)
    key = jax.random.PRNGKey(3)
    _, k_bg = jax.random.split(key)
    bg = np.asarray(jax.random.uniform(k_bg, (6, 3), jnp.float32))
    jopt = j_create(JTrain())
    jp = {"w": jnp.asarray(W0)}
    jst, jaux = j_make(jrender, jopt, random_bg=True)(
        JState(jp, jopt.init(jp), jnp.zeros((), jnp.int32)), jb, key)
    state = init_train_state(_Field(W0), TrainConfig())
    orig = sampling.draw_uniform
    sampling.draw_uniform = lambda gen, shape, device: torch.from_numpy(bg.copy()).reshape(shape)
    try:
        aux = make_train_step(render, random_bg=True)(state, b)
    finally:
        sampling.draw_uniform = orig
    _close(aux["loss"], jaux["loss"], "loss")
    _close(state.params["w"].detach(), jst.params["w"], "params after the step")
    # the compositing alone, term by term
    rgb, acc = np.float32([[0.2, 0.5, 0.9]] * 6), np.float32([0.3] * 6)
    gt = np.asarray(jb.gt_rgb)
    a = gt[..., 3:4]
    want = (rgb + (1.0 - acc)[..., None] * bg) - (gt[..., :3] * a + bg * (1.0 - a))
    jwant = jax.jit(lambda r, c, g, k: (r + (1.0 - c)[..., None] * k)
                    - (g[..., :3] * g[..., 3:4] + k * (1.0 - g[..., 3:4])))(rgb, acc, gt, bg)
    t = lambda x: torch.from_numpy(np.asarray(x))
    got = (t(rgb) + (1.0 - t(acc))[..., None] * t(bg)) \
        - (t(gt)[..., :3] * t(gt)[..., 3:4] + t(bg) * (1.0 - t(gt)[..., 3:4]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwant))
    np.testing.assert_array_equal(got.numpy(), want)


def _sphere_dataset(channels):
    from tnerf_torch.data.dataset import ImageDataset

    rng = np.random.default_rng(2)
    img = np.ones((2, 8, 8, 4), np.float32)
    img[..., 3] = rng.integers(0, 2, (2, 8, 8))
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 2, 3] = 3.0
    return ImageDataset(images=img[..., :channels], poses=poses, focal=10.0, width=8, height=8,
                        channels=channels, split="train")


def test_pixel_sampler_keeps_alpha():
    """tests/test_random_background.py:53: with random_background the
    sampler keeps straight RGBA (alpha 0 / 1), without it composites to
    RGB; a 3-channel scene is refused with the reference's message."""
    from tnerf.data.dataset import ImageDataset as JData
    from tnerf.train import PixelSampler as JSampler
    from tnerf_torch.train import PixelSampler

    ds = _sphere_dataset(4)
    gen = torch.Generator().manual_seed(0)
    batch = PixelSampler(ds, 1.0, True, "cpu", random_background=True).sample(gen, 32)
    assert batch.gt_rgb.shape == (32, 4)
    assert set(np.unique(batch.gt_rgb[:, 3].numpy())) <= {0.0, 1.0}
    assert PixelSampler(ds, 1.0, True, "cpu").sample(gen, 32).gt_rgb.shape == (32, 3)
    ds3 = _sphere_dataset(3)
    with pytest.raises(ValueError) as want:
        JSampler(JData(**vars(ds3)), 1.0, True, random_background=True)
    with pytest.raises(ValueError) as got:
        PixelSampler(ds3, 1.0, True, "cpu", random_background=True)
    assert str(got.value) == str(want.value) and "alpha" in str(got.value)


def test_random_background_requires_an_alpha_dataset(tmp_path):
    """tests/test_random_background.py:133: a procedural scene (3 channels)
    under train.random_background is refused before training."""
    from tnerf_torch.train_loop import run_training

    cfg = Config().apply_overrides(SMALL + ["train.random_background=true", "train.steps=2",
                                            "render.pipeline=uniform",
                                            f"logging.out_dir={tmp_path}"])
    with pytest.raises(ValueError, match="train.random_background needs GT alpha"):
        run_training(cfg, device="cpu")


# ---- the BARF window and unit view directions ------------------------------

def test_barf_window_and_windowed_encoding_match_the_reference():
    """tests/test_pose_opt.py:207: the band weights bit-equal to the
    reference's for alphas over [0, 1] and beyond; the windowed encoding
    each band's sin and cos times its weight, within 1e-5 of the
    reference's (sin / cos of large arguments differ in the last bits
    between the two libraries, tests/test_torch_field_occupancy.py); a
    window of ones is the plain encoding, a zero window keeps only the raw
    input."""
    from tnerf.fields.encodings import barf_window as j_window, frequency_encoding as j_enc
    from tnerf_torch.fields.encodings import barf_window, frequency_encoding

    L = 6
    x = np.random.default_rng(0).normal(0, 1, (5, 3)).astype(np.float32)
    for a in list(np.linspace(-0.25, 1.25, 13, dtype=np.float32)) + [np.float32(1 / 3)]:
        w = barf_window(torch.tensor(a), L)
        np.testing.assert_array_equal(w.numpy(), np.asarray(j_window(jnp.asarray(a), L)))
        got = frequency_encoding(torch.from_numpy(x), L, window=w)
        np.testing.assert_allclose(got.numpy(), np.asarray(j_enc(
            jnp.asarray(x), L, window=j_window(jnp.asarray(a), L))), atol=1e-5, rtol=0)
        # the window scales each band's sin and cos of the plain encoding
        bands = frequency_encoding(torch.from_numpy(x), L)[:, 3:].reshape(5, 3, 2, L)
        np.testing.assert_array_equal(got[:, 3:].reshape(5, 3, 2, L).numpy(),
                                      (bands * w).numpy())
    half = barf_window(torch.tensor(0.5), L).numpy()
    assert np.allclose(half[:3], 1.0) and np.allclose(half[3:], 0.0)
    full = frequency_encoding(torch.from_numpy(x), L)
    assert torch.equal(frequency_encoding(torch.from_numpy(x), L, window=torch.ones(L)), full)
    zeroed = frequency_encoding(torch.from_numpy(x), L, window=torch.zeros(L)).numpy()
    np.testing.assert_array_equal(zeroed[:, :3], x)
    assert np.allclose(zeroed[:, 3:], 0.0)


def _field_pair(extra_ov=(), alpha=None):
    """(reference field, its params, port params) of a small fused5d field,
    the weights carried across; with alpha, both carry freq_alpha."""
    from tnerf.train_loop import build_field
    from tnerf_torch.utils.checkpoint import params_from_jax

    ov = ["field_.hidden_width=16", "field_.hidden_layers=2", "field_.n_frequencies=4",
          "field_.n_frequencies_view=3", "field_.compute_dtype=float32"] + list(extra_ov)
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    jfield = build_field(jcfg)
    jparams = jfield.init(jax.random.PRNGKey(4))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    if alpha is not None:
        jparams = {**jparams, "freq_alpha": jnp.float32(alpha)}
        params["freq_alpha"] = torch.tensor(alpha, dtype=torch.float32)
    return jfield, jparams, params, cfg


def _points(n=64):
    rng = np.random.default_rng(6)
    x = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    tp = np.stack([rng.uniform(0, np.pi, n), rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    return x, tp


@pytest.mark.parametrize("view_param,alpha", [("thetaphi", 0.37), ("unit", None),
                                              ("unit", 0.8)])
def test_field_with_window_and_unit_view_matches_the_reference(view_param, alpha):
    """The fused5d field at positions and (theta, phi): the BARF window
    where params carry freq_alpha, the frequency encoding of the unit view
    direction under view_param=unit (width 3 (2 L + 1) against 2 (2 L + 1),
    `tnerf/fields/nerf_field.py:160-188`): rgb and sigma of a float32 field
    within 1e-5 of the reference's (jitted; sin / cos and the products'
    order differ in the last bits); the occupancy probe reads the window
    too."""
    from tnerf_torch.fields.nerf_field import NeRFField, apply_field, view_enc_dim

    jfield, jparams, params, cfg = _field_pair([f"field_.view_param={view_param}"], alpha)
    assert view_enc_dim(cfg.field_) == (3 if view_param == "unit" else 2) * 7
    x, tp = _points()
    jrgb, jsig = jax.jit(jfield.apply)(jparams, jnp.asarray(x), jnp.asarray(tp))
    rgb, sig = apply_field(params, cfg.field_, cfg.grid, torch.from_numpy(x), torch.from_numpy(tp))
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(jrgb), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sig.detach().numpy(), np.asarray(jsig), atol=1e-5, rtol=1e-5)
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict({k: v for k, v in params.items() if k != "freq_alpha"})
    np.testing.assert_allclose(field.density(torch.from_numpy(x), params).detach().numpy(),
                               np.asarray(jax.jit(jfield.density)(jparams, x)), atol=1e-5,
                               rtol=1e-5)
    if alpha is not None:  # the window's alpha reaches the field with its gradient cut
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        apply_field(p, cfg.field_, cfg.grid, torch.from_numpy(x),
                    torch.from_numpy(tp))[0].sum().backward()
        assert p["freq_alpha"].grad is None and p["trunk.w.0"].grad is not None


def test_unit_view_param_on_the_fused_pipeline_is_refused_as_the_reference_fails():
    """The fused kernel packs (x, y, z, theta, phi): the reference's fused
    renderer fails at its first call (layer 0's view columns do not match
    its encoding); the port refuses the configuration by name at config
    time, for serving and training, and runs it on grid_march."""
    from tnerf.render.pallas_fused2 import pack_params_f32
    from tnerf.render.fused_common import _norm_affine
    from tnerf_torch.train_loop import build_renderer, validate_ported

    jfield, jparams, _, cfg = _field_pair(["field_.view_param=unit"])
    s_aff, b_aff = _norm_affine(jfield.grid)
    with pytest.raises(ValueError, match="layer-0 in_dim"):
        pack_params_f32(jparams, jfield.config, s_aff, b_aff)
    fused = cfg.apply_overrides(["render.pipeline=fused"])
    for for_eval in (True, False):
        with pytest.raises(ValueError, match="field_.view_param='unit' needs"):
            validate_ported(fused, for_eval=for_eval)
    assert callable(build_renderer(cfg.apply_overrides(["render.pipeline=grid_march"]),
                                   for_eval=False))


def test_freq_alpha_is_exact_under_adamw():
    """tests/test_pose_opt.py:331: with weight decay the schedule leaf is
    written back as exactly this step's alpha, step after step, past the
    end of the window too."""
    from tnerf_torch.train import TrainState, create_optimizer, make_train_step

    params = {"w": torch.ones(4, requires_grad=True),
              "freq_alpha": torch.zeros((), requires_grad=True)}

    def render(p, rays, occupancy=None, generator=None):
        n = rays.origins.shape[0]
        return SimpleNamespace(rgb=torch.ones(n, 3) * p["w"].mean() * p["freq_alpha"].detach(),
                               acc=torch.ones(n))

    class Holder(torch.nn.Module):
        def params(self):
            return {"w": params["w"]}

    state = TrainState(Holder(), create_optimizer(TrainConfig(skip_nonfinite=False,
                                                              weight_decay=0.1), params),
                       extra={"freq_alpha": params["freq_alpha"]})
    step = make_train_step(render, freq_anneal=10)
    for (_, b) in _batches(13):
        step(state, b)
        want = min(np.float32(state.step - 1) / np.float32(10), 1.0)
        got = float(params["freq_alpha"].detach())
        assert got == want, (state.step, got)
    assert float(state.optimizer.state["mu"]["freq_alpha"]) == 0.0


def test_freq_anneal_end_to_end_and_validation(tmp_path):
    """tests/test_pose_opt.py:233: a grid_march run with a window of 10
    steps: the checkpoint at step 5 holds the window of its last step, 4 /
    10, the final one 1.0, both read by the reference's restore into its
    own template; a table encoding and the fused pipeline are refused with
    the reference's errors."""
    from tnerf.grid.occupancy import init_occupancy as j_occ
    from tnerf.train import create_optimizer as j_create, init_train_state as j_init
    from tnerf.train import pose_extra_params as j_extra
    from tnerf.train_loop import build_field
    from tnerf.utils.checkpoint import restore_checkpoint
    from tnerf_torch.train_loop import run_training, validate_ported

    ov = SMALL + ["train.freq_anneal_steps=10", "train.steps=20", "train.eval_every=0",
                  "train.checkpoint_every=5", f"logging.out_dir={tmp_path}"]
    cfg = Config().apply_overrides(ov)
    m = run_training(cfg, device="cpu")
    assert np.isfinite(m["psnr_test"])
    jcfg = JConfig().apply_overrides(ov)
    template = (j_init(build_field(jcfg), j_create(jcfg.train), 0, j_extra(jcfg, 3)),
                j_occ(jcfg.grid))
    ck = str(tmp_path / "checkpoints")
    _, (st, _) = restore_checkpoint(ck, template)
    assert float(st.params["freq_alpha"]) == 1.0
    os.rename(os.path.join(ck, "step_00000020.npz"), os.path.join(ck, "x.npz"))
    for n in (15, 10):
        os.remove(os.path.join(ck, f"step_{n:08d}.npz"))
    _, (st, _) = restore_checkpoint(ck, template)
    assert np.asarray(st.params["freq_alpha"]) == np.float32(4) / np.float32(10)
    for bad, match in ((["field_.encoding=hashgrid", "render.pipeline=grid_march"],
                        "anneals the frequency positional encoding"),
                       (["render.pipeline=fused"], "needs the XLA field path")):
        with pytest.raises(ValueError, match=match):
            validate_ported(cfg.apply_overrides(bad), for_eval=False)


# ---- remat -----------------------------------------------------------------

@pytest.mark.parametrize("pipeline", ["fused", "fused_cdf", "grid_march_cdf"])
def test_remat_is_semantically_invisible(pipeline):
    """tests/test_train_ergonomics.py:248: one train step with the renderer
    under torch.utils.checkpoint gives the same loss and the same updated
    parameters, bit for bit, as without (the CPU runs the fused kernels'
    plain versions, which repeat exactly); where the renderer draws CDF
    jitter, the rerun replays the forward's draws and the generator ends
    where it ends without remat, random background's draw included."""
    from tnerf_torch.cameras import Rays, viewdirs_to_thetaphi
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.train import RayBatch, init_train_state, make_train_step
    from tnerf_torch.train_loop import build_renderer

    ov = SMALL + ["field_.hidden_width=32", "render.fused_tighten=true",
                  "render.pipeline=" + pipeline.split("_cdf")[0]]
    if pipeline.endswith("cdf"):
        ov += ["sampler.placement=occupancy_cdf", "sampler.cdf_bins=8"]
    cfg = Config().apply_overrides(ov)
    rng = np.random.default_rng(7)
    o = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0
    d = -o / 3.0
    td = torch.from_numpy(d)
    gt = torch.from_numpy(rng.uniform(0, 1, (64, 4)).astype(np.float32))
    batch = RayBatch(Rays(torch.from_numpy(o), td, viewdirs_to_thetaphi(td)), gt)
    occ = torch.from_numpy(rng.uniform(0, 1, (8, 8, 8)) < 0.6)
    outs = []
    for remat in (False, True):
        field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(3))
        state = init_train_state(field, cfg.train)
        gen = torch.Generator().manual_seed(9)
        step = make_train_step(build_renderer(cfg, for_eval=False), remat=remat, random_bg=True)
        aux = step(state, batch, occ, gen)
        outs.append((float(aux["loss"]), {k: v.detach().clone() for k, v in state.params.items()},
                     torch.rand(4, generator=gen)))
    (l0, p0, g0), (l1, p1, g1) = outs
    assert l0 == l1 and torch.equal(g0, g1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


# ---- checkpoints of the new layouts, both ways ------------------------------

LAYOUTS = {
    "ema": ["train.param_ema=0.9"],
    "accum": ["train.grad_accum_steps=2", "train.lr_final_fraction=0.1"],
    "anneal": ["train.freq_anneal_steps=10"],
    "ema_accum": ["train.param_ema=0.9", "train.grad_accum_steps=2"],
    "ema_anneal": ["train.param_ema=0.9", "train.freq_anneal_steps=10",
                   "train.optimize_poses=true"],
    "accum_anneal": ["train.grad_accum_steps=3", "train.freq_anneal_steps=10",
                     "train.skip_nonfinite=false"],
}


def _filled(tree, rng):
    """A pytree of the same structure with seeded values of each leaf's
    dtype (what a checkpoint of a run under way holds)."""
    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.bool_:
            return np.asarray(rng.integers(0, 2, x.shape).astype(bool))
        if np.issubdtype(x.dtype, np.integer):
            return np.asarray(rng.integers(0, 7, x.shape).astype(x.dtype))
        return np.asarray(rng.normal(0, 1, x.shape).astype(x.dtype))
    return jax.tree.map(fill, tree)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_checkpoints_of_the_new_layouts_both_ways(layout, tmp_path):
    """The EMA, MultiSteps' state and the freq_alpha leaf, alone and in
    pairs: a reference checkpoint (its treedef from the reference's own
    template) resumes in the port leaf for leaf, the port writes that
    treedef string, and the reference restores the port's checkpoint into
    its template with every leaf equal."""
    from tnerf.grid.occupancy import init_occupancy as j_occ
    from tnerf.train import create_optimizer as j_create, init_train_state as j_init
    from tnerf.train import pose_extra_params as j_extra
    from tnerf.train_loop import build_field
    from tnerf.utils.checkpoint import restore_checkpoint, save_checkpoint as j_save
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.train import init_train_state, pose_extra_params
    from tnerf_torch.utils.checkpoint import read_train_checkpoint, save_checkpoint

    ov = SMALL + LAYOUTS[layout]
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    jst = j_init(build_field(jcfg), j_create(jcfg.train), 0, j_extra(jcfg, 3),
                 param_ema=jcfg.train.param_ema > 0)
    template = (jst, j_occ(jcfg.grid))
    payload = _filled(template, np.random.default_rng(1))
    payload = (payload[0]._replace(step=np.asarray(7, np.int32)), payload[1])
    j_save(str(tmp_path / "j"), 7, payload)
    treedef = json.load(open(tmp_path / "j" / "treedef.json"))["treedef"]
    assert treedef == str(jax.tree_util.tree_structure(template))

    ck = read_train_checkpoint(str(tmp_path / "j"), "cpu")
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    state = init_train_state(field, cfg.train, pose_extra_params(cfg, 3))
    state.load_params(ck.params)
    state.optimizer.load_state(ck.opt_state)
    assert (ck.ema is None) == (jcfg.train.param_ema == 0)
    save_checkpoint(str(tmp_path / "t"), ck.step, state.params, state.optimizer.state,
                    ck.occupancy, cfg.train, ema=ck.ema)
    assert json.load(open(tmp_path / "t" / "treedef.json"))["treedef"] == treedef
    step, got = restore_checkpoint(str(tmp_path / "t"), template)
    assert step == 7
    for a, b in zip(jax.tree.leaves(payload), jax.tree.leaves(got)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---- keep_best, debug_nans, profile -----------------------------------------

def test_restore_best_psnr_survives_resume(tmp_path):
    """tests/test_train_ergonomics.py:159, against the reference's tracker
    on the same metrics files."""
    from tnerf.train_loop import _restore_best_psnr as j_restore
    from tnerf_torch.train_loop import _restore_best_psnr
    from tnerf_torch.utils.metrics import get_logger

    out = tmp_path / "run"
    out.mkdir()
    with open(out / "metrics.jsonl", "w") as fh:
        fh.write(json.dumps({"step": 9, "best_psnr": 28.5, "best_step": 10}) + "\n")
        fh.write(json.dumps({"step": 19, "loss": 0.1}) + "\n")
        fh.write("not json\n")
        fh.write(json.dumps({"step": 19, "best_psnr": 30.1, "best_step": 20}) + "\n")
    log = get_logger()
    for ov, start in ((["train.keep_best=true"], 20), (["train.keep_best=true"], 0),
                      (["train.keep_best=false"], 20),
                      ([f"logging.out_dir={tmp_path / 'nope'}", "train.keep_best=true"], 20)):
        ov = [f"logging.out_dir={out}"] + ov
        got = _restore_best_psnr(Config().apply_overrides(ov), start, log)
        assert got == j_restore(JConfig().apply_overrides(ov), start, log)
    assert _restore_best_psnr(Config().apply_overrides(
        [f"logging.out_dir={out}", "train.keep_best=true"]), 20, log) == 30.1


def test_grad_accum_keep_best_and_remat_end_to_end(tmp_path):
    """tests/test_train_ergonomics.py:118: run_training with accumulation,
    warmup, keep_best, the weight EMA and remat writes a best checkpoint
    (the newest file its recorded best_step) that the reference restores
    into its MultiSteps + EMA template, with finite PSNRs; the optimizer
    made one update every two loop steps."""
    from tnerf.grid.occupancy import init_occupancy as j_occ
    from tnerf.train import create_optimizer as j_create, init_train_state as j_init
    from tnerf.train_loop import build_field
    from tnerf.utils.checkpoint import restore_checkpoint
    from tnerf_torch.train_loop import run_training
    from tnerf_torch.utils.checkpoint import latest_checkpoint, read_train_checkpoint

    ov = SMALL + ["train.steps=30", "train.eval_every=10", "train.grad_accum_steps=2",
                  "train.lr_warmup_steps=4", "train.keep_best=true", "train.param_ema=0.9",
                  "train.remat=true", "train.checkpoint_every=30", f"logging.out_dir={tmp_path}"]
    m = run_training(Config().apply_overrides(ov), device="cpu")
    assert np.isfinite(m["psnr_test"])
    best = [json.loads(line) for line in open(tmp_path / "metrics.jsonl") if "best_psnr" in line]
    assert best and np.isfinite(best[-1]["best_psnr"])
    bdir = str(tmp_path / "checkpoints_best")
    assert latest_checkpoint(bdir)[0] == best[-1]["best_step"]
    jcfg = JConfig().apply_overrides(ov)
    template = (j_init(build_field(jcfg), j_create(jcfg.train), 0, param_ema=True),
                j_occ(jcfg.grid))
    step, (jst, _) = restore_checkpoint(bdir, template)
    assert step == best[-1]["best_step"] and jst.ema is not None
    ck = read_train_checkpoint(str(tmp_path / "checkpoints"), "cpu")
    assert int(ck.opt_state["count"]) == 15 and int(ck.opt_state["gradient_step"]) == 15


def test_eval_reads_the_ema_weights(tmp_path):
    """Two fused steps at param_ema=0.5: the run's final eval equals the
    eval of the checkpoint's EMA weights (through the fused kernels' plain
    versions, which pack whatever params they are given), not that of its
    live weights; `cli eval` serves the same EMA weights."""
    from tnerf_torch.cli import main
    from tnerf_torch.eval import evaluate
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.train_loop import build_renderer, load_datasets, run_training
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint, read_train_checkpoint

    ov = SMALL + ["render.pipeline=fused", "render.fused_tighten=false", "field_.hidden_width=32",
                  "train.steps=2", "train.eval_every=0", "train.checkpoint_every=2",
                  "train.param_ema=0.5", "train.lr=0.05", "render.ray_compact=false",
                  f"logging.out_dir={tmp_path}"]
    cfg = Config().apply_overrides(ov)
    m = run_training(cfg, device="cpu")
    ck = read_train_checkpoint(str(tmp_path / "checkpoints"), "cpu")
    test = load_datasets(cfg, splits=("test",), device="cpu")["test"]
    renderer = build_renderer(cfg)
    payload = renderer_payload(ck.occupancy, cfg.sampler, cfg.grid)
    got = {tag: evaluate(renderer, params, test, 1.0, chunk_size=cfg.render.chunk_size,
                         occupancy=payload, device="cpu")["psnr_test"]
           for tag, params in (("ema", ck.ema), ("live", ck.params))}
    assert abs(m["psnr_test"] - got["ema"]) < 1e-9 and abs(got["ema"] - got["live"]) > 1e-3
    _, served, _ = load_jax_checkpoint(str(tmp_path / "checkpoints"), "cpu", ema=True)
    assert all(torch.equal(served[k], ck.ema[k]) for k in served)
    out = tmp_path / "eval.json"
    assert main(["eval", "--device", "cpu", "--config", str(tmp_path / "config.json"),
                 "--out", str(out)]) == 0
    assert abs(json.load(open(out))["psnr_test"] - got["ema"]) < 1e-9
    with pytest.raises(ValueError, match="weight EMA"):
        load_jax_checkpoint(str(tmp_path / "checkpoints"), "cpu", ema=False)


def test_debug_nans_stops_at_the_first_nonfinite_step():
    """logging.debug_nans: the step whose loss turns non-finite raises
    FloatingPointError naming that step, before its update; without it the
    non-finite skip rejects the update and training goes on."""
    from tnerf_torch.train import TrainState, create_optimizer, make_train_step

    def render(p, rays, occupancy=None, generator=None):
        n = rays.origins.shape[0]
        scale = torch.where(p["w"][0] > 1.05, torch.tensor(float("nan")), torch.tensor(1.0))
        return SimpleNamespace(rgb=torch.sigmoid(p["w"][:3]).expand(n, 3) * scale,
                               acc=torch.ones(n))

    for debug in (True, False):
        params = {"w": torch.ones(4, requires_grad=True)}

        class Holder(torch.nn.Module):
            def params(self):
                return params

        state = TrainState(Holder(), create_optimizer(TrainConfig(lr=0.03), params))
        step = make_train_step(render, debug_nans=debug)
        batches = [b for _, b in _batches(6)]
        params["w"].data[0] = 1.0
        raised = None
        for i, b in enumerate(batches):
            if i == 2:
                with torch.no_grad():
                    params["w"][0] = 2.0  # the step's loss turns NaN
            before = params["w"].detach().clone()
            try:
                step(state, b)
            except FloatingPointError as e:
                raised = (i, str(e), torch.equal(params["w"].detach(), before))
                break
        if debug:
            assert raised is not None and raised[0] == 2 and "at step 2" in raised[1] \
                and raised[2]
        else:
            assert raised is None and int(state.optimizer.total_notfinite) == 4


def test_profile_writes_a_trace(tmp_path):
    """logging.profile: a torch.profiler Chrome trace of the training loop
    under <out_dir>/profile."""
    from tnerf_torch.train_loop import run_training
    from tnerf_torch.utils.metrics import TRACE_FILE

    cfg = Config().apply_overrides(SMALL + ["train.steps=3", "train.eval_every=0",
                                            "logging.profile=true", f"logging.out_dir={tmp_path}"])
    run_training(cfg, device="cpu")
    with open(tmp_path / "profile" / TRACE_FILE) as fh:
        events = json.load(fh)["traceEvents"]
    assert sum(1 for e in events if e.get("name", "").startswith("aten::")) > 10
