"""Every stage of a grid_intervals train step, the port against the reference
package, on real mid-training states of the committed intervals config
(runs/hard_r4_intervals16/config.json at its full width: 8 x 128, 10 + 4
frequencies, a 16^3 grid walked for 48 hits, 16 samples per interval,
threshold 0.01) and on a few dozen rays of the hard scene (ROADMAP Queue C 2).

The states are the port's own, trained on an H100 from the reference's
initial state (runs/hard_r4_intervals16_port/README.md): after 257 steps
(the first refresh, at step 256, included), 500 and 1500.  Each is loaded
into both packages (the checkpoint layout is the reference's), and one step
is taken stage by stage:

1. the grid walk on the state's bitfield (kernel B5's plain version against
   the reference's scan walk): per ray the same occupied cells in order,
   bounds within T_ATOL; then the samples placed in them from the same
   uniforms per interval;
2. the forward render and the loss, both packages drawing those uniforms;
3. each leaf's gradient;
4. one Adam update from the same gradient at the state's step, under the
   config's schedule (lr_final_fraction 0.1 over 2500 steps);
5. one occupancy refresh with the same probe jitter: the density EMA, then
   the bits at the threshold.

Beside them, what a trajectory fed the reference's draws cannot see: the
law of the port's own draws in a step of this config (the pixel sampler's
randint, the stratified jitter in each interval, the refresh's probe
jitter), against the reference's code.

Stages 2 and 3 run the reference eager: under jit XLA:CPU contracts o + t d
into a fused multiply-add, and a position one ulp off is a phase the
encoding's highest octave (2^9) turns into other bf16 roundings (on these
states the gradients then part by up to 8e-2 of a leaf's largest entry).
They run at the config's bf16 and again at compute_dtype=float32, where
only the order of float32 sums is left.

Tolerances, stated before the committed states' first run (shaped by runs
on the port's mid-training states from its own initial weights): the
walk's bounds T_ATOL (the scan walk adds each axis's crossing step
repeatedly, the kernel recomputes it from the cell: tests/test_torch_dda.py;
measured 1.4e-6); the render per ray RGB_ATOL / ACC_ATOL / DEPTH_ATOL (the
bounds the restored checkpoints and B1 are held to; measured 5.7e-4 at
most) and the loss LOSS_RTOL (the one-step bound of
tests/test_torch_march_slice.py; measured 6e-6); each gradient at bf16
GRAD_RTOL of its leaf's largest entry, one bf16 step there (both packages
round dW to bf16, and sums a hair apart round to neighbours; measured 5e-3),
at float32 GRAD_F32_RTOL (measured 1.3e-6); the Adam update ADAM_RTOL of
each leaf's largest entry (measured 5e-8); the refresh EMA_RTOL of the
EMA's largest entry and at most BITS_DIFF_MAX bits apart, each where the
reference's EMA lies within EDGE_RTOL of the threshold (one bf16 step of
the raw output moves a density at the threshold by about 1.4%; measured
per-cell gaps up to 4.2%)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "runs", "hard_r4_intervals16", "config.json")
STATES = os.path.join(REPO, "runs", "hard_r4_intervals16_port")
STATE_STEPS = (257, 500, 1500)
N_RAYS = 32  # of them N_HIT on the rods, the rest drawn from every pixel
N_HIT = 24

T_ATOL = 3e-4
RGB_ATOL, ACC_ATOL, DEPTH_ATOL = 5e-3, 5e-3, 2e-2
LOSS_RTOL = 1e-4
GRAD_RTOL = 2.0 ** -7
GRAD_F32_RTOL = 1e-5
ADAM_RTOL = 1e-6
EMA_RTOL, EDGE_RTOL, BITS_DIFF_MAX = 1e-2, 5e-2, 16
# the law of a draw: its mean, its variance and the correlation of
# neighbours along each axis within MOMENT_SIGMAS standard errors of a
# uniform law's
MOMENT_SIGMAS = 5.0


def _hard_rays(cfg, n, n_hit, seed=0):
    """(o, d, theta-phi, gt) numpy of n pixels of the hard scene's train
    views, n_hit of them where the ground truth is not background; the
    ground truth marched per ray as the scene generator marches it."""
    from tnerf_torch.cameras import camera_rays, focal_from_angle, viewdirs_to_thetaphi
    from tnerf_torch.data.procedural import CAMERA_ANGLE_X, FIELDS, sphere_poses
    from tnerf_torch.render.composite import composite

    W = 128
    poses = sphere_poses(24, radius=3.5, seed=10)
    rng = np.random.default_rng(seed)
    views = rng.integers(0, len(poses), 8)
    o, d = [], []
    for v in views:
        r = camera_rays(poses[v], W, W, focal_from_angle(W, CAMERA_ANGLE_X))
        o.append(r.origins.reshape(-1, 3))
        d.append(r.directions.reshape(-1, 3))
    o, d = torch.cat(o), torch.cat(d)
    idx = torch.from_numpy(rng.permutation(o.shape[0])[:4096])
    o, d = o[idx], d[idx]
    S = 772
    t = torch.linspace(cfg.sampler.near, cfg.sampler.far, S + 1)
    t_mid, deltas = 0.5 * (t[:-1] + t[1:]), t[1:] - t[:-1]
    rgb, sigma = FIELDS["hard"]((o[:, None, :] + d[:, None, :] * t_mid[:, None]).reshape(-1, 3))
    B = o.shape[0]
    gt = composite(rgb.reshape(B, S, 3), sigma.reshape(B, S), deltas.expand(B, S),
                   t_mid=t_mid.expand(B, S), white_background=False).rgb.clamp(0.0, 1.0)
    hit = (gt.sum(-1) > 0.05).nonzero()[:, 0]
    miss = (gt.sum(-1) <= 0.05).nonzero()[:, 0]
    pick = torch.cat([hit[:n_hit], miss[:n - n_hit]])
    o, d, gt = o[pick], d[pick], gt[pick]
    return (o.numpy(), d.numpy(), viewdirs_to_thetaphi(d).numpy(), gt.numpy())


def _slot_map(ref_mask, got_mask):
    """[B, H] index into the reference's slots for each of the port's: the
    port's k-th valid slot reads the reference's k-th valid one (a slot the
    port leaves empty reads slot 0, whose draws it masks out)."""
    B, H = ref_mask.shape
    out = np.zeros((B, H), np.int64)
    for b in range(B):
        r, g = np.nonzero(ref_mask[b])[0], np.nonzero(got_mask[b])[0]
        assert len(r) == len(g), (b, len(r), len(g))
        out[b, g] = r
    return out


@pytest.fixture(scope="module")
def setup():
    from tnerf.config import Config as JConfig
    from tnerf.train import create_optimizer
    from tnerf.train_loop import build_field
    from tnerf_torch.config import Config

    jcfg, cfg = JConfig.from_json_file(CONFIG), Config.from_json_file(CONFIG)
    jfield = build_field(jcfg)
    return dict(jcfg=jcfg, cfg=cfg, jfield=jfield, joptimizer=create_optimizer(jcfg.train),
                rays=_hard_rays(cfg, N_RAYS, N_HIT))


def _reference_step(jcfg, rays, params, key, bits):
    """((loss, RenderResult), gradients) of the reference's render of the
    rays, eager: under jit XLA:CPU contracts o + t d into a fused
    multiply-add, a position one ulp off, which the encoding's highest
    octave (2^9) turns into phases that flip bf16 roundings."""
    from tnerf.cameras import Rays as JRays
    from tnerf.train_loop import build_field, build_renderer as j_build

    o, d, tp, gt = rays
    render = j_build(jcfg, build_field(jcfg))

    def loss(p):
        res = render(p, JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tp)), key, bits)
        return jnp.mean(jnp.square(res.rgb - gt)), res

    return jax.value_and_grad(loss, has_aux=True)(params)


def _port_step(cfg, rays, params, ref_iv, u_ref, bits):
    """(loss, RenderResult, gradients) of the port's render of the rays,
    walking the reference's intervals and drawing its uniforms."""
    from tnerf_torch import sampling
    from tnerf_torch.cameras import Rays
    from tnerf_torch.grid.traversal import Intervals
    from tnerf_torch.render import grid_renderer
    from tnerf_torch.train_loop import build_renderer

    o, d, tp, gt = rays
    walk = Intervals(*(torch.from_numpy(np.array(a)) for a in ref_iv))
    real = sampling.draw_uniform, grid_renderer.traverse_grid

    def fed(gen, shape, device):
        assert tuple(shape) == u_ref.shape
        return torch.from_numpy(u_ref)

    sampling.draw_uniform = fed
    grid_renderer.traverse_grid = lambda *a, **kw: walk
    try:
        res = build_renderer(cfg, for_eval=False)(
            params, Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tp)), bits,
            torch.Generator())
    finally:
        sampling.draw_uniform, grid_renderer.traverse_grid = real
    loss = torch.mean(torch.square(res.rgb - torch.from_numpy(gt)))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return float(loss.detach()), res, grads


@pytest.fixture(scope="module", params=STATE_STEPS, ids=[f"step{s}" for s in STATE_STEPS])
def stages(request, setup):
    """Every stage of one step of both packages from one committed state."""
    import optax

    from tnerf.grid.occupancy import init_occupancy as j_init_occ
    from tnerf.grid.occupancy import update_occupancy as j_update
    from tnerf.grid.traversal import traverse_grid as j_traverse
    from tnerf.sampling import interval_samples as j_interval_samples
    from tnerf.train import init_train_state as j_init
    from tnerf.utils.checkpoint import restore_checkpoint
    from tnerf_torch import sampling
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.grid.occupancy import update_occupancy
    from tnerf_torch.grid.traversal import traverse_grid
    from tnerf_torch.train import init_train_state
    from tnerf_torch.utils.checkpoint import read_train_checkpoint

    s = setup
    jcfg, cfg = s["jcfg"], s["cfg"]
    ckpt = os.path.join(STATES, f"state_{request.param:05d}")
    template = j_init(s["jfield"], s["joptimizer"], 0)
    step, (jstate, jocc) = restore_checkpoint(ckpt, (template, j_init_occ(jcfg.grid)))
    start, params, opt_state, occ, _ = read_train_checkpoint(ckpt, "cpu")
    assert step == start == request.param
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(params)
    state = init_train_state(field, cfg.train)
    state.optimizer.load_state(opt_state)
    out = {"step": step, "bits": occ.bitfield}

    o, d = s["rays"][:2]
    H, S = cfg.grid.effective_max_hits, cfg.sampler.samples_per_interval
    bits = jnp.asarray(jocc.bitfield)
    # 1. the walk, then the samples
    ref_iv = j_traverse(jnp.asarray(o), jnp.asarray(d), jcfg.grid, occupancy=bits, max_hits=H)
    got_iv = traverse_grid(torch.from_numpy(o), torch.from_numpy(d), cfg.grid, occ.bitfield,
                           max_hits=H)
    out["walk"] = (ref_iv, got_iv)
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.train.seed), step)
    u_ref = np.array(jax.random.uniform(key, (N_RAYS, H, S), jnp.float32))
    slots = _slot_map(np.asarray(ref_iv.mask), got_iv.mask.numpy())
    u_got = torch.from_numpy(np.take_along_axis(u_ref, slots[..., None], axis=1))
    ref_s = j_interval_samples(ref_iv.t_starts, ref_iv.t_ends, ref_iv.mask, S,
                               mode="stratified", key=key)
    got_s = sampling.interval_samples(got_iv.t_starts, got_iv.t_ends, got_iv.mask, S,
                                      mode="stratified", u=u_got)
    out["samples"] = (ref_s, got_s)

    # 2, 3. the render, the loss and the gradients from the same samples:
    # the port's renderer walks the reference's intervals and draws its
    # uniforms (stage 1 holds the walks and the placement to each other)
    (jl, jres), jgrads = _reference_step(jcfg, s["rays"], jstate.params, key, bits)
    loss, res, grads = _port_step(cfg, s["rays"], state.params, ref_iv, u_ref, occ.bitfield)
    out["render"] = ((float(jl), jres), (loss, res))
    jg = params_from_jax(jax.tree.map(np.asarray, jgrads))
    out["grads"] = (jg, grads)
    # the same at compute_dtype float32: no bf16 rounding, so what is left
    # is the order of float32 sums
    f32 = ["field_.compute_dtype=float32"]
    (_, _), jgrads32 = _reference_step(jcfg.apply_overrides(f32), s["rays"], jstate.params, key,
                                       bits)
    out["grads_f32"] = (params_from_jax(jax.tree.map(np.asarray, jgrads32)),
                        _port_step(cfg.apply_overrides(f32), s["rays"], state.params, ref_iv,
                                   u_ref, occ.bitfield)[2])

    # 4. one Adam update from the reference's gradient
    updates, jopt = s["joptimizer"].update(jgrads, jstate.opt_state, jstate.params)
    jnew = params_from_jax(jax.tree.map(np.asarray, optax.apply_updates(jstate.params, updates)))
    jmom = jax.tree.map(np.asarray, jopt.inner_state[0])
    state.optimizer.step([jg[k] for k in state.params])
    out["adam"] = ((jnew, params_from_jax(jmom.mu), params_from_jax(jmom.nu), int(jmom.count)),
                   ({k: v.detach() for k, v in state.params.items()},
                    state.optimizer.state["mu"], state.optimizer.state["nu"],
                    int(state.optimizer.state["count"])))
    out["lr"] = (float(optax.exponential_decay(
        cfg.train.lr, cfg.train.steps, cfg.train.lr_final_fraction)(
            int(jstate.opt_state.inner_state[1].count))),
                 float(state.optimizer.learning_rate(
                     torch.tensor(int(opt_state["sched_count"]), dtype=torch.int32))))

    # 5. the refresh, with the reference's probe jitter
    k_occ = jax.random.fold_in(key, 1)
    jocc_new = j_update(jocc, lambda x: s["jfield"].density(jstate.params, x), jcfg.grid, k_occ)
    res_ = cfg.grid.resolution
    jitter = np.array(jax.random.uniform(k_occ, (res_, res_, res_, 3), jnp.float32, -0.5, 0.5))
    occ_new = update_occupancy(occ, lambda x: field.density(x, params), cfg.grid,
                               jitter=torch.from_numpy(jitter))
    out["refresh"] = (jocc_new, occ_new)
    return out


def test_states_are_mid_training(stages):
    """Each state is what its name says: the pruned grid of the config."""
    frac = float(stages["bits"].float().mean())
    assert 0.05 < frac < 0.5, frac


def test_walk_keeps_the_reference_intervals(stages):
    ref, got = stages["walk"]
    rm, gm = np.asarray(ref.mask), got.mask.numpy()
    assert rm.sum() > N_RAYS
    gap = max(np.abs(np.asarray(a)[rm] - c.numpy()[gm]).max()
              for a, c in ((ref.t_starts, got.t_starts), (ref.t_ends, got.t_ends)))
    print(f"state {stages['step']}: walk {int(rm.sum())} intervals, bounds within {gap:.3e}")
    for b in range(N_RAYS):
        np.testing.assert_array_equal(np.asarray(ref.cells[b])[rm[b]], got.cells[b].numpy()[gm[b]])
        for a, c in ((ref.t_starts, got.t_starts), (ref.t_ends, got.t_ends)):
            np.testing.assert_allclose(np.asarray(a[b])[rm[b]], c[b].numpy()[gm[b]],
                                       atol=T_ATOL, rtol=0)


def test_samples_in_the_intervals(stages):
    ref, got = stages["samples"]
    rm, gm = np.asarray(ref.mask), got.mask.numpy()
    assert rm.sum() == gm.sum()
    print(f"state {stages['step']}: {int(rm.sum())} samples, t within "
          f"{np.abs(np.asarray(ref.t)[rm] - got.t.numpy()[gm]).max():.3e}")
    for b in range(N_RAYS):
        for a, c in ((ref.t, got.t), (ref.deltas, got.deltas)):
            np.testing.assert_allclose(np.asarray(a[b])[rm[b]], c[b].numpy()[gm[b]],
                                       atol=T_ATOL, rtol=0)


def test_render_and_loss(stages):
    (jl, jres), (loss, res) = stages["render"]
    assert float(res.acc.detach().max()) > 0.2
    gaps = [np.abs(getattr(res, k).detach().numpy() - np.asarray(getattr(jres, k))).max()
            for k in ("rgb", "acc", "depth")]
    print(f"state {stages['step']}: rgb / acc / depth within {gaps[0]:.3e} / {gaps[1]:.3e} / "
          f"{gaps[2]:.3e}; loss {loss:.6e} against {jl:.6e} ({abs(loss - jl) / jl:.3e})")
    np.testing.assert_allclose(res.rgb.detach().numpy(), np.asarray(jres.rgb), atol=RGB_ATOL,
                               rtol=0)
    np.testing.assert_allclose(res.acc.detach().numpy(), np.asarray(jres.acc), atol=ACC_ATOL,
                               rtol=0)
    np.testing.assert_allclose(res.depth.detach().numpy(), np.asarray(jres.depth),
                               atol=DEPTH_ATOL, rtol=0)
    assert abs(loss - jl) <= LOSS_RTOL * jl, (loss, jl)


@pytest.mark.parametrize("which,bound", [("grads", GRAD_RTOL), ("grads_f32", GRAD_F32_RTOL)],
                         ids=["bf16", "float32"])
def test_gradients(stages, which, bound):
    jg, grads = stages[which]
    assert set(jg) == set(grads)
    rels = {}
    for k, g in grads.items():
        want = jg[k].numpy()
        assert np.abs(want).max() > 0, k
        rels[k] = np.abs(g.numpy() - want).max() / np.abs(want).max()
    worst = max(rels, key=rels.get)
    print(f"state {stages['step']} ({which}): gradients within {rels[worst]:.3e} of their leaf's "
          f"largest entry (worst {worst})")
    for k, rel in rels.items():
        assert rel <= bound, (k, rel)


def test_adam_update(stages):
    (jnew, jmu, jnu, jcount), (new, mu, nu, count) = stages["adam"]
    assert count == jcount == stages["step"] + 1
    lr_ref, lr = stages["lr"]
    assert abs(lr - lr_ref) <= 2e-7 * lr_ref, (lr, lr_ref)
    worst = 0.0
    for want, got in ((jnew, new), (jmu, mu), (jnu, nu)):
        for k, v in got.items():
            w = want[k].numpy()
            rel = np.abs(v.numpy() - w).max() / np.abs(w).max()
            worst = max(worst, rel)
            assert rel <= ADAM_RTOL, (k, rel)
    print(f"state {stages['step']}: lr {lr:.9e} (reference {lr_ref:.9e}); parameters and "
          f"moments within {worst:.3e} of their leaf's largest entry")


def test_refresh(stages, setup):
    jocc, occ = stages["refresh"]
    thr = setup["cfg"].grid.density_threshold
    jema, ema = np.asarray(jocc.density_ema), occ.density_ema.numpy()
    assert np.abs(ema - jema).max() <= EMA_RTOL * jema.max()
    flipped = np.asarray(jocc.bitfield) != occ.bitfield.numpy()
    print(f"state {stages['step']}: refresh EMA within "
          f"{np.abs(ema - jema).max() / jema.max():.3e} of its largest entry, {int(flipped.sum())} "
          f"bits differ, occupancy {float(occ.bitfield.float().mean()):.6f} against "
          f"{float(np.asarray(jocc.bitfield).mean()):.6f}")
    assert flipped.sum() <= BITS_DIFF_MAX
    assert (np.abs(jema[flipped] - thr) <= EDGE_RTOL * thr).all()
    assert int(occ.step) == int(jocc.step)


def _uniform_law(x, lo, hi, discrete=False):
    """Whether draws x have the mean and variance of U[lo, hi) (of the
    integers lo..hi-1 with discrete) within MOMENT_SIGMAS standard errors,
    and no correlation between neighbours along any axis beyond as many."""
    x = np.asarray(x, np.float64)
    n = x.size
    if discrete:
        m = hi - lo
        mean, var, m4 = (lo + hi - 1) / 2, (m * m - 1) / 12, (3 * m * m - 7) * (m * m - 1) / 240
    else:
        w = hi - lo
        mean, var, m4 = (lo + hi) / 2, w * w / 12, w ** 4 / 80
    ok = abs(x.mean() - mean) <= MOMENT_SIGMAS * np.sqrt(var / n)
    ok &= abs(x.var() - var) <= MOMENT_SIGMAS * np.sqrt((m4 - var * var) / n)
    for axis in range(x.ndim):
        if x.shape[axis] > 1:
            y = np.moveaxis(x, axis, -1)
            r = np.corrcoef(y[..., :-1].reshape(-1), y[..., 1:].reshape(-1))[0, 1]
            ok &= abs(r) <= MOMENT_SIGMAS / np.sqrt(y[..., :-1].size)
    return bool(ok)


def _pixel_dataset(package, n, h, w):
    """An ImageDataset of package whose pixel (i, y, x) holds (i / n, y / h,
    x / w): a batch's ground truth says which pixels were drawn."""
    from tnerf_torch.data.procedural import sphere_poses

    i, y, x = np.meshgrid(np.arange(n) / n, np.arange(h) / h, np.arange(w) / w, indexing="ij")
    return package.ImageDataset(images=np.stack([i, y, x], -1).astype(np.float32),
                                poses=sphere_poses(n, radius=3.5, seed=10).astype(np.float32),
                                focal=110.0, width=w, height=h, channels=3)


def test_pixel_draws_have_the_reference_law(setup):
    """train.shuffle="random": both samplers draw the view and the pixel
    independently and uniformly, with replacement, over the same ranges."""
    import tnerf.data.dataset as jds
    import tnerf_torch.data.dataset as ds
    from tnerf.train import PixelSampler as JSampler
    from tnerf_torch.train import PixelSampler

    cfg = setup["cfg"]
    n, h, w, B, batches = 24, 128, 128, cfg.train.batch_size, 8
    sampler = PixelSampler(_pixel_dataset(ds, n, h, w), 1.0, False, "cpu")
    jsampler = JSampler(_pixel_dataset(jds, n, h, w), 1.0, False)
    gen = torch.Generator().manual_seed(cfg.train.seed + 1)
    key = jax.random.PRNGKey(cfg.train.seed)
    got = np.stack([sampler.sample(gen, B).gt_rgb.numpy() for _ in range(batches)])
    want = np.stack([np.asarray(jsampler.sample(k, B).gt_rgb)
                     for k in jax.random.split(key, batches)])
    for draws in (got, want):
        idx = np.rint(draws * np.array([n, h, w])).astype(np.int64)  # [batches, B, 3]
        for c, m in enumerate((n, h, w)):
            assert idx[..., c].min() == 0 and idx[..., c].max() == m - 1
            assert _uniform_law(idx[..., c], 0, m, discrete=True), c
        # with replacement: a batch of 4096 of 393,216 pixels repeats one
        # about 21 times
        flat = (idx[..., 0] * h + idx[..., 1]) * w + idx[..., 2]
        repeats = sum(B - len(np.unique(f)) for f in flat)
        assert 4 * batches <= repeats <= 60 * batches, repeats


def test_interval_jitter_has_the_reference_law(setup):
    """The stratified jitter of a step of this config: one [0, 1) draw per
    (ray, interval slot, sample), the shape the reference draws from its
    key, no axis sharing a draw, and each sample inside its own stratum."""
    from tnerf.sampling import interval_samples as j_interval_samples
    from tnerf_torch import sampling
    from tnerf_torch.cameras import Rays
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.grid.traversal import traverse_grid
    from tnerf_torch.train_loop import build_renderer

    cfg = setup["cfg"]
    o, d, tp, _ = setup["rays"]
    H, S = cfg.grid.effective_max_hits, cfg.sampler.samples_per_interval
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    seen = []
    real = sampling.draw_uniform

    def spy(gen, shape, device):
        u = real(gen, shape, device)
        seen.append(u)
        return u

    sampling.draw_uniform = spy
    try:
        with torch.no_grad():
            build_renderer(cfg, for_eval=False)(
                dict(field.named_parameters()),
                Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tp)),
                torch.ones((16, 16, 16), dtype=torch.bool),
                torch.Generator().manual_seed(cfg.train.seed + 1))
    finally:
        sampling.draw_uniform = real
    assert len(seen) == 1 and tuple(seen[0].shape) == (N_RAYS, H, S)
    u = seen[0].numpy()
    assert u.min() >= 0.0 and u.max() < 1.0 and _uniform_law(u, 0.0, 1.0)
    # the reference's draw for the same walk: its shape, its law, and the
    # same placement of each draw in its stratum
    key = jax.random.PRNGKey(cfg.train.seed)
    iv = traverse_grid(torch.from_numpy(o), torch.from_numpy(d), cfg.grid,
                       torch.ones((16, 16, 16), dtype=torch.bool), max_hits=H)
    ju = np.array(jax.random.uniform(key, (N_RAYS, H, S), jnp.float32))
    assert _uniform_law(ju, 0.0, 1.0)
    jt = np.asarray(j_interval_samples(jnp.asarray(iv.t_starts.numpy()),
                                       jnp.asarray(iv.t_ends.numpy()),
                                       jnp.asarray(iv.mask.numpy()), S, mode="stratified",
                                       key=key).t)
    t = sampling.interval_samples(iv.t_starts, iv.t_ends, iv.mask, S, mode="stratified",
                                  u=torch.from_numpy(ju)).t.numpy()
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-6)
    t = sampling.interval_samples(iv.t_starts, iv.t_ends, iv.mask, S, mode="stratified",
                                  u=seen[0]).t.numpy().reshape(N_RAYS, H, S)
    t0, t1 = iv.t_starts.numpy()[..., None], iv.t_ends.numpy()[..., None]
    lo = t0 + np.arange(S) / S * (t1 - t0)
    hi = t0 + (np.arange(S) + 1) / S * (t1 - t0)
    live = np.broadcast_to(iv.mask.numpy()[..., None], t.shape)
    assert live.sum() > N_RAYS * S
    assert ((t >= lo - 1e-6) & (t <= hi + 1e-6))[live].all()


def test_probe_jitter_has_the_reference_law(setup):
    """The refresh's probes: one point a cell, offset from its centre by a
    draw in [-0.5, 0.5) cells per axis, in both packages."""
    from tnerf.grid.occupancy import init_occupancy as j_init_occ
    from tnerf.grid.occupancy import update_occupancy as j_update
    from tnerf_torch.grid.occupancy import cell_centers, init_occupancy, update_occupancy

    cfg, jcfg = setup["cfg"], setup["jcfg"]
    res = cfg.grid.resolution
    h = (cfg.grid.aabb_max[0] - cfg.grid.aabb_min[0]) / res
    seen = {}

    def probe(tag):
        def density(x):
            seen[tag] = np.asarray(x)
            return x[..., 0] * 0.0
        return density

    gen = torch.Generator().manual_seed(cfg.train.seed + 1)
    update_occupancy(init_occupancy(cfg.grid), probe("port"), cfg.grid, generator=gen)
    j_update(j_init_occ(jcfg.grid), probe("reference"), jcfg.grid, jax.random.PRNGKey(1))
    centers = cell_centers(cfg.grid).numpy()
    for tag, pts in seen.items():
        off = (pts.reshape(res, res, res, 3) - centers) / h
        assert off.min() >= -0.5 - 1e-4 and off.max() < 0.5 + 1e-4, tag
        assert _uniform_law(off, -0.5, 0.5), tag
