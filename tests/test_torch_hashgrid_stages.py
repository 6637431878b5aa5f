"""Every stage of a hash-grid train step under occupancy-CDF placement, the
port against the reference package, on real mid-training states of the
committed config at its full width (runs/hard_r5_hashgrid_diffuse/
config.json: 8192 rays, 24 samples a ray placed by the inverse CDF of 64
bins with floor 0.01, sample compaction at 0.95, 12 hash levels of 2^14
rows x 2 features, SH of degree 1, a 128^3 grid refreshed with its own
per-cell jitter; ROADMAP Queue C 5).

The states are the port's own, trained on an H100 from the reference's
initial state (runs/hard_r5_hashgrid_diffuse_port/README.md): after 257
steps (the first refresh, at step 256, included) and a later one.  Each is
loaded into both packages (the checkpoint layout is the reference's), and
one step is taken stage by stage, every stage fed the reference's output of
the stage before:

1. the pixel batch: the same (view, x, y) draws, from a numpy seed, through
   both samplers' gather: the rays and the ground truth;
2. the span: the box entry and exit from sampler.near, then the tightening
   by 64 probes of the 32^3 pooling;
3. the CDF bin weights: 64 bin midpoints probed on the 128^3 bitfield;
4. the placement: 24 samples a ray by the inverse CDF, with the reference's
   stratum jitter: t, the point-Jacobian deltas and the support mask;
5. sample compaction: the first `capacity` live samples in ray order go to
   the field (a probe field whose outputs are exact in both packages),
   at the config's capacity and at one that drops live samples;
6. the encode (the float32 gather; the bf16 one-hot on a subset), SH and
   the MLPs on the step's live samples, at bf16 and at float32;
7. the whole compacted render and the loss, the port drawing the
   reference's jitter;
8. each leaf's gradient, at bf16 and at float32;
9. one Adam update from the same gradient at the state's step;
10. one occupancy refresh with the reference's per-cell jitter, on fixed
    slabs of cells (REFRESH_SLABS, one x-slab in sixteen), which hold both
    sides of the threshold: the EMA, then the bits.

Beside them the laws of the port's draws that no trajectory fed the
reference's draws can see, against the reference's code: the CDF stratum
jitter at S = 24, the refresh's per-cell jitter at 128^3, and the initial
weights (the tables' uniform +-1e-4, the MLPs' He-normal weights and zero
biases).

Stages 2-10 run the reference eager: under jit XLA:CPU contracts o + t d
into a fused multiply-add, and a position one ulp off is another hash cell
or another bf16 rounding (tests/test_torch_intervals_stages.py).  Stage 1
runs the reference's gather jitted, as its sampler does in training.

Tolerances, stated before the committed states' first run (shaped by runs
on the reference's own states of the same config after 257, 514 and 771
steps from the same initial state): the rays RAY_ATOL (the reference's
jitted arithmetic against the port's eager one); the span's bounds T_ATOL
(the tightening probes at the same float32 points); bins and support equal;
the placement's t within PLACE_T_ATOL (a few ulps of t: the reference
divides (s + u) / S, the port multiplies by RN(1 / S) as the reference's
XLA does under jit, and the bin's pmf divides the difference) and its
deltas within PLACE_RTOL of each ray's span; the compacted samples equal
to the bit and the probe field's composite within COMPOSITE_ATOL (the
order of a ray's sums); the features within FEAT_ATOL (float32
interpolation weights multiplied in one order in both), the one-hot's
within FEAT_ONEHOT_ATOL (both round the table to bf16; the weights' product
order is the only difference), the SH basis within SH_ATOL; the field's
rgb / sigma within FIELD_RTOL of their largest entry at float32 and
FIELD_BF16_RTOL at bf16 (a bf16 rounding of one operand flips in a
handful of samples); the render per ray RGB_ATOL / ACC_ATOL / DEPTH_ATOL
(the bounds of the intervals trace) and the loss LOSS_RTOL; each gradient
at bf16 within GRAD_RTOL of its leaf's largest entry (one bf16 step: both
packages round the products' operands to bf16), at float32 within
GRAD_F32_RTOL (on one of the reference's states the float32 table
gradient's rows of the finest levels, a few small cotangents each, part
by 3e-4 of the largest entry, as far as the reference's own eager and
jitted gradients part there); the Adam update ADAM_RTOL of each leaf's largest entry; the
refresh EMA_RTOL of the EMA's largest entry, at most BITS_DIFF_MAX bits
apart, each where the reference's EMA lies within EDGE_RTOL of the
threshold (one bf16 step of the trunk's raw output moves a density near the
threshold by about 1.4%)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(4)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse", "config.json")
STATES = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse_port")
STATE_STEPS = (257, 2000)
INIT = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse_init", "checkpoints")
N_VIEWS = 2          # train views of the hard scene the batch is drawn from
GT_SAMPLES = 256
REFRESH_SLABS = slice(4, 128, 16)
N_ONEHOT = 2048      # live samples through the bf16 one-hot encode

RAY_ATOL = 1e-6
T_ATOL = 1e-5
PLACE_T_ATOL, PLACE_RTOL = 4e-6, 1e-5
COMPOSITE_ATOL = 1e-5
FEAT_ATOL, FEAT_ONEHOT_ATOL, SH_ATOL = 1e-7, 1e-6, 1e-6
FIELD_RTOL, FIELD_BF16_RTOL = 1e-5, 2.0 ** -7
RGB_ATOL, ACC_ATOL, DEPTH_ATOL = 5e-3, 5e-3, 2e-2
LOSS_RTOL = 1e-4
GRAD_RTOL = 2.0 ** -7
GRAD_F32_RTOL = 1e-3
ADAM_RTOL = 1e-6
EMA_RTOL, EDGE_RTOL, BITS_DIFF_MAX = 1e-2, 5e-2, 64
# the law of a draw: its mean, its variance and the correlation of
# neighbours along each axis within MOMENT_SIGMAS standard errors
MOMENT_SIGMAS = 5.0


class _ProbeField:
    """A field whose outputs are exact float32 arithmetic of the position
    (the same bits in both packages), keeping the positions it is given:
    what sample compaction sends to the field."""

    def __init__(self):
        self.seen = []

    def apply(self, params, x, v):
        self.seen.append(x)
        return jnp.clip(0.5 * x + 0.5, 0.0, 1.0), 4.0 * (x[..., 0] * x[..., 0] + 1.0)

    def torch_fn(self, params, x, v):
        self.seen.append(x.detach().numpy().copy())
        return torch.clamp(0.5 * x + 0.5, 0.0, 1.0), 4.0 * (x[..., 0] * x[..., 0] + 1.0)


@pytest.fixture(scope="module")
def setup():
    import tnerf.data.dataset as jds
    from tnerf.config import Config as JConfig
    from tnerf.train import PixelSampler as JSampler
    from tnerf.train import create_optimizer
    from tnerf.train_loop import build_field
    import tnerf_torch.data.dataset as ds_
    from tnerf_torch.cameras import focal_from_angle
    from tnerf_torch.config import Config
    from tnerf_torch.data.procedural import CAMERA_ANGLE_X, render_gt_image, sphere_poses
    from tnerf_torch.train import PixelSampler

    jcfg, cfg = JConfig.from_json_file(CONFIG), Config.from_json_file(CONFIG)
    # N_VIEWS train views of the hard scene at its 128x128, marched at
    # GT_SAMPLES a ray (the scene's own 772 would cost the file 10 s; the
    # images are both packages' input, not a reference to match)
    poses = sphere_poses(24, radius=3.5, seed=10)[:N_VIEWS]
    focal = focal_from_angle(128, CAMERA_ANGLE_X)
    images = np.stack([render_gt_image(p, 128, 128, focal, cfg.sampler.near, cfg.sampler.far,
                                       GT_SAMPLES, False, field_name="hard",
                                       device="cpu").clamp(0.0, 1.0).numpy() for p in poses])
    ds, jds_ = (pkg.ImageDataset(images=images, poses=poses.astype(np.float32), focal=focal,
                                 width=128, height=128, channels=3) for pkg in (ds_, jds))
    B = cfg.train.batch_size
    rng = np.random.default_rng(18)
    img, x, y = (rng.integers(0, m, B) for m in (N_VIEWS, ds.width, ds.height))
    sampler = PixelSampler(ds, cfg.scene.scene_scale, cfg.scene.white_background, "cpu")
    jsampler = JSampler(jds_, jcfg.scene.scene_scale, jcfg.scene.white_background)
    got = sampler._gather(*(torch.from_numpy(a) for a in (img, x, y)))
    want = jax.jit(lambda i, xx, yy: jsampler._gather(i, xx, yy))(
        *(jnp.asarray(a, jnp.int32) for a in (img, x, y)))
    jfield = build_field(jcfg)
    return dict(jcfg=jcfg, cfg=cfg, jfield=jfield, joptimizer=create_optimizer(jcfg.train),
                batch=(want, got),
                rays=tuple(np.asarray(a) for a in (*want.rays, want.gt_rgb)))


def _reference_step(jcfg, jfield, rays, params, key, bits):
    """((loss, RenderResult), gradients) of the reference's compacted march
    render of the rays, eager."""
    from tnerf.cameras import Rays as JRays
    from tnerf.render.grid_renderer import make_grid_renderer

    o, d, tp, gt = rays
    render = make_grid_renderer(jfield, jcfg.grid, jcfg.sampler, jcfg.render, strategy="march",
                                compact=True)

    def loss(p):
        res = render(p, JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tp)), key, bits)
        return jnp.mean(jnp.square(res.rgb - gt)), res

    return jax.value_and_grad(loss, has_aux=True)(params)


def _port_step(cfg, rays, params, jitter, placed, bits):
    """(loss, RenderResult, gradients) of the port's compacted march render
    of the rays, drawing the reference's stratum jitter and placing the
    reference's samples `placed` (its t, deltas and mask: stage 4 holds the
    placements to each other, here the render is held on the same samples)."""
    from tnerf_torch import sampling
    from tnerf_torch.cameras import Rays
    from tnerf_torch.render import grid_renderer
    from tnerf_torch.render.grid_renderer import make_grid_renderer

    o, d, tp, gt = rays
    real = sampling.draw_uniform, grid_renderer.cdf_ray_samples

    def fed(gen, shape, device):
        assert tuple(shape) == jitter.shape
        return torch.from_numpy(jitter)

    def place(t0, t1, n, weights, floor, jitter, bin_support):
        got = real[1](t0, t1, n, weights, floor=floor, jitter=jitter, bin_support=bin_support)
        np.testing.assert_array_equal(got.mask.numpy(), placed[2])
        return sampling.RaySamples(*(torch.from_numpy(np.array(a)) for a in placed))

    sampling.draw_uniform, grid_renderer.cdf_ray_samples = fed, place
    try:
        res = make_grid_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render, strategy="march",
                                 compact=True)(
            params, Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tp)), bits,
            torch.Generator())
    finally:
        sampling.draw_uniform, grid_renderer.cdf_ray_samples = real
    loss = torch.mean(torch.square(res.rgb - torch.from_numpy(gt)))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return float(loss.detach()), res, grads


def _compaction(o, d, tp, t, deltas, mask, capacity, cfg):
    """Both packages' compacted_shade of the same samples through a probe
    field at `capacity`: ((reference's gathered positions, RenderResult),
    (the port's, RenderResult))."""
    from tnerf.render.grid_renderer import compacted_shade as j_compacted
    from tnerf.sampling import sample_positions as j_positions
    from tnerf_torch.render.grid_renderer import compacted_shade
    from tnerf_torch.sampling import sample_positions

    def reference(pos, tp_, t_, deltas_, mask_):
        jprobe = _ProbeField()
        res = j_compacted(jprobe, None, pos, tp_, t_, deltas_, mask_, capacity, False)
        return jprobe.seen[0], res

    # jitted: the gathers are exact, and the probe's composite is held to
    # COMPOSITE_ATOL, which a fused multiply-add does not reach
    jseen, jres = jax.jit(reference)(
        j_positions(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t)),
        *(jnp.asarray(a) for a in (tp, t, deltas, mask)))
    probe = _ProbeField()
    tt = lambda a: torch.from_numpy(np.asarray(a))
    res = compacted_shade(None, cfg.field_, cfg.grid, sample_positions(tt(o), tt(d), tt(t)),
                          tt(tp), tt(t), tt(deltas), tt(mask), capacity, False,
                          field_fn=probe.torch_fn)
    return (np.asarray(jseen), jres), (probe.seen[0], res)


@pytest.fixture(scope="module", params=STATE_STEPS, ids=[f"step{s}" for s in STATE_STEPS])
def stages(request, setup):
    """Every stage of one step of both packages from one committed state."""
    import optax

    from tnerf.cameras import thetaphi_to_unit as j_unit
    from tnerf.fields.encodings import sh_encoding as j_sh
    from tnerf.fields.hashgrid import apply_hashgrid as j_hash
    from tnerf.grid.occupancy import init_occupancy as j_init_occ
    from tnerf.grid.occupancy import update_occupancy as j_update
    from tnerf.grid.traversal import make_coarse_occupancy as j_coarse
    from tnerf.grid.traversal import ray_aabb as j_aabb
    from tnerf.grid.traversal import tightened_range as j_tighten
    from tnerf.render.grid_renderer import cdf_bin_weights as j_bins
    from tnerf.sampling import cdf_ray_samples as j_place
    from tnerf.sampling import sample_positions as j_positions
    from tnerf.train import init_train_state as j_init
    from tnerf.train_loop import build_field
    from tnerf.utils.checkpoint import restore_checkpoint
    from tnerf_torch.cameras import thetaphi_to_unit
    from tnerf_torch.fields.encodings import sh_encoding
    from tnerf_torch.fields.hashgrid import apply_hashgrid
    from tnerf_torch.fields.nerf_field import NeRFField, apply_field, normalize_positions
    from tnerf_torch.grid.occupancy import update_occupancy
    from tnerf_torch.grid.traversal import make_coarse_occupancy, ray_aabb, tightened_range
    from tnerf_torch.render.grid_renderer import cdf_bin_weights
    from tnerf_torch.sampling import cdf_ray_samples
    from tnerf_torch.train import init_train_state
    from tnerf_torch.utils.checkpoint import read_train_checkpoint

    s = setup
    jcfg, cfg, jfield = s["jcfg"], s["cfg"], s["jfield"]
    ckpt = os.path.join(STATES, f"state_{request.param:05d}")
    template = j_init(jfield, s["joptimizer"], 0)
    step, (jstate, jocc) = restore_checkpoint(ckpt, (template, j_init_occ(jcfg.grid)))
    start, params, opt_state, occ, _ = read_train_checkpoint(ckpt, "cpu")
    assert step == start == request.param
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(params)
    state = init_train_state(field, cfg.train)
    state.optimizer.load_state(opt_state)
    out = {"step": step, "bits": occ.bitfield}
    tt = lambda a: torch.from_numpy(np.array(a))
    o, d, tp, gt = s["rays"]
    B, S, res = o.shape[0], cfg.sampler.samples_per_ray, cfg.grid.resolution
    sp, grid = jcfg.sampler, jcfg.grid
    bits = jnp.asarray(jocc.bitfield)

    # 2. the span, then its tightening on the 32^3 pooling
    te, tx = j_aabb(jnp.asarray(o), jnp.asarray(d), grid.aabb_min, grid.aabb_max)
    te = jnp.maximum(te, sp.near)
    tx = jnp.maximum(tx, te)
    f = res // sp.tighten_res
    te2, tx2 = j_tighten(jnp.asarray(o), jnp.asarray(d), te, tx, j_coarse(bits, f), grid,
                         probes=sp.tighten_probes)
    gte, gtx = ray_aabb(tt(o), tt(d), cfg.grid.aabb_min, cfg.grid.aabb_max)
    gte = torch.clamp_min(gte, float(cfg.sampler.near))
    gtx = torch.maximum(gtx, gte)
    gte2, gtx2 = tightened_range(tt(o), tt(d), tt(te), tt(tx),
                                 make_coarse_occupancy(occ.bitfield, f), cfg.grid,
                                 probes=cfg.sampler.tighten_probes)
    out["span"] = ((te, tx, te2, tx2), (gte, gtx, gte2, gtx2))

    # 3. the bin weights on the 128^3 bitfield
    jw, jsupport = j_bins(jnp.asarray(o), jnp.asarray(d), te2, tx2, bits, None, grid, sp)
    w, support = cdf_bin_weights(tt(o), tt(d), tt(te2), tt(tx2), occ.bitfield, None, cfg.grid,
                                 cfg.sampler)
    out["bins"] = ((jw, jsupport), (w, support))

    # 4. the placement with the reference's stratum jitter (its train step's
    # draw: uniform(key, [B, S]) of the render key)
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.train.seed), step)
    jitter = np.array(jax.random.uniform(key, (B, S), jnp.float32))
    jplace = j_place(te2, tx2, S, jw, floor=sp.cdf_floor, jitter=jnp.asarray(jitter),
                     bin_support=jsupport)
    place = cdf_ray_samples(tt(te2), tt(tx2), S, tt(jw), floor=cfg.sampler.cdf_floor,
                            jitter=tt(jitter), bin_support=tt(jsupport))
    out["place"] = ((jplace, np.asarray(tx2 - te2)), place)

    # 5. compaction at the config's capacity and at one that drops live samples
    live = int(np.asarray(jplace.mask).sum())
    caps = (int(B * S * cfg.render.compact_fraction), live - B)
    out["compaction"] = [(cap, live, _compaction(o, d, tp, jplace.t, jplace.deltas, jplace.mask,
                                                 cap, cfg)) for cap in caps]

    # 6. the encode, SH and the MLPs on the step's live samples
    m = np.asarray(jplace.mask)
    pos = np.asarray(j_positions(jnp.asarray(o), jnp.asarray(d), jplace.t))[m]
    view = np.repeat(tp[:, None, :], S, axis=1)[m]
    x01 = 0.5 * (normalize_positions(tt(pos), cfg.grid) + 1.0)
    onehot = cfg.apply_overrides(["field_.hash_gather_mode=onehot"]).field_
    jonehot = jcfg.apply_overrides(["field_.hash_gather_mode=onehot"]).field_
    # (jitted: the inputs are the positions themselves, no o + t d)
    out["encode"] = (
        (np.asarray(jax.jit(lambda p, x: j_hash(p, x, jcfg.field_))(
            jstate.params["hashgrid"], jnp.asarray(x01.numpy()))),
         apply_hashgrid(params["hashgrid.tables"], x01, cfg.field_)),
        (np.asarray(jax.jit(lambda p, x: j_hash(p, x, jonehot))(
            jstate.params["hashgrid"], jnp.asarray(x01[:N_ONEHOT].numpy()))),
         apply_hashgrid(params["hashgrid.tables"], x01[:N_ONEHOT], onehot)),
        (np.asarray(jax.jit(lambda v: j_sh(j_unit(v), jcfg.field_.sh_degree))(
            jnp.asarray(view))),
         sh_encoding(thetaphi_to_unit(tt(view)), cfg.field_.sh_degree)))
    out["field"] = {}
    for dtype in ("bfloat16", "float32"):
        ov = [f"field_.compute_dtype={dtype}"]
        jf = build_field(jcfg.apply_overrides(ov))
        with torch.no_grad():
            got = apply_field(params, cfg.apply_overrides(ov).field_, cfg.grid, tt(pos), tt(view))
        out["field"][dtype] = (jax.jit(jf.apply)(jstate.params, jnp.asarray(pos),
                                                 jnp.asarray(view)), got)

    # 7, 8. the render, the loss and the gradients
    (jl, jres), jgrads = _reference_step(jcfg, jfield, s["rays"], jstate.params, key, bits)
    placed = tuple(np.asarray(a) for a in (jplace.t, jplace.deltas, jplace.mask))
    loss, res_, grads = _port_step(cfg, s["rays"], state.params, jitter, placed, occ.bitfield)
    out["render"] = ((float(jl), jres), (loss, res_))
    jg = params_from_jax(jax.tree.map(np.asarray, jgrads))
    out["grads"] = (jg, grads)
    f32 = ["field_.compute_dtype=float32"]
    jcfg32 = jcfg.apply_overrides(f32)
    (_, _), jgrads32 = _reference_step(jcfg32, build_field(jcfg32), s["rays"], jstate.params,
                                       key, bits)
    out["grads_f32"] = (params_from_jax(jax.tree.map(np.asarray, jgrads32)),
                        _port_step(cfg.apply_overrides(f32), s["rays"], state.params, jitter,
                                   placed, occ.bitfield)[2])

    # 9. one Adam update from the reference's gradient
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

    # 10. the refresh with the reference's per-cell jitter, on REFRESH_SLABS
    cells = np.zeros((res, res, res), bool)
    cells[REFRESH_SLABS] = True
    idx = np.flatnonzero(cells)
    k_occ = jax.random.fold_in(key, 1)

    def j_density(x):
        return jnp.zeros(x.shape[0], jnp.float32).at[idx].set(
            jfield.density(jstate.params, x[idx]))

    def density(x):
        sigma = torch.zeros(x.shape[0], dtype=torch.float32)
        sigma[idx] = field.density(x[idx], params)
        return sigma

    jocc_new = j_update(jocc, j_density, jcfg.grid, k_occ)
    jit_occ = np.array(jax.random.uniform(k_occ, (res, res, res, 3), jnp.float32, -0.5, 0.5))
    occ_new = update_occupancy(occ, density, cfg.grid, jitter=torch.from_numpy(jit_occ))
    out["refresh"] = (jocc_new, occ_new, cells)
    return out


def test_initial_state_loads_in_both_packages(setup):
    """The committed step-0 state of seed 1337 is the reference's own
    initial state, and both packages read it."""
    from tnerf.grid.occupancy import init_occupancy as j_init_occ
    from tnerf.train import init_train_state as j_init
    from tnerf.utils.checkpoint import restore_checkpoint
    from tnerf_torch.utils.checkpoint import read_train_checkpoint

    s = setup
    template = j_init(s["jfield"], s["joptimizer"], 0)
    step, (jstate, jocc) = restore_checkpoint(INIT, (template, j_init_occ(s["jcfg"].grid)))
    start, params, _, occ, _ = read_train_checkpoint(INIT, "cpu")
    assert step == start == 0
    fresh = params_from_jax(jax.tree.map(np.asarray, s["jfield"].init(
        jax.random.PRNGKey(s["cfg"].train.seed))))
    mine = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    assert set(fresh) == set(params) == set(mine)
    for k in params:  # XLA compiles the draws' arithmetic otherwise here: ulps apart
        np.testing.assert_array_equal(params[k].numpy(), mine[k].numpy(), err_msg=k)
        np.testing.assert_allclose(params[k].numpy(), fresh[k].numpy(), rtol=0,
                                   atol=1e-6 * np.abs(fresh[k].numpy()).max(), err_msg=k)
    assert bool(occ.bitfield.all()) and bool(np.asarray(jocc.bitfield).all())


def test_states_are_mid_training(stages):
    """Each state is what its name says: the pruned grid of the config."""
    frac = float(stages["bits"].float().mean())
    assert 0.02 < frac < 0.6, frac


def test_pixel_batch_and_rays(setup):
    want, got = setup["batch"]
    gaps = [np.abs(np.asarray(a) - b.numpy()).max() for a, b in zip(want.rays, got.rays)]
    print(f"rays: origins / directions / (theta, phi) within {gaps}")
    np.testing.assert_array_equal(got.gt_rgb.numpy(), np.asarray(want.gt_rgb))
    for a, b in zip(want.rays, got.rays):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=RAY_ATOL, rtol=0)


def test_span_and_its_tightening(stages):
    (te, tx, te2, tx2), got = stages["span"]
    gaps = [np.abs(np.asarray(a) - b.numpy()).max() for a, b in zip((te, tx, te2, tx2), got)]
    tight = float(np.mean(np.asarray(tx2 - te2) < np.asarray(tx - te)))
    print(f"state {stages['step']}: span / tightened span within {gaps}; {tight:.3f} of the rays "
          f"tightened")
    assert tight > 0.1
    for a, b in zip((te, tx, te2, tx2), got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=T_ATOL, rtol=0)


def test_cdf_bin_weights(stages):
    (jw, jsupport), (w, support) = stages["bins"]
    print(f"state {stages['step']}: {int(np.asarray(jsupport).sum())} of {jw.size} bins "
          f"supported, {int((np.asarray(jsupport) != support.numpy()).sum())} apart")
    np.testing.assert_array_equal(support.numpy(), np.asarray(jsupport))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


def test_placement(stages):
    (jplace, span), place = stages["place"]
    scale = np.maximum(span, 1e-6)[:, None]
    np.testing.assert_array_equal(place.mask.numpy(), np.asarray(jplace.mask))
    m = np.asarray(jplace.mask)
    gap_t = np.abs(place.t.numpy() - np.asarray(jplace.t))[m].max()
    gap_d = (np.abs(place.deltas.numpy() - np.asarray(jplace.deltas)) / scale)[m].max()
    print(f"state {stages['step']}: {int(m.sum())} live samples; their t within {gap_t:.3e}, "
          f"deltas within {gap_d:.3e} of the span")
    assert gap_t <= PLACE_T_ATOL and gap_d <= PLACE_RTOL
    # an empty bin's sample has a delta (1 + floor) / floor times its ray's
    # live samples', and the mask drops it
    deltas = np.asarray(jplace.deltas)
    live_max = np.where(m, deltas, -np.inf).max(axis=1)
    empty_min = np.where(~m & (span[:, None] > 0), deltas, np.inf).min(axis=1)
    assert (empty_min > 50.0 * live_max).all()


@pytest.mark.parametrize("which", [0, 1], ids=["config_capacity", "dropping"])
def test_compaction(stages, which):
    """The same live samples, in the same slots, go to the field; at a
    capacity under the live count the same ones are dropped."""
    cap, live, ((jseen, jres), (seen, res)) = stages["compaction"][which]
    n = min(cap, live)
    assert jseen.shape == seen.shape == (cap, 3)
    np.testing.assert_array_equal(seen[:n], jseen[:n])
    gaps = [np.abs(getattr(res, k).numpy() - np.asarray(getattr(jres, k))).max()
            for k in ("rgb", "acc", "depth")]
    print(f"state {stages['step']}: capacity {cap}, {live} live samples, {max(live - cap, 0)} "
          f"dropped; probe composite within {gaps}")
    if which == 1:
        assert live > cap
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(getattr(res, k).numpy(), np.asarray(getattr(jres, k)),
                                   atol=COMPOSITE_ATOL, rtol=0)


def test_encode_and_sh(stages):
    (jf, f), (jf1, f1), (jsh, sh) = stages["encode"]
    gaps = [np.abs(b.numpy() - a).max() for a, b in ((jf, f), (jf1, f1), (jsh, sh))]
    print(f"state {stages['step']}: {len(jf)} live samples; features within {gaps[0]:.3e} "
          f"(largest {np.abs(jf).max():.3e}), one-hot {gaps[1]:.3e}, SH {gaps[2]:.3e}")
    assert gaps[0] <= FEAT_ATOL and gaps[1] <= FEAT_ONEHOT_ATOL and gaps[2] <= SH_ATOL


@pytest.mark.parametrize("dtype,bound", [("bfloat16", FIELD_BF16_RTOL), ("float32", FIELD_RTOL)])
def test_field(stages, dtype, bound):
    (jrgb, jsigma), (rgb, sigma) = stages["field"][dtype]
    rels = [np.abs(b.numpy() - np.asarray(a)).max() / np.abs(np.asarray(a)).max()
            for a, b in ((jrgb, rgb), (jsigma, sigma))]
    print(f"state {stages['step']} ({dtype}): rgb / sigma within {rels[0]:.3e} / {rels[1]:.3e} "
          f"of their largest entry")
    assert max(rels) <= bound


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
    jocc, occ, cells = stages["refresh"]
    thr = setup["cfg"].grid.density_threshold
    jema, ema = np.asarray(jocc.density_ema), occ.density_ema.numpy()
    jbits = np.asarray(jocc.bitfield)
    near = np.abs(jema[cells] - thr) <= EDGE_RTOL * thr
    # the slabs hold both sides of the threshold and cells at its edge
    assert jbits[cells].any() and not jbits[cells].all() and near.sum() > 0
    assert np.abs(ema - jema).max() <= EMA_RTOL * jema.max()
    flipped = jbits != occ.bitfield.numpy()
    print(f"state {stages['step']}: refresh of {int(cells.sum())} cells, EMA within "
          f"{np.abs(ema - jema).max() / jema.max():.3e} of its largest entry, {int(flipped.sum())} "
          f"bits differ ({int(near.sum())} cells within {EDGE_RTOL} of the threshold), occupancy "
          f"{float(occ.bitfield.float().mean()):.6f} against {float(jbits.mean()):.6f}")
    assert flipped.sum() <= BITS_DIFF_MAX
    assert (np.abs(jema[flipped] - thr) <= EDGE_RTOL * thr).all()
    assert int(occ.step) == int(jocc.step)


def _uniform_law(x, lo, hi):
    """Whether draws x have the mean and variance of U[lo, hi) within
    MOMENT_SIGMAS standard errors, and no correlation between neighbours
    along any axis beyond as many."""
    x = np.asarray(x, np.float64)
    n, w = x.size, hi - lo
    mean, var, m4 = (lo + hi) / 2, w * w / 12, w ** 4 / 80
    ok = abs(x.mean() - mean) <= MOMENT_SIGMAS * np.sqrt(var / n)
    ok &= abs(x.var() - var) <= MOMENT_SIGMAS * np.sqrt((m4 - var * var) / n)
    return bool(ok) and _uncorrelated(x)


def _uncorrelated(x):
    for axis in range(x.ndim):
        if x.shape[axis] > 1:
            y = np.moveaxis(x, axis, -1)
            r = np.corrcoef(y[..., :-1].reshape(-1), y[..., 1:].reshape(-1))[0, 1]
            if abs(r) > MOMENT_SIGMAS / np.sqrt(y[..., :-1].size):
                return False
    return True


def _normal_law(x, std):
    """Whether draws x have the mean, variance and fourth moment of N(0,
    std^2) within MOMENT_SIGMAS standard errors, neighbours uncorrelated."""
    x = np.asarray(x, np.float64) / std
    n = x.size
    ok = abs(x.mean()) <= MOMENT_SIGMAS / np.sqrt(n)
    ok &= abs((x * x).mean() - 1.0) <= MOMENT_SIGMAS * np.sqrt(2.0 / n)
    ok &= abs((x ** 4).mean() - 3.0) <= MOMENT_SIGMAS * np.sqrt(96.0 / n)
    return bool(ok) and _uncorrelated(x)


def test_stratum_jitter_has_the_reference_law(setup):
    """The CDF placement's jitter in a train step of this config: one [0,
    1) draw per (ray, sample), the shape the reference draws from its key,
    no axis sharing a draw, and each sample inside its own stratum of the
    warped coordinate."""
    from tnerf_torch import sampling
    from tnerf_torch.cameras import Rays
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.render.grid_renderer import make_grid_renderer

    cfg = setup["cfg"]
    o, d, tp, _ = (a[:2048] for a in setup["rays"])
    S, res = cfg.sampler.samples_per_ray, cfg.grid.resolution
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
            make_grid_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render, strategy="march",
                               compact=True)(
                field.params(), Rays(torch.from_numpy(o), torch.from_numpy(d),
                                     torch.from_numpy(tp)),
                torch.ones((res,) * 3, dtype=torch.bool),
                torch.Generator().manual_seed(cfg.train.seed + 1))
    finally:
        sampling.draw_uniform = real
    assert len(seen) == 1 and tuple(seen[0].shape) == (len(o), S)
    u = seen[0].numpy()
    assert u.min() >= 0.0 and u.max() < 1.0 and _uniform_law(u, 0.0, 1.0)
    ju = np.array(jax.random.uniform(jax.random.PRNGKey(cfg.train.seed), (len(o), S),
                                     jnp.float32))
    assert _uniform_law(ju, 0.0, 1.0)
    for draw in (u, ju):
        warped = (np.arange(S, dtype=np.float32) + draw) * np.float32(1.0 / S)
        assert (warped >= np.arange(S) / S).all() and (warped < (np.arange(S) + 1) / S).all()


def test_refresh_jitter_has_the_reference_law(setup):
    """The refresh's probes at 128^3: one point a cell, offset from its
    centre by a draw in [-0.5, 0.5) cells per axis, in both packages."""
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


def test_initial_weights_have_the_reference_law(setup):
    """The port's initial weights at the config's seed and the reference's:
    the tables uniform in [-1e-4, 1e-4), each MLP weight He-normal (std
    sqrt(2 / fan-in)), every bias zero; the same leaves and shapes."""
    from tnerf_torch.fields.nerf_field import NeRFField

    cfg = setup["cfg"]
    mine = {k: v.detach().numpy() for k, v in NeRFField(
        cfg.field_, cfg.grid, torch.Generator().manual_seed(cfg.train.seed)).params().items()}
    ref = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(
        np.asarray, setup["jfield"].init(jax.random.PRNGKey(cfg.train.seed)))).items()}
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in ref.items()}
    for tag, leaves in (("port", mine), ("reference", ref)):
        for k, v in leaves.items():
            if k == "hashgrid.tables":
                assert v.min() >= -1e-4 and v.max() < 1e-4, (tag, k)
                assert _uniform_law(v, -1e-4, 1e-4), (tag, k)
            elif ".b." in k:
                assert not v.any(), (tag, k)
            else:
                assert _normal_law(v, np.sqrt(2.0 / v.shape[0])), (tag, k)
