"""Every stage of a progressive-triplane train step, the port against the
reference package, on real mid-training states of the committed config at
its full width (runs/hard_r3_triplane_prog/config.json: 8192 rays, 48
stratified samples a ray on the span tightened by 64 probes of the 32^3
pooling, each sample masked by the 128^3 bitfield, sample compaction at
0.25, a triplane of 3 planes of R^2 x 16 features and 3 lines of R x 16
grown from R = 32 through 51 and 81 to 128 at steps 625, 1250 and 1875,
the (theta, phi) frequency view encoding of 4 frequencies, heads of 2 x
64 in bf16, the tables' rate 10x; ROADMAP Queue C 9).

The states are the port's own, trained on an H100 from the reference's
initial state (runs/hard_r3_triplane_prog_port/README.md): after 257 steps
(R = 32, the first refresh, at step 256, included) and after 1885 (R =
128, ten Adam steps into the last stage).  Each is loaded into both
packages under its stage's config (as `_run_progressive` builds it: that
resolution, the stage's steps and schedule), and one step is taken stage
by stage, every stage fed the reference's output of the stage before:

1. the pixel batch: the same (view, x, y) draws, from a numpy seed, through
   both samplers' gather: the rays and the ground truth;
2. the span: the box entry and exit from sampler.near, then the tightening
   by 64 probes of the 32^3 pooling;
3. the stratified placement with the reference's jitter: t and the
   deltas, and the 128^3 bitfield's mask (the lookup on the reference's
   positions, and the mask of the port's own samples);
4. sample compaction: the first `capacity` live samples in ray order go to
   the field (a probe field whose outputs are exact in both packages), at
   the config's capacity and at one that drops live samples;
5. the plane and line encode on the step's live samples, the float32
   gather, and the bf16 one-hot on a subset;
6. the view encoding and the heads, at bf16 and at float32;
7. the whole compacted render and the loss, the port drawing the
   reference's jitter and placing the reference's samples;
8. each leaf's gradient, at bf16 and at float32;
9. one Adam update from the same gradient at the state's count: the 10x
   table rate and the stage's schedule;
10. one occupancy refresh with the reference's per-cell jitter, on fixed
    slabs of cells (REFRESH_SLABS): the EMA, then the bits;
11. the stage rewrite: both packages' `_upsample_checkpoint` on the same
    state (the 257-step one, as stage 1's last), with and without a weight
    EMA shadow: the planes and lines (and the shadow's) resampled to R =
    51, a fresh Adam state, the step, the occupancy and the MLPs carried
    over, the next stage's schedule from its first rate; each package then
    resumes the rewritten checkpoint as stage 2.

Beside them: the committed step-0 state is the reference's own initial
state of seed 1337 and both packages resume it as stage 1 of 4; the laws
of the port's draws that no trajectory fed the reference's draws can see,
against the reference's: the stratified jitter and the initial weights
(planes and lines 0.1 N(0, 1), `tnerf/fields/triplane.py:54-63`; the
heads He-normal, biases zero).

Stages 2-11 run the reference eager, as the hash grid's file does
(tests/test_torch_hashgrid_stages.py): under jit XLA:CPU contracts o + t d
into a fused multiply-add.  The field (stage 6) runs it jitted: its inputs
are the positions themselves.  Stage 1 runs the reference's gather jitted,
as its sampler does in training.

Tolerances, stated before the committed states' first run (shaped by runs
on the reference's own states of the same config from the same initial
state: its stage-2 checkpoint after 625 steps, R = 51, and the step-0
state): the rays RAY_ATOL (the reference's jitted arithmetic against the
port's eager one); the span's bounds T_ATOL (the tightening probes at the
same float32 points); the placement's t within PLACE_T_ATOL (a few ulps:
the reference divides the span by S eagerly, the port multiplies by RN(1 /
S) as the reference's XLA does under jit) and its deltas within PLACE_RTOL
of each ray's span; the bitfield's lookup on the same positions equal, the
port's own mask at most MASK_DIFF_MAX samples apart (each an ulp of t
across a cell's face); the compacted samples equal to the bit and the
probe field's composite within COMPOSITE_ATOL; the features within
FEAT_ATOL of their largest entry (the same products in the same order),
the one-hot's within FEAT_ONEHOT_ATOL (both round the tables to bf16), the
view encoding within VIEW_ATOL; the field's rgb / sigma within FIELD_RTOL
of their largest entry at float32 and FIELD_BF16_RTOL at bf16; the render
per ray RGB_ATOL / ACC_ATOL / DEPTH_ATOL and the loss LOSS_RTOL; each
gradient at bf16 within GRAD_RTOL of its leaf's largest entry (one bf16
step), at float32 within GRAD_F32_RTOL; the Adam update ADAM_RTOL of each
leaf's largest entry, the rate within 2e-7 of the reference's; the
refresh EMA_RTOL of the EMA's largest entry, at most BITS_DIFF_MAX bits
apart, each where the reference's EMA lies within EDGE_RTOL of the
threshold; the rewrite's resampled planes and lines within UPSAMPLE_RTOL
of their largest entry (the vertex positions are `jnp.linspace`'s, which
the port transcribes), every other leaf equal to the bit."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf_torch.utils.checkpoint import params_from_jax

# the probe field, both packages' compaction of the same samples and the
# moment tests of a draw's law
from test_torch_hashgrid_stages import _compaction, _normal_law, _uniform_law
from test_torch_progressive_keep_best import recorded_stages

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "runs", "hard_r3_triplane_prog", "config.json")
STATES = os.path.join(REPO, "runs", "hard_r3_triplane_prog_port")
STATE_STEPS = (257, 1885)
INIT = os.path.join(REPO, "runs", "hard_r3_triplane_prog_init", "checkpoints")
N_VIEWS = 2          # train views of the hard scene the batch is drawn from
GT_SAMPLES = 256
REFRESH_SLABS = slice(4, 128, 16)
N_ONEHOT = 2048      # live samples through the bf16 one-hot encode
EMA_DECAY = 0.5      # the shadow the rewrite is given in its EMA case

RAY_ATOL = 1e-6
T_ATOL = 1e-5
PLACE_T_ATOL, PLACE_RTOL = 4e-6, 1e-5
MASK_DIFF_MAX = 16
COMPOSITE_ATOL = 1e-5
FEAT_ATOL, FEAT_ONEHOT_ATOL, VIEW_ATOL = 1e-6, 1e-5, 1e-6
FIELD_RTOL, FIELD_BF16_RTOL = 1e-5, 2.0 ** -7
RGB_ATOL, ACC_ATOL, DEPTH_ATOL = 5e-3, 5e-3, 2e-2
LOSS_RTOL = 1e-4
GRAD_RTOL = 2.0 ** -7
GRAD_F32_RTOL = 1e-3
ADAM_RTOL = 1e-6
EMA_RTOL, EDGE_RTOL, BITS_DIFF_MAX = 1e-2, 5e-2, 64
UPSAMPLE_RTOL = 1e-6


def _stage_overrides(plan, k):
    """The config `_run_progressive` gives stage k (`tnerf/train_loop.py:340`):
    its resolution, no milestones, the stage's steps and schedule."""
    end, res = plan[k]
    prev = plan[k - 1][0] if k else 0
    return [f"field_.tri_resolution={res}", "field_.tri_upsample_steps=[]",
            "field_.tri_init_resolution=0", f"train.steps={end}",
            f"train.schedule_total_steps={end - prev}"]


def _find(tree, name):
    """The first node of an optax state whose type is called `name`."""
    if type(tree).__name__ == name:
        return tree
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            got = _find(sub, name)
            if got is not None:
                return got
    return None


@pytest.fixture(scope="module")
def setup():
    import tnerf.data.dataset as jds
    from tnerf.config import Config as JConfig
    from tnerf.train import PixelSampler as JSampler
    from tnerf.train_loop import _tri_stage_plan
    import tnerf_torch.data.dataset as ds_
    from tnerf_torch.cameras import focal_from_angle
    from tnerf_torch.config import Config
    from tnerf_torch.data.procedural import CAMERA_ANGLE_X, render_gt_image, sphere_poses
    from tnerf_torch.train import PixelSampler

    jcfg, cfg = JConfig.from_json_file(CONFIG), Config.from_json_file(CONFIG)
    # N_VIEWS train views of the hard scene at its 128x128, marched at
    # GT_SAMPLES a ray (the images are both packages' input, not a
    # reference to match)
    poses = sphere_poses(24, radius=3.5, seed=10)[:N_VIEWS]
    focal = focal_from_angle(128, CAMERA_ANGLE_X)
    images = np.stack([render_gt_image(p, 128, 128, focal, cfg.sampler.near, cfg.sampler.far,
                                       GT_SAMPLES, False, field_name="hard",
                                       device="cpu").clamp(0.0, 1.0).numpy() for p in poses])
    ds, jds_ = (pkg.ImageDataset(images=images, poses=poses.astype(np.float32), focal=focal,
                                 width=128, height=128, channels=3) for pkg in (ds_, jds))
    B = cfg.train.batch_size
    rng = np.random.default_rng(19)
    img, x, y = (rng.integers(0, m, B) for m in (N_VIEWS, ds.width, ds.height))
    sampler = PixelSampler(ds, cfg.scene.scene_scale, cfg.scene.white_background, "cpu")
    jsampler = JSampler(jds_, jcfg.scene.scene_scale, jcfg.scene.white_background)
    got = sampler._gather(*(torch.from_numpy(a) for a in (img, x, y)))
    want = jax.jit(lambda i, xx, yy: jsampler._gather(i, xx, yy))(
        *(jnp.asarray(a, jnp.int32) for a in (img, x, y)))
    plan = _tri_stage_plan(jcfg)
    return dict(jcfg=jcfg, cfg=cfg, plan=plan, batch=(want, got),
                rays=tuple(np.asarray(a) for a in (*want.rays, want.gt_rgb)))


def _stage_cfgs(setup, k, extra=()):
    ov = _stage_overrides(setup["plan"], k) + list(extra)
    return setup["jcfg"].apply_overrides(ov), setup["cfg"].apply_overrides(ov)


def _stage_of(setup, ckpt):
    """The stage whose resolution the checkpoint's lines hold."""
    with open(os.path.join(ckpt, "treedef.json")) as fh:
        step = json.load(fh)["last_step"]
    with np.load(os.path.join(ckpt, f"step_{step:08d}.npz")) as z:
        r = [z[f"leaf_{i}"].shape for i in range(len(z.files))]
    ress = [res for _, res in setup["plan"]]
    return next(ress.index(s[1]) for s in r if len(s) == 3 and s[0] == 3 and s[1] in ress)


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
    of the rays, drawing the reference's stratified jitter and placing the
    reference's samples `placed` (its t, deltas and mask: stage 3 holds the
    placements to each other, here the render is held on the same
    samples)."""
    from tnerf_torch import sampling
    from tnerf_torch.cameras import Rays
    from tnerf_torch.render import grid_renderer
    from tnerf_torch.render.grid_renderer import make_grid_renderer

    o, d, tp, gt = rays
    real = sampling.draw_uniform, grid_renderer.march_samples_t, grid_renderer.occupancy_lookup
    drawn = []

    def fed(gen, shape, device):
        assert tuple(shape) == jitter.shape
        drawn.append(shape)
        return torch.from_numpy(jitter)

    def place(t0, t1, n, jitter=None):
        t, _ = real[1](t0, t1, n, jitter=jitter)
        assert np.abs(t.numpy() - placed[0]).max() <= PLACE_T_ATOL
        return torch.from_numpy(placed[0]), torch.from_numpy(placed[1])

    def lookup(pts, occ, grid):
        assert tuple(pts.shape[:2]) == placed[2].shape
        return torch.from_numpy(placed[2])

    sampling.draw_uniform, grid_renderer.march_samples_t, grid_renderer.occupancy_lookup = (
        fed, place, lookup)
    try:
        res = make_grid_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render, strategy="march",
                                 compact=True)(
            params, Rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tp)), bits,
            torch.Generator())
    finally:
        sampling.draw_uniform, grid_renderer.march_samples_t, grid_renderer.occupancy_lookup = real
    assert len(drawn) == 1
    loss = torch.mean(torch.square(res.rgb - torch.from_numpy(gt)))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return float(loss.detach()), res, grads


def _load_both(setup, ckpt, k, extra=()):
    """The checkpoint in both packages under stage k's config: (jcfg,
    cfg, reference field, reference optimizer, reference state, reference
    occupancy, port field, port train state, port checkpoint)."""
    from tnerf.grid.occupancy import init_occupancy as j_init_occ
    from tnerf.train import create_optimizer
    from tnerf.train import init_train_state as j_init
    from tnerf.train_loop import build_field
    from tnerf.utils.checkpoint import restore_checkpoint
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.train import init_train_state
    from tnerf_torch.utils.checkpoint import read_train_checkpoint

    jcfg, cfg = _stage_cfgs(setup, k, extra)
    jfield, jopt = build_field(jcfg), create_optimizer(jcfg.train)
    template = j_init(jfield, jopt, 0, param_ema=jcfg.train.param_ema > 0)
    step, (jstate, jocc) = restore_checkpoint(ckpt, (template, j_init_occ(jcfg.grid)))
    ck = read_train_checkpoint(ckpt, "cpu")
    assert step == ck.step
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(ck.params)
    state = init_train_state(field, cfg.train)
    state.optimizer.load_state(ck.opt_state)
    return jcfg, cfg, jfield, jopt, jstate, jocc, field, state, ck


@pytest.fixture(scope="module", params=STATE_STEPS, ids=[f"step{s}" for s in STATE_STEPS])
def stages(request, setup):
    """Every stage of one step of both packages from one committed state."""
    import optax

    from tnerf.fields.triplane import apply_triplane as j_tri
    from tnerf.grid.occupancy import update_occupancy as j_update
    from tnerf.grid.traversal import make_coarse_occupancy as j_coarse
    from tnerf.grid.traversal import march_samples_t as j_march
    from tnerf.grid.traversal import occupancy_lookup_fast as j_lookup
    from tnerf.grid.traversal import ray_aabb as j_aabb
    from tnerf.grid.traversal import tightened_range as j_tighten
    from tnerf.sampling import sample_positions as j_positions
    from tnerf.train_loop import build_field
    from tnerf_torch.fields.nerf_field import apply_field, encode_view, normalize_positions
    from tnerf_torch.fields.triplane import apply_triplane
    from tnerf_torch.grid.occupancy import update_occupancy
    from tnerf_torch.grid.traversal import (make_coarse_occupancy, march_samples_t,
                                            occupancy_lookup, ray_aabb, tightened_range)
    from tnerf_torch.sampling import sample_positions

    s = setup
    ckpt = os.path.join(STATES, f"state_{request.param:05d}")
    k = _stage_of(s, ckpt)
    jcfg, cfg, jfield, jopt, jstate, jocc, field, state, ck = _load_both(s, ckpt, k)
    step, params, occ = ck.step, ck.params, ck.occupancy
    assert step == request.param
    out = {"step": step, "stage": k, "bits": occ.bitfield, "count": int(ck.opt_state["count"]),
           "R": cfg.field_.tri_resolution}
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

    # 3. the stratified placement with the reference's jitter (its train
    # step's draw: uniform(key, [B, S]) of the render key), then the 128^3
    # bitfield's mask
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.train.seed), step)
    jitter = np.array(jax.random.uniform(key, (B, S), jnp.float32))
    jt, jdeltas = j_march(te2, tx2, S, jitter=jnp.asarray(jitter))
    jpos = j_positions(jnp.asarray(o), jnp.asarray(d), jt)
    jlook = j_lookup(jpos, bits, grid)
    jmask = (tx2 > te2)[:, None] & jlook
    t, deltas = march_samples_t(tt(te2), tt(tx2), S, jitter=tt(jitter))
    look_on_ref = occupancy_lookup(tt(jpos), occ.bitfield, cfg.grid)
    mask = (tt(tx2) > tt(te2))[:, None] & occupancy_lookup(
        sample_positions(tt(o), tt(d), t), occ.bitfield, cfg.grid)
    out["place"] = ((np.asarray(jt), np.asarray(jdeltas), np.asarray(jlook),
                     np.asarray(jmask), np.asarray(tx2 - te2)),
                    (t.numpy(), deltas.numpy(), look_on_ref.numpy(), mask.numpy()))

    # 4. compaction at the config's capacity and at one that drops live samples
    live = int(np.asarray(jmask).sum())
    caps = (int(B * S * cfg.render.compact_fraction), live - B)
    out["compaction"] = [(cap, live, _compaction(o, d, tp, jt, jdeltas, jmask, cap, cfg))
                         for cap in caps]

    # 5, 6. the encode, the view encoding and the heads on the live samples
    m = np.asarray(jmask)
    pos = np.asarray(jpos)[m]
    view = np.repeat(tp[:, None, :], S, axis=1)[m]
    x01 = 0.5 * (normalize_positions(tt(pos), cfg.grid) + 1.0)
    onehot = cfg.apply_overrides(["field_.tri_gather_mode=onehot"]).field_
    jonehot = jcfg.apply_overrides(["field_.tri_gather_mode=onehot"]).field_
    jx01 = jnp.asarray(x01.numpy())
    out["encode"] = (
        (np.asarray(j_tri(jstate.params["triplane"], jx01, jcfg.field_)),
         apply_triplane(params["triplane.planes"], params["triplane.lines"], x01, cfg.field_)),
        (np.asarray(j_tri(jstate.params["triplane"], jx01[:N_ONEHOT], jonehot)),
         apply_triplane(params["triplane.planes"], params["triplane.lines"], x01[:N_ONEHOT],
                        onehot)),
        (np.asarray(jfield._encode_view(jnp.asarray(view))), encode_view(cfg.field_, tt(view))))
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
    placed = tuple(np.asarray(a) for a in (jt, jdeltas, jmask))
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

    # 9. one Adam update from the reference's gradient: the 10x table rate
    # and the stage's schedule
    updates, jnew_opt = jopt.update(jgrads, jstate.opt_state, jstate.params)
    jnew = params_from_jax(jax.tree.map(np.asarray, optax.apply_updates(jstate.params, updates)))
    jmom = jax.tree.map(np.asarray, _find(jnew_opt, "ScaleByAdamState"))
    jsched = _find(jstate.opt_state, "ScaleByScheduleState")
    state.optimizer.step([jg[n] for n in state.params])
    out["adam"] = ((jnew, params_from_jax(jmom.mu), params_from_jax(jmom.nu), int(jmom.count)),
                   ({n: v.detach() for n, v in state.params.items()},
                    state.optimizer.state["mu"], state.optimizer.state["nu"],
                    int(state.optimizer.state["count"])))
    out["lr"] = (float(optax.exponential_decay(
        cfg.train.lr, cfg.train.schedule_total_steps, cfg.train.lr_final_fraction)(
            int(jsched.count))),
                 float(state.optimizer.learning_rate(
                     torch.tensor(int(ck.opt_state["sched_count"]), dtype=torch.int32))))

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


def _resumed_stages(setup, ckpt, tmp, extra=()):
    """Both packages' stages, [(train.steps, R)], and rewrites from a run
    directory holding ckpt, under the committed config with `extra`
    overrides."""
    import tnerf.train_loop as jloop
    import tnerf_torch.train_loop as loop

    got = []
    for tag, mod, cfg, args in (("ref", jloop, setup["jcfg"].apply_overrides(extra), ({},)),
                                ("port", loop, setup["cfg"].apply_overrides(extra),
                                 ({}, "cpu"))):
        out = os.path.join(tmp, tag)
        shutil.copytree(ckpt, os.path.join(out, "checkpoints"))
        stages, rewrites = recorded_stages(mod, cfg.apply_overrides(
            [f"logging.out_dir={out}", "train.resume=true"]), *args)
        got.append(([(s[0], s[-1]) for s in stages], rewrites))
    return got


def test_initial_state_is_the_reference_stage_one(setup, tmp_path):
    """The committed step-0 state of seed 1337 is the reference's own
    initial state under the first stage's config, both packages read it,
    and both resume it as stage 1 of 4 at step 0: no rewrite before the
    first stage, every stage then run (each package's own stage matcher,
    the reference's by every leaf's shape, the port's by R)."""
    from tnerf.train_loop import _tri_stage_plan as j_plan
    from tnerf_torch.train_loop import _tri_stage_plan

    s = setup
    assert _tri_stage_plan(s["cfg"]) == s["plan"] == j_plan(s["jcfg"])
    assert _stage_of(s, INIT) == 0
    jcfg, cfg, jfield, _, jstate, jocc, _, _, ck = _load_both(s, INIT, 0)
    assert ck.step == 0 and int(ck.opt_state["count"]) == 0
    fresh = params_from_jax(jax.tree.map(np.asarray, jfield.init(
        jax.random.PRNGKey(cfg.train.seed))))
    mine = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    assert set(fresh) == set(ck.params) == set(mine)
    for k in ck.params:  # XLA compiles the draws' arithmetic otherwise here: ulps apart
        np.testing.assert_array_equal(ck.params[k].numpy(), mine[k].numpy(), err_msg=k)
        np.testing.assert_allclose(ck.params[k].numpy(), fresh[k].numpy(), rtol=0,
                                   atol=1e-6 * np.abs(fresh[k].numpy()).max(), err_msg=k)
    assert tuple(ck.params["triplane.planes"].shape) == (3, 32 * 32, 16)
    assert bool(ck.occupancy.bitfield.all()) and bool(np.asarray(jocc.bitfield).all())
    want = ([(end, res) for end, res in s["plan"]], [res for _, res in s["plan"][1:]])
    assert _resumed_stages(s, INIT, str(tmp_path)) == [want, want]


def test_states_are_mid_training(stages):
    """Each state is what its name says: the pruned grid, the stage's
    resolution, the Adam count since the stage's rewrite."""
    frac = float(stages["bits"].float().mean())
    assert 0.01 < frac < 0.6, frac
    assert (stages["stage"], stages["R"]) == {257: (0, 32), 1885: (3, 128)}[stages["step"]]
    assert stages["count"] == {257: 257, 1885: 10}[stages["step"]]


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


def test_stratified_placement_and_mask(stages):
    (jt, jdeltas, jlook, jmask, span), (t, deltas, look_on_ref, mask) = stages["place"]
    scale = np.maximum(span, 1e-6)[:, None]
    gap_t = np.abs(t - jt).max()
    gap_d = (np.abs(deltas - jdeltas) / scale).max()
    apart = int((mask != jmask).sum())
    print(f"state {stages['step']}: t within {gap_t:.3e}, deltas within {gap_d:.3e} of the span; "
          f"{int(jmask.sum())} live samples, the bitfield's lookup on the reference's positions "
          f"{int((look_on_ref != jlook).sum())} apart, the port's own mask {apart} apart")
    assert gap_t <= PLACE_T_ATOL and gap_d <= PLACE_RTOL
    np.testing.assert_array_equal(look_on_ref, jlook)
    assert 0 < jmask.sum() < jmask.size and apart <= MASK_DIFF_MAX


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


def test_encode_and_view_encoding(stages):
    (jf, f), (jf1, f1), (jv, v) = stages["encode"]
    gaps = [np.abs(b.numpy() - a).max() / np.abs(a).max() for a, b in ((jf, f), (jf1, f1))]
    gap_v = np.abs(v.numpy() - jv).max()
    print(f"state {stages['step']}: {len(jf)} live samples; features within {gaps[0]:.3e} of "
          f"their largest entry ({np.abs(jf).max():.3e}), one-hot {gaps[1]:.3e}, view encoding "
          f"{gap_v:.3e}")
    assert jf.shape == tuple(f.shape) and jf.shape[-1] == 48
    assert gaps[0] <= FEAT_ATOL and gaps[1] <= FEAT_ONEHOT_ATOL and gap_v <= VIEW_ATOL


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
    assert count == jcount == stages["count"] + 1
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


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "ema"])
def rewrite(request, setup, tmp_path_factory):
    """Both packages' stage rewrite of the 257-step state as stage 1's
    last, with (EMA_DECAY x the weights) or without a weight EMA shadow:
    (original checkpoint, the reference's leaves, the port's leaves, their
    treedefs, the two run directories, the stage configs)."""
    import tnerf.train_loop as jloop
    import tnerf_torch.train_loop as loop
    from tnerf_torch.utils.checkpoint import read_train_checkpoint, save_checkpoint
    from tnerf_torch.utils.metrics import get_logger

    s = setup
    src = os.path.join(STATES, f"state_{STATE_STEPS[0]:05d}")
    k = _stage_of(s, src)
    extra = [f"train.param_ema={EMA_DECAY}"] if request.param else []
    tmp = tmp_path_factory.mktemp("rewrite")
    base = os.path.join(tmp, "state")
    if request.param:
        ck = read_train_checkpoint(src, "cpu")
        save_checkpoint(base, ck.step, ck.params, ck.opt_state, ck.occupancy,
                        _stage_cfgs(s, k, extra)[1].train,
                        ema={n: EMA_DECAY * v for n, v in ck.params.items()})
    else:
        shutil.copytree(src, base)
    ck = read_train_checkpoint(base, "cpu")
    dirs = {tag: os.path.join(tmp, tag, "checkpoints") for tag in ("ref", "port")}
    for d in dirs.values():
        shutil.copytree(base, d)
    (jold, old), (jnew, new) = _stage_cfgs(s, k, extra), _stage_cfgs(s, k + 1, extra)
    jloop._upsample_checkpoint(jold, jnew, dirs["ref"], True, get_logger())
    loop._upsample_checkpoint(new, dirs["port"], get_logger())
    leaves, trees = {}, {}
    for tag, d in dirs.items():
        with open(os.path.join(d, "treedef.json")) as fh:
            trees[tag] = json.load(fh)
        with np.load(os.path.join(d, f"step_{ck.step:08d}.npz")) as z:
            leaves[tag] = [z[f"leaf_{i}"] for i in range(len(z.files))]
    return dict(ck=ck, ema=request.param, leaves=leaves, trees=trees, dirs=dirs, k=k,
                cfgs=((jold, old), (jnew, new)), tmp=str(tmp))


def test_stage_rewrite(rewrite):
    """The planes and lines (and the EMA shadow's) resampled to the next
    stage's R alike, every other leaf equal to the bit: the fresh Adam
    state, the step, the occupancy, the MLPs."""
    from tnerf_torch.utils.checkpoint import read_train_checkpoint

    ck, (ref, port) = rewrite["ck"], (rewrite["leaves"][t] for t in ("ref", "port"))
    assert rewrite["trees"]["ref"] == rewrite["trees"]["port"]
    assert len(ref) == len(port)
    r_new = rewrite["cfgs"][1][1].field_.tri_resolution
    table = {(3, r_new, 16), (3, r_new * r_new, 16)}
    worst = 0.0
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if a.shape in table and a.any():
            rel = np.abs(b - a).max() / np.abs(a).max()
            worst = max(worst, rel)
            assert rel <= UPSAMPLE_RTOL, (i, rel)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"leaf {i}")
    new = read_train_checkpoint(rewrite["dirs"]["port"], "cpu")
    assert new.step == ck.step and int(new.opt_state["count"]) == 0
    assert int(new.opt_state["sched_count"]) == 0
    assert all(not v.any() for m in ("mu", "nu") for v in new.opt_state[m].values())
    for n, v in ck.params.items():
        if not n.startswith("triplane."):
            np.testing.assert_array_equal(new.params[n].numpy(), v.numpy(), err_msg=n)
    assert tuple(new.params["triplane.planes"].shape) == (3, r_new * r_new, 16)
    for a, b in zip(new.occupancy, ck.occupancy):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (new.ema is not None) == rewrite["ema"]
    if rewrite["ema"]:
        for n in ("triplane.planes", "triplane.lines"):
            ema = new.ema[n].numpy()
            np.testing.assert_allclose(ema, EMA_DECAY * new.params[n].numpy(), rtol=0,
                                       atol=UPSAMPLE_RTOL * np.abs(ema).max())
    print(f"rewrite R = {ck.params['triplane.lines'].shape[1]} -> {r_new}"
          f"{' with an EMA shadow' if rewrite['ema'] else ''}: planes and lines within "
          f"{worst:.3e} of their largest entry, every other leaf equal")


def test_next_stage_schedule_and_resume(rewrite, setup):
    """The next stage's schedule from its first rate in both packages;
    each package resumes either package's rewritten checkpoint as the next
    stage (stage 2 of 4), with no second rewrite."""
    import optax

    from tnerf_torch.train import Optimizer

    jnew, new = rewrite["cfgs"][1]
    assert new.train.schedule_total_steps == jnew.train.schedule_total_steps == 625
    port = Optimizer(new.train, {n: v.clone() for n, v in rewrite["ck"].params.items()})
    for count in (0, 1, 312, 624):
        want = float(optax.exponential_decay(jnew.train.lr, jnew.train.schedule_total_steps,
                                             jnew.train.lr_final_fraction)(count))
        got = float(port.learning_rate(torch.tensor(count, dtype=torch.int32)))
        assert abs(got - want) <= 2e-7 * want, (count, got, want)
    assert float(port.learning_rate(torch.tensor(0, dtype=torch.int32))) == np.float32(
        new.train.lr)
    plan, k = setup["plan"], rewrite["k"] + 1
    want = ([(end, res) for end, res in plan[k:]], [res for _, res in plan[k + 1:]])
    extra = [f"train.param_ema={EMA_DECAY}"] if rewrite["ema"] else []
    for tag in ("ref", "port"):
        got = _resumed_stages(setup, rewrite["dirs"][tag],
                              os.path.join(rewrite["tmp"], f"resume_{tag}"), extra)
        assert got == [want, want], tag


def test_stratified_jitter_has_the_reference_law(setup):
    """The march placement's jitter in a train step of this config: one
    [0, 1) draw per (ray, sample), the shape the reference draws from its
    key, no axis sharing a draw, each sample inside its own stratum."""
    from tnerf_torch import sampling
    from tnerf_torch.cameras import Rays
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.render.grid_renderer import make_grid_renderer

    _, cfg = _stage_cfgs(setup, 0)
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
        warped = np.arange(S, dtype=np.float32) + draw
        assert (warped >= np.arange(S)).all() and (warped < np.arange(S) + 1).all()


@pytest.mark.parametrize("stage", [0, 3])
def test_initial_weights_have_the_reference_law(setup, stage):
    """The port's initial weights at the config's seed and the reference's,
    at the first stage's R and the last's: planes and lines 0.1 N(0, 1),
    each MLP weight He-normal (std sqrt(2 / fan-in)), every bias zero; the
    same leaves and shapes."""
    from tnerf.train_loop import build_field
    from tnerf_torch.fields.nerf_field import NeRFField

    jcfg, cfg = _stage_cfgs(setup, stage)
    mine = {k: v.detach().numpy() for k, v in NeRFField(
        cfg.field_, cfg.grid, torch.Generator().manual_seed(cfg.train.seed)).params().items()}
    ref = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(
        np.asarray, build_field(jcfg).init(jax.random.PRNGKey(cfg.train.seed)))).items()}
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in ref.items()}
    assert mine["triplane.lines"].shape == (3, setup["plan"][stage][1], 16)
    for tag, leaves in (("port", mine), ("reference", ref)):
        for k, v in leaves.items():
            if k.startswith("triplane."):
                assert _normal_law(v, 0.1), (tag, k)
            elif ".b." in k:
                assert not v.any(), (tag, k)
            else:
                assert _normal_law(v, np.sqrt(2.0 / v.shape[0])), (tag, k)
