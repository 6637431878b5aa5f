"""The grid_intervals training trajectory against the reference package, on
the CPU at a small size (tests/test_torch_march_slice.py's SMALL shape: 2
hidden layers x 32, 4 frequencies, a 16^3 grid walked for 48 hits, 4
samples per interval, batches of 256 rays of the 32x32 prims scene).

Both packages start from the reference's initial state and are driven step
by step as their train loops drive them: the same batch each step, the
port fed the uniforms the reference's key draws (by replacing
`tnerf_torch.sampling.draw_uniform`), and from step grid.warmup_steps = 8
on, every grid.update_every = 4 steps, an occupancy refresh of each
package's own field, the port fed the reference's probe jitter.  Over
TRAJECTORY_STEPS steps (eight refreshes, the grid pruned from the first
one on, so the skipping walk runs on a pruned grid), every step's loss must
agree, every refresh's density EMA must agree, and the bitfields may differ
only in a few cells whose density sits on the threshold.  This is the CPU
guard of the intervals item of ROADMAP.md's Queue C: at this shape the two
trajectories do not part."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tnerf.cameras import Rays as JRays
from tnerf.config import Config as JConfig
from tnerf_torch.config import Config
from tnerf_torch.utils.checkpoint import params_from_jax

from test_torch_march_slice import SMALL

torch.set_num_threads(2)

TRAJECTORY_STEPS = 40
# Prunes 30-70% of the grid from the first refresh on (the default 0.01
# prunes nothing this early: the young field's density is 0.1-0.8 in every
# cell); the skipping walk, which runs where grid.max_hits >= 3 res as in
# the committed intervals config, then walks a pruned grid.
DENSITY_THRESHOLD = 0.3
# The losses of the two packages at every step, relative: bf16 activations
# and bf16-rounded gradients summed in another order (the one-step parity
# bound of test_torch_march_slice.py is 1e-4 on the loss and 3e-2 on each
# gradient), carried through Adam, and a cell whose density sits on the
# threshold pruned in one package and not the other (measured: 2e-5 before
# the first refresh, at most 2.9e-3 after).
LOSS_RTOL = 5e-3
# The density EMA after each refresh, as a share of its largest entry
# (measured at most 6.2e-3); a bit may differ only where the reference's
# EMA lies within EDGE_RTOL of the threshold (measured 0.5%), and in no
# more than BITS_DIFF_MAX of the 4096 cells (measured 11; PR 2 recorded
# under 0.5% for the fused path's refresh).
EMA_RTOL = 1e-2
EDGE_RTOL = 1e-2
BITS_DIFF_MAX = 16


def test_intervals_training_follows_the_reference(monkeypatch):
    from tnerf.grid.occupancy import init_occupancy as j_init_occ
    from tnerf.grid.occupancy import renderer_payload as j_payload
    from tnerf.grid.occupancy import update_occupancy as j_update
    from tnerf.train import RayBatch as JBatch, create_optimizer, make_train_step as j_make
    from tnerf.train import init_train_state as j_init
    from tnerf.train_loop import build_field, build_renderer as j_build
    from tnerf_torch import sampling
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.grid.occupancy import init_occupancy, renderer_payload, update_occupancy
    from tnerf_torch.train import PixelSampler, RayBatch, init_train_state, make_train_step
    from tnerf_torch.train_loop import build_renderer

    ov = SMALL + ["render.pipeline=grid_intervals", "train.lr=5e-3",
                  f"grid.density_threshold={DENSITY_THRESHOLD}"]
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    assert cfg.grid.warmup_steps == 8 and cfg.grid.update_every == 4
    assert cfg.grid.effective_max_hits == 3 * cfg.grid.resolution  # the skipping walk

    # the reference's side
    jfield = build_field(jcfg)
    joptimizer = create_optimizer(jcfg.train)
    jstate = j_init(jfield, joptimizer, 0)
    jstep = j_make(j_build(jcfg, jfield), joptimizer)
    jocc = j_init_occ(jcfg.grid)
    j_refresh = jax.jit(lambda occ, params, key: j_update(
        occ, lambda x: jfield.density(params, x), jcfg.grid, key))

    # the port's side, from the reference's initial weights
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jstate.params)))
    state = init_train_state(field, cfg.train)
    step_fn = make_train_step(build_renderer(cfg, for_eval=False))
    occ = init_occupancy(cfg.grid)
    keys = {}
    monkeypatch.setattr(sampling, "draw_uniform", lambda gen, shape, device: torch.from_numpy(
        np.array(jax.random.uniform(keys["render"], tuple(shape), jnp.float32))))

    train = load_data("procedural", cfg.scene.name, splits=("train",),
                      proc=scene_proc_kwargs(cfg.scene), device="cpu")["train"]
    sampler = PixelSampler(train, cfg.scene.scene_scale, cfg.scene.white_background, "cpu")
    gen = torch.Generator().manual_seed(5)
    key = jax.random.PRNGKey(cfg.train.seed + 1)
    losses, refreshes = [], []
    for step in range(TRAJECTORY_STEPS):
        key, keys["render"], k_occ = jax.random.split(key, 3)
        batch = sampler.sample(gen, cfg.train.batch_size)
        o, d, tp = (a.numpy() for a in batch.rays)
        jbatch = JBatch(JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tp)),
                        jnp.asarray(batch.gt_rgb.numpy()))
        jpayload = j_payload(jocc, jcfg.sampler, jcfg.grid)
        jstate, jaux = jstep(jstate, jbatch, keys["render"], jpayload)
        aux = step_fn(state, RayBatch(batch.rays, batch.gt_rgb),
                      renderer_payload(occ, cfg.sampler, cfg.grid), gen)
        losses.append((float(aux["loss"]), float(jaux["loss"])))
        if step >= cfg.grid.warmup_steps and step % cfg.grid.update_every == 0:
            jocc = j_refresh(jocc, jstate.params, k_occ)
            res = cfg.grid.resolution
            jitter = np.array(jax.random.uniform(k_occ, (res, res, res, 3), jnp.float32, -0.5,
                                                 0.5))
            occ = update_occupancy(occ, field.density, cfg.grid, jitter=torch.from_numpy(jitter))
            bits, jbits = occ.bitfield.numpy(), np.asarray(jocc.bitfield)
            ema, jema = occ.density_ema.numpy(), np.asarray(jocc.density_ema)
            flipped = bits != jbits
            edge = np.abs(jema[flipped] - DENSITY_THRESHOLD) / DENSITY_THRESHOLD
            refreshes.append((step, int(flipped.sum()), float(edge.max(initial=0.0)),
                              float(np.abs(ema - jema).max() / jema.max()), float(bits.mean())))

    rel = [abs(a - b) / abs(b) for a, b in losses]
    assert max(rel) <= LOSS_RTOL, list(zip(range(TRAJECTORY_STEPS), losses, rel))
    assert len(refreshes) == 8
    for step, n_flipped, edge, ema_rel, frac in refreshes:
        assert n_flipped <= BITS_DIFF_MAX and edge <= EDGE_RTOL and ema_rel <= EMA_RTOL, refreshes
        # the grid pruned, so the walk ran on a pruned grid from the first refresh on
        assert 0.2 < frac < 0.8, refreshes
    assert losses[-1][1] < 0.8 * losses[0][1]  # and the reference itself learned
