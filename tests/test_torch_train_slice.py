"""The training slice as a whole against the reference package, on the CPU
at a small size (2 hidden layers x 32, 4 frequencies, 8^3 grid, 64 samples
per ray; the reference side packs two rays per row, `fused_train_rpc=2`,
and runs its Pallas kernels in interpret mode):

- one train step on a fixed ray batch: loss within 1e-4 relative (a mean
  over 384 squared errors, each output within the kernels' 5e-3), every
  parameter's gradient within 3e-2 of its largest entry (the bound of the
  reference's own kernel-against-autodiff test);
- the pixel -> ray / ground-truth gather of `PixelSampler` (atol 1e-6);
- `cli train --device cpu` on a 32x32 procedural scene: the loss falls and
  a checkpoint is written;
- checkpoints both ways: a reference TrainState (with Adam moments) saved
  by `tnerf`, resumed by the port, steps on with the moments intact; a
  port checkpoint restored by `tnerf.utils.checkpoint.restore_checkpoint`
  into the reference's template and rendered equal (atol 5e-3).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.config import Config as JConfig
from tnerf_torch.config import Config
from tnerf_torch.utils.checkpoint import params_from_jax

SMALL = ["sampler.samples_per_ray=64", "sampler.near=2.0", "sampler.far=5.5",
         "field_.hidden_width=32", "field_.hidden_layers=2", "field_.n_frequencies=4",
         "grid.resolution=8", "grid.warmup_steps=8", "grid.update_every=4",
         "scene.kind=procedural", "scene.name=prims", "scene.scene_scale=1.0",
         "scene.proc_width=32", "scene.proc_height=32", "scene.proc_n_train=6",
         "scene.proc_n_val=1", "scene.proc_n_test=2",
         "render.fused_train_rpc=2", "render.chunk_size=1024",
         "train.batch_size=256", "train.lr_final_fraction=0.1", "train.eval_every=0",
         "train.log_every=5", "train.checkpoint_every=0"]


def _cfgs(extra=()):
    ov = SMALL + list(extra)
    return JConfig().apply_overrides(ov), Config().apply_overrides(ov)


def _rays(B, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (B, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0).astype(np.float32)
    d = -o / 3.0 + rng.uniform(-0.15, 0.15, (B, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, rng.uniform(0, 1, (B, 3)).astype(np.float32)


def _reference_state(jcfg, steps=0):
    """(field, optimizer, renderer, state, occupancy) of the reference,
    `steps` train steps in (so the Adam moments are not zero)."""
    from tnerf.cameras import Rays as JRays, viewdirs_to_thetaphi
    from tnerf.grid.occupancy import init_occupancy
    from tnerf.train import RayBatch, create_optimizer, init_train_state, make_train_step
    from tnerf.train_loop import build_field, build_renderer

    field = build_field(jcfg)
    optimizer = create_optimizer(jcfg.train)
    renderer = build_renderer(jcfg, field, for_eval=False)
    state = init_train_state(field, optimizer, 0)
    occ = init_occupancy(jcfg.grid)
    step = make_train_step(renderer, optimizer)
    for i in range(steps):
        o, d, gt = _rays(128, seed=10 + i)
        rays = JRays(jnp.asarray(o), jnp.asarray(d), viewdirs_to_thetaphi(jnp.asarray(d)))
        state, _ = step(state, RayBatch(rays, jnp.asarray(gt)), jax.random.PRNGKey(i),
                        occ.bitfield)
    return field, optimizer, renderer, state, occ


def _port_field(cfg, jparams):
    from tnerf_torch.fields.nerf_field import NeRFField

    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return field


def test_one_train_step_matches_reference():
    from tnerf.cameras import Rays as JRays, viewdirs_to_thetaphi as j_tp
    from tnerf.train import RayBatch as JBatch, make_train_step as j_make
    from tnerf_torch.cameras import Rays, viewdirs_to_thetaphi
    from tnerf_torch.train import RayBatch, init_train_state, make_train_step
    from tnerf_torch.train_loop import build_renderer

    jcfg, cfg = _cfgs()
    jfield, joptimizer, jrenderer, jstate, jocc = _reference_state(jcfg)
    o, d, gt = _rays(128)
    jrays = JRays(jnp.asarray(o), jnp.asarray(d), j_tp(jnp.asarray(d)))

    def jloss(p):
        return jnp.mean(jnp.square(jrenderer(p, jrays, None, jocc.bitfield).rgb - gt))

    jl, jgrads = jax.value_and_grad(jloss)(jstate.params)
    jnew, jaux = j_make(jrenderer, joptimizer)(jstate, JBatch(jrays, jnp.asarray(gt)),
                                               jax.random.PRNGKey(0), jocc.bitfield)

    field = _port_field(cfg, jstate.params)
    state = init_train_state(field, cfg.train)
    renderer = build_renderer(cfg, for_eval=False)
    td = torch.from_numpy(d)
    batch = RayBatch(Rays(torch.from_numpy(o), td, viewdirs_to_thetaphi(td)), torch.from_numpy(gt))
    occ = torch.ones((8, 8, 8), dtype=torch.bool)
    params = state.params
    loss = torch.mean(torch.square(renderer(params, batch.rays, occ).rgb - batch.gt_rgb))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for l in range(3):
        for kind in ("w", "b"):
            a, b = grads[f"trunk.{kind}.{l}"].numpy(), np.asarray(jgrads["trunk"][kind][l])
            assert np.abs(b).max() > 0
            rel = np.abs(a - b).max() / np.abs(b).max()
            assert rel <= 3e-2, (kind, l, rel)

    before = {k: v.detach().clone() for k, v in params.items()}
    aux = make_train_step(renderer)(state, batch, occ)
    assert state.step == 1 and int(jnew.step) == 1
    for got, want in ((float(loss.detach()), float(jl)), (float(aux["loss"]), float(jaux["loss"]))):
        assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    assert abs(float(aux["psnr"]) - float(jaux["psnr"])) < 1e-3
    assert abs(float(aux["acc_mean"]) - float(jaux["acc_mean"])) < 1e-3
    # Adam's first update is -lr * sign(g) wherever |g| >> eps: the two
    # packages move nearly every weight the same way
    moved = np.concatenate([(params[f"trunk.w.{l}"].detach() - before[f"trunk.w.{l}"])
                            .numpy().ravel() for l in range(3)])
    jmoved = np.concatenate([np.asarray(jnew.params["trunk"]["w"][l]
                                        - jstate.params["trunk"]["w"][l]).ravel()
                             for l in range(3)])
    assert np.abs(moved).max() <= cfg.train.lr * 1.001
    assert np.mean(np.abs(moved - jmoved) < 1e-5) > 0.97


def test_pixel_sampler_gather_and_draws():
    from tnerf.data.dataset import ImageDataset as JDataset
    from tnerf.train import PixelSampler as JSampler
    from tnerf_torch.data.dataset import load_data
    from tnerf_torch.train import PixelSampler

    ds = load_data("procedural", "prims", splits=("train",),
                   proc=dict(width=16, height=12, n_train=5), device="cpu")["train"]
    jds = JDataset(images=ds.images, poses=ds.poses, focal=ds.focal, width=ds.width,
                   height=ds.height, channels=ds.channels, split="train")
    sampler = PixelSampler(ds, 0.8, True, device="cpu")
    jsampler = JSampler(jds, 0.8, True)
    rng = np.random.default_rng(0)
    img, x, y = rng.integers(0, 5, 300), rng.integers(0, 16, 300), rng.integers(0, 12, 300)
    got = sampler._gather(*(torch.from_numpy(a) for a in (img, x, y)))
    want = jsampler._gather(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.gt_rgb.numpy(), np.asarray(want.gt_rgb), atol=1e-6, rtol=0)
    for a, b in zip(got.rays, want.rays):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)

    draw = lambda seed: sampler.sample(torch.Generator().manual_seed(seed), 64)
    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a.gt_rgb, b.gt_rgb) and torch.equal(a.rays.directions, b.rays.directions)
    assert not torch.equal(a.rays.directions, c.rays.directions)
    assert a.rays.origins.shape == (64, 3) and a.gt_rgb.shape == (64, 3)
    # one epoch visits every pixel once; the next epoch is another order
    n = 5 * 16 * 12
    epoch = torch.cat([sampler.sample_epoch(7, i, 96).gt_rgb for i in range(n // 96)])
    every = sampler.images.reshape(n, 3)
    assert torch.allclose(epoch.sum(0), every.sum(0), rtol=1e-5)
    assert torch.equal(epoch.sort(dim=0).values, every.sort(dim=0).values)
    assert not torch.equal(sampler.sample_epoch(8, 0, 96).gt_rgb, epoch[:96])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`cli train --device cpu` for 40 steps (tightening off: its plain
    version is 256 sequential probes, most of a CPU step); the run's out_dir."""
    from tnerf_torch.cli import main

    out = str(tmp_path_factory.mktemp("train"))
    argv = ["train", "--device", "cpu", "--out", out]
    for ov in SMALL + ["train.steps=40", "train.batch_size=512", "train.lr=5e-3",
                       "render.fused_tighten=false"]:
        argv += ["-o", ov]
    assert main(argv) == 0
    return out


def test_cli_train_on_cpu(trained, capsys):
    recs = [json.loads(line) for line in open(os.path.join(trained, "metrics.jsonl"))]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 9 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < 0.8 * np.mean(losses[:2]), losses
    assert all(r["skipped_steps"] == 0 for r in recs if "loss" in r)
    final = [r for r in recs if "psnr_test" in r][-1]
    assert final["step"] == 40 and final["n_views_test"] == 2.0 and final["psnr_test"] > 8.0
    # occupancy refreshes ran after the warmup (steps 8, 12, ..., 36)
    from tnerf_torch.utils.checkpoint import load_train_checkpoint

    step, params, opt, occ = load_train_checkpoint(os.path.join(trained, "checkpoints"), "cpu")
    assert step == 40 and int(occ.step) == 8 and int(opt["count"]) == 40
    assert int(opt["sched_count"]) == 40 and int(opt["total_notfinite"]) == 0
    assert os.path.exists(os.path.join(trained, "renders_40", "test_001.png"))
    cfg = json.load(open(os.path.join(trained, "config.json")))
    assert cfg["train"]["resume"] is False and cfg["logging"]["out_dir"] == trained


def test_port_checkpoint_restores_into_the_reference(trained):
    """`tnerf`'s restore_checkpoint reads the port's checkpoint into its own
    template; the restored model renders what the port renders."""
    from tnerf.cameras import Rays as JRays, viewdirs_to_thetaphi as j_tp
    from tnerf.utils.checkpoint import restore_checkpoint
    from tnerf_torch.cameras import Rays, viewdirs_to_thetaphi
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_train_checkpoint

    jcfg, cfg = _cfgs()
    _, _, jrenderer, template, jocc = _reference_state(jcfg)
    ckpt = os.path.join(trained, "checkpoints")
    meta = json.load(open(os.path.join(ckpt, "treedef.json")))
    assert meta["treedef"] == str(jax.tree_util.tree_structure((template, jocc)))
    step, (jstate, jocc) = restore_checkpoint(ckpt, (template, jocc))
    _, params, opt, occ = load_train_checkpoint(ckpt, "cpu")
    assert step == 40 and int(jstate.step) == 40
    assert int(jstate.opt_state.inner_state[0].count) == 40
    for l in range(3):
        np.testing.assert_array_equal(jstate.params["trunk"]["w"][l], params[f"trunk.w.{l}"].numpy())
        np.testing.assert_array_equal(jstate.opt_state.inner_state[0].nu["trunk"]["b"][l],
                                      opt["nu"][f"trunk.b.{l}"].numpy())
    np.testing.assert_array_equal(jocc.bitfield, occ.bitfield.numpy())
    for leaf, like in zip(jax.tree.leaves((jstate, jocc)), jax.tree.leaves((template, jocc))):
        assert leaf.dtype == like.dtype and leaf.shape == like.shape

    o, d, _ = _rays(128, seed=5)
    jres = jrenderer(jax.tree.map(jnp.asarray, jstate.params),
                     JRays(jnp.asarray(o), jnp.asarray(d), j_tp(jnp.asarray(d))), None,
                     jnp.asarray(jocc.bitfield))
    td = torch.from_numpy(d)
    with torch.no_grad():
        res = build_renderer(cfg)(params, Rays(torch.from_numpy(o), td, viewdirs_to_thetaphi(td)),
                                  occ.bitfield)
    assert float(res.acc.max()) > 0.2
    np.testing.assert_allclose(res.rgb.numpy(), np.asarray(jres.rgb), atol=5e-3, rtol=0)
    np.testing.assert_allclose(res.acc.numpy(), np.asarray(jres.acc), atol=5e-3, rtol=0)


def test_port_resumes_a_reference_checkpoint(tmp_path):
    """A TrainState with two steps of Adam moments, saved by `tnerf`, is
    read leaf for leaf and trained on by the port for three more steps."""
    from tnerf.utils.checkpoint import save_checkpoint
    from tnerf_torch.train_loop import run_training
    from tnerf_torch.utils.checkpoint import load_train_checkpoint

    jcfg, cfg = _cfgs()
    _, _, _, jstate, jocc = _reference_state(jcfg, steps=2)
    ckpt = str(tmp_path / "checkpoints")
    save_checkpoint(ckpt, 2, (jstate, jocc))
    step, params, opt, occ = load_train_checkpoint(ckpt, "cpu")
    adam = jstate.opt_state.inner_state[0]
    assert step == 2 and int(opt["count"]) == 2 and int(opt["sched_count"]) == 2
    for l in range(3):
        for kind in ("w", "b"):
            k = f"trunk.{kind}.{l}"
            np.testing.assert_array_equal(params[k].numpy(), jstate.params["trunk"][kind][l])
            np.testing.assert_array_equal(opt["mu"][k].numpy(), adam.mu["trunk"][kind][l])
            np.testing.assert_array_equal(opt["nu"][k].numpy(), adam.nu["trunk"][kind][l])
    assert float(opt["nu"]["trunk.w.1"].max()) > 0

    run_training(cfg.apply_overrides(["train.resume=true", "train.steps=5",
                                      f"logging.out_dir={tmp_path}"]), device="cpu")
    step, params2, opt2, occ2 = load_train_checkpoint(ckpt, "cpu")
    assert step == 5 and int(opt2["count"]) == 5 and int(opt2["sched_count"]) == 5
    for k, nu in opt["nu"].items():
        # nu <- 0.999 nu + 0.001 g^2 never falls below 0.999^3 of the
        # restored moment: it was carried across, not reset
        assert bool((opt2["nu"][k] >= 0.999 ** 3 * nu * (1 - 1e-5)).all()), k
        assert not torch.equal(params2[k], params[k])
    # 3 steps at lr 1e-3 move no weight further than 3 lr
    assert max(float((params2[k] - params[k]).abs().max()) for k in params) <= 3.01e-3
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs if "loss" in r] == [4]  # steps 2..4 ran, not 0..4


def test_training_options_this_slice_does_not_run_are_refused():
    from tnerf_torch.train_loop import validate_ported

    _, cfg = _cfgs()
    validate_ported(cfg, for_eval=False)
    validate_ported(cfg.apply_overrides(["render.ray_compact=true"]), for_eval=False)
    # the training options and logging of tnerf/train.py are ported and
    # validate on the fused pipeline as in the reference
    for ov in ("train.grad_accum_steps=2", "train.param_ema=0.99", "train.random_background=true",
               "train.keep_best=true", "logging.profile=true", "logging.debug_nans=true",
               "train.remat=true"):
        validate_ported(cfg.apply_overrides([ov]), for_eval=False)
    # a mesh-bounded scene is ported: the option validates (the mesh is read
    # when the run builds its occupancy grid)
    validate_ported(cfg.apply_overrides(["grid.mesh_path=mesh.obj"]), for_eval=False)
    # the parallel axes are ported: each validates where the reference
    # accepts it, and raises the reference's own error where it raises
    # (`tnerf/train_loop.py:558-574`)
    validate_ported(cfg.apply_overrides(["parallel.data_parallel=2"]), for_eval=False)
    intervals = cfg.apply_overrides(["render.pipeline=grid_intervals"])
    validate_ported(intervals.apply_overrides(["parallel.sample_parallel=2"]), for_eval=False)
    hashgrid = cfg.apply_overrides(["render.pipeline=grid_march", "field_.encoding=hashgrid",
                                    "field_.view_encoding=sh"])
    validate_ported(hashgrid.apply_overrides(["parallel.table_parallel=2"]), for_eval=False)
    with pytest.raises(ValueError, match="parallel.sample_parallel shards the grid_intervals"):
        validate_ported(cfg.apply_overrides(["parallel.sample_parallel=2"]), for_eval=False)
    with pytest.raises(ValueError, match="parallel.table_parallel shards hash-grid level"):
        validate_ported(cfg.apply_overrides(["parallel.table_parallel=2"]), for_eval=False)
    # pose refinement is ported: refused on the fused pipeline with the
    # reference's own error (the kernel's VJP has no ray-geometry gradient)
    poses = cfg.apply_overrides(["train.optimize_poses=true", "train.pose_lr_mult=0.5"])
    with pytest.raises(ValueError, match="train.optimize_poses needs ray-geometry gradients"):
        validate_ported(poses, for_eval=False)
    validate_ported(poses.apply_overrides(["render.pipeline=grid_march"]), for_eval=False)


def test_fused_training_deeper_than_the_backward_kernel_holds_is_refused_at_config_time():
    from tnerf_torch.render.fused import MAX_BWD_LAYERS
    from tnerf_torch.train_loop import validate_ported

    _, cfg = _cfgs()
    deep = cfg.apply_overrides([f"field_.hidden_layers={MAX_BWD_LAYERS}"])
    with pytest.raises(ValueError, match=f"field_.hidden_layers={MAX_BWD_LAYERS}: fused training"):
        validate_ported(deep, for_eval=False)
    validate_ported(deep)  # served: the forward kernel takes any depth
    validate_ported(deep.apply_overrides(["render.pipeline=grid_march"]), for_eval=False)
    validate_ported(cfg.apply_overrides([f"field_.hidden_layers={MAX_BWD_LAYERS - 1}"]),
                    for_eval=False)
