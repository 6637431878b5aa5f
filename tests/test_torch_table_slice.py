"""The table-backed fields as a slice, against the reference package on the
CPU at small sizes (`tests/test_torch_march_slice.py`'s SMALL shape; the
trunk and the colour head 16 wide, hash grids of 4 levels x 2^8 entries,
triplanes and CP lines of 9 vertices):

- the two-branch field (`NeRFField.apply` and `.density`) of a reference
  `init`, its weights carried across by `params_from_jax`, against the
  port's `apply_field` / `density`: hashgrid + SH, triplane and CP with the
  frequency view encoding; tolerance as `tests/test_torch_field_occupancy.py`
  (bf16 activations rounded in another order: rgb atol 1e-2, sigma 2e-2
  relative plus 1e-2);
- a short grid_march training trajectory with a hash grid,
  train.table_lr_mult=10 and train.table_l1_weight > 0, and with CP and
  the triplane at the committed configs' rates, both packages fed the same
  batches and the reference's uniforms: losses and table leaves agree
  within the bounds stated below;
- checkpoints in both directions, for each encoding, with Adam moments;
- `cli train` / `eval --device cpu` of a hash grid with SH, and the
  progressive triplane, on a 32x32 scene;
- the fused pipeline refusing the table encodings by the reference's words.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.cameras import Rays as JRays
from tnerf.config import Config as JConfig
from tnerf_torch.config import Config
from tnerf_torch.utils.checkpoint import params_from_jax

from test_torch_march_slice import SMALL

torch.set_num_threads(2)

TABLE = ["field_.hash_levels=4", "field_.hash_log2_table_size=8",
         "field_.hash_base_resolution=4", "field_.hash_max_resolution=64",
         "field_.hash_hidden_width=16", "field_.tri_resolution=9", "field_.tri_features=4",
         "field_.tri_hidden_width=16", "grid.aabb_min=[-1.5,-1.0,-1.0]"]
ENCODINGS = {
    "hashgrid_sh": ["field_.encoding=hashgrid", "field_.view_encoding=sh", "field_.sh_degree=2"],
    "triplane": ["field_.encoding=triplane", "train.table_tv_weight=1e-3"],
    "cp": ["field_.encoding=cp"],
}


def _cfgs(extra=()):
    ov = SMALL + TABLE + list(extra)
    return JConfig().apply_overrides(ov), Config().apply_overrides(ov)


def _port_field(cfg, jparams):
    from tnerf_torch.fields.nerf_field import NeRFField

    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return field


@pytest.mark.parametrize("case", list(ENCODINGS))
def test_two_branch_field_matches_reference(case):
    from tnerf.fields.nerf_field import NeRFField as JField
    from tnerf_torch.fields.nerf_field import NeRFField

    jcfg, cfg = _cfgs(ENCODINGS[case])
    jfield = JField(jcfg.field_, jcfg.grid, arch="twobranch")
    jparams = jfield.init(jax.random.PRNGKey(0))
    # the port's own init has the reference's leaves, shapes and scales
    fresh = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(1)).params()
    converted = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert sorted(fresh) == sorted(converted)
    for k, v in converted.items():
        assert fresh[k].shape == v.shape, k
        if ".b." not in k:
            ratio = float(fresh[k].detach().std()) / float(v.std())
            assert 0.8 < ratio < 1.25, (k, ratio)
    # tables of unit scale, so that the field varies over the inputs (at
    # their initial 1e-4 the hash grid's density is a constant)
    rng = np.random.default_rng(0)
    enc = jcfg.field_.encoding
    jparams[enc] = {k: jnp.asarray(rng.uniform(-1, 1, v.shape).astype(np.float32))
                    for k, v in jparams[enc].items()}
    field = _port_field(cfg, jparams)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.5, 1.0, (512, 3)).astype(np.float32)
    tp = rng.uniform(-3, 3, (512, 2)).astype(np.float32)
    jrgb, jsig = jfield.apply(jparams, jnp.asarray(x), jnp.asarray(tp))
    with torch.no_grad():
        rgb, sig = field(torch.from_numpy(x), torch.from_numpy(tp))
        dens = field.density(torch.from_numpy(x))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-2, rtol=0)
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), atol=1e-2, rtol=2e-2)
    np.testing.assert_allclose(dens.numpy(), np.asarray(jfield.density(jparams, jnp.asarray(x))),
                               atol=1e-2, rtol=2e-2)
    torch.testing.assert_close(dens, sig, atol=0, rtol=0)  # the density is view-independent
    assert float(rgb.std()) > 1e-2 and float(sig.std()) > 1e-2


# A grid_march trajectory of TRAJECTORY_STEPS steps with the hash grid, its
# tables at 10x the learning rate (an Adam step moves an entry by up to
# lr x mult = 0.05) and under the L1 prior; one occupancy refresh at step 8.
# Losses, relative: bf16 activations and gradients summed in another order
# (the one-step bound of test_torch_march_slice.py is 1e-4), carried
# through Adam (measured at most 1.5e-4).  Tables after the first step:
# Adam's first move is +-lr x mult wherever |g| >> eps, so the two agree but
# where a gradient is near eps (measured: 0.1% of the entries differ by
# more than 1e-5, by at most 4e-5).  Tables after the last step: each
# step's Adam ratio carries the bf16-level (1e-2) gradient differences,
# so the packages part by about 1% of a step per step (measured: median
# 7.5e-4, largest 0.029, of moves up to 0.5).
TRAJECTORY_STEPS = 10
LOSS_RTOL = 2e-3
FIRST_STEP_SHARE, FIRST_STEP_ATOL = 5e-3, 1e-4
TABLE_MEDIAN_ATOL, TABLE_ATOL = 2e-3, 0.1


def _follow_reference(monkeypatch, overrides):
    """TRAJECTORY_STEPS grid_march train steps of both packages from the
    reference's initial weights on the same batches and uniforms, with an
    occupancy refresh from the reference's jitter.  Returns the (port,
    reference) losses, each table leaf's |port - reference| after the first
    and after the last step (by the port's parameter name), both final
    states and occupancy grids, and the largest move of a reference table
    entry over the run."""
    from tnerf.grid.occupancy import init_occupancy as j_init_occ
    from tnerf.grid.occupancy import renderer_payload as j_payload
    from tnerf.grid.occupancy import update_occupancy as j_update
    from tnerf.train import RayBatch as JBatch, create_optimizer, make_train_step as j_make
    from tnerf.train import init_train_state as j_init
    from tnerf.train_loop import build_field, build_renderer as j_build
    from tnerf_torch import sampling
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.grid.occupancy import init_occupancy, renderer_payload, update_occupancy
    from tnerf_torch.train import PixelSampler, RayBatch, init_train_state, make_train_step
    from tnerf_torch.train_loop import build_renderer

    jcfg, cfg = _cfgs(overrides)
    jfield = build_field(jcfg)
    joptimizer = create_optimizer(jcfg.train)
    jstate = j_init(jfield, joptimizer, 0)
    jstep = j_make(j_build(jcfg, jfield), joptimizer, table_l1=jcfg.train.table_l1_weight,
                   table_tv=jcfg.train.table_tv_weight)
    jocc = j_init_occ(jcfg.grid)
    j_refresh = jax.jit(lambda occ, params, key: j_update(
        occ, lambda x: jfield.density(params, x), jcfg.grid, key))

    field = _port_field(cfg, jstate.params)
    state = init_train_state(field, cfg.train)
    step_fn = make_train_step(build_renderer(cfg, for_eval=False),
                              table_l1_weight=cfg.train.table_l1_weight,
                              table_tv_weight=cfg.train.table_tv_weight)
    occ = init_occupancy(cfg.grid)
    keys = {}
    monkeypatch.setattr(sampling, "draw_uniform", lambda gen, shape, device: torch.from_numpy(
        np.array(jax.random.uniform(keys["render"], tuple(shape), jnp.float32))))
    train = load_data("procedural", cfg.scene.name, splits=("train",),
                      proc=scene_proc_kwargs(cfg.scene), device="cpu")["train"]
    sampler = PixelSampler(train, cfg.scene.scene_scale, cfg.scene.white_background, "cpu")
    gen = torch.Generator().manual_seed(5)
    key = jax.random.PRNGKey(cfg.train.seed + 1)
    enc = cfg.field_.encoding

    def table_diffs():
        return {f"{enc}.{k}": np.abs(field.params()[f"{enc}.{k}"].detach().numpy()
                                     - np.asarray(v)) for k, v in jstate.params[enc].items()}

    start = {k: np.asarray(v) for k, v in jstate.params[enc].items()}
    losses = []
    for step in range(TRAJECTORY_STEPS):
        key, keys["render"], k_occ = jax.random.split(key, 3)
        batch = sampler.sample(gen, cfg.train.batch_size)
        o, d, tp = (a.numpy() for a in batch.rays)
        jbatch = JBatch(JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tp)),
                        jnp.asarray(batch.gt_rgb.numpy()))
        jstate, jaux = jstep(jstate, jbatch, keys["render"], j_payload(jocc, jcfg.sampler,
                                                                       jcfg.grid))
        aux = step_fn(state, RayBatch(batch.rays, batch.gt_rgb),
                      renderer_payload(occ, cfg.sampler, cfg.grid), gen)
        losses.append((float(aux["loss"]), float(jaux["loss"])))
        if step == 0:
            first = table_diffs()
        if step >= cfg.grid.warmup_steps and step % cfg.grid.update_every == 0:
            jocc = j_refresh(jocc, jstate.params, k_occ)
            res = cfg.grid.resolution
            jitter = np.array(jax.random.uniform(k_occ, (res, res, res, 3), jnp.float32, -0.5,
                                                 0.5))
            occ = update_occupancy(occ, field.density, cfg.grid, jitter=torch.from_numpy(jitter))
    moved = max(float(np.abs(np.asarray(v) - start[k]).max())
                for k, v in jstate.params[enc].items())
    return losses, first, table_diffs(), (state, jstate), (occ, jocc), moved


def test_hashgrid_training_follows_the_reference(monkeypatch):
    losses, first, last, (state, jstate), (occ, jocc), _ = _follow_reference(
        monkeypatch, ENCODINGS["hashgrid_sh"] + [
            "render.pipeline=grid_march", "train.lr=5e-3", "train.table_lr_mult=10",
            "train.table_l1_weight=1e-4"])
    diff = first["hashgrid.tables"]
    assert np.mean(diff > 1e-5) <= FIRST_STEP_SHARE and diff.max() <= FIRST_STEP_ATOL
    diff = last["hashgrid.tables"]
    rel = [abs(a - b) / abs(b) for a, b in losses]
    assert max(rel) <= LOSS_RTOL, list(zip(losses, rel))
    assert losses[-1][1] < 0.9 * losses[0][1]  # the reference itself learned
    moved = np.abs(np.asarray(jstate.params["hashgrid"]["tables"])).max()
    assert 0.2 < moved <= 0.51  # the 10x table rate moved the tables
    assert np.median(diff) <= TABLE_MEDIAN_ATOL and diff.max() <= TABLE_ATOL
    # the step count, the optimizer's and the occupancy refreshes agree
    assert state.step == int(jstate.step) == TRAJECTORY_STEPS
    assert int(occ.step) == int(jocc.step) == 1


@pytest.mark.parametrize("case", list(ENCODINGS))
def test_checkpoints_both_ways(case, tmp_path):
    """A reference TrainState with two steps of Adam moments, saved by
    `tnerf`, loads leaf for leaf into the port; the port's checkpoint of it
    restores in `tnerf.utils.checkpoint.restore_checkpoint` leaf for leaf,
    with the treedef the reference writes."""
    from tnerf.grid.occupancy import init_occupancy as j_init_occ
    from tnerf.train import RayBatch as JBatch, create_optimizer, make_train_step as j_make
    from tnerf.train import init_train_state as j_init
    from tnerf.train_loop import build_field, build_renderer as j_build
    from tnerf.utils.checkpoint import restore_checkpoint, save_checkpoint as j_save
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.train import init_train_state
    from tnerf_torch.utils.checkpoint import load_train_checkpoint, save_checkpoint

    from test_torch_march_slice import _rays

    jcfg, cfg = _cfgs(ENCODINGS[case] + ["render.pipeline=grid_march", "train.table_lr_mult=10"])
    jfield = build_field(jcfg)
    joptimizer = create_optimizer(jcfg.train)
    jstate = j_init(jfield, joptimizer, 0)
    jocc = j_init_occ(jcfg.grid)
    jstep = j_make(j_build(jcfg, jfield), joptimizer)
    for i in range(2):
        o, d, gt = _rays(128, seed=10 + i)
        from tnerf.cameras import viewdirs_to_thetaphi as j_tp
        rays = JRays(jnp.asarray(o), jnp.asarray(d), j_tp(jnp.asarray(d)))
        jstate, _ = jstep(jstate, JBatch(rays, jnp.asarray(gt)), jax.random.PRNGKey(i),
                          jocc.bitfield)
    j_save(str(tmp_path / "from_jax"), 2, (jstate, jocc))
    step, params, opt, occ = load_train_checkpoint(str(tmp_path / "from_jax"), "cpu")
    adam = jstate.opt_state.inner_state[0][0]
    flat = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree))
    assert step == 2 and int(opt["count"]) == 2 and int(opt["sched_count"]) == 2
    for name, want in (("params", flat(jstate.params)), ("mu", flat(adam.mu)),
                       ("nu", flat(adam.nu))):
        got = params if name == "params" else opt[name]
        assert sorted(got) == sorted(want), name
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=f"{name} {k}")
    table = [k for k in params if k.split(".")[0] in ("hashgrid", "triplane", "cp")]
    assert table and all(float(opt["nu"][k].max()) > 0 for k in table)

    # the port's checkpoint of that state, read back by the reference
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(params)
    state = init_train_state(field, cfg.train)
    state.optimizer.load_state(opt)
    save_checkpoint(str(tmp_path / "from_port"), 2, state.params, state.optimizer.state, occ,
                    cfg.train)
    meta = json.load(open(tmp_path / "from_port" / "treedef.json"))
    assert meta["treedef"] == str(jax.tree_util.tree_structure((jstate, jocc)))
    _, (restored, rocc) = restore_checkpoint(str(tmp_path / "from_port"), (jstate, jocc))
    for a, b in zip(jax.tree.leaves((restored, rocc)), jax.tree.leaves((jstate, jocc))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b))


CLI_STEPS = 20


@pytest.mark.parametrize("case", ["hashgrid_sh", "triplane_prog"])
def test_cli_train_and_eval_on_cpu(case, tmp_path, capsys):
    """`cli train --device cpu` on the 32x32 scene, then `cli eval`: the
    loss falls, the checkpoint holds the encoding's tables and the eval
    reproduces the run's own final test PSNR.  The progressive triplane
    trains 5^3, 7^3 and 9^3 stages (upsampled at steps 6 and 12, a fresh
    optimizer each), as `tnerf.train_loop._run_progressive` does."""
    from tnerf_torch.cli import main
    from tnerf_torch.utils.checkpoint import load_train_checkpoint

    extra = ENCODINGS["hashgrid_sh"] if case == "hashgrid_sh" else [
        "field_.encoding=triplane", "field_.tri_init_resolution=5",
        "field_.tri_upsample_steps=[6,12]", "train.table_lr_mult=10"]
    argv = ["train", "--device", "cpu", "--out", str(tmp_path)]
    for ov in SMALL + TABLE + extra + ["render.pipeline=grid_march", f"train.steps={CLI_STEPS}",
                                       "train.lr=5e-3", "train.table_l1_weight=1e-5"]:
        argv += ["-o", ov]
    assert main(argv) == 0
    final = json.loads(capsys.readouterr().out)
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert all(np.isfinite(losses)) and np.mean(losses[-2:]) < 0.85 * np.mean(losses[:2])
    step, params, opt, occ = load_train_checkpoint(str(tmp_path / "checkpoints"), "cpu")
    assert step == CLI_STEPS and int(occ.step) == 3  # refreshes at steps 8, 12, 16
    if case == "triplane_prog":
        from tnerf.train_loop import _tri_stage_plan

        jcfg, _ = _cfgs(extra + [f"train.steps={CLI_STEPS}"])
        assert _tri_stage_plan(jcfg) == [(6, 5), (12, 7), (20, 9)]
        assert tuple(params["triplane.planes"].shape) == (3, 81, 4)
        assert int(opt["count"]) == CLI_STEPS - 12  # the optimizer restarted at step 12
        assert [r["step"] for r in recs if "psnr_test" in r] == [6, 12, 20]
    else:
        assert tuple(params["hashgrid.tables"].shape) == (4 * 256, 2)
        assert int(opt["count"]) == CLI_STEPS
    capsys.readouterr()
    assert main(["eval", "--device", "cpu", "--config", str(tmp_path / "config.json"),
                 "--checkpoint", str(tmp_path / "checkpoints")]) == 0
    evaluated = json.loads(capsys.readouterr().out)
    assert abs(evaluated["psnr_test"] - final["psnr_test"]) < 1e-4


@pytest.mark.parametrize("override", ["field_.encoding=hashgrid", "field_.encoding=triplane",
                                      "field_.encoding=cp", "field_.view_encoding=sh"])
def test_fused_pipeline_refuses_table_fields_as_the_reference_does(override):
    from tnerf.train_loop import build_field, build_renderer as j_build
    from tnerf_torch.train_loop import build_renderer

    jcfg, cfg = _cfgs([override, "render.pipeline=fused"])
    with pytest.raises(ValueError) as jerr:
        j_build(jcfg, build_field(jcfg))
    with pytest.raises(ValueError) as err:
        build_renderer(cfg)
    assert str(err.value) == str(jerr.value)


def test_a_view_smaller_than_a_chunk_gets_a_whole_chunks_capacity():
    """The reference pads a view to whole chunks of render.chunk_size rays
    (`tnerf/render/renderer.py:126`), so the compaction buffers of a view
    smaller than a chunk hold ray_compact_fraction / compact_fraction of a
    whole chunk, its real rays first.  The committed prims model through
    grid_march with ray compaction at 0.3 of a 4096-ray chunk (and sample
    compaction at 0.6 of its samples): a 32x32 view (1024 rays, more than
    0.3 of them kept) loses no ray, in either package (within the bf16
    tolerance of test_torch_march_slice.py)."""
    from tnerf.cameras import camera_rays as j_camera_rays
    from tnerf.cli import _build_restore
    from tnerf.render.renderer import render_image as j_render_image
    from tnerf.train_loop import build_renderer as j_build
    from tnerf_torch.cameras import camera_rays
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.render.renderer import render_image
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    run = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "runs",
                       "suite_rehearsal", "prims")
    ov = ["render.pipeline=grid_march", "sampler.samples_per_ray=32", "sampler.tighten_res=16",
          "sampler.occupancy_mask_res=16", "render.ray_compact=true",
          "render.ray_compact_fraction=0.3", "render.compact=true", "render.compact_fraction=0.6",
          "scene.proc_width=32", "scene.proc_height=32", "scene.proc_n_test=1"]
    jcfg = JConfig.from_json_file(os.path.join(run, "config.json")).apply_overrides(ov)
    cfg = Config.from_json_file(os.path.join(run, "config.json")).apply_overrides(ov)
    ckpt = os.path.join(run, "checkpoints")
    ds = load_data("procedural", "prims", splits=("test",), proc=scene_proc_kwargs(cfg.scene),
                   device="cpu")["test"]
    jfield, jstate, jocc, _, err = _build_restore(jcfg, ckpt, 0)
    assert err is None
    jres = j_render_image(j_build(jcfg, jfield, for_eval=True), jstate.params,
                          j_camera_rays(jnp.asarray(ds.poses[0]), 32, 32, ds.camera, 1.0),
                          chunk_size=4096, occupancy=jocc.bitfield)
    _, params, occ = load_jax_checkpoint(ckpt, device="cpu")
    rays = camera_rays(ds.poses[0], 32, 32, ds.camera, 1.0, device="cpu")
    with torch.no_grad():
        res = render_image(build_renderer(cfg), params, rays, chunk_size=4096,
                           occupancy=occ.bitfield)
        plain = render_image(build_renderer(cfg.apply_overrides(
            ["render.ray_compact=false", "render.compact=false"])), params, rays,
            chunk_size=4096, occupancy=occ.bitfield)
    kept = float((res.acc > 1e-3).float().mean())
    assert 0.3 < kept < 0.9, kept  # more rays than 0.3 of the view, fewer than 0.3 of a chunk
    np.testing.assert_allclose(res.rgb.numpy(), np.asarray(jres.rgb), atol=5e-3, rtol=0)
    np.testing.assert_allclose(res.acc.numpy(), plain.acc.numpy(), atol=1e-3, rtol=0)


def test_compacted_march_step_equals_the_dense_one(monkeypatch):
    """The hash grid + SH under occupancy-CDF placement on a pruned grid:
    the compacted march renderer (the field on the kept samples only, the
    masked samples as stand-ins; a capacity of every sample, so that none
    is dropped) gives the dense one's loss and gradients
    on one batch with the same uniforms (a sum in another order: within
    1e-6 relative on the loss, 1e-3 of each leaf's largest gradient entry;
    measured 0 and 1.1e-7)."""
    from tnerf_torch import sampling
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.train import PixelSampler
    from tnerf_torch.train_loop import build_renderer, resolve_near_far

    _, cfg = _cfgs(ENCODINGS["hashgrid_sh"] + ["render.pipeline=grid_march",
                                               "sampler.placement=occupancy_cdf",
                                               "render.compact_fraction=1.0"])
    ds = load_data("procedural", cfg.scene.name, splits=("train",),
                   proc=scene_proc_kwargs(cfg.scene), device="cpu")["train"]
    cfg = resolve_near_far(cfg, ds)
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    with torch.no_grad():
        field.hashgrid.tables.uniform_(-1, 1, generator=torch.Generator().manual_seed(2))
    batch = PixelSampler(ds, 1.0, False, "cpu").sample(torch.Generator().manual_seed(1), 256)
    occ = torch.from_numpy(np.random.default_rng(0).uniform(size=(16,) * 3) < 0.3)
    u = torch.rand((256, cfg.sampler.samples_per_ray), generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(sampling, "draw_uniform", lambda gen, shape, device: u.reshape(shape))
    out = []
    for compact in (False, True):
        params = field.params()
        res = build_renderer(cfg, for_eval=False, compact=compact)(params, batch.rays, occ,
                                                                    torch.Generator())
        loss = torch.mean(torch.square(res.rgb - batch.gt_rgb))
        grads = torch.autograd.grad(loss, list(params.values()))
        out.append((float(loss.detach()), dict(zip(params, grads)), float(res.acc.detach().max())))
    (dense, gd, acc), (compacted, gc, _) = out
    assert acc > 0.1 and abs(compacted - dense) <= 1e-6 * dense
    for k, g in gd.items():
        assert float(g.abs().max()) > 0, k
        assert float((gc[k] - g).abs().max()) <= 1e-3 * float(g.abs().max()), k


# The same trajectory with CP and the triplane (TV prior on), both at the
# committed configs' rates (lr 2e-3, tables at 10x).  Measured: losses
# within 2.9e-6 relative, the tables after the first step within 8.7e-7,
# after the last within a median of 1.7e-6 and at most 1.7e-3 (of moves up
# to 0.74); the bounds leave a factor of 30 or more.
VM_LOSS_RTOL, VM_FIRST_ATOL, VM_TABLE_MEDIAN_ATOL, VM_TABLE_ATOL = 1e-4, 3e-5, 5e-5, 5e-2


@pytest.mark.parametrize("case", ["cp", "triplane"])
def test_vm_training_follows_the_reference(monkeypatch, case):
    losses, first, last, (state, jstate), (occ, jocc), moved = _follow_reference(
        monkeypatch, ENCODINGS[case] + ["render.pipeline=grid_march", "train.lr=2e-3",
                                        "train.table_lr_mult=10"])
    rel = [abs(a - b) / abs(b) for a, b in losses]
    assert max(rel) <= VM_LOSS_RTOL, list(zip(losses, rel))
    assert losses[-1][1] < 0.95 * losses[0][1]  # the reference itself learned
    for k in first:
        assert first[k].max() <= VM_FIRST_ATOL, k
        assert np.median(last[k]) <= VM_TABLE_MEDIAN_ATOL and last[k].max() <= VM_TABLE_ATOL, k
    assert 0.1 < moved <= 0.25  # ~lr x mult = 0.02 a step: the 10x table rate moved them
    assert state.step == int(jstate.step) == TRAJECTORY_STEPS
    assert int(occ.step) == int(jocc.step) == 1
