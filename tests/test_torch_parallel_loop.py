"""The three parallel axes together, and the training loop under them, on 8
gloo ranks (one spawn for the module, `test_torch_parallel_mesh.spawn`),
against one rank and against the reference (`tests/test_dp_sp_tp.py`):

- the grid_intervals renderer on a 2 x 2 x 2 (data, sample, model) mesh:
  the hash grid's levels sharded over "model", each ray's samples over
  "sample", the rays over "data" (the reference's setup: 8 levels of 2^12,
  16^3 grid, max_hits 12 x 4 samples, 64 rays, a random 40% occupancy,
  float32): rgb, acc and weights atol 5e-5 against one rank and the
  reference, also with hash_nearest_levels = 4; the gradient of
  sum(rgb^2), summed over the ranks (table blocks gathered), within 1e-5
  of each leaf's largest entry against one rank and the reference's
  jitted gradient;
- `run_training` at 2 x 2 x 2 on the tiny scene of `tests/test_dp_sp_tp.py`
  (12 steps, occupancy refreshes, evals): finite PSNR, and the metrics
  written once;
- the table-parallel checkpoint: a hash-grid run at 2 x 4 (data, model)
  writes the full layout, which resumes at 4 x 2; the checkpoint loads in
  `tnerf.utils.checkpoint.restore_checkpoint` and in the port, equal, and
  a one-rank port run resumes it;
- a run in a process group of one (spawned on its own; the mesh, the
  gradient and aux all_reduces and the sharded occupancy refresh all run)
  equals the same run with no group: every step's loss, the eval, the
  final parameters, optimizer moments and occupancy grid, to the bit.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_parallel_mesh import jax_params, port_rays, spawn
from tnerf_torch.config import Config

N_RANKS = 8
DSP = ["render.pipeline=grid_intervals", "field_.encoding=hashgrid", "field_.hash_levels=8",
       "field_.hash_log2_table_size=12", "field_.hash_max_resolution=64",
       "field_.hash_gather_mode=gather", "field_.compute_dtype=float32", "grid.resolution=16",
       "grid.max_hits=12", "sampler.samples_per_interval=4", "scene.scene_scale=1.0"]
TINY = ["scene.kind=procedural", "scene.scene_scale=1.0", "grid.resolution=8",
        "grid.warmup_steps=5", "grid.update_every=5", "sampler.near=2.0", "sampler.far=5.5",
        "field_.encoding=hashgrid", "field_.hash_levels=8", "field_.hash_log2_table_size=12",
        "field_.hash_max_resolution=64", "field_.hash_gather_mode=gather",
        "train.batch_size=256", "render.chunk_size=1024"]
RUN_DSP = TINY + ["render.pipeline=grid_intervals", "grid.max_hits=8",
                  "sampler.samples_per_interval=4", "parallel.data_parallel=2",
                  "parallel.sample_parallel=2", "parallel.table_parallel=2", "train.steps=12",
                  "train.eval_every=6", "train.checkpoint_every=0", "train.log_every=6"]
RUN_TP = TINY + ["render.pipeline=grid_march", "sampler.samples_per_ray=32",
                 "parallel.data_parallel=2", "parallel.table_parallel=4", "train.steps=10",
                 "train.eval_every=0", "train.checkpoint_every=10", "train.log_every=5"]
# the frequency field on grid_march, whose occupancy refreshes at steps 5
# and 10 leave 37% and 53% of the cells, so that the dense-to-compact switch
# moves to the compacted step; parallel.data_parallel=-1 as every committed
# config sets it
RUN_ONE = [o for o in TINY if not o.startswith("field_.")] + [
    "field_.hidden_width=32", "field_.hidden_layers=2", "field_.n_frequencies=4",
    "render.pipeline=grid_march", "sampler.samples_per_ray=32", "render.compact=true",
    "render.compact_fraction=1.0", "grid.density_threshold=0.3", "train.steps=12",
    "train.eval_every=0", "train.checkpoint_every=0", "train.log_every=1"]
RESUME = ["parallel.data_parallel=4", "parallel.table_parallel=2", "train.resume=true",
          "train.steps=16"]


def _setup_np():
    rng = np.random.default_rng(3)
    B = 64
    o = rng.uniform(-1, 1, (B, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0).astype(np.float32)
    d = -o + rng.normal(0, 0.2, (B, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    occ = np.random.default_rng(5).uniform(0, 1, (16, 16, 16)) < 0.4
    return o, d, occ


def _scene():
    from tnerf_torch.data.procedural import generate_procedural_scene

    return generate_procedural_scene(width=24, height=24, n_train=4, n_val=1, n_test=1,
                                     n_samples=64, device="cpu")


def _loop_worker(rank, inputs, out):
    from tnerf_torch.parallel import comm
    from tnerf_torch.parallel.mesh import dp_render_sharded, make_mesh, shard_batch
    from tnerf_torch.parallel.sample_parallel import make_sp_interval_renderer
    from tnerf_torch.parallel.table_parallel import (
        full_tree,
        shard_tree,
        with_table_shard,
    )
    from tnerf_torch.train_loop import run_training

    inp = torch.load(inputs, weights_only=False)
    o, d, occ = inp["setup"]
    occ = torch.from_numpy(occ)
    mesh = make_mesh(2, "data", "sample", 2, "model", 2, device="cpu")
    res = {}
    for nearest in (0, 4):
        cfg = Config().apply_overrides(DSP + [f"field_.hash_nearest_levels={nearest}"])
        fcfg = with_table_shard(cfg.field_, mesh, "model")
        rend = make_sp_interval_renderer(fcfg, cfg.grid, cfg.sampler, cfg.render, mesh,
                                         model_axis="model")
        full = {k: torch.from_numpy(v) for k, v in inp["params"].items()}
        params = {k: v.requires_grad_() for k, v in
                  shard_tree(full, fcfg.table_shard).items()}
        with torch.no_grad():
            res[("render", nearest)] = dp_render_sharded(rend, mesh)(params, port_rays(o, d), occ)
        if nearest:
            continue
        local = rend(params, shard_batch(port_rays(o, d), mesh), occ)
        grads = dict(zip(params, torch.autograd.grad((local.rgb ** 2).sum(),
                                                     list(params.values()))))
        for v in grads.values():
            comm.all_reduce_(v, mesh.replica)
        res["grads"] = full_tree(grads, fcfg.table_shard)
    scene = _scene()
    res["dsp"] = run_training(Config().apply_overrides(
        RUN_DSP + [f"logging.out_dir={os.path.join(out, 'dsp')}"]), datasets=scene, device="cpu")
    tp = RUN_TP + [f"logging.out_dir={os.path.join(out, 'tp')}"]
    res["tp"] = run_training(Config().apply_overrides(tp), datasets=scene, device="cpu")
    res["resumed"] = run_training(Config().apply_overrides(tp + RESUME), datasets=scene,
                                  device="cpu")
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loop")
    inputs = {"params": jax_params(DSP)[3], "setup": _setup_np()}
    path = os.path.join(str(tmp), "inputs.pt")
    torch.save(inputs, path)
    spawn(_loop_worker, N_RANKS, tmp, path, str(tmp))
    return inputs, str(tmp), [torch.load(os.path.join(str(tmp), f"rank{r}.pt"),
                                         weights_only=False) for r in range(N_RANKS)]


def _one_rank(inputs, nearest=0):
    from tnerf_torch.render.grid_renderer import make_grid_renderer

    cfg = Config().apply_overrides(DSP + [f"field_.hash_nearest_levels={nearest}"])
    o, d, occ = inputs["setup"]
    rend = make_grid_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render, strategy="intervals")
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in inputs["params"].items()}
    res = rend(params, port_rays(o, d), torch.from_numpy(occ))
    grads = torch.autograd.grad((res.rgb ** 2).sum(), list(params.values()))
    return res, dict(zip(params, grads))


def _reference(inputs, nearest=0):
    """The reference's single-device renderer and its gradient, jitted (as
    `tests/test_dp_sp_tp.py` compares them)."""
    import jax
    import jax.numpy as jnp

    from tnerf.render.grid_renderer import make_grid_renderer
    from test_torch_parallel_mesh import jax_rays
    from tnerf_torch.utils.checkpoint import params_from_jax

    jcfg, field, params, _ = jax_params(DSP + [f"field_.hash_nearest_levels={nearest}"])
    o, d, occ = inputs["setup"]
    rend = make_grid_renderer(field, jcfg.grid, jcfg.sampler, jcfg.render, strategy="intervals",
                              compact=False)
    rays, occ = jax_rays(o, d), jnp.asarray(occ)
    res = jax.jit(lambda p, r, oc: rend(p, r, None, oc))(params, rays, occ)
    g = jax.jit(jax.grad(lambda p: (rend(p, rays, None, occ).rgb ** 2).sum()))(params)
    return res, params_from_jax(jax.tree.map(np.asarray, g))


@pytest.mark.parametrize("nearest", [0, 4])
def test_dp_sp_tp_render_parity(run, nearest):
    inputs, _, ranks = run
    want, _ = _one_rank(inputs, nearest)
    jwant, _ = _reference(inputs, nearest)
    assert float(want.acc.detach().max()) > 0.05
    for r in ranks:
        got = r[("render", nearest)]
        for k in ("rgb", "acc", "weights"):
            a = getattr(got, k).numpy()
            np.testing.assert_allclose(a, getattr(want, k).detach().numpy(), atol=5e-5, err_msg=k)
            np.testing.assert_allclose(a, np.asarray(getattr(jwant, k)), atol=5e-5, err_msg=k)


def test_dp_sp_tp_gradient_parity(run):
    inputs, _, ranks = run
    _, want = _one_rank(inputs)
    _, jwant = _reference(inputs)
    for r in ranks:
        for k, a in want.items():
            for ref in (a.numpy(), jwant[k].numpy()):
                rel = np.abs(r["grads"][k].numpy() - ref).max() / (np.abs(ref).max() + 1e-12)
                assert rel < 1e-5, (k, rel)


def test_run_training_dp_sp_tp(run):
    _, out, ranks = run
    for r in ranks:
        assert np.isfinite(r["dsp"]["psnr_test"])
        assert r["dsp"]["psnr_test"] == ranks[0]["dsp"]["psnr_test"]
    recs = [json.loads(line) for line in open(os.path.join(out, "dsp", "metrics.jsonl"))]
    assert [r["step"] for r in recs if "loss" in r] == [0, 6, 11]  # rank 0 alone writes
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)


def test_tp_checkpoint_loads_in_both_packages_and_resumes(run, tmp_path):
    import shutil

    import jax

    from tnerf.config import Config as JConfig
    from tnerf.grid.occupancy import init_occupancy
    from tnerf.train import create_optimizer, init_train_state
    from tnerf.train_loop import build_field
    from tnerf.utils.checkpoint import restore_checkpoint
    from tnerf_torch.train_loop import run_training
    from tnerf_torch.utils.checkpoint import load_train_checkpoint, params_from_jax

    _, out, ranks = run
    for r in ranks:
        assert np.isfinite(r["tp"]["psnr_test"]) and np.isfinite(r["resumed"]["psnr_test"])
    ckpt = os.path.join(out, "tp", "checkpoints")
    assert sorted(os.listdir(ckpt)) == ["step_00000010.npz", "step_00000016.npz", "treedef.json"]
    jcfg = JConfig().apply_overrides(RUN_TP)
    template = (init_train_state(build_field(jcfg), create_optimizer(jcfg.train), 0),
                init_occupancy(jcfg.grid))
    assert json.load(open(os.path.join(ckpt, "treedef.json")))["treedef"] == \
        str(jax.tree_util.tree_structure(template))
    step, (jstate, jocc) = restore_checkpoint(ckpt, template)
    _, params, _, occ = load_train_checkpoint(ckpt, "cpu")
    assert step == 16
    jflat = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    assert params["hashgrid.tables"].shape == (8 * 4096, 2)  # the full layout
    for k, v in jflat.items():
        np.testing.assert_array_equal(params[k].numpy(), v.numpy(), err_msg=k)
    np.testing.assert_array_equal(occ.bitfield.numpy(), np.asarray(jocc.bitfield))
    # a one-rank run of the port resumes it: the tables whole again
    one = os.path.join(str(tmp_path), "one")
    shutil.copytree(os.path.join(out, "tp"), one)
    cfg = Config().apply_overrides(TINY + RUN_TP[len(TINY):] + [
        "parallel.data_parallel=-1", "parallel.table_parallel=1", "train.resume=true",
        "train.steps=18", f"logging.out_dir={one}"])
    m = run_training(cfg, datasets=_scene(), device="cpu")
    assert np.isfinite(m["psnr_test"])
    recs = [json.loads(line) for line in open(os.path.join(one, "metrics.jsonl"))]
    assert [r["step"] for r in recs if "loss" in r and r["step"] >= 16] == [17]


def _group_of_one_worker(rank, out):
    from tnerf_torch.train_loop import build_mesh, run_training
    from tnerf_torch.utils.metrics import get_logger

    cfg = Config().apply_overrides(RUN_ONE + [f"logging.out_dir={out}"])
    mesh = build_mesh(cfg, torch.device("cpu"), get_logger())
    assert mesh is not None and mesh.shape == {"data": 1}
    torch.save(run_training(cfg, datasets=_scene(), device="cpu"), os.path.join(out, "final.pt"))


def test_group_of_one_equals_the_run_without_a_group(tmp_path):
    import torch.distributed as dist

    from tnerf_torch.train_loop import run_training
    from tnerf_torch.utils.checkpoint import read_train_checkpoint

    launched, alone = str(tmp_path / "launched"), str(tmp_path / "alone")
    spawn(_group_of_one_worker, 1, tmp_path, launched)
    assert not dist.is_initialized()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the spawned rank runs
    try:
        want = run_training(Config().apply_overrides(RUN_ONE + [f"logging.out_dir={alone}"]),
                            datasets=_scene(), device="cpu")
    finally:
        torch.set_num_threads(threads)
    got = torch.load(os.path.join(launched, "final.pt"), weights_only=False)
    timed = ("render_ms_val", "render_ms_test")
    assert {k: v for k, v in got.items() if k not in timed} == \
        {k: v for k, v in want.items() if k not in timed}
    assert np.isfinite(want["psnr_test"])

    def losses(d):
        return [(r["step"], r["loss"], r["train_psnr"], r["acc_mean"], r["occupancy_frac"])
                for r in map(json.loads, open(os.path.join(d, "metrics.jsonl"))) if "loss" in r]

    assert losses(launched) == losses(alone) and len(losses(alone)) == 12
    assert 0.0 < losses(alone)[-1][-1] < 0.6  # the compacted step ran
    a = read_train_checkpoint(os.path.join(launched, "checkpoints"), "cpu")
    b = read_train_checkpoint(os.path.join(alone, "checkpoints"), "cpu")
    assert a[0] == b[0] == 12
    for k, v in b[1].items():
        np.testing.assert_array_equal(a[1][k].numpy(), v.numpy(), err_msg=k)
    for part in ("mu", "nu"):
        for k, v in b[2][part].items():
            np.testing.assert_array_equal(a[2][part][k].numpy(), v.numpy(), err_msg=(part, k))
    np.testing.assert_array_equal(a[3].density_ema.numpy(), b[3].density_ema.numpy())
    np.testing.assert_array_equal(a[3].bitfield.numpy(), b[3].bitfield.numpy())
