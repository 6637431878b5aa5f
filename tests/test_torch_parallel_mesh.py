"""Data parallelism of the port (`tnerf_torch/parallel/mesh.py`,
`parallel/occupancy.py`) on gloo ranks, against one rank and against
`tnerf/parallel/` on the 8 virtual CPU devices of conftest.py.

The port's side runs in 4 ranks started once for the module by
`torch.multiprocessing.spawn` (`spawn`, a file store under tmp_path, one
thread a rank); the reference's side and the port's one-rank side run in
the pytest process.  Inputs come from numpy with a seed, at the sizes of
the reference's own tests (2 x 32 MLP, 4 frequencies, 32 samples;
float32 products, so that the two packages agree to the tolerances of
`tests/test_distributed.py`):

- one DP step of the frequency field (uniform renderer), the fused
  pipeline (the kernels' plain versions on the CPU) and the hash grid
  (grid_march): loss rtol 1e-5, every parameter after the update atol
  1e-5, and Adam's first moment (0.1 g: a gradient n times too large,
  which Adam's normalised update hides, shows there) atol 1e-7 against
  one rank and against the reference's `make_dp_train_step`; 3 steps in
  sync;
- DP rendering (`dp_render_sharded`, `render_image(mesh=...)`), also with
  ray compaction (kernel B4's plain version): atol 1e-3;
- the sharded occupancy refresh on a 1-D (4) and a 2-D (2 x 2) mesh, with
  and without a static mask, at grid.resolution 12 and 13 (12^3 divides
  by 4, 13^3 does not, so the last rank's slice pads): density EMA atol
  1e-6 and the bitfield equal to the replicated refresh, twice in a row.
"""

import os

import numpy as np
import pytest
import torch

from tnerf_torch.config import Config

N_RANKS = 4
JOIN_SECONDS = 240

BASE = ["sampler.samples_per_ray=32", "sampler.near=2.0", "sampler.far=5.5",
        "field_.hidden_width=32", "field_.hidden_layers=2", "field_.n_frequencies=4",
        "field_.compute_dtype=float32", "train.batch_size=256", "scene.scene_scale=1.0",
        "render.pipeline=uniform"]
FUSED = ["render.pipeline=fused", "sampler.samples_per_ray=64", "grid.resolution=16",
         "render.fused_tighten=false", "train.batch_size=128", "field_.compute_dtype=bfloat16"]
HASH = ["render.pipeline=grid_march", "render.compact=false", "grid.resolution=16",
        "field_.encoding=hashgrid", "field_.hash_gather_mode=gather", "field_.hash_levels=4",
        "field_.hash_log2_table_size=10", "field_.hash_base_resolution=4",
        "field_.hash_max_resolution=32", "field_.hash_hidden_width=32",
        "field_.hash_hidden_layers=2", "train.batch_size=64"]
COMPACT = ["grid.resolution=32", "render.pipeline=grid_march", "sampler.near=0.05",
           "sampler.tighten_res=16", "sampler.occupancy_mask_res=16", "render.ray_compact=true",
           "render.ray_compact_fraction=0.9"]
CASES = {"frequency": [], "fused": FUSED, "hashgrid": HASH}
# a threshold inside the random field's densities, so the bitfield is mixed
OCC = ["grid.density_threshold=0.8"]


# ---------------------------------------------------------------- spawning


def _rank_main(rank, world, store, fn, args):
    import torch.distributed as dist

    from tnerf_torch.parallel import comm

    torch.set_num_threads(1)
    comm.init_group("cpu", init_method=f"file://{store}", rank=rank, world_size=world,
                    local_world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp, *args, timeout=JOIN_SECONDS):
    """fn(rank, *args) on `world` gloo CPU ranks started by
    torch.multiprocessing.spawn, each in a process group formed on a file
    store under `tmp`; an exception in a rank fails the caller, and so does
    a run longer than `timeout` seconds."""
    import time

    import torch.multiprocessing as mp

    store = os.path.join(str(tmp), "store")
    ctx = mp.spawn(_rank_main, args=(world, store, fn, args), nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish in {timeout} s")


def rays_np(B, seed, radius=3.0, spread=0.15):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (B, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * radius).astype(np.float32)
    d = -o / radius + rng.uniform(-spread, spread, (B, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, rng.uniform(0, 1, (B, 3)).astype(np.float32)


def port_rays(o, d):
    from tnerf_torch.cameras import Rays, viewdirs_to_thetaphi

    td = torch.from_numpy(d)
    return Rays(torch.from_numpy(o), td, viewdirs_to_thetaphi(td))


def jax_rays(o, d):
    import jax.numpy as jnp

    from tnerf.cameras import Rays as JRays, viewdirs_to_thetaphi

    return JRays(jnp.asarray(o), jnp.asarray(d), viewdirs_to_thetaphi(jnp.asarray(d)))


def port_state(cfg, params):
    """A port TrainState of the flat `params` (numpy)."""
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.train import init_train_state

    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return init_train_state(field, cfg.train)


def jax_params(overrides, seed=0):
    """(reference config, field, params) and the port's flat numpy params."""
    import jax

    from tnerf.config import Config as JConfig
    from tnerf.train_loop import build_field
    from tnerf_torch.utils.checkpoint import params_from_jax

    jcfg = JConfig().apply_overrides(overrides)
    field = build_field(jcfg)
    params = field.init(jax.random.PRNGKey(seed))
    flat = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, params)).items()}
    return jcfg, field, params, flat


# ---------------------------------------------------------------- the ranks


def _steps(cfg, params, batches, occ, mesh=None):
    """(losses, params, Adam mu) after one step per batch."""
    from tnerf_torch.parallel.mesh import make_dp_train_step
    from tnerf_torch.train import RayBatch, make_train_step
    from tnerf_torch.train_loop import build_renderer

    state = port_state(cfg, params)
    rend = build_renderer(cfg, for_eval=False)
    step = make_train_step(rend) if mesh is None else make_dp_train_step(rend, mesh)
    losses = []
    for o, d, gt in batches:
        aux = step(state, RayBatch(port_rays(o, d), torch.from_numpy(gt)), occ)
        losses.append(float(aux["loss"]))
    return (losses, {k: v.detach().clone() for k, v in state.params.items()},
            {k: v.clone() for k, v in state.optimizer.state["mu"].items()})


def _mesh_worker(rank, inputs, out):
    from tnerf_torch.grid.occupancy import init_occupancy, update_occupancy
    from tnerf_torch.parallel.mesh import dp_render_sharded, make_mesh
    from tnerf_torch.parallel.occupancy import sharded_density
    from tnerf_torch.render.renderer import render_image
    from tnerf_torch.train_loop import build_renderer

    inp = torch.load(inputs, weights_only=False)
    mesh = make_mesh(N_RANKS, device="cpu")
    res = {}
    for case, ov in CASES.items():
        cfg = Config().apply_overrides(BASE + ov)
        occ = torch.ones((cfg.grid.resolution,) * 3, dtype=torch.bool) \
            if cfg.render.pipeline != "uniform" else None
        res[case] = _steps(cfg, inp["params"][case], inp["batches"][case][:1], occ, mesh)
    cfg = Config().apply_overrides(BASE)
    res["three"] = _steps(cfg, inp["params"]["frequency"], inp["batches"]["frequency"], None,
                          mesh)
    # eval-time DP: a 512-ray batch, and a 16 x 32 ray grid through render_image
    o, d, _ = inp["render_rays"]
    rend = build_renderer(cfg, for_eval=True)
    p = {k: torch.from_numpy(v) for k, v in inp["params"]["frequency"].items()}
    res["render"] = dp_render_sharded(rend, mesh)(p, port_rays(o, d)).rgb
    ccfg = Config().apply_overrides(BASE + COMPACT)
    crend = build_renderer(ccfg, for_eval=True)
    grid_rays = port_rays(*(a.reshape(16, 32, 3) for a in inp["compact_rays"][:2]))
    occ = torch.from_numpy(inp["compact_occ"])
    res["compact"] = render_image(crend, p, grid_rays, chunk_size=256, occupancy=occ,
                                  mesh=mesh).rgb
    # the sharded occupancy refresh, on the 1-D mesh and on a 2 x 2 one
    mesh2 = make_mesh(2, "data", "sample", 2, device="cpu")
    occ_res = {}
    for res_g in (12, 13):
        gcfg = Config().apply_overrides(BASE + OCC + [f"grid.resolution={res_g}"])
        field = port_state(gcfg, inp["params"]["frequency"]).field
        for name, m in (("1d", mesh), ("2d", mesh2)):
            for with_mask in (False, True):
                mask = torch.from_numpy(inp["masks"][res_g]) if with_mask else None
                density = sharded_density(lambda x: field.density(x), m)
                s1 = update_occupancy(init_occupancy(gcfg.grid, "cpu", mask), density, gcfg.grid,
                                      jitter=inp["jitter"][res_g][0], mask=mask)
                s2 = update_occupancy(s1, density, gcfg.grid, jitter=inp["jitter"][res_g][1],
                                      mask=mask)
                occ_res[(res_g, name, with_mask)] = (s1, s2)
    res["occupancy"] = occ_res
    res["coords"] = (mesh.coord("data"), mesh2.coord("data"), mesh2.coord("sample"))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


# ---------------------------------------------------------------- the module run


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    inputs = {"params": {}, "batches": {}}
    for case, ov in CASES.items():
        _, _, _, flat = jax_params(BASE + ov)
        inputs["params"][case] = flat
        B = Config().apply_overrides(BASE + ov).train.batch_size
        inputs["batches"][case] = [rays_np(B, seed=20 + i) for i in range(3)]
    inputs["render_rays"] = rays_np(512, seed=2)
    inputs["compact_rays"] = rays_np(512, seed=61, spread=0.2)
    occ = np.zeros((32, 32, 32), bool)
    occ[10:22, 10:22, 10:22] = True
    inputs["compact_occ"] = occ
    rng = np.random.default_rng(7)
    inputs["jitter"] = {r: [torch.from_numpy(rng.uniform(-0.5, 0.5, (r, r, r, 3)).astype(
        np.float32)) for _ in range(2)] for r in (12, 13)}
    inputs["masks"] = {}
    for r in (12, 13):
        m = np.zeros((r, r, r), bool)
        m[2:10, 2:10, 2:10] = True
        inputs["masks"][r] = m
    path = os.path.join(str(tmp), "inputs.pt")
    torch.save(inputs, path)
    spawn(_mesh_worker, N_RANKS, tmp, path, str(tmp))
    return inputs, [torch.load(os.path.join(str(tmp), f"rank{r}.pt"), weights_only=False)
                    for r in range(N_RANKS)]


def _jax_dp(overrides, batches, occupancy=False):
    """The reference's losses and params after make_dp_train_step on an
    8-device mesh, one step per batch (no jitter: key None)."""
    import jax
    import jax.numpy as jnp

    from tnerf.parallel.mesh import make_dp_train_step, make_mesh, replicate, shard_batch
    from tnerf.train import RayBatch, create_optimizer, init_train_state, make_train_step
    from tnerf.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import params_from_jax

    jcfg, field, params, _ = jax_params(overrides)
    opt = create_optimizer(jcfg.train)
    state = init_train_state(field, opt, 0)._replace(params=params)
    state = state._replace(opt_state=opt.init(params))
    mesh = make_mesh(8)
    step = make_dp_train_step(make_train_step(build_renderer(jcfg, field, for_eval=False), opt),
                              mesh, with_occupancy=occupancy)
    state = replicate(state, mesh)
    occ = replicate(jnp.ones((jcfg.grid.resolution,) * 3, bool), mesh) if occupancy else None
    losses = []
    for o, d, gt in batches:
        batch = shard_batch(RayBatch(jax_rays(o, d), jnp.asarray(gt)), mesh)
        args = (state, batch, None) + ((occ,) if occupancy else ())
        state, aux = step(*args)
        losses.append(float(aux["loss"]))
    return losses, params_from_jax(jax.tree.map(np.asarray, state.params))


def _one_rank(case, inputs, n=1):
    cfg = Config().apply_overrides(BASE + CASES[case])
    occ = torch.ones((cfg.grid.resolution,) * 3, dtype=torch.bool) \
        if cfg.render.pipeline != "uniform" else None
    return _steps(cfg, inputs["params"][case], inputs["batches"][case][:n], occ)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_step_equals_one_rank(run, case):
    inputs, ranks = run
    losses, params, mu = _one_rank(case, inputs)
    for r in ranks:  # every rank holds the same state after the step
        got_l, got_p, got_mu = r[case]
        np.testing.assert_allclose(got_l, losses, rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(got_p[k].numpy(), params[k].numpy(), atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got_mu[k].numpy(), mu[k].numpy(), atol=1e-7, err_msg=k)
        assert any(float(v.abs().max()) > 1e-5 for v in got_mu.values())


@pytest.mark.parametrize("case", ["frequency", "hashgrid"])
def test_dp_step_equals_the_reference_dp_step(run, case):
    inputs, ranks = run
    ov = BASE + CASES[case]
    occupancy = Config().apply_overrides(ov).render.pipeline != "uniform"
    losses, jparams = _jax_dp(ov, inputs["batches"][case][:1], occupancy)
    got_l, got_p, _ = ranks[0][case]
    np.testing.assert_allclose(got_l, losses, rtol=1e-5)
    for k, v in jparams.items():
        np.testing.assert_allclose(got_p[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)


def test_dp_three_steps_stay_in_sync(run):
    inputs, ranks = run
    losses, params, _ = _one_rank("frequency", inputs, n=3)
    jlosses, jparams = _jax_dp(BASE, inputs["batches"]["frequency"])
    for r in ranks:
        got_l, got_p, _ = r["three"]
        np.testing.assert_allclose(got_l, losses, rtol=1e-5)
        np.testing.assert_allclose(got_l, jlosses, rtol=1e-4)
        for k in params:
            np.testing.assert_allclose(got_p[k].numpy(), params[k].numpy(), atol=1e-5)
            np.testing.assert_allclose(got_p[k].numpy(), jparams[k].numpy(), atol=1e-4)


def test_dp_render_matches_one_rank_and_the_reference(run):
    import jax

    from tnerf.parallel.mesh import dp_render_sharded, make_mesh, replicate
    from tnerf.train_loop import build_renderer as j_build
    from jax.sharding import NamedSharding, PartitionSpec as P
    from tnerf_torch.train_loop import build_renderer

    inputs, ranks = run
    o, d, _ = inputs["render_rays"]
    cfg = Config().apply_overrides(BASE)
    p = {k: torch.from_numpy(v) for k, v in inputs["params"]["frequency"].items()}
    want = build_renderer(cfg, for_eval=True)(p, port_rays(o, d)).rgb
    jcfg, jfield, jparams, _ = jax_params(BASE)
    mesh = make_mesh()
    jrays = jax.device_put(jax_rays(o, d), NamedSharding(mesh, P("data")))
    jgot = dp_render_sharded(j_build(jcfg, jfield, for_eval=True), mesh)(
        replicate(jparams, mesh), jrays, None, None)
    for r in ranks:
        np.testing.assert_allclose(r["render"].numpy(), want.numpy(), atol=1e-3)
        np.testing.assert_allclose(r["render"].numpy(), np.asarray(jgot.rgb), atol=1e-3)


def test_dp_render_with_ray_compaction(run):
    from tnerf_torch.render.renderer import render_image
    from tnerf_torch.train_loop import build_renderer

    inputs, ranks = run
    cfg = Config().apply_overrides(BASE + COMPACT)
    p = {k: torch.from_numpy(v) for k, v in inputs["params"]["frequency"].items()}
    o, d, _ = inputs["compact_rays"]
    want = render_image(build_renderer(cfg, for_eval=True), p,
                        port_rays(o.reshape(16, 32, 3), d.reshape(16, 32, 3)), chunk_size=256,
                        occupancy=torch.from_numpy(inputs["compact_occ"])).rgb
    assert float((want < 0.99).float().mean()) > 0.05  # the object is in view
    for r in ranks:
        np.testing.assert_allclose(r["compact"].numpy(), want.numpy(), atol=1e-3)


@pytest.mark.parametrize("res", [12, 13])
@pytest.mark.parametrize("mesh_axes", ["1d", "2d"])
def test_sharded_occupancy_update_matches_replicated(run, res, mesh_axes):
    from tnerf_torch.grid.occupancy import init_occupancy, update_occupancy

    inputs, ranks = run
    gcfg = Config().apply_overrides(BASE + OCC + [f"grid.resolution={res}"])
    field = port_state(gcfg, inputs["params"]["frequency"]).field
    for with_mask in (False, True):
        mask = torch.from_numpy(inputs["masks"][res]) if with_mask else None
        s1 = update_occupancy(init_occupancy(gcfg.grid, "cpu", mask), lambda x: field.density(x),
                              gcfg.grid, jitter=inputs["jitter"][res][0], mask=mask)
        s2 = update_occupancy(s1, lambda x: field.density(x), gcfg.grid,
                              jitter=inputs["jitter"][res][1], mask=mask)
        assert 0 < int(s1.bitfield.sum()) < res ** 3
        for r in ranks:
            g1, g2 = r["occupancy"][(res, mesh_axes, with_mask)]
            for got, want in ((g1, s1), (g2, s2)):
                np.testing.assert_allclose(got.density_ema.numpy(), want.density_ema.numpy(),
                                           atol=1e-6)
                np.testing.assert_array_equal(got.bitfield.numpy(), want.bitfield.numpy())
            assert int(g1.step) == 1 and int(g2.step) == 2


def test_mesh_coordinates_are_row_major(run):
    _, ranks = run
    assert [r["coords"] for r in ranks] == [(0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]


def test_make_mesh_refuses_more_ranks_than_exist():
    from tnerf_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2)
    with pytest.raises(ValueError, match="requested 4 devices, have 1"):
        make_mesh(2, "data", "sample", 2)
