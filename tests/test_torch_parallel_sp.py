"""Sample parallelism of the port (`tnerf_torch/parallel/sample_parallel.py`)
on 4 gloo ranks, against one rank and against the reference's
grid_intervals renderer (`tnerf/parallel/sample_parallel.py` holds its SP
renderer to it in `tests/test_sample_parallel.py`).

The ranks start once for the module (`test_torch_parallel_mesh.spawn`).
The setup is the reference's test's: 8^3 grid, max_hits 24, 8 samples per
interval (S = 192), a 2 x 32 MLP of float32 products, 64 rays, a random
30% occupancy.  On the (data, sample) meshes 2 x 2, 1 x 4 and 4 x 1:

- the render (rgb, acc, the reassembled per-sample weights and
  transmittance): atol 5e-5 against one rank and the reference;
- the gradient of sum(rgb^2) summed over the ranks: within 1e-5 of each
  leaf's largest entry, against one rank and the reference (a backward
  that summed the per-ray sum over the sample ranks would give n_sp times
  the gradient);
- one train step through `make_train_step(mesh=...)` on the 2 x 2 mesh:
  loss rtol 1e-5, parameters atol 1e-5 and Adam's first moment atol 1e-7
  against one rank;
- a sample axis that does not divide over the ranks raises.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_parallel_mesh import jax_params, port_rays, spawn
from tnerf_torch.config import Config

N_RANKS = 4
SP = ["sampler.samples_per_interval=8", "grid.resolution=8", "grid.max_hits=24",
      "field_.hidden_width=32", "field_.hidden_layers=2", "field_.n_frequencies=4",
      "field_.compute_dtype=float32", "render.pipeline=grid_intervals", "train.batch_size=64",
      "scene.scene_scale=1.0"]
MESHES = [(2, 2), (1, 4), (4, 1)]


def _setup_np():
    rng = np.random.default_rng(0)
    B = 64
    o = rng.uniform(-1, 1, (B, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 3).astype(np.float32)
    d = -o + rng.uniform(-0.3, 0.3, (B, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    occ = rng.uniform(0, 1, (8, 8, 8)) < 0.3
    gt = rng.uniform(0, 1, (B, 3)).astype(np.float32)
    return o, d, occ, gt


def _sp_worker(rank, inputs, out):
    import torch.distributed as dist

    from tnerf_torch.parallel import comm
    from tnerf_torch.parallel.mesh import dp_render_sharded, make_dp_train_step, make_mesh
    from tnerf_torch.parallel.mesh import shard_batch
    from tnerf_torch.parallel.sample_parallel import make_sp_interval_renderer
    from tnerf_torch.train import RayBatch

    from test_torch_parallel_mesh import port_state

    inp = torch.load(inputs, weights_only=False)
    cfg = Config().apply_overrides(SP)
    o, d, occ, gt = inp["setup"]
    occ = torch.from_numpy(occ)
    res = {}
    for shape in MESHES:
        mesh = make_mesh(shape[0], "data", "sample", shape[1], device="cpu")
        rend = make_sp_interval_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render, mesh)
        params = {k: torch.from_numpy(v).requires_grad_() for k, v in inp["params"].items()}
        with torch.no_grad():
            full = dp_render_sharded(rend, mesh)(params, port_rays(o, d), occ)
        local = rend(params, shard_batch(port_rays(o, d), mesh), occ)
        loss = (local.rgb ** 2).sum()
        grads = torch.autograd.grad(loss, list(params.values()))
        flat = torch.cat([g.reshape(-1) for g in grads])
        comm.all_reduce_(flat, dist.group.WORLD)
        res[shape] = (full, dict(zip(params, torch.split(flat, [g.numel() for g in grads]))))
    mesh = make_mesh(2, "data", "sample", 2, device="cpu")
    rend = make_sp_interval_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render, mesh)
    state = port_state(cfg, inp["params"])
    step = make_dp_train_step(rend, mesh)
    aux = step(state, RayBatch(port_rays(o, d), torch.from_numpy(gt)), occ)
    res["step"] = (float(aux["loss"]), {k: v.detach() for k, v in state.params.items()},
                   state.optimizer.state["mu"])
    bad = cfg.apply_overrides(["sampler.samples_per_interval=5", "grid.max_hits=5"])
    m14 = make_mesh(1, "data", "sample", 4, device="cpu")
    try:
        make_sp_interval_renderer(cfg.field_, bad.grid, bad.sampler, bad.render, m14)
        res["indivisible"] = None
    except ValueError as e:
        res["indivisible"] = str(e)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    _, _, _, flat = jax_params(SP)
    inputs = {"params": flat, "setup": _setup_np()}
    path = os.path.join(str(tmp), "inputs.pt")
    torch.save(inputs, path)
    spawn(_sp_worker, N_RANKS, tmp, path, str(tmp))
    return inputs, [torch.load(os.path.join(str(tmp), f"rank{r}.pt"), weights_only=False)
                    for r in range(N_RANKS)]


def _one_rank(inputs):
    """(render, gradient of sum(rgb^2)) of the single-device renderer."""
    from tnerf_torch.render.grid_renderer import make_grid_renderer

    cfg = Config().apply_overrides(SP)
    o, d, occ, _ = inputs["setup"]
    rend = make_grid_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render, strategy="intervals")
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in inputs["params"].items()}
    res = rend(params, port_rays(o, d), torch.from_numpy(occ))
    grads = torch.autograd.grad((res.rgb ** 2).sum(), list(params.values()))
    return res, dict(zip(params, grads))


def _reference(inputs):
    import jax
    import jax.numpy as jnp

    from tnerf.render.grid_renderer import make_grid_renderer
    from test_torch_parallel_mesh import jax_rays
    from tnerf_torch.utils.checkpoint import params_from_jax

    jcfg, field, params, _ = jax_params(SP)
    o, d, occ, _ = inputs["setup"]
    rend = make_grid_renderer(field, jcfg.grid, jcfg.sampler, jcfg.render, strategy="intervals",
                              compact=False)
    rays, occ = jax_rays(o, d), jnp.asarray(occ)
    res = rend(params, rays, None, occ)
    g = jax.grad(lambda p: (rend(p, rays, None, occ).rgb ** 2).sum())(params)
    return res, params_from_jax(jax.tree.map(np.asarray, g))


@pytest.mark.parametrize("shape", MESHES)
def test_sp_render_parity(run, shape):
    inputs, ranks = run
    want, _ = _one_rank(inputs)
    jwant, _ = _reference(inputs)
    for r in ranks:
        got = r[shape][0]
        for k in ("rgb", "acc", "weights", "transmittance"):
            a = getattr(got, k).numpy()
            np.testing.assert_allclose(a, getattr(want, k).detach().numpy(), atol=5e-5, err_msg=k)
            np.testing.assert_allclose(a, np.asarray(getattr(jwant, k)), atol=5e-5, err_msg=k)
    assert float(want.acc.detach().max()) > 0.1


@pytest.mark.parametrize("shape", MESHES)
def test_sp_gradient_parity(run, shape):
    inputs, ranks = run
    _, want = _one_rank(inputs)
    _, jwant = _reference(inputs)
    for r in ranks:
        got = r[shape][1]
        for k, a in want.items():
            for ref in (a, jwant[k]):
                ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else ref
                scale = np.abs(ref).max() + 1e-12
                rel = np.abs(got[k].numpy().reshape(ref.shape) - ref).max() / scale
                assert rel < 1e-5, (k, rel)


def test_sp_train_step_equals_one_rank(run):
    from test_torch_parallel_mesh import _steps

    inputs, ranks = run
    cfg = Config().apply_overrides(SP)
    o, d, occ, gt = inputs["setup"]
    losses, params, mu = _steps(cfg, inputs["params"], [(o, d, gt)], torch.from_numpy(occ))
    for r in ranks:
        loss, got_p, got_mu = r["step"]
        np.testing.assert_allclose(loss, losses[0], rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(got_p[k].numpy(), params[k].numpy(), atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got_mu[k].numpy(), mu[k].numpy(), atol=1e-7, err_msg=k)


def test_sp_indivisible_sample_axis_raises(run):
    _, ranks = run
    for r in ranks:
        assert r["indivisible"] is not None and "must divide over 4 'sample'" in r["indivisible"]
