"""Table parallelism of the port (`tnerf_torch/parallel/table_parallel.py`)
on 4 gloo ranks, against one rank and against the reference's encodes
(`tnerf/parallel/table_parallel.py` holds its sharded encodes to them in
`tests/test_table_parallel.py` and `test_table_parallel_triplane.py`).

The ranks start once for the module (`test_torch_parallel_mesh.spawn`),
on a "model" axis of 4 and on a 2 x 2 (data, model) mesh, where each data
rank encodes its half of the positions.  Hash grid: 8 levels of 2^12
rows, resolutions 16 to 256 (2 levels a rank on the 4-rank axis);
triplane: R = 16, 8 features; 500 positions from numpy with a seed, on
the 2^-12 lattice (which `encode_positions` maps exactly to [0, 1]^3):

- the features: atol 1e-9 (hash grid; the reference's own bound) and 1e-6
  (triplane) against one rank, and against the reference's encode;
- the table and position gradients of sum(features * g): within 1e-6
  (hash grid) and 1e-5 (triplane) of one rank's; each rank's table
  gradient has its block's shape (the tables never leave their shard);
  a backward that summed the gathered features' cotangents over "model"
  would give n times the table gradient, one that did not sum the
  positions' over "model" a part of theirs;
- one Adam step on the sharded tables and their sharded moments, with
  and without a global-norm clip (whose norm spans the shards): atol 1e-6;
- hash_nearest_levels = 3 (a rank's block holding nearest and trilinear
  levels): features bit-equal, table gradients atol 1e-6;
- one train step of the two-branch field under table parallelism
  (hash grid on grid_march with train.table_l1_weight, triplane with
  train.table_tv_weight: the priors of the table blocks): loss rtol
  1e-5, parameters atol 1e-5, Adam's first moment atol 1e-7 against one
  rank;
- the validation errors (levels or features that do not divide, an
  encoding without tables).
"""

import os

import numpy as np
import pytest
import torch

from test_torch_parallel_mesh import jax_params, rays_np, spawn
from tnerf_torch.config import Config, FieldConfig

N_RANKS = 4
MESHES = {"model4": (1, 4), "data2_model2": (2, 2)}
HASH_CFG = dict(encoding="hashgrid", hash_levels=8, hash_log2_table_size=12,
                hash_base_resolution=16, hash_max_resolution=256, compute_dtype="float32",
                hash_gather_mode="gather")
TRI_CFG = dict(encoding="triplane", tri_resolution=16, tri_features=8, compute_dtype="float32")
STEP_HASH = ["render.pipeline=grid_march", "render.compact=false", "grid.resolution=16",
             "sampler.samples_per_ray=32", "sampler.near=2.0", "sampler.far=5.5",
             "field_.encoding=hashgrid", "field_.hash_gather_mode=gather",
             "field_.hash_levels=8", "field_.hash_log2_table_size=12",
             "field_.hash_max_resolution=64", "field_.hash_hidden_width=32",
             "field_.hash_hidden_layers=2", "field_.compute_dtype=float32",
             "train.batch_size=64", "train.table_l1_weight=1e-3", "train.grad_clip=0.05",
             "scene.scene_scale=1.0"]
STEP_TRI = STEP_HASH[:6] + ["field_.encoding=triplane", "field_.tri_resolution=16",
                            "field_.tri_features=8", "field_.tri_hidden_width=32",
                            "field_.tri_hidden_layers=2", "field_.compute_dtype=float32",
                            "train.batch_size=64", "train.table_tv_weight=1e-2",
                            "train.table_l1_weight=1e-3", "scene.scene_scale=1.0"]
STEPS = {"hashgrid": STEP_HASH, "triplane": STEP_TRI}


def _encode(params, x, cfg):
    from tnerf_torch.fields.nerf_field import encode_positions

    class _Unit:  # the [0, 1]^3 box, so encode_positions' x01 is x
        aabb_min, aabb_max = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)

    return encode_positions(params, cfg, _Unit, x)


def _tables(kind, rng):
    if kind == "hashgrid":
        # the NGP scale of `init_hashgrid`, as the reference's test draws it
        return {"hashgrid.tables": rng.uniform(-1e-4, 1e-4, (8 * 4096, 2)).astype(np.float32)}
    return {"triplane.planes": rng.normal(0, 0.1, (3, 256, 8)).astype(np.float32),
            "triplane.lines": rng.normal(0, 0.1, (3, 16, 8)).astype(np.float32)}


def _tp_worker(rank, inputs, out):
    import dataclasses

    from tnerf_torch.parallel import comm
    from tnerf_torch.parallel.mesh import GradSync, make_dp_train_step, make_mesh
    from tnerf_torch.parallel.table_parallel import (
        full_tree,
        shard_field,
        shard_tree,
        with_table_shard,
    )
    from tnerf_torch.train import Optimizer, RayBatch, init_train_state
    from tnerf_torch.train_loop import build_renderer

    from test_torch_parallel_mesh import port_rays, port_state

    inp = torch.load(inputs, weights_only=False)
    x, g = inp["x"], inp["g"]
    res = {}
    for mname, (n_dp, n_tp) in MESHES.items():
        mesh = make_mesh(n_dp, "data", "model", n_tp, device="cpu")
        rows = slice(mesh.coord("data") * 500 // n_dp, (mesh.coord("data") + 1) * 500 // n_dp)
        for kind, base in (("hashgrid", HASH_CFG), ("triplane", TRI_CFG),
                           ("nearest", dict(HASH_CFG, hash_nearest_levels=3))):
            cfg = with_table_shard(FieldConfig(**base), mesh, "model")
            shard = cfg.table_shard
            full = {k: torch.from_numpy(v) for k, v in inp["tables"][
                "triplane" if kind == "triplane" else "hashgrid"].items()}
            local = {k: v.requires_grad_() for k, v in shard_tree(full, shard).items()}
            xl = x[rows].clone().requires_grad_()
            f = _encode(local, xl, cfg)
            grads = torch.autograd.grad((f * g[rows, :f.shape[-1]]).sum(),
                                        list(local.values()) + [xl])  # every rank's backward
            tg = dict(zip(local, grads[:-1]))
            shapes = {k: tuple(v.shape) for k, v in tg.items()}
            for v in tg.values():  # sum over "data", then the blocks in the full layout
                comm.all_reduce_(v, mesh.replica)
            tg = full_tree(tg, shard)
            feats = torch.cat(comm.gather_blocks(f.detach(), mesh.group("data")))
            dx = torch.cat(comm.gather_blocks(grads[-1], mesh.group("data")))
            res[(mname, kind)] = (feats, tg, dx, shapes)
        # one Adam step on the sharded tables, with and without a clip
        for clip in (0.0, 0.05):
            cfg = with_table_shard(FieldConfig(**HASH_CFG), mesh, "model")
            tcfg = Config().apply_overrides(["train.lr=1e-2", f"train.grad_clip={clip}"]).train
            local = shard_tree({"hashgrid.tables": torch.from_numpy(inp["adam"])},
                               cfg.table_shard)
            p = {"hashgrid.tables": local["hashgrid.tables"].requires_grad_()}
            opt = Optimizer(tcfg, p)
            f = _encode(p, x[rows], cfg)
            (gr,) = torch.autograd.grad((f ** 2).sum(), [p["hashgrid.tables"]])
            sync = GradSync(mesh, opt.names, opt.sizes, ["hashgrid.tables"])
            # a sum, not a mean, over the data shards: undo the division by n_dp
            opt.step_flat(sync.reduce(gr.reshape(-1).clone()) * n_dp, sync)
            res[(mname, "adam", clip)] = full_tree({k: v.detach() for k, v in p.items()},
                                                   cfg.table_shard)
        # a train step of the two-branch field
        for kind, ov in STEPS.items():
            cfg = Config().apply_overrides(ov)
            state = port_state(cfg, inp["step_params"][kind])
            shard = shard_field(state.field, mesh)
            state = init_train_state(state.field, cfg.train)
            rcfg = dataclasses.replace(cfg, field_=state.field.config)
            step = make_dp_train_step(
                build_renderer(rcfg, for_eval=False), mesh,
                table_l1_weight=cfg.train.table_l1_weight,
                table_tv_weight=cfg.train.table_tv_weight)
            o, d, gt = inp["batch"]
            occ = torch.ones((16, 16, 16), dtype=torch.bool)
            aux = step(state, RayBatch(port_rays(o, d), torch.from_numpy(gt)), occ)
            res[(mname, "step", kind)] = (
                float(aux["loss"]), full_tree({k: v.detach() for k, v in state.params.items()},
                                              shard),
                full_tree(state.optimizer.state["mu"], shard))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(11)
    # multiples of 2^-12, which the [0, 1]^3 box maps to themselves exactly
    x = rng.integers(0, 4096, (500, 3)).astype(np.float32) / np.float32(4096)
    inputs = {"x": torch.from_numpy(x),
              "g": torch.from_numpy(rng.normal(0, 1, (500, 24)).astype(np.float32)),
              "tables": {k: _tables(k, rng) for k in ("hashgrid", "triplane")},
              # larger entries for the Adam step, whose gradients then stand
              # well clear of Adam's eps
              "adam": rng.normal(0, 0.1, (8 * 4096, 2)).astype(np.float32),
              "step_params": {k: jax_params(ov)[3] for k, ov in STEPS.items()},
              "batch": rays_np(64, seed=5)}
    path = os.path.join(str(tmp), "inputs.pt")
    torch.save(inputs, path)
    spawn(_tp_worker, N_RANKS, tmp, path, str(tmp))
    return inputs, [torch.load(os.path.join(str(tmp), f"rank{r}.pt"), weights_only=False)
                    for r in range(N_RANKS)]


def _one_rank(inputs, kind):
    base = {"hashgrid": HASH_CFG, "triplane": TRI_CFG,
            "nearest": dict(HASH_CFG, hash_nearest_levels=3)}[kind]
    cfg = FieldConfig(**base)
    full = {k: torch.from_numpy(v).requires_grad_() for k, v in inputs["tables"][
        "triplane" if kind == "triplane" else "hashgrid"].items()}
    x = inputs["x"].clone().requires_grad_()
    f = _encode(full, x, cfg)
    grads = torch.autograd.grad((f * inputs["g"][:, :f.shape[-1]]).sum(), list(full.values()) + [x])
    return f.detach(), dict(zip(full, grads[:-1])), grads[-1]


def _reference_features(inputs, kind):
    import jax.numpy as jnp

    from tnerf.config import FieldConfig as JFieldConfig

    x = jnp.asarray(inputs["x"].numpy())
    t = inputs["tables"]["triplane" if kind == "triplane" else "hashgrid"]
    if kind == "triplane":
        from tnerf.fields.triplane import apply_triplane_gather

        return np.asarray(apply_triplane_gather(
            {"planes": jnp.asarray(t["triplane.planes"]), "lines": jnp.asarray(t["triplane.lines"])},
            x, JFieldConfig(**TRI_CFG)))
    from tnerf.fields.hashgrid import apply_hashgrid_gather

    base = dict(HASH_CFG, hash_nearest_levels=3) if kind == "nearest" else HASH_CFG
    return np.asarray(apply_hashgrid_gather({"tables": jnp.asarray(t["hashgrid.tables"])}, x,
                                            JFieldConfig(**base)))


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("kind", ["hashgrid", "triplane", "nearest"])
def test_tp_forward_parity(run, mname, kind):
    inputs, ranks = run
    want, _, _ = _one_rank(inputs, kind)
    ref = _reference_features(inputs, kind)
    atol = 1e-6 if kind == "triplane" else 1e-9
    for r in ranks:
        got = r[(mname, kind)][0].numpy()
        np.testing.assert_allclose(got, want.numpy(), atol=atol)
        np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("kind", ["hashgrid", "triplane", "nearest"])
def test_tp_gradient_parity_and_local_table_grads(run, mname, kind):
    inputs, ranks = run
    _, tg, dx = _one_rank(inputs, kind)
    atol = 1e-5 if kind == "triplane" else 1e-6
    n_tp = MESHES[mname][1]
    for r in ranks:
        got_tg, got_dx, shapes = r[(mname, kind)][1:]
        for k, v in tg.items():
            assert float(v.abs().max()) > 1e-3
            np.testing.assert_allclose(got_tg[k].numpy(), v.numpy(), atol=atol, err_msg=k)
            full = tuple(v.shape)
            ax = 0 if k == "hashgrid.tables" else 2
            assert shapes[k] == full[:ax] + (full[ax] // n_tp,) + full[ax + 1:]
        np.testing.assert_allclose(got_dx.numpy(), dx.numpy(), atol=atol)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("clip", [0.0, 0.05])
def test_tp_optimizer_step_sharded(run, mname, clip):
    from tnerf_torch.train import Optimizer

    inputs, ranks = run
    cfg = FieldConfig(**HASH_CFG)
    tcfg = Config().apply_overrides(["train.lr=1e-2", f"train.grad_clip={clip}"]).train
    t = torch.from_numpy(inputs["adam"].copy()).requires_grad_()
    opt = Optimizer(tcfg, {"hashgrid.tables": t})
    (gr,) = torch.autograd.grad((_encode({"hashgrid.tables": t}, inputs["x"], cfg) ** 2).sum(),
                                [t])
    if clip:
        assert float(gr.norm()) > clip  # the clip acts
    opt.step([gr])
    for r in ranks:
        np.testing.assert_allclose(r[(mname, "adam", clip)]["hashgrid.tables"].numpy(),
                                   t.detach().numpy(), atol=1e-6)


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("kind", list(STEPS))
def test_tp_train_step_equals_one_rank(run, mname, kind):
    from test_torch_parallel_mesh import port_rays, port_state
    from tnerf_torch.train import RayBatch, make_train_step
    from tnerf_torch.train_loop import build_renderer

    inputs, ranks = run
    cfg = Config().apply_overrides(STEPS[kind])
    o, d, gt = inputs["batch"]

    state = port_state(cfg, inputs["step_params"][kind])
    step = make_train_step(build_renderer(cfg, for_eval=False),
                           table_l1_weight=cfg.train.table_l1_weight,
                           table_tv_weight=cfg.train.table_tv_weight)
    aux = step(state, RayBatch(port_rays(o, d), torch.from_numpy(gt)),
               torch.ones((16, 16, 16), dtype=torch.bool))
    mu = state.optimizer.state["mu"]
    for r in ranks:
        loss, got_p, got_mu = r[(mname, "step", kind)]
        np.testing.assert_allclose(loss, float(aux["loss"]), rtol=1e-5)
        for k, v in state.params.items():
            np.testing.assert_allclose(got_p[k].numpy(), v.detach().numpy(), atol=1e-5,
                                       err_msg=k)
            np.testing.assert_allclose(got_mu[k].numpy(), mu[k].numpy(), atol=1e-7, err_msg=k)


class _StubMesh:
    """What the validation reads of a mesh: an axis's size and coordinate."""

    def __init__(self, n):
        self.n = n

    def size(self, axis):
        return self.n

    def coord(self, axis):
        return 0


@pytest.mark.parametrize("bad,match", [
    (dict(HASH_CFG, hash_levels=6), "hash_levels=6 must divide over 4 'model' devices"),
    (dict(TRI_CFG, tri_features=6), "tri_features=6 must divide over 4 'model' devices"),
    (dict(encoding="frequency"), "parallel.table_parallel shards hash-grid level tables"),
    (dict(encoding="cp"), "parallel.table_parallel shards hash-grid level tables"),
])
def test_tp_validates(bad, match):
    from tnerf_torch.parallel.table_parallel import with_table_shard

    with pytest.raises(ValueError, match=match):
        with_table_shard(FieldConfig(**bad), _StubMesh(4), "model")
