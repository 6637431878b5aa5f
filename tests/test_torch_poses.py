"""Pose refinement, NDC training and the table lookups' gradient, against
the reference package on the CPU at a small size
(`tests/test_torch_march_slice.py`'s SMALL shape: 2 x 32 MLP, 4
frequencies, a 16^3 grid, 16 samples per ray):

- `se3_exp` and `compose_pose`: values within 1e-6 and gradients within
  1e-5 of their largest entry (float32 sums of three or four products in
  another order), at exactly zero too, where the reference's safe
  denominator keeps the gradient finite;
- one pose-refinement train step on grid_march (rays made inside the loss
  from exp(pose_deltas[img]) composed onto the poses): the loss within
  1e-4 relative and d loss / d pose_deltas within 3e-2 of its largest entry
  (the bf16 activations of `test_torch_march_slice.py`'s bound), and the
  port's own step reporting the same loss and the deltas' norm;
- one NDC train step on rays of the recentred COLMAP capture: the same
  bounds on the loss and every parameter's gradient;
- `cli train` / `eval` / `render --path` / `render --refined-poses` with
  `--device cpu`, of a pose-refined procedural scene and of the COLMAP
  capture in NDC (`render --orbit` refused there, as the reference does);
- an optimize_poses checkpoint (pose_lr_mult 0.5) of the reference loading
  leaf for leaf into the port, and the port's restoring in the reference;
- the table lookups' backward (ROADMAP Queue C 7): a fixed-order sorted
  segment sum, bit-equal to a numpy transcription of its order and within
  float32 rounding of `embedding_dense_backward`; the thread groups of
  its CUDA kernel at the table fields' shapes.
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

from test_torch_march_slice import SMALL, _ball

# The suite runs several workers side by side: more threads each only fight.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLMAP_ROOT = os.path.join(REPO, "data", "colmap")
POSES = ["render.pipeline=grid_march", "train.optimize_poses=true", "train.pose_lr_mult=0.5"]


def _cfgs(extra=()):
    ov = SMALL + list(extra)
    return JConfig().apply_overrides(ov), Config().apply_overrides(ov)


def _deltas(n, scale, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, 6)) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [0.0, 1e-5, 1e-2, 0.3, 1.0])
def test_se3_exp_and_compose_pose_match_reference(scale):
    from tnerf.cameras import compose_pose as j_compose, se3_exp as j_exp
    from tnerf_torch.cameras import compose_pose, se3_exp

    d = _deltas(16, scale)
    pose = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    pose[:, :3, :] += _deltas(16 * 2, 0.3, seed=1).reshape(16, 3, 4)
    np.testing.assert_allclose(se3_exp(torch.from_numpy(d)).numpy(), np.asarray(j_exp(d)),
                               atol=1e-6)
    w = np.random.default_rng(2).normal(size=(16, 4, 4)).astype(np.float32)  # a cotangent

    def jloss(x):
        return jnp.sum(j_compose(j_exp(x), jnp.asarray(pose)) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(d)))
    x = torch.from_numpy(d).requires_grad_()
    out = compose_pose(se3_exp(x), torch.from_numpy(pose))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(j_compose(j_exp(d), jnp.asarray(pose))), atol=1e-6)
    (got,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), x)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def _scene(n_train=4, size=24):
    from tnerf.data.procedural import generate_procedural_scene as j_scene

    return j_scene(width=size, height=size, n_train=n_train, n_val=1, n_test=1, n_samples=32)


def _grads_close(got, want, tag):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=3e-2 * np.abs(want).max(),
                               err_msg=tag)


def _feed_reference_uniforms(monkeypatch, key):
    """The port's renderers draw the uniforms the reference's key draws
    (as `test_torch_march_slice.py` does)."""
    from tnerf_torch import sampling

    monkeypatch.setattr(sampling, "draw_uniform", lambda gen, shape, device: torch.from_numpy(
        np.array(jax.random.uniform(key, tuple(shape), jnp.float32))))


@pytest.mark.parametrize("scale", [0.0, 0.02])
def test_one_pose_refinement_step_matches_reference(scale, monkeypatch):
    """The rays are made from the refined poses inside the loss; the
    gradient reaches the deltas through ray_aabb's span, the tightened
    span and the sample depths, as in the reference."""
    from tnerf.cameras import compose_pose as j_compose, pixel_rays as j_rays, se3_exp as j_exp
    from tnerf.train import create_optimizer, init_train_state as j_init, pose_extra_params
    from tnerf.train_loop import build_field, build_renderer as j_build
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.train import (
        PixelSampler,
        PoseBatch,
        init_train_state,
        make_train_step,
        pose_extra_params as extra_params,
    )
    from tnerf_torch.train_loop import build_renderer

    jcfg, cfg = _cfgs(POSES)
    scene = _scene()
    train = scene["train"]
    rng = np.random.default_rng(5)
    B = 96
    img = rng.integers(0, len(train), B)
    pix = np.stack([rng.integers(0, train.width, B), rng.integers(0, train.height, B)],
                   -1).astype(np.float32)
    gt = train.images[img, pix[:, 1].astype(int), pix[:, 0].astype(int)]
    occ = _ball()
    jfield = build_field(jcfg)
    jstate = j_init(jfield, create_optimizer(jcfg.train), 0, pose_extra_params(jcfg, len(train)))
    jparams = {**jstate.params, "pose_deltas": jnp.asarray(_deltas(len(train), scale))}
    jrenderer = j_build(jcfg, jfield)
    poses0 = jnp.asarray(train.poses)

    def jloss(p):
        delta = j_exp(p["pose_deltas"][img])
        rays = j_rays(j_compose(delta, poses0[img]), jnp.asarray(pix), train.width, train.height,
                      train.camera, 1.0)
        res = jrenderer(p, rays, key, jnp.asarray(occ))
        return jnp.mean(jnp.square(res.rgb - gt))

    key = jax.random.PRNGKey(7)
    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    _feed_reference_uniforms(monkeypatch, key)

    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(params_from_jax(jax.tree.map(
        np.asarray, {k: v for k, v in jstate.params.items() if k != "pose_deltas"})))
    extra = extra_params(cfg, len(train))
    with torch.no_grad():
        extra["pose_deltas"].copy_(torch.from_numpy(_deltas(len(train), scale)))
    state = init_train_state(field, cfg.train, extra)
    sampler = PixelSampler(train, 1.0, True, "cpu")
    batch = PoseBatch(torch.from_numpy(img), torch.from_numpy(pix), torch.from_numpy(gt))
    renderer = build_renderer(cfg, for_eval=False)
    params = state.params
    rays = sampler.rays(compose_pose_t(params["pose_deltas"][batch.img], sampler.poses[batch.img]),
                        batch.pix)
    gen = torch.Generator()
    res = renderer(params, rays, torch.from_numpy(occ), gen)
    loss = torch.mean(torch.square(res.rgb - batch.gt_rgb))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-4 * float(jl), (float(loss), float(jl))
    (g,) = torch.autograd.grad(loss, [params["pose_deltas"]])
    assert float(np.abs(np.asarray(jgrads["pose_deltas"])).max()) > 0
    _grads_close(g.numpy(), jgrads["pose_deltas"], "d loss / d pose_deltas")
    # the port's own step: the same loss, and the deltas move (Adam's first
    # step moves each by about lr x pose_lr_mult)
    aux = make_train_step(renderer, pose_setup=sampler)(state, batch, torch.from_numpy(occ), gen)
    assert float(aux["loss"]) == float(loss.detach())
    moved = (state.params["pose_deltas"] - torch.from_numpy(_deltas(len(train), scale))).abs()
    lr = cfg.train.lr * cfg.train.pose_lr_mult
    assert float(moved.max()) <= 1.01 * lr and float(moved.max()) > 0.5 * lr
    assert abs(float(aux["pose_delta_norm"]) - float(torch.linalg.norm(
        state.params["pose_deltas"], dim=-1).mean())) < 1e-7


def compose_pose_t(delta, poses):
    from tnerf_torch.cameras import compose_pose, se3_exp

    return compose_pose(se3_exp(delta), poses)


def _colmap_small():
    return ["scene.kind=colmap", "scene.name=prims_cm", f"scene.root={COLMAP_ROOT}",
            "scene.ndc=true", "scene.llff_recenter=true", "scene.llff_bd_rescale=0.75",
            "scene.downscale=8", "sampler.near=-1", "sampler.far=-1",
            "render.pipeline=grid_march"]


def test_one_ndc_step_matches_reference(monkeypatch):
    """NDC rays (origins on z = -1, directions not unit) of the recentred
    COLMAP capture through grid_march: the loss and every gradient."""
    from tnerf.cameras import Rays as JRays
    from tnerf.train import create_optimizer, init_train_state as j_init
    from tnerf.train_loop import build_field, build_renderer as j_build, resolve_near_far as j_nf
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.train import PixelSampler
    from tnerf_torch.train_loop import build_renderer, load_datasets, resolve_near_far

    jcfg, cfg = _cfgs(_colmap_small())
    ds = load_datasets(cfg, device="cpu")
    cfg, jcfg = resolve_near_far(cfg, ds["train"]), j_nf(jcfg, ds["train"])
    assert (cfg.sampler.near, cfg.sampler.far) == (jcfg.sampler.near, jcfg.sampler.far) == (0, 1)
    sampler = PixelSampler(ds["train"], 1.0, True, "cpu", ndc_near=1.0)
    batch = sampler.sample(torch.Generator().manual_seed(1), 128)
    assert torch.all(batch.rays.origins[:, 2] == -1.0)
    jfield = build_field(jcfg)
    jstate = j_init(jfield, create_optimizer(jcfg.train), 0)
    jrenderer = j_build(jcfg, jfield)
    occ = np.zeros((16,) * 3, bool)
    occ[:, :, 4:] = True  # a slab of the NDC cube, so that spans tighten
    jrays = JRays(*(jnp.asarray(a.numpy()) for a in batch.rays))
    gt = batch.gt_rgb.numpy()

    key = jax.random.PRNGKey(3)

    def jloss(p):
        res = jrenderer(p, jrays, key, jnp.asarray(occ))
        return jnp.mean(jnp.square(res.rgb - gt))

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(jstate.params)
    _feed_reference_uniforms(monkeypatch, key)
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jstate.params)))
    params = field.params()
    res = build_renderer(cfg, for_eval=False)(params, batch.rays, torch.from_numpy(occ),
                                              torch.Generator())
    loss = torch.mean(torch.square(res.rgb - batch.gt_rgb))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-4 * float(jl), (float(loss), float(jl))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for l in range(3):
        for kind in ("w", "b"):
            _grads_close(grads[f"trunk.{kind}.{l}"].numpy(), jgrads["trunk"][kind][l],
                         f"trunk.{kind}.{l}")


def _cli(argv, capsys):
    from tnerf_torch.cli import main

    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr()


def test_cli_pose_refinement_on_cpu(tmp_path, capsys):
    """`cli train` with train.optimize_poses, then `eval`, `render --path`
    and `render --split train --refined-poses` of its checkpoint; the
    refusals of --refined-poses without deltas or off the train split."""
    from tnerf_torch.utils.checkpoint import load_train_checkpoint

    out = tmp_path / "run"
    argv = ["train", "--device", "cpu", "--out", str(out)]
    for ov in SMALL + POSES + ["scene.proc_width=24", "scene.proc_height=24",
                               "scene.proc_n_train=4", "train.steps=12", "train.lr=5e-3"]:
        argv += ["-o", ov]
    rc, _ = _cli(argv, capsys)
    assert rc == 0
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    norms = [r["pose_delta_norm"] for r in recs if "pose_delta_norm" in r]
    assert norms and norms[-1] > 0
    _, params, opt, _ = load_train_checkpoint(str(out / "checkpoints"), "cpu")
    assert tuple(params["pose_deltas"].shape) == (4, 6) and float(opt["nu"]["pose_deltas"].max()) > 0
    base = ["--device", "cpu", "--config", str(out / "config.json")]
    rc, cap = _cli(["eval"] + base, capsys)
    assert rc == 0 and "psnr_test" in json.loads(cap.out)
    path = tmp_path / "path.json"
    from tnerf_torch.data.procedural import orbit_poses

    path.write_text(json.dumps({"poses": [p[:3].tolist() for p in orbit_poses(2, 3.5, 0.5)]}))
    rc, cap = _cli(["render"] + base + ["--path", str(path), "--out", str(tmp_path / "p")],
                   capsys)
    assert rc == 0 and sorted(os.listdir(tmp_path / "p")) == ["path_000.png", "path_001.png"]
    refined = str(tmp_path / "refined.png")
    rc, cap = _cli(["render"] + base + ["--split", "train", "--refined-poses", "--pose-index",
                                        "2", "--out", refined], capsys)
    assert rc == 0 and os.path.exists(refined)
    rc, cap = _cli(["render"] + base + ["--split", "test", "--refined-poses", "--out", refined],
                   capsys)
    assert rc == 1 and "--split test poses were never refined" in cap.err
    rc, cap = _cli(["render", "--device", "cpu", "--config", str(out / "config.json"),
                    "--path", str(path), "--orbit", "2"], capsys)
    assert rc == 1 and "mutually exclusive" in cap.err


def test_cli_colmap_ndc_on_cpu(tmp_path, capsys):
    """`cli train` of the COLMAP capture in NDC at 60x45, `eval` and
    `render --path` of its checkpoint; `render --orbit` refused with the
    reference's words; `--refined-poses` refused without pose deltas."""
    out = tmp_path / "run"
    argv = ["train", "--device", "cpu", "--out", str(out)]
    for ov in SMALL + _colmap_small() + ["train.steps=8"]:
        argv += ["-o", ov]
    rc, cap = _cli(argv, capsys)
    assert rc == 0
    final = json.loads(cap.out)
    base = ["--device", "cpu", "--config", str(out / "config.json")]
    rc, cap = _cli(["eval"] + base, capsys)
    assert rc == 0 and abs(json.loads(cap.out)["psnr_test"] - final["psnr_test"]) < 1e-4
    path = tmp_path / "path.json"
    from tnerf_torch.data.colmap import load_colmap_scene

    test = load_colmap_scene(COLMAP_ROOT, "prims_cm", downscale=8, recenter=True,
                             bd_rescale=0.75)["test"]
    path.write_text(json.dumps([p.tolist() for p in test.poses[:2]]))
    rc, cap = _cli(["render"] + base + ["--path", str(path), "--out", str(tmp_path / "p")],
                   capsys)
    assert rc == 0 and len(os.listdir(tmp_path / "p")) == 2
    rc, cap = _cli(["render"] + base + ["--orbit", "1", "--out", str(tmp_path / "o")], capsys)
    assert rc == 1 and "--orbit renders a full turntable, but scene.ndc" in cap.err
    rc, cap = _cli(["render"] + base + ["--split", "train", "--refined-poses"], capsys)
    assert rc == 1 and "needs a train.optimize_poses checkpoint" in cap.err


def test_pose_checkpoints_both_ways(tmp_path):
    """A reference TrainState with pose deltas and two steps of their Adam
    moments (pose_lr_mult 0.5: a second masked scale in the optimizer),
    saved by `tnerf`, loads leaf for leaf into the port; the port's
    checkpoint of it restores in the reference, with the treedef the
    reference writes."""
    from tnerf.grid.occupancy import init_occupancy as j_init_occ
    from tnerf.train import PoseBatch as JPose, create_optimizer, make_train_step as j_make
    from tnerf.train import init_train_state as j_init, pose_extra_params
    from tnerf.train_loop import build_field, build_renderer as j_build
    from tnerf.utils.checkpoint import restore_checkpoint, save_checkpoint as j_save
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.train import init_train_state, pose_extra_params as extra_params
    from tnerf_torch.utils.checkpoint import load_train_checkpoint, save_checkpoint

    jcfg, cfg = _cfgs(POSES + ["train.table_lr_mult=2"])
    scene = _scene(n_train=3, size=16)
    train = scene["train"]
    jfield = build_field(jcfg)
    joptimizer = create_optimizer(jcfg.train)
    jstate = j_init(jfield, joptimizer, 0, pose_extra_params(jcfg, 3))
    jocc = j_init_occ(jcfg.grid)
    setup = (jnp.asarray(train.poses), 16, 16, train.camera, 1.0, None)
    jstep = j_make(j_build(jcfg, jfield), joptimizer, pose_setup=setup)
    rng = np.random.default_rng(0)
    for i in range(2):
        img = rng.integers(0, 3, 64)
        pix = rng.integers(0, 16, (64, 2)).astype(np.float32)
        gt = train.images[img, pix[:, 1].astype(int), pix[:, 0].astype(int)]
        jstate, _ = jstep(jstate, JPose(jnp.asarray(img, jnp.int32), jnp.asarray(pix),
                                        jnp.asarray(gt)), jax.random.PRNGKey(i), jocc.bitfield)
    j_save(str(tmp_path / "from_jax"), 2, (jstate, jocc))
    step, params, opt, occ = load_train_checkpoint(str(tmp_path / "from_jax"), "cpu")
    adam = jstate.opt_state.inner_state[0][0][0]
    flat = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree))
    assert step == 2 and int(opt["count"]) == 2
    for name, want in (("params", flat(jstate.params)), ("mu", flat(adam.mu)),
                       ("nu", flat(adam.nu))):
        got = params if name == "params" else opt[name]
        assert sorted(got) == sorted(want) and "pose_deltas" in got, name
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=f"{name} {k}")
    assert float(np.abs(params["pose_deltas"].numpy()).max()) > 0

    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    state = init_train_state(field, cfg.train, extra_params(cfg, 3))
    state.load_params(params)
    state.optimizer.load_state(opt)
    save_checkpoint(str(tmp_path / "from_port"), 2, state.params, state.optimizer.state, occ,
                    cfg.train)
    meta = json.load(open(tmp_path / "from_port" / "treedef.json"))
    assert meta["treedef"] == str(jax.tree_util.tree_structure((jstate, jocc)))
    _, (restored, rocc) = restore_checkpoint(str(tmp_path / "from_port"), (jstate, jocc))
    for a, b in zip(jax.tree.leaves((restored, rocc)), jax.tree.leaves((jstate, jocc))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------------------------------- the table lookups' backward

def _fixed_order_sum(values, idx, rows, E):
    """A transcription of `segment_sum_rows`'s order in numpy: a row's
    values in lookup order, value k of the row into partial k mod E, each
    partial added one value after another, then the pairwise tree."""
    part = np.zeros((rows, E, values.shape[1]), np.float32)
    count = np.zeros(rows, np.int64)
    for j in np.argsort(idx, kind="stable"):
        r = idx[j]
        part[r, count[r] % E] += values[j]
        count[r] += 1
    while E > 1:
        E //= 2
        part = part[:, :E] + part[:, E:2 * E]
    return part[:, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n,f", [(7, 5000, 64), (1000, 50000, 16), (4096, 20000, 2),
                                      (384, 30000, 300)])
def test_table_lookup_backward_is_a_fixed_order_segment_sum(dtype, rows, n, f):
    """Every table lookup's gradient (`fields/hashgrid.rounded_lookup`) is
    `segment_sum_rows` (ROADMAP Queue C 7): a fixed order that the CUDA
    kernel (csrc/segment_sum.cu) and the plain version share, bit-equal
    here to its numpy transcription, and within float32 rounding of
    `embedding_dense_backward` (the lookups' backward before, which sums a
    row's cotangents in partial segments, in no fixed order on the card).
    The first case crowds 5000 cotangents onto 7 rows, as CP's lines do;
    the last has more features than a row group's 256 feature lanes."""
    from tnerf_torch.fields.hashgrid import rounded_lookup, segment_shape

    g = torch.Generator().manual_seed(rows)
    table = torch.randn(rows, f, generator=g).requires_grad_()
    idx = torch.randint(0, rows, (n // 2, 2), generator=g)
    cot = torch.randn(n // 2, 2, f, generator=g) * 100.0
    out = rounded_lookup(table, idx, dtype)
    assert out.grad_fn.name() == "_LookupBackward"
    (grad,) = torch.autograd.grad(out, table, cot)
    (again,) = torch.autograd.grad(rounded_lookup(table, idx, dtype), table, cot)
    assert torch.equal(grad, again)
    c = cot if dtype == torch.float32 else cot.to(dtype).float()
    _, E, _ = segment_shape(idx.numel(), rows, f)
    assert E > 1
    want = _fixed_order_sum(c.reshape(-1, f).numpy(), idx.reshape(-1).numpy(), rows, E)
    np.testing.assert_array_equal(grad.numpy(), want)
    emb = torch.ops.aten.embedding_dense_backward(c, idx, rows, -1, False)
    scale = float(torch.zeros(rows).index_add_(0, idx.reshape(-1),
                                               c.abs().sum(-1).reshape(-1)).max())
    assert float((grad - emb).abs().max()) <= 1e-6 * scale


def test_segment_shape_fills_a_row_group_by_the_rows_mean_length():
    """The thread groups of csrc/segment_sum.cu at the table fields' own
    shapes (a compacted step's lookups): E entry lanes x FT feature lanes
    per row, at most 1024 threads, 256-thread blocks of short rows."""
    from tnerf_torch.fields.hashgrid import segment_shape

    # hash grid: 12 levels x 2^14 rows of 2 features, 186,777 samples a call
    assert segment_shape(12 * 186777, 12 * 2 ** 14, 2) == (2, 16, 8)
    # CP lines: 3 x 128 rows of 64 features; triplane lines and planes (16)
    assert segment_shape(3 * 98304, 3 * 128, 64) == (64, 16, 1)
    assert segment_shape(3 * 98304, 3 * 128, 16) == (16, 64, 1)
    assert segment_shape(3 * 98304, 3 * 128 * 128, 16) == (16, 8, 2)
    assert segment_shape(10, 1000, 2) == (2, 1, 128)
    assert segment_shape(5, 1, 600) == (256, 4, 1)
