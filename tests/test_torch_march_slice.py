"""The unfused pipelines (grid_march, grid_intervals, uniform) as a whole
against the reference package, on the CPU at a small size (2 hidden layers
x 32, 4 frequencies, a 16^3 grid, 16 samples per ray, 4 per interval):

- one train step of each pipeline on a fixed ray batch, both packages fed
  the uniforms the reference's key draws: loss within 1e-4 relative, every
  parameter's gradient within 3e-2 of its largest entry (bf16 activations
  and bf16-rounded gradients in both, summed in another order; the bound
  `test_torch_train_slice.py` holds the fused step to), the distortion
  regularizer included;
- `cli train --device cpu` and `cli eval --device cpu` of each pipeline on a
  32x32 procedural scene: the loss falls, a checkpoint in the reference's
  layout is written (the uniform pipeline's holds no occupancy grid) and
  served;
- the committed prims checkpoint (8 x 128, trained on the fused path)
  through grid_march against the reference at 32x32: within 5e-3;
- the dense-to-compact switch of grid_march training, under uniform and
  under CDF placement;
- the options the unfused pipelines refuse, by the reference's words;
- a subprocess check that the new modules import neither `jax` nor `tnerf`.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.cameras import Rays as JRays
from tnerf.cameras import viewdirs_to_thetaphi as j_tp
from tnerf.config import Config as JConfig
from tnerf_torch.cameras import Rays, viewdirs_to_thetaphi
from tnerf_torch.config import Config
from tnerf_torch.utils.checkpoint import params_from_jax

# The suite runs several workers side by side: more threads each only fight.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "suite_rehearsal", "prims")
SMALL = ["sampler.samples_per_ray=16", "sampler.cdf_bins=16", "sampler.near=2.0",
         "sampler.far=5.5", "sampler.samples_per_interval=4", "sampler.mode=stratified",
         "sampler.tighten_probes=32", "sampler.tighten_res=8", "sampler.occupancy_mask_res=8",
         "field_.hidden_width=32", "field_.hidden_layers=2", "field_.n_frequencies=4",
         "grid.resolution=16", "grid.warmup_steps=8", "grid.update_every=4",
         "scene.kind=procedural", "scene.name=prims", "scene.scene_scale=1.0",
         "scene.proc_width=32", "scene.proc_height=32", "scene.proc_n_train=6",
         "scene.proc_n_val=1", "scene.proc_n_test=2", "render.chunk_size=1024",
         "render.compact=false", "render.ray_compact=false",
         "train.batch_size=256", "train.lr_final_fraction=0.1", "train.eval_every=0",
         "train.log_every=5", "train.checkpoint_every=0"]
PIPELINES = {
    "grid_march": ["render.pipeline=grid_march"],
    "grid_march_cdf": ["render.pipeline=grid_march", "sampler.placement=occupancy_cdf"],
    "grid_march_compact": ["render.pipeline=grid_march", "render.compact=true",
                           "render.compact_fraction=0.9"],
    "grid_intervals": ["render.pipeline=grid_intervals"],
    "uniform": ["render.pipeline=uniform"],
    "uniform_distortion": ["render.pipeline=uniform", "train.distortion_weight=0.01"],
}


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


def _ball(res=16):
    c = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return x ** 2 + y ** 2 + z ** 2 < 0.7 ** 2


@pytest.mark.parametrize("case", list(PIPELINES))
def test_one_train_step_matches_reference(case, monkeypatch):
    from tnerf.train import RayBatch as JBatch, create_optimizer, make_train_step as j_make
    from tnerf.train import init_train_state as j_init
    from tnerf.train_loop import build_field, build_renderer as j_build
    from tnerf_torch import sampling
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.train import RayBatch, init_train_state, make_train_step
    from tnerf_torch.train_loop import build_renderer

    jcfg, cfg = _cfgs(PIPELINES[case])
    B = 128
    o, d, gt = _rays(B)
    # the intervals step walks an all-occupied grid (training's start), where
    # the skipping walk fills the reference's slots one for one and so meets
    # the same uniforms; the march steps see a pruned grid
    occ = np.ones((16,) * 3, bool) if case == "grid_intervals" else _ball()
    jfield = build_field(jcfg)
    joptimizer = create_optimizer(jcfg.train)
    jrenderer = j_build(jcfg, jfield)
    jstate = j_init(jfield, joptimizer, 0)
    key = jax.random.PRNGKey(7)
    jrays = JRays(jnp.asarray(o), jnp.asarray(d), j_tp(jnp.asarray(d)))
    weight = jcfg.train.distortion_weight / (jcfg.sampler.far - jcfg.sampler.near)

    def jloss(p):
        res = jrenderer(p, jrays, key, jnp.asarray(occ))
        return jnp.mean(jnp.square(res.rgb - gt)) + weight * jnp.mean(res.distortion)

    jl, jgrads = jax.value_and_grad(jloss)(jstate.params)
    _, jaux = j_make(jrenderer, joptimizer, distortion=weight)(
        jstate, JBatch(jrays, jnp.asarray(gt)), key, jnp.asarray(occ))

    # the port draws what the reference's key draws
    monkeypatch.setattr(sampling, "draw_uniform", lambda gen, shape, device: torch.from_numpy(
        np.array(jax.random.uniform(key, tuple(shape), jnp.float32))))
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jstate.params)))
    state = init_train_state(field, cfg.train)
    renderer = build_renderer(cfg, for_eval=False)
    td = torch.from_numpy(d)
    batch = RayBatch(Rays(torch.from_numpy(o), td, viewdirs_to_thetaphi(td)), torch.from_numpy(gt))
    tocc = torch.from_numpy(occ)
    params = state.params
    gen = torch.Generator()
    res = renderer(params, batch.rays, tocc, gen)
    loss = torch.mean(torch.square(res.rgb - batch.gt_rgb)) + weight * res.distortion.mean()
    got = float(loss.detach())
    assert abs(got - float(jl)) <= 1e-4 * abs(float(jl)), (got, float(jl))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for l in range(3):
        for kind in ("w", "b"):
            a, b = grads[f"trunk.{kind}.{l}"].numpy(), np.asarray(jgrads["trunk"][kind][l])
            assert np.abs(b).max() > 0
            rel = np.abs(a - b).max() / np.abs(b).max()
            assert rel <= 3e-2, (kind, l, rel)
    aux = make_train_step(renderer, distortion=weight)(state, batch, tocc, gen)
    assert state.step == 1
    assert abs(float(aux["loss"]) - float(jaux["loss"])) <= 1e-4 * abs(float(jaux["loss"]))
    assert abs(float(aux["psnr"]) - float(jaux["psnr"])) < 1e-3
    assert abs(float(aux["acc_mean"]) - float(jaux["acc_mean"])) < 1e-3
    assert ("distortion" in aux) == (weight > 0)
    if weight > 0:
        assert float(aux["distortion"]) > 0
        assert abs(float(aux["distortion"]) - float(jaux["distortion"])) < 1e-4


CLI_STEPS = 30


@pytest.fixture(scope="module", params=["grid_march", "grid_intervals", "uniform"])
def trained(request, tmp_path_factory):
    """(pipeline, out_dir) of `cli train --device cpu` for CLI_STEPS steps."""
    from tnerf_torch.cli import main

    out = str(tmp_path_factory.mktemp(request.param))
    argv = ["train", "--device", "cpu", "--out", out]
    for ov in SMALL + [f"render.pipeline={request.param}", f"train.steps={CLI_STEPS}",
                       "train.lr=5e-3"]:
        argv += ["-o", ov]
    assert main(argv) == 0
    return request.param, out


def test_cli_train_on_cpu(trained):
    from tnerf_torch.utils.checkpoint import load_train_checkpoint

    pipeline, out = trained
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == CLI_STEPS // 5 + 1 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < 0.85 * np.mean(losses[:2]), losses
    assert all(r["skipped_steps"] == 0 for r in recs if "loss" in r)
    final = [r for r in recs if "psnr_test" in r][-1]
    assert final["step"] == CLI_STEPS and final["n_views_test"] == 2.0
    assert final["psnr_test"] > 8.0
    step, params, opt, occ = load_train_checkpoint(os.path.join(out, "checkpoints"), "cpu")
    assert step == CLI_STEPS and int(opt["count"]) == CLI_STEPS
    if pipeline == "uniform":
        assert occ is None and not any("occupancy_frac" in r for r in recs)
    else:
        assert int(occ.step) == 6 and occ.bitfield.shape == (16, 16, 16)  # steps 8, 12, ..., 28
    assert os.path.exists(os.path.join(out, f"renders_{CLI_STEPS}", "test_001.png"))


def test_cli_eval_on_cpu(trained, capsys):
    from tnerf_torch.cli import main

    pipeline, out = trained
    capsys.readouterr()
    rc = main(["eval", "--device", "cpu", "--config", os.path.join(out, "config.json"),
               "--checkpoint", os.path.join(out, "checkpoints")])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out)
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    final = [r for r in recs if "psnr_test" in r][-1]
    # the served checkpoint is the one the run's own last eval rendered
    assert abs(printed["psnr_test"] - final["psnr_test"]) < 1e-3
    assert printed["n_views_test"] == 2.0 and printed["n_views_val"] == 1.0


def test_port_checkpoint_restores_into_the_reference(trained):
    """Each pipeline's checkpoint is in the reference's layout: (TrainState,
    OccupancyGridState) for the grid pipelines, the TrainState alone for
    the uniform pipeline, which keeps no occupancy grid."""
    from tnerf.grid.occupancy import init_occupancy
    from tnerf.train import create_optimizer, init_train_state
    from tnerf.train_loop import build_field
    from tnerf.utils.checkpoint import restore_checkpoint
    from tnerf_torch.utils.checkpoint import load_train_checkpoint

    pipeline, out = trained
    jcfg, _ = _cfgs([f"render.pipeline={pipeline}"])
    template = init_train_state(build_field(jcfg), create_optimizer(jcfg.train), 0)
    if pipeline != "uniform":
        template = (template, init_occupancy(jcfg.grid))
    ckpt = os.path.join(out, "checkpoints")
    meta = json.load(open(os.path.join(ckpt, "treedef.json")))
    assert meta["treedef"] == str(jax.tree_util.tree_structure(template))
    step, restored = restore_checkpoint(ckpt, template)
    jstate = restored if pipeline == "uniform" else restored[0]
    _, params, _, occ = load_train_checkpoint(ckpt, "cpu")
    assert step == CLI_STEPS and int(jstate.step) == CLI_STEPS
    for l in range(3):
        np.testing.assert_array_equal(jstate.params["trunk"]["w"][l], params[f"trunk.w.{l}"].numpy())
    if pipeline != "uniform":
        np.testing.assert_array_equal(restored[1].bitfield, occ.bitfield.numpy())


def test_prims_checkpoint_through_grid_march_matches_reference():
    from tnerf.cameras import camera_rays as j_camera_rays
    from tnerf.cli import _build_restore
    from tnerf.render.renderer import render_image as j_render_image
    from tnerf.train_loop import build_renderer as j_build
    from tnerf_torch.cameras import camera_rays
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.render.renderer import render_image
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    ov = ["render.pipeline=grid_march", "sampler.samples_per_ray=96", "sampler.tighten_res=16",
          "sampler.occupancy_mask_res=16", "render.ray_compact=false", "render.compact=false",
          "scene.proc_width=32", "scene.proc_height=32", "scene.proc_n_test=2",
          "scene.proc_n_val=1"]
    path = os.path.join(RUN, "config.json")
    jcfg = JConfig.from_json_file(path).apply_overrides(ov)
    cfg = Config.from_json_file(path).apply_overrides(ov)
    ckpt = os.path.join(RUN, "checkpoints")
    ds = load_data("procedural", "prims", splits=("test",), proc=scene_proc_kwargs(cfg.scene),
                   device="cpu")["test"]
    jfield, jstate, jocc, step, err = _build_restore(jcfg, ckpt, 0)
    assert err is None and step == 1500
    jrays = j_camera_rays(jnp.asarray(ds.poses[0]), 32, 32, ds.camera, 1.0)
    jres = j_render_image(j_build(jcfg, jfield, for_eval=True), jstate.params, jrays,
                          chunk_size=1024, occupancy=jocc.bitfield)
    _, params, occ = load_jax_checkpoint(ckpt, device="cpu")
    rays = camera_rays(ds.poses[0], 32, 32, ds.camera, 1.0, device="cpu")
    res = render_image(build_renderer(cfg), params, rays, chunk_size=1024, occupancy=occ.bitfield)
    assert float(res.acc.max()) > 0.9 and float(res.acc.min()) < 1e-3
    np.testing.assert_allclose(res.rgb.numpy(), np.asarray(jres.rgb), atol=5e-3, rtol=0)
    np.testing.assert_allclose(res.acc.numpy(), np.asarray(jres.acc), atol=5e-3, rtol=0)


@pytest.mark.parametrize("placement", ["uniform", "occupancy_cdf"])
def test_dense_to_compact_switch(placement, tmp_path, monkeypatch):
    """render.compact on grid_march: training and eval march densely until
    an occupancy update finds the occupied share under 0.6 x
    render.compact_fraction, then through the compacted renderer.  A
    density threshold no cell reaches empties the grid at the first update
    (step 8), so the switch must fall there."""
    from tnerf_torch import train_loop

    calls = []
    make = train_loop.make_grid_renderer

    def tagged(*a, compact, **kw):
        render = make(*a, compact=compact, **kw)

        def wrapped(params, rays, occupancy=None, generator=None):
            calls.append(("compact" if compact else "dense",
                          "train" if generator is not None else "eval"))
            return render(params, rays, occupancy, generator)

        return wrapped

    monkeypatch.setattr(train_loop, "make_grid_renderer", tagged)
    _, cfg = _cfgs(["render.pipeline=grid_march", "render.compact=true",
                    "render.compact_fraction=0.5", f"sampler.placement={placement}",
                    "grid.density_threshold=1e6", "train.steps=12", "train.eval_every=6",
                    f"logging.out_dir={tmp_path}"])
    train_loop.run_training(cfg, device="cpu")
    train = [kind for kind, use in calls if use == "train"]
    assert train == ["dense"] * 9 + ["compact"] * 3  # the update after step 8 switches
    evals = [kind for kind, use in calls if use == "eval"]
    n_mid = evals.index("compact")
    assert n_mid > 0 and set(evals[:n_mid]) == {"dense"} and set(evals[n_mid:]) == {"compact"}
    # without render.compact nothing switches and nothing reads the share
    calls.clear()
    train_loop.run_training(cfg.apply_overrides(["render.compact=false", "train.steps=10",
                                                 "train.eval_every=0"]), device="cpu")
    assert {kind for kind, _ in calls} == {"dense"}


def test_unfused_pipelines_refuse_what_the_reference_refuses():
    from tnerf_torch.train_loop import build_renderer, validate_ported

    _, cfg = _cfgs()
    for p in ("grid_march", "grid_intervals", "uniform"):
        c = cfg.apply_overrides([f"render.pipeline={p}"])
        assert callable(build_renderer(c)) and callable(build_renderer(c, for_eval=False))
        validate_ported(c.apply_overrides(["train.distortion_weight=0.01"]), for_eval=False)
    for p in ("grid_intervals", "uniform"):
        with pytest.raises(ValueError, match="needs render.pipeline='grid_march' or 'fused'"):
            build_renderer(cfg.apply_overrides([f"render.pipeline={p}",
                                                "sampler.placement=occupancy_cdf"]))
    validate_ported(cfg.apply_overrides(["render.pipeline=grid_march",
                                         "sampler.placement=density_cdf"]), for_eval=False)
    with pytest.raises(ValueError, match="unknown render pipeline"):
        build_renderer(cfg.apply_overrides(["render.pipeline=raster"]))
    with pytest.raises(ValueError, match="needs per-sample compositing"):
        validate_ported(cfg.apply_overrides(["render.pipeline=fused",
                                             "train.distortion_weight=0.01"]), for_eval=False)
    with pytest.raises(ValueError, match="does not compose with render.compact"):
        validate_ported(cfg.apply_overrides(["render.pipeline=grid_march", "render.compact=true",
                                             "train.distortion_weight=0.01"]), for_eval=False)
    # the table priors are ported: TV on a field without a triplane is the
    # reference's own refusal (`tnerf/train_loop.py:775`)
    with pytest.raises(ValueError, match="table_tv_weight is the triplane family's"):
        validate_ported(cfg.apply_overrides(["render.pipeline=grid_march",
                                             "train.table_tv_weight=0.1"]), for_eval=False)
    # the BARF window and remat are ported: they validate on grid_march; the
    # window on the fused pipeline is the reference's own refusal
    # (`tnerf/train_loop.py:675`)
    for ov in ("train.freq_anneal_steps=100", "train.remat=true"):
        validate_ported(cfg.apply_overrides(["render.pipeline=grid_march", ov]), for_eval=False)
    with pytest.raises(ValueError, match="train.freq_anneal_steps needs the XLA field path"):
        validate_ported(cfg.apply_overrides(["render.pipeline=fused",
                                             "train.freq_anneal_steps=100"]), for_eval=False)


def test_density_payload_has_the_dense_start():
    from tnerf.grid.occupancy import init_occupancy as j_init, renderer_payload as j_payload
    from tnerf_torch.grid.occupancy import OccupancyGridState, init_occupancy, renderer_payload

    jcfg, cfg = _cfgs(["sampler.placement=density_cdf"])
    start = renderer_payload(init_occupancy(cfg.grid), cfg.sampler, cfg.grid)
    np.testing.assert_array_equal(start.numpy(),
                                  np.asarray(j_payload(j_init(jcfg.grid), jcfg.sampler, jcfg.grid)))
    assert start.dtype == torch.float32 and bool((start > cfg.grid.density_threshold).all())
    ema = torch.rand(16, 16, 16)
    later = OccupancyGridState(ema, ema > 0.01, torch.tensor(3, dtype=torch.int32))
    assert torch.equal(renderer_payload(later, cfg.sampler, cfg.grid), ema)
    _, plain = _cfgs()
    assert renderer_payload(later, plain.sampler, plain.grid).dtype == torch.bool
    assert renderer_payload(None, cfg.sampler, cfg.grid) is None


def test_new_modules_import_neither_jax_nor_tnerf():
    code = (
        "import importlib, sys\n"
        "for m in ('grid.dda', 'grid.traversal', 'render.grid_renderer', 'render.renderer',\n"
        "          'sampling', 'train_loop', 'cli'):\n"
        "    importlib.import_module('tnerf_torch.' + m)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'jaxlib', 'tnerf')\n"
        "             or k.startswith(('jax.', 'jaxlib.', 'tnerf.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
