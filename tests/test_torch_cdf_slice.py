"""The CDF-placement and ray-compaction slice as a whole against the
reference package, on the CPU at a small size (2 hidden layers x 32 wide,
padded to the kernel's 128 lanes as `pack_params_f32` does, 4 frequencies,
a 16^3 grid, 16 samples per ray, 16 CDF bins, 256 rays; the reference runs
its Pallas kernels in interpret mode):

- the port's renderer against `make_fused_pipeline_renderer_v2` for CDF
  placement, CDF placement with ray compaction and uniform placement with
  ray compaction, the same parameters through `params_from_jax`, eval mode
  (midpoint strata, no jitter): rgb and acc within 5e-3 (bf16 activations
  rounded in another order);
- rays beyond the compaction capacity render as background, in both;
- the training renderer jitters only where it is given a generator and
  never compacts; a few CDF training steps through `cli train --device cpu`
  reduce the loss; `cli eval` serves CDF placement with ray compaction and
  warns when the keep fraction exceeds the capacity;
- the reference's two `ValueError`s.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.cameras import Rays as JRays
from tnerf.cameras import viewdirs_to_thetaphi as j_tp
from tnerf.config import Config as JConfig
from tnerf.render.pallas_fused2 import make_fused_pipeline_renderer_v2
from tnerf_torch.cameras import Rays, viewdirs_to_thetaphi
from tnerf_torch.config import Config
from tnerf_torch.train_loop import build_renderer
from tnerf_torch.utils.checkpoint import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "suite_rehearsal", "prims")
ATOL = 5e-3
SMALL = ["sampler.samples_per_ray=16", "sampler.cdf_bins=16", "sampler.near=2.0",
         "sampler.far=5.5", "field_.hidden_width=32", "field_.hidden_layers=2",
         "field_.n_frequencies=4", "grid.resolution=16", "scene.scene_scale=1.0",
         "scene.kind=procedural", "scene.name=prims",
         "render.fused_rpc=1", "render.fused_train_rpc=1", "render.fused_tighten=true"]
MODES = {
    "cdf": ["sampler.placement=occupancy_cdf", "render.ray_compact=false"],
    "cdf_compact": ["sampler.placement=occupancy_cdf", "render.ray_compact=true",
                    "render.ray_compact_fraction=0.875"],
    "uniform_compact": ["sampler.placement=uniform", "render.ray_compact=true",
                        "render.ray_compact_fraction=0.875"],
}
B = 256  # a multiple of the reference's 32-row tile, so both pad nothing


def _cfgs(extra):
    ov = SMALL + list(extra)
    return JConfig().apply_overrides(ov), Config().apply_overrides(ov)


def _rays(seed=3):
    """Rays from radius 3 towards the box; a third of them miss the blob."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (B, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0).astype(np.float32)
    d = -o / 3.0 + rng.uniform(-0.25, 0.25, (B, 3)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _occupancy(res=16):
    """A ball of radius 0.55 and a detached slab."""
    c = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    return (x ** 2 + y ** 2 + z ** 2 < 0.55 ** 2) | ((np.abs(x - 0.7) < 0.1) & (np.abs(y) < 0.5))


def _params(jcfg):
    """The reference field's initial parameters with a denser head, so that
    rays through the ball reach acc ~ 1 and colours differ."""
    from tnerf.train_loop import build_field

    params = jax.tree.map(np.asarray, build_field(jcfg).init(jax.random.PRNGKey(0)))
    params["trunk"]["w"][-1] = params["trunk"]["w"][-1] * 6.0
    params["trunk"]["b"][-1] = params["trunk"]["b"][-1] + np.asarray([0, 0, 0, 3.0], np.float32)
    return params


def _both(mode, extra=()):
    """(reference RenderResult, port RenderResult) of the same rays."""
    jcfg, cfg = _cfgs(MODES[mode] + list(extra))
    o, d = _rays()
    occ = _occupancy()
    jparams = _params(jcfg)
    jrender = make_fused_pipeline_renderer_v2(
        jcfg.field_, jcfg.grid, jcfg.sampler, jcfg.render, interpret=True, rpc=1, tighten=True,
        ray_compact=jcfg.render.ray_compact)
    jres = jrender(jax.tree.map(jnp.asarray, jparams),
                   JRays(jnp.asarray(o), jnp.asarray(d), j_tp(jnp.asarray(d))), None,
                   jnp.asarray(occ))
    td = torch.from_numpy(d)
    with torch.no_grad():
        res = build_renderer(cfg)(params_from_jax(jparams),
                                  Rays(torch.from_numpy(o), td, viewdirs_to_thetaphi(td)),
                                  torch.from_numpy(occ))
    return jres, res


@pytest.mark.parametrize("mode", list(MODES))
def test_slice_matches_reference_renderer(mode):
    jres, res = _both(mode)
    acc = res.acc.numpy()
    assert 0.2 < (acc > 0.5).mean() < 0.9 and (acc == 0).mean() > 0.1  # object and background
    assert res.rgb.shape == (B, 3) and np.isfinite(res.rgb.numpy()).all()
    np.testing.assert_allclose(res.rgb.numpy(), np.asarray(jres.rgb), atol=ATOL, rtol=0)
    np.testing.assert_allclose(acc, np.asarray(jres.acc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(res.depth.numpy(), np.asarray(jres.depth), atol=4 * ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["cdf_compact", "uniform_compact"])
def test_compaction_changes_nothing_within_capacity(mode):
    """Kept rays are the same rows through the same arithmetic, dropped
    rays are background in both: bit-equal on the CPU."""
    _, on = _both(mode)
    _, off = _both(mode, ["render.ray_compact=false"])
    assert float((off.acc > 0).float().mean()) < 0.875
    assert torch.equal(on.rgb, off.rgb) and torch.equal(on.acc, off.acc)


@pytest.mark.parametrize("mode", ["cdf_compact", "uniform_compact"])
def test_over_capacity_rays_render_as_background(mode):
    """capacity 0.125 x 256 = 32 rays (one reference tile): the first 32 kept
    rays are rendered, every later one reads back as background (white)."""
    _, full = _both(mode)
    jres, res = _both(mode, ["render.ray_compact_fraction=0.125"])
    kept = full.acc.numpy() > 0
    assert kept.sum() > 64
    rank = np.cumsum(kept) - 1
    over = kept & (rank >= 32)
    acc = res.acc.numpy()
    assert np.all(acc[over] == 0.0) and np.all(res.rgb.numpy()[over] == 1.0)
    inside = kept & (rank < 24)  # the keep rule keeps a few rays that end with acc = 0
    np.testing.assert_array_equal(acc[inside], full.acc.numpy()[inside])
    np.testing.assert_allclose(acc, np.asarray(jres.acc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(res.rgb.numpy(), np.asarray(jres.rgb), atol=ATOL, rtol=0)


def test_training_renderer_jitters_with_a_generator_and_never_compacts():
    _, cfg = _cfgs(MODES["cdf_compact"])
    o, d = _rays()
    td = torch.from_numpy(d)
    rays = Rays(torch.from_numpy(o), td, viewdirs_to_thetaphi(td))
    occ = torch.from_numpy(_occupancy())
    params = params_from_jax(_params(_cfgs(MODES["cdf"])[0]))
    train = build_renderer(cfg, for_eval=False)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    *args, placed = train.kernel_inputs(params, rays, occ)
    assert args[2].shape[0] == B  # every ray is there: training does not compact
    *_, again = train.kernel_inputs(params, rays, occ)
    *_, j1 = train.kernel_inputs(params, rays, occ, gen(1))
    *_, j1b = train.kernel_inputs(params, rays, occ, gen(1))
    *_, j2 = train.kernel_inputs(params, rays, occ, gen(2))
    assert torch.equal(placed["ts"], again["ts"]) and torch.equal(j1["ts"], j1b["ts"])
    assert not torch.equal(j1["ts"], placed["ts"]) and not torch.equal(j1["ts"], j2["ts"])
    assert torch.all(j1["ts"][:, 1:] >= j1["ts"][:, :-1])
    *eval_args, _ = build_renderer(cfg).kernel_inputs(params, rays, occ)
    assert eval_args[2].shape[0] == int(B * cfg.render.ray_compact_fraction)
    # gradients reach every parameter through the per-sample backward
    loss = train(params, rays, occ, gen(3)).rgb.square().mean()
    leaves = [p.requires_grad_() for p in params.values()]
    loss = train(params, rays, occ, gen(3)).rgb.square().mean()
    for name, g in zip(params, torch.autograd.grad(loss, leaves)):
        assert float(g.abs().max()) > 0, name
    with pytest.raises(ValueError, match="needs an occupancy grid"):
        train(params, rays, None)


@pytest.mark.parametrize("override,message", [
    ("sampler.placement=density_cdf", "density_cdf"),
    ("render.fused_tighten=false", "needs render.fused_tighten=true"),
])
def test_reference_value_errors(override, message):
    from tnerf_torch.render.fused import make_fused_renderer
    from tnerf_torch.train_loop import validate_ported

    _, cfg = _cfgs(MODES["cdf"] + [override])
    for for_eval in (True, False):
        with pytest.raises(ValueError, match=message):
            build_renderer(cfg, for_eval=for_eval)
        with pytest.raises(ValueError, match=message):
            validate_ported(cfg, for_eval=for_eval)
    with pytest.raises(ValueError):
        make_fused_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render,
                            tighten=cfg.render.fused_tighten)


@pytest.mark.parametrize("override", ["sampler.placement=occupancy_cdf", "render.ray_compact=true"])
def test_cdf_placement_and_ray_compaction_are_no_longer_refused(override):
    cfg = Config.from_json_file(os.path.join(RUN, "config.json")).apply_overrides([override])
    assert callable(build_renderer(cfg)) and callable(build_renderer(cfg, for_eval=False))


def test_pooling_resolutions_and_guard_match_reference():
    from tnerf.cli import _ray_compact_guard as j_guard
    from tnerf.render.pallas_fused2 import select_bin_pool_res as j_pool
    from tnerf_torch.cli import _ray_compact_guard
    from tnerf_torch.render.fused import select_bin_pool_res

    for res in (8, 16, 24, 48, 64, 96, 128):
        assert select_bin_pool_res(res) == j_pool(res)
    for extra in (MODES["cdf_compact"], MODES["uniform_compact"], MODES["cdf"],
                  MODES["uniform_compact"] + ["render.fused_tighten=false"],
                  MODES["uniform_compact"] + ["grid.resolution=64", "render.fused_coarse_res=16"]):
        jcfg, cfg = _cfgs(extra)
        on, pool, n_mid = _ray_compact_guard(cfg)
        assert (on, pool) == j_guard(jcfg)
        if on:
            assert n_mid == (16 if cfg.sampler.placement == "uniform" else cfg.sampler.cdf_bins)


def test_keep_fraction_is_the_renderers_keep_rule():
    from tnerf_torch.cli import _ray_compact_guard, ray_keep_fraction

    o, d = _rays()
    td = torch.from_numpy(d)
    rays = Rays(torch.from_numpy(o), td, viewdirs_to_thetaphi(td))
    occ = torch.from_numpy(_occupancy())
    for mode in ("cdf_compact", "uniform_compact"):
        _, cfg = _cfgs(MODES[mode])
        _, pool, n_mid = _ray_compact_guard(cfg)
        kf = ray_keep_fraction(rays, occ, cfg, pool, n_mid)
        _, full = _both(mode)
        # every ray that ends with acc > 0 was kept; a kept ray may still end empty
        assert 0.3 < kf < 0.9 and kf >= float((full.acc > 0).float().mean())


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`cli train --device cpu` under CDF placement for 30 steps; the run's out_dir."""
    from tnerf_torch.cli import main

    out = str(tmp_path_factory.mktemp("train_cdf"))
    argv = ["train", "--device", "cpu", "--out", out]
    for ov in SMALL + MODES["cdf_compact"] + [
            "scene.proc_width=32", "scene.proc_height=32", "scene.proc_n_train=6",
            "scene.proc_n_val=1", "scene.proc_n_test=2", "sampler.samples_per_ray=32", "grid.warmup_steps=8",
            "grid.update_every=4", "render.chunk_size=1024", "train.batch_size=512",
            "render.ray_compact_fraction=1.0",  # the young occupancy grid keeps nearly every ray
            "train.lr=5e-3", "train.lr_final_fraction=0.1", "train.steps=30",
            "train.eval_every=0", "train.log_every=5", "train.checkpoint_every=0"]:
        argv += ["-o", ov]
    assert main(argv) == 0
    return out


def test_cli_train_cdf_on_cpu(trained):
    recs = [json.loads(line) for line in open(os.path.join(trained, "metrics.jsonl"))]
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 7 and all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < 0.8 * np.mean(losses[:2]), losses
    assert all(r["skipped_steps"] == 0 for r in recs if "loss" in r)
    final = [r for r in recs if "psnr_test" in r][-1]
    assert final["step"] == 30 and final["n_views_test"] == 2.0 and final["psnr_test"] > 8.0


def test_cli_eval_cdf_with_compaction_and_capacity_warning(trained, capsys):
    """`cli eval` of the CDF-trained checkpoint with the run's own config
    (ray compaction on): the compacted eval is the run's uncompacted one;
    a capacity below the keep fraction is reported."""
    from tnerf_torch.cli import main

    recs = [json.loads(line) for line in open(os.path.join(trained, "metrics.jsonl"))]
    final = [r for r in recs if "psnr_test" in r][-1]
    argv = ["eval", "--device", "cpu", "--config", os.path.join(trained, "config.json")]
    assert main(argv) == 0
    cap = capsys.readouterr()
    assert "WARNING: ray-compaction" not in cap.err
    assert abs(json.loads(cap.out)["psnr_test"] - final["psnr_test"]) < 1e-6
    assert main(argv + ["-o", "render.ray_compact_fraction=0.02"]) == 0
    cap = capsys.readouterr()
    assert "WARNING: ray-compaction keep fraction" in cap.err
    assert "exceeds render.ray_compact_fraction=0.02" in cap.err
    assert json.loads(cap.out)["psnr_test"] < final["psnr_test"] - 1.0  # rays went missing


@pytest.mark.slow
def test_full_view_cdf_with_and_without_compaction():
    """A whole 64x64 view of the committed prims model under CDF placement,
    compacted and not."""
    from tnerf_torch.data.dataset import load_data
    from tnerf_torch.eval import render_dataset_view
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    path = os.path.join(RUN, "config.json")
    ds = load_data("procedural", "prims", splits=("test",),
                   proc=dict(width=64, height=64, n_test=1), device="cpu")["test"]
    _, params, occ = load_jax_checkpoint(os.path.join(RUN, "checkpoints"), device="cpu")
    views = []
    for compact in ("true", "false"):
        cfg = Config.from_json_file(path).apply_overrides(
            ["sampler.placement=occupancy_cdf", f"render.ray_compact={compact}"])
        views.append(render_dataset_view(build_renderer(cfg), params, ds, 0, cfg.scene.scene_scale,
                                         cfg.render.chunk_size, occupancy=occ.bitfield,
                                         device="cpu"))
    np.testing.assert_array_equal(views[0], views[1])
    assert views[0].std() > 0.05
