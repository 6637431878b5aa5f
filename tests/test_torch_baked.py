"""The baked renderer, against the reference package on the CPU:

- `BakedField.apply` in each lookup mode (nearest, trilinear,
  trilinear_brick) and sigma space (linear, log1p), on float32 and
  bf16-rounded tables, at positions inside, on and outside the box: within
  1e-6 (the reference's jitted arithmetic against eager torch);
- `bake_positions` and `brick_pack` equal;
- `bake_field` of carried weights (a 3 x 32 float32 frequency MLP) with and
  without the occupancy's dilation, both view modes and sigma spaces:
  within 1e-5 (float32 sums in another order);
- the baked render of tests/test_baked.py's analytic field against the
  reference's baked render, each mode: within 1e-4;
- `cli bake --device cpu --eval` of one checkpoint in both packages (a
  tiny grid_march run trained by the reference): the npz's keys, dtypes
  and bake_res the reference's, its tables within float16 rounding, and
  baked_parity.json with the reference's keys, its PSNRs within 0.05 dB.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.config import Config as JConfig, GridConfig as JGrid
from tnerf.render import baked as jb
from tnerf_torch.config import Config, GridConfig
from tnerf_torch.render import baked as tb

torch.set_num_threads(2)
AABB = dict(aabb_min=(-1.2, -1.0, -0.9), aabb_max=(1.0, 1.1, 0.9))


def _positions(rng, n, grid):
    lo, hi = np.asarray(grid.aabb_min), np.asarray(grid.aabb_max)
    p = rng.uniform(lo - 0.1, hi + 0.1, (n, 3))
    p[:8] = lo  # the corners and faces of the box
    p[8:16] = hi
    p[16:24, 0] = lo[0]
    return p.astype(np.float32)


@pytest.mark.parametrize("mode", tb.MODES)
@pytest.mark.parametrize("sigma_space", ["linear", "log1p"])
@pytest.mark.parametrize("bf16", [False, True])
def test_baked_field_apply_matches_reference(mode, sigma_space, bf16):
    R = 9
    g, jg = GridConfig(resolution=16, **AABB), JGrid(resolution=16, **AABB)
    rng = np.random.default_rng([tb.MODES.index(mode), sigma_space == "log1p", bf16])
    table = rng.normal(0.5, 0.6, (R ** 3, 4)).astype(np.float32)
    jt = jnp.asarray(table, jnp.bfloat16 if bf16 else jnp.float32)
    tt = torch.from_numpy(table).to(torch.bfloat16 if bf16 else torch.float32)
    if mode == "trilinear_brick":
        jt, tt = jb.brick_pack(jt, R), tb.brick_pack(tt, R)
    p = _positions(rng, 300, g)
    jf = jb.BakedField(bake_res=R, grid=jg, mode=mode, sigma_space=sigma_space)
    want = jax.jit(lambda t, x: jf.apply({"table": t}, x))(jt, jnp.asarray(p))
    got = tb.BakedField(bake_res=R, grid=g, mode=mode, sigma_space=sigma_space).apply(
        {"table": tt}, torch.from_numpy(p))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("R", [2, 5, 8])
def test_brick_pack_and_positions_match_reference(R):
    g, jg = GridConfig(**AABB), JGrid(**AABB)
    np.testing.assert_array_equal(tb.bake_positions(R, g).numpy(),
                                  np.asarray(jb.bake_positions(R, jg)))
    table = np.random.default_rng(R).normal(0, 1, (R ** 3, 4)).astype(np.float32)
    for td, jd in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tb.brick_pack(torch.from_numpy(table).to(td), R)
        want = jb.brick_pack(jnp.asarray(table, jd), R)
        assert got.dtype == td and tuple(got.shape) == want.shape == (R ** 3, 32)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _carried_field():
    from tnerf.fields.nerf_field import NeRFField as JField
    from tnerf_torch.fields.nerf_field import apply_field
    from tnerf_torch.utils.checkpoint import params_from_jax

    ov = ["field_.hidden_width=32", "field_.hidden_layers=3", "field_.n_frequencies=6",
          "field_.compute_dtype=float32", "grid.resolution=16",
          "grid.aabb_min=[-1.2,-1.0,-0.9]", "grid.aabb_max=[1.0,1.1,0.9]"]
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    jfield = JField(jcfg.field_, jcfg.grid)
    jparams = jfield.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jfield, jparams, params, \
        lambda p, x, v: apply_field(p, cfg.field_, cfg.grid, x, v)


@pytest.mark.parametrize("view_mode", ["radial_in", "fixed_z"])
@pytest.mark.parametrize("sigma_space", ["linear", "log1p"])
def test_bake_field_matches_reference(view_mode, sigma_space):
    jcfg, cfg, jfield, jparams, params, field_fn = _carried_field()
    occ = np.random.default_rng(3).random((16, 16, 16)) < 0.05
    occ[0, 5, 5] = occ[15, 15, 15] = True  # at the box's faces: clamped, not wrapped
    R = 20
    for o in (None, occ):
        want = np.asarray(jb.bake_field(jfield, jparams, jcfg.grid, bake_res=R, chunk=2000,
                                        view_mode=view_mode, sigma_space=sigma_space,
                                        occupancy=None if o is None else jnp.asarray(o)))
        got = tb.bake_field(field_fn, params, cfg.grid, bake_res=R, chunk=3000,
                            view_mode=view_mode, sigma_space=sigma_space,
                            occupancy=None if o is None else torch.from_numpy(o)).numpy()
        assert got.shape == want.shape == (R ** 3, 4)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        if o is not None:  # the same vertices zeroed
            np.testing.assert_array_equal(got.any(axis=1), want.any(axis=1))
            assert 0 < got.any(axis=1).mean() < 0.9


@pytest.mark.parametrize("mode", tb.MODES)
def test_baked_render_of_the_analytic_field_matches_reference(mode):
    """tests/test_baked.py's oracle in both packages: the analytic field
    baked at 64^3 with the analytic occupancy and rendered through the
    march renderer."""
    from tnerf.cameras import Rays as JRays, viewdirs_to_thetaphi as jtp
    from tnerf.data.procedural import analytic_field as janalytic
    from tnerf.grid.occupancy import cell_centers
    from tnerf_torch.cameras import Rays
    from tnerf_torch.data.procedural import analytic_field

    ov = ["grid.resolution=32", "scene.scene_scale=1.0", "sampler.samples_per_ray=64",
          "sampler.near=2.0", "sampler.far=5.5", "sampler.tighten=false",
          "sampler.occupancy_mask_res=0", "render.pipeline=grid_march",
          "render.ray_compact=false", "render.compact=false"]
    jcfg, cfg = JConfig().apply_overrides(ov), Config().apply_overrides(ov)
    _, sigma = janalytic(cell_centers(jcfg.grid).reshape(-1, 3))
    occ = (np.asarray(sigma) > 0.5).reshape(32, 32, 32)

    class _Analytic:
        def apply(self, params, positions, viewdirs=None):
            return janalytic(positions)

    jtable = jb.bake_field(_Analytic(), {}, jcfg.grid, bake_res=64, occupancy=jnp.asarray(occ))
    table = tb.bake_field(lambda p, x, v: analytic_field(x), {}, cfg.grid, bake_res=64,
                          occupancy=torch.from_numpy(occ))
    np.testing.assert_allclose(table.numpy(), np.asarray(jtable), atol=1e-5, rtol=0)
    # the renderers on one table (the two bakes' bf16 roundings of values
    # 1e-6 apart may fall on either side of a tie)
    jrend = jb.make_baked_renderer(jtable, 64, jcfg.grid, jcfg.sampler, jcfg.render, mode=mode)
    rend = tb.make_baked_renderer(torch.from_numpy(np.asarray(jtable)), 64, cfg.grid,
                                  cfg.sampler, cfg.render, mode=mode)
    np.testing.assert_array_equal(rend.params["table"].float().numpy(),
                                  np.asarray(jrend.params["table"], np.float32))
    rng = np.random.default_rng(3)
    o = rng.uniform(-1, 1, (128, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0).astype(np.float32)
    d = (-o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    want = jrend(jrend.params, JRays(jnp.asarray(o), jnp.asarray(d), jtp(jnp.asarray(d))),
                 None, jnp.asarray(occ))
    td = torch.from_numpy(d)
    got = rend(rend.params, Rays(torch.from_numpy(o), td, tb.viewdirs_to_thetaphi(td)),
               torch.from_numpy(occ))
    for k in ("rgb", "acc", "depth"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   atol=1e-4 * (5.5 if k == "depth" else 1.0), rtol=0)
    assert float(got.acc.max()) > 0.5


BAKE_RUN = ["scene.kind=procedural", "scene.name=prims", "scene.scene_scale=1.0",
            "scene.proc_width=24", "scene.proc_height=24", "scene.proc_n_train=4",
            "scene.proc_n_val=0", "scene.proc_n_test=2", "render.pipeline=grid_march",
            "render.ray_compact=false", "render.compact=false", "sampler.samples_per_ray=16",
            "sampler.near=2.0", "sampler.far=5.5", "field_.hidden_width=16",
            "field_.hidden_layers=1", "field_.n_frequencies=2", "grid.resolution=8",
            "grid.warmup_steps=4", "grid.update_every=4", "train.batch_size=128",
            "train.steps=24", "train.eval_every=0", "train.checkpoint_every=0",
            "train.log_every=8", "render.chunk_size=576"]


def test_cli_bake_eval_matches_reference(tmp_path):
    from tnerf.cli import main as jmain
    from tnerf_torch.cli import main

    run = str(tmp_path / "run")
    ov = []
    for o in BAKE_RUN:
        ov += ["-o", o]
    assert jmain(["train", *ov, "-o", f"logging.out_dir={run}"]) == 0
    ck = ["--checkpoint", os.path.join(run, "checkpoints")]
    arts = {}
    for tag, fn, extra in (("ref", jmain, []), ("port", main, ["--device", "cpu"])):
        out = str(tmp_path / tag)
        assert fn(["bake", *ov, *ck, *extra, "--bake-res", "16", "--eval",
                   "-o", f"logging.out_dir={out}"]) == 0
        with np.load(os.path.join(out, "baked", "baked_16.npz")) as z:
            arts[tag] = (sorted(z.files), z["table"], int(z["bake_res"]),
                         json.load(open(os.path.join(out, "baked_parity.json"))))
    (jkeys, jtable, jres, jart), (keys, table, res, art) = arts["ref"], arts["port"]
    assert keys == jkeys == ["bake_res", "table"] and res == jres == 16
    assert table.dtype == jtable.dtype == np.float16 and table.shape == jtable.shape
    # one float16 step of the largest entries, after bf16-activation fields
    np.testing.assert_allclose(table.astype(np.float32), jtable.astype(np.float32),
                               atol=2e-2, rtol=0)
    assert sorted(art) == sorted(jart)
    for k in ("baked", "march"):
        assert sorted(art[k]) == sorted(jart[k])
        assert abs(art[k]["psnr_test"] - jart[k]["psnr_test"]) <= 0.05, (k, art, jart)
        assert art[k]["n_views_test"] == jart[k]["n_views_test"] == 2
    assert art["bake_res"] == 16 and art["mode"] == "trilinear_brick"
    assert art["checkpoint_step"] == jart["checkpoint_step"] == 24
    assert art["parity_db"] == round(abs(art["march"]["psnr_test"] - art["baked"]["psnr_test"]),
                                     4)


def test_unknown_lookup_mode_is_refused():
    with pytest.raises(ValueError, match="unknown bake lookup mode 'cubic'"):
        tb.BakedField(bake_res=4, grid=GridConfig(), mode="cubic")
