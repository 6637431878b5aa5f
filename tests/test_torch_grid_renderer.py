"""The unfused renderers and their parts against the reference package, on
the CPU at a small size (2 hidden layers x 32, 4 frequencies, a 16^3 grid,
16 samples per ray, 16 CDF bins, 4 samples per interval, 256 rays; where
the reference's eval reaches its Pallas tighten + mask kernel it runs in
interpret mode):

- `tightened_range`, `density_lookup`, `make_coarse_density`,
  `cdf_bin_weights` for both placements, `cdf_occupied_sample_fraction`:
  the same float32 arithmetic on the same inputs, within 1e-5 (sums in
  another order), support masks equal;
- `compacted_shade` against `composite(mask=...)` of the same samples
  (within 1e-6: the same field outputs, composited per ray in both) and
  against the reference's, including a capacity that overflows: the first
  `capacity` kept samples win, rays left with none are background;
- `make_grid_renderer` against the reference's at eval (midpoint samples)
  for intervals, march uniform, march occupancy-CDF with the kernel's bin
  mask folded in and with separate bin probes, march density-CDF, ray
  compaction, sample compaction; `make_uniform_renderer`: rgb and acc
  within 5e-3, depth within 2e-2 (bf16 activations; matrix products sum in
  another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.cameras import Rays as JRays
from tnerf.cameras import viewdirs_to_thetaphi as j_tp
from tnerf.config import Config as JConfig
from tnerf.render import grid_renderer as jgr
from tnerf.train_loop import build_field
from tnerf_torch.cameras import Rays, viewdirs_to_thetaphi
from tnerf_torch.config import Config
from tnerf_torch.render import grid_renderer as gr
from tnerf_torch.utils.checkpoint import params_from_jax

# The suite runs several workers side by side: more threads each only fight.
torch.set_num_threads(2)

ATOL, DEPTH_ATOL, PART_ATOL = 5e-3, 2e-2, 1e-5
SMALL = ["sampler.samples_per_ray=16", "sampler.cdf_bins=16", "sampler.near=2.0",
         "sampler.far=5.5", "sampler.samples_per_interval=4", "sampler.tighten_probes=32",
         "sampler.tighten_res=8", "sampler.occupancy_mask_res=8",
         "field_.hidden_width=32", "field_.hidden_layers=2", "field_.n_frequencies=4",
         "grid.resolution=16", "scene.scene_scale=1.0", "scene.kind=procedural",
         "scene.name=prims", "render.compact=false", "render.ray_compact=false"]
B = 256


def _cfgs(extra=()):
    ov = SMALL + list(extra)
    return JConfig().apply_overrides(ov), Config().apply_overrides(ov)


def _rays(seed=3, n=B):
    """Rays from radius 3 towards the box; a third of them miss the blob."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0).astype(np.float32)
    d = -o / 3.0 + rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _density(res=16):
    """A ball of radius 0.55 whose density falls off outwards, and a
    detached thin slab: (density EMA f32, bitfield at threshold 0.01)."""
    c = (np.arange(res) + 0.5) / res * 2.0 - 1.0
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    r2 = x ** 2 + y ** 2 + z ** 2
    dens = np.where(r2 < 0.55 ** 2, 8.0 * (1.0 - r2 / 0.55 ** 2) + 0.05, 0.0)
    dens = np.where((np.abs(x - 0.7) < 0.1) & (np.abs(y) < 0.5), 0.5, dens).astype(np.float32)
    return dens, dens > 0.01


def _params(jcfg):
    """The reference field's initial parameters with a denser head."""
    params = jax.tree.map(np.asarray, build_field(jcfg).init(jax.random.PRNGKey(0)))
    params["trunk"]["w"][-1] = params["trunk"]["w"][-1] * 6.0
    params["trunk"]["b"][-1] = params["trunk"]["b"][-1] + np.asarray([0, 0, 0, 3.0], np.float32)
    return params


def _jrays(o, d):
    return JRays(jnp.asarray(o), jnp.asarray(d), j_tp(jnp.asarray(d)))


def _trays(o, d):
    td = torch.from_numpy(d)
    return Rays(torch.from_numpy(o), td, viewdirs_to_thetaphi(td))


def _spans(o, d, grid, near):
    from tnerf_torch.grid.traversal import ray_aabb

    te, tx = ray_aabb(torch.from_numpy(o), torch.from_numpy(d), grid.aabb_min, grid.aabb_max)
    te = torch.clamp_min(te, near)
    return te.numpy(), torch.maximum(tx, te).numpy()


@pytest.mark.parametrize("pool", [16, 8])
def test_tightened_range_matches_reference(pool):
    from tnerf.grid.traversal import make_coarse_occupancy as j_pool
    from tnerf.grid.traversal import tightened_range as j_tight
    from tnerf_torch.grid.traversal import make_coarse_occupancy, tightened_range

    jcfg, cfg = _cfgs()
    o, d = _rays()
    _, occ = _density()
    te, tx = _spans(o, d, cfg.grid, 2.0)
    jocc = jnp.asarray(occ) if pool == 16 else j_pool(jnp.asarray(occ), 16 // pool)
    tocc = torch.from_numpy(occ) if pool == 16 else make_coarse_occupancy(torch.from_numpy(occ),
                                                                           16 // pool)
    w0, w1 = j_tight(jnp.asarray(o), jnp.asarray(d), jnp.asarray(te), jnp.asarray(tx), jocc,
                     jcfg.grid, probes=32)
    g0, g1 = tightened_range(*(torch.from_numpy(a) for a in (o, d, te, tx)), tocc, cfg.grid,
                             probes=32)
    np.testing.assert_allclose(g0.numpy(), np.asarray(w0), atol=PART_ATOL, rtol=0)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1), atol=PART_ATOL, rtol=0)
    shrunk = (g1 - g0).numpy() < (tx - te) - 0.1
    assert 0.3 < shrunk.mean() < 1.0  # rays through the ball tighten, the others keep their span


def test_density_lookup_and_pooling_match_reference():
    from tnerf.grid.traversal import density_lookup as j_lookup
    from tnerf.grid.traversal import make_coarse_density as j_pool
    from tnerf_torch.grid.traversal import density_lookup, make_coarse_density

    jcfg, cfg = _cfgs()
    dens, _ = _density()
    pts = np.random.default_rng(0).uniform(-1.3, 1.3, (500, 3)).astype(np.float32)
    for factor in (1, 2, 4):
        jd = jnp.asarray(dens) if factor == 1 else j_pool(jnp.asarray(dens), factor)
        td = torch.from_numpy(dens) if factor == 1 else make_coarse_density(
            torch.from_numpy(dens), factor)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(density_lookup(torch.from_numpy(pts), td, cfg.grid).numpy(),
                                      np.asarray(j_lookup(jnp.asarray(pts), jd, jcfg.grid)))
    outside = np.abs(pts).max(axis=1) > 1.0
    assert outside.any() and not density_lookup(torch.from_numpy(pts), torch.from_numpy(dens),
                                                cfg.grid).numpy()[outside].any()
    with pytest.raises(ValueError, match="not divisible"):
        make_coarse_density(torch.from_numpy(dens), 3)


@pytest.mark.parametrize("placement", ["occupancy_cdf", "density_cdf"])
def test_cdf_bin_weights_and_sample_fraction_match_reference(placement):
    from tnerf.grid.traversal import make_coarse_density as j_pool_d
    from tnerf.grid.traversal import make_coarse_occupancy as j_pool
    from tnerf_torch.grid.traversal import make_coarse_density, make_coarse_occupancy

    jcfg, cfg = _cfgs([f"sampler.placement={placement}"])
    o, d = _rays()
    dens, occ = _density()
    te, tx = _spans(o, d, cfg.grid, 2.0)
    jw, jsup = jgr.cdf_bin_weights(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(te), jnp.asarray(tx),
        j_pool(jnp.asarray(occ), 2), j_pool_d(jnp.asarray(dens), 2), jcfg.grid, jcfg.sampler)
    w, sup = gr.cdf_bin_weights(
        *(torch.from_numpy(a) for a in (o, d, te, tx)),
        make_coarse_occupancy(torch.from_numpy(occ), 2),
        make_coarse_density(torch.from_numpy(dens), 2), cfg.grid, cfg.sampler)
    np.testing.assert_array_equal(sup.numpy(), np.asarray(jsup))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=PART_ATOL, rtol=1e-5)
    assert 0.05 < sup.float().mean() < 0.6
    if placement == "density_cdf":
        # bins behind the ball's dense core get less than bins in front of it
        k = sup.sum(dim=1).float()
        np.testing.assert_allclose(w.sum(dim=1).numpy()[k.numpy() > 0], k.numpy()[k.numpy() > 0],
                                   rtol=1e-4)
        assert float(w.max()) > 1.5
        with pytest.raises(ValueError, match="density-EMA"):
            gr.cdf_bin_weights(*(torch.from_numpy(a) for a in (o, d, te, tx)),
                               torch.from_numpy(occ), None, cfg.grid, cfg.sampler)
    payload = dens if placement == "density_cdf" else occ
    want = jgr.cdf_occupied_sample_fraction(_jrays(o, d), jnp.asarray(payload), jcfg.grid,
                                            jcfg.sampler)
    got = gr.cdf_occupied_sample_fraction(_trays(o, d), torch.from_numpy(payload), cfg.grid,
                                          cfg.sampler)
    assert got.shape == () and abs(float(got) - float(want)) < PART_ATOL
    assert 0.3 < float(got) < 1.0


def test_split_occupancy_payload():
    _, cfg = _cfgs()
    dens, occ = _density()
    assert gr.split_occupancy_payload(None, cfg.grid) == (None, None)
    bits, none = gr.split_occupancy_payload(torch.from_numpy(occ).reshape(-1), cfg.grid)
    assert none is None and bits.shape == (16, 16, 16) and bits.dtype == torch.bool
    bits2, d3 = gr.split_occupancy_payload(torch.from_numpy(dens), cfg.grid)
    assert torch.equal(bits2, bits) and torch.equal(d3, torch.from_numpy(dens))


def _shade_inputs(seed=1):
    """([B, S, 3] positions, viewdirs, t, deltas, mask) with a ragged mask,
    some rays empty."""
    rng = np.random.default_rng(seed)
    n, S = 40, 12
    o, d = _rays(seed, n)
    t = np.sort(rng.uniform(2.0, 4.0, (n, S)), axis=1).astype(np.float32)
    deltas = rng.uniform(0.05, 0.2, (n, S)).astype(np.float32)
    mask = rng.uniform(size=(n, S)) < 0.4
    mask[::5] = False
    pos = o[:, None, :] + d[:, None, :] * t[..., None]
    tp = viewdirs_to_thetaphi(torch.from_numpy(d)).numpy()
    return pos.astype(np.float32), tp, t, deltas, mask


@pytest.mark.parametrize("capacity", [10 ** 6, 60, 1])
def test_compacted_shade_against_composite_and_reference(capacity):
    from tnerf_torch.fields.nerf_field import apply_field
    from tnerf_torch.render.composite import composite

    jcfg, cfg = _cfgs()
    jparams = _params(jcfg)
    params = params_from_jax(jparams)
    pos, tp, t, deltas, mask = _shade_inputs()
    n, S = mask.shape
    T = torch.from_numpy
    with torch.no_grad():
        got = gr.compacted_shade(params, cfg.field_, cfg.grid, T(pos), T(tp), T(t), T(deltas),
                                 T(mask), capacity, True)
        # the first `capacity` kept samples, in ray order, are the ones that count
        keep = mask.reshape(-1) & (np.cumsum(mask.reshape(-1)) <= capacity)
        rgb, sigma = apply_field(params, cfg.field_, cfg.grid, T(pos), T(tp)[:, None, :])
        want = composite(rgb, sigma, T(deltas), t_mid=T(t), mask=T(keep.reshape(n, S)),
                         white_background=True)
    assert mask.sum() > 60  # the two small capacities overflow
    np.testing.assert_allclose(got.rgb.numpy(), want.rgb.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.acc.numpy(), want.acc.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.depth.numpy(), want.depth.numpy(), atol=1e-5, rtol=0)
    assert got.weights.shape == (n, 0) and not got.distortion.any()
    dropped = ~keep.reshape(n, S).any(axis=1)
    assert dropped.any() and (got.acc.numpy()[dropped] == 0).all()
    assert (got.rgb.numpy()[dropped] == 1.0).all()  # white background
    field = build_field(jcfg)
    jres = jgr.compacted_shade(field, jax.tree.map(jnp.asarray, jparams), jnp.asarray(pos),
                               jnp.asarray(tp), jnp.asarray(t), jnp.asarray(deltas),
                               jnp.asarray(mask), capacity, True)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(jres.rgb), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.acc.numpy(), np.asarray(jres.acc), atol=ATOL, rtol=0)


def test_compacted_shade_carries_gradients():
    _, cfg = _cfgs()
    from tnerf_torch.fields.nerf_field import NeRFField

    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    pos, tp, t, deltas, mask = (torch.from_numpy(a) for a in _shade_inputs())
    res = gr.compacted_shade(field.params(), cfg.field_, cfg.grid, pos, tp, t, deltas, mask, 100,
                             False)
    grads = torch.autograd.grad(res.rgb.square().mean(), list(field.parameters()))
    assert all(float(g.abs().max()) > 0 for g in grads)


MARCH = {
    "intervals": ("intervals", []),
    "intervals_budget_cut": ("intervals", ["grid.max_hits=20"]),
    "march_uniform": ("march", []),
    "march_uniform_fine_mask": ("march", ["sampler.occupancy_mask_res=16"]),
    "march_no_kernel": ("march", ["sampler.tighten_res=16", "sampler.occupancy_mask_res=16"]),
    "march_no_tighten": ("march", ["sampler.tighten=false"]),
    "march_cdf_fold": ("march", ["sampler.placement=occupancy_cdf"]),
    "march_cdf_probes": ("march", ["sampler.placement=occupancy_cdf",
                                   "sampler.occupancy_mask_res=16"]),
    "march_density_cdf": ("march", ["sampler.placement=density_cdf"]),
    "march_ray_compact": ("march", ["render.ray_compact=true",
                                    "render.ray_compact_fraction=0.875"]),
    "march_cdf_ray_compact": ("march", ["sampler.placement=occupancy_cdf",
                                        "render.ray_compact=true",
                                        "render.ray_compact_fraction=0.875"]),
    "march_sample_compact": ("march", ["render.compact=true", "render.compact_fraction=0.6"]),
    "march_both_compact": ("march", ["sampler.placement=density_cdf", "render.compact=true",
                                     "render.compact_fraction=0.9", "render.ray_compact=true",
                                     "render.ray_compact_fraction=0.875"]),
}


def _both(case, extra=(), occupied=True):
    """(reference RenderResult, port RenderResult) of the same rays at eval."""
    strategy, ov = MARCH[case]
    jcfg, cfg = _cfgs(ov + list(extra))
    o, d = _rays()
    dens, occ = _density()
    payload = None if not occupied else dens if cfg.sampler.placement == "density_cdf" else occ
    jparams = _params(jcfg)
    kw = dict(strategy=strategy, compact=cfg.render.compact)
    jrender = jgr.make_grid_renderer(build_field(jcfg), jcfg.grid, jcfg.sampler, jcfg.render, **kw)
    jres = jrender(jax.tree.map(jnp.asarray, jparams), _jrays(o, d), None,
                   None if payload is None else jnp.asarray(payload))
    render = gr.make_grid_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render, **kw)
    with torch.no_grad():
        res = render(params_from_jax(jparams), _trays(o, d),
                     None if payload is None else torch.from_numpy(payload))
    return jres, res


def _assert_same_render(jres, res, same_slots=True):
    """same_slots=False: the skipping walk (max_hits >= 3 res) keeps the
    reference's intervals in order but not in its slots, so per-sample
    arrays are compared through their sums only."""
    np.testing.assert_allclose(res.rgb.numpy(), np.asarray(jres.rgb), atol=ATOL, rtol=0)
    np.testing.assert_allclose(res.acc.numpy(), np.asarray(jres.acc), atol=ATOL, rtol=0)
    np.testing.assert_allclose(res.depth.numpy(), np.asarray(jres.depth), atol=DEPTH_ATOL, rtol=0)
    assert tuple(res.weights.shape) == tuple(jres.weights.shape)
    if res.weights.shape[-1]:
        np.testing.assert_allclose(res.distortion.numpy(), np.asarray(jres.distortion),
                                   atol=DEPTH_ATOL, rtol=0)
        if same_slots:
            np.testing.assert_allclose(res.weights.numpy(), np.asarray(jres.weights), atol=ATOL,
                                       rtol=0)
            np.testing.assert_allclose(res.transmittance.numpy(), np.asarray(jres.transmittance),
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", list(MARCH))
def test_grid_renderer_matches_reference_at_eval(case):
    jres, res = _both(case)
    acc = res.acc.numpy()
    assert 0.2 < (acc > 0.5).mean() < 0.9 and (acc < 1e-6).mean() > 0.1  # object and background
    assert res.rgb.shape == (B, 3) and np.isfinite(res.rgb.numpy()).all()
    _assert_same_render(jres, res, same_slots=case != "intervals")


@pytest.mark.parametrize("case", ["intervals", "march_uniform", "march_cdf_fold"])
def test_grid_renderer_without_occupancy_matches_reference(case):
    """No grid: every crossed cell / every sample of the span counts, and
    CDF placement falls back to the uniform quadrature."""
    jres, res = _both(case, occupied=False)
    assert float((res.acc > 0.5).float().mean()) > 0.2
    _assert_same_render(jres, res)


@pytest.mark.parametrize("case", ["march_ray_compact", "march_cdf_ray_compact",
                                  "march_sample_compact"])
def test_compaction_within_capacity_changes_nothing(case):
    _, on = _both(case)
    _, off = _both(case, ["render.ray_compact=false", "render.compact=false"])
    np.testing.assert_allclose(on.rgb.numpy(), off.rgb.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(on.acc.numpy(), off.acc.numpy(), atol=1e-6, rtol=0)


def test_over_capacity_rays_render_as_background():
    _, full = _both("march_ray_compact")
    jres, res = _both("march_ray_compact", ["render.ray_compact_fraction=0.125"])
    _assert_same_render(jres, res)
    lost = (full.acc.numpy() > 0) & (res.acc.numpy() == 0)
    assert lost.sum() > 20 and (res.rgb.numpy()[lost] == 1.0).all()  # white background
    first = np.flatnonzero(full.acc.numpy() > 0)[:10]
    np.testing.assert_allclose(res.rgb.numpy()[first], full.rgb.numpy()[first], atol=1e-6)


@pytest.mark.parametrize("mode", ["regular", "stratified"])
def test_uniform_renderer_matches_reference(mode):
    from tnerf.render.renderer import make_uniform_renderer as j_make
    from tnerf_torch.render.renderer import make_uniform_renderer

    jcfg, cfg = _cfgs([f"sampler.mode={mode}", "sampler.samples_per_ray=24"])
    o, d = _rays()
    jparams = _params(jcfg)
    jres = j_make(build_field(jcfg), jcfg.sampler, jcfg.render)(
        jax.tree.map(jnp.asarray, jparams), _jrays(o, d), None)
    render = make_uniform_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render)
    with torch.no_grad():
        res = render(params_from_jax(jparams), _trays(o, d), torch.ones(3))  # occupancy ignored
        jittered = render(params_from_jax(jparams), _trays(o, d), None,
                          torch.Generator().manual_seed(0))
    _assert_same_render(jres, res)
    assert res.weights.shape == (B, 24)
    # without a generator every mode samples the strata's midpoints
    assert torch.equal(jittered.rgb, res.rgb) == (mode == "regular")


def test_training_renderer_jitters_only_with_a_generator():
    _, cfg = _cfgs(["sampler.mode=stratified"])
    o, d = _rays()
    _, occ = _density()
    params = params_from_jax(_params(_cfgs()[0]))
    gen = lambda s: torch.Generator().manual_seed(s)
    for strategy in ("march", "intervals"):
        render = gr.make_grid_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render,
                                       strategy=strategy, compact=False)
        with torch.no_grad():
            a, a2 = (render(params, _trays(o, d), torch.from_numpy(occ)) for _ in range(2))
            j1, j1b, j2 = (render(params, _trays(o, d), torch.from_numpy(occ), gen(s))
                           for s in (1, 1, 2))
        assert torch.equal(a.rgb, a2.rgb) and torch.equal(j1.rgb, j1b.rgb)
        assert not torch.equal(j1.rgb, a.rgb) and not torch.equal(j1.rgb, j2.rgb)
        assert float((j1.rgb - a.rgb).abs().max()) < 0.5


def test_renderer_value_errors():
    _, cfg = _cfgs()
    make = lambda c, s: gr.make_grid_renderer(c.field_, c.grid, c.sampler, c.render, strategy=s)
    with pytest.raises(ValueError, match="unknown grid render strategy"):
        make(cfg, "sweep")
    with pytest.raises(ValueError, match="sampler.placement must be"):
        make(cfg.apply_overrides(["sampler.placement=cdf"]), "march")
    with pytest.raises(ValueError, match="grid_march pipeline only"):
        make(cfg.apply_overrides(["sampler.placement=occupancy_cdf"]), "intervals")
    o, d = _rays()
    _, occ = _density()
    dcdf = make(cfg.apply_overrides(["sampler.placement=density_cdf"]), "march")
    with pytest.raises(ValueError, match="given a bool"):
        dcdf(params_from_jax(_params(_cfgs()[0])), _trays(o, d), torch.from_numpy(occ))
