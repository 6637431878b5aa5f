"""`tnerf_torch.sampling.cdf_ray_samples` and the ray compaction pair
`compact_rows` / `scatter_back` against the reference's functions on the
same numpy inputs.

Tolerances: the sample's bin (and so its mask) must be the reference's;
deltas, and t of every sample the mask keeps, within 1e-6 relative.  The
two packages add the cumulative sum in another order (XLA in a tree,
PyTorch on the CPU in float64), which moves a CDF edge by an ulp.  Inside
a bin the position is (u - edge) / pmf, so in an empty bin, whose pmf is
the floor's 0.01 / total, that ulp grows to some 1e-5 of the span: masked
samples, which nothing composites, are held to 5e-5 of it.  A stratum
centre that sits on a CDF edge (with weights in {0.01, 1.01} this happens
exactly, e.g. 16 of 64 bins occupied and u = 1.5 / 24) falls into either
neighbouring bin by that ulp: such samples, found in float64, are left out
of the comparison, and nothing else may differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.render.fused_common import compact_rows as j_compact
from tnerf.render.fused_common import scatter_back as j_scatter
from tnerf.sampling import cdf_ray_samples as j_cdf
from tnerf.sampling import sample_positions as j_positions
from tnerf_torch.render.fused_common import compact_rows, scatter_back
from tnerf_torch.sampling import RaySamples, cdf_ray_samples, sample_positions

RTOL = 1e-6
MASKED_SPAN_TOL = 5e-5


def _on_an_edge(bins, u, floor=0.01):
    """[B, S] bool: the query u sits within 1e-6 of an interior CDF edge."""
    w = bins.astype(np.float64) + floor
    cdf = np.cumsum(w, axis=1) / w.sum(axis=1, keepdims=True)
    return (np.abs(cdf[:, None, :-1] - u[:, :, None]) < 1e-6).any(axis=2)


def _rays_and_bins(B=257, P=16, seed=0):
    rng = np.random.default_rng(seed)
    te = rng.uniform(2.0, 3.0, B).astype(np.float32)
    tx = te + rng.uniform(0.2, 2.0, B).astype(np.float32)
    tx[:7] = te[:7]  # rays without a span
    bins = rng.uniform(size=(B, P)) < 0.3
    bins[7:20] = False  # rays that no probe hit
    bins[20:30] = True
    return te, tx, bins


@pytest.mark.parametrize("P,S,jittered", [(16, 16, False), (16, 16, True), (64, 24, False),
                                          (8, 32, True)])
def test_cdf_ray_samples_matches_reference(P, S, jittered):
    te, tx, bins = _rays_and_bins(P=P, seed=P + S)
    jit = np.random.default_rng(3).uniform(size=(te.shape[0], S)).astype(np.float32) \
        if jittered else None
    ref = j_cdf(jnp.asarray(te), jnp.asarray(tx), S, jnp.asarray(bins, jnp.float32), floor=0.01,
                jitter=None if jit is None else jnp.asarray(jit), bin_support=jnp.asarray(bins))
    got = cdf_ray_samples(torch.from_numpy(te), torch.from_numpy(tx), S,
                          torch.from_numpy(bins).float(), floor=0.01,
                          jitter=None if jit is None else torch.from_numpy(jit),
                          bin_support=torch.from_numpy(bins))
    assert isinstance(got, RaySamples) and got.mask.dtype == torch.bool
    u = (np.arange(S) + (0.5 if jit is None else jit.astype(np.float64))) / S
    clear = ~_on_an_edge(bins, np.broadcast_to(u, (te.shape[0], S)))
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(got.mask.numpy()[clear], np.asarray(ref.mask)[clear])
    t, kept = got.t.numpy(), got.mask.numpy() & clear
    np.testing.assert_allclose(t[kept], np.asarray(ref.t)[kept], rtol=RTOL, atol=0)
    assert np.all(np.abs(t - np.asarray(ref.t)) <= MASKED_SPAN_TOL * (tx - te)[:, None])
    np.testing.assert_allclose(got.deltas.numpy()[clear], np.asarray(ref.deltas)[clear],
                               rtol=RTOL, atol=0)
    assert np.all(np.diff(t, axis=1) >= 0)  # monotone along the ray
    assert np.all(t >= te[:, None] - 1e-6) and np.all(t <= tx[:, None] + 1e-5)
    # occupied bins draw the samples: most samples of a ray with hits are kept
    hit = bins.any(axis=1) & (tx > te)
    assert got.mask.numpy()[hit].mean() > 0.8 and not got.mask.numpy()[~hit].any()


def test_default_support_is_the_nonzero_weights():
    te, tx, bins = _rays_and_bins()
    w = torch.from_numpy(bins).float() * 3.0
    a = cdf_ray_samples(torch.from_numpy(te), torch.from_numpy(tx), 16, w)
    ref = j_cdf(jnp.asarray(te), jnp.asarray(tx), 16, jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(a.mask.numpy(), np.asarray(ref.mask))
    kept = a.mask.numpy()
    np.testing.assert_allclose(a.t.numpy()[kept], np.asarray(ref.t)[kept], rtol=RTOL, atol=0)


@pytest.mark.parametrize("P,S", [(16, 16), (64, 32), (8, 24)])
def test_constant_weights_reduce_to_uniform_strata(P, S):
    te, tx, _ = _rays_and_bins(P=P)
    got = cdf_ray_samples(torch.from_numpy(te), torch.from_numpy(tx), S, torch.ones((len(te), P)))
    span = (tx - te)[:, None]
    mid = te[:, None] + (np.arange(S, dtype=np.float32) + 0.5) / S * span
    np.testing.assert_allclose(got.t.numpy(), mid, rtol=2e-6, atol=0)
    np.testing.assert_allclose(got.deltas.numpy(), np.broadcast_to(span / S, mid.shape),
                               rtol=2e-6, atol=0)
    np.testing.assert_array_equal(got.mask.numpy(), np.broadcast_to(span > 0, mid.shape))


def test_floor_must_be_positive_and_positions_match():
    te, tx, bins = _rays_and_bins(B=8)
    with pytest.raises(ValueError, match="floor must be > 0"):
        cdf_ray_samples(torch.from_numpy(te), torch.from_numpy(tx), 4,
                        torch.from_numpy(bins).float(), floor=0.0)
    rng = np.random.default_rng(1)
    o, d = rng.normal(size=(8, 3)).astype(np.float32), rng.normal(size=(8, 3)).astype(np.float32)
    t = rng.uniform(2, 5, (8, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        sample_positions(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t)).numpy(),
        np.asarray(j_positions(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t))))


@pytest.mark.parametrize("cap", [1, 40, 100, 300])
def test_compact_rows_and_scatter_back_match_reference(cap):
    """cap 300 holds every kept ray; 40 and 1 leave kept rays over capacity
    (they read back as background); dropped rays always do."""
    rng = np.random.default_rng(cap)
    B, K = 200, 7
    keep = rng.uniform(size=B) < 0.5
    rows = rng.normal(size=(B, K)).astype(np.float32)
    jbuf, jwidx = j_compact(jnp.asarray(keep), jnp.asarray(rows), cap)
    buf, widx = compact_rows(torch.from_numpy(keep), torch.from_numpy(rows), cap)
    assert buf.shape == (cap, K)
    np.testing.assert_array_equal(widx.numpy(), np.asarray(jwidx))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    bg = np.full((1, K), -1.0, np.float32)
    back = scatter_back(buf * 2.0, widx, torch.from_numpy(bg)).numpy()
    np.testing.assert_array_equal(back, np.asarray(j_scatter(jbuf * 2.0, jwidx, jnp.asarray(bg))))
    rank = np.cumsum(keep) - 1
    inside = keep & (rank < cap)
    np.testing.assert_array_equal(back[inside], rows[inside] * 2.0)
    assert np.all(back[~inside] == -1.0)
    assert inside.sum() == min(cap, keep.sum())


# --- fixed-count, per-interval and march sampling (the unfused pipelines) ---
# Fed the same uniforms, the two packages do the same float32 arithmetic:
# t and deltas within 1e-6 (jnp.linspace and torch.linspace may differ in
# the last bit of an edge), masks equal.

SAMPLE_ATOL = 1e-6


@pytest.mark.parametrize("mode", ["regular", "stratified", "uniform"])
def test_uniform_ray_samples_match_reference(mode):
    from tnerf.sampling import uniform_ray_samples as j_uniform
    from tnerf_torch.sampling import uniform_ray_samples

    import jax

    batch, S = (5, 7), 24
    key = jax.random.PRNGKey(3)
    want = j_uniform(2.0, 5.5, S, batch, mode=mode, key=None if mode == "regular" else key)
    u = None if mode == "regular" else torch.from_numpy(
        np.array(jax.random.uniform(key, (*batch, S), jnp.float32)))
    got = uniform_ray_samples(2.0, 5.5, S, batch, mode=mode, u=u)
    assert got.t.shape == (*batch, S) and got.mask.dtype == torch.bool
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas), atol=SAMPLE_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert bool((got.t[..., 1:] >= got.t[..., :-1]).all())


@pytest.mark.parametrize("mode", ["regular", "stratified", "uniform"])
def test_interval_samples_match_reference(mode):
    from tnerf.sampling import interval_samples as j_interval
    from tnerf_torch.sampling import interval_samples

    import jax

    rng = np.random.default_rng(5)
    B, H, S = 33, 6, 4
    edges = np.sort(rng.uniform(2.0, 5.0, (B, 2 * H)), axis=1).astype(np.float32)
    t0, t1 = edges[:, 0::2], edges[:, 1::2]
    hit = rng.uniform(size=(B, H)) < 0.6
    key = jax.random.PRNGKey(9)
    want = j_interval(jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(hit), S, mode=mode,
                      key=None if mode == "regular" else key)
    u = None if mode == "regular" else torch.from_numpy(
        np.array(jax.random.uniform(key, (B, H, S), jnp.float32)))
    got = interval_samples(torch.from_numpy(t0), torch.from_numpy(t1), torch.from_numpy(hit), S,
                           mode=mode, u=u)
    assert got.t.shape == (B, H * S)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(got.deltas.numpy(), np.asarray(want.deltas), atol=SAMPLE_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_sampling_draws_come_from_the_generator_and_modes_are_checked():
    from tnerf_torch.sampling import interval_samples, uniform_ray_samples

    gen = lambda s: torch.Generator().manual_seed(s)
    a = uniform_ray_samples(0.0, 1.0, 8, (4,), mode="stratified", generator=gen(1))
    b = uniform_ray_samples(0.0, 1.0, 8, (4,), mode="stratified", generator=gen(1))
    c = uniform_ray_samples(0.0, 1.0, 8, (4,), mode="stratified", generator=gen(2))
    assert torch.equal(a.t, b.t) and not torch.equal(a.t, c.t)
    edges = torch.linspace(0.0, 1.0, 9)
    assert bool(((a.t >= edges[:-1]) & (a.t <= edges[1:])).all())
    with pytest.raises(ValueError, match="requires a generator"):
        uniform_ray_samples(0.0, 1.0, 8, (4,), mode="uniform")
    t0, t1 = torch.zeros(3, 2), torch.ones(3, 2)
    with pytest.raises(ValueError, match="requires a generator"):
        interval_samples(t0, t1, torch.ones(3, 2, dtype=torch.bool), 4, mode="stratified")
    with pytest.raises(ValueError, match="sampling mode"):
        interval_samples(t0, t1, torch.ones(3, 2, dtype=torch.bool), 4, mode="jittered")


@pytest.mark.parametrize("jittered", [False, True])
def test_march_samples_t_matches_reference(jittered):
    from tnerf.grid.traversal import march_samples_t as j_march
    from tnerf_torch.grid.traversal import march_samples_t

    rng = np.random.default_rng(11)
    te = rng.uniform(2.0, 3.0, 50).astype(np.float32)
    tx = (te + rng.uniform(-0.2, 2.0, 50)).astype(np.float32)  # some spans are empty
    jit = rng.uniform(size=(50, 12)).astype(np.float32) if jittered else None
    wt, wd = j_march(jnp.asarray(te), jnp.asarray(tx), 12,
                     jitter=None if jit is None else jnp.asarray(jit))
    gt, gd = march_samples_t(torch.from_numpy(te), torch.from_numpy(tx), 12,
                             jitter=None if jit is None else torch.from_numpy(jit))
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=SAMPLE_ATOL, rtol=0)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=SAMPLE_ATOL, rtol=0)
    assert float(gd[torch.from_numpy(tx <= te)].abs().max()) == 0.0
