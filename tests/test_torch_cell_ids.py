"""Cell ids, probe fractions and sample spacings computed as the reference's
XLA computes them.

The reference divides by compile-time constants: a cell size in every cell
id, a probe, sample or bin count in every probe fraction and spacing.
Under `jit`, and inside a Pallas kernel in interpret mode, XLA's algebraic
simplifier rewrites x / c into x * RN(1 / c), the reciprocal rounded once
to float32, and the port multiplies by that reciprocal.  The two agree
with a true division only where c is a power of two, and every committed
configuration has one, so these cases use grids whose cell size is not:
res 12, 24 and 48 on [-1, 1]^3 and res 24 on [-1.3, 0.9]^3, with
coordinates found by search: the float32 values within 64 ulp of a cell
boundary where floor((p - lo) / cell) and floor((p - lo) * RN(1 / cell))
differ (`chip_smoke.split_arguments`, which the card's checks use too).
Rays run along an axis (the other direction
components 0, which `d_safe` turns into 1e-12) with their other two
coordinates on such values, so every step or probe of a ray tests them.

Jit against eager: the reference's lookups (`occupancy_lookup`,
`density_lookup`) divide exactly when called eagerly and multiply by the
reciprocal under `jit`.  The reference's train and eval steps are jitted,
so the port is held to the jitted result.

The reference runs in one subprocess with XLA:CPU limited to AVX, as in
`tests/test_torch_tighten.py`: with FMA instructions XLA:CPU contracts a
product and a sum (te + span * frac) into one fused multiply-add, which
moves depths by an ulp; the reference's source rounds them separately,
and so does the port.  Cells, depths, spans and masks are compared bit for
bit; B1's outputs within the bf16 tolerance of `tests/test_torch_fused.py`
(5e-3), where a sample mask that differs moves a ray's opacity by far
more."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import split_arguments, split_rays
from tnerf_torch.config import GridConfig, SamplerConfig
from tnerf_torch.grid import dda
from tnerf_torch.grid.tighten import pack_words_rows, tighten_range_plain
from tnerf_torch.grid.tighten import tighten_sample_mask_plain
from tnerf_torch.grid.traversal import (
    density_lookup,
    march_samples_t,
    occupancy_lookup,
    ray_aabb,
    tightened_range,
)
from tnerf_torch.render import fused as tf
from tnerf_torch.render.grid_renderer import cdf_bin_weights
from tnerf_torch.sampling import cdf_ray_samples, interval_samples

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF = ((-1.3,) * 3, (0.9,) * 3)
UNIT = ((-1.0,) * 3, (1.0,) * 3)
# B5: (resolution, box, coarse factor or 0 for the dense walk); the
# reference's skipping walk takes a power-of-two factor only
WALKS = {"r24_dense": (24, UNIT, 0), "r24_skip": (24, UNIT, 2), "r12_skip": (12, UNIT, 1),
         "r48_dense": (48, UNIT, 0), "off24_skip": (24, OFF, 2), "off24_dense": (24, OFF, 0)}
LOOKUPS = {"r12": (12, UNIT), "r24": (24, UNIT), "r48": (48, UNIT), "off24": (24, OFF)}
PROBE_RES = (12, 24)  # B3 / B4 coarse grids on [-1, 1]^3
N_MID = 33            # B4's midpoints
PROBES = 100
B1_RES, B1_S = 24, 128


def grid(res, box):
    return GridConfig(resolution=res, aabb_min=box[0], aabb_max=box[1])


def _box_cell(res, box):
    lo = np.asarray(box[0], np.float32)
    return lo, (np.asarray(box[1], np.float32) - lo) / np.float32(res)


def _slabs(res):
    """[res]^3 bool occupied where j + k is even: a ray along x is occupied
    everywhere or nowhere, and one cell off in y or z flips it."""
    j, k = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    return np.broadcast_to(((j + k) % 2 == 0)[None], (res,) * 3).copy()


def _spans(o, d, box, near=0.0):
    te, tx = ray_aabb(torch.from_numpy(o), torch.from_numpy(d), box[0], box[1])
    te = torch.clamp_min(te, near)
    return te.numpy(), torch.maximum(tx, te).numpy()


def _lookup_points(res, box, seed):
    """[n, 3] points whose coordinates are split arguments, in random
    triples, plus cell centres."""
    lo, cell = _box_cell(res, box)
    rng = np.random.default_rng(seed)
    p = split_arguments(lo[0], cell[0], res)
    pts = rng.choice(p, size=(4 * p.size, 3)).astype(np.float32)
    centres = (lo + (np.arange(res)[:, None] + 0.5) * cell).astype(np.float32)
    return np.concatenate([pts, centres])


def _glue_inputs():
    """Spans, intervals and bin weights for the glue functions."""
    rng = np.random.default_rng(11)
    B = 256
    te = rng.uniform(1.5, 2.5, B).astype(np.float32)
    tx = (te + rng.uniform(0.0, 2.0, B)).astype(np.float32)
    tx[:8] = te[:8]  # empty spans
    starts = np.sort(rng.uniform(2.0, 5.0, (B, 6)), axis=1).astype(np.float32)
    ends = (starts + rng.uniform(0.01, 0.2, (B, 6))).astype(np.float32)
    hit = rng.uniform(size=(B, 6)) < 0.8
    bins = (rng.uniform(size=(B, 48)) < 0.3).astype(np.float32)
    return te, tx, starts, ends, hit, bins


def _b1_workload():
    """Rays along x, y on split arguments of the 24^3 coarse grid and z on
    cell centres (so that a cell id one off in y flips the slab's bit),
    padded to a multiple of 8 rays with rays on cell centres; random
    weights and encodings; every sample inside the box."""
    rng = np.random.default_rng(0)
    o, d = split_rays(grid(B1_RES, UNIT), axes=(0,))
    B = -(-o.shape[0] // 8) * 8
    pad = B - o.shape[0]
    lo, cell = _box_cell(B1_RES, UNIT)
    o[:, 2] = lo[2] + (rng.integers(0, B1_RES, o.shape[0]) + 0.5) * cell[2]
    extra = np.zeros((pad, 3), np.float32)
    extra[:, 0] = -2.5
    extra[:, 1:] = lo[1:] + (rng.integers(0, B1_RES, (pad, 2)) + 0.5) * cell[1:]
    o = np.concatenate([o, extra])
    d = np.concatenate([d, np.tile(np.float32([1, 0, 0]), (pad, 1))])
    NL = 4
    W = rng.normal(0, 0.05, (NL, 128, 128)).astype(np.float32)
    Bias = rng.normal(0, 0.1, (NL, 128)).astype(np.float32)
    Bias[NL - 1, 3] = 3.0  # sigma about 2: a ray whose samples count is nearly opaque
    gamma = rng.normal(0, 1.0, (B, 128)).astype(np.float32)
    beta = rng.normal(0, 0.02, (B, 128)).astype(np.float32)
    te = (-1.0 - o[:, 0] + 0.05).astype(np.float32)  # enter at x = -0.95
    dt = np.full(B, 1.9 / B1_S, np.float32)
    mask = np.ones((B, B1_S), np.float32)
    return W, Bias, gamma, beta, te, dt, o, d, mask, _slabs(B1_RES)


_REFERENCE = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
from tnerf.config import GridConfig, SamplerConfig
from tnerf.grid import traversal as tv
from tnerf.grid.pallas_dda import (march_pallas_raw, pack_words_rows, tighten_range_pallas,
                                   tighten_sample_mask_pallas)
from tnerf.render import grid_renderer as gr
from tnerf.render import pallas_fused2 as jf
from tnerf import sampling as sp

inp = np.load(sys.argv[1])
out = {}
g = lambda res, lo, hi: GridConfig(resolution=int(res), aabb_min=tuple(map(float, lo)),
                                   aabb_max=tuple(map(float, hi)))
for name in inp["walks"]:
    res, factor = inp[f"{name}_res"], int(inp[f"{name}_factor"])
    grid = g(res, inp[f"{name}_lo"], inp[f"{name}_hi"])
    occ = jnp.asarray(inp[f"{name}_occ"]) if factor else None
    o, d = jnp.asarray(inp[f"{name}_o"]), jnp.asarray(inp[f"{name}_d"])
    t0, cell, te, tx = march_pallas_raw(o, d, grid, occ, coarse_factor=max(factor, 1),
                                        interpret=True)
    out[f"{name}_t0"], out[f"{name}_cell"] = np.asarray(t0), np.asarray(cell)
    out[f"{name}_te"], out[f"{name}_tx"] = np.asarray(te), np.asarray(tx)
for name in inp["lookups"]:
    grid = g(inp[f"{name}_res"], inp[f"{name}_lo"], inp[f"{name}_hi"])
    pts = jnp.asarray(inp[f"{name}_pts"])
    out[f"{name}_occ"] = np.asarray(jax.jit(lambda p, o: tv.occupancy_lookup(p, o, grid))(
        pts, jnp.asarray(inp[f"{name}_bits"])))
    out[f"{name}_dens"] = np.asarray(jax.jit(lambda p, v: tv.density_lookup(p, v, grid))(
        pts, jnp.asarray(inp[f"{name}_density"])))
    out[f"{name}_occ_eager"] = np.asarray(tv.occupancy_lookup(pts, jnp.asarray(inp[f"{name}_bits"]),
                                                              grid))
for res_c in inp["probe_res"]:
    k = f"p{res_c}"
    o, d, te, tx = (jnp.asarray(inp[f"{k}_{a}"]) for a in ("o", "d", "te", "tx"))
    occ = jnp.asarray(inp[f"{k}_occ"])
    t0, t1 = tighten_range_pallas(o, d, te, tx, pack_words_rows(occ), int(res_c), GridConfig(),
                                  probes=int(inp["probes"]), interpret=True)
    out[f"{k}_b3_t0"], out[f"{k}_b3_t1"] = np.asarray(t0), np.asarray(t1)
    t0, t1, mask = tighten_sample_mask_pallas(o, d, te, tx, occ, int(inp["n_mid"]), GridConfig(),
                                              probes=int(inp["probes"]), interpret=True)
    out[f"{k}_b4_t0"], out[f"{k}_b4_t1"], out[f"{k}_b4_mask"] = (np.asarray(t0), np.asarray(t1),
                                                                 np.asarray(mask))
# B1: the fused forward kernel's in-kernel coarse test at a 24^3 coarse grid
res_c = int(inp["b1_res"])
lo = np.asarray(GridConfig().aabb_min, np.float32)
hi = np.asarray(GridConfig().aabb_max, np.float32)
coarse = (res_c, max(1, -(-(res_c ** 3) // 4096)), tuple(lo), tuple((hi - lo) / res_c))
fused = jf.make_fused_trainable(4, 1, b_tile=8, term_eps=0.0, interpret=True, coarse=coarse)
rays8 = np.concatenate([inp["b1_te"][:, None], inp["b1_dt"][:, None], inp["b1_o"], inp["b1_d"]],
                       axis=1)
words = jf.pack_occupancy_words(jnp.asarray(inp["b1_occ"]), res_c, res_c)
out["b1"] = np.asarray(fused(*(inp[f"b1_{a}"] for a in ("W", "Bias", "gamma", "beta")), rays8,
                             inp["b1_mask"], words))[:, :6]
# the glue, jitted as the reference's steps run it
te, tx = jnp.asarray(inp["te"]), jnp.asarray(inp["tx"])
t, dt = jax.jit(tv.march_samples_t, static_argnums=2)(te, tx, 96)
out["march_t"], out["march_dt"] = np.asarray(t), np.asarray(dt)
rs = jax.jit(lambda a, b, h: sp.interval_samples(a, b, h, 12))(
    jnp.asarray(inp["starts"]), jnp.asarray(inp["ends"]), jnp.asarray(inp["hit"]))
out["interval_t"], out["interval_deltas"] = np.asarray(rs.t), np.asarray(rs.deltas)
rs = jax.jit(lambda a, b, w: sp.cdf_ray_samples(a, b, 96, w, floor=0.25))(
    te, tx, jnp.asarray(inp["bins"]))
out["cdf_t"], out["cdf_deltas"], out["cdf_mask"] = (np.asarray(rs.t), np.asarray(rs.deltas),
                                                    np.asarray(rs.mask))
g24 = g(24, (-1.0,) * 3, (1.0,) * 3)
o, d = jnp.asarray(inp["g_o"]), jnp.asarray(inp["g_d"])
gte, gtx = jnp.asarray(inp["g_te"]), jnp.asarray(inp["g_tx"])
occ24 = jnp.asarray(inp["g_occ"])
t0, t1 = jax.jit(lambda *a: tv.tightened_range(*a, occ24, g24, probes=100))(o, d, gte, gtx)
out["tight_t0"], out["tight_t1"] = np.asarray(t0), np.asarray(t1)
scfg = SamplerConfig(cdf_bins=48, placement="occupancy_cdf")
w, sup = jax.jit(lambda *a: gr.cdf_bin_weights(*a, occ24, None, g24, scfg))(o, d, gte, gtx)
out["bins_w"], out["bins_support"] = np.asarray(w), np.asarray(sup)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cell_ids")
    inp = {"walks": np.asarray(list(WALKS)), "lookups": np.asarray(list(LOOKUPS)),
           "probe_res": np.asarray(PROBE_RES), "probes": PROBES, "n_mid": N_MID}
    rng = np.random.default_rng(4)
    for name, (res, box, factor) in WALKS.items():
        o, d = split_rays(grid(res, box))
        inp.update({f"{name}_res": res, f"{name}_factor": factor, f"{name}_lo": box[0],
                    f"{name}_hi": box[1], f"{name}_o": o, f"{name}_d": d,
                    f"{name}_occ": rng.uniform(size=(res,) * 3) < 0.5})
    for name, (res, box) in LOOKUPS.items():
        i, j, k = np.meshgrid(*(np.arange(res),) * 3, indexing="ij")
        inp.update({f"{name}_res": res, f"{name}_lo": box[0], f"{name}_hi": box[1],
                    f"{name}_pts": _lookup_points(res, box, seed=res),
                    f"{name}_bits": (i + j + k) % 2 == 0,
                    f"{name}_density": rng.uniform(size=(res,) * 3).astype(np.float32)})
    for res_c in PROBE_RES:
        o, d = split_rays(grid(res_c, UNIT))
        te, tx = _spans(o, d, UNIT)
        inp.update({f"p{res_c}_o": o, f"p{res_c}_d": d, f"p{res_c}_te": te, f"p{res_c}_tx": tx,
                    f"p{res_c}_occ": _slabs(res_c)})
    W, Bias, gamma, beta, te, dt, o, d, mask, occ = _b1_workload()
    inp.update({"b1_res": B1_RES, "b1_W": W, "b1_Bias": Bias, "b1_gamma": gamma,
                "b1_beta": beta, "b1_te": te, "b1_dt": dt, "b1_o": o, "b1_d": d,
                "b1_mask": mask, "b1_occ": occ})
    te, tx, starts, ends, hit, bins = _glue_inputs()
    inp.update({"te": te, "tx": tx, "starts": starts, "ends": ends, "hit": hit, "bins": bins})
    o, d = split_rays(grid(24, UNIT))
    gte, gtx = _spans(o, d, UNIT)
    middle = np.zeros((24,) * 3, bool)
    middle[8:16, 8:16, 8:16] = True  # so that the spans tighten
    inp.update({"g_o": o, "g_d": d, "g_te": gte, "g_tx": gtx, "g_occ": _slabs(24) & middle})
    np.savez(tmp / "in.npz", **inp)
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_cpu_max_isa=AVX --xla_backend_optimization_level=0"}
    subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   env=env, check=True, timeout=900)
    with np.load(tmp / "in.npz") as i, np.load(tmp / "out.npz") as o:
        return {k: i[k] for k in i.files}, {k: o[k] for k in o.files}


@pytest.mark.parametrize("res,count", [(6, 1), (12, 14), (24, 31), (48, 100)])
def test_the_search_finds_the_arguments_where_the_two_differ(res, count):
    lo, cell = _box_cell(res, UNIT)
    p = split_arguments(lo[0], cell[0], res)
    assert p.size == count
    # the example of the port's ROADMAP: -0.4166667 is in cell 6 by the
    # division and in cell 7 by the reciprocal at res 24
    if res == 24:
        p0 = np.float32(-0.4166667)
        assert p0 in p
        assert int(np.floor((p0 - lo[0]) / cell[0])) == 6
        assert int(np.floor((p0 - lo[0]) * (np.float32(1) / cell[0]))) == 7


@pytest.mark.parametrize("name", list(WALKS))
def test_b5_walk_matches_the_pallas_kernel(reference, name):
    """march_raw_plain against march_pallas_raw(interpret=True): the cells
    equal, the depths bitwise equal on the rays that hit the box."""
    inp, ref = reference
    res, box, factor = WALKS[name]
    occ = torch.from_numpy(inp[f"{name}_occ"]) if factor else None
    t0, cell, te, tx = dda.march_raw_plain(torch.from_numpy(inp[f"{name}_o"]),
                                           torch.from_numpy(inp[f"{name}_d"]), grid(res, box),
                                           occ, coarse_factor=max(factor, 1))
    np.testing.assert_array_equal(te.numpy(), ref[f"{name}_te"])
    np.testing.assert_array_equal(tx.numpy(), ref[f"{name}_tx"])
    np.testing.assert_array_equal(cell.numpy(), ref[f"{name}_cell"])
    hit = ref[f"{name}_tx"] > ref[f"{name}_te"]
    assert hit.mean() > 0.8 and (cell.numpy() >= 0).mean() > 0.05
    np.testing.assert_array_equal(t0.numpy()[:, hit], ref[f"{name}_t0"][:, hit])


@pytest.mark.parametrize("name", list(LOOKUPS))
def test_lookups_match_the_jitted_reference(reference, name):
    """occupancy_lookup and density_lookup against the reference's under
    jit (its eager call divides, and differs at these points)."""
    inp, ref = reference
    res, box = LOOKUPS[name]
    g = grid(res, box)
    pts = torch.from_numpy(inp[f"{name}_pts"])
    got = occupancy_lookup(pts, torch.from_numpy(inp[f"{name}_bits"]), g)
    np.testing.assert_array_equal(got.numpy(), ref[f"{name}_occ"])
    dens = density_lookup(pts, torch.from_numpy(inp[f"{name}_density"]), g)
    np.testing.assert_array_equal(dens.numpy(), ref[f"{name}_dens"])
    assert (ref[f"{name}_occ"] != ref[f"{name}_occ_eager"]).any()


@pytest.mark.parametrize("res_c", PROBE_RES)
def test_b3_and_b4_match_the_pallas_kernels(reference, res_c):
    """tighten_range_plain and tighten_sample_mask_plain against the
    reference's tighten kernels in interpret mode, at a coarse grid whose
    cell size is not a power of two, on rays whose probes sit on split
    arguments: spans and mask bit-equal."""
    inp, ref = reference
    k = f"p{res_c}"
    o, d, te, tx = (torch.from_numpy(inp[f"{k}_{a}"]) for a in ("o", "d", "te", "tx"))
    occ = torch.from_numpy(inp[f"{k}_occ"])
    t0, t1 = tighten_range_plain(o, d, te, tx, pack_words_rows(occ), res_c, GridConfig(), PROBES)
    np.testing.assert_array_equal(t0.numpy(), ref[f"{k}_b3_t0"])
    np.testing.assert_array_equal(t1.numpy(), ref[f"{k}_b3_t1"])
    m0, m1, mask = tighten_sample_mask_plain(o, d, te, tx, occ, N_MID, GridConfig(), PROBES)
    np.testing.assert_array_equal(m0.numpy(), ref[f"{k}_b4_t0"])
    np.testing.assert_array_equal(m1.numpy(), ref[f"{k}_b4_t1"])
    np.testing.assert_array_equal(mask.numpy(), ref[f"{k}_b4_mask"])
    kept = mask.any(dim=1).float().mean()
    assert 0.5 < kept < 1.0  # the rays along x through odd (j, k) are dropped


def test_b1_sample_mask_matches_the_pallas_kernel(reference):
    """The fused forward (plain version) against the reference's kernel in
    interpret mode with its in-kernel coarse test at 24^3: every sample of
    a ray along x tests the same (j, k) cell, so the mask is all or nothing
    per ray, and a cell id one off moves the ray's opacity by far more
    than the tolerance."""
    inp, ref = reference
    W, Bias, gamma, beta, te, dt, o, d, mask, occ = _b1_workload()
    lo = np.asarray(GridConfig().aabb_min, np.float32)
    cell = (np.asarray(GridConfig().aabb_max, np.float32) - lo) / np.float32(B1_RES)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    got = tf.fused_forward(t(W), t(Bias), t(gamma), t(beta), t(te), t(dt), t(o), t(d), t(mask),
                           pack_words_rows(t(occ)), (B1_RES, lo, cell)).numpy()
    np.testing.assert_allclose(got, ref["b1"], atol=5e-3, rtol=0)
    acc = ref["b1"][:, 3]
    assert (acc == 0).mean() > 0.2 and (acc > 0.9).mean() > 0.2  # masked-out rays and lit ones


GLUE = ["march_samples_t", "interval_samples", "cdf_ray_samples", "tightened_range",
        "cdf_bin_weights"]


@pytest.mark.parametrize("what", GLUE)
def test_glue_matches_the_jitted_reference(reference, what):
    """The unfused pipelines' spacings (96 samples, 12 per interval, 48
    bins, 100 probes) and their lookups at 24^3, bit for bit against the
    reference under jit."""
    inp, ref = reference
    te, tx = torch.from_numpy(inp["te"]), torch.from_numpy(inp["tx"])
    eq = lambda a, b: np.testing.assert_array_equal(a.numpy(), ref[b])
    if what == "march_samples_t":
        t, dt = march_samples_t(te, tx, 96)
        eq(t, "march_t"), eq(dt, "march_dt")
    elif what == "interval_samples":
        rs = interval_samples(*(torch.from_numpy(inp[k]) for k in ("starts", "ends", "hit")), 12)
        eq(rs.t, "interval_t"), eq(rs.deltas, "interval_deltas")
    elif what == "cdf_ray_samples":
        rs = cdf_ray_samples(te, tx, 96, torch.from_numpy(inp["bins"]), floor=0.25)
        eq(rs.t, "cdf_t"), eq(rs.deltas, "cdf_deltas"), eq(rs.mask, "cdf_mask")
    else:
        g = grid(24, UNIT)
        args = [torch.from_numpy(inp[k]) for k in ("g_o", "g_d", "g_te", "g_tx")]
        occ = torch.from_numpy(inp["g_occ"])
        if what == "tightened_range":
            t0, t1 = tightened_range(*args, occ, g, probes=100)
            eq(t0, "tight_t0"), eq(t1, "tight_t1")
            assert (t0 > args[2]).any() and (t1 < args[3]).any()
        else:
            w, sup = cdf_bin_weights(*args, occ, None, g,
                                     SamplerConfig(cdf_bins=48, placement="occupancy_cdf"))
            eq(w, "bins_w"), eq(sup, "bins_support")
