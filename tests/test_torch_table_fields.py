"""The table-backed encodings of the port against the reference package on
the CPU, at small sizes, on the same numpy-seeded inputs: the hash grid
(`level_resolutions`, the gather encode at dense and hashed levels, with a
level whose hash wraps past 2^32, with 0 and 2 nearest levels, on cell
faces and at the clip bound; its table gradient; the one-hot form's
numerics), spherical harmonics at degrees 1-4, the triplane and CP
encodes and their gradients, `upsample_triplane` and `triplane_tv`.

Tolerances:
- the encodes' forward: bit-equal to the reference as its XLA runs it
  under `jit`, which is how the reference trains.  That reference runs in
  a subprocess with XLA:CPU limited to AVX (as in
  `tests/test_torch_tighten.py`): with FMA instructions XLA:CPU contracts
  w * value + sum into one fused multiply-add (an ulp apart), which the
  reference's source and the port round separately; run op by op (no
  `jit`), the reference is bit-equal too;
- table gradients: a scatter-add, summed in another order than the
  reference's segment sum: max |port - reference| <= GRAD_RTOL of the
  largest entry (measured 2.4e-7);
- SH: XLA:CPU's rsqrt and torch's (1 / sqrt) differ in the last bit:
  atol SH_ATOL (measured 6.6e-7 at degree 4); `thetaphi_to_unit`: sin and
  cos an ulp apart, atol 2.4e-7;
- `upsample_triplane` and its vertex positions (jnp.linspace's): bit-equal;
  `triplane_tv`: a mean in another order, rtol 1e-6;
- the one-hot form at bfloat16: forward bit-equal, its table gradient
  within GRAD_RTOL of the reference's one-hot gradient, and farther than
  that from the float32 gather's (the rounding is computed, not skipped).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.config import Config as JConfig
from tnerf_torch.config import Config
from tnerf_torch.fields import hashgrid as th
from tnerf_torch.fields import triplane as tt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL = 1e-6
SH_ATOL = 2e-6

# name -> hash-grid overrides.  "small": L=6, T=2^10, base 4, max 128
# (resolutions 4 7 15 31 63 127; 4 and 7 dense, the rest hashed);
# "wide": the committed max 2048 at T=2^8 (every level hashed, vertex
# coordinates up to 2049).
HASH = {
    "small": ["field_.hash_levels=6", "field_.hash_log2_table_size=10",
              "field_.hash_base_resolution=4", "field_.hash_max_resolution=128"],
    "small_k2": ["field_.hash_levels=6", "field_.hash_log2_table_size=10",
                 "field_.hash_base_resolution=4", "field_.hash_max_resolution=128",
                 "field_.hash_nearest_levels=2"],
    "wide": ["field_.hash_levels=4", "field_.hash_log2_table_size=8",
             "field_.hash_base_resolution=16", "field_.hash_max_resolution=2048"],
    "wide_k4": ["field_.hash_levels=4", "field_.hash_log2_table_size=8",
                "field_.hash_base_resolution=16", "field_.hash_max_resolution=2048",
                "field_.hash_nearest_levels=4"],
}
TRI = ["field_.tri_resolution=9", "field_.tri_features=4"]
N = 3000

_REFERENCE = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
from tnerf.config import Config
from tnerf.fields import hashgrid, triplane
inp = np.load(sys.argv[1])
out = {}
for name in inp["hash_cases"]:
    cfg = Config().apply_overrides(list(inp[f"{name}_ov"])).field_
    x = jnp.asarray(inp[f"{name}_x"])
    t = jnp.asarray(inp[f"{name}_tables"])
    out[name] = np.asarray(jax.jit(
        lambda t, x: hashgrid.apply_hashgrid_gather({"tables": t}, x, cfg))(t, x))
    if name == "small":
        cfg_b = Config().apply_overrides(list(inp[f"{name}_ov"])
                                         + ["field_.compute_dtype=bfloat16"]).field_
        out["onehot"] = np.asarray(jax.jit(
            lambda t, x: hashgrid.apply_hashgrid_onehot({"tables": t}, x, cfg_b))(t, x))
cfg = Config().apply_overrides(list(inp["tri_ov"])).field_
p, l, x = (jnp.asarray(inp[k]) for k in ("tri_planes", "tri_lines", "tri_x"))
out["triplane"] = np.asarray(jax.jit(
    lambda p, l, x: triplane.apply_triplane_gather({"planes": p, "lines": l}, x, cfg))(p, l, x))
out["cp"] = np.asarray(jax.jit(lambda l, x: triplane.apply_cp_gather({"lines": l}, x, cfg))(l, x))
np.savez(sys.argv[2], **out)
"""


def _cfgs(ov):
    return JConfig().apply_overrides(ov).field_, Config().apply_overrides(ov).field_


def _points(seed, res_max=128):
    """N points in [0, 1]^3: random, on cell faces of every power-of-two
    level (k / 2^j), at 0 and 1 (the clip bound res - 1e-4), and just
    outside the unit cube (clipped)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    x[:600] = (rng.integers(0, res_max + 1, (600, 3)) / res_max).astype(np.float32)
    x[600:700, rng.integers(0, 3)] = 1.0
    x[700:800] = 0.0
    x[800:900] = rng.uniform(-0.05, 1.05, (100, 3)).astype(np.float32)
    return x


def _hash_inputs(name, seed):
    jc, _ = _cfgs(HASH[name])
    rows = jc.hash_levels * (1 << jc.hash_log2_table_size)
    rng = np.random.default_rng(seed + 100)
    return _points(seed), rng.uniform(-1, 1, (rows, 2)).astype(np.float32)


def _tri_inputs():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((3, 81, 4)).astype(np.float32),
            rng.standard_normal((3, 9, 4)).astype(np.float32),
            rng.uniform(-0.1, 1.1, (N, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's jitted encodes, computed in one AVX subprocess."""
    tmp = tmp_path_factory.mktemp("table_fields")
    inp = {"hash_cases": np.asarray(list(HASH)), "tri_ov": np.asarray(TRI)}
    for i, name in enumerate(HASH):
        x, tables = _hash_inputs(name, i)
        inp.update({f"{name}_x": x, f"{name}_tables": tables, f"{name}_ov": np.asarray(HASH[name])})
    inp["tri_planes"], inp["tri_lines"], inp["tri_x"] = _tri_inputs()
    np.savez(tmp / "in.npz", **inp)
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_cpu_max_isa=AVX --xla_backend_optimization_level=0"}
    subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   env=env, check=True, timeout=600)
    with np.load(tmp / "out.npz") as out:
        return {k: out[k] for k in out.files}


@pytest.mark.parametrize("ov", [
    [], HASH["small"], HASH["wide"], ["field_.hash_levels=1"],
    ["field_.hash_levels=12", "field_.hash_base_resolution=16"],
], ids=["default", "small", "wide", "one_level", "committed"])
def test_level_resolutions_are_the_references(ov):
    from tnerf.fields.hashgrid import level_resolutions as j_levels

    jc, tc = _cfgs(ov)
    want = j_levels(jc)
    got = th.level_resolutions(tc)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(HASH))
def test_hash_encode_is_bit_equal_to_the_jitted_reference(reference, name):
    x, tables = _hash_inputs(name, list(HASH).index(name))
    _, tc = _cfgs(HASH[name])
    got = th.apply_hashgrid(torch.from_numpy(tables), torch.from_numpy(x), tc).numpy()
    assert got.shape == (N, tc.hash_levels * 2)
    np.testing.assert_array_equal(got, reference[name])


@pytest.mark.parametrize("name", ["small", "wide"])
def test_the_cases_cover_dense_hashed_and_wrapping_levels(name):
    """The hash cases reach what they are meant to: in "small", dense and
    hashed levels; in both, hashed vertices whose uint32 products wrap
    (y 2654435761 or z 805459861 >= 2^32), up to the largest coordinate."""
    _, tc = _cfgs(HASH[name])
    res = th.level_resolutions(tc)
    T = 1 << tc.hash_log2_table_size
    dense = (res + 1) ** 3 <= T
    assert (not dense.all()) and (dense.any() == (name == "small"))
    x, _ = _hash_inputs(name, list(HASH).index(name))
    i0, _ = th._level_geometry(torch.from_numpy(x), tc)
    top = i0[..., ~torch.from_numpy(dense), :] + 1
    assert int(top[..., 1].max()) * th._PRIMES[1] >= 2 ** 32
    assert int(top[..., 2].max()) * th._PRIMES[2] >= 2 ** 32
    assert int(top.max()) == res.max()  # the clip bound's corner, res_max - 1 + 1


@pytest.mark.parametrize("name", ["small", "small_k2", "wide"])
def test_hash_table_gradient_matches_jax_grad(name):
    from tnerf.fields.hashgrid import apply_hashgrid_gather as j_apply

    x, tables = _hash_inputs(name, list(HASH).index(name))
    jc, tc = _cfgs(HASH[name])
    g = np.random.default_rng(3).standard_normal((N, jc.hash_levels * 2)).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        j_apply({"tables": t}, jnp.asarray(x), jc) * g))(jnp.asarray(tables)))
    t = torch.from_numpy(tables).requires_grad_()
    (th.apply_hashgrid(t, torch.from_numpy(x), tc) * torch.from_numpy(g)).sum().backward()
    assert np.abs(want).max() > 0 and (want != 0).mean() > 0.2
    assert np.abs(t.grad.numpy() - want).max() <= GRAD_RTOL * np.abs(want).max()


def test_explicit_onehot_computes_the_rounded_lookups(reference):
    """hash_gather_mode=onehot at compute_dtype=bfloat16: the reference's
    one-hot numerics (bf16 table values, bf16 per-corner cotangents), not
    the float32 gather."""
    from tnerf.fields.hashgrid import apply_hashgrid_onehot as j_onehot

    ov = HASH["small"] + ["field_.compute_dtype=bfloat16"]
    x, tables = _hash_inputs("small", 0)
    jc, tc = _cfgs(ov + ["field_.hash_gather_mode=onehot"])
    assert th.resolve_gather_mode(tc) == "onehot"
    t = torch.from_numpy(tables).requires_grad_()
    got = th.apply_hashgrid(t, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(got.detach().numpy(), reference["onehot"])
    assert not np.array_equal(reference["onehot"], reference["small"])
    g = np.random.default_rng(4).standard_normal(got.shape).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()
    want = np.asarray(jax.grad(lambda tb: jnp.sum(
        j_onehot({"tables": tb}, jnp.asarray(x), jc) * g))(jnp.asarray(tables)))
    scale = np.abs(want).max()
    assert np.abs(t.grad.numpy() - want).max() <= GRAD_RTOL * scale
    t32 = torch.from_numpy(tables).requires_grad_()
    (th.apply_hashgrid(t32, torch.from_numpy(x), _cfgs(HASH["small"])[1])
     * torch.from_numpy(g)).sum().backward()
    assert np.abs(t32.grad.numpy() - want).max() > 100 * GRAD_RTOL * scale


@pytest.mark.parametrize("mode,ov,error", [
    ("auto", [], None), ("gather", [], None), ("onehot", [], None),
    ("pallas", [], "removed"), ("nope", [], "must be"),
    ("onehot", ["field_.hash_log2_table_size=16"], "128 | T <= 2"),
])
def test_hash_gather_modes(mode, ov, error):
    from tnerf.fields.hashgrid import apply_hashgrid as j_apply

    jc, tc = _cfgs(HASH["small"] + ov + [f"field_.hash_gather_mode={mode}"])
    x = torch.rand(16, 3)
    if error is None:
        want = "gather" if mode == "auto" else mode
        assert th.resolve_gather_mode(tc) == want
        th.apply_hashgrid(torch.zeros((th.hashgrid_num_params(tc) // 2, 2)), x, tc)
        return
    with pytest.raises(ValueError, match=error):
        th.apply_hashgrid(torch.zeros((16, 2)), x, tc)
    if mode != "nope":  # the reference refuses these too (an unknown mode it gathers)
        with pytest.raises(ValueError):
            j_apply({"tables": jnp.zeros((16, 2))}, jnp.asarray(x.numpy()), jc, mode)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encoding_matches_reference(degree):
    from tnerf.fields.encodings import sh_encoding as j_sh, sh_encoding_dim as j_dim
    from tnerf_torch.fields.encodings import sh_encoding, sh_encoding_dim

    d = np.random.default_rng(degree).standard_normal((2000, 3)).astype(np.float32)
    d[:10] *= 1e-3  # not unit: normalized inside
    want = np.asarray(jax.jit(lambda v: j_sh(v, degree))(jnp.asarray(d)))
    got = sh_encoding(torch.from_numpy(d), degree).numpy()
    assert got.shape == (2000, sh_encoding_dim(degree)) and sh_encoding_dim(degree) == j_dim(degree)
    np.testing.assert_allclose(got, want, atol=SH_ATOL, rtol=0)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="sh degree"):
            sh_encoding(torch.from_numpy(d), bad)


def test_thetaphi_to_unit_matches_reference():
    from tnerf.cameras import thetaphi_to_unit as j_unit
    from tnerf_torch.cameras import thetaphi_to_unit, viewdirs_to_thetaphi

    tp = np.random.default_rng(0).uniform(-3, 3, (2000, 2)).astype(np.float32)
    got = thetaphi_to_unit(torch.from_numpy(tp))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_unit(jnp.asarray(tp))), atol=2.4e-7,
                               rtol=0)
    d = torch.nn.functional.normalize(torch.randn(100, 3, generator=torch.Generator()
                                                  .manual_seed(1)), dim=-1)
    torch.testing.assert_close(thetaphi_to_unit(viewdirs_to_thetaphi(d)), d, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["triplane", "cp"])
def test_triplane_and_cp_encodes_match_reference(reference, kind):
    """Forward bit-equal to the jitted reference; gradients of planes and
    lines within GRAD_RTOL of jax.grad's."""
    from tnerf.fields import triplane as jt

    planes, lines, x = _tri_inputs()
    jc, tc = _cfgs(TRI)
    p = torch.from_numpy(planes).requires_grad_()
    l = torch.from_numpy(lines).requires_grad_()
    if kind == "triplane":
        got = tt.apply_triplane(p, l, torch.from_numpy(x), tc)
        japply = lambda pp, ll: jt.apply_triplane_gather({"planes": pp, "lines": ll},
                                                         jnp.asarray(x), jc)
    else:
        got = tt.apply_cp(l, torch.from_numpy(x), tc)
        japply = lambda pp, ll: jt.apply_cp_gather({"lines": ll}, jnp.asarray(x), jc)
    np.testing.assert_array_equal(got.detach().numpy(), reference[kind])
    g = np.random.default_rng(5).standard_normal(got.shape).astype(np.float32)
    (got * torch.from_numpy(g)).sum().backward()
    jgp, jgl = jax.grad(lambda pp, ll: jnp.sum(japply(pp, ll) * g), argnums=(0, 1))(
        jnp.asarray(planes), jnp.asarray(lines))
    leaves = [(l.grad, jgl)] + ([(p.grad, jgp)] if kind == "triplane" else [])
    for mine, want in leaves:
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        assert np.abs(mine.numpy() - want).max() <= GRAD_RTOL * np.abs(want).max()
    assert kind == "triplane" or p.grad is None


def test_triplane_modes():
    _, tc = _cfgs(TRI)
    assert tt.resolve_tri_mode(tc) == "gather" and tt.resolve_cp_mode(tc) == "gather"
    _, big = _cfgs(["field_.tri_resolution=182", "field_.tri_gather_mode=onehot"])
    with pytest.raises(ValueError, match="R\\*R <= 2"):
        tt.resolve_tri_mode(big)
    assert tt.resolve_cp_mode(big) == "onehot"
    planes, lines, x = _tri_inputs()
    _, oh = _cfgs(TRI + ["field_.tri_gather_mode=onehot", "field_.compute_dtype=bfloat16"])
    rounded = tt.apply_triplane(torch.from_numpy(planes), torch.from_numpy(lines),
                                torch.from_numpy(x), oh)
    by_hand = tt.apply_triplane(torch.from_numpy(planes).bfloat16().float(),
                                torch.from_numpy(lines).bfloat16().float(),
                                torch.from_numpy(x), tc)
    torch.testing.assert_close(rounded, by_hand, atol=0, rtol=0)


@pytest.mark.parametrize("r_new", [9, 13, 17, 32])
def test_upsample_triplane_and_tv_match_reference(r_new):
    from tnerf.fields import triplane as jt

    planes, lines, _ = _tri_inputs()
    want = jt.upsample_triplane({"planes": jnp.asarray(planes), "lines": jnp.asarray(lines)},
                                r_new)
    p, l = tt.upsample_triplane(torch.from_numpy(planes), torch.from_numpy(lines), r_new)
    assert tuple(p.shape) == (3, r_new * r_new, 4) and tuple(l.shape) == (3, r_new, 4)
    np.testing.assert_array_equal(p.numpy(), np.asarray(want["planes"]))
    np.testing.assert_array_equal(l.numpy(), np.asarray(want["lines"]))
    tv = float(tt.triplane_tv(p, l))
    jtv = float(jt.triplane_tv({"planes": want["planes"], "lines": want["lines"]}))
    assert abs(tv - jtv) <= 1e-6 * abs(jtv)
    if r_new == 9:  # resampling onto the same vertices is the identity
        np.testing.assert_array_equal(p.numpy(), planes)


def test_vertex_positions_are_jnp_linspace():
    bad = []
    for r_old in range(2, 140, 9):
        for r_new in (1, 2, 5, 13, 17, 32, 51, 81, 128, 129):
            want = np.asarray(jnp.linspace(0.0, r_old - 1.0, r_new))
            got = tt.vertex_positions(r_old, r_new).numpy()
            if not np.array_equal(got, want):
                bad.append((r_old, r_new))
    assert not bad, bad
