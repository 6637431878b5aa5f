"""The table lookups' gradient on the CPU: the stable sort by row
(`fields/hashgrid.py:segment_sort`, csrc/segment_sort.cu on the card) and
the fixed-order segment sum after it (`segment_sum_rows`, csrc/
segment_sum.cu), at small sizes on numpy-seeded inputs.

- `sort_passes`: the digit passes over the row ids' bits;
- the plain sort against `np.argsort(kind="stable")`, keys, payload and
  row starts bit for bit;
- a transcription of the card's digit pass (tiles of SORT_TILE keys, a
  warp's keys in rounds of 32 ranked by digit, the warps' counts scanned
  in warp order, the counts of earlier tiles, the tile placed in digit
  order and written out) and of its row-starts kernel, bit-equal to the
  stable argsort: the kernels' index arithmetic, which the CPU cannot run;
- `segment_sum_rows_plain` against a numpy transcription of its order
  at the edge shapes, bit for bit;
- the limits' errors;
- the table gradient of `rounded_lookup` (and of the hash-grid encode,
  which reaches it) against the reference's jitted gather VJP
  (`tnerf/fields/hashgrid.py:193`): another summation order, so within
  float32 rounding: GRAD_L1_RTOL of the largest row's sum of |cotangent|
  for the lookups alone (measured 3.0e-8, with up to 7662 lookups in a
  row), GRAD_RTOL of the largest entry for the encode (as
  tests/test_torch_table_fields.py holds it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.config import Config as JConfig
from tnerf_torch.config import Config
from tnerf_torch.fields import hashgrid as th

torch.set_num_threads(2)

GRAD_RTOL = 1e-6
GRAD_L1_RTOL = 1e-6
THREADS, ITEMS = 256, 16  # csrc/segment_sort.cu: kThreads, kItems (SORT_TILE = their product)


def _inputs(n, rows, F, seed, skew=False):
    rng = np.random.default_rng(seed)
    if skew:  # a few rows take most lookups
        idx = (rng.zipf(1.3, n) - 1) % max(rows, 1)
    else:
        idx = rng.integers(0, max(rows, 1), n)
    return (rng.standard_normal((n, F), dtype=np.float32), idx.astype(np.int64))


# ------------------------------------------------------------- digit passes

@pytest.mark.parametrize("rows,want", [
    (1, (1, 1)), (2, (1, 1)), (3, (1, 2)), (384, (1, 9)), (512, (1, 9)), (513, (2, 5)),
    (1024, (2, 5)), (1025, (2, 6)), (2 ** 16, (2, 8)), (2 ** 16 + 1, (2, 9)),
    (12 * 2 ** 10, (2, 7)), (3 * 128 * 128, (2, 8)), (196_608, (2, 9)), (2 ** 18, (2, 9)),
    (2 ** 18 + 1, (3, 7)), (2 ** 24, (3, 8)), (2 ** 24 + 1, (3, 9)), (2 ** 31 - 1, (4, 8))])
def test_sort_passes_cover_the_row_ids_bits(rows, want):
    """rows = 1, 384, 2^k, 2^k + 1, 196,608 (the hash grid's 12 x 2^14) and
    2^24: as few passes as 9-bit digits allow, over ceil(log2 rows) bits
    (at least 1), each pass needed."""
    passes, bits = th.sort_passes(rows)
    assert (passes, bits) == want
    key_bits = max(1, (rows - 1).bit_length())
    assert bits <= th.SORT_MAX_BITS and passes * bits >= key_bits > (passes - 1) * bits
    assert passes == -(-key_bits // th.SORT_MAX_BITS)


def test_sort_tile_is_the_kernels():
    assert th.SORT_TILE == THREADS * ITEMS == 4096


@pytest.mark.parametrize("n,rows,F", [(0, 10, 2), (1, 1, 2), (5000, 7, 64), (10_000, 196_608, 2),
                                      (3001, 384, 16), (20_000, 2 ** 24, 1)])
def test_sort_layout_regions_fit(n, rows, F):
    """The one allocation of `segment_sort` on the card: the cleared region
    holds what csrc/segment_sort.cu carves of it (digit counts and tile
    counters, then 32-bit status words); regions 16-byte aligned,
    disjoint, in order."""
    lay = th._SortLayout(n, rows, F)
    radix, tiles = 1 << lay.bits, -(-n // th.SORT_TILE)
    assert 4 * lay.passes * (radix + 1) + 4 * lay.passes * tiles * radix <= lay.zeroed
    pw = F if F <= th.SORT_BY_VALUE_MAX_F else 1
    assert lay.pw == pw and lay.by_value == (F <= 4)
    starts = [lay.keys, lay.payload, lay.offsets, lay.keys_tmp, lay.pay_tmp, lay.total]
    sizes = [4 * n, 4 * n * pw, 4 * (rows + 1)] + ([4 * n, 4 * n * pw] if lay.passes > 1
                                                  else [0, 0])
    for a, b, size in zip(starts, starts[1:], sizes):
        assert a % 16 == 0 and b - a >= size


# ---------------------------------------------------------- the plain sort

@pytest.mark.parametrize("n,rows,F,skew", [
    (0, 5, 2, False), (1, 1, 2, False), (5000, 1, 2, False), (5000, 1, 64, False),
    (300, 20_000, 2, False), (384 * 768 // 8, 384, 64, False), (40_000, 12 * 2 ** 10, 2, False),
    (30_000, 3 * 128 * 128, 16, False), (50_000, 4096, 3, True), (10_000, 777, 5, True)])
def test_plain_sort_is_numpy_stable_argsort(n, rows, F, skew):
    values, idx = _inputs(n, rows, F, n + rows)
    keys, payload, offsets = th.segment_sort(torch.from_numpy(values), torch.from_numpy(idx), rows)
    order = np.argsort(idx, kind="stable")
    assert keys.dtype == offsets.dtype == torch.int32
    np.testing.assert_array_equal(keys.numpy(), idx[order])
    if F <= th.SORT_BY_VALUE_MAX_F:
        assert payload.dtype == torch.float32 and payload.shape == (n, F)
        np.testing.assert_array_equal(payload.numpy().view(np.int32),
                                      values[order].view(np.int32))
    else:
        assert payload.dtype == torch.int32 and payload.shape == (n,)
        np.testing.assert_array_equal(payload.numpy(), order)
    np.testing.assert_array_equal(offsets.numpy(),
                                  np.searchsorted(idx[order], np.arange(rows + 1), "left"))


# ------------------------------------ a transcription of the card's kernels

def _digit_pass(keys, payload, shift, bits):
    """csrc/segment_sort.cu:segment_sort_pass_kernel over every tile in tile
    order (the look-back's counts of earlier tiles as a running sum)."""
    n, radix = len(keys), 1 << bits
    digit = (keys >> shift) & (radix - 1)
    total = np.bincount(digit, minlength=radix)
    start = np.cumsum(total) - total  # the histogram kernel's counts, scanned
    earlier = np.zeros(radix, np.int64)
    keys_out, pay_out = np.full_like(keys, -1), np.zeros_like(payload)
    warps = THREADS // 32
    for base in range(0, n, th.SORT_TILE):
        valid = min(th.SORT_TILE, n - base)
        warp_cnt = np.zeros((warps, radix), np.int64)
        rank = np.zeros(th.SORT_TILE, np.int64)
        for w in range(warps):
            for k in range(ITEMS):
                pos = w * 32 * ITEMS + k * 32 + np.arange(32)
                d = np.where(pos < valid, digit[base + np.minimum(pos, valid - 1)], -1)
                for lane in range(32):
                    if pos[lane] < valid:  # before + popc(peers & lower lanes)
                        rank[pos[lane]] = warp_cnt[w, d[lane]] + (d[:lane] == d[lane]).sum()
                for dd in np.unique(d[pos < valid]):  # the leader's update
                    warp_cnt[w, dd] += (d == dd).sum()
        count = warp_cnt.sum(0)
        warp_start = np.cumsum(warp_cnt, 0) - warp_cnt
        tile_base = np.cumsum(count) - count
        out_base = start + earlier - tile_base
        at = np.array([tile_base[digit[base + t]] + warp_start[t // (32 * ITEMS), digit[base + t]]
                       + rank[t] for t in range(valid)])
        np.testing.assert_array_equal(np.sort(at), np.arange(valid))  # a permutation
        skeys, spay = np.empty(valid, keys.dtype), np.empty((valid,) + payload.shape[1:],
                                                           payload.dtype)
        skeys[at], spay[at] = keys[base:base + valid], payload[base:base + valid]
        to = out_base[(skeys >> shift) & (radix - 1)] + np.arange(valid)
        keys_out[to], pay_out[to] = skeys, spay
        earlier += count
    assert (keys_out >= 0).all()
    return keys_out, pay_out


def _row_starts(keys, rows):
    """csrc/segment_sort.cu:segment_row_starts_kernel, one thread a key."""
    offsets = np.full(rows + 1, -1, np.int64)
    for j, k in enumerate(keys):
        prev = keys[j - 1] if j else -1
        offsets[prev + 1:min(k, rows) + 1] = j
        if j == len(keys) - 1:
            offsets[k + 1:rows + 1] = len(keys)
    assert (offsets >= 0).all()
    return offsets


@pytest.mark.parametrize("n,rows,F,skew", [
    (1, 1, 2, False), (4095, 384, 2, False), (4096, 2, 64, False), (4097, 1000, 1, False),
    (9000, 2 ** 13 + 1, 3, False), (7000, 384, 16, True), (5000, 196_608, 2, False),
    (4000, 2 ** 24, 4, True)])
def test_kernel_passes_transcribed_sort_stably(n, rows, F, skew):
    """Every pass of the card's sort, transcribed, on ragged last tiles,
    one row, two and three passes, skewed rows crossing tiles: the keys,
    the payload (the values where F <= 4, else the lookup index) and the
    row starts equal the stable argsort's."""
    values, idx = _inputs(n, rows, F, 7 * n + rows, skew)
    passes, bits = th.sort_passes(rows)
    keys = idx.astype(np.int64)
    payload = values if F <= th.SORT_BY_VALUE_MAX_F else np.arange(n, dtype=np.int64)
    for p in range(passes):
        keys, payload = _digit_pass(keys, payload, p * bits, bits)
    order = np.argsort(idx, kind="stable")
    np.testing.assert_array_equal(keys, idx[order])
    want = values[order] if F <= th.SORT_BY_VALUE_MAX_F else order
    np.testing.assert_array_equal(payload, want)
    np.testing.assert_array_equal(_row_starts(keys, rows),
                                  np.searchsorted(keys, np.arange(rows + 1), "left"))


def test_row_starts_transcribed_with_most_rows_empty():
    keys = np.array([3, 3, 9, 40, 40, 40, 41, 99], np.int64)
    np.testing.assert_array_equal(_row_starts(keys, 120),
                                  np.searchsorted(keys, np.arange(121), "left"))


# ------------------------------------------------------- the plain sum

def _fixed_order_sum(values, idx, rows, E):
    """`segment_sum_rows`'s order in numpy: a row's values in lookup
    order, value k of the row into partial k mod E, each partial added one
    value after another, then the pairwise tree."""
    part = np.zeros((rows, E, values.shape[1]), np.float32)
    order = np.argsort(idx, kind="stable")
    starts = np.searchsorted(idx[order], np.arange(rows + 1), "left")
    for r in np.flatnonzero(np.diff(starts)):  # a row's values, lane by lane, in order
        js = order[starts[r]:starts[r + 1]]
        for e in range(E):
            for j in js[e::E]:
                part[r, e] += values[j]
    while E > 1:
        E //= 2
        part = part[:, :E] + part[:, E:2 * E]
    return part[:, 0]


@pytest.mark.parametrize("what,n,rows,F", [
    ("no lookup", 0, 10, 2), ("no row", 0, 0, 2), ("one row", 5000, 1, 2),
    ("one row, wide", 3000, 1, 64), ("most rows empty", 300, 20_000, 2),
    ("CP-like", 384 * 768, 384, 64), ("hash-grid-like", 12 * 2 ** 10 * 6, 12 * 2 ** 10, 2)])
def test_plain_segment_sum_at_the_edges(what, n, rows, F):
    """`segment_sum_rows_plain` (and `segment_sum_rows`, which takes it on
    the CPU) bit-equal to the numpy transcription of the order the kernel
    shares: no lookup, no row, every lookup in one row, rows > n with most
    rows empty, CP's 384 rows x 768 lookups x 64 features, a hash grid's
    12 x 2^10 rows x 2 features."""
    values, idx = _inputs(n, rows, F, 11 + n)
    _, E, _ = th.segment_shape(n, rows, F)
    want = _fixed_order_sum(values, idx, rows, E)
    got = th.segment_sum_rows_plain(torch.from_numpy(values), torch.from_numpy(idx), rows)
    assert got.shape == (rows, F) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    again = th.segment_sum_rows(torch.from_numpy(values), torch.from_numpy(idx), rows)
    np.testing.assert_array_equal(again.numpy().view(np.int32), want.view(np.int32))
    if n == 0:
        assert not want.any()


# --------------------------------------------------------------- limits

@pytest.mark.parametrize("fn", ["segment_sum_rows", "segment_sort", "segment_sort_plain"])
def test_limits_raise_before_any_work(fn):
    """2^31 rows, or 2^31 lookups (a stride-0 view: nothing allocated),
    raise a ValueError that names the limit."""
    f = getattr(th, fn)
    one = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match=r"2\^31"):
        f(torch.zeros(1, 2), one, 2 ** 31)
    with pytest.raises(ValueError, match=r"2\^31"):
        f(torch.zeros(1, 2).expand(2 ** 31, 2), one.expand(2 ** 31), 5)
    th.check_segment_limits(2 ** 31 - 1, 2 ** 31 - 1)


def test_other_devices_are_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        th.segment_sort(torch.zeros(4, 2, device="meta"), torch.zeros(4, dtype=torch.int64,
                                                                       device="meta"), 3)
    with pytest.raises(ValueError, match="unsupported device"):
        th.segment_sum_rows(torch.zeros(4, 2, device="meta"),
                            torch.zeros(4, dtype=torch.int64, device="meta"), 3)


# ------------------------------------------------ against the reference

@pytest.mark.parametrize("n,rows,F,skew", [(20_000, 12 * 2 ** 10, 2, False),
                                           (30_000, 384, 64, False), (30_000, 384, 16, True),
                                           (5000, 1, 2, False), (4000, 50_000, 4, True)])
def test_lookup_gradient_matches_the_reference_gather_vjp(n, rows, F, skew):
    """The table gradient of `rounded_lookup` (float32) against the
    reference's jitted gather's VJP (`tables[idx]`, the lookup of
    `tnerf/fields/hashgrid.py:193`), hash-grid-like, CP- and line-like
    (thousands of lookups in a row), one row, most rows empty: both add a
    row's cotangents in float32, in other orders, so within GRAD_L1_RTOL
    of the largest row's sum of |cotangent|."""
    cot, idx = _inputs(n, rows, F, 5 * n + rows, skew)
    table = np.random.default_rng(rows).standard_normal((rows, F), dtype=np.float32)
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(idx)], jnp.asarray(table))
    (want,) = jax.jit(vjp)(jnp.asarray(cot))
    want = np.asarray(want)
    t = torch.from_numpy(table).requires_grad_()
    (got,) = torch.autograd.grad(th.rounded_lookup(t, torch.from_numpy(idx), torch.float32), t,
                                 torch.from_numpy(cot))
    l1 = np.zeros(rows, np.float64)
    np.add.at(l1, idx, np.abs(cot).sum(1))
    assert np.abs(want).max() > 0
    assert np.abs(got.numpy() - want).max() <= GRAD_L1_RTOL * l1.max()


def test_hashgrid_table_gradient_matches_the_reference_jitted_gather():
    """The hash-grid encode's table gradient (eight lookups a level, each
    through `rounded_lookup`) against `jax.jit(jax.vjp)` of the reference's
    `apply_hashgrid_gather` at L = 6, T = 2^10 (two dense levels, four
    hashed), within GRAD_RTOL of the largest entry."""
    from tnerf.fields.hashgrid import apply_hashgrid_gather as j_apply

    ov = ["field_.hash_levels=6", "field_.hash_log2_table_size=10",
          "field_.hash_base_resolution=4", "field_.hash_max_resolution=128"]
    jc, tc = JConfig().apply_overrides(ov).field_, Config().apply_overrides(ov).field_
    rng = np.random.default_rng(23)
    x = rng.random((4000, 3), dtype=np.float32)
    tables = (rng.random((6 * 2 ** 10, 2), dtype=np.float32) * 2e-4 - 1e-4).astype(np.float32)
    g = rng.standard_normal((4000, 12)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: j_apply({"tables": t}, jnp.asarray(x), jc), jnp.asarray(tables))
    (want,) = jax.jit(vjp)(jnp.asarray(g))
    want = np.asarray(want)
    t = torch.from_numpy(tables).requires_grad_()
    (got,) = torch.autograd.grad(th.apply_hashgrid(t, torch.from_numpy(x), tc), t,
                                 torch.from_numpy(g))
    assert (want != 0).mean() > 0.2
    assert np.abs(got.numpy() - want).max() <= GRAD_RTOL * np.abs(want).max()
