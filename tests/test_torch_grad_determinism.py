"""The fixed-point sums of kernel B2 (tnerf_torch/render/fused.py:
`GRAD_SHIFT`, `quantize_grad`, `dequantize_grad`, `bwd_grad_limit`,
`bwd_grad_sums`) on the CPU.  The kernel rounds each (tile, chunk)'s f32
partial of dW and dBias once to a multiple of 2^-GRAD_SHIFT and adds it into
an int64 sum, in whatever order its CTAs reach the sum; here the same
rounding of numpy-seeded partials at the training shape's magnitudes is
summed in shuffled orders and over the tile-to-CTA schedules of two grid
sizes, and the f32 gradient made of the sum is held to the exact sum
rounded once and to the f32 sum of the raw partials.  A flagged sum must
come back non-finite, and the optimizer's non-finite skip must then leave
every parameter and Adam moment as it was.  The kernel itself runs only on
the card (`chip_smoke.py`, `check_backward`)."""

import os
import re

import numpy as np
import pytest
import torch

from tnerf_torch.config import TrainConfig
from tnerf_torch.render import fused as tf
from tnerf_torch.train import create_optimizer

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(tf.__file__))), "csrc",
                    "fused_backward.cu")
# the training batch: 8192 rays x 64 samples, one (tile, chunk) a ray;
# a CPU-sized share of its tiles, each adding one partial per entry
TILES = 384
COLS = 64


def _partials(seed, kind):
    """[TILES, 128, COLS] f32 per-tile partials of one leaf at the
    magnitudes of a training step's (PERF.md: entries of 1e-6 to 1e-2 a
    tile), with what the kernel skips: rows of dead units zero in every
    tile, and a fifth of the tiles' entries zero (masked samples).  kind
    "dW": each entry's tiles scatter around its own mean, so the sums do
    not cancel to nothing; "dBias": the sums cancel (zero-mean partials)."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-6, -2, size=(1, 128, COLS))
    mean = scale * rng.choice([-1.0, 1.0], size=scale.shape) if kind == "dW" else 0.0
    x = mean + scale * rng.standard_normal((TILES, 128, COLS))
    x[:, rng.uniform(size=128) < 0.3] = 0.0
    x[rng.uniform(size=x.shape) < 0.2] = 0.0
    return torch.from_numpy(x.astype(np.float32))


def _grid_sum(q, order, n_ctas):
    """The sum of per-tile partials q, one add at a time in q's dtype, as a
    persistent grid of n_ctas adds them: CTA k takes tiles k, k + n_ctas,
    ... in turn, the CTAs' adds landing in `order` (a permutation of the
    tiles)."""
    total = torch.zeros(q.shape[1:], dtype=q.dtype)
    by_cta = {k: [] for k in range(n_ctas)}
    for t in order:
        by_cta[int(t) % n_ctas].append(int(t))
    for k in np.random.default_rng(n_ctas).permutation(n_ctas):
        for t in by_cta[int(k)]:
            total += q[t]
    return total


@pytest.mark.parametrize("grids", [(132, 37), (1, 132), (7, 64)])
@pytest.mark.parametrize("kind", ["dW", "dBias"])
def test_fixed_point_sum_is_the_same_in_any_order_and_grid(kind, grids):
    x = _partials(1, kind)
    q = tf.quantize_grad(x)
    rng = np.random.default_rng(2)
    orders = [np.arange(TILES)] + [rng.permutation(TILES) for _ in range(2)]
    sums = [_grid_sum(q, order, n) for order in orders for n in grids]
    for s in sums[1:]:
        assert torch.equal(s, sums[0])
    deq = [tf.dequantize_grad(s, torch.zeros(1)) for s in sums]
    assert all(torch.equal(d, deq[0]) for d in deq[1:])
    # the same schedules move an f32 sum of the raw partials, as B2's f32
    # atomics did: what the fixed point takes away
    f32 = [_grid_sum(x, order, n) for order in orders for n in grids]
    assert any(not torch.equal(f, f32[0]) for f in f32[1:])


@pytest.mark.parametrize("kind", ["dW", "dBias"])
def test_dequantized_sum_is_the_exact_sum_rounded_once(kind):
    x = _partials(3, kind)
    q = tf.quantize_grad(x)
    got = tf.dequantize_grad(q.sum(0), torch.zeros(1))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    # float64 holds these sums exactly (|sum| < 2^53 quanta)
    exact = q.numpy().astype(np.float64).sum(0)
    assert np.abs(q.sum(0).numpy()).max() < 2 ** 53
    np.testing.assert_array_equal(got.numpy(), (exact * 2.0 ** -tf.GRAD_SHIFT).astype(np.float32))
    # off the exact sum of the raw partials by at most half a quantum a
    # partial and half an f32 ulp of the result
    raw64 = x.numpy().astype(np.float64).sum(0)
    ulp = np.spacing(np.abs(got.numpy())).astype(np.float64)
    bound = TILES * 2.0 ** -(tf.GRAD_SHIFT + 1) + ulp / 2
    assert (np.abs(got.numpy().astype(np.float64) - raw64) <= bound).all()
    if kind == "dW":  # within 1e-6 of the f32 sum of the raw partials, entries above 1e-6
        raw = x.sum(0)
        big = raw.abs() > 1e-6
        assert int(big.sum()) > 0.5 * raw.numel()
        assert float(((got - raw).abs() / raw.abs())[big].max()) <= 1e-6


@pytest.mark.parametrize("x, want", [
    (2.0 ** -41, 0), (3 * 2.0 ** -41, 2), (5 * 2.0 ** -41, 2), (-3 * 2.0 ** -41, -2),
    (2.0 ** -42, 0), (2.0 ** -17 + 2.0 ** -40, 2 ** 23 + 1), (1.0, 2 ** 40), (-0.0, 0)])
def test_quantize_rounds_half_to_even_as_the_kernel(x, want):
    """`__float2ll_rn` of x 2^40: ties go to the even integer; partials of
    2^-17 and more (x 2^40 >= 2^23, an integer) are kept exactly."""
    assert int(tf.quantize_grad(torch.tensor([x], dtype=torch.float32))[0]) == want


def test_partials_above_two_to_minus_seventeen_come_back_exactly():
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.choice([-1, 1], 4096) * 10.0 ** rng.uniform(-5.1, 3, 4096))
                         .astype(np.float32))
    assert torch.equal(tf.dequantize_grad(tf.quantize_grad(x), torch.zeros(1)), x)


@pytest.mark.parametrize("B, S", [(8192, 64), (8192, 256), (8189, 64), (8192, 32), (1001, 100),
                                  (1, 64), (66000, 1024)])
def test_flag_bound_keeps_every_sum_from_wrapping(B, S):
    n_terms = tf.bwd_tiles(B, S)[0] * tf.n_bwd_chunks(S)
    limit = tf.bwd_grad_limit(B, S)
    assert limit == 2 ** int(np.log2(limit))  # a power of two: exact in float32
    assert n_terms * int(limit) <= 2 ** 62
    assert 2 * n_terms * int(limit) > 2 ** 62  # no tighter than it must be
    # n_terms partials at the bound summed in int64 stay clear of 2^63
    assert abs(int(np.full(n_terms, -int(limit), np.int64).sum())) < 2 ** 63
    if (B, S) == (8192, 64):  # the training batch: 512 in gradient units
        assert limit * 2.0 ** -tf.GRAD_SHIFT == 512.0


def test_flag_word_reads_as_nan_in_the_buffers_last_word():
    with open(CSRC) as fh:
        bits = int(re.search(r"constexpr uint32_t kFlagNaN = (0x[0-9a-f]+)u;", fh.read()).group(1),
                   16)
    buf, qW, qB, flag = tf.bwd_grad_sums(2, "cpu")
    assert flag.data_ptr() == buf[-1:].data_ptr()  # the low half (little-endian)
    buf[-1] = bits
    assert torch.isnan(flag).all()
    g = tf.dequantize_grad(buf[:-1], flag)
    assert g.shape == (qW.numel() + qB.numel(),) and not torch.isfinite(g).any()


def test_flagged_gradient_makes_adam_skip_the_step():
    rng = np.random.default_rng(5)
    NL = 3
    params = {"w": torch.from_numpy(rng.normal(0, 0.1, (NL, 128, 128)).astype(np.float32)),
              "b": torch.from_numpy(rng.normal(0, 0.1, (NL, 128)).astype(np.float32))}
    opt = create_optimizer(TrainConfig(lr_final_fraction=0.1, steps=20), params)
    assert opt.skip_nonfinite

    def step(flagged):
        buf, qW, qB, flag = tf.bwd_grad_sums(NL, "cpu")
        qW.copy_(tf.quantize_grad(torch.from_numpy(
            rng.normal(0, 1e-3, (NL, 128, 128)).astype(np.float32))))
        qB.copy_(tf.quantize_grad(torch.from_numpy(rng.normal(0, 1e-3, (NL, 128))
                                                   .astype(np.float32))))
        if flagged:
            flag.fill_(float("nan"))
        g = tf.dequantize_grad(buf[:-1], flag)
        before = [p.clone() for p in opt.params] + [opt.mu.clone(), opt.nu.clone(),
                                                    opt.count.clone()]
        opt.step([g[:qW.numel()].view(qW.shape), g[qW.numel():].view(qB.shape)])
        after = list(opt.params) + [opt.mu, opt.nu, opt.count]
        return [torch.equal(a, b) for a, b in zip(before, after)]

    assert not any(step(False))  # an unflagged step moves everything
    assert all(step(True))       # a flagged one nothing
    assert int(opt.total_notfinite) == 1
    assert not any(step(False))


def test_lane_exchange_adds_every_entry_in_its_place():
    """csrc/fused_backward.cu's `red_partial`, transcribed: lane l of a warp
    holds f[4 i + 2 h + e] = dW[k0 + l / 4 + 8 h][n0 + 8 i + 2 (l % 4) + e];
    lanes l and l ^ 2 trade their second columns, and each lane adds two
    entries per (i, h).  Every entry must be added once, at its own place,
    each add instruction covering whole 32-byte sectors (four neighbouring
    columns of a row)."""
    held = [{(i, h, e): (l // 4 + 8 * h, 8 * i + 2 * (l % 4) + e)
             for i in range(8) for h in range(2) for e in range(2)} for l in range(32)]
    m = [l % 4 for l in range(32)]
    high = [bool(l & 2) for l in range(32)]
    own = [2 * m[l] for l in range(32)]
    got = [2 * (m[l] ^ 2) + 1 for l in range(32)]
    col0 = [got[l] if high[l] else own[l] for l in range(32)]
    col1 = [own[l] if high[l] else got[l] for l in range(32)]
    added = {}
    for i in range(8):
        for h in range(2):
            a = [held[l][(i, h, 0)] for l in range(32)]
            b = [held[l][(i, h, 1)] for l in range(32)]
            y = [b[l ^ 2] for l in range(32)]
            for cols, vals in ((col0, [y[l] if high[l] else a[l] for l in range(32)]),
                               (col1, [a[l] if high[l] else y[l] for l in range(32)])):
                at = [(l // 4 + 8 * h, 8 * i + cols[l]) for l in range(32)]
                assert len({(r, c // 4) for r, c in at}) == 8  # 8 rows x one sector
                for where, val in zip(at, vals):
                    assert where not in added
                    added[where] = val
    assert len(added) == 16 * 64 and all(where == val for where, val in added.items())
