"""The host side of kernels B3 and B4 (tnerf_torch/grid/tighten.py): the
choice of lanes per ray, and a transcription of the kernels' scan and
mask stores held bit-equal to the plain versions, with the count of
probes the scan evaluates.  The kernels themselves run only on the card
(`chip_smoke.py`); nothing here needs one, nor JAX."""

import functools
import os

import numpy as np
import pytest
import torch

from tnerf_torch.config import GridConfig
from tnerf_torch.grid import tighten as tg
from tnerf_torch.grid.traversal import make_coarse_occupancy, ray_aabb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "runs", "suite_rehearsal", "prims", "checkpoints", "step_00001500.npz")
H100 = (132, 2048)  # SMs, resident threads per SM
GRID = GridConfig()


@pytest.mark.parametrize("n_sms", [1, 132])
@pytest.mark.parametrize("probes", [16, 64, 100, 256, 1024])
@pytest.mark.parametrize("n_rays", [0, 1, 1001, 8192, 8448, 32000, 66000, 270336, 640000])
def test_lane_group_fills_the_card_and_bounds_the_rounds(n_rays, probes, n_sms):
    G = tg.lane_group(n_rays, probes, n_sms)
    slots = n_sms * 2048
    assert G in (8, 16, 32)
    # B x G threads cover the card's resident slots where the rays allow it
    assert n_rays * G >= slots or G == 32
    # a full pass over the probes takes at most 8 rounds where 32 lanes allow it
    assert -(-probes // G) <= 8 or G == 32
    # and G is the least that does both
    if G > 8:
        assert n_rays * (G // 2) < slots or -(-probes // (G // 2)) > 8


@pytest.mark.parametrize("n_rays, probes, want", [
    (8192, 256, 32), (32000, 256, 32), (66000, 256, 32), (32000, 64, 16), (1, 256, 32),
    (640000, 64, 8), (640000, 100, 16), (640000, 256, 32)])
def test_lane_group_at_the_main_paths_shapes(n_rays, probes, want):
    """The training batch, the serving chunk, 66,000 rays (256 probes), the
    march eval (64 probes) and an 800x800 view on an H100."""
    assert tg.lane_group(n_rays, probes, *H100) == want


def _rays(n=384, seed=7, near=2.0):
    """Camera-like rays towards a jittered point near the origin (a tenth
    miss the box, so te == tx after the near clamp), and every 9th ray
    given an empty span inside the box."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * rng.uniform(3.0, 4.0, (n, 1))
    target = rng.uniform(-0.6, 0.6, (n, 3))
    target[: n // 10] += 3.0
    d = target - o
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    o = torch.from_numpy(o.astype(np.float32))
    te, tx = ray_aabb(o, d, GRID.aabb_min, GRID.aabb_max)
    te = torch.clamp_min(te, near)
    tx = torch.maximum(tx, te)
    tx[::9] = te[::9]
    return o, d, te, tx


@functools.lru_cache(maxsize=None)
def _occupancy(kind: str, c: int) -> torch.Tensor:
    """[c, c, c] bool: the committed prims model's occupancy pooled to c
    (a ball and a shell of the same scale where 64 / c is not whole), or a
    random 10% one."""
    if kind == "random":
        return torch.from_numpy(np.random.default_rng(c).uniform(size=(c,) * 3) < 0.1)
    if 64 % c == 0:
        with np.load(NPZ) as data:
            return make_coarse_occupancy(torch.from_numpy(data["leaf_61"].copy()), 64 // c)
    x = (np.arange(c) + 0.5) / c * 2 - 1
    r = np.sqrt(sum(a ** 2 for a in np.meshgrid(x, x, x, indexing="ij")))
    return torch.from_numpy((r < 0.3) | ((r > 0.6) & (r < 0.75)))


@functools.lru_cache(maxsize=None)
def _plain(kind, c, probes):
    o, d, te, tx = _rays()
    return tg.tighten_range_plain(o, d, te, tx, tg.pack_words_rows(_occupancy(kind, c)), c, GRID,
                                  probes)


def _probe_bits(o, d, te, tx, words, c, probes):
    """[B, probes] occupancy of every probe, each rounded as the plain
    version rounds it; rays without a span have none."""
    lo, cell, _ = tg.coarse_constants(GRID, c)
    span = torch.clamp_min(tx - te, 0.0)
    frac = (torch.arange(probes, dtype=torch.float32) + 0.5) * tg.reciprocal(probes, "cpu")
    t = te[:, None] + span[:, None] * frac[None, :]
    bits = tg.occ_bit(*(o[:, a, None] + d[:, a, None] * t for a in range(3)), words, c, lo, cell)
    return bits & (span > 0)[:, None]


def _expected_evaluated(bits, G):
    """What the scan evaluates per ray, from its first and last occupied
    probe: whole forward rounds up to the one holding the first, then
    backward rounds above it down to the one holding the last."""
    B, probes = bits.shape
    out = []
    for row in bits.tolist():
        hits = [i for i, b in enumerate(row) if b]
        if not hits:
            out.append(probes)  # a ray without a span is masked by the caller
            continue
        first, last = hits[0], hits[-1]
        above = (first // G + 1) * G
        fwd = min(probes, above)
        if above >= probes:
            bwd = 0
        elif last >= above:
            bwd = min(probes - above, ((probes - 1 - last) // G + 1) * G)
        else:
            bwd = probes - above
        out.append(fwd + bwd)
    return torch.tensor(out)


@pytest.mark.parametrize("group", [1, 4, 8, 32])
@pytest.mark.parametrize("probes", [64, 100, 256])
@pytest.mark.parametrize("res_c", [1, 7, 16, 32])
@pytest.mark.parametrize("kind", ["random", "model"])
def test_scan_is_bit_equal_to_the_plain_version(kind, res_c, probes, group):
    o, d, te, tx = _rays()
    words = tg.pack_words_rows(_occupancy(kind, res_c))
    t0, t1, evaluated = tg.tighten_range_scan(o, d, te, tx, words, res_c, GRID, probes, group)
    p0, p1 = _plain(kind, res_c, probes)
    assert torch.equal(t0, p0) and torch.equal(t1, p1)
    bits = _probe_bits(o, d, te, tx, words, res_c, probes)
    has_span = tx > te
    want = torch.where(has_span, _expected_evaluated(bits, group), 0)
    assert torch.equal(evaluated, want)
    assert int(evaluated.max()) <= probes  # no probe twice
    assert not evaluated[~has_span].any()


def _cells_of_probe(o, d, te, tx, c, probes, which):
    """[c, c, c] bool occupied exactly at the cells that probe `which` of
    the rays with a span falls in."""
    lo, cell, _ = tg.coarse_constants(GRID, c)
    span = torch.clamp_min(tx - te, 0.0)
    frac = (torch.tensor(float(which)) + 0.5) * tg.reciprocal(probes, "cpu")
    t = te + span * frac
    idx = []
    for a in range(3):
        p = o[:, a] + d[:, a] * t
        idx.append(torch.clamp(torch.floor((p - torch.tensor(lo[a])) / torch.tensor(cell[a])), 0,
                               c - 1).long())
    occ = torch.zeros((c,) * 3, dtype=torch.bool)
    keep = span > 0
    occ[idx[0][keep], idx[1][keep], idx[2][keep]] = True
    return occ


@pytest.mark.parametrize("group", [1, 8, 32])
@pytest.mark.parametrize("probes", [64, 100, 256])
@pytest.mark.parametrize("case", ["full", "empty", "first probe", "last probe"])
def test_scan_edges(case, probes, group):
    """Every probe occupied (hits at the first and the last probe), none
    (every ray makes one full pass, or none without a span), and only the
    cells of the first or of the last probe of each ray."""
    o, d, te, tx = _rays()
    c = 32
    occ = {"full": torch.ones((c,) * 3, dtype=torch.bool),
           "empty": torch.zeros((c,) * 3, dtype=torch.bool)}.get(case)
    if occ is None:
        occ = _cells_of_probe(o, d, te, tx, c, probes, 0 if case == "first probe" else probes - 1)
    words = tg.pack_words_rows(occ)
    t0, t1, evaluated = tg.tighten_range_scan(o, d, te, tx, words, c, GRID, probes, group)
    p0, p1 = tg.tighten_range_plain(o, d, te, tx, words, c, GRID, probes)
    assert torch.equal(t0, p0) and torch.equal(t1, p1)
    has_span = tx > te
    bits = _probe_bits(o, d, te, tx, words, c, probes)
    if case == "full":
        assert bits[has_span].all()
        assert (evaluated[has_span] == min(group, probes)
                + (min(group, probes - group) if probes > group else 0)).all()
    elif case == "empty":
        assert torch.equal(t0, te) and torch.equal(t1, tx)
        assert (evaluated[has_span] == probes).all()
    else:
        which = 0 if case == "first probe" else probes - 1
        assert bits[has_span, which].all()
        assert torch.equal(evaluated, torch.where(has_span, _expected_evaluated(bits, group), 0))
    assert not evaluated[~has_span].any()


@pytest.mark.parametrize("seed", range(8))
def test_probe_depths_do_not_decrease(seed):
    """t_i = te + span * ((i + 0.5) * (1 / probes)), each operation rounded
    to float32, is non-decreasing in i for span >= 0: the reason the scan
    may stop at the first and last occupied probe."""
    rng = np.random.default_rng(seed)
    n = 64
    te = torch.from_numpy(np.concatenate([rng.uniform(-10, 10, n - 4), [0.0, -0.0, 1e-30, 7.5]])
                          .astype(np.float32))
    span = torch.from_numpy(np.concatenate([rng.uniform(0, 100, n - 8) * rng.choice(
        [1.0, 1e-3, 1e-6], n - 8), [0.0, 1e-38, 1e-7, 3.0, 2.0, 0.5, 1e4, 3.4e3]])
        .astype(np.float32))
    for probes in [int(p) for p in rng.integers(1, 4097, 6)] + [64, 100, 256]:
        frac = (torch.arange(probes, dtype=torch.float32) + 0.5) * tg.reciprocal(probes, "cpu")
        t = te[:, None] + span[:, None] * frac[None, :]
        assert (torch.diff(t, dim=1) >= 0).all()


def mask_store_units(row_start: int, n: int):
    """The stores that write one ray's mask row of n bytes at byte
    offset row_start of the mask, as (offset in the row, width) in the
    order csrc/tighten.cu's tighten_mask_kernel numbers them: a byte up
    to the first 2-byte boundary, 2-byte stores, then a tail byte. Unit
    u goes to lane u % G of the ray's group."""
    head = min(row_start % 2, n)
    pairs = (n - head) // 2
    return ([(s, 1) for s in range(head)] + [(head + 2 * w, 2) for w in range(pairs)]
            + [(s, 1) for s in range(head + 2 * pairs, n)])


def tighten_sample_mask_scan(o, d, te, tx, occ_coarse, n_samples: int, grid, probes: int = 256,
                             group: int = 32):
    """B4 transcribed (any device): `tighten_range_scan`, then each
    ray's row written store by store as `mask_store_units` cuts it, lane
    u % G testing the midpoints of unit u.  Returns (t0, t1, mask [B,
    n_samples] bool, evaluated)."""
    res_c = occ_coarse.shape[0]
    words = tg.pack_words_rows(occ_coarse)
    lo, cell_c, _ = tg.coarse_constants(grid, res_c)
    t0, t1, evaluated = tg.tighten_range_scan(o, d, te, tx, words, res_c, grid, probes, group)
    dev = o.device
    B = te.shape[0]
    dt = (t1 - t0) * tg.reciprocal(n_samples, dev)
    mask = torch.zeros((B, n_samples), dtype=torch.bool, device=dev)
    ray = torch.arange(B, device=dev)
    for phase in range(2):  # rays whose rows start at the same offset modulo 2
        rows = ray[(ray * n_samples) % 2 == phase]
        units = mask_store_units(phase, n_samples)
        for lane in range(group):
            for start, width in units[lane::group]:
                s = torch.arange(start, start + width, dtype=torch.float32, device=dev) + 0.5
                t = t0[rows, None] + dt[rows, None] * s[None, :]
                bit = tg.occ_bit(*(o[rows, a, None] + d[rows, a, None] * t for a in range(3)),
                              words, res_c, lo, cell_c)
                mask[rows, start:start + width] = bit & (t1[rows] > t0[rows])[:, None]
    return t0, t1, mask, evaluated



@pytest.mark.parametrize("row_start", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 33, 64, 96, 100])
def test_mask_stores_cover_a_row_once_aligned(n, row_start):
    units = mask_store_units(row_start, n)
    covered = [s for start, width in units for s in range(start, start + width)]
    assert covered == list(range(n))
    assert all(width in (1, 2) for _, width in units)
    assert all((row_start + start) % 2 == 0 for start, width in units if width == 2)
    singles = [start for start, width in units if width == 1]
    assert len(singles) <= 2 and all(s in (0, n - 1) for s in singles)


@pytest.mark.parametrize("group", [1, 4, 8, 32])
@pytest.mark.parametrize("n", [1, 33, 64, 96])
@pytest.mark.parametrize("probes", [64, 256])
def test_mask_transcription_is_bit_equal_to_the_plain_version(probes, n, group):
    o, d, te, tx = _rays(160, seed=3)
    occ = _occupancy("model", 16)
    t0, t1, mask, _ = tighten_sample_mask_scan(o, d, te, tx, occ, n, GRID, probes, group)
    p0, p1, pm = tg.tighten_sample_mask_plain(o, d, te, tx, occ, n, GRID, probes)
    assert torch.equal(t0, p0) and torch.equal(t1, p1) and torch.equal(mask, pm)
    assert 0 < int(mask.sum()) < mask.numel()


@pytest.mark.parametrize("v", [1, 3, 64, 96, 100, 256])
def test_reciprocal_is_the_rounded_float32_reciprocal(v):
    r = tg.reciprocal(v, "cpu")
    assert r.dtype == torch.float32 and float(r) == float(np.float32(1) / np.float32(v))
    x = torch.from_numpy(np.random.default_rng(v).uniform(0, 10, 1000).astype(np.float32))
    if v & (v - 1) == 0:  # a power of two: the same as the division
        assert torch.equal(x * r, x / torch.tensor(float(v)))


def test_launch_constants_are_computed_once_per_grid():
    a = tg._coarse_floats(GRID, 32)
    assert tg._coarse_floats(GridConfig(), 32) is a
    lo, cell, diag = tg.coarse_constants(GRID, 32)
    # the kernels take the reciprocals of the cell size (the reference's XLA multiplies by them)
    rcp = np.float32(1.0) / cell
    assert a == (tuple(float(np.float32(v)) for v in (*lo, *rcp)), float(np.float32(diag)))
    other = tg._coarse_floats(GridConfig(aabb_min=(-1.5, -1.5, -1.5), aabb_max=(1.5, 1.5, 1.5)), 32)
    assert other != a
