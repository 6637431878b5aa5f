"""The grid walk (kernel B5's plain version) and `traverse_grid` against the
reference package, on the CPU:

- `march_raw_plain` against the Pallas kernel in interpret mode
  (`march_pallas_raw(interpret=True)`), dense and with occupancy, 16^3 at
  coarse factor 4 and 32^3 at factor 8: cells equal, and the step depths
  bitwise equal on the rays that hit the box (a ray that misses converts
  out-of-range floats to int, which the two frameworks do differently;
  all of its cells are -1 in both);
- the port's `traverse_grid` against the reference's scan walks
  `traverse_grid` and `traverse_grid_twolevel`: per ray the same masked
  cells in order, bounds within 3e-4 (the scan walk carries each axis's
  next crossing by repeated addition, the kernel recomputes it from the
  cell index: the tolerance `tests/test_pallas_dda.py` states);
- the cut and the padding to max_hits, the sentinel end of a cut walk, and
  which walk `traverse_grid` takes on either side of max_hits = 3 res.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tnerf.config import GridConfig as JGrid
from tnerf.grid.pallas_dda import march_pallas_raw
from tnerf.grid.pallas_dda import pack_coarse_words as j_pack
from tnerf.grid.traversal import traverse_grid as j_traverse
from tnerf.grid.traversal import traverse_grid_twolevel as j_twolevel
from tnerf_torch.config import GridConfig
from tnerf_torch.grid import dda
from tnerf_torch.grid.traversal import traverse_grid, traverse_grid_twolevel

# The suite runs several workers side by side: more threads each only fight.
torch.set_num_threads(2)

T_ATOL = 3e-4


def _rays(B, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (B, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.5
    t = rng.uniform(-1.2, 1.2, (B, 3))
    d = t - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d


def _occ(res, seed=2, p=0.08):
    return np.random.default_rng(seed).uniform(0, 1, (res, res, res)) < p


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_interval_parity(ref, got, B):
    for b in range(B):
        rm, gm = np.asarray(ref.mask[b]), got.mask[b].numpy()
        np.testing.assert_array_equal(np.asarray(ref.cells[b])[rm], got.cells[b].numpy()[gm])
        np.testing.assert_allclose(np.asarray(ref.t_starts[b])[rm], got.t_starts[b].numpy()[gm],
                                   atol=T_ATOL, rtol=0)
        np.testing.assert_allclose(np.asarray(ref.t_ends[b])[rm], got.t_ends[b].numpy()[gm],
                                   atol=T_ATOL, rtol=0)


@pytest.mark.parametrize("res,factor,with_occ", [
    (16, 4, False), (16, 4, True), (32, 8, True), (32, 8, False)])
def test_plain_walk_is_bit_equal_to_the_pallas_kernel(res, factor, with_occ):
    B = 300
    o, d = _rays(B)
    occ = _occ(res) if with_occ else None
    jt0, jcell, jte, jtx = march_pallas_raw(_j(o), _j(d), JGrid(resolution=res), _j(occ),
                                            coarse_factor=factor, interpret=True)
    t0, cell, te, tx = dda.march_raw_plain(_t(o), _t(d), GridConfig(resolution=res), _t(occ),
                                           coarse_factor=factor)
    assert t0.shape == (3 * res, B) and cell.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jte), te.numpy())
    np.testing.assert_array_equal(np.asarray(jtx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jcell), cell.numpy())
    hit = np.asarray(jtx > jte)
    assert 0.5 < hit.mean() <= 1.0 and (cell.numpy() >= 0).mean() > 0.05
    np.testing.assert_array_equal(np.asarray(jt0)[:, hit], t0.numpy()[:, hit])
    assert (cell.numpy()[:, ~hit] == -1).all()


def test_pack_coarse_words_is_the_reference_bitfield():
    occ = _occ(16, seed=3, p=0.3)
    words = dda.pack_coarse_words(_t(occ)).numpy()
    assert words.shape == (1024,) and words.dtype == np.int32
    np.testing.assert_array_equal(words[:128], np.asarray(j_pack(_j(occ)))[0])
    assert not words[128:].any()


@pytest.mark.parametrize("res,with_occ,max_hits", [
    (16, False, 48), (16, True, 48), (32, True, 96), (16, True, 20), (32, True, 40),
    (16, False, 20), (16, True, 64)])
def test_traverse_grid_matches_the_scan_walk(res, with_occ, max_hits):
    """Both sides of the rule: max_hits >= 3 res takes the skipping walk,
    which no budget cuts; a smaller budget takes the dense walk, which the
    budget cuts where it cuts the reference's."""
    B = 300
    o, d = _rays(B, seed=1)
    occ = _occ(res) if with_occ else None
    ref = j_traverse(_j(o), _j(d), JGrid(resolution=res), occupancy=_j(occ), max_hits=max_hits)
    got = traverse_grid(_t(o), _t(d), GridConfig(resolution=res), _t(occ), max_hits=max_hits)
    assert got.mask.shape == (B, max_hits) and got.cells.dtype == torch.int32
    assert int(got.mask.sum()) > B
    _assert_interval_parity(ref, got, B)
    np.testing.assert_array_equal(np.asarray(ref.t_enter), got.t_enter.numpy())
    np.testing.assert_array_equal(np.asarray(ref.t_exit), got.t_exit.numpy())
    assert (got.cells[~got.mask] == -1).all() and (got.t_ends[~got.mask] == 0).all()
    if with_occ:
        assert _t(occ).reshape(-1)[got.cells[got.mask].long()].all()
    if max_hits < 3 * res and not with_occ:
        # the dense walk fills the reference's slots one for one
        np.testing.assert_array_equal(np.asarray(ref.mask), got.mask.numpy())


@pytest.mark.parametrize("res,factor", [(16, 4), (32, 8), (16, 1)])
def test_traverse_grid_twolevel_matches_the_reference(res, factor):
    B = 200
    o, d = _rays(B, seed=5)
    occ = _occ(res, seed=6)
    ref = j_twolevel(_j(o), _j(d), JGrid(resolution=res), _j(occ), coarse_factor=factor)
    got = traverse_grid_twolevel(_t(o), _t(d), GridConfig(resolution=res), _t(occ),
                                 coarse_factor=factor)
    np.testing.assert_array_equal(np.asarray(ref.mask), got.mask.numpy())
    np.testing.assert_array_equal(np.asarray(ref.cells), got.cells.numpy())
    m = got.mask.numpy()
    np.testing.assert_allclose(np.asarray(ref.t_starts)[m], got.t_starts.numpy()[m],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.asarray(ref.t_ends)[m], got.t_ends.numpy()[m],
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="needs an occupancy"):
        traverse_grid_twolevel(_t(o), _t(d), GridConfig(resolution=res), None)


def test_capacity_cut_padding_and_sentinel():
    o, d = _rays(64, seed=4)
    grid = GridConfig(resolution=16)
    padded = dda.traverse_grid_dda(_t(o), _t(d), grid, max_hits=64, steps=48)
    assert padded.cells.shape == (64, 64) and not padded.mask[:, 48:].any()
    assert (padded.cells[:, 48:] == -1).all() and (padded.t_ends[:, 48:] == 0).all()
    cut = dda.traverse_grid_dda(_t(o), _t(d), grid, max_hits=10, steps=48)
    assert cut.cells.shape == (64, 10)
    assert torch.equal(cut.cells, padded.cells[:, :10])
    # a walk that the budget cuts ends its last interval at that cell's own
    # exit (the depth at which the next step would start), not at t_exit
    oo = torch.tensor([[-3.0, 0.01, 0.02]])
    dd = torch.tensor([[1.0, 0.0, 0.0]])
    got = dda.traverse_grid_dda(oo, dd, grid, steps=5, max_hits=5)
    want = j_traverse(_j(oo.numpy()), _j(dd.numpy()), JGrid(resolution=16), max_hits=5)
    np.testing.assert_allclose(got.t_ends[0].numpy(), np.asarray(want.t_ends[0]), atol=1e-5)
    np.testing.assert_allclose(got.t_starts[0].numpy(), np.asarray(want.t_starts[0]), atol=1e-5)
    assert float(got.t_ends[0, -1]) < float(got.t_exit[0]) - 1.0
    # batch shapes carry through
    iv = traverse_grid(_t(o).reshape(8, 8, 3), _t(d).reshape(8, 8, 3), grid)
    assert iv.mask.shape == (8, 8, 48) and iv.t_enter.shape == (8, 8)


def test_walk_refuses_what_the_kernel_cannot_hold():
    o, d = _rays(8)
    with pytest.raises(ValueError, match="coarse grid"):
        dda.march_raw_plain(_t(o), _t(d), GridConfig(resolution=128), _t(_occ(128)),
                            coarse_factor=2)
    with pytest.raises(ValueError, match="coarse grid"):
        dda.march_raw_plain(_t(o), _t(d), GridConfig(resolution=16), _t(_occ(16)),
                            coarse_factor=3)
    with pytest.raises(ValueError, match="CUDA"):
        dda.dda_steps(*dda._ray_setup(_t(o), _t(d), GridConfig(resolution=16)), None, 16, 1, 4,
                      GridConfig(resolution=16))
    assert dda.march_raw.launches == 0  # nothing on the CPU counts as a launch
