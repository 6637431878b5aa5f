"""The host side of the grid walk's kernel B5 (`grid/dda.py`), on the CPU:

- `block_shape`, the rays per block the wrapper launches with: every SM
  given a block at the intervals training batch (4096 rays on 132 SMs),
  blocks that start on a 32-byte sector of the steps-major output, at
  most 256 threads, every ray covered;
- the refusals the kernel's launcher shares with the plain version: a
  coarse grid over 32^3 cells, a factor that does not divide the
  resolution, fewer than one step;
- the coarse cell of a fine index as the kernel forms it (an arithmetic
  shift for a power-of-two factor, a floor division otherwise, both for
  the index -1 a walk leaving the box holds);
- the plain walk at the training shape (16^3, the skipping walk at coarse
  factor 1, 49 steps, the committed prims occupancy pooled to 16^3)
  against the reference's Pallas kernel in interpret mode, bit for bit
  (cells; depths on the rays that hit the box)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.config import GridConfig as JGrid
from tnerf.grid.pallas_dda import march_pallas_raw
from tnerf_torch.config import GridConfig
from tnerf_torch.grid import dda
from tnerf_torch.grid.traversal import make_coarse_occupancy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "runs", "suite_rehearsal", "prims", "checkpoints", "step_00001500.npz")
H100_SMS = 132


@pytest.mark.parametrize("n_rays", [1, 7, 100, 4096, 16384, 32768, 640000])
def test_block_shape_covers_every_ray_in_sector_aligned_blocks(n_rays):
    threads, blocks = dda.block_shape(n_rays, H100_SMS)
    assert 8 <= threads <= dda.MAX_THREADS and threads % 8 == 0
    assert blocks * threads >= n_rays > (blocks - 1) * threads


def test_block_shape_at_the_main_paths_batches():
    # the intervals training batch: every SM has a block (171 of 24 rays)
    threads, blocks = dda.block_shape(4096, H100_SMS)
    assert (threads, blocks) == (24, 171) and blocks >= H100_SMS
    # an eval chunk of 32,768 rays and a 128 x 128 view: one block per SM and a few more
    assert dda.block_shape(32768, H100_SMS) == (248, 133)
    assert dda.block_shape(16384, H100_SMS) == (120, 137)
    # the reference benchmark's 640,000 rays: full blocks of 256
    assert dda.block_shape(640000, H100_SMS) == (256, 2500)
    # a card with fewer SMs gets bigger blocks, never over 256
    assert dda.block_shape(4096, 16) == (256, 16)


def _rays(B, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (B, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.5
    d = rng.uniform(-1.2, 1.2, (B, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d


@pytest.mark.parametrize("res,factor", [(66, 1), (64, 1), (48, 5), (24, 7), (40, 0)])
def test_walk_refuses_coarse_grids_it_does_not_take(res, factor):
    o, d = (torch.from_numpy(a) for a in _rays(4))
    args = dda._ray_setup(o, d, GridConfig(resolution=res))
    words = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 32\\^3 coarse cells"):
        dda.dda_steps(*args, words, res, factor, 8, GridConfig(resolution=res))
    with pytest.raises(ValueError, match="at most 32\\^3 coarse cells"):
        dda.dda_steps_plain(*args, words, res, factor, 8, GridConfig(resolution=res))
    with pytest.raises(ValueError, match="at most 32\\^3 coarse cells"):
        dda.march_raw_plain(o, d, GridConfig(resolution=res),
                            torch.ones((res,) * 3, dtype=torch.bool), coarse_factor=factor)
    # the dense walk takes any resolution
    dda.check_walk(res, factor, 8, skipping=False)


@pytest.mark.parametrize("steps", [0, -1])
def test_walk_refuses_fewer_than_one_step(steps):
    o, d = (torch.from_numpy(a) for a in _rays(4))
    grid = GridConfig(resolution=16)
    args = dda._ray_setup(o, d, grid)
    for words in (None, torch.zeros(1024, dtype=torch.int32)):
        with pytest.raises(ValueError, match="steps >= 1"):
            dda.dda_steps(*args, words, 16, 1, steps, grid)
        with pytest.raises(ValueError, match="steps >= 1"):
            dda.dda_steps_plain(*args, words, 16, 1, steps, grid)


def test_the_kernel_needs_cuda_tensors():
    o, d = (torch.from_numpy(a) for a in _rays(4))
    grid = GridConfig(resolution=16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dda.dda_steps(*dda._ray_setup(o, d, grid), None, 16, 1, 8, grid)


def _coarse_of(i, factor):
    """dda.cu's coarse_of: a shift for a power of two, else a floor division."""
    if factor & (factor - 1) == 0:
        return i >> (factor.bit_length() - 1)
    return i // factor if i >= 0 else -((factor - 1 - i) // factor)


@pytest.mark.parametrize("factor", [1, 2, 3, 4, 5, 6, 8, 16])
def test_coarse_index_is_the_floor_of_the_division(factor):
    for i in range(-1, 129):
        assert _coarse_of(i, factor) == i // factor  # Python's // floors


@pytest.fixture(scope="module")
def occupancy16():
    with np.load(NPZ) as data:
        occ64 = torch.from_numpy(data["leaf_61"].copy())
    return make_coarse_occupancy(occ64, 4)


def test_plain_walk_at_the_training_shape_matches_the_pallas_kernel(occupancy16):
    """16^3, the skipping walk at coarse factor 1 (what traverse_grid runs
    under max_hits = 3 res), 49 steps, 256 rays."""
    B, steps = 256, 49
    o, d = _rays(B, seed=5)
    occ = occupancy16.numpy()
    jt0, jcell, jte, jtx = march_pallas_raw(jnp.asarray(o), jnp.asarray(d), JGrid(resolution=16),
                                            jnp.asarray(occ), coarse_factor=1, steps=steps,
                                            interpret=True)
    t0, cell, te, tx = dda.march_raw_plain(torch.from_numpy(o), torch.from_numpy(d),
                                           GridConfig(resolution=16), occupancy16,
                                           coarse_factor=1, steps=steps)
    assert t0.shape == (steps, B)
    np.testing.assert_array_equal(np.asarray(jcell), cell.numpy())
    hit = np.asarray(jtx > jte)
    assert hit.mean() > 0.5 and (cell.numpy() >= 0).mean() > 0.02
    np.testing.assert_array_equal(np.asarray(jt0)[:, hit], t0.numpy()[:, hit])
