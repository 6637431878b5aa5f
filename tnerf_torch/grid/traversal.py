"""Ray-box, occupancy-cell and ray-grid traversal arithmetic (counterpart
of `tnerf/grid/traversal.py`).

The reference's `*_lookup_matmul` / `*_lookup_fast` are one-hot matrix
products that stand in for a gather on a machine where gathers are dear;
here a lookup is the gather through `cell_flat_index`.  The reference's
`lax.scan` walks have one counterpart, the step walk of `grid/dda.py`,
which CUDA tensors run as kernel B5.

Divisions by a constant.  The reference divides by compile-time constants
(a cell size, a probe or sample count) inside jitted steps and Pallas
kernels, and XLA's algebraic simplifier rewrites x / c there into x *
RN(1 / c), the reciprocal rounded once to float32 (under jit, and in
interpret mode too).  The port multiplies by that reciprocal
(`reciprocal`), as a tensor on the data's device, so that the CPU and
the card compute the same: PyTorch divides exactly on the CPU and, by a
Python scalar, multiplies by the reciprocal on the card.  For a power of
two the multiply equals the division."""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch


class Intervals(NamedTuple):
    """Per-ray traversal intervals, static shape, invalid slots masked."""

    t_starts: torch.Tensor  # [..., H] f32
    t_ends: torch.Tensor    # [..., H] f32
    cells: torch.Tensor     # [..., H] int32 flat cell id (x res^2 + y res + z), -1 invalid
    mask: torch.Tensor      # [..., H] bool
    t_enter: torch.Tensor   # [...] f32 entry depth into the grid box
    t_exit: torch.Tensor    # [...] f32 exit depth


@functools.lru_cache(maxsize=None)
def reciprocal(v, dev) -> torch.Tensor:
    """1 / v rounded once to float32, as a tensor on dev: what the
    reference's XLA multiplies by where its source divides by the constant
    v (a cell size, a probe or sample count).  Cached, so that a step does
    not copy it to the card again; callers only read it."""
    with np.errstate(divide="ignore"):
        return torch.tensor(np.float32(1.0) / np.float32(v), dtype=torch.float32, device=dev)


@functools.lru_cache(maxsize=None)
def cell_size(grid, res: int) -> np.ndarray:
    """[3] float32 (hi - lo) / res, rounded as the reference's constant
    (read-only: it is cached)."""
    lo = np.asarray(grid.aabb_min, np.float32)
    hi = np.asarray(grid.aabb_max, np.float32)
    h = (hi - lo) / np.float32(res)
    h.setflags(write=False)
    return h


def ray_aabb(origins, directions, aabb_min, aabb_max):
    """Slab test -> (t_enter, t_exit); the ray hits iff
    t_exit > max(t_enter, 0)."""
    lo = torch.as_tensor(aabb_min, dtype=torch.float32, device=origins.device)
    hi = torch.as_tensor(aabb_max, dtype=torch.float32, device=origins.device)
    tiny = torch.full_like(directions, 1e-12)
    inv_d = 1.0 / torch.where(torch.abs(directions) < 1e-12, tiny, directions)
    t0 = (lo - origins) * inv_d
    t1 = (hi - origins) * inv_d
    t_enter = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    return t_enter, t_exit


def make_coarse_occupancy(occupancy, factor: int):
    """Max-pool a [res]^3 bitfield by `factor` per axis: a coarse cell is
    occupied iff any of its factor^3 fine cells is."""
    res = occupancy.shape[0]
    if res % factor:
        raise ValueError(f"resolution {res} not divisible by factor {factor}")
    c = res // factor
    return occupancy.reshape(c, factor, c, factor, c, factor).any(dim=5).any(dim=3).any(dim=1)


def cell_flat_index(positions, res: int, grid):
    """(inside, flat) nearest-cell arithmetic: multiply by the reciprocal
    of the cell size (the reference's jitted `(p - lo) / cell`), floor,
    clip, flatten as (i * res + j) * res + k."""
    dev = positions.device
    lo = torch.as_tensor(grid.aabb_min, dtype=torch.float32, device=dev)
    rcp = torch.as_tensor(np.float32(1.0) / cell_size(grid, res), device=dev)
    ijk = torch.floor((positions - lo) * rcp).to(torch.int32)
    inside = torch.all((ijk >= 0) & (ijk < res), dim=-1)
    ijk = torch.clamp(ijk, 0, res - 1).long()
    flat = (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]
    return inside, flat


def occupancy_lookup(positions, occupancy, grid):
    """Point-in-occupied-cell test [..., 3] -> [...] bool; the resolution
    comes from a cubic 3-D occupancy, else grid.resolution."""
    res = occupancy.shape[0] if occupancy.dim() == 3 else grid.resolution
    inside, flat = cell_flat_index(positions, res, grid)
    return inside & occupancy.reshape(-1)[flat]


def make_coarse_density(density, factor: int):
    """Max-pool a [res]^3 density grid by `factor` per axis: pooled(density)
    > threshold is exactly the max-pool of the fine bitfield."""
    res = density.shape[0]
    if res % factor:
        raise ValueError(f"resolution {res} not divisible by factor {factor}")
    c = res // factor
    return density.reshape(c, factor, c, factor, c, factor).amax(dim=(1, 3, 5))


def density_lookup(positions, density, grid):
    """Nearest-cell density fetch [..., 3] -> [...] f32, 0 outside the box:
    the probe of density-weighted CDF placement."""
    res = density.shape[0] if density.dim() == 3 else grid.resolution
    inside, flat = cell_flat_index(positions, res, grid)
    vals = density.reshape(-1)[flat].to(torch.float32)
    return torch.where(inside, vals, torch.zeros_like(vals))


def march_samples_t(t_enter, t_exit, n_samples: int, jitter: Optional[torch.Tensor] = None):
    """Fixed-count uniform marching over each ray's [t_enter, t_exit]:
    (t [..., S], delta [..., S]); jitter [..., S] in [0, 1) places each
    sample within its stratum, else at its midpoint."""
    span = torch.clamp_min(t_exit - t_enter, 0.0)
    dt = span * reciprocal(n_samples, span.device)
    frac = torch.arange(n_samples, dtype=torch.float32, device=t_enter.device)
    frac = frac + 0.5 if jitter is None else frac + jitter
    t = t_enter[..., None] + dt[..., None] * frac
    return t, dt[..., None].expand(t.shape)


def tightened_range(origins, directions, t_enter, t_exit, occupancy, grid, probes: int = 64):
    """Shrink each ray's [t_enter, t_exit] to the span of occupied cells,
    by `probes` lookups of `occupancy` (a [c]^3 bool grid at any pooling)
    along the span: the first and last occupied probe, padded by one probe
    step plus one fine-cell diagonal; a ray that no probe hits keeps its
    span.  The version march training uses (`tnerf/grid/traversal.py:369`);
    kernels B3 / B4 (`grid/tighten.py`) compute the same on a packed
    bitfield with their own rounding."""
    span = torch.clamp_min(t_exit - t_enter, 0.0)
    dev = origins.device
    rcp = reciprocal(probes, dev)
    frac = (torch.arange(probes, dtype=torch.float32, device=dev) + 0.5) * rcp
    t = t_enter[..., None] + span[..., None] * frac
    pts = origins[..., None, :] + directions[..., None, :] * t[..., None]
    occ = occupancy_lookup(pts, occupancy, grid)
    inf = torch.full_like(t, float("inf"))
    t_first = torch.amin(torch.where(occ, t, inf), dim=-1)
    t_last = torch.amax(torch.where(occ, t, -inf), dim=-1)
    pad = span * rcp + torch.linalg.norm(torch.tensor(cell_size(grid, grid.resolution),
                                                      device=dev))
    hit = t_last >= t_first
    t0 = torch.where(hit, torch.maximum(t_first - pad, t_enter), t_enter)
    t1 = torch.where(hit, torch.minimum(t_last + pad, t_exit), t_exit)
    return t0, t1


def traverse_grid_twolevel(origins, directions, grid, occupancy, coarse_factor: int = 8,
                           max_hits: Optional[int] = None,
                           steps: Optional[int] = None) -> Intervals:
    """The walk that jumps across empty coarse cells
    (`tnerf/grid/traversal.py:233`): intervals of the fine cells inside
    occupied coarse cells, the fine occupancy applied to them.  It is the
    skipping mode of `grid/dda.py`'s walk."""
    from tnerf_torch.grid.dda import traverse_grid_dda

    if occupancy is None:
        raise ValueError("traverse_grid_twolevel needs an occupancy bitfield")
    return traverse_grid_dda(origins, directions, grid, occupancy, coarse_factor,
                             max_hits=max_hits, steps=steps)


def traverse_grid(origins, directions, grid, occupancy=None,
                  max_hits: Optional[int] = None) -> Intervals:
    """A ray's grid-cell intervals, occupied ones only if an occupancy
    bitfield ([res]^3 bool) is given; at most max_hits of them (default
    grid.effective_max_hits = 3 res), invalid slots masked
    (`tnerf/grid/traversal.py:72`).

    CUDA tensors walk through kernel B5, CPU tensors through its plain
    version.  Which walk: dense (every crossed cell takes a slot, the
    occupancy is applied to the slots afterwards) when there is no
    occupancy or when max_hits < 3 res; skipping (coarse factor max(1, res
    // 16): empty coarse cells take one step, and no slot that survives the
    mask) when max_hits >= 3 res.  The reference's walk is dense and spends
    its budget on every crossed cell, so a budget that cuts a ray must cut
    the port's dense walk at the same cell; where the budget cuts no ray
    both walks keep the same occupied cells with the same bounds, in order,
    which is all the intervals renderer reads."""
    from tnerf_torch.grid.dda import traverse_grid_dda

    res = grid.resolution
    H = max_hits if max_hits is not None else grid.effective_max_hits
    if occupancy is not None and H >= 3 * res:
        return traverse_grid_dda(origins, directions, grid, occupancy,
                                 coarse_factor=max(1, res // 16), max_hits=H)
    return _mask_dense(traverse_grid_dda(origins, directions, grid, None, max_hits=H),
                       occupancy, res)


def _mask_dense(iv: Intervals, occupancy, res: int) -> Intervals:
    """A dense walk's intervals with the fine occupancy applied."""
    if occupancy is None:
        return iv
    occ = occupancy.reshape(-1)
    mask = iv.mask & occ[torch.clamp(iv.cells, 0, res ** 3 - 1).long()]
    zero = torch.zeros_like(iv.t_starts)
    return iv._replace(t_starts=torch.where(mask, iv.t_starts, zero),
                       t_ends=torch.where(mask, iv.t_ends, zero),
                       cells=torch.where(mask, iv.cells, torch.full_like(iv.cells, -1)),
                       mask=mask)
