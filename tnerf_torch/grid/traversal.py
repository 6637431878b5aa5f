"""Ray-box and occupancy-cell arithmetic (counterpart of the parts of
`tnerf/grid/traversal.py` that the fused render path uses)."""

from __future__ import annotations

import torch


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
    """(inside, flat) nearest-cell arithmetic: divide by the cell size,
    floor, clip, flatten as (i * res + j) * res + k."""
    lo = torch.as_tensor(grid.aabb_min, dtype=torch.float32, device=positions.device)
    hi = torch.as_tensor(grid.aabb_max, dtype=torch.float32, device=positions.device)
    ijk = torch.floor((positions - lo) / ((hi - lo) / res)).to(torch.int32)
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
