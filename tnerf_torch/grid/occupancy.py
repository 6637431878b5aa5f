"""Occupancy grid state and its density-driven refresh (counterpart of
`tnerf/grid/occupancy.py:27-112`, without the static mesh mask): a density
EMA per cell, thresholded into the bitfield that the renderers skip empty
space with."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class OccupancyGridState(NamedTuple):
    density_ema: torch.Tensor  # [res, res, res] f32
    bitfield: torch.Tensor     # [res, res, res] bool
    step: torch.Tensor         # scalar int32 update counter


def init_occupancy(grid, device="cpu") -> OccupancyGridState:
    """All-occupied start.  density_ema starts at 0, so the first update
    already reflects the field; the bitfield stays dense until then."""
    res = grid.resolution
    return OccupancyGridState(
        density_ema=torch.zeros((res, res, res), dtype=torch.float32, device=device),
        bitfield=torch.ones((res, res, res), dtype=torch.bool, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def cell_centers(grid, device="cpu") -> torch.Tensor:
    """[res, res, res, 3] world-space cell centers."""
    res = grid.resolution
    lo = torch.as_tensor(grid.aabb_min, dtype=torch.float32, device=device)
    hi = torch.as_tensor(grid.aabb_max, dtype=torch.float32, device=device)
    idx = torch.arange(res, dtype=torch.float32, device=device) + 0.5
    ii, jj, kk = torch.meshgrid(idx, idx, idx, indexing="ij")
    return lo + (hi - lo) / res * torch.stack([ii, jj, kk], dim=-1)


def ema_threshold_update(density_ema: torch.Tensor, sigma: torch.Tensor, grid) -> tuple:
    """(new_ema, bits) from one round of density probes: the decay-max EMA
    (the Instant-NGP update rule) and its threshold."""
    ema = torch.clamp_max(density_ema * grid.ema_decay, 1e4)
    ema = torch.maximum(ema, sigma)
    return ema, ema > grid.density_threshold


@torch.no_grad()
def update_occupancy(state: OccupancyGridState, density_fn, grid,
                     generator: Optional[torch.Generator] = None,
                     jitter: Optional[torch.Tensor] = None) -> OccupancyGridState:
    """One occupancy refresh: one jittered density probe per cell -> EMA ->
    threshold.  density_fn: positions [N, 3] -> sigma [N].  The probe
    offsets are uniform in [-0.5, 0.5) cells, drawn from `generator` on the
    state's device, or given as `jitter` [res, res, res, 3] (so two
    implementations can be fed the same points)."""
    res = grid.resolution
    dev = state.density_ema.device
    lo = torch.as_tensor(grid.aabb_min, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(grid.aabb_max, dtype=torch.float32, device=dev)
    centers = cell_centers(grid, dev)
    if jitter is None:
        jitter = torch.rand(centers.shape, generator=generator, dtype=torch.float32,
                            device=dev) - 0.5
    points = centers + jitter * ((hi - lo) / res)
    sigma = density_fn(points.reshape(-1, 3)).reshape(res, res, res)
    ema, bits = ema_threshold_update(state.density_ema, sigma, grid)
    return OccupancyGridState(density_ema=ema, bitfield=bits, step=state.step + 1)


def occupancy_fraction(state: OccupancyGridState) -> torch.Tensor:
    return state.bitfield.float().mean()


def renderer_payload(state, sampler_cfg, grid_cfg):
    """The `occupancy=` argument for a renderer of this config: the bool
    bitfield, after checking that it has the grid's resolution.  The
    density-EMA payload of `density_cdf` placement is not ported yet."""
    if state is None:
        return None
    if sampler_cfg.placement == "density_cdf":
        raise NotImplementedError(
            "sampler.placement='density_cdf' is not yet ported to tnerf_torch, see ROADMAP.md"
        )
    res = grid_cfg.resolution
    if tuple(state.bitfield.shape) != (res, res, res):
        raise ValueError(
            f"occupancy bitfield {tuple(state.bitfield.shape)} does not match "
            f"grid.resolution={res}"
        )
    return state.bitfield
