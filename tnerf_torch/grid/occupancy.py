"""Occupancy grid state and its density-driven refresh (counterpart of
`tnerf/grid/occupancy.py:27-112`): a density EMA per cell, thresholded into
the bitfield that the renderers skip empty space with, optionally held
inside a static mask (a mesh-bounded scene, `grid.mesh_path`,
`grid/mesh.mesh_occupancy_mask`)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tnerf_torch.grid.traversal import cell_size


class OccupancyGridState(NamedTuple):
    density_ema: torch.Tensor  # [res, res, res] f32
    bitfield: torch.Tensor     # [res, res, res] bool
    step: torch.Tensor         # scalar int32 update counter


def _mask3(mask, res: int, device) -> torch.Tensor:
    return torch.as_tensor(mask, device=device).reshape(res, res, res).to(torch.bool)


def init_occupancy(grid, device="cpu", mask=None) -> OccupancyGridState:
    """All-occupied start, or the static mask where one is given.
    density_ema starts at 0, so the first update already reflects the
    field; the bitfield stays dense (within the mask) until then."""
    res = grid.resolution
    bits = torch.ones((res, res, res), dtype=torch.bool, device=device) if mask is None \
        else _mask3(mask, res, device).clone()
    return OccupancyGridState(
        density_ema=torch.zeros((res, res, res), dtype=torch.float32, device=device),
        bitfield=bits,
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def cell_centers(grid, device="cpu") -> torch.Tensor:
    """[res, res, res, 3] world-space cell centers."""
    res = grid.resolution
    lo = torch.as_tensor(grid.aabb_min, dtype=torch.float32, device=device)
    h = torch.tensor(cell_size(grid, res), device=device)
    idx = torch.arange(res, dtype=torch.float32, device=device) + 0.5
    ii, jj, kk = torch.meshgrid(idx, idx, idx, indexing="ij")
    return lo + h * torch.stack([ii, jj, kk], dim=-1)


def ema_threshold_update(density_ema: torch.Tensor, sigma: torch.Tensor, grid,
                         mask=None) -> tuple:
    """(new_ema, bits) from one round of density probes: the decay-max EMA
    (the Instant-NGP update rule) and its threshold.  With a static mask
    the EMA is zeroed outside it before the threshold, so neither the bits
    nor a density_cdf payload derived from the EMA can leave it."""
    ema = torch.clamp_max(density_ema * grid.ema_decay, 1e4)
    ema = torch.maximum(ema, sigma)
    if mask is not None:
        res = grid.resolution
        ema = torch.where(_mask3(mask, res, ema.device), ema, torch.zeros_like(ema))
    return ema, ema > grid.density_threshold


@torch.no_grad()
def update_occupancy(state: OccupancyGridState, density_fn, grid,
                     generator: Optional[torch.Generator] = None,
                     jitter: Optional[torch.Tensor] = None, mask=None) -> OccupancyGridState:
    """One occupancy refresh: one jittered density probe per cell -> EMA ->
    threshold.  density_fn: positions [N, 3] -> sigma [N].  The probe
    offsets are uniform in [-0.5, 0.5) cells, drawn from `generator` on the
    state's device, or given as `jitter` [res, res, res, 3] (so two
    implementations can be fed the same points).  mask: the static
    [res, res, res] bool bound of a mesh-bounded scene, or None."""
    res = grid.resolution
    dev = state.density_ema.device
    centers = cell_centers(grid, dev)
    if jitter is None:
        jitter = torch.rand(centers.shape, generator=generator, dtype=torch.float32,
                            device=dev) - 0.5
    points = centers + jitter * torch.tensor(cell_size(grid, res), device=dev)
    sigma = density_fn(points.reshape(-1, 3)).reshape(res, res, res)
    ema, bits = ema_threshold_update(state.density_ema, sigma, grid, mask)
    return OccupancyGridState(density_ema=ema, bitfield=bits, step=state.step + 1)


def occupancy_fraction(state: OccupancyGridState) -> torch.Tensor:
    return state.bitfield.float().mean()


def renderer_payload(state, sampler_cfg, grid_cfg):
    """The `occupancy=` argument for a renderer of this config
    (`tnerf/grid/occupancy.py:115`): the bool bitfield, or under
    sampler.placement="density_cdf" the f32 density EMA, from which the
    renderer derives the bitfield (ema > grid.density_threshold) and its
    per-bin placement weights.

    Dense start: before the first occupancy update (state.step == 0) the
    bitfield is all ones but the EMA all zero, which would mask every
    sample for the whole warmup.  Until then the f32 payload holds a
    constant above the threshold in every bitfield cell: the bits derive
    back to the initial bitfield and constant weights place near-uniformly.
    The switch is a `torch.where` on the device, not a host read."""
    if state is None:
        return None
    res = grid_cfg.resolution
    if tuple(state.bitfield.shape) != (res, res, res):
        raise ValueError(
            f"occupancy bitfield {tuple(state.bitfield.shape)} does not match "
            f"grid.resolution={res}"
        )
    if sampler_cfg.placement == "density_cdf":
        fill = 2.0 * grid_cfg.density_threshold + 1.0
        dense_start = torch.where(state.bitfield, fill, 0.0)
        return torch.where(state.step > 0, state.density_ema, dense_start)
    return state.bitfield
