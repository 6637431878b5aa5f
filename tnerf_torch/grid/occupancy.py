"""Occupancy grid state (counterpart of `tnerf/grid/occupancy.py`; the
density refresh `update_occupancy` belongs to the training slice)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class OccupancyGridState(NamedTuple):
    density_ema: torch.Tensor  # [res, res, res] f32
    bitfield: torch.Tensor     # [res, res, res] bool
    step: torch.Tensor         # scalar int32 update counter


def renderer_payload(state, sampler_cfg, grid_cfg):
    """The `occupancy=` argument for a renderer of this config: the bool
    bitfield, after checking that it has the grid's resolution.  The
    density-EMA payload of `density_cdf` placement is not ported yet."""
    if state is None:
        return None
    if sampler_cfg.placement != "uniform":
        raise NotImplementedError(
            f"sampler.placement={sampler_cfg.placement!r} is not yet ported "
            "to tnerf_torch, see ROADMAP.md"
        )
    res = grid_cfg.resolution
    if tuple(state.bitfield.shape) != (res, res, res):
        raise ValueError(
            f"occupancy bitfield {tuple(state.bitfield.shape)} does not match "
            f"grid.resolution={res}"
        )
    return state.bitfield
