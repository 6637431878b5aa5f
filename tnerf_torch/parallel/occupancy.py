"""The occupancy refresh with its cell probes sharded over the mesh
(counterpart of `tnerf/parallel/occupancy.py`).

A refresh probes one jittered point per cell: res^3 field evaluations that
a replicated `grid.occupancy.update_occupancy` repeats on every rank.
Given `sharded_density` as its density function, every rank draws the same
jitter (the generator is seeded alike on every rank), evaluates its
contiguous slice of the flat cells (padded to a multiple of the rank
count), and an all_gather over the world, whose rank order is the mesh's
row-major order, reassembles the densities; the EMA and the threshold stay
replicated.  The result is that of the replicated update: each position is
evaluated by one rank, at the same point.  Used on DP and DP x SP meshes,
whose parameters every rank holds whole; under table parallelism the
replicated update runs, its density encode sharded like the renderers'.
"""

from __future__ import annotations

import torch

from tnerf_torch.parallel import comm


def sharded_density(density_fn, mesh):
    """positions [N, 3] -> sigma [N], as density_fn, with each rank of
    `mesh` evaluating its contiguous slice of the N positions (the last
    slices padded with zeros) and the slices gathered over every rank."""

    def density(points: torch.Tensor) -> torch.Tensor:
        n = points.shape[0]
        per = -(-n // mesh.n_ranks)
        mine = points[mesh.rank * per:(mesh.rank + 1) * per]
        if mine.shape[0] < per:  # the padding of the last ranks' slices
            mine = torch.cat([mine, mine.new_zeros((per - mine.shape[0], 3))])
        return torch.cat(comm.gather_blocks(density_fn(mine), mesh.world))[:n]

    return density
