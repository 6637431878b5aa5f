"""The device mesh and data-parallel training and rendering over rays
(counterpart of `tnerf/parallel/mesh.py`).

Rays are i.i.d., so the ray batch is split over the mesh's "data" axis and
the parameters are replicated; each rank computes the gradient of its
shard's loss and the gradients are all-reduced before the optimizer's
update.  Two further axes compose with it, as in the reference:
"sample" shards the samples-per-ray quadrature of grid_intervals
(`parallel/sample_parallel.py`), "model" the hash-grid level tables or the
triplane features (`parallel/table_parallel.py`); all three together form
a (data, sample, model) mesh.

The mesh is a `torch.distributed.device_mesh.DeviceMesh` over the world's
ranks in row-major order (rank = its coordinates flattened row-major, as
`tnerf/parallel/mesh.py` reshapes its devices).  Ranks that share a
"data" coordinate hold the same rays.

Where the reference's XLA inserts the gradient all-reduce from sharding
constraints, the port's train step shards the batch and reduces itself
(`GradSync`, built by `tnerf_torch.train.make_train_step(mesh=...)`):
each leaf's gradient is summed over the ranks that hold the same copy of
it (every rank but those of other "model" coordinates) and divided by the
"data" size, so that it equals the gradient of the world-size-1 loss.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tnerf_torch.parallel import comm
from tnerf_torch.render.composite import RenderResult


class Mesh:
    """A DeviceMesh with the groups the port's collectives run over.

    axis_names / shape: the mesh's axes in order and their sizes (shape is
    a dict); device: this rank's device.  `group(axis)` is the group of
    the ranks that differ from this one only along `axis`; `replica` the
    ranks that hold the same copy of every leaf (all axes but "model");
    `world` every rank of the mesh.  data_axis is the first axis;
    sample_axis / model_axis name the others' roles (parallel.*_axis_name)."""

    def __init__(self, axes: Sequence[tuple], device: torch.device, sample_axis: str = "sample",
                 model_axis: str = "model"):
        from torch.distributed.device_mesh import DeviceMesh

        self.axis_names = tuple(n for n, _ in axes)
        self.shape = {n: int(s) for n, s in axes}
        self.device = device
        layout = torch.arange(int(np.prod(list(self.shape.values())))).reshape(
            [s for _, s in axes])
        self.device_mesh = DeviceMesh(device.type, layout, mesh_dim_names=self.axis_names)
        self.rank = dist.get_rank()
        self.coords = {n: self.device_mesh.get_local_rank(n) for n in self.axis_names}
        self.groups = {n: self.device_mesh.get_group(n) for n in self.axis_names}
        self.world = dist.group.WORLD
        self.data_axis, self.sample_axis, self.model_axis = self.axis_names[0], sample_axis, \
            model_axis
        self.replica = self.world
        if self.size(model_axis) > 1:
            m = self.axis_names.index(model_axis)
            lines = [layout.select(m, k).reshape(-1).tolist() for k in range(layout.shape[m])]
            self.replica, _ = dist.new_subgroups_by_enumeration(lines, timeout=comm.TIMEOUT)

    def size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis is not None else 1

    def coord(self, axis: Optional[str]) -> int:
        return self.coords.get(axis, 0) if axis is not None else 0

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def n_ranks(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def barrier(self) -> None:
        """Every rank waits for every other (`comm.barrier`)."""
        comm.barrier(self.device)

    def from_rank0(self, value: float) -> float:
        """Rank 0's value on every rank (a broadcast): a host decision that
        reads a device value is taken once, from rank 0's reading."""
        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0, group=self.world)
        return float(t.item())


def make_mesh(n_devices: int = -1, axis_name: str = "data", extra_axis: Optional[str] = None,
              n_extra: int = 1, extra_axis2: Optional[str] = None, n_extra2: int = 1,
              device=None, sample_axis: str = "sample", model_axis: str = "model") -> Mesh:
    """The mesh over the ray (data) axis, optionally with a second and third
    axis (sample- and/or table-parallel): shape (n_devices, n_extra[,
    n_extra2]), n_devices = -1 taking every rank the other axes leave.
    Needs the process group formed (`comm.init_group`) unless one rank is
    asked for; asks for no more ranks than exist, and for no fewer (a rank
    left out of the mesh would have nothing to run).  `device` defaults to
    this rank's card (`comm.rank_device("cuda")`), which raises where there
    is none: the CPU is had only by passing device="cpu"."""
    have = comm.world_size()
    axes = [(axis_name, n_devices)]
    if extra_axis is not None and n_extra > 1:
        axes.append((extra_axis, n_extra))
    if extra_axis2 is not None and n_extra2 > 1:
        axes.append((extra_axis2, n_extra2))
    n_rest = int(np.prod([s for _, s in axes[1:]])) if len(axes) > 1 else 1
    if n_devices == -1:
        axes[0] = (axis_name, max(1, have // n_rest))
    total = axes[0][1] * n_rest
    if total > have:
        raise ValueError(f"requested {total} devices, have {have}")
    if total < have:
        raise ValueError(f"requested {total} devices, but {have} ranks were launched: each "
                         "rank must hold a place in the mesh")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with "
                           "`python -m torch.distributed.run` (or call comm.init_group)")
    if device is None:  # the card, as every entry point defaults to; the CPU only when asked
        device = comm.rank_device("cuda")
    return Mesh(axes, torch.device(device), sample_axis, model_axis)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@torch.no_grad()
def replicate(tree, mesh: Mesh, group=None):
    """Broadcast every tensor of `tree` (a tensor, or dicts / lists / tuples
    of them) in place from the group's first rank (default: global rank 0),
    so that a state initialised or resumed on each rank is one state;
    returns `tree`."""
    group = mesh.world if group is None else group
    src = dist.get_global_rank(group, 0)
    for t in _tensors(tree):
        dist.broadcast(t.data, src=src, group=group)
    return tree


def data_slice(n: int, mesh: Mesh, axis_name: str = "data") -> slice:
    """This rank's contiguous slice of n rays by its `axis_name` coordinate."""
    k = mesh.size(axis_name)
    if n % k != 0:
        raise ValueError(f"ray batch {n} must divide over {k} '{axis_name}' devices (check "
                         "train.batch_size / render.chunk_size)")
    per = n // k
    c = mesh.coord(axis_name)
    return slice(c * per, (c + 1) * per)


def _sliced(tree, sl: slice):
    if isinstance(tree, torch.Tensor):
        return tree[sl]
    return type(tree)(*(_sliced(v, sl) for v in tree))


def shard_batch(batch, mesh: Mesh, axis_name: Optional[str] = None):
    """This rank's shard of a ray batch (a RayBatch or PoseBatch, or Rays):
    its contiguous slice of the ray axis by its `axis_name` coordinate, so
    ranks of one sample or model group hold the same rays."""
    n = (batch.gt_rgb if hasattr(batch, "gt_rgb") else batch.origins).shape[0]
    return _sliced(batch, data_slice(n, mesh, axis_name or mesh.data_axis))


def make_dp_train_step(renderer, mesh: Mesh, **kw):
    """The data-parallel train step (the reference's name):
    `train.make_train_step(renderer, mesh=mesh, **kw)`, which trains each
    rank on its shard of the full batch, reduces the gradients across the
    mesh and returns the global aux."""
    from tnerf_torch.train import make_train_step

    return make_train_step(renderer, mesh=mesh, **kw)


def dp_render_sharded(renderer, mesh: Mesh, axis_name: Optional[str] = None,
                      sample_axis: Optional[str] = None):
    """render(params, rays, occupancy=None, generator=None) -> RenderResult
    of every ray: each rank renders its slice of the rays over `axis_name`
    and the results are all-gathered (the eval-time counterpart of DP
    training; axis_name defaults to the mesh's data axis).  Under a
    sample-parallel renderer the per-sample arrays are gathered over the
    mesh's sample axis first."""
    axis_name = axis_name or mesh.data_axis
    sample_axis = sample_axis or mesh.sample_axis

    @torch.no_grad()
    def render(params, rays, occupancy=None, generator=None) -> RenderResult:
        local = renderer(params, shard_batch(rays, mesh, axis_name), occupancy, generator)
        out = []
        for k, x in enumerate(local):
            if k in (3, 4) and mesh.size(sample_axis) > 1 and x.shape[-1] > 0:
                x = torch.cat(comm.gather_blocks(x, mesh.group(sample_axis)), dim=-1)
            if mesh.size(axis_name) > 1:
                x = torch.cat(comm.gather_blocks(x, mesh.group(axis_name)), dim=0)
            out.append(x)
        return RenderResult(*out)

    return render


class GradSync:
    """The gradient reduction of a train step on `mesh`.  names / sizes:
    the optimizer's leaves in order and their element counts; sharded: the
    names of the leaves each "model" rank holds only a block of
    (`table_parallel.tp_state_sharding`)."""

    def __init__(self, mesh: Mesh, names: Sequence[str], sizes: Sequence[int],
                 sharded: Sequence[str] = ()):
        self.mesh = mesh
        self.n_dp = mesh.size(mesh.data_axis)
        self.n_tp = mesh.size(mesh.model_axis)
        self.n_replica = mesh.n_ranks // self.n_tp
        self.sharded = set(sharded)
        self._mask = None
        if self.n_tp > 1 and self.sharded:
            self._mask = torch.cat([torch.full((n,), k in self.sharded, dtype=torch.bool)
                                    for k, n in zip(names, sizes)]).to(mesh.device)

    def reduce(self, g: torch.Tensor) -> torch.Tensor:
        """Flat local gradient -> the world-size-1 gradient: summed over the
        ranks that hold the same copy of each leaf, divided by the data
        size."""
        if self.n_replica > 1:
            comm.all_reduce_(g, self.mesh.replica)
        if self.n_dp > 1:
            g = g / self.n_dp
        return g

    def norm_sq_and_finite(self, finite: torch.Tensor, g: Optional[torch.Tensor]):
        """(the squared norm of the whole gradient g, or None without g;
        whether every rank's gradient is finite, from this rank's `finite`):
        the sharded leaves' squares summed over "model" once, the
        replicated ones counted once, and one decision on the finite check
        (one all_reduce over "model"; none without table parallelism, where
        every rank reduced the same gradient)."""
        if self.n_tp == 1:
            return (None if g is None else torch.sum(g * g)), finite
        zero = torch.zeros((), dtype=torch.float32, device=finite.device)
        sh = rep = zero
        if g is not None:
            sq = g * g
            sh = torch.sum(torch.where(self._mask, sq, zero)) if self._mask is not None else zero
            rep = torch.sum(torch.where(self._mask, zero, sq)) if self._mask is not None \
                else torch.sum(sq)
        v = torch.stack([sh, (~finite).to(torch.float32)])
        comm.all_reduce_(v, self.mesh.group(self.mesh.model_axis))
        # each replica group reduced its own copy alike, so a non-finite
        # block of one "model" rank is now seen by every rank
        return (None if g is None else rep + v[0]), v[1] == 0

    def decide(self, flag: torch.Tensor) -> torch.Tensor:
        """A device bool that is one decision on every rank (all_reduce MIN)."""
        v = flag.to(torch.float32).reshape(1)
        comm.all_reduce_(v, self.mesh.world, dist.ReduceOp.MIN)
        return v[0] > 0.5


def reduce_aux(values: Dict[str, torch.Tensor], weights: Dict[str, float], mesh: Mesh
               ) -> Dict[str, torch.Tensor]:
    """One all_reduce (sum) over the world of the scalars `values`, each
    scaled by its weight first."""
    keys = list(values)
    v = torch.stack([values[k].detach().to(torch.float32) * weights[k] for k in keys])
    comm.all_reduce_(v, mesh.world)
    return {k: v[i] for i, k in enumerate(keys)}
