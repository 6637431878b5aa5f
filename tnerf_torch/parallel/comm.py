"""Process groups and differentiable collectives on `torch.distributed`.

The reference runs one program over a JAX device mesh (`shard_map`, jit
sharding constraints) and gets the transpose of every collective from
JAX.  Here each rank is a process; a multi-GPU run starts as PyTorch's
launcher starts it,

    python -m torch.distributed.run --nproc-per-node N -m tnerf_torch.cli train --config ...

and the rank, the world size and the local rank come from the launcher's
environment (`init_from_env`).  Rank r runs on cuda:(LOCAL_RANK % cards).
When every local rank has a card of its own the backend is NCCL; when
ranks share a card (NCCL refuses two ranks on one device), and on the
CPU, it is gloo.  Only the collectives both backends take on CUDA tensors
are used: all_reduce, all_gather and broadcast.  Every group carries a
timeout (TIMEOUT), so a rank that stops answering fails the run instead of
hanging it.

The collectives that gradients pass through are autograd Functions whose
backward is the transpose `shard_map` gives the reference, under its
convention that a value every rank holds alike carries its cotangent once,
not once per rank:

- `psum`: per-rank partials summed into a value every rank then holds
  alike; backward: the identity (each partial's cotangent is the sum's);
- `all_gather_invariant`: a tiled gather of per-rank blocks into a value
  every rank consumes alike; backward: this rank's block of the cotangent;
- `all_gather_varying`: the same gather, consumed differently on each
  rank (the sample-parallel transmittance prefix); backward: the
  cotangents of all ranks summed, then this rank's block (a reduce-scatter);
- `copy_to_group`: a value every rank holds alike that each rank consumes
  only in part (the table-parallel encode reads its own levels of the
  positions); forward: the identity, backward: the sum over the group.

`torch.distributed.nn.functional` is not used: its all_reduce and
all_gather sum the cotangents of the whole group in their backward, which
multiplies the gradient of a loss that every rank computes alike by the
group's size.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

TIMEOUT = timedelta(seconds=120)
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def launched() -> bool:
    """True where PyTorch's launcher (torch.distributed.run) started this
    process: its environment names the rank and the world size."""
    return all(k in os.environ for k in LAUNCH_ENV)


def rank_device(device) -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK % cards) for a CUDA request, the
    CPU for a CPU one."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA run was requested but torch.cuda.is_available() is False")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def pick_backend(dev: torch.device, local_world_size: int) -> str:
    """nccl where every local rank has a card of its own, else gloo (ranks
    sharing one card, or the CPU)."""
    if dev.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_group(device, init_method: str = "env://", rank: Optional[int] = None,
               world_size: Optional[int] = None, local_world_size: Optional[int] = None,
               log=None) -> torch.device:
    """Form the default process group (if none is formed yet) and return
    this rank's device.  Without rank / world_size they come from the
    launcher's environment.  The backend follows `pick_backend`; the choice
    is logged.  A group that does not form raises."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = pick_backend(dev, local_world_size)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT)
    if log is not None:
        log.info("process group: rank %d of %d, backend %s, device %s (%d local ranks, %d "
                 "cards)", rank, world_size, backend, dev, local_world_size,
                 torch.cuda.device_count() if dev.type == "cuda" else 0)
    return dev


def init_from_env(device, log=None) -> Optional[torch.device]:
    """The entry points' set-up: where the launcher started this process (or
    a group is formed already), form the group and return this rank's
    device; else None, and nothing changes."""
    if dist.is_initialized() or launched():
        return init_group(device, log=log)
    return None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def group_rank(group) -> int:
    return dist.get_rank(group)


def barrier(device) -> None:
    """Every rank of the world waits for every other (a one-element
    all_reduce on the rank's device, which both backends take); a no-op
    without a process group."""
    if dist.is_initialized():
        dist.all_reduce(torch.zeros((1,), device=device))


def gather_blocks(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's x (same shape everywhere), in the group's rank order."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all_reduce of x over `group`; returns x."""
    dist.all_reduce(x, op=op, group=group)
    return x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return torch.cat(gather_blocks(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


class _GatherVarying(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, x.shape[dim]
        return torch.cat(gather_blocks(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        total = all_reduce_(g.contiguous().clone(), ctx.group)
        return total.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of the ranks' x over `group`; backward: the identity."""
    return _Psum.apply(x, group)


def all_gather_invariant(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in rank order; backward: this
    rank's block of the cotangent."""
    return _GatherInvariant.apply(x, dim % x.dim(), group)


def all_gather_varying(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in rank order; backward: the
    group's cotangents summed, then this rank's block."""
    return _GatherVarying.apply(x, dim % x.dim(), group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """x; backward: the cotangents of the group summed."""
    if not x.requires_grad:
        return x
    return _CopyToGroup.apply(x, group)
