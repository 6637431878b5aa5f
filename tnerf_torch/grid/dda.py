"""The grid walk of the intervals renderer (kernel B5).

Replaces the TPU kernel `tnerf/grid/pallas_dda.py:_dda_kernel` (:61) with
its wrappers `march_pallas_raw` (:151) and `traverse_grid_pallas` (:232).
Per ray, an Amanatides-Woo walk of `steps` steps over the res^3 grid emits
per step the depth at which the step starts and the flat id of the cell it
crosses, or -1.  With an occupancy bitfield, a step inside an occupied
coarse cell (the bitfield max-pooled by `coarse_factor`) crosses one fine
cell, and a step inside an empty coarse cell jumps to that cell's exit
plane; without one every cell counts as occupied.

Rounding decides cells (a one-ulp change of a crossing depth flips the tie
rule x before y before z), so the plain version and the CUDA kernel
(`tnerf_torch/csrc/dda.cu`) round every product and sum separately, in the
reference's association: the kernel is bit-equal to the plain version,
which is bit-equal to the reference kernel.  The reference's cell ids
divide by the cell size, a constant, which its XLA computes as a multiply
by the float32 reciprocal RN(1 / h); so do both versions here, with the
reciprocal as a tensor on the data's device (`grid/traversal.py`).

The kernel gives each ray one thread; `block_shape` sizes its blocks from
the card's SM count so that every SM has one at the intervals training
batch (4096 rays).

`march_raw` takes the plain version for CPU tensors and launches the kernel
for CUDA tensors; there is no fallback between the two.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from tnerf_torch.grid.tighten import _card_slots, pack_words_rows
from tnerf_torch.grid.traversal import Intervals, cell_size, make_coarse_occupancy, ray_aabb
from tnerf_torch.kernels import build

EPS = 1e-6  # the walk's re-entry offset


def pack_coarse_words(occ_coarse: torch.Tensor) -> torch.Tensor:
    """[c, c, c] bool (c <= 32) -> int32 [1024] bitfield: flat index (x c +
    y) c + z, bit i of word i // 32 (`pallas_dda.pack_coarse_words`, :47,
    without its eight identical rows)."""
    return pack_words_rows(occ_coarse)


def _grid_constants(grid, coarse_factor: int):
    """(lo, h, ch, rcp) numpy float32 [3]: box corner, fine and coarse cell
    size, and RN(1 / h)."""
    lo = np.asarray(grid.aabb_min, np.float32)
    h = cell_size(grid, grid.resolution)
    return lo, h, h * np.float32(coarse_factor), np.float32(1.0) / h


MAX_THREADS = 256  # the kernel's launch bound


def block_shape(n_rays: int, n_sms: int) -> tuple:
    """(threads per block, blocks) of the B5 kernel for n_rays rays on a
    card of n_sms SMs.  A ray is one thread, and at small batches a warp
    waits on its own walk step after step, so the rays are spread over
    every SM: the threads per block are n_rays / n_sms rounded down to a
    multiple of 8 (so that a block's stores start on a 32-byte sector),
    at least 8 and at most 256.  At 4096 rays on 132 SMs: 24 threads, 171
    blocks."""
    threads = min(MAX_THREADS, max(8, 8 * (n_rays // (8 * max(n_sms, 1)))))
    return threads, -(-n_rays // threads)


def _ray_setup(origins, directions, grid):
    """(o, d_safe, inv_d [B, 3], t_enter, t_exit [B]) f32 contiguous, as the
    reference's wrapper prepares them (:176-179)."""
    o = origins.reshape(-1, 3).float().contiguous()
    d = directions.reshape(-1, 3).float()
    t_enter, t_exit = ray_aabb(o, d, grid.aabb_min, grid.aabb_max)
    t_enter = torch.clamp_min(t_enter, 0.0).contiguous()
    d_safe = torch.where(torch.abs(d) < 1e-12, torch.full_like(d, 1e-12), d).contiguous()
    return o, d_safe, (1.0 / d_safe).contiguous(), t_enter, t_exit.contiguous()


def check_walk(res: int, coarse_factor: int, steps: int, skipping: bool) -> None:
    """Refuse what the walk does not take: fewer than one step, and for the
    skipping walk a coarse factor that does not divide the resolution or
    leaves more than 32^3 coarse cells (the bitfield's 1024 words)."""
    if skipping and (coarse_factor < 1 or res % coarse_factor or res // coarse_factor > 32):
        raise ValueError(
            f"coarse grid {res}/{coarse_factor}: the factor must divide the resolution and "
            "leave at most 32^3 coarse cells")
    if steps < 1:
        raise ValueError(f"the walk needs steps >= 1, got {steps}")


def _coarse_words(occupancy, res: int, coarse_factor: int):
    check_walk(res, coarse_factor, 1, True)
    return pack_coarse_words(make_coarse_occupancy(occupancy.reshape(res, res, res),
                                                   coarse_factor))


def dda_steps_plain(o, d_safe, inv_d, t_enter, t_exit, words, res: int, coarse_factor: int,
                    steps: int, grid):
    """The kernel's arithmetic, step by step on tensors (any device):
    steps-major (t0 [steps, B] f32, cells [steps, B] int32).  words: the
    coarse bitfield, or None for the dense walk."""
    check_walk(res, coarse_factor, steps, words is not None)
    dev = o.device
    lo, h, ch, rcp = _grid_constants(grid, coarse_factor)
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
    eps, tiny = f32(EPS), f32(1e-7)
    cres = res // coarse_factor
    ox, dx, iv = o.unbind(1), d_safe.unbind(1), inv_d.unbind(1)
    hit_box = t_exit > t_enter
    pos = [(iv[a] > 0).to(torch.int32) for a in range(3)]
    sign = [2 * p - 1 for p in pos]

    def cell_of(a, t, lo_clip, hi_clip):
        c = torch.floor((ox[a] + dx[a] * t - f32(lo[a])) * f32(rcp[a]))
        # clamp before the int conversion: out-of-range floats saturate
        c = torch.clamp(c, float(lo_clip), float(hi_clip)).to(torch.int32)
        return c

    def plane_t(a, k, size):
        return (f32(lo[a]) + k.to(torch.float32) * f32(size[a]) - ox[a]) * iv[a]

    t_in = t_enter + eps
    idx = [cell_of(a, t_in, 0, res - 1) for a in range(3)]
    t_cur = t_enter
    t0s, cells = [], []
    for _ in range(steps):
        tn = [plane_t(a, idx[a] + pos[a], h) for a in range(3)]
        t_fine = torch.minimum(tn[0], torch.minimum(tn[1], tn[2]))
        inb = (idx[0] >= 0) & (idx[0] < res) & (idx[1] >= 0) & (idx[1] < res) \
            & (idx[2] >= 0) & (idx[2] < res)
        if words is not None:
            c = [torch.div(i, coarse_factor, rounding_mode="floor") for i in idx]
            cflat = torch.clamp((c[0] * cres + c[1]) * cres + c[2], 0, cres ** 3 - 1)
            bit = (words[(cflat >> 5).long()] >> (cflat & 31)) & 1
            c_occ = (bit > 0) & inb
            ct = [plane_t(a, c[a] + pos[a], ch) for a in range(3)]
            t_coarse = torch.minimum(ct[0], torch.minimum(ct[1], ct[2]))
            t_step = torch.where(c_occ, t_fine, torch.maximum(t_coarse, t_cur + eps))
        else:
            c_occ = inb
            t_step = t_fine
        valid = (torch.minimum(t_step, t_exit) > t_cur + tiny) & hit_box & c_occ
        flat = (idx[0] * res + idx[1]) * res + idx[2]
        t0s.append(t_cur)
        cells.append(torch.where(valid, flat, torch.full_like(flat, -1)))
        fx = c_occ & (tn[0] <= tn[1]) & (tn[0] <= tn[2])  # ties: x before y before z
        fy = c_occ & ~fx & (tn[1] <= tn[2])
        fz = c_occ & ~fx & ~fy
        nxt = [torch.where(f, i + s, i) for f, i, s in zip((fx, fy, fz), idx, sign)]
        if words is not None:
            tj = t_step + eps
            nxt = [torch.where(c_occ, nxt[a], cell_of(a, tj, -1, res)) for a in range(3)]
        idx = nxt
        t_cur = torch.maximum(t_cur, t_step)
    return torch.stack(t0s), torch.stack(cells)


@functools.lru_cache(maxsize=None)
def _grid_floats(grid, coarse_factor: int):
    """lo, h, ch and 1 / h (xyz each) as the launch function takes them."""
    return tuple(float(v) for a in _grid_constants(grid, coarse_factor) for v in a)


def dda_steps(o, d_safe, inv_d, t_enter, t_exit, words, res: int, coarse_factor: int,
              steps: int, grid):
    """The B5 kernel on prepared CUDA tensors: o, d_safe, inv_d [B, 3],
    t_enter, t_exit [B] f32, words int32 [1024] or None (dense walk) ->
    (t0 [steps, B] f32, cells [steps, B] int32)."""
    check_walk(res, coarse_factor, steps, words is not None)
    dev = o.device
    if dev.type != "cuda":
        raise ValueError(f"dda_steps: the kernel needs CUDA tensors, got {dev}")
    B = o.shape[0]
    for name, t in (("o", o), ("d_safe", d_safe), ("inv_d", inv_d)):
        build.check_tensor(name, t, (B, 3), torch.float32, dev)
    for name, t in (("t_enter", t_enter), ("t_exit", t_exit)):
        build.check_tensor(name, t, (B,), torch.float32, dev)
    if words is not None:
        build.check_tensor("words", words, (1024,), torch.int32, dev)
    t0 = torch.empty((steps, B), dtype=torch.float32, device=dev)
    cells = torch.empty((steps, B), dtype=torch.int32, device=dev)
    if B == 0:
        return t0, cells
    lib = build.library()
    with torch.cuda.device(dev):
        threads, _ = block_shape(B, _card_slots(torch.cuda.current_device())[0])
        err = lib.tnerf_dda_march(
            o.data_ptr(), d_safe.data_ptr(), inv_d.data_ptr(), t_enter.data_ptr(),
            t_exit.data_ptr(), words.data_ptr() if words is not None else None,
            t0.data_ptr(), cells.data_ptr(), B, steps, res, coarse_factor,
            int(words is not None), *_grid_floats(grid, coarse_factor), threads,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(err, "tnerf_dda_march")
    march_raw.launches += 1
    return t0, cells


def _march(origins, directions, grid, occupancy, coarse_factor, steps, plain: bool):
    res = grid.resolution
    n_steps = steps if steps is not None else 3 * res
    o, d_safe, inv_d, t_enter, t_exit = _ray_setup(origins, directions, grid)
    words = None if occupancy is None else _coarse_words(occupancy, res, coarse_factor)
    walk = dda_steps_plain if plain else dda_steps
    t0, cells = walk(o, d_safe, inv_d, t_enter, t_exit, words, res,
                     coarse_factor if occupancy is not None else 1, n_steps, grid)
    return t0, cells, t_enter, t_exit


def march_raw_plain(origins, directions, grid, occupancy=None, coarse_factor: int = 8,
                    steps: Optional[int] = None):
    """The plain PyTorch version of `march_raw` (any device)."""
    return _march(origins, directions, grid, occupancy, coarse_factor, steps, plain=True)


def march_raw(origins, directions, grid, occupancy=None, coarse_factor: int = 8,
              steps: Optional[int] = None):
    """Walk rays ([B, 3] origins and directions) through the grid: steps-
    major raw outputs (t0 [steps, B] f32, cells [steps, B] int32, t_enter
    [B], t_exit [B]), steps = 3 res by default (`march_pallas_raw`, :151).
    occupancy: [res]^3 bool, pooled by coarse_factor for the skipping walk,
    or None for the dense walk.  The cells are what the walk crossed, not
    yet tested against the fine occupancy.

    CPU tensors take the plain version; CUDA tensors launch the B5 kernel."""
    if origins.device.type not in ("cpu", "cuda"):
        raise ValueError(f"march_raw: unsupported device {origins.device}")
    return _march(origins, directions, grid, occupancy, coarse_factor, steps,
                  plain=origins.device.type == "cpu")


march_raw.launches = 0


def traverse_grid_dda(origins, directions, grid, occupancy=None, coarse_factor: int = 8,
                      max_hits: Optional[int] = None, steps: Optional[int] = None) -> Intervals:
    """`march_raw` as rays-major, masked Intervals with the fine occupancy
    applied (`traverse_grid_pallas`, :232-287).

    The walk runs one step beyond the budget: its depth is monotone and
    step s ends where step s + 1 starts, so the extra step's start is the
    true end of the last budgeted cell (t_exit there would stretch the last
    interval of a cut walk across everything it never visited).  The result
    is padded with invalid slots, or cut, to max_hits."""
    res = grid.resolution
    H = max_hits if max_hits is not None else grid.effective_max_hits
    n_steps = steps if steps is not None else min(H, 3 * res)
    batch_shape = origins.shape[:-1]
    t0s, cells, t_enter, t_exit = march_raw(origins, directions, grid, occupancy, coarse_factor,
                                            steps=n_steps + 1)
    t0s = t0s.T
    cells = cells.T[:, :n_steps]
    t1s = torch.minimum(t0s[:, 1:], t_exit[:, None])
    t0s = t0s[:, :n_steps]
    mask = cells >= 0
    if occupancy is not None:
        occ = occupancy.reshape(-1)
        mask = mask & occ[torch.clamp(cells, 0, res ** 3 - 1).long()]
    mask = mask & (t1s > t0s)
    cells = torch.where(mask, cells, torch.full_like(cells, -1))
    t0s = torch.where(mask, t0s, torch.zeros_like(t0s))
    t1s = torch.where(mask, t1s, torch.zeros_like(t1s))
    if n_steps < H:
        pad = lambda a, v: torch.nn.functional.pad(a, (0, H - n_steps), value=v)
        t0s, t1s, cells, mask = pad(t0s, 0.0), pad(t1s, 0.0), pad(cells, -1), pad(mask, False)
    elif n_steps > H:
        t0s, t1s, cells, mask = (a[:, :H] for a in (t0s, t1s, cells, mask))
    shape = lambda a: a.reshape(*batch_shape, -1)
    return Intervals(t_starts=shape(t0s), t_ends=shape(t1s), cells=shape(cells), mask=shape(mask),
                     t_enter=t_enter.reshape(batch_shape), t_exit=t_exit.reshape(batch_shape))
