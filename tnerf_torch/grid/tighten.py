"""Occupancy range tightening (kernel B3).

Replaces the TPU kernel `tnerf/grid/pallas_dda.py:_tighten_kernel` (its
wrapper `tighten_range_pallas`, :518; the probe phase `_probe_tighten`,
:299).  Per ray, 256 midpoint probes test a <= 32^3 coarse bitfield;
[t_enter, t_exit] shrinks to the span of the occupied probes, padded by
one probe step plus one fine-cell diagonal; a ray that no probe hits
keeps its full span.

The result must be bit-exact with the reference, so the plain version
and the CUDA kernel (`tnerf_torch/csrc/tighten.cu`) round every multiply
and add separately, in the reference's association, and find cell ids
by a true division by the cell size.  Every constant that enters a
division is a tensor on the data's device: PyTorch's CUDA division by a
Python scalar multiplies by its reciprocal, which is not bit-exact.

`tighten_range` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; there is no fallback between the two.
"""

from __future__ import annotations

import numpy as np
import torch

from tnerf_torch.kernels import build

WORDS = 1024  # 32^3 bits as 1024 int32 words (the TPU's [8, 128] words, row-major)


def pack_words_rows(occ_coarse: torch.Tensor) -> torch.Tensor:
    """[c, c, c] bool (c <= 32) -> flat int32 [1024] bitfield: bit i of
    the row-major flattened grid is bit (i & 31) of word i >> 5."""
    c = occ_coarse.shape[0]
    n = c * c * c
    if n > WORDS * 32:
        raise ValueError(f"coarse grid {c}^3 = {n} bits exceeds {WORDS * 32}")
    bits = torch.zeros(WORDS * 32, dtype=torch.int64, device=occ_coarse.device)
    bits[:n] = occ_coarse.reshape(-1).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=occ_coarse.device)
    words = (bits.reshape(WORDS, 32) << shifts).sum(dim=1)
    # two's complement: bit 31 becomes the sign bit, as in the reference
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def coarse_constants(grid, res_c: int):
    """(lo, cell_c, fine_diag) computed in numpy float32 / Python float
    exactly as `pallas_dda.tighten_range_pallas` does (:538-542)."""
    lo = np.asarray(grid.aabb_min, np.float32)
    hi = np.asarray(grid.aabb_max, np.float32)
    cell_c = (hi - lo) / res_c
    fine_diag = float(np.linalg.norm((hi - lo) / grid.resolution))
    return lo, cell_c, fine_diag


def occ_bit(x, y, z, words, res_c: int, lo, cell_c):
    """Point test against a pack_words_rows bitfield (the reference's
    `_occ_bit_rows`, :372): cell id = clip(floor((p - lo) / cell), 0,
    res_c - 1), flattened (i * res_c + j) * res_c + k."""
    def cell(p, a):
        lo_a = torch.tensor(lo[a], dtype=torch.float32, device=p.device)
        cell_a = torch.tensor(cell_c[a], dtype=torch.float32, device=p.device)
        # clamp before the int conversion: out-of-range floats saturate,
        # as XLA's conversion does, instead of wrapping
        c = torch.clamp(torch.floor((p - lo_a) / cell_a), -1.0, float(res_c))
        return torch.clamp(c.to(torch.int32), 0, res_c - 1)

    cflat = (cell(x, 0) * res_c + cell(y, 1)) * res_c + cell(z, 2)
    w = words[(cflat >> 5).long()]
    return ((w >> (cflat & 31)) & 1) > 0


def tighten_range_plain(o, d, te, tx, words, res_c: int, grid, probes: int = 256):
    """The plain PyTorch version (any device)."""
    lo, cell_c, fine_diag = coarse_constants(grid, res_c)
    dev = o.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    n_probes = f32(float(probes))
    span = torch.clamp_min(tx - te, 0.0)
    step = span / n_probes
    big = f32(3.0e38)
    tf = torch.full_like(te, 3.0e38)
    tl = torch.full_like(te, -3.0e38)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    for i in range(probes):
        t = te + span * ((f32(float(i)) + 0.5) / n_probes)
        occ = occ_bit(ox + dx * t, oy + dy * t, oz + dz * t, words, res_c, lo, cell_c) & (span > 0)
        tf = torch.minimum(tf, torch.where(occ, t, big))
        tl = torch.maximum(tl, torch.where(occ, t, -big))
    hit = tl >= tf
    pad = step + f32(fine_diag)
    t0 = torch.where(hit, torch.maximum(tf - pad, te), te)
    t1 = torch.where(hit, torch.minimum(tl + pad, tx), tx)
    return t0, t1


def tighten_range(o, d, te, tx, words, res_c: int, grid, probes: int = 256):
    """Shrink [te, tx] (each [B] f32) of rays o, d ([B, 3] f32) to the
    occupied span of the res_c^3 bitfield `words` (int32 [1024]).
    CPU tensors take the plain version; CUDA tensors the B3 kernel."""
    if not 1 <= res_c <= 32:
        raise ValueError(f"res_c={res_c} must be in [1, 32]")
    if o.device.type == "cpu":
        return tighten_range_plain(o, d, te, tx, words, res_c, grid, probes)
    if o.device.type != "cuda":
        raise ValueError(f"tighten_range: unsupported device {o.device}")
    B = o.shape[0]
    dev = o.device
    build.check_tensor("o", o, (B, 3), torch.float32, dev)
    build.check_tensor("d", d, (B, 3), torch.float32, dev)
    build.check_tensor("te", te, (B,), torch.float32, dev)
    build.check_tensor("tx", tx, (B,), torch.float32, dev)
    build.check_tensor("words", words, (WORDS,), torch.int32, dev)
    lo, cell_c, fine_diag = coarse_constants(grid, res_c)
    t0 = torch.empty_like(te)
    t1 = torch.empty_like(tx)
    if B == 0:
        return t0, t1
    lib = build.library()
    f = lambda v: float(np.float32(v))
    with torch.cuda.device(dev):
        err = lib.tnerf_tighten_range(
            o.data_ptr(), d.data_ptr(), te.data_ptr(), tx.data_ptr(), words.data_ptr(),
            t0.data_ptr(), t1.data_ptr(), B, res_c,
            f(lo[0]), f(lo[1]), f(lo[2]), f(cell_c[0]), f(cell_c[1]), f(cell_c[2]),
            probes, f(fine_diag), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(err, "tnerf_tighten_range")
    tighten_range.launches += 1
    return t0, t1


tighten_range.launches = 0
