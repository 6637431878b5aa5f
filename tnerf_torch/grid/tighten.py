"""Occupancy range tightening (kernel B3) and tightening plus the
per-sample occupancy mask of the tightened span (kernel B4).

Replaces the TPU kernels `tnerf/grid/pallas_dda.py:_tighten_kernel` (its
wrapper `tighten_range_pallas`, :518) and `_tighten_mask_kernel` (:400,
wrapper `tighten_sample_mask_pallas`, :439); both run the probe phase
`_probe_tighten` (:299).  Per ray, 256 midpoint probes test a <= 32^3
coarse bitfield; [t_enter, t_exit] shrinks to the span of the occupied
probes, padded by one probe step plus one fine-cell diagonal; a ray that
no probe hits keeps its full span.  B4 then tests the bitfield at the
midpoints of the tightened span.

The result must be bit-exact with the reference, so the plain version
and the CUDA kernels (`tnerf_torch/csrc/tighten.cu`, `probe.cuh`) round
every multiply and add separately, in the reference's association.  The
reference divides by constants: the probe or sample count and the cell
size.  XLA computes each such division as a multiply by the constant's
float32 reciprocal, so the port multiplies by it (`reciprocal`, as a
tensor on the data's device): the probe fraction, step and midpoint
spacing by RN(1 / count), the cell ids floor((p - lo) * RN(1 / cell))
(`cell_ids`; the kernels take the reciprocals from the host).

The kernels give each ray a group of G lanes (`lane_group`), which scan
the probes in rounds of G from the front to the first occupied probe and
from the back to the last (`tighten_range_scan` transcribes the scan and
counts the probes it evaluates).

`tighten_range` and `tighten_sample_mask` take the plain version for CPU
tensors and launch the kernel for CUDA tensors; there is no fallback
between the two.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tnerf_torch.grid.traversal import reciprocal
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
    exactly as `pallas_dda.tighten_range_pallas` does (:538-542).  The
    reference's kernels divide by cell_c, which its XLA computes as a
    multiply by RN(1 / cell_c); so does the port (`occ_bit`, the kernels)."""
    lo = np.asarray(grid.aabb_min, np.float32)
    hi = np.asarray(grid.aabb_max, np.float32)
    cell_c = (hi - lo) / np.float32(res_c)
    fine_diag = float(np.linalg.norm((hi - lo) / grid.resolution))
    return lo, cell_c, fine_diag


def cell_ids(p, lo_a: float, rcp_a: float, res_c: int):
    """clip(floor((p - lo) * rcp), 0, res_c - 1) int32: the coarse cell id
    of one coordinate (the reference's `(p - lo) / cell` as its XLA
    computes it)."""
    lo_t = torch.tensor(lo_a, dtype=torch.float32, device=p.device)
    rcp_t = torch.tensor(rcp_a, dtype=torch.float32, device=p.device)
    # clamp before the int conversion: out-of-range floats saturate, as
    # XLA's conversion does, instead of wrapping
    c = torch.clamp(torch.floor((p - lo_t) * rcp_t), -1.0, float(res_c))
    return torch.clamp(c.to(torch.int32), 0, res_c - 1)


def occ_bit(x, y, z, words, res_c: int, lo, cell_c):
    """Point test against a pack_words_rows bitfield (the reference's
    `_occ_bit_rows`, :372): the cell ids `cell_ids` of the three
    coordinates by the reciprocals RN(1 / cell_c), flattened (i * res_c +
    j) * res_c + k."""
    rcp = np.float32(1.0) / np.asarray(cell_c, np.float32)
    cflat = (cell_ids(x, lo[0], rcp[0], res_c) * res_c + cell_ids(y, lo[1], rcp[1], res_c)) \
        * res_c + cell_ids(z, lo[2], rcp[2], res_c)
    w = words[(cflat >> 5).long()]
    return ((w >> (cflat & 31)) & 1) > 0


def tighten_range_plain(o, d, te, tx, words, res_c: int, grid, probes: int = 256):
    """The plain PyTorch version (any device): the probe phase that both
    plain versions share (`_probe_tighten`, :299)."""
    lo, cell_c, fine_diag = coarse_constants(grid, res_c)
    dev = o.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    rcp = reciprocal(probes, dev)
    span = torch.clamp_min(tx - te, 0.0)
    step = span * rcp
    big = f32(3.0e38)
    tf = torch.full_like(te, 3.0e38)
    tl = torch.full_like(te, -3.0e38)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    for i in range(probes):
        t = te + span * ((f32(float(i)) + 0.5) * rcp)
        occ = occ_bit(ox + dx * t, oy + dy * t, oz + dz * t, words, res_c, lo, cell_c) & (span > 0)
        tf = torch.minimum(tf, torch.where(occ, t, big))
        tl = torch.maximum(tl, torch.where(occ, t, -big))
    hit = tl >= tf
    pad = step + f32(fine_diag)
    t0 = torch.where(hit, torch.maximum(tf - pad, te), te)
    t1 = torch.where(hit, torch.minimum(tl + pad, tx), tx)
    return t0, t1


def _pow2_at_least(v: int) -> int:
    g = 1
    while g < v:
        g *= 2
    return g


def lane_group(n_rays: int, probes: int, n_sms: int, threads_per_sm: int = 2048) -> int:
    """G, the lanes of one warp that the kernels give each ray, a power of
    two in [8, 32]: at least the least power of two for which n_rays x G
    threads fill the card's n_sms x threads_per_sm resident slots (32
    where n_rays cannot), and at least probes / 8 rounded up to a power of
    two, so that a full pass takes at most 8 rounds.  Measured on an H100
    (`tools/torch_probe_turns.py --groups`): G = 32 is the fastest at 256 probes from 8192 to
    66,000 rays, 16 at 64 probes and 32,000 rays, and G < 8 is slower
    everywhere, since the groups of one warp then wait on each other's
    ballots."""
    fill = _pow2_at_least(-(-n_sms * threads_per_sm // max(n_rays, 1)))
    return min(32, max(8, fill, _pow2_at_least(-(-probes // 8))))


def tighten_range_scan(o, d, te, tx, words, res_c: int, grid, probes: int = 256, group: int = 32):
    """The kernels' probe phase transcribed (any device): (t0, t1,
    evaluated [B] int64, the probes each ray's lane group evaluates).

    Each ray's G = `group` lanes evaluate probes in rounds of G, front to
    back, up to the round that holds the first occupied probe; that
    round's occupancy bits are kept.  Then, from the last probe down, in
    rounds of G, the probes above that round, up to the round that holds
    the last occupied probe; where none is occupied, the last is the
    highest bit of the kept round.  No probe is evaluated twice, and a
    ray with no occupied probe makes one full forward pass.  The probe
    depths t_i = te + span * ((i + 0.5) * (1 / probes)), each operation
    rounded, do not decrease with i, so the first and last occupied
    depths are the minimum and maximum that `tighten_range_plain` folds
    over all probes, and the result is bit-equal to it."""
    lo, cell_c, fine_diag = coarse_constants(grid, res_c)
    dev = o.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    rcp = reciprocal(probes, dev)
    span = torch.clamp_min(tx - te, 0.0)
    step = span * rcp
    frac = (torch.arange(probes, dtype=torch.float32, device=dev) + 0.5) * rcp
    B = te.shape[0]
    lanes = torch.arange(group, device=dev)

    def occupied(rows, idx):
        """[len(rows), G] occupancy bits of probes idx ([G]) of rays rows."""
        t = te[rows, None] + span[rows, None] * frac[idx.clamp(0, probes - 1)][None, :]
        p = [o[rows, a, None] + d[rows, a, None] * t for a in range(3)]
        return occ_bit(*p, words, res_c, lo, cell_c)

    first = torch.full((B,), -1, dtype=torch.int64, device=dev)
    last = torch.full((B,), -1, dtype=torch.int64, device=dev)
    evaluated = torch.zeros(B, dtype=torch.int64, device=dev)
    rows = torch.nonzero(span > 0).flatten()
    for base in range(0, probes, group):
        if rows.numel() == 0:
            break
        idx = base + lanes
        valid = idx < probes
        occ = occupied(rows, idx) & valid
        evaluated[rows] += int(valid.sum())
        hit = occ.any(dim=1)
        first[rows[hit]] = base + occ[hit].int().argmax(dim=1)
        # the highest occupied probe of the kept round
        last[rows[hit]] = base + group - 1 - occ[hit].flip(1).int().argmax(dim=1)
        rows = rows[~hit]
    rows = torch.nonzero(first >= 0).flatten()
    above = first - first % group + group  # the first probe above the kept round
    for top in range(probes - 1, -1, -group):
        rows = rows[top >= above[rows]]
        if rows.numel() == 0:
            break
        idx = top - lanes
        live = idx[None, :] >= above[rows, None]
        occ = occupied(rows, idx) & live
        evaluated[rows] += live.sum(dim=1)
        hit = occ.any(dim=1)
        last[rows[hit]] = top - occ[hit].int().argmax(dim=1)
        rows = rows[~hit]
    hit = first >= 0
    t_at = lambda i: te + span * frac[i.clamp_min(0)]
    tf = torch.minimum(t_at(first), f32(3.0e38))
    tl = torch.maximum(t_at(last), f32(-3.0e38))
    pad = step + f32(fine_diag)
    t0 = torch.where(hit, torch.maximum(tf - pad, te), te)
    t1 = torch.where(hit, torch.minimum(tl + pad, tx), tx)
    return t0, t1, evaluated


def _check_ray_inputs(o, d, te, tx, words):
    B, dev = o.shape[0], o.device
    build.check_tensor("o", o, (B, 3), torch.float32, dev)
    build.check_tensor("d", d, (B, 3), torch.float32, dev)
    build.check_tensor("te", te, (B,), torch.float32, dev)
    build.check_tensor("tx", tx, (B,), torch.float32, dev)
    build.check_tensor("words", words, (WORDS,), torch.int32, dev)


@functools.lru_cache(maxsize=None)
def _coarse_floats(grid, res_c: int):
    """(lo xyz, 1 / cell xyz, fine_diag) as the launch functions take them,
    computed once per (grid, res_c): the wrappers run in every train step
    and view chunk, and the steps are host-bound."""
    lo, cell_c, fine_diag = coarse_constants(grid, res_c)
    rcp = np.float32(1.0) / cell_c
    f = lambda v: float(np.float32(v))
    return (f(lo[0]), f(lo[1]), f(lo[2]), f(rcp[0]), f(rcp[1]), f(rcp[2])), f(fine_diag)


@functools.lru_cache(maxsize=None)
def _card_slots(index: int):
    """(SMs, resident threads per SM) of CUDA device `index`."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, getattr(props, "max_threads_per_multi_processor", 2048)


def _launch_group(B: int, probes: int) -> int:
    """G for B rays and `probes` probes on the current CUDA device."""
    return lane_group(B, probes, *_card_slots(torch.cuda.current_device()))


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
    _check_ray_inputs(o, d, te, tx, words)
    B, dev = o.shape[0], o.device
    t0 = torch.empty_like(te)
    t1 = torch.empty_like(tx)
    if B == 0:
        return t0, t1
    lib = build.library()
    coarse, fine_diag = _coarse_floats(grid, res_c)
    with torch.cuda.device(dev):
        err = lib.tnerf_tighten_range(
            o.data_ptr(), d.data_ptr(), te.data_ptr(), tx.data_ptr(), words.data_ptr(),
            t0.data_ptr(), t1.data_ptr(), B, res_c, *coarse, probes, fine_diag,
            _launch_group(B, probes), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(err, "tnerf_tighten_range")
    tighten_range.launches += 1
    return t0, t1


tighten_range.launches = 0


def tighten_sample_mask_plain(o, d, te, tx, occ_coarse, n_samples: int, grid, probes: int = 256,
                              words=None):
    """The plain PyTorch version of `tighten_sample_mask` (any device)."""
    res_c = occ_coarse.shape[0]
    if words is None:
        words = pack_words_rows(occ_coarse)
    lo, cell_c, _ = coarse_constants(grid, res_c)
    t0, t1 = tighten_range_plain(o, d, te, tx, words, res_c, grid, probes)
    dev = o.device
    dt = ((t1 - t0) * reciprocal(n_samples, dev))[:, None]
    s = torch.arange(n_samples, dtype=torch.float32, device=dev)[None, :] + 0.5
    t = t0[:, None] + dt * s
    bit = occ_bit(o[:, 0:1] + d[:, 0:1] * t, o[:, 1:2] + d[:, 1:2] * t, o[:, 2:3] + d[:, 2:3] * t,
                  words, res_c, lo, cell_c)
    return t0, t1, bit & (t1 > t0)[:, None]


def tighten_sample_mask(o, d, te, tx, occ_coarse, n_samples: int, grid, probes: int = 256,
                        words=None):
    """`tighten_range` on the pooled occupancy occ_coarse ([c, c, c] bool,
    c <= 32), then the occupancy bit at the n_samples midpoints of the
    tightened span: t_s = t0 + (t1 - t0) / n_samples * (s + 0.5), mask =
    bit(o + d t_s) & (t1 > t0).  Returns (t0 [B], t1 [B], mask [B,
    n_samples] bool).  The counterpart of `tighten_sample_mask_pallas`
    (:439), bit-exact with it; the mask's layout is the port's own.
    words: `pack_words_rows(occ_coarse)`, where the caller holds it already.

    CPU tensors take the plain version; CUDA tensors the B4 kernel."""
    if occ_coarse.dim() != 3 or occ_coarse.dtype != torch.bool or n_samples < 1:
        raise ValueError(f"tighten_sample_mask: need a [c, c, c] bool occupancy and n_samples "
                         f">= 1, got {occ_coarse.dtype} {tuple(occ_coarse.shape)}, {n_samples}")
    if o.device.type == "cpu":
        return tighten_sample_mask_plain(o, d, te, tx, occ_coarse, n_samples, grid, probes, words)
    if o.device.type != "cuda":
        raise ValueError(f"tighten_sample_mask: unsupported device {o.device}")
    res_c = occ_coarse.shape[0]
    if words is None:
        words = pack_words_rows(occ_coarse)
    _check_ray_inputs(o, d, te, tx, words)
    B, dev = o.shape[0], o.device
    t0 = torch.empty_like(te)
    t1 = torch.empty_like(tx)
    mask = torch.empty((B, n_samples), dtype=torch.uint8, device=dev)
    if B == 0:
        return t0, t1, mask.bool()
    lib = build.library()
    coarse, fine_diag = _coarse_floats(grid, res_c)
    with torch.cuda.device(dev):
        err = lib.tnerf_tighten_sample_mask(
            o.data_ptr(), d.data_ptr(), te.data_ptr(), tx.data_ptr(), words.data_ptr(),
            t0.data_ptr(), t1.data_ptr(), mask.data_ptr(), B, n_samples, res_c, *coarse, probes,
            fine_diag, _launch_group(B, probes), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(err, "tnerf_tighten_sample_mask")
    tighten_sample_mask.launches += 1
    return t0, t1, mask.view(torch.bool)


tighten_sample_mask.launches = 0
