"""Multiresolution hash-grid encoding (Instant-NGP; counterpart of
`tnerf/fields/hashgrid.py`).

All L level tables live in one [L*T, F] float32 table; a sample's lookup
at level l reads rows l*T + index.  Levels whose dense vertex grid fits
the table ((res+1)^3 <= T) index it linearly, the others through the NGP
spatial hash (primes 1, 2654435761, 805459861).  The reference hashes in
uint32 with wraparound; here the vertex coordinates are int64 (at most
hash_max_resolution + 1, so a product stays far below 2^63) and only the
index's low log2(T) bits are kept: they are the low bits of the uint32
result, whatever wrapped above them.

Formulation: the gather form of `apply_hashgrid_gather` (:193), eight
corners accumulated in the reference's order.  The reference's "onehot"
form (:210, `fields/onehot.py`) is a matrix product that exists only to
dodge the TPU's gather; what it computes differently is its rounding: it
reads table values rounded to field_.compute_dtype and scatters each
corner's cotangent rounded to it.  `hash_gather_mode="onehot"` computes
exactly that, by a lookup (`rounded_lookup`).  "auto" resolves as the
reference resolves it off a TPU: "gather", float32 lookups.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tnerf_torch.fields.mlp import rounding_dtype

_PRIMES = (1, 2654435761, 805459861)


def level_resolutions(cfg) -> np.ndarray:
    """Per-level grid resolution N_l = floor(N0 * b^l) with b = exp((ln Nmax
    - ln N0) / (L - 1)), in numpy float64 as the reference computes it."""
    return _level_resolutions(cfg.hash_levels, cfg.hash_base_resolution,
                              cfg.hash_max_resolution)


def _level_resolutions(L: int, n0: int, nmax: int) -> np.ndarray:
    if L == 1:
        return np.array([n0], np.int64)
    b = float(np.exp((np.log(nmax) - np.log(n0)) / (L - 1)))
    return np.floor(n0 * b ** np.arange(L)).astype(np.int64)


def hashgrid_num_params(cfg) -> int:
    return cfg.hash_levels * (1 << cfg.hash_log2_table_size) * cfg.hash_features_per_level


def init_hashgrid(cfg, generator: torch.Generator) -> torch.Tensor:
    """[L*T, F] float32 table, uniform(-1e-4, 1e-4) (the NGP scale)."""
    L, F = cfg.hash_levels, cfg.hash_features_per_level
    T = 1 << cfg.hash_log2_table_size
    return torch.rand((L * T, F), generator=generator, dtype=torch.float32) * 2e-4 - 1e-4


def resolve_gather_mode(cfg) -> str:
    """"gather" or "onehot" (`tnerf/fields/hashgrid.py:110`): "auto" is what
    the reference picks off a TPU, "gather"."""
    mode = cfg.hash_gather_mode
    if mode == "pallas":
        raise ValueError(
            "hash_gather_mode='pallas' was removed from the reference package after its "
            "round-4 measurement (docs/KERNEL_NOTES.md); use 'gather' (or 'auto')")
    if mode not in ("auto", "gather", "onehot"):
        raise ValueError(f"hash_gather_mode must be auto, gather or onehot, got {mode!r}")
    return "gather" if mode == "auto" else mode


def segment_shape(n: int, rows: int, F: int):
    """(FT, E, rows_per_block) of the segment sum of n values [n, F] into
    `rows` rows: a row's group of E x FT threads, FT = min(F, 256) feature
    lanes and E entry lanes, E the rows' mean length rounded up to a power
    of two, at most 1024 // FT (csrc/segment_sum.cu); as many rows per
    block as fill 256 threads.  The summation order depends on E, so the
    plain version and the kernel take it from here."""
    FT = min(F, 256)
    mean = max(1, -(-n // max(rows, 1)))
    E = min(1 << (mean - 1).bit_length(), max(1, 1024 // FT))
    return FT, E, max(1, 256 // (E * FT))


# The lookups' stable sort by row on the card (csrc/segment_sort.cu): a
# tile of SORT_TILE lookups per block, digits of at most SORT_MAX_BITS bits,
# and the lookups' values as the payload where a row holds at most
# SORT_BY_VALUE_MAX_F of them (else the lookup's index).
SORT_TILE = 4096
SORT_MAX_BITS = 9
SORT_BY_VALUE_MAX_F = 4
SEGMENT_LIMIT = 1 << 31  # rows and lookups: 32-bit keys, indices and offsets


def check_segment_limits(n: int, rows: int) -> None:
    """Raise unless n lookups into `rows` rows fit the kernels' 32-bit keys,
    lookup indices and offsets."""
    if n >= SEGMENT_LIMIT or rows >= SEGMENT_LIMIT:
        raise ValueError(f"segment_sum_rows: {n} lookups into {rows} rows; both must be under "
                         f"2^31 (the sort's 32-bit keys, indices and offsets)")


def sort_passes(rows: int):
    """(passes, bits): the stable radix sort of row ids in [0, rows) covers
    their ceil(log2 rows) bits (at least 1) in `passes` digits of `bits` bits
    each, as few passes as digits of at most SORT_MAX_BITS allow."""
    key_bits = max(1, (rows - 1).bit_length())
    passes = -(-key_bits // SORT_MAX_BITS)
    return passes, -(-key_bits // passes)


def _sorted_rows(idx: torch.Tensor, rows: int):
    """(sorted keys, order, offsets): the stable sort of idx as int32 keys and
    each row's start in it ([rows + 1] int64, by searchsorted: no host
    synchronisation); the plain version of the sort in `segment_sort`."""
    sorted_idx, order = torch.sort(idx.to(torch.int32), stable=True)
    offsets = torch.searchsorted(
        sorted_idx, torch.arange(rows + 1, dtype=torch.int32, device=idx.device))
    return sorted_idx, order, offsets


def segment_sum_rows_plain(values: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The plain PyTorch version of `segment_sum_rows`, in the kernel's
    order: the values of a row in lookup order, entry j of the row into
    partial sum j mod E, each partial summed one value after another
    (`torch.segment_reduce`), then the E partials by the kernel's pairwise
    tree."""
    n, F = values.shape
    _, E, _ = segment_shape(n, rows, F)
    dev = idx.device
    sorted_idx, order, offsets = _sorted_rows(idx, rows)
    pos = torch.arange(n, device=dev) - offsets[sorted_idx]
    lane_key, lane_order = torch.sort(sorted_idx * E + pos % E, stable=True)
    lane_offsets = torch.searchsorted(lane_key, torch.arange(rows * E + 1, device=dev))
    part = torch.segment_reduce(values[order[lane_order]], "sum", offsets=lane_offsets, axis=0,
                                unsafe=True).reshape(rows, E, F)
    while E > 1:
        E //= 2
        part = part[:, :E] + part[:, E:2 * E]
    return part[:, 0]


class _SortLayout:
    """Byte offsets of `segment_sort`'s buffers in one allocation: first the
    region the kernels need cleared (each pass's digit counts and tile
    counter, then its tiles' status words), then the sorted keys, payload
    and row starts, then the other half of the passes' ping-pong."""

    def __init__(self, n: int, rows: int, F: int):
        self.passes, self.bits = sort_passes(rows)
        self.by_value = F <= SORT_BY_VALUE_MAX_F
        self.pw = F if self.by_value else 1
        radix, tiles = 1 << self.bits, -(-n // SORT_TILE)
        up = lambda b: -(-b // 16) * 16
        self.zeroed = up(4 * self.passes * (radix + 1 + tiles * radix))
        self.keys = self.zeroed
        self.payload = self.keys + up(4 * n)
        self.offsets = self.payload + up(4 * n * self.pw)
        self.keys_tmp = self.offsets + up(4 * (rows + 1))
        self.pay_tmp = self.keys_tmp + (up(4 * n) if self.passes > 1 else 0)
        self.total = self.pay_tmp + (up(4 * n * self.pw) if self.passes > 1 else 0)


def _sort_on_card(idx: torch.Tensor, values: torch.Tensor, rows: int):
    """(buffer, layout): csrc/segment_sort.cu on n >= 1 lookups (int64 idx,
    contiguous float32 values [n, F] on one card)."""
    from tnerf_torch.kernels import build

    n, F = values.shape
    lay = _SortLayout(n, rows, F)
    buf = torch.empty(lay.total, dtype=torch.uint8, device=values.device)
    p = buf.data_ptr()
    tmp = (lay.keys_tmp, lay.pay_tmp) if lay.passes > 1 else (lay.keys, lay.payload)
    err = build.library().tnerf_segment_sort(
        idx.data_ptr(), values.data_ptr(), n, rows, lay.passes, lay.bits, int(lay.by_value),
        lay.pw, SORT_TILE, p + lay.keys, p + lay.payload, p + tmp[0], p + tmp[1],
        p + lay.offsets, p, lay.zeroed, torch.cuda.current_stream(values.device).cuda_stream)
    build.check(err, "tnerf_segment_sort")
    segment_sort.launches += 1
    return buf, lay


def _lookups(values: torch.Tensor, idx: torch.Tensor, rows: int):
    """(values [n, F] contiguous float32, idx [n]) of a call, after the
    limits' check."""
    idx = idx.reshape(-1)
    n = idx.shape[0]
    check_segment_limits(n, rows)
    F = values.shape[-1] if n == 0 else -1
    return values.reshape(n, F).to(torch.float32).contiguous(), idx


def segment_sort_plain(values: torch.Tensor, idx: torch.Tensor, rows: int):
    """The plain PyTorch version of `segment_sort`: `_sorted_rows`."""
    values, idx = _lookups(values, idx, rows)
    sorted_idx, order, offsets = _sorted_rows(idx, rows)
    payload = values[order] if values.shape[1] <= SORT_BY_VALUE_MAX_F else order.to(torch.int32)
    return sorted_idx, payload, offsets.to(torch.int32)


def segment_sort(values: torch.Tensor, idx: torch.Tensor, rows: int):
    """(keys [n] int32, payload, offsets [rows + 1] int32): the lookups idx
    (in [0, rows)) stably sorted by row, and each row's start.  The payload
    is the lookups' values [n, F] float32 in that order where F <=
    SORT_BY_VALUE_MAX_F, else their indices [n] int32.  CPU tensors take
    the plain version, CUDA tensors csrc/segment_sort.cu."""
    if values.device.type == "cpu":
        return segment_sort_plain(values, idx, rows)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sort: unsupported device {values.device}")
    values, idx = _lookups(values, idx, rows)
    n, F = values.shape
    dev = values.device
    by_value = F <= SORT_BY_VALUE_MAX_F
    if n == 0 or rows == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                values.clone() if by_value else torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(rows + 1, dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        buf, lay = _sort_on_card(idx.to(device=dev, dtype=torch.int64).contiguous(), values, rows)
    keys = buf[lay.keys:lay.keys + 4 * n].view(torch.int32)
    payload = buf[lay.payload:lay.payload + 4 * n * lay.pw]
    payload = payload.view(torch.float32).view(n, F) if by_value else payload.view(torch.int32)
    return keys, payload, buf[lay.offsets:lay.offsets + 4 * (rows + 1)].view(torch.int32)


segment_sort.launches = 0


def segment_sum_rows(values: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """out[r] = the sum of values[i] over every i with idx[i] == r, [rows,
    F] float32, in a fixed order (a row's values in lookup order, in E
    strided partial sums, then a fixed tree: `segment_sum_rows_plain`), so
    two calls give the same bits and the CPU and the card agree.  CPU
    tensors take the plain version; CUDA tensors the stable sort by row
    (`segment_sort`, csrc/segment_sort.cu) and the segment-sum kernel
    (csrc/segment_sum.cu) on its sorted stream.  n and rows must be under
    2^31."""
    values, idx = _lookups(values, idx, rows)
    if values.device.type == "cpu":
        return segment_sum_rows_plain(values, idx, rows)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum_rows: unsupported device {values.device}")
    from tnerf_torch.kernels import build

    n, F = values.shape
    dev = values.device
    if n == 0 or rows == 0 or F == 0:
        return torch.zeros((rows, F), dtype=torch.float32, device=dev)
    FT, E, per_block = segment_shape(n, rows, F)
    out = torch.empty((rows, F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        buf, lay = _sort_on_card(idx.to(device=dev, dtype=torch.int64).contiguous(), values, rows)
        p = buf.data_ptr()
        err = build.library().tnerf_segment_sum(
            values.data_ptr(), p + lay.payload, p + lay.offsets, out.data_ptr(), rows, F, FT, E,
            per_block, int(lay.by_value), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "tnerf_segment_sum")
    segment_sum_rows.launches += 1
    return out


segment_sum_rows.launches = 0


class _Lookup(torch.autograd.Function):
    """embedding(idx, table) with the table's values rounded to `dtype`
    (read back as float32, a no-op for float32), and a backward that rounds
    the incoming cotangent to `dtype` and sums it into the table's gradient
    by `segment_sum_rows`, in a fixed order: bit-reproducible on the card,
    as the reference's scatter-add is.  With dtype bfloat16 this is the
    numerics of the reference's one-hot lookup and its transpose
    (`tnerf/fields/onehot.py:65`, `:96`)."""

    @staticmethod
    def forward(ctx, table, idx, dtype):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        ctx.dtype = dtype
        if dtype == torch.float32:
            return torch.nn.functional.embedding(idx, table)
        return torch.nn.functional.embedding(idx, table.to(dtype)).float()

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        g = grad if ctx.dtype == torch.float32 else grad.to(ctx.dtype).float()
        return segment_sum_rows(g, idx, ctx.rows), None, None


def rounded_lookup(table: torch.Tensor, idx: torch.Tensor, dtype) -> torch.Tensor:
    """Rows idx of table ([M, F] -> [..., F] float32); with dtype float32 the
    plain lookup, else the one-hot form's rounding (`_Lookup`).

    Every table lookup of the port goes through here.  The backward is a
    fixed-order sorted segment sum (`segment_sum_rows`, a CUDA kernel on
    the card): `embedding`'s own
    backward sums a row's cotangents in partial segments, in no fixed
    order on the card; advanced indexing's backward (`index_put_` with
    accumulate) repeats but walks a row's cotangents one after another;
    `index_add_` sums them by atomics (tools/torch_field_steps.py,
    PERF.md)."""
    return _Lookup.apply(table, idx, dtype)


@functools.lru_cache(maxsize=None)
def _level_constants(L: int, T: int, n0: int, nmax: int, device: str):
    """(res [L] f32, upper clip res - 1e-4 [L] f32, dense_fits [L] bool, n1
    [L] int64, level offset [L] int64) on device, made once (read-only)."""
    res = _level_resolutions(L, n0, nmax)
    res32 = res.astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(res32), t(res32 - np.float32(1e-4)), t((res + 1) ** 3 <= T), t(res + 1),
            t(np.arange(L, dtype=np.int64) * T))


def _constants(cfg, device):
    return _level_constants(cfg.hash_levels, 1 << cfg.hash_log2_table_size,
                            cfg.hash_base_resolution, cfg.hash_max_resolution, str(device))


def _level_geometry(x01: torch.Tensor, cfg):
    """(i0 [..., L, 3] int64 base corner, frac [..., L, 3] f32) of x01 [...,
    3] at every level (`tnerf/fields/hashgrid.py:57`): scale by the level's
    resolution, clip to [0, res - 1e-4], floor."""
    res, upper, _, _, _ = _constants(cfg, x01.device)
    pos = x01[..., None, :] * res[:, None]
    pos = torch.minimum(torch.clamp_min(pos, 0.0), upper[:, None])
    i0f = torch.floor(pos)
    return i0f.to(torch.int64), pos - i0f


def _index_of(x_, y_, z_, dense_fits, n1, T: int):
    """Within-level table index [..., L] in [0, T) of integer vertex
    coordinates: linear where the level's dense grid fits, else the spatial
    hash; the mask keeps the low bits of the reference's uint32 result."""
    linear = x_ + n1 * (y_ + n1 * z_)
    hashed = x_ ^ y_ * _PRIMES[1] ^ z_ * _PRIMES[2]
    return torch.where(dense_fits, linear, hashed) & (T - 1)


def _corner_index_weight(c: int, i0, frac, dense_fits, n1, T: int):
    """Corner c (0..7) of the trilinear cube: table index [..., L] and weight
    [..., L] f32 (`tnerf/fields/hashgrid.py:87`)."""
    off = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
    idx = _index_of(i0[..., 0] + off[0], i0[..., 1] + off[1], i0[..., 2] + off[2],
                    dense_fits, n1, T)
    w = ((frac[..., 0] if off[0] else 1.0 - frac[..., 0])
         * (frac[..., 1] if off[1] else 1.0 - frac[..., 1])
         * (frac[..., 2] if off[2] else 1.0 - frac[..., 2]))
    return idx, w


def _nearest_index(i0, frac, dense_fits, n1, T: int):
    """Nearest-vertex table index [..., L] (tcnn's 'Nearest' interpolation)."""
    ix = i0 + (frac >= 0.5).to(torch.int64)
    return _index_of(ix[..., 0], ix[..., 1], ix[..., 2], dense_fits, n1, T)


def apply_hashgrid(tables: torch.Tensor, x01: torch.Tensor, cfg) -> torch.Tensor:
    """x01 [..., 3] in [0, 1]^3 -> [..., L*F] features of the [L*T, F] table,
    in the mode `resolve_gather_mode` picks (`tnerf/fields/hashgrid.py:156`)."""
    if not 0 <= cfg.hash_nearest_levels <= cfg.hash_levels:
        raise ValueError(f"hash_nearest_levels={cfg.hash_nearest_levels} must be in "
                         f"[0, hash_levels={cfg.hash_levels}]")
    if resolve_gather_mode(cfg) == "onehot":
        T = 1 << cfg.hash_log2_table_size
        if T % 128 != 0 or T > (1 << 15):
            raise ValueError(f"onehot gather mode needs 128 | T <= 2^15, got "
                             f"T=2^{cfg.hash_log2_table_size}")
        return apply_hashgrid_gather(tables, x01, cfg, lookup_dtype=rounding_dtype(cfg))
    return apply_hashgrid_gather(tables, x01, cfg)


def apply_hashgrid_gather(tables: torch.Tensor, x01: torch.Tensor, cfg,
                          lookup_dtype=torch.float32, levels=None) -> torch.Tensor:
    """The gather form (`tnerf/fields/hashgrid.py:193`): the first K =
    hash_nearest_levels levels read their nearest vertex (weight 1), the
    others sum w * table[idx] over the eight corners in the reference's
    order, starting from zero.  lookup_dtype rounds the table values and
    their cotangents as the one-hot form does (`rounded_lookup`).
    levels=(l0, l1): the features of levels [l0, l1) only, from `tables`
    holding just those levels' rows (a table-parallel rank's block)."""
    L, F = cfg.hash_levels, cfg.hash_features_per_level
    l0, l1 = (0, L) if levels is None else levels
    K = min(max(cfg.hash_nearest_levels - l0, 0), l1 - l0)  # nearest levels of the block
    T = 1 << cfg.hash_log2_table_size
    _, _, dense_fits, n1, level_off = _constants(cfg, x01.device)
    dense_fits, n1, level_off = dense_fits[l0:l1], n1[l0:l1], level_off[:l1 - l0]
    i0, frac = _level_geometry(x01, cfg)
    i0, frac = i0[..., l0:l1, :], frac[..., l0:l1, :]
    Lb = l1 - l0
    parts = []
    if K:
        idxn = _nearest_index(i0[..., :K, :], frac[..., :K, :], dense_fits[:K], n1[:K], T)
        parts.append(rounded_lookup(tables, idxn + level_off[:K], lookup_dtype))
    if K < Lb:
        lin = torch.zeros((*x01.shape[:-1], Lb - K, F), dtype=torch.float32, device=x01.device)
        geom = (i0[..., K:, :], frac[..., K:, :], dense_fits[K:], n1[K:])
        for c in range(8):
            idx, w = _corner_index_weight(c, *geom, T)
            lin = lin + w[..., None] * rounded_lookup(tables, idx + level_off[K:], lookup_dtype)
        parts.append(lin)
    out = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-2)
    return out.reshape(*x01.shape[:-1], Lb * F)
