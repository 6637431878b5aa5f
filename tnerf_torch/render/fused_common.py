"""Static algebra of the fused renderer (the port's own copy of
`tnerf/render/fused_common.py:21-93`, numpy float32 exactly as there) and
its ray compaction (`compact_rows` / `scatter_back`, :97-127).

The frequency encoding and the raw-coordinate normalization fold into
static matrices, so the kernel feeds raw (x, y, z, theta, phi):
sin((s p + b) f + c) = sin(p (s f) + (b f + c)).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

LANES = 128  # encoded feature width and MLP width of the fused kernel


def _norm_affine(grid_cfg) -> Tuple[np.ndarray, np.ndarray]:
    """Per-feature affine (s, b) with p5_normalized = s * p5_raw + b,
    p5_raw = [x, y, z, theta, phi]: positions map to [-1, 1] over the
    grid AABB, angles scale by 1/pi."""
    lo = np.asarray(grid_cfg.aabb_min, np.float32)
    hi = np.asarray(grid_cfg.aabb_max, np.float32)
    ih = 2.0 / (hi - lo)
    s = np.concatenate([ih, [1.0 / math.pi, 1.0 / math.pi]]).astype(np.float32)
    b = np.concatenate([-lo * ih - 1.0, [0.0, 0.0]]).astype(np.float32)
    return s, b


def _encoding_matrices(cfg, s: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """Static (A, C) with enc = concat([p5_raw, sin(p5_raw @ A + C)]):
    columns are (axis, frequency pi * 2^k, phase 0 | pi/2)."""
    L3, L2 = cfg.n_frequencies, cfg.n_frequencies_view
    cols = []
    for axis in range(3):
        for k in range(L3):
            for phase in (0.0, 0.5 * math.pi):
                cols.append((axis, math.pi * 2.0 ** k, phase))
    for axis in (3, 4):
        for k in range(L2):
            for phase in (0.0, 0.5 * math.pi):
                cols.append((axis, math.pi * 2.0 ** k, phase))
    n_feat = 5 + len(cols)
    if n_feat > LANES:
        raise ValueError(
            f"encoded width {n_feat} exceeds {LANES}; lower n_frequencies "
            f"(the fused kernel supports 3*2*L3 + 2*2*L2 <= 123)"
        )
    A = np.zeros((8, LANES - 5), np.float32)  # rows 0..4 used
    C = np.zeros((8, LANES - 5), np.float32)  # row 0 used
    for j, (axis, f, phase) in enumerate(cols):
        A[axis, j] = s[axis] * f
        C[0, j] = b[axis] * f + phase
    return A, C, n_feat


def _feature_permutation(cfg) -> np.ndarray:
    """perm[kernel_feature_index] = field_feature_index.

    The field orders features [x,y,z, per-dim sin*L cos*L, th,ph, per-dim
    sin*L cos*L]; the kernel orders [x,y,z,th,ph, per-axis (sin,cos)
    frequency-interleaved].  Layer-0 weight rows are permuted at pack time."""
    L3, L2 = cfg.n_frequencies, cfg.n_frequencies_view
    pos_w = 3 + 3 * 2 * L3
    perm = [0, 1, 2, pos_w + 0, pos_w + 1]
    for axis in range(3):
        base = 3 + axis * 2 * L3
        for k in range(L3):
            perm += [base + k, base + L3 + k]
    for axis in range(2):
        base = pos_w + 2 + axis * 2 * L2
        for k in range(L2):
            perm += [base + k, base + L2 + k]
    return np.asarray(perm, np.int64)


def compact_rows(keep, rows, cap: int):
    """Pack the kept rows of `rows` [B, K] into a static [cap, K] buffer,
    in their order (`tnerf/render/fused_common.py:97`).

    widx[i] is ray i's rank among the kept rays, or `cap` for a dropped
    ray.  Rows are written into a [cap + 1, K] buffer whose last row is
    sacrificial: dropped rays and kept rays beyond `cap` land there and
    are cut off, so over-capacity rays read back as background at
    `scatter_back`.  The capacity is static, so nothing here waits for the
    device to learn how many rays were kept.

    Returns (buf [cap, K], widx [B] int64)."""
    widx = torch.where(keep, torch.cumsum(keep, dim=0) - 1, cap)
    buf = torch.zeros((cap + 1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    buf[torch.clamp_max(widx, cap)] = rows
    return buf[:cap], widx


def scatter_back(out_rows, widx, bg_row):
    """Inverse of `compact_rows` for per-ray outputs: out_rows [cap, K]
    rendered from the compacted buffer, bg_row [1, K] -> [B, K].  Dropped
    (widx == cap) and over-capacity (widx > cap) rays both read the
    background row."""
    cap = out_rows.shape[0]
    return torch.cat([out_rows, bg_row], dim=0)[torch.clamp_max(widx, cap)]
