"""Triplane (TensoRF's vector-matrix factorization) and CP field encodings
(counterpart of `tnerf/fields/triplane.py`, the gather forms).

Triplane: three R x R feature planes and three R-entry feature lines,
feat_p(x) = bilinear(plane_p, proj_p(x)) * linear(line_p, axis_p(x)) for
the pairs (XY, Z), (XZ, Y), (YZ, X): [..., 3F] features.  CP: the rank-F
product of three R-entry line factors, one per axis: [..., F] features.
The R vertices span [0, 1] with R - 1 cells.  The reference's one-hot
forms (MXU matrix products standing in for the TPU's gather) differ from
the gather forms only in rounding: with tri_gather_mode="onehot" the table
values and each corner's cotangent are rounded to field_.compute_dtype
(`hashgrid.rounded_lookup`); "auto" resolves to "gather" as the reference
does off a TPU.
"""

from __future__ import annotations

import numpy as np
import torch

from tnerf_torch.fields.hashgrid import rounded_lookup
from tnerf_torch.fields.mlp import rounding_dtype

def init_triplane(cfg, generator: torch.Generator):
    """(planes [3, R*R, F], lines [3, R, F]) float32, 0.1 * N(0, 1)."""
    R, F = cfg.tri_resolution, cfg.tri_features
    planes = 0.1 * torch.randn((3, R * R, F), generator=generator, dtype=torch.float32)
    lines = 0.1 * torch.randn((3, R, F), generator=generator, dtype=torch.float32)
    return planes, lines


def init_cp(cfg, generator: torch.Generator) -> torch.Tensor:
    """lines [3, R, F] float32, 0.2 * N(0, 1) (three factors, hence the larger scale)."""
    R, F = cfg.tri_resolution, cfg.tri_features
    return 0.2 * torch.randn((3, R, F), generator=generator, dtype=torch.float32)


def triplane_num_params(cfg) -> int:
    R, F = cfg.tri_resolution, cfg.tri_features
    return 3 * R * R * F + 3 * R * F


def cp_num_params(cfg) -> int:
    return 3 * cfg.tri_resolution * cfg.tri_features


def _resolve(cfg, what: str) -> str:
    mode = cfg.tri_gather_mode
    if mode not in ("auto", "gather", "onehot"):
        raise ValueError(f"tri_gather_mode must be auto, gather or onehot, got {mode!r}")
    if mode == "onehot" and what == "triplane" and cfg.tri_resolution ** 2 > (1 << 15):
        raise ValueError(f"onehot triplane mode needs R*R <= 2^15, got R={cfg.tri_resolution}")
    return "gather" if mode == "auto" else mode


def resolve_tri_mode(cfg) -> str:
    """"gather" or "onehot" (`tnerf/fields/triplane.py:163`); "auto" -> "gather"."""
    return _resolve(cfg, "triplane")


def resolve_cp_mode(cfg) -> str:
    """"gather" or "onehot" (`tnerf/fields/triplane.py:408`); "auto" -> "gather"."""
    return _resolve(cfg, "cp")


def _vertex_geometry(x01: torch.Tensor, R: int):
    """(i0 [..., 3] int64, frac [..., 3] f32) of x01 on the R-vertex grid of
    each axis: x01 (R - 1) clipped to [0, R - 1 - 1e-4], floored
    (`tnerf/fields/triplane.py:128`, `:377`)."""
    pos = torch.clamp(x01 * (R - 1), 0.0, (R - 1) - 1e-4)
    i0 = torch.floor(pos)
    return i0.to(torch.int64), pos - i0


def _plane_axes(a: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 2]: the components each plane reads, (x, y),
    (x, z), (y, z); plane p's line reads the remaining axis, z, y, x."""
    return torch.stack([a[..., 0:2], a[..., 0::2], a[..., 1:3]], dim=-2)


def _plane_corner(c: int, ip0, fp, R: int):
    """Bilinear corner c (0..3): flat plane index [..., 3] in [0, R*R) and
    weight [..., 3] f32 (`tnerf/fields/triplane.py:146`)."""
    du, dv = (c >> 1) & 1, c & 1
    idx = (ip0[..., 0] + du) * R + (ip0[..., 1] + dv)
    w = (fp[..., 0] if du else 1.0 - fp[..., 0]) * (fp[..., 1] if dv else 1.0 - fp[..., 1])
    return idx, w


def vm_product_gather(planes3: torch.Tensor, lines3: torch.Tensor, x01: torch.Tensor, R: int,
                      lookup_dtype=torch.float32) -> torch.Tensor:
    """The VM product: planes3 [3, R*R, F], lines3 [3, R, F] -> [..., 3, F]
    (`tnerf/fields/triplane.py:191`): four plane corners, then two line
    vertices, each summed from zero in the reference's order."""
    f = planes3.shape[-1]
    dev = x01.device
    i0, frac = _vertex_geometry(x01, R)
    ip0, fp = _plane_axes(i0), _plane_axes(frac)  # [..., 3, 2]
    il0, fl = i0.flip(-1), frac.flip(-1)           # [..., 3]: axes z, y, x
    planes = planes3.reshape(3 * R * R, f)
    lines = lines3.reshape(3 * R, f)
    off_p = torch.arange(3, device=dev) * (R * R)
    off_l = torch.arange(3, device=dev) * R
    B = torch.zeros((*x01.shape[:-1], 3, f), dtype=torch.float32, device=dev)
    for c in range(4):
        idx, w = _plane_corner(c, ip0, fp, R)
        B = B + w[..., None] * rounded_lookup(planes, idx + off_p, lookup_dtype)
    Lin = torch.zeros_like(B)
    for c in range(2):
        w = fl if c else 1.0 - fl
        Lin = Lin + w[..., None] * rounded_lookup(lines, il0 + c + off_l, lookup_dtype)
    return B * Lin


def apply_triplane(planes: torch.Tensor, lines: torch.Tensor, x01: torch.Tensor,
                   cfg) -> torch.Tensor:
    """x01 [..., 3] in [0, 1]^3 -> [..., 3F] VM features (`:172`, `:220`)."""
    dtype = rounding_dtype(cfg) if resolve_tri_mode(cfg) == "onehot" else torch.float32
    out = vm_product_gather(planes, lines, x01, cfg.tri_resolution, dtype)
    return out.reshape(*x01.shape[:-1], 3 * cfg.tri_features)


def cp_factors(lines3: torch.Tensor, i0, frac, lookup_dtype=torch.float32) -> torch.Tensor:
    """Linearly interpolated per-axis factors [..., 3, F] of lines3 [3, R, F]
    (`tnerf/fields/triplane.py:385`)."""
    R, F = lines3.shape[1], lines3.shape[-1]
    lines = lines3.reshape(3 * R, F)
    off = torch.arange(3, device=i0.device) * R
    out = torch.zeros((*i0.shape[:-1], 3, F), dtype=torch.float32, device=i0.device)
    for c in range(2):
        w = frac if c else 1.0 - frac
        out = out + w[..., None] * rounded_lookup(lines, i0 + c + off, lookup_dtype)
    return out


def apply_cp(lines: torch.Tensor, x01: torch.Tensor, cfg) -> torch.Tensor:
    """x01 [..., 3] in [0, 1]^3 -> [..., F] CP features (`:399`)."""
    dtype = rounding_dtype(cfg) if resolve_cp_mode(cfg) == "onehot" else torch.float32
    fac = cp_factors(lines, *_vertex_geometry(x01, cfg.tri_resolution), dtype)
    return fac[..., 0, :] * fac[..., 1, :] * fac[..., 2, :]


def _resize_vertex_axis(a: torch.Tensor, axis: int, r_new: int) -> torch.Tensor:
    """Align-corners linear resize along a vertex axis (`:72`): the new
    vertices sample the old interpolant where they lie."""
    r_old = a.shape[axis]
    pos = vertex_positions(r_old, r_new).to(a.device)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, max(r_old - 2, 0))
    f = pos - i0.to(torch.float32)
    a0 = torch.index_select(a, axis, i0)
    a1 = torch.index_select(a, axis, torch.clamp_max(i0 + 1, r_old - 1))
    shape = [1] * a.ndim
    shape[axis] = r_new
    f = f.reshape(shape)
    return a0 * (1.0 - f) + a1 * f


def vertex_positions(r_old: int, r_new: int) -> torch.Tensor:
    """jnp.linspace(0.0, r_old - 1.0, r_new) in float32 as the reference's
    XLA computes it: i * RN((r_old - 1) * RN(1 / (r_new - 1))), the last
    point r_old - 1 (it multiplies by the reciprocal of the constant and
    folds the constants together; `tests/test_torch_table_fields.py`)."""
    stop = np.float32(r_old - 1.0)
    if r_new == 1:
        return torch.zeros((1,), dtype=torch.float32)
    step = stop * (np.float32(1.0) / np.float32(r_new - 1))
    return torch.cat([torch.arange(r_new - 1, dtype=torch.float32) * step,
                      torch.tensor([stop], dtype=torch.float32)])


def upsample_triplane(planes: torch.Tensor, lines: torch.Tensor, r_new: int):
    """TensoRF's progressive upsampling step (`:90`): planes [3, R*R, F] and
    lines [3, R, F] resampled onto r_new vertices per axis (align corners)."""
    r_old, f = lines.shape[1], planes.shape[-1]
    p = planes.reshape(3, r_old, r_old, f)
    p = _resize_vertex_axis(_resize_vertex_axis(p, 1, r_new), 2, r_new)
    return p.reshape(3, r_new * r_new, f), _resize_vertex_axis(lines, 1, r_new)


def triplane_tv(planes: torch.Tensor, lines: torch.Tensor) -> torch.Tensor:
    """TensoRF's total variation of the VM factors (`:109`): the mean squared
    difference of adjacent vertices along both plane axes and the lines."""
    r, f = lines.shape[1], planes.shape[-1]
    p = planes.reshape(3, r, r, f)
    return (torch.square(torch.diff(p, dim=1)).mean()
            + torch.square(torch.diff(p, dim=2)).mean()
            + torch.square(torch.diff(lines, dim=1)).mean())
