"""Input encodings (counterpart of `tnerf/fields/encodings.py`): the
frequency encoding (:23) with BARF's band window (:54) and the real
spherical-harmonics basis of view directions (:71).  The table-backed
position encodings are in `fields/hashgrid.py` and `fields/triplane.py`."""

from __future__ import annotations

import math

import torch


def frequency_encoding(x: torch.Tensor, n_frequencies: int, include_input: bool = True,
                       scale: float = math.pi, window: "torch.Tensor | None" = None
                       ) -> torch.Tensor:
    """NeRF positional encoding [..., D] -> [..., D * (2L (+ 1))]: per input
    dimension (sin(2^0 s p) .. sin(2^{L-1} s p), cos(2^0 s p) .. cos(2^{L-1}
    s p)), optionally behind p itself.  scale = pi: inputs normalized to
    [-1, 1] see their full period at octave 0.  window: [L] band weights
    (`barf_window`) scaling each band's sin and cos; p itself is never
    windowed."""
    if n_frequencies <= 0:
        return x
    freqs = scale * (2.0 ** torch.arange(n_frequencies, dtype=torch.float32, device=x.device))
    xb = x[..., None] * freqs  # [..., D, L]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)  # [..., D, 2L]
    if window is not None:
        enc = enc * torch.cat([window, window])
    enc = enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * n_frequencies)
    return torch.cat([x, enc], dim=-1) if include_input else enc


def barf_window(alpha: torch.Tensor, n_frequencies: int) -> torch.Tensor:
    """BARF's coarse-to-fine band weights (`tnerf/fields/encodings.py:54`,
    Lin et al. 2021 eq. 14): band k weighs (1 - cos(pi t)) / 2 with t =
    clip(alpha L - k, 0, 1), so alpha in [0, 1] sweeps the active bands
    from none to all."""
    k = torch.arange(n_frequencies, dtype=torch.float32, device=alpha.device)
    t = torch.clamp(alpha * n_frequencies - k, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * t))


def frequency_encoding_dim(in_dim: int, n_frequencies: int, include_input: bool = True) -> int:
    return in_dim * 2 * n_frequencies + (in_dim if include_input else 0)


# Real SH constants of bands l = 0..3 (tcnn SphericalHarmonics semantics).
_SH_C0 = 0.28209479177387814
_SH_C1 = 0.48860251190291987


def sh_encoding(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical-harmonics basis of view directions [..., 3] ->
    [..., degree**2] (bands l = 0..degree-1), as
    `tnerf/fields/encodings.py:71` computes it: the closed forms in the
    components of dirs * rsqrt(|dirs|^2 + 1e-20), term by term in the same
    order, so any nonzero vector may be passed."""
    if not 1 <= degree <= 4:
        raise ValueError(f"sh degree must be in 1..4, got {degree}")
    d = dirs * torch.rsqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True) + 1e-20)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full_like(x, _SH_C0)]
    if degree > 1:
        out += [-_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x]
    if degree > 2:
        xy, yz, xz = x * y, y * z, x * z
        x2, y2, z2 = x * x, y * y, z * z
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if degree > 3:  # the l = 3 forms use x^2 + y^2 = 1 - z^2 (unit input)
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.37317633259011546 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)


def sh_encoding_dim(degree: int) -> int:
    return degree * degree
