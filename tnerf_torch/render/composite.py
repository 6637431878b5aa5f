"""Emission-absorption quadrature (counterpart of `tnerf/render/composite.py`).

    alpha_i = 1 - exp(-sigma_i * delta_i)
    T_i     = exp(-sum_{j<i} sigma_j delta_j)     (exclusive)
    w_i     = T_i * alpha_i
    rgb     = sum_i w_i c_i  (+ background * (1 - sum_i w_i))

The ground-truth renderer of the procedural scenes uses it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RenderResult(NamedTuple):
    """Renderer output.  The fused renderer composites inside its kernel
    and returns zero-width `weights` / `transmittance`."""

    rgb: torch.Tensor            # [..., 3]
    acc: torch.Tensor            # [...]
    depth: torch.Tensor          # [...] sum of w * t
    weights: torch.Tensor        # [..., S] (S = 0 from the fused renderer)
    transmittance: torch.Tensor  # [..., S] (S = 0 from the fused renderer)
    distortion: torch.Tensor     # [...] (0 from the fused renderer)


def render_weights(sigma, deltas, mask=None):
    """(weights, transmittance) per sample, float32."""
    tau = sigma.float() * deltas.float()
    if mask is not None:
        tau = torch.where(mask, tau, torch.zeros_like(tau))
    tau_cum = torch.cumsum(tau, dim=-1) - tau
    transmittance = torch.exp(-tau_cum)
    weights = transmittance * (1.0 - torch.exp(-tau))
    return weights, transmittance


def distortion_term(weights, t_mid, deltas):
    """Per-ray mip-NeRF 360 distortion (eq. 15), O(S) cumsum form."""
    w = weights.float()
    s = t_mid.float()
    wc = torch.cumsum(w, dim=-1) - w
    wsc = torch.cumsum(w * s, dim=-1) - w * s
    inter = 2.0 * torch.sum(w * (s * wc - wsc), dim=-1)
    intra = torch.sum(w * w * deltas.float(), dim=-1) / 3.0
    return inter + intra


def composite(rgb, sigma, deltas, t_mid=None, mask=None, background: Optional[torch.Tensor] = None,
              white_background: bool = False) -> RenderResult:
    """Per-sample radiance [..., S, 3] and density [..., S] -> per-ray pixel."""
    weights, transmittance = render_weights(sigma, deltas, mask)
    out_rgb = torch.sum(weights[..., None] * rgb.float(), dim=-2)
    acc = torch.sum(weights, dim=-1)
    if t_mid is None:
        depth = torch.zeros_like(acc)
        distortion = torch.zeros_like(acc)
    else:
        depth = torch.sum(weights * t_mid.float(), dim=-1)
        distortion = distortion_term(weights, t_mid, deltas)
    if background is None and white_background:
        background = torch.ones(3, dtype=torch.float32, device=acc.device)
    if background is not None:
        out_rgb = out_rgb + (1.0 - acc)[..., None] * background
    return RenderResult(out_rgb, acc, depth, weights, transmittance, distortion)
