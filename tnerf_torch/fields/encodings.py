"""Input encodings (counterpart of `tnerf/fields/encodings.py:23`; the
frequency encoding only, which is what the fused frequency-MLP model uses)."""

from __future__ import annotations

import math

import torch


def frequency_encoding(x: torch.Tensor, n_frequencies: int, include_input: bool = True,
                       scale: float = math.pi) -> torch.Tensor:
    """NeRF positional encoding [..., D] -> [..., D * (2L (+ 1))]: per input
    dimension (sin(2^0 s p) .. sin(2^{L-1} s p), cos(2^0 s p) .. cos(2^{L-1}
    s p)), optionally behind p itself.  scale = pi: inputs normalized to
    [-1, 1] see their full period at octave 0."""
    if n_frequencies <= 0:
        return x
    freqs = scale * (2.0 ** torch.arange(n_frequencies, dtype=torch.float32, device=x.device))
    xb = x[..., None] * freqs  # [..., D, L]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)  # [..., D, 2L]
    enc = enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * n_frequencies)
    return torch.cat([x, enc], dim=-1) if include_input else enc


def frequency_encoding_dim(in_dim: int, n_frequencies: int, include_input: bool = True) -> int:
    return in_dim * 2 * n_frequencies + (in_dim if include_input else 0)
