"""Plain MLP with mixed-precision products (counterpart of
`tnerf/fields/mlp.py:18-62`).

Parameters are float32; every layer multiplies bf16-rounded inputs by
bf16-rounded weights and sums in float32, adds the float32 bias, applies
ReLU and rounds to bf16 for the next layer.  The rounding is written out
and the product runs in float32 (exact for bf16 operands): a bf16 matmul
would round its sums to bf16.  These products lie outside any kernel in
the reference too, so `torch.matmul` is their place.
"""

from __future__ import annotations

import torch
from torch import nn

from tnerf_torch.device import full_f32_matmul


class MLP(nn.Module):
    """`hidden_layers` hidden matmuls: [in -> w] + (hidden_layers - 1) x
    [w -> w] + [w -> out].  Weights are [in, out], He-normal from the
    given generator; biases zero.  Parameter names are `w.<l>` / `b.<l>`."""

    def __init__(self, in_dim: int, hidden_width: int, hidden_layers: int, out_dim: int,
                 generator: torch.Generator):
        super().__init__()
        dims = [in_dim] + [hidden_width] * hidden_layers + [out_dim]
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            std = (2.0 / d_in) ** 0.5
            self.w.append(nn.Parameter(
                torch.randn((d_in, d_out), generator=generator, dtype=torch.float32) * std))
            self.b.append(nn.Parameter(torch.zeros((d_out,), dtype=torch.float32)))

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16):
        """[..., in_dim] -> [..., out_dim] float32 (raw last-layer output)."""
        h = x.to(compute_dtype)
        n = len(self.w)
        with full_f32_matmul():
            for i, (w, b) in enumerate(zip(self.w, self.b)):
                h = h.float() @ w.to(compute_dtype).float() + b
                if i < n - 1:
                    h = torch.relu(h).to(compute_dtype)
        return h
