"""Plain MLP with mixed-precision products (counterpart of
`tnerf/fields/mlp.py:18-62`).

Parameters are float32; every layer multiplies bf16-rounded inputs by
bf16-rounded weights and sums in float32, adds the float32 bias, applies
ReLU and rounds to bf16 for the next layer (here: rounds, then applies
ReLU, which gives the same values).  The rounding is written out
and the product runs in float32 (exact for bf16 operands): a bf16 matmul
would round its sums to bf16.  These products lie outside any kernel in
the reference too, so `torch.matmul` is their place.
"""

from __future__ import annotations

import torch
from torch import nn

from tnerf_torch.device import full_f32_matmul


def rounding_dtype(field_cfg) -> torch.dtype:
    """The rounding type of field_.compute_dtype ("bfloat16" or float32)."""
    return torch.bfloat16 if field_cfg.compute_dtype == "bfloat16" else torch.float32


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
        return mlp_forward(list(self.w), list(self.b), x, compute_dtype)


def mlp_forward(ws, bs, x: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16):
    """The MLP of weights ws ([in, out] each) and biases bs on x [..., in]
    -> [..., out] float32 (raw last-layer output).

    Written for the fewest passes over the activations, which is what an
    unfused layer costs on the card: the bias is added in the product's own
    epilogue (`addmm`), and a hidden layer's output is rounded before the
    ReLU (the two commute: rounding keeps signs and zero) and rectified in
    place in the narrow type."""
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1]).to(compute_dtype)
    n = len(ws)
    with full_f32_matmul():
        for i, (w, b) in enumerate(zip(ws, bs)):
            h = torch.addmm(b, h.float(), w.to(compute_dtype).float())
            if i < n - 1:
                h = torch.relu_(h.to(compute_dtype))
    return h.reshape(*lead, h.shape[-1])
