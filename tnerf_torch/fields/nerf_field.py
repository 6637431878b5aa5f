"""The radiance field outside the fused kernels: encoding + MLP + head
activations (counterpart of `tnerf/fields/nerf_field.py`, the `fused5d`
architecture with frequency encodings).  The fused renderer evaluates
this model inside kernels B1 / B2; the unfused renderers call
`apply_field` per sample, and the occupancy grid's density probes go
through `NeRFField.density`.  `NeRFField` owns the parameters."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from tnerf_torch.fields.encodings import frequency_encoding, frequency_encoding_dim
from tnerf_torch.fields.mlp import MLP, mlp_forward
from tnerf_torch.utils.checkpoint import n_layers


def density_activation(raw: torch.Tensor) -> torch.Tensor:
    """softplus(raw - 1), as jax.nn.softplus computes it."""
    x = raw - 1.0
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def normalize_positions(x: torch.Tensor, grid_cfg) -> torch.Tensor:
    """Grid-AABB coordinates -> [-1, 1]^3."""
    lo = torch.as_tensor(grid_cfg.aabb_min, dtype=torch.float32, device=x.device)
    hi = torch.as_tensor(grid_cfg.aabb_max, dtype=torch.float32, device=x.device)
    return 2.0 * (x - lo) / (hi - lo) - 1.0


# Samples per slab of a field evaluation that records no gradients: an
# eval chunk of the intervals renderer is 32768 rays x 768 samples, whose
# activations at full width would not fit the card in one piece.
EVAL_SLAB = 1 << 21


def apply_field(params: Dict[str, torch.Tensor], field_cfg, grid_cfg, positions: torch.Tensor,
                viewdirs_tp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The field of `params` ({"trunk.w.<l>", "trunk.b.<l>"}, as a
    checkpoint or `NeRFField.params()` gives them) at positions [..., 3]
    seen along (theta, phi) [..., 2] (broadcast against the positions) ->
    (rgb [..., 3], sigma [...]): the reference's `NeRFField.apply(params,
    ...)`, which the unfused renderers call per sample.  Where no gradient
    is recorded, more than EVAL_SLAB samples are evaluated slab by slab."""
    n = positions.numel() // 3
    if n > EVAL_SLAB and not torch.is_grad_enabled():
        batch = positions.shape[:-1]
        pos = positions.reshape(n, 3)
        view = viewdirs_tp.expand(*batch, 2).reshape(n, 2)
        parts = [apply_field(params, field_cfg, grid_cfg, pos[i:i + EVAL_SLAB],
                             view[i:i + EVAL_SLAB]) for i in range(0, n, EVAL_SLAB)]
        return (torch.cat([p[0] for p in parts]).reshape(*batch, 3),
                torch.cat([p[1] for p in parts]).reshape(batch))
    pos_enc = frequency_encoding(normalize_positions(positions, grid_cfg),
                                 field_cfg.n_frequencies)
    view_enc = frequency_encoding(viewdirs_tp * (1.0 / math.pi), field_cfg.n_frequencies_view)
    h = torch.cat([pos_enc, view_enc.expand(*pos_enc.shape[:-1], view_enc.shape[-1])], dim=-1)
    dtype = torch.bfloat16 if field_cfg.compute_dtype == "bfloat16" else torch.float32
    L = n_layers(params)
    out = mlp_forward([params[f"trunk.w.{l}"] for l in range(L)],
                      [params[f"trunk.b.{l}"] for l in range(L)], h, compute_dtype=dtype)
    return torch.sigmoid(out[..., :3]), density_activation(out[..., 3])


class NeRFField(nn.Module):
    """One trunk on enc(x) ++ enc(view) -> (rgb, sigma).  Its parameters
    are named `trunk.w.<l>` / `trunk.b.<l>`, the flat names of
    `checkpoint.params_from_jax`, so `load_state_dict` takes that dict."""

    def __init__(self, field_cfg, grid_cfg, generator: torch.Generator):
        super().__init__()
        if field_cfg.encoding != "frequency" or field_cfg.view_encoding != "frequency" \
                or field_cfg.view_param != "thetaphi":
            raise NotImplementedError(
                f"field_.encoding={field_cfg.encoding!r} / view_encoding="
                f"{field_cfg.view_encoding!r} / view_param={field_cfg.view_param!r} is not yet "
                "ported to tnerf_torch (frequency encodings of (theta, phi) only), see ROADMAP.md")
        self.config = field_cfg
        self.grid = grid_cfg
        in_dim = frequency_encoding_dim(3, field_cfg.n_frequencies) \
            + frequency_encoding_dim(2, field_cfg.n_frequencies_view)
        self.trunk = MLP(in_dim, field_cfg.hidden_width, field_cfg.hidden_layers, 4, generator)

    def params(self) -> Dict[str, nn.Parameter]:
        """{"trunk.w.<l>", "trunk.b.<l>"}: what the renderers take."""
        return dict(self.named_parameters())

    def forward(self, positions: torch.Tensor, viewdirs_tp: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions [..., 3], (theta, phi) [..., 2] -> (rgb [..., 3], sigma
        [...]) with the module's own parameters."""
        return apply_field(self.params(), self.config, self.grid, positions, viewdirs_tp)

    def density(self, positions: torch.Tensor) -> torch.Tensor:
        """Density-only query for the occupancy refresh.  This architecture
        needs a view direction, so it probes with the fixed (0, 0)."""
        probe = torch.zeros((*positions.shape[:-1], 2), dtype=torch.float32,
                            device=positions.device)
        return self(positions, probe)[1]
