"""The radiance field outside the fused kernels: encoding + MLP + head
activations (counterpart of `tnerf/fields/nerf_field.py`, the `fused5d`
architecture with frequency encodings, which is the model the fused
renderer trains).  Training renders through kernels B1/B2; this module
owns the parameters and answers the occupancy grid's density probes."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from tnerf_torch.fields.encodings import frequency_encoding, frequency_encoding_dim
from tnerf_torch.fields.mlp import MLP


def density_activation(raw: torch.Tensor) -> torch.Tensor:
    """softplus(raw - 1), as jax.nn.softplus computes it."""
    x = raw - 1.0
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


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

    def normalize_positions(self, x: torch.Tensor) -> torch.Tensor:
        """Grid-AABB coordinates -> [-1, 1]^3."""
        lo = torch.as_tensor(self.grid.aabb_min, dtype=torch.float32, device=x.device)
        hi = torch.as_tensor(self.grid.aabb_max, dtype=torch.float32, device=x.device)
        return 2.0 * (x - lo) / (hi - lo) - 1.0

    def forward(self, positions: torch.Tensor, viewdirs_tp: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions [..., 3], (theta, phi) [..., 2] -> (rgb [..., 3], sigma
        [...]): the reference's `NeRFField.apply` (`nn.Module.apply` means
        something else, so the module's call is its name here)."""
        pos_enc = frequency_encoding(self.normalize_positions(positions),
                                     self.config.n_frequencies)
        view_enc = frequency_encoding(viewdirs_tp * (1.0 / math.pi),
                                      self.config.n_frequencies_view)
        h = torch.cat([pos_enc, view_enc.expand(*pos_enc.shape[:-1], view_enc.shape[-1])], dim=-1)
        dtype = torch.bfloat16 if self.config.compute_dtype == "bfloat16" else torch.float32
        out = self.trunk(h, compute_dtype=dtype)
        return torch.sigmoid(out[..., :3]), density_activation(out[..., 3])

    def density(self, positions: torch.Tensor) -> torch.Tensor:
        """Density-only query for the occupancy refresh.  This architecture
        needs a view direction, so it probes with the fixed (0, 0)."""
        probe = torch.zeros((*positions.shape[:-1], 2), dtype=torch.float32,
                            device=positions.device)
        return self(positions, probe)[1]
