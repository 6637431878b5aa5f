"""The radiance field outside the fused kernels: encoding + MLP + head
activations (counterpart of `tnerf/fields/nerf_field.py`).  Two
architectures, picked from the encoding as `tnerf/train_loop.py:66` picks
them (`field_arch`):

- "fused5d": the frequency encoding of the position and of (theta, phi)
  into one trunk -> (rgb, sigma); the model kernels B1 / B2 evaluate on
  the fused path;
- "twobranch" (hashgrid, triplane, cp): a table-backed encoding of the
  position in [0, 1]^3 into a density trunk -> (sigma, GEO_FEATURES
  geometry features); a colour head on [geometry ++ view encoding] -> rgb.

The unfused renderers call `apply_field` per sample, and the occupancy
grid's density probes go through `NeRFField.density`.  `NeRFField` owns
the parameters; their flat names (`trunk.w.<l>`, `color.b.<l>`,
`hashgrid.tables`, `triplane.planes`, ...) are those of
`checkpoint.params_from_jax`."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from tnerf_torch.cameras import thetaphi_to_unit
from tnerf_torch.fields.encodings import (
    barf_window,
    frequency_encoding,
    frequency_encoding_dim,
    sh_encoding,
    sh_encoding_dim,
)
from tnerf_torch.fields.hashgrid import apply_hashgrid, init_hashgrid
from tnerf_torch.fields.mlp import MLP, mlp_forward, rounding_dtype
from tnerf_torch.fields.triplane import apply_cp, apply_triplane, init_cp, init_triplane

GEO_FEATURES = 15  # geometry features the twobranch trunk hands the colour head
TABLE_ENCODINGS = ("hashgrid", "triplane", "cp")


def field_arch(field_cfg) -> str:
    """"twobranch" for the table-backed encodings, else "fused5d"."""
    return "twobranch" if field_cfg.encoding in TABLE_ENCODINGS else "fused5d"


def density_activation(raw: torch.Tensor) -> torch.Tensor:
    """softplus(raw - 1), as jax.nn.softplus computes it."""
    x = raw - 1.0
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def normalize_positions(x: torch.Tensor, grid_cfg) -> torch.Tensor:
    """Grid-AABB coordinates -> [-1, 1]^3."""
    lo = torch.as_tensor(grid_cfg.aabb_min, dtype=torch.float32, device=x.device)
    hi = torch.as_tensor(grid_cfg.aabb_max, dtype=torch.float32, device=x.device)
    return 2.0 * (x - lo) / (hi - lo) - 1.0


def mlp_shape(field_cfg) -> Tuple[int, int]:
    """(width, hidden layers) of the trunk (`nerf_field.py:191`)."""
    if field_cfg.encoding == "hashgrid":
        return field_cfg.hash_hidden_width, field_cfg.hash_hidden_layers
    if field_cfg.encoding in ("triplane", "cp"):
        return field_cfg.tri_hidden_width, field_cfg.tri_hidden_layers
    return field_cfg.hidden_width, field_cfg.hidden_layers


def pos_enc_dim(field_cfg) -> int:
    if field_cfg.encoding == "frequency":
        return frequency_encoding_dim(3, field_cfg.n_frequencies)
    if field_cfg.encoding == "triplane":
        return 3 * field_cfg.tri_features
    if field_cfg.encoding == "cp":
        return field_cfg.tri_features
    if field_cfg.encoding == "hashgrid":
        return field_cfg.hash_levels * field_cfg.hash_features_per_level
    raise ValueError(f"unknown encoding {field_cfg.encoding!r}")


def view_enc_dim(field_cfg) -> int:
    if field_cfg.view_encoding == "sh":
        return sh_encoding_dim(field_cfg.sh_degree)
    d = 3 if field_cfg.view_param == "unit" else 2
    return frequency_encoding_dim(d, field_cfg.n_frequencies_view)


def encode_positions(params: Dict[str, torch.Tensor], field_cfg, grid_cfg,
                     positions: torch.Tensor) -> torch.Tensor:
    """The position encoding [..., 3] -> [..., pos_enc_dim]: the frequency
    encoding of the [-1, 1]^3 position, BARF-windowed where params hold a
    `freq_alpha` (train.freq_anneal_steps; `nerf_field.py:113`, the alpha
    with its gradient cut), or the table encoding of the [0, 1]^3 position
    0.5 (normalized + 1) (`nerf_field.py:129`); a field config with a
    `table_shard` (`parallel/table_parallel.with_table_shard`) encodes
    from this rank's block of the tables and gathers the features."""
    xn = normalize_positions(positions, grid_cfg)
    enc = field_cfg.encoding
    if enc == "frequency":
        window = None
        if "freq_alpha" in params:
            window = barf_window(params["freq_alpha"].detach(), field_cfg.n_frequencies)
        return frequency_encoding(xn, field_cfg.n_frequencies, window=window)
    xn01 = 0.5 * (xn + 1.0)
    shard = getattr(field_cfg, "table_shard", None)
    if shard is not None:  # table-parallel (`nerf_field.py:64-140`)
        from tnerf_torch.parallel import table_parallel as tp

        if enc == "hashgrid":
            return tp.tp_apply_hashgrid(params, xn01, field_cfg, shard)
        return tp.tp_apply_triplane(params, xn01, field_cfg, shard)
    if enc == "hashgrid":
        return apply_hashgrid(params["hashgrid.tables"], xn01, field_cfg)
    if enc == "triplane":
        return apply_triplane(params["triplane.planes"], params["triplane.lines"], xn01,
                              field_cfg)
    if enc == "cp":
        return apply_cp(params["cp.lines"], xn01, field_cfg)
    raise ValueError(f"unknown encoding {enc!r}")


def encode_view(field_cfg, viewdirs_tp: torch.Tensor) -> torch.Tensor:
    """The view encoding of (theta, phi) [..., 2]: spherical harmonics of
    the unit direction `thetaphi_to_unit` makes of it, as the reference's
    field does with the (theta, phi) its renderers pass; or the frequency
    encoding of (theta, phi) / pi, or under field_.view_param="unit" of
    that unit direction (`nerf_field.py:160-170`)."""
    if field_cfg.view_encoding == "sh":
        return sh_encoding(thetaphi_to_unit(viewdirs_tp), field_cfg.sh_degree)
    if field_cfg.view_encoding != "frequency":
        raise ValueError(f"unknown view_encoding {field_cfg.view_encoding!r}")
    if field_cfg.view_param == "unit":
        return frequency_encoding(thetaphi_to_unit(viewdirs_tp), field_cfg.n_frequencies_view)
    if field_cfg.view_param != "thetaphi":
        raise ValueError(f"unknown view_param {field_cfg.view_param!r}")
    return frequency_encoding(viewdirs_tp * (1.0 / math.pi), field_cfg.n_frequencies_view)


def _mlp(params, name: str, x: torch.Tensor, dtype) -> torch.Tensor:
    L = sum(1 for k in params if k.startswith(f"{name}.w."))
    return mlp_forward([params[f"{name}.w.{l}"] for l in range(L)],
                       [params[f"{name}.b.{l}"] for l in range(L)], x, compute_dtype=dtype)


def _trunk(params, field_cfg, grid_cfg, positions) -> torch.Tensor:
    """The twobranch trunk's raw output [..., 1 + GEO_FEATURES]."""
    return _mlp(params, "trunk", encode_positions(params, field_cfg, grid_cfg, positions),
                rounding_dtype(field_cfg))


# Samples per slab of a field evaluation that records no gradients: an
# eval chunk of the intervals renderer is 32768 rays x 768 samples, whose
# activations at full width would not fit the card in one piece.
EVAL_SLAB = 1 << 21


def apply_field(params: Dict[str, torch.Tensor], field_cfg, grid_cfg, positions: torch.Tensor,
                viewdirs_tp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The field of `params` (flat names, as a checkpoint or
    `NeRFField.params()` gives them) at positions [..., 3] seen along
    (theta, phi) [..., 2] (broadcast against the positions) -> (rgb [...,
    3], sigma [...]): the reference's `NeRFField.apply(params, ...)` of the
    architecture `field_arch` picks, which the unfused renderers call per
    sample.  Where no gradient is recorded, more than EVAL_SLAB samples are
    evaluated slab by slab."""
    n = positions.numel() // 3
    if n > EVAL_SLAB and not torch.is_grad_enabled():
        batch = positions.shape[:-1]
        pos = positions.reshape(n, 3)
        view = viewdirs_tp.expand(*batch, 2).reshape(n, 2)
        parts = [apply_field(params, field_cfg, grid_cfg, pos[i:i + EVAL_SLAB],
                             view[i:i + EVAL_SLAB]) for i in range(0, n, EVAL_SLAB)]
        return (torch.cat([p[0] for p in parts]).reshape(*batch, 3),
                torch.cat([p[1] for p in parts]).reshape(batch))
    dtype = rounding_dtype(field_cfg)
    view_enc = encode_view(field_cfg, viewdirs_tp)
    if field_arch(field_cfg) == "twobranch":
        out = _trunk(params, field_cfg, grid_cfg, positions)
        geo = out[..., 1:]
        h = torch.cat([geo, view_enc.expand(*geo.shape[:-1], view_enc.shape[-1])], dim=-1)
        return torch.sigmoid(_mlp(params, "color", h, dtype)), density_activation(out[..., 0])
    pos_enc = encode_positions(params, field_cfg, grid_cfg, positions)
    h = torch.cat([pos_enc, view_enc.expand(*pos_enc.shape[:-1], view_enc.shape[-1])], dim=-1)
    out = _mlp(params, "trunk", h, dtype)
    return torch.sigmoid(out[..., :3]), density_activation(out[..., 3])


class NeRFField(nn.Module):
    """The field's parameters and its two queries.  fused5d: one trunk on
    enc(x) ++ enc(view) -> (rgb, sigma), parameters `trunk.w.<l>` /
    `trunk.b.<l>`.  twobranch: the encoding's table(s) (`hashgrid.tables`
    [L*T, F]; `triplane.planes` [3, R*R, F] and `triplane.lines` [3, R, F];
    `cp.lines` [3, R, F]), the trunk (`mlp_shape`, 1 + GEO_FEATURES
    outputs) and the colour head `color.*` (two hidden layers of the
    trunk's width, 3 outputs).  `load_state_dict` takes the flat dict of
    `checkpoint.params_from_jax`."""

    def __init__(self, field_cfg, grid_cfg, generator: torch.Generator):
        super().__init__()
        self.config = field_cfg
        self.grid = grid_cfg
        self.arch = field_arch(field_cfg)
        width, layers = mlp_shape(field_cfg)
        if self.arch == "fused5d":
            self.trunk = MLP(pos_enc_dim(field_cfg) + view_enc_dim(field_cfg), width, layers, 4,
                             generator)
            return
        enc = field_cfg.encoding
        if enc == "hashgrid":
            tables = {"tables": init_hashgrid(field_cfg, generator)}
        elif enc == "triplane":
            planes, lines = init_triplane(field_cfg, generator)
            tables = {"planes": planes, "lines": lines}
        else:
            tables = {"lines": init_cp(field_cfg, generator)}
        self.add_module(enc, nn.ParameterDict({k: nn.Parameter(v) for k, v in tables.items()}))
        self.trunk = MLP(pos_enc_dim(field_cfg), width, layers, 1 + GEO_FEATURES, generator)
        self.color = MLP(GEO_FEATURES + view_enc_dim(field_cfg), width, 2, 3, generator)

    def params(self) -> Dict[str, nn.Parameter]:
        """Flat name -> parameter: what the renderers take."""
        return dict(self.named_parameters())

    def forward(self, positions: torch.Tensor, viewdirs_tp: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions [..., 3], (theta, phi) [..., 2] -> (rgb [..., 3], sigma
        [...]) with the module's own parameters."""
        return apply_field(self.params(), self.config, self.grid, positions, viewdirs_tp)

    def density(self, positions: torch.Tensor, params=None) -> torch.Tensor:
        """Density-only query for the occupancy refresh
        (`nerf_field.py:262`) with the module's parameters, or `params`
        (the training state's, which may add the BARF window's
        `freq_alpha`): twobranch runs the trunk alone; fused5d needs a view
        direction and probes with the fixed (0, 0)."""
        params = self.params() if params is None else params
        if self.arch == "twobranch":
            return density_activation(_trunk(params, self.config, self.grid, positions)[..., 0])
        probe = torch.zeros((*positions.shape[:-1], 2), dtype=torch.float32,
                            device=positions.device)
        return apply_field(params, self.config, self.grid, positions, probe)[1]
