"""Sample-parallel (SP) rendering: the samples-per-ray axis of the
grid_intervals pipeline sharded over the mesh's "sample" axis
(counterpart of `tnerf/parallel/sample_parallel.py`).

The emission-absorption integral is a prefix product in transmittance,
sequential along the samples, but it segments exactly: with the sample
axis split into contiguous per-rank slices,

    T(i on rank r) = T_local(i) * exp(-sum_{r' < r} tau_total_r')

so each rank composites its slice with the same cumsum quadrature as
`render/composite.py`, shifted by one per-ray optical-depth prefix, and
the per-ray outputs combine with a sum.  What crosses ranks is an
all_gather of the [B] per-slice optical depths and the sum of the [B, 5]
per-ray partials, never the [B, S] field arrays.  The gradient flows
through both: the sum's backward is the identity (every rank then holds
the same pixels and computes the same loss), the gather's the sum of the
ranks' cotangents (each rank reads the gathered depths through its own
prefix).

Composes with DP (rays over "data") and with TP (`model_axis`: the hash
encode of each rank's samples runs level-sharded, `table_parallel`).
"""

from __future__ import annotations

from typing import Optional

import torch

from tnerf_torch.cameras import Rays
from tnerf_torch.fields.nerf_field import apply_field
from tnerf_torch.grid.traversal import traverse_grid
from tnerf_torch.parallel import comm
from tnerf_torch.render.composite import RenderResult
from tnerf_torch.render.grid_renderer import split_occupancy_payload
from tnerf_torch import sampling
from tnerf_torch.sampling import interval_samples, sample_positions


def sp_composite_local(rgb, sigma, deltas, t_mid, mask, group,
                       white_background: bool = False) -> RenderResult:
    """The segmented composite of this rank's contiguous [B, S/n] slice of
    every ray's samples (rgb [B, S/n, 3], sigma / deltas / t_mid / mask [B,
    S/n]) over `group`, the ranks holding the ray's other slices (None: a
    sample axis of one rank, the whole ray here): per-ray
    outputs summed over the group (every rank holds them alike), per-sample
    weights and transmittance of the local slice; distortion 0 (its
    weight pairs span the slices, which train_loop refuses)."""
    tau = sigma.float() * deltas.float()
    if mask is not None:
        tau = torch.where(mask, tau, torch.zeros_like(tau))
    tau_cum = torch.cumsum(tau, dim=-1) - tau                            # exclusive, local
    if group is not None:
        tau_total = torch.sum(tau, dim=-1)                               # [B]
        gathered = comm.all_gather_varying(tau_total[None], group, dim=0)  # [n, B]
        prefix = torch.sum(gathered[:comm.group_rank(group)], dim=0)     # [B]
        tau_cum = tau_cum + prefix[..., None]
    transmittance = torch.exp(-tau_cum)
    weights = transmittance * (1.0 - torch.exp(-tau))
    rgb_p = torch.sum(weights[..., None] * rgb.float(), dim=-2)
    acc_p = torch.sum(weights, dim=-1)
    depth_p = torch.zeros_like(acc_p) if t_mid is None \
        else torch.sum(weights * t_mid.float(), dim=-1)
    out = torch.cat([rgb_p, acc_p[:, None], depth_p[:, None]], dim=1)
    if group is not None:
        out = comm.psum(out, group)
    out_rgb, acc, depth = out[:, 0:3], out[:, 3], out[:, 4]
    if white_background:
        out_rgb = out_rgb + (1.0 - acc)[..., None]
    return RenderResult(out_rgb, acc, depth, weights, transmittance, torch.zeros_like(acc))


def make_sp_interval_renderer(field_cfg, grid_cfg, sampler_cfg, render_cfg, mesh,
                              sample_axis: str = "sample", max_hits: Optional[int] = None,
                              model_axis: Optional[str] = None):
    """render(params, rays, occupancy=None, generator=None) -> RenderResult
    of the grid_intervals pipeline with the sample axis sharded over
    `sample_axis`: the traversal (kernel B5 on the card) and the interval
    sampling run on this rank's rays (its "data" shard, `mesh.shard_batch`,
    which every rank of its sample group holds alike, drawing the same
    jitter from a generator seeded alike), then the field and the segmented composite on this
    rank's contiguous S/n slice of the samples.  The per-ray outputs are
    those of every sample; the per-sample arrays are the local slice.

    S = max_hits x samples_per_interval must divide by the axis size.
    model_axis composes table parallelism: the hash tables enter as this
    rank's level block and the encode runs sharded (hash grid only)."""
    n_sp = mesh.size(sample_axis)
    H = max_hits if max_hits is not None else grid_cfg.effective_max_hits
    n_iv = sampler_cfg.samples_per_interval
    S_total = H * n_iv
    if S_total % n_sp != 0:
        raise ValueError(
            f"sample axis {S_total} (max_hits {H} x samples_per_interval {n_iv}) must divide "
            f"over {n_sp} '{sample_axis}' devices"
        )
    if model_axis is not None:
        if field_cfg.encoding != "hashgrid":
            raise ValueError(
                "model_axis shards hash-grid level tables; "
                f"field encoding is {field_cfg.encoding!r}"
            )
        if getattr(field_cfg, "table_shard", None) is None:
            from tnerf_torch.parallel.table_parallel import with_table_shard

            field_cfg = with_table_shard(field_cfg, mesh, model_axis)
    group = mesh.group(sample_axis) if n_sp > 1 else None
    S_local = S_total // n_sp
    s0 = mesh.coord(sample_axis) * S_local
    white = render_cfg.white_background

    def render(params, rays: Rays, occupancy=None, generator=None) -> RenderResult:
        o, d, tp = (a.float() for a in rays)
        occ3, _ = split_occupancy_payload(occupancy, grid_cfg)
        iv = traverse_grid(o, d, grid_cfg, occupancy=occ3, max_hits=H)
        mode = sampler_cfg.mode if generator is not None else "regular"
        u = None if mode == "regular" else sampling.draw_uniform(
            generator, (*iv.t_starts.shape, n_iv), o.device)
        samples = interval_samples(iv.t_starts, iv.t_ends, iv.mask, n_iv, mode=mode, u=u)
        sl = slice(s0, s0 + S_local)
        t, deltas, smask = samples.t[:, sl], samples.deltas[:, sl], samples.mask[:, sl]
        rgb, sigma = apply_field(params, field_cfg, grid_cfg, sample_positions(o, d, t),
                                 tp[..., None, :])
        return sp_composite_local(rgb, sigma, deltas, t, smask, group, white_background=white)

    return render
