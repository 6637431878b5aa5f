"""Sample placement along rays (counterpart of the parts of
`tnerf/sampling.py` that the fused renderer uses: `RaySamples`,
`sample_positions`, `cdf_ray_samples`, :129-243).

Outputs are (t, deltas, mask); positions are formed by the caller as
o + t d."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RaySamples(NamedTuple):
    t: torch.Tensor       # [..., S] sample depths along the ray
    deltas: torch.Tensor  # [..., S] quadrature step per sample
    mask: torch.Tensor    # [..., S] bool validity


def sample_positions(origins, directions, t):
    """o + t d: [..., 3], [..., 3], [..., S] -> [..., S, 3]."""
    return origins[..., None, :] + directions[..., None, :] * t[..., :, None]


def cdf_ray_samples(t_enter, t_exit, n_samples: int, bin_weights, floor: float = 0.01,
                    jitter: Optional[torch.Tensor] = None,
                    bin_support: Optional[torch.Tensor] = None) -> RaySamples:
    """Inverse-CDF stratified placement of n_samples samples over each
    ray's [t_enter, t_exit] from per-bin weights
    (`sampler.placement="occupancy_cdf"`).

    Per ray: bin_weights [..., P] >= 0 get `floor` added (every bin keeps
    support, so a ray with no occupied bin does not divide by zero) and
    are normalized to a pmf and a CDF over u in [0, 1].  Sample s sits at
    the stratum centre u_s = (s + 0.5) / S, or at (s + jitter_s) / S with
    `jitter` [..., S] in [0, 1), and maps through the piecewise-linear
    inverse CDF to t_s (monotone in s).  Its quadrature step is the point
    Jacobian of the warp at the sample's own bin, delta_s = (span / P) /
    (pmf_b(s) S), not the distance between stratum edges: a stratum that
    straddles an occupancy boundary would otherwise smear its empty extent
    into an occupied sample's tau = sigma delta.  Samples in empty bins
    get large deltas and a False mask; callers composite masked samples
    out.  With constant weights this is uniform midpoint placement with
    delta = span / S.

    mask = (span > 0) & (the sample's bin is in the support): bins with a
    non-zero weight before the floor, or `bin_support` [..., P] bool.

    The reference picks each sample's bin values with one-hot masked sums,
    a formulation for a machine without a cheap gather; here the bin index
    is the number of interior CDF edges below u (`torch.searchsorted`) and
    the picks are gathers.  Selecting one f32 is bit-equal to the masked
    sum."""
    if not floor > 0.0:
        raise ValueError(
            f"cdf floor must be > 0 (got {floor}): a ray whose probes are "
            "all empty would otherwise divide 0/0 into NaN positions"
        )
    dev = t_enter.device
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)
    P = bin_weights.shape[-1]
    n_bins, n = f32(P), f32(n_samples)
    span = torch.clamp_min(t_exit - t_enter, 0.0)
    w = bin_weights.to(torch.float32) + f32(floor)
    csum = torch.cumsum(w, dim=-1)
    total = csum[..., -1:]
    pmf = w / total                                                   # [..., P]
    cdf = torch.cat([torch.zeros_like(total), csum / total], dim=-1)  # [..., P + 1]

    s = torch.arange(n_samples, dtype=torch.float32, device=dev)
    if jitter is not None:
        u_pts = (s + jitter) / n
    else:
        u_pts = ((s + 0.5) / n).expand(*span.shape, n_samples)

    # bin index of each query: #{p : cdf[p + 1] < u}, in [0, P - 1]
    idx = torch.searchsorted(cdf[..., 1:-1].contiguous(), u_pts.contiguous(), right=False)
    pick = lambda v: torch.gather(v, -1, idx)
    c0 = pick(cdf[..., :-1])
    pmf_s = pick(pmf)
    frac = (u_pts - c0) / torch.clamp_min(pmf_s, 1e-12)
    x = (idx.to(torch.float32) + frac) / n_bins
    t = t_enter[..., None] + x * span[..., None]
    deltas = (span[..., None] / n_bins) / (pmf_s * n)
    support = bin_weights.to(torch.float32) > 0 if bin_support is None else bin_support
    mask = (span > 0)[..., None] & pick(support)
    return RaySamples(t=t, deltas=deltas, mask=mask)
