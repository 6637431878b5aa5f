"""Sample placement along rays (counterpart of `tnerf/sampling.py`):
fixed-count sampling over [near, far] (`uniform_ray_samples`), per
traversal interval (`interval_samples`) and through the inverse CDF of
per-bin weights (`cdf_ray_samples`).

Outputs are (t, deltas, mask); positions are formed by the caller as
o + t d.  Randomness comes from an explicit `torch.Generator` on the
tensors' device; each function also takes the uniforms as a tensor `u`, so
that a test can feed the numbers another generator drew.

Where the reference divides by a sample or bin count, its XLA multiplies
by the count's float32 reciprocal, and so does the port
(`grid/traversal.py:reciprocal`)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tnerf_torch.grid.traversal import reciprocal


class RaySamples(NamedTuple):
    t: torch.Tensor       # [..., S] sample depths along the ray
    deltas: torch.Tensor  # [..., S] quadrature step per sample
    mask: torch.Tensor    # [..., S] bool validity


MODES = ("regular", "stratified", "uniform")


def draw_uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    """[0, 1) float32 draws from `generator` (on `device`): the one source
    of randomness of the samplers and the renderers."""
    return torch.rand(shape, generator=generator, dtype=torch.float32, device=device)


def _uniforms(mode: str, shape, device, generator, u):
    """The [0, 1) draws of a non-regular mode: `u` if given, else drawn
    from `generator`."""
    if mode not in MODES:
        raise ValueError(f"sampling mode must be one of {MODES}, got {mode!r}")
    if mode == "regular":
        return None
    if u is not None:
        return u
    if generator is None:
        raise ValueError(f"{mode} sampling requires a generator")
    return draw_uniform(generator, shape, device)


def uniform_ray_samples(near: float, far: float, n_samples: int, batch_shape: tuple,
                        mode: str = "regular", generator: Optional[torch.Generator] = None,
                        u: Optional[torch.Tensor] = None, device="cpu") -> RaySamples:
    """Fixed-count samples over the global [near, far] range.

    regular:    midpoints of a uniform partition.
    stratified: one uniform draw per stratum.
    uniform:    iid uniform over [near, far], sorted along the ray; the
                steps run between consecutive samples, the last one to far."""
    shape = (*batch_shape, n_samples)
    u = _uniforms(mode, shape, device, generator, u)
    edges = torch.linspace(near, far, n_samples + 1, dtype=torch.float32, device=device)
    width = (far - near) / n_samples
    if mode == "regular":
        t = (0.5 * (edges[:-1] + edges[1:])).expand(shape)
    elif mode == "stratified":
        t = edges[:-1] + u * width
    else:
        t = torch.sort(near + u * (far - near), dim=-1).values
    if mode == "uniform":
        last = torch.full((*batch_shape, 1), far, dtype=torch.float32, device=device)
        deltas = torch.diff(t, dim=-1, append=last)
    else:
        deltas = torch.full(shape, width, dtype=torch.float32, device=device)
    return RaySamples(t=t, deltas=deltas, mask=torch.ones(shape, dtype=torch.bool, device=device))


def interval_samples(t_starts, t_ends, hit_mask, samples_per_interval: int,
                     mode: str = "regular", generator: Optional[torch.Generator] = None,
                     u: Optional[torch.Tensor] = None) -> RaySamples:
    """S samples inside every traversal interval [t0, t1) ([..., H] each,
    hit_mask [..., H] bool marking the real ones), flattened to a sample
    axis of H * S: regular (interval midpoint rule), stratified (u [..., H,
    S] within the strata) or uniform (sorted draws).  Every sample of an
    interval steps by (t1 - t0) / S: intervals integrate independently, and
    the gaps between them are empty space that contributes nothing."""
    S = samples_per_interval
    *batch, H = t_starts.shape
    dev = t_starts.device
    u = _uniforms(mode, (*batch, H, S), dev, generator, u)
    rcp = reciprocal(S, dev)
    length = (t_ends - t_starts) * rcp
    steps = torch.arange(S, dtype=torch.float32, device=dev)
    if mode == "regular":
        frac = ((steps + 0.5) * rcp).expand(*batch, H, S)
    elif mode == "stratified":
        frac = (steps + u) * rcp
    else:
        frac = torch.sort(u, dim=-1).values
    t = t_starts[..., None] + frac * (t_ends - t_starts)[..., None]
    flat = lambda a: a.expand(t.shape).reshape(*batch, H * S)
    return RaySamples(t=flat(t), deltas=flat(length[..., None]), mask=flat(hit_mask[..., None]))


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
    n, rcp_n, rcp_bins = f32(n_samples), reciprocal(n_samples, dev), reciprocal(P, dev)
    span = torch.clamp_min(t_exit - t_enter, 0.0)
    w = bin_weights.to(torch.float32) + f32(floor)
    csum = torch.cumsum(w, dim=-1)
    total = csum[..., -1:]
    pmf = w / total                                                   # [..., P]
    cdf = torch.cat([torch.zeros_like(total), csum / total], dim=-1)  # [..., P + 1]

    s = torch.arange(n_samples, dtype=torch.float32, device=dev)
    if jitter is not None:
        u_pts = (s + jitter) * rcp_n
    else:
        u_pts = ((s + 0.5) * rcp_n).expand(*span.shape, n_samples)

    # bin index of each query: #{p : cdf[p + 1] < u}, in [0, P - 1]
    idx = torch.searchsorted(cdf[..., 1:-1].contiguous(), u_pts.contiguous(), right=False)
    pick = lambda v: torch.gather(v, -1, idx)
    c0 = pick(cdf[..., :-1])
    pmf_s = pick(pmf)
    frac = (u_pts - c0) / torch.clamp_min(pmf_s, 1e-12)
    # the reference's t_enter + (idx + frac) / P * span: its XLA multiplies by
    # RN(1 / P) and moves that constant onto span
    bin_len = span[..., None] * rcp_bins
    t = t_enter[..., None] + (idx.to(torch.float32) + frac) * bin_len
    deltas = bin_len / (pmf_s * n)
    support = bin_weights.to(torch.float32) > 0 if bin_support is None else bin_support
    mask = (span > 0)[..., None] & pick(support)
    return RaySamples(t=t, deltas=deltas, mask=mask)
