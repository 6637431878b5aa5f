"""Occupancy-grid renderers outside the fused kernels (counterpart of
`tnerf/render/grid_renderer.py`).

Two strategies, each sampling -> field (`fields/nerf_field.apply_field`,
its matrix products `torch.matmul`) -> `composite`:

- "intervals": `traverse_grid` (kernel B5 on the card) -> per-interval
  sampling -> field -> composite;
- "march": fixed-count marching over each ray's span of the grid box, the
  span tightened to the occupied range, empty samples masked by the
  occupancy, placement uniform or through the inverse CDF of per-bin
  occupancy / density weights; at eval the tightening and the mask come
  from kernel B4 (`tighten_sample_mask`), rays without an occupied sample
  can be compacted away (render.ray_compact), and the field can run on the
  occupied samples only (render.compact).
"""

from __future__ import annotations

from typing import Optional

import torch

from tnerf_torch.cameras import Rays
from tnerf_torch.fields.nerf_field import apply_field
from tnerf_torch.grid.tighten import tighten_sample_mask
from tnerf_torch.grid.traversal import (
    density_lookup,
    make_coarse_density,
    make_coarse_occupancy,
    march_samples_t,
    occupancy_lookup,
    ray_aabb,
    reciprocal,
    tightened_range,
    traverse_grid,
)
from tnerf_torch.render.composite import RenderResult, composite
from tnerf_torch import sampling
from tnerf_torch.render.fused_common import compact_rows, scatter_back
from tnerf_torch.sampling import cdf_ray_samples, interval_samples, sample_positions

CDF_PLACEMENTS = ("occupancy_cdf", "density_cdf")


def _without_samples(rgb, acc, depth) -> RenderResult:
    """What the compacted paths return: no per-sample arrays, distortion 0."""
    empty = torch.zeros((acc.shape[0], 0), dtype=torch.float32, device=acc.device)
    return RenderResult(rgb, acc, depth, empty, empty, torch.zeros_like(acc))


def compacted_shade(params, field_cfg, grid_cfg, positions, viewdirs, t, deltas, mask,
                    capacity: int, white_background: bool, field_fn=None) -> RenderResult:
    """Field evaluation on the kept samples only, then compositing
    (`tnerf/render/grid_renderer.py:64`).

    positions [B, S, 3], viewdirs [B, 2], t / deltas [B, S], mask [B, S]
    bool.  The kept samples are ranked in ray order by a cumulative sum;
    the first `capacity` of them are gathered into a static buffer, which
    is all the field sees; later ones are dropped, and a ray all of whose
    samples were masked or dropped composites to the background.  Nothing
    waits for the device to learn how many were kept: slots beyond the kept
    count hold the masked samples, in order, as stand-ins whose density is
    set to 0.  field_fn: the shade stage in place of `apply_field` (see
    `make_grid_renderer`).

    The field's outputs go back to their [B, S] places (zeros elsewhere)
    and `composite` runs there, so each ray's transmittance is its own
    cumulative sum, as precise as the uncompacted path.  (The reference
    sorts and scans segments in the compacted order because scatters and
    gathers are dear on its machine; the result is the same up to the order
    of a ray's sum.)  Returns no per-sample arrays and distortion 0, as the
    reference does."""
    B, S = mask.shape
    N = B * S
    capacity = min(capacity, N)
    dev = mask.device
    flat_mask = mask.reshape(N)
    rank = torch.cumsum(flat_mask, dim=0) - 1
    total = rank[-1] + 1                            # kept samples, on the device
    kept = flat_mask & (rank < capacity)
    # Slots past the kept ones take the masked samples in order, as the
    # reference's stable sort puts them (distinct rows: a table lookup's
    # backward is slow where one row takes many cotangents).
    standin = total + torch.cumsum(~flat_mask, dim=0) - 1
    fill = torch.where(flat_mask, rank, standin).clamp_max(capacity)  # `capacity`: sacrificial
    src = torch.zeros((capacity + 1,), dtype=torch.int64, device=dev)
    src.index_put_((fill,), torch.arange(N, device=dev))
    src = src[:capacity]                            # [K] source sample of each buffer slot
    slot = torch.where(kept, rank, capacity)        # [N] each kept sample's slot
    valid = torch.arange(capacity, device=dev) < total

    field_fn = field_fn or (lambda p, x, v: apply_field(p, field_cfg, grid_cfg, x, v))
    rgb_c, sigma_c = field_fn(params, positions.reshape(N, 3)[src], viewdirs[src // S])
    sigma_c = torch.where(valid, sigma_c.float(), torch.zeros_like(sigma_c, dtype=torch.float32))
    # back to [B, S]: a dropped sample reads the zero row appended at
    # `capacity`, which takes no gradient (an embedding's padding row: an
    # indexing backward would sum the cotangents of every dropped sample
    # into that one row, one after another)
    back = lambda a: torch.nn.functional.embedding(
        slot, torch.cat([a, torch.zeros_like(a[:1])]), padding_idx=capacity)
    res = composite(back(rgb_c.float()).reshape(B, S, 3), back(sigma_c[:, None]).reshape(B, S),
                    deltas, t_mid=t, mask=kept.reshape(B, S), white_background=white_background)
    return _without_samples(res.rgb, res.acc, res.depth)


def split_occupancy_payload(occupancy, grid_cfg):
    """(bitfield [res]^3 bool, density [res]^3 f32 or None) of a renderer's
    `occupancy=` payload: a bool payload is the bitfield; a float payload
    is the occupancy grid's density EMA, whose bitfield is ema >
    grid.density_threshold (the rule `update_occupancy` applies), and whose
    values feed density-weighted CDF placement."""
    if occupancy is None:
        return None, None
    r = grid_cfg.resolution
    arr = occupancy.reshape(r, r, r)
    if arr.dtype == torch.bool:
        return arr, None
    dens3 = arr.float()
    return dens3 > grid_cfg.density_threshold, dens3


def cdf_bin_weights(origins, directions, t0, t1, occ_m, dens_m, grid_cfg, sampler_cfg):
    """(weights, support) [B, P] of CDF placement's bins, probed at the bin
    midpoints of [t0, t1] (`tnerf/render/grid_renderer.py:242`).

    occupancy_cdf: weight = support = the bin's bit on the pooled bitfield
    occ_m.  density_cdf: weight = T_b (1 - exp(-sigma_b dt_b)) with sigma
    from the pooled density dens_m and T_b the transmittance of the bins
    before, so bins behind an opaque surface get almost no samples; the
    support stays sigma_b > threshold, and the weights are rescaled so that
    support bins average 1 (sampler.cdf_floor then means the same under
    both placements)."""
    P = sampler_cfg.cdf_bins
    span = t1 - t0
    rcp = reciprocal(P, t0.device)
    frac = (torch.arange(P, dtype=torch.float32, device=t0.device) + 0.5) * rcp
    tb = t0[..., None] + frac * span[..., None]
    pts = sample_positions(origins, directions, tb)
    pos_span = (span > 0)[..., None]
    if sampler_cfg.placement == "density_cdf":
        if dens_m is None:
            raise ValueError(
                "sampler.placement='density_cdf' needs the density-EMA "
                "payload (pass occupancy=occ.density_ema, see "
                "occupancy.renderer_payload), got a bool bitfield"
            )
        sigma = density_lookup(pts, dens_m, grid_cfg)
        support = (sigma > grid_cfg.density_threshold) & pos_span
        tau = sigma * (torch.clamp_min(span, 0.0)[..., None] * rcp)
        trans = torch.exp(-(torch.cumsum(tau, dim=-1) - tau))
        w = torch.where(support, trans * (1.0 - torch.exp(-tau)), torch.zeros_like(tau))
        k = support.sum(dim=-1).to(torch.float32)
        w = w * (k / torch.clamp_min(w.sum(dim=-1), 1e-12))[..., None]
    else:
        support = occupancy_lookup(pts, occ_m, grid_cfg) & pos_span
        w = support.to(torch.float32)
    return w, support


def _pool(grid3, res: int, to_res: int, pool_fn=make_coarse_occupancy):
    return grid3 if to_res == res else pool_fn(grid3, res // to_res)


def _march_span(rays: Rays, grid_cfg, sampler_cfg):
    """(o, d, viewdirs, t_enter, t_exit) of a march: the box span from
    sampler.near on, empty (t_exit = t_enter) for a ray that misses."""
    o, d, tp = (a.float().contiguous() for a in rays)
    t_enter, t_exit = ray_aabb(o, d, grid_cfg.aabb_min, grid_cfg.aabb_max)
    t_enter = torch.clamp_min(t_enter, float(sampler_cfg.near))
    return o, d, tp, t_enter.contiguous(), torch.maximum(t_exit, t_enter).contiguous()


def cdf_occupied_sample_fraction(rays: Rays, occupancy, grid_cfg, sampler_cfg) -> torch.Tensor:
    """The expected share of CDF-placed samples that land in occupied bins:
    sum_b pmf_b support_b, averaged over the rays
    (`tnerf/render/grid_renderer.py:304`).  The dense-to-compact switch of
    training plans its capacity from it, because under CDF placement the
    grid's occupied-cell share says nothing about the samples.  The weights
    are `cdf_bin_weights`, the ones the renderer places with.  occupancy:
    the renderer payload.  Returns a scalar tensor."""
    res = grid_cfg.resolution
    occ3, dens3 = split_occupancy_payload(occupancy, grid_cfg)
    t_res = min(sampler_cfg.tighten_res or res, res)
    m_res = min(sampler_cfg.occupancy_mask_res or res, res)
    o, d, _, te, tx = _march_span(Rays(*(a.reshape(-1, a.shape[-1]) for a in rays)), grid_cfg,
                                  sampler_cfg)
    if sampler_cfg.tighten:
        te, tx = tightened_range(o, d, te, tx, _pool(occ3, res, t_res), grid_cfg,
                                 probes=sampler_cfg.tighten_probes)
    dens_m = None
    if dens3 is not None and sampler_cfg.placement == "density_cdf":
        dens_m = _pool(dens3, res, m_res, make_coarse_density)
    w, support = cdf_bin_weights(o, d, te, tx, _pool(occ3, res, m_res), dens_m, grid_cfg,
                                 sampler_cfg)
    wf = w + sampler_cfg.cdf_floor
    pmf = wf / torch.sum(wf, dim=-1, keepdim=True)
    return torch.sum(pmf * support, dim=-1).mean()


def make_grid_renderer(field_cfg, grid_cfg, sampler_cfg, render_cfg, strategy: str = "march",
                       compact: bool = True, compact_fraction: Optional[float] = None,
                       compact_capacity: Optional[int] = None, max_hits: Optional[int] = None,
                       field_fn=None):
    """render(params, rays, occupancy=None, generator=None) -> RenderResult
    (`tnerf/render/grid_renderer.py:359`).

    field_fn: the shade stage, (params, positions [..., 3], (theta, phi)
    [..., 2] broadcast against them) -> (rgb [..., 3], sigma [...]); None
    is the field of field_cfg (`apply_field`).  The baked renderer passes
    its table lookup here (`render/baked.make_baked_renderer`), as the
    reference passes a field with `.apply`.

    rays: flat Rays on the params' device.  occupancy: the renderer payload
    (`grid/occupancy.renderer_payload`): the [res]^3 bool bitfield, under
    density_cdf placement the f32 density EMA, or None (dense: every crossed
    cell / every sample of the span counts).  generator: a torch.Generator
    on the rays' device, the counterpart of the reference's key: with it
    the samples are jittered (training); without it they sit at midpoints
    and the march takes its span and mask from kernel B4 (eval)."""
    if strategy not in ("march", "intervals"):
        raise ValueError(f"unknown grid render strategy {strategy!r}")
    if sampler_cfg.placement not in ("uniform",) + CDF_PLACEMENTS:
        # a typo must not render the uniform quadrature without a word
        raise ValueError(
            f"sampler.placement must be 'uniform', 'occupancy_cdf' or "
            f"'density_cdf', got {sampler_cfg.placement!r}"
        )
    if strategy == "intervals" and sampler_cfg.placement != "uniform":
        raise ValueError(
            f"sampler.placement={sampler_cfg.placement!r} applies to the "
            "grid_march pipeline only; grid_intervals samples per cell "
            "interval (set sampler.placement=uniform)"
        )
    S = sampler_cfg.samples_per_ray
    res = grid_cfg.resolution
    t_res = min(sampler_cfg.tighten_res or res, res)
    m_res = min(sampler_cfg.occupancy_mask_res or res, res)
    field_fn = field_fn or (lambda p, x, v: apply_field(p, field_cfg, grid_cfg, x, v))

    def render(params, rays: Rays, occupancy=None, generator=None) -> RenderResult:
        occ3, dens3 = split_occupancy_payload(occupancy, grid_cfg)
        if sampler_cfg.placement == "density_cdf" and occ3 is not None and dens3 is None:
            raise ValueError(
                "sampler.placement='density_cdf' renderer was given a bool "
                "bitfield; pass the density EMA payload "
                "(occupancy.renderer_payload)"
            )

        def shade(o_, d_, tp_, t, deltas, smask):
            """Field evaluation + compositing on explicit rays and samples."""
            pts = sample_positions(o_, d_, t)
            if strategy == "march" and compact and occ3 is not None:
                frac = compact_fraction if compact_fraction is not None \
                    else render_cfg.compact_fraction
                cap = compact_capacity or max(1, int(pts.shape[0] * pts.shape[1] * frac))
                return compacted_shade(params, field_cfg, grid_cfg, pts, tp_, t, deltas, smask,
                                       cap, render_cfg.white_background, field_fn)
            rgb, sigma = field_fn(params, pts, tp_[..., None, :])
            return composite(rgb, sigma, deltas, t_mid=t, mask=smask,
                             white_background=render_cfg.white_background)

        if strategy == "intervals":
            o, d, tp = (a.float() for a in rays)
            iv = traverse_grid(o, d, grid_cfg, occupancy=occ3, max_hits=max_hits)
            mode = sampler_cfg.mode if generator is not None else "regular"
            n_iv = sampler_cfg.samples_per_interval
            u = None if mode == "regular" else sampling.draw_uniform(
                generator, (*iv.t_starts.shape, n_iv), o.device)
            samples = interval_samples(iv.t_starts, iv.t_ends, iv.mask, n_iv, mode=mode, u=u)
            return shade(o, d, tp, samples.t, samples.deltas, samples.mask)

        o, d, tp, t_enter, t_exit = _march_span(rays, grid_cfg, sampler_cfg)
        dev = o.device
        use_cdf = sampler_cfg.placement in CDF_PLACEMENTS and occ3 is not None
        dens_m = None
        if dens3 is not None and sampler_cfg.placement == "density_cdf":
            dens_m = _pool(dens3, res, m_res, make_coarse_density)

        def cdf_place(o_, d_, t0_, t1_, gen_=None, pre=None):
            """pre = (weights, support) [B, P] where kernel B4's bin mask
            stands in for the bin probes."""
            wb, support = pre if pre is not None else cdf_bin_weights(
                o_, d_, t0_, t1_, _pool(occ3, res, m_res), dens_m, grid_cfg, sampler_cfg)
            jitter = None if gen_ is None else sampling.draw_uniform(gen_, (*t0_.shape, S), dev)
            s = cdf_ray_samples(t0_, t1_, S, wb, floor=sampler_cfg.cdf_floor, jitter=jitter,
                                bin_support=support)
            return s.t, s.deltas, s.mask  # the mask is each sample's own bin's support

        # Kernel B4 (tighten + midpoint mask on one pooled bitfield of at most
        # 32^3 bits) at eval, where the samples sit at midpoints.
        use_kernel = (occ3 is not None and sampler_cfg.tighten and generator is None
                      and m_res >= t_res and t_res < res and t_res <= 32)
        # occupancy_cdf whose bin probes use the kernel's own pooling: the
        # kernel at n = cdf_bins gives the bin weights and support as well.
        fold_cdf = (use_kernel and use_cdf and m_res == t_res
                    and sampler_cfg.placement == "occupancy_cdf")
        # Under either CDF placement the kernel probes the cdf_bins midpoints
        # and not the S sample midpoints: ray compaction's keep rule (any
        # occupied probe) must cover the positions the placement spreads over.
        kernel_n = sampler_cfg.cdf_bins if (use_kernel and use_cdf) else S

        def kernel(o_, d_, te_, tx_):
            return tighten_sample_mask(o_, d_, te_, tx_, _pool(occ3, res, t_res), kernel_n,
                                       grid_cfg, probes=sampler_cfg.tighten_probes)

        def kernel_samples(o_, d_, te_, tx_):
            """(t, deltas, mask) of rays whose span and mask come from B4."""
            t0_, t1_, mask_k = kernel(o_, d_, te_, tx_)
            if fold_cdf:
                return cdf_place(o_, d_, t0_, t1_, pre=(mask_k.float(), mask_k))
            if use_cdf:
                return cdf_place(o_, d_, t0_, t1_)
            t_, deltas_ = march_samples_t(t0_, t1_, S)
            if m_res != t_res:
                # a mask resolution finer than the kernel's bitfield: intersect
                # with the lookup there (the pooled mask is a superset)
                mask_k = mask_k & occupancy_lookup(sample_positions(o_, d_, t_),
                                                   _pool(occ3, res, m_res), grid_cfg)
            return t_, deltas_, mask_k

        if use_kernel and render_cfg.ray_compact:
            # Ray compaction: a first pass finds the rays with any occupied
            # probe; their rows are packed into a static buffer of cap rays;
            # a second pass of the kernel gives the kept rays' span and mask;
            # dropped rays, and kept rays beyond cap, come back as background.
            B = o.shape[0]
            cap = max(1, int(B * render_cfg.ray_compact_fraction))
            _, _, mask_a = kernel(o, d, t_enter, t_exit)
            buf, widx = compact_rows(mask_a.any(dim=1), torch.cat(
                [o, d, tp, t_enter[:, None], t_exit[:, None]], dim=1), cap)
            o_c, d_c, v_c = (buf[:, a:b].contiguous() for a, b in ((0, 3), (3, 6), (6, 8)))
            res_c = shade(o_c, d_c, v_c, *kernel_samples(o_c, d_c, buf[:, 8].contiguous(),
                                                         buf[:, 9].contiguous()))
            bgv = 1.0 if render_cfg.white_background else 0.0
            bg_row = torch.tensor([[bgv, bgv, bgv, 0.0, 0.0]], dtype=torch.float32, device=dev)
            full = scatter_back(torch.cat([res_c.rgb, res_c.acc[:, None], res_c.depth[:, None]],
                                          dim=1), widx, bg_row)
            return _without_samples(full[:, 0:3], full[:, 3], full[:, 4])
        if use_kernel:
            return shade(o, d, tp, *kernel_samples(o, d, t_enter, t_exit))

        if occ3 is not None and sampler_cfg.tighten:
            t_enter, t_exit = tightened_range(o, d, t_enter, t_exit, _pool(occ3, res, t_res),
                                              grid_cfg, probes=sampler_cfg.tighten_probes)
        if use_cdf:
            t, deltas, smask = cdf_place(o, d, t_enter, t_exit, generator)
        else:
            jitter = None if generator is None \
                else sampling.draw_uniform(generator, (*t_enter.shape, S), dev)
            t, deltas = march_samples_t(t_enter, t_exit, S, jitter=jitter)
            smask = (t_exit > t_enter)[..., None].expand(t.shape)
            if occ3 is not None:
                smask = smask & occupancy_lookup(sample_positions(o, d, t),
                                                 _pool(occ3, res, m_res), grid_cfg)
        return shade(o, d, tp, t, deltas, smask)

    return render
