"""The grid-free renderer and whole-image rendering in chunks (counterpart
of `tnerf/render/renderer.py`: `make_uniform_renderer`, `render_image`)."""

from __future__ import annotations

from typing import Optional

import torch

from tnerf_torch.cameras import Rays
from tnerf_torch.fields.nerf_field import apply_field
from tnerf_torch.render.composite import RenderResult, composite
from tnerf_torch.sampling import sample_positions, uniform_ray_samples


def make_uniform_renderer(field_cfg, grid_cfg, sampler_cfg, render_cfg,
                          mode: Optional[str] = None):
    """render(params, rays, occupancy=None, generator=None) -> RenderResult
    with a fixed count of samples over [sampler.near, sampler.far] and no
    occupancy grid (`tnerf/render/renderer.py:32`; `occupancy` is taken and
    ignored).  With a generator the samples follow `mode` (default
    sampler.mode), without one they sit at the strata's midpoints."""
    mode = mode or sampler_cfg.mode

    def render(params, rays: Rays, occupancy=None, generator=None) -> RenderResult:
        o, d, tp = (a.float() for a in rays)
        samples = uniform_ray_samples(
            sampler_cfg.near, sampler_cfg.far, sampler_cfg.samples_per_ray, o.shape[:-1],
            mode=mode if generator is not None else "regular", generator=generator,
            device=o.device)
        rgb, sigma = apply_field(params, field_cfg, grid_cfg,
                                 sample_positions(o, d, samples.t), tp[..., None, :])
        return composite(rgb, sigma, samples.deltas, t_mid=samples.t, mask=samples.mask,
                         white_background=render_cfg.white_background)

    return render


@torch.no_grad()
def render_image(renderer, params, rays: Rays, chunk_size: int = 65536,
                 occupancy=None, mesh=None) -> RenderResult:
    """Render an [H, W] ray grid in chunks of chunk_size rays
    (`tnerf/render/renderer.py:101`).

    As in the reference, the rays are padded with zero rays to a whole
    number of chunks and interleave across them (ray j * n_chunks + i goes
    to chunk i), so every chunk sees about the image's overall object
    fraction, and each chunk's padding comes after its real rays.  The
    renderers size their compaction buffers from the rays they are given,
    so this is what makes a view smaller than a chunk get the reference's
    capacity (render.ray_compact_fraction / compact_fraction of a whole
    chunk) with its real rays first; each ray's result does not depend on
    its chunk.  With `mesh` (`parallel.mesh.make_mesh`), each chunk's rays
    are split over its data axis and the results gathered
    (`parallel.mesh.dp_render_sharded`): every rank of the mesh calls this
    with the same rays and gets the whole image."""
    if mesh is not None:
        from tnerf_torch.parallel.mesh import dp_render_sharded

        renderer = dp_render_sharded(renderer, mesh)
    h, w = rays.origins.shape[:2]
    n = h * w
    n_chunks = max(1, -(-n // chunk_size))
    pad = n_chunks * chunk_size - n
    flat = Rays(*(torch.cat([a.reshape(n, a.shape[-1]), a.new_zeros((pad, a.shape[-1]))])
                  for a in rays))
    outs = [renderer(params, Rays(*(a[i::n_chunks] for a in flat)), occupancy)
            for i in range(n_chunks)]
    fields = []
    for k in range(len(RenderResult._fields)):
        first = outs[0][k]
        full = torch.empty((n + pad, *first.shape[1:]), dtype=first.dtype, device=first.device)
        for i, res in enumerate(outs):
            full[i::n_chunks] = res[k]
        fields.append(full[:n].reshape(h, w, *first.shape[1:]))
    return RenderResult(*fields)
