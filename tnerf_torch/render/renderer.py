"""Whole-image rendering in chunks (counterpart of
`tnerf/render/renderer.py:render_image`)."""

from __future__ import annotations

import torch

from tnerf_torch.cameras import Rays
from tnerf_torch.render.composite import RenderResult


@torch.no_grad()
def render_image(renderer, params, rays: Rays, chunk_size: int = 65536,
                 occupancy=None) -> RenderResult:
    """Render an [H, W] ray grid in chunks of at most chunk_size rays.

    Rays interleave across chunks as in the reference (ray j * n_chunks + i
    goes to chunk i), so every chunk sees about the image's overall
    object fraction; each ray's result does not depend on its chunk."""
    h, w = rays.origins.shape[:2]
    n = h * w
    flat = Rays(*(a.reshape(n, a.shape[-1]) for a in rays))
    n_chunks = max(1, -(-n // chunk_size))
    outs = [renderer(params, Rays(*(a[i::n_chunks] for a in flat)), occupancy)
            for i in range(n_chunks)]
    fields = []
    for k in range(len(RenderResult._fields)):
        first = outs[0][k]
        full = torch.empty((n, *first.shape[1:]), dtype=first.dtype, device=first.device)
        for i, res in enumerate(outs):
            full[i::n_chunks] = res[k]
        fields.append(full.reshape(h, w, *first.shape[1:]))
    return RenderResult(*fields)
