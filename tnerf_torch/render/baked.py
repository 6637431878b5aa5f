"""Baked-field rendering (counterpart of `tnerf/render/baked.py`).

Baking evaluates the trained field once into a dense vertex grid (RGB and
density), after which rendering is a grid lookup per sample, with no field
math at all (SNeRG / FastNeRF's move).  The lookups are the shade stage of
the production march renderer (`grid_renderer.make_grid_renderer`'s
`field_fn`), so tightening, CDF placement and ray compaction (kernel B4 at
eval) are the march pipeline's own.

Three lookup modes trade gathers against memory:
  nearest         1 gather of 4 channels   (R^3 x 4 values)
  trilinear       8 gathers of 4 channels  (R^3 x 4)
  trilinear_brick 1 gather of 32 channels  (R^3 x 32: each vertex row holds
                  its 2x2x2 corner block, `brick_pack`)

View dependence: the bake queries the field at one direction per vertex
(default the inward radial direction, from which a camera on the standard
orbit sphere sees the point); a view-dependent scene loses its highlights.

The bake is the reference's, so that the two tables can be held equal: the
npz stores neither the sigma space nor the view mode, the occupancy
dilation takes the 6-neighbourhood, and no loader reads a bake back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tnerf_torch.cameras import viewdirs_to_thetaphi
from tnerf_torch.config import GridConfig
from tnerf_torch.grid.mesh import dilate

MODES = ("nearest", "trilinear", "trilinear_brick")


@dataclasses.dataclass(frozen=True)
class BakedField:
    """The baked table as a field: `apply(params, positions, viewdirs)` ->
    (rgb, sigma) by table lookups; `params` is {"table": [R^3, C]}.

    sigma_space "log1p": the table's 4th channel holds log1p(sigma), and a
    lookup returns expm1 after interpolation, which keeps the density
    spikes at surfaces sharp where a linear interpolation of raw sigma
    would smear them across whole cells."""

    bake_res: int
    grid: GridConfig
    mode: str = "trilinear_brick"  # nearest | trilinear | trilinear_brick
    sigma_space: str = "linear"    # linear | log1p (must match the bake)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown bake lookup mode {self.mode!r}: one of {MODES}")

    def _uvw(self, positions: torch.Tensor) -> torch.Tensor:
        """Align-corners vertex coordinates: u in [0, R-1] per axis, the
        division by the box's extent a multiply by its float32 reciprocal,
        as the reference's jitted lookup computes it."""
        dev = positions.device
        lo = np.asarray(self.grid.aabb_min, np.float32)
        rcp = np.float32(1.0) / (np.asarray(self.grid.aabb_max, np.float32) - lo)
        return (positions - torch.from_numpy(lo).to(dev)) * torch.from_numpy(rcp).to(dev) \
            * float(self.bake_res - 1)

    def _sigma(self, s: torch.Tensor) -> torch.Tensor:
        if self.sigma_space == "log1p":
            return torch.expm1(torch.clamp_min(s, 0.0))
        return s

    def apply(self, params, positions: torch.Tensor, viewdirs=None):
        """positions [..., 3] -> (rgb [..., 3], sigma [...]); viewdirs are
        ignored (a diffuse bake)."""
        table = params["table"]
        R = self.bake_res
        u = self._uvw(positions)
        if self.mode == "nearest":
            idx = torch.clamp(torch.round(u).to(torch.int64), 0, R - 1)
            flat = (idx[..., 0] * R + idx[..., 1]) * R + idx[..., 2]
            v = table[flat].float()
            return v[..., 0:3], self._sigma(v[..., 3])
        i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, R - 2)
        f = torch.clamp(u - i0.float(), 0.0, 1.0)
        fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
        w = [
            (1 - fx) * (1 - fy) * (1 - fz), (1 - fx) * (1 - fy) * fz,
            (1 - fx) * fy * (1 - fz), (1 - fx) * fy * fz,
            fx * (1 - fy) * (1 - fz), fx * (1 - fy) * fz,
            fx * fy * (1 - fz), fx * fy * fz,
        ]  # corner order: (dx, dy, dz) lexicographic, z fastest
        if self.mode == "trilinear_brick":
            flat = (i0[..., 0] * R + i0[..., 1]) * R + i0[..., 2]
            rows = table[flat].float()  # [..., 32]
            v = w[0][..., None] * rows[..., 0:4]
            for c in range(1, 8):
                v = v + w[c][..., None] * rows[..., 4 * c:4 * c + 4]
            return v[..., 0:3], self._sigma(v[..., 3])
        v = None  # trilinear: 8 separate 4-channel gathers
        c = 0
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    flat = ((i0[..., 0] + dx) * R + (i0[..., 1] + dy)) * R + (i0[..., 2] + dz)
                    term = w[c][..., None] * table[flat].float()
                    v = term if v is None else v + term
                    c += 1
        return v[..., 0:3], self._sigma(v[..., 3])


def bake_positions(bake_res: int, grid: GridConfig, device="cpu") -> torch.Tensor:
    """[R^3, 3] align-corners vertex positions spanning the AABB (numpy's
    float32 linspace, as the reference makes them)."""
    lo = np.asarray(grid.aabb_min, np.float32)
    hi = np.asarray(grid.aabb_max, np.float32)
    ax = [np.linspace(lo[a], hi[a], bake_res, dtype=np.float32) for a in range(3)]
    gx, gy, gz = np.meshgrid(*ax, indexing="ij")
    return torch.from_numpy(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)).to(device)


def vertex_keep(positions: torch.Tensor, occupancy: torch.Tensor, grid: GridConfig
                ) -> torch.Tensor:
    """[N] bool: the vertex lies in an occupied cell of `occupancy` [res]^3
    (the reference's eager `occupancy_lookup`, which divides by the cell
    size; the jitted lookups of the renderers multiply by its reciprocal)."""
    res = occupancy.shape[0]
    dev = positions.device
    lo = torch.tensor(grid.aabb_min, dtype=torch.float32, device=dev)
    hi = torch.tensor(grid.aabb_max, dtype=torch.float32, device=dev)
    ijk = torch.floor((positions - lo) / ((hi - lo) / res)).to(torch.int64)
    inside = torch.all((ijk >= 0) & (ijk < res), dim=-1)
    ijk = torch.clamp(ijk, 0, res - 1)
    return inside & occupancy.reshape(-1)[(ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]]


@torch.no_grad()
def bake_field(field_fn, params, grid: GridConfig, bake_res: int = 256, chunk: int = 65536,
               view_mode: str = "radial_in", occupancy: Optional[torch.Tensor] = None,
               dtype=torch.float32, sigma_space: str = "log1p", device=None) -> torch.Tensor:
    """Evaluate the field over the vertex grid -> [R^3, 4] (rgb, sigma)
    table on `device` (default the occupancy's, else the CPU).

    field_fn: (params, positions [N, 3], (theta, phi) [N, 2]) -> (rgb,
    sigma).  view_mode "radial_in": the view direction -normalize(p), from
    which a camera on the standard outward orbit sees vertex p; "fixed_z":
    -z for every vertex.  occupancy: the fine bitfield; the vertices outside
    its 6-neighbourhood dilation are zeroed after the evaluation, so that
    stale field values never leak into empty space through interpolation
    (the whole grid is still evaluated)."""
    if view_mode not in ("radial_in", "fixed_z"):
        raise ValueError(f"unknown bake view_mode {view_mode!r}")
    dev = torch.device(device) if device is not None else (
        occupancy.device if occupancy is not None else torch.device("cpu"))
    pts_all = bake_positions(bake_res, grid, dev)
    n = pts_all.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        p = pts_all[s:s + chunk]
        if view_mode == "radial_in":
            d = -p / torch.clamp_min(torch.linalg.vector_norm(p, dim=-1, keepdim=True), 1e-6)
        else:
            d = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(p.shape)
        rgb, sigma = field_fn(params, p, viewdirs_to_thetaphi(d))
        if sigma_space == "log1p":
            sigma = torch.log1p(torch.clamp_min(sigma.float(), 0.0))
        out[s:s + chunk, 0:3] = rgb.float()
        out[s:s + chunk, 3] = sigma.float()
    if occupancy is not None:
        # the 6-neighbourhood (`tnerf/render/baked.py:172-187`): clamped
        # shifts, so that occupancy at one face never wraps onto the other
        res = grid.resolution
        grown = dilate(occupancy.reshape(res, res, res).cpu().numpy().astype(bool), 1)
        keep = vertex_keep(pts_all, torch.from_numpy(grown).to(dev), grid)
        out *= keep[:, None].float()
    return out.to(dtype)


def brick_pack(table: torch.Tensor, bake_res: int) -> torch.Tensor:
    """[R^3, 4] -> [R^3, 32]: row v holds the 2x2x2 corner block starting
    at v (clamped at the +1 faces, where an in-range sample's weight is 0,
    since i0 is clipped to R - 2), so trilinear needs one row gather.
    Corner order matches BakedField.apply ((dx, dy, dz) lexicographic)."""
    R = bake_res
    t3 = table.reshape(R, R, R, 4)

    def shift(a, d, ax):
        if d == 0:
            return a
        return torch.cat([a.narrow(ax, 1, R - 1), a.narrow(ax, R - 1, 1)], dim=ax)

    parts = [shift(shift(shift(t3, dx, 0), dy, 1), dz, 2)
             for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    return torch.cat(parts, dim=-1).reshape(R ** 3, 32)


def make_baked_renderer(baked_table: torch.Tensor, bake_res: int, grid_cfg, sampler_cfg,
                        render_cfg, mode: str = "trilinear_brick",
                        sigma_space: str = "log1p"):
    """render(params, rays, occupancy=None, generator=None) -> RenderResult
    through the production march renderer (tightening, CDF placement, ray
    compaction) with the baked lookup as its shade stage.  Sample
    compaction is off: a lookup costs one gather, and compacting it would
    cost more than it saves.  The table is rounded to bf16 before brick
    packing (half the memory; the lookups read it back as float32) and
    rides as the renderer's params: pass `render.params`."""
    from tnerf_torch.render.grid_renderer import make_grid_renderer

    bf = BakedField(bake_res=bake_res, grid=grid_cfg, mode=mode, sigma_space=sigma_space)
    t16 = baked_table.to(torch.bfloat16)
    table = brick_pack(t16, bake_res) if mode == "trilinear_brick" and baked_table.shape[-1] == 4 \
        else t16
    rend = make_grid_renderer(None, grid_cfg, sampler_cfg, render_cfg, strategy="march",
                              compact=False, field_fn=bf.apply)

    def render(params, rays, occupancy=None, generator=None):
        return rend(params if params is not None else render.params, rays, occupancy,
                    generator)

    render.params = {"table": table}
    return render
