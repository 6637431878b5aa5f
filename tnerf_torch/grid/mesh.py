"""Mesh-bounded scenes: tet and triangle meshes -> occupancy bitfields
(counterpart of `tnerf/grid/mesh.py`, numpy, bit-equal to it).

A mesh bounds the scene by voxelizing into the occupancy bitfield, after
which the standard grid traversal applies; `grid.mesh_path` names it and
training holds every occupancy refresh inside it
(`grid/occupancy.update_occupancy`'s mask).

- `load_tet_mesh`: the textual tet format (header `verts N` + 3 values a
  vertex, header `tets M` + `n i j k l` lines); each tet contributes the
  faces (i,j,k), (i,j,l), (j,k,l), (i,k,l).
- `load_obj`: minimal OBJ (v / f lines, polygon fan triangulation).
- `voxelize_triangles`: conservative triangle -> cell coverage (each
  triangle supersampled barycentrically at sub-cell spacing, its sample
  cells marked), vectorized.
- `fill_interior`, `dilate`: the solid fill and the safety margin, both
  by one 6-neighbourhood stencil.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tnerf_torch.config import GridConfig


def load_tet_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Reference tet format -> (vertices [V,3] f32, faces [F,3] i32)."""
    with open(path) as fh:
        tokens = fh.read().split()
    i = 0
    if tokens[i].lower() not in ("verts", "vertices"):
        raise ValueError(f"expected 'verts N' header, got {tokens[i]!r}")
    n_verts = int(tokens[i + 1])
    i += 2
    verts = np.asarray(tokens[i : i + 3 * n_verts], np.float32).reshape(n_verts, 3)
    i += 3 * n_verts
    if tokens[i].lower() not in ("tets", "tetrahedra"):
        raise ValueError(f"expected 'tets M' header, got {tokens[i]!r}")
    n_tets = int(tokens[i + 1])
    i += 2
    faces = []
    for _ in range(n_tets):
        _n, x, y, z, w = (int(t) for t in tokens[i : i + 5])
        i += 5
        faces += [(x, y, z), (x, y, w), (y, z, w), (x, z, w)]
    return verts, np.asarray(faces, np.int32)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal Wavefront OBJ -> (vertices [V,3] f32, faces [F,3] i32)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(v) for v in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def voxelize_triangles(
    vertices: np.ndarray,
    faces: np.ndarray,
    grid: GridConfig,
    supersample: int = 4,
) -> np.ndarray:
    """Mark every grid cell touched by any triangle. Returns
    [res, res, res] bool (a surface shell — combine with fill_interior
    for solid occupancy)."""
    res = grid.resolution
    lo = np.asarray(grid.aabb_min, np.float32)
    hi = np.asarray(grid.aabb_max, np.float32)
    h = (hi - lo) / res
    tri = vertices[faces]  # [F, 3, 3]

    # Per-triangle sample density from its size in cells: supersample the
    # barycentric simplex finely enough that no crossed cell is missed.
    edge = np.maximum(
        np.linalg.norm(tri[:, 1] - tri[:, 0], axis=-1),
        np.linalg.norm(tri[:, 2] - tri[:, 0], axis=-1),
    )
    n_max = max(2, int(np.ceil(edge.max() / h.min() * supersample)) + 1)
    u = np.linspace(0.0, 1.0, n_max, dtype=np.float32)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    keep = uu + vv <= 1.0 + 1e-6
    uu, vv = uu[keep], vv[keep]  # [K] barycentric grid over the simplex
    pts = (
        tri[:, None, 0]
        + uu[None, :, None] * (tri[:, None, 1] - tri[:, None, 0])
        + vv[None, :, None] * (tri[:, None, 2] - tri[:, None, 0])
    ).reshape(-1, 3)
    ijk = np.floor((pts - lo) / h).astype(np.int64)
    inside = np.all((ijk >= 0) & (ijk < res), axis=-1)
    ijk = ijk[inside]
    occ = np.zeros((res, res, res), bool)
    occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
    return occ


def _dilate_once(occ: np.ndarray) -> np.ndarray:
    """One 6-neighborhood dilation step — the single stencil shared by
    fill_interior's flood and dilate()."""
    grown = occ.copy()
    grown[1:, :, :] |= occ[:-1, :, :]
    grown[:-1, :, :] |= occ[1:, :, :]
    grown[:, 1:, :] |= occ[:, :-1, :]
    grown[:, :-1, :] |= occ[:, 1:, :]
    grown[:, :, 1:] |= occ[:, :, :-1]
    grown[:, :, :-1] |= occ[:, :, 1:]
    return grown


def fill_interior(shell: np.ndarray) -> np.ndarray:
    """Solid occupancy from a closed surface shell: a cell is interior if
    it is enclosed along all six axis-aligned directions (conservative
    parity-free flood: exterior = reachable from the boundary through
    empty cells)."""
    res = shell.shape[0]
    exterior = np.zeros_like(shell)
    frontier = ~shell
    # seed: all boundary cells that are empty
    exterior[0, :, :] |= frontier[0, :, :]
    exterior[-1, :, :] |= frontier[-1, :, :]
    exterior[:, 0, :] |= frontier[:, 0, :]
    exterior[:, -1, :] |= frontier[:, -1, :]
    exterior[:, :, 0] |= frontier[:, :, 0]
    exterior[:, :, -1] |= frontier[:, :, -1]
    # BFS by repeated dilation (at most res iterations; typically far fewer)
    for _ in range(3 * res):
        grown = _dilate_once(exterior) & ~shell
        if (grown == exterior).all():
            break
        exterior = grown
    return ~exterior


def occupancy_from_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    grid: GridConfig,
    solid: bool = True,
) -> np.ndarray:
    shell = voxelize_triangles(vertices, faces, grid)
    return fill_interior(shell) if solid else shell


def dilate(occ: np.ndarray, cells: int = 1) -> np.ndarray:
    """6-neighborhood dilation by `cells` — a conservative safety margin
    around a voxelized mesh (samples near the surface and the trilinear
    support of grid-encoded fields extend past the exact cell)."""
    for _ in range(cells):
        occ = _dilate_once(occ)
    return occ


def mesh_occupancy_mask(grid: GridConfig):
    """The static occupancy mask configured by grid.mesh_path, or None.

    Loads a triangle mesh (.obj) or the textual tet format (any other
    extension), voxelizes
    it into the grid, optionally fills the interior (grid.mesh_solid)
    and dilates by grid.mesh_dilate cells.  The mask statically bounds
    marching: occupancy updates can only prune within it, never escape
    it."""
    if not grid.mesh_path:
        return None
    verts, faces = (
        load_obj(grid.mesh_path)
        if grid.mesh_path.lower().endswith(".obj")
        else load_tet_mesh(grid.mesh_path)
    )
    mask = occupancy_from_mesh(verts, faces, grid, solid=grid.mesh_solid)
    if grid.mesh_dilate > 0:
        mask = dilate(mask, grid.mesh_dilate)
    if not mask.any():
        raise ValueError(
            f"grid.mesh_path={grid.mesh_path!r} voxelizes to an empty "
            f"occupancy at resolution {grid.resolution} — mesh outside "
            f"the AABB {grid.aabb_min}..{grid.aabb_max}?"
        )
    return mask
