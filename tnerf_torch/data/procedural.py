"""Procedural analytic scenes and their ground-truth renderer
(counterpart of `tnerf/data/procedural.py`).

Soft colored primitives inside the [-1,1]^3 box; ground truth is a dense
uniform march of the analytic field with the standard quadrature
(`tnerf_torch.render.composite`).  Cameras sit on a sphere of radius
3.5 looking at the origin with lego's horizontal field of view.  Poses
come from numpy generators with fixed seeds, so both packages see the
same views.
"""

from __future__ import annotations

import json
import os
from functools import partial
from typing import Dict, Sequence

import numpy as np
import torch

from tnerf_torch.cameras import camera_rays, focal_from_angle
from tnerf_torch.data.dataset import ImageDataset
from tnerf_torch.device import resolve_device
from tnerf_torch.render.composite import composite

CAMERA_ANGLE_X = 0.6911112070083618  # lego's horizontal FoV


def _vec(v, x):
    return torch.as_tensor(v, dtype=torch.float32, device=x.device)


def _sphere_sdf(x, center, radius):
    return torch.linalg.norm(x - _vec(center, x), dim=-1) - radius


def _box_sdf(x, center, half):
    q = torch.abs(x - _vec(center, x)) - _vec(half, x)
    outside = torch.linalg.norm(torch.clamp_min(q, 0.0), dim=-1)
    inside = torch.clamp_max(torch.amax(q, dim=-1), 0.0)
    return outside + inside


def _cylinder_sdf(x, center, axis: int, radius, half_len):
    d = x - _vec(center, x)
    perp = [i for i in range(3) if i != axis]
    radial = torch.sqrt(d[..., perp[0]] ** 2 + d[..., perp[1]] ** 2) - radius
    axial = torch.abs(d[..., axis]) - half_len
    return torch.maximum(radial, axial)


def _torus_sdf(x, center, axis: int, R, r):
    d = x - _vec(center, x)
    perp = [i for i in range(3) if i != axis]
    ring = torch.sqrt(d[..., perp[0]] ** 2 + d[..., perp[1]] ** 2) - R
    return torch.sqrt(ring ** 2 + d[..., axis] ** 2) - r


_PRIMS = (
    (partial(_sphere_sdf, center=(0.35, 0.0, 0.1), radius=0.32), (0.9, 0.25, 0.2)),
    (partial(_sphere_sdf, center=(-0.3, 0.3, -0.2), radius=0.26), (0.2, 0.55, 0.95)),
    (partial(_box_sdf, center=(-0.1, -0.35, 0.25), half=(0.3, 0.16, 0.2)), (0.3, 0.85, 0.35)),
    (partial(_box_sdf, center=(0.0, 0.0, -0.45), half=(0.55, 0.55, 0.08)), (0.9, 0.8, 0.3)),
)

_HARD_RODS = (
    ((0.45, -0.35, -0.05), 2, 0.015, 0.42),
    ((-0.5, 0.1, 0.15), 0, 0.015, 0.45),
    ((0.05, 0.5, 0.3), 1, 0.015, 0.4),
    ((-0.15, -0.5, 0.05), 2, 0.022, 0.5),
    ((0.3, 0.25, 0.42), 0, 0.022, 0.5),
)
_HARD_PRIMS = (
    (partial(_sphere_sdf, center=(0.0, 0.0, 0.05), radius=0.3), (0.85, 0.3, 0.25)),
    (partial(_box_sdf, center=(0.0, 0.0, -0.5), half=(0.6, 0.6, 0.06)), (0.35, 0.5, 0.9)),
)
_ROD_COLORS = (
    (0.95, 0.8, 0.2), (0.2, 0.9, 0.5), (0.9, 0.3, 0.8),
    (0.25, 0.7, 0.95), (0.95, 0.45, 0.15),
)

_RING_PRIMS = (
    (partial(_torus_sdf, center=(0.0, 0.0, 0.0), axis=2, R=0.45, r=0.09), (0.9, 0.35, 0.2)),
    (partial(_torus_sdf, center=(0.0, 0.0, 0.0), axis=0, R=0.32, r=0.07), (0.25, 0.6, 0.95)),
    (partial(_torus_sdf, center=(0.1, -0.1, 0.2), axis=1, R=0.22, r=0.06), (0.3, 0.9, 0.4)),
    (partial(_sphere_sdf, center=(0.0, 0.0, 0.0), radius=0.13), (0.95, 0.85, 0.3)),
)

_LAYER_PRIMS = (
    (partial(_box_sdf, center=(-0.35, 0.0, -0.45), half=(0.22, 0.55, 0.07)), (0.85, 0.3, 0.3)),
    (partial(_box_sdf, center=(-0.05, 0.0, -0.22), half=(0.22, 0.5, 0.07)), (0.9, 0.65, 0.25)),
    (partial(_box_sdf, center=(0.25, 0.0, 0.01), half=(0.22, 0.45, 0.07)), (0.35, 0.8, 0.35)),
    (partial(_box_sdf, center=(0.5, 0.0, 0.24), half=(0.18, 0.4, 0.07)), (0.3, 0.55, 0.9)),
    (partial(_sphere_sdf, center=(-0.3, 0.3, 0.25), radius=0.18), (0.8, 0.35, 0.85)),
    (partial(_sphere_sdf, center=(0.0, -0.4, 0.35), radius=0.14), (0.3, 0.85, 0.85)),
    (partial(_cylinder_sdf, center=(-0.45, -0.3, -0.05), axis=2, radius=0.07, half_len=0.45),
     (0.95, 0.9, 0.5)),
)


def _soft_union_field(prims, x, sharpness=60.0, density_scale=45.0):
    """Density: smooth indicator of the primitive union; color: the
    softmin-weighted blend of primitive colors."""
    sdfs = torch.stack([sdf(x) for sdf, _ in prims], dim=-1)
    colors = torch.tensor([c for _, c in prims], dtype=torch.float32, device=x.device)
    occ = torch.sigmoid(-sharpness * sdfs)
    union = 1.0 - torch.prod(1.0 - occ, dim=-1)
    sigma = density_scale * union
    wts = torch.softmax(-sharpness * sdfs, dim=-1)
    rgb = torch.sum(wts[..., :, None] * colors, dim=-2)
    return rgb, sigma


def analytic_field(x, sharpness: float = 60.0, density_scale: float = 45.0):
    return _soft_union_field(_PRIMS, x, sharpness, density_scale)


def analytic_field_hard(x, sharpness: float = 220.0, density_scale: float = 160.0):
    prims = list(_HARD_PRIMS) + [
        (partial(_cylinder_sdf, center=center, axis=axis, radius=radius, half_len=half), col)
        for (center, axis, radius, half), col in zip(_HARD_RODS, _ROD_COLORS)
    ]
    rgb, sigma = _soft_union_field(prims, x, sharpness, density_scale)
    f = 22.0
    checker = 0.55 + 0.45 * torch.sin(f * x[..., 0]) * torch.sin(f * x[..., 1] + 1.3) \
        * torch.sin(f * x[..., 2] + 2.1)
    return torch.clamp(rgb * checker[..., None], 0.0, 1.0), sigma


def analytic_field_rings(x):
    return _soft_union_field(_RING_PRIMS, x, sharpness=80.0)


def analytic_field_layers(x):
    return _soft_union_field(_LAYER_PRIMS, x)


FIELDS = {
    "prims": analytic_field,
    "hard": analytic_field_hard,
    "rings": analytic_field_rings,
    "layers": analytic_field_layers,
}


def scene_background(name: str) -> bool:
    """Intrinsic GT background of a procedural scene (True = white)."""
    return name != "hard"


def _look_at_pose(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """OpenGL/NeRF camera-to-world: the camera looks down its -z at target."""
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, y, z, eye
    return pose


def sphere_poses(n: int, radius: float = 3.5, seed: int = 0,
                 elevation_range=(0.15, 1.1)) -> np.ndarray:
    """n camera poses on a sphere looking at the origin. [n, 4, 4]."""
    rng = np.random.default_rng(seed)
    azim = rng.uniform(0.0, 2.0 * np.pi, size=n)
    elev = rng.uniform(*elevation_range, size=n)
    up = np.array([0, 0, 1.0], np.float32)
    poses = [
        _look_at_pose(radius * np.array([np.cos(a) * np.cos(e), np.sin(a) * np.cos(e), np.sin(e)],
                                        dtype=np.float32), np.zeros(3, np.float32), up)
        for a, e in zip(azim, elev)
    ]
    return np.stack(poses)


def orbit_poses(n: int, radius: float = 3.5, elevation: float = 0.5) -> np.ndarray:
    """n poses on a circular orbit at a fixed elevation. [n, 4, 4]."""
    up = np.array([0, 0, 1.0], np.float32)
    poses = [
        _look_at_pose(radius * np.array([np.cos(a) * np.cos(elevation),
                                         np.sin(a) * np.cos(elevation),
                                         np.sin(elevation)], dtype=np.float32),
                      np.zeros(3, np.float32), up)
        for a in np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    ]
    return np.stack(poses)


@torch.no_grad()
def render_gt_image(pose, width: int, height: int, focal_px: float, near: float, far: float,
                    n_samples: int, white_background: bool, field_name: str = "prims",
                    device="cuda") -> torch.Tensor:
    """[H, W, 3] ground truth of one pose, marched in row chunks that hold
    at most ~8M samples each."""
    rays = camera_rays(pose, width, height, focal_px, device=device)
    t = torch.linspace(near, far, n_samples + 1, dtype=torch.float32, device=device)
    t_mid = 0.5 * (t[:-1] + t[1:])
    deltas = t[1:] - t[:-1]
    field = FIELDS[field_name]
    row_chunk = max(1, min(height, int(8_000_000 / (width * n_samples))))
    out = []
    for r0 in range(0, height, row_chunk):
        o = rays.origins[r0:r0 + row_chunk]
        d = rays.directions[r0:r0 + row_chunk]
        h = o.shape[0]
        pts = o[..., None, :] + d[..., None, :] * t_mid[:, None]
        rgb, sigma = field(pts.reshape(-1, 3))
        res = composite(rgb.reshape(h, width, n_samples, 3), sigma.reshape(h, width, n_samples),
                        deltas.expand(h, width, n_samples),
                        t_mid=t_mid.expand(h, width, n_samples),
                        white_background=white_background)
        out.append(res.rgb)
    return torch.cat(out, dim=0)


def generate_procedural_scene(
    name: str = "prims",
    width: int = 128,
    height: int = 128,
    n_train: int = 24,
    n_val: int = 4,
    n_test: int = 8,
    n_samples: int = 384,
    near: float = 2.0,
    far: float = 5.5,
    white_background: bool = True,
    radius: float = 3.5,
    splits: Sequence[str] = ("train", "val", "test"),
    device="cuda",
) -> Dict[str, ImageDataset]:
    """{train, val, test} splits of a procedural field (only those named
    in `splits`; each split has its own pose seed, so leaving one out
    changes none of the others).  Images come back as host numpy, as the
    reference's do."""
    if name not in FIELDS:
        raise ValueError(f"unknown procedural scene {name!r}; have {sorted(FIELDS)}")
    device = resolve_device(device)
    if name == "hard":
        white_background = False
        n_samples = max(n_samples, 772)
    focal = focal_from_angle(width, CAMERA_ANGLE_X)
    out: Dict[str, ImageDataset] = {}
    counts = {"train": n_train, "val": n_val, "test": n_test}
    seeds = {"train": 10, "val": 20, "test": 30}
    for split, n in counts.items():
        if n == 0 or split not in splits:
            continue
        poses = sphere_poses(n, radius=radius, seed=seeds[split])
        imgs = [
            render_gt_image(poses[i], width, height, focal, near, far, n_samples,
                            white_background, field_name=name, device=device).cpu().numpy()
            for i in range(n)
        ]
        out[split] = ImageDataset(
            images=np.clip(np.stack(imgs), 0.0, 1.0).astype(np.float32),
            poses=poses, focal=focal, width=width, height=height, channels=3, split=split,
        )
    return out


def frontal_poses(n: int, radius: float = 3.5, seed: int = 0, azimuth_half_width: float = 0.35,
                  elevation_range=(0.25, 0.6)) -> np.ndarray:
    """n forward-facing poses on a narrow frontal arc looking at the origin,
    the LLFF capture geometry (`tnerf/data/procedural.py:362`). [n, 4, 4]."""
    rng = np.random.default_rng(seed)
    azim = rng.uniform(-azimuth_half_width, azimuth_half_width, size=n)
    elev = rng.uniform(*elevation_range, size=n)
    up = np.array([0, 0, 1.0], np.float32)
    poses = [
        _look_at_pose(radius * np.array([np.cos(a) * np.cos(e), np.sin(a) * np.cos(e), np.sin(e)],
                                        dtype=np.float32), np.zeros(3, np.float32), up)
        for a, e in zip(azim, elev)
    ]
    return np.stack(poses)


def generate_llff_pool(name: str = "prims", width: int = 320, height: int = 240,
                       n_views: int = 24, n_samples: int = 384, near: float = 2.0,
                       far: float = 5.5, radius: float = 3.5, seed: int = 40,
                       device="cuda") -> ImageDataset:
    """One pool of forward-facing, non-square views of a procedural field
    (`tnerf/data/procedural.py:387`), the LLFF capture shape: a single
    image set whose test views are held out by index."""
    if name not in FIELDS:
        raise ValueError(f"unknown procedural scene {name!r}; have {sorted(FIELDS)}")
    device = resolve_device(device)
    focal = focal_from_angle(width, CAMERA_ANGLE_X)
    poses = frontal_poses(n_views, radius=radius, seed=seed)
    imgs = [render_gt_image(poses[i], width, height, focal, near, far, n_samples,
                            scene_background(name), field_name=name, device=device).cpu().numpy()
            for i in range(n_views)]
    return ImageDataset(images=np.clip(np.stack(imgs), 0.0, 1.0).astype(np.float32), poses=poses,
                        focal=focal, width=width, height=height, channels=3, split="all")


def export_llff_format(ds: ImageDataset, scene_dir: str, near: float, far: float) -> None:
    """An image pool on disk in LLFF layout, poses_bounds.npy + images/
    (`tnerf/data/procedural.py:426`): each row the flattened [3, 5] matrix
    in LLFF's [down, right, backwards] axes | [H, W, focal], then [near,
    far]; the exact inverse of `data/llff.py`'s conversion."""
    from tnerf_torch.data.png_io import write_png_batch

    img_dir = os.path.join(scene_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    n = len(ds)
    write_png_batch([os.path.join(img_dir, f"image{i:03d}.png") for i in range(n)], ds.images)
    pb = np.zeros((n, 17), np.float64)
    for i in range(n):
        c2w = ds.poses[i]
        raw = np.zeros((3, 5), np.float64)
        raw[:, 0] = -c2w[:3, 1]  # down  = -up
        raw[:, 1] = c2w[:3, 0]   # right
        raw[:, 2] = c2w[:3, 2]   # backwards
        raw[:, 3] = c2w[:3, 3]   # translation
        raw[:, 4] = (ds.height, ds.width, ds.focal)
        pb[i, :15] = raw.reshape(-1)
        pb[i, 15:] = (near, far)
    np.save(os.path.join(scene_dir, "poses_bounds.npy"), pb)


def export_colmap_format(ds: ImageDataset, scene_dir: str, n_points: int = 512, seed: int = 7,
                         field_name: str = "prims", sigma_threshold: float = 1.0) -> None:
    """An image pool on disk as a COLMAP text model, sparse/0/{cameras,
    images,points3D}.txt + images/ (`tnerf/data/procedural.py:461`): poses
    as world-to-camera quaternions in COLMAP's y-down, z-forward axes (the
    inverse of `data/colmap.py`'s conversion), and a sparse cloud of
    n_points sampled where the field's density (on a 48^3 probe grid,
    evaluated on the CPU) exceeds sigma_threshold, so that the reader's
    per-image depth bounds follow the scene's content."""
    from tnerf_torch.data.colmap import rotmat_to_qvec
    from tnerf_torch.data.png_io import write_png_batch

    sparse = os.path.join(scene_dir, "sparse", "0")
    img_dir = os.path.join(scene_dir, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)
    n = len(ds)
    names = [f"frame_{i:03d}.png" for i in range(n)]
    write_png_batch([os.path.join(img_dir, nm) for nm in names], ds.images)

    lin = np.linspace(-1.1, 1.1, 48, dtype=np.float32)
    X = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1).reshape(-1, 3)
    with torch.no_grad():
        _, sigma = FIELDS[field_name](torch.from_numpy(X))
    occ = X[sigma.numpy() > sigma_threshold]
    if occ.shape[0] == 0:
        raise ValueError(f"procedural field {field_name!r} has no density above "
                         f"{sigma_threshold} on the probe grid")
    rng = np.random.default_rng(seed)
    sel = rng.choice(occ.shape[0], min(n_points, occ.shape[0]), replace=False)
    pts = occ[sel] + rng.normal(0.0, 0.005, (sel.size, 3)).astype(np.float32)

    cx, cy = ds.width / 2.0, ds.height / 2.0
    with open(os.path.join(sparse, "cameras.txt"), "w") as fh:
        fh.write("# Camera list: CAMERA_ID MODEL W H fx fy cx cy\n")
        fh.write(f"1 PINHOLE {ds.width} {ds.height} "
                 f"{ds.focal:.17g} {ds.focal:.17g} {cx:.17g} {cy:.17g}\n")
    with open(os.path.join(sparse, "images.txt"), "w") as fh:
        fh.write("# IMAGE_ID qw qx qy qz tx ty tz CAMERA_ID NAME\n")
        for i in range(n):
            c = np.array(ds.poses[i], np.float64)
            c[:3, 1] *= -1.0  # NeRF (y up, z back) -> COLMAP (y down, z forward)
            c[:3, 2] *= -1.0
            R = c[:3, :3].T
            t = -R @ c[:3, 3]
            q = rotmat_to_qvec(R)
            fh.write(f"{i + 1} " + " ".join(f"{v:.17g}" for v in q) + " "
                     + " ".join(f"{v:.17g}" for v in t) + f" 1 {names[i]}\n")
            # every view observes every point (the reader uses only the ids)
            fh.write(" ".join(f"0.0 0.0 {pid + 1}" for pid in range(len(pts))) + "\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as fh:
        fh.write("# POINT3D_ID x y z r g b error TRACK\n")
        for pid, xyz in enumerate(pts):
            fh.write(f"{pid + 1} " + " ".join(f"{v:.17g}" for v in xyz)
                     + " 128 128 128 0.5 1 0\n")


def export_nerf_synthetic_format(datasets: Dict[str, ImageDataset], scene_dir: str) -> None:
    """Splits on disk in NeRF-synthetic layout, transforms_{split}.json +
    {split}/r_{i}.png (`tnerf/data/procedural.py:543`), as
    `dataset.load_synthetic_scene` reads them back."""
    from tnerf_torch.data.png_io import write_png_batch

    os.makedirs(scene_dir, exist_ok=True)
    for split, ds in datasets.items():
        os.makedirs(os.path.join(scene_dir, split), exist_ok=True)
        write_png_batch([os.path.join(scene_dir, f"{split}/r_{i}.png") for i in range(len(ds))],
                        ds.images)
        frames = [{"file_path": f"./{split}/r_{i}", "transform_matrix": ds.poses[i].tolist()}
                  for i in range(len(ds))]
        with open(os.path.join(scene_dir, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, fh)
