"""COLMAP sparse-model reader (scene.kind="colmap"), the counterpart of
`tnerf/data/colmap.py`, numpy arithmetic for numpy arithmetic: the TEXT
(.txt) and BINARY (.bin) models of cameras, images and points3D.

Layout expected under ``<root>/<name>``:

    images/            (or images_<downscale>/ — LLFF convention)
    sparse/0/cameras.{txt|bin}, images.{txt|bin}, points3D.{txt|bin}
    (also accepted: sparse/ or colmap/sparse/0/)

Conventions handled here:
- COLMAP stores WORLD-TO-CAMERA rotations as quaternions with the
  camera looking down +z, y DOWN; we invert to camera-to-world and
  flip to the NeRF/OpenGL convention (y up, z back): columns
  (r0, -r1, -r2).
- Per-image [near, far] depth bounds come from the 3D points observed
  by that image (percentiles of their camera-space depths) — the same
  role as LLFF's poses_bounds, so ``sampler.near/far = -1`` (auto) and
  the NDC pipeline work unchanged.
- ``recenter`` / ``bd_rescale`` reuse the LLFF preprocessing
  (llff.recenter_poses) — required for scene.ndc.

Only distortion-free pinhole models map exactly onto the ray generator;
radial/OpenCV models load with a loud warning that distortion
coefficients are ignored (undistort with ``colmap image_undistorter``
for exact geometry).
"""

from __future__ import annotations

import os
import struct
import warnings
from typing import Dict, Tuple

import numpy as np

from tnerf_torch.data.dataset import ImageDataset
from tnerf_torch.data.llff import recenter_poses
from tnerf_torch.data.png_io import read_png

# COLMAP model ids -> (name, n_params); params always start with the
# focal(s) then the principal point.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_BY_NAME = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}
# models whose leading params are (f, cx, cy) vs (fx, fy, cx, cy)
_SINGLE_FOCAL = {
    "SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
    "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV",
}
_EXACT = {"SIMPLE_PINHOLE", "PINHOLE"}


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP (qw, qx, qy, qz) -> 3x3 rotation (world-to-camera)."""
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Inverse of qvec_to_rotmat (used by the test fixture writer)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# --------------------------------------------------------------------------
# model parsing (text and binary)


def _read_cameras_txt(path: str) -> Dict[int, dict]:
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            out[int(el[0])] = dict(
                model=el[1], width=int(el[2]), height=int(el[3]),
                params=np.array([float(v) for v in el[4:]]),
            )
    return out


def _read_images_txt(path: str) -> Dict[int, dict]:
    out = {}
    with open(path) as fh:
        lines = [
            l.strip() for l in fh
            if l.strip() and not l.strip().startswith("#")
        ]
    for meta, pts in zip(lines[0::2], lines[1::2]):
        el = meta.split()
        p = pts.split()
        pids = np.array([int(v) for v in p[2::3]], dtype=np.int64)
        out[int(el[0])] = dict(
            qvec=np.array([float(v) for v in el[1:5]]),
            tvec=np.array([float(v) for v in el[5:8]]),
            camera_id=int(el[8]),
            name=el[9],
            point3d_ids=pids[pids >= 0],
        )
    return out


def _read_points3d_txt(path: str) -> Dict[int, np.ndarray]:
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            out[int(el[0])] = np.array([float(v) for v in el[1:4]])
    return out


def _read_cameras_bin(path: str) -> Dict[int, dict]:
    out = {}
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        for _ in range(n):
            cid, mid, w, h = struct.unpack("<iiQQ", fh.read(24))
            name, np_ = CAMERA_MODELS[mid]
            params = struct.unpack(f"<{np_}d", fh.read(8 * np_))
            out[cid] = dict(
                model=name, width=int(w), height=int(h),
                params=np.array(params),
            )
    return out


def _read_images_bin(path: str) -> Dict[int, dict]:
    out = {}
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        for _ in range(n):
            (iid,) = struct.unpack("<i", fh.read(4))
            q = struct.unpack("<4d", fh.read(32))
            t = struct.unpack("<3d", fh.read(24))
            (cid,) = struct.unpack("<i", fh.read(4))
            name = b""
            while (c := fh.read(1)) != b"\x00":
                name += c
            (npts,) = struct.unpack("<Q", fh.read(8))
            # per 2D point: x f64, y f64, point3D_id i64 (24 bytes)
            rec = np.frombuffer(
                fh.read(24 * npts),
                dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")],
            )
            pids = rec["id"].astype(np.int64)
            out[iid] = dict(
                qvec=np.array(q), tvec=np.array(t), camera_id=cid,
                name=name.decode(), point3d_ids=pids[pids >= 0],
            )
    return out


def _read_points3d_bin(path: str) -> Dict[int, np.ndarray]:
    out = {}
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        for _ in range(n):
            (pid,) = struct.unpack("<Q", fh.read(8))
            xyz = struct.unpack("<3d", fh.read(24))
            fh.read(3)  # rgb
            fh.read(8)  # error
            (tl,) = struct.unpack("<Q", fh.read(8))
            fh.read(8 * tl)  # track (image_id, point2D_idx) pairs
            out[pid] = np.array(xyz)
    return out


def _find_model_dir(scene_dir: str) -> str:
    for cand in ("sparse/0", "sparse", "colmap/sparse/0"):
        d = os.path.join(scene_dir, cand)
        if os.path.isfile(os.path.join(d, "cameras.txt")) or os.path.isfile(
            os.path.join(d, "cameras.bin")
        ):
            return d
    raise FileNotFoundError(
        f"no COLMAP model (cameras.txt/bin) under {scene_dir}/sparse[/0]"
    )


def _read_model(model_dir: str):
    if os.path.isfile(os.path.join(model_dir, "cameras.bin")):
        cams = _read_cameras_bin(os.path.join(model_dir, "cameras.bin"))
        imgs = _read_images_bin(os.path.join(model_dir, "images.bin"))
        p3d_path = os.path.join(model_dir, "points3D.bin")
        pts = _read_points3d_bin(p3d_path) if os.path.isfile(p3d_path) else {}
    else:
        cams = _read_cameras_txt(os.path.join(model_dir, "cameras.txt"))
        imgs = _read_images_txt(os.path.join(model_dir, "images.txt"))
        p3d_path = os.path.join(model_dir, "points3D.txt")
        pts = _read_points3d_txt(p3d_path) if os.path.isfile(p3d_path) else {}
    return cams, imgs, pts


def _intrinsics(cam: dict) -> Tuple[float, float, float, float]:
    name, params = cam["model"], cam["params"]
    if name not in _MODEL_BY_NAME:
        raise ValueError(f"unknown COLMAP camera model {name!r}")
    if name not in _EXACT:
        warnings.warn(
            f"COLMAP camera model {name} carries distortion coefficients "
            "that the pinhole ray generator ignores — run `colmap "
            "image_undistorter` for exact geometry",
            stacklevel=3,
        )
    if name in _SINGLE_FOCAL:
        f, cx, cy = params[0], params[1], params[2]
        return float(f), float(f), float(cx), float(cy)
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    return float(fx), float(fy), float(cx), float(cy)


def load_colmap_scene(
    root: str,
    name: str,
    srgb_to_linear: bool = False,
    downscale: int = 1,
    holdout_every: int = 8,
    recenter: bool = False,
    bd_rescale: float = 0.0,
) -> Dict[str, ImageDataset]:
    """Load a COLMAP-reconstructed capture; every ``holdout_every``-th
    view (in filename order) becomes the test split, like LLFF."""
    scene_dir = os.path.join(root, name)
    cams, imgs, pts = _read_model(_find_model_dir(scene_dir))
    if not imgs:
        raise ValueError(f"COLMAP model under {scene_dir} has no images")
    cam_ids = {im["camera_id"] for im in imgs.values()}
    if len(cam_ids) != 1:
        raise ValueError(
            f"{len(cam_ids)} distinct COLMAP cameras; this reader expects "
            "a single shared camera (one intrinsics set per dataset)"
        )
    cam = cams[cam_ids.pop()]
    fx, fy, cx, cy = _intrinsics(cam)
    w_native, h_native = cam["width"], cam["height"]

    order = sorted(imgs.values(), key=lambda im: im["name"])
    c2ws, paths, bounds = [], [], []
    all_depths = []
    for im in order:
        R = qvec_to_rotmat(im["qvec"])          # world-to-camera
        t = im["tvec"]
        c2w = np.eye(4, dtype=np.float64)
        c2w[:3, :3] = R.T
        c2w[:3, 3] = -R.T @ t
        # COLMAP camera (x right, y down, z forward) -> NeRF (y up, z back)
        c2w[:3, 1] *= -1.0
        c2w[:3, 2] *= -1.0
        c2ws.append(c2w)
        paths.append(im["name"])
        depths = np.array([
            (R @ pts[pid] + t)[2]
            for pid in im["point3d_ids"] if pid in pts
        ])
        depths = depths[depths > 0]
        if depths.size:
            bounds.append(np.percentile(depths, [1.0, 99.0]))
            all_depths.append(depths)
        else:
            bounds.append(None)
    if all_depths:
        glob = np.percentile(np.concatenate(all_depths), [1.0, 99.0])
        near_far = np.stack([
            b if b is not None else glob for b in bounds
        ]).astype(np.float32)
    else:
        near_far = None
    c2w = np.stack(c2ws).astype(np.float32)

    if bd_rescale > 0.0:
        if near_far is None:
            raise ValueError(
                "bd_rescale needs depth bounds, but this COLMAP model has "
                "no points3D"
            )
        sc = 1.0 / (float(near_far.min()) * float(bd_rescale))
        c2w[:, :3, 3] *= sc
        near_far = near_far * sc
    if recenter:
        c2w = recenter_poses(c2w)

    img_dir = os.path.join(scene_dir, f"images_{downscale}")
    use_predownscaled = downscale > 1 and os.path.isdir(img_dir)
    if not use_predownscaled:
        img_dir = os.path.join(scene_dir, "images")
    images = np.stack([
        read_png(
            os.path.join(img_dir, p), channels=4,
            srgb_to_linear=srgb_to_linear,
        )
        for p in paths
    ]).astype(np.float32)
    n, h, w = images.shape[:3]
    if not use_predownscaled and downscale > 1:
        if h % downscale or w % downscale:
            raise ValueError(
                f"downscale={downscale} does not divide {w}x{h}"
            )
        c = images.shape[-1]
        images = images.reshape(
            n, h // downscale, downscale, w // downscale, downscale, c
        ).mean(axis=(2, 4))
        h, w = images.shape[1:3]
    d = w_native / w  # effective downscale (covers pre-downscaled dirs)
    intr = (fx / d, fy / d, cx / d, cy / d)

    idx = np.arange(n)
    test_sel = (
        (idx % holdout_every == 0) if holdout_every > 0
        else np.zeros(n, bool)
    )
    out: Dict[str, ImageDataset] = {}
    for split, sel in (("train", ~test_sel), ("test", test_sel)):
        if not sel.any():
            continue
        out[split] = ImageDataset(
            images=images[sel],
            poses=c2w[sel],
            focal=intr[0],
            width=w,
            height=h,
            channels=images.shape[-1],
            split=split,
            near_far=None if near_far is None else near_far[sel],
            intrinsics=intr,
        )
    return out
