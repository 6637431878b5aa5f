"""LLFF dataset reader (poses_bounds.npy + images/), the counterpart of
`tnerf/data/llff.py`, numpy arithmetic for numpy arithmetic.

Format (LLFF convention): poses_bounds.npy is [N, 17] — a flattened
[3, 5] matrix per image (rotation | translation | [H, W, focal]) plus
[near, far] depth bounds.  LLFF camera axes are [down, right, backwards];
we convert to the NeRF/OpenGL convention [right, up, backwards] used by
tnerf_torch.cameras (columns swapped with a sign flip).  Images load from
`images_{downscale}/` when present, else `images/`.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from tnerf_torch.data.dataset import ImageDataset
from tnerf_torch.data.png_io import read_png

IMG_EXTS = (".png", ".jpg", ".jpeg", ".JPG", ".PNG")


def _image_dir(scene_dir: str, downscale: int) -> str:
    if downscale > 1:
        cand = os.path.join(scene_dir, f"images_{downscale}")
        if os.path.isdir(cand):
            return cand
    return os.path.join(scene_dir, "images")


def _list_images(d: str):
    return sorted(
        os.path.join(d, f) for f in os.listdir(d) if f.endswith(IMG_EXTS)
    )


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / max(float(np.linalg.norm(v)), 1e-12)


def poses_avg(c2w: np.ndarray) -> np.ndarray:
    """Average camera-to-world frame of a pose set [N, 4, 4] -> [4, 4]:
    translation = mean eye, z = normalized mean backward axis, y from the
    mean up hint (the standard LLFF `viewmatrix(mean_z, mean_up, center)`
    construction).  Recentering with its inverse puts the mean camera at
    the origin looking down world -z — the frame the NDC warp
    (cameras.ndc_warp) requires."""
    center = c2w[:, :3, 3].mean(axis=0)
    z = _normalize(c2w[:, :3, 2].mean(axis=0))
    up = c2w[:, :3, 1].mean(axis=0)
    x = _normalize(np.cross(up, z))
    y = np.cross(z, x)
    avg = np.eye(4, dtype=np.float64)
    avg[:3, 0], avg[:3, 1], avg[:3, 2], avg[:3, 3] = x, y, z, center
    return avg


def recenter_poses(c2w: np.ndarray) -> np.ndarray:
    """Rigidly move all poses so their average frame is the identity."""
    inv = np.linalg.inv(poses_avg(c2w.astype(np.float64)))
    out = (inv[None] @ c2w.astype(np.float64)).astype(np.float32)
    out[:, 3, :] = (0.0, 0.0, 0.0, 1.0)
    return out


def load_llff_scene(
    root: str,
    name: str,
    srgb_to_linear: bool = False,
    downscale: int = 1,
    holdout_every: int = 8,
    recenter: bool = False,
    bd_rescale: float = 0.0,
) -> Dict[str, ImageDataset]:
    """Load an LLFF scene; every `holdout_every`-th view becomes the test
    split (the standard LLFF protocol).

    recenter: rigidly transform all poses so their AVERAGE camera frame
    is the world identity (recenter_poses) — required by the NDC
    parameterization (scene.ndc), which projects along world -z.
    bd_rescale: when > 0, the classic LLFF `bd_factor` preprocessing —
    scale translations and depth bounds by 1 / (min_bound * bd_rescale)
    so the nearest content sits at depth 1/bd_rescale (1.33 world units
    at the standard 0.75), safely beyond an NDC near plane at 1.0."""
    scene_dir = os.path.join(root, name)
    pb_path = os.path.join(scene_dir, "poses_bounds.npy")
    if not os.path.exists(pb_path):
        raise FileNotFoundError(f"no poses_bounds.npy under {scene_dir}")
    pb = np.load(pb_path)
    if pb.ndim != 2 or pb.shape[1] != 17:
        raise ValueError(f"poses_bounds.npy must be [N, 17]; got {pb.shape}")
    poses_raw = pb[:, :15].reshape(-1, 3, 5)
    bounds = pb[:, 15:17]  # [N, 2] near/far

    img_dir = _image_dir(scene_dir, downscale)
    paths = _list_images(img_dir)
    if len(paths) != len(pb):
        raise ValueError(
            f"{len(paths)} images in {img_dir} but {len(pb)} poses"
        )

    images = np.stack(
        [read_png(p, channels=4, srgb_to_linear=srgb_to_linear) for p in paths]
    ).astype(np.float32)
    h, w = images.shape[1:3]

    # [down, right, back] -> [right, up, back]: c2w columns (r0,r1,r2) =
    # (raw_col1, -raw_col0, raw_col2)
    c2w = np.zeros((len(pb), 4, 4), np.float32)
    c2w[:, 3, 3] = 1.0
    c2w[:, :3, 0] = poses_raw[:, :, 1]
    c2w[:, :3, 1] = -poses_raw[:, :, 0]
    c2w[:, :3, 2] = poses_raw[:, :, 2]
    c2w[:, :3, 3] = poses_raw[:, :, 3]

    # hwf stored at native resolution; rescale focal to loaded size
    focal_native = float(poses_raw[0, 2, 4])
    w_native = float(poses_raw[0, 1, 4])
    focal = focal_native * (w / w_native)

    if bd_rescale > 0.0:
        sc = 1.0 / (float(bounds.min()) * float(bd_rescale))
        c2w[:, :3, 3] *= sc
        bounds = bounds * sc
    if recenter:
        c2w = recenter_poses(c2w)

    idx = np.arange(len(pb))
    test_sel = (idx % holdout_every == 0) if holdout_every > 0 else np.zeros(len(pb), bool)
    out: Dict[str, ImageDataset] = {}
    for split, sel in (("train", ~test_sel), ("test", test_sel)):
        if not sel.any():
            continue
        out[split] = ImageDataset(
            images=images[sel],
            poses=c2w[sel],
            focal=focal,
            width=w,
            height=h,
            channels=images.shape[-1],
            split=split,
            near_far=bounds[sel].astype(np.float32),
        )
    return out
