"""Image datasets (counterpart of `tnerf/data/dataset.py`): the
`ImageDataset` split, the NeRF-synthetic reader (`transforms_{split}.json`
+ PNGs, also instant-ngp's `fl_x` / `fl_y` / `cx` / `cy` intrinsics), and
the `load_data` dispatch to the procedural scenes, LLFF
(`data/llff.py`) and COLMAP (`data/colmap.py`).  Host-side I/O is numpy;
images are decoded by the port's own PNG reader (`data/png_io.py`)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from tnerf_torch.cameras import focal_from_angle
from tnerf_torch.data.png_io import read_png

SYNTHETIC_SCENES = (
    "chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship",
)
SPLITS = ("train", "val", "test")


@dataclass
class ImageDataset:
    """One split of one scene."""

    images: np.ndarray   # [N, H, W, C] float32 in [0,1]
    poses: np.ndarray    # [N, 4, 4] float32 camera-to-world
    focal: float         # pixels (fx; a scalar stand-in when intrinsics are set)
    width: int
    height: int
    channels: int
    split: str = "train"
    # per-view [near, far] depth bounds (LLFF, COLMAP); None for synthetic scenes
    near_far: "np.ndarray | None" = None
    # full pinhole intrinsics (fx, fy, cx, cy); None = the centred
    # isotropic pinhole of `focal`
    intrinsics: "tuple | None" = None

    @property
    def camera(self):
        """What camera_rays / pixel_rays take as `focal_px`."""
        return self.intrinsics if self.intrinsics is not None else self.focal

    def __len__(self) -> int:
        return self.images.shape[0]

    def composited(self, white_background: bool = True) -> np.ndarray:
        """RGB images with alpha composited over a white/black background."""
        if self.channels == 3:
            return self.images
        rgb, a = self.images[..., :3], self.images[..., 3:4]
        bg = 1.0 if white_background else 0.0
        return rgb * a + bg * (1.0 - a)


def load_images_json(scene_dir: str, split: str, srgb_to_linear: bool = False,
                     downscale: int = 1) -> ImageDataset:
    """transforms_{split}.json + its PNGs (`tnerf/data/dataset.py:71`)."""
    tf_path = os.path.join(scene_dir, f"transforms_{split}.json")
    with open(tf_path) as fh:
        meta = json.load(fh)
    if "camera_angle_x" not in meta and "fl_x" not in meta:
        raise ValueError(
            f"{tf_path} has neither camera_angle_x (NeRF-synthetic) nor "
            "fl_x (instant-ngp style) — cannot derive a camera"
        )
    paths: List[str] = []
    poses: List[np.ndarray] = []
    for frame in meta["frames"]:
        img_path = os.path.join(scene_dir, frame["file_path"])
        if not os.path.splitext(img_path)[1]:
            img_path += ".png"
        paths.append(img_path)
        poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))
    images_arr = np.stack(
        [read_png(p, channels=4, srgb_to_linear=srgb_to_linear) for p in paths]
    ).astype(np.float32)
    if downscale > 1:
        n, h, w, c = images_arr.shape
        images_arr = images_arr.reshape(
            n, h // downscale, downscale, w // downscale, downscale, c
        ).mean(axis=(2, 4))
    poses_arr = np.stack(poses)
    h, w = images_arr.shape[1:3]
    intrinsics = None
    if "fl_x" in meta:
        # instant-ngp intrinsics, stated at the original resolution
        fx = float(meta["fl_x"])
        fy = float(meta.get("fl_y", fx))
        cx = float(meta.get("cx", 0.5 * w * downscale))
        cy = float(meta.get("cy", 0.5 * h * downscale))
        d = float(max(downscale, 1))
        fx, fy, cx, cy = fx / d, fy / d, cx / d, cy / d
        focal = fx
        if not (fx == fy and cx == 0.5 * w and cy == 0.5 * h):
            intrinsics = (fx, fy, cx, cy)
    else:
        focal = focal_from_angle(w, float(meta["camera_angle_x"]))
    return ImageDataset(
        images=images_arr, poses=poses_arr, focal=focal,
        width=w, height=h, channels=images_arr.shape[-1], split=split,
        intrinsics=intrinsics,
    )


def load_synthetic_scene(root: str, name: str, srgb_to_linear: bool = False,
                         downscale: int = 1, splits=SPLITS) -> Dict[str, ImageDataset]:
    """The named splits of a NeRF-synthetic-format scene under root/name
    (`tnerf/data/dataset.py:144`): any directory in that layout loads."""
    scene_dir = os.path.join(root, name)
    if not os.path.isdir(scene_dir) and name not in SYNTHETIC_SCENES:
        raise ValueError(
            f"unknown synthetic scene {name!r}: no directory {scene_dir} "
            f"and not one of the standard scenes {SYNTHETIC_SCENES}"
        )
    out = {}
    for split in splits:
        if os.path.exists(os.path.join(scene_dir, f"transforms_{split}.json")):
            out[split] = load_images_json(
                scene_dir, split, srgb_to_linear=srgb_to_linear, downscale=downscale
            )
    if not out:
        raise FileNotFoundError(f"no transforms_*.json under {scene_dir}")
    return out


def scene_proc_kwargs(scene_cfg) -> Dict[str, int]:
    """generate_procedural_scene overrides from a SceneConfig's proc_*
    fields (0 = keep the library default)."""
    out = {}
    for n in ("width", "height", "n_train", "n_val", "n_test", "n_samples"):
        v = getattr(scene_cfg, f"proc_{n}", 0)
        if v:
            out[n] = int(v)
    return out


def scene_llff_kwargs(scene_cfg) -> Dict[str, float]:
    """load_llff_scene / load_colmap_scene preprocessing from a SceneConfig
    (`tnerf/data/dataset.py:191`): pose recentering and the bd_factor
    rescale, the NDC prerequisites."""
    out: Dict[str, float] = {}
    if getattr(scene_cfg, "llff_recenter", False):
        out["recenter"] = True
    v = getattr(scene_cfg, "llff_bd_rescale", 0.0)
    if v:
        out["bd_rescale"] = float(v)
    return out


def load_data(kind: str, name: str, root: str = "./data/nerf_synthetic",
              srgb_to_linear: bool = False, downscale: int = 1,
              splits: Sequence[str] = SPLITS, proc: Optional[Dict[str, int]] = None,
              llff: Optional[Dict[str, float]] = None, device="cuda") -> Dict[str, ImageDataset]:
    """The splits of a scene (`tnerf/data/dataset.py:203`).  `proc`
    (scene_proc_kwargs) sizes a procedural scene, whose ground truth is
    rendered on `device` (the images come back as numpy); `llff`
    (scene_llff_kwargs) preprocesses LLFF and COLMAP poses.  A
    NeRF-synthetic or procedural scene loads the `splits` named; LLFF and
    COLMAP scenes split one image set (every 8th view is a test view) and
    return both of their splits."""
    if kind == "nerf_synthetic":
        return load_synthetic_scene(root, name, srgb_to_linear, downscale, splits)
    if kind == "llff":
        from tnerf_torch.data.llff import load_llff_scene

        return load_llff_scene(root, name, srgb_to_linear=srgb_to_linear, downscale=downscale,
                               **(llff or {}))
    if kind == "colmap":
        from tnerf_torch.data.colmap import load_colmap_scene

        return load_colmap_scene(root, name, srgb_to_linear=srgb_to_linear, downscale=downscale,
                                 **(llff or {}))
    if kind == "procedural":
        from tnerf_torch.data.procedural import generate_procedural_scene

        return generate_procedural_scene(name, splits=splits, device=device, **(proc or {}))
    raise ValueError(f"unknown dataset kind {kind!r}")


def validate_scene_background(kind: str, name: str, white_background: bool) -> None:
    """Procedural GT is composited over its intrinsic background; a
    config that disagrees would compare against the wrong targets."""
    if kind != "procedural":
        return
    from tnerf_torch.data.procedural import scene_background

    want = scene_background(name)
    if white_background != want:
        raise ValueError(
            f"procedural scene {name!r} has a {'white' if want else 'black'} "
            f"background baked into its GT images; set scene.white_background={want}"
        )
