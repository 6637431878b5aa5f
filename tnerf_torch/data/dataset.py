"""Image datasets (counterpart of `tnerf/data/dataset.py`, procedural
scenes only for now: the NeRF-synthetic, LLFF and COLMAP readers are
still to be ported, see ROADMAP.md)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

SPLITS = ("train", "val", "test")


@dataclass
class ImageDataset:
    """One split of one scene."""

    images: np.ndarray   # [N, H, W, C] float32 in [0,1]
    poses: np.ndarray    # [N, 4, 4] float32 camera-to-world
    focal: float         # pixels
    width: int
    height: int
    channels: int
    split: str = "train"
    near_far: "np.ndarray | None" = None
    intrinsics: "tuple | None" = None

    @property
    def camera(self):
        """What camera_rays takes as `focal_px`."""
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


def scene_proc_kwargs(scene_cfg) -> Dict[str, int]:
    """generate_procedural_scene overrides from a SceneConfig's proc_*
    fields (0 = keep the library default)."""
    out = {}
    for n in ("width", "height", "n_train", "n_val", "n_test", "n_samples"):
        v = getattr(scene_cfg, f"proc_{n}", 0)
        if v:
            out[n] = int(v)
    return out


def load_data(kind: str, name: str, splits: Sequence[str] = SPLITS,
              proc: Optional[Dict[str, int]] = None, device="cuda") -> Dict[str, ImageDataset]:
    """The named splits of a scene; `device` is where a procedural
    scene's ground truth is rendered (the images come back as numpy)."""
    if kind == "procedural":
        from tnerf_torch.data.procedural import generate_procedural_scene

        return generate_procedural_scene(name, splits=splits, device=device, **(proc or {}))
    raise NotImplementedError(
        f"scene.kind={kind!r} is not yet ported to tnerf_torch (procedural "
        "scenes only), see ROADMAP.md"
    )


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
