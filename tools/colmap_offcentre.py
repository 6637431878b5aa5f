"""A COLMAP capture whose principal point is off the image centre.

Every other committed capture has cx = W/2, cy = H/2, where the NDC warp
of a training step folds its constants into one product; with a shift the
add stays and the warp runs another arithmetic.  This tool exports such a
capture from the procedural prims field, as tools/colmap_rehearsal.py
exports data/colmap/prims_cm:

1. renders a forward-facing pool of procedural GT views (landscape
   240x180) through a PINHOLE camera with fx != fy and the principal
   point at (W/2 + 17.5, H/2 - 11.25),
2. writes it as a COLMAP sparse text model (sparse/0 + images/) with
   `export_colmap_format`, then states the camera's own intrinsics in
   cameras.txt (the exporter writes a centred pinhole of one focal),
3. loads it back through the COLMAP reader (holdout split, recentring,
   bd_rescale) and prints the splits and intrinsics.

Usage:   python tools/colmap_offcentre.py [--skip-export]
Outputs: data/colmap/prims_oc/ (committed).  Training it: the config
written by `config_overrides()`, e.g. `python -m tnerf_torch.cli train
--config runs/colmap_rehearsal/config.json -o scene.name=prims_oc
-o scene.root=data/colmap -o train.steps=300 --out <dir>`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DATA_ROOT = os.path.join(REPO, "data", "colmap")
SCENE = "prims_oc"
W, H = 240, 180
N_VIEWS = 18  # holdout_every=8 -> 3 test views (0, 8, 16)
NEAR, FAR = 2.0, 5.5
SHIFT_X, SHIFT_Y = 17.5, -11.25  # principal point minus the image centre, pixels
ASPECT_Y = 1.04  # fy / fx


def intrinsics():
    """(fx, fy, cx, cy) of the capture's camera."""
    from tnerf.cameras import focal_from_angle
    from tnerf.data.procedural import CAMERA_ANGLE_X

    fx = float(focal_from_angle(W, CAMERA_ANGLE_X))
    return fx, fx * ASPECT_Y, W / 2.0 + SHIFT_X, H / 2.0 + SHIFT_Y


def export_scene():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tnerf.data.dataset import ImageDataset
    from tnerf.data.procedural import (
        _render_gt_image,
        export_colmap_format,
        frontal_poses,
        scene_background,
    )

    scene_dir = os.path.join(DATA_ROOT, SCENE)
    t0 = time.perf_counter()
    cam = intrinsics()
    poses = frontal_poses(N_VIEWS, radius=3.5, seed=40)
    # the GT renderer unjitted: its jit traces the focal, and a traced
    # (fx, fy, cx, cy) cannot be read as the intrinsics
    render = _render_gt_image.__wrapped__
    imgs = [np.asarray(jax.device_get(render(
        jnp.asarray(p), W, H, cam, NEAR, FAR, 384, scene_background("prims"),
        field_name="prims")), np.float32) for p in poses]
    pool = ImageDataset(images=np.clip(np.stack(imgs), 0.0, 1.0), poses=poses, focal=cam[0],
                        width=W, height=H, channels=3, split="all")
    export_colmap_format(pool, scene_dir, field_name="prims")
    with open(os.path.join(scene_dir, "sparse", "0", "cameras.txt"), "w") as fh:
        fh.write("# Camera list: CAMERA_ID MODEL W H fx fy cx cy\n")
        fh.write(f"1 PINHOLE {W} {H} " + " ".join(f"{v:.17g}" for v in cam) + "\n")
    print(f"[export] {SCENE}: {N_VIEWS} views {W}x{H}, intrinsics {cam}, in "
          f"{time.perf_counter() - t0:.1f} s -> {scene_dir}")


def load_scene():
    from tnerf.data.dataset import load_data

    ds = load_data("colmap", SCENE, root=DATA_ROOT, llff={"recenter": True, "bd_rescale": 0.75})
    for split, d in ds.items():
        print(f"[loader] {SCENE} {split}: {len(d)} views {d.width}x{d.height}, intrinsics "
              f"{d.intrinsics}, near/far [{float(d.near_far.min()):.4f}, "
              f"{float(d.near_far.max()):.4f}]")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-export", action="store_true")
    args = ap.parse_args()
    if not args.skip_export:
        export_scene()
    load_scene()


if __name__ == "__main__":
    main()
