"""Camera models and ray generation (counterpart of `tnerf/cameras.py`).

OpenGL/NeRF convention: the camera looks down -z, x right, y up; pixel
(i, j) maps to the direction R @ [(i - cx + 0.5)/fx, -(j - cy + 0.5)/fy, -1].
View directions are also given as the reference's (theta, phi):
theta = atan2(sqrt(dx^2 + dy^2), dz), phi = atan2(dy, dx).

Everything is float32 on the device of its inputs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Rays(NamedTuple):
    """A bundle of rays. Leading dims are arbitrary batch dims."""

    origins: torch.Tensor      # [..., 3]
    directions: torch.Tensor   # [..., 3] unit vectors
    viewdirs_tp: torch.Tensor  # [..., 2] (theta, phi)


def focal_from_angle(width: int, camera_angle_x: float) -> float:
    """Pixel focal length from the horizontal field of view."""
    return 0.5 * float(width) / math.tan(0.5 * float(camera_angle_x))


def resolve_intrinsics(width: int, height: int, focal) -> tuple:
    """(fx, fy, cx, cy) from a scalar pixel focal (centered isotropic
    pinhole) or a 4-tuple (fx, fy, cx, cy)."""
    if isinstance(focal, (tuple, list)):
        if len(focal) != 4:
            raise ValueError(f"focal tuple must be (fx, fy, cx, cy), got {focal!r}")
        fx, fy, cx, cy = (float(v) for v in focal)
        return fx, fy, cx, cy
    return focal, focal, 0.5 * width, 0.5 * height


def pixel_directions_cam(width: int, height: int, focal_px, device="cpu") -> torch.Tensor:
    """[H, W, 3] camera-space ray directions (not normalized); pixel
    centers at half-integer coordinates."""
    fx, fy, cx, cy = resolve_intrinsics(width, height, focal_px)
    i = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    j = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    jj, ii = torch.meshgrid(j, i, indexing="ij")  # [H, W]
    x = (ii - cx) / fx
    y = -(jj - cy) / fy
    z = -torch.ones_like(x)
    return torch.stack([x, y, z], dim=-1)


def viewdirs_to_thetaphi(directions: torch.Tensor) -> torch.Tensor:
    """(theta, phi) of unit directions [..., 3] -> [..., 2]."""
    dx, dy, dz = directions[..., 0], directions[..., 1], directions[..., 2]
    theta = torch.atan2(torch.sqrt(dx * dx + dy * dy), dz)
    phi = torch.atan2(dy, dx)
    return torch.stack([theta, phi], dim=-1)


def thetaphi_to_unit(tp: torch.Tensor) -> torch.Tensor:
    """Inverse of `viewdirs_to_thetaphi`: (theta, phi) [..., 2] -> unit
    directions [..., 3] (`tnerf/cameras.py:92`)."""
    theta, phi = tp[..., 0], tp[..., 1]
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1)


def camera_rays(pose, width: int, height: int, focal_px, scene_scale: float = 1.0,
                device=None) -> Rays:
    """All W*H rays of one camera; pose is a [4, 4] camera-to-world
    matrix (numpy or tensor).  Returns Rays with [H, W, ...] shape on
    `device` (default: the pose tensor's device, else the CPU)."""
    if device is None:
        device = pose.device if isinstance(pose, torch.Tensor) else "cpu"
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    dirs_cam = pixel_directions_cam(width, height, focal_px, device)
    rot = pose[:3, :3]
    # Elementwise broadcast-and-sum in float32, as the reference does:
    # the rotation must not go through a reduced-precision matmul.
    dirs_world = torch.sum(rot[None, None] * dirs_cam[..., None, :], dim=-1)
    dirs_world = dirs_world / torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
    origin = pose[:3, 3] * scene_scale
    return Rays(
        origins=origin.expand(dirs_world.shape).contiguous(),
        directions=dirs_world,
        viewdirs_tp=viewdirs_to_thetaphi(dirs_world),
    )


def pixel_rays(poses: torch.Tensor, pix_xy: torch.Tensor, width: int, height: int, focal_px,
               scene_scale: float = 1.0) -> Rays:
    """Rays of a flat batch of (pose, pixel) pairs, the training-batch path
    (`tnerf/cameras.py:129`).  poses [B, 4, 4] camera-to-world, already
    gathered per ray; pix_xy [B, 2] float pixel coordinates (x = column,
    y = row), centers at +0.5 as in `pixel_directions_cam`."""
    fx, fy, cx, cy = resolve_intrinsics(width, height, focal_px)
    x = (pix_xy[..., 0] + 0.5 - cx) / fx
    y = -(pix_xy[..., 1] + 0.5 - cy) / fy
    dirs_cam = torch.stack([x, y, -torch.ones_like(x)], dim=-1)
    # float32 broadcast-and-sum, as in camera_rays
    dirs_world = torch.sum(poses[..., :3, :3] * dirs_cam[..., None, :], dim=-1)
    dirs_world = dirs_world / torch.linalg.norm(dirs_world, dim=-1, keepdim=True)
    return Rays(
        origins=poses[..., :3, 3] * scene_scale,
        directions=dirs_world,
        viewdirs_tp=viewdirs_to_thetaphi(dirs_world),
    )
