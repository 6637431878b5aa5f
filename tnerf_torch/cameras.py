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

import numpy as np
import torch


class Rays(NamedTuple):
    """A bundle of rays. Leading dims are arbitrary batch dims."""

    origins: torch.Tensor      # [..., 3]
    directions: torch.Tensor   # [..., 3] unit vectors (not under the NDC warp)
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


def _divider(dev, eager: bool):
    """x -> x / c for a constant c, as the reference computes it at that
    site: jitted (its training step), XLA multiplies by RN(1 / c)
    (`grid/traversal.py:reciprocal`); eager (its eval), the divisor is an
    argument and the division is exact.  Both as tensors on dev, so the
    CPU and the card agree (PyTorch divides exactly by a Python scalar on
    the CPU and multiplies by its reciprocal on the card)."""
    from tnerf_torch.grid.traversal import reciprocal

    if eager:
        return lambda x, c: x / torch.tensor(c, dtype=torch.float32, device=dev)
    return lambda x, c: x * reciprocal(c, dev)


def _ndc_origin(o, f: float, near: float, shift: float, half: float, eager: bool, div):
    """(f o / near + shift) / half, an NDC origin term.  Eager, as written.
    Jitted, the reference's XLA also folds the constant factors of a
    product chain, x * c1 * c2 -> x * RN(c1 c2): o * RN(f * RN(1 / near)),
    and where shift rounds to 0 (the add is dropped) RN(1 / half) joins
    the same constant (a centred principal point: LLFF, and COLMAP's
    PINHOLE with cx = W/2)."""
    if eager:
        return div(div(f * o, near) + shift, half)
    one = np.float32(1.0)
    c = np.float32(f) * (one / np.float32(near))
    if np.float32(shift) == 0:
        return o * torch.tensor(c * (one / np.float32(half)), device=o.device)
    return div(o * torch.tensor(c, device=o.device) + shift, half)


def ndc_warp(rays: Rays, width: int, height: int, focal_px, near: float = 1.0,
             eager: bool = False) -> Rays:
    """Warp forward-facing world rays into NDC space (`tnerf/cameras.py:164`):
    the frustum beyond the z = -near plane of a camera at the origin
    looking down -z maps onto [-1, 1]^3, the grid's box; warped t runs over
    [0, 1] (near plane to infinity).  Full (fx, fy, cx, cy) intrinsics: the
    principal point shifts the origin terms (with + in x, - in y, as pixel
    rows run down) and cancels in the directions.  Directions are not unit
    vectors; viewdirs_tp stays the world direction.  Rays with d_z >= 0 are
    clamped to a slope of -1e-8.

    The divisions by the constants near, W/2 and H/2 follow the site the
    reference runs the warp from (`_divider`): eager=False as its jitted
    training step (`tnerf/train.py:256`, `:360`), eager=True as its eval
    and CLI (`tnerf/eval.py:85`, `tnerf/cli.py:389`, `:515`)."""
    fx, fy, cx, cy = resolve_intrinsics(width, height, focal_px)
    wx, wy = 0.5 * width, 0.5 * height
    o, d = rays.origins, rays.directions
    div = _divider(o.device, eager)
    dz = torch.clamp_max(d[..., 2], -1e-8)
    # slide the origins onto the near plane: o_z + t_n d_z == -near
    t_n = -(near + o[..., 2]) / dz
    o = o + t_n[..., None] * d
    ox, oy = o[..., 0], o[..., 1]
    dx, dy = d[..., 0], d[..., 1]
    o0 = _ndc_origin(ox, fx, near, cx - wx, wx, eager, div)
    o1 = _ndc_origin(oy, fy, near, -(cy - wy), wy, eager, div)
    d0 = -(fx / wx) * (dx / dz + div(ox, near))
    d1 = -(fy / wy) * (dy / dz + div(oy, near))
    return Rays(
        origins=torch.stack([o0, o1, torch.full_like(ox, -1.0)], dim=-1),
        directions=torch.stack([d0, d1, torch.full_like(ox, 2.0)], dim=-1),
        viewdirs_tp=rays.viewdirs_tp,
    )


def se3_exp(delta: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map (`tnerf/cameras.py:232`): delta [..., 6] = (w
    rotation, v translation) -> [..., 4, 4].  Closed-form Rodrigues whose
    coefficients switch to their Taylor series below theta^2 = 1e-8, with
    a safe denominator in the other branch, so that the gradient at delta
    = 0 (where pose refinement starts) is finite."""
    w, v = delta[..., :3], delta[..., 3:]
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (t2s * t))
    zeros = torch.zeros_like(w[..., 0])
    W = torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device).expand(W.shape)
    # float32 broadcast-and-sum products, as the reference's geometry
    W2 = torch.sum(W[..., :, :, None] * W[..., None, :, :], dim=-2)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    tr = torch.sum(V * v[..., None, :], dim=-1)
    top = torch.cat([R, tr[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=delta.dtype, device=delta.device) \
        .expand(*delta.shape[:-1], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def compose_pose(t_world: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """t_world @ pose as a float32 broadcast-and-sum (`tnerf/cameras.py:272`)."""
    return torch.sum(t_world[..., :, :, None] * pose[..., None, :, :], dim=-2)
