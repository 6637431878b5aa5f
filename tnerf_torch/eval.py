"""Evaluation: PSNR / SSIM over held-out splits and images to write
(counterpart of `tnerf/eval.py` and `tnerf/train.py:psnr`).

Metrics are computed on the host in float64 numpy, as the reference
does, so both packages score an image the same way."""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from tnerf_torch.cameras import camera_rays, compose_pose, ndc_warp, se3_exp
from tnerf_torch.data.dataset import ImageDataset
from tnerf_torch.device import resolve_device
from tnerf_torch.render.composite import RenderResult
from tnerf_torch.render.renderer import render_image


def psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def ssim(pred: np.ndarray, gt: np.ndarray, window: int = 11, sigma: float = 1.5) -> float:
    """Structural similarity (11x11 gaussian window, L=1, k1=0.01,
    k2=0.03), in numpy as the reference computes it."""
    a = np.asarray(pred, np.float64)
    b = np.asarray(gt, np.float64)
    r = window // 2
    x = np.arange(window) - r
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()

    def blur(img):  # separable gaussian over H, W for each channel
        out = np.apply_along_axis(lambda v: np.convolve(v, g, mode="same"), 0, img)
        return np.apply_along_axis(lambda v: np.convolve(v, g, mode="same"), 1, out)

    mu_a, mu_b = blur(a), blur(b)
    sa = blur(a * a) - mu_a ** 2
    sb = blur(b * b) - mu_b ** 2
    sab = blur(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (sa + sb + c2)
    )
    return float(s[r:-r, r:-r].mean())


def render_pose_result(renderer, params, pose, width: int, height: int, camera,
                       scene_scale: float, chunk_size: int = 65536, occupancy=None,
                       device="cuda", ndc_near=None, pose_delta=None, mesh=None) -> RenderResult:
    """Full RenderResult of one camera pose, as host numpy arrays.
    pose_delta: an [6] SE(3) delta composed onto the pose first (a train
    view of a pose-refined checkpoint, `cli render --refined-poses`);
    ndc_near: scene.ndc's near plane (None = off), the rays warped as the
    reference's eval warps them (`cameras.ndc_warp`, eager=True).  mesh:
    the rays of each chunk split over its "data" axis (`render_image`)."""
    dev = resolve_device(device)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    if pose_delta is not None:
        delta = torch.as_tensor(pose_delta, dtype=torch.float32, device=dev)
        pose = compose_pose(se3_exp(delta), pose)
    rays = camera_rays(pose, width, height, camera, scene_scale, device=dev)
    if ndc_near is not None:
        rays = ndc_warp(rays, width, height, camera, ndc_near, eager=True)
    res = render_image(renderer, params, rays, chunk_size=chunk_size, occupancy=occupancy,
                       mesh=mesh)
    return RenderResult(*(a.cpu().numpy() for a in res))


def render_dataset_view_result(renderer, params, dataset: ImageDataset, index: int,
                               scene_scale: float, chunk_size: int = 65536,
                               occupancy=None, device="cuda", ndc_near=None,
                               pose_delta=None, mesh=None) -> RenderResult:
    """RenderResult (rgb + acc + expected depth) of one dataset pose, as
    host numpy arrays (`tnerf/eval.py:54`)."""
    return render_pose_result(renderer, params, dataset.poses[index], dataset.width,
                              dataset.height, dataset.camera, scene_scale,
                              chunk_size=chunk_size, occupancy=occupancy, device=device,
                              ndc_near=ndc_near, pose_delta=pose_delta, mesh=mesh)


def render_dataset_view(renderer, params, dataset: ImageDataset, index: int,
                        scene_scale: float, chunk_size: int = 65536, occupancy=None,
                        device="cuda", ndc_near=None, mesh=None) -> np.ndarray:
    return render_dataset_view_result(renderer, params, dataset, index, scene_scale,
                                      chunk_size, occupancy, device, ndc_near,
                                      mesh=mesh).rgb


def hit_depths(depth: np.ndarray, acc: np.ndarray, acc_threshold: float = 0.1) -> tuple:
    """(hit_mask, E[t | hit]) per pixel."""
    depth = np.asarray(depth, np.float32)
    acc = np.asarray(acc, np.float32)
    hit = acc > acc_threshold
    return hit, np.where(hit, depth / np.maximum(acc, 1e-6), 0.0)


def depth_image(depth: np.ndarray, acc: np.ndarray, near: Optional[float] = None,
                far: Optional[float] = None, acc_threshold: float = 0.1) -> np.ndarray:
    """Expected-termination depth as an inverted-grayscale [H, W, 3] image
    (near = bright, background = black); pixels with acc above the
    threshold are normalized by their opacity, the rest are background.
    Without [near, far] the range is the opaque pixels' min/max."""
    hit, t_hit = hit_depths(depth, acc, acc_threshold)
    if near is None:
        near = float(t_hit[hit].min()) if hit.any() else 0.0
    if far is None:
        far = float(t_hit[hit].max()) if hit.any() else 1.0
    x = (t_hit - near) / max(far - near, 1e-6)
    g = np.where(hit, 1.0 - np.clip(x, 0.0, 1.0), 0.0).astype(np.float32)
    return np.repeat(g[..., None], 3, axis=-1)


def acc_image(acc: np.ndarray) -> np.ndarray:
    """Accumulated opacity as an [H, W, 3] image in [0, 1]."""
    g = np.clip(np.asarray(acc, np.float32), 0.0, 1.0)
    return np.repeat(g[..., None], 3, axis=-1)


def evaluate(renderer, params, dataset: ImageDataset, scene_scale: float,
             white_background: bool = True, max_views: Optional[int] = None,
             save_dir: Optional[str] = None, chunk_size: int = 65536, occupancy=None,
             device="cuda", ndc_near=None, mesh=None) -> Dict[str, float]:
    """Mean PSNR / SSIM over (up to max_views of) a split, and the mean
    host-clock time to render a view (rays to host numpy); optionally
    write each view's render as <save_dir>/<split>_###.png.  mesh: every
    rank of it calls this alike, each rendering its share of every chunk
    (`render_image`); pass save_dir on one rank only."""
    gt = dataset.composited(white_background)
    n = len(dataset) if max_views is None else min(max_views, len(dataset))
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    psnrs, ssims, frames, ms = [], [], [], []
    for i in range(n):
        t0 = time.perf_counter()
        # the copy to host numpy waits for the device, so this times the view
        pred = render_dataset_view(renderer, params, dataset, i, scene_scale, chunk_size,
                                   occupancy=occupancy, device=device, ndc_near=ndc_near,
                                   mesh=mesh)
        ms.append((time.perf_counter() - t0) * 1e3)
        psnrs.append(psnr(pred, gt[i]))
        ssims.append(ssim(pred, gt[i]))
        if save_dir:
            frames.append(pred)
    if save_dir and frames:
        from tnerf_torch.data.png_io import write_png_batch

        write_png_batch([os.path.join(save_dir, f"{dataset.split}_{i:03d}.png")
                         for i in range(n)], frames)
    return {
        f"psnr_{dataset.split}": float(np.mean(psnrs)),
        f"psnr_{dataset.split}_min": float(np.min(psnrs)),
        f"ssim_{dataset.split}": float(np.mean(ssims)),
        f"n_views_{dataset.split}": float(n),
        f"render_ms_{dataset.split}": float(np.mean(ms)),
    }
