"""Renderer construction and sampler-range resolution (the parts of
`tnerf/train_loop.py` the serving path uses; the training loop belongs to
the training slice, see ROADMAP.md)."""

from __future__ import annotations

import dataclasses

import numpy as np

from tnerf_torch.config import Config
from tnerf_torch.data.dataset import ImageDataset
from tnerf_torch.render.fused import make_fused_renderer, refuse_unported


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to tnerf_torch, see ROADMAP.md")


def validate_ported(cfg: Config) -> None:
    """Refuse every option this slice does not run, rather than running
    another path in its place."""
    if cfg.render.pipeline != "fused":
        raise _not_ported(f"render.pipeline={cfg.render.pipeline!r} (fused only)")
    if cfg.field_.encoding != "frequency":
        raise _not_ported(f"field_.encoding={cfg.field_.encoding!r} (frequency only)")
    if cfg.field_.view_encoding != "frequency":
        raise _not_ported(f"field_.view_encoding={cfg.field_.view_encoding!r} (frequency only)")
    if cfg.scene.kind != "procedural":
        raise _not_ported(f"scene.kind={cfg.scene.kind!r} (procedural scenes only)")
    if cfg.scene.ndc:
        raise _not_ported("scene.ndc=true")
    refuse_unported(cfg.sampler, cfg.render)


def build_renderer(cfg: Config, for_eval: bool = True):
    """The fused renderer of `cfg` (`tnerf/train_loop.py:70`, fused
    branch).  Only eval/render renderers exist until the training slice."""
    if not for_eval:
        raise _not_ported("training (for_eval=False)")
    if cfg.scene.white_background != cfg.render.white_background:
        raise ValueError(
            "scene.white_background and render.white_background disagree "
            f"({cfg.scene.white_background} vs {cfg.render.white_background}): "
            "set both to the same value"
        )
    validate_ported(cfg)
    return make_fused_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render,
                               tighten=cfg.render.fused_tighten)


def resolve_near_far(cfg: Config, dataset: ImageDataset) -> Config:
    """Resolve sampler.near/far = -1 (auto) from the dataset's per-view
    depth bounds: near = 0.9 min, far = 1.1 max, in scene_scale units
    (`tnerf/train_loop.py:194`).  No-op when both are explicit."""
    if cfg.sampler.near >= 0 and cfg.sampler.far >= 0:
        return cfg
    if dataset.near_far is None:
        raise ValueError(
            "sampler.near/far=-1 (auto) needs a dataset with per-view depth "
            "bounds; this scene has none — set explicit sampler.near and sampler.far"
        )
    lo = float(np.min(dataset.near_far)) * cfg.scene.scene_scale
    hi = float(np.max(dataset.near_far)) * cfg.scene.scene_scale
    near = 0.9 * lo if cfg.sampler.near < 0 else cfg.sampler.near
    far = 1.1 * hi if cfg.sampler.far < 0 else cfg.sampler.far
    return dataclasses.replace(cfg, sampler=dataclasses.replace(cfg.sampler, near=near, far=far))
