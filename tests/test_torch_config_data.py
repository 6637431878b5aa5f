"""The port's own copies of the config tree, cameras and procedural
scenes agree with the reference package (numpy-seeded inputs, CPU)."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tnerf.config as jcfg
import tnerf_torch.config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    glob.glob(os.path.join(REPO, "configs", "*.json"))
    + glob.glob(os.path.join(REPO, "runs", "**", "config.json"), recursive=True)
)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_config_files_mean_the_same(path):
    assert tcfg.Config.from_json_file(path).to_dict() == jcfg.Config.from_json_file(path).to_dict()


def test_config_defaults_and_overrides_mean_the_same():
    ov = ["render.ray_compact=false", "scene.proc_width=16", "grid.aabb_min=[-2,-1,-1]",
          "train.lr=0.5", "render.fused_tighten=0", "sampler.placement=occupancy_cdf"]
    assert tcfg.Config().to_dict() == jcfg.Config().to_dict()
    assert tcfg.Config().apply_overrides(ov).to_dict() == jcfg.Config().apply_overrides(ov).to_dict()
    with pytest.raises(KeyError):
        tcfg.Config().apply_overrides(["render.no_such_key=1"])


def test_camera_rays_match_reference():
    from tnerf.cameras import camera_rays as j_rays
    from tnerf.data.procedural import sphere_poses as j_poses
    from tnerf_torch.cameras import camera_rays as t_rays
    from tnerf_torch.data.procedural import sphere_poses as t_poses

    pose = t_poses(3, seed=30)[1]
    np.testing.assert_array_equal(pose, j_poses(3, seed=30)[1])
    jr = j_rays(jnp.asarray(pose), 40, 30, 52.5, 0.8)
    tr = t_rays(pose, 40, 30, 52.5, 0.8, device="cpu")
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_procedural_ground_truth_matches_reference():
    """prims at 24x24 with a 64-sample GT march (atol 1e-5: float32
    quadrature, summed in another order)."""
    from tnerf.data.procedural import generate_procedural_scene as j_gen
    from tnerf_torch.data.procedural import generate_procedural_scene as t_gen

    kw = dict(width=24, height=24, n_train=0, n_val=1, n_test=2, n_samples=64)
    js = j_gen("prims", **kw)
    ts = t_gen("prims", device="cpu", **kw)
    assert sorted(ts) == sorted(js) == ["test", "val"]
    for split in js:
        assert ts[split].focal == js[split].focal
        np.testing.assert_array_equal(ts[split].poses, js[split].poses)
        np.testing.assert_allclose(ts[split].images, js[split].images, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["rings", "layers"])
def test_suite_fields_match_reference(name):
    """The other committed suite scenes' analytic fields (atol 1e-5)."""
    from tnerf.data.procedural import FIELDS as J
    from tnerf_torch.data.procedural import FIELDS as T

    x = np.random.default_rng(0).uniform(-1, 1, (4096, 3)).astype(np.float32)
    jr, js = J[name](jnp.asarray(x))
    tr, ts = T[name](torch.from_numpy(x))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5 * 45, rtol=1e-5)


def test_png_writer_round_trips(tmp_path):
    from tnerf.data.png_io import read_png
    from tnerf_torch.data.png_io import write_png

    img = np.random.default_rng(1).uniform(0, 1, (9, 7, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    back = read_png(path, channels=3)
    np.testing.assert_allclose(back, np.round(np.clip(img, 0, 1) * 255) / 255, atol=1 / 255 + 1e-6)
