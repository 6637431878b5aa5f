"""The serving slice end to end: the committed prims checkpoint rendered
by the reference's fused renderer (Pallas interpret mode) and by the
port's renderer on the CPU, the port's CLI, the device rule, and the
package's independence from JAX and from `tnerf`."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "suite_rehearsal", "prims")
CKPT = os.path.join(RUN, "checkpoints")
OVERRIDES = ["render.ray_compact=false", "scene.proc_width=32", "scene.proc_height=32"]


def test_slice_matches_reference_renderer():
    """512 rays of test view 0 at 32x32: rgb and acc within atol 5e-3
    (bf16 activations rounded in another order)."""
    from tnerf.cameras import Rays as JRays
    from tnerf.cli import _build_restore
    from tnerf.config import Config as JConfig
    from tnerf.train_loop import build_renderer as j_build
    from tnerf_torch.cameras import Rays, camera_rays, focal_from_angle
    from tnerf_torch.config import Config
    from tnerf_torch.data.procedural import CAMERA_ANGLE_X, sphere_poses
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    path = os.path.join(RUN, "config.json")
    jcfg = JConfig.from_json_file(path).apply_overrides(OVERRIDES)
    cfg = Config.from_json_file(path).apply_overrides(OVERRIDES)
    rays = camera_rays(sphere_poses(8, seed=30)[0], 32, 32, focal_from_angle(32, CAMERA_ANGLE_X),
                       device="cpu")
    flat = [a[8:24].reshape(512, a.shape[-1]) for a in rays]

    field, state, jocc, _, err = _build_restore(jcfg, CKPT, 0)
    assert err is None
    jres = j_build(jcfg, field, for_eval=True)(
        state.params, JRays(*(jnp.asarray(a.numpy()) for a in flat)), None, jocc.bitfield)

    _, params, occ = load_jax_checkpoint(CKPT, device="cpu")
    res = build_renderer(cfg)(params, Rays(*flat), renderer_payload(occ, cfg.sampler, cfg.grid))
    acc = res.acc.numpy()
    assert 0.1 < (acc > 0.5).mean() < 0.9  # the rays see object and background
    np.testing.assert_allclose(res.rgb.numpy(), np.asarray(jres.rgb), atol=5e-3, rtol=0)
    np.testing.assert_allclose(acc, np.asarray(jres.acc), atol=5e-3, rtol=0)


def test_cli_eval_on_cpu(capsys, tmp_path):
    from tnerf_torch.cli import main

    out = tmp_path / "metrics.json"
    rc = main(["eval", "--device", "cpu", "--config", os.path.join(RUN, "config.json"),
               "--checkpoint", CKPT, "--out", str(out),
               "-o", "render.ray_compact=false", "-o", "scene.proc_width=16",
               "-o", "scene.proc_height=16", "-o", "scene.proc_n_val=1", "-o", "scene.proc_n_test=2"])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(out.read_text())
    assert printed["n_views_test"] == 2.0 and printed["n_views_val"] == 1.0
    assert 25.0 < printed["psnr_test"] < 60.0 and 0.5 < printed["ssim_test"] <= 1.0


def test_cli_render_orbit_on_cpu(capsys, tmp_path):
    from tnerf.data.png_io import read_png
    from tnerf_torch.cli import main

    rc = main(["render", "--device", "cpu", "--config", os.path.join(RUN, "config.json"),
               "--checkpoint", CKPT, "--orbit", "2", "--channels", "rgb,depth",
               "--out", str(tmp_path / "orbit"), "-o", "render.ray_compact=false",
               "-o", "scene.proc_width=16", "-o", "scene.proc_height=16", "-o", "scene.proc_n_test=2"])
    assert rc == 0
    timing = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert timing["frames"] == 2 and timing["device"] == "cpu"
    for i in range(2):
        for suffix in ("", "_depth"):
            img = read_png(str(tmp_path / "orbit" / f"orbit_{i:03d}{suffix}.png"), channels=3)
            assert img.shape == (16, 16, 3)
    assert img.max() > img.min()


@pytest.mark.parametrize("override", [
    "render.pipeline=grid_march", "render.pipeline=grid_intervals",
    "field_.view_encoding=sh", "field_.encoding=hashgrid", "scene.kind=nerf_synthetic",
    "scene.ndc=true",
])
def test_unported_options_are_refused(override):
    from tnerf_torch.config import Config
    from tnerf_torch.train_loop import build_renderer

    cfg = Config.from_json_file(os.path.join(RUN, "config.json")).apply_overrides(
        ["render.ray_compact=false", override])
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_renderer(cfg)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the request for it is served")
    from tnerf_torch.cli import main
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    with pytest.raises(RuntimeError, match="cuda"):
        load_jax_checkpoint(CKPT)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["eval", "--config", os.path.join(RUN, "config.json"), "--checkpoint", CKPT,
              "-o", "render.ray_compact=false"])


def test_port_imports_neither_jax_nor_tnerf():
    code = (
        "import importlib, pkgutil, sys, tnerf_torch\n"
        "for m in pkgutil.walk_packages(tnerf_torch.__path__, 'tnerf_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'jaxlib', 'tnerf')\n"
        "             or k.startswith(('jax.', 'jaxlib.', 'tnerf.')))\n"
        "print(len([k for k in sys.modules if k.startswith('tnerf_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 29  # tnerf_torch.sampling and every other module
