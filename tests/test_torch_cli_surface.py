"""The port's `cli config`, `cli suite` and `render --gif` against the
reference package's CLI on the CPU:

- `Config.diff_overrides` over every committed configs/*.json and
  runs/**/config.json equal to the reference's list, and fed back through
  `apply_overrides` the same `to_dict()`; `config [--diff]` prints what
  `tnerf.cli config` prints;
- `suite` of a tiny trained scene pair (uniform pipeline, with a weight
  EMA, so that both packages read `eval_params`) and a missing scene:
  the same scenes evaluated, each test PSNR within 0.05 dB of the
  reference's (the field's bf16 products summed in another order), the
  missing scene skipped by both, the renders written;
- `render --orbit 3 --gif`: the standard-library GIF decoded by PIL (in
  the test only) frame for frame within a mean of 1.5 and a maximum of 40
  levels of 255 of the PNG frames (the writer's median cut to 256
  colours; exact where a frame has no more); every frame decodes to
  exactly the palette colours the writer chose.
"""

import contextlib
import glob
import io
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    glob.glob(os.path.join(REPO, "configs", "*.json"))
    + glob.glob(os.path.join(REPO, "runs", "**", "config.json"), recursive=True)
)
TINY = ["scene.kind=procedural", "scene.scene_scale=1.0", "scene.proc_width=24",
        "scene.proc_height=24", "scene.proc_n_train=3", "scene.proc_n_val=1",
        "scene.proc_n_test=2", "scene.proc_n_samples=32", "render.pipeline=uniform",
        "sampler.samples_per_ray=16", "sampler.near=2.0", "sampler.far=5.5",
        "field_.hidden_width=16", "field_.hidden_layers=1", "field_.n_frequencies=2",
        "train.batch_size=128", "train.steps=12", "train.lr=5e-3", "train.eval_every=0",
        "train.checkpoint_every=12", "train.log_every=6", "train.param_ema=0.5",
        "render.chunk_size=576"]
SUITE_PSNR_TOL_DB = 0.05

torch.set_num_threads(2)


def _run(main, argv):
    """(exit status, standard output, standard error) of a CLI's main."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_diff_overrides_match_the_reference_on_every_committed_config():
    from tnerf.config import Config as JConfig
    from tnerf_torch.config import Config

    assert len(CONFIGS) > 40
    for path in CONFIGS:
        got = Config.from_json_file(path).diff_overrides()
        assert got == JConfig.from_json_file(path).diff_overrides(), path
        assert Config().apply_overrides(got).to_dict() == \
            Config.from_json_file(path).to_dict(), path


@pytest.mark.parametrize("argv", [["--diff"], [], ["-o", "train.steps=7", "--diff"]])
def test_cli_config_prints_what_the_reference_prints(argv):
    from tnerf.cli import main as j_main
    from tnerf_torch.cli import main

    for path in (os.path.join(REPO, "configs", "procedural_hard_30db.json"),
                 os.path.join(REPO, "runs", "pose_refinement_barf_unit", "config.json"), None):
        args = ["config"] + (["--config", path] if path else []) + argv
        got = _run(main, args)
        assert got == _run(j_main, args) and got[0] == 0
        assert bool(got[1].strip()) == bool(path or argv != ["--diff"])


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """<root>/prims and <root>/rings, each a tiny model trained by the port
    (uniform pipeline, weight EMA 0.5), with the run's config."""
    from tnerf_torch.config import Config
    from tnerf_torch.train_loop import run_training

    root = tmp_path_factory.mktemp("suite")
    for name in ("prims", "rings"):
        run_training(Config().apply_overrides(TINY + [f"scene.name={name}",
                                                      f"logging.out_dir={root / name}"]),
                     device="cpu")
    return root


def test_suite_matches_the_reference_suite(scenes):
    """`suite --scenes prims,missing,rings` in both packages on the port's
    checkpoints: the same scenes, each within SUITE_PSNR_TOL_DB of the
    reference, SSIM within 1e-3, the missing scene skipped, the mean the
    mean of the scenes, each scene's renders in suite_renders."""
    from tnerf.cli import main as j_main
    from tnerf_torch.cli import main

    argv = ["suite", "--config", str(scenes / "prims" / "config.json"), "-o",
            f"logging.out_dir={scenes}", "--scenes", "prims,missing,rings"]
    rc, out, err = _run(main, argv + ["--device", "cpu"])
    jrc, jout, jerr = _run(j_main, argv)
    assert rc == jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert sorted(got["scenes"]) == sorted(want["scenes"]) == ["prims", "rings"]
    for sc in got["scenes"]:
        assert abs(got["scenes"][sc]["psnr_test"] - want["scenes"][sc]["psnr_test"]) \
            <= SUITE_PSNR_TOL_DB, sc
        assert abs(got["scenes"][sc]["ssim_test"] - want["scenes"][sc]["ssim_test"]) <= 1e-3
        assert got["scenes"][sc]["n_views_test"] == 2
        assert sorted(os.listdir(scenes / sc / "suite_renders")) == ["test_000.png",
                                                                     "test_001.png"]
    assert got["mean_psnr_test"] == pytest.approx(
        np.mean([r["psnr_test"] for r in got["scenes"].values()]))
    assert "missing: SKIP (no data:" in err and "missing: SKIP (no data:" in jerr
    rc, _, err = _run(main, argv[:-1] + ["nothing", "--device", "cpu"])
    assert rc == 1 and "no scene produced results" in err


def test_suite_skips_a_scene_without_a_checkpoint(scenes, tmp_path):
    from tnerf_torch.cli import main

    os.makedirs(tmp_path / "rings")
    rc, out, err = _run(main, ["suite", "--device", "cpu", "--config",
                               str(scenes / "prims" / "config.json"), "-o",
                               f"logging.out_dir={tmp_path}", "--scenes", "rings"])
    assert rc == 1 and "rings: SKIP (no checkpoint found in" in err


def _gif_frames_rgb(path):
    from PIL import Image

    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB"), np.int64))
    return im, frames


def test_render_orbit_gif(scenes, tmp_path):
    """`render --orbit 3 --gif`: three PNG frames and orbit.gif, which PIL
    reads as three 24x24 frames of 100 ms looping forever, each within the
    quantizer's bound of its PNG frame (exact where the frame has at most
    256 colours); the port's block parser agrees."""
    from tnerf_torch.cli import main
    from tnerf_torch.data.gif_io import gif_frames
    from tnerf_torch.data.png_io import read_png

    out = tmp_path / "orbit"
    rc, text, _ = _run(main, ["render", "--device", "cpu", "--config",
                              str(scenes / "prims" / "config.json"), "--orbit", "3", "--gif",
                              "--out", str(out)])
    assert rc == 0 and json.loads(text.strip().splitlines()[-1])["frames"] == 3
    gif = out / "orbit.gif"
    assert gif_frames(str(gif)) == (3, 24, 24)
    im, frames = _gif_frames_rgb(gif)
    assert im.info["loop"] == 0 and im.info["duration"] == 100
    for i, got in enumerate(frames):
        png = np.round(read_png(str(out / f"orbit_{i:03d}.png"))[..., :3] * 255).astype(np.int64)
        diff = np.abs(got - png)
        assert diff.mean() <= 1.5 and diff.max() <= 40, (i, diff.mean(), diff.max())
        if len(np.unique(png.reshape(-1, 3), axis=0)) <= 256:
            assert diff.max() == 0


def test_gif_writer_encodes_its_palettes_exactly(tmp_path):
    """Frames of many colours (median cut; the LZW table fills and
    restarts), of one colour and of two: PIL decodes each frame to exactly
    the palette colours the writer chose (`quantize`); the quantizer keeps
    a committed 400x400 render within a mean of 1.5 and a maximum of 40
    levels of 255."""
    from tnerf_torch.data.gif_io import gif_frames, quantize, to_uint8, write_gif
    from tnerf_torch.data.png_io import read_png

    y, x = np.mgrid[0:120, 0:160] / np.float32(120)
    smooth = np.stack([np.sin(3 * x) ** 2, y, (x * y) % 1], -1).astype(np.float32)
    two = np.zeros((120, 160, 3), np.float32)
    two[:, 80:] = [0.2, 0.6, 1.0]
    frames = [smooth, np.full((120, 160, 3), 0.5, np.float32), two, smooth[::-1]]
    path = str(tmp_path / "t.gif")
    write_gif(path, frames)
    assert gif_frames(path) == (4, 160, 120)
    im, decoded = _gif_frames_rgb(path)
    assert len(decoded) == 4
    for f, got in zip(frames, decoded):
        palette, idx = quantize(to_uint8(f))
        np.testing.assert_array_equal(got, palette[idx].astype(np.int64))
    with pytest.raises(ValueError, match="one \\[H, W, 3\\]"):
        write_gif(path, [smooth, two[:60]])
    render = to_uint8(read_png(os.path.join(REPO, "runs", "suite_rehearsal", "prims",
                                            "suite_renders", "test_000.png"))[..., :3])
    palette, idx = quantize(render)
    assert len(np.unique(render.reshape(-1, 3), axis=0)) > 256 and palette.shape == (256, 3)
    diff = np.abs(palette[idx].astype(np.int64) - render.astype(np.int64))
    assert diff.mean() <= 1.5 and diff.max() <= 40, (diff.mean(), diff.max())
