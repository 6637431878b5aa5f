"""Scenes read from disk, against the reference package on the CPU:

- the standard-library PNG reader bit-equal to `tnerf.data.png_io.read_png`
  (the reference's native decoder) on the committed LLFF and COLMAP frames
  and on RGBA, RGB, grey, grey + alpha and palette (tRNS) files the test
  writes, with 3 and 4 channels and the sRGB decode; 16-bit, sub-byte,
  interlaced and corrupt files refused by name;
- the LLFF and COLMAP loaders on data/llff/prims_ff, data/colmap/prims_cm
  and data/colmap/prims_oc (an off-centre principal point, fx != fy)
  bit-equal to the reference's (images, poses, near_far, camera), with
  recentering and bd_rescale 0.75 on and off;
- a COLMAP binary model equal to the same text model (the reference's
  writer, tests/test_colmap.py), and both equal to the reference's loads;
- export -> load round trips of the LLFF, COLMAP and NeRF-synthetic
  formats equal to the reference's round trips of the same pool;
- `cameras.ndc_warp` bit-equal at 480x360 to the reference in both places
  it runs there: eager (its eval and CLI) in this process, jitted (its
  training step) in a subprocess whose XLA:CPU is limited to AVX (without
  that it contracts multiplies and adds into FMAs, which no PyTorch
  elementwise kernel does).
"""

import functools
import json
import os
import struct
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The suite runs several workers side by side: more threads each only fight.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLFF_ROOT = os.path.join(REPO, "data", "llff")
COLMAP_ROOT = os.path.join(REPO, "data", "colmap")
FRAMES = [os.path.join(LLFF_ROOT, "prims_ff", "images", f"image00{i}.png") for i in (0, 7)] + \
    [os.path.join(COLMAP_ROOT, "prims_cm", "images", f"frame_00{i}.png") for i in (0, 7)]


def _same_read(path):
    from tnerf.data.png_io import read_png as j_read
    from tnerf_torch.data.png_io import read_png

    for channels in (3, 4):
        for srgb in (False, True):
            want = j_read(path, channels, srgb)
            got = read_png(path, channels, srgb)
            assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{path} {channels} {srgb}")


@pytest.mark.parametrize("path", FRAMES, ids=os.path.basename)
def test_png_reader_matches_reference_on_committed_frames(path):
    _same_read(path)


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA", "P"])
def test_png_reader_matches_reference_on_written_files(mode, tmp_path):
    """Files PIL writes with its adaptive row filters (all five occur in a
    smooth image with noise); the palette image carries a tRNS alpha."""
    from PIL import Image

    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:37, 0:53]
    img = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    img[..., 0] = (4 * xx) % 256
    img[..., 1] = (5 * yy + xx) % 256
    path = str(tmp_path / f"{mode}.png")
    if mode == "P":
        im = Image.fromarray(img[..., :3], "RGB").quantize(colors=50)
        im.save(path, transparency=bytes(range(0, 250, 5)))
    else:
        Image.fromarray(img, "RGBA").convert(mode).save(path)
    _same_read(path)


def _patched(tmp_path, name, ihdr=None, body=None, crc_ok=True):
    """An 8-bit RGB PNG from the port's writer, with IHDR fields replaced
    and/or the IDAT body replaced; the CRCs recomputed unless crc_ok is
    False."""
    from tnerf_torch.data.png_io import _chunk, encode_png

    data = encode_png(np.zeros((4, 5, 3), np.uint8))
    w, h, depth, ctype, comp, filt, lace = struct.unpack(">IIBBBBB", data[16:29])
    fields = {"depth": depth, "ctype": ctype, "lace": lace, **(ihdr or {})}
    new = struct.pack(">IIBBBBB", w, h, fields["depth"], fields["ctype"], comp, filt,
                      fields["lace"])
    idat = zlib.compress(body) if body is not None else None
    out = data[:8] + _chunk(b"IHDR", new)
    rest = data[8 + 25:]
    if idat is not None:
        rest = _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")
    out += rest
    if not crc_ok:
        out = out[:29] + bytes([out[29] ^ 1]) + out[30:]
    path = str(tmp_path / name)
    with open(path, "wb") as fh:
        fh.write(out)
    return path


@pytest.mark.parametrize("what,patch,match", [
    ("16-bit", dict(ihdr=dict(depth=16)), "16-bit RGB PNG is not supported"),
    ("4-bit palette", dict(ihdr=dict(depth=4, ctype=3)), "4-bit palette PNG is not supported"),
    ("interlaced", dict(ihdr=dict(lace=1)), r"interlaced \(Adam7\) PNG is not supported"),
    ("bad CRC", dict(crc_ok=False), "CRC mismatch"),
    ("short data", dict(body=b"\x00" * 10), "decompressed 10 bytes, expected 64"),
    ("unknown filter", dict(body=b"\x07" * 64), "unknown row filter 7 in row 0"),
])
def test_png_reader_refuses_what_it_does_not_read(what, patch, match, tmp_path):
    from tnerf_torch.data.png_io import read_png

    path = _patched(tmp_path, "x.png", **patch)
    with pytest.raises(ValueError, match=match):
        read_png(path)


def _assert_same_datasets(got, want):
    assert sorted(got) == sorted(want)
    for split in want:
        g, w = got[split], want[split]
        for name in ("images", "poses"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape, (split, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{split} {name}")
        if w.near_far is None:
            assert g.near_far is None
        else:
            assert g.near_far.dtype == w.near_far.dtype
            np.testing.assert_array_equal(g.near_far, w.near_far)
        assert (g.focal, g.width, g.height, g.channels, g.split, g.intrinsics, g.camera) == \
            (w.focal, w.width, w.height, w.channels, w.split, w.intrinsics, w.camera)
        np.testing.assert_array_equal(g.composited(True), w.composited(True))


@pytest.mark.parametrize("kind,name,root", [("llff", "prims_ff", LLFF_ROOT),
                                            ("colmap", "prims_cm", COLMAP_ROOT),
                                            ("colmap", "prims_oc", COLMAP_ROOT)])
@pytest.mark.parametrize("recenter,bd_rescale", [(False, 0.0), (True, 0.75), (True, 0.0),
                                                 (False, 0.75)])
def test_loaders_match_reference_on_the_committed_captures(kind, name, root, recenter,
                                                           bd_rescale):
    """Bit-equal: every image, pose, depth bound and camera number."""
    from tnerf.data.dataset import load_data as j_load
    from tnerf_torch.data.dataset import load_data

    llff = dict(recenter=recenter, bd_rescale=bd_rescale)
    _assert_same_datasets(load_data(kind, name, root=root, llff=llff, device="cpu"),
                          j_load(kind, name, root=root, llff=llff))


def test_loader_options_follow_the_config():
    """scene_llff_kwargs and the loader's preprocessing from a config, as
    the reference reads them, and a scene kind neither knows refused."""
    from tnerf.config import Config as JConfig
    from tnerf.data.dataset import scene_llff_kwargs as j_kwargs
    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_llff_kwargs

    for ov in ([], ["scene.llff_recenter=true"], ["scene.llff_bd_rescale=0.75"],
               ["scene.llff_recenter=true", "scene.llff_bd_rescale=0.5"]):
        assert scene_llff_kwargs(Config().apply_overrides(ov).scene) == \
            j_kwargs(JConfig().apply_overrides(ov).scene)
    with pytest.raises(ValueError, match="unknown dataset kind 'blender'"):
        load_data("blender", "x", device="cpu")


@pytest.mark.parametrize("binary", [False, True])
def test_colmap_binary_and_text_models_load_as_the_reference_loads_them(binary, tmp_path):
    """The reference's own model writer (tests/test_colmap.py): the binary
    model loads equal to the text model, and each as the reference loads it."""
    from tnerf.data.colmap import load_colmap_scene as j_load
    from tnerf.data.procedural import frontal_poses as j_frontal
    from tnerf_torch.data.colmap import load_colmap_scene

    from test_colmap import _write_model

    poses = j_frontal(9, radius=3.0, seed=1).astype(np.float64)
    points = np.array([[0.0, 0.0, 0.0], [0.3, -0.2, 0.1], [-0.4, 0.1, -0.2],
                       [0.1, 0.4, 0.3], [0.0, -0.3, -0.4]])
    _write_model(tmp_path, poses, points, binary=binary, name="m")
    _write_model(tmp_path, poses, points, binary=not binary, name="other")
    got = load_colmap_scene(str(tmp_path), "m", recenter=True, bd_rescale=0.75)
    _assert_same_datasets(got, j_load(str(tmp_path), "m", recenter=True, bd_rescale=0.75))
    other = load_colmap_scene(str(tmp_path), "other", recenter=True, bd_rescale=0.75)
    for split in got:
        np.testing.assert_allclose(got[split].poses, other[split].poses, atol=1e-7)
        np.testing.assert_allclose(got[split].near_far, other[split].near_far, rtol=1e-7)
        assert got[split].intrinsics == other[split].intrinsics


def test_colmap_refusals_and_warning_as_the_reference(tmp_path):
    """More than one camera is refused and a distorted model warns, with
    the reference's words."""
    from tnerf.data.colmap import load_colmap_scene as j_load
    from tnerf.data.procedural import frontal_poses as j_frontal
    from tnerf_torch.data.colmap import load_colmap_scene

    from test_colmap import _write_model

    poses = j_frontal(3, radius=3.0, seed=1).astype(np.float64)
    points = np.array([[0.0, 0.0, 0.0], [0.2, 0.1, -0.1]])
    _write_model(tmp_path, poses, points, model="SIMPLE_RADIAL", name="radial")
    with pytest.warns(UserWarning, match="SIMPLE_RADIAL carries distortion coefficients"):
        got = load_colmap_scene(str(tmp_path), "radial")
    with pytest.warns(UserWarning):
        _assert_same_datasets(got, j_load(str(tmp_path), "radial"))
    images = tmp_path / "radial" / "sparse" / "0" / "images.txt"
    lines = images.read_text().splitlines()
    meta = [i for i, ln in enumerate(lines) if ln.endswith(".png")]
    el = lines[meta[1]].split()
    el[8] = "2"
    lines[meta[1]] = " ".join(el)
    images.write_text("\n".join(lines) + "\n")
    for load in (load_colmap_scene, j_load):
        with pytest.raises(ValueError, match="2 distinct COLMAP cameras"):
            load(str(tmp_path), "radial")


@pytest.fixture(scope="module")
def pool():
    """A small forward-facing pool of the prims field rendered by both
    packages (the GT quadrature in float32 each: equal to rounding)."""
    from tnerf.data.procedural import generate_llff_pool as j_pool
    from tnerf_torch.data.procedural import frontal_poses, generate_llff_pool

    from tnerf.data.procedural import frontal_poses as j_frontal

    np.testing.assert_array_equal(frontal_poses(9, seed=40), j_frontal(9, seed=40))
    kw = dict(width=32, height=24, n_views=9, n_samples=64)
    want = j_pool(**kw)
    got = generate_llff_pool(**kw, device="cpu")
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_allclose(got.images, want.images, atol=2e-5)
    assert (got.focal, got.width, got.height, got.channels) == \
        (want.focal, want.width, want.height, want.channels)
    return want


def test_llff_export_round_trip_matches_reference(pool, tmp_path):
    from tnerf.data.llff import load_llff_scene as j_load
    from tnerf.data.procedural import export_llff_format as j_export
    from tnerf_torch.data.llff import load_llff_scene
    from tnerf_torch.data.procedural import export_llff_format

    export_llff_format(pool, str(tmp_path / "port"), near=2.0, far=5.5)
    j_export(pool, str(tmp_path / "ref"), near=2.0, far=5.5)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "poses_bounds.npy"),
                                  np.load(tmp_path / "ref" / "poses_bounds.npy"))
    for kw in ({}, dict(recenter=True, bd_rescale=0.75)):
        want = j_load(str(tmp_path), "ref", **kw)
        _assert_same_datasets(load_llff_scene(str(tmp_path), "port", **kw), want)
        _assert_same_datasets(load_llff_scene(str(tmp_path), "ref", **kw), want)


def test_colmap_export_round_trip_matches_reference(pool, tmp_path):
    from tnerf.data.colmap import load_colmap_scene as j_load
    from tnerf.data.procedural import export_colmap_format as j_export
    from tnerf_torch.data.colmap import load_colmap_scene
    from tnerf_torch.data.procedural import export_colmap_format

    export_colmap_format(pool, str(tmp_path / "port"), n_points=128)
    j_export(pool, str(tmp_path / "ref"), n_points=128)
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        a = (tmp_path / "port" / "sparse" / "0" / f).read_bytes()
        assert a == (tmp_path / "ref" / "sparse" / "0" / f).read_bytes(), f
    for kw in ({}, dict(recenter=True, bd_rescale=0.75)):
        want = j_load(str(tmp_path), "ref", **kw)
        _assert_same_datasets(load_colmap_scene(str(tmp_path), "port", **kw), want)


def test_nerf_synthetic_export_round_trip_matches_reference(tmp_path):
    from tnerf.data.dataset import load_data as j_load
    from tnerf.data.procedural import export_nerf_synthetic_format as j_export
    from tnerf.data.procedural import generate_procedural_scene as j_scene
    from tnerf_torch.data.dataset import load_data
    from tnerf_torch.data.procedural import export_nerf_synthetic_format

    scene = j_scene(width=16, height=16, n_train=3, n_val=1, n_test=2, n_samples=32)
    export_nerf_synthetic_format(scene, str(tmp_path / "port"))
    j_export(scene, str(tmp_path / "ref"))
    for split in ("train", "val", "test"):
        assert json.loads((tmp_path / "port" / f"transforms_{split}.json").read_text()) == \
            json.loads((tmp_path / "ref" / f"transforms_{split}.json").read_text())
    want = j_load("nerf_synthetic", "ref", root=str(tmp_path))
    _assert_same_datasets(load_data("nerf_synthetic", "port", root=str(tmp_path)), want)
    _assert_same_datasets(load_data("nerf_synthetic", "ref", root=str(tmp_path),
                                    splits=("test", "val", "train")), want)
    assert sorted(load_data("nerf_synthetic", "ref", root=str(tmp_path), splits=("test",))) \
        == ["test"]


# ------------------------------------------------------------------ NDC warp

CAMERAS = {
    # LLFF: a scalar focal (principal point at the centre)
    "llff": 666.6666187162609,
    # COLMAP's PINHOLE of data/colmap/prims_cm
    "colmap": (666.6666666666666, 666.6666666666666, 240.0, 180.0),
    # an off-centre principal point and fx != fy
    "offset": (600.0, 650.0, 250.3, 170.2),
}


@functools.lru_cache(maxsize=None)
def _test_pose():
    from tnerf_torch.data.colmap import load_colmap_scene

    return load_colmap_scene(COLMAP_ROOT, "prims_cm", recenter=True,
                             bd_rescale=0.75)["test"].poses[0]


def _view_rays(camera):
    """World rays of a 480x360 view of the recentred COLMAP capture's
    first test pose, as numpy [H, W, 3] / [H, W, 2]."""
    from tnerf_torch.cameras import camera_rays

    r = camera_rays(_test_pose(), 480, 360, camera, 1.0, device="cpu")
    return tuple(a.numpy() for a in r)


@pytest.mark.parametrize("camera", list(CAMERAS))
def test_ndc_warp_eager_matches_the_reference_eval(camera):
    """Bit-equal to the reference's eager warp (`tnerf/eval.py:85`)."""
    from tnerf.cameras import Rays as JRays, ndc_warp as j_warp
    from tnerf_torch.cameras import Rays, ndc_warp

    o, d, tp = _view_rays(CAMERAS[camera])
    want = j_warp(JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tp)), 480, 360,
                  CAMERAS[camera], 1.0)
    got = ndc_warp(Rays(*(torch.from_numpy(a) for a in (o, d, tp))), 480, 360,
                   CAMERAS[camera], 1.0, eager=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.all(got.origins[..., 2].numpy() == -1.0) and np.all(got.directions[..., 2].numpy()
                                                                   == 2.0)


_JITTED = """
import sys
import numpy as np
import jax
from tnerf.cameras import Rays, ndc_warp
inp = np.load(sys.argv[1])
out = {}
for name in inp["names"]:
    cam = tuple(inp[name + "_cam"]) if inp[name + "_cam"].size == 4 else float(inp[name + "_cam"])
    near = float(inp[name + "_near"])
    f = jax.jit(lambda o, d, tp: ndc_warp(Rays(o, d, tp), 480, 360, cam, near))
    r = f(inp[name + "_o"], inp[name + "_d"], inp[name + "_tp"])
    out[name + "_o"], out[name + "_d"] = np.asarray(r.origins), np.asarray(r.directions)
np.savez(sys.argv[2], **out)
"""


def test_ndc_warp_jitted_matches_the_reference_training_step(tmp_path):
    """Bit-equal to the reference's warp under jit (its training step,
    `tnerf/train.py:256`), where XLA multiplies by the reciprocals of the
    constants and folds the constant factors of the origin terms; at near
    1.0 (the committed configs) and 0.7."""
    from tnerf_torch.cameras import Rays, ndc_warp

    cases, inp = {}, {}
    for camera, cam in CAMERAS.items():
        for near in (1.0, 0.7):
            name = f"{camera}_{near}"
            o, d, tp = _view_rays(cam)
            cases[name] = (cam, near, o, d, tp)
            inp.update({name + "_cam": np.asarray(cam, np.float64), name + "_near": near,
                        name + "_o": o, name + "_d": d, name + "_tp": tp})
    inp["names"] = np.asarray(list(cases))
    np.savez(tmp_path / "in.npz", **inp)
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_cpu_max_isa=AVX"}
    subprocess.run([sys.executable, "-c", _JITTED, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], env=env, check=True, timeout=600)
    with np.load(tmp_path / "out.npz") as want:
        for name, (cam, near, o, d, tp) in cases.items():
            got = ndc_warp(Rays(*(torch.from_numpy(a) for a in (o, d, tp))), 480, 360, cam, near)
            np.testing.assert_array_equal(got.origins.numpy(), want[name + "_o"], err_msg=name)
            np.testing.assert_array_equal(got.directions.numpy(), want[name + "_d"],
                                          err_msg=name)


ABSENT = sorted(p for p in __import__("glob").glob(os.path.join(REPO, "configs", "*.json"))
                if json.load(open(p))["scene"]["kind"] != "procedural")


@pytest.mark.parametrize("path", ABSENT, ids=os.path.basename)
def test_configs_of_captures_not_in_the_repo_load_and_validate(path):
    """The lego / reference_parity / llff_ndc configs name scenes that are
    not in the repo: the port takes each for training and serving, builds
    its renderer, and fails to load the missing capture with the
    reference loader's own error."""
    from tnerf.config import Config as JConfig
    from tnerf.train_loop import _load_datasets
    from tnerf_torch.config import Config
    from tnerf_torch.train_loop import build_renderer, load_datasets, validate_ported

    cfg = Config.from_json_file(path)
    validate_ported(cfg, for_eval=False)
    assert callable(build_renderer(cfg))
    with pytest.raises(Exception) as want:
        _load_datasets(JConfig.from_json_file(path))
    with pytest.raises(type(want.value)) as got:
        load_datasets(cfg, device="cpu")
    assert str(got.value) == str(want.value)
