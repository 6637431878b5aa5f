"""Mesh-bounded scenes, against the reference package on the CPU:

- every function of `tnerf_torch/grid/mesh.py` against `tnerf/grid/mesh.py`
  bit for bit (the readers, voxelization, fill, dilation, the mask from a
  config and its empty-voxelization error), on the cases of
  tests/test_mesh.py and on seeded random triangles and occupancies;
- the masked occupancy refresh: `ema_threshold_update` with a mask bit-equal
  to the reference's given the same densities; `update_occupancy` with a
  mask (the two packages' jitter streams differ: the port alone) never sets
  a cell outside it, and zeroes the EMA there;
- `cli train --device cpu` of a mesh-bounded scene: the bitfield of every
  occupancy refresh inside the mask, the resumed run rebuilding the same
  mask from the config; `scene.ndc` with `grid.mesh_path` refused with the
  reference's error.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tnerf.config import Config as JConfig, GridConfig as JGrid
from tnerf.grid import mesh as jmesh
from tnerf_torch.config import Config, GridConfig
from tnerf_torch.grid import mesh as tmesh

from test_mesh import CUBE_FACES, CUBE_VERTS, _write_cube_obj

torch.set_num_threads(2)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _random_triangles(seed, n=40, spread=1.3):
    rng = np.random.default_rng(seed)
    verts = rng.uniform(-spread, spread, (3 * n, 3)).astype(np.float32)
    return verts, np.arange(3 * n, dtype=np.int32).reshape(n, 3)


@pytest.mark.parametrize("res", [16, 32])
@pytest.mark.parametrize("case", ["cube", "cube_scaled", "random0", "random1"])
def test_voxelize_fill_and_occupancy_match_reference(res, case):
    if case == "cube":
        verts, faces = CUBE_VERTS, CUBE_FACES
    elif case == "cube_scaled":  # faces off the cell boundaries, one outside the box
        verts, faces = CUBE_VERTS * np.float32(1.37) + np.float32(0.11), CUBE_FACES
    else:
        verts, faces = _random_triangles(int(case[-1]))
    aabb = dict(aabb_min=(-1.2, -1.0, -0.9), aabb_max=(1.0, 1.1, 0.9))
    g, jg = GridConfig(resolution=res, **aabb), JGrid(resolution=res, **aabb)
    shell = tmesh.voxelize_triangles(verts, faces, g)
    _same(shell, jmesh.voxelize_triangles(verts, faces, jg))
    _same(tmesh.voxelize_triangles(verts, faces, g, supersample=2),
          jmesh.voxelize_triangles(verts, faces, jg, supersample=2))
    _same(tmesh.fill_interior(shell), jmesh.fill_interior(shell))
    for solid in (True, False):
        _same(tmesh.occupancy_from_mesh(verts, faces, g, solid=solid),
              jmesh.occupancy_from_mesh(verts, faces, jg, solid=solid))


def test_reference_cube_cases_hold_in_the_port():
    """tests/test_mesh.py's cube: the shell's cells, the hollow centre, the
    filled interior and its share of the grid."""
    grid = GridConfig(resolution=16)
    shell = tmesh.voxelize_triangles(CUBE_VERTS, CUBE_FACES, grid)
    assert shell[4, 8, 8] and shell[12, 8, 8] and not shell[8, 8, 8] and not shell[0, 0, 0]
    solid = tmesh.fill_interior(shell)
    assert solid[8, 8, 8] and not solid[0, 0, 0] and 0.10 < solid.mean() < 0.22


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dilate_matches_reference(seed):
    occ = np.random.default_rng(seed).random((12, 12, 12)) < 0.03
    for cells in (0, 1, 2, 3):
        _same(tmesh.dilate(occ, cells), jmesh.dilate(occ, cells))
    _same(tmesh._dilate_once(occ), jmesh._dilate_once(occ))
    one = np.zeros((8, 8, 8), bool)
    one[4, 4, 4] = True
    assert tmesh.dilate(one, 1).sum() == 7 and tmesh.dilate(one, 0).sum() == 1


def test_readers_match_reference(tmp_path):
    tet = tmp_path / "two.tet"
    tet.write_text("verts 5\n0 0 0   1 0 0   0 1 0\n0 0 1\n0.5 0.5 0.5\n"
                   "TETS 2\n4 0 1 2 3\n4 1 2 3 4\n")
    for got, want in zip(tmesh.load_tet_mesh(str(tet)), jmesh.load_tet_mesh(str(tet))):
        _same(got, want)
    faces = tmesh.load_tet_mesh(str(tet))[1]
    assert faces.shape == (8, 3)
    _same(faces[:4], np.asarray([[0, 1, 2], [0, 1, 3], [1, 2, 3], [0, 2, 3]], np.int32))
    bad = tmp_path / "bad.tet"
    bad.write_text("points 1\n0 0 0\n")
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError, match="expected 'verts N' header"):
            mod.load_tet_mesh(str(bad))
    obj = tmp_path / "poly.obj"
    obj.write_text("# c\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0 0.1 0.2 0.3\n"
                   "vn 0 0 1\nf 1/1/1 2/2/1 3/3/1 4/4/1\nf 3 5 4\n\n")
    for got, want in zip(tmesh.load_obj(str(obj)), jmesh.load_obj(str(obj))):
        _same(got, want)
    _same(tmesh.load_obj(str(obj))[1], np.asarray([[0, 1, 2], [0, 2, 3], [2, 4, 3]], np.int32))


def test_mesh_occupancy_mask_matches_reference(tmp_path):
    """The OBJ and tet dispatch, solid / shell, dilation, no mesh, and the
    empty-voxelization error with the reference's words."""
    p = tmp_path / "cube.obj"
    _write_cube_obj(p)
    tet = tmp_path / "cube.tet"
    tet.write_text("verts 4\n-0.6 -0.6 -0.6\n0.7 -0.5 -0.6\n-0.5 0.7 -0.5\n-0.5 -0.5 0.7\n"
                   "tets 1\n4 0 1 2 3\n")
    for path in (p, tet):
        for solid in (True, False):
            for d in (0, 1, 2):
                kw = dict(resolution=16, mesh_path=str(path), mesh_solid=solid, mesh_dilate=d)
                got = tmesh.mesh_occupancy_mask(GridConfig(**kw))
                _same(got, jmesh.mesh_occupancy_mask(JGrid(**kw)))
                assert got.shape == (16, 16, 16) and got.any()
    assert tmesh.mesh_occupancy_mask(GridConfig(resolution=16)) is None
    far = tmp_path / "far.obj"
    _write_cube_obj(far, CUBE_VERTS + 10.0)
    with pytest.raises(ValueError) as want:
        jmesh.mesh_occupancy_mask(JGrid(resolution=16, mesh_path=str(far)))
    with pytest.raises(ValueError) as got:
        tmesh.mesh_occupancy_mask(GridConfig(resolution=16, mesh_path=str(far)))
    assert str(got.value) == str(want.value) and "voxelizes to an empty" in str(got.value)


def test_masked_ema_update_matches_reference():
    import jax.numpy as jnp

    from tnerf.grid import occupancy as jocc
    from tnerf_torch.grid import occupancy as tocc

    res = 12
    g, jg = GridConfig(resolution=res), JGrid(resolution=res)
    rng = np.random.default_rng(0)
    mask = rng.random((res, res, res)) < 0.4
    ema0 = (rng.random((res, res, res)) * 0.03).astype(np.float32)
    sigma = (rng.exponential(0.02, (res, res, res))).astype(np.float32)
    for m in (mask, None):
        want = jax.jit(lambda e, s: jocc.ema_threshold_update(e, s, jg, m))(
            jnp.asarray(ema0), jnp.asarray(sigma))
        got = tocc.ema_threshold_update(torch.from_numpy(ema0), torch.from_numpy(sigma), g,
                                        None if m is None else torch.from_numpy(m))
        for a, b in zip(got, want):
            _same(a.numpy(), np.asarray(b))


def test_masked_update_occupancy_stays_inside_the_mask():
    from tnerf_torch.grid.occupancy import init_occupancy, renderer_payload, update_occupancy
    from tnerf_torch.render.grid_renderer import split_occupancy_payload

    grid = GridConfig(resolution=8)
    mask = np.zeros((8, 8, 8), bool)
    mask[2:6, 2:6, 2:6] = True
    mask[0, 0, 0] = True
    occ = init_occupancy(grid, "cpu", torch.from_numpy(mask))
    _same(occ.bitfield.numpy(), mask)
    cfg = Config().apply_overrides(["grid.resolution=8", "sampler.placement=density_cdf"])
    bits0, _ = split_occupancy_payload(renderer_payload(occ, cfg.sampler, grid), grid)
    _same(bits0.numpy(), mask)  # the dense-start density_cdf payload derives the mask
    gen = torch.Generator().manual_seed(0)
    for sigma in (100.0, 0.005, 3.0):  # density everywhere, then nowhere, then again
        occ = update_occupancy(occ, lambda x: torch.full(x.shape[:-1], sigma), grid,
                               generator=gen, mask=torch.from_numpy(mask))
        bits = occ.bitfield.numpy()
        assert not (bits & ~mask).any()
        assert float(occ.density_ema[torch.from_numpy(~mask)].abs().max()) == 0.0
    _same(occ.bitfield.numpy(), mask)


TRAIN = ["scene.kind=procedural", "scene.name=prims", "scene.scene_scale=1.0",
         "scene.proc_width=24", "scene.proc_height=24", "scene.proc_n_train=3",
         "scene.proc_n_val=0", "scene.proc_n_test=1", "scene.proc_n_samples=64",
         "render.pipeline=grid_march", "render.compact=false", "render.ray_compact=false",
         "sampler.samples_per_ray=16", "sampler.near=2.0", "sampler.far=5.5",
         "field_.hidden_width=16", "field_.hidden_layers=1", "field_.n_frequencies=2",
         "grid.resolution=8", "grid.warmup_steps=4", "grid.update_every=4",
         "grid.mesh_dilate=0", "train.batch_size=128", "train.eval_every=0",
         "train.log_every=8", "render.chunk_size=576"]


def test_cli_train_mesh_bounded_holds_every_refresh_and_resume_rebuilds_the_mask(
        tmp_path, monkeypatch):
    import tnerf_torch.train_loop as tl
    from tnerf_torch.cli import main

    p = tmp_path / "bound.obj"
    _write_cube_obj(p, CUBE_VERTS * np.float32(1.2))  # a box around the primitives
    mesh_cfg = Config().apply_overrides(TRAIN + [f"grid.mesh_path={p}"])
    mask = tmesh.mesh_occupancy_mask(mesh_cfg.grid)
    assert 0.2 < mask.mean() < 0.8
    seen = []
    real = tl.update_occupancy

    def spy(occ, density_fn, grid, **kw):
        out = real(occ, density_fn, grid, **kw)
        seen.append((kw["mask"].numpy().copy(), out.bitfield.numpy().copy(),
                     out.density_ema.numpy().copy()))
        return out

    monkeypatch.setattr(tl, "update_occupancy", spy)
    out = str(tmp_path / "run")
    args = ["train", "--device", "cpu", "--out", out, "-o", f"grid.mesh_path={p}"]
    for ov in TRAIN:
        args += ["-o", ov]
    assert main(args + ["-o", "train.steps=24", "-o", "train.checkpoint_every=12"]) == 0
    assert len(seen) == 5  # steps 4, 8, ..., 20
    assert main(args + ["-o", "train.steps=36", "-o", "train.checkpoint_every=12",
                        "-o", "train.resume=true"]) == 0
    assert len(seen) == 8  # and 24, 28, 32 after the resume
    for m, bits, ema in seen:
        _same(m, mask)
        assert not (bits & ~mask).any() and float(np.abs(ema[~mask]).max()) == 0.0
    assert any(bits.any() for _, bits, _ in seen)
    # the checkpoints hold the bitfield, not the mask: within it at every save
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    for step in (12, 24, 36):
        ck = tmp_path / f"ck{step}"
        ck.mkdir()
        src = os.path.join(out, "checkpoints")
        os.link(os.path.join(src, f"step_{step:08d}.npz"), ck / f"step_{step:08d}.npz")
        os.link(os.path.join(src, "treedef.json"), ck / "treedef.json")
        _, _, occ = load_jax_checkpoint(str(ck), device="cpu")
        assert not (occ.bitfield.numpy() & ~mask).any()
    final = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))][-1]
    assert np.isfinite(final["psnr_test"])


def test_ndc_with_a_mesh_is_refused_with_the_reference_error():
    from tnerf.train_loop import validate_ndc as jvalidate
    from tnerf_torch.train_loop import validate_ported

    ov = ["scene.kind=llff", "scene.ndc=true", "scene.llff_recenter=true",
          "sampler.near=-1", "sampler.far=-1", "render.pipeline=grid_march",
          "grid.mesh_path=mesh.obj"]
    with pytest.raises(ValueError) as want:
        jvalidate(JConfig().apply_overrides(ov))
    for for_eval in (True, False):
        with pytest.raises(ValueError) as got:
            validate_ported(Config().apply_overrides(ov), for_eval=for_eval)
        assert str(got.value) == str(want.value)
    validate_ported(Config().apply_overrides(ov[-2:]), for_eval=False)
