"""Isosurface extraction, against the reference package on the CPU:

- `marching_tetrahedra` on the fields of tests/test_marching.py (sphere,
  plane, thin sheet, empty and full levels) and on seeded random fields of
  other shapes, origins and spacings: faces equal and vertices bit-equal;
  the tet cases and their LUTs equal; `vertex_normals` bit-equal; `save_obj`
  the same text;
- `extract_density_mesh` through the port's field against the reference's,
  both the committed prims model (its weights carried across, the field
  in float32) at resolution 32: the density grids within 1e-5 of their
  maximum (float32 sums in another order); the two meshes' counts and faces
  equal and their vertices within 1e-4, at a level that no grid value lies
  within 1e-4 of (asserted of the inputs);
- `cli mesh --device cpu --resolution 32` of the committed prims checkpoint
  against `tnerf.cli mesh`: with the field in float32, the OBJs' counts and
  faces equal and their coordinates within 1e-4 (a vertex on an edge whose
  two values differ by d moves by a cell times the density error over d:
  the largest such move here is 1.03e-5 of a coordinate, which the OBJ's six
  decimals can round past 1e-5), the vertex colours within 2e-3, 99% of
  them within 2e-4; as committed (bf16 activations, rounded in
  another order), the meshes' summaries within the chip run's bounds; an
  empty isosurface is refused with the reference's words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.config import Config as JConfig
from tnerf.grid import marching as jm
from tnerf_torch.config import Config
from tnerf_torch.grid import marching as tm

from test_marching import _sphere_values

torch.set_num_threads(2)
RUN = "runs/suite_rehearsal/prims"


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _sheet():
    vals = np.full((12, 12, 12), -1.0, np.float32)
    vals[2:-2, 2:-2, 6] = 1.0
    return vals


def _fields():
    vals, h = _sphere_values()
    ax = np.linspace(0.0, 1.0, 9, dtype=np.float32)
    x = np.meshgrid(ax, ax, ax, indexing="ij")[0]
    rng = np.random.default_rng(0)
    return {
        "sphere": (vals, 0.0, (-1.0, -1.0, -1.0), (h, h, h)),
        "plane": (0.35 - x, 0.0, (0, 0, 0), (1 / 8,) * 3),
        "sheet": (_sheet(), 0.0, (0, 0, 0), (1, 1, 1)),
        "empty": (_sphere_values(n=9)[0], 10.0, (0, 0, 0), (1, 1, 1)),
        "full": (_sphere_values(n=9)[0], -10.0, (0, 0, 0), (1, 1, 1)),
        "random": (rng.normal(0, 1, (7, 11, 5)).astype(np.float32), 0.3, (-0.5, 0.2, 1.0),
                   (0.1, 0.25, 0.3)),
        "random_ties": (np.round(rng.normal(0, 1, (9, 6, 8)), 1).astype(np.float32), 0.2,
                        (0, 0, 0), (1, 1, 1)),
        "blobs": (np.sin(3.1 * np.arange(20 * 20 * 20, dtype=np.float32) ** 0.5)
                  .reshape(20, 20, 20), 0.5, (-1, -1, -1), (0.1, 0.1, 0.1)),
    }


def test_tet_cases_and_luts_match_reference():
    assert tm._tet_cases() == jm._tet_cases()
    for name in ("_CUBE", "_TETS_ARR", "_CASE_NTRI", "_TRI_LUT"):
        _same(getattr(tm, name), getattr(jm, name))
    assert tm._TETS == jm._TETS


@pytest.mark.parametrize("case", list(_fields()))
def test_marching_tetrahedra_matches_reference(case, tmp_path):
    vals, level, origin, spacing = _fields()[case]
    got = tm.marching_tetrahedra(vals, level, origin=origin, spacing=spacing)
    want = jm.marching_tetrahedra(vals, level, origin=origin, spacing=spacing)
    _same(got[0], want[0])
    _same(got[1], want[1])
    if case in ("empty", "full"):
        assert len(got[0]) == 0 and len(got[1]) == 0
        return
    assert len(got[1]) > 0
    _same(tm.vertex_normals(*got), jm.vertex_normals(*want))
    colors = np.random.default_rng(1).random((len(got[0]), 3)).astype(np.float32) * 1.2 - 0.1
    for c in (None, colors):
        tm.save_obj(str(tmp_path / "port" / "m.obj"), *got, c)
        jm.save_obj(str(tmp_path / "ref" / "m.obj"), *want, c)
        assert (tmp_path / "port" / "m.obj").read_text() == \
            (tmp_path / "ref" / "m.obj").read_text()


def test_marching_refuses_a_flat_grid():
    for mod in (tm, jm):
        with pytest.raises(ValueError, match="need >=2 vertices per axis"):
            mod.marching_tetrahedra(np.zeros((1, 4, 4), np.float32), 0.0)


def _carried_fields():
    """The committed prims model in both packages, its field in float32:
    the reference's restored by its CLI's own restore, the port's carried
    across by `load_jax_checkpoint`."""
    from tnerf.cli import _build_restore
    from tnerf.train import eval_params
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    ov = ["field_.compute_dtype=float32"]
    jcfg = JConfig.from_json_file(f"{RUN}/config.json").apply_overrides(ov)
    cfg = Config.from_json_file(f"{RUN}/config.json").apply_overrides(ov)
    jfield, state, _, _, err = _build_restore(jcfg, f"{RUN}/checkpoints", 0)
    assert err is None
    _, params, _ = load_jax_checkpoint(f"{RUN}/checkpoints", device="cpu")
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator())
    return jcfg, cfg, jfield, eval_params(state), lambda x: field.density(x, params)


def test_extract_density_mesh_of_carried_weights_matches_reference():
    jcfg, cfg, jfield, jparams, port_density = _carried_fields()
    res = 32
    dens = jax.jit(jfield.density)
    calls = []

    def counted(x):
        calls.append(x.shape[0])
        return port_density(x)

    want_grid = tm.density_grid(lambda x: torch.from_numpy(np.array(
        dens(jparams, jnp.asarray(x.numpy())))), cfg.grid, res)
    got_grid = tm.density_grid(counted, cfg.grid, res, chunk=10000)
    assert calls == [10000] * 3 + [33 ** 3 - 30000]
    top = float(np.abs(want_grid).max())
    assert float(np.abs(got_grid - want_grid).max()) <= 1e-5 * top
    # a level in the widest gap between the grid's values on the surfaces
    # (from 1 to half the largest density), so that no value lies within
    # 1e-4 of it
    v = np.sort(want_grid.ravel())
    v = v[(v > 1.0) & (v < 0.5 * top)]
    i = int(np.argmax(np.diff(v)))
    level = float(0.5 * (v[i] + v[i + 1]))
    assert float(np.abs(want_grid - level).min()) > 1e-4
    assert float(np.abs(got_grid - level).min()) > 1e-4
    want = jm.extract_density_mesh(lambda x: dens(jparams, jnp.asarray(x)), jcfg.grid,
                                   resolution=res, level=level)
    got = tm.extract_density_mesh(port_density, cfg.grid, resolution=res, level=level)
    assert len(want[1]) > 100
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    _same(got[1], want[1])
    assert float(np.abs(got[0] - want[0]).max()) <= 1e-4
    # the marching itself is the reference's: the reference's grid through
    # the port's extraction gives the reference's mesh bit for bit
    lo = np.asarray(cfg.grid.aabb_min, np.float32)
    spacing = (np.asarray(cfg.grid.aabb_max, np.float32) - lo) / res
    same = tm.marching_tetrahedra(want_grid, level, origin=lo, spacing=spacing)
    _same(same[0], want[0])
    _same(same[1], want[1])


def _cli_meshes(tmp_path, extra, ref_extra=None):
    from tnerf.cli import main as jmain
    from tnerf_torch.cli import main

    base = ["--config", f"{RUN}/config.json", "--checkpoint", f"{RUN}/checkpoints",
            "--resolution", "32"]
    ov = []
    for o in extra:
        ov += ["-o", o]
    assert jmain(["mesh", *base, "--out", str(tmp_path / "ref.obj"), *ov,
                  *(ref_extra or [])]) == 0
    assert main(["mesh", *base, "--out", str(tmp_path / "port.obj"), "--device", "cpu", *ov,
                 *(ref_extra or [])]) == 0
    import sys

    sys.path.insert(0, "tools")
    try:
        from mesh_stats import mesh_stats, read_obj
    finally:
        sys.path.remove("tools")
    return read_obj(str(tmp_path / "port.obj")), read_obj(str(tmp_path / "ref.obj")), mesh_stats


def test_cli_mesh_float32_matches_reference(tmp_path):
    (v, f, c), (jv, jf, jc), _ = _cli_meshes(tmp_path, ["field_.compute_dtype=float32"],
                                             ["--vertex-colors"])
    assert v.shape == jv.shape and len(f) > 10000
    _same(f, jf)
    assert float(np.abs(v - jv).max()) <= 1e-4
    # colours: the normals come from the vertices, and a small face turns
    # with its vertices' 1e-5: all within 2e-3, 99% within the OBJ's four
    # decimals' rounding on both sides (2e-4)
    dc = np.abs(c - jc).max(axis=1)
    assert float(dc.max()) <= 2e-3 and float(np.mean(dc <= 2e-4)) >= 0.99


def test_cli_mesh_as_committed_agrees_with_reference(tmp_path):
    (v, f, c), (jv, jf, jc), stats = _cli_meshes(tmp_path, [])
    assert c is None and jc is None
    s, js = stats(v, f), stats(jv, jf)
    cell = 2.0 / 32
    for k in ("n_vertices", "n_faces"):
        assert abs(s[k] - js[k]) <= 0.005 * js[k], (k, s[k], js[k])
    assert np.abs(np.subtract(s["bbox_min"], js["bbox_min"])).max() <= cell
    assert np.abs(np.subtract(s["bbox_max"], js["bbox_max"])).max() <= cell
    assert abs(s["surface_area"] - js["surface_area"]) <= 0.01 * js["surface_area"]


def test_cli_mesh_empty_isosurface_is_refused(tmp_path, capsys):
    from tnerf.cli import main as jmain
    from tnerf_torch.cli import main

    base = ["mesh", "--config", f"{RUN}/config.json", "--checkpoint", f"{RUN}/checkpoints",
            "--resolution", "8", "--threshold", "1e9", "--out", str(tmp_path / "none.obj")]
    assert jmain(base) == 1
    want = capsys.readouterr().err.splitlines()[-1]
    assert main(base + ["--device", "cpu"]) == 1
    assert capsys.readouterr().err.splitlines()[-1] == want
    assert want.startswith("error: empty isosurface")
    assert not (tmp_path / "none.obj").exists()
