"""The port reads the reference package's checkpoints without JAX:
`tnerf_torch.utils.checkpoint` against the npz leaves and against
`tnerf.utils.checkpoint.restore_checkpoint` (exact, float32)."""

import json
import os
import shutil

import numpy as np
import pytest

from tnerf_torch.utils.checkpoint import load_jax_checkpoint, params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "suite_rehearsal", "prims")
CKPT = os.path.join(RUN, "checkpoints")
NPZ = os.path.join(CKPT, "step_00001500.npz")


@pytest.fixture(scope="module")
def loaded():
    return load_jax_checkpoint(CKPT, device="cpu")


def test_loader_matches_npz_leaves(loaded):
    step, params, occ = loaded
    assert step == 1500
    with np.load(NPZ) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    assert len(leaves) == 63
    shapes = [(81, 128)] + [(128, 128)] * 7 + [(128, 4)]
    for l in range(9):
        w, b = params[f"trunk.w.{l}"].numpy(), params[f"trunk.b.{l}"].numpy()
        assert w.shape == shapes[l] and b.shape == (shapes[l][1],)
        np.testing.assert_array_equal(b, leaves[l])
        np.testing.assert_array_equal(w, leaves[9 + l])
    np.testing.assert_array_equal(occ.bitfield.numpy(), leaves[61])
    np.testing.assert_array_equal(occ.density_ema.numpy(), leaves[60])
    assert occ.bitfield.dtype.is_floating_point is False and occ.bitfield.shape == (64, 64, 64)


def _copy_ckpt(tmp_path, edit):
    dst = tmp_path / "ckpt"
    shutil.copytree(CKPT, dst)
    meta = json.loads((dst / "treedef.json").read_text())
    edit(meta, dst)
    (dst / "treedef.json").write_text(json.dumps(meta))
    return str(dst)


@pytest.mark.parametrize("case", ["leaf_count", "weight_ema", "pose_extra"])
def test_loader_refuses_other_layouts(tmp_path, case):
    def edit(meta, dst):
        if case == "leaf_count":
            meta["n_leaves"] = 62
        elif case == "weight_ema":
            meta["treedef"] = meta["treedef"].replace(", *, None]),", ", *, *]),")
            meta["n_leaves"] += 1
        else:
            meta["treedef"] = meta["treedef"].replace(
                "[{'trunk':", "[{'pose_deltas': *, 'trunk':", 1)
            meta["n_leaves"] += 1

    with pytest.raises(ValueError):
        load_jax_checkpoint(_copy_ckpt(tmp_path, edit), device="cpu")


def test_params_from_jax_matches_jax_restore(loaded):
    from tnerf.cli import _build_restore
    from tnerf.config import Config

    cfg = Config.from_json_file(os.path.join(RUN, "config.json"))
    _, state, occ, step, err = _build_restore(cfg, CKPT, 0)
    assert err is None and step == 1500
    jparams = {"trunk": {k: [np.asarray(a) for a in v]
                         for k, v in state.params["trunk"].items()}}
    converted = params_from_jax(jparams)
    _, params, occ_t = loaded
    assert set(converted) == set(params)
    for k, v in converted.items():
        assert v.dtype == params[k].dtype
        np.testing.assert_array_equal(v.numpy(), params[k].numpy())
    np.testing.assert_array_equal(np.asarray(occ.bitfield), occ_t.bitfield.numpy())
