"""The progressive triplane's stage configs against the reference's, and
train.keep_best across the progressive stages.

- Both packages' `_run_progressive` with `_run_training_single` and
  `_upsample_checkpoint` replaced by recorders: every stage's train.steps,
  schedule_total_steps, keep_best, assert_test_psnr_min and
  field_.tri_resolution, and every rewrite's target resolution, equal
  between the two (`tnerf/train_loop.py:340-355`: keep_best and the
  acceptance gate apply to the last stage only).
- The port's `cli train --device cpu` of the 32x32 progressive run
  (5, 7 and 9 vertices a side, as in
  `tests/test_torch_table_slice.py`) with train.keep_best=true: every file
  in checkpoints_best, the newest included, is the last stage's and
  restores under the final config (the reference's template at R = 9 and
  the port's `cli eval`), and every best_psnr record is the last stage's.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tnerf.config import Config as JConfig
from tnerf_torch.config import Config

from test_torch_march_slice import SMALL
from test_torch_table_slice import TABLE

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "runs", "hard_r3_triplane_prog", "config.json")
TINY = SMALL + TABLE + ["field_.encoding=triplane", "field_.tri_init_resolution=5",
                        "field_.tri_upsample_steps=[6,12]", "train.table_lr_mult=10",
                        "render.pipeline=grid_march", "train.steps=20", "train.lr=5e-3"]
KEYS = ("steps", "schedule_total_steps", "keep_best", "assert_test_psnr_min")


def recorded_stages(mod, cfg, *args):
    """What one package's `_run_progressive(cfg, *args)` would run, nothing
    trained: [(the stage's train.steps, schedule_total_steps, keep_best,
    assert_test_psnr_min, field_.tri_resolution)] and the rewrites'
    target resolutions."""
    stages, rewrites = [], []
    real = mod._run_training_single, mod._upsample_checkpoint

    def single(scfg, *a, **kw):
        stages.append(tuple(getattr(scfg.train, k) for k in KEYS)
                      + (scfg.field_.tri_resolution,))
        return {}

    def upsample(*a):
        new = a[1] if len(a) == 5 else a[0]  # (old, new, dir, use_grid, log) / (new, dir, log)
        rewrites.append(new.field_.tri_resolution)

    mod._run_training_single, mod._upsample_checkpoint = single, upsample
    try:
        mod._run_progressive(cfg, *args)
    finally:
        mod._run_training_single, mod._upsample_checkpoint = real
    return stages, rewrites


@pytest.mark.parametrize("keep_best", [True, False])
@pytest.mark.parametrize("case", ["committed", "tiny"])
def test_stage_configs_match_the_reference(case, keep_best, tmp_path):
    import tnerf.train_loop as jloop
    import tnerf_torch.train_loop as loop

    if case == "committed":
        jbase, base = JConfig.from_json_file(COMMITTED), Config.from_json_file(COMMITTED)
    else:
        jbase, base = JConfig().apply_overrides(TINY), Config().apply_overrides(TINY)
    ov = [f"train.keep_best={str(keep_best).lower()}", "train.assert_test_psnr_min=25"]
    want = recorded_stages(jloop, jbase.apply_overrides(
        ov + [f"logging.out_dir={tmp_path / 'ref'}"]), {})
    got = recorded_stages(loop, base.apply_overrides(
        ov + [f"logging.out_dir={tmp_path / 'port'}"]), {}, "cpu")
    assert got == want
    stages, rewrites = got
    assert [s[2] for s in stages] == [False] * (len(stages) - 1) + [keep_best]
    assert [s[3] for s in stages] == [0.0] * (len(stages) - 1) + [25.0]
    assert rewrites == [s[4] for s in stages[1:]]
    if case == "committed":
        assert [(s[0], s[1], s[4]) for s in stages] == [
            (625, 625, 32), (1250, 625, 51), (1875, 625, 81), (2500, 625, 128)]


def test_keep_best_writes_the_last_stage_only(tmp_path, capsys):
    from tnerf.grid.occupancy import init_occupancy as j_occ
    from tnerf.train import create_optimizer as j_create, init_train_state as j_init
    from tnerf.train_loop import build_field
    from tnerf.utils.checkpoint import latest_checkpoint
    from tnerf_torch.cli import main

    argv = ["train", "--device", "cpu", "--out", str(tmp_path)]
    for ov in TINY + ["train.keep_best=true", "train.table_l1_weight=1e-5"]:
        argv += ["-o", ov]
    assert main(argv) == 0
    capsys.readouterr()
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs if "psnr_test" in r] == [6, 12, 20]
    best = [r for r in recs if "best_psnr" in r]
    assert best and all(r["best_step"] > 12 for r in best)
    bdir = tmp_path / "checkpoints_best"
    files = sorted(f for f in os.listdir(bdir) if f.endswith(".npz"))
    assert files and all(int(f[5:13]) > 12 for f in files)
    step, path = latest_checkpoint(str(bdir))
    assert step == best[-1]["best_step"] == 20

    # the final config's template: every leaf's shape, the planes at R = 9
    jcfg = JConfig().apply_overrides(TINY + ["train.keep_best=true"]).apply_overrides(
        ["field_.tri_resolution=9", "field_.tri_upsample_steps=[]",
         "field_.tri_init_resolution=0"])
    template = (j_init(build_field(jcfg), j_create(jcfg.train), jcfg.train.seed),
                j_occ(jcfg.grid))
    with np.load(path) as z:
        shapes = [z[f"leaf_{i}"].shape for i in range(len(z.files))]
    assert shapes == [np.shape(x) for x in jax.tree.leaves(template)]
    assert (3, 81, 4) in shapes
    assert main(["eval", "--device", "cpu", "--config", str(tmp_path / "config.json"),
                 "--checkpoint", str(bdir)]) == 0
    evaluated = json.loads(capsys.readouterr().out)
    final = [r for r in recs if r["step"] == 20 and "psnr_test" in r][0]
    assert abs(evaluated["psnr_test"] - final["psnr_test"]) < 1e-4
