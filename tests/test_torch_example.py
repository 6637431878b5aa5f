"""examples/train_and_render_torch.py, the port's library-usage example, run
end to end on the CPU in a subprocess: 2 training steps of the procedural
prims scene at 16 x 16 through the kernels' plain versions, then the
checkpoint read back and one held-out view and its depth map written."""

import json
import os
import subprocess
import sys

import numpy as np


def test_example_script_runs_on_the_cpu(tmp_path):
    out = tmp_path / "ex"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd() + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "examples/train_and_render_torch.py", str(out), "2", "--cpu",
         "--size", "16"], capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "from step 2" in proc.stdout
    from PIL import Image

    for name in ("example_view.png", "example_depth.png"):
        assert Image.open(out / name).size == (16, 16)
    cfg = json.load(open(out / "config.json"))
    assert cfg["render"]["pipeline"] == "grid_march" and cfg["train"]["steps"] == 2
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert (out / "checkpoints").is_dir() and (out / "checkpoints_best").is_dir()
