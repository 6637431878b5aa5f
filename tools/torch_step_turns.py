#!/usr/bin/env python3
"""Time the port's kernels and its train steps in turns with an earlier
revision of the repository, on one NVIDIA card.

    mkdir -p _dev/parent && git archive <rev> chip_smoke.py tnerf_torch configs \\
        runs/suite_rehearsal/prims runs/hard_r4_intervals16 \\
        runs/hard_r4_intervals16_init | tar -x -C _dev/parent
    python3 tools/torch_step_turns.py --old _dev/parent [--steps intervals,prims,cdf]
        [--no-kernels] [--rounds N]

For each tree in the order old, new, new, old (N rounds of it), processes
of its own, run from that tree:
- `chip_smoke.py --phases kernels` (unless --no-kernels): its kernels
  line, the device time of every kernel at that tree's shapes (B1 / B1t
  at the serving chunk, B2 / B2t at the training batch, B3 / B4 at the
  serving chunk, B5 at the intervals training shape);
- 20 train steps of each of --steps through
  `chip_smoke.profile_train_steps`: host clock per step, device busy time
  per step under torch.profiler and launches per step.  `intervals`:
  `runs/hard_r4_intervals16/config.json` from the committed checkpoint
  `runs/hard_r4_intervals16_init` (the reference's initial state, step 0,
  every cell occupied); `prims`: the prims config from its committed
  checkpoint (step 1500); `cdf`: `configs/procedural_hard_fused_cdf2.json`
  (occupancy-CDF placement, B2t) on the same checkpoint's weights and
  occupancy, drawing the hard scene's rays.
Writes chiprun_out/step_turns.json with the card's name and power limit;
medians over each tree's turns are printed.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = {
    "intervals": ("runs/hard_r4_intervals16/config.json",
                  "runs/hard_r4_intervals16_init/checkpoints"),
    "prims": ("runs/suite_rehearsal/prims/config.json", "runs/suite_rehearsal/prims/checkpoints"),
    "cdf": ("configs/procedural_hard_fused_cdf2.json", "runs/suite_rehearsal/prims/checkpoints"),
}
PROFILE = (
    "import json, os, sys\n"
    "sys.path.insert(0, os.getcwd())\n"
    "import chip_smoke as cs\n"
    "os.makedirs(cs.OUT, exist_ok=True)\n"
    "r = cs.profile_train_steps(os.path.join(cs.REPO, sys.argv[1]), os.path.join(cs.REPO, "
    "sys.argv[2]), sys.argv[3] + '_turns')\n"
    "print('STEP ' + json.dumps(r), flush=True)\n"
)


def run(tree, argv, tag):
    """The JSON object that a line of argv's standard output starting with
    `tag` holds."""
    proc = subprocess.run(argv, cwd=tree, capture_output=True, text=True, timeout=1200)
    if proc.returncode:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"{' '.join(argv)} in {tree} exited {proc.returncode}")
    for line in proc.stdout.splitlines():
        if line.startswith(tag):
            return json.loads(line if tag.startswith("{") else line[len(tag):])
    raise SystemExit(f"{' '.join(argv)} in {tree} printed no {tag!r} line")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="an earlier revision's tree (chip_smoke.py, "
                                                 "tnerf_torch/, configs/, runs/)")
    ap.add_argument("--steps", default="intervals", help=f"comma list of {', '.join(STEPS)}")
    ap.add_argument("--no-kernels", action="store_true", help="leave out the kernels phase")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of old, new, new, old")
    opts = ap.parse_args()
    import numpy as np

    steps = opts.steps.split(",")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    trees = {"old": os.path.abspath(opts.old), "new": REPO}
    turns = []
    for name in ("old", "new", "new", "old") * opts.rounds:
        rec = {"tree": name}
        if not opts.no_kernels:
            kernels = run(trees[name], [sys.executable, "chip_smoke.py", "--phases", "kernels"],
                          '{"kernels"')
            rec["kernel_ms"] = {r["name"]: r["ms"] for r in kernels["kernels"]}
        for tag in steps:
            step = run(trees[name], [sys.executable, "-c", PROFILE, *STEPS[tag], tag], "STEP ")
            rec[tag] = {"host_ms": step["ms_per_step_unprofiled"],
                        "device_ms": step["device_ms_per_step"],
                        "launches": step["kernels_per_step"]}
        turns.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {}
    for name in ("old", "new"):
        mine = [t for t in turns if t["tree"] == name]
        summary[name] = {tag: {k: float(np.median([t[tag][k] for t in mine]))
                               for k in ("host_ms", "device_ms", "launches")} for tag in steps}
        if not opts.no_kernels:
            summary[name]["kernel_ms"] = {k: float(np.median([t["kernel_ms"][k] for t in mine]))
                                          for k in mine[0]["kernel_ms"]}
    print("medians", json.dumps(summary), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "step_turns.json"), "w") as fh:
        json.dump({"card": card, "turns": turns, "medians": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
