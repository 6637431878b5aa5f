#!/usr/bin/env python3
"""How far the renderer's sample-jitter stream alone moves a trained field's
PSNR, one rank on one NVIDIA card.

    python3 tools/torch_jitter_streams.py [--config runs/hard_r3_triplane_prog/config.json] \
        [--streams shared,0,1,2]

Trains the config through `train_loop.run_training` once per stream, from
the same initial weights; only the generator that the renderers draw
their sample jitter from differs (and with it, under `shared`, the later
draws of the batches and probes, which come from the same generator):
- `shared`: the one-rank run's (the generator that also draws the batches
  and the probes, `train_loop.jitter_generator` off a mesh);
- an integer k: a generator of its own, seeded as `jitter_generator` seeds
  "data" shard k's stream on a mesh of several "data" ranks.  Stream 0 is
  what the ranks of a table-parallel run at data_parallel = 1 would draw
  if every mesh, one "data" rank included, drew per-shard streams.
Each run keeps the config's gate off and logs every 250 steps; of its
output directory, chiprun_out/jitter_streams/<stream>, only config.json and
metrics.jsonl are kept.  Writes chiprun_out/jitter_streams.json: per
stream the final psnr_test, psnr_test_min and seconds, with the card's
name and power limit.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def stream_generator(k):
    """A `train_loop.jitter_generator` that draws from "data" shard k's
    stream whatever the mesh."""
    import numpy as np
    import torch

    def jitter_generator(cfg, mesh, gen):
        g = torch.Generator(device=gen.device)
        g.manual_seed(int(np.random.SeedSequence([cfg.train.seed + 1, k]).generate_state(1)[0]))
        return g

    return jitter_generator


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join(REPO, "runs", "hard_r3_triplane_prog",
                                                      "config.json"))
    ap.add_argument("--streams", default="shared,0,1,2")
    args = ap.parse_args()

    import torch

    from tnerf_torch import train_loop
    from tnerf_torch.config import Config

    if not torch.cuda.is_available():
        sys.exit("torch_jitter_streams: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    shared = train_loop.jitter_generator
    out = os.path.join(REPO, "chiprun_out")
    report = {"card": smi.splitlines()[0], "config": os.path.relpath(args.config, REPO),
              "runs": {}}
    for name in args.streams.split(","):
        train_loop.jitter_generator = shared if name == "shared" else stream_generator(int(name))
        cfg = Config.from_json_file(args.config).apply_overrides([
            f"logging.out_dir={os.path.join(out, 'jitter_streams', name)}",
            "train.assert_test_psnr_min=0", "train.log_every=250"])
        t0 = time.perf_counter()
        final = train_loop.run_training(cfg, device="cuda")
        report["runs"][name] = {"psnr_test": final["psnr_test"],
                                "psnr_test_min": final["psnr_test_min"],
                                "seconds": time.perf_counter() - t0}
        print(f"stream {name}: {json.dumps(report['runs'][name])}", flush=True)
        for sub in os.listdir(cfg.logging.out_dir):  # keep metrics.jsonl and config.json
            if os.path.isdir(os.path.join(cfg.logging.out_dir, sub)):
                shutil.rmtree(os.path.join(cfg.logging.out_dir, sub))
    train_loop.jitter_generator = shared
    with open(os.path.join(out, "jitter_streams.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
