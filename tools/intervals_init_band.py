#!/usr/bin/env python3
"""The reference's intervals run against the band of the port's streams.

    python3 tools/intervals_init_band.py [metrics.jsonl ...]

Each argument is the metrics.jsonl of one `chip_smoke.py --phases
intervals_init --stream K` run (runs/hard_r4_intervals16/config.json
trained by the port from the reference's initial state, one batch and
jitter stream each); by default the streams committed under
runs/hard_r4_intervals16_port/.  For every logged window it prints the
band (least, greatest) of the streams' loss, train_psnr, acc_mean and
occupancy_frac beside the reference's run (runs/hard_r4_intervals16/
metrics.jsonl), marks each reference value outside its band, names the
first window whose occupancy_frac or acc_mean leaves the band, and prints
each stream's final test PSNR.  Needs only the standard library.
"""

import glob
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "runs", "hard_r4_intervals16", "metrics.jsonl")
STREAMS = os.path.join(REPO, "runs", "hard_r4_intervals16_port", "stream_*.jsonl")
KEYS = ("loss", "train_psnr", "acc_mean", "occupancy_frac")
WATCHED = ("acc_mean", "occupancy_frac")


def records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def windows(recs):
    return {r["step"]: r for r in recs if "loss" in r}


def final_test(recs):
    tests = [r for r in recs if "psnr_test" in r]
    return tests[-1] if tests else None


def main(paths) -> int:
    paths = paths or sorted(glob.glob(STREAMS))
    if not paths:
        print(f"no stream metrics given and none under {STREAMS}", file=sys.stderr)
        return 1
    streams = [records(p) for p in paths]
    ref = records(REFERENCE)
    ref_w = windows(ref)
    print(f"{len(paths)} streams: " + ", ".join(os.path.relpath(p, REPO) for p in paths))
    print("step | " + " | ".join(f"{k}: band / reference" for k in KEYS))
    first = None
    for step in sorted(ref_w):
        cells = []
        for k in KEYS:
            vals = [windows(s)[step][k] for s in streams if step in windows(s)]
            if not vals:
                cells.append(f"{k}: no stream logged step {step}")
                continue
            lo, hi, r = min(vals), max(vals), ref_w[step][k]
            out = not lo <= r <= hi
            cells.append(f"[{lo:.6g}, {hi:.6g}] / {r:.6g}{' OUT' if out else ''}")
            if out and k in WATCHED and first is None:
                first = (step, k)
        print(f"{step:5d} | " + " | ".join(cells))
    if first is None:
        print("no window's acc_mean or occupancy_frac leaves the streams' band")
    else:
        print(f"first window outside the band: step {first[0]} ({first[1]})")
    ref_final = final_test(ref)
    for p, s in zip(paths, streams):
        f = final_test(s)
        print(f"{os.path.relpath(p, REPO)}: psnr_test {f['psnr_test']:.4f} dB on "
              f"{f['n_views_test']:.0f} views (the reference's {ref_final['psnr_test']:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
