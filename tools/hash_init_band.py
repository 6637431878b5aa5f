#!/usr/bin/env python3
"""A table field's streams from the reference's initial state: the port's
streams under each lookup mode against the reference's.

    python3 tools/hash_init_band.py                   # the hash grid's fog
    python3 tools/hash_init_band.py --field triplane  # the progressive triplane

The triplane's streams (runs/hard_r3_triplane_prog_port/ and
runs/hard_r3_triplane_prog_ref_streams/, `chip_smoke.py --phases tri_init`
and tools/hash_ref_streams.sh with CONFIG / INIT / DEST) are not classed:
it prints each group's final test PSNRs, their mean and range, the band
(least, greatest) of occupancy_frac and of the loss at every 250th logged
step, and the two-sided exact Mann-Whitney p of the port's gather streams
against the reference's and of one-hot against gather (RANK_P: "apart"
under it, fixed before the first run).

The hash grid's, as follows.

Reads the streams committed under runs/hard_r5_hashgrid_diffuse_port/
(`gather_sK.jsonl`, `onehot_sK.jsonl`: `chip_smoke.py --phases hash_init`,
runs/hard_r5_hashgrid_diffuse/config.json trained by the port on the card
from runs/hard_r5_hashgrid_diffuse_init) and
runs/hard_r5_hashgrid_diffuse_ref_streams/ (`stream_K.jsonl`:
tools/hash_ref_streams.sh, the reference on the CPU from the same state).
A stream is fogged when its final test PSNR (at FINAL_STEP, the config's
last step) is under FOG_DB (the rule of `chip_smoke.HASH_FOG_DB`, fixed
before the first run); a stream that has not reached FINAL_STEP is left
out of the counts.  It prints each group's streams and
count, the band (least, greatest) of occupancy_frac over the clear and
over the fogged streams of each group at every 250th logged step, the
step from which each fogged stream's occupancy_frac stays above the
clear port streams' band, how well a threshold on occupancy_frac at step
WINDOW_STEP tells the port's fogged streams from the clear ones, and the
one-sided Fisher exact p-values of the fog
counts: port gather against the reference (is the port's rate higher?),
one-hot against gather (is one-hot's rate lower?).  Needs only the
standard library.
"""

import glob
import json
import math
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse_port")
REF = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse_ref_streams")
TRI_PORT = os.path.join(REPO, "runs", "hard_r3_triplane_prog_port")
TRI_REF = os.path.join(REPO, "runs", "hard_r3_triplane_prog_ref_streams")
FOG_DB = 39.0
RANK_P = 0.05
FINAL_STEP = 2500  # the config's train.steps: the final eval
EVERY = 250
WINDOW_STEP = 1000  # an early window: does the fog show there yet?


def records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def stream(path):
    """(name, {step: logged window}, final psnr_test or None)."""
    recs = records(path)
    tests = [r["psnr_test"] for r in recs if "psnr_test" in r and r["step"] == FINAL_STEP]
    name = os.path.splitext(os.path.basename(path))[0]
    return name, {r["step"]: r for r in recs if "loss" in r}, (tests[-1] if tests else None)


def group(pattern):
    def key(p):
        return int(re.findall(r"\d+", os.path.basename(p))[-1])
    return [stream(p) for p in sorted(glob.glob(pattern), key=key)]


def fisher_greater(a, n1, b, n2):
    """One-sided Fisher exact p: the chance, with the margins fixed, that
    the first group counts a or more of the a + b events."""
    k, n = a + b, n1 + n2
    total = math.comb(n, k)
    return sum(math.comb(n1, i) * math.comb(n2, k - i)
               for i in range(a, min(k, n1) + 1)) / total


def band(streams, step, key="occupancy_frac", fmt=".4f"):
    vals = [w[step][key] for _, w, _ in streams if step in w]
    return f"[{min(vals):{fmt}}, {max(vals):{fmt}}] ({len(vals)})" if vals else "-"


def mann_whitney(a, b):
    """(U of a, two-sided exact p) of the Mann-Whitney rank test: the chance
    under one shuffled pool that U lies as far from its centre (ties count
    a half; the exact law is that of untied samples)."""
    u = sum((x > y) + 0.5 * (x == y) for x in a for y in b)
    n1, n2 = len(a), len(b)
    # ways[k][j]: arrangements of k of the first and j of the second sample
    # by the count of (first, second) pairs in which the first is larger
    ways = [[[1] for _ in range(n2 + 1)]]
    for k in range(1, n1 + 1):
        row = [[1]]
        for j in range(1, n2 + 1):
            left, down = row[j - 1], ways[k - 1][j]
            # the largest of the pool is a first-sample value (j pairs more)
            # or a second-sample one
            out = [0] * (k * j + 1)
            for v, c in enumerate(down):
                out[v + j] += c
            for v, c in enumerate(left):
                out[v] += c
            row.append(out)
        ways.append(row)
    dist = ways[n1][n2]
    total = math.comb(n1 + n2, n1)
    centre = n1 * n2 / 2
    far = sum(c for v, c in enumerate(dist) if abs(v - centre) >= abs(u - centre) - 1e-9)
    return u, min(1.0, far / total)


def triplane_main() -> int:
    groups = {"port gather": group(os.path.join(TRI_PORT, "gather_s*.jsonl")),
              "port one-hot": group(os.path.join(TRI_PORT, "onehot_s*.jsonl")),
              "reference": group(os.path.join(TRI_REF, "stream_*.jsonl"))}
    finals = {}
    for tag, streams in groups.items():
        done = [s for s in streams if s[2] is not None]
        finals[tag] = [psnr for _, _, psnr in done]
        if not done:
            print(f"{tag}: no stream with a final eval")
            continue
        vals = finals[tag]
        print(f"{tag}: {len(done)} streams, final psnr_test mean {sum(vals) / len(vals):.4f}, "
              f"range [{min(vals):.4f}, {max(vals):.4f}]"
              + (f"; {len(streams) - len(done)} without a final eval"
                 if len(done) < len(streams) else ""))
        print("  " + ", ".join(f"{name} {psnr:.4f}" for name, _, psnr in done))
    steps = sorted({st for _, w, _ in groups["port gather"] for st in w})
    print("step | " + " | ".join(f"{tag} occupancy_frac | {tag} loss" for tag in groups))
    for st in [s for s in steps if s % EVERY == 0 or s == steps[-1]]:
        cells = []
        for streams in groups.values():
            cells += [band(streams, st), band(streams, st, "loss", ".3e")]
        print(f"{st:5d} | " + " | ".join(cells))
    for a, b in (("port gather", "reference"), ("port one-hot", "port gather")):
        if finals[a] and finals[b]:
            u, p = mann_whitney(finals[a], finals[b])
            print(f"{a} ({len(finals[a])}) against {b} ({len(finals[b])}): Mann-Whitney U = "
                  f"{u:g} of {len(finals[a]) * len(finals[b])}, two-sided exact p = {p:.4f}: "
                  f"{'apart' if p < RANK_P else 'not apart'} (apart under {RANK_P})")
    return 0


def main() -> int:
    if sys.argv[1:] == ["--field", "triplane"]:
        return triplane_main()
    if sys.argv[1:] not in ([], ["--field", "hashgrid"]):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    groups = {"port gather": group(os.path.join(PORT, "gather_s*.jsonl")),
              "port one-hot": group(os.path.join(PORT, "onehot_s*.jsonl")),
              "reference": group(os.path.join(REF, "stream_*.jsonl"))}
    counts = {}
    for tag, streams in groups.items():
        done = [s for s in streams if s[2] is not None]
        fogged = [s for s in done if s[2] < FOG_DB]
        counts[tag] = (len(fogged), len(done))
        print(f"{tag}: {len(fogged)} of {len(done)} fogged (final psnr_test under {FOG_DB} dB)"
              + (f"; {len(streams) - len(done)} without a final eval" if len(done) < len(streams)
                 else ""))
        for name, _, psnr in done:
            print(f"  {name}: {psnr:.4f} dB {'FOGGED' if psnr < FOG_DB else 'clear'}")
    clear_port = [s for s in groups["port gather"] if s[2] is not None and s[2] >= FOG_DB]
    steps = sorted({st for _, w, _ in clear_port for st in w})
    print("occupancy_frac, step | " + " | ".join(
        f"{tag} clear | {tag} fogged" for tag in groups))
    for st in [s for s in steps if s % EVERY == 0 or s == steps[-1]]:
        cells = []
        for tag, streams in groups.items():
            done = [s for s in streams if s[2] is not None]
            cells += [band([s for s in done if s[2] >= FOG_DB], st),
                      band([s for s in done if s[2] < FOG_DB], st)]
        print(f"{st:5d} | " + " | ".join(cells))
    for tag, streams in groups.items():
        for name, w, psnr in streams:
            if psnr is None or psnr >= FOG_DB:
                continue
            out = [st for st in steps if st in w and any(st in c[1] for c in clear_port)
                   and w[st]["occupancy_frac"] > max(c[1][st]["occupancy_frac"]
                                                     for c in clear_port if st in c[1])]
            later = [st for st in steps if st in w]
            first = next((st for st in out if all(s in out for s in later if s >= st)), None)
            print(f"{tag} {name}: occupancy_frac above the clear port streams' band from step "
                  f"{first} to the end")
    # the best rule "fogged when occupancy_frac at WINDOW_STEP is over a
    # threshold" on the port's gather streams: how far that early window
    # tells the fogged streams from the clear ones
    done = [(w[WINDOW_STEP]["occupancy_frac"], psnr < FOG_DB)
            for _, w, psnr in groups["port gather"] if psnr is not None and WINDOW_STEP in w]
    if done:
        best = max((sum((occ > thr) == fog for occ, fog in done), thr)
                   for thr in sorted({occ for occ, _ in done}))
        print(f"occupancy_frac at step {WINDOW_STEP} over {best[1]:.4f} as the fog rule: "
              f"{best[0]} of {len(done)} port gather streams classed right (the best threshold)")
    (fg, ng), (fo, no), (fr, nr) = (counts[t] for t in groups)
    if ng and nr:
        print(f"port gather {fg}/{ng} against the reference {fr}/{nr}: one-sided Fisher p = "
              f"{fisher_greater(fg, ng, fr, nr):.4f} (the port's rate higher)")
    if ng and no:
        print(f"port one-hot {fo}/{no} against port gather {fg}/{ng}: one-sided Fisher p = "
              f"{fisher_greater(fg, ng, fo, no):.4f} (one-hot's rate lower)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
