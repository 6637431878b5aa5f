#!/usr/bin/env python3
"""A table field's streams from the reference's initial state: the port's
streams under each lookup mode against the reference's.

    python3 tools/hash_init_band.py                   # the hash grid's fog
    python3 tools/hash_init_band.py --field triplane  # the progressive triplane
    python3 tools/hash_init_band.py --from port       # both, from the port's weights

`--from port` compares the two packages from the port's own step-0 state of
seed 1337 (runs/hard_r5_hashgrid_diffuse_port_init/ and
runs/hard_r3_triplane_prog_port_init/, the state the `fields` runs start
from): the port's gather streams on the card (`port_streams/gather_sK.jsonl`,
`chip_smoke.py --phases hash_port_init` / `tri_port_init`) against the
reference's on the CPU (`ref_streams/stream_K.jsonl`,
tools/reference_from_port_state.sh <config> <the state's npz> <out>
train.seed=<1337 + K>).  For the hash grid it prints each side's fog count
(FOG_DB), the one-sided Fisher exact p of the port's fog rate over the
reference's, and the two-sided exact Mann-Whitney p of the clear runs'
final test PSNRs where each side has at least MIN_CLEAR clear runs; for
the triplane the two-sided exact Mann-Whitney p of the final test PSNRs.
The two laws are "apart" where one of these p is under RANK_P (0.05, fixed
before the first of these streams ran); a field whose laws are apart is
held by `chip_smoke.py` to its one anchor run, not to the reference's band.
Then, for each class, the band of the reference's committed streams
(least and greatest final test PSNR widened by MARGIN_DB) and the port's
runs inside it, and the gate `chip_smoke.reference_bands` holds the
`fields` run to.  For the hash grid it also prints the two-sided exact
Mann-Whitney p of the fogged runs' final test PSNRs: a comparison added
after the port's streams were read, so not one of the tests above, which
decide "apart".

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
A stream is fogged when its final test PSNR (at chip_smoke.FIELD_STEPS,
the config's last step) is under FOG_DB (the rule of `chip_smoke.HASH_FOG_DB`, fixed
before the first run); a stream that has not reached that step is left
out of the counts.  It prints each group's streams and
count, the band (least, greatest) of occupancy_frac over the clear and
over the fogged streams of each group at every 250th logged step, the
step from which each fogged stream's occupancy_frac stays above the
clear port streams' band, how well a threshold on occupancy_frac at step
WINDOW_STEP tells the port's fogged streams from the clear ones, and the
one-sided Fisher exact p-values of the fog
counts: port gather against the reference (is the port's rate higher?),
one-hot against gather (is one-hot's rate lower?).  Reads the streams
with `chip_smoke.committed_streams`; needs only the standard library.
"""

import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import (CONFIG_HASH, CONFIG_TRIPLANE, committed_streams,  # noqa: E402
                        reference_bands)

PORT = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse_port")
REF = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse_ref_streams")
TRI_PORT = os.path.join(REPO, "runs", "hard_r3_triplane_prog_port")
TRI_REF = os.path.join(REPO, "runs", "hard_r3_triplane_prog_ref_streams")
HASH_PORT_INIT = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse_port_init")
TRI_PORT_INIT = os.path.join(REPO, "runs", "hard_r3_triplane_prog_port_init")
FOG_DB = 39.0
MARGIN_DB = 1.5  # chip_smoke.TRAIN_PSNR_MARGIN_DB: a band is the streams' range widened by it
RANK_P = 0.05
MIN_CLEAR = 3  # clear runs a side needs before their PSNRs are compared
EVERY = 250
WINDOW_STEP = 1000  # an early window: does the fog show there yet?


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
    groups = {"port gather": committed_streams(TRI_PORT, "gather_s"),
              "port one-hot": committed_streams(TRI_PORT, "onehot_s"),
              "reference": committed_streams(TRI_REF)}
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


def rank_test(tag, a, b):
    """Print the two-sided exact Mann-Whitney p of a against b; its p."""
    u, p = mann_whitney(a, b)
    print(f"{tag}: port ({len(a)}) against the reference ({len(b)}): Mann-Whitney U = {u:g} of "
          f"{len(a) * len(b)}, two-sided exact p = {p:.4f}: "
          f"{'apart' if p < RANK_P else 'not apart'} (apart under {RANK_P})")
    return p


def from_port_main() -> int:
    """Both table fields from the port's own step-0 state: each side's final
    test PSNRs, the hash grid's fog counts, the laws' p values, the bands of
    the reference's streams and the gate."""
    for field, config, run_dir, fog_db in (
            ("hash grid", CONFIG_HASH, HASH_PORT_INIT, FOG_DB),
            ("triplane", CONFIG_TRIPLANE, TRI_PORT_INIT, None)):
        sides = {"port": committed_streams(os.path.join(run_dir, "port_streams"), "gather_s"),
                 "reference": committed_streams(os.path.join(run_dir, "ref_streams"))}
        finals = {}
        for tag, streams in sides.items():
            done = [s for s in streams if s[2] is not None]
            finals[tag] = vals = [psnr for _, _, psnr in done]
            if not vals:
                print(f"{field} {tag}: no stream with a final eval")
                continue
            fogged = (f", {sum(v < fog_db for v in vals)} fogged (under {fog_db} dB)"
                      if fog_db is not None else "")
            print(f"{field} {tag}: {len(vals)} streams{fogged}, final psnr_test mean "
                  f"{sum(vals) / len(vals):.4f}, range [{min(vals):.4f}, {max(vals):.4f}]; "
                  f"acc_mean at step 0 {band(streams, 0, 'acc_mean')}")
            print("  " + ", ".join(f"{name} {psnr:.4f}" for name, _, psnr in done))
        port, ref = finals["port"], finals["reference"]
        if not (port and ref):
            continue
        apart = False
        classes = {"all": (lambda v: True)}
        if fog_db is not None:
            classes = {"fogged": (lambda v: v < fog_db), "clear": (lambda v: v >= fog_db)}
            fp, fr = sum(v < fog_db for v in port), sum(v < fog_db for v in ref)
            p = fisher_greater(fp, len(port), fr, len(ref))
            apart |= p < RANK_P
            print(f"{field}: fogged port {fp}/{len(port)} against the reference {fr}/{len(ref)}: "
                  f"one-sided Fisher p = {p:.4f} (the port's rate higher): "
                  f"{'apart' if p < RANK_P else 'not apart'} (apart under {RANK_P})")
            cp, cr = [v for v in port if v >= fog_db], [v for v in ref if v >= fog_db]
            if min(len(cp), len(cr)) >= MIN_CLEAR:
                apart |= rank_test(f"{field} clear runs", cp, cr) < RANK_P
            else:
                print(f"{field} clear runs: {len(cp)} port, {len(cr)} reference: fewer than "
                      f"{MIN_CLEAR} on a side, not compared")
        else:
            apart |= rank_test(field, port, ref) < RANK_P
        print(f"{field}: the laws are {'APART' if apart else 'not apart'} by the tests fixed "
              "before the run")
        if fog_db is not None:
            rank_test(f"{field} fogged runs (added after the port's streams were read)",
                      [v for v in port if v < fog_db], [v for v in ref if v < fog_db])
        for cls, member in classes.items():
            vals = [v for v in ref if member(v)]
            mine = [v for v in port if member(v)]
            if not vals:
                print(f"{field} {cls} streams: the reference showed none: no band "
                      f"({len(mine)} port runs)")
                continue
            lo, hi = min(vals) - MARGIN_DB, max(vals) + MARGIN_DB
            out = [v for v in mine if not lo <= v <= hi]
            print(f"{field} {cls} streams: band [{lo:.4f}, {hi:.4f}] over {len(vals)} reference "
                  f"streams; {len(mine) - len(out)} of {len(mine)} port runs inside")
        lo, hi, n = reference_bands(config)
        inside = sum(lo <= v <= hi for v in port)
        print(f"{field} gate (chip_smoke.reference_bands): [{lo:.4f}, {hi:.4f}] over {n} "
              f"reference runs; {inside} of {len(port)} port runs inside")
    return 0


def main() -> int:
    if sys.argv[1:] == ["--field", "triplane"]:
        return triplane_main()
    if sys.argv[1:] == ["--from", "port"]:
        return from_port_main()
    if sys.argv[1:] not in ([], ["--field", "hashgrid"]):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    groups = {"port gather": committed_streams(PORT, "gather_s"),
              "port one-hot": committed_streams(PORT, "onehot_s"),
              "reference": committed_streams(REF)}
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
