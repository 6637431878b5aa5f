#!/usr/bin/env bash
# The reference package's streams from the reference's own initial state, on
# the CPU: a config resumed from a committed step-0 state through
# `python -m tnerf.cli train` once per stream K, at train.seed = 1337 + K (the
# batches, the sample jitter and the refresh jitter; the weights are the
# committed ones), for the first STEPS (default 2500, all) steps under the
# schedule of all 2500, logging every 50 steps, the final eval on the test
# views.  Arguments holding "=" are config overrides applied to every stream.
# Each stream's metrics.jsonl is copied to $DEST/stream_K.jsonl; its run
# directory is $RUN_DIR/sK (default _dev/hash_ref, git-ignored).
#
# CONFIG, INIT and DEST name the config, the directory of its step-0 state
# and the directory of the streams' metrics.  They default to the hash grid's
# (runs/hard_r5_hashgrid_diffuse/config.json,
# runs/hard_r5_hashgrid_diffuse_init/checkpoints,
# runs/hard_r5_hashgrid_diffuse_ref_streams).  The progressive triplane:
#
#   CONFIG=runs/hard_r3_triplane_prog/config.json \
#   INIT=runs/hard_r3_triplane_prog_init/checkpoints \
#   DEST=runs/hard_r3_triplane_prog_ref_streams RUN_DIR=../tri_ref \
#     bash tools/hash_ref_streams.sh 0 1
#
# (RUN_DIR outside the checkout: each run keeps its checkpoints, 10-20 MB
# apiece, which would otherwise travel with every copy of the tree.)
#
# A progressive config runs whole: its stages follow from train.steps and
# set their own schedules, and every stage draws afresh from the stream's
# seed, so neither STEPS nor CONTINUE applies to it.
#
# CONTINUE=1 takes each stream on from the last checkpoint of its run
# directory to STEPS, appending to its metrics.jsonl, at train.seed = 1337 +
# K + 1000: the reference derives its key afresh from the seed when it
# resumes, so the stream's own seed would replay the batches and jitter of
# its first steps.  The continuation's draws are fresh ones of the same law.
#
#   STEPS=1000 bash tools/hash_ref_streams.sh 0 1 2 3
#   CONTINUE=1 bash tools/hash_ref_streams.sh 0 1 2 3
#
# For the hash grid, 1000 steps take about 17 min on 6 CPU cores, a whole
# stream 45-65 min on 3 (a fogged run is slower: more live samples).  The
# run's checkpoints (15 MB each for the hash grid) are kept: a continuation
# starts from them.
set -u
cd "$(dirname "$0")/.."
config=${CONFIG:-runs/hard_r5_hashgrid_diffuse/config.json}
init=${INIT:-runs/hard_r5_hashgrid_diffuse_init/checkpoints}
dest=${DEST:-runs/hard_r5_hashgrid_diffuse_ref_streams}
streams=(); overrides=()
for a in "$@"; do
  if [[ $a == *=* ]]; then overrides+=(-o "$a"); else streams+=("$a"); fi
done
runs_dir=${RUN_DIR:-_dev/hash_ref}
mkdir -p "$runs_dir" "$dest"
for k in "${streams[@]}"; do
  out=$runs_dir/s$k
  seed=$((1337 + k))
  if [[ -n ${CONTINUE:-} ]]; then
    seed=$((seed + 1000))
  else
    rm -rf "$out"
    mkdir -p "$out/checkpoints" && cp "$init"/* "$out/checkpoints/"
  fi
  t0=$(date +%s)
  PYTHONPATH=. JAX_PLATFORMS=cpu python -m tnerf.cli train --config "$config" --out "$out" \
    -o train.resume=true -o train.seed=$seed -o train.steps="${STEPS:-2500}" \
    -o train.schedule_total_steps=2500 -o train.log_every=50 -o train.eval_every=0 \
    -o train.checkpoint_every=0 -o train.assert_test_psnr_min=0 \
    ${overrides[@]+"${overrides[@]}"} >> "$out.log" 2>&1 || echo "stream $k exited $?"
  echo "stream $k: $(($(date +%s) - t0)) s"
  grep -E "psnr_test" "$out/metrics.jsonl" | tail -n 1
  cp "$out/metrics.jsonl" "$dest/stream_$k.jsonl"
done
