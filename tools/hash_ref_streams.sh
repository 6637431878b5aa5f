#!/usr/bin/env bash
# The reference package's hash-grid streams from the reference's own initial
# state, on the CPU: runs/hard_r5_hashgrid_diffuse/config.json resumed from
# runs/hard_r5_hashgrid_diffuse_init (step 0 of seed 1337) through
# `python -m tnerf.cli train` once per stream K, at train.seed = 1337 + K (the
# batches, the sample jitter and the refresh jitter; the weights are the
# committed ones), for the first STEPS (default 2500, all) steps under the
# schedule of all 2500, logging every 50 steps, the final eval on the test
# views.  Arguments holding "=" are config overrides applied to every stream.
# Each stream's metrics.jsonl is copied to
# runs/hard_r5_hashgrid_diffuse_ref_streams/stream_K.jsonl; its run directory
# is $RUN_DIR/sK (default _dev/hash_ref, git-ignored).
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
# 1000 steps take about 17 min on 6 CPU cores, a whole stream 45-65 min on
# 3 (a fogged run is slower: more live samples).  The run's checkpoints
# (15 MB each) are kept: a continuation starts from them.
set -u
cd "$(dirname "$0")/.."
config=runs/hard_r5_hashgrid_diffuse/config.json
init=runs/hard_r5_hashgrid_diffuse_init/checkpoints
dest=runs/hard_r5_hashgrid_diffuse_ref_streams
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
