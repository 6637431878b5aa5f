#!/usr/bin/env bash
# Train a config through `python -m tnerf_torch.cli train` once per seed on
# the card, logging every 50 steps, with the config's acceptance gate off;
# arguments holding "=" are config overrides applied to every run.  With
# `--from <checkpoint dir>` every run starts from that checkpoint (weights,
# Adam moments, occupancy grid; a reference checkpoint too) instead of the
# seed's initial weights, and the seed draws only the batches and samples.
# Each run's metrics.jsonl is copied to chiprun_out/seeds/<tag>_s<seed>.jsonl
# (<tag>: the config's directory, and the overrides if any, and "from").
#
#   bash tools/torch_field_seeds.sh runs/hard_r5_hashgrid_diffuse/config.json 1337 1 2
#   bash tools/torch_field_seeds.sh runs/hard_r5_hashgrid_diffuse/config.json 1337 \
#       field_.hash_gather_mode=onehot
#   bash tools/torch_field_seeds.sh runs/hard_r5_hashgrid_diffuse/config.json 1337 1 \
#       --from _dev/ref_init/checkpoints
#
# A reference checkpoint to start from: `python -m tnerf.cli train --config
# <config> --out _dev/ref_init -o train.steps=0` writes the reference's
# initial state of the config's seed (on the CPU), `-o
# train.checkpoint_every=100` a run's states along the way.
set -u
config=$1; shift
tag=$(basename "$(dirname "$config")")
seeds=(); overrides=(); from=""
while (($#)); do
  a=$1; shift
  if [[ $a == --from ]]; then from=$1; shift; tag="${tag}_from"
  elif [[ $a == *=* ]]; then overrides+=(-o "$a"); tag="${tag}_${a##*=}"
  else seeds+=("$a"); fi
done
[[ -n $from ]] && overrides+=(-o train.resume=true)
mkdir -p _dev/seeds chiprun_out/seeds
for seed in "${seeds[@]}"; do
  out=_dev/seeds/${tag}_s$seed
  rm -rf "$out"
  if [[ -n $from ]]; then mkdir -p "$out/checkpoints" && cp "$from"/* "$out/checkpoints/"; fi
  python3 -m tnerf_torch.cli train --config "$config" --out "$out" -o train.seed="$seed" \
    -o train.log_every=50 -o train.assert_test_psnr_min=0 ${overrides[@]+"${overrides[@]}"} > "$out.log" 2>&1 \
    || echo "seed $seed exited $?"
  grep -E "INFO step [0-9]*(000|500) |psnr_test" "$out.log" | tail -n 12
  cp "$out/metrics.jsonl" "chiprun_out/seeds/${tag}_s$seed.jsonl"
done
