#!/usr/bin/env bash
# Train the reference package (tnerf, JAX, on the CPU) from a state of the
# port: the port's initial state of a config at the config's seed, which
# this script writes on the CPU (`python -m tnerf_torch.cli train --device
# cpu -o train.steps=0`, bit-equal to what the port draws on the card), or
# a checkpoint of a port run (weights, Adam moments, occupancy grid).  The
# reference then trains the rest of the config's steps from it
# (`python -m tnerf.cli train -o train.resume=true`), so that the two
# packages can be compared from the same initial weights.  Arguments after
# the output directory are config overrides for both runs.
#
#   bash tools/reference_from_port_state.sh runs/hard_r5_hashgrid_diffuse/config.json init \
#       _dev/ref_from_port/hash
#   bash tools/reference_from_port_state.sh runs/hard_r5_hashgrid_diffuse/config.json \
#       <port run>/checkpoints/step_00000900.npz _dev/ref_from_port/hash900
#
# Writes <out>/metrics.jsonl and <out>/train.log; prints the log's steps
# and the final metrics.  The full-size configs take 30-60 minutes on 8
# CPU cores.
set -eu
config=$1; state=$2; out=$3; shift 3
overrides=()
for a in "$@"; do overrides+=(-o "$a"); done
rm -rf "$out"
mkdir -p "$out/checkpoints"
if [[ $state == init ]]; then
  python3 -m tnerf_torch.cli train --config "$config" --device cpu --out "$out/port_init" \
    -o train.steps=0 -o train.assert_test_psnr_min=0 ${overrides[@]+"${overrides[@]}"} \
    > "$out/port_init.log" 2>&1
  cp "$out"/port_init/checkpoints/* "$out/checkpoints/"
else
  cp "$state" "$(dirname "$state")/treedef.json" "$out/checkpoints/"
fi
JAX_PLATFORMS=cpu python3 -m tnerf.cli train --config "$config" --out "$out" \
  -o train.resume=true -o train.log_every=50 -o train.checkpoint_every=0 \
  -o train.assert_test_psnr_min=0 ${overrides[@]+"${overrides[@]}"} > "$out/train.log" 2>&1
grep -E "INFO (resumed|step [0-9]*[05]00 )" "$out/train.log"
grep -E "psnr_test" "$out/train.log" | tail -n 2
