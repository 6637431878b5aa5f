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
#
# A progressive triplane config (field_.tri_upsample_steps set) refuses
# train.steps=0, so its initial state is drawn under its first stage's
# config (field_.tri_resolution=<tri_init_resolution>,
# field_.tri_upsample_steps=[], field_.tri_init_resolution=0): the state the
# progressive run starts from, which both packages resume as stage 1.
set -eu
config=$1; state=$2; out=$3; shift 3
overrides=()
for a in "$@"; do overrides+=(-o "$a"); done
rm -rf "$out"
mkdir -p "$out/checkpoints"
if [[ $state == init ]]; then
  stage0=()
  r0=$(python3 -c 'import json, sys; f = json.load(open(sys.argv[1]))["field_"]
print(f["tri_init_resolution"] if f.get("tri_upsample_steps") else "")' "$config")
  if [[ -n $r0 ]]; then
    stage0=(-o field_.tri_resolution="$r0" -o "field_.tri_upsample_steps=[]"
            -o field_.tri_init_resolution=0)
  fi
  python3 -m tnerf_torch.cli train --config "$config" --device cpu --out "$out/port_init" \
    ${overrides[@]+"${overrides[@]}"} -o train.steps=0 -o train.assert_test_psnr_min=0 \
    ${stage0[@]+"${stage0[@]}"} > "$out/port_init.log" 2>&1
  cp "$out"/port_init/checkpoints/* "$out/checkpoints/"
else
  cp "$state" "$(dirname "$state")/treedef.json" "$out/checkpoints/"
fi
JAX_PLATFORMS=cpu python3 -m tnerf.cli train --config "$config" --out "$out" \
  -o train.resume=true -o train.log_every=50 -o train.checkpoint_every=0 \
  -o train.assert_test_psnr_min=0 ${overrides[@]+"${overrides[@]}"} > "$out/train.log" 2>&1
grep -E "INFO (resumed|step [0-9]*[05]00 )" "$out/train.log"
grep -E "psnr_test" "$out/train.log" | tail -n 2
