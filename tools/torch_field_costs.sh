#!/usr/bin/env bash
# The table lookups' gradient schemes against one another at step 1000 of
# each committed table-field config, on the card: each config trained to
# step 1000 through `python -m tnerf_torch.cli train` (the progressive
# triplane with one upsampling, 32 -> 128 at step 625, so that step 1000
# runs at its final resolution), then `tools/torch_field_steps.py` from
# that checkpoint (compacted step device time with each lookup scheme,
# the encode alone, bit-repeatability; chiprun_out/field_steps_<enc>.json).
#
#   bash tools/torch_field_costs.sh        # on a machine with one NVIDIA card
set -eu
cd "$(dirname "$0")/.."
out=_dev/field_costs
rm -rf "$out"
mkdir -p "$out"
for pair in "runs/hard_r5_hashgrid_diffuse/config.json hash" \
            "runs/hard_r4_cp/config.json cp" \
            "runs/hard_r3_triplane_prog/config.json triplane"; do
  set -- $pair
  extra=()
  [[ $2 == triplane ]] && extra=(-o "field_.tri_upsample_steps=[625]")
  python3 -m tnerf_torch.cli train --config "$1" --out "$out/$2" -o train.steps=1000 \
    -o train.checkpoint_every=1000 -o train.eval_every=0 -o train.assert_test_psnr_min=0 \
    -o train.log_every=500 "${extra[@]}" > "$out.$2.log" 2>&1 || { tail -20 "$out.$2.log"; exit 1; }
  python3 tools/torch_field_steps.py --config "$1" --checkpoint "$out/$2/checkpoints"
done
