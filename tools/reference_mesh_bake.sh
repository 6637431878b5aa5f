#!/usr/bin/env bash
# The reference package (tnerf, JAX) on the CPU: `cli mesh` and `cli bake
# --eval` of the committed prims checkpoint (runs/suite_rehearsal/prims),
# the records the port's geometry and bake are held to.
#
#   bash tools/reference_mesh_bake.sh
#
# Writes runs/prims_mesh_reference/{config.json,mesh_stats.json,mesh.log}
# (the OBJ itself, mesh.obj, is git-ignored) and
# runs/prims_baked_reference/{config.json,baked_parity.json,bake.log} (the
# npz under baked/ is git-ignored).  About 15-30 minutes on 8 CPU cores,
# most of it the 256^3 bake's 16.7M field queries.
set -eu
cd "$(dirname "$0")/.."
run=runs/suite_rehearsal/prims
mesh_dir=runs/prims_mesh_reference
bake_dir=runs/prims_baked_reference
export JAX_PLATFORMS=cpu
mkdir -p "$mesh_dir" "$bake_dir"

python3 -m tnerf.cli config --config "$run/config.json" \
  -o "logging.out_dir=$mesh_dir" > "$mesh_dir/config.json"
python3 -m tnerf.cli mesh --config "$run/config.json" --checkpoint "$run/checkpoints" \
  --out "$mesh_dir/mesh.obj" --resolution 128 --vertex-colors \
  -o "logging.out_dir=$mesh_dir" > "$mesh_dir/mesh.log" 2>&1
python3 tools/mesh_stats.py "$mesh_dir/mesh.obj" --out "$mesh_dir/mesh_stats.json"

python3 -m tnerf.cli config --config "$run/config.json" \
  -o "logging.out_dir=$bake_dir" > "$bake_dir/config.json"
python3 -m tnerf.cli bake --config "$run/config.json" --checkpoint "$run/checkpoints" \
  --bake-res 256 --eval -o "logging.out_dir=$bake_dir" > "$bake_dir/bake.log" 2>&1
cat "$bake_dir/baked_parity.json"
