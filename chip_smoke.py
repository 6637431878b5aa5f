#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`tnerf_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. print the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build every kernel of tnerf_torch/csrc with nvcc for sm_90a;
  3. `kernels`: hold each kernel against its plain PyTorch version on the
     card, at the main paths' shapes, and time both.  Serving: one 32768-ray
     chunk of a 400x400 test view of the committed prims model, 64 samples
     per ray: B3 tighten and B4 tighten + sample mask bit-equal (B4 at n = 64
     on the kernel's pooling and at n = cdf_bins on the bin pooling, with
     the model's occupancy and a random 32^3 bitfield), B1 fused forward and
     its per-sample instantiation B1t (on inverse-CDF samples built from the
     model's occupancy, and on the affine ts = te + (s + 0.5) dt against B1)
     within the bf16 tolerance; the CDF placement itself on the card against
     the CPU (how many samples a tie at a CDF edge sends to another bin).  Training: a batch of 8192 rays drawn from
     the train views x 64 samples, with the committed weights and occupancy
     and a seeded cotangent: B2 fused backward and B2t (and B1's / B1t's
     per-chunk transmittance) against the plain versions at term_eps = 0,
     at 64, 256 (four chunks per ray: the saved transmittance and the dL/dT
     carry), 32 (two rays per tile) and 100 samples per ray (a ragged last
     chunk), on batches that leave the kernel's persistent grid a ragged
     last round, and with a 2-layer MLP of random weights; at depth
     (check_deep_backward), B2 and B2t at 9, 10, 13 and 17 layers of random
     weights at the committed model's widths on the training batch's rays
     (past 9 the kernel spills layer inputs to its scratch), each leaf and
     each layer whose input or output gradient passes through the
     scratch's slots, a ragged batch at 13, two launches at 17 within
     B2_RTOL of each other, times at 13 and 17 (b2_deep.json); at 256
     samples and 13 layers of a dense random model under the config's
     term_eps (check_deep_skip), the chunks B1 leaves unshaded equal to
     those B2 skips and the rule's, and B2's gradient within B2_RTOL of
     the plain version's with the same chunks masked.
     B1 / B1t beyond that: 2 and 12 layers of random weights, a ragged
     batch of 1001 rays, two launches bit for bit, and at 256 samples
     under the config's term_eps the chunks B1 leaves unshaded equal to
     those B2 skips and to the rule
     `unshaded_chunks` states; the forward's branch-free sine bit-equal to
     sinf over 2.1e7 arguments.  B3 and B4 beyond that (check_probe_kernels):
     bit-equal at the training batch of both uses, at res_c = 1, 7, 16, 32
     with model, random, empty and full bitfields at 64, 100 and 256
     probes, with rays whose te == tx, at B = 1, 1001 and 66,000, at every
     lane group the kernels build, two launches bit for bit, and the
     kernels' cell ids (by the reciprocal of the cell size, as the
     reference's XLA computes them) bit-equal to the plain versions'
     arithmetic over 2.1e7 arguments.  The table lookups' sort and segment
     sum (check_segment_edges) bit-equal to their plain versions, twice,
     at no lookup, no row, one row, most rows empty, CP- and hash-grid-like
     shapes, three digit passes, payloads of 1-5 words, 300 features and
     a skewed multiplicity.  Every kernel's `ms` is its device time
     (torch.profiler, at least 50 launches), `wrapper_ms` the host clock
     per call of its wrapper; B3 / B4 are timed at the training batch, the
     serving chunk, the march eval and 66,000 rays, with the share of
     probes their scan evaluates (probe_kernels.json);
  4. `serve`: `tnerf_torch.cli eval` of runs/suite_rehearsal/prims with its
     config as committed (render.ray_compact=true; val + test views at
     400x400), launch counts set to 0 just before and read just after; B4
     and B1 must have launched, and the test PSNR must be within 0.1 dB of
     the reference package's record; one test view rendered with and
     without ray compaction; one 800x800 `cli render --orbit 1` frame;
  5. `train`: `tnerf_torch.cli train` of the same config from scratch, all
     1500 steps at full width: B1, B2 and B3 each at least once per step,
     test PSNR within TRAIN_PSNR_MARGIN_DB of the reference's record and
     over the config's own gate; ms/step and rays/s of the last window;
  5b. `deep`: `tnerf_torch.cli train` of the same config at
     field_.hidden_layers=12 (13 layers; DEEP_OVERRIDES), all 1500 steps:
     B1, B2 and B3 each at least once per step, test PSNR no more than
     TRAIN_PSNR_MARGIN_DB under the 9-layer record (a sanity bar: no
     record of this depth exists); its `cli eval` (the run's own PSNR) and
     one 800x800 `cli render` frame; configs/procedural_hard_fused_cdf2.json
     at the same depth for DEEP_CDF_STEPS steps: B2t every step, the loss
     falling;
  6. `resume`: the committed reference checkpoint (step 1500, with its Adam
     moments) resumed for 50 steps: the train loss must stay under
     RESUME_LOSS_MAX; then 20 steps under torch.profiler;
  7. `cdf`: `tnerf_torch.cli train` of configs/procedural_hard_fused_cdf2.json
     (occupancy-CDF placement) at full width, its first 2500 of 5000 steps
     under the full schedule (CDF_TRAIN_OVERRIDES, for the time limit): B4,
     B1t and B2t each at least once per step, no step skipped, its eval at
     step 2499 within TRAIN_PSNR_MARGIN_DB of the reference's at that step,
     the final eval over the config's gate; `cli eval` of that checkpoint with the config as committed (ray
     compaction on): within 0.1 dB of the run's own uncompacted eval; one
     800x800 orbit frame; 20 CDF train steps under torch.profiler;
  8. `march`: `tnerf_torch.cli eval` of the prims checkpoint through
     render.pipeline=grid_march (the march settings of
     configs/procedural_hard_30db.json), under uniform, occupancy-CDF and
     density-CDF placement, each with and without ray and sample
     compaction: B4 launched, test PSNR within MARCH_SERVE_TOL_DB of the
     fused eval's, one view equal across the compaction variants; then
     `cli train` of configs/procedural_hard_30db.json, its first 2500 of
     5000 steps under the full schedule (MARCH_TRAIN_OVERRIDES, for the
     time limit): its eval at step 2499 within TRAIN_PSNR_MARGIN_DB of the
     reference's at that step, the final eval over the config's gate, B4
     launched by its evals; 20 steps under torch.profiler;
  9. `intervals`: `cli train` of runs/hard_r4_intervals16/config.json
     (train.seed=3: see INTERVALS_OVERRIDES), its first 250 of 2500 steps
     under the full schedule: B5 at least once per step, the loss falling;
     `cli eval` of its checkpoint: B5 at least once per eval chunk, the
     test PSNR the run's own within PSNR_TOL_DB (the PSNR gate against the
     reference's record is `intervals_full`'s);
 10. `fields`: the table-backed fields through grid_march: `cli train` of
     runs/hard_r5_hashgrid_diffuse (hash grid, SH view encoding,
     occupancy-CDF placement), runs/hard_r4_cp and
     runs/hard_r3_triplane_prog (three upsampling stages) as committed,
     2500 steps each from the port's step-0 state of the committed seed:
     test PSNR inside the band of what the reference reaches from that
     state (FIELD_GATES: the triplane's committed streams, the hash grid's
     and CP's one run each; the gap to the reference's record printed)
     and over the config's gate, B4
     launched by the evals;
     the hash grid's `cli eval` (the run's own PSNR) and `cli bake
     --bake-res 320 --eval` of its checkpoint (baked within
     HASH_BAKE_PARITY_DB of the march render of the same checkpoint, the
     absolute PSNRs printed beside the reference's record, B4 launched);
     20 steps of each under torch.profiler, with the position
     encoding's forward and backward timed alone at a step's own samples
     and two backward passes there bit-equal; the lookups' table gradient
     on the step's first lookup (the stable sort by row, csrc/
     segment_sort.cu, and the segment sum, csrc/segment_sum.cu), each
     bit-equal to its plain version twice, a call's kernels listed (the
     repo's alone), the whole call timed in turns against its former path
     (`torch.sort` + `torch.searchsorted` + tools/segment_sum_parent.cu)
     beside `index_add_` and its byte bound (segment_calls.json; the
     rows in the kernels' line are the hash grid's); 20 compacted steps
     from the trained state in turns against the former path, which must
     leave the same state to the bit (tools/torch_segment_turns.py);
 11. `scenes`: scenes read from disk, NDC and pose refinement through the
     entry points.  (a) `cli train` of the LLFF capture data/llff/prims_ff
     in world space with tools/llff_rehearsal.py's overrides (grid_march,
     the first SCENE_SHORT_STEPS of its 2500 steps under the schedule of
     all 2500): the loader's splits and focal the reference's, the loss
     falling, B4 launched by the evals and bit-equal to its plain version
     on a 480x360 view's rays (`scenes_full`, an extra phase, trains all
     2500 steps: test PSNR within TRAIN_PSNR_MARGIN_DB of its record and
     over 30 dB); (b) `cli train` of runs/colmap_rehearsal/ config.json as
     committed (COLMAP text model, NDC, cut and gated as (a); the data
     root set to the checkout's): the same gates, B4 bit-equal on the
     NDC rays of a test view, `cli render` of a test view and `--path` of
     three poses, `--orbit 1` refused; (c) the prims model's `cli eval`
     from a NeRF-synthetic export of its 400x400 ground truth: within
     SYNTHETIC_TOL_DB of the procedural eval; (d) the corrupted-pose
     dataset of tests/test_pose_opt.py (48x48, 3 x 64 MLP) trained 800
     steps without and with train.optimize_poses: each within
     TRAIN_PSNR_MARGIN_DB of the reference's record, refinement better by
     more than 0.5 dB, `cli render --split train --refined-poses` of the
     refined checkpoint; (e) the off-centre capture data/colmap/prims_oc
     (tools/colmap_offcentre.py) trained 300 steps in NDC, its loss
     falling, the training warp's rays of a view bit-equal on the card and
     the CPU and B4 bit-equal to its plain version on them and on a test
     view;
 12. `options`: the training options and CLI commands through the entry
     points, under chiprun_out/chip_smoke/options/: (a) grad accumulation
     (the prims config as 3000 loop steps of 4096 rays, 1500 updates; the
     default run takes its first ACCUM_SHORT_STEPS loop steps, the loss
     falling and Adam's count half of them; `options_full` all, within
     TRAIN_PSNR_MARGIN_DB of the record, Adam's count 1500); (b) the
     weight EMA with keep_best and remat (the default run its first
     EMA_SHORT_STEPS steps, the loss falling; `options_full` all 1500, the
     EMA eval within the margin; both: `cli eval` of checkpoints_best
     reproducing its best_psnr within
     BEST_PSNR_TOL_DB, B1 rerun in each backward pass, one step's gradient
     with and without remat within B2_RTOL); (c) random background on the
     fused pipeline (the white sphere on white of
     tests/test_random_background.py: its PSNR and opacity gates); (d) the
     BARF window with unit view directions on grid_march (within the
     margin of the reference's CPU run, freq_alpha of a mid-anneal
     checkpoint exact); (e) `cli suite` of the three procedural checkpoints
     and a missing scene (each within PSNR_TOL_DB of its record); (f)
     `render --orbit 8 --gif` (8 frames in the GIF's blocks); (g)
     logging.profile (a trace holding the card's kernels) and
     logging.debug_nans (nothing raised) on 50 steps;
 13. `geometry`: (a) `cli mesh --resolution 128 --vertex-colors` of the prims
     checkpoint (the density queries through the port's field on the card,
     no kernel): its vertex and face counts, bounding box and boundary
     edges held to the reference's CLI run (runs/prims_mesh_reference/
     mesh_stats.json), one slab of its density grid against the plain
     version on the CPU; (b) `cli mesh --resolution 64 --threshold 1.0` (the
     default threshold's surface is open and bounds nothing: see
     MESH_BOUND_LEVEL), then `cli train` of the prims config bounded by that
     mesh (grid.mesh_path, solid, grid.mesh_dilate=1), all 1500 steps: B1,
     B2 and B3 at least once per step, the bitfield inside the mask at the
     step-750 checkpoint and at the end, test PSNR not under the reference's
     unbounded record by more than TRAIN_PSNR_MARGIN_DB and over the
     config's gate, the mask's share of the cells printed;
 14. `bake`: `cli bake --bake-res 256 --mode trilinear_brick --eval` of the
     prims checkpoint: the baked and the march PSNR each within
     BAKE_PSNR_TOL_DB of the reference's CLI run
     (runs/prims_baked_reference/baked_parity.json), the bake's seconds and
     the npz's size printed; test view 0 through the bake in each lookup
     mode, trilinear and trilinear_brick within BAKE_MODE_ATOL;
 15. `parallel`: `tnerf_torch/parallel/` with two ranks sharing the card
     under gloo (NCCL refuses two ranks on one device; `parallel_rank`),
     each form against one rank on the same inputs: one fused DP step of
     the prims model on 8192 rays (loss within PARALLEL_LOSS_RTOL, each
     gradient leaf within B2_RTOL; B3, B1, B2 on each rank), its test view
     0 at 400x400 through `dp_render_sharded` (within
     PARALLEL_RENDER_ATOL; B4, B1), one step of the intervals config at
     sample_parallel = 2 (S = 768; B5 on each rank) and a render of its
     rays (SP_RENDER_ATOL), one step of the hash grid at
     table_parallel = 2 (the segment sum on each rank), the sharded
     occupancy refresh of the prims model (no bit differing); the
     gradient all_reduce's and the DP step's times; beside them `cli
     train` of prims for NCCL_TRAIN_STEPS steps under `python -m
     torch.distributed.run --nproc-per-node 1` (the group forms under
     NCCL, the loss falls);
 16. print the kernels' JSON line, then the status line.
In the `kernels` phase B5 (the grid walk) is held bit-equal to its plain
version, dense at 16^3 and 128^3, with occupancy at 64^3 (the prims
model's bitfield, coarse factor 4) and 32^3 (a random 8% bitfield, factor
8), and at the non-power-of-two 24^3 (dense, and factor 2) and on the box
[-1.3, 0.9]^3 at 24^3 (dense, and factor 3) with rays through the
coordinates where a cell id by the reciprocal differs from the division's;
it is timed at the intervals training shape (4096 rays, 16^3, 49 steps),
an intervals eval chunk (a 128 x 128 view) and at 640,000 rays, 128^3,
dense, 384 steps; B4 is held bit-equal at the march eval's shape (16^3
pooling, 64 probes, 96 midpoints).
Each phase prints its seconds, and the run its total.
`--phases kernels,serve,train,deep,resume,cdf,march,intervals,fields,scenes,options,geometry,bake,parallel`
runs a subset (for development; the kernels' line then lists what ran).
`--phases march_full` or `cdf_full`, which no default run includes (it
would not fit the chip call's 1200 s), trains configs/procedural_hard_30db.json
or configs/procedural_hard_fused_cdf2.json for its full 5000 steps against
the reference's final record; `--phases intervals_full` trains
runs/hard_r4_intervals16/config.json (train.seed=3) for its 2500 steps
against its record JAX_INTERVALS_PSNR_TEST, then its `cli eval` (B5 on
every chunk), one 800x800 orbit frame and 20 profiled steps;
`--phases parallel_full` trains the prims
config at parallel.data_parallel=2 and the progressive triplane at
table_parallel=2 under the launcher with two ranks on the card, each to
its one-rank gates (`PARALLEL_FULL_RUNS`).  `--phases repeats` (about 2
min) trains the march config (at render.compact=true, past its switch
to the compacted step), the intervals config, the hash grid and the
corrupted-pose scene with train.optimize_poses (dense, and compacted)
first under torch.use_deterministic_algorithms(True, warn_only=True),
printing every warning, then twice from one seed: every logged loss and
every leaf of the final checkpoint equal to the bit, each run past two
refreshes (repeats.json).  `--phases intervals_init --stream 0,1,2` (about
310 s a stream) trains runs/hard_r4_intervals16/config.json from the
reference's initial state (runs/hard_r4_intervals16_init) once per stream
of batches and jitter (train.seed = 1337 + K), each logged window printed
beside the reference's run; stream 0 keeps the states that
tests/test_torch_intervals_stages.py reads (INTERVALS_STATE_STEPS).
`--phases hash_init --stream 0-7 [--lookup gather,onehot]` (about 60 s a
stream) trains runs/hard_r5_hashgrid_diffuse/config.json from the
reference's initial state (runs/hard_r5_hashgrid_diffuse_init) once per
stream and lookup mode, each logged window printed beside the reference's
record and its CPU streams, each run classed fogged or clear by its final
test PSNR (HASH_FOG_DB); stream 0 of the gather keeps the states that
tests/test_torch_hashgrid_stages.py reads (HASH_STATE_STEPS).
`--phases tri_init` does the same for the progressive triplane
(runs/hard_r3_triplane_prog from runs/hard_r3_triplane_prog_init, no
classing; TRI_STATE_STEPS for tests/test_torch_triplane_stages.py).
`--phases hash_port_init,tri_port_init --stream 0-19` (about 60 s a
stream) trains both from the port's own step-0 state of the committed
seed (runs/hard_r5_hashgrid_diffuse_port_init,
runs/hard_r3_triplane_prog_port_init: the state the `fields` runs start
from), each logged window printed beside the band of the reference's CPU
streams from that state (ref_streams/stream_K.jsonl; the triplane's
`fields` gate reads them), the start checked against the reference's
first window and the first step of the config from scratch; no states
kept.  The
`kernels` phase also traces a data-parallel step's gradient at B2
(`trace_dp_split`) and `parallel` prints the DP step's gap per leaf
(ROADMAP Queue C 10).  Files go under chiprun_out/ (git-ignored).
"""

import argparse
import contextlib
import functools
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RUN = os.path.join(REPO, "runs", "suite_rehearsal", "prims")
CONFIG = os.path.join(RUN, "config.json")
CKPT = os.path.join(RUN, "checkpoints")
CONFIG_CDF = os.path.join(REPO, "configs", "procedural_hard_fused_cdf2.json")
CONFIG_MARCH = os.path.join(REPO, "configs", "procedural_hard_30db.json")
CONFIG_INTERVALS = os.path.join(REPO, "runs", "hard_r4_intervals16", "config.json")
# The table-backed fields, as committed: a hash grid with SH view encoding
# under occupancy-CDF placement, CP lines, and the progressive triplane.
CONFIG_HASH = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse", "config.json")
CONFIG_CP = os.path.join(REPO, "runs", "hard_r4_cp", "config.json")
CONFIG_TRIPLANE = os.path.join(REPO, "runs", "hard_r3_triplane_prog", "config.json")
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
# The reference package's eval of this checkpoint (runs/suite_rehearsal/prims/metrics.jsonl).
JAX_PSNR_TEST, JAX_SSIM_TEST = 34.393025040374724, 0.9663567049469579
PSNR_TOL_DB = 0.1
# The reference's final test PSNR of the CDF config
# (runs/hard_r4_fused_cdf2/metrics.jsonl, last line): quality, not speed.
JAX_CDF_PSNR_TEST = 38.95965774441899
# The default run trains the CDF config's first 2500 of 5000 steps under the
# schedule of all 5000, held to the reference's own eval at that step (the
# same run, 2 test views, step 2499); `cdf_full`, outside the default set,
# trains all 5000 against the final record.
CDF_TRAIN_OVERRIDES = ["train.steps=2500", "train.schedule_total_steps=5000"]
JAX_CDF_PSNR_TEST_2499 = 37.017407884994874
# The reference's final test PSNR of the march config
# (runs/hard_r3_march/metrics.jsonl) and of the intervals config
# (runs/hard_r4_intervals16/metrics.jsonl), last lines.
JAX_MARCH_PSNR_TEST = 39.177740514541384
# The march config trains its first 2500 of 5000 steps, under the
# schedule of all 5000 (so the run is the first half of the full one), to
# keep the script inside its time limit; it is held to the reference's
# own eval at that step (the same run, 2 test views, step 2499).
MARCH_TRAIN_OVERRIDES = ["train.steps=2500", "train.schedule_total_steps=5000"]
JAX_MARCH_PSNR_TEST_2499 = 36.886449828787946
JAX_INTERVALS_PSNR_TEST = 33.336694779861396
# The reference's final test PSNRs of the table-field runs (each run's
# metrics.jsonl, last line): TPU runs whose lookups were rounded to bf16
# (the one-hot form); the port's are float32 gathers.
JAX_HASH_PSNR_TEST = 42.92676198891576
JAX_CP_PSNR_TEST = 41.57507631109071
JAX_TRIPLANE_PSNR_TEST = 41.56194746218691
# The progressive triplane is not cut: its first two stages (1250 steps,
# planned as the full run plans them) ended 1.88 dB over the reference's
# eval at step 1250 (40.16 against 38.28 dB on one H100), outside
# TRAIN_PSNR_MARGIN_DB, where the full run ends inside it.
# The table fields' training gates.  Where a table-field run ends depends
# on its initial weights, which the two packages draw differently from one
# seed, and on its stream of batches and jitter, in both packages alike:
# from one initial state the hash grid fogs over (a final test PSNR under
# HASH_FOG_DB) in some streams and ends clear in the others, and the
# triplane spreads over about two dB (PERF.md, ROADMAP Queue C 5, C 9 and
# C 12).  So each field trained at the committed seed (`fields`, and
# `parallel_full`'s table-parallel triplane) starts from the port's own
# step-0 state of that seed, committed under runs/<config>_port_init/
# checkpoints, and is held to what the reference reaches from that same
# state: its final test PSNR must lie in the band from the least to the
# greatest final test PSNR of the reference's runs from that state,
# widened by TRAIN_PSNR_MARGIN_DB on each side (`reference_bands`,
# FIELD_GATES).  The triplane's band is over the reference's committed
# streams (runs/hard_r3_triplane_prog_port_init/ref_streams/stream_K.jsonl:
# tools/reference_from_port_state.sh <config> <that state> <out>
# train.seed=<1337 + K>, the reference on the CPU with float32 lookups, as
# it resolves `auto` off a TPU), whose law the port's streams from the same
# state match (tools/hash_init_band.py --from port).  The hash grid keeps
# its one anchor run, the reference's at seed 1337 from the same state by
# the same script (34.42 dB, fogged; its metrics are not in the repo): the
# port's fogged streams from that state end at 31.6-38.7 dB where the
# reference's committed ones end at 30.3-33.2, and the band of the
# committed streams (fogged [28.81, 34.70]) would refuse the port's own run
# at the committed seed (35.23), so the two fogs are not yet shown to be
# one law (ROADMAP Queue C 12).  A clear hash-grid run fails this gate.
# CP keeps its one reference run (43.80 dB), a band of one.  The gap to the
# record is printed beside the band.
JAX_HASH_FROM_PORT_INIT_PSNR_TEST = 34.42220929004496
JAX_CP_FROM_PORT_INIT_PSNR_TEST = 43.79805301785407
# The intervals config at 16^3 prunes thin rods through one density probe
# per 0.125-wide cell, and where it ends depends on the initial weights: on
# the card the port's runs ended at 29.59 (the committed seed 1337, whose
# weights in torch's stream start as an opaque fog, acc 0.71 at step 0;
# under the config's own 30 dB gate), 32.29, 31.86 and 32.46 dB (seeds 1, 2,
# 3); the reference's one run at 33.34.  Resumed from the reference's own
# initial state of seed 1337 (runs/hard_r4_intervals16_init) it ends at
# 31.77: the 29.59 came from the initial weights.  The phase trains seed 3
# and holds it to the same margin and gate as every other run.
INTERVALS_OVERRIDES = ["train.seed=3"]
# The default run's `intervals` phase trains that config and seed for its
# first 250 of 2500 steps under the full schedule (the whole run, 2500
# steps at about 117 ms, was 30% of the default run's time): the loss must
# fall, B5 launch every step and every eval chunk, `cli eval` equal the
# run's own eval.  The PSNR gate is `intervals_full`'s.  A run cut this
# short of its config's steps is not held to the config's final gate
# (train.assert_test_psnr_min, which `cli train` itself raises on): the
# full runs are (`intervals_full` here, `cdf` / `cdf_full` for the deep CDF
# run below).
SHORT_RUN = ["train.assert_test_psnr_min=0"]
# Phase `train`: two `cli train` runs of the prims config from one seed
# (B2), REPEAT_STEPS steps each, past grid.warmup_steps (256) so that the
# occupancy refreshes at steps 256, 272 and 288 run too, and two of the CDF
# config (B2t), CDF_REPEAT_STEPS each: every step's loss and every leaf of
# the final checkpoint (parameters, Adam moments and counts, occupancy)
# equal to the bit.
REPEAT_STEPS = 300
CDF_REPEAT_STEPS = 100
REPEAT_OVERRIDES = SHORT_RUN + ["train.log_every=1", "train.eval_every=0"]
# Phase `repeats` (not in the default run): the same for the unfused and
# table-field paths, each run going past at least two occupancy refreshes:
# the march config (B4 on its evals) at render.compact=true with the hash
# grid's committed render.compact_fraction=0.95, so that it switches from
# the dense to the compacted step after its first refreshes (as committed
# it never compacts: render.compact=false), 300 steps (refreshes at 256,
# 272, 288); the intervals config (B5 every step) with
# INTERVALS_REPEAT_GRID's shorter warmup and cadence, 48 steps
# (refreshes at 16, 24, 32, 40); the hash grid as committed (occupancy-CDF
# placement, the segment sum, its own switch), 300 steps; the corrupted-pose
# scene of phase `scenes` (d) with train.optimize_poses, 200 steps
# (refreshes every 10 from step 20; positions and directions take a
# gradient), as committed (dense) and at POSE_COMPACT_OVERRIDES, where the
# compacted shade's gathers of positions and directions (many slots
# reading one ray's) take that gradient: its young field prunes no cell in
# 200 steps, so a fraction over 1 switches at the first refresh, and the
# buffer then holds every sample.  Each path first trains as many steps under
# torch.use_deterministic_algorithms(True, warn_only=True), the refreshes
# and the compacted step included, and every warning PyTorch raises there
# is printed.  Each run's directory is removed once read (the hash grid's
# checkpoints are 10 MB each).
MARCH_REPEAT_OVERRIDES = ["render.compact=true", "render.compact_fraction=0.95"]
POSE_COMPACT_OVERRIDES = ["render.compact=true", "render.compact_fraction=2.0"]
INTERVALS_REPEAT_GRID = ["grid.warmup_steps=16", "grid.update_every=8"]
UNFUSED_REPEAT_STEPS = {"march": 300, "intervals": 48, "hash": 300, "poses": 200,
                        "poses_compact": 200}
# Phase `intervals_init` (not in the default run, a call of its own):
# runs/hard_r4_intervals16/config.json trained from the reference's own
# initial state of seed 1337 (runs/hard_r4_intervals16_init, step 0) with
# the config's log cadence and evals, each logged window printed beside the
# reference's run (runs/hard_r4_intervals16/metrics.jsonl).  `--stream K`
# draws the batches, sample jitter and occupancy probes at train.seed =
# 1337 + K (the initial weights stay the reference's); stream 0 also keeps
# the states after INTERVALS_STATE_STEPS steps (257: the first refresh, at
# step 256, included), which runs/hard_r4_intervals16_port holds.
INTERVALS_INIT = os.path.join(REPO, "runs", "hard_r4_intervals16_init", "checkpoints")
INTERVALS_RECORD = os.path.join(REPO, "runs", "hard_r4_intervals16", "metrics.jsonl")
INTERVALS_STATE_STEPS = (257, 500, 1500)
WINDOW_KEYS = ("loss", "train_psnr", "acc_mean", "occupancy_frac")
INTERVALS_SHORT_STEPS = 250
# Phase `hash_init` (not in the default run; calls of their own):
# runs/hard_r5_hashgrid_diffuse/config.json (hash grid, SH, occupancy-CDF
# placement) trained from the reference's own initial state of seed 1337
# (runs/hard_r5_hashgrid_diffuse_init, step 0), logging every 50 steps,
# once per `--stream K` (train.seed = 1337 + K: the batches, the CDF
# jitter and the refresh jitter; the weights are the reference's) and per
# `--lookup` mode: "gather" is the config as committed (`auto`, the float32
# gather off a TPU), "onehot" the lookups rounded to bf16 as the TPU's
# one-hot product reads them (field_.hash_gather_mode=onehot).  Each
# logged window is printed beside the reference's record
# (runs/hard_r5_hashgrid_diffuse/metrics.jsonl, a TPU run) and the band of
# the reference's CPU streams from the same state
# (runs/hard_r5_hashgrid_diffuse_ref_streams, tools/hash_ref_streams.sh).
# A run is classed fogged when its final test PSNR is under HASH_FOG_DB,
# fixed before the first run: every run of this config on record ended
# either at 33.3-38.5 dB (fogged) or at 41.7-43.3 dB (clear).  There is no
# PSNR gate; the start is checked (acc_mean at step 0 within 0.05 of the
# record's).  Stream 0 of the gather keeps its states after
# HASH_STATE_STEPS steps under chiprun_out/chip_smoke/hash_states/: 257
# (the first refresh, at step 256, included) and 2000, where its
# occupancy_frac has left the band of the clear streams and its fog has
# not yet set in (it fogs from step 2050 on).
HASH_INIT = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse_init", "checkpoints")
HASH_RECORD = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse", "metrics.jsonl")
HASH_REF_STREAMS = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse_ref_streams")
HASH_STATE_STEPS = (257, 2000)
HASH_FOG_DB = 39.0
HASH_LOOKUPS = {"gather": [], "onehot": ["field_.hash_gather_mode=onehot"]}
# Phase `tri_init` (not in the default run; calls of their own):
# runs/hard_r3_triplane_prog/config.json (the progressive triplane: R = 32,
# grown to 51, 81 and 128 at steps 625, 1250 and 1875, each growth a fresh
# optimizer and schedule) trained from the reference's own step-0 state of
# seed 1337 (runs/hard_r3_triplane_prog_init, drawn under the first stage's
# config; both packages resume it as stage 1 of 4), logging every 50 steps,
# once per `--stream K` and `--lookup` mode as `hash_init` ("onehot":
# field_.tri_gather_mode=onehot, the lookups rounded to bf16 as the record's
# TPU run read them).  Every stage draws its batches and jitter afresh from
# train.seed + 1, as the reference's stages do.  Each logged window is
# printed beside the record (runs/hard_r3_triplane_prog/metrics.jsonl, a
# TPU run) and the band of the reference's CPU streams from the same state
# (runs/hard_r3_triplane_prog_ref_streams, tools/hash_ref_streams.sh with
# CONFIG / INIT / DEST).  No PSNR gate; the start is checked as
# `hash_init`'s.  Stream 0 of the gather keeps its states after
# TRI_STATE_STEPS steps under chiprun_out/chip_smoke/tri_states/: 257 (R =
# 32, the first refresh, at step 256, included) and 1885 (R = 128, ten Adam
# steps after the last stage's rewrite).  The stages' last checkpoints stay
# while the run lasts: each stage resumes from the one before.
TRI_INIT = os.path.join(REPO, "runs", "hard_r3_triplane_prog_init", "checkpoints")
TRI_RECORD = os.path.join(REPO, "runs", "hard_r3_triplane_prog", "metrics.jsonl")
TRI_REF_STREAMS = os.path.join(REPO, "runs", "hard_r3_triplane_prog_ref_streams")
TRI_STATE_STEPS = (257, 1885)
TRI_LOOKUPS = {"gather": [], "onehot": ["field_.tri_gather_mode=onehot"]}
# The port's own step-0 states of the committed seed (the `fields` runs
# start from them), each with the reference's CPU streams from it
# (ref_streams/stream_K.jsonl) and the port's on the card
# (port_streams/gather_sK.jsonl): see FIELD_GATES.
HASH_PORT_INIT = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse_port_init")
TRI_PORT_INIT = os.path.join(REPO, "runs", "hard_r3_triplane_prog_port_init")
# The last step of both table-field configs: a stream's final eval.
FIELD_STEPS = 2500
# Each table field's gate: the reference's runs from the port's step-0
# state, as a directory of committed streams or as the final test PSNRs of
# runs whose metrics are not committed; the fog threshold its runs are
# classed by in the print (None: no classing); the record.
FIELD_GATES = {
    CONFIG_HASH: dict(psnrs=(JAX_HASH_FROM_PORT_INIT_PSNR_TEST,), fog_db=HASH_FOG_DB,
                      record=JAX_HASH_PSNR_TEST),
    CONFIG_CP: dict(psnrs=(JAX_CP_FROM_PORT_INIT_PSNR_TEST,), fog_db=None,
                    record=JAX_CP_PSNR_TEST),
    CONFIG_TRIPLANE: dict(streams=os.path.join(TRI_PORT_INIT, "ref_streams"), fog_db=None,
                          record=JAX_TRIPLANE_PSNR_TEST),
}
INTERVALS_SHORT_OVERRIDES = INTERVALS_OVERRIDES + SHORT_RUN + [
    f"train.steps={INTERVALS_SHORT_STEPS}", "train.schedule_total_steps=2500"]
# Phase `deep`: the prims config at 13 layers of 128 (field_.hidden_layers=12).
# No reference record of a fused model this deep exists, so its gate is a
# sanity bar, not parity: the final test PSNR no more than
# TRAIN_PSNR_MARGIN_DB under the 9-layer record JAX_PSNR_TEST (34.393 dB).
# Written before the first run.  The CDF config at that depth trains
# DEEP_CDF_STEPS steps (B2t every step, the loss falling).
DEEP_OVERRIDES = ["field_.hidden_layers=12"]
DEEP_CDF_STEPS = 300
# The prims model, trained on the fused path (64 uniform samples of the
# tightened span), served through grid_march at 96 samples on the 16^3
# pooling: another quadrature of the same field.  The reference's own
# fused / march gap is 0.46 dB (docs/ROUND5.md); 1.0 dB was written before the
# first run and held for uniform and occupancy-CDF placement.  Density-CDF
# placement missed it by 0.04 dB: it spends the samples where the density
# EMA says the ray's weight is, a quadrature this model was not trained
# under (the reference's own density-CDF training of the hard scene ends
# 16 dB under its uniform one, runs/hard_r3_march_dcdf), so its bound is wider.
MARCH_SERVE_TOL_DB = {"uniform": 1.0, "occupancy_cdf": 1.0, "density_cdf": 2.0}
MARCH_OVERRIDES = ["render.pipeline=grid_march", "sampler.samples_per_ray=96",
                   "sampler.tighten=true", "sampler.tighten_probes=64", "sampler.tighten_res=16",
                   "sampler.occupancy_mask_res=16"]
# Compaction variants of one march view: kept samples are the same samples
# through the same field, in batches of another shape (the matrix products
# sum in another order).
MARCH_COMPACT_ATOL = 1e-3
# One view with and without ray compaction: kept rays are the same rows
# through the same kernel and dropped rays are acc = 0 in both, so at
# transmittance_threshold = 0 they agree to rounding; at the config's
# threshold a tile stops once all of its rays are opaque, and compaction
# changes a ray's neighbours in its tile.
COMPACT_ATOL_EPS0, COMPACT_ATOL = 1e-5, 2e-3
# Scenes and poses (phase `scenes`): the reference's records of the
# committed captures.  LLFF, world space (tools/llff_rehearsal.py, its
# overrides in LLFF_OVERRIDES; runs/llff_rehearsal/summary.json): the
# loader's splits and 44.34 dB.  COLMAP in NDC as committed
# (runs/colmap_rehearsal/config.json, summary.json): 39.81 dB.  The
# pose-refinement pair (runs/pose_refinement_{opt,no_opt}/metrics.jsonl):
# 18.03 dB with train.optimize_poses against 16.20 without, 800 steps on
# the corrupted-pose dataset of tests/test_pose_opt.py, and the
# reference's own gate there: refinement wins by more than 0.5 dB.
LLFF_ROOT = os.path.join(REPO, "data", "llff")
COLMAP_ROOT = os.path.join(REPO, "data", "colmap")
CONFIG_COLMAP = os.path.join(REPO, "runs", "colmap_rehearsal", "config.json")
JAX_LLFF_PSNR_TEST = 44.342881402053365
JAX_LLFF_LOADER = {"train": (22, [360, 480, 4]), "test": (4, [360, 480, 4]),
                   "focal": 666.6666187162609}
JAX_COLMAP_PSNR_TEST = 39.812801577821745
JAX_POSE_OPT_PSNR_TEST, JAX_POSE_NO_OPT_PSNR_TEST = 18.03, 16.20
POSE_OPT_MIN_GAIN_DB = 0.5
SCENE_PSNR_FLOOR_DB = 30.0
# A capture with an off-centre principal point (data/colmap/prims_oc,
# tools/colmap_offcentre.py: 240x180, fx != fy, the principal point at
# (W/2 + 17.5, H/2 - 11.25)), trained in NDC as runs/colmap_rehearsal is:
# the training warp keeps its shift add there (no constant folding).
OFFCENTRE_OVERRIDES = [f"scene.root={COLMAP_ROOT}", "scene.name=prims_oc", "train.steps=300",
                       "train.log_every=50", "train.eval_every=0", "train.checkpoint_every=300"]
LLFF_OVERRIDES = ["scene.kind=llff", "scene.name=prims_ff", f"scene.root={LLFF_ROOT}",
                  "scene.white_background=true", "render.white_background=true",
                  "scene.scene_scale=1.0", "sampler.near=2.0", "sampler.far=5.5",
                  "render.pipeline=grid_march", "render.compact=false",
                  "render.ray_compact=false", "train.steps=2500", "train.eval_every=2500",
                  "train.checkpoint_every=2500"]
# The default run trains the two captures (LLFF, COLMAP) for their first
# SCENE_SHORT_STEPS of 2500 steps under the schedule of all 2500: the loss
# falling, B4 launched by the evals and held on a view.  No reference eval
# is logged before the captures' last step, so their PSNR gates are
# `scenes_full`'s, which runs the whole phase at the committed lengths.
SCENE_SHORT_STEPS = 300
SCENE_SHORT_OVERRIDES = SHORT_RUN + [f"train.steps={SCENE_SHORT_STEPS}",
                                     "train.schedule_total_steps=2500"]
# Each phase's arguments of `train_and_serve_scenes`: the overrides both
# captures add, and the gates of LLFF and COLMAP: the reference's record
# (with SCENE_PSNR_FLOOR_DB) or None (the loss falling).
SCENE_RUNS = {"scenes": (SCENE_SHORT_OVERRIDES, None, None),
              "scenes_full": ([], JAX_LLFF_PSNR_TEST, JAX_COLMAP_PSNR_TEST)}
# The prims model's eval from 8-bit PNGs of its own ground truth against
# its procedural eval: PNG rounding adds noise of 1 / (255 sqrt(12)) RMS to
# the targets, 0.3% of the model's MSE at 34.4 dB, about 0.015 dB.
SYNTHETIC_TOL_DB = 0.05
# B1 tolerance: bf16 activations rounded in another order than the plain
# version's (f32 sums in another order flip single bf16 roundings); depth
# is a sum of w * t with t up to sampler.far = 5.5, so its bound scales.
B1_ATOL, B1_DEPTH_ATOL = 5e-3, 2e-2
# B2 tolerance, per leaf (dW, dBias) as max |kernel - plain| / max |plain|:
# both round the same quantities to bf16, but sum in another order (mma
# fragments, atomics), which flips single bf16 roundings of activations and
# gradients; a gradient entry sums ~5e5 samples, so flips average out.  The
# reference's own kernel-against-autodiff test allows 3e-2.
B2_RTOL = 1e-2
# B2 / B2t sum dW and dBias in 64-bit fixed point, so their gradient
# repeats bit for bit: every backward_rel case launches twice and must get
# the same bits, and one launch on a grid of SMALL_GRID CTAs (the
# occupancy query gives 132 on an H100) must equal the full grid's.
SMALL_GRID = 37
# The overflow flag, driven on the card: the cotangent times FLAG_GOUT_SCALE
# puts a tile's partial far past the wrapper's bound (512 in gradient units
# at the training batch, where partials stay under 1e-1: PERF.md), so the
# gradient must come back non-finite.
FLAG_GOUT_SCALE = 1e9
# The trained model against the reference's record (34.393 dB): the two
# packages draw other batches and other initial weights from the same seed,
# so there is no bit parity; written down before the first run.
TRAIN_PSNR_MARGIN_DB = 1.5
# Train loss of the resumed reference checkpoint: its last logged loss is
# 1.77e-4 (metrics.jsonl, step 1499) on batches of 8192 rays; lost Adam
# moments would send the first updates far off.  Written before the run.
RESUME_LOSS_MAX = 3e-4
RESUME_STEPS = 50
# Phase `options`: the training options and CLI commands of tnerf/train.py and
# tnerf/cli.py through the entry points, each run under chiprun_out/.
# (a) grad accumulation: the prims config's 1500 updates of 8192 rays as
# 3000 loop steps of 4096, two microbatches an update.
ACCUM_OVERRIDES = ["train.grad_accum_steps=2", "train.batch_size=4096", "train.steps=3000"]
# (b) the weight EMA, keep_best and remat on the prims config; two val
# views, so that every in-training eval sees all of them and `cli eval`
# of the best checkpoint can reproduce its best_psnr.
EMA_OVERRIDES = ["train.param_ema=0.99", "train.keep_best=true", "train.remat=true",
                 "train.eval_every=750", "scene.proc_n_val=2"]
BEST_PSNR_TOL_DB = 1e-3
# The default run cuts (a) to its first ACCUM_SHORT_STEPS loop steps and
# (b) to its first EMA_SHORT_STEPS (evals every EMA_SHORT_EVAL), each
# under the schedule of the whole run: the loss falling, the updates
# counted, keep_best and remat checked as in the whole run.  The prims
# record logs no eval before step 1500, so the PSNR gates of (a) and (b)
# are `options_full`'s, which runs the whole phase at the committed
# lengths.
ACCUM_SHORT_STEPS = 400
EMA_SHORT_STEPS, EMA_SHORT_EVAL = 300, 100
# Each phase's arguments of `train_with_options`: the overrides (a) and (b)
# add to their committed ones, and their gate: the prims record (with the
# config's own gate, check_trained) or None (the loss falling).
OPTION_RUNS = {
    "options": (SHORT_RUN + [f"train.steps={ACCUM_SHORT_STEPS}"],
                SHORT_RUN + [f"train.steps={EMA_SHORT_STEPS}",
                             f"train.eval_every={EMA_SHORT_EVAL}"], None),
    "options_full": ([], [], JAX_PSNR_TEST),
}
# (c) random background: the white sphere on white of
# tests/test_random_background.py (radius 0.6, cameras at radius 3, its
# 24-pixel view's field of view) at 128x128, 16 train / 2 test views,
# through the default config's fused pipeline; its gates are that test's.
RBG_SIZE, RBG_TRAIN, RBG_TEST, RBG_STEPS = 128, 16, 2, 1000
RBG_RADIUS, RBG_FOCAL = 0.6, 26.0 * 128 / 24
RBG_OVERRIDES = ["scene.kind=procedural", "scene.name=prims", "scene.scene_scale=1.0",
                 "scene.white_background=true", "render.white_background=true",
                 "sampler.near=1.5", "sampler.far=4.5", "train.random_background=true",
                 f"train.steps={RBG_STEPS}", "train.eval_every=0",
                 f"train.checkpoint_every={RBG_STEPS}", "train.log_every=250"]
RBG_PSNR_MIN, RBG_ACC_CORE_MIN, RBG_ACC_BG_MAX = 20.0, 0.85, 0.10
# (d) the BARF window and unit view directions: the pose-refinement config
# as the reference trained it on the CPU through its CLI (the committed
# runs/pose_refinement_barf_unit: runs/pose_refinement_opt/config.json on
# the prims scene of tests/test_pose_opt.py's size, uncorrupted, with
# train.freq_anneal_steps=400 field_.view_param=unit, a checkpoint every
# 200 steps); its final test PSNR (metrics.jsonl, last line).
CONFIG_BARF = os.path.join(REPO, "runs", "pose_refinement_barf_unit", "config.json")
JAX_BARF_UNIT_PSNR_TEST = 14.477848861019408
# (e) `cli suite` over copies of the three committed procedural
# checkpoints: each within PSNR_TOL_DB of its record (each metrics.jsonl's
# last line).
SUITE_RUNS = os.path.join(REPO, "runs", "suite_rehearsal")
SUITE_SCENES = ("prims", "rings", "layers")
# (f) `cli render --orbit ORBIT_FRAMES --gif` of the prims model.
ORBIT_FRAMES = 8
# (g) logging.profile, then logging.debug_nans, on PROFILE_STEPS prims steps.
PROFILE_STEPS = 50
# Phase `geometry`: `cli mesh` of the prims checkpoint at 128 cells per axis
# with vertex colours, held to the reference's CLI run of the same command
# on the CPU (tools/reference_mesh_bake.sh): vertex and face counts within
# MESH_COUNT_RTOL, the bounding box within one cell, the boundary edges (the
# reference's surface at the default threshold is open where its fog meets
# the box and at a few zero-area faces it drops: 2681 of them) within
# MESH_BOUNDARY_RTOL; one slab of the density grid on the card within
# MESH_DENSITY_RTOL of its largest value from the plain version on the CPU.
# Then `cli train` of the prims config bounded by a mesh (solid,
# grid.mesh_dilate=1), all 1500 steps, a checkpoint at step 750.  The bound
# is the isosurface at MESH_BOUND_LEVEL, not at the default 0.01: there the
# fog connects the objects' insides to the box's faces, the surface is
# open, and the solid fill (`fill_interior`, exterior = what the box's faces
# reach through cells the surface does not cross) leaves only the shell:
# the committed model rendered inside that mask falls from 33.83 to 16.34
# dB (grid_march, 4 test views at 100x100, on the CPU), and the bounded
# training ended at 29.04 dB, worst view 24.56, under the config's gate (on
# one H100).  Inside the masks of the levels 0.1 and 1.0 it renders 34.10
# and 34.02 dB; 1.0 is the tighter bound (0.188 of the cells against the
# trained bitfield's 0.271).  64 cells per axis: the grid's own resolution.
# The bounded run is held to the reference's unbounded record from below
# only (`train_from_scratch(at_least=True)`): a bound that keeps the
# floaters out is another model of the scene, and its first run ended 2.48
# dB over the record (36.88 dB on one H100), where no reference run of a
# bounded prims exists to hold it to.
MESH_RECORD = os.path.join(REPO, "runs", "prims_mesh_reference", "mesh_stats.json")
MESH_RESOLUTION = 128
MESH_COUNT_RTOL, MESH_BOUNDARY_RTOL = 0.005, 0.02
MESH_DENSITY_RTOL = 1e-4
MESH_BOUND_LEVEL, MESH_BOUND_RESOLUTION = 1.0, 64
# Phase `bake`: `cli bake --bake-res 256 --eval` of the prims checkpoint, held
# to the reference's CLI run on the CPU (runs/prims_baked_reference): the
# baked and the march PSNR each within BAKE_PSNR_TOL_DB; one test view in
# every lookup mode, trilinear and trilinear_brick within one bf16 step of a
# value under 1 (they read the same bf16 table).
BAKE_RECORD = os.path.join(REPO, "runs", "prims_baked_reference", "baked_parity.json")
BAKE_RES = 256
BAKE_PSNR_TOL_DB = 0.05
BAKE_MODE_ATOL = 2.0 ** -8
# Inside `fields`: the hash grid's checkpoint baked at 320^3 with --eval, as
# the reference's runs/hard_r5_hashgrid_diffuse/baked_parity.json was (its
# baked 41.6626 dB against its march 41.0205, +0.6421): the port's baked
# render within HASH_BAKE_PARITY_DB of its own march render of the same
# checkpoint, either way.
HASH_BAKE_RECORD = os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse", "baked_parity.json")
HASH_BAKE_RES = 320
HASH_BAKE_PARITY_DB = 1.0
ALL_PHASES = ("kernels", "serve", "train", "deep", "resume", "cdf", "march", "intervals",
              "fields", "scenes", "options", "geometry", "bake", "parallel")
# Not in the default run, which would not fit the chip call's 1200 s with them:
# `march_full` and `cdf_full` train configs/procedural_hard_30db.json and
# configs/procedural_hard_fused_cdf2.json for all their 5000 steps against
# the reference's final records; `intervals_full` trains
# runs/hard_r4_intervals16/config.json for all its 2500 steps against its
# record (about 340 s); `parallel_full` trains two configs under the
# launcher with two ranks (about 310 s); `repeats` the pairs from one seed
# of the unfused and table paths (about 120 s); `intervals_init` the
# intervals config from the reference's initial state, once per --stream
# (about 310 s each); `hash_init` the hash grid and `tri_init` the
# progressive triplane from the reference's initial state, and
# `hash_port_init` / `tri_port_init` from the port's, once per --stream and
# --lookup (about 60 s each); `scenes_full` and `options_full` the phases
# `scenes` and `options` with the runs the default cuts short
# (SCENE_SHORT_STEPS, ACCUM_SHORT_STEPS, EMA_SHORT_STEPS) whole, each held
# to its reference's record.
EXTRA_PHASES = ("march_full", "cdf_full", "intervals_full", "scenes_full", "options_full",
                "parallel_full", "repeats", "intervals_init", "hash_init", "tri_init",
                "hash_port_init", "tri_port_init")
# Published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM3.
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, reps):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel, reps=50):
    """Mean device time (ms) of the kernels whose name holds `kernel`, over
    at least `reps` of their launches, from windows of `reps` calls of fn
    under torch.profiler.  The profiler may miss launches of a window (at
    its start); windows are added until it has seen `reps`, at most six."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    total = count = 0
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and kernel in e.key]
        total += sum(e.self_device_time_total for e in evs)
        count += sum(e.count for e in evs)
        if count >= reps:
            return total / count / 1e3
    raise AssertionError(f"the profiler saw {count} launches of *{kernel}* in {6 * reps} calls")


def wrapper_ms(fn, reps=50):
    """Host clock per call of fn over `reps` calls, synchronised once at the
    end: what a caller pays for the wrapper and the launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


class _Tee(io.StringIO):
    """Keeps what is written and passes it on."""

    def __init__(self, to):
        super().__init__()
        self.to = to

    def write(self, text):
        self.to.write(text)
        return super().write(text)


def run_cli(argv, with_stderr=False):
    """The entry point's standard output (and, on request, what it wrote to
    standard error, which is shown all the same)."""
    from tnerf_torch.cli import main

    buf, err = io.StringIO(), _Tee(sys.stderr)
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"tnerf_torch.cli {' '.join(argv)} exited {rc}")
    return (buf.getvalue(), err.getvalue()) if with_stderr else buf.getvalue()


def kernel_counters():
    """name of a kernels-line row -> (wrapper, name of its launch count)."""
    from tnerf_torch.fields.hashgrid import segment_sort, segment_sum_rows
    from tnerf_torch.grid.dda import march_raw
    from tnerf_torch.grid.tighten import tighten_range, tighten_sample_mask
    from tnerf_torch.render.fused import fused_backward, fused_forward

    return {"segment_sort": (segment_sort, "launches"),
            "segment_sum": (segment_sum_rows, "launches"),
            "dda_march": (march_raw, "launches"),
            "tighten_range": (tighten_range, "launches"),
            "tighten_sample_mask": (tighten_sample_mask, "launches"),
            "fused_forward": (fused_forward, "launches"),
            "fused_forward_tmode": (fused_forward, "launches_tmode"),
            "fused_backward": (fused_backward, "launches"),
            "fused_backward_tmode": (fused_backward, "launches_tmode")}


def counted(fn):
    """fn() with every launch count set to 0 just before and read just
    after: (result, {row name: launches})."""
    counters = kernel_counters()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    result = fn()
    return result, {k: getattr(wrapper, attr) for k, (wrapper, attr) in counters.items()}


def bound_row(name, source, replaces, err, ms, plain_ms, n_bytes, ops, peak_ops, wrapper=None):
    """A row of the kernels line: ms is the kernel's device time, wrapper
    the host clock per call of its wrapper."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES, ops / peak_ops
    return dict(name=name, route="cuda", source=source, replaces=replaces, max_abs_err=err, ms=ms,
                wrapper_ms=wrapper, plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes > by_ops else "operations", library_ms=None)


def probe_bound(n_rays, live, probes, n):
    """(bytes, f32 operations) of B3 (n = 0) or B4 (n midpoints) on n_rays
    rays, live of them with a span: the reference's work, every probe
    evaluated, whatever the kernel skips.  Bytes: o, d, te, tx read, t0,
    t1 (and the mask) written, the bitfield read.  Operations per probe:
    depth 4, position 6, cell ids 9, min / max 2; per midpoint: depth 3,
    position 6, cell ids 9, and 1."""
    from tnerf_torch.grid.tighten import WORDS

    return n_rays * (24 + 8 + 8 + n) + 4 * WORDS, live * (probes * 21 + n * 19)


def n_bytes(tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def live_mask(args, placed=None):
    """[B, S] bool: the samples of a fused-kernel call that survive the span
    and coarse masks, the only ones whose MLP work the result needs."""
    import torch

    from tnerf_torch.grid.tighten import occ_bit

    _, _, _, _, te, dt, o, d, mask, words, coarse = args
    if placed:
        t = placed["ts"]
    else:
        s = torch.arange(mask.shape[1], device=mask.device) + 0.5
        t = te[:, None] + s[None, :] * dt[:, None]
    bit = occ_bit(o[:, None, 0] + t * d[:, None, 0], o[:, None, 1] + t * d[:, None, 1],
                  o[:, None, 2] + t * d[:, None, 2], words, *coarse)
    return (mask > 0) & bit


def live_samples(args, placed=None):
    return int(live_mask(args, placed).sum())


def device_time_by_kernel(prof):
    """(device ms in all, launches, kernels by device time) of a torch.profiler run."""
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return (sum(e.self_device_time_total for e in kernels) / 1e3, sum(e.count for e in kernels),
            kernels)


def serving_chunk(cfg, dev):
    """One chunk of test view 0 as `render_image` cuts it: every
    n_chunks-th ray of the 400x400 view."""
    from tnerf_torch.cameras import Rays, camera_rays, focal_from_angle
    from tnerf_torch.data.procedural import CAMERA_ANGLE_X, sphere_poses

    W = H = cfg.scene.proc_width
    rays = camera_rays(sphere_poses(8, seed=30)[0], W, H, focal_from_angle(W, CAMERA_ANGLE_X),
                       cfg.scene.scene_scale, device=dev)
    n = W * H
    n_chunks = -(-n // cfg.render.chunk_size)
    return Rays(*(a.reshape(n, a.shape[-1])[0::n_chunks].contiguous() for a in rays))


def check_forward(name, args, placed, eps, what):
    """B1 (or, with placed, B1t) against its plain version on one call's
    inputs; returns (max |err| per column, kernel device ms, plain ms,
    wrapper ms)."""
    import torch

    from tnerf_torch.render import fused as fz

    out_k = fz.fused_forward(*args, term_eps=0.0, **placed)
    out_p = fz.fused_forward_plain(*args, **placed)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k).all():
        raise AssertionError(f"{name} fused forward ({what}): non-finite output")
    err = (out_k - out_p).abs().amax(dim=0).tolist()
    log(f"{name} ({what}) max |kernel - plain| per column (r, g, b, acc, depth, T):", err)
    if max(err[:4] + err[5:]) > B1_ATOL or err[4] > B1_DEPTH_ATOL:
        raise AssertionError(f"{name} fused forward ({what}) disagrees with its plain version: "
                             f"{err}")
    run = lambda: fz.fused_forward(*args, term_eps=eps, **placed)
    ms, wrapper = device_ms(run, "fused_forward_kernel"), wrapper_ms(run)
    plain = cuda_ms(lambda: fz.fused_forward_plain(*args, **placed), 3)
    return err, ms, plain, wrapper


def forward_err(out_k, out_p):
    """max |kernel - plain| per output column (r, g, b, acc, depth, T), and
    whether it is within B1_ATOL (B1_DEPTH_ATOL for depth)."""
    err = (out_k - out_p).abs().amax(dim=0).tolist()
    return err, max(err[:4] + err[5:]) <= B1_ATOL and err[4] <= B1_DEPTH_ATOL


def check_forward_cases(tag, args, placed):
    """B1 (B1t with placed) at the training shape beyond the committed
    model: 2 and 12 layers of random weights, a ragged batch, and two
    launches bit for bit."""
    import torch

    from tnerf_torch.render import fused as fz

    B = args[8].shape[0]
    g = torch.Generator().manual_seed(4)
    for NL in (2, 12):
        W = (torch.randn((NL, fz.LANES, fz.LANES), generator=g) * 0.1).to("cuda")
        Bias = (torch.randn((NL, fz.LANES), generator=g) * 0.1).to("cuda")
        out_k, tchk_k = fz.fused_forward(W, Bias, *args[2:], return_tchk=True, **placed)
        out_p, tchk_p = fz.fused_forward_plain(W, Bias, *args[2:], return_tchk=True, **placed)
        err, ok = forward_err(out_k, out_p)
        err_t = float((tchk_k - tchk_p).abs().max())
        log(f"{tag} NL={NL} random weights: max |kernel - plain| {err}, tchk {err_t:.2e}")
        if not (ok and err_t <= B1_ATOL and torch.isfinite(out_k).all()):
            raise AssertionError(f"{tag} forward with {NL} random layers disagrees: {err}, tchk "
                                 f"{err_t}")
    n = 1001
    cut = tuple(a[:n] if torch.is_tensor(a) and a.dim() >= 1 and a.shape[0] == B else a
                for a in args[2:])
    cut_placed = {k: v[:n] for k, v in placed.items()}
    out_k, tchk_k = fz.fused_forward(*args[:2], *cut, return_tchk=True, **cut_placed)
    out_p, tchk_p = fz.fused_forward_plain(*args[:2], *cut, return_tchk=True, **cut_placed)
    err, ok = forward_err(out_k, out_p)
    err_t = float((tchk_k - tchk_p).abs().max())
    log(f"{tag} B={n}: max |kernel - plain| {err}, tchk {err_t:.2e}")
    if not (ok and err_t <= B1_ATOL):
        raise AssertionError(f"{tag} forward at B={n} disagrees: {err}, tchk {err_t}")
    runs = [fz.fused_forward(*args, term_eps=0.0, return_tchk=True, **placed) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError(f"{tag}: two forward launches are not bit-equal")
    log(f"{tag}: two forward launches bit-equal (out and tchk)")


def check_skip_contract(tag, args, placed, gout, eps):
    """Under term_eps the forward leaves chunks of opaque rays unshaded and
    the backward must skip the same ones: B1's decisions (its `shaded`
    output) equal B2's and the rule `unshaded_chunks` states.  Returns the
    number of (ray, 128-sample chunk) pairs left unshaded."""
    import torch

    from tnerf_torch.render import fused as fz

    B, S = args[8].shape
    shaded_f = torch.empty((B, fz.n_bwd_chunks(S)), dtype=torch.uint8, device="cuda")
    shaded_b = torch.empty_like(shaded_f)
    _, tchk = fz.fused_forward(*args, term_eps=eps, return_tchk=True, shaded=shaded_f, **placed)
    fz.fused_backward(*args, tchk, gout, term_eps=eps, shaded=shaded_b, **placed)
    torch.cuda.synchronize()
    rule = ~fz.unshaded_chunks(live_mask(args, placed), tchk, eps)
    if not (torch.equal(shaded_f, shaded_b) and torch.equal(shaded_f.bool(), rule)):
        raise AssertionError(
            f"{tag}: B1 left {int((shaded_f == 0).sum())} chunks unshaded, B2 skipped "
            f"{int((shaded_b == 0).sum())}, the rule says {int((~rule).sum())}; they differ in "
            f"{int((shaded_f != shaded_b).sum())} / {int((shaded_f.bool() != rule).sum())}")
    pairs = int((shaded_f.reshape(B, -1, 2) == 0).all(dim=2).sum()) if S >= 256 else 0
    log(f"{tag} S={S} at term_eps={eps}: B1 and B2 both left {int((shaded_f == 0).sum())} "
        f"(ray, 64-sample chunk) pairs unshaded ({pairs} whole 128-sample chunks), as the rule "
        f"says")
    return pairs


def check_sin_fast_path():
    """The forward kernel's branch-free sine (csrc/fused.cuh:sin_fast_path)
    bit-equal to sinf wherever sinf takes the same path (|x| < 105615):
    2^24 arguments over the encoding's range (|x| up to 1.6e3 rad), 2^22
    over the whole fast-path range, and zeros, subnormals and the
    neighbours of multiples of pi / 4."""
    import numpy as np
    import torch

    from tnerf_torch.kernels import build

    rng = np.random.default_rng(5)
    k = np.arange(-3000, 3000)
    near = (k * np.pi / 4).astype(np.float32)
    parts = [rng.uniform(-2e3, 2e3, 1 << 24), rng.uniform(-105614, 105614, 1 << 22),
             near, np.nextafter(near, np.float32(np.inf)), np.nextafter(near, np.float32(-np.inf)),
             [0.0, -0.0, 1e-40, -1e-40, 1e-30, 105614.99]]
    x = torch.from_numpy(np.concatenate([np.asarray(p, np.float32) for p in parts])).cuda()
    fast, exact = torch.empty_like(x), torch.empty_like(x)
    build.check(build.library().tnerf_sin_fast_check(
        x.data_ptr(), fast.data_ptr(), exact.data_ptr(), x.numel(),
        torch.cuda.current_stream().cuda_stream), "tnerf_sin_fast_check")
    torch.cuda.synchronize()
    bad = int((fast.view(torch.int32) != exact.view(torch.int32)).sum())
    log(f"sin_fast_path against sinf on {x.numel()} arguments: {bad} differ in any bit")
    if bad:
        raise AssertionError(f"the forward kernel's sine differs from sinf in {bad} arguments")


def check_kernels():
    """Phase 3, serving shape: B3, B4, B1 and B1t against their plain
    versions on one chunk; returns their rows."""
    import numpy as np
    import torch

    from tnerf_torch.config import Config
    from tnerf_torch.grid import tighten as tg
    from tnerf_torch.grid.traversal import make_coarse_occupancy, ray_aabb
    from tnerf_torch.render import fused as fz
    from tnerf_torch.render.fused_common import _encoding_matrices, _norm_affine
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(CONFIG).apply_overrides(["render.ray_compact=false"])
    flat = serving_chunk(cfg, dev)
    B = flat.origins.shape[0]
    _, params, occ = load_jax_checkpoint(CKPT, device=dev)
    res = cfg.grid.resolution
    res_c = fz.select_coarse_res(cfg.render, res)
    res_t = fz.select_bin_pool_res(res)
    S, P = cfg.sampler.samples_per_ray, cfg.sampler.cdf_bins
    rows = []

    # B3 tighten: bit-equal on the chunk's rays, with the model's pooled
    # occupancy and with a random 32^3 bitfield.
    te, tx = ray_aabb(flat.origins, flat.directions, cfg.grid.aabb_min, cfg.grid.aabb_max)
    te = torch.clamp_min(te, cfg.sampler.near)
    tx = torch.maximum(tx, te)
    o, d = flat.origins, flat.directions
    words = fz.pack_occupancy_words(occ.bitfield, res, res_c)
    rand = torch.from_numpy(np.random.default_rng(0).uniform(size=(res_c,) * 3) < 0.1).to(dev)
    for name, wd in (("model", words), ("random", tg.pack_words_rows(rand))):
        k0, k1 = tg.tighten_range(o, d, te, tx, wd, res_c, cfg.grid)
        p0, p1 = tg.tighten_range_plain(o, d, te, tx, wd, res_c, cfg.grid)
        if not (torch.equal(k0, p0) and torch.equal(k1, p1)):
            bad = int(((k0 != p0) | (k1 != p1)).sum())
            raise AssertionError(f"B3 tighten ({name} bitfield): {bad} of {B} rays differ")
        log(f"B3 tighten bit-equal on {B} rays ({name} bitfield)")
    live = int((tx > te).sum())
    b3 = probe_shape("serving chunk", o, d, te, tx, words, res_c, cfg.grid, 256, 0)
    b3_ms = b3["ms"]
    b3_plain = cuda_ms(lambda: tg.tighten_range_plain(o, d, te, tx, words, res_c, cfg.grid), 3)
    rows.append(bound_row("tighten_range", "tnerf_torch/csrc/tighten.cu",
                          "tnerf/grid/pallas_dda.py:333", 0.0, b3_ms, b3_plain,
                          *probe_bound(B, live, 256, 0), PEAK_F32, b3["wrapper_ms"]))

    # B4 tighten + sample mask: bit-equal t0, t1 and mask for both of its
    # uses (ray compaction: n = S on the kernel's pooling; CDF bins: n =
    # cdf_bins on the bin pooling), model and random bitfields; its t0 / t1
    # are B3's.
    b4_ms = b4_plain = None
    for use, pool, n in (("compaction", res_c, S), ("cdf bins", res_t, P)):
        model = make_coarse_occupancy(occ.bitfield.reshape(res, res, res), res // pool)
        rnd = torch.from_numpy(np.random.default_rng(1).uniform(size=(pool,) * 3) < 0.1).to(dev)
        for name, oc in (("model", model), ("random", rnd)):
            k = tg.tighten_sample_mask(o, d, te, tx, oc, n, cfg.grid)
            pl = tg.tighten_sample_mask_plain(o, d, te, tx, oc, n, cfg.grid)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(k, pl)):
                bad = [int((a != b).sum()) for a, b in zip(k, pl)]
                raise AssertionError(f"B4 ({use}, {name} bitfield): (t0, t1, mask) differ in {bad}")
            b3 = tg.tighten_range(o, d, te, tx, tg.pack_words_rows(oc), pool, cfg.grid)
            if not (torch.equal(k[0], b3[0]) and torch.equal(k[1], b3[1])):
                raise AssertionError(f"B4 ({use}, {name} bitfield): its span is not B3's")
            log(f"B4 bit-equal on {B} rays x {n} ({use}, {name} bitfield at {pool}^3): "
                f"{float(k[2].any(dim=1).float().mean()):.3f} of rays kept, "
                f"{float(k[2].float().mean()):.3f} of midpoints occupied")
        wd = tg.pack_words_rows(model)
        b4 = probe_shape(f"serving chunk, {use}", o, d, te, tx, wd, pool, cfg.grid, 256, n, model)
        b4_ms, b4_wrap = b4["ms"], b4["wrapper_ms"]
        b4_plain = cuda_ms(lambda: tg.tighten_sample_mask_plain(o, d, te, tx, model, n, cfg.grid,
                                                                words=wd), 3)
    # the row is the CDF use (timed last)
    rows.append(bound_row("tighten_sample_mask", "tnerf_torch/csrc/tighten.cu",
                          "tnerf/grid/pallas_dda.py:400", 0.0, b4_ms, b4_plain,
                          *probe_bound(B, live, 256, P), PEAK_F32, b4_wrap))

    # B1 fused forward on exactly the renderer's kernel inputs.
    eps = cfg.render.transmittance_threshold
    widths = [params[f"trunk.w.{l}"].shape for l in range(len(params) // 2)]
    macs = sum(a * b for a, b in widths)
    args = build_renderer(cfg).kernel_inputs(params, flat, occ.bitfield)
    err, b1_ms, b1_plain, b1_wrap = check_forward("B1", args, {}, eps, "uniform placement")
    # work this chunk needs: the MLP at its true widths for every live sample
    n_live = live_samples(args)
    rows.append(bound_row("fused_forward", "tnerf_torch/csrc/fused_forward.cu",
                          "tnerf/render/pallas_fused2.py:350", max(err), b1_ms, b1_plain,
                          n_bytes(args[:10]) + B * 6 * 4, n_live * 2 * macs, PEAK_BF16, b1_wrap))

    # B1t fed the uniform samples as per-sample placement agrees with B1.
    _, _, _, _, te_u, dt_u, o_u, d_u, mask_u, _, _ = args
    s_mid = torch.arange(S, dtype=torch.float32, device=dev) + 0.5
    affine = {"ts": (te_u[:, None] + s_mid[None, :] * dt_u[:, None]).contiguous(),
              "dts": dt_u[:, None].expand(-1, S).contiguous()}
    s_aff, b_aff = _norm_affine(cfg.grid)
    A, C, _ = _encoding_matrices(cfg.field_, s_aff, b_aff)
    zero = torch.zeros_like(te_u)
    g0, b0 = fz.encode_gamma_beta(o_u, d_u, flat.viewdirs_tp.float().contiguous(), zero,
                                  torch.ones_like(te_u), A, C)
    out_t = fz.fused_forward(args[0], args[1], g0, b0, zero, zero, *args[6:], term_eps=0.0,
                             **affine)
    out_u = fz.fused_forward(*args, term_eps=0.0)
    err_a = (out_t - out_u).abs().amax(dim=0).tolist()
    log("B1t on affine samples against B1, max |diff| per column:", err_a)
    if max(err_a[:4] + err_a[5:]) > B1_ATOL or err_a[4] > B1_DEPTH_ATOL:
        raise AssertionError(f"B1t on affine samples disagrees with B1: {err_a}")

    # B1t on inverse-CDF samples built from the model's occupancy (a kernel
    # check: that the model was trained with uniform placement does not matter).
    cdf = cfg.apply_overrides(["sampler.placement=occupancy_cdf"])
    *args_t, placed = build_renderer(cdf).kernel_inputs(params, flat, occ.bitfield)
    args_t = tuple(args_t)
    err_t, b1t_ms, b1t_plain, b1t_wrap = check_forward("B1t", args_t, placed, eps,
                                                       "CDF placement")
    n_live_t = live_samples(args_t, placed)
    rows.append(bound_row("fused_forward_tmode", "tnerf_torch/csrc/fused_forward.cu",
                          "tnerf/render/pallas_fused2.py:350", max(err_t), b1t_ms, b1t_plain,
                          n_bytes(args_t[:4] + args_t[6:10] + tuple(placed.values())) + B * 6 * 4,
                          n_live_t * 2 * macs, PEAK_BF16, b1t_wrap))
    # The same placement computed on the CPU: the cumulative sum adds in
    # another order there, so a stratum centre that sits on a CDF edge may
    # fall into the neighbouring bin (its position is continuous across the
    # edge; its mask and step are the bin's).
    from tnerf_torch.sampling import cdf_ray_samples

    t0c, t1c, bins = tg.tighten_sample_mask(
        o, d, te, tx, make_coarse_occupancy(occ.bitfield.reshape(res, res, res), res // res_t), P,
        cfg.grid)
    on_card = cdf_ray_samples(t0c, t1c, S, bins.float(), floor=cfg.sampler.cdf_floor,
                              bin_support=bins)
    on_cpu = cdf_ray_samples(t0c.cpu(), t1c.cpu(), S, bins.float().cpu(),
                             floor=cfg.sampler.cdf_floor, bin_support=bins.cpu())
    flipped = on_card.mask.cpu() != on_cpu.mask
    moved = (on_card.t.cpu() - on_cpu.t).abs()
    print(f"CDF placement, card against CPU on {B}x{S} samples: {int(flipped.sum())} masks differ "
          f"({float(flipped.float().mean()):.2e}), max |t diff| {float(moved.max()):.3e} "
          f"({float(moved[~flipped].max()):.3e} where the masks agree)", flush=True)
    if float(flipped.float().mean()) > 1e-2 or float(moved.max()) > 1e-3:
        raise AssertionError("CDF placement on the card left the CPU's by more than ties explain")
    log(f"chunk of {B} rays x {S} samples: uniform {n_live} live samples "
        f"({n_live / (B * S):.3f}), B1 {b1_ms:.3f} ms (plain {b1_plain:.1f}); CDF {n_live_t} live "
        f"({n_live_t / (B * S):.3f}), B1t {b1t_ms:.3f} ms (plain {b1t_plain:.1f}); "
        f"B3 {b3_ms:.4f} ms (plain {b3_plain:.1f})")
    print(f"serving chunk {B}x{S}: live share uniform {n_live / (B * S):.4f}, CDF "
          f"{n_live_t / (B * S):.4f}; fused_forward {b1_ms:.4f} ms, fused_forward_tmode "
          f"{b1t_ms:.4f} ms, tighten_range {b3_ms:.4f} ms, tighten_sample_mask {b4_ms:.4f} ms",
          flush=True)
    return rows


def backward_rel(tag, args, tchk, gout, placed, gated=(), eps=0.0, plain_args=None):
    """B2 (or, with placed, B2t) against its plain version, by default at
    term_eps = 0 and on the same arguments (plain_args: the plain
    version's, where the kernel skips chunks under eps): (max |kernel -
    plain| / max |plain| per leaf, kernel dW, dBias, plain dW, dBias);
    fails beyond B2_RTOL in a leaf or in the dW of a layer in `gated`,
    against that layer's largest entry, and where a second launch does not
    give the same bits (`check_repeats`)."""
    import torch

    from tnerf_torch.render import fused as fz

    dW_k, dB_k = fz.fused_backward(*args, tchk, gout, term_eps=eps, **placed)
    dW_p, dB_p = fz.fused_backward_plain(*(plain_args or args), tchk, gout, **placed)
    again = fz.fused_backward(*args, tchk, gout, term_eps=eps, **placed)
    rel = {}
    for name, k, p in (("dW", dW_k, dW_p), ("dBias", dB_k, dB_p)):
        if not torch.isfinite(k).all():
            raise AssertionError(f"{tag} backward: non-finite {name}")
        rel[name] = float((k - p).abs().max() / p.abs().max())
    check_repeats(tag, again, (dW_k, dB_k))
    per_layer = [float((dW_k[l] - dW_p[l]).abs().max() / dW_p[l].abs().max().clamp_min(1e-30))
                 for l in range(dW_p.shape[0])]
    log(f"{tag}: max |kernel - plain| / max |plain|: {rel}; per layer dW {per_layer}")
    if max(rel.values()) > B2_RTOL:
        raise AssertionError(f"{tag} backward disagrees with its plain version: {rel}")
    worst = {l: per_layer[l] for l in gated if not per_layer[l] <= B2_RTOL}
    if worst:
        raise AssertionError(f"{tag} backward: the dW of layers {worst} (relative to each "
                             f"layer's largest entry) disagree with the plain version")
    return rel, dW_k, dB_k, dW_p, dB_p


def check_repeats(tag, got, want):
    """Two launches' (dW, dBias), bit-equal in both leaves (the fixed-point
    sums do not depend on the order of the adds)."""
    import torch

    torch.cuda.synchronize()
    diff = [float((a - b).abs().max()) for a, b in zip(got, want)]
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{tag}: two launches of the backward differ (max |diff| dW, dBias "
                             f"{diff})")


def step_cotangent(out, gt, white_background):
    """d mean((rgb - gt)^2) / d out of a fused forward's output out [B, 6]
    (rgb, acc, ...): the cotangent a train step gives B2."""
    import torch

    B = out.shape[0]
    rgb = out[:, 0:3] + ((1.0 - out[:, 3:4]) if white_background else 0.0)
    g = torch.zeros_like(out)
    g[:, 0:3] = 2.0 * (rgb - gt) / (3 * B)
    if white_background:
        g[:, 3] = -g[:, 0:3].sum(dim=1)
    return g


def trace_dp_split(args, tchk, gout, tag):
    """Where a data-parallel step's gradient parts from one rank's
    (ROADMAP Queue C 10), at the kernel: B2 on the training batch's two
    halves, each at twice the cotangent (a rank's loss is the mean over its
    half), summed and halved in float32 as `GradSync.reduce` sums and
    divides, against B2 on the whole batch at the cotangent (one rank) and
    at twice it, halved (one rank at a DP rank's scale).  Prints per leaf
    max |diff| / max |one rank's|; fails on nothing."""
    import torch

    from tnerf_torch.render import fused as fz

    B = gout.shape[0]
    full = fz.fused_backward(*args, tchk, gout)
    rows = lambda a, lo, hi: a[lo:hi] if torch.is_tensor(a) and a.dim() >= 1 \
        and a.shape[0] == B else a
    halves = []
    for lo, hi in ((0, B // 2), (B // 2, B)):
        cut = args[:2] + tuple(rows(a, lo, hi) for a in args[2:])
        halves.append(fz.fused_backward(*cut, tchk[lo:hi], 2.0 * gout[lo:hi]))
    split = [(a + b) / 2 for a, b in zip(*halves)]
    scaled = [g / 2 for g in fz.fused_backward(*args, tchk, 2.0 * gout)]
    torch.cuda.synchronize()
    rel = lambda x, y: [float((a - b).abs().max() / b.abs().max()) for a, b in zip(x, y)]
    report = {"halves_vs_one_rank": rel(split, full), "twice_vs_one_rank": rel(scaled, full),
              "halves_vs_twice": rel(split, scaled),
              "largest": [float(g.abs().max()) for g in full]}
    print(f"B2 data-parallel trace, {tag} (dW, dBias; max |diff| / max |one rank's|): "
          + json.dumps(report), flush=True)


def check_grid_and_flag(tag, args, tchk, gout, placed, want):
    """B2 (B2t with placed) at the training shape on a grid of SMALL_GRID
    CTAs (by replacing the occupancy query) bit-equal to `want`, the full
    grid's (dW, dBias); then under the cotangent times FLAG_GOUT_SCALE, the
    overflow flag fires and both leaves come back non-finite."""
    import torch

    from tnerf_torch.render import fused as fz

    B, S = args[8].shape
    full = fz.bwd_grid(fz.bwd_tiles(B, S)[0], fz._max_bwd_ctas(args[2].device.index,
                                                                 args[0].shape[0], bool(placed)))
    chosen = fz._max_bwd_ctas
    try:
        fz._max_bwd_ctas = lambda *_: SMALL_GRID
        small = fz.fused_backward(*args, tchk, gout, **placed)
    finally:
        fz._max_bwd_ctas = chosen
    check_repeats(f"{tag}: {SMALL_GRID} CTAs against {full}", small, want)
    flagged = fz.fused_backward(*args, tchk, gout * FLAG_GOUT_SCALE, **placed)
    torch.cuda.synchronize()
    finite = [int(torch.isfinite(g).sum()) for g in flagged]
    log(f"{tag}: {SMALL_GRID} CTAs bit-equal to {full}; under gout x {FLAG_GOUT_SCALE:g} the "
        f"flag leaves {finite} finite entries of dW, dBias")
    if any(finite):
        raise AssertionError(f"{tag}: the overflow flag did not make the gradient non-finite "
                             f"under gout x {FLAG_GOUT_SCALE:g}: {finite} finite entries")
    print(f"{tag}: the fixed-point gradient on {SMALL_GRID} CTAs equals the full grid's "
          f"({full}) to the bit; a cotangent x {FLAG_GOUT_SCALE:g} sets the overflow flag "
          f"(dW, dBias all non-finite)", flush=True)


def check_deep_skip(tag, args, placed, gout, eps, widths):
    """At 256 samples per ray under the config's term_eps, a dense random
    model of DEEP_SKIP_LAYERS layers (its inputs spilled): the chunks B1
    leaves unshaded are those B2 skips and the rule's, some of them for
    their transmittance; B2's gradient within B2_RTOL (each leaf and
    `spilled_layers`' dW) of the plain version's on the same rays with the
    skipped chunks' samples masked out."""
    import torch

    from tnerf_torch.render import fused as fz

    dev = args[2].device
    B, S = args[8].shape
    NL = DEEP_SKIP_LAYERS
    W, Bias = random_mlp(NL, 200 + NL, dev, widths)
    Bias[-1, 3] += DEEP_SKIP_DENSITY_BIAS
    deep = (W, Bias) + tuple(args[2:])
    check_skip_contract(f"{tag} NL={NL}", deep, placed, gout, eps)
    _, tchk = fz.fused_forward(*deep, term_eps=eps, return_tchk=True, **placed)
    shaded = torch.empty((B, fz.n_bwd_chunks(S)), dtype=torch.uint8, device=dev)
    fz.fused_backward(*deep, tchk, gout, term_eps=eps, shaded=shaded, **placed)
    by_t = int((fz.unshaded_chunks(live_mask(deep, placed), tchk, eps) &
                ~fz.unshaded_chunks(live_mask(deep, placed), tchk, 0.0)).sum())
    if by_t == 0:
        raise AssertionError(f"{tag} NL={NL}: no chunk skipped for its transmittance")
    keep = shaded.repeat_interleave(min(S, fz.BWD_CHUNK), dim=1)[:, :S].to(args[8].dtype)
    masked = deep[:8] + (deep[8] * keep,) + deep[9:]
    rel = backward_rel(f"{tag} NL={NL} S={S} at term_eps={eps}", deep, tchk, gout, placed,
                       spilled_layers(NL), eps=eps, plain_args=masked)[0]
    print(f"{tag} at {NL} layers, {B}x{S} under term_eps={eps}: {by_t} (ray, chunk) pairs "
          f"skipped for their transmittance, {int((shaded == 0).sum())} in all; gradient "
          f"against the plain version with them masked {rel}", flush=True)


PROBE_TIMES = []


def probe_shape(what, o, d, te, tx, words, res_c, grid, probes, n, occ=None):
    """B3 (n = 0) or B4 (n midpoints of occ, whose bitfield is `words`) on
    these rays: device and wrapper time, the reference's bound, and the
    share of probes the kernels' scan evaluates (`tighten_range_scan` at
    the wrapper's lane group); printed and kept in PROBE_TIMES."""
    from tnerf_torch.grid import tighten as tg

    B = o.shape[0]
    if n:
        run = lambda: tg.tighten_sample_mask(o, d, te, tx, occ, n, grid, probes, words=words)
        name, kernel = "tighten_sample_mask", "tighten_mask_kernel"
    else:
        run = lambda: tg.tighten_range(o, d, te, tx, words, res_c, grid, probes)
        name, kernel = "tighten_range", "tighten_kernel"
    ms, wrap = device_ms(run, kernel), wrapper_ms(run)
    group = tg._launch_group(B, probes)
    _, _, evaluated = tg.tighten_range_scan(o, d, te, tx, words, res_c, grid, probes, group)
    share = float(evaluated.sum()) / (B * probes)
    nb, ops = probe_bound(B, int((tx > te).sum()), probes, n)
    bound = max(nb / PEAK_BYTES, ops / PEAK_F32) * 1e3
    rec = dict(shape=what, kernel=name, rays=B, probes=probes, n=n, res_c=res_c, group=group,
               ms=ms, wrapper_ms=wrap, bound_ms=bound, evaluated_share=share)
    PROBE_TIMES.append(rec)
    print(f"{name} at the {what}: {B} rays, {probes} probes, n = {n}, {res_c}^3, G = {group}: "
          f"{ms:.5f} ms device, {wrap:.4f} ms wrapper, bound {bound:.5f}; the scan evaluates "
          f"{share:.4f} of the probes", flush=True)
    return rec


def probe_rays(o, d, grid, near):
    """(o, d, te, tx) as the renderers give B3 / B4 their spans."""
    import torch

    from tnerf_torch.grid.traversal import ray_aabb

    o, d = o.float().contiguous(), d.float().contiguous()
    te, tx = ray_aabb(o, d, grid.aabb_min, grid.aabb_max)
    te = torch.clamp_min(te, near)
    return o, d, te.contiguous(), torch.maximum(tx, te).contiguous()


def check_cell_ids():
    """coarse.cuh's cell id, which B1 to B4 share (floor((p - lo) * RN(1 /
    cell)), formed in floats), bit-equal on the card to the plain
    versions' arithmetic (`tighten.cell_ids`) over 2.1e7 arguments: 5e6
    uniform over three box widths around the box at res_c = 1, 7, 16 and
    32, 1e6 around a box of another size and offset, every cell boundary
    +- 4 ulp (computed in float32 and in float64), and at res_c = 12 and
    24 every argument within 64 ulp of a boundary where the reciprocal and
    the division floor differently."""
    import numpy as np
    import torch

    from tnerf_torch.grid.tighten import cell_ids
    from tnerf_torch.kernels import build

    rng = np.random.default_rng(8)
    total = bad = split = 0
    for lo, hi, res_c, n in ((-1.0, 1.0, 1, 5_000_000), (-1.0, 1.0, 7, 5_000_000),
                             (-1.0, 1.0, 16, 5_000_000), (-1.0, 1.0, 32, 5_000_000),
                             (-0.7, 2.3, 32, 1_000_000), (-1.0, 1.0, 12, 0),
                             (-1.0, 1.0, 24, 0)):
        lo32 = np.float32(lo)
        cell = (np.float32(hi) - lo32) / np.float32(res_c)
        rcp = np.float32(1.0) / cell
        ext = np.float32(hi) - lo32
        k = np.arange(res_c + 1)
        edges = [(lo32 + np.float32(k) * cell).astype(np.float32),
                 (lo + k * (hi - lo) / res_c).astype(np.float32)]
        near = []
        for e in edges:
            up = down = e
            near.append(e)
            for _ in range(4):
                up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down,
                                                                                np.float32(-np.inf))
                near += [up, down]
        ties = split_arguments(lo32, cell, res_c)
        split += ties.size
        p = np.concatenate([rng.uniform(lo - ext, hi + ext, n).astype(np.float32), ties] + near)
        x = torch.from_numpy(p).cuda()
        ids = torch.empty(x.numel(), dtype=torch.int32, device="cuda")
        build.check(build.library().tnerf_cell_id_check(
            x.data_ptr(), ids.data_ptr(), x.numel(), float(lo32), float(rcp), res_c,
            torch.cuda.current_stream().cuda_stream), "tnerf_cell_id_check")
        torch.cuda.synchronize()
        total += x.numel()
        bad += int((ids != cell_ids(x, float(lo32), float(rcp), res_c)).sum())
    log(f"coarse.cuh's cell ids against the plain arithmetic on {total} arguments ({split} where "
        f"the reciprocal and the division floor differently): {bad} differ")
    if bad:
        raise AssertionError(f"coarse.cuh's cell_id differs from tighten.cell_ids in {bad} "
                             "arguments")
    return total, split


def split_arguments(lo, cell, res, ulps=64):
    """The float32 p within `ulps` ulp of a cell boundary lo + k cell (k =
    0 .. res) where floor((p - lo) / cell) and floor((p - lo) * RN(1 /
    cell)) differ, sorted."""
    import numpy as np

    rcp = np.float32(1.0) / cell
    out = []
    for k in range(res + 1):
        b = np.float32(float(lo) + k * float(cell))
        steps = [np.array([b], np.float32)]
        up = down = steps[0]
        for _ in range(ulps):
            up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(-np.inf))
            steps += [up, down]
        p = np.concatenate(steps)
        out.append(p[np.floor((p - lo) / cell) != np.floor((p - lo) * rcp)])
    return np.unique(np.concatenate(out).astype(np.float32))


def check_probe_kernels():
    """Phase 3, B3 and B4 at every edge of their contract: t0, t1 and the
    mask bit-equal to the plain versions on a training batch of 8192
    rays (both of its uses: B3 on the kernel bitfield at 256 probes, B4
    at n = cdf_bins on the bin pooling), at res_c = 1, 7, 16 and 32 with
    the model's pooled, a random, an empty and a full bitfield at 64, 100
    and 256 probes (B4 at n = 33: rows that start off a 4-byte boundary
    and ragged tails); rays with te == tx; B = 1 and 1001; every lane
    group the kernels build, G = 8, 16 and 32 (by replacing `lane_group`);
    two launches bit-equal;
    66,000 rays of a view; the cell ids by reciprocal (check_cell_ids).
    Times both kernels at the training batch and at 66,000 rays."""
    import numpy as np
    import torch

    from tnerf_torch.cameras import camera_rays, focal_from_angle
    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.data.procedural import CAMERA_ANGLE_X, sphere_poses
    from tnerf_torch.grid import tighten as tg
    from tnerf_torch.grid.traversal import make_coarse_occupancy
    from tnerf_torch.render import fused as fz
    from tnerf_torch.train import PixelSampler
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    check_cell_ids()
    dev = torch.device("cuda")
    cfg = Config.from_json_file(CONFIG)
    grid, near = cfg.grid, cfg.sampler.near
    res = grid.resolution
    _, _, occ = load_jax_checkpoint(CKPT, device=dev)
    pooled = lambda c: make_coarse_occupancy(occ.bitfield.reshape(res, res, res), res // c)
    train = load_data("procedural", cfg.scene.name, splits=("train",),
                      proc=scene_proc_kwargs(cfg.scene))["train"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rays = PixelSampler(train, cfg.scene.scene_scale, cfg.scene.white_background,
                        dev).sample(gen, cfg.train.batch_size).rays
    o, d, te, tx = probe_rays(rays.origins, rays.directions, grid, near)

    def same(tag, o, d, te, tx, oc, n, probes):
        w = tg.pack_words_rows(oc)
        c = oc.shape[0]
        p = tg.tighten_sample_mask_plain(o, d, te, tx, oc, n, grid, probes, words=w)
        k3 = tg.tighten_range(o, d, te, tx, w, c, grid, probes)
        k4 = tg.tighten_sample_mask(o, d, te, tx, oc, n, grid, probes, words=w)
        torch.cuda.synchronize()
        bad = [int((a != b).sum()) for a, b in zip(k3 + k4, p[:2] + p)]
        if any(bad):
            raise AssertionError(f"{tag}: B3 (t0, t1) and B4 (t0, t1, mask) differ from the plain "
                                 f"versions in {bad} elements")
        return p

    cases = 0
    rng = np.random.default_rng(6)
    for c in (1, 7, 16, 32):
        fields = {"random": torch.from_numpy(rng.uniform(size=(c,) * 3) < 0.1).to(dev),
                  "empty": torch.zeros((c,) * 3, dtype=torch.bool, device=dev),
                  "full": torch.ones((c,) * 3, dtype=torch.bool, device=dev)}
        if res % c == 0:
            fields["model"] = pooled(c)
        for fname, oc in fields.items():
            for probes in (64, 100, 256):
                same(f"res_c={c}, {fname} bitfield, {probes} probes", o, d, te, tx, oc, 33, probes)
                cases += 1
    model = pooled(32)
    flat_tx = tx.clone()
    flat_tx[::7] = te[::7]
    same("every 7th ray with te == tx", o, d, te, flat_tx, model, 64, 256)
    for n_rays in (1, 1001):
        same(f"B = {n_rays}", o[:n_rays], d[:n_rays], te[:n_rays], tx[:n_rays], model, 33, 256)
    chosen = tg.lane_group
    try:
        for G in (8, 16, 32):
            tg.lane_group = lambda *_, G=G: G
            same(f"G = {G}", o, d, te, tx, model, 33, 256)
            same(f"G = {G}, 100 probes", o, d, te, tx, model, 64, 100)
    finally:
        tg.lane_group = chosen
    cases += 6

    # both uses at the training batch, timed; two launches bit-equal
    res_c, res_t = fz.select_coarse_res(cfg.render, res), fz.select_bin_pool_res(res)
    kernel_words = fz.pack_occupancy_words(occ.bitfield, res, res_c)
    k = tg.tighten_range(o, d, te, tx, kernel_words, res_c, grid)
    if not all(torch.equal(a, b) for a, b in
               zip(k, tg.tighten_range_plain(o, d, te, tx, kernel_words, res_c, grid))):
        raise AssertionError("B3 at the training batch differs from its plain version")
    bins = pooled(res_t)
    same("training batch, CDF bins", o, d, te, tx, bins, cfg.sampler.cdf_bins, 256)
    again3 = [tg.tighten_range(o, d, te, tx, kernel_words, res_c, grid) for _ in range(2)]
    again4 = [tg.tighten_sample_mask(o, d, te, tx, bins, 64, grid) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for x, y in (again3, again4) for a, b in zip(x, y)):
        raise AssertionError("two launches of B3 or B4 are not bit-equal")
    log(f"B3 / B4 bit-equal to the plain versions in {cases + 5} cases; two launches bit-equal")
    probe_shape("training batch", o, d, te, tx, kernel_words, res_c, grid, 256, 0)
    probe_shape("training batch, CDF bins", o, d, te, tx, tg.pack_words_rows(bins), res_t, grid,
                256, cfg.sampler.cdf_bins, bins)

    # 66,000 rays of a 400x400 view: two blocks of 256 one-ray threads per SM
    W = cfg.scene.proc_width
    view = camera_rays(sphere_poses(8, seed=30)[0], W, W, focal_from_angle(W, CAMERA_ANGLE_X),
                       cfg.scene.scene_scale, device=dev)
    pick = torch.randperm(W * W, generator=torch.Generator().manual_seed(3))[:66000].to(dev)
    ob, db, teb, txb = probe_rays(view.origins.reshape(-1, 3)[pick],
                                  view.directions.reshape(-1, 3)[pick], grid, near)
    same("66,000 rays", ob, db, teb, txb, bins, 64, 256)
    probe_shape("66,000 rays", ob, db, teb, txb, kernel_words, res_c, grid, 256, 0)
    probe_shape("66,000 rays, CDF bins", ob, db, teb, txb, tg.pack_words_rows(bins), res_t, grid,
                256, 64, bins)


# B2 / B2t at depth: 9 layers (every layer input of a tile in shared
# memory), 10 (the first spilled to the scratch), 13 (the `deep` phase's
# model) and 17 (eight spilled; the scratch 17 MB on 132 CTAs).  Random
# weights at the ReLU (He) scale sqrt(2 / 128), biases at 0.01, so the
# signal neither dies nor blows up across 17 layers; at the reference's 0.1
# of the 2-layer check the gradient of the first layers vanishes in bf16.
# The widths are the committed model's: the first layer reads the encoding
# only, the head writes lanes 0..3 (rgb, density); the rest is zero, as
# `pack_params_f32` pads it.
DEEP_LAYERS = (9, 10, 13, 17)
DEEP_W_SCALE = (2.0 / 128) ** 0.5
DEEP_ROWS = []  # B2 / B2t at depth, timed at the training batch (b2_deep.json)
# check_deep_skip's density lane bias: softplus(x + 15) makes most rays
# through the occupied cells opaque within their first 128 samples, so the
# skip rule drops chunks for their transmittance (the check prints how
# many), not only for holding no live sample.
DEEP_SKIP_LAYERS = 13
DEEP_SKIP_DENSITY_BIAS = 16.0


def deep_widths(NL, widths):
    """[(in, out)] of an NL-layer MLP at the committed model's widths."""
    return [widths[0]] + [widths[1]] * (NL - 2) + [widths[-1]]


def random_mlp(NL, seed, dev, widths):
    """(W [NL, 128, 128], Bias [NL, 128]) f32 of random weights at the deep
    checks' scale, zero outside the first layer's input width and the
    head's output width (widths: the committed model's [(in, out)])."""
    import torch

    from tnerf_torch.render import fused as fz

    g = torch.Generator().manual_seed(seed)
    W = torch.randn((NL, fz.LANES, fz.LANES), generator=g) * DEEP_W_SCALE
    Bias = torch.randn((NL, fz.LANES), generator=g) * 0.01
    W[0, widths[0][0]:] = 0.0
    W[-1, :, widths[-1][1]:] = 0.0
    Bias[-1, widths[-1][1]:] = 0.0
    return W.to(dev), Bias.to(dev)


def spilled_layers(NL):
    """Layers whose dW reads a tile the scratch's ring of slots held: input
    v <= NL - 9 (spilled) and, two layers down, the gradient at layer m's
    output for m <= NL - 11; layer 0's gradient comes through them all."""
    from tnerf_torch.render import fused as fz

    return list(range(max(0, NL - fz.MAX_BWD_LAYERS) + 1))


def check_deep_backward(tag, args, placed, gout, eps, widths):
    """B2 (B2t with placed) past shared memory, on the training batch's
    rays: within B2_RTOL of the plain version at every depth of
    DEEP_LAYERS, in each leaf and in each of `spilled_layers`' dW, on a
    ragged batch at 13 layers, two launches bit-equal at every depth
    (`backward_rel`); device times at 13 and 17 layers under the config's
    term_eps, with the bound and the scratch's bytes."""
    import torch

    from tnerf_torch.render import fused as fz

    dev = args[2].device
    B, S = args[8].shape
    for NL in DEEP_LAYERS:
        W, Bias = random_mlp(NL, 100 + NL, dev, widths)
        deep = (W, Bias) + tuple(args[2:])
        gated = spilled_layers(NL)
        _, tchk = fz.fused_forward(*deep, term_eps=0.0, return_tchk=True, **placed)
        backward_rel(f"{tag} NL={NL}", deep, tchk, gout, placed, gated)
        if NL == 13:
            n = 1001
            cut = tuple(a[:n] if torch.is_tensor(a) and a.dim() >= 1 and a.shape[0] == B else a
                        for a in deep[2:])
            backward_rel(f"{tag} NL={NL} B={n}", deep[:2] + cut, tchk[:n], gout[:n],
                         {k: v[:n] for k, v in placed.items()}, gated)
        if NL in (13, 17):
            _, tchk_e = fz.fused_forward(*deep, term_eps=eps, return_tchk=True, **placed)
            shaded = torch.zeros((B, fz.n_bwd_chunks(S)), dtype=torch.uint8, device=dev)
            fz.fused_backward(*deep, tchk_e, gout, term_eps=eps, shaded=shaded, **placed)
            run = lambda: fz.fused_backward(*deep, tchk_e, gout, term_eps=eps, **placed)
            ms = device_ms(run, "fused_backward_kernel", reps=20)
            live = int((live_mask(deep, placed) &
                        shaded.repeat_interleave(min(S, fz.BWD_CHUNK), dim=1)[:, :S].bool()).sum())
            # forward again, weight and input gradients at the model's widths,
            # less the first layer's input gradient (as check_backward's bound)
            wd = deep_widths(NL, widths)
            ops = live * 2 * (3 * sum(a * b for a, b in wd) - wd[0][0] * wd[0][1])
            # each shaded tile stores and reloads its spilled inputs, 16 KB each way
            tiles = int(shaded.sum()) // fz.bwd_tiles(B, S)[1]
            spill = tiles * (NL - fz.MAX_BWD_LAYERS) * 2 * fz.BWD_CHUNK * fz.LANES * 2
            row = {"tag": tag, "layers": NL, "batch": [B, S], "ms": ms, "live_samples": live,
                   "bound_ms": ops / PEAK_BF16 * 1e3, "bound_by": "operations",
                   "spill_bytes": spill, "spill_ms_at_hbm_rate": spill / PEAK_BYTES * 1e3}
            DEEP_ROWS.append(row)
            print(f"{tag} at {NL} layers, training batch {B}x{S}: {ms:.4f} ms (bound "
                  f"{row['bound_ms']:.4f} by operations; scratch traffic {spill / 1e6:.1f} MB, "
                  f"{row['spill_ms_at_hbm_rate']:.4f} ms at the HBM rate)", flush=True)


def check_backward():
    """Phase 3, training shape: B2 and B2t (and B1's / B1t's tchk) against
    the plain versions on a batch drawn from the train views, at S = 64
    (the training shape), 256 (four chunks per ray: the saved transmittance
    and the dL/dT carry), 32 (two rays per tile) and 100 (a ragged last
    chunk); a 2-layer MLP of random weights; batches that leave the
    kernel's persistent grid a ragged last round; the skip rule under the
    config's term_eps; two launches bit-equal in every case, a smaller grid
    bit-equal to the full one, the overflow flag.  Returns the two
    backward rows."""
    import torch

    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.render import fused as fz
    from tnerf_torch.train import PixelSampler
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(CONFIG)
    train_ds = load_data("procedural", cfg.scene.name, splits=("train",),
                         proc=scene_proc_kwargs(cfg.scene))["train"]
    sampler = PixelSampler(train_ds, cfg.scene.scene_scale, cfg.scene.white_background, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    batch = sampler.sample(gen, cfg.train.batch_size)
    _, params, occ = load_jax_checkpoint(CKPT, device=dev)
    B = cfg.train.batch_size
    gout = torch.randn((B, 6), generator=torch.Generator().manual_seed(1)).to(dev)
    eps = cfg.render.transmittance_threshold
    widths = [tuple(params[f"trunk.w.{l}"].shape) for l in range(len(params) // 2)]
    macs = sum(a * b for a, b in widths)
    rows = []
    for tmode in (False, True):
        tag = "B2t/B1t (CDF placement, jittered)" if tmode else "B2/B1 (uniform placement)"
        for S in (cfg.sampler.samples_per_ray, 256, 32, 100):
            c = cfg.apply_overrides([f"sampler.samples_per_ray={S}"] +
                                    (["sampler.placement=occupancy_cdf"] if tmode else []))
            inputs = build_renderer(c, for_eval=False).kernel_inputs(
                params, batch.rays, occ.bitfield, gen if tmode else None)
            args, placed = (tuple(inputs[:11]), inputs[11]) if tmode else (inputs, {})
            out_k, tchk = fz.fused_forward(*args, term_eps=0.0, return_tchk=True, **placed)
            out_p, tchk_p = fz.fused_forward_plain(*args, return_tchk=True, **placed)
            torch.cuda.synchronize()
            errs, ok = forward_err(out_k, out_p)
            err_out = max(errs[:4] + errs[5:])
            err_t = float((tchk - tchk_p).abs().max())
            if not (ok and err_t <= B1_ATOL):
                raise AssertionError(f"{tag} forward at the training shape (S={S}): out "
                                     f"{errs}, tchk {err_t}")
            _, dW_k, dB_k, dW_p, dB_p = backward_rel(f"{tag} S={S}", args, tchk, gout, placed)
            log(f"{tag} S={S}: tchk [B, {tchk.shape[1]}] err {err_t:.2e}, out err {err_out:.2e}")
            if S == 256:
                # four chunks per ray: under the config's term_eps the forward
                # stops shading rays that have gone opaque and the backward must
                # skip the same chunks; what they held is below term_eps
                out_e, tchk_e = fz.fused_forward(*args, term_eps=eps, return_tchk=True, **placed)
                dW_e, dB_e = fz.fused_backward(*args, tchk_e, gout, term_eps=eps, **placed)
                torch.cuda.synchronize()
                skipped = int((tchk_e[:, [0, 2]] <= eps).sum())
                rel_e = float((dW_e - dW_k).abs().max() / dW_k.abs().max())
                err_e = float((out_e - out_k).abs()[:, [0, 1, 2, 3, 5]].max())
                log(f"{tag} S={S} at term_eps={eps}: {skipped} (ray, 128-sample chunk) pairs "
                    f"skipped, dW moves by {rel_e:.2e} of its largest entry, out by {err_e:.2e}")
                if not (rel_e <= 2e-3 and err_e <= 2e-3 and torch.isfinite(dW_e).all()):
                    raise AssertionError(f"{tag}: term_eps={eps} changed the S={S} result: dW "
                                         f"{rel_e}, out {err_e}")
                check_skip_contract(tag, args, placed, gout, eps)
                check_deep_skip(tag, args, placed, gout, eps, widths)
            if S != cfg.sampler.samples_per_ray:
                continue
            check_forward_cases(tag, args, placed)
            check_grid_and_flag(tag, args, tchk, gout, placed, (dW_k, dB_k))
            if not tmode:
                trace_dp_split(args, tchk, gout, "random cotangent")
                trace_dp_split(args, tchk, step_cotangent(out_k, batch.gt_rgb,
                                                          cfg.render.white_background),
                               "the train step's cotangent at the committed checkpoint")
            check_deep_backward(tag, args, placed, gout, eps, widths)
            # a batch that leaves the persistent grid's last round ragged, and (uniform
            # placement) a 2-layer MLP of random weights on the same rays
            n = B - 3 if tmode else 1001
            cut = tuple(a[:n] if torch.is_tensor(a) and a.dim() >= 1 and a.shape[0] == B else a
                        for a in args[2:])
            cut_placed = {k: v[:n] for k, v in placed.items()}
            backward_rel(f"{tag} S={S} B={n}", args[:2] + cut, tchk[:n], gout[:n], cut_placed)
            if not tmode:
                g = torch.Generator().manual_seed(3)
                W2 = (torch.randn((2, fz.LANES, fz.LANES), generator=g) * 0.1).to(dev)
                B2 = (torch.randn((2, fz.LANES), generator=g) * 0.1).to(dev)
                _, tchk2 = fz.fused_forward(W2, B2, *args[2:], term_eps=0.0, return_tchk=True)
                backward_rel(f"{tag} S={S} NL=2 random weights", (W2, B2) + args[2:], tchk2,
                             gout, {})
            # times and bound at the training shape
            b2_run = lambda: fz.fused_backward(*args, tchk, gout, term_eps=eps, **placed)
            b2_ms, b2_wrap = device_ms(b2_run, "fused_backward_kernel"), wrapper_ms(b2_run)
            b2_plain = cuda_ms(lambda: fz.fused_backward_plain(*args, tchk, gout, **placed), 2)
            b1_ms = device_ms(lambda: fz.fused_forward(*args, term_eps=eps, return_tchk=True,
                                                       **placed), "fused_forward_kernel")
            b1_plain = cuda_ms(lambda: fz.fused_forward_plain(*args, return_tchk=True, **placed),
                               2)
            live = live_samples(args, placed)
            # forward again, weight gradient and input gradient of every layer
            # but the first (whose input needs no gradient)
            b2_ops = live * 2 * (3 * macs - widths[0][0] * widths[0][1])
            read = (args[:4] + args[6:10] + tuple(placed.values())) if tmode else args[:10]
            row = bound_row("fused_backward_tmode" if tmode else "fused_backward",
                            "tnerf_torch/csrc/fused_backward.cu",
                            "tnerf/render/pallas_fused2.py:438",
                            float(max((dW_k - dW_p).abs().max(), (dB_k - dB_p).abs().max())),
                            b2_ms, b2_plain, n_bytes(read + (tchk, gout, dW_k, dB_k)), b2_ops,
                            PEAK_BF16, b2_wrap)
            rows.append(row)
            b1_bound = max((n_bytes(read + (tchk,)) + B * 6 * 4) / PEAK_BYTES,
                           live * 2 * macs / PEAK_BF16) * 1e3
            # the kernel's dense work: 26 products of 64 x 128 x 128 per tile
            dense_ms = fz.bwd_tiles(B, S)[0] * 26 * 2 * 64 * 128 * 128 / PEAK_BF16 * 1e3
            log(f"{tag}: training batch of {B} rays x {S} samples: {live} live samples "
                f"({live / (B * S):.3f}); backward {b2_ms:.3f} ms (plain {b2_plain:.1f}, bound "
                f"{row['bound_ms']:.4f} by {row['bound_by']}, dense tiles {dense_ms:.4f}), forward "
                f"with tchk {b1_ms:.3f} ms (plain {b1_plain:.1f}, bound {b1_bound:.4f})")
            print(f"train shape {B}x{S}, {'CDF' if tmode else 'uniform'} placement: live share "
                  f"{live / (B * S):.4f}, {row['name']} {b2_ms:.4f} ms (bound "
                  f"{row['bound_ms']:.4f}, dense tiles {dense_ms:.4f}), forward+tchk "
                  f"{b1_ms:.4f} ms (bound {b1_bound:.4f})", flush=True)
    return rows


def split_rays(grid, axes=(0, 1, 2)):
    """Rays along each of `axes` (the others' direction components 0, which
    `d_safe` turns into 1e-12) from 1.5 before the box, whose two other
    coordinates are arguments where the cell id by the reciprocal and by
    the division differ (`split_arguments`): (o, d) [n, 3] float32 numpy."""
    import numpy as np

    lo = np.asarray(grid.aabb_min, np.float32)
    cell = (np.asarray(grid.aabb_max, np.float32) - lo) / np.float32(grid.resolution)
    os_, ds = [], []
    for a in axes:
        b, c = (a + 1) % 3, (a + 2) % 3
        pb = split_arguments(lo[b], cell[b], grid.resolution)
        pc = split_arguments(lo[c], cell[c], grid.resolution)
        n = max(pb.size, pc.size)
        o = np.zeros((n, 3), np.float32)
        o[:, a] = lo[a] - 1.5
        o[:, b] = np.resize(pb, n)
        o[:, c] = np.resize(pc, n)[::-1]
        d = np.zeros((n, 3), np.float32)
        d[:, a] = 1.0
        os_.append(o)
        ds.append(d)
    return np.concatenate(os_), np.concatenate(ds)


def check_dda():
    """Phase 3, the grid walk: B5 bit-equal to its plain version (cells, and
    depths on the rays that hit the box) in both modes, at 16^3, 32^3,
    64^3, 128^3 and at the non-power-of-two 24^3 on [-1, 1]^3 and on
    [-1.3, 0.9]^3 (with rays through the coordinates where a cell id by
    the reciprocal differs from the division's), its times at the
    intervals training shape, an intervals eval chunk and the reference
    benchmark's shape, and B4 at the march eval's shape; returns B5's
    row."""
    import numpy as np
    import torch

    from tnerf_torch.cameras import camera_rays, focal_from_angle
    from tnerf_torch.config import Config, GridConfig
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.data.procedural import CAMERA_ANGLE_X, sphere_poses
    from tnerf_torch.grid import dda
    from tnerf_torch.grid import tighten as tg
    from tnerf_torch.grid.traversal import make_coarse_occupancy, ray_aabb
    from tnerf_torch.train import PixelSampler
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(CONFIG)
    flat = serving_chunk(cfg, dev)
    o, d = flat.origins, flat.directions
    B = o.shape[0]
    _, _, occ = load_jax_checkpoint(CKPT, device=dev)
    rand = lambda r: torch.from_numpy(np.random.default_rng(2).uniform(size=(r,) * 3)
                                      < 0.08).to(dev)
    off = dict(aabb_min=(-1.3,) * 3, aabb_max=(0.9,) * 3)
    for res, box, occupancy, factor, what in (
            (16, {}, None, 1, "dense"), (128, {}, None, 1, "dense"),
            (64, {}, occ.bitfield, 4, "the prims model's bitfield, factor 4"),
            (32, {}, rand(32), 8, "a random 8% bitfield, factor 8"),
            (24, {}, None, 1, "dense"), (24, {}, rand(24), 2, "a random 8% bitfield, factor 2"),
            (24, off, rand(24), 3, "box [-1.3, 0.9]^3, a random 8% bitfield, factor 3"),
            (24, off, None, 1, "box [-1.3, 0.9]^3, dense")):
        grid = GridConfig(resolution=res, **box)
        ro, rd = o, d
        if res == 24:  # add rays along the axes through coordinates where the cell id by
            # the reciprocal differs from the division's
            ro, rd = (torch.cat([a, torch.from_numpy(b).to(dev)])
                      for a, b in zip((o, d), split_rays(grid)))
        k_t0, k_cell, te, tx = dda.march_raw(ro, rd, grid, occupancy, factor)
        p_t0, p_cell, _, _ = dda.march_raw_plain(ro, rd, grid, occupancy, factor)
        torch.cuda.synchronize()
        hit = tx > te
        bad_cells = int((k_cell != p_cell).sum())
        bad_t0 = int((k_t0[:, hit] != p_t0[:, hit]).sum())
        log(f"B5 at {res}^3 ({what}), {ro.shape[0]} rays x {k_t0.shape[0]} steps: {bad_cells} "
            f"cells and {bad_t0} depths differ from the plain version; "
            f"{float(hit.float().mean()):.3f} of rays hit the box, "
            f"{float((k_cell >= 0).float().mean()):.4f} of steps emit a cell")
        if bad_cells or bad_t0:
            raise AssertionError(f"B5 at {res}^3 ({what}) is not bit-equal to its plain version: "
                                 f"{bad_cells} cells, {bad_t0} depths")

    # ragged and tiny batches (a partial last block, one block of 8 threads with
    # one ray), one step, and two launches bit for bit
    g16, w16 = GridConfig(resolution=16), dda.pack_coarse_words(rand(16))
    for n, n_steps in ((1, 1), (1, 48), (1001, 1), (1001, 48)):
        args_n = dda._ray_setup(o[:n], d[:n], g16)
        for words_n in (None, w16):
            k = dda.dda_steps(*args_n, words_n, 16, 1, n_steps, g16)
            again = dda.dda_steps(*args_n, words_n, 16, 1, n_steps, g16)
            p = dda.dda_steps_plain(*args_n, words_n, 16, 1, n_steps, g16)
            hit = args_n[4] > args_n[3]
            mode = "dense" if words_n is None else "skipping"
            if not (torch.equal(k[1], p[1]) and torch.equal(k[0][:, hit], p[0][:, hit])
                    and torch.equal(k[0], again[0]) and torch.equal(k[1], again[1])):
                raise AssertionError(f"B5 on {n} rays x {n_steps} steps ({mode}) is not "
                                     "bit-equal to its plain version or to its own second launch")
    log("B5 on 1 and 1001 rays, 1 and 48 steps, dense and skipping: bit-equal to the plain "
        "version, two launches bit-equal")
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bound(n_rays, steps, words, ops_per_step):
        n_b = n_rays * 44 + steps * n_rays * 8 + (4096 if words else 0)
        return n_b, n_rays * steps * ops_per_step

    # the intervals training shape: a batch of the hard scene's train rays,
    # 16^3, 49 steps, the skipping walk at coarse factor 1 (what
    # `traverse_grid` runs under max_hits = 3 res), on the prims occupancy
    # pooled to 16^3
    icfg = Config.from_json_file(CONFIG_INTERVALS)
    train_ds = load_data("procedural", icfg.scene.name, splits=("train",),
                         proc=scene_proc_kwargs(icfg.scene))["train"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rays = PixelSampler(train_ds, icfg.scene.scene_scale, icfg.scene.white_background,
                        dev).sample(gen, icfg.train.batch_size).rays
    occ16 = make_coarse_occupancy(occ.bitfield, 4)
    steps = icfg.grid.effective_max_hits + 1
    args = dda._ray_setup(rays.origins, rays.directions, icfg.grid)
    words = dda.pack_coarse_words(occ16)
    k = dda.dda_steps(*args, words, 16, 1, steps, icfg.grid)
    pl = dda.dda_steps_plain(*args, words, 16, 1, steps, icfg.grid)
    hit = args[4] > args[3]
    if not (torch.equal(k[1], pl[1]) and torch.equal(k[0][:, hit], pl[0][:, hit])):
        raise AssertionError("B5 at the intervals training shape is not bit-equal to its plain "
                             "version")
    n_small = rays.origins.shape[0]
    b5_run = lambda: dda.dda_steps(*args, words, 16, 1, steps, icfg.grid)
    ms_small, b5_wrap = device_ms(b5_run, "dda_kernel"), wrapper_ms(b5_run)
    # an intervals eval chunk: test view 0 of the hard scene (128 x 128 rays, one chunk)
    W = train_ds.width
    view = camera_rays(sphere_poses(8, seed=30)[0], W, train_ds.height,
                       focal_from_angle(W, CAMERA_ANGLE_X), icfg.scene.scene_scale, device=dev)
    args_e = dda._ray_setup(view.origins, view.directions, icfg.grid)
    eval_run = lambda: dda.dda_steps(*args_e, words, 16, 1, steps, icfg.grid)
    ms_eval, eval_wrap = device_ms(eval_run, "dda_kernel"), wrapper_ms(eval_run)
    n_eval = args_e[0].shape[0]
    plain_small = cuda_ms(lambda: dda.dda_steps_plain(*args, words, 16, 1, steps, icfg.grid), 3)
    # per step: three crossing depths (4 each), min / max / compare ~14, cell id
    # and bounds ~14; the coarse test and the jump add ~35
    row = bound_row("dda_march", "tnerf_torch/csrc/dda.cu", "tnerf/grid/pallas_dda.py:61", 0.0,
                    ms_small, plain_small, *bound(n_small, steps, True, 75), PEAK_F32, b5_wrap)

    # the reference benchmark's shape: an 800x800 view, 128^3, dense, 384 steps
    big = camera_rays(sphere_poses(8, seed=30)[0], 800, 800, focal_from_angle(800, CAMERA_ANGLE_X),
                      cfg.scene.scene_scale, device=dev)
    g128 = GridConfig(resolution=128)
    args_b = dda._ray_setup(big.origins, big.directions, g128)
    n_big = args_b[0].shape[0]
    ms_big = device_ms(lambda: dda.dda_steps(*args_b, None, 128, 1, 384, g128), "dda_kernel")
    bytes_big, ops_big = bound(n_big, 384, False, 40)
    bound_big = max(bytes_big / PEAK_BYTES, ops_big / PEAK_F32) * 1e3
    bytes_eval, ops_eval = bound(n_eval, steps, True, 75)
    bound_eval = max(bytes_eval / PEAK_BYTES, ops_eval / PEAK_F32) * 1e3
    shapes = {k: dda.block_shape(n, sms) for k, n in (("train", n_small), ("eval", n_eval),
                                                       ("big", n_big))}
    print(f"dda_march: {n_small} rays x {steps} steps at 16^3 with occupancy {ms_small:.5f} ms "
          f"device, {b5_wrap:.4f} ms wrapper (plain {plain_small:.2f}, bound "
          f"{row['bound_ms']:.5f} by {row['bound_by']}); eval chunk of {n_eval} rays "
          f"{ms_eval:.5f} ms device, {eval_wrap:.4f} ms wrapper (bound {bound_eval:.5f}); {n_big} "
          f"rays x 384 steps at 128^3 dense {ms_big:.4f} ms (bound {bound_big:.4f} by "
          f"{'bytes' if bytes_big / PEAK_BYTES > ops_big / PEAK_F32 else 'operations'}, "
          f"{bytes_big / ms_big / 1e6:.1f} GB/s); blocks (threads, count) on {sms} SMs: {shapes}",
          flush=True)

    # B4 at the march eval's shape: 16^3 pooling, 64 probes, 96 midpoints
    te, tx = ray_aabb(o, d, cfg.grid.aabb_min, cfg.grid.aabb_max)
    te = torch.clamp_min(te, cfg.sampler.near).contiguous()
    tx = torch.maximum(tx, te).contiguous()
    w16 = tg.pack_words_rows(occ16)
    kb = tg.tighten_sample_mask(o, d, te, tx, occ16, 96, cfg.grid, probes=64, words=w16)
    pb = tg.tighten_sample_mask_plain(o, d, te, tx, occ16, 96, cfg.grid, probes=64)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kb, pb)):
        raise AssertionError("B4 at the march eval's shape is not bit-equal to its plain version")
    probe_shape("march eval (16^3, 64 probes, 96 midpoints, words passed)", o, d, te, tx, w16,
                16, cfg.grid, 64, 96, occ16)
    return [row]


def last_window(metrics_path):
    """(last record with a loss, every logged loss, final eval metrics) of a metrics.jsonl."""
    with open(metrics_path) as fh:
        recs = [json.loads(line) for line in fh]
    logged = [r for r in recs if "loss" in r]
    final = {}
    for r in recs:
        if "psnr_test" in r or "psnr_val" in r:
            final.update(r)
    return logged[-1], [r["loss"] for r in logged], final


def train_from_scratch(config, out_name, steps, per_step, reference_psnr, overrides=(),
                       gate_step=None, at_least=False, checkpoints=None):
    """A training run through the entry point, all `steps` steps of
    `config` (with `overrides`): every kernel named in per_step at least
    once per step, no step skipped, test PSNR within TRAIN_PSNR_MARGIN_DB
    of the reference's (the final eval's, or with gate_step the eval
    the run logged at that step; with at_least, not under it by more; no
    PSNR gate where reference_psnr is None).  checkpoints: a directory
    copied to the run's checkpoints first (the state train.resume starts
    from).  Returns (launch counts, final metrics, output directory)."""
    import shutil

    out_dir = os.path.join(OUT, out_name)
    shutil.rmtree(out_dir, ignore_errors=True)
    if checkpoints:
        shutil.copytree(checkpoints, os.path.join(out_dir, "checkpoints"))
    t0 = time.perf_counter()
    argv = ["train", "--config", config, "--out", out_dir]
    for ov in overrides:
        argv += ["-o", ov]
    text, launches = counted(lambda: run_cli(argv))
    train_s = time.perf_counter() - t0
    final = json.loads(text)
    last, losses, _ = last_window(os.path.join(out_dir, "metrics.jsonl"))
    gated = final
    if gate_step is not None:
        gated = [r for r in map(json.loads, open(os.path.join(out_dir, "metrics.jsonl")))
                 if r["step"] == gate_step and "psnr_test" in r][0]
    log(f"{out_name} ({train_s:.1f} s): {json.dumps(final)}; last window {json.dumps(last)}; "
        f"launches {launches}")
    if min([launches[k] for k in per_step], default=steps) < steps:
        raise AssertionError(f"{out_name}: not every kernel of {per_step} launched once per "
                             f"step: {launches}")
    if last["step"] != steps - 1 or last.get("skipped_steps", 0) > 0:
        raise AssertionError(f"{out_name}: training ended at {last}")
    ref = "no reference" if reference_psnr is None else f"reference {reference_psnr:.4f}"
    print(f"{out_name} {steps} steps: psnr_test {final['psnr_test']:.4f} dB ({ref}, worst view "
          f"{final['psnr_test_min']:.4f}), ssim_test "
          f"{final['ssim_test']:.4f}, last window {last['step_seconds'] * 1e3:.3f} ms/step, "
          f"{last['rays_per_sec']:.0f} rays/s, loss {last['loss']:.3e}, whole run {train_s:.1f} s",
          flush=True)
    if gate_step is not None:
        print(f"{out_name}: its eval at step {gate_step}: psnr_test {gated['psnr_test']:.4f} dB "
              f"on {gated['n_views_test']:.0f} views (the reference's at that step "
              f"{reference_psnr:.4f})", flush=True)
    gap = 0.0 if reference_psnr is None else gated["psnr_test"] - reference_psnr
    if (-gap if at_least else abs(gap)) > TRAIN_PSNR_MARGIN_DB:
        raise AssertionError(f"{out_name}: trained test PSNR {gated['psnr_test']} is not within "
                             f"{TRAIN_PSNR_MARGIN_DB} dB of the reference's {reference_psnr}"
                             f"{' or over it' if at_least else ''}")
    return launches, final, out_dir


def final_leaves(out_dir):
    """Every leaf of a run's last checkpoint, by name."""
    import numpy as np

    ckpt = os.path.join(out_dir, "checkpoints")
    npz = [f for f in sorted(os.listdir(ckpt)) if f.endswith(".npz")][-1]
    with np.load(os.path.join(ckpt, npz)) as z:
        return {k: z[k] for k in z.files}


def check_pair(name, what, steps, runs):
    """Two runs from one seed, each (logged losses, final checkpoint leaves,
    psnr_test): every loss and every leaf equal to the bit."""
    (l0, z0, p0), (l1, z1, p1) = runs
    loss_diff = [i for i, (a, b) in enumerate(zip(l0, l1)) if a != b]
    leaf_diff = [k for k in z0 if k not in z1 or z0[k].tobytes() != z1[k].tobytes()]
    print(f"{name}: two runs of {what} from one seed, {steps} steps: {len(l0)} logged losses, "
          f"{len(loss_diff)} differ; {len(z0)} checkpoint leaves, {len(leaf_diff)} differ; "
          f"psnr_test {p0:.6f} / {p1:.6f} dB", flush=True)
    if len(l0) != steps or len(l0) != len(l1) or loss_diff or leaf_diff \
            or set(z0) != set(z1) or p0 != p1:
        raise AssertionError(f"{name}: two runs from one seed parted: losses at steps "
                             f"{loss_diff[:10]}, leaves {leaf_diff[:10]}")


def train_repeats():
    """Two `cli train` runs of the prims config (B2) from one seed, and two
    of the CDF config (B2t): every logged loss (every step's) and every leaf
    of the final checkpoint (parameters, Adam moments and counts, the
    occupancy grid) equal to the bit.  Returns the runs' launch counts."""
    total = {}
    for config, name, steps, per_step in (
            (CONFIG, "repeat", REPEAT_STEPS, ("tighten_range", "fused_forward", "fused_backward")),
            (CONFIG_CDF, "repeat_cdf", CDF_REPEAT_STEPS,
             ("tighten_sample_mask", "fused_forward_tmode", "fused_backward_tmode"))):
        runs = []
        for i in range(2):
            launches, final, out_dir = train_from_scratch(
                config, f"{name}_{i}", steps, per_step, None,
                REPEAT_OVERRIDES + [f"train.steps={steps}", f"train.checkpoint_every={steps}"])
            runs.append((last_window(os.path.join(out_dir, "metrics.jsonl"))[1],
                         final_leaves(out_dir), final["psnr_test"]))
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
        check_pair(name, f"`cli train` of {os.path.relpath(config, REPO)}", steps, runs)
    return total


@contextlib.contextmanager
def calls_of(module, name):
    """Counts the calls of module.name (a function its callers look up by
    name at each call) while the block runs: yields [count]."""
    real, count = getattr(module, name), [0]

    def counting(*args, **kw):
        count[0] += 1
        return real(*args, **kw)

    setattr(module, name, counting)
    try:
        yield count
    finally:
        setattr(module, name, real)


def corrupted_pose_scene():
    """(datasets, overrides) of the corrupted-pose scene of
    tests/test_pose_opt.py (48x48, 3 x 64 MLP on grid_march), as phase
    `scenes` (d) trains it; train.optimize_poses is the caller's."""
    import dataclasses

    import numpy as np
    import torch

    from tnerf_torch.cameras import se3_exp
    from tnerf_torch.data.procedural import generate_procedural_scene

    n_train = 8
    scene = generate_procedural_scene(width=48, height=48, n_train=n_train, n_val=1, n_test=2,
                                      n_samples=96, device="cuda")
    rng = np.random.RandomState(3)
    true_d = np.zeros((n_train, 6), np.float32)
    true_d[:, :3] = rng.randn(n_train, 3) * 0.05
    true_d[:, 3:] = rng.randn(n_train, 3) * 0.08
    pert = se3_exp(torch.from_numpy(true_d)).numpy()
    tr = scene["train"]
    corrupted = dict(scene, train=dataclasses.replace(
        tr, poses=np.einsum("nij,njk->nik", pert, tr.poses).astype(np.float32)))
    base = [
        "scene.kind=procedural", "scene.name=prims", "scene.scene_scale=1.0",
        "scene.proc_width=48", "scene.proc_height=48", f"scene.proc_n_train={n_train}",
        "scene.proc_n_val=1", "scene.proc_n_test=2", "scene.proc_n_samples=96",
        "render.pipeline=grid_march", "grid.resolution=16", "grid.warmup_steps=20",
        "grid.update_every=10", "sampler.samples_per_ray=48", "sampler.near=2.0",
        "sampler.far=5.5", "field_.n_frequencies=6", "field_.hidden_width=64",
        "field_.hidden_layers=3", "train.batch_size=1024", "train.steps=800",
        "train.eval_every=0", "train.checkpoint_every=800", "train.log_every=400",
        "render.chunk_size=4096",
    ]
    return corrupted, base


def unfused_paths():
    """name -> (what, run, (config, overrides), switches) of phase
    `repeats`: run(out_name, extra overrides, steps) -> (launch counts,
    final metrics, output directory) trains the path; switches: whether its
    runs must reach the compacted step."""
    from tnerf_torch.config import Config
    from tnerf_torch.train_loop import run_training

    poses, pose_base = corrupted_pose_scene()
    pose_base = pose_base + ["train.optimize_poses=true"]

    def cli(config, overrides, per_step):
        return lambda out_name, extra, steps: train_from_scratch(
            config, out_name, steps, per_step, None, overrides + extra)

    def pose(overrides):
        def pose_run(out_name, extra, steps):
            import shutil

            out_dir = os.path.join(OUT, out_name)
            shutil.rmtree(out_dir, ignore_errors=True)
            cfg = Config().apply_overrides(pose_base + overrides + extra
                                           + [f"logging.out_dir={out_dir}"])
            final, launches = counted(lambda: run_training(cfg, datasets=dict(poses),
                                                           device="cuda"))
            return launches, final, out_dir
        return pose_run

    return {
        "march": (f"`cli train` of {os.path.relpath(CONFIG_MARCH, REPO)}",
                  cli(CONFIG_MARCH, MARCH_REPEAT_OVERRIDES, ()),
                  (CONFIG_MARCH, MARCH_REPEAT_OVERRIDES), True),
        "intervals": (f"`cli train` of {os.path.relpath(CONFIG_INTERVALS, REPO)}",
                      cli(CONFIG_INTERVALS, INTERVALS_REPEAT_GRID, ("dda_march",)),
                      (CONFIG_INTERVALS, INTERVALS_REPEAT_GRID), False),
        "hash": (f"`cli train` of {os.path.relpath(CONFIG_HASH, REPO)}",
                 cli(CONFIG_HASH, [], ("segment_sum",)), (CONFIG_HASH, []), True),
        "poses": ("`run_training` of the corrupted-pose scene, train.optimize_poses=true",
                  pose([]), (None, pose_base), False),
        "poses_compact": ("`run_training` of the corrupted-pose scene, train.optimize_poses="
                          "true, compacted", pose(POSE_COMPACT_OVERRIDES),
                          (None, pose_base + POSE_COMPACT_OVERRIDES), True),
    }


def refresh_steps(config, overrides, steps):
    """The steps of a run at which the occupancy refreshes (the train
    loop's rule); config None: the default config."""
    from tnerf_torch.config import Config

    cfg = load_config(config, overrides) if config else Config().apply_overrides(overrides)
    return [s for s in range(steps)
            if s >= cfg.grid.warmup_steps and s % cfg.grid.update_every == 0]


def deterministic_mode_warnings(run, name, extra, steps):
    """{first line of a warning: count} of `steps` steps of a path under
    torch.use_deterministic_algorithms(True, warn_only=True)."""
    import shutil
    import warnings

    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out_dir = run(f"deterministic_{name}",
                          extra + [f"train.steps={steps}", "train.checkpoint_every=0"], steps)[2]
    finally:
        torch.use_deterministic_algorithms(False)
    shutil.rmtree(out_dir)
    messages = {}
    for w in caught:
        key = str(w.message).splitlines()[0][:240]
        messages[key] = messages.get(key, 0) + 1
    return messages


def unfused_repeats():
    """Phase `repeats`: for march, intervals, the hash grid and pose
    refinement, UNFUSED_REPEAT_STEPS steps under PyTorch's deterministic
    mode (its warnings printed), then two runs from one seed of as many
    steps: every logged loss and every leaf of the
    final checkpoint (parameters, poses, Adam moments and counts, the
    occupancy grid) equal to the bit, at least two refreshes in each run,
    and the compacted step reached where the path switches to it.  Writes
    repeats.json; returns the runs' launch counts."""
    import shutil

    from tnerf_torch.render import grid_renderer

    total, report = {}, {}
    for name, (what, run, (config, overrides), switches) in unfused_paths().items():
        t0 = time.perf_counter()
        steps = UNFUSED_REPEAT_STEPS[name]
        warned = deterministic_mode_warnings(run, name, REPEAT_OVERRIDES, steps)
        print(f"repeat_{name}: {steps} steps under "
              f"use_deterministic_algorithms(True, warn_only=True): "
              f"{json.dumps(warned) if warned else 'no warning'}", flush=True)
        refreshes = refresh_steps(config, overrides, steps)
        if len(refreshes) < 2:
            raise AssertionError(f"repeat_{name}: {steps} steps refresh the grid at {refreshes}")
        runs = []
        for i in range(2):
            with calls_of(grid_renderer, "compacted_shade") as shaded:
                launches, final, out_dir = run(
                    f"repeat_{name}_{i}",
                    REPEAT_OVERRIDES + [f"train.steps={steps}", f"train.checkpoint_every={steps}"],
                    steps)
            if switches and shaded[0] == 0:
                raise AssertionError(f"repeat_{name}: the run never switched to the compacted "
                                     "step (no call of compacted_shade)")
            runs.append((last_window(os.path.join(out_dir, "metrics.jsonl"))[1],
                         final_leaves(out_dir), final["psnr_test"]))
            shutil.rmtree(out_dir)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
        check_pair(f"repeat_{name}", what, steps, runs)
        seconds = time.perf_counter() - t0
        report[name] = {"warnings": warned, "refreshes": refreshes,
                        "compacted_shade_calls": shaded[0], "seconds": seconds}
        print(f"repeat_{name}: refreshes at steps {refreshes}, compacted_shade called "
              f"{shaded[0]} times in a run; {seconds:.1f} s", flush=True)
    with open(os.path.join(OUT, "repeats.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return total


def logged_windows(metrics_path):
    """{step: logged window} of a metrics.jsonl (the records with a loss)."""
    with open(metrics_path) as fh:
        return {r["step"]: r for r in map(json.loads, fh) if "loss" in r}


@contextlib.contextmanager
def checkpoints_only_at(steps):
    """While the block runs, the train loop writes a checkpoint only after
    the given numbers of steps."""
    from tnerf_torch import train_loop

    real = train_loop.save_train_state

    def at_steps(ckpt_dir, step, *args, **kw):
        if step in steps:
            real(ckpt_dir, step, *args, **kw)

    train_loop.save_train_state = at_steps
    try:
        yield
    finally:
        train_loop.save_train_state = real


def train_intervals_from_reference_init(stream):
    """Phase `intervals_init`: runs/hard_r4_intervals16/config.json trained
    from the reference's initial state with the config's own log cadence
    and evals, at train.seed = 1337 + stream (the batches, the sample
    jitter and the probes; the weights are the reference's): B5 every step,
    no step skipped; each logged window printed beside the reference's;
    stream 0 keeps the states after INTERVALS_STATE_STEPS steps.  No PSNR
    gate: the final test PSNR is printed beside the reference's."""
    name = f"intervals_init_s{stream}"
    out_dir = os.path.join(OUT, name)
    cfg = load_config(CONFIG_INTERVALS)
    keep = set(INTERVALS_STATE_STEPS if stream == 0 else ()) | {cfg.train.steps}
    overrides = ["train.resume=true", f"train.seed={cfg.train.seed + stream}",
                 "train.assert_test_psnr_min=0", "train.checkpoint_every=1"]
    with checkpoints_only_at(keep):
        launches, final, _ = train_from_scratch(CONFIG_INTERVALS, name, cfg.train.steps,
                                                ("dda_march",), None, overrides,
                                                checkpoints=INTERVALS_INIT)
    ours, ref = (logged_windows(p) for p in (os.path.join(out_dir, "metrics.jsonl"),
                                             INTERVALS_RECORD))
    if abs(ours[0]["acc_mean"] - ref[0]["acc_mean"]) > 0.05:
        raise AssertionError(f"{name} did not start from the reference's initial state: "
                             f"acc_mean {ours[0]['acc_mean']} at step 0, the reference's "
                             f"{ref[0]['acc_mean']}")
    print(f"{name}: window | port " + " ".join(WINDOW_KEYS) + " | reference", flush=True)
    for step in sorted(ref):
        mine = ours.get(step, {})
        print(f"{name}: {step:5d} | " + " ".join(f"{mine.get(k, float('nan')):.6g}"
                                                 for k in WINDOW_KEYS)
              + " | " + " ".join(f"{ref[step][k]:.6g}" for k in WINDOW_KEYS), flush=True)
    print(f"{name}: psnr_test {final['psnr_test']:.4f} dB on {final['n_views_test']:.0f} views "
          f"(the reference's {JAX_INTERVALS_PSNR_TEST:.4f}, gap "
          f"{final['psnr_test'] - JAX_INTERVALS_PSNR_TEST:+.4f}), worst view "
          f"{final['psnr_test_min']:.4f}", flush=True)
    return launches


def committed_streams(run_dir, prefix="stream_"):
    """The streams committed as run_dir/<prefix>K.jsonl, in the order of K:
    [(name, {step: logged window}, final test PSNR)], the final test PSNR
    being the eval logged at FIELD_STEPS, None where a stream has none."""
    import glob
    import re

    paths = sorted(glob.glob(os.path.join(run_dir, f"{prefix}*.jsonl")),
                   key=lambda p: int(re.search(r"(\d+)\.jsonl$", p).group(1)))
    streams = []
    for path in paths:
        with open(path) as fh:
            recs = [json.loads(line) for line in fh if line.strip()]
        finals = [r["psnr_test"] for r in recs if "psnr_test" in r and r["step"] == FIELD_STEPS]
        windows = {r["step"]: r for r in recs if "loss" in r}
        streams.append((os.path.basename(path)[:-len(".jsonl")], windows,
                        finals[-1] if finals else None))
    return streams


def reference_stream_bands(ref_dir):
    """{step: {key: (least, greatest)}} over the reference's committed CPU
    streams ref_dir/stream_K.jsonl, and their count."""
    streams = [w for _, w, _ in committed_streams(ref_dir)]
    bands = {}
    for step in sorted({s for w in streams for s in w}):
        vals = [w[step] for w in streams if step in w]
        bands[step] = {k: (min(v[k] for v in vals), max(v[k] for v in vals)) for k in WINDOW_KEYS}
    return bands, len(streams)


def reference_bands(config):
    """(low, high, runs) of a table field's gate (FIELD_GATES): the least
    and greatest final test PSNR of the reference's runs from the port's
    own step-0 state, widened by TRAIN_PSNR_MARGIN_DB, and how many runs
    are behind it."""
    spec = FIELD_GATES[config]
    psnrs = list(spec.get("psnrs", ()))
    if "streams" in spec:
        psnrs += [v for _, _, v in committed_streams(spec["streams"])]
    if not psnrs or None in psnrs:
        raise AssertionError(f"no final eval of the reference committed for {config}: {psnrs}")
    return min(psnrs) - TRAIN_PSNR_MARGIN_DB, max(psnrs) + TRAIN_PSNR_MARGIN_DB, len(psnrs)


def hold_to_reference_band(name, config, psnr):
    """The table field's gate on a run's final test PSNR: inside the band
    of the reference's runs from the same initial state (`reference_bands`).
    Prints the run's class, the band, the runs behind it and the gap to the
    record."""
    lo, hi, n = reference_bands(config)
    spec = FIELD_GATES[config]
    cls = "" if spec["fog_db"] is None else (
        f", {'fogged' if psnr < spec['fog_db'] else 'clear'} (under {spec['fog_db']} dB is "
        "fogged)")
    print(f"{name}: psnr_test {psnr:.4f} dB{cls}; the band of the reference from the port's "
          f"initial state [{lo:.4f}, {hi:.4f}] over {n} runs; {psnr - spec['record']:+.4f} dB "
          f"against the record {spec['record']:.4f}", flush=True)
    if not lo <= psnr <= hi:
        raise AssertionError(f"{name}: test PSNR {psnr} is outside the band [{lo}, {hi}] of the "
                             f"reference's {n} runs from the same initial state")


# The phases that train a table field from a committed step-0 state: the
# config, that state, the record (a TPU run), the file whose step-0 window
# the start is checked against, the reference's CPU streams from the same
# state (a directory of stream_K.jsonl), stream 0's kept states and where
# they go, the lookup modes, and the fog threshold (None: no classing).
# `hash_init` and `tri_init` start from the reference's own state;
# `hash_port_init` and `tri_port_init` from the port's (the state the
# `fields` runs start from), keep no states, and check the start also
# against the first step of the config trained from scratch at its seed,
# as the `fields` run trains it.
FROM_REFERENCE_INIT = {
    "hash_init": dict(config=CONFIG_HASH, init=HASH_INIT, record=HASH_RECORD,
                      record_psnr=JAX_HASH_PSNR_TEST, start=HASH_RECORD,
                      ref_streams=HASH_REF_STREAMS,
                      keep=HASH_STATE_STEPS, states="hash_states", lookups=HASH_LOOKUPS,
                      fog_db=HASH_FOG_DB),
    "tri_init": dict(config=CONFIG_TRIPLANE, init=TRI_INIT, record=TRI_RECORD,
                     record_psnr=JAX_TRIPLANE_PSNR_TEST, start=TRI_RECORD,
                     ref_streams=TRI_REF_STREAMS,
                     keep=TRI_STATE_STEPS, states="tri_states", lookups=TRI_LOOKUPS,
                     fog_db=None),
    "hash_port_init": dict(config=CONFIG_HASH, init=os.path.join(HASH_PORT_INIT, "checkpoints"),
                           record=HASH_RECORD, record_psnr=JAX_HASH_PSNR_TEST,
                           start=os.path.join(HASH_PORT_INIT, "ref_streams", "stream_0.jsonl"),
                           ref_streams=os.path.join(HASH_PORT_INIT, "ref_streams"),
                           keep=(), states=None, lookups=HASH_LOOKUPS, fog_db=HASH_FOG_DB),
    "tri_port_init": dict(config=CONFIG_TRIPLANE, init=os.path.join(TRI_PORT_INIT, "checkpoints"),
                          record=TRI_RECORD, record_psnr=JAX_TRIPLANE_PSNR_TEST,
                          start=os.path.join(TRI_PORT_INIT, "ref_streams", "stream_0.jsonl"),
                          ref_streams=os.path.join(TRI_PORT_INIT, "ref_streams"),
                          keep=(), states=None, lookups=TRI_LOOKUPS, fog_db=None),
}
# The step-0 window of each config trained from scratch at its seed, one
# step (`first_window_from_scratch`), once a call.
SCRATCH_WINDOWS = {}


def first_window_from_scratch(config):
    """The first logged window of `config` trained through the entry point
    from scratch at its own seed, as the `fields` phase trains it, cut to
    one step (a progressive triplane under its first stage's config, the
    stage the full run starts with and draws its first batch in)."""
    import shutil

    if config not in SCRATCH_WINDOWS:
        cfg = load_config(config)
        out_dir = os.path.join(OUT, "scratch_first_step")
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = ["train", "--config", config, "--out", out_dir]
        overrides = ["train.steps=1", "train.log_every=1", "train.eval_every=0",
                     "train.checkpoint_every=0", "train.assert_test_psnr_min=0"]
        if cfg.field_.tri_upsample_steps:
            overrides += [f"field_.tri_resolution={cfg.field_.tri_init_resolution}",
                          "field_.tri_upsample_steps=[]", "field_.tri_init_resolution=0"]
        for ov in overrides:
            argv += ["-o", ov]
        counted(lambda: run_cli(argv))
        SCRATCH_WINDOWS[config] = logged_windows(os.path.join(out_dir, "metrics.jsonl"))[0]
        shutil.rmtree(out_dir)
    return SCRATCH_WINDOWS[config]


def train_from_reference_init(phase, stream, lookup):
    """The phases of FROM_REFERENCE_INIT: the config trained from the
    committed step-0 state at train.seed = 1337 + stream, with the lookups
    of `lookup`, logging every 50 steps; each logged window printed beside
    the reference's record and the band of its CPU streams from the same
    state; the hash grid's run classed fogged or clear (HASH_FOG_DB).
    Stream 0 of the gather keeps its states.  No PSNR gate: the start is
    checked (acc_mean at step 0 within 0.05 of the start file's, and for
    the port's state of the first step from scratch's).  Returns (launch
    counts, summary)."""
    import shutil

    spec = FROM_REFERENCE_INIT[phase]
    name = f"{phase}_{lookup}_s{stream}"
    out_dir = os.path.join(OUT, name)
    cfg = load_config(spec["config"])
    keep = set(spec["keep"]) if (stream, lookup) == (0, "gather") else set()
    overrides = ["train.resume=true", f"train.seed={cfg.train.seed + stream}",
                 "train.assert_test_psnr_min=0", "train.log_every=50",
                 f"train.checkpoint_every={1 if keep else 0}"] + spec["lookups"][lookup]
    # the stages' last checkpoints: each stage resumes from the one before
    chain = set(cfg.field_.tri_upsample_steps)
    t0 = time.perf_counter()
    with checkpoints_only_at(keep | chain):  # no final checkpoint: 15-20 MB each
        launches, final, _ = train_from_scratch(spec["config"], name, cfg.train.steps, (), None,
                                                overrides, checkpoints=spec["init"])
    seconds = time.perf_counter() - t0
    ckpt = os.path.join(out_dir, "checkpoints")
    for step in sorted(keep):
        dest = os.path.join(OUT, spec["states"], f"state_{step:05d}")
        shutil.rmtree(dest, ignore_errors=True)
        os.makedirs(dest)
        npz = f"step_{step:08d}.npz"
        shutil.copy(os.path.join(ckpt, npz), os.path.join(dest, npz))
        with open(os.path.join(ckpt, "treedef.json")) as fh:
            tree = json.load(fh)
        tree["last_step"] = step
        with open(os.path.join(dest, "treedef.json"), "w") as fh:
            json.dump(tree, fh)
    shutil.rmtree(ckpt)
    ours, ref, start = (logged_windows(p) for p in (os.path.join(out_dir, "metrics.jsonl"),
                                                    spec["record"], spec["start"]))
    starts = {"the reference's": start[0]}
    if spec["states"] is None:  # the port's own state: the `fields` run's first step
        starts["the first step from scratch's"] = first_window_from_scratch(spec["config"])
    for whose, window in starts.items():
        if abs(ours[0]["acc_mean"] - window["acc_mean"]) > 0.05:
            raise AssertionError(f"{name} did not start from the committed initial state: "
                                 f"acc_mean {ours[0]['acc_mean']} at step 0, {whose} "
                                 f"{window['acc_mean']}")
    print(f"{name}: step 0 acc_mean {ours[0]['acc_mean']:.6g}, loss {ours[0]['loss']:.6g}; "
          + "; ".join(f"{whose} {w['acc_mean']:.6g}, {w['loss']:.6g}"
                      + (" (the same stream: equal to the bit)"
                         if (w["acc_mean"], w["loss"]) == (ours[0]["acc_mean"], ours[0]["loss"])
                         else "") for whose, w in starts.items()), flush=True)
    bands, n_ref = reference_stream_bands(spec["ref_streams"])
    print(f"{name}: window | port " + " ".join(WINDOW_KEYS) + " | record | band of "
          f"{n_ref} reference streams", flush=True)
    for step in sorted(ours):
        cells = [" ".join(f"{ours[step][k]:.6g}" for k in WINDOW_KEYS)]
        cells.append(" ".join(f"{ref[step][k]:.6g}" for k in WINDOW_KEYS) if step in ref
                     else "-")
        cells.append(" ".join(f"[{bands[step][k][0]:.6g}, {bands[step][k][1]:.6g}]"
                              for k in WINDOW_KEYS) if step in bands else "-")
        print(f"{name}: {step:5d} | " + " | ".join(cells), flush=True)
    summary = dict(stream=stream, lookup=lookup, psnr_test=final["psnr_test"],
                   psnr_test_min=final["psnr_test_min"], seconds=seconds,
                   start={whose: {k: w[k] for k in ("acc_mean", "loss")}
                          for whose, w in starts.items()})
    verdict = ""
    if spec["fog_db"] is not None:
        summary["fogged"] = final["psnr_test"] < spec["fog_db"]
        verdict = (f": {'FOGGED' if summary['fogged'] else 'clear'} (under {spec['fog_db']} dB "
                   "is fogged)")
    print(f"{name}: psnr_test {final['psnr_test']:.4f} dB on {final['n_views_test']:.0f} views, "
          f"worst view {final['psnr_test_min']:.4f} (the record's {spec['record_psnr']:.4f})"
          f"{verdict}; {seconds:.1f} s", flush=True)
    with open(os.path.join(OUT, f"{name}.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    return launches, summary


def resume_reference_checkpoint():
    """Phase 6: the committed reference checkpoint (step 1500, Adam moments
    included) resumed through the entry point for RESUME_STEPS steps."""
    import shutil

    out_dir = os.path.join(OUT, "resume")
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(CKPT, os.path.join(out_dir, "checkpoints"))
    _, launches = counted(lambda: run_cli(
        ["train", "--config", CONFIG, "--out", out_dir, "-o", "train.resume=true",
         "-o", f"train.steps={1500 + RESUME_STEPS}", "-o", "train.schedule_total_steps=1500",
         "-o", "train.log_every=10", "-o", "train.checkpoint_every=0"]))
    last, losses, final = last_window(os.path.join(out_dir, "metrics.jsonl"))
    print(f"resume +{RESUME_STEPS} steps: losses {['%.3e' % x for x in losses]}, psnr_test "
          f"{final['psnr_test']:.4f} dB", flush=True)
    if last["step"] != 1500 + RESUME_STEPS - 1 or max(losses) > RESUME_LOSS_MAX:
        raise AssertionError(f"resumed training left the reference's loss level: {losses} "
                             f"(bound {RESUME_LOSS_MAX})")
    return launches


def step_positions(run_one_step):
    """(params, field config, grid config, positions) of the first call of
    the field's position encoding (`nerf_field.encode_positions`) that
    records autograd while run_one_step() runs: what one train step feeds
    the encoding."""
    import torch

    from tnerf_torch.fields import nerf_field

    seen, encode = [], nerf_field.encode_positions

    def capture(params, field_cfg, grid_cfg, positions):
        if torch.is_grad_enabled() and not seen:
            seen.append((params, field_cfg, grid_cfg, positions.detach()))
        return encode(params, field_cfg, grid_cfg, positions)

    nerf_field.encode_positions = capture
    try:
        run_one_step()
    finally:
        nerf_field.encode_positions = encode
    return seen[0]


def encode_times(params, field_cfg, grid_cfg, positions):
    """(forward ms, backward ms) of the field's position encoding (the table
    lookups of a table-backed field) at `positions`, each timed alone with
    CUDA events: the forward with autograd recording, as in the step, the
    backward as forward and backward less the forward."""
    import torch

    from tnerf_torch.fields.nerf_field import TABLE_ENCODINGS, encode_positions

    tables = [v for k, v in params.items() if k.split(".")[0] in TABLE_ENCODINGS]
    forward = lambda: encode_positions(params, field_cfg, grid_cfg, positions)
    cot = torch.randn_like(forward())
    fwd_ms = cuda_ms(forward, 20)
    both_ms = cuda_ms(lambda: torch.autograd.grad(forward(), tables, cot), 20)
    return fwd_ms, both_ms - fwd_ms


def table_gradient_repeats(params, field_cfg, grid_cfg, positions):
    """Two backward passes of the field's position encoding at `positions`
    with one random cotangent: whether the table gradients are bit-equal,
    and their largest difference."""
    import torch

    from tnerf_torch.fields.nerf_field import TABLE_ENCODINGS, encode_positions

    tables = [v for k, v in params.items() if k.split(".")[0] in TABLE_ENCODINGS]
    forward = lambda: encode_positions(params, field_cfg, grid_cfg, positions)
    cot = torch.randn_like(forward())
    grads = [torch.autograd.grad(forward(), tables, cot) for _ in range(2)]
    equal = all(torch.equal(a, b) for a, b in zip(*grads))
    diff = max(float((a - b).abs().max()) for a, b in zip(*grads))
    return equal, diff


SEGMENT_ROWS = []  # the segment-sum kernel's rows, one per table-field config
SORT_ROWS = []  # the stable sort's
SEGMENT_CALLS = []  # the whole call at each table field's first lookup, in turns
# every kernel one call of segment_sum_rows may launch on the card
SEGMENT_KERNELS = ("segment_sort_hist_kernel", "segment_sort_pass_kernel",
                   "segment_row_starts_kernel", "segment_sum_kernel", "segment_sum_warp_kernel",
                   "Memset")
SEGMENT_REPLACES = ("none (no Pallas kernel; the transpose of the gathers at "
                    "tnerf/fields/hashgrid.py:193, tnerf/fields/triplane.py:191, :385)")


def float_bits(t):
    """t with its float32 entries as their bits (int32), others as they are."""
    import torch

    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def check_segment_call(values, idx, rows, what):
    """`segment_sort` and `segment_sum_rows` on the card, each twice, against
    their plain versions on the CPU, bit for bit (keys, payload, row starts,
    sums); returns the sums' largest difference (0)."""
    import torch

    from tnerf_torch.fields import hashgrid

    sums = [hashgrid.segment_sum_rows(values, idx, rows) for _ in range(2)]
    sorts = [hashgrid.segment_sort(values, idx, rows) for _ in range(2)]
    torch.cuda.synchronize()
    plain = hashgrid.segment_sum_rows_plain(values.cpu(), idx.cpu(), rows)
    plain_sort = hashgrid.segment_sort_plain(values.cpu(), idx.cpu(), rows)
    sums_equal = all(torch.equal(float_bits(g.cpu()), float_bits(plain)) for g in sums)
    sorts_equal = all(torch.equal(float_bits(a.cpu()), float_bits(b))
                      for got in sorts for a, b in zip(got, plain_sort))
    err = float((sums[0].cpu() - plain).abs().max()) if plain.numel() else 0.0
    if not (sums_equal and sorts_equal):
        raise AssertionError(f"segment sum at {what}: the card's sort equal to the plain one "
                             f"{sorts_equal}, its sums {sums_equal} (max |diff| {err})")
    return err


def check_segment_edges():
    """`check_segment_call` at the edges of the sort and the sum (the shapes
    of tests/test_torch_segment_sort.py and beyond): no lookup, no row,
    every lookup in one row, most rows empty, the CP-like and hash-grid-like
    shapes, three digit passes, every payload width 1-5 and a row wider than
    a row group's 256 feature lanes, a ragged last tile, and a skewed
    multiplicity whose long rows cross many tiles."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    cases = [("no lookup", 0, 10, 2), ("no row", 0, 0, 2), ("one row, narrow", 5000, 1, 2),
             ("one row, wide", 5000, 1, 64), ("most rows empty", 1000, 100_000, 2),
             ("CP-like", 384 * 768, 384, 64), ("hash-grid-like", 150_001, 12 * 2 ** 10, 2),
             ("three passes", 1 << 20, 1 << 24, 1), ("F = 3", 100_003, 2 ** 16 + 1, 3),
             ("F = 4", 70_000, 5000, 4), ("F = 5", 50_000, 777, 5), ("F = 300", 30_000, 384, 300),
             ("skewed", 2_000_000, 196_608, 2)]
    t0 = time.perf_counter()
    for what, n, rows, F in cases:
        if what == "skewed":
            idx = (rng.zipf(1.3, n) - 1) % rows
        else:
            idx = rng.integers(0, max(rows, 1), n)
        values = torch.from_numpy(rng.standard_normal((n, F), dtype=np.float32)).to(dev)
        check_segment_call(values, torch.from_numpy(idx.astype(np.int64)).to(dev), rows, what)
    print(f"segment sort and sum at {len(cases)} edge shapes ({', '.join(c[0] for c in cases)}): "
          f"each call twice bit-equal to the plain versions ({time.perf_counter() - t0:.1f} s)",
          flush=True)


def segment_bytes(n, rows, F):
    """(sort, sum, whole call) bytes each input read once and each output
    written once: the sort reads the int64 indices (and the values where
    they are its payload) and writes the keys, payload and row starts; the
    sum reads the payload (and by index the values) and the row starts and
    writes the rows; the whole call reads the values and indices and writes
    the rows."""
    from tnerf_torch.fields.hashgrid import SORT_BY_VALUE_MAX_F

    by_value = F <= SORT_BY_VALUE_MAX_F
    payload = 4 * n * (F if by_value else 1)
    sort = 8 * n + (4 * n * F if by_value else 0) + 4 * n + payload + 4 * (rows + 1)
    summed = payload + (0 if by_value else 4 * n * F) + 4 * (rows + 1) + 4 * rows * F
    return sort, summed, 8 * n + 4 * n * F + 4 * rows * F


def check_segment_sum(params, field_cfg, grid_cfg, positions, tag):
    """The table gradient of every lookup (the stable sort, csrc/
    segment_sort.cu, then the segment sum, csrc/segment_sum.cu) on the first
    lookup of the encode's backward at a train step's own samples: the sort
    and the sums each twice bit-equal to their plain versions (on the CPU);
    the kernels of a call, listed by the profiler over windows of calls,
    must be the repo's alone; the whole call against its former path (`torch.sort` +
    `torch.searchsorted` + the former kernel, tools/torch_segment_turns.py)
    in turns: device time of every kernel a call launches, kernels per call,
    wrapper; the sort and the sum each timed with their plain versions on
    the card and a PyTorch call (`torch.sort` of the int32 keys, stable;
    `index_add_`, the one call that sums the same rows, by atomics).
    Appends the rows to SORT_ROWS and SEGMENT_ROWS, the whole call to
    SEGMENT_CALLS."""
    import torch

    from tnerf_torch.fields import hashgrid
    from tnerf_torch.fields.nerf_field import TABLE_ENCODINGS, encode_positions
    from tools.torch_segment_turns import call_turns

    seen, wrapper = [], hashgrid.segment_sum_rows

    def capture(values, idx, rows):
        if not seen:
            seen.append((values.reshape(idx.numel(), -1).contiguous(), idx.reshape(-1), rows))
        return wrapper(values, idx, rows)

    capture.launches = 0  # the wrapper counts its launches under its module name

    tables = [v for k, v in params.items() if k.split(".")[0] in TABLE_ENCODINGS]
    out = encode_positions(params, field_cfg, grid_cfg, positions)
    hashgrid.segment_sum_rows = capture
    try:
        torch.autograd.grad(out, tables, torch.randn_like(out))
    finally:
        hashgrid.segment_sum_rows = wrapper
    values, idx, rows = seen[0]
    n, F = values.shape
    shape = f"{tag}: {n} x {F} into {rows} rows"
    err = check_segment_call(values, idx, rows, f"the {tag} step")
    passes, bits = hashgrid.sort_passes(rows)
    FT, E, per_block = hashgrid.segment_shape(n, rows, F)
    turns = call_turns(values, idx, rows)
    names = turns["port"]["kernels"]
    print(f"segment sum at the {tag} step's first lookup ({n} values x {F} into {rows} rows; "
          f"{passes} digit pass(es) of {bits} bits, payload "
          f"{'the values' if F <= hashgrid.SORT_BY_VALUE_MAX_F else 'the lookup index'}; "
          f"{E} x {FT} lanes a row): bit-equal to the plain versions, twice; a call under "
          f"the profiler: {turns['port']['kernels_per_call']} launches, ms a call "
          f"{json.dumps(names)}", flush=True)
    foreign = [k for k in names if not any(s in k for s in SEGMENT_KERNELS)]
    missing = [s for s in SEGMENT_KERNELS[:3] + ("segment_sum_",) if not any(s in k for k in names)]
    if foreign or missing:
        raise AssertionError(f"segment_sum_rows at the {tag} step launched kernels not of the "
                             f"repo {foreign}, or none of {missing}")
    port, parent = turns["port"], turns["parent"]
    mean = lambda xs: sum(xs) / len(xs)
    sum_ms = sum(ms for k, ms in port["kernels"].items() if "segment_sum_" in k)
    sort_ms = sum(ms for k, ms in port["kernels"].items() if "segment_sum_" not in k)
    sort_bytes, sum_bytes, call_bytes = segment_bytes(n, rows, F)
    sort_wrap = wrapper_ms(lambda: hashgrid.segment_sort(values, idx, rows))
    sort_row = bound_row("segment_sort", "tnerf_torch/csrc/segment_sort.cu", SEGMENT_REPLACES,
                         0.0, sort_ms,
                         cuda_ms(lambda: hashgrid.segment_sort_plain(values, idx, rows), 3),
                         sort_bytes, 0, PEAK_F32, sort_wrap)
    keys32 = idx.to(torch.int32)
    sort_row["library_ms"] = cuda_ms(lambda: torch.sort(keys32, stable=True), 20)
    sum_row = bound_row("segment_sum", "tnerf_torch/csrc/segment_sum.cu", SEGMENT_REPLACES, err,
                        sum_ms, cuda_ms(lambda: hashgrid.segment_sum_rows_plain(values, idx, rows),
                                        3), sum_bytes, n * F, PEAK_F32, mean(port["wrapper_ms"]))
    library_ms = cuda_ms(lambda: torch.zeros((rows, F), device=values.device).index_add_(
        0, idx, values), 20)
    sum_row["library_ms"] = library_ms
    sort_row["shape"] = sum_row["shape"] = shape
    call = {"shape": shape, "kernels_per_call": port["kernels_per_call"],
            "device_ms": mean(port["device_ms"]), "wrapper_ms": mean(port["wrapper_ms"]),
            "bound_ms": call_bytes / PEAK_BYTES * 1e3, "index_add_ms": library_ms,
            "parent_device_ms": mean(parent["device_ms"]),
            "parent_wrapper_ms": mean(parent["wrapper_ms"]),
            "parent_kernels_per_call": parent["kernels_per_call"], "turns": turns}
    print(f"segment sum at the {tag} step, whole call (turns PNNP: the former path P, the "
          f"port N): {call['device_ms']:.4f} ms device in "
          f"{call['kernels_per_call']} kernels (turns {port['device_ms']}), "
          f"{call['wrapper_ms']:.4f} ms wrapper (turns {port['wrapper_ms']}); former "
          f"{call['parent_device_ms']:.4f} ms device in {call['parent_kernels_per_call']} "
          f"kernels (turns {parent['device_ms']}), {call['parent_wrapper_ms']:.4f} ms wrapper "
          f"(turns {parent['wrapper_ms']}); bound {call['bound_ms']:.4f}, index_add_ "
          f"{library_ms:.4f}; the sort's kernels {sort_ms:.4f} ms (bound "
          f"{sort_row['bound_ms']:.4f}, torch.sort of int32 keys {sort_row['library_ms']:.4f}, "
          f"wrapper {sort_wrap:.4f}), the sum's {sum_ms:.4f} (bound {sum_row['bound_ms']:.4f})",
          flush=True)
    SORT_ROWS.append(sort_row)
    SEGMENT_ROWS.append(sum_row)
    SEGMENT_CALLS.append(call)


def segment_step_turns(config, ckpt_dir, tag):
    """tools/torch_segment_turns.py:step_turns from the run's checkpoint:
    20 compacted steps by the former gradient path and the port's, in turns;
    the two must leave the same state to the bit."""
    from tools.torch_segment_turns import step_turns

    turns = step_turns(config, ckpt_dir)
    mean = lambda xs: sum(xs) / len(xs)
    print(f"{tag} compacted steps in turns (PNNP), per step: former path "
          f"{mean(turns['parent']['host_ms']):.3f} ms host {turns['parent']['host_ms']}, "
          f"{mean(turns['parent']['device_ms']):.3f} ms device {turns['parent']['device_ms']}, "
          f"{mean(turns['parent']['launches']):.1f} launches; the port "
          f"{mean(turns['port']['host_ms']):.3f} ms host {turns['port']['host_ms']}, "
          f"{mean(turns['port']['device_ms']):.3f} ms device {turns['port']['device_ms']}, "
          f"{mean(turns['port']['launches']):.1f} launches; states after the turns bit-equal "
          f"{turns['states_bit_equal']}", flush=True)
    if not turns["states_bit_equal"]:
        raise AssertionError(f"{tag}: the former gradient path and the port's left other states")
    return turns


def profile_train_steps(config, ckpt_dir, tag, n_steps=20, encode=False):
    """Where a train step's time goes, late in training (the weights,
    moments and occupancy of the checkpoint in ckpt_dir): device time by
    kernel (torch.profiler) against the host clock of the same steps; with
    encode, also the position encoding's forward and backward time at the
    step's own positions (`encode_times`) as shares of the step's device
    time, and whether two backward passes of it there give the same table
    gradient bits (`table_gradient_repeats`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.cameras import Rays, camera_rays
    from tnerf_torch.train import PixelSampler, RayBatch, init_train_state, make_train_step
    from tnerf_torch.train_loop import build_renderer, resolve_near_far
    from tnerf_torch.utils.checkpoint import load_train_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(config)
    train_ds = load_data("procedural", cfg.scene.name, splits=("train",),
                         proc=scene_proc_kwargs(cfg.scene))["train"]
    cfg = resolve_near_far(cfg, train_ds)
    sampler = PixelSampler(train_ds, cfg.scene.scene_scale, cfg.scene.white_background, dev)
    _, params, opt_state, occ = load_train_checkpoint(ckpt_dir, dev)
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0)).to(dev)
    field.load_state_dict(params)
    state = init_train_state(field, cfg.train)
    state.optimizer.load_state(opt_state)
    step_fn = make_train_step(build_renderer(cfg, for_eval=False))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    run = lambda n: [step_fn(state, sampler.sample(gen, cfg.train.batch_size), payload, gen)
                     for _ in range(n)]
    run(3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n_steps)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n_steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, n_launches, kernels = device_time_by_kernel(prof)
    top = [{"kernel": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
            "calls_per_step": e.count / n_steps} for e in kernels[:12]]
    result = {"config": os.path.relpath(config, REPO), "steps": n_steps,
              "ms_per_step_unprofiled": plain_ms,
              "ms_per_step_profiled": wall_ms / n_steps, "device_ms_per_step": device_ms / n_steps,
              "device_busy_share": device_ms / wall_ms,
              "kernels_per_step": n_launches / n_steps, "top": top}
    if encode:
        inputs = step_positions(lambda: run(1))
        n = inputs[3].shape[0]
        fwd_ms, bwd_ms = encode_times(*inputs)
        equal, diff = table_gradient_repeats(*inputs)
        check_segment_sum(*inputs, tag)
        step_ms = device_ms / n_steps
        result.update(encode_samples=n, encode_fwd_ms=fwd_ms, encode_bwd_ms=bwd_ms,
                      encode_fwd_share=fwd_ms / step_ms, encode_bwd_share=bwd_ms / step_ms,
                      table_gradient_bit_equal=equal, table_gradient_max_diff=diff,
                      segment_step_turns=segment_step_turns(config, ckpt_dir, tag))
        print(f"{tag} step: the position encoding at the step's {n} samples, alone: forward "
              f"{fwd_ms:.3f} ms ({fwd_ms / step_ms:.3f} of the step's device time), backward "
              f"{bwd_ms:.3f} ms ({bwd_ms / step_ms:.3f})", flush=True)
        print(f"{cfg.field_.encoding} table gradient, two backward passes at the step's {n} "
              f"samples: {'bit-equal' if equal else 'NOT bit-equal'} (max |diff| {diff:.3e})",
              flush=True)
        if not equal:
            raise AssertionError(f"{tag}: two backward passes of the {cfg.field_.encoding} "
                                 f"encoding gave other table gradients (max |diff| {diff})")
    with open(os.path.join(OUT, f"profile_{tag}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    log(f"profile of {tag} steps:", json.dumps(result))
    print(f"{tag} step, late in training: {plain_ms:.3f} ms host clock per step "
          f"({wall_ms / n_steps:.3f} under the profiler), {device_ms / n_steps:.3f} ms device busy "
          f"({result['device_busy_share']:.3f}), {result['kernels_per_step']:.0f} launches",
          flush=True)
    return result


@functools.lru_cache(maxsize=None)
def _prims_test_split():
    """The committed prims config's test split (ground truth rendered once)."""
    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs

    cfg = Config.from_json_file(CONFIG)
    return load_data("procedural", cfg.scene.name, splits=("test",),
                     proc=scene_proc_kwargs(cfg.scene))["test"]


def prims_view_renderer(overrides=()):
    """(view() -> rgb [H, W, 3] numpy of test view 0 of the prims model, cfg)
    under the committed config with `overrides`."""
    from tnerf_torch.config import Config
    from tnerf_torch.eval import render_dataset_view
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    cfg = Config.from_json_file(CONFIG).apply_overrides(list(overrides))
    ds = _prims_test_split()
    _, params, occ = load_jax_checkpoint(CKPT)
    renderer = build_renderer(cfg)
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    return (lambda: render_dataset_view(renderer, params, ds, 0, cfg.scene.scene_scale,
                                        cfg.render.chunk_size, occupancy=payload)), cfg


def compare_compaction():
    """One test view with and without ray compaction, at
    transmittance_threshold = 0 and at the config's threshold."""
    import numpy as np

    for eps_override, atol in ((["render.transmittance_threshold=0.0"], COMPACT_ATOL_EPS0),
                               ([], COMPACT_ATOL)):
        on, cfg = prims_view_renderer(eps_override)
        off, _ = prims_view_renderer(eps_override + ["render.ray_compact=false"])
        diff = float(np.abs(on() - off()).max())
        print(f"test view 0 with / without ray compaction at transmittance_threshold="
              f"{cfg.render.transmittance_threshold}: max |diff| {diff:.3e} (bound {atol})",
              flush=True)
        if not diff <= atol:
            raise AssertionError(f"ray compaction changed the view by {diff} (bound {atol})")


def profile_view():
    """Where one 400x400 test view's time goes under the committed config
    (ray compaction on): device time by kernel (torch.profiler) against the
    host clock of the same render."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    view, _ = prims_view_renderer()
    view()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        view()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, n_launches, kernels = device_time_by_kernel(prof)
    top = [{"kernel": e.key[:80], "ms": e.self_device_time_total / 1e3, "calls": e.count}
           for e in kernels[:10]]
    result = {"view": "test 0, 400x400, ray compaction on", "wall_ms": wall_ms,
              "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
              "n_kernels": n_launches, "top": top}
    with open(os.path.join(OUT, "profile.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    log("profile of one view:", json.dumps(result))
    return result


def eval_cli(config, ckpt, name, overrides=()):
    """`cli eval` through the entry point: (metrics, launch counts, what it
    wrote to standard error)."""
    metrics_path = os.path.join(OUT, f"{name}.json")
    argv = ["eval", "--config", config, "--checkpoint", ckpt, "--out", metrics_path,
            "--save-renders", os.path.join(OUT, f"renders_{name}")]
    for ov in overrides:
        argv += ["-o", ov]
    t0 = time.perf_counter()
    (_, err), launches = counted(lambda: run_cli(argv, with_stderr=True))
    with open(metrics_path) as fh:
        m = json.load(fh)
    log(f"{name} ({time.perf_counter() - t0:.1f} s): {json.dumps(m)}; launches {launches}")
    return m, launches, err


def orbit_frame(config, ckpt, name):
    text = run_cli(["render", "--config", config, "--checkpoint", ckpt, "--orbit", "1",
                    "--out", os.path.join(OUT, name), "-o", "scene.proc_width=800",
                    "-o", "scene.proc_height=800"])
    return json.loads(text.strip().splitlines()[-1])["ms_per_frame"]


SERVED_PSNR_TEST = []  # the serve phase's procedural eval of the prims model


def serve_prims():
    """Phase 4: the serving path, through the entry point a user calls,
    with the config as committed (ray compaction on)."""
    from tnerf_torch.cameras import camera_rays
    from tnerf_torch.cli import _ray_compact_guard, ray_keep_fraction
    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    m, served, _ = eval_cli(CONFIG, CKPT, "eval")
    SERVED_PSNR_TEST.append(m["psnr_test"])
    if served["fused_forward"] < 1 or served["tighten_sample_mask"] < 1:
        raise AssertionError(f"the serving path did not launch its kernels: {served}")
    if abs(m["psnr_test"] - JAX_PSNR_TEST) > PSNR_TOL_DB:
        raise AssertionError(f"test PSNR {m['psnr_test']} is not within {PSNR_TOL_DB} dB "
                             f"of the reference's {JAX_PSNR_TEST}")
    m_off, _, _ = eval_cli(CONFIG, CKPT, "eval_uncompacted", ["render.ray_compact=false"])
    cfg = Config.from_json_file(CONFIG)
    _, pool, n_mid = _ray_compact_guard(cfg)
    _, _, occ = load_jax_checkpoint(CKPT)
    ds = load_data("procedural", cfg.scene.name, splits=("test",),
                   proc=scene_proc_kwargs(cfg.scene))["test"]
    kf = ray_keep_fraction(camera_rays(ds.poses[0], ds.width, ds.height, ds.camera,
                                       cfg.scene.scene_scale, device="cuda"),
                           occ.bitfield, cfg, pool, n_mid)
    print(f"eval psnr_test {m['psnr_test']:.4f} dB (reference {JAX_PSNR_TEST:.4f}; without ray "
          f"compaction {m_off['psnr_test']:.4f}), ssim_test {m['ssim_test']:.4f} (reference "
          f"{JAX_SSIM_TEST:.4f}), render_ms_test {m['render_ms_test']:.2f} (without ray "
          f"compaction {m_off['render_ms_test']:.2f}), keep fraction of test view 0 {kf:.4f} "
          f"(capacity {cfg.render.ray_compact_fraction})", flush=True)
    views = m["n_views_val"] + m["n_views_test"]
    for k, n in served.items():
        log(f"{k}: {n / views:.1f} launches per 400x400 view")
    compare_compaction()
    prof = profile_view()
    print(f"one 400x400 view: {prof['wall_ms']:.2f} ms host clock, {prof['device_ms']:.2f} ms "
          f"device busy ({prof['device_busy_share']:.3f})", flush=True)
    print(f"render 800x800: {orbit_frame(CONFIG, CKPT, 'orbit800'):.2f} ms/frame", flush=True)
    return served


def train_and_serve_cdf():
    """Phase 7: occupancy-CDF placement, trained (its first 2500 of 5000
    steps, CDF_TRAIN_OVERRIDES) and then served with ray compaction, through
    the entry points."""
    from tnerf_torch.config import Config

    cfg = Config.from_json_file(CONFIG_CDF).apply_overrides(CDF_TRAIN_OVERRIDES)
    launches, final, out_dir = train_from_scratch(
        CONFIG_CDF, "train_cdf", cfg.train.steps,
        ("tighten_sample_mask", "fused_forward_tmode", "fused_backward_tmode"),
        JAX_CDF_PSNR_TEST_2499, CDF_TRAIN_OVERRIDES, gate_step=cfg.train.steps - 1)
    check_trained("train_cdf", cfg, final)
    ckpt = os.path.join(out_dir, "checkpoints")
    m, served, err = eval_cli(CONFIG_CDF, ckpt, "eval_cdf")
    if served["fused_forward_tmode"] < 1 or served["tighten_sample_mask"] < 1:
        raise AssertionError(f"the CDF serving path did not launch its kernels: {served}")
    warning = [line for line in err.splitlines() if line.startswith("WARNING: ray-compaction")]
    print(f"CDF eval with ray compaction: psnr_test {m['psnr_test']:.4f} dB (the run's own "
          f"uncompacted eval {final['psnr_test']:.4f}), ssim_test {m['ssim_test']:.4f}, "
          f"render_ms_test {m['render_ms_test']:.2f}; capacity warning: "
          f"{warning[0] if warning else 'none'}", flush=True)
    if abs(m["psnr_test"] - final["psnr_test"]) > PSNR_TOL_DB:
        raise AssertionError(f"compacted CDF eval {m['psnr_test']} dB is not within {PSNR_TOL_DB} "
                             f"dB of the run's own eval {final['psnr_test']}")
    print(f"CDF render 800x800: {orbit_frame(CONFIG_CDF, ckpt, 'orbit800_cdf'):.2f} ms/frame",
          flush=True)
    profile_train_steps(CONFIG_CDF, ckpt, "train_cdf")
    return {k: launches[k] + served[k] for k in launches}


def check_trained(name, cfg, final):
    """The config's own gate on the worst test view of a trained run."""
    if final["psnr_test_min"] < cfg.train.assert_test_psnr_min:
        raise AssertionError(f"{name}: worst test view {final['psnr_test_min']} dB is under the "
                             f"config's gate {cfg.train.assert_test_psnr_min}")


def serve_and_train_march():
    """Phase 8: the march pipeline.  The prims checkpoint served through
    grid_march under the three placements, with and without ray and sample
    compaction; then configs/procedural_hard_30db.json trained as
    committed."""
    import numpy as np

    from tnerf_torch.config import Config

    launches = {k: 0 for k in kernel_counters()}
    compacted = ["render.ray_compact=true", "render.compact=true", "render.compact_fraction=1.0"]
    plain = ["render.ray_compact=false", "render.compact=false"]
    for placement in ("uniform", "occupancy_cdf", "density_cdf"):
        base = MARCH_OVERRIDES + [f"sampler.placement={placement}"]
        psnrs = {}
        for tag, extra in (("plain", plain), ("compacted", compacted)):
            m, served, err = eval_cli(CONFIG, CKPT, f"eval_march_{placement}_{tag}", base + extra)
            if served["tighten_sample_mask"] < 1:
                raise AssertionError(f"march eval ({placement}, {tag}) did not launch B4: "
                                     f"{served}")
            for k, n in served.items():
                launches[k] += n
            warned = [ln for ln in err.splitlines() if ln.startswith("WARNING")]
            if warned:
                raise AssertionError(f"march eval ({placement}, {tag}): {warned}")
            psnrs[tag] = m
            if abs(m["psnr_test"] - JAX_PSNR_TEST) > MARCH_SERVE_TOL_DB[placement]:
                raise AssertionError(
                    f"prims through grid_march ({placement}, {tag}): test PSNR {m['psnr_test']} "
                    f"is not within {MARCH_SERVE_TOL_DB[placement]} dB of the fused eval's "
                    f"{JAX_PSNR_TEST}")
        views = {}
        for tag, extra in (("plain", plain),
                           ("rays", ["render.ray_compact=true", "render.compact=false"]),
                           ("samples", ["render.ray_compact=false", "render.compact=true",
                                        "render.compact_fraction=1.0"]),
                           ("both", compacted)):
            views[tag] = prims_view_renderer(base + extra)[0]()
        diffs = {tag: float(np.abs(v - views["plain"]).max()) for tag, v in views.items()
                 if tag != "plain"}
        print(f"prims through grid_march, {placement} placement: psnr_test "
              f"{psnrs['plain']['psnr_test']:.4f} dB plain, {psnrs['compacted']['psnr_test']:.4f} "
              f"with ray and sample compaction (fused eval {JAX_PSNR_TEST:.4f}); render_ms_test "
              f"{psnrs['plain']['render_ms_test']:.2f} / {psnrs['compacted']['render_ms_test']:.2f}"
              f"; test view 0 against the plain march, max |diff|: {diffs}", flush=True)
        if max(diffs.values()) > MARCH_COMPACT_ATOL:
            raise AssertionError(f"compaction changed the march view ({placement}): {diffs} "
                                 f"(bound {MARCH_COMPACT_ATOL})")

    cfg = Config.from_json_file(CONFIG_MARCH).apply_overrides(MARCH_TRAIN_OVERRIDES)
    trained, final, out_dir = train_from_scratch(CONFIG_MARCH, "train_march", cfg.train.steps, (),
                                                 JAX_MARCH_PSNR_TEST_2499, MARCH_TRAIN_OVERRIDES,
                                                 gate_step=cfg.train.steps - 1)
    check_trained("train_march", cfg, final)
    if trained["tighten_sample_mask"] < 1:
        raise AssertionError(f"the march run's evals did not launch B4: {trained}")
    profile_train_steps(CONFIG_MARCH, os.path.join(out_dir, "checkpoints"), "train_march")
    return {k: launches[k] + trained[k] for k in launches}


def train_intervals_short():
    """Phase 9: the intervals pipeline on the card, briefly: the config at
    INTERVALS_OVERRIDES trained INTERVALS_SHORT_STEPS steps through `cli
    train` (B5 every step, the loss falling), then its checkpoint served by
    `cli eval` (`serve_intervals`).  Its PSNR gate is `intervals_full`'s."""
    launches, final, out_dir = train_from_scratch(
        CONFIG_INTERVALS, "train_intervals", INTERVALS_SHORT_STEPS, ("dda_march",), None,
        INTERVALS_SHORT_OVERRIDES)
    _, losses, _ = last_window(os.path.join(out_dir, "metrics.jsonl"))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"intervals: the loss did not fall in {INTERVALS_SHORT_STEPS} "
                             f"steps: {losses}")
    print(f"intervals {INTERVALS_SHORT_STEPS} steps: loss {losses[0]:.4e} -> {losses[-1]:.4e}",
          flush=True)
    served = serve_intervals(os.path.join(out_dir, "checkpoints"), final, "eval_intervals")
    return {k: launches[k] + served[k] for k in launches}


def serve_intervals(ckpt, final, name):
    """`cli eval` of an intervals checkpoint with the config as committed:
    every eval chunk walks the grid in B5, and the test PSNR is the
    training run's own final eval's within PSNR_TOL_DB.  Returns the launch
    counts."""
    m, served, _ = eval_cli(CONFIG_INTERVALS, ckpt, name)
    views = m["n_views_val"] + m["n_views_test"]
    if served["dda_march"] < views:
        raise AssertionError(f"the intervals eval did not walk every chunk in B5: {served}")
    if abs(m["psnr_test"] - final["psnr_test"]) > PSNR_TOL_DB:
        raise AssertionError(f"intervals eval {m['psnr_test']} dB is not the run's own "
                             f"{final['psnr_test']}")
    print(f"intervals eval: psnr_test {m['psnr_test']:.4f} dB, ssim_test {m['ssim_test']:.4f}, "
          f"render_ms_test {m['render_ms_test']:.2f}, {served['dda_march'] / views:.1f} B5 "
          f"launches per view", flush=True)
    return served


def train_and_serve_intervals():
    """Phase `intervals_full` (not in the default run): the intervals
    pipeline trained for all its 2500 steps at INTERVALS_OVERRIDES and
    served through the entry points: every step and every eval chunk walks
    the grid in B5, the test PSNR within TRAIN_PSNR_MARGIN_DB of the
    reference's record and over the config's gate; one 800x800 orbit frame;
    20 steps under torch.profiler."""
    cfg = load_config(CONFIG_INTERVALS, INTERVALS_OVERRIDES)
    launches, final, out_dir = train_from_scratch(
        CONFIG_INTERVALS, "train_intervals_full", cfg.train.steps, ("dda_march",),
        JAX_INTERVALS_PSNR_TEST, INTERVALS_OVERRIDES)
    check_trained("train_intervals_full", cfg, final)
    ckpt = os.path.join(out_dir, "checkpoints")
    served = serve_intervals(ckpt, final, "eval_intervals_full")
    print(f"intervals render 800x800: "
          f"{orbit_frame(CONFIG_INTERVALS, ckpt, 'orbit800_intervals'):.2f} ms/frame", flush=True)
    profile_train_steps(CONFIG_INTERVALS, ckpt, "train_intervals_full")
    return {k: launches[k] + served[k] for k in launches}


def train_deep():
    """Phase `deep`: fused training past shared memory, through the entry
    points.  `cli train` of the prims config at DEEP_OVERRIDES (13 layers:
    B2 keeps 8 layer inputs of a tile in shared memory and spills 4), all
    its 1500 steps: B3, B1 and B2 at least once per step, the final test
    PSNR no more than TRAIN_PSNR_MARGIN_DB under JAX_PSNR_TEST; `cli eval`
    of its checkpoint equal to the run's own eval within PSNR_TOL_DB and
    one 800x800 `cli render` frame; then `cli train` of
    configs/procedural_hard_fused_cdf2.json at the same depth,
    DEEP_CDF_STEPS steps under its full schedule: B4, B1t and B2t every
    step and the loss falling."""
    launches, final, out_dir = train_from_scratch(
        CONFIG, "train_deep", 1500, ("tighten_range", "fused_forward", "fused_backward"),
        JAX_PSNR_TEST, DEEP_OVERRIDES, at_least=True)
    config = os.path.join(out_dir, "config.json")
    ckpt = os.path.join(out_dir, "checkpoints")
    m, served, _ = eval_cli(config, ckpt, "eval_deep")
    if served["fused_forward"] < 1 or abs(m["psnr_test"] - final["psnr_test"]) > PSNR_TOL_DB:
        raise AssertionError(f"deep eval: {m['psnr_test']} dB against the run's "
                             f"{final['psnr_test']}, launches {served}")
    ms = orbit_frame(config, ckpt, "orbit800_deep")
    print(f"deep eval: psnr_test {m['psnr_test']:.4f} dB (the run's {final['psnr_test']:.4f}); "
          f"render 800x800 {ms:.2f} ms/frame", flush=True)
    add = {k: launches[k] + served[k] for k in launches}
    cdf = DEEP_OVERRIDES + SHORT_RUN + [f"train.steps={DEEP_CDF_STEPS}",
                                        "train.schedule_total_steps=5000"]
    cdf_launches, _, cdf_dir = train_from_scratch(
        CONFIG_CDF, "train_deep_cdf", DEEP_CDF_STEPS,
        ("tighten_sample_mask", "fused_forward_tmode", "fused_backward_tmode"), None, cdf)
    _, losses, _ = last_window(os.path.join(cdf_dir, "metrics.jsonl"))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"deep CDF: the loss did not fall: {losses}")
    print(f"deep CDF {DEEP_CDF_STEPS} steps: loss {losses[0]:.4e} -> {losses[-1]:.4e}",
          flush=True)
    return {k: add[k] + cdf_launches[k] for k in add}


def train_and_serve_fields():
    """Phase 10: the table-backed fields through grid_march, each trained as
    committed through the entry point: the hash grid with SH (then its `cli
    eval` and its bake, `bake_hash_grid`), CP, and the progressive triplane;
    B4 launched by their evals;
    then 20 steps of each under torch.profiler, with the encoding's shares
    and the table gradients' repeatability at a step's own samples."""
    import shutil

    from tnerf_torch.config import Config

    launches = {k: 0 for k in kernel_counters()}
    for config, name in ((CONFIG_HASH, "train_hash"), (CONFIG_CP, "train_cp"),
                         (CONFIG_TRIPLANE, "train_triplane")):
        cfg = Config.from_json_file(config)
        trained, final, out_dir = train_from_scratch(config, name, cfg.train.steps, (), None)
        hold_to_reference_band(name, config, final["psnr_test"])
        check_trained(name, cfg, final)
        if trained["tighten_sample_mask"] < 1:
            raise AssertionError(f"the {name} run's evals did not launch B4: {trained}")
        for k, n in trained.items():
            launches[k] += n
        ckpt = os.path.join(out_dir, "checkpoints")
        if config == CONFIG_HASH:
            m, served, _ = eval_cli(config, ckpt, "eval_hash")
            if served["tighten_sample_mask"] < 1:
                raise AssertionError(f"the hash-grid eval did not launch B4: {served}")
            if abs(m["psnr_test"] - final["psnr_test"]) > PSNR_TOL_DB:
                raise AssertionError(f"hash-grid eval {m['psnr_test']} dB is not the run's own "
                                     f"{final['psnr_test']}")
            print(f"hash-grid eval: psnr_test {m['psnr_test']:.4f} dB, worst view "
                  f"{m['psnr_test_min']:.4f}, ssim_test {m['ssim_test']:.4f}, render_ms_test "
                  f"{m['render_ms_test']:.2f}", flush=True)
            for k, n in served.items():
                launches[k] += n
        profile_train_steps(config, ckpt, name, encode=True)
        if config == CONFIG_HASH:
            hash_ckpt = ckpt
            start_job("bake_hash", bake_argv(CONFIG_HASH, ckpt, "bake_hash", HASH_BAKE_RES))
        else:
            shutil.rmtree(ckpt)  # 128^3 occupancy grids: chiprun_out/ must stay small
    for k, n in bake_hash_grid().items():
        launches[k] += n
    shutil.rmtree(hash_ckpt)
    return launches


def b4_on_view(tag, config, ckpt, split, overrides=()):
    """B4 held bit-equal to its plain version on every ray of view 0 of
    `split`, as the march eval gives it those rays (the NDC warp where the
    config has it), with the trained occupancy of ckpt pooled as the eval
    pools it; then timed there.  Returns the launch's record."""
    import torch

    from tnerf_torch.cameras import camera_rays, ndc_warp
    from tnerf_torch.config import Config
    from tnerf_torch.grid import tighten as tg
    from tnerf_torch.grid.traversal import make_coarse_occupancy
    from tnerf_torch.train_loop import load_datasets, ndc_near_or_none, resolve_near_far
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(config).apply_overrides(list(overrides))
    ds = load_datasets(cfg, splits=(split,), device=dev)[split]
    cfg = resolve_near_far(cfg, ds)
    rays = camera_rays(ds.poses[0], ds.width, ds.height, ds.camera, cfg.scene.scene_scale,
                       device=dev)
    if ndc_near_or_none(cfg) is not None:
        rays = ndc_warp(rays, ds.width, ds.height, ds.camera, cfg.scene.ndc_near, eager=True)
    _, _, occ = load_jax_checkpoint(ckpt, device=dev)
    res, t_res = cfg.grid.resolution, cfg.sampler.tighten_res
    pooled = make_coarse_occupancy(occ.bitfield.reshape(res, res, res), res // t_res)
    o, d, te, tx = probe_rays(rays.origins.reshape(-1, 3), rays.directions.reshape(-1, 3),
                              cfg.grid, cfg.sampler.near)
    n, probes = cfg.sampler.samples_per_ray, cfg.sampler.tighten_probes
    plain = tg.tighten_sample_mask_plain(o, d, te, tx, pooled, n, cfg.grid, probes)
    kernel = tg.tighten_sample_mask(o, d, te, tx, pooled, n, cfg.grid, probes)
    torch.cuda.synchronize()
    bad = [int((a != b).sum()) for a, b in zip(kernel, plain)]
    live = int((tx > te).sum())
    print(f"B4 on the {tag} ({o.shape[0]} rays, {live} with a span, |d| in "
          f"[{float(d.norm(dim=1).min()):.4f}, {float(d.norm(dim=1).max()):.4f}], te from "
          f"{float(te.min()):.3e}): t0, t1, mask differ from the plain version in {bad} "
          f"elements", flush=True)
    if any(bad):
        raise AssertionError(f"B4 on the {tag} differs from its plain version: {bad}")
    return probe_shape(tag, o, d, te, tx, tg.pack_words_rows(pooled), t_res, cfg.grid, probes,
                       n, pooled)


def loss_falls(name, out_dir):
    """The gate of a run cut short of its config's steps: its last logged
    loss under its first."""
    _, losses, _ = last_window(os.path.join(out_dir, "metrics.jsonl"))
    print(f"{name}: loss {losses[0]:.4e} -> {losses[-1]:.4e} (cut short: the PSNR gate is the "
          "whole run's, in an extra phase)", flush=True)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall: {losses}")


def scene_run(config, name, reference, overrides=()):
    """A scene trained through `cli train` (train_from_scratch), held to
    `reference` and over SCENE_PSNR_FLOOR_DB, or where `reference` is None
    (a run cut short), its loss falling.  The run's step and view times
    printed."""
    cfg = load_config(config, overrides)
    launches, final, out_dir = train_from_scratch(config, name, cfg.train.steps, (), reference,
                                                  overrides)
    if reference is None:
        loss_falls(name, out_dir)
    elif final["psnr_test"] <= SCENE_PSNR_FLOOR_DB:
        raise AssertionError(f"{name}: test PSNR {final['psnr_test']} is not over "
                             f"{SCENE_PSNR_FLOOR_DB} dB")
    print(f"{name}: render_ms_test {final['render_ms_test']:.2f} per "
          f"{cfg.scene.kind} test view", flush=True)
    return launches, final, out_dir


def load_config(config, overrides=()):
    from tnerf_torch.config import Config

    return Config.from_json_file(config).apply_overrides(list(overrides))


def cli_status(argv):
    """(exit code, standard error) of the entry point, which may fail."""
    from tnerf_torch.cli import main

    err = _Tee(sys.stderr)
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, err.getvalue()


def train_and_serve_scenes(extra, llff_reference, colmap_reference):
    """Phase 11: scenes read from disk and pose refinement, through the
    entry points.  (a) LLFF in world space, (b) COLMAP in NDC, each trained
    at full width and depth on grid_march under the `extra` overrides and
    held to its reference (`scene_run`; SCENE_RUNS: the default phase's
    SCENE_SHORT_STEPS of 2500 steps, `scenes_full`'s all 2500 against the
    reference's records), B4 launched by their evals and held bit-equal on
    a view's rays; (c) the prims model served
    from a NeRF-synthetic export of its own ground truth; (d) the
    corrupted-pose dataset trained without and with train.optimize_poses,
    then `cli render --refined-poses`."""
    import shutil

    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.data.procedural import export_nerf_synthetic_format
    from tnerf_torch.train_loop import load_datasets, run_training

    launches = {k: 0 for k in kernel_counters()}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    # (a) LLFF, world space
    t0 = time.perf_counter()
    llff = load_data("llff", "prims_ff", root=LLFF_ROOT, device="cuda")
    loader_s = time.perf_counter() - t0
    got = {sp: (len(d), [d.height, d.width, d.channels]) for sp, d in llff.items()}
    print(f"LLFF loader: {got}, focal {llff['train'].focal!r}, {loader_s:.3f} s", flush=True)
    want = {sp: JAX_LLFF_LOADER[sp] for sp in ("train", "test")}
    if got != want or llff["train"].focal != JAX_LLFF_LOADER["focal"]:
        raise AssertionError(f"the LLFF loader's splits {got} / focal {llff['train'].focal} are "
                             f"not the reference's {JAX_LLFF_LOADER}")
    config_llff = os.path.join(OUT, "llff_config.json")
    with open(config_llff, "w") as fh:
        fh.write(Config().apply_overrides(LLFF_OVERRIDES).to_json())
    trained, final, out_dir = scene_run(config_llff, "train_llff", llff_reference, extra)
    if trained["tighten_sample_mask"] < 1:
        raise AssertionError(f"the LLFF run's evals did not launch B4: {trained}")
    add(trained)
    b4_on_view("LLFF world-space 480x360 test view", config_llff,
               os.path.join(out_dir, "checkpoints"), "test")
    shutil.rmtree(os.path.join(out_dir, "checkpoints"))

    # (b) COLMAP in NDC, as committed but for the data's root
    t0 = time.perf_counter()
    cm = load_datasets(load_config(CONFIG_COLMAP, [f"scene.root={COLMAP_ROOT}"]), device="cuda")
    print(f"COLMAP loader (recentred, bd_rescale 0.75): "
          f"{ {sp: (len(d), [d.height, d.width, d.channels]) for sp, d in cm.items()} }, "
          f"intrinsics {cm['train'].intrinsics}, {time.perf_counter() - t0:.3f} s", flush=True)
    root = [f"scene.root={COLMAP_ROOT}"]
    trained, final, out_dir = scene_run(CONFIG_COLMAP, "train_colmap", colmap_reference,
                                        root + list(extra))
    if trained["tighten_sample_mask"] < 1:
        raise AssertionError(f"the COLMAP run's evals did not launch B4 on NDC rays: {trained}")
    add(trained)
    ckpt = os.path.join(out_dir, "checkpoints")
    b4_on_view("COLMAP NDC 480x360 test view", CONFIG_COLMAP, ckpt, "test", root)
    base = ["--config", CONFIG_COLMAP, "--checkpoint", ckpt, "-o", root[0]]
    served, n = counted(lambda: run_cli(["render"] + base + [
        "--split", "test", "--out", os.path.join(OUT, "colmap_test_000.png")]))
    add(n)
    path_json = os.path.join(OUT, "colmap_path.json")
    with open(path_json, "w") as fh:
        json.dump({"poses": [p.tolist() for p in cm["test"].poses[:3]]}, fh)
    text, n = counted(lambda: run_cli(["render"] + base + [
        "--path", path_json, "--out", os.path.join(OUT, "colmap_path")]))
    add(n)
    frames = json.loads(text.strip().splitlines()[-1])
    print(f"COLMAP render --path: {frames['frames']} frames {frames['width']}x"
          f"{frames['height']}, {frames['ms_per_frame']:.2f} ms/frame", flush=True)
    if frames["frames"] != 3:
        raise AssertionError(f"render --path wrote {frames}")
    rc, err = cli_status(["render"] + base + ["--orbit", "1",
                                              "--out", os.path.join(OUT, "colmap_orbit")])
    if rc == 0 or "--orbit renders a full turntable, but scene.ndc" not in err:
        raise AssertionError(f"render --orbit under scene.ndc exited {rc}: {err[-300:]}")
    print("COLMAP render --orbit 1 under scene.ndc: refused as the reference refuses it",
          flush=True)
    shutil.rmtree(ckpt)

    # (c) NeRF-synthetic: the prims model on its own ground truth, read from PNGs
    cfg = Config.from_json_file(CONFIG)
    gt = load_data("procedural", cfg.scene.name, splits=("val", "test"),
                   proc=scene_proc_kwargs(cfg.scene), device="cuda")
    syn_root = os.path.join(OUT, "nerf_synthetic")
    shutil.rmtree(syn_root, ignore_errors=True)
    export_nerf_synthetic_format(gt, os.path.join(syn_root, cfg.scene.name))
    if not SERVED_PSNR_TEST:
        m, n, _ = eval_cli(CONFIG, CKPT, "eval")
        add(n)
        SERVED_PSNR_TEST.append(m["psnr_test"])
    m, n, _ = eval_cli(CONFIG, CKPT, "eval_nerf_synthetic",
                       ["scene.kind=nerf_synthetic", f"scene.root={syn_root}"])
    if n["fused_forward"] < 1 or n["tighten_sample_mask"] < 1:
        raise AssertionError(f"the NeRF-synthetic eval did not launch B4 and B1: {n}")
    add(n)
    print(f"prims from its NeRF-synthetic export: psnr_test {m['psnr_test']:.4f} dB (procedural "
          f"eval {SERVED_PSNR_TEST[0]:.4f}), render_ms_test {m['render_ms_test']:.2f}", flush=True)
    if abs(m["psnr_test"] - SERVED_PSNR_TEST[0]) > SYNTHETIC_TOL_DB:
        raise AssertionError(f"the NeRF-synthetic eval {m['psnr_test']} dB is not within "
                             f"{SYNTHETIC_TOL_DB} dB of the procedural eval "
                             f"{SERVED_PSNR_TEST[0]}")
    shutil.rmtree(syn_root)

    # (d) pose refinement on the corrupted-pose dataset of tests/test_pose_opt.py
    corrupted, base = corrupted_pose_scene()
    psnrs = {}
    for tag, extra, reference in (("no_opt", [], JAX_POSE_NO_OPT_PSNR_TEST),
                                  ("opt", ["train.optimize_poses=true"], JAX_POSE_OPT_PSNR_TEST)):
        out_dir = os.path.join(OUT, f"pose_{tag}")
        shutil.rmtree(out_dir, ignore_errors=True)
        t0 = time.perf_counter()
        final, n = counted(lambda: run_training(
            Config().apply_overrides(base + extra + [f"logging.out_dir={out_dir}"]),
            datasets=dict(corrupted), device="cuda"))
        add(n)
        last, _, _ = last_window(os.path.join(out_dir, "metrics.jsonl"))
        psnrs[tag] = final["psnr_test"]
        print(f"pose refinement {tag}: psnr_test {final['psnr_test']:.4f} dB (reference "
              f"{reference:.2f}), {last['step_seconds'] * 1e3:.3f} ms/step, pose_delta_norm "
              f"{last.get('pose_delta_norm', 0.0):.4f}, {time.perf_counter() - t0:.1f} s",
              flush=True)
        if abs(final["psnr_test"] - reference) > TRAIN_PSNR_MARGIN_DB:
            raise AssertionError(f"pose refinement {tag}: test PSNR {final['psnr_test']} is not "
                                 f"within {TRAIN_PSNR_MARGIN_DB} dB of the reference's {reference}")
    gain = psnrs["opt"] - psnrs["no_opt"]
    print(f"pose refinement gains {gain:.4f} dB (the reference's gate: more than "
          f"{POSE_OPT_MIN_GAIN_DB}; its record 1.83)", flush=True)
    if gain <= POSE_OPT_MIN_GAIN_DB:
        raise AssertionError(f"pose refinement gained {gain} dB, not more than "
                             f"{POSE_OPT_MIN_GAIN_DB}")
    # the refined checkpoint through the CLI, on the corrupted views read from disk
    pose_root = os.path.join(OUT, "pose_scene")
    shutil.rmtree(pose_root, ignore_errors=True)
    export_nerf_synthetic_format(corrupted, os.path.join(pose_root, "prims"))
    out_dir = os.path.join(OUT, "pose_opt")
    _, n = counted(lambda: run_cli([
        "render", "--config", os.path.join(out_dir, "config.json"), "--split", "train",
        "--refined-poses", "--pose-index", "1", "-o", "scene.kind=nerf_synthetic",
        "-o", f"scene.root={pose_root}", "--out", os.path.join(OUT, "pose_refined_train_001.png")]))
    add(n)
    print("cli render --split train --refined-poses of the refined checkpoint: written",
          flush=True)
    add(offcentre_capture())
    return launches


def offcentre_capture():
    """(e) The off-centre capture: `cli train` of 300 steps in NDC whose
    logged loss falls; then, with the trained occupancy, the training warp's
    rays of a whole training view (the NDC warp as a train step runs it) on
    the card bit-equal to the same warp on the CPU, B4 on them bit-equal to
    its plain version, and B4 on a test view's eval rays (b4_on_view)."""
    import shutil

    import torch

    from tnerf_torch.cameras import Rays, ndc_warp
    from tnerf_torch.grid import tighten as tg
    from tnerf_torch.grid.traversal import make_coarse_occupancy
    from tnerf_torch.train import PixelSampler
    from tnerf_torch.train_loop import load_datasets, ndc_near_or_none, resolve_near_far
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    cfg = load_config(CONFIG_COLMAP, OFFCENTRE_OVERRIDES)
    out_dir = os.path.join(OUT, "train_offcentre")
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    argv = ["train", "--config", CONFIG_COLMAP, "--out", out_dir]
    for ov in OFFCENTRE_OVERRIDES:
        argv += ["-o", ov]
    text, launches = counted(lambda: run_cli(argv))
    last, losses, _ = last_window(os.path.join(out_dir, "metrics.jsonl"))
    final = json.loads(text)
    print(f"off-centre capture, {cfg.train.steps} steps in NDC ({time.perf_counter() - t0:.1f} s):"
          f" logged losses {['%.4f' % x for x in losses]}, psnr_test {final['psnr_test']:.4f} dB, "
          f"{last['step_seconds'] * 1e3:.3f} ms/step", flush=True)
    if not losses[-1] < losses[0] or last["step"] != cfg.train.steps - 1:
        raise AssertionError(f"off-centre capture: the loss did not fall: {losses}")
    ckpt = os.path.join(out_dir, "checkpoints")

    dev = torch.device("cuda")
    ds = load_datasets(cfg, splits=("train",), device=dev)["train"]
    cfg = resolve_near_far(cfg, ds)
    sampler = PixelSampler(ds, cfg.scene.scene_scale, cfg.scene.white_background, dev)
    ys, xs = torch.meshgrid(torch.arange(ds.height, device=dev),
                            torch.arange(ds.width, device=dev), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).float()
    world = sampler.rays(sampler.poses[torch.zeros_like(xs.reshape(-1))], pix)
    near = ndc_near_or_none(cfg)
    card = ndc_warp(world, ds.width, ds.height, ds.camera, near)
    host = ndc_warp(Rays(*(t.cpu() for t in world)), ds.width, ds.height, ds.camera, near)
    warp_bad = [int((a.cpu() != b).sum()) for a, b in zip(card[:2], host[:2])]
    _, _, occ = load_jax_checkpoint(ckpt, dev)
    res, t_res = cfg.grid.resolution, cfg.sampler.tighten_res
    pooled = make_coarse_occupancy(occ.bitfield.reshape(res, res, res), res // t_res)
    o, d, te, tx = probe_rays(card.origins, card.directions, cfg.grid, cfg.sampler.near)
    n, probes = cfg.sampler.samples_per_ray, cfg.sampler.tighten_probes
    plain = tg.tighten_sample_mask_plain(o, d, te, tx, pooled, n, cfg.grid, probes)
    kernel = tg.tighten_sample_mask(o, d, te, tx, pooled, n, cfg.grid, probes)
    torch.cuda.synchronize()
    b4_bad = [int((a != b).sum()) for a, b in zip(kernel, plain)]
    print(f"off-centre capture (intrinsics {ds.intrinsics}): the training warp of train view 0 "
          f"({pix.shape[0]} rays) on the card against the CPU, origins / directions differ in "
          f"{warp_bad} elements; B4 on those rays (trained occupancy, {int(kernel[2].sum())} "
          f"occupied midpoints) against its plain version: {b4_bad}", flush=True)
    if any(warp_bad) or any(b4_bad):
        raise AssertionError(f"off-centre capture: warp {warp_bad}, B4 {b4_bad} elements differ")
    b4_on_view("off-centre COLMAP NDC 240x180 test view", CONFIG_COLMAP, ckpt, "test",
               OFFCENTRE_OVERRIDES)
    shutil.rmtree(ckpt)
    return launches


def remat_gradient_check(ckpt_dir):
    """(b) One fused train step's gradient from the weights and occupancy of
    ckpt_dir on one batch of 8192 prims rays, with and without remat: each
    leaf within B2_RTOL of its largest entry (B2 does not repeat bit for
    bit, ROADMAP Queue C 1), and B1 launched twice under remat (once more
    in the backward pass), once without."""
    import torch

    from tnerf_torch.config import Config
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.train import PixelSampler, rematerialized
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import read_train_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(CONFIG)
    sampler = PixelSampler(_prims_test_split(), cfg.scene.scene_scale,
                           cfg.scene.white_background, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    batch = sampler.sample(gen, cfg.train.batch_size)
    ck = read_train_checkpoint(ckpt_dir, dev)  # the live weights
    params, occ = ck.params, ck.occupancy
    names = sorted(params)
    for v in params.values():
        v.requires_grad_(True)
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    renderer = build_renderer(cfg, for_eval=False)

    def grads(r):
        res = r(params, batch.rays, payload, None)
        loss = torch.mean(torch.square(res.rgb - batch.gt_rgb))
        out = torch.autograd.grad(loss, [params[k] for k in names])
        torch.cuda.synchronize()
        return out

    plain, n_plain = counted(lambda: grads(renderer))
    remat, n_remat = counted(lambda: grads(rematerialized(renderer)))
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(remat, plain))
    print(f"one fused train step's gradient with and without remat: max |diff| / max |leaf| "
          f"{rel:.3e} over {len(names)} leaves (bound B2_RTOL {B2_RTOL}); B1 launches "
          f"{n_remat['fused_forward']} with remat, {n_plain['fused_forward']} without; B2 "
          f"{n_remat['fused_backward']} / {n_plain['fused_backward']}", flush=True)
    if rel > B2_RTOL:
        raise AssertionError(f"remat changed the gradient by {rel} (bound {B2_RTOL})")
    if (n_remat["fused_forward"], n_plain["fused_forward"]) != (2, 1) \
            or n_remat["fused_backward"] != 1:
        raise AssertionError(f"remat did not rerun B1 in the backward pass: {n_remat} / "
                             f"{n_plain}")


def sphere_rgba_dataset(n_views, split, seed):
    """tests/test_random_background.py's white sphere on white, RGBA with the
    analytic silhouette as alpha, built by the port's own code at
    RBG_SIZE^2."""
    import numpy as np

    from tnerf_torch.data.dataset import ImageDataset
    from tnerf_torch.data.procedural import sphere_poses

    poses = sphere_poses(n_views, radius=3.0, seed=seed).astype(np.float32)
    imgs = []
    for p in poses:
        rgba = np.ones((RBG_SIZE, RBG_SIZE, 4), np.float32)
        rgba[..., 3] = sphere_silhouette(p)
        imgs.append(rgba)
    return ImageDataset(images=np.stack(imgs), poses=poses, focal=RBG_FOCAL, width=RBG_SIZE,
                        height=RBG_SIZE, channels=4, split=split)


def sphere_silhouette(pose):
    """Analytic alpha of the centred sphere from one camera (float64)."""
    import numpy as np

    from tnerf_torch.cameras import camera_rays

    rays = camera_rays(pose, RBG_SIZE, RBG_SIZE, RBG_FOCAL, device="cpu")
    o = rays.origins.numpy().astype(np.float64)
    d = rays.directions.numpy().astype(np.float64)
    b = np.sum(d * o, axis=-1)
    disc = b * b - (np.sum(o * o, axis=-1) - RBG_RADIUS * RBG_RADIUS)
    return (disc > 0).astype(np.float32)


def random_background_sphere():
    """(c) train.random_background on the fused pipeline: the white sphere
    on white, whose composited images are all but uniform, so that only the
    alpha channel (composited over each ray's random colour) says where the
    sphere is; gates: test PSNR over RBG_PSNR_MIN, the opacity of test view
    0 over RBG_ACC_CORE_MIN inside the eroded silhouette and under
    RBG_ACC_BG_MAX outside it."""
    import shutil

    import numpy as np
    import torch
    from scipy import ndimage

    from tnerf_torch.config import Config
    from tnerf_torch.eval import render_pose_result
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.train_loop import build_renderer, run_training
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    out_dir = os.path.join(OUT, "options", "random_background")
    shutil.rmtree(out_dir, ignore_errors=True)
    datasets = {"train": sphere_rgba_dataset(RBG_TRAIN, "train", 0),
                "test": sphere_rgba_dataset(RBG_TEST, "test", 9)}
    cfg = Config().apply_overrides(RBG_OVERRIDES + [f"logging.out_dir={out_dir}"])
    t0 = time.perf_counter()
    final, launches = counted(lambda: run_training(cfg, datasets=datasets, device="cuda"))
    train_s = time.perf_counter() - t0
    _, params, occ = load_jax_checkpoint(os.path.join(out_dir, "checkpoints"), "cuda")
    ds = datasets["test"]
    res = render_pose_result(build_renderer(cfg), params, ds.poses[0], ds.width, ds.height,
                             ds.camera, cfg.scene.scene_scale, chunk_size=cfg.render.chunk_size,
                             occupancy=renderer_payload(occ, cfg.sampler, cfg.grid),
                             device=torch.device("cuda"))
    acc = np.asarray(res.acc, np.float32)
    sil = sphere_silhouette(ds.poses[0])
    core = ndimage.binary_erosion(sil > 0.5, iterations=2)
    bg = ndimage.binary_erosion(sil < 0.5, iterations=2)
    a_core, a_bg = float(acc[core].mean()), float(acc[bg].mean())
    print(f"random background, white sphere on white ({RBG_SIZE}x{RBG_SIZE}, {RBG_TRAIN} train "
          f"views, fused, {RBG_STEPS} steps, {train_s:.1f} s): psnr_test {final['psnr_test']:.4f} "
          f"dB (gate > {RBG_PSNR_MIN}), acc inside the eroded silhouette {a_core:.4f} (> "
          f"{RBG_ACC_CORE_MIN}), outside {a_bg:.4f} (< {RBG_ACC_BG_MAX}); launches {launches}",
          flush=True)
    if not (core.sum() > 10 and bg.sum() > 50):
        raise AssertionError(f"eroded regions too small: {core.sum()} / {bg.sum()} pixels")
    if final["psnr_test"] <= RBG_PSNR_MIN or a_core <= RBG_ACC_CORE_MIN \
            or a_bg >= RBG_ACC_BG_MAX:
        raise AssertionError("random background: the opacity does not follow the silhouette")
    if min(launches["fused_forward"], launches["fused_backward"]) < RBG_STEPS:
        raise AssertionError(f"random background did not train through B1 / B2: {launches}")
    shutil.rmtree(os.path.join(out_dir, "checkpoints"))
    return launches


def barf_unit_run():
    """(d) the BARF window and unit view directions on grid_march, through
    `cli train`: test PSNR within TRAIN_PSNR_MARGIN_DB of the reference's
    CPU run of the same config, and the mid-anneal checkpoint step_200
    holding the window's alpha of its last step, 199 / 400 in float32, as
    the reference's checkpoint holds it."""
    import numpy as np

    from tnerf_torch.utils.checkpoint import layout_of, leaf_names, load_jax_checkpoint

    cfg = load_config(CONFIG_BARF)
    launches, final, out_dir = train_from_scratch(
        CONFIG_BARF, os.path.join("options", "barf_unit"), cfg.train.steps, (),
        JAX_BARF_UNIT_PSNR_TEST)
    ckpt = os.path.join(out_dir, "checkpoints")
    _, params, _ = load_jax_checkpoint(ckpt, "cpu")
    i = leaf_names(layout_of(params)).index("freq_alpha")
    step = cfg.train.checkpoint_every
    with np.load(os.path.join(ckpt, f"step_{step:08d}.npz")) as data:
        alpha = data[f"leaf_{i}"]
    want = np.float32(step - 1) / np.float32(cfg.train.freq_anneal_steps)
    print(f"BARF window + unit view directions (grid_march, {cfg.train.steps} steps): "
          f"freq_alpha in step_{step} {alpha!r} (the window of step {step - 1}: {want!r}), at "
          f"the end {float(params['freq_alpha'])}; B4 launches {launches['tighten_sample_mask']}",
          flush=True)
    if alpha.dtype != np.float32 or alpha.shape != () or alpha != want \
            or float(params["freq_alpha"]) != 1.0:
        raise AssertionError(f"freq_alpha {alpha!r} / {params['freq_alpha']} is not the "
                             f"window's {want!r} / 1.0")
    return launches


def suite_run():
    """(e) `cli suite` over copies of runs/suite_rehearsal/{prims,rings,layers}
    (config and checkpoint; the committed suite_renders stay as they are)
    and a scene that does not exist: each scene within PSNR_TOL_DB of its
    record, the missing one skipped, the summary's mean printed."""
    import shutil

    root = os.path.join(OUT, "options", "suite")
    shutil.rmtree(root, ignore_errors=True)
    records = {}
    for scene in SUITE_SCENES:
        src = os.path.join(SUITE_RUNS, scene)
        os.makedirs(os.path.join(root, scene))
        shutil.copy(os.path.join(src, "config.json"), os.path.join(root, scene))
        shutil.copytree(os.path.join(src, "checkpoints"), os.path.join(root, scene, "checkpoints"))
        with open(os.path.join(src, "metrics.jsonl")) as fh:
            records[scene] = json.loads(fh.read().strip().splitlines()[-1])["psnr_test"]
    t0 = time.perf_counter()
    (text, err), launches = counted(lambda: run_cli(
        ["suite", "--config", os.path.join(root, "prims", "config.json"), "-o",
         f"logging.out_dir={root}", "--scenes", ",".join(SUITE_SCENES + ("missing",))],
        with_stderr=True))
    summary = json.loads(text)
    gaps = {sc: summary["scenes"][sc]["psnr_test"] - records[sc] for sc in SUITE_SCENES}
    print(f"cli suite ({time.perf_counter() - t0:.1f} s): "
          + ", ".join(f"{sc} {summary['scenes'][sc]['psnr_test']:.4f} dB (record "
                      f"{records[sc]:.4f}, {gaps[sc]:+.4f})" for sc in SUITE_SCENES)
          + f"; mean_psnr_test {summary['mean_psnr_test']:.4f}; launches {launches}", flush=True)
    if sorted(summary["scenes"]) != sorted(SUITE_SCENES) or "missing: SKIP" not in err:
        raise AssertionError(f"cli suite evaluated {sorted(summary['scenes'])}: {err[-400:]}")
    if max(abs(g) for g in gaps.values()) > PSNR_TOL_DB:
        raise AssertionError(f"cli suite: a scene is not within {PSNR_TOL_DB} dB of its record: "
                             f"{gaps}")
    for scene in SUITE_SCENES:
        shutil.rmtree(os.path.join(root, scene, "checkpoints"))
    return launches


def orbit_gif():
    """(f) `cli render --orbit ORBIT_FRAMES --gif` of the prims model: the
    GIF's blocks hold ORBIT_FRAMES frames of the view's size."""
    from tnerf_torch.data.gif_io import gif_frames

    out = os.path.join(OUT, "options", "orbit_gif")
    text, launches = counted(lambda: run_cli(
        ["render", "--config", CONFIG, "--checkpoint", CKPT, "--orbit", str(ORBIT_FRAMES),
         "--gif", "--out", out]))
    got = gif_frames(os.path.join(out, "orbit.gif"))
    frames = json.loads(text.strip().splitlines()[-1])
    print(f"render --orbit {ORBIT_FRAMES} --gif: {got[0]} frames {got[1]}x{got[2]} in "
          f"orbit.gif ({os.path.getsize(os.path.join(out, 'orbit.gif'))} bytes), "
          f"{frames['ms_per_frame']:.2f} ms/frame", flush=True)
    if got != (ORBIT_FRAMES, frames["width"], frames["height"]):
        raise AssertionError(f"orbit.gif holds {got}")
    return launches


def profile_and_debug_nans():
    """(g) PROFILE_STEPS prims steps with logging.profile (a torch.profiler
    trace holding the card's kernels), then the same steps with
    logging.debug_nans, which must raise nothing."""
    import shutil

    from tnerf_torch.utils.metrics import TRACE_FILE

    total = {k: 0 for k in kernel_counters()}
    # 50 steps are no trained model: the config's acceptance gate is for
    # its full 1500
    base = ["train", "--config", CONFIG, "-o", f"train.steps={PROFILE_STEPS}",
            "-o", "train.checkpoint_every=0", "-o", "train.log_every=10",
            "-o", "train.assert_test_psnr_min=0"]
    for tag, flag in (("profile", "logging.profile=true"),
                      ("debug_nans", "logging.debug_nans=true")):
        out_dir = os.path.join(OUT, "options", tag)
        shutil.rmtree(out_dir, ignore_errors=True)
        t0 = time.perf_counter()
        _, launches = counted(lambda: run_cli(base + ["--out", out_dir, "-o", flag]))
        for k, n in launches.items():
            total[k] += n
        last, _, _ = last_window(os.path.join(out_dir, "metrics.jsonl"))
        seconds = time.perf_counter() - t0
        if tag == "profile":
            trace = os.path.join(out_dir, "profile", TRACE_FILE)
            size = os.path.getsize(trace)
            with open(trace) as fh:
                events = json.load(fh)["traceEvents"]
            kernels = sum(1 for e in events if e.get("cat") == "kernel")
            print(f"logging.profile: {PROFILE_STEPS} steps in {seconds:.1f} s, last window "
                  f"{last['step_seconds'] * 1e3:.3f} ms/step; {TRACE_FILE} {size} bytes, "
                  f"{len(events)} events, {kernels} kernel launches on the card", flush=True)
            if kernels < launches["fused_backward"]:
                raise AssertionError(f"the trace holds {kernels} kernels of the card")
            shutil.rmtree(os.path.join(out_dir, "profile"))
        else:
            print(f"logging.debug_nans: {PROFILE_STEPS} steps in {seconds:.1f} s, nothing "
                  f"raised, last window {last['step_seconds'] * 1e3:.3f} ms/step", flush=True)
    return total


def train_with_options(accum_extra, ema_extra, reference):
    """Phase `options`: (a) grad accumulation, (b) the weight EMA with
    keep_best and remat, (c) random background, (d) the BARF window with
    unit view directions, (e) `cli suite`, (f) `render --orbit --gif`, (g)
    logging.profile and logging.debug_nans.  (a) and (b) train under the
    schedule of their whole runs with the extra overrides given, held to
    `reference` or, where it is None, their loss falling (OPTION_RUNS: the
    default phase cuts them short, `options_full` runs them whole)."""
    import shutil

    from tnerf_torch.utils.checkpoint import latest_checkpoint, read_train_checkpoint

    launches = {k: 0 for k in kernel_counters()}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    per_step = ("tighten_range", "fused_forward", "fused_backward")

    def run(tag, overrides, extra):
        """A run under the schedule of its whole length, gated."""
        whole = load_config(CONFIG, overrides).train.steps
        overrides = overrides + [f"train.schedule_total_steps={whole}"] + list(extra)
        cfg = load_config(CONFIG, overrides)
        n, final, out_dir = train_from_scratch(CONFIG, os.path.join("options", tag),
                                               cfg.train.steps, per_step, reference, overrides)
        add(n)
        if reference is None:
            loss_falls(f"options/{tag}", out_dir)
        else:
            check_trained(f"options/{tag}", cfg, final)
        return cfg, n, final, out_dir

    # (a) grad accumulation
    cfg, _, _, out_dir = run("accum", ACCUM_OVERRIDES, accum_extra)
    ck = read_train_checkpoint(os.path.join(out_dir, "checkpoints"), "cpu")
    updates = (int(ck.opt_state["count"]), int(ck.opt_state["gradient_step"]),
               int(ck.opt_state["mini_step"]))
    print(f"grad accumulation: {cfg.train.steps} loop steps of {cfg.train.batch_size} rays -> "
          f"Adam count, gradient_step, mini_step {updates}", flush=True)
    want = cfg.train.steps // cfg.train.grad_accum_steps
    whole = cfg.train.schedule_total_steps // cfg.train.grad_accum_steps
    if updates != (want, want, 0) or whole != load_config(CONFIG).train.steps:
        raise AssertionError(f"accumulation emitted {updates}, not {want} updates, or its "
                             f"whole run's {whole} are not the prims config's")
    shutil.rmtree(os.path.join(out_dir, "checkpoints"))

    # (b) weight EMA, keep_best, remat
    cfg, n, final, out_dir = run("ema", EMA_OVERRIDES, ema_extra)
    if n["fused_forward"] < 2 * cfg.train.steps:
        raise AssertionError(f"remat did not rerun B1 in each backward pass: {n}")
    recs = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    best = [r for r in recs if "best_psnr" in r][-1]
    bdir = os.path.join(out_dir, "checkpoints_best")
    bstep, _ = latest_checkpoint(bdir)
    m, n, _ = eval_cli(os.path.join(out_dir, "config.json"), bdir, "options_ema_best",
                       ["render.ray_compact=false"])
    add(n)
    print(f"EMA 0.99 + keep_best + remat: EMA eval psnr_test {final['psnr_test']:.4f} dB "
          f"(record {JAX_PSNR_TEST:.4f}); best_psnr {best['best_psnr']:.6f} dB at step "
          f"{best['best_step']}, checkpoints_best's newest step {bstep}, its cli eval psnr_val "
          f"{m['psnr_val']:.6f} ({m['psnr_val'] - best['best_psnr']:+.2e} dB)", flush=True)
    if bstep != best["best_step"] or abs(m["psnr_val"] - best["best_psnr"]) > BEST_PSNR_TOL_DB:
        raise AssertionError(f"checkpoints_best (step {bstep}, cli eval {m['psnr_val']}) is not "
                             f"the recorded best {best}")
    remat_gradient_check(os.path.join(out_dir, "checkpoints"))
    shutil.rmtree(os.path.join(out_dir, "checkpoints"))
    shutil.rmtree(bdir)

    add(random_background_sphere())  # (c)
    add(barf_unit_run())  # (d)
    add(suite_run())  # (e)
    add(orbit_gif())  # (f)
    add(profile_and_debug_nans())  # (g)
    return launches


def _mesh_tools():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import mesh_stats
    finally:
        sys.path.pop(0)
    return mesh_stats


def density_slab_max_diff():
    """One slab (the first 131,072 points) of `cli mesh`'s density grid
    through the prims field on the card and through the plain version on the
    CPU: (max |diff|, largest |density| on the CPU)."""
    import numpy as np
    import torch

    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    cfg = load_config(CONFIG)
    n = MESH_RESOLUTION + 1
    lo, hi = np.asarray(cfg.grid.aabb_min, np.float32), np.asarray(cfg.grid.aabb_max, np.float32)
    axes = [np.linspace(lo[a], hi[a], n, dtype=np.float32) for a in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)[:1 << 17]
    out = {}
    for dev in ("cuda", "cpu"):
        _, params, _ = load_jax_checkpoint(CKPT, device=dev)
        field = NeRFField(cfg.field_, cfg.grid, torch.Generator()).to(dev)
        with torch.no_grad():
            out[dev] = field.density(torch.from_numpy(pts).to(dev), params).float().cpu().numpy()
    return float(np.abs(out["cuda"] - out["cpu"]).max()), float(np.abs(out["cpu"]).max())


JOBS = {}  # name -> (process, result file, start time): entry points run beside a phase


def start_job(name, argv, stats_of=None):
    """`tnerf_torch.cli argv` in a process of its own (`run_job`), started
    where a phase leaves the host idle (the device-bound intervals training)
    or beside another training, and read by `job_result`: the mesh's and the
    bake's time is mostly numpy and zlib on the host.  stats_of: an OBJ the
    process summarises after (tools/mesh_stats.py)."""
    os.makedirs(OUT, exist_ok=True)
    result = os.path.join(OUT, f"job_{name}.json")
    code = (f"import chip_smoke; chip_smoke.run_job({result!r}, {list(argv)!r}, "
            f"{stats_of!r})")
    env = dict(os.environ, PYTHONPATH=REPO)
    JOBS[name] = (subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env), result,
                  time.perf_counter())


def run_job(result, argv, stats_of=None):
    """The body of a job's process: the entry point with its kernels'
    launches counted, its output, and the summary of `stats_of`, written to
    `result` as JSON."""
    sys.path.insert(0, REPO)
    (text, err), launches = counted(lambda: run_cli(argv, with_stderr=True))
    out = {"text": text, "err": err, "launches": launches}
    if stats_of:
        mesh_stats = _mesh_tools()
        out["stats"] = mesh_stats.mesh_stats(*mesh_stats.read_obj(stats_of))
    with open(result, "w") as fh:
        json.dump(out, fh)


def job_result(name):
    """Wait for the job `name`: (its JSON result, seconds since its start);
    a job that failed fails the phase."""
    proc, result, t0 = JOBS.pop(name)
    if proc.wait() != 0:
        raise RuntimeError(f"the job {name} exited {proc.returncode}")
    with open(result) as fh:
        out = json.load(fh)
    os.remove(result)
    return out, time.perf_counter() - t0


def mesh_argv(obj):
    return ["mesh", "--config", CONFIG, "--checkpoint", CKPT, "--out", obj,
            "--resolution", str(MESH_RESOLUTION), "--vertex-colors"]


def geometry():
    """Phase `geometry`: (a) `cli mesh --resolution 128 --vertex-colors` of
    the prims checkpoint on the card (the job `mesh`, started before the
    intervals phase where that runs), held to the reference's record; one
    slab of its density grid against the plain version on the CPU; (b) `cli
    mesh --resolution 64 --threshold MESH_BOUND_LEVEL`, then `cli train` of
    the prims config bounded by that mesh, all 1500 steps: B1, B2 and B3
    once a step, the bitfield inside the mask at step 750 and at the end,
    the PSNR not under the reference's unbounded record by more than the
    margin, over the config's gate."""
    import numpy as np

    import tnerf_torch.grid.mesh as mesh_mod
    from tnerf_torch.config import Config

    obj, bound = geometry_paths()
    try:
        if "mesh" not in JOBS:
            start_job("mesh", mesh_argv(obj), stats_of=obj)
        job, mesh_s = job_result("mesh")
        text, meshed, stats = job["text"], job["launches"], job["stats"]
        bound_text = run_cli(["mesh", "--config", CONFIG, "--checkpoint", CKPT, "--out", bound,
                              "--resolution", str(MESH_BOUND_RESOLUTION),
                              "--threshold", str(MESH_BOUND_LEVEL)])
        check_mesh_record(stats, text, meshed, mesh_s)
        print(f"the bound: {bound_text.strip()} (--resolution {MESH_BOUND_RESOLUTION} "
              f"--threshold {MESH_BOUND_LEVEL})", flush=True)
        diff, top = density_slab_max_diff()
        print(f"cli mesh's density grid, one slab of 131072 points: max |card - CPU| {diff:.3e}, "
              f"largest density {top:.3f} (bound {MESH_DENSITY_RTOL} of it)", flush=True)
        if diff > MESH_DENSITY_RTOL * top:
            raise AssertionError(f"the density grid on the card is not the plain version's: "
                                 f"max |diff| {diff}")

        # (b) the mesh as the scene's bound; the run's own mask is kept
        masks = []
        real = mesh_mod.mesh_occupancy_mask

        def keep_mask(grid):
            masks.append(real(grid))
            return masks[-1]

        overrides = [f"grid.mesh_path={bound}", "grid.mesh_solid=true", "grid.mesh_dilate=1",
                     "train.checkpoint_every=750"]
        cfg = Config.from_json_file(CONFIG).apply_overrides(overrides)
        mesh_mod.mesh_occupancy_mask = keep_mask
        try:
            launches, final, run_dir = train_from_scratch(
                CONFIG, "train_mesh_bounded", cfg.train.steps,
                ("tighten_range", "fused_forward", "fused_backward"), JAX_PSNR_TEST, overrides,
                at_least=True)
        finally:
            mesh_mod.mesh_occupancy_mask = real
        check_trained("train_mesh_bounded", cfg, final)
        (mask,) = masks
        share = {}
        for step in (750, cfg.train.steps):
            with np.load(os.path.join(run_dir, "checkpoints", f"step_{step:08d}.npz")) as z:
                bits = [z[k] for k in z.files if z[k].dtype == bool and z[k].shape == mask.shape]
            outside = [int((b & ~mask).sum()) for b in bits]
            if outside != [0]:
                raise AssertionError(f"the bitfield at step {step} leaves the mesh's mask: "
                                     f"{outside} cells outside")
            share[step] = float(bits[0].mean())
        print(f"mesh-bounded prims training: the mask holds {mask.mean():.4f} of the "
              f"{mask.shape[0]}^3 cells; occupied share at steps 750 / {cfg.train.steps} "
              f"{share[750]:.4f} / {share[cfg.train.steps]:.4f}, none outside the mask; "
              f"psnr_test {final['psnr_test']:.4f} dB (the unbounded record "
              f"{JAX_PSNR_TEST:.4f})", flush=True)
    finally:  # chiprun_out/ must stay small: the 128^3 mesh is 60 MB
        for path in (obj, bound, os.path.join(OUT, "train_mesh_bounded", "checkpoints")):
            shutil_rm(path) if os.path.isdir(path) else (os.path.exists(path) and os.remove(path))
    return {k: meshed[k] + launches[k] for k in launches}


def geometry_paths():
    """(the 128^3 mesh, the bound's mesh) under chiprun_out/."""
    out_dir = os.path.join(OUT, "geometry")
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, "prims.obj"), os.path.join(out_dir, "prims_bound.obj")


def check_mesh_record(stats, text, meshed, mesh_s):
    """The 128^3 mesh held to the reference's record."""
    import numpy as np

    with open(os.path.join(OUT, "geometry", "mesh_stats.json"), "w") as fh:
        json.dump(stats, fh, indent=1)
    with open(MESH_RECORD) as fh:
        rec = json.load(fh)
    cell = 2.0 / MESH_RESOLUTION
    bbox = max(float(np.abs(np.subtract(stats[k], rec[k])).max()) for k in ("bbox_min", "bbox_max"))
    rel = {k: stats[k] / rec[k] - 1.0 for k in ("n_vertices", "n_faces", "boundary_edges")}
    print(f"cli mesh --resolution {MESH_RESOLUTION} --vertex-colors (done {mesh_s:.1f} s after "
          f"its start, launches {({k: n for k, n in meshed.items() if n})}): {text.strip()}; "
          f"against the "
          f"reference's: vertices {stats['n_vertices']} / {rec['n_vertices']}, faces "
          f"{stats['n_faces']} / {rec['n_faces']}, boundary edges {stats['boundary_edges']} / "
          f"{rec['boundary_edges']}, surface area {stats['surface_area']:.4f} / "
          f"{rec['surface_area']:.4f}, bounding box within {bbox:.2e}, mean vertex colour "
          f"{np.round(stats['mean_vertex_color'], 4).tolist()} / "
          f"{np.round(rec['mean_vertex_color'], 4).tolist()}", flush=True)
    if max(abs(rel["n_vertices"]), abs(rel["n_faces"])) > MESH_COUNT_RTOL or bbox > cell \
            or abs(rel["boundary_edges"]) > MESH_BOUNDARY_RTOL:
        raise AssertionError(f"the port's mesh is not the reference's: {stats} against {rec}")


def shutil_rm(path):
    import shutil

    shutil.rmtree(path, ignore_errors=True)


def bake_argv(config, ckpt, name, bake_res):
    return ["bake", "--config", config, "--checkpoint", ckpt, "--bake-res", str(bake_res),
            "--mode", "trilinear_brick", "--eval", "-o",
            f"logging.out_dir={os.path.join(OUT, name)}"]


def bake_cli(name, bake_res, argv):
    """The job `name`, `cli bake --bake-res R --eval` (started by `start_job`
    with bake_argv): (its baked_parity.json, launch counts, seconds since
    its start, the npz's path)."""
    out_dir = os.path.join(OUT, name)
    if name not in JOBS:
        start_job(name, argv)
    job, seconds = job_result(name)
    err, launches = job["err"], job["launches"]
    with open(os.path.join(out_dir, "baked_parity.json")) as fh:
        art = json.load(fh)
    npz = os.path.join(out_dir, "baked", f"baked_{bake_res}.npz")
    timing = [ln for ln in err.splitlines() if ln.startswith(("baked ", "render_ms_test"))]
    print(f"{name}: cli bake --bake-res {bake_res} --eval (done {seconds:.1f} s after its start; "
          f"{'; '.join(timing)}; "
          f"npz {os.path.getsize(npz)} bytes): baked {art['baked']['psnr_test']:.4f} dB, march "
          f"{art['march']['psnr_test']:.4f}, parity {art['parity_db']:.4f}, bake "
          f"{art['bake_seconds']} s; launches { {k: n for k, n in launches.items() if n} }",
          flush=True)
    return art, launches, seconds, npz


def bake_prims():
    """Phase `bake`: `cli bake --bake-res 256 --eval` of the prims checkpoint
    held to the reference's record; test view 0 through the bake in each
    lookup mode."""
    import numpy as np
    import torch

    from tnerf_torch.eval import psnr, render_dataset_view
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.render.baked import MODES, make_baked_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    art, launches, _, npz = bake_cli("bake", BAKE_RES, bake_argv(CONFIG, CKPT, "bake", BAKE_RES))
    with open(BAKE_RECORD) as fh:
        rec = json.load(fh)
    for k in ("baked", "march"):
        if abs(art[k]["psnr_test"] - rec[k]["psnr_test"]) > BAKE_PSNR_TOL_DB:
            raise AssertionError(f"the {k} render of the bake's eval, {art[k]['psnr_test']} dB, "
                                 f"is not within {BAKE_PSNR_TOL_DB} dB of the reference's "
                                 f"{rec[k]['psnr_test']}")
    print(f"bake of prims against the reference's CPU run: baked {art['baked']['psnr_test']:.4f}"
          f" / {rec['baked']['psnr_test']:.4f} dB, march {art['march']['psnr_test']:.4f} / "
          f"{rec['march']['psnr_test']:.4f}", flush=True)
    cfg = load_config(CONFIG)
    with np.load(npz) as z:
        table = torch.from_numpy(z["table"].astype(np.float32)).cuda()
    os.remove(npz)  # chiprun_out/ must stay small
    _, _, occ = load_jax_checkpoint(CKPT)
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    ds = _prims_test_split()
    gt = ds.composited(cfg.scene.white_background)[0]
    views = {}
    for mode in MODES:
        rend = make_baked_renderer(table, BAKE_RES, cfg.grid, cfg.sampler, cfg.render, mode=mode)
        views[mode] = render_dataset_view(rend, rend.params, ds, 0, cfg.scene.scene_scale,
                                          cfg.render.chunk_size, occupancy=payload)
    diff = float(np.abs(views["trilinear"] - views["trilinear_brick"]).max())
    print(f"test view 0 through the bake: psnr {', '.join(f'{m} {psnr(v, gt):.4f}' for m, v in views.items())}"
          f" dB; trilinear against trilinear_brick max |diff| {diff:.3e} (bound "
          f"{BAKE_MODE_ATOL:.3e})", flush=True)
    if diff > BAKE_MODE_ATOL:
        raise AssertionError(f"trilinear and trilinear_brick lookups disagree by {diff}")
    return launches


def bake_hash_grid():
    """Inside `fields`: the hash grid's checkpoint baked at 320^3 with --eval
    (the job `bake_hash`, started after the hash grid's run, beside the CP
    and triplane runs), its baked render within HASH_BAKE_PARITY_DB of its
    own march render, B4 launched by both evals."""
    art, launches, _, npz = bake_cli("bake_hash", HASH_BAKE_RES, None)
    os.remove(npz)  # chiprun_out/ must stay small
    with open(HASH_BAKE_RECORD) as fh:
        rec = json.load(fh)
    gap = art["baked"]["psnr_test"] - art["march"]["psnr_test"]
    rec_gap = rec["baked"]["psnr_test"] - rec["march"]["psnr_test"]
    print(f"hash grid baked at {HASH_BAKE_RES}^3: baked {art['baked']['psnr_test']:.4f} dB, its "
          f"march {art['march']['psnr_test']:.4f} ({gap:+.4f}); the reference's record "
          f"{rec['baked']['psnr_test']:.4f} / {rec['march']['psnr_test']:.4f} "
          f"({rec_gap:+.4f}), from another checkpoint", flush=True)
    if abs(gap) > HASH_BAKE_PARITY_DB:
        raise AssertionError(f"the hash grid's bake is {gap:+.4f} dB from its march render "
                             f"(bound {HASH_BAKE_PARITY_DB})")
    if launches["tighten_sample_mask"] < 1:
        raise AssertionError(f"the hash grid's bake eval did not launch B4: {launches}")
    return launches


def train_cdf_full():
    """Phase `cdf_full` (not in the default run):
    configs/procedural_hard_fused_cdf2.json trained for all its 5000 steps
    through `cli train`, held to the reference's record JAX_CDF_PSNR_TEST and
    the config's own gate."""
    cfg = load_config(CONFIG_CDF)
    launches, final, _ = train_from_scratch(
        CONFIG_CDF, "train_cdf_full", cfg.train.steps,
        ("tighten_sample_mask", "fused_forward_tmode", "fused_backward_tmode"),
        JAX_CDF_PSNR_TEST)
    check_trained("train_cdf_full", cfg, final)
    return launches


def train_march_full():
    """Phase `march_full` (not in the default run): configs/procedural_hard_30db.json
    trained for all its 5000 steps through `cli train`, held to the
    reference's record JAX_MARCH_PSNR_TEST and the config's own gate."""
    cfg = load_config(CONFIG_MARCH)
    launches, final, _ = train_from_scratch(CONFIG_MARCH, "train_march_full", cfg.train.steps, (),
                                            JAX_MARCH_PSNR_TEST)
    check_trained("train_march_full", cfg, final)
    return launches


# Phase `parallel`: two ranks share the one card under gloo (NCCL refuses two
# ranks on one device), each check against one rank on the same inputs.
PARALLEL_RANKS = 2
PARALLEL_JOIN_S = 300
PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_RENDER_ATOL = 1e-5        # the DP render of prims test view 0
SP_RENDER_ATOL = 5e-5              # the intervals config's render at SP = 2
# unfused gradients, per leaf, of its largest entry: the TP step runs the
# one-rank step's products on the same rows (features gathered whole); the
# SP step's run on half the samples a ray, products of another shape whose
# f32 sums round in another order and flip single bf16 roundings of the
# activations (the configs compute in bfloat16), hence B2_RTOL there
GRAD_RTOL = 1e-4
NCCL_TRAIN_STEPS = 50
NCCL_STEP_REPS = 20


def _rank_sum(results, key):
    out = {k: 0 for k in kernel_counters()}
    for r in results:
        for k, n in r[key].items():
            out[k] += n
    return out


def _max_rel(got, want):
    """max over leaves of max |got - want| / max |want| (the leaves' names)."""
    worst = 0.0
    for k, w in want.items():
        scale = float(w.abs().max()) or 1.0
        worst = max(worst, float((got[k] - w).abs().max()) / scale)
    return worst


def _mu(state):
    return {k: v.detach().clone() for k, v in state.optimizer.state["mu"].items()}


def parallel_rank(rank, world, store, out, overrides=(), device="cuda"):
    """The body of one rank of phase `parallel` (torch.multiprocessing.spawn):
    the process group on a file store, this rank on cuda:0 under gloo.  Rank
    0 computes every one-rank reference (no collective) and holds the
    parallel results to it; every rank counts its kernels' launches in the
    parallel runs alone and writes them to out/parallel_rank<r>.json.
    (overrides, device="cpu": a rehearsal on the CPU at a small size.)"""
    sys.path.insert(0, REPO)
    import dataclasses

    import torch
    import torch.distributed as dist

    from tnerf_torch.config import Config
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.grid.occupancy import init_occupancy, renderer_payload, update_occupancy
    from tnerf_torch.parallel import comm
    from tnerf_torch.parallel.mesh import dp_render_sharded, make_dp_train_step, make_mesh
    from tnerf_torch.parallel.occupancy import sharded_density
    from tnerf_torch.parallel.sample_parallel import make_sp_interval_renderer
    from tnerf_torch.parallel.table_parallel import shard_field
    from tnerf_torch.render.renderer import render_image
    from tnerf_torch.cameras import Rays, camera_rays
    from tnerf_torch.train import PixelSampler, RayBatch, init_train_state, make_train_step
    from tnerf_torch.train_loop import build_renderer, load_datasets
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = comm.init_group(device, init_method=f"file://{store}", rank=rank, world_size=world,
                          local_world_size=world)
    main = rank == 0
    report = {"backend": dist.get_backend(), "device": str(dev), "launches": {},
              "checks": {}}
    totals = {k: 0 for k in kernel_counters()}

    def run_counted(name, fn):
        """fn() with the launch counts set to 0 before and read after, on
        every rank at once (the barrier keeps a rank's reference work out)."""
        comm.barrier(dev)
        result, launches = counted(fn)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        report["launches"][name] = launches
        for k, n in launches.items():
            totals[k] += n
        return result

    def check(name, value, bound):
        report["checks"][name] = [value, bound]
        if main and not value <= bound:
            raise AssertionError(f"parallel {name}: {value} > {bound}")

    def load(path):
        return Config.from_json_file(path).apply_overrides(list(overrides))

    def state_of(cfg, params=None, seed=0):
        field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(seed)).to(dev)
        if params is not None:
            field.load_state_dict(params)
        return init_train_state(field, cfg.train)

    cfg = load(CONFIG)
    _, params, occ = load_jax_checkpoint(CKPT, device=dev)
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    data = load_datasets(cfg, splits=("train", "test"), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    batch = PixelSampler(data["train"], cfg.scene.scene_scale, cfg.scene.white_background,
                         dev).sample(gen, cfg.train.batch_size)
    mesh = make_mesh(world, device=dev)

    # (a) one fused DP step of the prims model: B3, B1, B2 on each rank's half
    rend = build_renderer(cfg, for_eval=False)
    if main:
        one = one_dp = state_of(cfg, params)
        aux1 = make_train_step(rend)(one, batch, payload)
    dp = state_of(cfg, params)
    step = make_dp_train_step(rend, mesh)
    aux2 = run_counted("dp_step", lambda: step(dp, batch, payload))
    if main:
        l1, l2 = float(aux1["loss"]), float(aux2["loss"])
        check("dp_step_loss_rel", abs(l2 - l1) / abs(l1), PARALLEL_LOSS_RTOL)
        check("dp_step_grad_rel", _max_rel(_mu(dp), _mu(one)), B2_RTOL)
        # the gap per leaf (ROADMAP Queue C 10; its kernel-level trace is
        # `trace_dp_split` in phase `kernels`)
        mu_dp, mu_one = _mu(dp), _mu(one)
        report["dp_step_grad_rel_per_leaf"] = {k: _max_rel({k: mu_dp[k]}, {k: w})
                                               for k, w in mu_one.items()}
        print("parallel: the DP step's gradient against one rank's, per leaf (max |diff| / max "
              "|one rank's|): " + json.dumps(report["dp_step_grad_rel_per_leaf"]), flush=True)
        # one-rank steps on each half of the batch, their moments averaged
        # as GradSync averages the gradients: against the DP step (the
        # reduce's own rounding) and against one rank's step on the whole
        n = cfg.train.batch_size
        halves = []
        for lo, hi in ((0, n // 2), (n // 2, n)):
            half = state_of(cfg, params)
            make_train_step(rend)(half, RayBatch(Rays(*(a[lo:hi] for a in batch.rays)),
                                                 batch.gt_rgb[lo:hi]), payload)
            halves.append(_mu(half))
        mu_halves = {k: (halves[0][k] + halves[1][k]) / 2 for k in mu_one}
        report["dp_step_halves"] = {"dp_vs_halves": _max_rel(mu_dp, mu_halves),
                                    "halves_vs_one_rank": _max_rel(mu_halves, mu_one)}
        print("parallel: one-rank steps on the two halves, averaged: "
              + json.dumps(report["dp_step_halves"]), flush=True)

    # (b) test view 0 at 400 x 400 through dp_render_sharded (B4, B1)
    ds = data["test"]
    rays = camera_rays(torch.as_tensor(ds.poses[0], device=dev), ds.width, ds.height, ds.camera,
                       cfg.scene.scene_scale, device=dev)
    erend = build_renderer(cfg, for_eval=True)
    if main:
        want = render_image(erend, params, rays, cfg.render.chunk_size, payload).rgb
    got = run_counted("dp_render", lambda: render_image(erend, params, rays,
                                                        cfg.render.chunk_size, payload,
                                                        mesh=mesh).rgb)
    if main:
        check("dp_render_max_abs", float((got - want).abs().max()), PARALLEL_RENDER_ATOL)

    # (c) the intervals config at SP = 2 (S = 48 x 16 = 768): one step and a
    # render of its batch's rays, B5 on each rank
    icfg = load(CONFIG_INTERVALS)
    sp_mesh = make_mesh(1, "data", "sample", world, device=dev)
    n = icfg.train.batch_size
    ibatch = RayBatch(Rays(*(a[:n] for a in batch.rays)), batch.gt_rgb[:n])
    ipay = renderer_payload(init_occupancy(icfg.grid, dev), icfg.sampler, icfg.grid)
    irend = build_renderer(icfg, for_eval=False)
    sprend = make_sp_interval_renderer(icfg.field_, icfg.grid, icfg.sampler, icfg.render, sp_mesh)
    if main:
        one = state_of(icfg, seed=icfg.train.seed)
        with torch.no_grad():
            want = irend(one.params, ibatch.rays, ipay).rgb
        aux1 = make_train_step(irend)(one, ibatch, ipay)
    sp = state_of(icfg, seed=icfg.train.seed)
    step = make_dp_train_step(sprend, sp_mesh)

    def sp_run():
        with torch.no_grad():
            rgb = dp_render_sharded(sprend, sp_mesh)(sp.params, ibatch.rays, ipay).rgb
        return step(sp, ibatch, ipay), rgb

    aux2, got = run_counted("sp_step", sp_run)
    if main:
        l1, l2 = float(aux1["loss"]), float(aux2["loss"])
        check("sp_step_loss_rel", abs(l2 - l1) / abs(l1), PARALLEL_LOSS_RTOL)
        check("sp_step_grad_rel", _max_rel(_mu(sp), _mu(one)), B2_RTOL)
        check("sp_render_max_abs", float((got - want).abs().max()), SP_RENDER_ATOL)

    # (d) the hash grid (L = 12) at TP = 2: one step, the segment sum on each rank
    hcfg = load(CONFIG_HASH)
    tp_mesh = make_mesh(1, "data", "model", world, device=dev)
    hpay = renderer_payload(init_occupancy(hcfg.grid, dev), hcfg.sampler, hcfg.grid)
    hgen = lambda: torch.Generator(device=dev).manual_seed(1)  # noqa: E731
    if main:
        one = state_of(hcfg, seed=hcfg.train.seed)
        aux1 = make_train_step(build_renderer(hcfg, for_eval=False, compact=False))(
            one, batch, hpay, hgen())
    tp = state_of(hcfg, seed=hcfg.train.seed)
    shard = shard_field(tp.field, tp_mesh)
    tp = init_train_state(tp.field, hcfg.train)
    trend = build_renderer(dataclasses.replace(hcfg, field_=tp.field.config), for_eval=False,
                           compact=False)
    step = make_dp_train_step(trend, tp_mesh)
    aux2 = run_counted("tp_step", lambda: step(tp, batch, hpay, hgen()))
    from tnerf_torch.parallel.table_parallel import full_tree

    mu2 = full_tree(_mu(tp), shard)
    if main:
        l1, l2 = float(aux1["loss"]), float(aux2["loss"])
        check("tp_step_loss_rel", abs(l2 - l1) / abs(l1), PARALLEL_LOSS_RTOL)
        check("tp_step_grad_rel", _max_rel(mu2, _mu(one)), GRAD_RTOL)

    # (e) the sharded occupancy refresh of the prims model on its grid (64^3)
    field = state_of(cfg, params).field
    density = lambda x: field.density(x)  # noqa: E731
    jit = torch.rand((cfg.grid.resolution,) * 3 + (3,), generator=gen, device=dev) - 0.5
    got = run_counted("occupancy", lambda: update_occupancy(occ, sharded_density(density, mesh),
                                                            cfg.grid, jitter=jit))
    if main:
        want = update_occupancy(occ, density, cfg.grid, jitter=jit)
        check("occupancy_bits_differing", int((got.bitfield != want.bitfield).sum()), 0)
        report["occupancy_ema_max_abs"] = float((got.density_ema - want.density_ema).abs().max())
    report["totals"] = totals

    # the collectives' cost on this card: the DP step's gradient all_reduce
    # (the prims model's flat gradient, float32) and the whole DP step
    def host_ms(fn, reps, together=True):
        fn()
        if together:
            comm.barrier(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    flat = torch.cat([p.detach().reshape(-1) for p in dp.params.values()])
    report["allreduce_bytes"] = flat.numel() * flat.element_size()
    report["allreduce_ms"] = host_ms(lambda: comm.all_reduce_(flat, mesh.replica), 20)
    step = make_dp_train_step(rend, mesh)
    report["dp_step_ms"] = host_ms(lambda: step(dp, batch, payload), 10)
    comm.barrier(dev)
    if main:  # one rank alone on the card, the other waiting
        report["one_rank_step_ms"] = host_ms(lambda: make_train_step(rend)(one_dp, batch,
                                                                          payload), 10, False)
    comm.barrier(dev)
    with open(os.path.join(out, f"parallel_rank{rank}.json"), "w") as fh:
        json.dump(report, fh)
    dist.destroy_process_group()


def spawn_ranks(fn, world, *args):
    """fn(rank, world, store, *args) on `world` processes
    (torch.multiprocessing.spawn), each waited for at most PARALLEL_JOIN_S
    seconds; a rank's exception fails the caller."""
    import torch.multiprocessing as mp

    store = os.path.join(OUT, "parallel_store")
    if os.path.exists(store):
        os.remove(store)
    ctx = mp.spawn(fn, args=(world, store) + args, nprocs=world, join=False)
    deadline = time.perf_counter() + PARALLEL_JOIN_S
    while not ctx.join(timeout=max(1.0, deadline - time.perf_counter())):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish in {PARALLEL_JOIN_S} s")


def launcher_argv(nproc, argv):
    """`python -m torch.distributed.run --standalone --nproc-per-node nproc`
    of `argv` (a rendezvous on localhost)."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={nproc}"] + list(argv)


def run_launched(nproc, argv, timeout):
    """The launcher's run of argv from the checkout: (stdout, stderr); a
    non-zero exit fails the phase."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(launcher_argv(nproc, argv), cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(launcher_argv(nproc, argv))} exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    return proc.stdout, proc.stderr


def nccl_step_job(result_path, marker, argv):
    """The body of the launched one-rank run of phase `parallel`
    (`chip_smoke.py --nccl-job PATH MARKER ARGV...` under
    torch.distributed.run): `tnerf_torch.cli` with argv, whose run forms
    the group of one under NCCL; then, once the file MARKER exists (the
    two gloo ranks are done, so the card is this process's alone), in that
    group the prims step timed on the mesh of one rank
    (`make_train_step(mesh=)`: the gradient and aux all_reduces) and off it
    (the step a run that was not launched takes), in blocks of
    NCCL_STEP_REPS steps in the order off, on, on, off.  Writes the times
    to PATH."""
    sys.path.insert(0, REPO)
    import torch

    from tnerf_torch.config import Config
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.parallel.mesh import make_mesh
    from tnerf_torch.train import PixelSampler, init_train_state, make_train_step
    from tnerf_torch.train_loop import build_renderer, load_datasets
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    run_cli(argv)
    deadline = time.perf_counter() + PARALLEL_JOIN_S
    while not os.path.exists(marker):
        if time.perf_counter() > deadline:
            raise TimeoutError(f"{marker} did not appear in {PARALLEL_JOIN_S} s")
        time.sleep(0.2)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = Config.from_json_file(CONFIG)
    _, params, occ = load_jax_checkpoint(CKPT, device=dev)
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    data = load_datasets(cfg, splits=("train",), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    batch = PixelSampler(data["train"], cfg.scene.scene_scale, cfg.scene.white_background,
                         dev).sample(gen, cfg.train.batch_size)
    rend = build_renderer(cfg, for_eval=False)

    def state():
        field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0)).to(dev)
        field.load_state_dict(params)
        return init_train_state(field, cfg.train)

    steps = {"off": (make_train_step(rend), state()),
             "on": (make_train_step(rend, mesh=make_mesh(-1, device=dev)), state())}
    times = {"off": [], "on": []}
    for name in ("off", "on", "on", "off"):
        step, st = steps[name]
        step(st, batch, payload)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(NCCL_STEP_REPS):
            step(st, batch, payload)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / NCCL_STEP_REPS)
    with open(result_path, "w") as fh:
        json.dump(times, fh)


def nccl_train(marker):
    """`python -m torch.distributed.run --nproc-per-node 1` of `tnerf_torch.cli
    train` of the prims config for NCCL_TRAIN_STEPS steps: the group forms
    under NCCL (one rank, one card) and the loss falls; then, once the file
    `marker` exists, the step on the mesh of one rank against the step off
    it (`nccl_step_job`).  Returns the step times."""
    import shutil

    out_dir = os.path.join(OUT, "train_nccl")
    shutil.rmtree(out_dir, ignore_errors=True)
    result = os.path.join(OUT, "nccl_steps.json")
    t0 = time.perf_counter()
    _, err = run_launched(1, [
        os.path.join(REPO, "chip_smoke.py"), "--nccl-job", result, marker,
        "train", "--config", CONFIG, "--out", out_dir,
        "-o", f"train.steps={NCCL_TRAIN_STEPS}", "-o", "train.log_every=10",
        "-o", "train.eval_every=0", "-o", "train.checkpoint_every=0",
        "-o", "scene.proc_n_train=8", "-o", "scene.proc_n_val=1", "-o", "scene.proc_n_test=1",
        "-o", "train.assert_test_psnr_min=0"],  # 50 steps: the config's 28 dB gate is for 1500
        timeout=PARALLEL_JOIN_S)
    _, losses, final = last_window(os.path.join(out_dir, "metrics.jsonl"))
    backend = "backend nccl" in err
    with open(result) as fh:
        times = json.load(fh)
    os.remove(result)
    print(f"parallel nccl train ({time.perf_counter() - t0:.1f} s): backend nccl {backend}, "
          f"losses {['%.3e' % x for x in losses]}, psnr_test {final['psnr_test']:.4f}; the "
          f"prims step in that group of one, ms over {NCCL_STEP_REPS} steps, blocks off / on / "
          f"on / off: on the mesh {[round(t, 3) for t in times['on']]}, off it (as a run that "
          f"was not launched) {[round(t, 3) for t in times['off']]}", flush=True)
    if not backend or not losses[-1] < losses[0]:
        raise AssertionError(f"the launched run under NCCL: backend logged {backend}, losses "
                             f"{losses}")
    return times


def parallel_checks():
    """Phase `parallel`: two ranks on the one card under gloo
    (`parallel_rank`), each parallel form against one rank on the same
    inputs, beside `nccl_train` (a process of its own, started first, which
    times its steps once the ranks are done)."""
    import concurrent.futures

    import torch

    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks' processes
    marker = os.path.join(OUT, "parallel_ranks_done")
    if os.path.exists(marker):
        os.remove(marker)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nccl = pool.submit(nccl_train, marker)
        t0 = time.perf_counter()
        try:
            spawn_ranks(parallel_rank, PARALLEL_RANKS, OUT)
        finally:  # the NCCL run goes on to its end either way
            open(marker, "w").close()
        ranks_s = time.perf_counter() - t0
        nccl.result()
    os.remove(marker)
    results = []
    for r in range(PARALLEL_RANKS):
        path = os.path.join(OUT, f"parallel_rank{r}.json")
        with open(path) as fh:
            results.append(json.load(fh))
        os.remove(path)
    print(f"parallel: {PARALLEL_RANKS} ranks on one card, backend {results[0]['backend']}, "
          f"{ranks_s:.1f} s; checks {json.dumps(results[0]['checks'])}", flush=True)
    print(f"parallel timing (two ranks sharing one card, not a scaling figure): gradient "
          f"all_reduce of {results[0]['allreduce_bytes']} bytes "
          f"{[round(r['allreduce_ms'], 3) for r in results]} ms per call on ranks 0 and 1; "
          f"DP step of 8192 rays {[round(r['dp_step_ms'], 3) for r in results]} ms; one rank "
          f"alone {results[0]['one_rank_step_ms']:.3f} ms", flush=True)
    for name, counts in results[0]["launches"].items():
        print(f"parallel {name}: rank 0 launches {json.dumps(counts)}", flush=True)
    need = {"dp_step": ("tighten_range", "fused_forward", "fused_backward"),
            "dp_render": ("fused_forward",), "sp_step": ("dda_march",),
            "tp_step": ("segment_sort", "segment_sum")}
    for r in results:
        for name, kernels in need.items():
            if min(r["launches"][name][k] for k in kernels) < 1:
                raise AssertionError(f"parallel {name}: a kernel of {kernels} was not launched "
                                     f"on every rank: {r['launches'][name]}")
    return _rank_sum(results, "totals")


# Phase `parallel_full`: the entry point under the launcher with two ranks
# on the one card (gloo), trained to the end against the gates the one-rank
# runs are held to.  Two processes share one card: the times are not a
# scaling figure.  A reference of None: the table field's band
# (`hold_to_reference_band`), as the one-rank run's.
PARALLEL_FULL_RUNS = (
    ("train_dp2", CONFIG, ["parallel.data_parallel=2"], JAX_PSNR_TEST),
    ("train_triplane_tp2", CONFIG_TRIPLANE, ["parallel.table_parallel=2"], None),
)


def cli_rank_job(result_prefix, argv):
    """The body of a launched rank of phase `parallel_full` (`chip_smoke.py
    --rank-job PREFIX ARGV...` under torch.distributed.run): the entry
    point `tnerf_torch.cli` with its kernels' launches counted, written to
    PREFIX.rank<RANK>.json."""
    sys.path.insert(0, REPO)
    text, launches = counted(lambda: run_cli(argv))
    with open(f"{result_prefix}.rank{os.environ['RANK']}.json", "w") as fh:
        json.dump({"text": text, "launches": launches}, fh)


def parallel_full():
    """Phase `parallel_full` (not in the default run): `cli train` under the
    launcher with two ranks of the prims config at parallel.data_parallel=2
    (1500 steps) and of the progressive triplane at table_parallel=2, each
    held as its one-rank run is (the prims config within
    TRAIN_PSNR_MARGIN_DB of the reference's, the triplane inside the band of
    the reference's streams from the port's own initial weights, which both
    runs draw) and over its config's gate."""
    import shutil

    launches = {k: 0 for k in kernel_counters()}
    for name, config, overrides, reference in PARALLEL_FULL_RUNS:
        out_dir = os.path.join(OUT, name)
        shutil.rmtree(out_dir, ignore_errors=True)
        prefix = os.path.join(OUT, f"job_{name}")
        argv = ["train", "--config", config, "--out", out_dir]
        for ov in overrides:
            argv += ["-o", ov]
        t0 = time.perf_counter()
        run_launched(PARALLEL_RANKS, [os.path.join(REPO, "chip_smoke.py"), "--rank-job", prefix]
                     + argv, timeout=3000)
        seconds = time.perf_counter() - t0
        cfg = load_config(config, overrides)
        results = []
        for r in range(PARALLEL_RANKS):
            with open(f"{prefix}.rank{r}.json") as fh:
                results.append(json.load(fh))
            os.remove(f"{prefix}.rank{r}.json")
        final = json.loads(results[0]["text"])
        last, _, _ = last_window(os.path.join(out_dir, "metrics.jsonl"))
        for r in results:
            for k, n in r["launches"].items():
                launches[k] += n
        ref = "the band below" if reference is None else f"reference {reference:.4f}"
        print(f"{name}: {PARALLEL_RANKS} ranks sharing one card (not a scaling figure), "
              f"{seconds:.1f} s in all, last window {last['step_seconds'] * 1e3:.3f} ms/step, "
              f"psnr_test {final['psnr_test']:.4f} dB ({ref}, worst view "
              f"{final['psnr_test_min']:.4f}), launches rank 0 {json.dumps(results[0]['launches'])}",
              flush=True)
        if config == CONFIG_TRIPLANE:
            shutil.rmtree(os.path.join(out_dir, "checkpoints"))  # chiprun_out/ must stay small
        check_trained(name, cfg, final)
        if reference is None:
            hold_to_reference_band(name, config, final["psnr_test"])
        elif abs(final["psnr_test"] - reference) > TRAIN_PSNR_MARGIN_DB:
            raise AssertionError(f"{name}: test PSNR {final['psnr_test']} is not within "
                                 f"{TRAIN_PSNR_MARGIN_DB} dB of the reference's {reference}")
    return launches


def run_phases(phases, streams=(0,), lookups=("gather",)):
    """The phases named in `phases`, in the script's order (streams: phase
    `intervals_init`'s and FROM_REFERENCE_INIT's, one run each, and for the
    latter one per lookup mode): (kernels' rows, launch counts of the main
    paths)."""
    rows = {}
    phase_t0 = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - phase_t0[0]:.1f} s", flush=True)
        phase_t0[0] = now

    if "kernels" in phases:
        check_sin_fast_path()
        check_probe_kernels()
        check_segment_edges()
        for r in check_kernels() + check_backward() + check_dda():
            rows[r["name"]] = r
        with open(os.path.join(OUT, "probe_kernels.json"), "w") as fh:
            json.dump(PROBE_TIMES, fh, indent=1)
        with open(os.path.join(OUT, "b2_deep.json"), "w") as fh:
            json.dump(DEEP_ROWS, fh, indent=1)
        phase_done("kernels")
    launches = {k: 0 for k in kernel_counters()}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    if "serve" in phases:
        add(serve_prims())
        phase_done("serve")
    if "train" in phases:
        add(train_from_scratch(CONFIG, "train", 1500,
                               ("tighten_range", "fused_forward", "fused_backward"),
                               JAX_PSNR_TEST)[0])
        add(train_repeats())
        phase_done("train")
    if "deep" in phases:
        add(train_deep())
        phase_done("deep")
    if "resume" in phases:
        add(resume_reference_checkpoint())
        profile_train_steps(CONFIG, CKPT, "train")
        phase_done("resume")
    if "cdf" in phases:
        add(train_and_serve_cdf())
        phase_done("cdf")
    if "march" in phases:
        add(serve_and_train_march())
        phase_done("march")
    if "intervals" in phases:  # jobs whose host work the device-bound training hides
        if "geometry" in phases:
            obj = geometry_paths()[0]
            start_job("mesh", mesh_argv(obj), stats_of=obj)
        if "bake" in phases:
            start_job("bake", bake_argv(CONFIG, CKPT, "bake", BAKE_RES))
        add(train_intervals_short())
        phase_done("intervals")
    if "fields" in phases:
        add(train_and_serve_fields())
        rows["segment_sort"] = SORT_ROWS[0]  # the hash grid's: the most rows and values
        rows["segment_sum"] = SEGMENT_ROWS[0]
        with open(os.path.join(OUT, "segment_calls.json"), "w") as fh:
            json.dump(SEGMENT_CALLS, fh, indent=1)
        phase_done("fields")
    if "scenes" in phases:
        add(train_and_serve_scenes(*SCENE_RUNS["scenes"]))
        phase_done("scenes")
    if "scenes_full" in phases:
        add(train_and_serve_scenes(*SCENE_RUNS["scenes_full"]))
        phase_done("scenes_full")
    if "options" in phases:
        add(train_with_options(*OPTION_RUNS["options"]))
        phase_done("options")
    if "options_full" in phases:
        add(train_with_options(*OPTION_RUNS["options_full"]))
        phase_done("options_full")
    if "geometry" in phases:
        add(geometry())
        phase_done("geometry")
    if "bake" in phases:
        add(bake_prims())
        phase_done("bake")
    if "march_full" in phases:
        add(train_march_full())
        phase_done("march_full")
    if "cdf_full" in phases:
        add(train_cdf_full())
        phase_done("cdf_full")
    if "intervals_full" in phases:
        add(train_and_serve_intervals())
        phase_done("intervals_full")
    if "parallel" in phases:
        add(parallel_checks())
        phase_done("parallel")
    if "parallel_full" in phases:
        add(parallel_full())
        phase_done("parallel_full")
    if "intervals_init" in phases:
        for k in streams:
            add(train_intervals_from_reference_init(k))
        phase_done("intervals_init")
    for phase in [p for p in FROM_REFERENCE_INIT if p in phases]:
        runs = []
        for lookup in lookups:
            for k in streams:
                counts, summary = train_from_reference_init(phase, k, lookup)
                add(counts)
                runs.append(summary)
        for lookup in lookups:
            mine = [r for r in runs if r["lookup"] == lookup]
            psnrs = [r["psnr_test"] for r in mine]
            fogged = (f"{sum(r['fogged'] for r in mine)} of {len(mine)} streams fogged; "
                      if "fogged" in mine[0] else "")
            print(f"{phase} {lookup}: {fogged}psnr_test mean {sum(psnrs) / len(psnrs):.4f}, "
                  f"range [{min(psnrs):.4f}, {max(psnrs):.4f}]: " + ", ".join(
                      f"s{r['stream']} {r['psnr_test']:.4f} ({r['seconds']:.1f} s)"
                      for r in mine), flush=True)
        phase_done(phase)
    if "repeats" in phases:
        add(unfused_repeats())
        phase_done("repeats")

    return rows, launches


def main() -> int:
    start = time.perf_counter()
    import torch

    if sys.argv[1:2] == ["--rank-job"]:  # a launched rank of phase `parallel_full`
        cli_rank_job(sys.argv[2], sys.argv[3:])
        return 0
    if sys.argv[1:2] == ["--nccl-job"]:  # the launched one-rank run of phase `parallel`
        nccl_step_job(sys.argv[2], sys.argv[3], sys.argv[4:])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help=f"comma list of {', '.join(ALL_PHASES + EXTRA_PHASES)} (default: "
                    f"{', '.join(ALL_PHASES)})")
    ap.add_argument("--stream", default="0",
                    help="phases intervals_init and those from a committed step-0 state "
                    f"({', '.join(FROM_REFERENCE_INIT)}): a comma list of "
                    "streams K (or ranges a-b), one run each at train.seed = 1337 + K")
    ap.add_argument("--lookup", default="gather",
                    help=f"phases {', '.join(FROM_REFERENCE_INIT)}: a comma list of "
                    f"{', '.join(HASH_LOOKUPS)}, each run over every stream")
    opts = ap.parse_args()
    phases = set(opts.phases.split(","))
    unknown = phases - set(ALL_PHASES + EXTRA_PHASES)
    if unknown:
        log(f"chip_smoke: unknown phases {sorted(unknown)}")
        return 2
    streams = [k for part in opts.stream.split(",")
               for k in (range(int(part.split("-")[0]), int(part.split("-")[1]) + 1)
                         if "-" in part else [int(part)])]
    lookups = opts.lookup.split(",")
    if set(lookups) - set(HASH_LOOKUPS):
        log(f"chip_smoke: unknown lookup modes {sorted(set(lookups) - set(HASH_LOOKUPS))}")
        return 2
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA card")
        return 1
    if not os.path.isdir(os.path.join(REPO, "tnerf_torch")) or not os.path.isdir(CKPT):
        log(f"chip_smoke: {REPO} is not a checkout of the repository (no tnerf_torch/ or "
            "runs/suite_rehearsal/prims)")
        return 1
    sys.path.insert(0, REPO)
    os.makedirs(OUT, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log(sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)

    from tnerf_torch.kernels import build

    t0 = time.perf_counter()
    build.build(verbose=True)
    log(f"built {build.LIB_PATH} in {time.perf_counter() - t0:.1f} s\n{build.build.log}")
    build.library()

    try:
        rows, launches = run_phases(phases, streams, lookups)
    finally:
        for proc, _, _ in JOBS.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "wrapper_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, r in rows.items():
        r["launches"] = launches[name]
    if phases >= set(ALL_PHASES) and (len(rows) != 9
                                      or min(r["launches"] for r in rows.values()) < 1):
        raise AssertionError(f"a kernel of the main paths was not launched: {launches}")
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s in all (phases "
          f"{','.join(p for p in ALL_PHASES + EXTRA_PHASES if p in phases)})", flush=True)
    print(smi.splitlines()[0], flush=True)  # again: a long run's first lines get cut off
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
