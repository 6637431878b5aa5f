"""Minimal library-level usage of the PyTorch + CUDA package: procedural
scene -> train -> render, the counterpart of examples/train_and_render.py
through the same public calls in `tnerf_torch`.

The CLI (`python -m tnerf_torch.cli`) wraps the same calls.  Runs
hermetically (the procedural scene needs no dataset on disk), on the
NVIDIA card by default, or on the CPU (the kernels' plain versions) with
--cpu; --size N renders the scene at N x N pixels instead of 64 x 64:

    python examples/train_and_render_torch.py [out_dir] [steps] [--cpu] [--size N]
"""

import sys

from tnerf_torch.config import Config
from tnerf_torch.data.dataset import load_data
from tnerf_torch.data.png_io import write_png
from tnerf_torch.eval import depth_image, render_dataset_view_result
from tnerf_torch.grid.occupancy import renderer_payload
from tnerf_torch.train_loop import build_renderer, run_training
from tnerf_torch.utils.checkpoint import load_jax_checkpoint

args = sys.argv[1:]
device = "cpu" if "--cpu" in args else "cuda"
size = int(args[args.index("--size") + 1]) if "--size" in args else 64
args = [a for i, a in enumerate(args)
        if a != "--cpu" and "--size" not in args[max(i - 1, 0):i + 1]]
out_dir = args[0] if args else "./runs/example_torch"
steps = int(args[1]) if len(args) > 1 else 500

# 1. configure: start from defaults, override like the CLI's -o flags
cfg = Config().apply_overrides([
    "scene.kind=procedural", "scene.name=prims", "scene.scene_scale=1.0",
    f"scene.proc_width={size}", f"scene.proc_height={size}",
    "render.pipeline=grid_march",
    "sampler.samples_per_ray=32", "sampler.near=2.0", "sampler.far=5.5",
    "grid.resolution=32", f"grid.warmup_steps={max(steps // 10, 1)}",
    "grid.update_every=10",
    "train.batch_size=1024", f"train.steps={steps}",
    f"train.eval_every={max(steps // 2, 1)}",
    "train.keep_best=true",
    f"logging.out_dir={out_dir}",
    # the renderer pads every chunk of rays to chunk_size: a small one on the CPU
    f"render.chunk_size={1024 if device == 'cpu' else 65536}",
])

# 2. train (loads the scene itself; pass datasets=... to override).
# Writes checkpoints/, checkpoints_best/, metrics.jsonl, config.json
# and final renders under out_dir, in the reference package's layout.
metrics = run_training(cfg, device=device)
print("final metrics:", {k: round(v, 3) for k, v in metrics.items()})

# 3. render one held-out view + its depth map from the trained field
scene = load_data("procedural", cfg.scene.name, splits=("test",),
                  proc={"width": size, "height": size}, device=device)
step, params, occ = load_jax_checkpoint(f"{out_dir}/checkpoints", device=device)
renderer = build_renderer(cfg, for_eval=True)
res = render_dataset_view_result(
    renderer, params, scene["test"], 0, cfg.scene.scene_scale,
    chunk_size=cfg.render.chunk_size,
    occupancy=renderer_payload(occ, cfg.sampler, cfg.grid), device=device,
)
write_png(f"{out_dir}/example_view.png", res.rgb)
write_png(f"{out_dir}/example_depth.png", depth_image(res.depth, res.acc))
print(f"wrote {out_dir}/example_view.png (+ depth) from step {step}")
