#!/usr/bin/env python3
"""Where a table-field train step's time goes on one NVIDIA card, and how
the table lookups' gradient is best formed there.

    python3 tools/torch_field_steps.py --checkpoint <run>/checkpoints \\
        [--config runs/hard_r5_hashgrid_diffuse/config.json]

From the checkpoint's weights, Adam moments and occupancy grid:
- 20 train steps of the march renderer without and with sample compaction
  (the dense and the compacted step of `train_loop.run_training`) under
  torch.profiler: host clock per step, device time per step, launches, the
  kernels by device time;
- the table gradient formed four ways: the port's fixed-order sorted
  segment sum (`fields/hashgrid.py:segment_sum_rows`), advanced indexing
  (`table[idx]`, whose backward is `index_put_` with accumulate),
  `torch.nn.functional.embedding` (partial segments by sorted index, in
  no fixed order) and `index_select` (`index_add_`, atomics): for each,
  20 compacted train steps under torch.profiler from the checkpoint's
  state (device time per step, the cost the lookup puts on the step), and
  the position encoding alone at one compacted step's own positions
  (forward and backward device time by CUDA events, two backward passes
  compared bit for bit); for a hash grid, the largest index multiplicity,
  the count of one table row's contributions in one pass.
Writes chiprun_out/field_steps_<encoding>.json with the card's name and power
limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def profile_steps(step, n_steps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    device_ms, launches, kernels = cs.device_time_by_kernel(prof)
    return {"host_ms": host_ms, "device_ms": device_ms / n_steps,
            "launches": launches / n_steps,
            "top": [{"kernel": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
                     "calls_per_step": e.count / n_steps} for e in kernels[:12]]}


def lookups(kind):
    """table, idx, dtype -> rows, by the formulation `kind` (dtype is the
    port's rounding, used by "segment" only: every committed config looks
    up in float32)."""
    import torch

    from tnerf_torch.fields import hashgrid

    if kind == "segment":
        return hashgrid.rounded_lookup
    fn = _plain_lookup(kind)
    return lambda table, idx, dtype: fn(table, idx)


def _plain_lookup(kind):
    import torch

    if kind == "index":
        return lambda table, idx: table[idx]
    if kind == "embedding":
        return lambda table, idx: torch.nn.functional.embedding(idx, table)
    return lambda table, idx: torch.index_select(table, 0, idx.reshape(-1)).reshape(
        *idx.shape, table.shape[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--config", default=os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse",
                                                     "config.json"))
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.fields import hashgrid, nerf_field, triplane
    from tnerf_torch.grid.occupancy import occupancy_fraction, renderer_payload
    from tnerf_torch.train import PixelSampler, init_train_state, make_train_step
    from tnerf_torch.train_loop import build_renderer, resolve_near_far
    from tnerf_torch.utils.checkpoint import load_train_checkpoint

    if not torch.cuda.is_available():
        raise SystemExit("no card: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from tnerf_torch.kernels import build

    build.build()
    dev = torch.device("cuda")
    cfg = Config.from_json_file(args.config)
    train_ds = load_data("procedural", cfg.scene.name, splits=("train",),
                         proc=scene_proc_kwargs(cfg.scene))["train"]
    cfg = resolve_near_far(cfg, train_ds)
    sampler = PixelSampler(train_ds, cfg.scene.scene_scale, cfg.scene.white_background, dev)
    _, params, opt_state, occ = load_train_checkpoint(args.checkpoint, dev)
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    result = {"card": smi, "config": os.path.relpath(args.config, REPO),
              "occupancy_frac": float(occupancy_fraction(occ)), "steps": {}}

    def fresh_step(compact):
        field = nerf_field.NeRFField(cfg.field_, cfg.grid, torch.Generator()).to(dev)
        field.load_state_dict(params)
        state = init_train_state(field, cfg.train)
        state.optimizer.load_state(opt_state)
        step_fn = make_train_step(build_renderer(cfg, for_eval=False, compact=compact))
        gen = torch.Generator(device=dev).manual_seed(2)
        return lambda: step_fn(state, sampler.sample(gen, cfg.train.batch_size), payload, gen)

    for compact in (False, True):
        r = profile_steps(fresh_step(compact), args.steps)
        result["steps"]["compact" if compact else "dense"] = r
        print(f"{'compacted' if compact else 'dense'} step: {r['host_ms']:.3f} ms host clock, "
              f"{r['device_ms']:.3f} ms device, {r['launches']:.0f} launches; top "
              f"{[(k['kernel'][:40], round(k['ms_per_step'], 3)) for k in r['top'][:5]]}",
              flush=True)

    # one compacted step's positions, as the encoding sees them
    positions = cs.step_positions(fresh_step(True))[3]
    enc = cfg.field_.encoding
    tables = {k: v.detach().clone().requires_grad_() for k, v in params.items()
              if k.split(".")[0] == enc}
    encode_alone = lambda: nerf_field.encode_positions(tables, cfg.field_, cfg.grid, positions)
    cot = torch.randn_like(encode_alone())
    grad = lambda: torch.cat([g.reshape(-1) for g in torch.autograd.grad(
        encode_alone(), list(tables.values()), cot)])
    ref = grad()
    result["samples"] = positions.shape[0]
    result["lookups"] = {}
    original = hashgrid.rounded_lookup
    for kind in ("segment", "embedding", "index", "index_select"):
        hashgrid.rounded_lookup = triplane.rounded_lookup = lookups(kind)
        try:
            step_ms = profile_steps(fresh_step(True), args.steps)["device_ms"]
            fwd_ms = cs.cuda_ms(encode_alone, 20)
            both_ms = cs.cuda_ms(grad, 20)
            g1, g2 = grad(), grad()
        finally:
            hashgrid.rounded_lookup = triplane.rounded_lookup = original
        r = {"step_device_ms": step_ms, "fwd_ms": fwd_ms, "bwd_ms": both_ms - fwd_ms,
             "repeats": bool(torch.equal(g1, g2)),
             "max_rel_to_port": float((g1 - ref).abs().max() / ref.abs().max())}
        result["lookups"][kind] = r
        print(f"lookup {kind}: compacted step {step_ms:.3f} ms device, encode forward "
              f"{fwd_ms:.3f} ms, backward {r['bwd_ms']:.3f} ms, two passes bit-equal "
              f"{r['repeats']}, against fields/hashgrid.py's gradient "
              f"{r['max_rel_to_port']:.2e} of its largest entry", flush=True)
    seg, emb = result["lookups"]["segment"], result["lookups"]["embedding"]
    result["segment_step_over_embedding"] = seg["step_device_ms"] / emb["step_device_ms"]
    print(f"the fixed-order segment sum's step against embedding's: "
          f"{result['segment_step_over_embedding']:.4f}x device time", flush=True)
    if enc == "hashgrid":  # how often the most used row of each level is read in one pass
        xn01 = 0.5 * (nerf_field.normalize_positions(positions, cfg.grid) + 1.0)
        i0, frac = hashgrid._level_geometry(xn01, cfg.field_)
        _, _, dense, n1, off = hashgrid._constants(cfg.field_, dev)
        T = 1 << cfg.field_.hash_log2_table_size
        idx = torch.stack([hashgrid._corner_index_weight(c, i0, frac, dense, n1, T)[0] + off
                           for c in range(8)])
        counts = torch.bincount(idx.reshape(-1), minlength=cfg.field_.hash_levels * T)
        result["max_multiplicity_per_level"] = counts.reshape(-1, T).max(dim=1).values.tolist()
        print(f"largest multiplicity of a row per level: {result['max_multiplicity_per_level']}",
              flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"field_steps_{enc}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
