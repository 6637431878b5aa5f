#!/usr/bin/env python3
"""The table lookups' gradient on one NVIDIA card against its former path,
in turns within one process.

    python3 tools/torch_segment_turns.py --checkpoint <run>/checkpoints \\
        [--config runs/hard_r5_hashgrid_diffuse/config.json] [--steps 20]

The port's path (`fields/hashgrid.py:segment_sum_rows`: the stable sort by
row, csrc/segment_sort.cu, then csrc/segment_sum.cu) against the former one
(`parent_segment_sum_rows`: `torch.sort` of the int64 indices,
`torch.searchsorted` for the row starts, then the segment-sum kernel of
tools/segment_sum_parent.cu, built here into a library of its own), in the
order former, port, port, former:
- one call at the first lookup of a compacted train step's encode
  backward (`call_turns`): device time of every kernel the call launches
  and kernels per call (torch.profiler), the wrapper's host clock;
- 20 compacted train steps from the checkpoint's weights, Adam moments and
  occupancy (`step_turns`): host clock, device time and launches per step.
Both paths give the same bits (checked here).  chip_smoke.py's `fields`
phase runs both on each table field's trained checkpoint; this script runs
them on one checkpoint and writes chiprun_out/segment_turns_<encoding>.json
with the card's name and power limit.
"""

import argparse
import functools
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PARENT_SOURCE = os.path.join(REPO, "tools", "segment_sum_parent.cu")
TURNS = "PNNP"  # P: the former path, N: the port's


@functools.lru_cache(maxsize=None)
def parent_library():
    """tools/segment_sum_parent.cu built with nvcc for sm_90a and loaded."""
    import ctypes

    from tnerf_torch.kernels import build

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(build.BUILD_DIR, "libtnerf_segment_parent.so")
    subprocess.run([build.nvcc(), *build.ARCH, *build.FLAGS, "-shared", PARENT_SOURCE, "-o",
                    lib_path], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tnerf_segment_sum_parent.argtypes = [P] * 4 + [I] * 5 + [P]
    lib.tnerf_segment_sum_parent.restype = I
    return lib


def parent_segment_sum_rows(values, idx, rows):
    """`segment_sum_rows` as it was before its sort moved into a kernel of
    the port: `torch.sort` (stable, int64 keys), `torch.searchsorted`, and
    the segment-sum kernel on the order."""
    import torch

    from tnerf_torch.fields.hashgrid import segment_shape
    from tnerf_torch.kernels import build

    idx = idx.reshape(-1)
    values = values.reshape(idx.shape[0], -1).to(torch.float32).contiguous()
    n, F = values.shape
    dev = values.device
    sorted_idx, order = torch.sort(idx, stable=True)
    offsets = torch.searchsorted(sorted_idx, torch.arange(rows + 1, device=dev))
    out = torch.empty((rows, F), dtype=torch.float32, device=dev)
    if rows == 0 or F == 0:
        return out
    FT, E, per_block = segment_shape(n, rows, F)
    with torch.cuda.device(dev):
        err = parent_library().tnerf_segment_sum_parent(
            values.data_ptr(), order.data_ptr(), offsets.data_ptr(), out.data_ptr(), rows, F, FT,
            E, per_block, torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "tnerf_segment_sum_parent")
    return out


def device_events(prof):
    """[(name, ns)] of every kernel and memset a torch.profiler run saw, read
    from its raw events: parsing them into FunctionEvents (`key_averages`)
    takes about 0.3 ms an event on the card's host, seconds for a window of
    train steps."""
    return [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type().name == "CUDA"]


def profile_window(fn, reps):
    """{kernel or memset name: (device us, launches)} of `reps` calls of fn
    under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for name, ns in device_events(prof):
        us, n = seen.get(name, (0.0, 0))
        seen[name] = (us + ns / 1e3, n + 1)
    return seen


def measure_steps(step, n_steps):
    """Host ms (synchronised once over n_steps steps, after three), device
    ms (every kernel and memset, torch.profiler over n_steps more) and
    launches per step."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

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
    evs = device_events(prof)
    return {"host_ms": host_ms, "device_ms": sum(ns for _, ns in evs) / 1e6 / n_steps,
            "launches": len(evs) / n_steps}


def call_turns(values, idx, rows, reps=30):
    """The two paths on one call's inputs, in the order TURNS, one profiler
    window of `reps` calls a turn: per path the turns' device ms per call
    (every kernel and memset), wrapper ms (host clock, synchronised once
    over `reps` calls), kernels per call and ms per call by kernel.  The
    profiler can miss launches of a window, so a kernel's time is its mean
    over the launches seen and its launches per call the most one of the
    path's windows saw, per call."""
    import chip_smoke as cs
    from tnerf_torch.fields import hashgrid

    paths = {"P": parent_segment_sum_rows, "N": hashgrid.segment_sum_rows}
    windows = {k: [] for k in "PN"}
    wrappers = {k: [] for k in "PN"}
    for tag in TURNS:
        run = functools.partial(paths[tag], values, idx, rows)
        run()
        windows[tag].append(profile_window(run, reps))
        wrappers[tag].append(cs.wrapper_ms(run, reps))
    result = {}
    for tag, seen in windows.items():
        names = set().union(*seen)
        per_call = {k: max(1, round(max(w.get(k, (0, 0))[1] for w in seen) / reps))
                    for k in names}
        mean_us = {k: sum(w[k][0] for w in seen if k in w) / sum(w[k][1] for w in seen if k in w)
                   for k in names}
        result["parent" if tag == "P" else "port"] = {
            "device_ms": [sum(per_call[k] * (w[k][0] / w[k][1] if k in w else mean_us[k])
                              for k in names) / 1e3 for w in seen],
            "wrapper_ms": wrappers[tag], "kernels_per_call": sum(per_call.values()),
            "kernels": {k: per_call[k] * mean_us[k] / 1e3 for k in names}}
    return result


def step_turns(config, ckpt_dir, n_steps=20):
    """20 compacted train steps from the checkpoint's state by each path, in
    the order TURNS, each turn from a fresh copy of the state: per path
    the turns' host ms, device ms and launches per step, and whether one
    step's table gradients were equal to the bit between the paths."""
    import torch

    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.fields import hashgrid, nerf_field
    from tnerf_torch.grid.occupancy import renderer_payload
    from tnerf_torch.train import PixelSampler, init_train_state, make_train_step
    from tnerf_torch.train_loop import build_renderer, resolve_near_far
    from tnerf_torch.utils.checkpoint import load_train_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(config)
    train_ds = load_data("procedural", cfg.scene.name, splits=("train",),
                         proc=scene_proc_kwargs(cfg.scene))["train"]
    cfg = resolve_near_far(cfg, train_ds)
    sampler = PixelSampler(train_ds, cfg.scene.scene_scale, cfg.scene.white_background, dev)
    _, params, opt_state, occ = load_train_checkpoint(ckpt_dir, dev)
    payload = renderer_payload(occ, cfg.sampler, cfg.grid)
    step_fn = make_train_step(build_renderer(cfg, for_eval=False, compact=True))

    def fresh():
        field = nerf_field.NeRFField(cfg.field_, cfg.grid, torch.Generator()).to(dev)
        field.load_state_dict(params)
        state = init_train_state(field, cfg.train)
        state.optimizer.load_state(opt_state)
        gen = torch.Generator(device=dev).manual_seed(2)
        return state, lambda: step_fn(state, sampler.sample(gen, cfg.train.batch_size), payload,
                                      gen)

    port = hashgrid.segment_sum_rows
    paths = {"P": parent_segment_sum_rows, "N": port}
    result = {k: {"host_ms": [], "device_ms": [], "launches": []} for k in "PN"}
    after = {}
    try:
        for tag in TURNS:
            hashgrid.segment_sum_rows = paths[tag]
            state, step = fresh()
            r = measure_steps(step, n_steps)
            for key in ("host_ms", "device_ms", "launches"):
                result[tag][key].append(r[key])
            after[tag] = [p.detach().clone() for p in state.field.parameters()]
    finally:
        hashgrid.segment_sum_rows = port
    equal = all(torch.equal(a, b) for a, b in zip(after["P"], after["N"]))
    out = {"parent" if k == "P" else "port": v for k, v in result.items()}
    out["states_bit_equal"] = equal
    return out


def mean(xs):
    return sum(xs) / len(xs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--config", default=os.path.join(REPO, "runs", "hard_r5_hashgrid_diffuse",
                                                     "config.json"))
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()

    import torch

    from tnerf_torch.config import Config
    from tnerf_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("no card: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.build()
    enc = Config.from_json_file(args.config).field_.encoding
    steps = step_turns(args.config, args.checkpoint, args.steps)
    print(f"{enc}: {json.dumps(steps)}", flush=True)
    result = {"card": smi, "config": os.path.relpath(args.config, REPO), "steps": steps}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"segment_turns_{enc}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    for k in ("parent", "port"):
        print(f"{k}: {mean(steps[k]['host_ms']):.3f} ms host, {mean(steps[k]['device_ms']):.3f} "
              f"ms device, {mean(steps[k]['launches']):.1f} launches per step", flush=True)
    return 0 if steps["states_bit_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
