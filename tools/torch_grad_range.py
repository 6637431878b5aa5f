#!/usr/bin/env python3
"""The range of the fused backward's gradient sums on one NVIDIA card, from
which B2 / B2t's fixed point is chosen (`GRAD_SHIFT` in
tnerf_torch/render/fused.py), and the ops of a fused training run that
PyTorch itself calls nondeterministic.

    python3 tools/torch_grad_range.py [--steps 100] [--every 10]

1. For prims (runs/suite_rehearsal/prims/config.json, B2), the CDF config
   (configs/procedural_hard_fused_cdf2.json, B2t) and prims at 13 layers
   (field_.hidden_layers=12, inputs spilled past shared memory), trains the
   first --steps steps through `cli train` and, at every --every-th backward
   launch, records per leaf (dW, dBias) the largest |sum| (the kernel's
   gradient) and the largest |partial| of one (tile, chunk) (the plain
   version's terms, `fused.backward_terms`, summed per tile), beside the
   launch's overflow bound (`bwd_grad_limit`) in gradient units, and the
   share of the (tile, chunk) dW partials' entries that are not zero.
2. 20 steps of prims and of the CDF config through `cli train` under
   torch.use_deterministic_algorithms(True, warn_only=True): every warning
   PyTorch raises, by message, and the aten ops of the run (its final eval
   included) that PyTorch makes deterministic only under that mode
   (`ONLY_UNDER_MODE`).
Writes chiprun_out/grad_range.json with the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# aten ops that use atomics or pick among duplicate writes on CUDA unless
# torch.use_deterministic_algorithms(True) (its docstring's list)
ONLY_UNDER_MODE = ("aten::index_put_", "aten::_index_put_impl_", "aten::put_",
                   "aten::scatter_add_", "aten::scatter_add", "aten::scatter_",
                   "aten::scatter", "aten::scatter_reduce", "aten::index_add_",
                   "aten::index_add", "aten::index_copy_", "aten::index_select_backward",
                   "aten::gather_backward", "aten::embedding_dense_backward",
                   "aten::repeat_interleave")


def tile_partial_max(args, kw):
    """(largest |dW partial|, largest |dBias partial|, share of nonzero dW
    partials) of one (tile, chunk) over the launch's tiles, from the plain
    version's terms: a tile is R rays x one chunk of their samples, as
    `bwd_tiles` cuts them."""
    import torch
    import torch.nn.functional as nnf

    from tnerf_torch.device import full_f32_matmul
    from tnerf_torch.render import fused as fz

    B, S = args[8].shape
    R = fz.bwd_tiles(B, S)[1]
    pad = (-B) % R
    w_max = b_max = 0.0
    nonzero = total = 0
    with torch.no_grad(), full_f32_matmul():
        for _, a_in, gb in fz.backward_terms(*args, ts=kw.get("ts"), dts=kw.get("dts")):
            n = a_in.shape[0] // B
            a = nnf.pad(a_in.view(B, n, fz.LANES), (0, 0, 0, 0, 0, pad)).view(-1, R * n, fz.LANES)
            g = nnf.pad(gb.view(B, n, fz.LANES), (0, 0, 0, 0, 0, pad)).view(-1, R * n, fz.LANES)
            b_max = max(b_max, float(g.sum(dim=1).abs().max()))
            for t in range(0, a.shape[0], 1024):
                part = torch.bmm(a[t:t + 1024].transpose(1, 2), g[t:t + 1024])
                w_max = max(w_max, float(part.abs().max()))
                nonzero += int((part != 0).sum())
                total += part.numel()
    return w_max, b_max, nonzero / total


def gradient_ranges(config, overrides, steps, every, out_dir):
    """The records of item 1 for one training run."""
    import chip_smoke as cs
    from tnerf_torch.render import fused as fz

    real = fz.fused_backward
    seen, records = [0], []

    def recording(*args, **kw):
        dW, dB = real(*args, **kw)
        if seen[0] % every == 0:
            w_part, b_part, nonzero = tile_partial_max(args[:13], kw)
            B, S = args[8].shape
            records.append({"launch": seen[0], "sum_max": [float(dW.abs().max()),
                                                           float(dB.abs().max())],
                            "partial_max": [w_part, b_part], "dW_partial_nonzero": nonzero,
                            "limit": fz.bwd_grad_limit(B, S) * 2.0 ** -fz.GRAD_SHIFT})
        seen[0] += 1
        return dW, dB

    # the wrapper counts its launches on whatever its module calls fused_backward
    recording.launches = recording.launches_tmode = 0
    fz.fused_backward = recording
    try:
        argv = ["train", "--config", config, "--out", out_dir, "-o", f"train.steps={steps}",
                "-o", "train.eval_every=0", "-o", "train.checkpoint_every=0"]
        for ov in overrides:
            argv += ["-o", ov]
        cs.run_cli(argv)
    finally:
        fz.fused_backward = real
    return {"launches": seen[0], "records": records,
            "sum_max": [max(r["sum_max"][i] for r in records) for i in (0, 1)],
            "partial_max": [max(r["partial_max"][i] for r in records) for i in (0, 1)]}


def deterministic_mode_run(config, out_dir):
    """The warnings and ONLY_UNDER_MODE ops of 20 steps of `config`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    argv = ["train", "--config", config, "--out", out_dir, "-o", "train.steps=20", "-o",
            "train.eval_every=0", "-o", "train.checkpoint_every=0", "-o",
            "train.assert_test_psnr_min=0"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, \
                profile(activities=[ProfilerActivity.CPU]) as prof:
            warnings.simplefilter("always")
            cs.run_cli(argv)
    finally:
        torch.use_deterministic_algorithms(False)
    messages = {}
    for w in caught:
        key = str(w.message).splitlines()[0][:200]
        messages[key] = messages.get(key, 0) + 1
    ops = {e.key: e.count for e in prof.key_averages() if e.key in ONLY_UNDER_MODE}
    return {"warnings": messages, "ops_only_deterministic_under_mode": ops}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--every", type=int, default=10)
    opts = ap.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_grad_range: no card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "steps": opts.steps, "every": opts.every, "ranges": {},
              "deterministic_mode": {}}
    runs = {"prims": (cs.CONFIG, []), "cdf": (cs.CONFIG_CDF, cs.SHORT_RUN),
            "deep": (cs.CONFIG, cs.DEEP_OVERRIDES)}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (config, overrides) in runs.items():
            r = gradient_ranges(config, list(overrides) + cs.SHORT_RUN, opts.steps, opts.every,
                                os.path.join(tmp, name))
            result["ranges"][name] = r
            print(f"{name}: {r['launches']} launches; largest |sum| dW {r['sum_max'][0]:.4e}, "
                  f"dBias {r['sum_max'][1]:.4e}; largest |partial| of a (tile, chunk) dW "
                  f"{r['partial_max'][0]:.4e}, dBias {r['partial_max'][1]:.4e}; the flag's "
                  f"bound {r['records'][0]['limit']:g}", flush=True)
        for name in ("prims", "cdf"):
            d = deterministic_mode_run(runs[name][0], os.path.join(tmp, f"det_{name}"))
            result["deterministic_mode"][name] = d
            print(f"{name} under use_deterministic_algorithms(warn_only): {json.dumps(d)}",
                  flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "grad_range.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
