#!/usr/bin/env python3
"""Time the port's fused backward kernel B2 / B2t in one process, in turns
with other builds of `csrc/fused_backward.cu`, on one NVIDIA card:

- at 13 and 17 layers, against this source built with -DTNERF_NO_SPILL,
  which leaves out the stores to and reloads from the scratch of spilled
  layer inputs (the same products and slots; its gradient is wrong past
  9 layers): what the scratch costs;
- at 9 layers (the committed model), 13 and 17, against each `--old
  NAME=DIR`, a directory holding another `fused_backward.cu` and its
  headers, such as an earlier revision's `tnerf_torch/csrc`:

    mkdir -p _dev/parent_csrc
    git archive <rev> tnerf_torch/csrc | tar -x -C _dev/parent_csrc --strip-components=2
    python3 tools/torch_b2_spill_cost.py --old parent=_dev/parent_csrc

One process times every build on the same inputs, so the spread between
turns is that of the card alone, not of processes (`tools/torch_step_turns.py`
runs each tree in processes of its own).  At `chip_smoke.py`'s training
batch (8192 rays drawn from the prims train views x 64 samples, uniform
and occupancy-CDF placement, the config's term_eps), with the deep checks'
random weights past 9 layers; each build timed 20 launches at a time
(CUDA events), in turns (this build first, the others, then back), three
times.  Medians, every reading, the gradient error against the plain
version at 9 layers of each build with the fixed-point sums, and the
card's name and power limit go to chiprun_out/b2_spill_cost.json.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
LAYERS = (9, 13, 17)


class Library:
    """One build of fused_backward.cu, called as the wrapper calls the
    library.  A source from before the fixed-point sums (f32 atomics into
    dW / dBias) is called without the flag, 2^shift and the bound: it adds
    f32 bits into the wrapper's int64 sums, so its time is kept and its
    gradient is not read; one from before the scratch argument also
    without that."""

    def __init__(self, path, has_spill, fixed_point):
        from tnerf_torch.kernels import build

        self.cdll, self.fixed_point = ctypes.CDLL(path), fixed_point
        # the wrapper's arguments this build takes: flag 14, spill 16, 2^shift 30, bound 31
        n = len(build.PROTOTYPES["tnerf_fused_backward"])
        drop = (() if fixed_point else (14, 30, 31)) + (() if has_spill else (16,))
        self.keep = [i for i in range(n) if i not in drop]
        for name in ("tnerf_fused_backward", "tnerf_fused_backward_tmode",
                     "tnerf_fused_backward_max_ctas"):
            argtypes = list(build.PROTOTYPES[name])
            if name != "tnerf_fused_backward_max_ctas":
                argtypes = [argtypes[i] for i in self.keep]
            getattr(self.cdll, name).argtypes = argtypes
            getattr(self.cdll, name).restype = ctypes.c_int

    def __getattr__(self, name):
        fn = getattr(self.cdll, name)
        if name == "tnerf_fused_backward_max_ctas":
            return fn
        return lambda *a: fn(*[a[i] for i in self.keep])


def build_variants(variants, out_dir):
    """{name: Library} of each (name, csrc directory, extra nvcc flags), built together."""
    from tnerf_torch.kernels import build

    procs = {}
    for name, src_dir, flags in variants:
        lib = os.path.join(out_dir, f"lib_{name}.so")
        src = os.path.join(src_dir, "fused_backward.cu")
        with open(src) as fh:
            text = fh.read()
        kinds = ("void* spill" in text, "grad_scale" in text)
        procs[name] = (lib, kinds, subprocess.Popen(
            [build.nvcc(), *build.ARCH, *build.FLAGS, *flags, "-shared", "-I", src_dir, "-o",
             lib, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, kinds, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{text}")
        libs[name] = Library(lib, *kinds)
    return libs


def batch_inputs(widths_out):
    """{placement: (kernel arguments, placement keywords)} at the training
    batch, with the seeded cotangent and the config's term_eps."""
    import torch

    import chip_smoke as cs
    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.train import PixelSampler
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(cs.CONFIG)
    _, params, occ = load_jax_checkpoint(cs.CKPT, device=dev)
    widths_out.extend(tuple(params[f"trunk.w.{l}"].shape) for l in range(len(params) // 2))
    train = load_data("procedural", cfg.scene.name, splits=("train",),
                      proc=scene_proc_kwargs(cfg.scene))["train"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    batch = PixelSampler(train, cfg.scene.scene_scale, cfg.scene.white_background,
                         dev).sample(gen, cfg.train.batch_size)
    out = {"uniform": (build_renderer(cfg, for_eval=False).kernel_inputs(
        params, batch.rays, occ.bitfield, None), {})}
    cdf = cfg.apply_overrides(["sampler.placement=occupancy_cdf"])
    *a, placed = build_renderer(cdf, for_eval=False).kernel_inputs(params, batch.rays,
                                                                   occ.bitfield, gen)
    out["cdf"] = (tuple(a), placed)
    gout = torch.randn((cfg.train.batch_size, 6),
                       generator=torch.Generator().manual_seed(1)).to(dev)
    return out, gout, cfg.render.transmittance_threshold


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", action="append", default=[], metavar="NAME=DIR",
                    help="another fused_backward.cu's directory, timed at 9 layers")
    opts = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from tnerf_torch.kernels import build
    from tnerf_torch.render import fused as fz

    if not torch.cuda.is_available():
        print("torch_b2_spill_cost: no card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    library = build.library
    old = [tuple(v.split("=", 1)) for v in opts.old]
    result = {"card": card, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants([("no_spill", build.CSRC, ["-DTNERF_NO_SPILL"])] +
                              [(name, os.path.abspath(d), []) for name, d in old], tmp)
        libs["port"] = library()
        widths = []
        inputs, gout, eps = batch_inputs(widths)
        for placement, (args, placed) in inputs.items():
            for NL in LAYERS:
                deep = args if NL == len(widths) else (
                    cs.random_mlp(NL, 100 + NL, torch.device("cuda"), widths) + tuple(args[2:]))
                _, tchk = fz.fused_forward(*deep, term_eps=eps, return_tchk=True, **placed)
                others = [name for name, _ in old] + ([] if NL == len(widths) else ["no_spill"])

                def run(name, timed=True):
                    build.library = lambda: libs[name]  # the wrapper launches this build
                    try:
                        fn = lambda: fz.fused_backward(*deep, tchk, gout, term_eps=eps, **placed)
                        return cs.cuda_ms(fn, 20) if timed else fn()
                    finally:
                        build.library = library

                times = {name: [] for name in ["port"] + others}
                for _ in range(3):
                    for name in ["port"] + others + others[::-1] + ["port"]:
                        times[name].append(run(name))
                row = {"layers": NL, "batch": list(args[8].shape),
                       "ms": {k: float(np.median(v)) for k, v in times.items()}, "ms_each": times}
                if NL == len(widths):
                    plain = fz.fused_backward_plain(*deep, tchk, gout, **placed)
                    row["rel_to_plain"] = {
                        name: [float((g - p).abs().max() / p.abs().max())
                               for g, p in zip(run(name, timed=False), plain)]
                        for name in times if name == "port" or libs[name].fixed_point}
                result["cases"][f"{placement}_{NL}"] = row
                print(placement, NL, json.dumps(row), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "b2_spill_cost.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
