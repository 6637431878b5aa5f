#!/usr/bin/env python3
"""Time the port's grid walk B5 (`grid/dda.py:dda_steps`, `csrc/dda.cu`) in
turns with an earlier version of it, on one NVIDIA card, by device time, at
three shapes:

- the intervals training shape: 4096 rays drawn from the hard scene's
  train views (`runs/hard_r4_intervals16/config.json`), 16^3, 49 steps,
  the skipping walk at coarse factor 1 on the prims occupancy pooled to
  16^3, as `chip_smoke.py:check_dda` builds it;
- an intervals eval chunk: the rays of test view 0 of the same scene
  (128 x 128 = 16,384 rays: the view is smaller than the config's chunk
  of 32,768 rays, so it is one chunk), the same walk;
- the large dense shape: an 800 x 800 view of the prims scene, 640,000
  rays x 384 steps at 128^3 without occupancy.

    mkdir -p _dev/old && git archive <rev> tnerf_torch/csrc \\
        tnerf_torch/grid/dda.py | tar -x -C _dev/old --strip-components=1
    python3 tools/torch_dda_turns.py --old _dev/old [--attribute]

`--old` is a directory holding an earlier revision's `csrc/` and
`grid/dda.py`; its `dda.cu` is built alone with nvcc for sm_90a and
driven through its own `dda_steps`. Each row's device time is the
kernel's mean self time in `torch.profiler` over at least 50 launches and
`wrapper_ms` the host clock per call of 50 further calls
(`chip_smoke.device_ms` / `wrapper_ms`). Rows are timed in the order old,
port, port, old, three times; medians are printed and written to
chiprun_out/dda_turns.json with the card's name, power limit and SM
count, beside the byte bound and how many cells and depths of the old and
port outputs differ (none is allowed where both compute cell ids the same
way). `--attribute` also builds the old kernel with one change each, for
step 0 of PERF.md's entry on B5 (it needs a `--old` of commit cbff516):
`block32` / `block64` (32 or 64 threads per block instead of 256, so that
every SM has a block at 4096 rays) and `no_div` (the cell ids by a
multiply with the reciprocal of the cell size instead of the division);
and the port's kernel with one change each: `port_plain_stores` (plain
stores instead of streaming ones), `port_ldg_words` (the coarse words
read through the read-only cache instead of staged in shared memory) and
`port_block256` (256 rays per block, as before `block_shape`), and
`port_clock`, which adds thread 0's `clock64` split of each block into
its prologue (the bitfield staged, the ray loaded) and its walk; with it
the port is also timed at one step (the launch, the prologue and one
step). Variants are timed once, after the turns.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402  (standard-library imports only)

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the launch function's C interface at commit cbff516
OLD_PROTOTYPE = [P] * 8 + [I] * 5 + [F] * 9 + [P]
# Source edits of that kernel: (old text, new text) in dda.cu.
OLD_VARIANTS = {
    "block32": [("constexpr int kThreads = 256;", "constexpr int kThreads = 32;")],
    "block64": [("constexpr int kThreads = 256;", "constexpr int kThreads = 64;")],
    "no_div": [("return __float2int_rd(__fdiv_rn(__fsub_rn(__fadd_rn(o, __fmul_rn(d, t)), lo), "
                "h));",
                "return __float2int_rd(__fmul_rn(__fsub_rn(__fadd_rn(o, __fmul_rn(d, t)), lo), "
                "__frcp_rn(h)));")],
}
# Thread 0's clock64 split of the port's kernel, summed over blocks: the
# prologue (staging the bitfield, loading the ray, the barrier) and the walk.
CLOCK = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n__device__ unsigned long long dda_clk[2];\n"),
    ("  __shared__ uint32_t words[kOcc ? kMaxWords : 1];\n",
     "  __shared__ uint32_t words[kOcc ? kMaxWords : 1];\n  const long long c0 = clock64();\n"),
    ("  if (r >= n) return;\n", "  if (r >= n) return;\n  const long long c1 = clock64();\n"),
    ("    t_cur = fmaxf(t_cur, t_step);\n  }\n}\n",
     "    t_cur = fmaxf(t_cur, t_step);\n  }\n  if (threadIdx.x == 0) {\n"
     "    atomicAdd(&dda_clk[0], (unsigned long long)(c1 - c0));\n"
     "    atomicAdd(&dda_clk[1], (unsigned long long)(clock64() - c1));\n  }\n}\n"),
]
CLOCK_READER = """
extern "C" int dda_clock(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[2] = {0, 0};
    return (int)cudaMemcpyToSymbol(dda_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, dda_clk, 2 * sizeof(unsigned long long));
}
"""
# Source edits of the port's kernel: plain stores instead of streaming ones,
# and the coarse words read through the read-only path instead of staged.
PORT_VARIANTS = {
    "port_plain_stores": [("__device__ __forceinline__ void store(T* p, T v) { __stcs(p, v); }",
                           "__device__ __forceinline__ void store(T* p, T v) { *p = v; }")],
    "port_ldg_words": [
        ("    for (int i = threadIdx.x; i < n_words; i += blockDim.x) words[i] = "
         "__ldg(words_in + i);\n", "    (void)n_words;\n"),
        ("c_occ = ((words[cflat >> 5] >>", "c_occ = ((__ldg(words_in + (cflat >> 5)) >>")],
    "port_clock": CLOCK,
}


def build_variants(csrc, out_dir, variants, prototype):
    """{name: ctypes library} of `csrc`'s dda.cu with each variant's edits
    (the "" edits of a name build it as it stands), all compiled at once."""
    from tnerf_torch.kernels.build import ARCH, FLAGS, nvcc

    procs = {}
    for name, edits in variants.items():
        src = os.path.join(out_dir, name)
        shutil.copytree(csrc, src)
        path = os.path.join(src, "dda.cu")
        text = open(path).read()
        for a, b in edits:
            if a not in text:
                raise SystemExit(f"{csrc}/dda.cu is not the kernel the {name} edits expect "
                                 f"(missing {a[:60]!r})")
            text = text.replace(a, b, 1)
        if edits is CLOCK:
            text += CLOCK_READER
        open(path, "w").write(text)
        lib = os.path.join(out_dir, f"lib_{name}.so")
        cmd = [nvcc(), *ARCH, *FLAGS, "-shared", "-Xptxas", "-v", "-I", src, "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} build:\n{text}")
        print(f"{name}: " + "; ".join(ln.split(":", 1)[1].strip() for ln in text.splitlines()
                                      if "registers" in ln), flush=True)
        cdll = ctypes.CDLL(lib)
        cdll.tnerf_dda_march.argtypes, cdll.tnerf_dda_march.restype = prototype, ctypes.c_int
        libs[name] = cdll
    return libs


def load_module(pkg_dir, lib, tag):
    """grid/dda.py of the package directory `pkg_dir`, its kernel taken
    from `lib`."""
    from tnerf_torch.kernels import build

    spec = importlib.util.spec_from_file_location(f"_dda_{tag}",
                                                  os.path.join(pkg_dir, "grid", "dda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = types.SimpleNamespace(library=lambda: lib, check=build.check,
                                      check_tensor=build.check_tensor)
    return mod


def cases():
    """{name: (prepared rays, words or None, res, coarse factor, steps, grid)}."""
    import torch

    from tnerf_torch.cameras import camera_rays, focal_from_angle
    from tnerf_torch.config import Config, GridConfig
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.data.procedural import CAMERA_ANGLE_X, sphere_poses
    from tnerf_torch.grid import dda
    from tnerf_torch.grid.traversal import make_coarse_occupancy
    from tnerf_torch.train import PixelSampler
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(cs.CONFIG)
    icfg = Config.from_json_file(cs.CONFIG_INTERVALS)
    _, _, occ = load_jax_checkpoint(cs.CKPT, device=dev)
    words = dda.pack_coarse_words(make_coarse_occupancy(occ.bitfield, 4))
    steps = icfg.grid.effective_max_hits + 1
    train = load_data("procedural", icfg.scene.name, splits=("train",),
                      proc=scene_proc_kwargs(icfg.scene))["train"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rays = PixelSampler(train, icfg.scene.scene_scale, icfg.scene.white_background,
                        dev).sample(gen, icfg.train.batch_size).rays
    W = train.width
    view = camera_rays(sphere_poses(8, seed=30)[0], W, train.height, focal_from_angle(
        W, CAMERA_ANGLE_X), icfg.scene.scene_scale, device=dev)
    big = camera_rays(sphere_poses(8, seed=30)[0], 800, 800, focal_from_angle(800, CAMERA_ANGLE_X),
                      cfg.scene.scene_scale, device=dev)
    g128 = GridConfig(resolution=128)
    return {
        "train": (dda._ray_setup(rays.origins, rays.directions, icfg.grid), words, 16, 1, steps,
                  icfg.grid),
        "eval_view": (dda._ray_setup(view.origins, view.directions, icfg.grid), words, 16, 1,
                      steps, icfg.grid),
        "big_dense": (dda._ray_setup(big.origins, big.directions, g128), None, 128, 1, 384, g128),
    }


def call(mod, case):
    args, words, res, factor, steps, grid = case
    return lambda: mod.dda_steps(*args, words, res, factor, steps, grid)


def clock_split(lib, mod, case):
    """Thread 0's clock64 split of one launch, summed over the blocks:
    {prologue, walk: shares, cycles, cycles per block}."""
    import torch

    lib.dda_clock.argtypes, lib.dda_clock.restype = [P, I], ctypes.c_int
    buf = (ctypes.c_ulonglong * 2)()
    lib.dda_clock(None, 1)
    args, words, res, factor, steps, grid = case
    call(mod, case)()
    torch.cuda.synchronize()
    lib.dda_clock(buf, 0)
    total = buf[0] + buf[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, blocks = mod.block_shape(args[0].shape[0], sms)
    return {"prologue": buf[0] / total, "walk": buf[1] / total, "cycles": total,
            "walk_cycles_per_block_and_step": buf[1] / blocks / steps}


def byte_bound_ms(case):
    """o, d_safe, inv_d, te, tx read once (44 B per ray), t0 and the cell
    written per step (8 B), the bitfield read once, over 3.35 TB/s."""
    args, words, _, _, steps, _ = case
    B = args[0].shape[0]
    return (44 * B + 8 * B * steps + (4096 if words is not None else 0)) / cs.PEAK_BYTES * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory of an earlier tnerf_torch/ (csrc/, "
                                                 "grid/dda.py)")
    ap.add_argument("--attribute", action="store_true",
                    help="also time the old kernel with its block size or its divisions changed")
    opts = ap.parse_args()
    import numpy as np
    import torch

    from tnerf_torch.grid import dda
    from tnerf_torch.kernels import build

    if not torch.cuda.is_available():
        print("torch_dda_turns: no card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"card": card, "sms": sms, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        old_v = {"old": [], **(OLD_VARIANTS if opts.attribute else {})}
        libs = build_variants(os.path.join(opts.old, "csrc"), tmp, old_v, OLD_PROTOTYPE)
        mods = {name: load_module(opts.old, lib, name) for name, lib in libs.items()}
        if opts.attribute:
            pkg = os.path.join(REPO, "tnerf_torch")
            libs = build_variants(os.path.join(pkg, "csrc"), os.path.join(tmp, "port"),
                                  PORT_VARIANTS, build.PROTOTYPES["tnerf_dda_march"])
            mods.update({name: load_module(pkg, lib, name) for name, lib in libs.items()})
            if hasattr(dda, "block_shape"):  # the port kernel at PR 7's 256 rays per block
                mods["port_block256"] = load_module(pkg, build.library(), "port_block256")
                mods["port_block256"].block_shape = lambda n, _: (256, -(-n // 256))
        runs = {"old": mods["old"], "port": dda, **{k: m for k, m in mods.items() if k != "old"}}
        for name, case in cases().items():
            args = case[0]
            hit = args[4] > args[3]
            outs = {k: call(m, case)() for k, m in runs.items()}
            torch.cuda.synchronize()
            differ = {k: [int((o[1] != outs["old"][1]).sum()),
                          int((o[0][:, hit] != outs["old"][0][:, hit]).sum())]
                      for k, o in outs.items() if k != "old"}
            dev_t = {k: [] for k in runs}
            host_t = {k: [] for k in runs}
            order = ["old", "port"]
            for _ in range(3):
                for k in order + order[::-1]:
                    dev_t[k].append(cs.device_ms(call(runs[k], case), "dda_kernel"))
                    host_t[k].append(cs.wrapper_ms(call(runs[k], case)))
            for k in runs:
                if k not in order:
                    dev_t[k].append(cs.device_ms(call(runs[k], case), "dda_kernel"))
                    host_t[k].append(cs.wrapper_ms(call(runs[k], case)))
            row = {"rays": int(args[0].shape[0]), "steps": case[4], "res": case[2],
                   "occupancy": case[1] is not None, "bound_ms": byte_bound_ms(case),
                   "ms": {k: float(np.median(v)) for k, v in dev_t.items()},
                   "ms_all": dev_t,
                   "wrapper_ms": {k: float(np.median(v)) for k, v in host_t.items()},
                   "differ_from_old": differ,
                   "rays_hit": int(hit.sum()),
                   "cells_emitted": int((outs["port"][1] >= 0).sum())}
            if hasattr(dda, "block_shape"):
                row["port_block"] = list(dda.block_shape(row["rays"], sms))
            if "port_clock" in runs:
                row["port_clock_split"] = clock_split(libs["port_clock"], runs["port_clock"], case)
                one = case[:4] + (1,) + case[5:]  # the launch, the prologue and one step
                row["port_ms_one_step"] = cs.device_ms(call(dda, one), "dda_kernel")
            result["cases"][name] = row
            print(name, json.dumps(row), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "dda_turns.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
