#!/usr/bin/env python3
"""Time the port's occupancy probe kernels B3 (`tighten_range`) and B4
(`tighten_sample_mask`) in turns with an earlier version of them, on one
NVIDIA card, by device time, at the shapes of `chip_smoke.py`:

- the training batch: 8192 rays drawn from the prims train views (B3 at
  256 probes on the 32^3 kernel bitfield; B4 at n = cdf_bins on the bin
  pooling, as a CDF train step runs it);
- the serving chunk: 32,000 rays of a 400x400 test view (B3; B4 at n = S
  on the kernel's pooling and at n = cdf_bins on the bin pooling);
- the march eval: the same chunk at 16^3, 64 probes, 96 midpoints;
- 66,000 rays of the same view (B3 and B4 at n = 64): past one block of
  256 threads per SM for the one-thread-per-ray kernels.

    git archive <rev> tnerf_torch/csrc tnerf_torch/grid/tighten.py \\
        | tar -x -C _dev/old --strip-components=1
    python3 tools/torch_probe_turns.py --old _dev/old [--attribute] [--groups]

`--old` is a directory holding an earlier revision's `csrc/` and
`grid/tighten.py`; its `tighten.cu` is built alone with nvcc for sm_90a
and driven through its own wrapper. Each row's device time is the kernel's
mean self time in `torch.profiler` over at least 50 launches and
`wrapper_ms` the host clock per call of 50 further calls of the wrapper,
synchronised once at the end (`chip_smoke.device_ms` / `wrapper_ms`). Rows
are timed in the order old, port, port, old, three times; medians are
printed and written to chiprun_out/probe_turns.json with the card's name
and power limit. Every case also records the share of probes that the
port's scan evaluates (`tighten_range_scan` on the same rays, at the lane
group the wrapper chooses), how many elements of the old and port outputs
differ (none, except where the port's reciprocal of a probe or sample
count that is not a power of two replaces the old division: at n = 96),
and an empty launch's device time. `--attribute` also builds the old
kernel with its divisions replaced by reciprocal multiplies (timed, not
bit-exact) and with thread 0's `clock64` split of B4 (staging, probe
phase, mask phase; both with and without the divisions): step 0 of
PERF.md's entry for these kernels, which needs a `--old` of commit
c4b0a44. `--groups` also times the port at every lane group its kernels
build (G = 8, 16, 32, by replacing `lane_group`): the measurement behind
`lane_group`'s rule.
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
# the launch functions' C interface at commit c4b0a44
OLD_PROTOTYPES = {
    "tnerf_tighten_range": [P] * 7 + [I, I] + [F] * 6 + [I, F, P],
    "tnerf_tighten_sample_mask": [P] * 8 + [I, I, I] + [F] * 6 + [I, F, P],
}
# Source edits of that kernel: (file, old text, new text).
NO_DIV = [
    ("probe.cuh", "  const float step = __fdiv_rn(span, nprobes);\n",
     "  const float step = __fdiv_rn(span, nprobes);\n"
     "  const float inv_np = __frcp_rn(nprobes);\n"),
    ("probe.cuh", "const float frac = __fdiv_rn(__fadd_rn((float)i, 0.5f), nprobes);",
     "const float frac = __fmul_rn(__fadd_rn((float)i, 0.5f), inv_np);"),
    ("coarse.cuh", "float c = floorf(__fdiv_rn(__fsub_rn(p, lo), cell));",
     "float c = floorf(__fmul_rn(__fsub_rn(p, lo), __frcp_rn(cell)));"),
]
CLOCK = [
    ("tighten.cu", '#include "probe.cuh"\n',
     '#include "probe.cuh"\n__device__ unsigned long long probe_clk[3];\n'),
    ("tighten.cu", "                    int probes, float pad_diag, int n_samples) {\n"
                   "  __shared__ uint32_t words[kWords];\n  stage_words(words, words_in);\n",
     "                    int probes, float pad_diag, int n_samples) {\n"
     "  __shared__ uint32_t words[kWords];\n  const long long c0 = clock64();\n"
     "  stage_words(words, words_in);\n  const long long c1 = clock64();\n"),
    ("tighten.cu", "  t1_out[r] = t1;\n\n  // Phase 2",
     "  t1_out[r] = t1;\n  const long long c2 = clock64();\n\n  // Phase 2"),
    ("tighten.cu", "    for (int s = 0; s < n_samples; ++s) row[s] = (uint8_t)bit(s);\n  }\n}\n",
     "    for (int s = 0; s < n_samples; ++s) row[s] = (uint8_t)bit(s);\n  }\n"
     "  const long long c3 = clock64();\n  if (threadIdx.x == 0) {\n"
     "    atomicAdd(&probe_clk[0], (unsigned long long)(c1 - c0));\n"
     "    atomicAdd(&probe_clk[1], (unsigned long long)(c2 - c1));\n"
     "    atomicAdd(&probe_clk[2], (unsigned long long)(c3 - c2));\n  }\n}\n"),
]
CLOCK_READER = """
extern "C" int probe_clock(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[3] = {0, 0, 0};
    return (int)cudaMemcpyToSymbol(probe_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, probe_clk, 3 * sizeof(unsigned long long));
}
"""
CLOCK_PHASES = ["stage_words", "probe", "mask"]
VARIANTS = {"no_div": NO_DIV, "clock": CLOCK, "clock_no_div": CLOCK + NO_DIV}


def build_old(old_dir, out_dir, variants):
    """{name: ctypes library} of the old tighten.cu as it stands ("old")
    and in `variants`, all compiled at once."""
    from tnerf_torch.kernels.build import ARCH, FLAGS, nvcc

    procs = {}
    for name, edits in {"old": [], **variants}.items():
        src = os.path.join(out_dir, name)
        shutil.copytree(os.path.join(old_dir, "csrc"), src)
        for fname, a, b in edits:
            path = os.path.join(src, fname)
            text = open(path).read()
            if a not in text:
                raise SystemExit(f"--attribute: {old_dir}/csrc/{fname} is not the c4b0a44 kernel "
                                 f"these edits expect (missing {a[:60]!r})")
            open(path, "w").write(text.replace(a, b, 1))
        if any(e in CLOCK for e in edits):
            with open(os.path.join(src, "tighten.cu"), "a") as fh:
                fh.write(CLOCK_READER)
        lib = os.path.join(out_dir, f"lib_{name}.so")
        cmd = [nvcc(), *ARCH, *FLAGS, "-shared", "-Xptxas", "-v", "-I", src, "-o", lib,
               os.path.join(src, "tighten.cu")]
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
        for fn, argtypes in OLD_PROTOTYPES.items():
            getattr(cdll, fn).argtypes, getattr(cdll, fn).restype = argtypes, ctypes.c_int
        libs[name] = cdll
    return libs


def old_wrappers(old_dir, lib, tag):
    """The old revision's tighten.py, its kernels taken from `lib`."""
    from tnerf_torch.kernels import build

    spec = importlib.util.spec_from_file_location(f"_tighten_{tag}",
                                                  os.path.join(old_dir, "grid", "tighten.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = types.SimpleNamespace(library=lambda: lib, check=build.check,
                                      check_tensor=build.check_tensor)
    return mod


def cases():
    """{name: (kind, rays o, d, te, tx, occupancy [c, c, c] bool or None,
    words, res_c, n, probes)} at the shapes of the module docstring, and
    the grid config."""
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

    dev = torch.device("cuda")
    cfg = Config.from_json_file(cs.CONFIG)
    _, _, occ = load_jax_checkpoint(cs.CKPT, device=dev)
    res = cfg.grid.resolution
    res_c = fz.select_coarse_res(cfg.render, res)
    res_t = fz.select_bin_pool_res(res)
    S, nb = cfg.sampler.samples_per_ray, cfg.sampler.cdf_bins
    pool = lambda c: make_coarse_occupancy(occ.bitfield.reshape(res, res, res), res // c)

    train = load_data("procedural", cfg.scene.name, splits=("train",),
                      proc=scene_proc_kwargs(cfg.scene))["train"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rays = PixelSampler(train, cfg.scene.scene_scale, cfg.scene.white_background,
                        dev).sample(gen, cfg.train.batch_size).rays
    near = cfg.sampler.near
    train_rays = cs.probe_rays(rays.origins, rays.directions, cfg.grid, near)
    flat = cs.serving_chunk(cfg, dev)
    serve_rays = cs.probe_rays(flat.origins, flat.directions, cfg.grid, near)
    W = cfg.scene.proc_width
    view = camera_rays(sphere_poses(8, seed=30)[0], W, W, focal_from_angle(W, CAMERA_ANGLE_X),
                       cfg.scene.scene_scale, device=dev)
    pick = torch.randperm(W * W, generator=torch.Generator().manual_seed(3))[:66000].to(dev)
    big_rays = cs.probe_rays(view.origins.reshape(-1, 3)[pick],
                             view.directions.reshape(-1, 3)[pick], cfg.grid, near)
    kernel_words = fz.pack_occupancy_words(occ.bitfield, res, res_c)
    occ_t, occ_16 = pool(res_t), pool(16)
    return {
        "train_b3": ("b3", *train_rays, None, kernel_words, res_c, 0, 256),
        "train_b4_bins": ("b4", *train_rays, occ_t, tg.pack_words_rows(occ_t), res_t, nb, 256),
        "serve_b3": ("b3", *serve_rays, None, kernel_words, res_c, 0, 256),
        "serve_b4_S": ("b4", *serve_rays, pool(res_c), kernel_words, res_c, S, 256),
        "serve_b4_bins": ("b4", *serve_rays, occ_t, tg.pack_words_rows(occ_t), res_t, nb, 256),
        "march_b4": ("b4", *serve_rays, occ_16, tg.pack_words_rows(occ_16), 16, 96, 64),
        "big_b3": ("b3", *big_rays, None, kernel_words, res_c, 0, 256),
        "big_b4": ("b4", *big_rays, occ_t, tg.pack_words_rows(occ_t), res_t, nb, 256),
    }, cfg.grid


def call(mod, case, grid):
    """fn() running one case through the tighten module `mod`."""
    kind, o, d, te, tx, occ, words, res_c, n, probes = case
    if kind == "b3":
        return lambda: mod.tighten_range(o, d, te, tx, words, res_c, grid, probes)
    return lambda: mod.tighten_sample_mask(o, d, te, tx, occ, n, grid, probes, words=words)


def empty_launch():
    """Device time of two launches that do almost nothing, on the stream
    the kernels use: B3 on one ray whose span is empty (it stages the 4 KB
    bitfield and writes 8 bytes), and a fill of one float."""
    import torch

    from tnerf_torch.config import GridConfig
    from tnerf_torch.grid import tighten as tg

    one = torch.zeros((1, 3), device="cuda")
    te = torch.full((1,), 2.0, device="cuda")
    words = torch.zeros(tg.WORDS, dtype=torch.int32, device="cuda")
    b3 = cs.device_ms(lambda: tg.tighten_range(one, one, te, te, words, 32, GridConfig()),
                      "tighten")
    x = torch.zeros(1, device="cuda")
    fill = lambda: x.fill_(1.0)
    return {"b3_empty_span_ms": b3, "fill_one_float_ms": cs.device_ms(fill, ""),
            "fill_one_float_host_ms": cs.wrapper_ms(fill)}


def clock_split(lib, mod, case, grid):
    """Thread 0's clock64 split of one B4 launch (sum over blocks)."""
    import torch

    lib.probe_clock.argtypes, lib.probe_clock.restype = [P, I], ctypes.c_int
    buf = (ctypes.c_ulonglong * 3)()
    lib.probe_clock(None, 1)
    call(mod, case, grid)()
    torch.cuda.synchronize()
    lib.probe_clock(buf, 0)
    total = sum(buf)
    return {k: buf[i] / total for i, k in enumerate(CLOCK_PHASES)} | {"cycles": total}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory of an earlier tnerf_torch/ (csrc/, "
                                                 "grid/tighten.py)")
    ap.add_argument("--attribute", action="store_true",
                    help="also time the old kernel without divisions and read its clock split")
    ap.add_argument("--groups", action="store_true",
                    help="also time the port at every lane group G its kernels build")
    opts = ap.parse_args()
    import numpy as np
    import torch

    from tnerf_torch.grid import tighten as tg
    from tnerf_torch.kernels import build

    if not torch.cuda.is_available():
        print("torch_probe_turns: no card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    build.library()
    result = {"card": card, "sms": torch.cuda.get_device_properties(0).multi_processor_count,
              "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_old(opts.old, tmp, VARIANTS if opts.attribute else {})
        mods = {name: old_wrappers(opts.old, lib, name) for name, lib in libs.items()}
        inputs, grid = cases()
        result["empty_launch"] = empty_launch()
        print("empty launch", json.dumps(result["empty_launch"]), flush=True)
        for name, case in inputs.items():
            kind, o, d, te, tx, occ, words, res_c, n, probes = case
            B = o.shape[0]
            runs = {"old": mods["old"], "port": tg}
            if "no_div" in mods:
                runs["old_no_div"] = mods["no_div"]
            outs = {k: call(m, case, grid)() for k, m in runs.items()}
            torch.cuda.synchronize()
            differ = [int((a != b).sum()) for a, b in zip(outs["old"], outs["port"])]
            dev_t = {k: [] for k in runs}
            host_t = {k: [] for k in runs}
            for _ in range(3):
                for k in list(runs) + list(reversed(list(runs))):
                    dev_t[k].append(cs.device_ms(call(runs[k], case, grid), "tighten"))
                    host_t[k].append(cs.wrapper_ms(call(runs[k], case, grid)))
            G = tg._launch_group(B, probes)
            _, _, evaluated = tg.tighten_range_scan(o, d, te, tx, words, res_c, grid, probes, G)
            row = {"rays": B, "probes": probes, "n": n, "res_c": res_c, "group": G,
                   "ms": {k: float(np.median(v)) for k, v in dev_t.items()},
                   "wrapper_ms": {k: float(np.median(v)) for k, v in host_t.items()},
                   "old_port_differ": differ,
                   "evaluated_share": float(evaluated.sum()) / (B * probes),
                   "rays_with_span": int((tx > te).sum()),
                   "rays_tightened": int(((outs["port"][0] != te) | (outs["port"][1] != tx)).sum())}
            if "no_div" in mods:
                row["no_div_differs"] = int(sum(int((a != b).sum()) for a, b in
                                                zip(outs["old"], outs["old_no_div"])))
            if opts.groups:
                chosen = tg.lane_group
                try:
                    row["ms_by_group"] = {}
                    for g in (8, 16, 32):
                        tg.lane_group = lambda *_, g=g: g
                        row["ms_by_group"][g] = cs.device_ms(call(tg, case, grid), "tighten")
                finally:
                    tg.lane_group = chosen
            if kind == "b4" and "clock" in libs:
                row["old_clock_split"] = clock_split(libs["clock"], mods["clock"], case, grid)
                row["old_clock_split_no_div"] = clock_split(libs["clock_no_div"],
                                                            mods["clock_no_div"], case, grid)
            result["cases"][name] = row
            print(name, json.dumps(row), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "probe_turns.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
