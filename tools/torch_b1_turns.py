#!/usr/bin/env python3
"""Time the port's fused forward kernel B1 / B1t in turns with an earlier
version of it, on one NVIDIA card (CUDA events), at the shapes of
`chip_smoke.py`: the serving chunk (32,000 rays of a 400x400 test view of
the prims model x 64 samples) and the training batch (8192 rays x 64
samples, with the per-chunk transmittance), each under uniform and
occupancy-CDF placement.

    git archive <rev> tnerf_torch/csrc | tar -x -C _dev/old --strip-components=2
    python3 tools/torch_b1_turns.py --old _dev/old [--attribute] [--clock]

`--old` is a directory holding an earlier revision's `tnerf_torch/csrc`
whose `fused_forward.cu` has the pre-redesign C interface (`tnerf_fused_
forward(wt, ...)` with out-major weights, no grid size).  It is built
alone with nvcc for sm_90a.  `--attribute` also builds it in variants that
each remove one cost (weights staged once per tile, compositing skipped,
encoding replaced by a constant) and one that records thread 0's clock64
split, as step 0 of PERF.md's PR 6 entry; `--clock` reads the port
kernel's own split (thread 0 of each warpgroup, a build with
-DTNERF_FWD_CLOCK).  Each row is timed 20 launches
at a time, in the order old, variants, port, then reversed, three times;
the medians are printed and written to chiprun_out/b1_turns.json with the
card's name and power limit.
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

# Source edits that turn the pre-redesign kernel into its attribution
# variants (each a macro the build sets).
ATTRIBUTE = [
    ('#include "coarse.cuh"',
     '#include "coarse.cuh"\n#ifdef B1_CLOCK\n__device__ unsigned long long b1_clk[8];\n'
     '#define CLK(k) do { if (threadIdx.x == 0) { long long _n = clock64(); clk[k] += _n - clk_t; '
     'clk_t = _n; } } while (0)\n#else\n#define CLK(k) do {} while (0)\n#endif'),
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n#ifdef B1_CLOCK\n"
     "  long long clk[8] = {0, 0, 0, 0, 0, 0, 0, 0}, clk_t = clock64();\n#endif\n"),
    ("  __syncthreads();\n\n  for (int k = 0; k < n_chunks; ++k) {",
     "#ifdef B1_STAGE_ONCE\n  tnerf::stage_matrix(sm.w, wt, tid, kThreads);\n#endif\n  __syncthreads();\n"
     "  CLK(0);\n\n  for (int k = 0; k < n_chunks; ++k) {"),
    ("    if (!any_sample || !any_live) continue;\n",
     "    CLK(1);\n    if (!any_sample || !any_live) continue;\n"),
    ("        v = tnerf::encode_feature(gamma[gi], beta[gi], place.abscissa(s, sm.t[row]), f);",
     "#ifdef B1_CONST_ENCODE\n        v = 0.5f;\n#else\n"
     "        v = tnerf::encode_feature(gamma[gi], beta[gi], place.abscissa(s, sm.t[row]), f);\n"
     "#endif"),
    ("      __syncthreads();  // activations written; previous layer's weights free\n"
     "      tnerf::stage_matrix(sm.w, wt + (size_t)l * kLanes * kLanes, tid, kThreads);\n"
     "      __syncthreads();\n",
     "      __syncthreads();  // activations written; previous layer's weights free\n"
     "      CLK(l == 0 ? 2 : 4);\n#ifndef B1_STAGE_ONCE\n"
     "      tnerf::stage_matrix(sm.w, wt + (size_t)l * kLanes * kLanes, tid, kThreads);\n#endif\n"
     "      __syncthreads();\n      CLK(3);\n"),
    ("    __syncthreads();\n\n    // Phase 4: activations per row",
     "    __syncthreads();\n    CLK(4);\n\n    // Phase 4: activations per row"),
    ("    __syncthreads();\n    for (int j = tid; j < R; j += kThreads) {\n"
     "      if (ray0 + j >= B) continue;\n      const float T0 = sm.T[j];",
     "    __syncthreads();\n    CLK(5);\n#ifndef B1_NO_COMPOSITE\n"
     "    for (int j = tid; j < R; j += kThreads) {\n      if (ray0 + j >= B) continue;\n"
     "      const float T0 = sm.T[j];"),
    ("      sm.T[j] = T0 * expf(-incl);\n    }\n    __syncthreads();\n  }\n",
     "      sm.T[j] = T0 * expf(-incl);\n    }\n#endif\n    __syncthreads();\n    CLK(6);\n  }\n"),
    ("    po[5] = sm.T[j];\n  }\n}",
     "    po[5] = sm.T[j];\n  }\n#ifdef B1_CLOCK\n  CLK(7);\n  if (tid == 0)\n"
     "    for (int q = 0; q < 8; ++q) atomicAdd(&b1_clk[q], (unsigned long long)clk[q]);\n#endif\n}"),
]
CLOCK_READER = """
#ifdef B1_CLOCK
extern "C" int b1_clock(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(b1_clk, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, b1_clk, 8 * sizeof(unsigned long long));
}
#endif
"""
VARIANTS = {"stage_once": ["-DB1_STAGE_ONCE"], "no_composite": ["-DB1_NO_COMPOSITE"],
            "const_encode": ["-DB1_CONST_ENCODE"], "clock": ["-DB1_CLOCK"]}
CLOCK_PHASES = ["init", "rows+tchk", "encode", "stage_w", "products", "head_act", "composite",
                "output"]
# csrc/fused_forward.cu's phases under -DTNERF_FWD_CLOCK
PORT_PHASES = ["rows+skip", "layers", "weight_wait", "encode", "head", "composite"]
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_PROTO = [P] * 12 + [I] * 5 + [F] * 7 + [P]
PORT_PROTO = [P] * 13 + [I] * 6 + [F] * 7 + [P]


def build_old(old_dir, out_dir, variants):
    """{name: ctypes library} of the old kernel as it stands ("old") and in
    `variants`, all compiled at once."""
    from tnerf_torch.kernels.build import ARCH, FLAGS, nvcc

    src = open(os.path.join(old_dir, "fused_forward.cu")).read()
    if variants:
        for a, b in ATTRIBUTE:
            if a not in src:
                raise SystemExit(f"--attribute: {old_dir}/fused_forward.cu is not the pre-redesign "
                                 f"kernel these edits expect (missing {a[:60]!r})")
            src = src.replace(a, b, 1)
        src += CLOCK_READER
    path = os.path.join(out_dir, "fused_forward_old.cu")
    with open(path, "w") as fh:
        fh.write(src)
    procs = {}
    for name, flags in {"old": [], **variants}.items():
        lib = os.path.join(out_dir, f"lib_{name}.so")
        cmd = [nvcc(), *ARCH, *FLAGS, "-shared", "-Xptxas", "-v", "-I", old_dir, *flags, "-o", lib,
               path]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {name} build:\n{text}")
        print(f"{name}: " + "; ".join(ln.split(":", 1)[1].strip() for ln in text.splitlines()
                                      if "registers" in ln), flush=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def build_port_clock(out_dir):
    """The port's forward kernel built with its clock split."""
    from tnerf_torch.kernels.build import ARCH, CSRC, FLAGS, nvcc

    lib = os.path.join(out_dir, "lib_port_clock.so")
    proc = subprocess.run([nvcc(), *ARCH, *FLAGS, "-shared", "-DTNERF_FWD_CLOCK", "-o", lib,
                           os.path.join(CSRC, "fused_forward.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on the clock build:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib)


def port_clock_split(lib, args, placed, eps, with_tchk):
    """The share of each phase in thread 0's clock of every warpgroup, over
    one launch of the port's kernel on one call's inputs."""
    import numpy as np
    import torch

    from tnerf_torch.render import fused as fz

    W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse = args
    fn = lib.tnerf_fused_forward_tmode if placed else lib.tnerf_fused_forward
    fn.argtypes, fn.restype = PORT_PROTO, ctypes.c_int
    lib.tnerf_fused_forward_clock.argtypes = [P]
    B, S = mask.shape
    Wk = W.to(torch.bfloat16).contiguous()
    out = torch.empty((B, 6), device="cuda")
    tchk = torch.empty((B, fz.n_bwd_chunks(S)), device="cuda") if with_tchk else None
    pp = (placed["ts"], placed["dts"]) if placed else (te, dt)
    buf = (ctypes.c_ulonglong * 8)()
    lib.tnerf_fused_forward_clock(buf)  # zero it
    err = fn(Wk.data_ptr(), Bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(), pp[0].data_ptr(),
             pp[1].data_ptr(), o.data_ptr(), d.data_ptr(), mask.data_ptr(), words.data_ptr(),
             out.data_ptr(), None if tchk is None else tchk.data_ptr(), None, B, S, W.shape[0],
             fz.fwd_grid(fz.bwd_tiles(B, S)[0], fz._max_fwd_ctas(0, bool(placed))),
             *fz._coarse_args(coarse), float(np.float32(eps)),
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err or lib.tnerf_fused_forward_clock(buf):
        raise RuntimeError("the clock build's launch failed")
    total = sum(buf[:len(PORT_PHASES)])
    return {k: buf[i] / total for i, k in enumerate(PORT_PHASES)}


def old_launcher(lib, args, placed, eps, tchk):
    """fn() launching the pre-redesign kernel of `lib` on one call's inputs."""
    import numpy as np
    import torch

    from tnerf_torch.render import fused as fz

    W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse = args
    fn = lib.tnerf_fused_forward_tmode if placed else lib.tnerf_fused_forward
    fn.argtypes, fn.restype = OLD_PROTO, ctypes.c_int
    Wt = W.to(torch.bfloat16).transpose(1, 2).contiguous()  # its out-major layout
    B, S = mask.shape
    out = torch.empty((B, 6), device="cuda")
    pp = (placed["ts"], placed["dts"]) if placed else (te, dt)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(Wt.data_ptr(), Bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 pp[0].data_ptr(), pp[1].data_ptr(), o.data_ptr(), d.data_ptr(), mask.data_ptr(),
                 words.data_ptr(), out.data_ptr(), None if tchk is None else tchk.data_ptr(), B, S,
                 W.shape[0], *fz._coarse_args(coarse), float(np.float32(eps)), stream)
        if err:
            raise RuntimeError(f"old kernel launch failed: cudaError {err}")
        return out
    return run


def cases():
    """{name: (kernel arguments, placement keywords, with tchk)} at the
    serving chunk and the training batch, and the config's term_eps."""
    import torch

    import chip_smoke as cs
    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.train import PixelSampler
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(cs.CONFIG).apply_overrides(["render.ray_compact=false"])
    cdf = cfg.apply_overrides(["sampler.placement=occupancy_cdf"])
    _, params, occ = load_jax_checkpoint(cs.CKPT, device=dev)
    flat = cs.serving_chunk(cfg, dev)
    out = {"serve_uniform": (build_renderer(cfg).kernel_inputs(params, flat, occ.bitfield), {},
                             False)}
    *a, placed = build_renderer(cdf).kernel_inputs(params, flat, occ.bitfield)
    out["serve_cdf"] = (tuple(a), placed, False)
    train = load_data("procedural", cfg.scene.name, splits=("train",),
                      proc=scene_proc_kwargs(cfg.scene))["train"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    batch = PixelSampler(train, cfg.scene.scene_scale, cfg.scene.white_background,
                         dev).sample(gen, cfg.train.batch_size)
    out["train_uniform"] = (build_renderer(cfg, for_eval=False).kernel_inputs(
        params, batch.rays, occ.bitfield, None), {}, True)
    *a, placed = build_renderer(cdf, for_eval=False).kernel_inputs(params, batch.rays,
                                                                   occ.bitfield, gen)
    out["train_cdf"] = (tuple(a), placed, True)
    return out, cfg.render.transmittance_threshold


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="directory of the earlier tnerf_torch/csrc")
    ap.add_argument("--attribute", action="store_true",
                    help="also time the old kernel's cost-removing variants and its clock split")
    ap.add_argument("--clock", action="store_true",
                    help="also read the port kernel's clock split (a build with -DTNERF_FWD_CLOCK)")
    opts = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from tnerf_torch.kernels import build
    from tnerf_torch.render import fused as fz

    if not torch.cuda.is_available():
        print("torch_b1_turns: no card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    build.library()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_old(opts.old, tmp, VARIANTS if opts.attribute else {})
        port_clock = build_port_clock(tmp) if opts.clock else None
        inputs, eps = cases()
        result = {"card": card, "cases": {}}
        for case, (args, placed, with_tchk) in inputs.items():
            B, S = args[8].shape
            tchk = torch.empty((B, fz.n_bwd_chunks(S)), device="cuda") if with_tchk else None
            runs = {name: old_launcher(lib, args, placed, eps, tchk)
                    for name, lib in libs.items() if name != "clock"}
            runs["port"] = lambda: fz.fused_forward(*args, term_eps=eps, return_tchk=with_tchk,
                                                    **placed)
            new = runs["port"]()
            new = new[0] if with_tchk else new
            err = float((runs["old"]() - new).abs()[:, [0, 1, 2, 3, 5]].max())
            times = {name: [] for name in runs}
            for _ in range(3):
                for name in list(runs) + list(reversed(list(runs))):
                    times[name].append(cs.cuda_ms(runs[name], 20))
            row = {"ms": {name: float(np.median(v)) for name, v in times.items()},
                   "max_abs_diff_old_port": err}
            if "clock" in libs:
                clk = libs["clock"]
                clk.b1_clock.argtypes, clk.b1_clock.restype = [P, I], ctypes.c_int
                buf = (ctypes.c_ulonglong * 8)()
                clk.b1_clock(None, 1)
                old_launcher(clk, args, placed, eps, tchk)()
                torch.cuda.synchronize()
                clk.b1_clock(buf, 0)
                row["old_clock_split"] = {k: v / sum(buf) for k, v in zip(CLOCK_PHASES, buf)}
            if port_clock is not None:
                row["port_clock_split"] = port_clock_split(port_clock, args, placed, eps,
                                                           with_tchk)
            result["cases"][case] = row
            print(case, json.dumps(row), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "b1_turns.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
