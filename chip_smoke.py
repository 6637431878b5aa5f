#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`tnerf_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. print the card's name and power limit (nvidia-smi); no card -> exit 1;
  2. build every kernel of tnerf_torch/csrc with nvcc for sm_90a;
  3. hold each kernel against its plain PyTorch version on the card, at the
     main path's shapes (one 32768-ray chunk of a 400x400 test view of the
     committed prims model, 64 samples per ray): B3 tighten bit-equal, B1
     fused forward within its bf16 tolerance; time kernel and plain version;
  4. the main path: `tnerf_torch.cli eval` of runs/suite_rehearsal/prims
     (val + test views at 400x400) with the launch counts set to 0 just
     before and read just after; both kernels must have launched, and the
     test PSNR must be within 0.1 dB of the reference package's record;
  5. one 800x800 `tnerf_torch.cli render --orbit 1` frame, timed;
  6. print the kernels' JSON line, then the status line.
Files it writes go under chiprun_out/ (git-ignored).
"""

import contextlib
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
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
# The reference package's eval of this checkpoint (runs/suite_rehearsal/prims/metrics.jsonl).
JAX_PSNR_TEST, JAX_SSIM_TEST = 34.393025040374724, 0.9663567049469579
PSNR_TOL_DB = 0.1
# B1 tolerance: bf16 activations rounded in another order than the plain
# version's (f32 sums in another order flip single bf16 roundings); depth
# is a sum of w * t with t up to sampler.far = 5.5, so its bound scales.
B1_ATOL, B1_DEPTH_ATOL = 5e-3, 2e-2
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


def run_cli(argv):
    from tnerf_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"tnerf_torch.cli {' '.join(argv)} exited {rc}")
    return buf.getvalue()


def check_kernels():
    """Phase 3: both kernels against their plain versions on one chunk."""
    import numpy as np
    import torch

    from tnerf_torch.cameras import Rays, camera_rays
    from tnerf_torch.config import Config
    from tnerf_torch.data.procedural import CAMERA_ANGLE_X, sphere_poses
    from tnerf_torch.cameras import focal_from_angle
    from tnerf_torch.grid import tighten as tg
    from tnerf_torch.grid.traversal import ray_aabb
    from tnerf_torch.render import fused as fz
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    dev = torch.device("cuda")
    cfg = Config.from_json_file(CONFIG).apply_overrides(["render.ray_compact=false"])
    W = H = cfg.scene.proc_width
    rays = camera_rays(sphere_poses(8, seed=30)[0], W, H, focal_from_angle(W, CAMERA_ANGLE_X),
                       cfg.scene.scene_scale, device=dev)
    n, chunk = W * H, cfg.render.chunk_size
    n_chunks = -(-n // chunk)
    flat = Rays(*(a.reshape(n, a.shape[-1])[0::n_chunks].contiguous() for a in rays))
    B = flat.origins.shape[0]
    _, params, occ = load_jax_checkpoint(CKPT, device=dev)
    renderer = build_renderer(cfg)
    res_c = fz.select_coarse_res(cfg.render, cfg.grid.resolution)
    rows = []

    # B3 tighten: bit-equal on the chunk's rays, with the model's pooled
    # occupancy and with a random 32^3 bitfield.
    te, tx = ray_aabb(flat.origins, flat.directions, cfg.grid.aabb_min, cfg.grid.aabb_max)
    te = torch.clamp_min(te, cfg.sampler.near)
    tx = torch.maximum(tx, te)
    o, d = flat.origins, flat.directions
    words = fz.pack_occupancy_words(occ.bitfield, cfg.grid.resolution, res_c)
    rand = torch.from_numpy(np.random.default_rng(0).uniform(size=(res_c,) * 3) < 0.1).to(dev)
    for name, wd in (("model", words), ("random", tg.pack_words_rows(rand))):
        k0, k1 = tg.tighten_range(o, d, te, tx, wd, res_c, cfg.grid)
        p0, p1 = tg.tighten_range_plain(o, d, te, tx, wd, res_c, cfg.grid)
        if not (torch.equal(k0, p0) and torch.equal(k1, p1)):
            bad = int(((k0 != p0) | (k1 != p1)).sum())
            raise AssertionError(f"B3 tighten ({name} bitfield): {bad} of {B} rays differ")
        log(f"B3 tighten bit-equal on {B} rays ({name} bitfield)")
    live = int((tx > te).sum())
    b3_ms = cuda_ms(lambda: tg.tighten_range(o, d, te, tx, words, res_c, cfg.grid), 50)
    b3_plain = cuda_ms(lambda: tg.tighten_range_plain(o, d, te, tx, words, res_c, cfg.grid), 3)
    b3_bytes = B * (24 + 8 + 8) + 4 * tg.WORDS
    b3_ops = live * 256 * 21  # per probe: depth 4, position 6, cell ids 9, min/max 2
    rows.append(dict(
        name="tighten_range", route="cuda", source="tnerf_torch/csrc/tighten.cu",
        replaces="tnerf/grid/pallas_dda.py:333", max_abs_err=0.0, ms=b3_ms, plain_ms=b3_plain,
        bound_ms=max(b3_bytes / PEAK_BYTES, b3_ops / PEAK_F32) * 1e3,
        bound_by="bytes" if b3_bytes / PEAK_BYTES > b3_ops / PEAK_F32 else "operations",
        library_ms=None))

    # B1 fused forward on exactly the renderer's kernel inputs.
    args = renderer.kernel_inputs(params, flat, occ.bitfield)
    eps = cfg.render.transmittance_threshold
    out_k = fz.fused_forward(*args, term_eps=0.0)
    out_p = fz.fused_forward_plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out_k).all():
        raise AssertionError("B1 fused forward: non-finite output")
    err = (out_k - out_p).abs().amax(dim=0).tolist()
    log("B1 max |kernel - plain| per column (r, g, b, acc, depth, T):", err)
    if max(err[:4] + err[5:]) > B1_ATOL or err[4] > B1_DEPTH_ATOL:
        raise AssertionError(f"B1 fused forward disagrees with its plain version: {err}")
    b1_ms = cuda_ms(lambda: fz.fused_forward(*args, term_eps=eps), 20)
    b1_plain = cuda_ms(lambda: fz.fused_forward_plain(*args), 3)
    Wp, Bias, gamma, beta, te2, dt, o2, d2, mask, wd, coarse = args
    S = mask.shape[1]
    # work this chunk needs: the MLP at its true widths for every sample
    # that survives the span and coarse masks (others contribute nothing)
    res_c_, lo, cell = coarse
    t = te2[:, None] + (torch.arange(S, device=dev) + 0.5)[None, :] * dt[:, None]
    bit = tg.occ_bit(o2[:, None, 0] + t * d2[:, None, 0], o2[:, None, 1] + t * d2[:, None, 1],
                     o2[:, None, 2] + t * d2[:, None, 2], wd, res_c_, lo, cell)
    live_samples = int(((mask > 0) & bit).sum())
    widths = [params[f"trunk.w.{l}"].shape for l in range(len(params) // 2)]
    b1_ops = live_samples * 2 * sum(a * b for a, b in widths)
    b1_bytes = sum(x.numel() * x.element_size() for x in (Wp, Bias, gamma, beta, te2, dt, o2,
                                                          d2, mask, wd)) + B * 6 * 4
    rows.append(dict(
        name="fused_forward", route="cuda", source="tnerf_torch/csrc/fused_forward.cu",
        replaces="tnerf/render/pallas_fused2.py:350", max_abs_err=max(err), ms=b1_ms,
        plain_ms=b1_plain, bound_ms=max(b1_bytes / PEAK_BYTES, b1_ops / PEAK_BF16) * 1e3,
        bound_by="bytes" if b1_bytes / PEAK_BYTES > b1_ops / PEAK_BF16 else "operations",
        library_ms=None))
    log(f"chunk of {B} rays x {S} samples: {live_samples} live samples "
        f"({live_samples / (B * S):.3f}); B1 {b1_ms:.3f} ms (plain {b1_plain:.1f}), "
        f"B3 {b3_ms:.4f} ms (plain {b3_plain:.1f})")
    return rows


def profile_view():
    """Where one 400x400 test view's time goes: device time by kernel
    (torch.profiler) against the host clock of the same render."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.eval import render_dataset_view
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    cfg = Config.from_json_file(CONFIG).apply_overrides(["render.ray_compact=false"])
    ds = load_data("procedural", cfg.scene.name, splits=("test",),
                   proc=scene_proc_kwargs(cfg.scene))["test"]
    _, params, occ = load_jax_checkpoint(CKPT)
    renderer = build_renderer(cfg)
    view = lambda: render_dataset_view(renderer, params, ds, 0, cfg.scene.scene_scale,
                                       cfg.render.chunk_size, occupancy=occ.bitfield)
    view()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        view()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [{"kernel": e.key[:80], "ms": e.self_device_time_total / 1e3, "calls": e.count}
           for e in kernels[:10]]
    result = {"view": "test 0, 400x400", "wall_ms": wall_ms, "device_ms": device_ms,
              "device_busy_share": device_ms / wall_ms, "n_kernels": sum(e.count for e in kernels),
              "top": top}
    with open(os.path.join(OUT, "profile.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    log("profile of one view:", json.dumps(result))
    return result


def main() -> int:
    import torch

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
    from tnerf_torch.grid.tighten import tighten_range
    from tnerf_torch.render.fused import fused_forward

    t0 = time.perf_counter()
    build.build(verbose=True)
    log(f"built {build.LIB_PATH} in {time.perf_counter() - t0:.1f} s\n{build.build.log}")
    build.library()

    rows = check_kernels()

    # Phase 4: the main path, through the entry point a user calls.
    counters = {"tighten_range": tighten_range, "fused_forward": fused_forward}
    for fn in counters.values():
        fn.launches = 0
    metrics_path = os.path.join(OUT, "eval.json")
    t0 = time.perf_counter()
    run_cli(["eval", "--config", CONFIG, "--checkpoint", CKPT, "--override",
             "render.ray_compact=false", "--out", metrics_path,
             "--save-renders", os.path.join(OUT, "renders")])
    eval_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    with open(metrics_path) as fh:
        m = json.load(fh)
    log(f"eval ({eval_s:.1f} s): {json.dumps(m)}; launches {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"the main path did not launch every kernel: {launches}")
    print(f"eval psnr_test {m['psnr_test']:.4f} dB (reference {JAX_PSNR_TEST:.4f}), "
          f"ssim_test {m['ssim_test']:.4f} (reference {JAX_SSIM_TEST:.4f}), "
          f"render_ms_test {m['render_ms_test']:.2f}", flush=True)
    if abs(m["psnr_test"] - JAX_PSNR_TEST) > PSNR_TOL_DB:
        raise AssertionError(f"test PSNR {m['psnr_test']} is not within {PSNR_TOL_DB} dB "
                             f"of the reference's {JAX_PSNR_TEST}")
    views = m["n_views_val"] + m["n_views_test"]
    for r in rows:
        r["launches"] = launches[r["name"]]
        log(f"{r['name']}: {r['launches'] / views:.1f} launches per 400x400 view")
    prof = profile_view()
    print(f"one 400x400 view: {prof['wall_ms']:.2f} ms host clock, {prof['device_ms']:.2f} ms "
          f"device busy ({prof['device_busy_share']:.3f})", flush=True)

    # Phase 5: one 800x800 orbit frame.
    text = run_cli(["render", "--config", CONFIG, "--checkpoint", CKPT, "--orbit", "1",
                    "--out", os.path.join(OUT, "orbit800"), "-o", "render.ray_compact=false",
                    "-o", "scene.proc_width=800", "-o", "scene.proc_height=800"])
    frame = json.loads(text.strip().splitlines()[-1])
    print(f"render 800x800: {frame['ms_per_frame']:.2f} ms/frame", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
