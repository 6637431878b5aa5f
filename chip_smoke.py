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
     and once more at 256 samples per ray (four chunks per ray: the saved
     transmittance and the dL/dT carry);
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
  6. `resume`: the committed reference checkpoint (step 1500, with its Adam
     moments) resumed for 50 steps: the train loss must stay under
     RESUME_LOSS_MAX; then 20 steps under torch.profiler;
  7. `cdf`: `tnerf_torch.cli train` of configs/procedural_hard_fused_cdf2.json
     (occupancy-CDF placement), all 5000 steps at full width: B4, B1t and
     B2t each at least once per step, no step skipped, test PSNR within
     TRAIN_PSNR_MARGIN_DB of the reference's record and over the config's
     gate; `cli eval` of that checkpoint with the config as committed (ray
     compaction on): within 0.1 dB of the run's own uncompacted eval; one
     800x800 orbit frame; 20 CDF train steps under torch.profiler;
  8. print the kernels' JSON line, then the status line.
`--phases kernels,serve,train,resume,cdf` runs a subset (for development;
the kernels' line then lists what ran).  Files go under chiprun_out/
(git-ignored).
"""

import argparse
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
CONFIG_CDF = os.path.join(REPO, "configs", "procedural_hard_fused_cdf2.json")
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
# The reference package's eval of this checkpoint (runs/suite_rehearsal/prims/metrics.jsonl).
JAX_PSNR_TEST, JAX_SSIM_TEST = 34.393025040374724, 0.9663567049469579
PSNR_TOL_DB = 0.1
# The reference's final test PSNR of the CDF config
# (runs/hard_r4_fused_cdf2/metrics.jsonl, last line): quality, not speed.
JAX_CDF_PSNR_TEST = 38.95965774441899
# One view with and without ray compaction: kept rays are the same rows
# through the same kernel and dropped rays are acc = 0 in both, so at
# transmittance_threshold = 0 they agree to rounding; at the config's
# threshold a tile stops once all of its rays are opaque, and compaction
# changes a ray's neighbours in its tile.
COMPACT_ATOL_EPS0, COMPACT_ATOL = 1e-5, 2e-3
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
# The trained model against the reference's record (34.393 dB): the two
# packages draw other batches and other initial weights from the same seed,
# so there is no bit parity; written down before the first run.
TRAIN_PSNR_MARGIN_DB = 1.5
# Train loss of the resumed reference checkpoint: its last logged loss is
# 1.77e-4 (metrics.jsonl, step 1499) on batches of 8192 rays; lost Adam
# moments would send the first updates far off.  Written before the run.
RESUME_LOSS_MAX = 3e-4
RESUME_STEPS = 50
ALL_PHASES = ("kernels", "serve", "train", "resume", "cdf")
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
    from tnerf_torch.grid.tighten import tighten_range, tighten_sample_mask
    from tnerf_torch.render.fused import fused_backward, fused_forward

    return {"tighten_range": (tighten_range, "launches"),
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


def bound_row(name, source, replaces, err, ms, plain_ms, n_bytes, ops, peak_ops):
    by_bytes, by_ops = n_bytes / PEAK_BYTES, ops / peak_ops
    return dict(name=name, route="cuda", source=source, replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes > by_ops else "operations", library_ms=None)


def n_bytes(tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def live_samples(args, placed=None):
    """Samples of a fused-kernel call that survive the span and coarse
    masks: the only ones whose MLP work the result needs."""
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
    return int(((mask > 0) & bit).sum())


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
    inputs; returns (max |err| per column, kernel ms, plain ms)."""
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
    ms = cuda_ms(lambda: fz.fused_forward(*args, term_eps=eps, **placed), 20)
    plain = cuda_ms(lambda: fz.fused_forward_plain(*args, **placed), 3)
    return err, ms, plain


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
    b3_ms = cuda_ms(lambda: tg.tighten_range(o, d, te, tx, words, res_c, cfg.grid), 50)
    b3_plain = cuda_ms(lambda: tg.tighten_range_plain(o, d, te, tx, words, res_c, cfg.grid), 3)
    probe_ops = 256 * 21  # per probe: depth 4, position 6, cell ids 9, min/max 2
    rows.append(bound_row("tighten_range", "tnerf_torch/csrc/tighten.cu",
                          "tnerf/grid/pallas_dda.py:333", 0.0, b3_ms, b3_plain,
                          B * (24 + 8 + 8) + 4 * tg.WORDS, live * probe_ops, PEAK_F32))

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
        b4_ms = cuda_ms(lambda: tg.tighten_sample_mask(o, d, te, tx, model, n, cfg.grid,
                                                       words=wd), 50)
        b4_plain = cuda_ms(lambda: tg.tighten_sample_mask_plain(o, d, te, tx, model, n, cfg.grid,
                                                                words=wd), 3)
        log(f"B4 ({use}): {b4_ms:.4f} ms (plain {b4_plain:.1f})")
    # the row is the CDF use (timed last); per midpoint: depth 3, position 6, cell ids 9, and 1
    rows.append(bound_row("tighten_sample_mask", "tnerf_torch/csrc/tighten.cu",
                          "tnerf/grid/pallas_dda.py:400", 0.0, b4_ms, b4_plain,
                          B * (24 + 8 + 8 + P) + 4 * tg.WORDS, live * (probe_ops + P * 19),
                          PEAK_F32))

    # B1 fused forward on exactly the renderer's kernel inputs.
    eps = cfg.render.transmittance_threshold
    widths = [params[f"trunk.w.{l}"].shape for l in range(len(params) // 2)]
    macs = sum(a * b for a, b in widths)
    args = build_renderer(cfg).kernel_inputs(params, flat, occ.bitfield)
    err, b1_ms, b1_plain = check_forward("B1", args, {}, eps, "uniform placement")
    # work this chunk needs: the MLP at its true widths for every live sample
    n_live = live_samples(args)
    rows.append(bound_row("fused_forward", "tnerf_torch/csrc/fused_forward.cu",
                          "tnerf/render/pallas_fused2.py:350", max(err), b1_ms, b1_plain,
                          n_bytes(args[:10]) + B * 6 * 4, n_live * 2 * macs, PEAK_BF16))

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
    err_t, b1t_ms, b1t_plain = check_forward("B1t", args_t, placed, eps, "CDF placement")
    n_live_t = live_samples(args_t, placed)
    rows.append(bound_row("fused_forward_tmode", "tnerf_torch/csrc/fused_forward.cu",
                          "tnerf/render/pallas_fused2.py:350", max(err_t), b1t_ms, b1t_plain,
                          n_bytes(args_t[:4] + args_t[6:10] + tuple(placed.values())) + B * 6 * 4,
                          n_live_t * 2 * macs, PEAK_BF16))
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


def check_backward():
    """Phase 3, training shape: B2 and B2t (and B1's / B1t's tchk) against
    the plain versions on a batch drawn from the train views; returns the
    two backward rows."""
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
        for S in (cfg.sampler.samples_per_ray, 256):
            c = cfg.apply_overrides([f"sampler.samples_per_ray={S}"] +
                                    (["sampler.placement=occupancy_cdf"] if tmode else []))
            inputs = build_renderer(c, for_eval=False).kernel_inputs(
                params, batch.rays, occ.bitfield, gen if tmode else None)
            args, placed = (tuple(inputs[:11]), inputs[11]) if tmode else (inputs, {})
            out_k, tchk = fz.fused_forward(*args, term_eps=0.0, return_tchk=True, **placed)
            out_p, tchk_p = fz.fused_forward_plain(*args, return_tchk=True, **placed)
            dW_k, dB_k = fz.fused_backward(*args, tchk, gout, term_eps=0.0, **placed)
            dW_p, dB_p = fz.fused_backward_plain(*args, tchk, gout, **placed)
            torch.cuda.synchronize()
            err_out = float((out_k - out_p).abs()[:, [0, 1, 2, 3, 5]].max())
            err_t = float((tchk - tchk_p).abs().max())
            if not (err_out <= B1_ATOL and err_t <= B1_ATOL):
                raise AssertionError(f"{tag} forward at the training shape (S={S}): out "
                                     f"{err_out}, tchk {err_t}")
            rel = {}
            for name, k, p in (("dW", dW_k, dW_p), ("dBias", dB_k, dB_p)):
                if not torch.isfinite(k).all():
                    raise AssertionError(f"{tag} backward (S={S}): non-finite {name}")
                rel[name] = float((k - p).abs().max() / p.abs().max())
            per_layer = [float((dW_k[l] - dW_p[l]).abs().max()
                               / dW_p[l].abs().max().clamp_min(1e-30))
                         for l in range(dW_p.shape[0])]
            log(f"{tag} S={S}: max |kernel - plain| / max |plain|: {rel}; per layer dW "
                f"{per_layer}; tchk [B, {tchk.shape[1]}] err {err_t:.2e}, out err {err_out:.2e}")
            if max(rel.values()) > B2_RTOL:
                raise AssertionError(f"{tag} backward disagrees with its plain version at S={S}: "
                                     f"{rel}")
            if S != cfg.sampler.samples_per_ray:
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
                continue
            # times and bound at the training shape
            b2_ms = cuda_ms(lambda: fz.fused_backward(*args, tchk, gout, term_eps=eps, **placed),
                            10)
            b2_plain = cuda_ms(lambda: fz.fused_backward_plain(*args, tchk, gout, **placed), 2)
            b1_ms = cuda_ms(lambda: fz.fused_forward(*args, term_eps=eps, return_tchk=True,
                                                     **placed), 20)
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
                            PEAK_BF16)
            rows.append(row)
            b1_bound = max((n_bytes(read + (tchk,)) + B * 6 * 4) / PEAK_BYTES,
                           live * 2 * macs / PEAK_BF16) * 1e3
            # run-to-run reproducibility of the atomic sums
            again = fz.fused_backward(*args, tchk, gout, term_eps=0.0, **placed)[0]
            log(f"{tag}: training batch of {B} rays x {S} samples: {live} live samples "
                f"({live / (B * S):.3f}); backward {b2_ms:.3f} ms (plain {b2_plain:.1f}, bound "
                f"{row['bound_ms']:.4f} by {row['bound_by']}), forward with tchk {b1_ms:.3f} ms "
                f"(plain {b1_plain:.1f}, bound {b1_bound:.4f}); two backward runs bit-equal: "
                f"{bool(torch.equal(again, dW_k))}, max |diff| "
                f"{float((again - dW_k).abs().max()):.3e}")
            print(f"train shape {B}x{S}, {'CDF' if tmode else 'uniform'} placement: live share "
                  f"{live / (B * S):.4f}, {row['name']} {b2_ms:.4f} ms, forward+tchk "
                  f"{b1_ms:.4f} ms (bound {b1_bound:.4f})", flush=True)
    return rows


def last_window(metrics_path):
    """(last record with a loss, every logged loss, final eval metrics) of a metrics.jsonl."""
    recs = [json.loads(line) for line in open(metrics_path)]
    logged = [r for r in recs if "loss" in r]
    final = {}
    for r in recs:
        if "psnr_test" in r or "psnr_val" in r:
            final.update(r)
    return logged[-1], [r["loss"] for r in logged], final


def train_from_scratch(config, out_name, steps, per_step, reference_psnr):
    """A training run through the entry point, all `steps` steps of
    `config`: every kernel named in per_step at least once per step, no
    step skipped, test PSNR within TRAIN_PSNR_MARGIN_DB of the reference's.
    Returns (launch counts, final metrics, output directory)."""
    import shutil

    out_dir = os.path.join(OUT, out_name)
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    text, launches = counted(lambda: run_cli(["train", "--config", config, "--out", out_dir]))
    train_s = time.perf_counter() - t0
    final = json.loads(text)
    last, losses, _ = last_window(os.path.join(out_dir, "metrics.jsonl"))
    log(f"{out_name} ({train_s:.1f} s): {json.dumps(final)}; last window {json.dumps(last)}; "
        f"launches {launches}")
    if min(launches[k] for k in per_step) < steps:
        raise AssertionError(f"{out_name}: not every kernel of {per_step} launched once per "
                             f"step: {launches}")
    if last["step"] != steps - 1 or last.get("skipped_steps", 0) > 0:
        raise AssertionError(f"{out_name}: training ended at {last}")
    print(f"{out_name} {steps} steps: psnr_test {final['psnr_test']:.4f} dB (reference "
          f"{reference_psnr:.4f}, worst view {final['psnr_test_min']:.4f}), ssim_test "
          f"{final['ssim_test']:.4f}, last window {last['step_seconds'] * 1e3:.3f} ms/step, "
          f"{last['rays_per_sec']:.0f} rays/s, loss {last['loss']:.3e}, whole run {train_s:.1f} s",
          flush=True)
    if abs(final["psnr_test"] - reference_psnr) > TRAIN_PSNR_MARGIN_DB:
        raise AssertionError(f"{out_name}: trained test PSNR {final['psnr_test']} is not within "
                             f"{TRAIN_PSNR_MARGIN_DB} dB of the reference's {reference_psnr}")
    return launches, final, out_dir


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


def profile_train_steps(config, ckpt_dir, tag, n_steps=20):
    """Where a train step's time goes, late in training (the weights,
    moments and occupancy of the checkpoint in ckpt_dir): device time by
    kernel (torch.profiler) against the host clock of the same steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.fields.nerf_field import NeRFField
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
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0)).to(dev)
    field.load_state_dict(params)
    state = init_train_state(field, cfg.train)
    state.optimizer.load_state(opt_state)
    step_fn = make_train_step(build_renderer(cfg, for_eval=False))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    run = lambda n: [step_fn(state, sampler.sample(gen, cfg.train.batch_size), occ.bitfield, gen)
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
    with open(os.path.join(OUT, f"profile_{tag}.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    log(f"profile of {tag} steps:", json.dumps(result))
    print(f"{tag} step, late in training: {plain_ms:.3f} ms host clock per step "
          f"({wall_ms / n_steps:.3f} under the profiler), {device_ms / n_steps:.3f} ms device busy "
          f"({result['device_busy_share']:.3f}), {result['kernels_per_step']:.0f} launches",
          flush=True)
    return result


def prims_view_renderer(overrides=()):
    """(view() -> rgb [H, W, 3] numpy of test view 0 of the prims model, cfg)
    under the committed config with `overrides`."""
    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.eval import render_dataset_view
    from tnerf_torch.train_loop import build_renderer
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    cfg = Config.from_json_file(CONFIG).apply_overrides(list(overrides))
    ds = load_data("procedural", cfg.scene.name, splits=("test",),
                   proc=scene_proc_kwargs(cfg.scene))["test"]
    _, params, occ = load_jax_checkpoint(CKPT)
    renderer = build_renderer(cfg)
    return (lambda: render_dataset_view(renderer, params, ds, 0, cfg.scene.scene_scale,
                                        cfg.render.chunk_size, occupancy=occ.bitfield)), cfg


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


def serve_prims():
    """Phase 4: the serving path, through the entry point a user calls,
    with the config as committed (ray compaction on)."""
    from tnerf_torch.cameras import camera_rays
    from tnerf_torch.cli import _ray_compact_guard, ray_keep_fraction
    from tnerf_torch.config import Config
    from tnerf_torch.data.dataset import load_data, scene_proc_kwargs
    from tnerf_torch.utils.checkpoint import load_jax_checkpoint

    m, served, _ = eval_cli(CONFIG, CKPT, "eval")
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
    """Phase 7: occupancy-CDF placement, trained and then served with ray
    compaction, through the entry points."""
    from tnerf_torch.config import Config

    cfg = Config.from_json_file(CONFIG_CDF)
    launches, final, out_dir = train_from_scratch(
        CONFIG_CDF, "train_cdf", cfg.train.steps,
        ("tighten_sample_mask", "fused_forward_tmode", "fused_backward_tmode"),
        JAX_CDF_PSNR_TEST)
    if final["psnr_test_min"] < cfg.train.assert_test_psnr_min:
        raise AssertionError(f"worst test view {final['psnr_test_min']} dB is under the config's "
                             f"gate {cfg.train.assert_test_psnr_min}")
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


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help=f"comma list of {', '.join(ALL_PHASES)} (default: all)")
    phases = set(ap.parse_args().phases.split(","))
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

    rows = {}
    if "kernels" in phases:
        for r in check_kernels() + check_backward():
            rows[r["name"]] = r
    launches = {k: 0 for k in kernel_counters()}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    if "serve" in phases:
        add(serve_prims())
    if "train" in phases:
        add(train_from_scratch(CONFIG, "train", 1500,
                               ("tighten_range", "fused_forward", "fused_backward"),
                               JAX_PSNR_TEST)[0])
    if "resume" in phases:
        add(resume_reference_checkpoint())
        profile_train_steps(CONFIG, CKPT, "train")
    if "cdf" in phases:
        add(train_and_serve_cdf())

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for name, r in rows.items():
        r["launches"] = launches[name]
    if phases >= set(ALL_PHASES) and (len(rows) != 6
                                      or min(r["launches"] for r in rows.values()) < 1):
        raise AssertionError(f"a kernel of the main paths was not launched: {launches}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
