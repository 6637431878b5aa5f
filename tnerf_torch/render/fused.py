"""Fused frequency-MLP renderer (kernels B1 and B2) and its glue.

Replaces the TPU kernels `tnerf/render/pallas_fused2.py:_fwd_kernel`
(:350) and `_bwd_kernel` (:438), both with uniform and with per-sample
placement (their `tmode`), the custom VJP that joins them
(`make_fused_trainable`, :582) and `make_fused_pipeline_renderer_v2`
(:922-1243): uniform and occupancy-CDF placement, each with and without
ray compaction.

`fused_forward` / `fused_backward` take their plain PyTorch versions for
CPU tensors and launch the CUDA kernels (`tnerf_torch/csrc/
fused_forward.cu`, `fused_backward.cu`) for CUDA tensors; there is no
fallback between the two.  `fused_render` is the differentiable call: a
`torch.autograd.Function` whose forward is `fused_forward` (saving the
per-chunk entry transmittance) and whose backward is `fused_backward`,
with gradients onto the packed (W, Bias) only, as on the TPU.  The plain
forward is the torch mirror of `fused_reference_v2` (:803) plus the
kernel's in-kernel coarse occupancy test (`_coarse_mask`, :256): bf16
operands with f32 products and sums, f32 activations and compositing;
the plain backward writes the backward kernel out step by step.

The TPU kernel's `rpc` packs rays into 128-lane rows; each ray's samples
are contiguous here, so `render.fused_rpc` changes nothing and is not
read (rpc=1 and rpc=2 give the same quadrature in the reference too).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tnerf_torch.cameras import Rays
from tnerf_torch.device import full_f32_matmul
from tnerf_torch.grid.tighten import (
    WORDS,
    coarse_constants,
    occ_bit,
    pack_words_rows,
    tighten_range,
    tighten_sample_mask,
)
from tnerf_torch.grid.traversal import make_coarse_occupancy, ray_aabb, reciprocal
from tnerf_torch.kernels import build
from tnerf_torch.render.composite import RenderResult
from tnerf_torch.render.fused_common import (
    LANES,
    _encoding_matrices,
    _feature_permutation,
    _norm_affine,
    compact_rows,
    scatter_back,
)
from tnerf_torch.sampling import cdf_ray_samples
from tnerf_torch.utils.checkpoint import n_layers


def pack_params_f32(params, field_cfg, s_aff, b_aff):
    """[NL, 128, 128] f32 weights + [NL, 128] f32 biases in kernel feature
    order, with the input-normalization affine folded into layer 0
    (`pallas_fused2.pack_params_f32`, :73).  params: the flat
    {"trunk.w.<l>", "trunk.b.<l>"} dict of `params_from_jax`."""
    perm = _feature_permutation(field_cfg)
    W_layers, B_layers = [], []
    for l in range(n_layers(params)):
        w, b = params[f"trunk.w.{l}"].float(), params[f"trunk.b.{l}"].float()
        dev = w.device
        wi, wo = w.shape
        if wi > LANES or wo > LANES:
            raise ValueError(f"fused kernel supports layer dims <= {LANES}; got {tuple(w.shape)}")
        if l == 0:
            if wi != len(perm):
                raise ValueError(f"layer-0 in_dim {wi} != encoded width {len(perm)}")
            w = w[torch.as_tensor(perm, device=dev)]
            ident = w[0:5]
            b = b + torch.as_tensor(b_aff, device=dev) @ ident
            w = torch.cat([torch.as_tensor(s_aff, device=dev)[:, None] * ident, w[5:]])
        Wp = torch.zeros((LANES, LANES), dtype=torch.float32, device=dev)
        Wp[:wi, :wo] = w
        Bp = torch.zeros((LANES,), dtype=torch.float32, device=dev)
        Bp[:wo] = b
        W_layers.append(Wp)
        B_layers.append(Bp)
    return torch.stack(W_layers), torch.stack(B_layers)


def encode_gamma_beta(origins, directions, viewdirs_tp, t_enter, dt, A, C):
    """Per-ray (gamma, beta) [B, 128] with feature_f(s) = act_f(gamma_f +
    (s + 0.5) beta_f) (`pallas_fused2.encode_gamma_beta`, :103).

    The [5 -> 123] frequency map has one nonzero per column, so it is
    written as a broadcast-and-sum in f32: the same value as the
    reference's HIGHEST-precision product, with no TF32 on the card."""
    dev = origins.device
    e = origins + t_enter[:, None] * directions
    f = dt[:, None] * directions
    g5 = torch.cat([e, viewdirs_tp], dim=1)
    b5 = torch.cat([f, torch.zeros_like(viewdirs_tp)], dim=1)
    A5 = torch.as_tensor(A[0:5, :], device=dev)
    C0 = torch.as_tensor(C[0:1, :], device=dev)
    gamma = torch.cat([g5, (g5[:, :, None] * A5).sum(dim=1) + C0], dim=1)
    beta = torch.cat([b5, (b5[:, :, None] * A5).sum(dim=1)], dim=1)
    return gamma.contiguous(), beta.contiguous()


def select_bin_pool_res(res: int) -> int:
    """The pooling resolution of the CDF path's tighten and bin probes: the
    largest divisor of res not above 32, whatever render.fused_coarse_res
    is (`:880`)."""
    return next(c for c in range(min(32, res), 0, -1) if res % c == 0)


def select_coarse_res(render_cfg, res: int) -> int:
    """The in-kernel coarse bitfield resolution: the largest divisor of
    res not above min(render.fused_coarse_res, res, 32) (`:888`)."""
    want_c = min(render_cfg.fused_coarse_res, res)
    if want_c > 32:
        raise ValueError(
            f"render.fused_coarse_res={want_c}: the 1024-word bitfield holds at most 32^3 bits"
        )
    if want_c < 1:
        raise ValueError(f"render.fused_coarse_res={want_c} must be >= 1")
    return next(c for c in range(want_c, 0, -1) if res % c == 0)


def pack_occupancy_words(occupancy, res: int, res_c: int):
    """Max-pool a [res]^3 occupancy to res_c^3 and pack it into the flat
    int32 [1024] bitfield (`:904`)."""
    if res % res_c != 0:
        raise ValueError(
            f"grid resolution {res} must be a multiple of the coarse resolution {res_c}"
        )
    return pack_words_rows(make_coarse_occupancy(occupancy.reshape(res, res, res), res // res_c))


# Rows of the fused kernels' tile (`kBwdRows` in csrc/fused.cuh): the
# forward saves each ray's transmittance at every BWD_CHUNK-th sample.
BWD_CHUNK = 64
# Samples per ray over which the kernels' skip rule reads the entry
# transmittance (`kFwdRows` in csrc/fused_forward.cu and fused_backward.cu).
SKIP_CHUNK = 128
# Warpgroups of the forward kernel, and the tiles each holds at once
# (`kGroups`, `kPair` in csrc/fused_forward.cu).
FWD_GROUPS = 2
FWD_TILES_PER_GROUP = 2
# Layers whose every input the backward kernel keeps in shared memory: 227 KB
# less 94 KB of fixed buffers (two-slot weight ring, gradient tile, biases,
# coarse words, per-row scalars), over 16 KB per layer input of a tile
# (csrc/fused_backward.cu's header).  A deeper model keeps its last
# MAX_BWD_LAYERS - 1 inputs there and spills the earlier ones to a scratch
# in device memory (`bwd_spill_shape`).
MAX_BWD_LAYERS = 9


def n_bwd_chunks(S: int) -> int:
    return -(-S // min(S, BWD_CHUNK))


def bwd_tiles(B: int, S: int) -> tuple[int, int]:
    """(tiles, rays per tile) of the backward kernel: a tile is BWD_CHUNK
    rows, one chunk of min(S, BWD_CHUNK) samples of each of its rays."""
    R = BWD_CHUNK // min(S, BWD_CHUNK)
    return -(-B // R), R


def _persistent_grid(n_tiles: int, max_active: int, what: str) -> int:
    if max_active < 1:
        raise ValueError(f"{what}: the card holds no CTA of the kernel")
    return max(1, min(max_active, n_tiles))


def bwd_grid(n_tiles: int, max_active: int) -> int:
    """CTAs of the backward kernel's persistent grid: as many as the card
    holds at once (`max_active`, the occupancy query's answer: one per SM),
    and no more than there are tiles."""
    return _persistent_grid(n_tiles, max_active, "fused_backward")


def fwd_grid(n_tiles: int, max_active: int) -> int:
    """CTAs of the forward kernel's persistent grid, sized as `bwd_grid`'s."""
    return _persistent_grid(n_tiles, max_active, "fused_forward")


def bwd_spill_shape(NL: int, n_ctas: int):
    """Shape of the backward kernel's scratch of spilled layer inputs: one
    bf16 [BWD_CHUNK, 128] tile per CTA of the persistent grid and per layer
    input beyond what shared memory keeps (inputs 1 .. NL - MAX_BWD_LAYERS),
    or None where every input stays resident."""
    n_spilled = NL - MAX_BWD_LAYERS
    return (n_ctas, n_spilled, BWD_CHUNK, LANES) if n_spilled > 0 else None


# The backward kernel sums dW and dBias across its CTAs in 64-bit fixed
# point: each (tile, chunk)'s f32 partial is rounded once to a multiple of
# 2^-GRAD_SHIFT and added as an integer, so the sums do not depend on the
# order of the adds, the grid size or the schedule, and repeat bit for bit
# as the reference's sequential grid does (csrc/fused_backward.cu's
# header).  The quantum 2^-40 = 9.1e-13 is 1e-4 of Adam's eps; a sum may
# reach 2^23 = 8.4e6, over 2^25 times the largest the first 100 steps of
# the prims, CDF and 13-layer runs gave (0.196; tools/torch_grad_range.py,
# PERF.md), and a tile's partial stayed under 7.3e-5 against the flag's
# bound of 512 at the training batch.
GRAD_SHIFT = 40


def bwd_grad_limit(B: int, S: int) -> float:
    """The bound on one partial, in quanta of 2^-GRAD_SHIFT, past which the
    backward kernel sets its flag: 2^62 over the launch's count of (tile,
    chunk) pairs, each of which adds at most one partial to a sum, rounded
    up to a power of two; so no int64 sum can wrap."""
    n_terms = bwd_tiles(B, S)[0] * n_bwd_chunks(S)
    return float(2 ** (62 - (n_terms - 1).bit_length()))


def bwd_grad_sums(NL: int, device):
    """The zeroed int64 buffer one backward launch sums into (one fill), and
    its views: (buffer, qW [NL, 128, 128], qB [NL, 128], flag), the flag
    being the low half of the last word read as float32: 0.0 until the
    kernel sets it to a quiet NaN's bits."""
    n_w, n_b = NL * LANES * LANES, NL * LANES
    buf = torch.zeros(n_w + n_b + 1, dtype=torch.int64, device=device)
    return (buf, buf[:n_w].view(NL, LANES, LANES), buf[n_w:n_w + n_b].view(NL, LANES),
            buf[n_w + n_b:].view(torch.float32)[:1])


def quantize_grad(x, shift: int = GRAD_SHIFT):
    """The backward kernel's rounding of an f32 partial to fixed point, in
    plain PyTorch: x 2^shift (exact) rounded half to even (as
    `__float2ll_rn`), int64."""
    return torch.round(x * 2.0 ** shift).to(torch.int64)


def dequantize_grad(q, flag, shift: int = GRAD_SHIFT):
    """The f32 gradient of int64 fixed-point sums q in units of 2^-shift:
    each sum rounded once to f32 (the integer's conversion is correctly
    rounded and the power-of-two scale exact, so this is the exact sum
    rounded once), and every entry NaN where `flag` (float32, 0.0 or NaN)
    is set, so that the optimizer's skip_nonfinite skips the step.  One
    elementwise op: flag + 2^-shift q."""
    return torch.add(flag, q, alpha=2.0 ** -shift)


def bwd_schedule(B: int, S: int, n_ctas: int) -> list[list[tuple[int, int]]]:
    """What the backward kernel's persistent grid does, in order: for CTA
    k, the (ray, chunk) pairs it shades.  CTA k takes tiles k, k + n_ctas,
    ...; a tile walks its chunks last first, all its rays in step, and
    each chunk through every layer's weight tile in turn."""
    n_tiles, R = bwd_tiles(B, S)
    n_chunks = n_bwd_chunks(S)
    plan = [[] for _ in range(n_ctas)]
    for k in range(n_ctas):
        for tile in range(k, n_tiles, n_ctas):
            rays = range(tile * R, min(B, (tile + 1) * R))
            plan[k] += [(ray, c) for c in reversed(range(n_chunks)) for ray in rays]
    return plan


def fwd_schedule(B: int, S: int, n_ctas: int) -> list[list[list[tuple[int, int]]]]:
    """What the forward kernel's persistent grid does, in order: for CTA k
    and warpgroup g, the (ray, chunk) pairs it shades.  CTA k takes tiles
    k, k + n_ctas, ... (the tiles of `bwd_tiles`) in rounds of FWD_GROUPS x
    FWD_TILES_PER_GROUP, its i-th tile going to warpgroup (i %
    (FWD_GROUPS FWD_TILES_PER_GROUP)) // FWD_TILES_PER_GROUP; a warpgroup
    walks its tiles' chunks first to last, the tiles of a round in step,
    carrying their rays' transmittance."""
    n_tiles, R = bwd_tiles(B, S)
    n_chunks = n_bwd_chunks(S)
    per_round = FWD_GROUPS * FWD_TILES_PER_GROUP
    plan = [[[] for _ in range(FWD_GROUPS)] for _ in range(n_ctas)]
    for k in range(n_ctas):
        mine = list(range(k, n_tiles, n_ctas))
        for r0 in range(0, len(mine), per_round):
            for g in range(FWD_GROUPS):
                tiles = mine[r0 + g * FWD_TILES_PER_GROUP:r0 + (g + 1) * FWD_TILES_PER_GROUP]
                rays = [ray for t in tiles for ray in range(t * R, min(B, (t + 1) * R))]
                plan[k][g] += [(ray, c) for c in range(n_chunks) for ray in rays]
    return plan


def unshaded_chunks(live, tchk, term_eps: float):
    """[B, n_bwd_chunks(S)] bool: the (ray, chunk) pairs the forward kernel
    leaves unshaded, in its own terms.  live [B, S] bool: the samples that
    survive the span and coarse masks; tchk: the forward's entry
    transmittance per chunk.  Walking a tile's chunks first to last, the
    kernel keeps the transmittance at which each ray entered the current
    SKIP_CHUNK-sample chunk, and leaves a chunk unshaded when none of the
    tile's samples in it is live, or when every ray of the tile had entered
    at or below term_eps.  Every ray of a tile shares its tile's decision."""
    B, S = live.shape
    n_tiles, R = bwd_tiles(B, S)
    ch, fch = min(S, BWD_CHUNK), min(S, SKIP_CHUNK)
    pad = n_tiles * R - B
    out = torch.zeros((B, n_bwd_chunks(S)), dtype=torch.bool, device=live.device)
    t_entry = None
    for c in range(n_bwd_chunks(S)):
        if (c * ch) % fch == 0:
            t_entry = tchk[:, c]
        any_live = torch.nn.functional.pad(live[:, c * ch:(c + 1) * ch].any(dim=1), (0, pad))
        above = torch.nn.functional.pad(t_entry > term_eps, (0, pad))
        shade = any_live.reshape(n_tiles, R).any(dim=1) & above.reshape(n_tiles, R).any(dim=1)
        out[:, c] = ~shade.repeat_interleave(R)[:B]
    return out


def _chunk_forward(Wb, Bias, gamma, beta, te, dt, o, d, mask, words, coarse, s0: int, s1: int,
                   ts=None, dts=None):
    """Samples s0..s1-1 of every ray through the encoding, the MLP and the
    head activations: (acts, rgb, sig, t, m, tau, step), acts[l] being
    layer l's bf16 input [B * n, 128] and step the quadrature step [B, n]
    or [B, 1].  Wb: the bf16-rounded weights as f32."""
    B = gamma.shape[0]
    NL = Wb.shape[0]
    dev = gamma.device
    if ts is None:
        s = torch.arange(s0, s1, dtype=torch.float32, device=dev) + 0.5
        I = gamma[:, None, :] + s[None, :, None] * beta[:, None, :]
        t = te[:, None] + s[None, :] * dt[:, None]
        step = dt[:, None]
    else:
        t, step = ts[:, s0:s1], dts[:, s0:s1]
        I = gamma[:, None, :] + t[:, :, None] * beta[:, None, :]
    lane = torch.arange(LANES, device=dev)
    E = torch.where(lane < 5, I, torch.sin(I))
    acts = [E.reshape(B * (s1 - s0), LANES).to(torch.bfloat16)]
    for l in range(NL - 1):
        acts.append(torch.relu(acts[l].float() @ Wb[l] + Bias[l][None, :]).to(torch.bfloat16))
    hL = (acts[NL - 1].float() @ Wb[NL - 1] + Bias[NL - 1][None, :]).reshape(B, s1 - s0, LANES)
    rgb = torch.sigmoid(hL[..., 0:3])
    x = hL[..., 3] - 1.0
    sig = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))  # jax.nn.softplus
    m = mask[:, s0:s1].float()
    if coarse is not None:
        bit = occ_bit(o[:, None, 0] + t * d[:, None, 0], o[:, None, 1] + t * d[:, None, 1],
                      o[:, None, 2] + t * d[:, None, 2], words, *coarse)
        m = m * bit.float()
    tau = sig * step * m
    return acts, rgb, sig, t, m, tau, step


def fused_forward_plain(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse,
                        return_tchk: bool = False, ts=None, dts=None):
    """The plain PyTorch version of `fused_forward` (any device;
    differentiable in W and Bias): the torch mirror of `fused_reference_v2`
    (:803) and, with ts / dts, of `fused_reference_v2_t` (:841).

    bf16 operands are rounded, then upcast and multiplied in f32: a bf16
    matmul would round its sums to bf16, and the reference accumulates in
    f32 (preferred_element_type=f32).  On the card this needs full-f32
    matrix products, so TF32 is held off while it runs."""
    S = mask.shape[1]
    with full_f32_matmul():
        _, rgb, _, t, _, tau, _ = _chunk_forward(W.to(torch.bfloat16).float(), Bias, gamma, beta,
                                                 te, dt, o, d, mask, words, coarse, 0, S, ts, dts)
    excl = torch.cumsum(tau, dim=1) - tau
    w = torch.exp(-excl) * (1.0 - torch.exp(-tau))
    out = torch.cat([
        torch.sum(w[..., None] * rgb, dim=1),
        torch.sum(w, dim=1, keepdim=True),
        torch.sum(w * t, dim=1, keepdim=True),
        torch.exp(-torch.sum(tau, dim=1, keepdim=True)),
    ], dim=1)
    if return_tchk:
        return out, torch.exp(-excl[:, ::min(S, BWD_CHUNK)]).detach().contiguous()
    return out


@torch.no_grad()
def fused_backward_plain(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse, tchk, gout,
                         ts=None, dts=None):
    """The plain PyTorch version of `fused_backward` (any device), written
    out step by step as the kernel does it (`_bwd_kernel`, :438-570):
    chunks of BWD_CHUNK samples, last first, each recomputed from its
    saved entry transmittance tchk[:, c]; the exact compositing VJP with
    the running dL/dT carry; the MLP backward with the gradient rounded to
    bf16 at every layer and f32 sums.  No chunk is skipped.  Returns
    (dW [NL, 128, 128], dBias [NL, 128]) f32."""
    NL = W.shape[0]
    dW = torch.zeros((NL, LANES, LANES), dtype=torch.float32, device=W.device)
    dB = torch.zeros((NL, LANES), dtype=torch.float32, device=W.device)
    with full_f32_matmul():
        for l, a_in, gb in backward_terms(W, Bias, gamma, beta, te, dt, o, d, mask, words,
                                          coarse, tchk, gout, ts, dts):
            dW[l] += a_in.T @ gb
            dB[l] += gb.sum(dim=0)
    return dW, dB


def backward_terms(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse, tchk, gout,
                   ts=None, dts=None):
    """What `fused_backward_plain` sums, in its order: for each chunk of
    BWD_CHUNK samples, last first, and each layer l, last first, (l, a_in,
    gb): layer l's bf16 input and the bf16 gradient at its output,
    both as f32 [B * chunk samples, 128], rows ray-major, so that dW[l] +=
    a_in^T gb and dBias[l] += the column sums of gb.  Run it where full-f32
    matrix products are on (`full_f32_matmul`)."""
    B, S = mask.shape
    NL = W.shape[0]
    Wb = W.to(torch.bfloat16).float()
    ch = min(S, BWD_CHUNK)
    gT = gout[:, 5].clone()
    for c in reversed(range(n_bwd_chunks(S))):
        s0, s1 = c * ch, min(S, (c + 1) * ch)
        acts, rgb, sig, t, m, tau, step = _chunk_forward(
            Wb, Bias, gamma, beta, te, dt, o, d, mask, words, coarse, s0, s1, ts, dts)
        T0 = tchk[:, c:c + 1]
        E = torch.exp(-(torch.cumsum(tau, dim=1) - tau))
        emt = torch.exp(-tau)
        F = 1.0 - emt
        w = T0 * E * F
        Texp = torch.exp(-torch.sum(tau, dim=1, keepdim=True))
        dw = torch.sum(gout[:, None, 0:3] * rgb, dim=-1) + gout[:, 3:4] + gout[:, 4:5] * t
        G = dw * w
        suffix = torch.flip(torch.cumsum(torch.flip(G, [1]), dim=1), [1]) - G
        dtau = -suffix + dw * (T0 * E * emt) - gT[:, None] * (T0 * Texp)
        dsig = dtau * step * m
        g = torch.zeros((B, s1 - s0, LANES), dtype=torch.float32, device=W.device)
        g[..., 0:3] = (w[..., None] * gout[:, None, 0:3]) * rgb * (1.0 - rgb)
        g[..., 3] = dsig * (1.0 - torch.exp(-sig))  # softplus' = 1 - exp(-softplus)
        gT = torch.sum(dw * E * F, dim=1) + gT * Texp[:, 0]
        g = g.reshape(B * (s1 - s0), LANES)
        for l in range(NL - 1, -1, -1):
            gb = g.to(torch.bfloat16).float()
            a_in = acts[l].float()
            yield l, a_in, gb
            if l > 0:
                g = (gb @ Wb[l].T) * (a_in > 0)


def _check_fused_inputs(what, W, Bias, gamma, beta, te, dt, o, d, mask, words, ts, dts):
    dev = gamma.device
    B, S = mask.shape
    NL = W.shape[0]
    f32 = torch.float32
    # f32, or the bf16 copy the kernels read (rounded once per train step)
    build.check_tensor("W", W, (NL, LANES, LANES),
                       torch.bfloat16 if W.dtype == torch.bfloat16 else f32, dev)
    build.check_tensor("Bias", Bias, (NL, LANES), f32, dev)
    for name, t in (("gamma", gamma), ("beta", beta)):
        build.check_tensor(name, t, (B, LANES), f32, dev)
    for name, t in (("te", te), ("dt", dt)):
        build.check_tensor(name, t, (B,), f32, dev)
    for name, t in (("o", o), ("d", d)):
        build.check_tensor(name, t, (B, 3), f32, dev)
    build.check_tensor("mask", mask, (B, S), f32, dev)
    if (ts is None) != (dts is None):
        raise ValueError(f"{what}: ts and dts go together")
    if ts is not None:
        build.check_tensor("ts", ts, (B, S), f32, dev)
        build.check_tensor("dts", dts, (B, S), f32, dev)
    build.check_tensor("words", words, (WORDS,), torch.int32, dev)
    if S < 1 or NL < 1:
        raise ValueError(f"{what}: need S >= 1 and at least one layer, got S={S}, NL={NL}")


def _coarse_args(coarse):
    """(use_coarse, res_c, lo xyz, 1 / cell xyz) as the launch functions take them:
    the kernels multiply by the reciprocal of the cell size, as the
    reference's XLA computes its division by it."""
    res_c, lo, cell_c = coarse if coarse is not None else (1, np.zeros(3, np.float32),
                                                            np.ones(3, np.float32))
    rcp = np.float32(1.0) / np.asarray(cell_c, np.float32)
    fl = lambda v: float(np.float32(v))
    return (int(coarse is not None), res_c, fl(lo[0]), fl(lo[1]), fl(lo[2]),
            fl(rcp[0]), fl(rcp[1]), fl(rcp[2]))


def _weights_bf16(W):
    """The bf16 weights both kernels read, in-major [NL, k, n] as W: W
    itself where the caller rounded it already."""
    return W if W.dtype == torch.bfloat16 else W.to(torch.bfloat16).contiguous()


def _shaded_arg(shaded, B: int, S: int, dev):
    """The `shaded` output's pointer (null if not wanted), after checking it."""
    if shaded is None:
        return None
    build.check_tensor("shaded", shaded, (B, n_bwd_chunks(S)), torch.uint8, dev)
    return shaded.data_ptr()


def _placement_ptrs(te, dt, ts, dts):
    """The two placement pointers of a launch: (te, dt) per ray, or (ts,
    dts) per sample, which the per-sample instantiation reads instead."""
    return (te.data_ptr(), dt.data_ptr()) if ts is None else (ts.data_ptr(), dts.data_ptr())


def fused_forward(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse, term_eps: float = 0.0,
                  return_tchk: bool = False, ts=None, dts=None, shaded=None):
    """Encode + MLP + composite every ray's S samples.

    W [NL, 128, 128] f32 (rounded to bf16 here) or already bf16, Bias [NL,
    128] f32, gamma / beta [B, 128] f32, te / dt [B] f32, o / d [B, 3] f32,
    mask [B, S] f32, words int32 [1024], coarse = (res_c, lo, cell_c) from
    `coarse_constants` or None (no occupancy test).  Uniform placement:
    sample s sits at te + (s + 0.5) dt with step dt, (gamma, beta) folded
    at (te, dt).  Per-sample placement (ts, dts [B, S] f32 given): depth
    ts and step dts, feature = act(gamma + ts beta) with (gamma, beta)
    folded at (0, 1); te and dt are not read.  Returns [B, 6] f32: rgb (no
    background), acc, depth = sum w t, T_final; with return_tchk also tchk
    [B, n_bwd_chunks(S)] f32, the transmittance at which each ray enters
    every BWD_CHUNK-th sample (what `fused_backward` restarts its chunks
    from).  `shaded`, a uint8 [B, n_bwd_chunks(S)] tensor, receives 1
    where a ray's chunk was shaded and 0 where the skip rule dropped it.

    CPU tensors take the plain version (term_eps does not apply there: it
    shades every chunk); CUDA tensors launch the B1 kernel (its per-sample
    instantiation with ts / dts) on a persistent grid (`fwd_schedule`),
    which leaves a tile's chunk unshaded by the rule of `unshaded_chunks`."""
    B, S = mask.shape
    if gamma.device.type == "cpu":
        if shaded is not None:
            shaded.fill_(1)
        return fused_forward_plain(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse,
                                   return_tchk=return_tchk, ts=ts, dts=dts)
    if gamma.device.type != "cuda":
        raise ValueError(f"fused_forward: unsupported device {gamma.device}")
    _check_fused_inputs("fused_forward", W, Bias, gamma, beta, te, dt, o, d, mask, words, ts, dts)
    dev = gamma.device
    shaded_ptr = _shaded_arg(shaded, B, S, dev)
    out = torch.empty((B, 6), dtype=torch.float32, device=dev)
    tchk = torch.empty((B, n_bwd_chunks(S)), dtype=torch.float32, device=dev) \
        if return_tchk else None
    if B > 0:
        Wk = _weights_bf16(W)
        lib = build.library()
        tmode = ts is not None
        n_ctas = fwd_grid(bwd_tiles(B, S)[0], _max_fwd_ctas(dev.index, tmode))
        launch = lib.tnerf_fused_forward_tmode if tmode else lib.tnerf_fused_forward
        with torch.cuda.device(dev):
            err = launch(
                Wk.data_ptr(), Bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                *_placement_ptrs(te, dt, ts, dts), o.data_ptr(), d.data_ptr(), mask.data_ptr(),
                words.data_ptr(), out.data_ptr(), tchk.data_ptr() if return_tchk else None,
                shaded_ptr, B, S, W.shape[0], n_ctas, *_coarse_args(coarse),
                float(np.float32(term_eps)), torch.cuda.current_stream(dev).cuda_stream,
            )
        build.check(err, "tnerf_fused_forward_tmode" if tmode else "tnerf_fused_forward")
        if tmode:
            fused_forward.launches_tmode += 1
        else:
            fused_forward.launches += 1
    return (out, tchk) if return_tchk else out


@functools.lru_cache(maxsize=None)
def _max_fwd_ctas(device_index: int, tmode: bool) -> int:
    """CTAs of the forward kernel the card holds at once (the CUDA
    occupancy query; its shared memory does not depend on the depth)."""
    with torch.cuda.device(device_index):
        n = build.library().tnerf_fused_forward_max_ctas(int(tmode))
    if n < 0:
        build.check(-n, "tnerf_fused_forward_max_ctas")
    return n


fused_forward.launches = 0        # of the uniform-placement instantiation
fused_forward.launches_tmode = 0  # of the per-sample instantiation


def fused_backward(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse, tchk, gout,
                   term_eps: float = 0.0, ts=None, dts=None, shaded=None):
    """(dL/dW [NL, 128, 128], dL/dBias [NL, 128]) f32 of `fused_forward`'s
    output under the cotangent gout [B, 6], from the forward's own inputs
    (W in f32 or bf16, ts / dts included) and its tchk.  CPU tensors take
    the plain version; CUDA tensors launch the B2 kernel, which skips what
    the forward kernel skipped under the same term_eps (`shaded`, as in
    `fused_forward`, receives its decisions).  The kernel runs a persistent
    grid, one CTA per SM (`bwd_schedule`), and adds each tile's partial
    gradient into int64 sums in fixed point (`GRAD_SHIFT`), which repeat
    bit for bit from run to run and at any grid size; they come back as
    f32 through `dequantize_grad`, non-finite where a partial was out of
    range (`bwd_grad_limit`) or not finite.  Any depth: past MAX_BWD_LAYERS
    the kernel spills the earlier layer inputs of each tile to a scratch of
    `bwd_spill_shape` that this call allocates."""
    if gamma.device.type == "cpu":
        if shaded is not None:
            shaded.fill_(1)
        return fused_backward_plain(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse,
                                    tchk, gout, ts=ts, dts=dts)
    if gamma.device.type != "cuda":
        raise ValueError(f"fused_backward: unsupported device {gamma.device}")
    B, S, NL = _check_backward_inputs(W, Bias, gamma, beta, te, dt, o, d, mask, words, tchk, gout,
                                      ts, dts)
    dev = gamma.device
    shaded_ptr = _shaded_arg(shaded, B, S, dev)
    buf, qW, qB, flag = bwd_grad_sums(NL, dev)
    if B > 0:
        Wk = _weights_bf16(W)
        lib = build.library()
        tmode = ts is not None
        n_ctas = bwd_grid(bwd_tiles(B, S)[0], _max_bwd_ctas(dev.index, NL, tmode))
        spill_shape = bwd_spill_shape(NL, n_ctas)
        spill = None if spill_shape is None else torch.empty(spill_shape, dtype=torch.bfloat16,
                                                             device=dev)
        launch = lib.tnerf_fused_backward_tmode if tmode else lib.tnerf_fused_backward
        with torch.cuda.device(dev):
            err = launch(
                Wk.data_ptr(), Bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                *_placement_ptrs(te, dt, ts, dts), o.data_ptr(), d.data_ptr(), mask.data_ptr(),
                words.data_ptr(), tchk.data_ptr(), gout.data_ptr(), qW.data_ptr(), qB.data_ptr(),
                flag.data_ptr(), shaded_ptr, None if spill is None else spill.data_ptr(), B, S,
                NL, n_ctas, *_coarse_args(coarse), float(np.float32(term_eps)),
                float(2 ** GRAD_SHIFT), bwd_grad_limit(B, S),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        build.check(err, "tnerf_fused_backward_tmode" if tmode else "tnerf_fused_backward")
        if tmode:
            fused_backward.launches_tmode += 1
        else:
            fused_backward.launches += 1
    g = dequantize_grad(buf[:-1], flag)
    return g[:qW.numel()].view(qW.shape), g[qW.numel():].view(qB.shape)


def _check_backward_inputs(W, Bias, gamma, beta, te, dt, o, d, mask, words, tchk, gout, ts, dts):
    """(B, S, NL) of a backward kernel call, or ValueError on what the
    kernel does not take."""
    _check_fused_inputs("fused_backward", W, Bias, gamma, beta, te, dt, o, d, mask, words, ts,
                        dts)
    B, S = mask.shape
    NL = W.shape[0]
    build.check_tensor("tchk", tchk, (B, n_bwd_chunks(S)), torch.float32, gamma.device)
    build.check_tensor("gout", gout, (B, 6), torch.float32, gamma.device)
    return B, S, NL


@functools.lru_cache(maxsize=None)
def _max_bwd_ctas(device_index: int, NL: int, tmode: bool) -> int:
    """CTAs of the backward kernel the card holds at once for NL layers (the
    CUDA occupancy query; past MAX_BWD_LAYERS the shared memory is that of
    MAX_BWD_LAYERS); raises with the CUDA error if the query fails."""
    with torch.cuda.device(device_index):
        n = build.library().tnerf_fused_backward_max_ctas(NL, int(tmode))
    if n < 0:
        build.check(-n, "tnerf_fused_backward_max_ctas")
    return n


fused_backward.launches = 0
fused_backward.launches_tmode = 0


class _FusedRender(torch.autograd.Function):
    """`fused_forward` with `fused_backward` as its derivative onto (W,
    Bias); every other input, ts and dts included, gets no gradient
    (`:750-760`, `:785-793`)."""

    @staticmethod
    def forward(ctx, W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse, term_eps, ts, dts):
        # one bf16 copy of the weights serves both kernels
        Wk = W.to(torch.bfloat16).contiguous()
        out, tchk = fused_forward(Wk, Bias, gamma, beta, te, dt, o, d, mask, words, coarse,
                                  term_eps=term_eps, return_tchk=True, ts=ts, dts=dts)
        ctx.save_for_backward(Wk, Bias, gamma, beta, te, dt, o, d, mask, words, tchk, ts, dts)
        ctx.coarse, ctx.term_eps = coarse, term_eps
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        *inputs, tchk, ts, dts = ctx.saved_tensors
        dW, dBias = fused_backward(*inputs, ctx.coarse, tchk, gout.float().contiguous(),
                                   term_eps=ctx.term_eps, ts=ts, dts=dts)
        return (dW, dBias) + (None,) * 12


def fused_render(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse, term_eps: float = 0.0,
                 ts=None, dts=None):
    """`fused_forward`, differentiable in W and Bias (the counterpart of
    the function `make_fused_trainable` returns)."""
    return _FusedRender.apply(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse, term_eps,
                              ts, dts)


def make_fused_renderer(field_cfg, grid_cfg, sampler_cfg, render_cfg, tighten: bool = True,
                        for_eval: bool = True):
    """render(params, rays, occupancy=None, generator=None) -> RenderResult
    through the B1 kernel: the counterpart of
    `make_fused_pipeline_renderer_v2` (:922-1243).  for_eval=False builds
    the training renderer: where gradients are being recorded it goes
    through `fused_render`, so `backward()` reaches the field's parameters
    through kernel B2 and the differentiable `pack_params_f32`; the ray,
    its span, its samples and the occupancy get no gradient.

    rays: flat Rays ([B, 3], [B, 3], [B, 2]) on the params' device;
    occupancy: the [res]^3 bool bitfield or None (every coarse bit set,
    no tightening).  Three ways to place and pick the samples:

    - uniform placement: with tighten, each ray's span shrinks to its
      occupied range (kernel B3, 256 probes), and S midpoint samples cover
      it;
    - sampler.placement="occupancy_cdf" (`:1145-1193`): kernel B4 tightens
      the span and tests its sampler.cdf_bins bin midpoints against the
      occupancy pooled to `select_bin_pool_res`; the S samples go through
      the inverse CDF of those bits (`cdf_ray_samples`): stratum midpoints,
      or jittered within their strata where `generator` (a torch.Generator
      on the rays' device, the counterpart of the reference's key) is
      given, as training gives it; the kernels run in per-sample placement;
    - render.ray_compact (eval only, as in the reference; `:1154-1180`,
      `:1195-1230`): rays with no occupied bin (CDF), or no occupied
      midpoint sample of the tightened span (uniform; kernel B4 at n = S on
      the occupancy pooled as the kernel's coarse bitfield), are dropped
      before the fused kernel, which runs on a buffer of cap = max(1,
      int(B * render.ray_compact_fraction)) rays; dropped rays, and kept
      rays beyond cap, come back as background (acc = 0).  The reference
      rounds cap up to its kernel's row tile and pads the rays to it: TPU
      tiling, which has no counterpart here."""
    if sampler_cfg.placement == "density_cdf":
        raise ValueError(
            "render.pipeline='fused' supports sampler.placement="
            "'occupancy_cdf' (binary bin weights from the fold kernel); "
            "density_cdf needs density-EMA bin probes — use "
            "render.pipeline='grid_march' for density-weighted placement"
        )
    use_cdf = sampler_cfg.placement == "occupancy_cdf"
    if use_cdf and not tighten:
        raise ValueError(
            "fused CDF placement needs tighten=True (bin weights come "
            "from the tighten+sample-mask kernel); set "
            "render.fused_tighten=true"
        )
    ray_compact = render_cfg.ray_compact and for_eval
    s_aff, b_aff = _norm_affine(grid_cfg)
    A, C, _ = _encoding_matrices(field_cfg, s_aff, b_aff)
    S = sampler_cfg.samples_per_ray
    P = sampler_cfg.cdf_bins
    res = grid_cfg.resolution
    res_c = select_coarse_res(render_cfg, res)
    res_t = select_bin_pool_res(res)
    lo, cell_c, _ = coarse_constants(grid_cfg, res_c)
    coarse = (res_c, lo, cell_c)
    near = float(sampler_cfg.near)

    def tighten_mask(o, d, te, tx, occupancy, words, to_res: int, n: int):
        """Kernel B4 on the occupancy pooled to to_res; `words` is that
        bitfield where to_res is the kernel's own pooling."""
        occ_c = make_coarse_occupancy(occupancy.reshape(res, res, res), res // to_res)
        return tighten_sample_mask(o, d, te, tx, occ_c, n, grid_cfg,
                                   words=words if to_res == res_c else None)

    def compact(keep, *cols):
        """The kept rays' columns, each cut from one compacted buffer."""
        cap = max(1, int(keep.shape[0] * render_cfg.ray_compact_fraction))
        wide = [c if c.dim() == 2 else c[:, None] for c in cols]
        buf, widx = compact_rows(keep, torch.cat(wide, dim=1), cap)
        parts = torch.split(buf, [c.shape[1] for c in wide], dim=1)
        return [p.contiguous() if c.dim() == 2 else p[:, 0].contiguous()
                for p, c in zip(parts, cols)], widx

    def prepare(params, rays: Rays, occupancy, generator):
        """(positional arguments, keyword arguments, widx) of this
        renderer's fused_forward call; widx [B] maps the rays to the
        call's rows where they were compacted, else None."""
        o, d, tp = (a.float().contiguous() for a in rays)
        dev = o.device
        te, tx = ray_aabb(o, d, grid_cfg.aabb_min, grid_cfg.aabb_max)
        te = torch.clamp_min(te, near)
        tx = torch.maximum(tx, te)
        widx, placed = None, {}
        if occupancy is None:
            if use_cdf:
                raise ValueError(
                    "fused CDF placement (sampler.placement='occupancy_cdf') needs an "
                    "occupancy grid at render time — pass occupancy=..."
                )
            words = torch.full((WORDS,), -1, dtype=torch.int32, device=dev)
        else:
            words = pack_occupancy_words(occupancy, res, res_c)
        if use_cdf:
            te, tx, bins = tighten_mask(o, d, te, tx, occupancy, words, res_t, P)
            if ray_compact:
                (o, d, tp, te, tx, binsf), widx = compact(bins.any(dim=1), o, d, tp, te, tx,
                                                          bins.float())
                bins = binsf > 0.5
            jitter = None if generator is None else torch.rand(
                (*te.shape, S), generator=generator, dtype=torch.float32, device=dev)
            rs = cdf_ray_samples(te, tx, S, bins.float(), floor=sampler_cfg.cdf_floor,
                                 jitter=jitter, bin_support=bins)
            placed = {"ts": rs.t.contiguous(), "dts": rs.deltas.contiguous()}
            mask = rs.mask.float().contiguous()
            # (gamma, beta) folded at (t = 0, dt = 1): feature = act(gamma + t beta)
            te = dt = torch.zeros_like(te)
            gamma, beta = encode_gamma_beta(o, d, tp, te, torch.ones_like(te), A, C)
        else:
            if occupancy is not None and tighten:
                if ray_compact:
                    te, tx, kmask = tighten_mask(o, d, te, tx, occupancy, words, res_c, S)
                    (o, d, tp, te, tx), widx = compact(kmask.any(dim=1), o, d, tp, te, tx)
                else:
                    te, tx = tighten_range(o, d, te, tx, words, res_c, grid_cfg)
            # dt divides by the requested S, as the reference does (:1032-1039):
            # its XLA multiplies by RN(1 / S)
            dt = ((tx - te) * reciprocal(S, dev)).contiguous()
            mask = (tx > te)[:, None].expand(-1, S).float().contiguous()
            gamma, beta = encode_gamma_beta(o, d, tp, te, dt, A, C)
        W, Bias = pack_params_f32(params, field_cfg, s_aff, b_aff)
        return (W, Bias, gamma, beta, te.contiguous(), dt, o, d, mask, words, coarse), placed, widx

    def kernel_inputs(params, rays: Rays, occupancy=None, generator=None) -> tuple:
        """The positional arguments of this renderer's fused_forward call;
        under CDF placement, followed by the dict of its ts / dts keywords."""
        args, placed, _ = prepare(params, rays, occupancy, generator)
        return (*args, placed) if use_cdf else args

    def render(params, rays: Rays, occupancy=None, generator=None) -> RenderResult:
        call = fused_forward if for_eval or not torch.is_grad_enabled() else fused_render
        args, placed, widx = prepare(params, rays, occupancy, generator)
        out = call(*args, term_eps=render_cfg.transmittance_threshold, **placed)[:, 0:5]
        if widx is not None:
            # the background row is all zeros (acc = 0); a white background
            # is added after the rays are back in place
            out = scatter_back(out, widx, torch.zeros((1, 5), dtype=out.dtype, device=out.device))
        rgb, acc, depth = out[:, 0:3], out[:, 3], out[:, 4]
        if render_cfg.white_background:
            rgb = rgb + (1.0 - acc)[:, None]
        empty = torch.zeros((out.shape[0], 0), dtype=torch.float32, device=out.device)
        return RenderResult(rgb=rgb, acc=acc, depth=depth, weights=empty,
                            transmittance=empty, distortion=torch.zeros_like(acc))

    render.kernel_inputs = kernel_inputs
    return render
