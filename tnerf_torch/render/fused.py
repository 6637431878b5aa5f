"""Fused frequency-MLP renderer (kernel B1) and its glue.

Replaces the TPU kernel `tnerf/render/pallas_fused2.py:_fwd_kernel`
(:350, built by `make_fused_trainable` :582) and the uniform-placement,
uncompacted branch of `make_fused_pipeline_renderer_v2` (:922-1243).

`fused_forward` takes the plain PyTorch version for CPU tensors and
launches the CUDA kernel (`tnerf_torch/csrc/fused_forward.cu`) for CUDA
tensors; there is no fallback between the two.  The plain version is the
torch mirror of `fused_reference_v2` (:803) plus the kernel's in-kernel
coarse occupancy test (`_coarse_mask`, :256): bf16 operands with f32
products and sums, f32 activations and compositing.

The TPU kernel's `rpc` packs rays into 128-lane rows; each ray's samples
are contiguous here, so `render.fused_rpc` changes nothing and is not
read (rpc=1 and rpc=2 give the same quadrature in the reference too).
"""

from __future__ import annotations

import numpy as np
import torch

from tnerf_torch.cameras import Rays
from tnerf_torch.grid.tighten import WORDS, coarse_constants, occ_bit, pack_words_rows, tighten_range
from tnerf_torch.grid.traversal import make_coarse_occupancy, ray_aabb
from tnerf_torch.kernels import build
from tnerf_torch.render.composite import RenderResult
from tnerf_torch.render.fused_common import (
    LANES,
    _encoding_matrices,
    _feature_permutation,
    _norm_affine,
)
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


def fused_forward_plain(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse):
    """The plain PyTorch version of `fused_forward` (any device).

    bf16 operands are rounded, then upcast and multiplied in f32: a bf16
    matmul would round its sums to bf16, and the reference accumulates in
    f32 (preferred_element_type=f32).  On the card this needs full-f32
    matrix products, so TF32 is switched off for them (it is off by
    default in PyTorch)."""
    if W.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    B, S = mask.shape
    NL = W.shape[0]
    dev = gamma.device
    s = torch.arange(S, dtype=torch.float32, device=dev) + 0.5
    I = gamma[:, None, :] + s[None, :, None] * beta[:, None, :]
    lane = torch.arange(LANES, device=dev)
    E = torch.where(lane < 5, I, torch.sin(I))
    h = E.reshape(B * S, LANES).to(torch.bfloat16)
    Wb = W.to(torch.bfloat16).float()
    for l in range(NL - 1):
        h = torch.relu(h.float() @ Wb[l] + Bias[l][None, :]).to(torch.bfloat16)
    hL = (h.float() @ Wb[NL - 1] + Bias[NL - 1][None, :]).reshape(B, S, LANES)
    rgb = torch.sigmoid(hL[..., 0:3])
    x = hL[..., 3] - 1.0
    sig = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))  # jax.nn.softplus
    t = te[:, None] + s[None, :] * dt[:, None]
    m = mask.float()
    if coarse is not None:
        res_c, lo, cell_c = coarse
        bit = occ_bit(o[:, None, 0] + t * d[:, None, 0], o[:, None, 1] + t * d[:, None, 1],
                      o[:, None, 2] + t * d[:, None, 2], words, res_c, lo, cell_c)
        m = m * bit.float()
    tau = sig * dt[:, None] * m
    excl = torch.cumsum(tau, dim=1) - tau
    w = torch.exp(-excl) * (1.0 - torch.exp(-tau))
    return torch.cat([
        torch.sum(w[..., None] * rgb, dim=1),
        torch.sum(w, dim=1, keepdim=True),
        torch.sum(w * t, dim=1, keepdim=True),
        torch.exp(-torch.sum(tau, dim=1, keepdim=True)),
    ], dim=1)


def fused_forward(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse, term_eps: float = 0.0):
    """Encode + MLP + composite every ray's S uniform samples.

    W [NL, 128, 128] f32 (cast to bf16 here), Bias [NL, 128] f32, gamma /
    beta [B, 128] f32, te / dt [B] f32, o / d [B, 3] f32, mask [B, S] f32,
    words int32 [1024], coarse = (res_c, lo, cell_c) from
    `coarse_constants` or None (no occupancy test).  Returns [B, 6] f32:
    rgb (no background), acc, depth = sum w t, T_final.

    CPU tensors take the plain version (term_eps does not apply there);
    CUDA tensors launch the B1 kernel, which stops shading a tile of rays
    once all of them are below term_eps."""
    if gamma.device.type == "cpu":
        return fused_forward_plain(W, Bias, gamma, beta, te, dt, o, d, mask, words, coarse)
    if gamma.device.type != "cuda":
        raise ValueError(f"fused_forward: unsupported device {gamma.device}")
    dev = gamma.device
    B, S = mask.shape
    NL = W.shape[0]
    f32 = torch.float32
    build.check_tensor("W", W, (NL, LANES, LANES), f32, dev)
    build.check_tensor("Bias", Bias, (NL, LANES), f32, dev)
    for name, t in (("gamma", gamma), ("beta", beta)):
        build.check_tensor(name, t, (B, LANES), f32, dev)
    for name, t in (("te", te), ("dt", dt)):
        build.check_tensor(name, t, (B,), f32, dev)
    for name, t in (("o", o), ("d", d)):
        build.check_tensor(name, t, (B, 3), f32, dev)
    build.check_tensor("mask", mask, (B, S), f32, dev)
    build.check_tensor("words", words, (WORDS,), torch.int32, dev)
    if S < 1 or NL < 1:
        raise ValueError(f"fused_forward: need S >= 1 and at least one layer, got S={S}, NL={NL}")
    out = torch.empty((B, 6), dtype=f32, device=dev)
    if B == 0:
        return out
    Wt = W.to(torch.bfloat16).transpose(1, 2).contiguous()  # out-major [NL, n, k]
    res_c, lo, cell_c = coarse if coarse is not None else (1, np.zeros(3, np.float32),
                                                            np.ones(3, np.float32))
    lib = build.library()
    fl = lambda v: float(np.float32(v))
    with torch.cuda.device(dev):
        err = lib.tnerf_fused_forward(
            Wt.data_ptr(), Bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(), te.data_ptr(),
            dt.data_ptr(), o.data_ptr(), d.data_ptr(), mask.data_ptr(), words.data_ptr(),
            out.data_ptr(), B, S, NL, int(coarse is not None), res_c,
            fl(lo[0]), fl(lo[1]), fl(lo[2]), fl(cell_c[0]), fl(cell_c[1]), fl(cell_c[2]),
            fl(term_eps), torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(err, "tnerf_fused_forward")
    fused_forward.launches += 1
    return out


fused_forward.launches = 0


def refuse_unported(sampler_cfg, render_cfg) -> None:
    """Raise on the fused-path options this port does not run yet."""
    if sampler_cfg.placement != "uniform":
        raise NotImplementedError(
            f"sampler.placement={sampler_cfg.placement!r} is not yet ported to "
            "tnerf_torch (uniform placement only), see ROADMAP.md"
        )
    if render_cfg.ray_compact:
        raise NotImplementedError(
            "render.ray_compact=true is not yet ported to tnerf_torch (it needs "
            "kernel B4), see ROADMAP.md; pass --override render.ray_compact=false"
        )


def make_fused_renderer(field_cfg, grid_cfg, sampler_cfg, render_cfg, tighten: bool = True):
    """render(params, rays, occupancy=None) -> RenderResult through the B1
    kernel: the counterpart of `make_fused_pipeline_renderer_v2` with
    uniform placement and no ray compaction (:1126-1243).

    rays: flat Rays ([B, 3], [B, 3], [B, 2]) on the params' device;
    occupancy: the [res]^3 bool bitfield or None (every coarse bit set,
    no tightening).  With tighten, each ray's span shrinks to its
    occupied range (kernel B3, 256 probes) before sampling."""
    refuse_unported(sampler_cfg, render_cfg)
    s_aff, b_aff = _norm_affine(grid_cfg)
    A, C, _ = _encoding_matrices(field_cfg, s_aff, b_aff)
    S = sampler_cfg.samples_per_ray
    res = grid_cfg.resolution
    res_c = select_coarse_res(render_cfg, res)
    lo, cell_c, _ = coarse_constants(grid_cfg, res_c)
    coarse = (res_c, lo, cell_c)
    near = float(sampler_cfg.near)

    def kernel_inputs(params, rays: Rays, occupancy=None) -> tuple:
        """The positional arguments of this renderer's fused_forward call."""
        o, d, tp = (a.float().contiguous() for a in rays)
        dev = o.device
        te, tx = ray_aabb(o, d, grid_cfg.aabb_min, grid_cfg.aabb_max)
        te = torch.clamp_min(te, near)
        tx = torch.maximum(tx, te)
        if occupancy is None:
            words = torch.full((WORDS,), -1, dtype=torch.int32, device=dev)
        else:
            words = pack_occupancy_words(occupancy, res, res_c)
            if tighten:
                te, tx = tighten_range(o, d, te, tx, words, res_c, grid_cfg)
        # dt divides by the requested S, as the reference does (:1032-1039)
        dt = (tx - te) / torch.tensor(float(S), dtype=torch.float32, device=dev)
        mask = (tx > te)[:, None].expand(-1, S).float().contiguous()
        gamma, beta = encode_gamma_beta(o, d, tp, te, dt, A, C)
        W, Bias = pack_params_f32(params, field_cfg, s_aff, b_aff)
        return (W, Bias, gamma, beta, te.contiguous(), dt.contiguous(), o, d, mask, words,
                coarse)

    def render(params, rays: Rays, occupancy=None) -> RenderResult:
        out = fused_forward(*kernel_inputs(params, rays, occupancy),
                            term_eps=render_cfg.transmittance_threshold)
        rgb, acc, depth = out[:, 0:3], out[:, 3], out[:, 4]
        if render_cfg.white_background:
            rgb = rgb + (1.0 - acc)[:, None]
        empty = torch.zeros((out.shape[0], 0), dtype=torch.float32, device=out.device)
        return RenderResult(rgb=rgb, acc=acc, depth=depth, weights=empty,
                            transmittance=empty, distortion=torch.zeros_like(acc))

    render.kernel_inputs = kernel_inputs
    return render
