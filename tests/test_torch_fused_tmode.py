"""Per-sample placement (the reference's `tmode`) of the fused kernels'
plain versions, B1t and B2t, against the reference: the Pallas kernels in
interpret mode through `make_fused_trainable(..., tmode=True)` (forward
and `jax.grad` through its custom VJP, with the in-kernel coarse test) and
the jnp mirror `fused_reference_v2_t`.

Tolerances, those of tests/test_torch_fused.py and
tests/test_torch_fused_backward.py: atol 5e-3 for the forward outputs
(bf16 activations rounded in another order); per leaf (dW, dBias) as
max |a - b| / max |b|: 5e-3 against `torch.autograd.grad` of the plain
forward (one more bf16 rounding of the head's gradient), 3e-2 against the
reference (its activations are rounded by another product order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.config import GridConfig as JGrid
from tnerf.render import pallas_fused2 as jf
from tnerf_torch.config import GridConfig
from tnerf_torch.grid.tighten import coarse_constants
from tnerf_torch.grid.tighten import pack_words_rows as t_pack
from tnerf_torch.render import fused as tf

FORWARD_ATOL = 5e-3
AUTOGRAD_RTOL = 5e-3
REFERENCE_RTOL = 3e-2


def _workload(S, coarse_res=16, NL=4, B=64):
    """The reference's tmode workload (tests/test_pallas_fused2.py:390-410):
    monotone, non-uniform depths with their own steps, (gamma, beta) as
    folded at (0, 1), plus ray geometry for the coarse test and a cotangent
    on all six output columns."""
    rng = np.random.default_rng(7)
    W = rng.normal(0, 0.3, (NL, 128, 128)).astype(np.float32)
    Bias = rng.normal(0, 0.1, (NL, 128)).astype(np.float32)
    gamma = rng.normal(0, 1.0, (B, 128)).astype(np.float32)
    beta = rng.normal(0, 0.3, (B, 128)).astype(np.float32)
    o = rng.normal(size=(B, 3))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0).astype(np.float32)
    d = -o / 3.0 + rng.uniform(-0.1, 0.1, (B, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    te = rng.uniform(1.5, 2.5, (B, 1)).astype(np.float32)
    span = rng.uniform(1.0, 2.0, (B, 1)).astype(np.float32)
    ts = te + np.sort(rng.uniform(0, 1, (B, S)).astype(np.float32), axis=1) * span
    dts = rng.uniform(0.004, 0.02, (B, S)).astype(np.float32)
    mask = (rng.uniform(0, 1, (B, S)) < 0.7).astype(np.float32)
    mask[:4] = 0.0  # fully masked rays must contribute nothing
    occ = rng.uniform(size=(coarse_res,) * 3) < 0.5
    cot = np.random.default_rng(1).normal(0, 1.0, (B, 6)).astype(np.float32)
    return dict(W=W, Bias=Bias, gamma=gamma, beta=beta, o=o, d=d, ts=ts, dts=dts, mask=mask,
                occ=occ, cot=cot)


def _torch_call(w, coarse):
    """(positional arguments, ts / dts keywords) of the port's functions."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    res_c = w["occ"].shape[0]
    lo, cell, _ = coarse_constants(GridConfig(), res_c)
    zero = torch.zeros(w["gamma"].shape[0])
    args = [t(w["W"]), t(w["Bias"]), t(w["gamma"]), t(w["beta"]), zero, zero, t(w["o"]),
            t(w["d"]), t(w["mask"]), t_pack(t(w["occ"])), (res_c, lo, cell) if coarse else None]
    return args, {"ts": t(w["ts"]), "dts": t(w["dts"])}


def _reference(w, NK, coarse):
    """fused(W, Bias) -> [B, 8] through the Pallas tmode kernels."""
    res_c = w["occ"].shape[0]
    lo = np.asarray(JGrid().aabb_min, np.float32)
    hi = np.asarray(JGrid().aabb_max, np.float32)
    jcoarse = (res_c, 1, tuple(lo), tuple((hi - lo) / res_c)) if coarse else None
    fused = jf.make_fused_trainable(w["W"].shape[0], NK, b_tile=32, b_tile_bwd=16, term_eps=0.0,
                                    interpret=True, coarse=jcoarse, tmode=True)
    B = w["gamma"].shape[0]
    rays8 = np.concatenate([np.zeros((B, 2), np.float32), w["o"], w["d"]], axis=1)
    words = jf.pack_occupancy_words(jnp.asarray(w["occ"]), res_c, res_c)
    return lambda W_, B_: fused(W_, B_, w["gamma"], w["beta"], rays8, w["mask"], w["ts"],
                                w["dts"], words)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-9)


def _function_grads(args, placed, cot):
    W, Bias = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
    out = tf.fused_render(W, Bias, *args[2:], 0.0, **placed)
    return torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (W, Bias)), out


@pytest.mark.parametrize("coarse", [False, True])
def test_forward_matches_pallas_tmode_kernel(coarse):
    NK = 2
    w = _workload(NK * 128)
    ref = np.asarray(_reference(w, NK, coarse)(w["W"], w["Bias"]))[:, :6]
    args, placed = _torch_call(w, coarse)
    got = tf.fused_forward(*args, **placed).numpy()
    np.testing.assert_allclose(got, ref, atol=FORWARD_ATOL, rtol=0)
    np.testing.assert_allclose(got[:4, 0:5], 0.0, atol=1e-7)  # rgb, acc, depth
    np.testing.assert_allclose(got[:4, 5], 1.0, atol=1e-7)    # T_final
    if coarse:  # the coarse test really masked samples at the per-sample depths
        open_ = tf.fused_forward(*args[:10], None, **placed).numpy()
        assert np.abs(open_ - got)[:, 3].max() > 0.05
    else:
        mirror = np.asarray(jf.fused_reference_v2_t(w["W"], w["Bias"], w["gamma"], w["beta"],
                                                    w["mask"], w["ts"], w["dts"]))[:, :6]
        np.testing.assert_allclose(got, mirror, atol=FORWARD_ATOL, rtol=0)


@pytest.mark.parametrize("S,coarse", [(64, False), (256, True), (100, True)])
def test_plain_backward_matches_autograd_of_plain_forward(S, coarse):
    """One chunk (64), four chunks (256: saved transmittance and the dL/dT
    carry), a ragged last chunk (100)."""
    w = _workload(S)
    args, placed = _torch_call(w, coarse)
    (dW, dB), out = _function_grads(args, placed, w["cot"])
    W, Bias = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
    ref_out = tf.fused_forward_plain(W, Bias, *args[2:], **placed)
    gW, gB = torch.autograd.grad((ref_out * torch.from_numpy(w["cot"])).sum(), (W, Bias))
    torch.testing.assert_close(out.detach(), ref_out.detach(), atol=1e-6, rtol=0)
    assert float(gW.abs().max()) > 1e-3 and float(gB.abs().max()) > 1e-3
    assert _rel(dW, gW) <= AUTOGRAD_RTOL, ("dW", _rel(dW, gW))
    assert _rel(dB, gB) <= AUTOGRAD_RTOL, ("dBias", _rel(dB, gB))
    _, tchk = tf.fused_forward(*args, return_tchk=True, **placed)
    assert tchk.shape == (64, tf.n_bwd_chunks(S)) and torch.all(tchk[:, 0] == 1.0)
    assert torch.all(tchk[:, 1:] <= tchk[:, :-1])


@pytest.mark.parametrize("coarse", [False, True])
def test_plain_backward_matches_reference_custom_vjp(coarse):
    NK = 2
    w = _workload(NK * 128)
    fused = _reference(w, NK, coarse)
    loss_k = lambda W_, B_: jnp.sum(fused(W_, B_)[:, :6] * w["cot"])
    jW, jB = jax.grad(loss_k, argnums=(0, 1))(jnp.asarray(w["W"]), jnp.asarray(w["Bias"]))
    args, placed = _torch_call(w, coarse)
    (dW, dB), _ = _function_grads(args, placed, w["cot"])
    assert _rel(dW, jW) <= REFERENCE_RTOL, ("dW vs custom VJP", _rel(dW, jW))
    assert _rel(dB, jB) <= REFERENCE_RTOL, ("dBias vs custom VJP", _rel(dB, jB))
    if not coarse:
        loss_r = lambda W_, B_: jnp.sum(jf.fused_reference_v2_t(
            W_, B_, w["gamma"], w["beta"], w["mask"], w["ts"], w["dts"])[:, :6] * w["cot"])
        rW, rB = jax.grad(loss_r, argnums=(0, 1))(jnp.asarray(w["W"]), jnp.asarray(w["Bias"]))
        assert _rel(dW, rW) <= REFERENCE_RTOL, ("dW vs jax.grad", _rel(dW, rW))
        assert _rel(dB, rB) <= REFERENCE_RTOL, ("dBias vs jax.grad", _rel(dB, rB))


def test_samples_get_no_gradient():
    """ts and dts are placements, not parameters: the autograd Function
    gives them no gradient, as the reference's VJP gives them zeros."""
    w = _workload(64)
    args, placed = _torch_call(w, True)
    W = args[0].clone().requires_grad_()
    ts = placed["ts"].clone().requires_grad_()
    dts = placed["dts"].clone().requires_grad_()
    out = tf.fused_render(W, *args[1:], 0.0, ts=ts, dts=dts)
    gW, gts, gdts = torch.autograd.grad(out.sum(), (W, ts, dts), allow_unused=True)
    assert gts is None and gdts is None and float(gW.abs().max()) > 0


def test_affine_samples_reduce_to_uniform_placement():
    """With ts = te + (s + 0.5) dt, dts = dt and (gamma, beta) refolded from
    (0, 1) to (te, dt), per-sample placement is uniform placement: same
    math, another parameterization (tests/test_pallas_fused2.py:426)."""
    S = 128
    w = _workload(S)
    rng = np.random.default_rng(5)
    B = w["gamma"].shape[0]
    te = rng.uniform(1.5, 2.5, B).astype(np.float32)
    dt = rng.uniform(0.01, 0.02, B).astype(np.float32)
    w["ts"] = te[:, None] + (np.arange(S, dtype=np.float32) + 0.5)[None, :] * dt[:, None]
    w["dts"] = np.broadcast_to(dt[:, None], (B, S)).copy()
    w["beta"] = (0.05 * w["beta"]).astype(np.float32)
    args, placed = _torch_call(w, True)
    out_t = tf.fused_forward(*args, **placed)
    t = torch.from_numpy
    gamma_u = args[2] + t(te)[:, None] * args[3]
    beta_u = t(dt)[:, None] * args[3]
    out_u = tf.fused_forward(args[0], args[1], gamma_u, beta_u, t(te), t(dt), *args[6:])
    np.testing.assert_allclose(out_t.numpy(), out_u.numpy(), atol=FORWARD_ATOL, rtol=0)
    (dW_t, dB_t), _ = _function_grads(args, placed, w["cot"])
    (dW_u, dB_u), _ = _function_grads([args[0], args[1], gamma_u, beta_u, t(te), t(dt), *args[6:]],
                                      {}, w["cot"])
    assert _rel(dW_t, dW_u) <= REFERENCE_RTOL and _rel(dB_t, dB_u) <= REFERENCE_RTOL


def test_wrappers_refuse_half_a_placement():
    w = _workload(64)
    args, placed = _torch_call(w, False)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tf.fused_forward(*meta, ts=placed["ts"].to("meta"), dts=placed["dts"].to("meta"))
    with pytest.raises(ValueError, match="ts and dts go together"):
        tf._check_fused_inputs("fused_forward", *args[:10], placed["ts"], None)
