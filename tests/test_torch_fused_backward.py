"""Kernel B2's plain version, the autograd Function around B1/B2 and the
differentiable parameter packing, against autograd of the plain forward
and against the reference's custom VJP (the Pallas backward kernel in
interpret mode) and `jax.grad` of its jnp mirror.

Tolerances, as max |a - b| / max |b| per leaf (dW, dBias):
- 5e-3 against `torch.autograd.grad` of `fused_forward_plain`.  Both round
  the gradient to bf16 wherever the forward rounded an activation; the
  plain backward (like the kernel) also rounds the head's gradient to bf16
  before the last layer's two products, which autograd keeps in f32: one
  bf16 rounding, 2^-9 relative per element.  Measured 3.4e-3 at worst.
- 3e-2 against the reference, the bound of its own kernel-against-autodiff
  test (tests/test_pallas_fused2.py:69-73): its activations are rounded by
  another product order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.config import GridConfig as JGrid
from tnerf.render import pallas_fused2 as jf
from tnerf_torch.config import Config, GridConfig
from tnerf_torch.grid.tighten import coarse_constants
from tnerf_torch.grid.tighten import pack_words_rows as t_pack
from tnerf_torch.render import fused as tf

AUTOGRAD_RTOL = 5e-3
REFERENCE_RTOL = 3e-2


def _workload(S, coarse_res=16, NL=4, B=64, w_scale=0.3):
    """The reference test's workload (tests/test_pallas_fused2.py:22-36)
    plus ray geometry, a random coarse bitfield and a cotangent on all six
    output columns."""
    rng = np.random.default_rng(0)
    W = rng.normal(0, w_scale, (NL, 128, 128)).astype(np.float32)
    Bias = rng.normal(0, 0.1, (NL, 128)).astype(np.float32)
    gamma = rng.normal(0, 1.0, (B, 128)).astype(np.float32)
    beta = rng.normal(0, 0.02, (B, 128)).astype(np.float32)
    te = rng.uniform(1.5, 2.5, B).astype(np.float32)
    dt = rng.uniform(0.01, 0.02, B).astype(np.float32)
    o = rng.normal(size=(B, 3))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0).astype(np.float32)
    d = -o / 3.0 + rng.uniform(-0.1, 0.1, (B, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    mask = (rng.uniform(0, 1, (B, S)) < 0.7).astype(np.float32)
    mask[:4] = 0.0  # fully masked rays must contribute nothing
    occ = rng.uniform(size=(coarse_res,) * 3) < 0.5
    cot = np.random.default_rng(1).normal(0, 1.0, (B, 6)).astype(np.float32)
    return W, Bias, gamma, beta, te, dt, o, d, mask, occ, cot


def _torch_args(W, Bias, gamma, beta, te, dt, o, d, mask, occ, coarse):
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    res_c = occ.shape[0]
    lo, cell, _ = coarse_constants(GridConfig(), res_c)
    return [t(W), t(Bias), t(gamma), t(beta), t(te), t(dt), t(o), t(d), t(mask), t_pack(t(occ)),
            (res_c, lo, cell) if coarse else None]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-9)


def _function_grads(args, cot):
    """(dW, dBias) through `fused_render`: on CPU tensors its backward is
    `fused_backward_plain` on the saved per-chunk transmittance."""
    W, Bias = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
    out = tf.fused_render(W, Bias, *args[2:], 0.0)
    return torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (W, Bias)), out


@pytest.mark.parametrize("S,coarse", [(64, False), (256, False), (256, True), (100, True)])
def test_plain_backward_matches_autograd_of_plain_forward(S, coarse):
    """One chunk (64), four chunks (256: saved transmittance and the dL/dT
    carry), a ragged last chunk (100), with and without the coarse test."""
    *arrs, cot = _workload(S)
    args = _torch_args(*arrs, coarse)
    (dW, dB), out = _function_grads(args, cot)
    W, Bias = args[0].clone().requires_grad_(), args[1].clone().requires_grad_()
    ref_out = tf.fused_forward_plain(W, Bias, *args[2:])
    gW, gB = torch.autograd.grad((ref_out * torch.from_numpy(cot)).sum(), (W, Bias))
    torch.testing.assert_close(out.detach(), ref_out.detach(), atol=1e-6, rtol=0)
    assert float(gW.abs().max()) > 1e-3 and float(gB.abs().max()) > 1e-3
    assert _rel(dW, gW) <= AUTOGRAD_RTOL, ("dW", _rel(dW, gW))
    assert _rel(dB, gB) <= AUTOGRAD_RTOL, ("dBias", _rel(dB, gB))
    # the forward's saved transmittance: 1 at every ray's start, T_final's
    # factor chain at the chunk starts
    _, tchk = tf.fused_forward(*args, return_tchk=True)
    assert tchk.shape == (64, tf.n_bwd_chunks(S)) and torch.all(tchk[:, 0] == 1.0)
    assert torch.all(tchk[:4] == 1.0)  # fully masked rays stay transparent
    assert torch.all(tchk[:, 1:] <= tchk[:, :-1])


@pytest.mark.parametrize("coarse", [False, True])
def test_plain_backward_matches_reference_custom_vjp(coarse):
    """Against the Pallas backward kernel (interpret mode) through its
    custom VJP, and against jax.grad of the jnp mirror (no coarse test
    there)."""
    _check_against_reference_custom_vjp(coarse, NL=4, NK=2)


@pytest.mark.parametrize("coarse", [False, True])
def test_deep_plain_backward_matches_reference_custom_vjp(coarse):
    """The same at 11 layers (hidden_layers = 10), past the 9 whose inputs
    the card's kernel keeps in shared memory: the depth its scratch serves.
    Weights at the ReLU scale sqrt(2 / 128), so the gradient reaches the
    first layers; one 128-sample chunk per ray.  The tolerance stays 3e-2."""
    _check_against_reference_custom_vjp(coarse, NL=11, NK=1, w_scale=(2.0 / 128) ** 0.5)


def _check_against_reference_custom_vjp(coarse, NL, NK, w_scale=0.3):
    res_c = 16
    W, Bias, gamma, beta, te, dt, o, d, mask, occ, cot = _workload(NK * 128, res_c, NL=NL,
                                                                   w_scale=w_scale)
    lo = np.asarray(JGrid().aabb_min, np.float32)
    hi = np.asarray(JGrid().aabb_max, np.float32)
    jcoarse = (res_c, 1, tuple(lo), tuple((hi - lo) / res_c)) if coarse else None
    fused = jf.make_fused_trainable(NL, NK, b_tile=32, b_tile_bwd=16, term_eps=0.0,
                                    interpret=True, coarse=jcoarse)
    rays8 = np.concatenate([te[:, None], dt[:, None], o, d], axis=1)
    words = jf.pack_occupancy_words(jnp.asarray(occ), res_c, res_c)
    loss_k = lambda W_, B_: jnp.sum(fused(W_, B_, gamma, beta, rays8, mask, words)[:, :6] * cot)
    jW, jB = jax.grad(loss_k, argnums=(0, 1))(jnp.asarray(W), jnp.asarray(Bias))
    args = _torch_args(W, Bias, gamma, beta, te, dt, o, d, mask, occ, coarse)
    (dW, dB), _ = _function_grads(args, cot)
    assert float(np.abs(jW[0]).max()) > 0 and float(np.abs(jB[0]).max()) > 0  # reaches layer 0
    assert _rel(dW, jW) <= REFERENCE_RTOL, ("dW vs custom VJP", _rel(dW, jW))
    assert _rel(dB, jB) <= REFERENCE_RTOL, ("dBias vs custom VJP", _rel(dB, jB))
    if not coarse:
        loss_r = lambda W_, B_: jnp.sum(
            jf.fused_reference_v2(W_, B_, gamma, beta, rays8, mask)[:, :6] * cot)
        rW, rB = jax.grad(loss_r, argnums=(0, 1))(jnp.asarray(W), jnp.asarray(Bias))
        assert _rel(dW, rW) <= REFERENCE_RTOL, ("dW vs jax.grad", _rel(dW, rW))
        assert _rel(dB, rB) <= REFERENCE_RTOL, ("dBias vs jax.grad", _rel(dB, rB))
    else:
        # the coarse test really masked samples: without it the gradient moves
        (dW0, _), _ = _function_grads(_torch_args(W, Bias, gamma, beta, te, dt, o, d, mask, occ,
                                                  False), cot)
        assert _rel(dW0, dW) > 0.05


def _small_cfg():
    return Config().apply_overrides([
        "sampler.samples_per_ray=64", "sampler.near=2.0", "sampler.far=5.5",
        "field_.hidden_width=32", "field_.hidden_layers=2", "field_.n_frequencies=4",
        "grid.resolution=8", "scene.scene_scale=1.0", "render.ray_compact=false",
    ])


def test_gradients_reach_the_field_through_packing_and_affine_fold():
    """`backward()` through the training renderer: kernel-order packing,
    the feature permutation and the layer-0 affine fold carry dW / dBias to
    every parameter, the raw-coordinate rows of `trunk.w.0` included; the
    result equals autograd through the plain forward."""
    from tnerf_torch.cameras import Rays, viewdirs_to_thetaphi
    from tnerf_torch.fields.nerf_field import NeRFField
    from tnerf_torch.render.fused import make_fused_renderer

    cfg = _small_cfg()
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    o = rng.uniform(-1, 1, (64, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 3.0
    d = torch.from_numpy((-o / 3.0).astype(np.float32))
    rays = Rays(torch.from_numpy(o.astype(np.float32)), d, viewdirs_to_thetaphi(d))
    occ = torch.ones((8, 8, 8), dtype=torch.bool)
    gt = torch.from_numpy(rng.uniform(0, 1, (64, 3)).astype(np.float32))
    render = make_fused_renderer(cfg.field_, cfg.grid, cfg.sampler, cfg.render, for_eval=False)
    params = field.params()
    names = list(params)

    loss = torch.mean((render(params, rays, occ).rgb - gt) ** 2)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))

    args = render.kernel_inputs(params, rays, occ)
    out = tf.fused_forward_plain(*args)
    rgb = out[:, 0:3] + (1.0 - out[:, 3])[:, None]
    ref = dict(zip(names, torch.autograd.grad(torch.mean((rgb - gt) ** 2),
                                              [params[k] for k in names])))
    for k in names:
        assert float(ref[k].abs().max()) > 0, k
        assert _rel(grads[k], ref[k]) <= AUTOGRAD_RTOL, (k, _rel(grads[k], ref[k]))
    # field rows 0..2 are x, y, z and rows 27, 28 theta, phi (3 + 3*2*4 = 27):
    # the five rows the affine fold scales
    w0 = grads["trunk.w.0"]
    for row in (0, 1, 2, 27, 28):
        assert float(w0[row].abs().max()) > 0, row
    # no gradient is recorded, and nothing is saved, outside grad mode
    with torch.no_grad():
        assert not render(params, rays, occ).rgb.requires_grad


def test_wrappers_refuse_other_devices_and_bad_cotangents():
    *arrs, cot = _workload(64)
    args = _torch_args(*arrs, False)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tf.fused_backward(*meta, torch.empty((64, 1), device="meta"),
                          torch.empty((64, 6), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tf.fused_forward(*meta)
