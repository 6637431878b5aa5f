"""Kernel B1's plain version and glue against the reference: the Pallas
forward kernel in interpret mode (rpc 1 and 2, in-kernel coarse test)
and its jnp mirror `fused_reference_v2`.

Tolerances: atol 5e-3 for the forward outputs (bf16 activations rounded
in another order, the reference test's own bound); 1e-6 / rtol 1e-5 for
the f32 packing and encoding algebra."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.config import FieldConfig as JField
from tnerf.config import GridConfig as JGrid
from tnerf.render import pallas_fused2 as jf
from tnerf.render.fused_common import _encoding_matrices, _norm_affine
from tnerf_torch.config import FieldConfig, GridConfig
from tnerf_torch.grid.tighten import coarse_constants
from tnerf_torch.grid.tighten import pack_words_rows as t_pack
from tnerf_torch.render import fused as tf


def _params(rng, widths=(81, 128, 128, 128, 128, 128, 128, 128, 128, 4)):
    ws = [rng.normal(0, 0.2, (a, b)).astype(np.float32) for a, b in zip(widths[:-1], widths[1:])]
    bs = [rng.normal(0, 0.1, (b,)).astype(np.float32) for b in widths[1:]]
    return ws, bs


def test_pack_params_matches_reference():
    rng = np.random.default_rng(0)
    ws, bs = _params(rng)
    grid = GridConfig(aabb_min=(-1.5, -1.0, -2.0), aabb_max=(1.0, 1.0, 2.0))
    s, b = _norm_affine(grid)
    jW, jB = jf.pack_params_f32({"trunk": {"w": ws, "b": bs}}, JField(), s, b)
    tp = {f"trunk.w.{l}": torch.from_numpy(w) for l, w in enumerate(ws)}
    tp.update({f"trunk.b.{l}": torch.from_numpy(x) for l, x in enumerate(bs)})
    tW, tB = tf.pack_params_f32(tp, FieldConfig(), s, b)
    np.testing.assert_allclose(tW.numpy(), np.asarray(jW), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tB.numpy(), np.asarray(jB), atol=1e-6, rtol=0)


def test_encode_gamma_beta_matches_reference():
    rng = np.random.default_rng(1)
    B = 256
    o = rng.uniform(-4, 4, (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tp = rng.uniform(-3, 3, (B, 2)).astype(np.float32)
    te = rng.uniform(2, 3, B).astype(np.float32)
    dt = rng.uniform(0.01, 0.05, B).astype(np.float32)
    s, b = _norm_affine(GridConfig())
    A, C, _ = _encoding_matrices(FieldConfig(), s, b)
    jg, jb = jf.encode_gamma_beta(*(jnp.asarray(x) for x in (o, d, tp, te, dt)), A, C)
    tg, tb = tf.encode_gamma_beta(*(torch.from_numpy(x) for x in (o, d, tp, te, dt)), A, C)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6, rtol=1e-5)


def _workload(S, coarse_res):
    """The reference test's workload (tests/test_pallas_fused2.py), plus
    ray geometry and a random coarse bitfield for the in-kernel test."""
    rng = np.random.default_rng(0)
    NL, B = 4, 64
    W = rng.normal(0, 0.3, (NL, 128, 128)).astype(np.float32)
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
    mask[:4] = 0.0  # fully-masked rays must contribute nothing
    occ = rng.uniform(size=(coarse_res,) * 3) < 0.5
    return W, Bias, gamma, beta, te, dt, o, d, mask, occ


def _plain(W, Bias, gamma, beta, te, dt, o, d, mask, occ, coarse=True):
    res_c = occ.shape[0]
    lo, cell, _ = coarse_constants(GridConfig(), res_c)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return tf.fused_forward(t(W), t(Bias), t(gamma), t(beta), t(te), t(dt), t(o), t(d), t(mask),
                            t_pack(t(occ)), (res_c, lo, cell) if coarse else None).numpy()


@pytest.mark.parametrize("rpc,res_c", [(1, 16), (2, 32)])
def test_forward_matches_pallas_kernel_with_coarse_test(rpc, res_c):
    NK = 2
    spr = 128 // rpc
    S = NK * spr
    W, Bias, gamma, beta, te, dt, o, d, mask, occ = _workload(S, res_c)
    B = gamma.shape[0]
    lo = np.asarray(JGrid().aabb_min, np.float32)
    hi = np.asarray(JGrid().aabb_max, np.float32)
    coarse = (res_c, max(1, res_c ** 3 // 4096), tuple(lo), tuple((hi - lo) / res_c))
    fused = jf.make_fused_trainable(4, NK, b_tile=8, term_eps=0.0, interpret=True,
                                    coarse=coarse, rpc=rpc)
    rays8 = np.concatenate([te[:, None], dt[:, None], o, d], axis=1)
    words = jf.pack_occupancy_words(jnp.asarray(occ), res_c, res_c)
    if rpc == 1:
        out = np.asarray(fused(W, Bias, gamma, beta, rays8, mask, words))[:, :6]
    else:
        b_rows = B // rpc
        rays_pack = np.pad(rays8.reshape(b_rows, rpc * 8), ((0, 0), (0, 128 - rpc * 8)))
        mlane = mask.reshape(b_rows, rpc, NK, spr).transpose(0, 2, 1, 3).reshape(b_rows, NK * 128)
        packed = np.asarray(fused(W, Bias, gamma, beta, rays_pack, mlane, words))
        out = packed[:, :6 * rpc].reshape(b_rows, 6, rpc).transpose(0, 2, 1).reshape(B, 6)
    got = _plain(W, Bias, gamma, beta, te, dt, o, d, mask, occ)
    np.testing.assert_allclose(got, out, atol=5e-3, rtol=0)
    # the coarse test really masked samples: without it the outputs move
    assert np.abs(_plain(W, Bias, gamma, beta, te, dt, o, d, mask, occ, coarse=False)
                  - got)[:, 4].max() > 0.05  # depth


def test_forward_matches_jnp_mirror_and_masked_rays_are_empty():
    W, Bias, gamma, beta, te, dt, o, d, mask, occ = _workload(256, 16)
    rays8 = np.concatenate([te[:, None], dt[:, None], np.zeros((len(te), 6), np.float32)], axis=1)
    ref = np.asarray(jf.fused_reference_v2(W, Bias, gamma, beta, rays8, mask))[:, :6]
    got = _plain(W, Bias, gamma, beta, te, dt, o, d, mask, occ, coarse=False)
    np.testing.assert_allclose(got, ref, atol=5e-3, rtol=0)
    np.testing.assert_allclose(got[:4, 0:5], 0.0, atol=1e-7)  # rgb, acc, depth
    np.testing.assert_allclose(got[:4, 5], 1.0, atol=1e-7)    # T_final


def test_select_coarse_res_and_word_packing_match_reference():
    from tnerf.config import RenderConfig as JRender
    from tnerf_torch.config import RenderConfig

    for res in (8, 24, 48, 64, 96):
        for want in (16, 32):
            assert tf.select_coarse_res(RenderConfig(fused_coarse_res=want), res) == \
                jf.select_coarse_res(JRender(fused_coarse_res=want), res)
    occ = np.random.default_rng(3).uniform(size=(64,) * 3) < 0.05
    np.testing.assert_array_equal(
        tf.pack_occupancy_words(torch.from_numpy(occ), 64, 32).numpy(),
        np.asarray(jf.pack_occupancy_words(jnp.asarray(occ), 64, 32)).reshape(-1))
    with pytest.raises(ValueError):
        tf.select_coarse_res(RenderConfig(fused_coarse_res=64), 64)
