"""The host side of kernel B1's launch (tnerf_torch/render/fused.py): its
tile schedule over the persistent grid, the grid sizing, the skip rule it
shares with kernel B2, and the wrapper's refusals.  The kernel itself runs
only on the card (`chip_smoke.py`); nothing here needs one."""

import numpy as np
import pytest
import torch

from tnerf_torch.render import fused as tf


@pytest.mark.parametrize("n_ctas", [1, 2, 3, 7, 13, 132])
@pytest.mark.parametrize("S", [5, 16, 64, 100, 256])
def test_schedule_shades_every_ray_chunk_once_first_to_last(S, n_ctas):
    R = tf.BWD_CHUNK // min(S, tf.BWD_CHUNK)
    B = 29 * R - 1  # not a whole number of tiles, nor of CTAs
    n_chunks = tf.n_bwd_chunks(S)
    plan = tf.fwd_schedule(B, S, n_ctas)
    assert len(plan) == n_ctas and all(len(groups) == tf.FWD_GROUPS for groups in plan)
    pairs = [p for groups in plan for work in groups for p in work]
    assert len(pairs) == B * n_chunks
    assert set(pairs) == {(ray, c) for ray in range(B) for c in range(n_chunks)}
    assert plan == tf.fwd_schedule(B, S, n_ctas)  # static: the same every launch
    per_round = tf.FWD_GROUPS * tf.FWD_TILES_PER_GROUP
    for k, groups in enumerate(plan):
        mine = sorted({ray // R for work in groups for ray, _ in work})
        # CTA k's tiles are k, k + n_ctas, ...; its i-th goes to warpgroup
        # (i % per_round) // FWD_TILES_PER_GROUP
        assert mine == list(range(k, -(-B // R), n_ctas))
        for g, work in enumerate(groups):
            tiles = [ray // R for ray, _ in work]
            assert all((mine.index(t) % per_round) // tf.FWD_TILES_PER_GROUP == g for t in tiles)
            for t in sorted(set(tiles)):
                chunks = [c for ray, c in work if ray // R == t]
                # first to last, all the tile's rays in step
                n_rays = len(range(t * R, min(B, (t + 1) * R)))
                assert chunks == [c for c in range(n_chunks) for _ in range(n_rays)]
            # a round's tiles walk their chunks together: chunk c of every tile
            # of the round before chunk c + 1 of any
            for r in sorted({mine.index(t) // per_round for t in tiles}):
                steps = [c for ray, c in work if mine.index(ray // R) // per_round == r]
                assert steps == sorted(steps)


@pytest.mark.parametrize("n_tiles, max_active, want", [
    (8192, 132, 132), (32000, 132, 132), (100, 132, 100), (1, 132, 1), (17, 2, 2)])
def test_grid_holds_what_the_card_takes_and_no_idle_cta(n_tiles, max_active, want):
    n = tf.fwd_grid(n_tiles, max_active)
    assert n == want
    assert 1 <= n <= max_active and n <= n_tiles


def test_grid_sizing_refuses_a_card_that_holds_no_cta():
    with pytest.raises(ValueError, match="fused_forward: the card holds no CTA"):
        tf.fwd_grid(8192, 0)


def _b2_skipped(live, tchk, term_eps):
    """The rule fused_backward.cu applies, written as it is there: chunk c
    of a tile is recomputed when a sample of the tile's chunk is live and a
    ray of the tile entered the forward's (128-sample) chunk that holds it,
    tchk[ray, ((c ch) / fch) fch / ch], above term_eps."""
    B, S = live.shape
    ch, fch = min(S, 64), min(S, 128)
    n_tiles, R = tf.bwd_tiles(B, S)
    out = np.zeros((B, tf.n_bwd_chunks(S)), dtype=bool)
    for tile in range(n_tiles):
        rays = range(tile * R, min(B, (tile + 1) * R))
        for c in range(tf.n_bwd_chunks(S)):
            any_sample = any(live[ray, c * ch:(c + 1) * ch].any() for ray in rays)
            alive = any(tchk[ray, ((c * ch) // fch) * fch // ch] > term_eps for ray in rays)
            for ray in rays:
                out[ray, c] = not (any_sample and alive)
    return out


@pytest.mark.parametrize("S", [5, 32, 48, 64, 100, 192, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_skip_rule_helper_selects_what_the_backward_kernel_skips(S, seed):
    rng = np.random.default_rng(seed)
    B = 37
    n_chunks = tf.n_bwd_chunks(S)
    live = rng.uniform(size=(B, S)) < 0.05
    live[rng.uniform(size=B) < 0.3] = False  # some rays with no live sample at all
    # entry transmittance falling along each ray, some rays opaque early
    tchk = np.cumprod(rng.uniform(0.0, 1.0, size=(B, n_chunks)) ** 3, axis=1)
    tchk[:, 0] = 1.0
    tchk = tchk.astype(np.float32)
    eps = 1e-2
    got = tf.unshaded_chunks(torch.from_numpy(live), torch.from_numpy(tchk), eps).numpy()
    want = _b2_skipped(live, tchk, eps)
    assert np.array_equal(got, want)
    assert 0 < want.sum() < want.size  # the case exercises both decisions


def _meta_inputs(NL=9, B=64, S=64, wdtype=torch.float32):
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    return [m(NL, 128, 128, dtype=wdtype), m(NL, 128), m(B, 128), m(B, 128), m(B), m(B),
            m(B, 3), m(B, 3), m(B, S), m(1024, dtype=torch.int32)]


@pytest.mark.parametrize("NL, wdtype", [(9, torch.float32), (9, torch.bfloat16),
                                        (12, torch.float32), (1, torch.bfloat16)])
def test_wrapper_accepts_the_default_model_and_any_depth_on_meta_tensors(NL, wdtype):
    args = _meta_inputs(NL=NL, wdtype=wdtype)
    tf._check_fused_inputs("fused_forward", *args, None, None)
    shaded = torch.empty((64, tf.n_bwd_chunks(64)), dtype=torch.uint8, device="meta")
    tf.build.check_tensor("shaded", shaded, (64, 1), torch.uint8, torch.device("meta"))


@pytest.mark.parametrize("bad", ["wdtype", "width", "placement", "shaded_shape", "shaded_dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args = _meta_inputs(wdtype=torch.float16 if bad == "wdtype" else torch.float32)
    if bad == "width":
        args[0] = torch.empty((9, 64, 128), device="meta")
    ts = torch.empty((64, 64), device="meta") if bad == "placement" else None
    if bad.startswith("shaded"):
        shaded = torch.empty((64, 2) if bad == "shaded_shape" else (64, 1),
                             dtype=torch.uint8 if bad == "shaded_shape" else torch.bool,
                             device="meta")
        with pytest.raises(ValueError, match="shaded"):
            tf._shaded_arg(shaded, 64, 64, torch.device("meta"))
        return
    with pytest.raises(ValueError, match="W" if bad in ("wdtype", "width") else "ts and dts"):
        tf._check_fused_inputs("fused_forward", *args, ts, None)


def test_weights_are_rounded_once_and_a_bf16_copy_is_used_as_it_is():
    W = torch.randn((3, 128, 128))
    Wk = tf._weights_bf16(W)
    assert Wk.dtype == torch.bfloat16 and torch.equal(Wk.float(), W.to(torch.bfloat16).float())
    assert tf._weights_bf16(Wk) is Wk
