"""The host side of kernel B2's launch (tnerf_torch/render/fused.py): its
tile schedule over the persistent grid, the grid sizing, and the
wrapper's refusals.  The kernel itself runs only on the card
(`chip_smoke.py`); nothing here needs one."""

import pytest
import torch

from tnerf_torch.render import fused as tf


@pytest.mark.parametrize("S, R", [(16, 4), (32, 2), (48, 1), (64, 1), (100, 1), (256, 1), (5, 12)])
def test_tiles_hold_whole_ray_chunks(S, R):
    B = 1000
    n_tiles, rays = tf.bwd_tiles(B, S)
    assert rays == R
    assert n_tiles == -(-B // R)
    assert rays * min(S, tf.BWD_CHUNK) <= tf.BWD_CHUNK


@pytest.mark.parametrize("n_ctas", [1, 2, 3, 5, 8, 13, 16, 132])
@pytest.mark.parametrize("S", [16, 64, 100, 256])
def test_schedule_assigns_every_ray_chunk_once_in_a_fixed_order(S, n_ctas):
    R = tf.BWD_CHUNK // min(S, tf.BWD_CHUNK)
    B = 29 * R - 1  # not a whole number of tiles, nor of CTAs
    n_chunks = tf.n_bwd_chunks(S)
    plan = tf.bwd_schedule(B, S, n_ctas)
    assert len(plan) == n_ctas
    pairs = [p for work in plan for p in work]
    assert len(pairs) == B * n_chunks
    assert set(pairs) == {(ray, c) for ray in range(B) for c in range(n_chunks)}
    assert plan == tf.bwd_schedule(B, S, n_ctas)  # static: the same every launch
    for k, work in enumerate(plan):
        tiles = [ray // R for ray, _ in work]
        # tiles k, k + n_ctas, ... in turn
        assert tiles == sorted(tiles) and all(t % n_ctas == k for t in tiles)
        # a tile walks its chunks last first, all its rays in step
        for t in sorted(set(tiles)):
            mine = [(ray, c) for ray, c in work if ray // R == t]
            chunks = [c for _, c in mine]
            assert chunks == sorted(chunks, reverse=True)
            assert len(mine) == n_chunks * len(range(t * R, min(B, (t + 1) * R)))


@pytest.mark.parametrize("n_tiles, max_active, want", [
    (8192, 132, 132), (8192, 120, 120), (100, 132, 100), (1, 132, 1), (17, 2, 2), (4096, 1, 1)])
def test_grid_holds_what_the_card_takes_and_no_idle_cta(n_tiles, max_active, want):
    n = tf.bwd_grid(n_tiles, max_active)
    assert n == want
    assert 1 <= n <= max_active and n <= n_tiles


def test_grid_sizing_refuses_a_card_that_holds_no_cta():
    with pytest.raises(ValueError, match="no CTA"):
        tf.bwd_grid(8192, 0)


def _meta_inputs(NL=9, B=64, S=64):
    m = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    args = [m(NL, 128, 128), m(NL, 128), m(B, 128), m(B, 128), m(B), m(B), m(B, 3), m(B, 3),
            m(B, S), m(1024, dtype=torch.int32)]
    return args, m(B, tf.n_bwd_chunks(S)), m(B, 6)


def test_wrapper_accepts_the_default_model_on_meta_tensors():
    args, tchk, gout = _meta_inputs()
    assert tf._check_backward_inputs(*args, tchk, gout, None, None) == (64, 64, 9)


@pytest.mark.parametrize("bad", ["layers", "cotangent", "tchk", "dtype"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args, tchk, gout = _meta_inputs(NL=tf.MAX_BWD_LAYERS + 1 if bad == "layers" else 9)
    if bad == "cotangent":
        gout = torch.empty((64, 5), device="meta")
    if bad == "tchk":
        tchk = torch.empty((64, 2), device="meta")
    if bad == "dtype":
        gout = torch.empty((64, 6), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match=f"at most {tf.MAX_BWD_LAYERS}" if bad == "layers"
                       else ("tchk" if bad == "tchk" else "gout")):
        tf._check_backward_inputs(*args, tchk, gout, None, None)
