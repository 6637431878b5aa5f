"""The host side of kernel B2's launch (tnerf_torch/render/fused.py): its
tile schedule over the persistent grid, the grid sizing, the scratch of
spilled layer inputs and the plan of shared-memory slots at every depth,
and the wrapper's refusals.  The kernel itself runs only on the card
(`chip_smoke.py`); nothing here needs one."""

import os
import re

import numpy as np
import pytest
import torch

from tnerf_torch.render import fused as tf

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(tf.__file__))), "csrc",
                    "fused_backward.cu")


def _kernel_constant(name):
    with open(CSRC) as fh:
        return int(re.search(rf"constexpr int {name} = (\d+);", fh.read()).group(1))


# Slots the spilled layer inputs rotate through (`kRing` in the kernel).
RING = _kernel_constant("kRing")


def bwd_slots(NL, ring=RING):
    """Where csrc/fused_backward.cu keeps a tile's layer inputs and
    gradients, transcribed from its `slot` and `g_at`: ({v: shared-memory
    slot of layer v's input, v = 1 .. NL - 1}, {m: slot of the gradient at
    layer m's output, or "g" for the gradient tile, m = 0 .. NL - 1}).  Up
    to MAX_BWD_LAYERS layers input v lies in slot v - 1; deeper, the last
    MAX_BWD_LAYERS - 1 inputs keep slots 0 .. 7 and the spilled ones rotate
    through slots 0 .. ring - 1 below them."""
    n_spilled = max(0, NL - tf.MAX_BWD_LAYERS)

    def slot(v):
        k = v - n_spilled - 1
        return k % ring if k < 0 else k

    inputs = {v: slot(v) for v in range(1, NL)}
    grads = {m: "g" if m >= NL - 2 else slot(m + 2) for m in range(NL)}
    return inputs, grads


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
    """A model of no layer, and malformed cotangents or transmittances; any
    depth of at least one layer is taken (below)."""
    args, tchk, gout = _meta_inputs(NL=0 if bad == "layers" else 9)
    if bad == "cotangent":
        gout = torch.empty((64, 5), device="meta")
    if bad == "tchk":
        tchk = torch.empty((64, 2), device="meta")
    if bad == "dtype":
        gout = torch.empty((64, 6), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="at least one layer" if bad == "layers"
                       else ("tchk" if bad == "tchk" else "gout")):
        tf._check_backward_inputs(*args, tchk, gout, None, None)


@pytest.mark.parametrize("NL", [1, 2, 9, 10, 13, 17, 40])
def test_wrapper_accepts_any_depth_on_meta_tensors(NL):
    args, tchk, gout = _meta_inputs(NL=NL)
    assert tf._check_backward_inputs(*args, tchk, gout, None, None) == (64, 64, NL)


@pytest.mark.parametrize("NL", [1, 2, 9, 13, 17])
def test_grad_sums_on_meta_tensors(NL):
    """The kernel's fixed-point sums: int64 qW [NL, 128, 128] and qB [NL,
    128] and the float32 flag, back to back in one buffer (one fill), and
    the f32 gradient the wrapper makes of them."""
    buf, qW, qB, flag = tf.bwd_grad_sums(NL, "meta")
    assert (qW.shape, qW.dtype) == ((NL, 128, 128), torch.int64)
    assert (qB.shape, qB.dtype) == ((NL, 128), torch.int64)
    assert (flag.shape, flag.dtype) == ((1,), torch.float32)
    assert (buf.shape, buf.dtype) == ((NL * 128 * 129 + 1,), torch.int64)
    assert all(t.is_contiguous() for t in (qW, qB, flag))
    assert [t.storage_offset() * t.element_size() for t in (qW, qB, flag)] == \
        [0, NL * 128 * 128 * 8, NL * 128 * 129 * 8]
    g = tf.dequantize_grad(buf[:-1], flag)
    assert (g.shape, g.dtype, g.device.type) == ((NL * 128 * 129,), torch.float32, "meta")


@pytest.mark.parametrize("NL, n_ctas, want", [
    (1, 132, None), (9, 132, None), (10, 132, (132, 1, 64, 128)), (13, 7, (7, 4, 64, 128)),
    (17, 132, (132, 8, 64, 128))])
def test_spill_scratch_holds_each_cta_s_spilled_inputs(NL, n_ctas, want):
    assert tf.bwd_spill_shape(NL, n_ctas) == want
    if NL == 17:  # 17 MB, inside the H100's 50 MB L2
        assert int(np.prod(want)) * 2 == 132 * 8 * 16384


def _walk_slots(NL, ring=RING):
    """The kernel's reads and writes of a tile's shared-memory tiles for one
    chunk, in order, on `bwd_slots`' plan: (forward) layer l reads its
    input and writes layer l + 1's; (backward, last layer first) the reload
    of layer l - 1's input runs beside layer l, which reads its input and
    the gradient at its output and writes the gradient at layer l - 1's
    output, into another tile beside its reads or, for the head, into the
    same one after them.  Fails where a tile is read holding anything but
    what it should, or is written while the layer reads it."""
    inputs, grads = bwd_slots(NL, ring)
    n_spilled = max(0, NL - tf.MAX_BWD_LAYERS)
    held = {"g": ("a", 0)}  # the encoding goes into the gradient tile
    enc = "g" if NL > 2 else 0
    src = lambda l: "g" if l == 0 else inputs[l]
    for l in range(NL):
        assert held[src(l)] == ("a", l), ("forward", l)
        if l + 1 < NL:
            assert inputs[l + 1] != src(l)
            held[inputs[l + 1]] = ("a", l + 1)
    held["g"] = ("g", NL - 1)
    for l in range(NL - 1, -1, -1):
        a = enc if l == 0 else inputs[l]
        busy = {a, grads[l]}
        if l > 0:
            busy.add(grads[l - 1])
        if 1 <= l - 1 <= n_spilled:  # the reload beside this layer
            assert inputs[l - 1] not in busy, ("reload", l - 1)
            held[inputs[l - 1]] = ("a", l - 1)
        if l == 0:
            held[enc] = ("a", 0)
        assert held[a] == ("a", l), ("input", l)
        assert held[grads[l]] == ("g", l), ("gradient", l)
        if l > 0:
            apart = grads[l - 1] != grads[l]
            assert apart or l == NL - 1  # only the head's gradient shares the gradient tile
            if apart:
                assert grads[l - 1] != a
            held[grads[l - 1]] = ("g", l - 1)


@pytest.mark.parametrize("NL", list(range(1, 21)) + [33])
def test_slot_plan_keeps_every_tile_until_it_is_read(NL):
    """The plan of csrc/fused_backward.cu at every depth: up to 9 layers
    input v in slot v - 1 (the resident layout), deeper the last eight
    inputs in slots 0..7 and the spilled ones rotating through slots 0..3;
    no more than eight slots at any depth."""
    assert _kernel_constant("kMaxLayers") == tf.MAX_BWD_LAYERS
    inputs, grads = bwd_slots(NL)
    assert set(inputs.values()) <= set(range(tf.MAX_BWD_LAYERS - 1))
    if NL <= tf.MAX_BWD_LAYERS:
        assert inputs == {v: v - 1 for v in range(1, NL)}
    else:
        assert [inputs[v] for v in range(NL - 8, NL)] == list(range(8))
    assert all(grads[m] == "g" for m in range(max(0, NL - 2), NL))
    _walk_slots(NL)
