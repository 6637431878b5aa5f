"""The port's optimizer against `tnerf.train.create_optimizer` (optax): the
same numpy parameters and the same gradient sequence, one step of it
non-finite, through both for six steps.  Parameters, Adam moments and every
counter agree to 1e-6 relative (f32 arithmetic in another order; pow of the
schedule and the bias correction differ in the last bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tnerf.config import TrainConfig as JTrain
from tnerf.train import create_optimizer as j_create
from tnerf_torch.config import TrainConfig
from tnerf_torch.train import create_optimizer

SHAPES = {"b0": (16,), "b1": (4,), "w0": (9, 16), "w1": (16, 4)}
CASES = {
    "decay": dict(lr_final_fraction=0.1, steps=20),
    "constant": dict(),
    "warmup": dict(lr_final_fraction=0.1, lr_warmup_steps=3, steps=20),
    "warmup_constant": dict(lr_warmup_steps=4),
    "weight_decay": dict(lr_final_fraction=0.1, weight_decay=0.05, steps=20),
    "grad_clip": dict(lr_final_fraction=0.1, grad_clip=0.5, steps=20),
    "schedule_total_steps": dict(lr_final_fraction=0.01, steps=1000, schedule_total_steps=8),
    "no_skip": dict(lr_final_fraction=0.1, steps=20, skip_nonfinite=False),
}


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-9, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_six_steps_match_optax(case):
    kw = CASES[case]
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 2.0, s).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(6)]
    bad = 3 if kw.get("skip_nonfinite", True) else None
    if bad is not None:
        grads[bad]["w0"][2, 5] = np.inf
        grads[bad]["b1"][1] = np.nan

    jopt = j_create(JTrain(**kw))
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = create_optimizer(TrainConfig(**kw), params)

    for i, g in enumerate(grads):
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {k: v.clone() for k, v in params.items()}
        opt.step([torch.from_numpy(g[k]) for k in opt.names])
        for k in SHAPES:
            _close(params[k], jparams[k], f"{case}: step {i}, {k}")
        if i == bad:  # the rejected step changes nothing
            assert all(torch.equal(params[k], before[k]) for k in SHAPES)
        elif not (kw.get("lr_warmup_steps") and i == 0):  # a warmup starts from rate 0
            assert any(not torch.equal(params[k], before[k]) for k in SHAPES)

    # state, leaf by leaf in the reference's flatten order
    st = opt.state
    mine = []
    for k in ("notfinite_count", "last_finite", "total_notfinite"):
        if k in st:
            mine.append(st[k])
    mine.append(st["count"])
    mine += [st["mu"][k] for k in sorted(SHAPES)] + [st["nu"][k] for k in sorted(SHAPES)]
    if "sched_count" in st:
        mine.append(st["sched_count"])
    theirs = jax.tree.leaves(jstate)
    assert len(mine) == len(theirs), (len(mine), len(theirs))
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[1] == str(b.dtype), i
        _close(a.numpy(), b, f"{case}: state leaf {i}")
    if bad is not None:
        assert int(st["total_notfinite"]) == 1 and int(st["count"]) == 5
        assert bool(st["last_finite"]) and int(st["notfinite_count"]) == 0


def test_state_round_trip_and_refusals():
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    a = create_optimizer(TrainConfig(lr_final_fraction=0.1), params)
    a.step([torch.ones(s) for s in SHAPES.values()])
    b = create_optimizer(TrainConfig(lr_final_fraction=0.1),
                         {k: v.clone() for k, v in params.items()})
    b.load_state(a.state)
    assert int(b.count) == 1 and torch.equal(b.mu, a.mu) and torch.equal(b.nu, a.nu)
    with pytest.raises(ValueError, match="optimizer state"):
        create_optimizer(TrainConfig(), params).load_state(a.state)  # no schedule count there
    with pytest.raises(NotImplementedError, match="not yet ported"):
        create_optimizer(TrainConfig(grad_accum_steps=2), params)
