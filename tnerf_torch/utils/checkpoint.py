"""Read and write checkpoints in the reference package's layout, without JAX.

The reference writes `step_<N>.npz` (one array per pytree leaf,
`leaf_<i>` in `jax.tree_util` flatten order) plus `treedef.json` (the
treedef string, the leaf count and the last step) — see
`tnerf/utils/checkpoint.py:26-69`.  Flatten order sorts dict keys and
keeps NamedTuple fields in declaration order, so for the fused
frequency-MLP model the saved `(TrainState, OccupancyGridState)` is, with
L layers:

- leaves `0..L-1`: `params['trunk']['b']` (one bias per layer),
- leaves `L..2L-1`: `params['trunk']['w']` (`[in, out]` per layer),
- the optimizer state: the non-finite skip's three counters (int32, bool,
  int32; only with `train.skip_nonfinite`), Adam's `count`, `mu` and `nu`
  (each laid out like the params), the schedule's `count` (only when the
  learning rate is scheduled),
- `TrainState.step`, and `TrainState.ema` (must be `None`),
- the last three: `OccupancyGridState(density_ema, bitfield, step)`.

`save_checkpoint` writes exactly this, so the reference's
`restore_checkpoint` reads the port's checkpoints and the port resumes the
reference's.  Anything else (a weight EMA, pose deltas, another field, a
state-only checkpoint) is refused rather than guessed at.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tnerf_torch.device import resolve_device
from tnerf_torch.grid.occupancy import OccupancyGridState

_HEAD = "PyTreeDef((CustomNode(namedtuple[TrainState], [{{'trunk': {{'b': [{b}], 'w': [{w}]}}}}, "
_TAIL = ", *, None]), CustomNode(namedtuple[OccupancyGridState], [*, *, *])))"


def latest_checkpoint(ckpt_dir: str) -> Tuple[int, str]:
    """(step, path) of the newest `step_<N>.npz` in ckpt_dir; raises
    FileNotFoundError when there is none."""
    best = None
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            m = re.fullmatch(r"step_(\d+)\.npz", name)
            if m and (best is None or int(m.group(1)) > best[0]):
                best = (int(m.group(1)), os.path.join(ckpt_dir, name))
    if best is None:
        raise FileNotFoundError(f"no step_*.npz checkpoint in {ckpt_dir}")
    return best


def params_from_jax(np_params: dict) -> Dict[str, torch.Tensor]:
    """The reference's `TrainState.params` pytree ({'trunk': {'w': [...],
    'b': [...]}} of arrays) -> flat {"trunk.w.<l>", "trunk.b.<l>"} float32
    CPU tensors, values unchanged."""
    if set(np_params) != {"trunk"} or set(np_params["trunk"]) != {"w", "b"}:
        raise ValueError(
            f"expected params {{'trunk': {{'w', 'b'}}}}, got keys {sorted(np_params)}: "
            "only the frequency-MLP trunk is ported"
        )
    ws, bs = np_params["trunk"]["w"], np_params["trunk"]["b"]
    if len(ws) != len(bs) or not ws:
        raise ValueError(f"{len(ws)} weights but {len(bs)} biases")
    out = {}
    for l, (w, b) in enumerate(zip(ws, bs)):
        w = np.asarray(w)
        b = np.asarray(b)
        if w.dtype != np.float32 or b.dtype != np.float32:
            raise ValueError(f"layer {l}: expected float32 leaves, got {w.dtype} / {b.dtype}")
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"layer {l}: weight {w.shape} / bias {b.shape}")
        if l and w.shape[0] != ws[l - 1].shape[1]:
            raise ValueError(f"layer {l} input width {w.shape[0]} != layer {l - 1} output")
        out[f"trunk.w.{l}"] = torch.from_numpy(w.copy())
        out[f"trunk.b.{l}"] = torch.from_numpy(b.copy())
    return out


def n_layers(params: Dict[str, torch.Tensor]) -> int:
    return sum(1 for k in params if k.startswith("trunk.w."))


def _read_leaves(ckpt_dir: str):
    """(step, L, treedef, leaves) of the newest checkpoint, its layout checked."""
    step, path = latest_checkpoint(ckpt_dir)
    with open(os.path.join(ckpt_dir, "treedef.json")) as fh:
        meta = json.load(fh)
    treedef, n = meta["treedef"], int(meta["n_leaves"])
    if treedef.count("*") != n:
        raise ValueError(f"treedef has {treedef.count('*')} leaves, n_leaves says {n}")
    m = re.match(r"PyTreeDef\(\(CustomNode\(namedtuple\[TrainState\], \[\{'trunk': \{'b': \[([*, ]*)\]",
                 treedef)
    L = m.group(1).count("*") if m else 0
    stars = ", ".join(["*"] * L)
    if L == 0 or not treedef.startswith(_HEAD.format(b=stars, w=stars)) \
            or not treedef.endswith(_TAIL):
        raise ValueError(
            f"{ckpt_dir}: unsupported checkpoint layout (only a TrainState of "
            "params.trunk with no weight EMA, plus an OccupancyGridState, is ported): "
            f"{treedef[:160]}..."
        )
    with np.load(path) as data:
        if sorted(data.files) != sorted(f"leaf_{i}" for i in range(n)):
            raise ValueError(f"{path} holds {len(data.files)} leaves; treedef.json says {n}")
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    return step, L, treedef, leaves


def _occupancy_from_leaves(leaves, dev) -> OccupancyGridState:
    ema, bits, occ_step = leaves[-3:]
    if bits.dtype != np.bool_ or bits.ndim != 3 or len(set(bits.shape)) != 1 \
            or ema.shape != bits.shape or occ_step.shape != ():
        raise ValueError(
            f"occupancy leaves: density_ema {ema.shape}, bitfield {bits.shape} {bits.dtype}, "
            f"step {occ_step.shape}"
        )
    return OccupancyGridState(
        density_ema=torch.from_numpy(np.asarray(ema, np.float32).copy()).to(dev),
        bitfield=torch.from_numpy(bits.copy()).to(dev),
        step=torch.tensor(int(occ_step), dtype=torch.int32, device=dev),
    )


def load_jax_checkpoint(ckpt_dir: str, device="cuda"):
    """Newest checkpoint of ckpt_dir -> (step, params, occupancy) on
    `device`: params from params_from_jax, occupancy an
    OccupancyGridState whose bitfield is the saved [res]^3 bool grid."""
    dev = resolve_device(device)
    step, L, _, leaves = _read_leaves(ckpt_dir)
    params = params_from_jax({"trunk": {"b": leaves[:L], "w": leaves[L:2 * L]}})
    return step, {k: v.to(dev) for k, v in params.items()}, _occupancy_from_leaves(leaves, dev)


def load_train_checkpoint(ckpt_dir: str, device="cuda"):
    """Newest checkpoint of ckpt_dir -> (step, params, opt_state,
    occupancy) on `device`.  opt_state has the shape of
    `train.Optimizer.state`: which of the non-finite counters and the
    schedule's count it holds follows from the leaf count."""
    dev = resolve_device(device)
    step, L, treedef, leaves = _read_leaves(ckpt_dir)
    names = [f"trunk.b.{l}" for l in range(L)] + [f"trunk.w.{l}" for l in range(L)]
    params = params_from_jax({"trunk": {"b": leaves[:L], "w": leaves[L:2 * L]}})
    opt = leaves[2 * L:-4]  # between the params and (step, occupancy x 3); ema=None is no leaf
    extra = len(opt) - (1 + 4 * L)
    if extra not in (0, 1, 3, 4) \
            or ("ApplyIfFiniteState" in treedef) != (extra >= 3) \
            or ("ScaleByScheduleState" in treedef) != (extra in (1, 4)):
        raise ValueError(f"{ckpt_dir}: optimizer state of {len(opt)} leaves for {L} layers is "
                         "not an Adam state this port knows")
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    state = {}
    if extra >= 3:
        state.update(notfinite_count=t(opt[0]), last_finite=t(opt[1]), total_notfinite=t(opt[2]))
        opt = opt[3:]
    state["count"] = t(opt[0])
    state["mu"] = {k: t(a) for k, a in zip(names, opt[1:1 + 2 * L])}
    state["nu"] = {k: t(a) for k, a in zip(names, opt[1 + 2 * L:1 + 4 * L])}
    if extra in (1, 4):
        state["sched_count"] = t(opt[1 + 4 * L])
    if int(leaves[-4]) != step:
        raise ValueError(f"{ckpt_dir}: TrainState.step {int(leaves[-4])} in step_{step} file")
    return (step, {k: v.to(dev) for k, v in params.items()}, state,
            _occupancy_from_leaves(leaves, dev))


def checkpoint_treedef(L: int, train_cfg) -> str:
    """The treedef string the reference writes for `(TrainState,
    OccupancyGridState)` of an L-layer trunk under `train_cfg`'s optimizer
    (`str(jax.tree_util.tree_structure(...))`; informative: its reader
    checks only the leaf count, this port's reader the parts it names)."""
    stars = ", ".join(["*"] * L)
    tree = f"{{'trunk': {{'b': [{stars}], 'w': [{stars}]}}}}"
    empty = "CustomNode(namedtuple[EmptyState], [])"
    scheduled = train_cfg.lr_final_fraction != 1.0 or train_cfg.lr_warmup_steps > 0
    parts = [f"CustomNode(namedtuple[ScaleByAdamState], [*, {tree}, {tree}])"]
    if train_cfg.weight_decay > 0.0:
        parts.append(empty)
    parts.append("CustomNode(namedtuple[ScaleByScheduleState], [*])" if scheduled else empty)
    opt = "(" + ", ".join(parts) + ")"
    if train_cfg.grad_clip > 0.0:
        opt = f"({empty}, {opt})"
    if train_cfg.skip_nonfinite:
        opt = f"CustomNode(namedtuple[ApplyIfFiniteState], [*, *, *, {opt}])"
    return _HEAD.format(b=stars, w=stars) + opt + _TAIL


def save_checkpoint(ckpt_dir: str, step: int, params: Dict[str, torch.Tensor], opt_state: dict,
                    occupancy: OccupancyGridState, train_cfg) -> str:
    """Write ckpt_dir/step_<N>.npz + treedef.json in the reference's layout
    (module docstring).  opt_state: `train.Optimizer.state`."""
    os.makedirs(ckpt_dir, exist_ok=True)
    L = n_layers(params)
    names = [f"trunk.b.{l}" for l in range(L)] + [f"trunk.w.{l}" for l in range(L)]
    host = lambda t: t.detach().cpu().numpy()
    leaves = [host(params[k]) for k in names]
    for k in ("notfinite_count", "last_finite", "total_notfinite"):
        if k in opt_state:
            leaves.append(host(opt_state[k]))
    leaves.append(host(opt_state["count"]))
    leaves += [host(opt_state["mu"][k]) for k in names]
    leaves += [host(opt_state["nu"][k]) for k in names]
    if "sched_count" in opt_state:
        leaves.append(host(opt_state["sched_count"]))
    leaves.append(np.asarray(step, np.int32))
    leaves += [host(occupancy.density_ema), host(occupancy.bitfield), host(occupancy.step)]
    treedef = checkpoint_treedef(L, train_cfg)
    if treedef.count("*") != len(leaves):
        raise ValueError(f"{len(leaves)} leaves to write, but the optimizer of this config "
                         f"has a state of {treedef.count('*')}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, "treedef.json"), "w") as fh:
        json.dump({"treedef": treedef, "n_leaves": len(leaves), "last_step": step}, fh)
    return path
