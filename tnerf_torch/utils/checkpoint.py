"""Read and write checkpoints in the reference package's layout, without JAX.

The reference writes `step_<N>.npz` (one array per pytree leaf,
`leaf_<i>` in `jax.tree_util` flatten order) plus `treedef.json` (the
treedef string, the leaf count and the last step) — see
`tnerf/utils/checkpoint.py:26-69`.  Flatten order sorts dict keys and
keeps NamedTuple fields in declaration order, so the saved
`(TrainState, OccupancyGridState)` is:

- the params, group by group in sorted order: the frequency-MLP field has
  `trunk` alone, biases first (`params['trunk']['b']`, one per layer), then
  weights (`[in, out]` per layer); a twobranch field `color` (likewise),
  then its encoding's tables (`cp` {lines}, `hashgrid` {tables} or
  `triplane` {lines, planes}), then `trunk`; under `train.freq_anneal_steps`
  the scalar leaf `freq_alpha`, under `train.optimize_poses` the [N, 6]
  leaf `pose_deltas`, each in its sorted place among them;
- the optimizer state: the non-finite skip's three counters (int32, bool,
  int32; only with `train.skip_nonfinite`), then under
  `train.grad_accum_steps` > 1 `MultiStepsState`'s `mini_step` and
  `gradient_step` (int32), Adam's `count`, `mu` and `nu` (each laid out
  like the params), the schedule's `count` (only when the learning rate is
  scheduled; `train.table_lr_mult` and `train.pose_lr_mult` each add a
  masked scale, which holds no leaf), then with accumulation the
  accumulated gradient (laid out like the params; its `skip_state` is
  empty);
- `TrainState.step`, and `TrainState.ema`: `None` (no leaf), or under
  `train.param_ema` the shadow parameters, laid out like the params;
- the last three: `OccupancyGridState(density_ema, bitfield, step)`; the
  uniform pipeline keeps no occupancy grid and saves the `TrainState` alone.

`save_checkpoint` writes exactly this, so the reference's
`restore_checkpoint` reads the port's checkpoints and the port resumes the
reference's.  Anything else (another field, another optimizer) is refused
rather than guessed at.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tnerf_torch.device import resolve_device
from tnerf_torch.grid.occupancy import OccupancyGridState

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


# Top-level parameter groups of the reference's field (`tnerf/fields/
# nerf_field.py:211`): MLPs {'b': [...], 'w': [...]} and the table leaves
# of each table-backed encoding, by their sorted names.
_MLPS = ("color", "trunk")
_TABLES = {"cp": ("lines",), "hashgrid": ("tables",), "triplane": ("lines", "planes")}
# top-level leaves beyond the field (`tnerf/train.py:pose_extra_params`)
# and the shape of each ("N": one row per training view)
_LEAVES = {"freq_alpha": (), "pose_deltas": ("N", 6)}


def _layout(groups: dict) -> Dict[str, object]:
    """{group: layer count (an MLP) or leaf names (a table)}, checked: a
    trunk alone (the fused5d field), or a trunk, a colour head and one
    encoding's tables (twobranch)."""
    tables = [g for g in groups if g in _TABLES]
    unknown = sorted(set(groups) - set(_MLPS) - set(_TABLES) - set(_LEAVES))
    twobranch = "color" in groups
    if unknown or "trunk" not in groups or twobranch != bool(tables) or len(tables) > 1:
        raise ValueError(
            f"parameter groups {sorted(groups)}: only a frequency-MLP trunk, or a trunk, a "
            "colour head and one of the hashgrid / triplane / cp tables (and the pose deltas), "
            "is ported")
    return {g: groups[g] for g in sorted(groups)}


def layout_of(params: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """The layout (`_layout`) of a flat parameter dict."""
    groups: Dict[str, object] = {}
    for k in params:
        g = k.split(".")[0]
        if g in _TABLES:
            groups[g] = _TABLES[g]
        elif g in _LEAVES:
            groups[g] = None
        else:
            groups[g] = sum(1 for n in params if n.startswith(f"{g}.w."))
    return _layout(groups)


def leaf_names(layout: Dict[str, object]) -> list:
    """Flat parameter names in the reference's flatten order: groups sorted,
    an MLP's biases before its weights, a table's leaves sorted."""
    out = []
    for g, v in layout.items():
        if g in _TABLES:
            out += [f"{g}.{leaf}" for leaf in v]
        elif g in _LEAVES:
            out.append(g)
        else:
            out += [f"{g}.b.{l}" for l in range(v)] + [f"{g}.w.{l}" for l in range(v)]
    return out


def _tree(layout: Dict[str, object]) -> str:
    """The params part of the reference's treedef string."""
    parts = []
    for g, v in layout.items():
        if g in _TABLES:
            parts.append(f"'{g}': {{" + ", ".join(f"'{leaf}': *" for leaf in v) + "}")
        elif g in _LEAVES:
            parts.append(f"'{g}': *")
        else:
            stars = ", ".join(["*"] * v)
            parts.append(f"'{g}': {{'b': [{stars}], 'w': [{stars}]}}")
    return "{" + ", ".join(parts) + "}"


def _layout_of_tree(tree: str) -> Dict[str, object]:
    """The layout of a treedef's params part, e.g. "{'trunk': {'b': [*],
    'w': [*]}}"."""
    try:
        nested = ast.literal_eval(tree.replace("*", "0"))
    except (ValueError, SyntaxError) as e:
        raise ValueError(f"unreadable params tree {tree[:120]}...") from e
    if not isinstance(nested, dict):
        raise ValueError(f"params tree {tree[:120]}... is not a dict")
    groups: Dict[str, object] = {}
    for g, v in nested.items():
        if g in _TABLES and v == {leaf: 0 for leaf in _TABLES[g]}:
            groups[g] = _TABLES[g]
        elif g in _LEAVES and v == 0:
            groups[g] = None
        elif isinstance(v, dict) and set(v) == {"b", "w"} and len(v["b"]) == len(v["w"]) \
                and v["w"] and v["b"] == v["w"] == [0] * len(v["w"]):
            groups[g] = len(v["w"])
        else:
            raise ValueError(f"parameter group {g!r} of layout {v!r} is not ported")
    return _layout(groups)


def _mlp_from_jax(name: str, tree: dict, out: Dict[str, torch.Tensor]) -> None:
    if set(tree) != {"w", "b"}:
        raise ValueError(f"params[{name!r}] has keys {sorted(tree)}, expected w and b")
    ws, bs = tree["w"], tree["b"]
    if len(ws) != len(bs) or not ws:
        raise ValueError(f"{name}: {len(ws)} weights but {len(bs)} biases")
    for l, (w, b) in enumerate(zip(ws, bs)):
        w = np.asarray(w)
        b = np.asarray(b)
        if w.dtype != np.float32 or b.dtype != np.float32:
            raise ValueError(f"{name} layer {l}: expected float32 leaves, got {w.dtype} / "
                             f"{b.dtype}")
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(f"{name} layer {l}: weight {w.shape} / bias {b.shape}")
        if l and w.shape[0] != np.shape(ws[l - 1])[1]:
            raise ValueError(f"{name} layer {l} input width {w.shape[0]} != layer {l - 1} output")
        out[f"{name}.w.{l}"] = torch.from_numpy(w.copy())
        out[f"{name}.b.{l}"] = torch.from_numpy(b.copy())


def params_from_jax(np_params: dict) -> Dict[str, torch.Tensor]:
    """The reference's `TrainState.params` pytree -> flat float32 CPU
    tensors, values unchanged: {'trunk': {'w': [...], 'b': [...]}} ->
    "trunk.w.<l>" / "trunk.b.<l>"; a twobranch field adds 'color' (->
    "color.w.<l>" / "color.b.<l>") and one of {'hashgrid': {'tables'}}
    (-> "hashgrid.tables" [L*T, F]), {'triplane': {'lines', 'planes'}}
    (-> "triplane.lines" [3, R, F], "triplane.planes" [3, R*R, F]),
    {'cp': {'lines'}} (-> "cp.lines" [3, R, F]); and 'pose_deltas' [N,
    6] (-> "pose_deltas"), 'freq_alpha' [] (-> "freq_alpha")."""
    _layout({g: None for g in np_params})
    out: Dict[str, torch.Tensor] = {}
    for g in sorted(np_params):
        if g in _MLPS:
            _mlp_from_jax(g, np_params[g], out)
            continue
        if g in _LEAVES:
            a = np.asarray(np_params[g])
            want = _LEAVES[g]
            if a.dtype != np.float32 or a.ndim != len(want) \
                    or any(w != "N" and n != w for n, w in zip(a.shape, want)):
                raise ValueError(f"{g}: {a.dtype} {a.shape}, expected float32 {list(want)}")
            out[g] = torch.from_numpy(a.copy())
            continue
        if set(np_params[g]) != set(_TABLES[g]):
            raise ValueError(f"params[{g!r}] has keys {sorted(np_params[g])}, expected "
                             f"{list(_TABLES[g])}")
        for leaf in _TABLES[g]:
            a = np.asarray(np_params[g][leaf])
            if a.dtype != np.float32 or a.ndim != (2 if g == "hashgrid" else 3):
                raise ValueError(f"{g}.{leaf}: {a.dtype} {a.shape}")
            out[f"{g}.{leaf}"] = torch.from_numpy(a.copy())
    if "triplane" in np_params:
        p, l = out["triplane.planes"].shape, out["triplane.lines"].shape
        if p[0] != 3 or l[0] != 3 or p[1] != l[1] ** 2 or p[2] != l[2]:
            raise ValueError(f"triplane planes {tuple(p)} / lines {tuple(l)}")
    return out


def _nested(layout: Dict[str, object], leaves) -> dict:
    """The params pytree of `layout` from its leaves in flatten order."""
    it = iter(leaves)
    out = {}
    for g, v in layout.items():
        if g in _TABLES:
            out[g] = {leaf: next(it) for leaf in v}
        elif g in _LEAVES:
            out[g] = next(it)
        else:
            b = [next(it) for _ in range(v)]
            out[g] = {"b": b, "w": [next(it) for _ in range(v)]}
    return out


def n_layers(params: Dict[str, torch.Tensor]) -> int:
    """Layers of the trunk."""
    return sum(1 for k in params if k.startswith("trunk.w."))


_STATE = "CustomNode(namedtuple[TrainState], ["
_OCCUPANCY = ", CustomNode(namedtuple[OccupancyGridState], [*, *, *]))"


def _tail(ema_tree: str, with_occupancy: bool) -> str:
    """The end of the treedef string after the optimizer state:
    TrainState's step and ema (`None`, or the params' tree), then the
    OccupancyGridState where there is one."""
    return f", *, {ema_tree}])" + (_OCCUPANCY + ")" if with_occupancy else ")")


class _Leaves(NamedTuple):
    step: int
    layout: Dict[str, object]
    treedef: str
    leaves: list
    has_occupancy: bool
    has_ema: bool


def _read_leaves(ckpt_dir: str) -> _Leaves:
    """The newest checkpoint's leaves, its layout checked."""
    step, path = latest_checkpoint(ckpt_dir)
    with open(os.path.join(ckpt_dir, "treedef.json")) as fh:
        meta = json.load(fh)
    treedef, n = meta["treedef"], int(meta["n_leaves"])
    if treedef.count("*") != n:
        raise ValueError(f"treedef has {treedef.count('*')} leaves, n_leaves says {n}")
    if _STATE not in treedef:
        raise ValueError(f"{ckpt_dir}: not a TrainState checkpoint: {treedef[:160]}...")
    start = treedef.index(_STATE) + len(_STATE)
    depth = 0
    for end in range(start, len(treedef)):
        depth += {"{": 1, "}": -1}.get(treedef[end], 0)
        if depth == 0:
            break
    tree = treedef[start:end + 1]
    layout = _layout_of_tree(tree)
    shape = None
    for ema in (False, True):
        for occ in (False, True):
            head = "PyTreeDef((" if occ else "PyTreeDef("
            if treedef.startswith(head + _STATE) and treedef.endswith(
                    _tail(tree if ema else "None", occ)) and (occ or _OCCUPANCY not in treedef):
                shape = (occ, ema)
    if shape is None:
        raise ValueError(
            f"{ckpt_dir}: unsupported checkpoint layout (only a TrainState, with or without a "
            f"weight EMA and an OccupancyGridState, is ported): {treedef[:160]}...")
    with np.load(path) as data:
        if sorted(data.files) != sorted(f"leaf_{i}" for i in range(n)):
            raise ValueError(f"{path} holds {len(data.files)} leaves; treedef.json says {n}")
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    return _Leaves(step, layout, treedef, leaves, *shape)


def _occupancy_from_leaves(leaves, dev, has_occupancy: bool) -> Optional[OccupancyGridState]:
    if not has_occupancy:
        return None
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


def _params_on(layout, leaves, dev) -> Dict[str, torch.Tensor]:
    return {k: v.to(dev) for k, v in params_from_jax(_nested(layout, leaves)).items()}


def load_jax_checkpoint(ckpt_dir: str, device="cuda", ema: Optional[bool] = None):
    """Newest checkpoint of ckpt_dir -> (step, params, occupancy) on
    `device`: the parameters eval reads (`tnerf/train.py:eval_params`:
    the weight EMA's shadow where the checkpoint holds one, else the live
    parameters), from params_from_jax; occupancy an OccupancyGridState
    whose bitfield is the saved [res]^3 bool grid, or None where the
    checkpoint holds none (the uniform pipeline's).  ema (train.param_ema
    > 0 of the config that reads it), where given, must agree with the
    checkpoint, as the reference's restore template must."""
    dev = resolve_device(device)
    got = _read_leaves(ckpt_dir)
    if ema is not None and ema != got.has_ema:
        raise ValueError(
            f"{ckpt_dir}: the checkpoint {'holds' if got.has_ema else 'has no'} weight EMA, "
            f"but the config's train.param_ema {'is' if ema else 'is not'} > 0 (config "
            "mismatch?)")
    leaves = got.leaves
    if got.has_ema:
        P = len(leaf_names(got.layout))
        i_ema = len(leaves) - (3 if got.has_occupancy else 0) - P
        leaves = leaves[i_ema:i_ema + P]
    return (got.step, _params_on(got.layout, leaves, dev),
            _occupancy_from_leaves(got.leaves, dev, got.has_occupancy))


class TrainCheckpoint(NamedTuple):
    """A checkpoint as a run resumes it: the step, the live parameters,
    the optimizer state (shaped as `train.Optimizer.state`), the occupancy
    grid (or None) and the weight EMA's shadow (or None)."""

    step: int
    params: Dict[str, torch.Tensor]
    opt_state: dict
    occupancy: Optional[OccupancyGridState]
    ema: Optional[Dict[str, torch.Tensor]]


def read_train_checkpoint(ckpt_dir: str, device="cuda") -> TrainCheckpoint:
    """The newest checkpoint of ckpt_dir on `device`.  Which of the
    non-finite counters, MultiSteps' counters and accumulated gradient and
    the schedule's count the optimizer state holds is read from the
    treedef's nodes and checked against the leaf count."""
    dev = resolve_device(device)
    got = _read_leaves(ckpt_dir)
    leaves, treedef = got.leaves, got.treedef
    names = leaf_names(got.layout)
    P = len(names)
    n_ema = P if got.has_ema else 0
    i_step = len(leaves) - (3 if got.has_occupancy else 0) - n_ema - 1
    opt = leaves[P:i_step]  # between the params and (step, ema, occupancy x 3)
    skip = "ApplyIfFiniteState" in treedef
    multi = "MultiStepsState" in treedef
    sched = "ScaleByScheduleState" in treedef
    if len(opt) != 3 * skip + (2 + P) * multi + 1 + 2 * P + sched:
        raise ValueError(f"{ckpt_dir}: optimizer state of {len(opt)} leaves for {P} parameters "
                         "is not an Adam state this port knows")
    t = lambda a: torch.from_numpy(np.array(a)).to(dev)
    it = iter(opt)
    take = lambda: t(next(it))
    state = {}
    if skip:
        state.update(notfinite_count=take(), last_finite=take(), total_notfinite=take())
    if multi:
        state.update(mini_step=take(), gradient_step=take())
    state["count"] = take()
    state["mu"] = {k: take() for k in names}
    state["nu"] = {k: take() for k in names}
    if sched:
        state["sched_count"] = take()
    if multi:
        state["acc"] = {k: take() for k in names}
    if int(leaves[i_step]) != got.step:
        raise ValueError(f"{ckpt_dir}: TrainState.step {int(leaves[i_step])} in step_{got.step} "
                         "file")
    ema = _params_on(got.layout, leaves[i_step + 1:i_step + 1 + n_ema], dev) if n_ema else None
    return TrainCheckpoint(got.step, _params_on(got.layout, leaves, dev), state,
                           _occupancy_from_leaves(leaves, dev, got.has_occupancy), ema)


def load_train_checkpoint(ckpt_dir: str, device="cuda"):
    """Newest checkpoint of ckpt_dir -> (step, params, opt_state,
    occupancy) on `device` (`read_train_checkpoint` without the EMA)."""
    return tuple(read_train_checkpoint(ckpt_dir, device))[:4]


def checkpoint_treedef(layout: Dict[str, object], train_cfg, with_occupancy: bool = True) -> str:
    """The treedef string the reference writes for `(TrainState,
    OccupancyGridState)`, or for the `TrainState` alone, of a field of
    `layout` (`layout_of`) under `train_cfg`'s optimizer
    (`str(jax.tree_util.tree_structure(...))`, `tnerf/train.py:66`) and
    weight EMA (informative: its reader checks only the leaf count, this
    port's reader the parts it names)."""
    tree = _tree(layout)
    empty = "CustomNode(namedtuple[EmptyState], [])"
    scheduled = train_cfg.lr_final_fraction != 1.0 or train_cfg.lr_warmup_steps > 0
    parts = [f"CustomNode(namedtuple[ScaleByAdamState], [*, {tree}, {tree}])"]
    if train_cfg.weight_decay > 0.0:
        parts.append(empty)
    parts.append("CustomNode(namedtuple[ScaleByScheduleState], [*])" if scheduled else empty)
    opt = "(" + ", ".join(parts) + ")"
    if train_cfg.grad_clip > 0.0:
        opt = f"({empty}, {opt})"
    if train_cfg.table_lr_mult != 1.0:
        opt = f"({opt}, CustomNode(namedtuple[MaskedState], [{empty}]))"
    if train_cfg.pose_lr_mult != 1.0:
        opt = f"({opt}, CustomNode(namedtuple[MaskedState], [{empty}]))"
    if train_cfg.grad_accum_steps > 1:
        opt = f"CustomNode(namedtuple[MultiStepsState], [*, *, {opt}, {tree}, ()])"
    if train_cfg.skip_nonfinite:
        opt = f"CustomNode(namedtuple[ApplyIfFiniteState], [*, *, *, {opt}])"
    tail = _tail(tree if train_cfg.param_ema > 0 else "None", with_occupancy)
    return f"PyTreeDef({'(' if with_occupancy else ''}{_STATE}{tree}, {opt}{tail}"


def save_checkpoint(ckpt_dir: str, step: int, params: Dict[str, torch.Tensor], opt_state: dict,
                    occupancy: Optional[OccupancyGridState], train_cfg,
                    ema: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Write ckpt_dir/step_<N>.npz + treedef.json in the reference's layout
    (module docstring).  opt_state: `train.Optimizer.state`; occupancy:
    None for a run that keeps no grid; ema: the weight EMA's shadow, which
    a config with train.param_ema > 0 must give."""
    os.makedirs(ckpt_dir, exist_ok=True)
    layout = layout_of(params)
    names = leaf_names(layout)
    if (ema is not None) != (train_cfg.param_ema > 0):
        raise ValueError(f"a weight EMA {'was' if ema is not None else 'was not'} given, but "
                         f"train.param_ema is {train_cfg.param_ema}")
    host = lambda t: t.detach().cpu().numpy()
    leaves = [host(params[k]) for k in names]
    for k in ("notfinite_count", "last_finite", "total_notfinite", "mini_step",
              "gradient_step"):
        if k in opt_state:
            leaves.append(host(opt_state[k]))
    leaves.append(host(opt_state["count"]))
    leaves += [host(opt_state["mu"][k]) for k in names]
    leaves += [host(opt_state["nu"][k]) for k in names]
    if "sched_count" in opt_state:
        leaves.append(host(opt_state["sched_count"]))
    if "acc" in opt_state:
        leaves += [host(opt_state["acc"][k]) for k in names]
    leaves.append(np.asarray(step, np.int32))
    if ema is not None:
        leaves += [host(ema[k]) for k in names]
    if occupancy is not None:
        leaves += [host(occupancy.density_ema), host(occupancy.bitfield), host(occupancy.step)]
    treedef = checkpoint_treedef(layout, train_cfg, with_occupancy=occupancy is not None)
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


def save_train_state(ckpt_dir: str, step: int, params: Dict[str, torch.Tensor], opt_state: dict,
                     occupancy: Optional[OccupancyGridState], train_cfg,
                     ema: Optional[Dict[str, torch.Tensor]] = None, mesh=None,
                     shard=None) -> None:
    """`save_checkpoint` of a run on a mesh (`parallel.mesh.make_mesh`; None:
    one process): under table parallelism (shard, a
    `parallel.table_parallel.TableShard`) every rank first gathers its
    blocks of the sharded leaves, with their Adam moments, accumulated
    gradient and EMA mirrors, into the full layout; rank 0 writes the
    checkpoint a one-rank run writes, which both packages load, while the
    other ranks wait at a barrier."""
    if shard is not None:
        from tnerf_torch.parallel.table_parallel import full_tree

        params = full_tree(params, shard)
        opt_state = {k: full_tree(v, shard) if isinstance(v, dict) else v
                     for k, v in opt_state.items()}
        ema = None if ema is None else full_tree(ema, shard)
    if mesh is None or mesh.rank == 0:
        save_checkpoint(ckpt_dir, step, params, opt_state, occupancy, train_cfg, ema=ema)
    if mesh is not None:
        mesh.barrier()
