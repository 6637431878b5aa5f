"""Read a checkpoint written by the reference package, without JAX.

The reference writes `step_<N>.npz` (one array per pytree leaf,
`leaf_<i>` in `jax.tree_util` flatten order) plus `treedef.json` (the
treedef string, the leaf count and the last step) — see
`tnerf/utils/checkpoint.py:26-69`.  Flatten order sorts dict keys and
keeps NamedTuple fields in declaration order, so for the fused
frequency-MLP model the saved `(TrainState, OccupancyGridState)` is:

- leaves `0..L-1`: `params['trunk']['b']` (one bias per layer),
- leaves `L..2L-1`: `params['trunk']['w']` (`[in, out]` per layer),
- then the optimizer state (Adam moments: read by the training slice),
- then `TrainState.step`, and `TrainState.ema` (must be `None`),
- the last three: `OccupancyGridState(density_ema, bitfield, step)`.

Anything else (a weight EMA, pose deltas, another field, a state-only
checkpoint) is refused rather than guessed at.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Tuple

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


def load_jax_checkpoint(ckpt_dir: str, device="cuda"):
    """Newest checkpoint of ckpt_dir -> (step, params, occupancy) on
    `device`: params from params_from_jax, occupancy an
    OccupancyGridState whose bitfield is the saved [res]^3 bool grid."""
    dev = resolve_device(device)
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
    params = params_from_jax({"trunk": {"b": leaves[:L], "w": leaves[L:2 * L]}})
    ema, bits, occ_step = leaves[n - 3:]
    if bits.dtype != np.bool_ or bits.ndim != 3 or len(set(bits.shape)) != 1 \
            or ema.shape != bits.shape or occ_step.shape != ():
        raise ValueError(
            f"occupancy leaves: density_ema {ema.shape}, bitfield {bits.shape} {bits.dtype}, "
            f"step {occ_step.shape}"
        )
    occ = OccupancyGridState(
        density_ema=torch.from_numpy(np.asarray(ema, np.float32).copy()).to(dev),
        bitfield=torch.from_numpy(bits.copy()).to(dev),
        step=torch.tensor(int(occ_step), dtype=torch.int32, device=dev),
    )
    return step, {k: v.to(dev) for k, v in params.items()}, occ
