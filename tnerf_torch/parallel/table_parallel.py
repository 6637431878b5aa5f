"""Table-parallel (TP) grid encodings: the feature tables sharded over the
mesh's "model" axis (counterpart of `tnerf/parallel/table_parallel.py`).

The hash grid's L level tables live in one level-major [L*T, F] table;
rank m of the "model" axis holds levels [m L/n, (m+1) L/n), rows [m L/n
T, (m+1) L/n T).  The triplane's planes [3, R*R, F] and lines [3, R, F]
shard on the feature axis instead: rank m holds features [m F/n, (m+1)
F/n).  Each rank encodes every position of its rays from its own block
(the positions are replicated over "model") and a tiled all_gather of the
[..., L*F] feature matrix over "model" gives every rank the whole encoding:
features move, tables never do.  The gather's backward is this rank's
block of the cotangent (every rank runs the same MLP on the same
features), so a table's gradient stays on its shard; the positions' is
summed over "model" (`comm.copy_to_group`), as `shard_map` gives it.

Formulation: each rank knows its levels when it starts, so the encode of a
rank's level block is `hashgrid.apply_hashgrid_gather` over those levels,
nearest-interpolated levels (hash_nearest_levels) reading their one
nearest vertex as there.  The reference traces one program for every
shard and snaps a nearest level's fractions to {0, 1} instead, which
makes the trilinear weights one-hot on the same vertex: the same
features, bit for bit, and the same table cotangents.  As in the
reference, the sharded encodes read float32 tables whatever the gather
mode (`_local_encode`, `vm_product_gather` there).

Which leaves shard, with their Adam moments, accumulated gradient and
weight-EMA mirrors: `tp_state_sharding`.  A checkpoint holds the full
layout (`full_tree`), and a resume on any mesh cuts it again
(`shard_tree`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from tnerf_torch.config import FieldConfig
from tnerf_torch.fields.hashgrid import apply_hashgrid_gather
from tnerf_torch.fields.triplane import vm_product_gather
from tnerf_torch.parallel import comm

# leaf name -> the axis it shards along
SHARDED_AXES = {"hashgrid.tables": 0, "triplane.planes": 2, "triplane.lines": 2}


@dataclasses.dataclass(frozen=True)
class TableShard:
    """A field's table-parallel placement: the mesh and its "model" axis."""

    mesh: object
    axis_name: str = "model"

    @property
    def n(self) -> int:
        return self.mesh.size(self.axis_name)

    @property
    def index(self) -> int:
        return self.mesh.coord(self.axis_name)

    @property
    def group(self):
        return self.mesh.group(self.axis_name)


@dataclasses.dataclass(frozen=True)
class ShardedFieldConfig(FieldConfig):
    """A FieldConfig whose table encode runs sharded over `table_shard`
    (the reference's `NeRFField.table_parallel` / `tp_inline` hooks): the
    renderers take it where they take a field config."""

    table_shard: Optional[TableShard] = None


def with_table_shard(field_cfg, mesh, axis_name: str = "model") -> ShardedFieldConfig:
    """field_cfg with its table encode sharded over mesh's `axis_name`,
    checked as `tnerf/train_loop.py` and the encodes check it."""
    if field_cfg.encoding not in ("hashgrid", "triplane"):
        raise ValueError(
            "parallel.table_parallel shards hash-grid level tables or "
            f"triplane features; field_.encoding={field_cfg.encoding!r}"
        )
    shard = TableShard(mesh, axis_name)
    n = shard.n
    if field_cfg.encoding == "hashgrid" and field_cfg.hash_levels % n != 0:
        raise ValueError(
            f"hash_levels={field_cfg.hash_levels} must divide over {n} '{axis_name}' devices"
        )
    if field_cfg.encoding == "triplane" and field_cfg.tri_features % n != 0:
        raise ValueError(
            f"tri_features={field_cfg.tri_features} must divide over {n} '{axis_name}' devices"
        )
    return ShardedFieldConfig(**{f.name: getattr(field_cfg, f.name)
                                 for f in dataclasses.fields(FieldConfig)}, table_shard=shard)


def _local_encode(tables_l: torch.Tensor, x01: torch.Tensor, cfg, level0: int,
                  n_levels: int) -> torch.Tensor:
    """The features [..., n_levels * F] of levels [level0, level0 +
    n_levels) from this rank's block tables_l [n_levels * T, F].  A block
    of nearest-interpolated levels only has no position gradient; the
    positions still enter its graph (times 0), so that the backward's sum
    of the position cotangents over "model" runs on every rank."""
    feats = apply_hashgrid_gather(tables_l, x01, cfg, levels=(level0, level0 + n_levels))
    if x01.requires_grad and level0 + n_levels <= cfg.hash_nearest_levels:
        feats = feats + 0.0 * x01.sum()
    return feats


def tp_encode_local(tables_local: torch.Tensor, x01: torch.Tensor, cfg, group,
                    n_shards: int, index: int) -> torch.Tensor:
    """The level-sharded hash encode: this rank's [L/n * T, F] level block,
    the positions x01 [..., 3] every rank of `group` holds alike -> the
    full [..., L*F] features on every rank (a tiled all_gather over the
    group; backward: this rank's block)."""
    L = cfg.hash_levels
    if L % n_shards != 0:
        raise ValueError(f"hash_levels={L} must divide over {n_shards} devices")
    Ls = L // n_shards
    x01 = comm.copy_to_group(x01, group)
    feats = _local_encode(tables_local, x01, cfg, index * Ls, Ls)
    return comm.all_gather_invariant(feats, group, dim=-1)


def tp_apply_hashgrid(params: Dict[str, torch.Tensor], x01: torch.Tensor, cfg,
                      shard: TableShard) -> torch.Tensor:
    """apply_hashgrid with the level axis sharded over shard's axis: x01
    [..., 3] -> features [..., L*F]."""
    return tp_encode_local(params["hashgrid.tables"], x01, cfg, shard.group, shard.n,
                           shard.index)


def tp_apply_triplane(params: Dict[str, torch.Tensor], x01: torch.Tensor, cfg,
                      shard: TableShard) -> torch.Tensor:
    """apply_triplane with the feature axis sharded: this rank's planes [3,
    R*R, F/n] and lines [3, R, F/n] give its [..., 3, F/n] VM products,
    gathered over the axis into [..., 3, F] (the single-device feature
    order), then [..., 3F]."""
    x01 = comm.copy_to_group(x01, shard.group)
    out = vm_product_gather(params["triplane.planes"], params["triplane.lines"], x01,
                            cfg.tri_resolution)
    out = comm.all_gather_invariant(out, shard.group, dim=-1)
    return out.reshape(*x01.shape[:-1], 3 * cfg.tri_features)


def tp_state_sharding(names) -> Dict[str, int]:
    """{leaf name: the axis it shards along} of the names of a train state's
    leaves (params, Adam's mu / nu, the accumulated gradient and the weight
    EMA share them): the hash tables level-major on rows, triplane planes
    and lines on features; every other leaf is replicated."""
    return {k: SHARDED_AXES[k] for k in names if k in SHARDED_AXES}


def block(t: torch.Tensor, axis: int, n: int, index: int) -> torch.Tensor:
    """Block `index` of n contiguous blocks of t along `axis`."""
    size = t.shape[axis] // n
    return t.narrow(axis, index * size, size)


def shard_tree(tree: Dict[str, torch.Tensor], shard: TableShard) -> Dict[str, torch.Tensor]:
    """A full-layout {name: tensor} with every sharded leaf cut to this
    rank's block (copies, which hold none of the full leaf's memory): the
    reference's `shard_hashgrid_params` and `shard_triplane_params` in one,
    for parameters and for their optimizer and EMA mirrors alike."""
    return {k: (block(v, SHARDED_AXES[k], shard.n, shard.index).clone()
                if k in SHARDED_AXES else v) for k, v in tree.items()}


def full_tree(tree: Dict[str, torch.Tensor], shard: TableShard) -> Dict[str, torch.Tensor]:
    """This rank's {name: tensor} with every sharded leaf gathered over the
    axis into the full layout (a collective: every rank of the mesh calls
    it)."""
    out = {}
    for k, v in tree.items():
        if k in SHARDED_AXES:
            v = torch.cat(comm.gather_blocks(v.detach(), shard.group), dim=SHARDED_AXES[k])
        out[k] = v
    return out


def shard_field(field, mesh, axis_name: str = "model") -> TableShard:
    """Make `field` (a NeRFField holding the full tables) this rank's
    table-parallel field: its table parameters cut to this rank's blocks
    and its config `with_table_shard`; returns the placement."""
    from torch import nn

    field.config = with_table_shard(field.config, mesh, axis_name)
    shard = field.config.table_shard
    with torch.no_grad():
        for k, ax in tp_state_sharding(field.params()).items():
            group, leaf = k.split(".")
            tables = getattr(field, group)
            tables[leaf] = nn.Parameter(block(tables[leaf].data, ax, shard.n,
                                              shard.index).clone())
    return shard
