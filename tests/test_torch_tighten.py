"""Kernel B3's plain version against the reference's Pallas tighten
kernel in interpret mode: bit-exact (assert_array_equal), as the
reference's train-time and eval-time spans must agree.

The reference runs in a subprocess with XLA:CPU limited to AVX.  With
FMA instructions available, XLA:CPU contracts the probe depth
te + span * frac into one fused multiply-add inside the interpreted
kernel at res_c=32 (not at 16), which moves some spans by one ulp; the
kernel's source rounds the product and the sum separately, and so does
the port."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tnerf.grid.pallas_dda import pack_words_rows as j_pack
from tnerf.grid.traversal import make_coarse_occupancy as j_pool
from tnerf.grid.traversal import ray_aabb as j_aabb
from tnerf_torch.config import Config, GridConfig
from tnerf_torch.grid.tighten import pack_words_rows as t_pack
from tnerf_torch.grid.tighten import tighten_range
from tnerf_torch.grid.traversal import make_coarse_occupancy as t_pool
from tnerf_torch.grid.traversal import ray_aabb as t_aabb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "runs", "suite_rehearsal", "prims")
NPZ = os.path.join(RUN, "checkpoints", "step_00001500.npz")

_REFERENCE = """
import sys
import numpy as np
import jax.numpy as jnp
from tnerf.config import GridConfig
from tnerf.grid.pallas_dda import pack_words_rows, tighten_range_pallas
inp = np.load(sys.argv[1])
out = {}
for case in inp["cases"]:
    o, d, te, tx, occ = (inp[f"{case}_{k}"] for k in ("o", "d", "te", "tx", "occ"))
    t0, t1 = tighten_range_pallas(jnp.asarray(o), jnp.asarray(d), jnp.asarray(te),
                                  jnp.asarray(tx), pack_words_rows(jnp.asarray(occ)),
                                  occ.shape[0], GridConfig(), interpret=True)
    out[f"{case}_t0"], out[f"{case}_t1"] = np.asarray(t0), np.asarray(t1)
np.savez(sys.argv[2], **out)
"""


def _spans(o, d, near=2.0):
    te, tx = t_aabb(torch.from_numpy(o), torch.from_numpy(d), (-1, -1, -1), (1, 1, 1))
    te = torch.clamp_min(te, near)
    return te.numpy(), torch.maximum(tx, te).numpy()


def _random_rays(n, seed):
    """Camera-like rays from radius 3..4 towards a jittered point near the
    origin, with the renderer's near clamp applied to the AABB span."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * rng.uniform(3.0, 4.0, (n, 1))
    d = rng.uniform(-0.6, 0.6, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    return (o, d, *_spans(o, d))


def _view0_rays():
    """512 rays of test view 0 of the committed prims model at 32x32."""
    from tnerf_torch.cameras import camera_rays
    from tnerf_torch.data.procedural import CAMERA_ANGLE_X, sphere_poses
    from tnerf_torch.cameras import focal_from_angle

    cfg = Config.from_json_file(os.path.join(RUN, "config.json"))
    rays = camera_rays(sphere_poses(8, seed=30)[0], 32, 32, focal_from_angle(32, CAMERA_ANGLE_X),
                       device="cpu")
    o = rays.origins[8:24].reshape(-1, 3).numpy()
    d = rays.directions[8:24].reshape(-1, 3).numpy()
    return (o, d, *_spans(o, d, cfg.sampler.near))


def _cases():
    with np.load(NPZ) as data:
        occ64 = data["leaf_61"]
    rng = np.random.default_rng(5)
    sparse = rng.uniform(size=(64,) * 3) < 0.004
    return {
        "rand16": (_random_rays(2048, 7), sparse, 16),
        "rand32": (_random_rays(2048, 8), sparse, 32),
        "ckpt32": (_random_rays(2048, 9), occ64, 32),
        "view0": (_view0_rays(), occ64, 32),
    }


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tighten")
    cases = _cases()
    inp = {"cases": np.asarray(list(cases))}
    for name, ((o, d, te, tx), occ64, res_c) in cases.items():
        occ_c = np.asarray(j_pool(jnp.asarray(occ64), 64 // res_c))
        inp.update({f"{name}_o": o, f"{name}_d": d, f"{name}_te": te, f"{name}_tx": tx,
                    f"{name}_occ": occ_c})
    np.savez(tmp / "in.npz", **inp)
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_cpu_max_isa=AVX --xla_backend_optimization_level=0"}
    subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   env=env, check=True, timeout=600)
    with np.load(tmp / "out.npz") as out:
        return cases, {k: out[k] for k in out.files}


@pytest.mark.parametrize("res_c", [8, 16, 32])
def test_pack_words_rows_matches_reference(res_c):
    occ = np.random.default_rng(res_c).uniform(size=(res_c,) * 3) < 0.3
    np.testing.assert_array_equal(
        t_pack(torch.from_numpy(occ)).numpy(), np.asarray(j_pack(jnp.asarray(occ))).reshape(-1))


def test_ray_aabb_and_pooling_match_reference():
    o, d, _, _ = _random_rays(512, 4)
    te, tx = t_aabb(torch.from_numpy(o), torch.from_numpy(d), (-1, -1, -1), (1, 1, 1))
    jte, jtx = j_aabb(jnp.asarray(o), jnp.asarray(d), (-1, -1, -1), (1, 1, 1))
    np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jtx))
    with np.load(NPZ) as data:
        occ64 = data["leaf_61"]
    np.testing.assert_array_equal(t_pool(torch.from_numpy(occ64), 2).numpy(),
                                  np.asarray(j_pool(jnp.asarray(occ64), 2)))


@pytest.mark.parametrize("case", ["rand16", "rand32", "ckpt32", "view0"])
def test_tighten_plain_bit_exact_with_reference(reference, case):
    cases, ref = reference
    (o, d, te, tx), occ64, res_c = cases[case]
    occ_c = t_pool(torch.from_numpy(occ64.copy()), 64 // res_c)
    t0, t1 = tighten_range(*(torch.from_numpy(a) for a in (o, d, te, tx)), t_pack(occ_c),
                           res_c, GridConfig())
    np.testing.assert_array_equal(t0.numpy(), ref[f"{case}_t0"])
    np.testing.assert_array_equal(t1.numpy(), ref[f"{case}_t1"])
    shrunk = (t0.numpy() > te) | (t1.numpy() < tx)
    assert 0.05 < shrunk.mean() < 1.0  # the case exercises both hits and misses


@pytest.mark.parametrize("pooled", [False, True])
def test_occupancy_lookup_matches_reference(pooled):
    from tnerf.config import GridConfig as JGrid
    from tnerf.grid.traversal import occupancy_lookup as j_lookup
    from tnerf_torch.grid.traversal import occupancy_lookup as t_lookup

    with np.load(NPZ) as data:
        occ = data["leaf_61"]
    if pooled:
        occ = np.asarray(j_pool(jnp.asarray(occ), 2))
    x = np.random.default_rng(11).uniform(-1.2, 1.2, (8192, 3)).astype(np.float32)
    got = t_lookup(torch.from_numpy(x), torch.from_numpy(occ.copy()), GridConfig()).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_lookup(jnp.asarray(x), jnp.asarray(occ), JGrid())))
    assert 0.01 < got.mean() < 0.9
