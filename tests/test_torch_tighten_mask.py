"""Kernel B4's plain version against the reference's Pallas tighten +
sample-mask kernel in interpret mode: t0, t1 and the mask bit-equal
(assert_array_equal), as the reference's bin weights and keep rule must
be the port's.

The reference runs in a subprocess with XLA:CPU limited to AVX: with FMA
instructions available, XLA:CPU contracts te + span * frac and
t0 + dt * (s + 0.5) into fused multiply-adds inside the interpreted
kernel, which moves some depths by one ulp; the kernel's source rounds
the product and the sum separately, and so does the port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tnerf_torch.config import GridConfig
from tnerf_torch.grid.tighten import (
    pack_words_rows,
    tighten_range_plain,
    tighten_sample_mask,
    tighten_sample_mask_plain,
)
from tnerf_torch.grid.traversal import make_coarse_occupancy, ray_aabb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "runs", "suite_rehearsal", "prims", "checkpoints", "step_00001500.npz")
CASES = [(res_c, n, kind, 256) for res_c in (16, 32) for n in (16, 64)
         for kind in ("model", "random")]
# the march's 64 probes (16^3, 96 midpoints) and a count that is not a
# multiple of any lane group
CASES += [(16, 96, "model", 64), (32, 64, "random", 64), (16, 16, "random", 100),
          (32, 64, "model", 100)]
PARAMS = [pytest.param(*case, id="-".join(map(str, case[:3])) if case[3] == 256
                       else "-".join(map(str, case[:3])) + f"-probes{case[3]}") for case in CASES]

_REFERENCE = """
import sys
import numpy as np
import jax.numpy as jnp
from tnerf.config import GridConfig
from tnerf.grid.pallas_dda import tighten_sample_mask_pallas
inp = np.load(sys.argv[1])
o, d, te, tx = (jnp.asarray(inp[k]) for k in ("o", "d", "te", "tx"))
out = {}
for case in inp["cases"]:
    res_c, n, kind, probes = case.split("_")
    t0, t1, mask = tighten_sample_mask_pallas(o, d, te, tx, jnp.asarray(inp[f"occ_{kind}_{res_c}"]),
                                              int(n), GridConfig(), probes=int(probes),
                                              interpret=True)
    out[f"{case}_t0"], out[f"{case}_t1"] = np.asarray(t0), np.asarray(t1)
    out[f"{case}_mask"] = np.asarray(mask)
np.savez(sys.argv[2], **out)
"""


def _rays(n=1024, seed=7, near=2.0):
    """Camera-like rays from radius 3..4 towards a jittered point near the
    origin (a tenth of them miss the box), with the renderer's near clamp."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * rng.uniform(3.0, 4.0, (n, 1))
    target = rng.uniform(-0.6, 0.6, (n, 3))
    target[: n // 10] += 3.0
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    te, tx = ray_aabb(torch.from_numpy(o), torch.from_numpy(d), (-1, -1, -1), (1, 1, 1))
    te = torch.clamp_min(te, near)
    return o, d, te.numpy(), torch.maximum(tx, te).numpy()


def _occupancies():
    """Pooled [c, c, c] bool grids: the committed prims model's, and a
    sparse random one."""
    with np.load(NPZ) as data:
        model = torch.from_numpy(data["leaf_61"].copy())
    sparse = torch.from_numpy(np.random.default_rng(5).uniform(size=(64,) * 3) < 0.004)
    return {f"{kind}_{c}": make_coarse_occupancy(occ, 64 // c).numpy()
            for kind, occ in (("model", model), ("random", sparse)) for c in (16, 32)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tighten_mask")
    o, d, te, tx = _rays()
    occs = _occupancies()
    inp = {"cases": np.asarray(["_".join(map(str, case)) for case in CASES]), "o": o, "d": d,
           "te": te, "tx": tx, **{f"occ_{k}": v for k, v in occs.items()}}
    np.savez(tmp / "in.npz", **inp)
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_cpu_max_isa=AVX --xla_backend_optimization_level=0"}
    subprocess.run([sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   env=env, check=True, timeout=900)
    with np.load(tmp / "out.npz") as out:
        return (o, d, te, tx), occs, {k: out[k] for k in out.files}


@pytest.mark.parametrize("res_c,n,kind,probes", PARAMS)
def test_tighten_sample_mask_plain_bit_exact_with_reference(reference, res_c, n, kind, probes):
    rays, occs, ref = reference
    o, d, te, tx = (torch.from_numpy(a) for a in rays)
    occ = torch.from_numpy(occs[f"{kind}_{res_c}"])
    t0, t1, mask = tighten_sample_mask(o, d, te, tx, occ, n, GridConfig(), probes)
    case = f"{res_c}_{n}_{kind}_{probes}"
    np.testing.assert_array_equal(t0.numpy(), ref[f"{case}_t0"])
    np.testing.assert_array_equal(t1.numpy(), ref[f"{case}_t1"])
    assert mask.dtype == torch.bool and mask.shape == (o.shape[0], n)
    np.testing.assert_array_equal(mask.numpy(), ref[f"{case}_mask"])
    kept = mask.any(dim=1).float().mean()
    assert 0.05 < kept < 0.95  # the case has rays to keep and rays to drop
    # a ray without a span has no occupied midpoint
    assert not mask[(t1 <= t0)].any()


@pytest.mark.parametrize("res_c,kind", [(16, "model"), (32, "model"), (16, "random"),
                                        (32, "random")])
def test_span_is_tighten_range_bit_for_bit(res_c, kind):
    o, d, te, tx = (torch.from_numpy(a) for a in _rays(512, seed=9))
    occ = torch.from_numpy(_occupancies()[f"{kind}_{res_c}"])
    words = pack_words_rows(occ)
    t0, t1, _ = tighten_sample_mask_plain(o, d, te, tx, occ, 16, GridConfig())
    r0, r1 = tighten_range_plain(o, d, te, tx, words, res_c, GridConfig())
    assert torch.equal(t0, r0) and torch.equal(t1, r1)
    # a bitfield packed by the caller gives the same answer
    again = tighten_sample_mask(o, d, te, tx, occ, 16, GridConfig(), words=words)
    assert torch.equal(again[0], t0) and torch.equal(again[1], t1)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    o, d, te, tx = (torch.from_numpy(a) for a in _rays(8))
    occ = torch.ones((4, 4, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="bool occupancy"):
        tighten_sample_mask(o, d, te, tx, occ.float(), 8, GridConfig())
    with pytest.raises(ValueError, match="n_samples"):
        tighten_sample_mask(o, d, te, tx, occ, 0, GridConfig())
    with pytest.raises(ValueError, match="unsupported device"):
        tighten_sample_mask(*(a.to("meta") for a in (o, d, te, tx)), occ.to("meta"), 8,
                            GridConfig())
