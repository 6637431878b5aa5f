"""The field outside the kernels and the occupancy refresh against the
reference: `frequency_encoding`, `NeRFField` (apply and density) with
converted weights, `ema_threshold_update`, one `update_occupancy` fed the
same jittered points.

Tolerances: the encoding is f32 elementwise (atol 1e-5: sin / cos of
arguments up to pi 2^9 differ in the last bits between the two libraries);
the field rounds activations to bf16 in both packages, and a product summed
in another order flips single roundings, so rgb agrees to 1e-2 and sigma
to 2e-2 relative plus 1e-2 absolute; the EMA rule is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tnerf.config import Config as JConfig
from tnerf.fields import encodings as jenc
from tnerf.fields.nerf_field import NeRFField as JField
from tnerf.grid import occupancy as jocc
from tnerf_torch.config import Config
from tnerf_torch.fields.encodings import frequency_encoding, frequency_encoding_dim
from tnerf_torch.fields.nerf_field import NeRFField
from tnerf_torch.grid import occupancy as tocc
from tnerf_torch.utils.checkpoint import params_from_jax

OVERRIDES = ["field_.hidden_width=32", "field_.hidden_layers=3", "field_.n_frequencies=6",
             "grid.resolution=16", "grid.aabb_min=[-1.5,-1.0,-1.0]"]


def test_frequency_encoding_matches_reference():
    x = np.random.default_rng(0).uniform(-1, 1, (257, 3)).astype(np.float32)
    for L, include in ((10, True), (4, False), (0, True)):
        ref = np.asarray(jenc.frequency_encoding(jnp.asarray(x), L, include_input=include))
        got = frequency_encoding(torch.from_numpy(x), L, include_input=include).numpy()
        assert got.shape == ref.shape == (257, frequency_encoding_dim(3, L, include) if L else 3)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def _fields():
    jcfg = JConfig().apply_overrides(OVERRIDES)
    cfg = Config().apply_overrides(OVERRIDES)
    jfield = JField(jcfg.field_, jcfg.grid)
    jparams = jfield.init(jax.random.PRNGKey(0))
    field = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(0))
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jcfg, cfg, jfield, jparams, field


def test_field_apply_and_density_match_reference():
    jcfg, cfg, jfield, jparams, field = _fields()
    # the port's own init has the reference's shapes and scale (He-normal, zero biases)
    fresh = NeRFField(cfg.field_, cfg.grid, torch.Generator().manual_seed(1)).params()
    assert list(fresh) == ["trunk.w.0", "trunk.w.1", "trunk.w.2", "trunk.w.3",
                           "trunk.b.0", "trunk.b.1", "trunk.b.2", "trunk.b.3"]
    for l, w in enumerate(jparams["trunk"]["w"]):
        assert tuple(fresh[f"trunk.w.{l}"].shape) == w.shape
        assert abs(float(fresh[f"trunk.w.{l}"].detach().std()) / (2.0 / w.shape[0]) ** 0.5 - 1) < 0.15
        assert float(fresh[f"trunk.b.{l}"].detach().abs().max()) == 0.0
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    tp = rng.uniform(-3, 3, (512, 2)).astype(np.float32)
    jrgb, jsig = jfield.apply(jparams, jnp.asarray(x), jnp.asarray(tp))
    with torch.no_grad():
        rgb, sig = field(torch.from_numpy(x), torch.from_numpy(tp))
        dens = field.density(torch.from_numpy(x))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-2, rtol=0)
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), atol=1e-2, rtol=2e-2)
    np.testing.assert_allclose(dens.numpy(), np.asarray(jfield.density(jparams, jnp.asarray(x))),
                               atol=1e-2, rtol=2e-2)
    assert float(sig.std()) > 1e-3


def test_ema_threshold_update_is_bit_equal():
    jcfg, cfg, *_ = _fields()
    rng = np.random.default_rng(2)
    ema = rng.uniform(0, 0.05, (16, 16, 16)).astype(np.float32)
    ema[0, 0, 0] = 5e4  # above the 1e4 cap
    sigma = rng.uniform(0, 0.03, (16, 16, 16)).astype(np.float32)
    jema, jbits = jocc.ema_threshold_update(jnp.asarray(ema), jnp.asarray(sigma), jcfg.grid)
    tema, tbits = tocc.ema_threshold_update(torch.from_numpy(ema), torch.from_numpy(sigma),
                                            cfg.grid)
    np.testing.assert_array_equal(tema.numpy(), np.asarray(jema))
    np.testing.assert_array_equal(tbits.numpy(), np.asarray(jbits))
    assert 0.05 < tbits.float().mean() < 0.95
    np.testing.assert_allclose(tocc.cell_centers(cfg.grid).numpy(),
                               np.asarray(jocc.cell_centers(jcfg.grid)), atol=1e-6, rtol=0)


def test_update_occupancy_on_the_same_points():
    """Both packages probe the points the reference's key draws: the EMA
    agrees to the field's tolerance and under 0.5% of the cells land on the
    other side of the threshold."""
    jcfg, cfg, jfield, jparams, field = _fields()
    # densities on both sides of the threshold: a stronger last layer, a negative density bias
    jparams["trunk"]["w"][-1] = jparams["trunk"]["w"][-1] * 4.0
    jparams["trunk"]["b"][-1] = jparams["trunk"]["b"][-1].at[3].set(-4.0)
    field.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    key = jax.random.PRNGKey(7)
    jstate = jocc.update_occupancy(jocc.init_occupancy(jcfg.grid),
                                   lambda x: jfield.density(jparams, x), jcfg.grid, key)
    jitter = np.array(jax.random.uniform(key, (16, 16, 16, 3), jnp.float32, -0.5, 0.5))
    state = tocc.init_occupancy(cfg.grid)
    assert bool(state.bitfield.all()) and float(tocc.occupancy_fraction(state)) == 1.0
    state = tocc.update_occupancy(state, field.density, cfg.grid,
                                  jitter=torch.from_numpy(jitter))
    assert int(state.step) == int(jstate.step) == 1
    np.testing.assert_allclose(state.density_ema.numpy(), np.asarray(jstate.density_ema),
                               atol=1e-2, rtol=2e-2)
    differ = float((state.bitfield.numpy() != np.asarray(jstate.bitfield)).mean())
    assert differ < 0.005, differ
    frac = float(tocc.occupancy_fraction(state))
    assert 0.02 < frac < 0.98, frac
    # a drawn jitter stays inside its cell and the refresh is seeded
    a = tocc.update_occupancy(state, field.density, cfg.grid,
                              generator=torch.Generator().manual_seed(3))
    b = tocc.update_occupancy(state, field.density, cfg.grid,
                              generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.density_ema, b.density_ema) and int(a.step) == 2
