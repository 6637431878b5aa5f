"""The table fields' training gates of `chip_smoke.py` and the states they
start from.

`chip_smoke.py` trains each table field at its committed seed (the
`fields` phase; `parallel_full`'s table-parallel triplane) from the port's
own step-0 state and holds its final test PSNR to the band of the
reference's runs from that state (`reference_bands`,
`hold_to_reference_band`, FIELD_GATES): the triplane's committed CPU
streams (runs/hard_r3_triplane_prog_port_init/ref_streams/stream_K.jsonl),
the hash grid's and CP's one run each.  Here, on the CPU:

- the bands on the committed files: the runs behind each and their least
  and greatest, read independently of the function; a value exactly at an
  edge passes and one 0.01 dB outside fails; the hash grid's gate refuses
  every clear run, as no run of the reference behind it ended clear; the
  function opens nothing but the committed streams;
- the streams both packages ran from the port's states
  (`chip_smoke.committed_streams`, which tools/hash_init_band.py reads):
  their counts, each class's least and greatest, a final eval in each and
  a start at the committed state's;
- each committed step-0 state (runs/hard_r5_hashgrid_diffuse_port_init,
  runs/hard_r3_triplane_prog_port_init) equals, leaf by leaf and bit for
  bit, what `tnerf_torch.cli train --device cpu -o train.steps=0` draws at
  the config's seed 1337 (the triplane under its first stage's config, as
  tools/reference_from_port_state.sh draws it).  The scene is cut to a few
  16x16 views: the draw does not read it, which the equality shows.  Both
  packages resume the state at step 0 with the same parameters;
- `parallel.mesh.make_mesh` without a device asks for the card, and raises
  where there is none.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import (CONFIG_CP, CONFIG_HASH, CONFIG_TRIPLANE, FIELD_GATES, HASH_FOG_DB,
                        HASH_PORT_INIT, TRAIN_PSNR_MARGIN_DB, TRI_PORT_INIT, committed_streams,
                        hold_to_reference_band, reference_bands)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = {"hashgrid": CONFIG_HASH, "cp": CONFIG_CP, "triplane": CONFIG_TRIPLANE}
STATES = {"hashgrid": (CONFIG_HASH, HASH_PORT_INIT), "triplane": (CONFIG_TRIPLANE, TRI_PORT_INIT)}
# The committed streams from the port's states, at least: the reference's
# (ref_streams/stream_K.jsonl) and the port's gather streams on the card
# (port_streams/gather_sK.jsonl).
MIN_STREAMS = {("hashgrid", "ref_streams"): 6, ("triplane", "ref_streams"): 6,
               ("hashgrid", "port_streams"): 20, ("triplane", "port_streams"): 16}
# The reference's runs from the port's states known only by their final
# test PSNR (chip_smoke.JAX_HASH_FROM_PORT_INIT_PSNR_TEST,
# JAX_CP_FROM_PORT_INIT_PSNR_TEST).
ANCHORS = {"hashgrid": 34.42220929004496, "cp": 43.79805301785407}
SMALL_SCENE = ["scene.proc_width=16", "scene.proc_height=16", "scene.proc_n_train=2",
               "scene.proc_n_val=1", "scene.proc_n_test=1"]


def committed_finals(run_dir, prefix="stream_"):
    """The final test PSNR of each run_dir/<prefix>K.jsonl, read here
    directly: the eval logged at the config's last step (2500)."""
    finals = []
    for path in glob.glob(os.path.join(run_dir, f"{prefix}*.jsonl")):
        with open(path) as fh:
            recs = [json.loads(line) for line in fh if line.strip()]
        tests = [r for r in recs if "psnr_test" in r]
        assert tests[-1]["step"] == 2500, path
        finals.append(tests[-1]["psnr_test"])
    return finals


def gate_runs(field):
    """The final test PSNRs of the reference's runs behind a field's gate."""
    if field in ANCHORS:
        return [ANCHORS[field]]
    return committed_finals(os.path.join(TRI_PORT_INIT, "ref_streams"))


@pytest.mark.parametrize("field", list(FIELDS))
def test_bands_on_the_committed_files(field):
    runs = gate_runs(field)
    assert len(runs) >= (6 if field == "triplane" else 1)
    assert reference_bands(FIELDS[field]) == (min(runs) - TRAIN_PSNR_MARGIN_DB,
                                              max(runs) + TRAIN_PSNR_MARGIN_DB, len(runs))
    assert TRAIN_PSNR_MARGIN_DB == 1.5


@pytest.mark.parametrize("edge", ["low", "high"])
@pytest.mark.parametrize("field", list(FIELDS))
def test_a_value_at_an_edge_passes_and_one_past_it_fails(field, edge, capsys):
    config = FIELDS[field]
    lo, hi, n = reference_bands(config)
    at, past = (lo, lo - 0.01) if edge == "low" else (hi, hi + 0.01)
    hold_to_reference_band("edge", config, at)
    assert f"[{lo:.4f}, {hi:.4f}] over {n} runs" in capsys.readouterr().out
    with pytest.raises(AssertionError, match="outside the band"):
        hold_to_reference_band("past", config, past)


def test_the_hash_gate_refuses_a_clear_run(capsys):
    """The hash grid's gate is its one fogged anchor run: every clear value
    fails, the reference's own clear streams from the same state
    included, and a fogged one inside the band passes and says so."""
    lo, hi, n = reference_bands(CONFIG_HASH)
    assert n == 1 and hi < HASH_FOG_DB
    refs = committed_finals(os.path.join(HASH_PORT_INIT, "ref_streams"))
    for clear in [HASH_FOG_DB, 42.5] + [v for v in refs if v >= HASH_FOG_DB]:
        with pytest.raises(AssertionError, match="outside the band"):
            hold_to_reference_band("clear", CONFIG_HASH, clear)
    hold_to_reference_band("fogged", CONFIG_HASH, (lo + hi) / 2)
    assert "fogged (under 39.0 dB is fogged)" in capsys.readouterr().out


@pytest.mark.parametrize("field", list(FIELDS))
def test_the_bands_read_nothing_but_the_committed_streams(field, monkeypatch):
    import builtins

    opened = []
    real = builtins.open

    def recording(path, *a, **kw):
        opened.append(os.path.abspath(path))
        return real(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", recording)
    reference_bands(FIELDS[field])
    monkeypatch.undo()
    spec = FIELD_GATES[FIELDS[field]]
    if "streams" not in spec:
        assert opened == []
        return
    want = glob.glob(os.path.join(REPO, "runs", "*_port_init", "ref_streams", "stream_*.jsonl"))
    assert sorted(opened) == sorted(p for p in want if p.startswith(spec["streams"] + os.sep))
    assert len(opened) >= 6


@pytest.mark.parametrize("kind", ["ref_streams", "port_streams"])
@pytest.mark.parametrize("field", list(STATES))
def test_the_streams_from_the_port_states(field, kind):
    """committed_streams against the files read here: names in the order of
    K, every stream at its final eval, the hash grid's classes' least and
    greatest, and each stream's first window the committed state's (the
    reference's stream 0 within 0.05 in acc_mean, as the phases check)."""
    config, run_dir = STATES[field]
    prefix = "stream_" if kind == "ref_streams" else "gather_s"
    streams = committed_streams(os.path.join(run_dir, kind), prefix)
    finals = committed_finals(os.path.join(run_dir, kind), prefix)
    assert len(streams) >= MIN_STREAMS[field, kind]
    assert [name for name, _, _ in streams] == [f"{prefix}{k}" for k in range(len(streams))]
    got = [v for _, _, v in streams]
    assert sorted(got) == sorted(finals)
    if field == "hashgrid":
        for member in (lambda v: v < HASH_FOG_DB, lambda v: v >= HASH_FOG_DB):
            mine, want = [v for v in got if member(v)], [v for v in finals if member(v)]
            assert (min(mine), max(mine), len(mine)) == (min(want), max(want), len(want))
    start = committed_streams(os.path.join(run_dir, "ref_streams"))[0][1][0]["acc_mean"]
    for name, windows, _ in streams:
        assert windows[0]["step"] == 0 and abs(windows[0]["acc_mean"] - start) <= 0.05, name


def _first_stage(config):
    """The overrides of a progressive triplane's first stage (none for
    another config), as tools/reference_from_port_state.sh sets them."""
    with open(config) as fh:
        f = json.load(fh)["field_"]
    if not f.get("tri_upsample_steps"):
        return []
    return [f"field_.tri_resolution={f['tri_init_resolution']}",
            "field_.tri_upsample_steps=[]", "field_.tri_init_resolution=0"]


@pytest.mark.parametrize("field", list(STATES))
def test_the_committed_state_is_what_the_port_draws(field, tmp_path, capsys):
    from tnerf_torch.cli import main

    config, run_dir = STATES[field]
    argv = ["train", "--device", "cpu", "--config", config, "--out", str(tmp_path)]
    for ov in SMALL_SCENE + ["train.steps=0", "train.assert_test_psnr_min=0"] \
            + _first_stage(config):
        argv += ["-o", ov]
    assert main(argv) == 0
    capsys.readouterr()
    got, want = (os.path.join(d, "checkpoints") for d in (str(tmp_path), run_dir))
    for name in ("treedef.json",):
        with open(os.path.join(got, name)) as a, open(os.path.join(want, name)) as b:
            assert json.load(a) == json.load(b)
    with np.load(os.path.join(got, "step_00000000.npz")) as a, \
            np.load(os.path.join(want, "step_00000000.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("field", list(STATES))
def test_both_packages_resume_the_state_at_step_zero(field):
    import jax

    from tnerf.config import Config as JConfig
    from tnerf.grid.occupancy import init_occupancy as j_init_occ
    from tnerf.train import create_optimizer
    from tnerf.train import init_train_state as j_init
    from tnerf.train_loop import build_field
    from tnerf.utils.checkpoint import restore_checkpoint
    from tnerf_torch.utils.checkpoint import params_from_jax, read_train_checkpoint

    config, run_dir = STATES[field]
    ckpt = os.path.join(run_dir, "checkpoints")
    jcfg = JConfig.from_json_file(config).apply_overrides(_first_stage(config))
    jfield, jopt = build_field(jcfg), create_optimizer(jcfg.train)
    template = j_init(jfield, jopt, 0, param_ema=jcfg.train.param_ema > 0)
    step, (jstate, jocc) = restore_checkpoint(ckpt, (template, j_init_occ(jcfg.grid)))
    ck = read_train_checkpoint(ckpt, "cpu")
    assert step == ck.step == 0 and int(ck.opt_state["count"]) == 0
    mine = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    assert set(mine) == set(ck.params)
    for k in ck.params:
        np.testing.assert_array_equal(ck.params[k].numpy(), mine[k].numpy(), err_msg=k)
    assert bool(ck.occupancy.bitfield.all()) and bool(np.asarray(jocc.bitfield).all())


def test_make_mesh_defaults_to_the_card(tmp_path, monkeypatch):
    """Without `device`, make_mesh asks for this rank's card and raises
    where torch.cuda.is_available() is False; the CPU only when asked."""
    import torch.distributed as dist

    from tnerf_torch.parallel import comm
    from tnerf_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    formed = not dist.is_initialized()  # a group of one another test left is used as it is
    if formed:
        comm.init_group("cpu", init_method=f"file://{tmp_path / 'store'}", rank=0,
                        world_size=1, local_world_size=1)
    try:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh(1)
        assert make_mesh(1, device="cpu").device == torch.device("cpu")
    finally:
        if formed:
            dist.destroy_process_group()
