"""The port's checkpoints and resume held against the JAX package's.

Mirrors ``tests/test_checkpoint.py`` and the resume tests of
``tests/test_aux.py`` for the port's ``MOMP-STATE/1`` restart files
(``utils.checkpoint``; the JAX package writes Orbax trees), and holds the
two packages against each other: a port checkpoint read by the JAX
package's ``restore_state`` and continued by a JAX ``LifeSim``, a JAX
Orbax checkpoint continued by the port, the same checkpoint steps from
both run loops, and the port CLI's refusal of a newer Orbax tree. The port
runs on meshes of virtual CPU shards, where its kernel wrappers take their
plain versions; boards must match bit for bit.
"""

import os
import pickle
import stat
import struct
import zlib

import numpy as np
import pytest
import torch

from conftest import oracle_n
from mpi_and_open_mp_tpu.apps import life as jax_life_app
from mpi_and_open_mp_tpu.models.life import LifeSim as JaxSim
from mpi_and_open_mp_tpu.parallel import mesh as jmesh
from mpi_and_open_mp_tpu.utils import checkpoint as jckpt
from mpi_and_open_mp_tpu.utils.config import LifeConfig as JaxConfig

from mpi_and_open_mp_tpu_torch.apps import life as life_app
from mpi_and_open_mp_tpu_torch.models.life import LifeSim, state_from_jax_sim
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.utils import checkpoint
from mpi_and_open_mp_tpu_torch.utils.config import (
    config_from_board, save_config)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLIDER = os.path.join(ROOT, "tests", "fixtures", "glider_10x10.cfg")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small array operations: one torch thread beside the other test
    processes of a parallel run, and the pool handed back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(layout, shape):
    if layout == "serial":
        return None
    if layout == "cart":
        return mesh_lib.make_mesh_2d(*shape, device="cpu")
    axis = "x" if layout == "col" else "y"
    return mesh_lib.make_mesh_1d(shape[0], axis=axis, device="cpu")


def _sim(cfg, layout="row", impl="halo", shape=(4,), **kw):
    return LifeSim(cfg, layout=layout, impl=impl, mesh=_mesh(layout, shape),
                   device="cpu", **kw)


def _jax_cfg(cfg):
    return JaxConfig(steps=cfg.steps, save_steps=cfg.save_steps, nx=cfg.nx,
                     ny=cfg.ny, cells=cfg.cells)


def _cli(*argv):
    return life_app.main([*map(str, argv), "--device", "cpu"])


# --------------------------------------------- round trips and bit identity


def test_checkpoint_roundtrip_across_meshes(tmp_path, make_board):
    """Save on a row mesh mid-run; restore onto a cart mesh; finish: the
    result equals the oracle."""
    board = make_board(48, 40)
    cfg = config_from_board(board, steps=30, save_steps=0)
    sim = _sim(cfg, "row", "halo", (8,))
    sim.step(17)
    ckpt = tmp_path / "ckpt.state"
    sim.save_checkpoint(ckpt)
    resumed = LifeSim.from_checkpoint(ckpt, cfg, layout="cart", impl="halo",
                                      mesh=_mesh("cart", (4, 2)),
                                      device="cpu")
    assert resumed.step_count == 17
    np.testing.assert_array_equal(resumed.run(save=False),
                                  oracle_n(board, 30))


# Every layout and impl a Life checkpoint resumes on (a 64^2 board, which
# every bitfused plan below covers).
TARGETS = [("serial", "roll", None), ("serial", "native", None),
           ("row", "roll", (2,)), ("row", "halo", (2,)),
           ("row", "native", (2,)), ("row", "bitfused", (2,)),
           ("col", "roll", (4,)), ("col", "halo", (4,)),
           ("col", "native", (4,)), ("col", "bitfused", (4,)),
           ("cart", "roll", (2, 2)), ("cart", "halo", (2, 2)),
           ("cart", "native", (2, 2)), ("cart", "bitfused", (2, 2))]


@pytest.mark.parametrize("layout,impl,shape", TARGETS,
                         ids=[f"{a}-{b}" for a, b, _ in TARGETS])
def test_from_checkpoint_on_every_layout_and_impl(tmp_path, layout, impl,
                                                  shape):
    """A bitfused row-2 checkpoint at step 45 (past a k_max round) resumes
    on every layout and impl and ends on the oracle's board, and a
    checkpoint of the resumed sim holds that board."""
    board = (np.random.default_rng(5).random((64, 64)) < 0.35).astype(
        np.uint8)
    cfg = config_from_board(board, steps=80, save_steps=0)
    src = _sim(cfg, "row", "bitfused", (2,))
    src.step(45)
    ckpt = tmp_path / "mid.state"
    src.save_checkpoint(ckpt)
    resumed = LifeSim.from_checkpoint(ckpt, cfg, layout=layout, impl=impl,
                                      mesh=_mesh(layout, shape),
                                      device="cpu")
    assert resumed.step_count == 45
    np.testing.assert_array_equal(resumed.collect(), oracle_n(board, 45))
    np.testing.assert_array_equal(resumed.run(save=False),
                                  oracle_n(board, 80))
    resumed.save_checkpoint(tmp_path / "end.state")
    got, step = checkpoint.restore(tmp_path / "end.state")
    assert step == 80 and np.array_equal(got, oracle_n(board, 80))


def test_checkpoint_uneven_board(tmp_path, make_board):
    """An uneven board stored padded on the mesh round-trips: the
    checkpoint holds the logical board."""
    board = make_board(50, 37)
    cfg = config_from_board(board, steps=10, save_steps=0)
    sim = _sim(cfg, "row", "roll", (8,))
    assert sim.padded_shape != cfg.shape
    sim.step(4)
    ckpt = tmp_path / "ckpt.state"
    sim.save_checkpoint(ckpt)
    stored, _ = checkpoint.restore(ckpt)
    assert stored.shape == (50, 37)
    resumed = LifeSim.from_checkpoint(ckpt, cfg, layout="col", impl="roll",
                                      mesh=_mesh("col", (8,)), device="cpu")
    np.testing.assert_array_equal(resumed.run(save=False),
                                  oracle_n(board, 10))


@pytest.mark.parametrize("shape", [(48, 48), (64, 80)])
def test_from_checkpoint_refuses_another_board_shape(tmp_path, make_board,
                                                     shape):
    """A 64x64 checkpoint resumed with a config of another board shape
    raises, naming both shapes: no silently cropped (or padded) resume."""
    board = make_board(64, 64)
    sim = _sim(config_from_board(board, steps=8, save_steps=0))
    sim.step(3)
    ck = tmp_path / "ck.state"
    sim.save_checkpoint(ck)
    other = config_from_board(make_board(*shape), steps=8, save_steps=0)
    with pytest.raises(ValueError,
                       match=rf"\(64, 64\) board; the config's is "
                             rf"\({shape[0]}, {shape[1]}\)"):
        LifeSim.from_checkpoint(ck, other, layout="row", impl="halo",
                                mesh=_mesh("row", (4,)), device="cpu")


def test_checkpoint_restore_onto_2x4_and_single_device(tmp_path, make_board):
    board = make_board(48, 40)
    cfg = config_from_board(board, steps=100, save_steps=0)
    sim = _sim(cfg, "row", "halo", (8,))
    sim.step(60)
    ck = tmp_path / "ck.state"
    sim.save_checkpoint(ck)
    cart = LifeSim.from_checkpoint(ck, cfg, layout="cart", impl="halo",
                                   mesh=_mesh("cart", (2, 4)), device="cpu")
    np.testing.assert_array_equal(cart.run(save=False), oracle_n(board, 100))
    serial = LifeSim.from_checkpoint(ck, cfg, layout="serial", impl="roll",
                                     device="cpu")
    np.testing.assert_array_equal(serial.run(save=False),
                                  oracle_n(board, 100))


def test_resume_mid_run_bit_identity_vs_straight(tmp_path, make_board):
    board = make_board(40, 40)
    cfg = config_from_board(board, steps=100, save_steps=0)
    straight = _sim(cfg).run(save=False)
    sim = _sim(cfg)
    sim.step(60)
    ck = tmp_path / "ck.state"
    sim.save_checkpoint(ck)
    resumed = LifeSim.from_checkpoint(ck, cfg, layout="row", impl="halo",
                                      mesh=_mesh("row", (4,)), device="cpu")
    assert resumed.step_count == 60
    final = resumed.run(save=False)
    np.testing.assert_array_equal(final, straight)
    np.testing.assert_array_equal(final, oracle_n(board, 100))


def test_checkpoint_resume_bitfused_padded_frame(tmp_path, make_board):
    """The packed path on an unaligned board lives in a padded frame; the
    checkpoint holds the logical board and resumes onto other frames."""
    board = make_board(100, 130)
    cfg = config_from_board(board, steps=80, save_steps=0)
    sim = _sim(cfg, "row", "bitfused", (2,))
    assert sim.padded_shape == (128, 130)
    sim.step(45)
    ckpt = tmp_path / "bit_ck.state"
    sim.save_checkpoint(ckpt)
    for layout, impl, shape in [("row", "bitfused", (2,)),
                                ("cart", "bitfused", (2, 2)),
                                ("col", "roll", (8,))]:
        resumed = LifeSim.from_checkpoint(
            ckpt, cfg, layout=layout, impl=impl, mesh=_mesh(layout, shape),
            device="cpu")
        assert resumed.step_count == 45
        np.testing.assert_array_equal(resumed.run(save=False),
                                      oracle_n(board, 80),
                                      err_msg=f"{layout}/{impl}")


RUNS = [("serial", "native", None), ("row", "halo", (4,)),
        ("cart", "native", (2, 2)), ("row", "bitfused", (2,)),
        ("col", "roll", (3,))]


@pytest.mark.parametrize("layout,impl,shape", RUNS,
                         ids=[f"{a}-{b}" for a, b, _ in RUNS])
def test_checkpointed_run_matches_straight_and_jax_steps(tmp_path, layout,
                                                         impl, shape):
    """A run that checkpoints every 13 steps (segments not a multiple of
    bitfused's rounds) ends on the straight run's board, writes the steps
    the JAX package's loop writes, and each file holds the oracle's board
    at its step."""
    board = (np.random.default_rng(9).random((64, 64)) < 0.35).astype(
        np.uint8)
    cfg = config_from_board(board, steps=60, save_steps=25)
    straight = _sim(cfg, layout, impl, shape).run()
    ck = tmp_path / "port"
    sim = _sim(cfg, layout, impl, shape, checkpoint_dir=ck,
               checkpoint_every=13)
    sim.warmup()
    np.testing.assert_array_equal(sim.run(), straight)
    np.testing.assert_array_equal(straight, oracle_n(board, 60))
    jck = tmp_path / "jax"
    JaxSim(_jax_cfg(cfg), layout="row", impl="halo",
           mesh=jmesh.make_mesh_1d(4), checkpoint_dir=jck,
           checkpoint_every=13).run()
    want = sorted(os.listdir(jck))
    assert sorted(os.listdir(ck)) == [f"{n}.state" for n in want]
    for name in want:
        got, step = checkpoint.restore(ck / f"{name}.state")
        assert step == int(name[5:])
        np.testing.assert_array_equal(got, oracle_n(board, step))


def test_default_run_is_one_advance(tmp_path, make_board):
    """With nothing to save or checkpoint and no plan or guard, run()
    advances the whole budget in one call; a checkpoint cadence cuts it
    into segments at the cadence."""
    cfg = config_from_board(make_board(32, 32), steps=50, save_steps=0)
    for kw, save, want in [({}, None, [50]), ({}, True, [50]),
                           ({"checkpoint_dir": tmp_path / "ck",
                             "checkpoint_every": 20}, None, [20, 20, 10])]:
        sim = _sim(cfg, **kw)
        calls = []
        advance = sim._advance
        sim._advance = lambda b, n: calls.append(n) or advance(b, n)
        sim.run(save=save)
        assert calls == want, kw
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "step_000020.state", "step_000040.state"]


def test_segment_lengths_count_the_cadence_and_a_pending_preempt(
        monkeypatch, tmp_path, make_board):
    """warmup() builds every segment length run() takes: the checkpoint
    cadence and a pending simulated preemption cut segments, as in the
    JAX package."""
    from mpi_and_open_mp_tpu.robust import chaos as jchaos
    from mpi_and_open_mp_tpu_torch.robust import chaos

    board = make_board(32, 32)
    cfg = config_from_board(board, steps=100, save_steps=0)
    monkeypatch.setenv("MOMP_CHAOS", "preempt=45;noguard")
    chaos.reset()
    jchaos.reset()
    try:
        sim = _sim(cfg, checkpoint_dir=tmp_path / "p", checkpoint_every=20)
        theirs = JaxSim(_jax_cfg(cfg), layout="row", impl="halo",
                        mesh=jmesh.make_mesh_1d(4),
                        checkpoint_dir=tmp_path / "j", checkpoint_every=20)
        assert sim._segment_lengths() == theirs._segment_lengths() == [5, 15,
                                                                       20]
    finally:
        chaos.reset()
        jchaos.reset()


# ------------------------------------------------------------ the CLI


def test_cli_checkpoint_and_resume(tmp_path, capsys, make_board):
    cfg = config_from_board(make_board(16, 16), steps=20, save_steps=5)
    cfg_path = tmp_path / "run.cfg"
    save_config(cfg_path, cfg)
    out, ck = tmp_path / "vtk", tmp_path / "ck"
    assert _cli(cfg_path, "--layout", "row", "--virtual-devices", "4",
                "--outdir", out, "--checkpoint-dir", ck) == 0
    assert sorted(os.listdir(ck)) == [f"step_{i:06d}.state"
                                      for i in (0, 5, 10, 15)]
    capsys.readouterr()
    assert _cli(cfg_path, "--layout", "cart", "--virtual-devices", "4",
                "--outdir", out, "--checkpoint-dir", ck, "--resume") == 0
    assert "resuming from checkpoint" in capsys.readouterr().err


def test_cli_checkpoint_only_no_outdir(tmp_path, capsys, make_board):
    cfg = config_from_board(make_board(16, 16), steps=10, save_steps=5)
    cfg_path = tmp_path / "run.cfg"
    save_config(cfg_path, cfg)
    ck = tmp_path / "ck"
    assert _cli(cfg_path, "--layout", "row", "--checkpoint-dir", ck) == 0
    assert sorted(os.listdir(ck)) == ["step_000000.state", "step_000005.state"]
    capsys.readouterr()
    assert _cli(cfg_path, "--layout", "row", "--checkpoint-dir", ck,
                "--resume", "--print-final-population") == 0
    err = capsys.readouterr().err.splitlines()
    assert err[0].startswith("resuming from checkpoint")
    # The JAX CLI's status line: without a plan store, plan_source
    # "heuristic" and no plans_installed.
    assert err[1] == ('{"resumed": "step_000005.state", "step": 5, '
                      '"plan_source": "heuristic"}')
    assert int(err[-1]) == int(oracle_n(cfg.board(), 10).sum())


def test_resume_prefers_newest_state(tmp_path, capsys, make_board):
    """A stale checkpoint must not roll back past newer VTK snapshots."""
    cfg = config_from_board(make_board(16, 16), steps=20, save_steps=5)
    cfg_path = tmp_path / "run.cfg"
    save_config(cfg_path, cfg)
    out, ck = tmp_path / "vtk", tmp_path / "ck"
    stale = _sim(config_from_board(make_board(16, 16), 1, 1), "row", "halo",
                 (2,), checkpoint_dir=ck)
    stale.save_checkpoint(ck / "step_000000.state")
    assert _cli(cfg_path, "--layout", "row", "--outdir", out) == 0
    capsys.readouterr()
    assert _cli(cfg_path, "--layout", "row", "--outdir", out,
                "--checkpoint-dir", ck, "--resume") == 0
    assert "life_000015.vtk (step 15)" in capsys.readouterr().err


def test_resume_refuses_a_newer_orbax_tree(tmp_path, capsys, make_board):
    """The JAX package's Orbax tree is not this package's format: --resume
    refuses to roll back past a newer one, naming it, and resumes from
    its own newest file when the tree is not newer."""
    board = make_board(16, 16)
    cfg = config_from_board(board, steps=20, save_steps=0)
    cfg_path = tmp_path / "run.cfg"
    save_config(cfg_path, cfg)
    ck = tmp_path / "ck"
    sim = _sim(cfg, "row", "halo", (2,))
    sim.step(5)
    sim.save_checkpoint(ck / "step_000005.state")
    jsim = JaxSim(_jax_cfg(cfg), layout="row", impl="halo",
                  mesh=jmesh.make_mesh_1d(2))
    jsim.step(12)
    jsim.save_checkpoint(ck / "step_000012")
    assert jax_life_app.find_latest_checkpoint(str(ck))[1] == 12
    assert life_app.find_latest_checkpoint(str(ck))[1] == 5
    capsys.readouterr()
    assert _cli(cfg_path, "--layout", "row", "--checkpoint-dir", ck,
                "--resume") == 2
    err = capsys.readouterr().err
    assert "step_000012" in err and "JAX Orbax checkpoint" in err
    sim.step(10)
    sim.save_checkpoint(ck / "step_000015.state")
    assert _cli(cfg_path, "--layout", "row", "--checkpoint-dir", ck,
                "--resume", "--print-final-population") == 0
    err = capsys.readouterr().err.splitlines()
    assert "step_000015.state (step 15)" in err[0]
    assert int(err[-1]) == int(oracle_n(board, 20).sum())


def test_resume_from_snapshot_bit_exact(tmp_path, make_board):
    """A run to completion against one interrupted and resumed from its
    snapshot: identical, and the resumed run writes the snapshot the
    interrupted one missed."""
    board = make_board(32, 40)
    cfg = config_from_board(board, steps=40, save_steps=10)
    full = _sim(cfg, outdir=tmp_path / "a").run()
    out_b = tmp_path / "b"
    sim = _sim(cfg, outdir=out_b)
    i = 0
    while i < 25:
        if i % cfg.save_steps == 0:
            sim.save_snapshot()
        n = min(cfg.save_steps - i % cfg.save_steps, 25 - i)
        sim.step(n)
        i += n
    latest = life_app.find_latest_snapshot(str(out_b))
    assert latest is not None and latest[1] == 20
    resumed = LifeSim.from_snapshot(cfg, latest[0], latest[1], layout="cart",
                                    impl="halo", mesh=_mesh("cart", (2, 2)),
                                    device="cpu", outdir=out_b)
    final = resumed.run()
    np.testing.assert_array_equal(final, full)
    np.testing.assert_array_equal(final, oracle_n(board, 40))
    assert os.path.exists(out_b / "life_000030.vtk")


def test_resume_cli(tmp_path, capsys):
    outdir = tmp_path / "vtk"
    assert _cli(GLIDER, "--layout", "serial", "--impl", "roll",
                "--outdir", outdir) == 0
    capsys.readouterr()
    assert _cli(GLIDER, "--layout", "serial", "--impl", "roll",
                "--outdir", outdir, "--resume") == 0
    err = capsys.readouterr().err
    assert "resuming from" in err and "life_000075.vtk" in err


def test_resume_cli_no_state(tmp_path, capsys):
    """Nothing to resume from: exit 2 with the JAX package's text, from
    both CLIs."""
    none, ck = str(tmp_path / "none"), str(tmp_path / "ck")
    assert _cli(GLIDER, "--outdir", none, "--resume") == 2
    ours = capsys.readouterr().err.strip().splitlines()[-1]
    assert jax_life_app.main([GLIDER, "--outdir", none, "--resume"]) == 2
    assert ours == capsys.readouterr().err.strip().splitlines()[-1]
    assert _cli(GLIDER, "--outdir", none, "--checkpoint-dir", ck,
                "--resume") == 2
    err = capsys.readouterr().err
    assert f"--resume: no checkpoints in {ck!r} and no snapshots in" in err


def test_cli_batch_refuses_checkpoints_and_impl_pallas_alias(tmp_path,
                                                             capsys):
    """--batch refuses the checkpoint channel with the JAX package's text;
    --impl pallas runs the native kernels, as the JAX package's name."""
    for extra in (["--checkpoint-dir", tmp_path], ["--resume"]):
        with pytest.raises(SystemExit):
            _cli(GLIDER, "--layout", "serial", "--batch", "2", *extra)
        assert ("--batch is a throughput mode: drop --outdir/"
                "--checkpoint-dir/--resume") in capsys.readouterr().err
    assert _cli(GLIDER, "--layout", "serial", "--impl", "pallas",
                "--print-final-population") == 0
    assert capsys.readouterr().err.strip().splitlines()[-1] == "5"


def test_batched_and_non_life_sims_refuse_checkpoints(tmp_path):
    cfg = config_from_board(np.zeros((16, 16), np.uint8), 4, 0)
    stack = np.zeros((3, 16, 16), np.uint8)
    with pytest.raises(ValueError, match="batched runs have no"):
        LifeSim(cfg, layout="serial", device="cpu", initial_board=stack,
                checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match="uint8"):
        LifeSim(cfg, layout="serial", device="cpu", workload="heat",
                checkpoint_dir=tmp_path)
    batched = LifeSim(cfg, layout="serial", device="cpu", initial_board=stack)
    with pytest.raises(ValueError, match="one Life board"):
        batched.save_checkpoint(tmp_path / "b.state")


# -------------------------------------------------- across the two packages


def test_port_checkpoint_read_by_jax_and_continued(tmp_path, make_board):
    """The JAX package's restore_state reads a port checkpoint, and a JAX
    LifeSim continues it to the port's final board."""
    board = make_board(48, 40)
    cfg = config_from_board(board, steps=50, save_steps=0)
    sim = _sim(cfg, "cart", "native", (2, 2))
    sim.step(21)
    path = tmp_path / checkpoint.checkpoint_name(21)
    sim.save_checkpoint(path)
    state = jckpt.restore_state(path)
    assert sorted(state) == ["board", "crc", "step"] and state["step"] == 21
    assert state["board"].dtype == np.uint8
    assert state["crc"] == zlib.crc32(state["board"].tobytes())
    theirs = JaxSim(_jax_cfg(cfg), layout="row", impl="halo",
                    mesh=jmesh.make_mesh_1d(8), initial_board=state["board"],
                    initial_step=state["step"])
    np.testing.assert_array_equal(np.asarray(theirs.run(save=False)),
                                  sim.run(save=False))


def test_jax_orbax_checkpoint_continued_by_port(tmp_path, make_board):
    """A JAX Orbax checkpoint of a padded row board, restored by the JAX
    package and continued by the port (state_from_jax_sim, which crops the
    padding, and from_checkpoint of the logical board saved as a port
    file; the padded board in a port file is refused, as any board of
    another shape than the config's)."""
    board = make_board(50, 37)
    cfg = config_from_board(board, steps=40, save_steps=0)
    jsim = JaxSim(_jax_cfg(cfg), layout="row", impl="roll",
                  mesh=jmesh.make_mesh_1d(8))
    jsim.step(13)
    jsim.save_checkpoint(tmp_path / "step_000013")
    jboard, jstep = jckpt.restore(tmp_path / "step_000013")
    assert jboard.shape != (50, 37)  # the JAX package stores its padding
    ours = state_from_jax_sim(cfg, jboard, jstep, layout="cart",
                              impl="roll", mesh=_mesh("cart", (2, 2)),
                              device="cpu")
    np.testing.assert_array_equal(ours.run(save=False), oracle_n(board, 40))
    checkpoint.save(tmp_path / "padded.state", jboard, jstep)
    with pytest.raises(ValueError, match=r"holds a \(56, 37\) board"):
        LifeSim.from_checkpoint(tmp_path / "padded.state", cfg,
                                layout="serial", impl="native", device="cpu")
    checkpoint.save(tmp_path / "logical.state", jboard[:50, :37], jstep)
    again = LifeSim.from_checkpoint(tmp_path / "logical.state", cfg,
                                    layout="serial", impl="native",
                                    device="cpu")
    assert again.step_count == 13
    np.testing.assert_array_equal(again.run(save=False), oracle_n(board, 40))


def test_state_files_are_byte_identical_across_packages(tmp_path):
    """The same state tree makes the same MOMP-STATE/1 bytes in both
    packages, and each reads the other's."""
    state = {"board": np.arange(12, dtype=np.uint8).reshape(3, 4), "step": 7,
             "crc": 3}
    checkpoint.save_state(tmp_path / "p.state", state)
    jckpt.save_state(tmp_path / "j.state", state)
    assert ((tmp_path / "p.state").read_bytes()
            == (tmp_path / "j.state").read_bytes())
    for path in ("p.state", "j.state"):
        for restore in (checkpoint.restore_state, jckpt.restore_state):
            got = restore(tmp_path / path)
            assert got["step"] == 7
            np.testing.assert_array_equal(got["board"], state["board"])
    assert checkpoint.STATE_MAGIC == jckpt.STATE_MAGIC


# ------------------------------------------------------ files and failures


def test_save_is_atomic_under_crash(tmp_path, monkeypatch, make_board):
    """A crash mid-write leaves the old complete file at the path (the
    partial only at the tmp sibling); the next save lands."""
    cfg = config_from_board(make_board(16, 16), steps=10, save_steps=0)
    sim = _sim(cfg, "row", "roll", (2,))
    ck = tmp_path / "ck.state"
    sim.save_checkpoint(ck)
    b0, s0 = checkpoint.restore(ck)
    sim.step(5)

    def crash(src, dst):
        raise RuntimeError("simulated crash mid-write")

    with monkeypatch.context() as m:
        m.setattr(checkpoint.os, "replace", crash)
        with pytest.raises(RuntimeError, match="simulated crash"):
            sim.save_checkpoint(ck)
    assert os.path.exists(str(ck) + ".tmp")
    b1, s1 = checkpoint.restore(ck)
    np.testing.assert_array_equal(b1, b0)
    assert s1 == s0 == 0
    sim.save_checkpoint(ck)
    _, s2 = checkpoint.restore(ck)
    assert s2 == 5 and not os.path.exists(str(ck) + ".tmp")


def test_restore_detects_crc_mismatch(tmp_path, monkeypatch, make_board):
    cfg = config_from_board(make_board(16, 16), steps=4, save_steps=0)
    sim = _sim(cfg, "row", "roll", (2,))
    ck = tmp_path / "ck.state"
    with monkeypatch.context() as m:
        m.setattr(checkpoint, "_board_crc", lambda board: 0xDEADBEEF)
        sim.save_checkpoint(ck)
    with pytest.raises(ValueError, match="CRC manifest"):
        checkpoint.restore(ck)


@pytest.mark.parametrize("tree,match", [
    ({"board": np.zeros((2, 2), np.uint8)}, "missing its board/step"),
    ([1, 2], "missing its board/step"),
    ({"board": np.zeros((2, 2, 2), np.uint8), "step": 1}, "rank 3, want 2"),
    ({"board": np.zeros((2, 2), np.uint8), "step": -1}, "negative step -1"),
])
def test_restore_validates_the_tree_as_jax_does(tmp_path, tree, match):
    """The checks (and texts) of the JAX package's restore, on a frame
    that passes its own CRC."""
    checkpoint.save_state(tmp_path / "t.state", tree)
    with pytest.raises(ValueError, match=match):
        checkpoint.restore(tmp_path / "t.state")


def test_restore_corrupt_or_missing_raises_valueerror(tmp_path):
    with pytest.raises(ValueError, match="no readable state checkpoint"):
        checkpoint.restore(tmp_path / "missing.state")
    bad = tmp_path / "bad.state"
    bad.write_text("not a checkpoint")
    with pytest.raises(ValueError, match="magic"):
        checkpoint.restore(bad)


def test_state_checkpoint_roundtrip_atomic(tmp_path):
    state = {"schema": "x/1", "boards": [np.arange(12).reshape(3, 4)],
             "n": 7, "names": ("a", "b")}
    path = tmp_path / "sub" / "queue.state"
    checkpoint.save_state(path, state)
    got = checkpoint.restore_state(path)
    assert got["n"] == 7 and got["names"] == ("a", "b")
    np.testing.assert_array_equal(got["boards"][0], state["boards"][0])
    checkpoint.save_state(path, {"n": 8})
    assert checkpoint.restore_state(path) == {"n": 8}
    assert not (tmp_path / "sub" / "queue.state.tmp").exists()


def test_state_checkpoint_truncation_fails_clean(tmp_path):
    """Cut at any offset: a clean ValueError naming the failure, with the
    JAX package's text for the same cut."""
    path = tmp_path / "q.state"
    checkpoint.save_state(
        path, {"pending": [{"board": np.ones((8, 8), np.uint8), "steps": 3}]})
    blob = path.read_bytes()
    head = len(checkpoint.STATE_MAGIC) + checkpoint._STATE_HEADER.size
    cuts = {3: "magic", len(checkpoint.STATE_MAGIC) + 4: "truncated",
            head + (len(blob) - head) // 2: "truncated",
            len(blob) - 1: "truncated"}
    for cut, expect in cuts.items():
        trunc = tmp_path / f"cut_{cut}.state"
        trunc.write_bytes(blob[:cut])
        with pytest.raises(ValueError, match=expect) as ours:
            checkpoint.restore_state(trunc)
        with pytest.raises(ValueError) as theirs:
            jckpt.restore_state(trunc)
        assert str(ours.value) == str(theirs.value)


def test_state_checkpoint_fsyncs_parent_directory(tmp_path, monkeypatch):
    synced_dirs = []
    real_fsync = os.fsync

    def spy_fsync(fd):
        if stat.S_ISDIR(os.fstat(fd).st_mode):
            synced_dirs.append(os.path.realpath(f"/proc/self/fd/{fd}")
                               if os.path.exists(f"/proc/self/fd/{fd}")
                               else "<dir>")
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", spy_fsync)
    checkpoint.save_state(tmp_path / "sub" / "queue.state", {"n": 1})
    assert synced_dirs, "save_state never fsynced a directory fd"
    assert any(d.endswith("sub") or d == "<dir>" for d in synced_dirs)


def test_state_checkpoint_garbage_crc_and_missing(tmp_path):
    garbage = tmp_path / "garbage.state"
    garbage.write_bytes(b"not a checkpoint at all, just bytes\n" * 3)
    with pytest.raises(ValueError, match="magic"):
        checkpoint.restore_state(garbage)
    path = tmp_path / "q.state"
    checkpoint.save_state(path, {"n": 1})
    blob = bytearray(path.read_bytes())
    blob[-1] ^= 0xFF
    flipped = tmp_path / "flipped.state"
    flipped.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="CRC"):
        checkpoint.restore_state(flipped)
    with pytest.raises(ValueError, match="no readable"):
        checkpoint.restore_state(tmp_path / "missing.state")


def test_state_checkpoint_version_skew_fails_clean(tmp_path):
    payload = pickle.dumps({"v": 2})
    for magic in (b"MOMP-STATE/2\n", b"MOMP-STATE/9\n", b"OTHER-FMT/1\n"):
        skew = tmp_path / f"skew-{magic[:4].decode()}.state"
        skew.write_bytes(magic + struct.pack(">QI", len(payload),
                                             zlib.crc32(payload)) + payload)
        with pytest.raises(ValueError, match="magic"):
            checkpoint.restore_state(skew)


def test_state_checkpoint_undecodable_payload(tmp_path):
    payload = b"\x80\x05not a pickle"
    path = tmp_path / "u.state"
    path.write_bytes(checkpoint.STATE_MAGIC + struct.pack(
        ">QI", len(payload), zlib.crc32(payload)) + payload)
    with pytest.raises(ValueError, match="failed to decode"):
        checkpoint.restore_state(path)


def test_quarantine_unique_stamped_copies(tmp_path):
    src = tmp_path / "artifact.bin"
    names = []
    for i in range(3):
        src.write_bytes(f"corruption #{i}".encode())
        dst = checkpoint.quarantine(src)
        assert dst is not None and not src.exists()
        names.append(dst)
    assert len(set(names)) == 3
    contents = sorted(open(n, "rb").read() for n in names)
    assert contents == [b"corruption #0", b"corruption #1",
                        b"corruption #2"]
    assert all(".corrupt." in n for n in names)
    assert checkpoint.quarantine(src) is None
    src.write_bytes(b"x")
    labeled = checkpoint.quarantine(src, label="stale")
    assert labeled is not None and ".stale." in labeled


def test_save_refuses_a_stack(tmp_path):
    with pytest.raises(ValueError, match="one \\(ny, nx\\) board"):
        checkpoint.save(tmp_path / "s.state", np.zeros((2, 4, 4), np.uint8),
                        0)
    checkpoint.save(tmp_path / "t.state", torch.ones(4, 4, dtype=torch.uint8),
                    3)
    board, step = checkpoint.restore(tmp_path / "t.state")
    assert step == 3 and board.dtype == np.uint8 and board.sum() == 16
