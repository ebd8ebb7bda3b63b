"""The port's serial LifeSim and CLI held against the JAX package's.

The JAX side runs ``LifeSim(layout="serial", impl="pallas")``, whose
resident Pallas kernel runs in interpret mode on the CPU; the port runs
``LifeSim(layout="serial", device="cpu")``, whose kernel wrappers take
their plain PyTorch versions there. Boards must be bit-identical and VTK
snapshots at the save cadence byte-identical.
"""

import os

import numpy as np
import pytest

from conftest import oracle_n as _oracle

from mpi_and_open_mp_tpu.models.life import LifeSim as JaxSim
from mpi_and_open_mp_tpu.utils.config import LifeConfig
from mpi_and_open_mp_tpu_torch import LifeSim, load_config
from mpi_and_open_mp_tpu_torch.apps import life as life_app

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLIDER = os.path.join(ROOT, "tests", "fixtures", "glider_10x10.cfg")
GUN_BIG = os.path.join(ROOT, "configs", "gun_big_500x500.cfg")


def _vtk_files(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _assert_same_snapshots(ours, theirs):
    names = _vtk_files(theirs)
    assert names and names == _vtk_files(ours)
    for name in names:
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


def _jax_cfg(cfg):
    return LifeConfig(steps=cfg.steps, save_steps=cfg.save_steps,
                      nx=cfg.nx, ny=cfg.ny, cells=cfg.cells)


@pytest.mark.parametrize("impl", ["native", "roll", "auto"])
def test_glider_matches_jax_with_snapshots(tmp_path, impl):
    cfg = load_config(GLIDER)  # 100 steps, snapshot every 25
    sim = LifeSim(cfg, layout="serial", impl=impl, device="cpu",
                  outdir=tmp_path / "port")
    ref = JaxSim(_jax_cfg(cfg), layout="serial", impl="pallas",
                 outdir=tmp_path / "jax")
    got = sim.run()
    want = np.asarray(ref.run())
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(got, _oracle(cfg.board(), cfg.steps))
    assert _vtk_files(tmp_path / "port") == [
        f"life_{i:06d}.vtk" for i in (0, 25, 50, 75)]
    _assert_same_snapshots(tmp_path / "port", tmp_path / "jax")
    assert sim.native_path == ("vmem" if impl == "native" else None)


def test_gun_big_full_width_matches_jax(tmp_path):
    """p46gun_big at its full 500x500 width, 300 steps, snapshots every
    100 steps through the resident path on both sides."""
    cfg = load_config(GUN_BIG)
    cfg = type(cfg)(steps=300, save_steps=100, nx=cfg.nx, ny=cfg.ny,
                    cells=cfg.cells)
    sim = LifeSim(cfg, impl="native", device="cpu", outdir=tmp_path / "port")
    assert sim.native_path == "vmem"
    ref = JaxSim(_jax_cfg(cfg), layout="serial", impl="pallas",
                 outdir=tmp_path / "jax")
    got = sim.run()
    assert np.array_equal(got, np.asarray(ref.run()))
    _assert_same_snapshots(tmp_path / "port", tmp_path / "jax")
    assert sim.step_count == 300


def test_step_reset_warmup_debug_check():
    cfg = load_config(GLIDER)
    sim = LifeSim(cfg, impl="native", device="cpu")
    sim.warmup()
    assert sim.step_count == 0 and np.array_equal(sim.collect(), cfg.board())
    sim.step(4)
    sim.sync()
    sim.debug_check()
    assert np.array_equal(sim.collect(), _oracle(cfg.board(), 4))
    sim.reset()
    assert sim.step_count == 0 and np.array_equal(sim.collect(), cfg.board())
    assert sim._segment_lengths() == [100]


def test_initial_board_and_step():
    cfg = load_config(GLIDER)
    board = _oracle(cfg.board(), 60)
    sim = LifeSim(cfg, impl="native", device="cpu", initial_board=board,
                  initial_step=60)
    assert np.array_equal(sim.run(), _oracle(cfg.board(), 100))
    with pytest.raises(ValueError, match="initial_board"):
        LifeSim(cfg, device="cpu", initial_board=np.zeros((3, 3), np.uint8))


def test_debug_check_catches_a_wrong_stepper():
    cfg = load_config(GLIDER)
    sim = LifeSim(cfg, impl="native", device="cpu")
    sim._advance = lambda board, n: board  # a stepper that never steps
    with pytest.raises(AssertionError, match="diverge"):
        sim.debug_check()


@pytest.mark.parametrize("kwargs,item", [
    ({"layout": "row"}, "item 3"),
    ({"checkpoint_dir": "ck"}, "item 4"),
    ({"initial_board": np.zeros((2, 10, 10), np.uint8)}, "item 5"),
    ({"workload": "heat"}, "item 7"),
])
def test_not_ported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        LifeSim(load_config(GLIDER), device="cpu", **kwargs)


def test_bad_options_raise():
    cfg = load_config(GLIDER)
    with pytest.raises(ValueError, match="layout"):
        LifeSim(cfg, layout="diagonal", device="cpu")
    with pytest.raises(ValueError, match="impl"):
        LifeSim(cfg, impl="pallas", device="cpu")


def test_cli_matches_jax_cli(tmp_path, capsys):
    """The port's CLI prints one elapsed-seconds line, appends times.txt,
    writes the same snapshots as the JAX CLI and the same population."""
    from mpi_and_open_mp_tpu.apps import life as jax_app

    times = tmp_path / "times.txt"
    rc = life_app.main([GLIDER, "--layout", "serial", "--device", "cpu",
                        "--outdir", str(tmp_path / "port"), "--times-file",
                        str(times), "--print-final-population",
                        "--debug-check"])
    out, err = capsys.readouterr()
    assert rc == 0
    assert len(out.strip().splitlines()) == 1 and float(out) >= 0
    assert err.strip() == "5"
    assert len(times.read_text().splitlines()) == 1
    assert jax_app.main([GLIDER, "--layout", "serial", "--impl", "pallas",
                         "--outdir", str(tmp_path / "jax"),
                         "--print-final-population"]) == 0
    _, jax_err = capsys.readouterr()
    assert jax_err.strip().splitlines()[-1] == "5"
    _assert_same_snapshots(tmp_path / "port", tmp_path / "jax")
