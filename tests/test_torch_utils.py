"""The port's config, VTK, timing and unpacked-step modules held against
the JAX package's (bit-exact: 0/1 integer boards, byte-equal files)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_and_open_mp_tpu.ops import life_ops as jlo
from mpi_and_open_mp_tpu.utils import config as jcfg
from mpi_and_open_mp_tpu.utils import vtk as jvtk
from mpi_and_open_mp_tpu_torch.ops import life_ops as tlo
from mpi_and_open_mp_tpu_torch.utils import config as tcfg
from mpi_and_open_mp_tpu_torch.utils import timing as ttiming
from mpi_and_open_mp_tpu_torch.utils import vtk as tvtk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
CONFIGS = sorted(
    os.path.join(d, f)
    for d in (FIXTURES, os.path.join(ROOT, "configs"))
    for f in os.listdir(d) if f.endswith(".cfg"))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_jax(path):
    ours = tcfg.load_config(path)
    theirs = jcfg.load_config_py(path)
    assert (ours.steps, ours.save_steps, ours.nx, ours.ny) == (
        theirs.steps, theirs.save_steps, theirs.nx, theirs.ny)
    assert np.array_equal(ours.cells, theirs.cells)
    assert np.array_equal(ours.board(), theirs.board())


def test_config_roundtrip(tmp_path):
    ours = tcfg.load_config(os.path.join(FIXTURES, "rpentomino_40x32.cfg"))
    path = tmp_path / "again.cfg"
    tcfg.save_config(path, ours)
    jcfg.save_config(tmp_path / "jax.cfg", jcfg.load_config_py(path))
    assert path.read_text() == (tmp_path / "jax.cfg").read_text()
    again = tcfg.load_config(path)
    assert np.array_equal(again.board(), ours.board())
    built = tcfg.config_from_board(ours.board(), 7, 3)
    assert built.shape == ours.shape and (built.steps, built.save_steps) == (7, 3)
    assert np.array_equal(built.board(), ours.board())


def test_load_config_errors(tmp_path):
    """The Python parser's errors (``load_config`` takes the native parser
    when it is built; its errors are ``test_torch_native.py``'s)."""
    bad = tmp_path / "bad.cfg"
    bad.write_text("10 1 5\n")
    with pytest.raises(ValueError, match="at least"):
        tcfg.load_config_py(bad)
    bad.write_text("10 1 5 5 1\n")
    with pytest.raises(ValueError, match="dangling"):
        tcfg.load_config_py(bad)


def test_vtk_golden_file(tmp_path):
    """The writer's bytes for the glider fixture are the committed golden
    frame, and the reader inverts it."""
    golden = os.path.join(FIXTURES, "golden_glider_000000.vtk")
    cfg = tcfg.load_config(os.path.join(FIXTURES, "glider_10x10.cfg"))
    assert np.array_equal(tvtk.read_vtk(golden), cfg.board())
    ours = tmp_path / "life_000000.vtk"
    tvtk.write_vtk(ours, cfg.board())
    with open(golden, "rb") as fd:
        assert ours.read_bytes() == fd.read()


def test_vtk_matches_jax_writer(tmp_path):
    b = (np.random.default_rng(3).random((17, 23)) < 0.5).astype(np.uint8)
    tvtk.write_vtk(tmp_path / "a.vtk", b)
    jvtk.write_vtk_py(tmp_path / "b.vtk", b)
    assert (tmp_path / "a.vtk").read_bytes() == (tmp_path / "b.vtk").read_bytes()
    assert np.array_equal(tvtk.read_vtk(tmp_path / "a.vtk"), b)
    assert tvtk.vtk_path("out", 25) == jvtk.vtk_path("out", 25)


def test_times_txt_and_sync(tmp_path):
    path = str(tmp_path / "times.txt")
    ttiming.append_times_txt(path, 1.23456)
    ttiming.append_times_txt(path, 2.0)
    assert open(path).read() == "1.235\n2.000\n"
    ttiming.sync(torch.zeros(3))  # a CPU tensor has nothing to wait for


def test_timer_runs_live_and_freezes_at_exit():
    with ttiming.Timer() as t:
        first = t.elapsed
        assert t.elapsed >= first >= 0.0  # live inside the block
    frozen = t.elapsed
    assert frozen >= first and t.elapsed == frozen


def test_write_csv_rows_bytes_equal_jax(tmp_path):
    from mpi_and_open_mp_tpu.utils import timing as jtiming

    rows = ["size,time", "1,2.500000", "10,3.000000"]
    ttiming.write_csv_rows(str(tmp_path / "port" / "a.csv"), rows)
    jtiming.write_csv_rows(str(tmp_path / "jax" / "a.csv"), rows)
    assert (tmp_path / "port" / "a.csv").read_bytes() == \
        (tmp_path / "jax" / "a.csv").read_bytes()
    ttiming.write_csv_rows(str(tmp_path / "port" / "a.csv"), rows[:1])
    assert (tmp_path / "port" / "a.csv").read_text() == "size,time\n"


@pytest.mark.parametrize("shape", [(10, 10), (7, 13), (64, 33)])
def test_unpacked_steps_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    b = (rng.random(shape) < 0.35).astype(np.uint8)
    want = np.asarray(jlo.life_step_roll(jnp.asarray(b)))
    assert np.array_equal(tlo.life_step_roll(torch.from_numpy(b)).numpy(), want)
    assert np.array_equal(tlo.life_step_numpy(b), jlo.life_step_numpy(b))
    padded = np.pad(b, 1, mode="wrap")
    assert np.array_equal(
        tlo.life_step_padded(torch.from_numpy(padded)).numpy(),
        np.asarray(jlo.life_step_padded(jnp.asarray(padded))))
    t = torch.from_numpy(b)
    for depth in (1, 2):
        assert np.array_equal(tlo.pad_x_wrap(t, depth).numpy(),
                              np.asarray(jlo.pad_x_wrap(jnp.asarray(b), depth)))
        assert np.array_equal(tlo.pad_y_wrap(t, depth).numpy(),
                              np.asarray(jlo.pad_y_wrap(jnp.asarray(b), depth)))
