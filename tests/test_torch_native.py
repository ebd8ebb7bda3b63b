"""The port's bindings of the native C++ IO library (``utils/native.py``)
against its Python forms and the JAX package's.

Every config of ``configs/`` and ``tests/fixtures/`` parses to the same
header and cells through the library, the port's ``load_config_py`` and
JAX's; the VTK writers give the same bytes; ``native.life_steps`` (both
forms) equals the port's and JAX's NumPy oracle; ``LIFE_TPU_NO_NATIVE``
and a bad ``MOMP_NATIVE_LIB`` keep the library out, as in JAX's
``tests/test_native.py``. The module skips, as that one does, when ``make
-C native`` fails.
"""

import glob
import importlib
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

from mpi_and_open_mp_tpu.ops.life_ops import life_step_numpy as jax_oracle
from mpi_and_open_mp_tpu.utils.config import load_config_py as jax_load
from mpi_and_open_mp_tpu.utils.vtk import write_vtk_py as jax_write_vtk
import mpi_and_open_mp_tpu_torch.utils as utils_pkg
from mpi_and_open_mp_tpu_torch.ops.life_ops import life_step_numpy
from mpi_and_open_mp_tpu_torch.utils import config as tcfg
from mpi_and_open_mp_tpu_torch.utils import native
from mpi_and_open_mp_tpu_torch.utils import vtk as tvtk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.cfg"))
                 + glob.glob(os.path.join(REPO, "tests", "fixtures",
                                          "*.cfg")))


@pytest.fixture(scope="module", autouse=True)
def built_lib():
    rc = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                        capture_output=True)
    if rc.returncode != 0 or not native.available():
        pytest.skip("native toolchain unavailable")


def _fields(cfg):
    return (cfg.steps, cfg.save_steps, cfg.nx, cfg.ny)


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_configs_equal_across_parsers(path):
    nat, py, jax = native.load_config(path), tcfg.load_config_py(path), \
        jax_load(path)
    assert _fields(nat) == _fields(py) == _fields(jax)
    np.testing.assert_array_equal(nat.cells, py.cells)
    np.testing.assert_array_equal(nat.cells, jax.cells)
    assert nat.cells.dtype == py.cells.dtype == np.int64
    # load_config takes the library when it is built.
    np.testing.assert_array_equal(tcfg.load_config(path).cells, nat.cells)


def test_native_parse_errors(tmp_path):
    bad = tmp_path / "bad.cfg"
    bad.write_text("1\n2\n")
    with pytest.raises(ValueError):
        native.load_config(bad)
    dangling = tmp_path / "dangling.cfg"
    dangling.write_text("1\n1\n4 4\n3\n")
    with pytest.raises(ValueError):
        native.load_config(dangling)
    with pytest.raises(ValueError):
        native.load_config(tmp_path / "missing.cfg")


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_vtk_bytes_equal_across_writers(tmp_path, path):
    board = tcfg.load_config_py(path).board()
    native.write_vtk(tmp_path / "native.vtk", board)
    tvtk.write_vtk_py(tmp_path / "py.vtk", board)
    jax_write_vtk(tmp_path / "jax.vtk", board)
    tvtk.write_vtk(tmp_path / "default.vtk", board)
    data = (tmp_path / "native.vtk").read_bytes()
    assert data == (tmp_path / "py.vtk").read_bytes()
    assert data == (tmp_path / "jax.vtk").read_bytes()
    assert data == (tmp_path / "default.vtk").read_bytes()
    np.testing.assert_array_equal(tvtk.read_vtk(tmp_path / "native.vtk"),
                                  board)


@pytest.mark.parametrize("shape,steps", [((37, 45), 13), ((64, 64), 20),
                                         ((10, 130), 7), ((1, 8), 3)])
@pytest.mark.parametrize("bits", [False, True])
def test_life_steps_match_oracles(shape, steps, bits):
    board = (np.random.default_rng(11).random(shape) < 0.35).astype(np.uint8)
    before = board.copy()
    got = native.life_steps(board, steps, bits=bits)
    ours, jax = board, board
    for _ in range(steps):
        ours, jax = life_step_numpy(ours), jax_oracle(jax)
    np.testing.assert_array_equal(got, ours)
    np.testing.assert_array_equal(got, jax)
    np.testing.assert_array_equal(board, before)  # the input is untouched


NATIVE = "mpi_and_open_mp_tpu_torch.utils.native"


def _fresh_native(monkeypatch, **env):
    """``utils.native`` imported again under ``env`` (its paths are read at
    import) and in use until the test ends, when the module the rest of
    the run holds comes back."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delitem(sys.modules, NATIVE)
    monkeypatch.setattr(utils_pkg, "native", native)
    return importlib.import_module(NATIVE)


def test_no_native_switch(monkeypatch, tmp_path):
    mod = _fresh_native(monkeypatch, LIFE_TPU_NO_NATIVE="1")
    assert not mod.available()
    with pytest.raises(RuntimeError, match="make -C native"):
        mod.load_config(CONFIGS[0])
    # The Python forms stand in, quietly.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = tcfg.load_config(CONFIGS[0])
        tvtk.write_vtk(tmp_path / "a.vtk", cfg.board())
    jax_write_vtk(tmp_path / "b.vtk", cfg.board())
    assert (tmp_path / "a.vtk").read_bytes() == (
        tmp_path / "b.vtk").read_bytes()


def test_bad_native_lib_warns(monkeypatch, tmp_path):
    stale = tmp_path / "liblifeio.so"
    stale.write_bytes(b"not a library")
    mod = _fresh_native(monkeypatch, MOMP_NATIVE_LIB=str(stale))
    with pytest.warns(RuntimeWarning, match="MOMP_NATIVE_LIB"):
        assert not mod.available()
    assert not mod.available()  # tried once


def test_missing_repo_lib_is_quiet(monkeypatch, tmp_path):
    """The repository's default path, missing: no warning, no library."""
    mod = _fresh_native(monkeypatch)
    monkeypatch.setattr(mod, "_SO_PATH", str(tmp_path / "missing.so"))
    monkeypatch.setattr(mod, "_FROM_ENV", False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not mod.available()


def test_stale_native_lib_rejected(monkeypatch, tmp_path):
    """A library without the newest entry point is a stale build: not
    used, with the warning an explicit ``MOMP_NATIVE_LIB`` gets."""
    src = tmp_path / "stale.cpp"
    src.write_text('extern "C" int lifeio_load_config() { return 0; }\n')
    lib = tmp_path / "libstale.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    mod = _fresh_native(monkeypatch, MOMP_NATIVE_LIB=str(lib))
    with pytest.warns(RuntimeWarning, match="lifeio_life_steps_bits"):
        assert not mod.available()
