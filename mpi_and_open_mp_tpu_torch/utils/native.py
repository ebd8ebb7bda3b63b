"""ctypes bindings to the native C++ IO library (``native/``).

Counterpart of ``mpi_and_open_mp_tpu/utils/native.py``, with the port's
own bindings. The reference's runtime layer (config parsing and VTK
serialisation, ``3-life/life2d.c:52-102``) is compiled C; so is the
repository's: ``native/lifeio.cpp``, built as ``native/liblifeio.so`` by
``make -C native``. It is host file IO, not a kernel of the device.

Rules, as the JAX package's:

* the library is ``$MOMP_NATIVE_LIB`` when set (a non-editable install has
  no ``native/`` beside the package), else ``native/liblifeio.so`` of the
  repository; both read once, when this module is imported;
* ``LIFE_TPU_NO_NATIVE`` (any value) keeps the library unloaded;
* a library without the newest entry point (``lifeio_life_steps_bits``)
  is a stale build and is not used;
* a library that fails to load leaves :func:`available` False, and
  ``utils.config.load_config`` and ``utils.vtk.write_vtk`` take their
  Python forms: quietly for the repository's default path, with a
  ``RuntimeWarning`` for an explicit ``MOMP_NATIVE_LIB``, which is a
  misconfiguration the variable exists to fix.

:func:`life_steps` is the compiled Life oracle (the role of the
reference's ``life2d`` binary): the byte-per-cell step and, with
``bits=True``, the bit-packed one (64 cells a word).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False

# The repository holds this package and native/ side by side.
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_FROM_ENV = bool(os.environ.get("MOMP_NATIVE_LIB"))
_SO_PATH = (os.environ.get("MOMP_NATIVE_LIB")
            or os.path.join(_REPO, "native", "liblifeio.so"))

_LL = ctypes.c_longlong
_LLP = ctypes.POINTER(ctypes.c_longlong)
_STEPS_ARGS = [ctypes.POINTER(ctypes.c_uint8), _LL, _LL, _LL]


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("LIFE_TPU_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
        lib.lifeio_life_steps_bits  # the newest symbol: a stale build lacks it
    except (OSError, AttributeError) as e:
        if _FROM_ENV:
            import warnings

            warnings.warn(
                f"MOMP_NATIVE_LIB={_SO_PATH} failed to load"
                f" ({type(e).__name__}: {e}); falling back to the Python"
                " implementations", RuntimeWarning, stacklevel=3)
        return None
    lib.lifeio_load_config.restype = ctypes.c_int
    # steps, save_steps, nx, ny, ncells; then the cells buffer.
    lib.lifeio_load_config.argtypes = [ctypes.c_char_p, _LLP,
                                       ctypes.POINTER(_LLP)]
    lib.lifeio_free.restype = None
    lib.lifeio_free.argtypes = [_LLP]
    lib.lifeio_write_vtk.restype = ctypes.c_int
    lib.lifeio_write_vtk.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int), _LL, _LL]
    for fn in (lib.lifeio_life_steps, lib.lifeio_life_steps_bits):
        fn.restype = None
        fn.argtypes = _STEPS_ARGS
    _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the library loaded (and is not stale or switched off)."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"native lifeio library not available (expected at {_SO_PATH}):"
            " build it with `make -C native` in the repository, or point"
            " MOMP_NATIVE_LIB at a built liblifeio.so")
    return lib


def load_config(path):
    """Parse a ``.cfg`` file with the C parser: ``utils.config.LifeConfig``,
    equal to the Python parser's."""
    from mpi_and_open_mp_tpu_torch.utils.config import LifeConfig

    lib = _require()
    header = (ctypes.c_longlong * 5)()
    cells_ptr = _LLP()
    rc = lib.lifeio_load_config(str(path).encode(), header,
                                ctypes.byref(cells_ptr))
    if rc != 0:
        raise ValueError(f"{path}: native config parse failed (rc={rc})")
    steps, save_steps, nx, ny, ncells = (int(v) for v in header)
    try:
        if ncells:
            cells = np.ctypeslib.as_array(
                cells_ptr, shape=(ncells * 2,)).copy().reshape(-1, 2)
        else:
            cells = np.zeros((0, 2), dtype=np.int64)
    finally:
        lib.lifeio_free(cells_ptr)
    return LifeConfig(steps=steps, save_steps=save_steps, nx=nx, ny=ny,
                      cells=cells)


def life_steps(board: np.ndarray, steps: int, bits: bool = False
               ) -> np.ndarray:
    """``board`` (``(ny, nx)``, 0/1) after ``steps`` torus generations of the
    compiled oracle: a byte a cell, or with ``bits=True`` the bit-packed
    carry-save variant. A new uint8 array; ``board`` is untouched."""
    lib = _require()
    out = np.ascontiguousarray(board, dtype=np.uint8).copy()
    ny, nx = out.shape
    fn = lib.lifeio_life_steps_bits if bits else lib.lifeio_life_steps
    fn(out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nx, ny,
       int(steps))
    return out


def write_vtk(path, board: np.ndarray) -> None:
    """Write one ``(ny, nx)`` snapshot with the C writer, byte for byte the
    Python writer's (``utils.vtk.write_vtk_py``)."""
    lib = _require()
    board = np.ascontiguousarray(board, dtype=np.int32)
    ny, nx = board.shape
    rc = lib.lifeio_write_vtk(
        str(path).encode(),
        board.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nx, ny)
    if rc != 0:
        raise OSError(f"{path}: native VTK write failed (rc={rc})")
