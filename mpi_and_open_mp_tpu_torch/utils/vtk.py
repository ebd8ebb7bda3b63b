"""ASCII VTK 3.0 STRUCTURED_POINTS board snapshots.

Format-compatible with the reference's ``life_save_vtk``
(``3-life/life_mpi.c:120-148``) and byte-identical to the JAX package's
writer (``mpi_and_open_mp_tpu/utils/vtk.py``): header with
``DIMENSIONS nx+1 ny+1 1``, ``CELL_DATA nx*ny``, scalar field ``life``, one
cell value per line in ``ind = i + j*nx`` order. Files are named
``life_%06d.vtk`` by step index. :func:`write_vtk` takes the native C
writer when ``native/liblifeio.so`` is built (``utils.native``), else
:func:`write_vtk_py`; both write the same bytes.
"""

from __future__ import annotations

import os
import re

import numpy as np


def vtk_path(outdir: str | os.PathLike, step: int) -> str:
    return os.path.join(outdir, f"life_{step:06d}.vtk")


def write_vtk(path: str | os.PathLike, board: np.ndarray) -> None:
    """Write one ``(ny, nx)`` board snapshot (native C writer when built,
    Python otherwise)."""
    from mpi_and_open_mp_tpu_torch.utils import native

    board = np.asarray(board, dtype=np.int32)
    if native.available():
        native.write_vtk(path, board)
        return
    write_vtk_py(path, board)


def write_vtk_py(path: str | os.PathLike, board: np.ndarray) -> None:
    """The pure-Python writer."""
    board = np.asarray(board, dtype=np.int32)
    ny, nx = board.shape
    lines = [
        "# vtk DataFile Version 3.0",
        "Created by mpi_and_open_mp_tpu",
        "ASCII",
        "DATASET STRUCTURED_POINTS",
        f"DIMENSIONS {nx + 1} {ny + 1} 1",
        "SPACING 1 1 0.0",
        "ORIGIN 0 0 0.0",
        f"CELL_DATA {nx * ny}",
        "SCALARS life int 1",
        "LOOKUP_TABLE life_table",
    ]
    body = "\n".join(str(v) for v in board.ravel())
    with open(path, "w") as fd:
        fd.write("\n".join(lines) + "\n" + body + "\n")


_DIMS_RE = re.compile(r"DIMENSIONS\s+(\d+)\s+(\d+)\s+(\d+)")


def read_vtk(path: str | os.PathLike) -> np.ndarray:
    """Read a snapshot back into a ``(ny, nx)`` uint8 array."""
    with open(path) as fd:
        text = fd.read()
    m = _DIMS_RE.search(text)
    if not m:
        raise ValueError(f"{path}: no DIMENSIONS header")
    nx, ny = int(m.group(1)) - 1, int(m.group(2)) - 1
    body = text.split("LOOKUP_TABLE", 1)[1].split("\n", 1)[1]
    vals = np.array(body.split(), dtype=np.int64)
    if vals.size != nx * ny:
        raise ValueError(f"{path}: expected {nx * ny} cells, got {vals.size}")
    return vals.reshape(ny, nx).astype(np.uint8)
