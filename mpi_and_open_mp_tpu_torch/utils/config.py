"""Life board configuration files (the port's own copy of the parser).

File format (the reference's ``.cfg`` contract, ``3-life/life_mpi.c:74-78``,
parsed by ``life_init`` at ``3-life/life2d.c:52-72``)::

    <steps>
    <save_steps>
    <nx> <ny>
    <i1> <j1>
    <i2> <j2>
    ...            # live-cell (i, j) pairs until EOF

``i`` is the column (x) index and ``j`` the row (y) index of a periodic
torus. Boards are ``(ny, nx)`` arrays indexed ``board[j, i]``. Counterpart
of ``mpi_and_open_mp_tpu/utils/config.py`` (its pure-Python parser; the
native C parser is not ported).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class LifeConfig:
    """A parsed Life run configuration."""

    steps: int
    save_steps: int
    nx: int
    ny: int
    cells: np.ndarray  # (n_live, 2) int array of (i, j) pairs

    @property
    def shape(self) -> tuple[int, int]:
        """Board array shape ``(ny, nx)``."""
        return (self.ny, self.nx)

    def board(self) -> np.ndarray:
        """Materialise the initial board as a ``(ny, nx)`` uint8 array."""
        b = np.zeros((self.ny, self.nx), dtype=np.uint8)
        if len(self.cells):
            i = self.cells[:, 0] % self.nx
            j = self.cells[:, 1] % self.ny
            b[j, i] = 1
        return b


def load_config(path: str | os.PathLike) -> LifeConfig:
    """Parse a ``.cfg`` file (reference semantics: read pairs to EOF)."""
    with open(path) as fd:
        tokens = fd.read().split()
    if len(tokens) < 4:
        raise ValueError(f"{path}: config needs at least steps/save_steps/nx/ny")
    steps, save_steps, nx, ny = (int(t) for t in tokens[:4])
    rest = tokens[4:]
    if len(rest) % 2:
        raise ValueError(f"{path}: dangling cell coordinate")
    cells = np.array([int(t) for t in rest], dtype=np.int64).reshape(-1, 2)
    return LifeConfig(steps=steps, save_steps=save_steps, nx=nx, ny=ny, cells=cells)


def save_config(path: str | os.PathLike, cfg: LifeConfig) -> None:
    """Write a config back out in the reference file format."""
    with open(path, "w") as fd:
        fd.write(f"{cfg.steps}\n{cfg.save_steps}\n{cfg.nx} {cfg.ny}\n")
        for i, j in np.asarray(cfg.cells):
            fd.write(f"{int(i)} {int(j)}\n")


def config_from_board(
    board: np.ndarray, steps: int, save_steps: int
) -> LifeConfig:
    """Build a config whose live-cell list reproduces ``board``."""
    board = np.asarray(board)
    ny, nx = board.shape
    j, i = np.nonzero(board)
    cells = np.stack([i, j], axis=1).astype(np.int64)
    return LifeConfig(steps=steps, save_steps=save_steps, nx=nx, ny=ny, cells=cells)
