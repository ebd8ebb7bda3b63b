"""Game-of-Life stencil steps on unpacked boards (rule + neighbour count).

Counterpart of ``mpi_and_open_mp_tpu/ops/life_ops.py``. Semantics match the
reference oracle ``3-life/life2d.c``: a periodic torus where every
neighbour index wraps (``life2d.c:9``), birth on exactly 3 neighbours and
survival on 2 or 3 (``life2d.c:117-123``). Boards are ``(ny, nx)`` 0/1
integer arrays indexed ``board[j, i]``, so every version here is bit-exact
against every other.

* :func:`life_step_numpy` - host NumPy oracle, the ground truth.
* :func:`life_step_roll` - whole-board torus step by circular shifts.
* :func:`life_step_padded` - step the interior of a halo-padded block.
"""

from __future__ import annotations

import numpy as np
import torch


def life_rule(alive, neighbours):
    """Conway rule on 0/1 integer arrays (NumPy or torch); returns the
    dtype of ``alive`` (the Life update of ``stencils/spec.py:_life_update``)."""
    out = (neighbours == 3) | ((neighbours == 2) & (alive == 1))
    if isinstance(out, torch.Tensor):
        return out.to(alive.dtype)
    return out.astype(alive.dtype)


def life_step_numpy(board: np.ndarray) -> np.ndarray:
    """Host-side oracle step; torus wrap via ``np.roll`` on both axes."""
    board = np.asarray(board)
    n = sum(
        np.roll(np.roll(board, dj, axis=0), di, axis=1)
        for dj in (-1, 0, 1)
        for di in (-1, 0, 1)
        if (dj, di) != (0, 0)
    )
    return life_rule(board, n)


def life_step_roll(board: torch.Tensor) -> torch.Tensor:
    """One torus step by circular shifts: the 3-row column sums, then
    their 3-column sums, minus the centre (4 rolls; exact in any integer
    dtype, since a count never exceeds 9)."""
    col = board + torch.roll(board, 1, 0) + torch.roll(board, -1, 0)
    total = col + torch.roll(col, 1, 1) + torch.roll(col, -1, 1)
    return life_rule(board, total - board)


def life_step_padded(padded: torch.Tensor) -> torch.Tensor:
    """Step the interior of an ``(h + 2, w + 2)`` halo-padded block whose
    ghost cells (edges and corners) already hold the neighbouring state;
    returns the ``(h, w)`` interior."""
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    n = sum(
        padded[1 + dj : 1 + dj + h, 1 + di : 1 + di + w]
        for dj in (-1, 0, 1)
        for di in (-1, 0, 1)
        if (dj, di) != (0, 0)
    )
    return life_rule(padded[1 : 1 + h, 1 : 1 + w], n)


def pad_x_wrap(block: torch.Tensor, depth: int = 1) -> torch.Tensor:
    """Pad the x (last) axis with its own torus wrap."""
    return torch.cat([block[..., -depth:], block, block[..., :depth]], dim=-1)


def pad_y_wrap(block: torch.Tensor, depth: int = 1) -> torch.Tensor:
    """Pad the y (second-to-last) axis with its own torus wrap."""
    return torch.cat(
        [block[..., -depth:, :], block, block[..., :depth, :]], dim=-2)
