"""Sparse active-tile stencil engine: skip the settled regions.

Counterpart of ``mpi_and_open_mp_tpu/stencils/sparse.py``. A cell can only
change if some cell within its radius changed last step, so a tile whose
radius-wide neighbourhood is settled stays settled. The engine keeps a
boolean "active" mask per tile (changed tiles, plus each neighbour whose
shared ``radius``-wide border band changed), gathers the active tiles with
their halos through modular index arrays, advances them in one device
step (``engine.step_padded`` over the gathered stack) and scatters the
results back. When the active fraction passes ``crossover``, the step is
the dense ``engine.step_roll`` over the whole board, and the mask is
rebuilt from the full-board diff.

The gathered stack's tile count is padded on the {pow2, 1.5*pow2} ladder
(:func:`_pad_count`), as in the JAX package, where it bounds the compiled
shapes; here it keeps the device allocations to a few sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.stencils import engine
from mpi_and_open_mp_tpu_torch.stencils.spec import StencilSpec
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device


def _pad_count(n: int) -> int:
    """Next size on the {pow2, 1.5*pow2} ladder (1,2,3,4,6,8,12,16,...)."""
    p = 1
    while p < n:
        if p + p // 2 >= n and p >= 2:
            return p + p // 2
        p *= 2
    return p


def _dilate(mask: np.ndarray) -> np.ndarray:
    """8-neighbour dilation with torus wrap."""
    out = mask.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                out |= np.roll(np.roll(mask, dy, axis=0), dx, axis=1)
    return out


class ActiveTileEngine:
    """Advance a torus board, stepping only tiles that might change.

    ``board`` lives on the host (NumPy); each step gathers the active
    tiles, runs one device step on ``device`` (the card unless the caller
    asks for the CPU) and scatters back. ``engine_stamp`` reads
    ``sparse:t<tile>`` while the sparse path runs, ``dense:crossover``
    when only the dense fallback ran.
    """

    def __init__(self, spec: StencilSpec, board, *, tile: int = 128,
                 crossover: float = 0.5,
                 device: str | torch.device = "cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        board = np.array(board, dtype=spec.np_dtype)
        if board.shape != spec.board_shape(*board.shape[-2:]):
            raise ValueError(
                f"sparse: board shape {board.shape} does not match "
                f"spec {spec.name!r} (channels={spec.channels})")
        ny, nx = board.shape[-2:]
        if ny % tile or nx % tile:
            raise ValueError(
                f"sparse: tile {tile} must divide the board {ny}x{nx}")
        if spec.radius > tile:
            raise ValueError(
                f"sparse: radius {spec.radius} exceeds tile {tile} "
                "(the one-tile dilation would under-activate)")
        self.board = board
        self.tile = int(tile)
        self.crossover = float(crossover)
        self.ty, self.tx = ny // tile, nx // tile
        # Everything starts active: the first step proves settledness.
        self.active = np.ones((self.ty, self.tx), dtype=bool)
        self.sparse_steps = 0
        self.dense_steps = 0
        self.tiles_stepped = 0
        self.tiles_skipped = 0
        self._frac_sum = 0.0
        self._frac_n = 0
        r = spec.radius
        # Modular halo index rows per tile coordinate, computed once.
        self._rows = [
            np.arange(j * tile - r, (j + 1) * tile + r) % ny
            for j in range(self.ty)]
        self._cols = [
            np.arange(i * tile - r, (i + 1) * tile + r) % nx
            for i in range(self.tx)]

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _tile_step(self, stack: np.ndarray) -> np.ndarray:
        """One ``step_padded`` over a (k, *lead, t+2r, t+2r) tile stack."""
        out = engine._on_stack(
            self.spec, self._to_device(stack),
            lambda s: engine.step_padded(self.spec, s))
        return out.cpu().numpy()

    # -- observability -----------------------------------------------------
    @property
    def active_frac(self) -> float:
        """Current fraction of tiles in the active mask."""
        return float(self.active.mean())

    @property
    def mean_active_frac(self) -> float:
        """Mean active fraction over every step taken so far."""
        return self._frac_sum / self._frac_n if self._frac_n else 1.0

    @property
    def engine_stamp(self) -> str:
        if self.dense_steps and not self.sparse_steps:
            return "dense:crossover"
        return f"sparse:t{self.tile}"

    # -- stepping ----------------------------------------------------------
    def step(self, n: int = 1) -> np.ndarray:
        for _ in range(int(n)):
            self._step_once()
        return self.board

    def _step_once(self) -> None:
        frac = self.active.mean()
        self._frac_sum += float(frac)
        self._frac_n += 1
        if frac > self.crossover:
            self._dense_step()
            return
        self.sparse_steps += 1
        idx = np.argwhere(self.active)
        k = len(idx)
        self.tiles_stepped += k
        self.tiles_skipped += self.ty * self.tx - k
        if k == 0:
            return  # fully settled: nothing can change
        t, r = self.tile, self.spec.radius
        side = t + 2 * r
        kp = _pad_count(k)
        lead = (self.spec.channels,) if self.spec.channels > 1 else ()
        stack = np.zeros((kp, *lead, side, side), dtype=self.board.dtype)
        for s, (j, i) in enumerate(idx):
            stack[s] = self.board[
                ..., self._rows[j][:, None], self._cols[i][None, :]]
        out = self._tile_step(stack)
        # Border-band activation: a neighbour wakes only when changed cells
        # sit within ``radius`` of the shared edge.
        nxt = np.zeros((self.ty, self.tx), dtype=bool)
        ty, tx = self.ty, self.tx
        for s, (j, i) in enumerate(idx):
            new = out[s]
            sl = (..., slice(j * t, (j + 1) * t), slice(i * t, (i + 1) * t))
            d = new != self.board[sl]
            if self.spec.channels > 1:
                d = d.any(axis=0)
            if not d.any():
                continue
            self.board[sl] = new
            nxt[j, i] = True
            up, dn = (j - 1) % ty, (j + 1) % ty
            lf, rt = (i - 1) % tx, (i + 1) % tx
            if d[:r, :].any():
                nxt[up, i] = True
            if d[-r:, :].any():
                nxt[dn, i] = True
            if d[:, :r].any():
                nxt[j, lf] = True
            if d[:, -r:].any():
                nxt[j, rt] = True
            if d[:r, :r].any():
                nxt[up, lf] = True
            if d[:r, -r:].any():
                nxt[up, rt] = True
            if d[-r:, :r].any():
                nxt[dn, lf] = True
            if d[-r:, -r:].any():
                nxt[dn, rt] = True
        self.active = nxt

    def _dense_step(self) -> None:
        self.dense_steps += 1
        out = engine.step_roll(self.spec, self._to_device(self.board))
        out = out.cpu().numpy()
        diff = out != self.board
        if self.spec.channels > 1:
            diff = diff.any(axis=0)
        t = self.tile
        changed = diff.reshape(self.ty, t, self.tx, t).any(axis=(1, 3))
        self.board = out
        self.active = _dilate(changed)

    def counters(self) -> dict:
        """Step mix and skip accounting."""
        return {
            "sparse_steps": self.sparse_steps,
            "dense_steps": self.dense_steps,
            "tiles_stepped": self.tiles_stepped,
            "tiles_skipped": self.tiles_skipped,
            "tile": self.tile,
            "crossover": self.crossover,
            "active_frac": round(self.mean_active_frac, 6),
        }
