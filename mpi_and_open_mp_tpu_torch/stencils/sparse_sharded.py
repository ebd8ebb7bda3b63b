"""Sparse active tiles on a sharded board: live-area cost at mesh scale.

Counterpart of ``mpi_and_open_mp_tpu/stencils/sparse_sharded.py``: the
active-tile skip of ``stencils.sparse`` composed with the sharded halo
rounds of ``parallel.haloplan``. A host-held GLOBAL active-tile mask over
a board held as the stacked shards of a ``parallel.mesh.Mesh`` (``(py, px,
h, w)``, every shard on one device); each round gathers the active tiles
of every shard, with ``radius * fuse``-deep halos cut from the exchanged
ghost frame, steps them ``fuse`` times and scatters them back in place.

**Activation crosses shards for free.** The mask lives in global tile
coordinates: each stepped tile reports a 3x3 border-band change flag (did
cells within the band of each edge and corner change between the last two
steps?), and the host wakes ``(gy + dy) % ty, (gx + dx) % tx``, which
neither knows nor cares where the shard boundaries fall. The gathered
tiles step through the same arithmetic over the same exchanged padding as
the dense sequential round, so the board equals the dense sharded board
bit for bit at every round (integer rules).

**The exchange skip.** Each round also reports whether any shard's
boundary band (the band-deep strips along the sharded axes) is live. When
none is, the next round pads the sharded axes with zeros
(``haloplan.padded_round_block_local``) in place of the exchanged ghosts
(``haloplan.padded_round_block``): equal, because the ghosts it replaces
are all zero. ``counters()["exchange_skips"]`` counts those rounds.

**The crossover.** Past ``crossover`` active fraction a round runs the
dense sharded runner (``engine.make_sharded_runner``) and the mask is
rebuilt from the diff of its last step pair (``dense:crossover``).
``MOMP_SPARSE_SHARDED=0`` pins every round to that runner and stamps
``dense:sharded``.

The round on the port: one frame of every shard at once on the ``(py, px,
h + 2d, w + 2d)`` stack (``d = radius * fuse``); every shard's active
tiles gathered into ONE ``(K, t + 2d, t + 2d)`` stack by index tensors;
``fuse`` steps of it through ``ops.native_stencil.stencil_step_padded``,
one launch a step for every shard (the hand-written ``stencil_padded``
kernel on the card, its plain version on the CPU), each step shrinking
the stack by ``radius`` a side to ``t``; the result scattered back with
``index_put_``; the band flags and the boundary-live scalar computed on
the device and fetched in one host copy a round. The JAX package pads the
per-shard tile count on a pow2 ladder to bound its compiled shapes and
steps a constant-shape frame re-padded with zeros; the port compiles
nothing per shape, so K is the real tile count and each tile is scattered
once. The counters count real tiles in both packages and are equal.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.stencils import engine
from mpi_and_open_mp_tpu_torch.stencils.sparse import _dilate
from mpi_and_open_mp_tpu_torch.stencils.spec import StencilSpec

ENV_SPARSE_SHARDED = "MOMP_SPARSE_SHARDED"


def sparse_sharded_enabled() -> bool:
    """The ``MOMP_SPARSE_SHARDED`` kill switch (default on)."""
    return os.environ.get(ENV_SPARSE_SHARDED, "1") != "0"


@dataclasses.dataclass(frozen=True)
class SparseShardedPlan:
    """One (layout, mesh, shard, tile) sparse-sharded decision, derived once
    per geometry: the sparse twin of ``haloplan.HaloPlan``."""

    layout: str                   # row | col | cart
    mesh_axes: tuple[int, int]    # (py, px)
    shard_shape: tuple[int, int]  # local (h, w) per shard
    tile: int
    crossover: float
    enabled: bool                 # sparse rounds may run at all
    engine: str                   # provenance stamp while sparse wins
    why: str                      # reason sparse was declined ("" if on)


@functools.lru_cache(maxsize=512)
def _plan(layout: str, mesh_axes: tuple[int, int],
          shard_shape: tuple[int, int], radius: int, tile: int,
          crossover: float, enabled: bool) -> SparseShardedPlan:
    h, w = shard_shape

    def off(why: str) -> SparseShardedPlan:
        return SparseShardedPlan(layout, mesh_axes, shard_shape, tile,
                                 crossover, False, "dense:sharded", why)

    if layout not in ("row", "col", "cart"):
        raise ValueError(f"layout must be row|col|cart, got {layout!r}")
    if not enabled:
        return off(f"{ENV_SPARSE_SHARDED}=0")
    if h % tile or w % tile:
        return off(f"tile {tile} does not divide shard {h}x{w}")
    if radius > tile:
        return off(f"radius {radius} exceeds tile {tile}")
    return SparseShardedPlan(
        layout, mesh_axes, shard_shape, tile, crossover, True,
        f"sparse-sharded:{layout}:t{tile}", "")


def plan_sparse_sharded(layout: str, mesh_axes: tuple[int, int],
                        shard_shape: tuple[int, int], radius: int,
                        tile: int, *, crossover: float = 0.5
                        ) -> SparseShardedPlan:
    """Derive (or fetch) the plan for one geometry. The kill switch is part
    of the cache key: flipping ``MOMP_SPARSE_SHARDED`` mid-process gives a
    fresh plan."""
    return _plan(layout, tuple(int(a) for a in mesh_axes),
                 tuple(int(a) for a in shard_shape), int(radius),
                 int(tile), float(crossover), sparse_sharded_enabled())


def _band_flags(d: torch.Tensor, b: int) -> torch.Tensor:
    """``(K, 3, 3)`` flags of a ``(K, t, t)`` change mask: entry ``[1 +
    dy, 1 + dx]`` says whether a cell changed within ``b`` of the edge (or
    corner) facing the neighbour at ``(dy, dx)``; ``[1, 1]`` whether any
    cell changed."""
    rows = torch.stack([d[:, :b].any(1), d.any(1), d[:, -b:].any(1)], 1)
    return torch.stack([rows[..., :b].any(-1), rows.any(-1),
                        rows[..., -b:].any(-1)], -1)


class SparseShardedEngine:
    """Advance a sharded torus board, stepping only tiles that might change:
    a round costs the live area of the whole mesh, not the area of a shard.

    The board is the stacked shards ``(py, px, h, w)`` on ``mesh``'s device
    (the card unless the mesh is the CPU's); the tile mask lives on the
    host in global tile coordinates. Every round gathers, steps ``fuse``
    times, scatters and fetches the band flags and the boundary-live flag
    in one host copy (module docstring).

    ``engine_stamp``: ``sparse-sharded:<layout>:t<tile>`` while sparse
    rounds ran, ``dense:crossover`` when the active fraction forced every
    round dense, ``dense:sharded`` when the plan is disabled.
    """

    def __init__(self, spec: StencilSpec, board, *, mesh,
                 layout: str = "row", tile: int = 64,
                 crossover: float = 0.5, exchange_skip: bool = True,
                 fuse: int = 16):
        from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib

        if spec.channels != 1:
            raise ValueError(
                f"sparse_sharded: single-channel specs only, "
                f"{spec.name!r} has {spec.channels}")
        if isinstance(board, torch.Tensor):
            board = board.to(device=mesh.device, dtype=spec.torch_dtype,
                             copy=True)
        else:
            board = torch.from_numpy(np.array(board, dtype=spec.np_dtype)).to(
                mesh.device)
        ny, nx = board.shape[-2:]
        py, px = engine.mesh_axes_for(layout, mesh)
        if ny % py or nx % px:
            raise ValueError(
                f"board {(ny, nx)} does not divide mesh "
                f"{dict(mesh.shape)} under layout={layout!r}")
        h, w = ny // py, nx // px
        if h % tile or w % tile:
            raise ValueError(
                f"sparse_sharded: tile {tile} must divide the shard "
                f"{h}x{w}")
        if spec.radius > tile:
            raise ValueError(
                f"sparse_sharded: radius {spec.radius} exceeds tile "
                f"{tile} (one-tile dilation would under-activate)")
        self.spec = spec
        self.mesh = mesh
        self.layout = layout
        self.tile = int(tile)
        self.crossover = float(crossover)
        self.exchange_skip = bool(exchange_skip)
        # Steps a round. The fused halo stays inside one tile ring
        # (radius * fuse <= tile), so the 3x3 wake flags still name every
        # tile activation can reach in one round.
        self.fuse = max(1, min(int(fuse), self.tile // spec.radius))
        self.shape = (int(ny), int(nx))
        self.mesh_axes = (py, px)
        self.shard_shape = (h, w)
        self.plan = plan_sparse_sharded(
            layout, (py, px), (h, w), spec.radius, tile,
            crossover=crossover)
        # Global and per-shard tile grids.
        self.ty, self.tx = ny // tile, nx // tile
        self._mty, self._mtx = h // tile, w // tile
        self.board = mesh_lib.shard(board, py, px)
        # Everything starts active, and the first round exchanges:
        # settledness and dead boundaries are proven, never assumed.
        self.active = np.ones((self.ty, self.tx), dtype=bool)
        self._exchange_needed = True
        self._dense_run = None  # built at the first crossover
        self.sparse_steps = 0
        self.dense_steps = 0
        self.settled_steps = 0
        self.tiles_stepped = 0
        self.tiles_skipped = 0
        self.exchange_rounds = 0
        self.exchange_skips = 0
        self._frac_sum = 0.0
        self._frac_n = 0

    # -- observability -----------------------------------------------------
    @property
    def active_frac(self) -> float:
        return float(self.active.mean())

    @property
    def mean_active_frac(self) -> float:
        return self._frac_sum / self._frac_n if self._frac_n else 1.0

    @property
    def engine_stamp(self) -> str:
        if not self.plan.enabled:
            return "dense:sharded"
        if self.dense_steps and not self.sparse_steps:
            return "dense:crossover"
        return self.plan.engine

    def counters(self) -> dict:
        """Step mix, skip accounting and the exchange round/skip split, with
        the JAX package's keys and values."""
        return {
            "sparse_steps": self.sparse_steps,
            "dense_steps": self.dense_steps,
            "settled_steps": self.settled_steps,
            "tiles_stepped": self.tiles_stepped,
            "tiles_skipped": self.tiles_skipped,
            "exchange_rounds": self.exchange_rounds,
            "exchange_skips": self.exchange_skips,
            "tile": self.tile,
            "fuse": self.fuse,
            "crossover": self.crossover,
            "active_frac": round(self.mean_active_frac, 6),
        }

    def global_board(self) -> torch.Tensor:
        """The ``(ny, nx)`` board on the mesh's device."""
        from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib

        return mesh_lib.unshard(self.board)

    def snapshot(self) -> np.ndarray:
        return self.global_board().cpu().numpy()

    # -- stepping ----------------------------------------------------------
    def step(self, n: int = 1) -> torch.Tensor:
        """Advance ``n`` steps in rounds of up to ``fuse``; returns the
        global board on the device."""
        n = int(n)
        while n > 0:
            f = min(self.fuse, n)
            self._round(f)
            n -= f
        return self.global_board()

    def _round(self, f: int) -> None:
        frac = self.active.mean()
        self._frac_sum += float(frac)
        self._frac_n += 1
        if not self.plan.enabled or frac > self.crossover:
            self._dense_round(f)
            return
        self.sparse_steps += f
        idx = np.argwhere(self.active)
        k = len(idx)
        self.tiles_stepped += k
        self.tiles_skipped += self.ty * self.tx - k
        if k == 0:
            # Fully settled: nothing can change, so no launch and no
            # exchange; the standing exchange flag stays valid.
            self.settled_steps += f
            return
        self._sparse_round(idx, f)

    # -- the sparse round --------------------------------------------------

    def _bucket(self, idx: np.ndarray) -> torch.Tensor:
        """``(4, K)`` int64 on the device: each active global tile's shard
        ``(sy, sx)`` and its local tile coordinates ``(ly, lx)`` there, in
        the order of ``idx`` (one host-to-device copy)."""
        gy, gx = idx[:, 0], idx[:, 1]
        coords = np.stack([gy // self._mty, gx // self._mtx,
                           gy % self._mty, gx % self._mtx])
        return torch.from_numpy(coords.astype(np.int64)).to(self.board.device)

    def _gather(self, where: tuple, d: int, exchange: bool) -> torch.Tensor:
        """The ``(K, t + 2d, t + 2d)`` stack of the tiles at ``where``
        (:meth:`_bucket`), each with a ``d``-deep halo cut from every
        shard's exchanged (or zero-sentinel) frame."""
        from mpi_and_open_mp_tpu_torch.parallel import haloplan

        frame = (haloplan.padded_round_block if exchange
                 else haloplan.padded_round_block_local)(self.layout,
                                                         self.board, d)
        # Every shard's (t + 2d)^2 windows at stride t, as a view; the
        # active ones gathered into one stack.
        t = self.tile
        side = t + 2 * d
        return frame.unfold(2, side, t).unfold(3, side, t)[where]

    def _sparse_round(self, idx: np.ndarray, f: int) -> None:
        from mpi_and_open_mp_tpu_torch.ops import native_stencil

        spec, t, r = self.spec, self.tile, self.spec.radius
        py, px = self.mesh_axes
        exchange = self._exchange_needed or not self.exchange_skip
        b = min(r * self.fuse, t)  # the wake band of a full round
        where = tuple(self._bucket(idx))
        stack = self._gather(where, r * f, exchange)
        prev = stack
        for _ in range(f):
            prev, stack = stack, native_stencil.stencil_step_padded(spec,
                                                                    stack)
        # The penultimate frame is t + 2r wide: its centre is the tile one
        # step before the last, whose diff wakes the neighbours (an
        # oscillator whose period divides f keeps its tiles awake).
        flags = _band_flags(stack != prev[:, r:r + t, r:r + t], b)
        tiles = self.board.view(py, px, self._mty, t, self._mtx, t)
        tiles.permute(0, 1, 2, 4, 3, 5).index_put_(where, stack)
        live = torch.zeros((), dtype=torch.bool, device=self.board.device)
        if self.layout in ("row", "cart"):
            live = live | (self.board[..., :b, :] != 0).any() | (
                self.board[..., -b:, :] != 0).any()
        if self.layout in ("col", "cart"):
            live = live | (self.board[..., :b] != 0).any() | (
                self.board[..., -b:] != 0).any()
        if exchange:
            self.exchange_rounds += 1
        else:
            self.exchange_skips += 1
        # The round's one host fetch: the flags and the live scalar.
        host = torch.cat([flags.reshape(-1), live.reshape(1)]).cpu().numpy()
        self._exchange_needed = bool(host[-1])
        flags = host[:-1].reshape(-1, 3, 3)
        # Wake every flagged neighbour of a tile that changed, modulo the
        # global tile grid (a tile that came back unchanged sleeps).
        k, dy, dx = np.nonzero(flags & flags[:, 1:2, 1:2])
        nxt = np.zeros((self.ty, self.tx), dtype=bool)
        nxt[(idx[k, 0] + dy - 1) % self.ty, (idx[k, 1] + dx - 1) % self.tx] = (
            True)
        self.active = nxt

    # -- the dense-crossover rung ------------------------------------------

    def _dense_round(self, f: int) -> None:
        from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib

        self.dense_steps += f
        if self._dense_run is None:
            self._dense_run, _plan = engine.make_sharded_runner(
                self.spec, self.mesh, self.layout, self.shape, fuse_steps=1)
        run = self._dense_run
        board = self.global_board()
        # The mask comes from the LAST step pair, not first-against-final:
        # an oscillator whose period divides f would look settled.
        prev = run(board, f - 1) if f > 1 else board
        new = run(prev, 1)
        t = self.tile
        changed = (new != prev).reshape(self.ty, t, self.tx, t).any(
            dim=3).any(dim=1).cpu().numpy()
        self.board = mesh_lib.shard(new, *self.mesh_axes)
        self.active = _dilate(changed)
        # Conservative: the dense round computed no boundary-live flag.
        self._exchange_needed = True
