"""Bit-packed Life on one board and on stacks: 32 cells per 32-bit word,
bitwise rule.

Counterpart of ``mpi_and_open_mp_tpu/ops/bitlife.py``. The packing is
the same bit for bit: 32 cells per word along y, and the rule is the
same carry-save adder form, ``(n0 | alive) & n1 & ~n2`` over the mod-8
neighbour count (at least 17 funnel-shift and 3-input logic
instructions per 32 cells on the card, y shifts included).

Packed layout ("offset-ghost", :func:`pack_board`): bit position ``p`` of a
packed column holds board row ``y = p - 1``; position ``0`` mirrors row
``ny-1`` and position ``ny+1`` mirrors row ``0`` (the torus ghosts, which
each step refreshes first). The "exact" layout (:func:`pack_board_exact`)
has no offset: bit ``b`` of word row ``w`` is board row ``32*w + b``.

Packed words live in ``torch.int32`` tensors. CPU PyTorch has no shifts or
``~`` for ``torch.uint32``, so the plain versions compute in int32: the
logical right shift is emulated by masking (:func:`_srl`) and ``x << 31``
wraps. The CUDA kernels read the same memory as ``uint32``.
``np.ndarray.view(np.uint32)`` turns a packed tensor into the JAX
package's words.

Two hand-written Hopper kernels carry the single-board engines on the card
(see ``csrc/``), each with a plain PyTorch version beside it:

* :func:`vmem_steps` - the whole packed board resident on the card for
  the entire step loop, spread over the column strips of one thread-block
  cluster under :func:`vmem_launch_geometry`, a column's words in
  registers (``"vmem"``), replacing ``_vmem_bits_kernel``;
* :func:`fused_steps` - ``k <= 128`` steps of a halo-extended frame (a
  128-row, 4-word y halo and, on column-tiled plans, ``hx`` wall
  columns), cut into row bands of column strips on thread-block clusters
  (2-D tiles where one cluster cannot hold the width) under
  :func:`fused_launch_geometry`, a column's words in registers, interior
  written back (``"fused"`` and ``"frame"``), replacing
  ``_fused_tiles_kernel``.

The sharded layouts (``models.life``, ``bitfused``) plan a board over a
mesh with :func:`plan_sharded_bits` and step the halo-extended shards of
one device with a third kernel, or with :func:`fused_steps` per shard:

* :func:`window_steps` - ``k <= min(32 h, hx or 128)`` steps of every
  shard's whole window (the shard plus the exchanged halo words and
  columns), each window spread over the column strips of a thread-block
  cluster under :func:`window_launch_geometry`, a column's words held in
  registers, interiors written back (``"window"``), replacing
  ``make_window_stepper``'s kernel; :func:`make_plan_stepper` and
  :func:`make_overlap_steppers` build the per-round calls.

Stacks of B boards come in two layouts, each with its kernel:

* cell-packed, ``(B, nw, nx)`` words (:func:`pack_boards`): the board
  layout above with a leading batch axis. :func:`vmem_batch_steps` runs
  each board over the column strips of a thread-block cluster of its own
  (or one block a board) under :func:`vmem_batch_launch_geometry`, every
  board resident for the whole loop (``"vmem-grid"``), replacing
  ``_vmem_bits_batch_kernel``; big boards loop through :func:`fused_steps`
  one board at a time.
* board-sliced, ``(n_planes, ny, nx)`` words (:func:`pack_batch_bits`):
  bit ``b % 32`` of plane ``b // 32`` holds board ``b``, so one word
  operation advances 32 boards and a word's neighbours are whole words.
  :func:`bitsliced_steps` spreads each plane's row bands over the column
  strips of thread-block clusters under :func:`plan_bitsliced`, a
  column's words in registers (``"bitsliced"``), replacing
  ``_bitsliced_kernel``. Ragged B zero-pads
  the high bits: an all-dead board stays dead under the rule.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.

The Hopper gates differ from the TPU's: a block has at most 227 KB of
dynamic shared memory (:data:`SMEM_BYTES`), and every kernel keeps a double
buffer of the resident words, 8 bytes per word. The port never pads x to a
lane multiple: the kernels index columns modulo the window width, so the
TPU's wrap-column patch (``nx_exact``) has no counterpart here and the
serial padded frame pads rows only. A frame sharded in x pads columns to
``W * px`` (``W = ceil(nx / px)``) with mirror columns, the column twin of
the mirror rows (``parallel.halo.packed_halo_x``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.obs import metrics
from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

# Dynamic shared memory one H100 thread block may use (227 KB), and the
# bytes each resident packed word costs in the kernels (two 4-byte
# buffers: the step reads one and writes the other).
SMEM_BYTES = 232_448
BYTES_PER_WORD = 8
# Streaming multiprocessors of an H100 SXM: the tile planner's wave size.
N_SMS = 132
# Clusters of c = 1..16 blocks the card places at once at one block a SM
# (cudaOccupancyMaxActiveClusters of 512-thread blocks, as sliced_times.py
# prints it; NVIDIA H100 80GB HBM3): a cluster's blocks share a GPC, so
# this is not 132 // c.
CLUSTERS_AT_ONCE = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)

# Halo word rows on each side of a fused tile: 4 words = 128 bit rows, so
# up to 128 steps run on one window before the junk that enters at its
# edges (one bit row per step) reaches the interior.
_FUSE_HALO_WORDS = 4
FUSE_MAX_STEPS = 32 * _FUSE_HALO_WORDS


def n_words(ny: int) -> int:
    """Packed words per column for ``ny`` rows plus the two ghost positions."""
    return (ny + 2 + 31) // 32


def fits_vmem_packed(shape: tuple[int, int]) -> bool:
    """Whether the whole packed board, double-buffered, fits one block's
    shared memory (29 056 words: 500x500 packs to 16x500 = 8000)."""
    ny, nx = shape
    return n_words(ny) * nx * BYTES_PER_WORD <= SMEM_BYTES


def _i32(v: int) -> int:
    """A 32-bit pattern as the int32 value with the same bits."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 words by ``0 < s < 32``."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _or_bits(bits: torch.Tensor, dim: int) -> torch.Tensor:
    """0/1 int32 with a 32-long axis ``dim`` -> int32 words without it,
    bit b from index b along ``dim``."""
    out = torch.zeros_like(bits.select(dim, 0))
    for b in range(32):
        out |= bits.select(dim, b) << b
    return out


def _bits_to_rows(packed: torch.Tensor) -> torch.Tensor:
    """(..., nw, nx) words -> (..., 32*nw, nx) 0/1 uint8 rows."""
    *lead, nw, nx = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    rows = (packed[..., :, None, :] >> shifts[:, None]) & 1
    return rows.reshape(*lead, nw * 32, nx).to(torch.uint8)


def pack_board(board: torch.Tensor) -> torch.Tensor:
    """(..., ny, nx) 0/1 ints -> (..., n_words(ny), nx) int32, offset-ghost
    layout (leading axes, if any, are a stack of boards).

    Ghost bits are left zero: every step refreshes them first."""
    *lead, ny, nx = board.shape
    nw = n_words(ny)
    rows = torch.zeros((*lead, nw * 32, nx), dtype=torch.int32,
                       device=board.device)
    rows[..., 1 : ny + 1, :] = board.to(torch.int32)
    return _or_bits(rows.view(*lead, nw, 32, nx), -2)


def unpack_board(packed: torch.Tensor, ny: int) -> torch.Tensor:
    """Inverse of :func:`pack_board`; returns (..., ny, nx) uint8."""
    return _bits_to_rows(packed)[..., 1 : ny + 1, :]


def pack_board_exact(board: torch.Tensor) -> torch.Tensor:
    """(..., ny, nx) 0/1 ints -> (..., ny/32, nx) int32 with no ghost
    offset: bit ``b`` of word row ``w`` holds board row ``32*w + b``
    (leading axes, if any, are a stack). Needs ``ny % 32 == 0`` (the
    torus wrap is then word-aligned)."""
    *lead, ny, nx = board.shape
    if ny % 32:
        raise ValueError(f"pack_board_exact needs ny % 32 == 0, got {ny}")
    return _or_bits(board.to(torch.int32).reshape(*lead, ny // 32, 32, nx),
                    -2)


def unpack_board_exact(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_board_exact`; returns (..., ny, nx) uint8."""
    return _bits_to_rows(packed)


def state_from_jax(
    packed: np.ndarray,
    ny: int,
    nx: int,
    layout: str = "offset-ghost",
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Carry JAX packed state across. ``packed`` is the uint32 output of the
    JAX package's ``pack_board`` (``layout="offset-ghost"``) or
    ``pack_board_exact`` (``layout="exact"``), possibly lane-padded past
    ``nx``, either 2-D or a cell-packed stack with a leading batch axis (its
    ``pack_boards``, as ``life_run_vmem_bits_batch`` packs); or the
    ``(n_planes, ny, nx)`` planes of its ``pack_batch_bits``
    (``layout="board-sliced"``). Returns the port's int32 tensor with the
    same bits and the last axis cut to ``nx``."""
    dev = resolve_device(device)
    words = np.asarray(packed)
    if words.dtype != np.uint32 or words.ndim not in (2, 3):
        raise ValueError(f"expected 2-D or 3-D uint32 words, got "
                         f"{words.dtype} {words.shape}")
    if layout == "offset-ghost":
        rows = n_words(ny)
    elif layout == "exact":
        if ny % 32:
            raise ValueError(f"exact layout needs ny % 32 == 0, got {ny}")
        rows = ny // 32
    elif layout == "board-sliced":
        if words.ndim != 3:
            raise ValueError(f"board-sliced planes are 3-D, got {words.shape}")
        rows = ny
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if words.shape[-2] != rows or words.shape[-1] < nx:
        raise ValueError(
            f"packed shape {words.shape} does not hold {layout} "
            f"({ny}, {nx}) state ({rows} word rows, >= {nx} columns)")
    own = np.ascontiguousarray(words[..., :nx]).view(np.int32)
    return torch.from_numpy(own.copy()).to(dev)


# ------------------------------------------------------ the plain packed step


def _refresh_ghosts(p: torch.Tensor, ny: int) -> torch.Tensor:
    """Rewrite the two torus ghost bits from live board state: position
    0 := position ny (board row ny-1); position ny+1 := position 1 (board
    row 0). ``p`` is ``(..., nw, nx)``; returns a new tensor."""
    p = p.clone()
    w_lo, b_lo = divmod(ny, 32)
    p[..., 0, :] = ((p[..., 0, :] & _i32(0xFFFFFFFE))
                    | ((p[..., w_lo, :] >> b_lo) & 1))
    w_hi, b_hi = divmod(ny + 1, 32)
    src = (p[..., 0, :] >> 1) & 1
    p[..., w_hi, :] = ((p[..., w_hi, :] & _i32(0xFFFFFFFF ^ (1 << b_hi)))
                       | (src << b_hi))
    return p


def _carry_save_rule(c, up, dn, roll_left, roll_right):
    """The bitwise Life rule given centre/up/down bit columns.

    Counts the 8 neighbours ``N`` (centre excluded) mod 8 - ``N == 8``
    wraps to 0 and correctly dies - with 2-bit column sums combined by
    full adders; ``alive' = (N == 3) | (alive & N == 2)`` is then
    ``(n0 | c) & n1 & ~n2``. 24 logical operations per 32 cells.
    """
    cs0 = up ^ dn
    cs1 = up & dn
    ys0 = cs0 ^ c
    ys1 = cs1 | (cs0 & c)
    l0 = roll_left(ys0)
    r0 = roll_right(ys0)
    l1 = roll_left(ys1)
    r1 = roll_right(ys1)
    p0 = l0 ^ r0
    q0 = l0 & r0
    p1x = l1 ^ r1
    p1 = p1x ^ q0
    p2 = (l1 & r1) | (p1x & q0)
    n0 = p0 ^ cs0
    rc = p0 & cs0
    n1x = p1 ^ cs1
    n1 = n1x ^ rc
    n2 = p2 ^ ((p1 & cs1) | (n1x & rc))
    return (n0 | c) & n1 & ~n2


# Left and right neighbour columns, wrapping at the last axis.
_X_ROLLS = (lambda x: torch.roll(x, 1, -1), lambda x: torch.roll(x, -1, -1))


def _window_step(w: torch.Tensor) -> torch.Tensor:
    """One packed step over a whole window, both axes wrapping at the
    window's edge: single-bit y shifts through the words (carries from
    the neighbouring word row) and column rolls. On a whole board this is
    the torus step; on a halo window the wrap feeds junk in at the edges,
    one bit row (and one column) per step, which never reaches the valid
    interior within the halo's depth. Leading axes of ``w`` are a stack."""
    dn = (w << 1) | _srl(torch.roll(w, 1, -2), 31)
    up = _srl(w, 1) | (torch.roll(w, -1, -2) << 31)
    return _carry_save_rule(w, up, dn, *_X_ROLLS)


def bit_step(p: torch.Tensor, ny: int) -> torch.Tensor:
    """One Life step on an offset-ghost packed board (ghost refresh, then
    the bitwise rule). The board is never lane-padded here, so its width
    is the torus width."""
    return _window_step(_refresh_ghosts(p, ny))


def bit_step_b(p: torch.Tensor, ny: int) -> torch.Tensor:
    """:func:`bit_step` on a ``(B, nw, nx)`` stack: every roll stays within
    a board, so boards never interact."""
    if p.dim() != 3:
        raise ValueError(f"bit_step_b: expected (B, nw, nx), got "
                         f"{tuple(p.shape)}")
    return bit_step(p, ny)


# ------------------------------------------------- kernel 1: resident board


def _check_card_words(t: torch.Tensor, name: str, ndim: int = 2) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
    if t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {ndim}-D int32 words, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _vmem_steps_plain(packed: torch.Tensor, ny: int, steps: int):
    for _ in range(int(steps)):
        packed = bit_step(packed, ny)
    return packed


def vmem_steps(packed: torch.Tensor, ny: int, steps: int,
               geometry: VmemGeometry | None = None) -> torch.Tensor:
    """Advance an offset-ghost packed board ``steps`` steps: the
    ``bitlife_vmem`` kernel on the card (the board spread over the column
    strips of one thread-block cluster, a column's words in registers, for
    the whole loop, laid out by :func:`vmem_launch_geometry` unless
    ``geometry`` is given), :func:`bit_step` looped on the CPU."""
    if packed.device.type == "cpu":
        return _vmem_steps_plain(packed, ny, steps)
    _check_card_words(packed, "vmem_steps")
    nw, nx = packed.shape
    if nw != n_words(ny) or not fits_vmem_packed((ny, nx)):
        raise ValueError(
            f"vmem_steps: packed {tuple(packed.shape)} for ny={ny} does not "
            f"fit the resident kernel (gate fits_vmem_packed)")
    geo = geometry or vmem_launch_geometry(ny, nx)
    out = torch.empty_like(packed)
    lib = _build.load("bitlife_vmem")
    with torch.cuda.device(packed.device):
        rc = lib.bitlife_vmem(
            packed.data_ptr(), out.data_ptr(), nw, nx, ny, int(steps),
            *geo.args(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "bitlife_vmem", rc)
    vmem_steps.launches += 1
    return out


vmem_steps.launches = 0


# ------------------------------------------------ kernel 2: fused halo tiles


def _tile_cost(nw, nx, tr, cx, h, hx, budget):
    """Estimated time of one fused launch in window-word steps per SM, or
    None when the tile does not fit: blocks spread evenly over the SMs,
    each block's time proportional to its window (tile plus halos)."""
    words = (tr + 2 * h) * (cx + 2 * hx)
    if words * BYTES_PER_WORD > budget:
        return None
    blocks = math.ceil(nw / tr) * math.ceil(nx / cx)
    return math.ceil(blocks / N_SMS) * words


def _fused_tile_words(nw, nx, h, budget, hx=0):
    """Best ``(cost, tr)`` for full-width row tiles (x wraps inside the
    window, or an x-sharded frame's ``hx`` exchanged columns per side), or
    None when no row tile fits."""
    best = None
    for tr in range(1, nw + 1):
        cost = _tile_cost(nw, nx, tr, nx, h, hx, budget)
        if cost is None:
            break
        if best is None or cost < best[0]:
            best = (cost, tr)
    return best


def _col_tile_plan(nw, nx, h, hx, budget):
    """Best ``(cost, tr, cx)`` for 2-D tiles carrying an ``hx``-column x
    halo (junk walks one column per step, so ``hx >= k``), or None. ``cx``
    is a multiple of 32 columns (coalesced rows)."""
    if nx < max(hx, 64):
        return None
    best = None
    max_words = budget // BYTES_PER_WORD
    for tr in range(1, nw + 1):
        cx_max = (max_words // (tr + 2 * h) - 2 * hx) // 32 * 32
        if cx_max < 32:
            break
        first = max(2, math.ceil(nx / cx_max))
        for n_tx in range(first, min(first + 32, nx // 32 + 1)):
            cx = math.ceil(nx / n_tx / 32) * 32
            cost = _tile_cost(nw, nx, tr, cx, h, hx, budget)
            if cost is not None and (best is None or cost < best[0]):
                best = (cost, tr, cx)
    return best


@dataclasses.dataclass(frozen=True)
class BitPlan:
    """How one board runs through the fused packed path over a ``(py,
    px)`` mesh: the padded frame, the halo depths and fuse budget, the
    stepper kind and the tile split of a shard. Produced by
    :func:`plan_sharded_bits`."""

    shape: tuple[int, int]   # logical (ny, nx)
    frame: tuple[int, int]   # stored (32 * nw_s * py, W * px)
    pad_y: int               # mirror rows below the board
    nw: int                  # packed word rows of the frame (nw_s * py)
    h: int                   # y halo words per side
    hx: int                  # x halo columns per side (0 = none)
    k_max: int               # fused steps per round
    tr: int                  # tile word rows (the last tile may be shorter)
    cx: int                  # tile columns (W for full-width tiles)
    py: int                  # mesh shards along y
    px: int                  # mesh shards along x
    y_sharded: bool
    x_sharded: bool
    nw_s: int                # packed word rows per shard
    W: int                   # columns per shard
    pad_x: int               # mirror columns right of the board
    mode: str                # "window" | "tiled"


@functools.lru_cache(maxsize=256)
def plan_sharded_bits(
    shape: tuple[int, int], py: int = 1, px: int = 1,
    y_sharded: bool = False, x_sharded: bool = False,
    budget: int = SMEM_BYTES,
) -> BitPlan | None:
    """Plan the fused packed path for any board over a ``(py, px)`` mesh
    of shards. Returns None when a shard is too small to carry a halo
    beside its padding, or no window or tile fits ``budget`` bytes of
    shared memory.

    * y: a shard holds ``nw_s = ceil(ny / (32 py))`` word rows; the frame's
      last ``pad_y`` rows mirror board rows ``[0, pad_y)``, so every
      window cut from it agrees with the torus. ``h = min(4, ...)`` halo
      words per side, as many as a neighbour can supply past its mirrors.
    * x, sharded: ``W = ceil(nx / px)`` columns per shard, the last
      ``pad_x`` mirroring board columns ``[0, pad_x)``, and ``hx = min(128,
      W - pad_x)`` exchanged columns per side (junk walks one column per
      step, so ``k <= hx``). Unsharded x: ``W = nx`` and the window wraps
      its own columns, exactly the torus. The port indexes columns modulo
      the window width, so it has no lane pitch and no wrap-patched rolls
      (the JAX package's ``nx_exact``).
    * ``mode="window"`` when the whole halo-extended shard window, double
      buffered, fits one block's shared memory and is at most
      :data:`WINDOW_MAX_ROWS` word rows tall (:func:`window_steps`), else
      ``"tiled"``: each shard through the fused kernel, tile split by
      :func:`_tile_cost`.

    A plan with neither axis sharded is the serial frame runner's
    (``life_run_frame_bits``): always ``"tiled"``, a full-width or 2-D
    tile split whose ``hx`` is a local wrap halo.
    """
    ny, nx = shape
    if ny < 8 or nx < 8:
        return None
    sharded = y_sharded or x_sharded
    if x_sharded:
        W = -(-nx // px)
        pad_x = W * px - nx
        hx = min(FUSE_MAX_STEPS, W - pad_x)
        if hx < 1:
            return None
    else:
        W, pad_x, hx = nx, 0, 0
    nw_s = -(-ny // (32 * py))
    pad_y = 32 * nw_s * py - ny
    # The wrap funnel reads h + 1 + pad_y // 32 words past the mirrors.
    h = min(_FUSE_HALO_WORDS,
            nw_s - 1 - pad_y // 32 if pad_y else nw_s)
    if h < 1:
        return None
    k_max = min(32 * h, hx or FUSE_MAX_STEPS)
    if (sharded and nw_s + 2 * h <= WINDOW_MAX_ROWS
            and (nw_s + 2 * h) * (W + 2 * hx) * BYTES_PER_WORD <= budget):
        mode, tr, cx = "window", nw_s, W
    else:
        mode = "tiled"
        rows = _fused_tile_words(nw_s, W, h, budget, hx)
        # 2-D tiles carry the exchanged columns, or a k_max-wide local wrap.
        cols = _col_tile_plan(nw_s, W, h, hx or k_max, budget)
        if rows is None and cols is None:
            return None
        if cols is not None and (rows is None or cols[0] < rows[0]):
            _, tr, cx = cols
            hx = hx or k_max
        else:
            _, tr = rows
            cx = W
    return BitPlan(
        shape=(ny, nx), frame=(32 * nw_s * py, W * px), pad_y=pad_y,
        nw=nw_s * py, h=h, hx=hx, k_max=k_max, tr=tr, cx=cx, py=py, px=px,
        y_sharded=y_sharded, x_sharded=x_sharded, nw_s=nw_s, W=W,
        pad_x=pad_x, mode=mode,
    )


def fused_bits_supported(shape: tuple[int, int]) -> bool:
    """Whether the aligned fused runner takes ``shape``: a word-aligned
    torus (``ny % 32 == 0``) with a full 4-word halo and a tile split."""
    plan = (plan_sharded_bits(tuple(shape)) if shape[0] % 32 == 0 else None)
    return plan is not None and plan.h == _FUSE_HALO_WORDS


def _fused_steps_plain(ext, k, plan):
    """Plain version of the fused kernel: the whole extended frame ``ext``
    stepped as one window, then cropped to the interior. The halo keeps
    the window edge's junk out of the interior, as it does per tile."""
    h, hx, nw, nx = plan.h, plan.hx, plan.nw_s, plan.W
    w = ext
    for _ in range(int(k)):
        w = _window_step(w)
    return w[h : h + nw, hx : hx + nx]


# Rows per thread that csrc/bitlife_fused.cu compiles a kernel for
# (kernel_for). Its block size and cluster caps are the window kernel's.
FUSED_ROWS_PER_THREAD = (4, 8, 12, 16, 20, 24, 32, 40, 48)


@dataclasses.dataclass(frozen=True)
class FusedGeometry:
    """How one ``bitlife_fused`` launch cuts the ``(nw + 2h, W + 2hx)``
    frame of an ``(nw, W)`` interior: ``bands`` row bands (each band's
    window its rows plus ``h`` halo words a side, ``segments *
    rows_per_thread`` rows), each band ``tiles`` tiles of ``W / tiles``
    interior columns with ``wall`` columns a side (one tile: the frame's
    whole width, ``wall == hx``), each tile ``strips`` column strips, one
    block each, with ``ghost`` columns a side refreshed from the ring
    neighbours every ``ghost`` steps when ``exchange`` (``ghost < k``; the
    tile's strips are then one cluster), else read once (ghost zones,
    ``cluster`` 1). A thread holds ``rows_per_thread`` words of a column; a
    segment's row of a strip takes ``warps`` warps, each with
    ``warp_ghost`` copied lanes a side when more than one (as
    :class:`WindowGeometry`). ``reason`` says why the chooser took it."""

    bands: int
    tiles: int
    wall: int
    strips: int
    cluster: int
    ghost: int
    rows_per_thread: int
    warp_ghost: int
    segments: int
    warps: int
    threads: int
    exchange: bool
    smem_bytes: int
    reason: str = ""

    @property
    def rows(self) -> int:
        """Word rows of every band's window."""
        return self.segments * self.rows_per_thread

    @property
    def blocks(self) -> int:
        return self.bands * self.tiles * self.strips

    def band_bounds(self, nw: int) -> list[tuple[int, int]]:
        """Each band's interior word rows ``[b0, b1)``."""
        return [(b * nw // self.bands, (b + 1) * nw // self.bands)
                for b in range(self.bands)]

    def tile_bounds(self, W: int) -> list[tuple[int, int]]:
        """Each tile's interior columns ``[t0, t1)``."""
        return [(t * W // self.tiles, (t + 1) * W // self.tiles)
                for t in range(self.tiles)]

    def strip_bounds(self, C: int) -> list[tuple[int, int]]:
        """Each strip's columns ``[c0, c1)`` of a ``C``-column tile
        window."""
        return [(r * C // self.strips, (r + 1) * C // self.strips)
                for r in range(self.strips)]

    def args(self) -> tuple[int, ...]:
        """The C entry's geometry arguments (bands, tiles, wall, strips,
        cluster, g, rt, tau)."""
        return (self.bands, self.tiles, self.wall, self.strips, self.cluster,
                self.ghost, self.rows_per_thread, self.warp_ghost)


def fused_geometry(nw: int, W: int, h: int, hx: int, k: int, bands: int,
                   tiles: int, wall: int, strips: int, ghost: int,
                   rows_per_thread: int, warp_ghost: int = 1,
                   reason: str = "") -> FusedGeometry:
    """The launch geometry of ``bands`` bands of ``tiles`` tiles (``wall``
    columns a side) of ``strips`` strips (``ghost`` columns a side),
    ``rows_per_thread`` words a thread and ``warp_ghost`` copied lanes a
    warp side, for ``k`` steps of the frame of an ``(nw, W)`` interior
    with halo ``h`` and ``hx``; derives and checks it as
    ``csrc/bitlife_fused.cu:layout`` does and raises ``ValueError`` where
    the entry would refuse it."""
    if rows_per_thread not in FUSED_ROWS_PER_THREAD:
        raise ValueError(f"fused geometry: {rows_per_thread} rows per "
                         f"thread not in {FUSED_ROWS_PER_THREAD}")
    if (not 1 <= bands <= nw or not 1 <= tiles <= W
            or not 1 <= strips <= WINDOW_MAX_CLUSTER or ghost < 1
            or not 1 <= warp_ghost <= 15):
        raise ValueError(f"fused geometry: bands={bands} outside [1, {nw}], "
                         f"tiles={tiles} outside [1, {W}], strips={strips} "
                         f"outside [1, {WINDOW_MAX_CLUSTER}], ghost={ghost} "
                         f"< 1 or warp_ghost={warp_ghost} outside [1, 15]")
    if tiles == 1 and wall != hx:
        raise ValueError(f"fused geometry: one tile takes the frame's wall "
                         f"hx={hx}, got wall={wall}")
    if tiles > 1 and wall < k:
        raise ValueError(f"fused geometry: 2-D tiles need a wall of at "
                         f"least k={k} columns, got {wall}")
    cmin, cmax = W // tiles + 2 * wall, -(-W // tiles) + 2 * wall
    if strips > cmin:
        raise ValueError(f"fused geometry: {strips} strips over a tile "
                         f"window of {cmin} columns")
    exchange = ghost < k
    if exchange and ghost % warp_ghost:
        raise ValueError(f"fused geometry: exchanged ghost {ghost} not a "
                         f"multiple of warp_ghost {warp_ghost}")
    if exchange and cmin // strips < ghost:
        raise ValueError(f"fused geometry: exchanged ghost {ghost} wider "
                         f"than the narrowest strip {cmin // strips}")
    segments = -(-(-(-nw // bands) + 2 * h) // rows_per_thread)
    lmax = -(-cmax // strips) + 2 * ghost
    warps = 1 if lmax <= 32 else -(-lmax // (32 - 2 * warp_ghost))
    threads = segments * 32 * warps
    if threads > WINDOW_MAX_THREADS:
        raise ValueError(f"fused geometry: {threads} threads a block, "
                         f"above {WINDOW_MAX_THREADS}")
    words = ((2 * segments * 32 * warps * 2 if segments > 1 else 0)
             + (2 * 2 * segments * warps * warp_ghost * rows_per_thread
                if warps > 1 else 0)
             + (2 * 2 * ghost * segments * rows_per_thread if exchange
                else 0))
    if 4 * words > SMEM_BYTES:
        raise ValueError(f"fused geometry: {4 * words} bytes of shared "
                         "memory")
    return FusedGeometry(bands, tiles, wall, strips,
                         strips if exchange else 1, ghost, rows_per_thread,
                         warp_ghost, segments, warps, threads, exchange,
                         4 * words, reason)


def fused_stepped_words(nw: int, W: int, geo: FusedGeometry) -> int:
    """The words a launch steps each step: every block's window rows times
    its local columns (its strip plus the ghosts), over the useful ``nw *
    W`` the ratio of redundant work."""
    cols = sum(c1 - c0 + 2 * geo.ghost
               for t0, t1 in geo.tile_bounds(W)
               for c0, c1 in geo.strip_bounds(t1 - t0 + 2 * geo.wall))
    return geo.bands * geo.rows * cols


def fused_waves(geo: FusedGeometry) -> int:
    """Waves of a launch at one block an SM: its clusters over those the
    card places at once (:data:`CLUSTERS_AT_ONCE`)."""
    clusters = geo.blocks // geo.cluster
    return -(-clusters // CLUSTERS_AT_ONCE[geo.cluster - 1])


def _fused_features(k: int, geo: FusedGeometry) -> list[float]:
    """The terms of :func:`_fused_time_model_us`: a launch, then per wave
    each step's floor, its warp-words on an SM (the issue rate), its rows
    a thread (the dependent chain), the block barrier that segments trade
    through, the strip refreshes and the warp refreshes."""
    waves = fused_waves(geo)
    refreshes = (k - 1) // geo.ghost if geo.exchange else 0
    warp_refreshes = (k - 1) // geo.warp_ghost if geo.warps > 1 else 0
    return [1.0, waves * k,
            waves * k * geo.segments * geo.warps * geo.rows_per_thread,
            waves * k * geo.rows_per_thread,
            waves * k if geo.segments > 1 else 0.0,
            waves * refreshes, waves * warp_refreshes]


# The launch-time model fused_launch_geometry minimises, in microseconds, a
# coefficient per term of _fused_features, fitted by least squares of the
# relative error to fused_times.py --sweep (160 geometries at the four
# frames of chip_smoke.py:fused_shapes, median error 5 %) on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md §6). The launch term is a fit's, not
# a launch's cost; the negative step floor offsets the rows-a-thread term.
_FUSED_US = (48.03, -0.3101, 0.005530, 0.02111, 0.1076, 0.6620, 0.2621)


def _fused_time_model_us(k: int, geo: FusedGeometry) -> float:
    return sum(c * f for c, f in zip(_FUSED_US, _fused_features(k, geo)))


def fused_candidates(nw: int, W: int, h: int, hx: int, k: int
                     ) -> list[FusedGeometry]:
    """Every geometry :func:`fused_launch_geometry` weighs for ``k`` steps
    of an ``(nw, W)`` interior's frame, in the order it weighs them: for
    each compiled rows-per-thread and each count of segments, the bands
    whose windows that fills; 16 down to 1 strips; ghosts of 32, 16, 8 and
    4 columns refreshed through the ring, or ``k`` (ghost zones); 1, 2 and
    4 copied lanes a warp side; one tile where a cluster holds the frame's
    width, else the fewest 2-D tiles of ``wall = k`` that it holds."""
    out = []
    E = W + 2 * hx
    for rt in FUSED_ROWS_PER_THREAD:
        seen = set()
        for P in range(1, WINDOW_MAX_THREADS // 32 + 1):
            band_rows = P * rt - 2 * h
            if band_rows < 1:
                continue
            bands = min(nw, -(-nw // band_rows))
            if bands in seen:
                continue
            seen.add(bands)
            nq_max = WINDOW_MAX_THREADS // (32 * P)
            for strips in range(WINDOW_MAX_CLUSTER, 0, -1):
                for ghost in sorted({32, 16, 8, 4, max(k, 1)}, reverse=True):
                    for tau in (1, 2, 4):
                        if ghost < k and ghost % tau:
                            continue
                        # The widest tile window a cluster of this strip
                        # count holds (each strip nq_max warps).
                        lmax = max(32, nq_max * (32 - 2 * tau))
                        cap = strips * (lmax - 2 * ghost)
                        if cap < strips:
                            continue
                        if E <= cap:
                            tiles, wall = 1, hx
                        elif cap > 2 * k:
                            tiles, wall = -(-W // (cap - 2 * k)), k
                        else:
                            continue
                        if tiles > W:
                            continue
                        try:
                            out.append(fused_geometry(
                                nw, W, h, hx, k, bands, tiles, wall, strips,
                                ghost, rt, tau))
                        except ValueError:
                            pass
    return out


@functools.lru_cache(maxsize=256)
def fused_launch_geometry(nw: int, W: int, h: int, hx: int, k: int
                          ) -> FusedGeometry:
    """The geometry :func:`fused_steps` launches ``k`` steps of the frame
    of an ``(nw, W)`` interior (halo ``h`` words and ``hx`` columns a side)
    with: a plain function of the shapes (cached), so that the same frame
    always gets the same launch. Of :func:`fused_candidates`, the one of
    least :func:`_fused_time_model_us` (the first on a tie). Raises
    ``ValueError`` where none is legal."""
    best = None
    for geo in fused_candidates(nw, W, h, hx, k):
        t = _fused_time_model_us(k, geo)
        if best is None or t < best[0]:
            best = (t, geo)
    if best is None:
        raise ValueError(f"fused_launch_geometry: no geometry for an "
                         f"({nw}, {W}) interior, h={h}, hx={hx}, k={k}")
    t, geo = best
    return dataclasses.replace(
        geo, reason=(f"{geo.bands} bands x {geo.tiles} tiles x "
                     f"{geo.strips} strips, "
                     + (f"refresh every {geo.ghost} steps"
                        if geo.exchange else "ghost zones")
                     + f", {fused_waves(geo)} waves, model {t:.1f} us"))


def fused_steps(ext: torch.Tensor, k: int, plan: BitPlan,
                geometry: FusedGeometry | None = None) -> torch.Tensor:
    """``k <= plan.k_max`` fused steps over the halo-extended packed frame
    (or one shard of it) ``ext`` of shape ``(nw_s + 2h, W + 2hx)``;
    returns the ``(nw_s, W)`` interior. The ``bitlife_fused`` kernel on
    the card (row bands of column strips on thread-block clusters, a
    column's words in registers, laid out by :func:`fused_launch_geometry`
    unless ``geometry`` is given), the plain version on the CPU."""
    nw, nx = plan.nw_s, plan.W
    if tuple(ext.shape) != (nw + 2 * plan.h, nx + 2 * plan.hx):
        raise ValueError(f"fused_steps: ext {tuple(ext.shape)} does not "
                         f"match the plan's extended frame")
    if not 0 <= k <= plan.k_max:
        raise ValueError(f"fused_steps: k={k} outside [0, {plan.k_max}]")
    if ext.device.type == "cpu":
        return _fused_steps_plain(ext, k, plan)
    _check_card_words(ext, "fused_steps")
    out = torch.empty((nw, nx), dtype=torch.int32, device=ext.device)
    geo = geometry or fused_launch_geometry(nw, nx, plan.h, plan.hx, int(k))
    lib = _build.load("bitlife_fused")
    with torch.cuda.device(ext.device):
        rc = lib.bitlife_fused(
            ext.data_ptr(), out.data_ptr(), nw, nx, plan.h, plan.hx, int(k),
            *geo.args(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "bitlife_fused", rc)
    fused_steps.launches += 1
    return out


fused_steps.launches = 0


def fused_attributes(plan: BitPlan, k: int,
                     geometry: FusedGeometry) -> dict[str, int]:
    """What the CUDA runtime reports for the ``bitlife_fused`` launch of
    this geometry over the plan's frame (``bitlife_fused_attributes``):
    registers and local (spilled) bytes a thread, static and dynamic
    shared bytes and threads a block, and the clusters the card can hold
    at once. Needs the card."""
    lib = _build.load("bitlife_fused")
    vals = (ctypes.c_int * 6)()
    rc = lib.bitlife_fused_attributes(plan.nw_s, plan.W, plan.h, plan.hx,
                                      int(k), *geometry.args(), vals)
    _build.check(lib, "bitlife_fused", rc)
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes", "max_active_clusters", "threads"),
                    vals))


# ------------------------------------------ kernel 3: resident shard windows


def window_max_steps(h: int, hx: int) -> int:
    """Steps a halo window of ``h`` words and ``hx`` columns per side
    takes before the junk that enters at its edges (one bit row and one
    column per step) reaches the interior: ``min(32 h, hx or 128)``; with
    ``hx == 0`` the window's own columns are the torus."""
    return min(32 * h, hx or FUSE_MAX_STEPS)


def _window_steps_plain(ext: torch.Tensor, k: int, h: int, hx: int):
    """Plain version of the window kernel: :func:`_window_step` ``k`` times
    over each whole window of the stack, then the interior."""
    w = ext
    for _ in range(int(k)):
        w = _window_step(w)
    R, C = ext.shape[-2:]
    return w[..., h : R - h, hx : C - hx]


# Rows per thread that csrc/bitlife_window.cu compiles a kernel for
# (kernel_for), its block-size cap, and the largest cluster it takes (above
# 8 with cudaFuncAttributeNonPortableClusterSizeAllowed).
WINDOW_ROWS_PER_THREAD = (4, 6, 8, 10, 12, 16, 20, 24, 32)
WINDOW_MAX_THREADS = 512
WINDOW_MAX_CLUSTER = 16


@dataclasses.dataclass(frozen=True)
class WindowGeometry:
    """How one ``bitlife_window`` launch spreads a stack of ``(R, C)``
    windows: each window over ``strips`` blocks, a column strip each (widths
    ``floor`` or ``ceil`` of ``C / strips``), with ``ghost`` columns per
    side; ghosts come from the neighbouring strips every ``ghost`` steps
    through distributed shared memory when ``exchange`` (``ghost < k``; the
    window's strips are then one cluster), else once from device memory
    (overlapping ghost-zone strips, ``cluster`` 1). A thread holds
    ``rows_per_thread`` words of a column (``segments`` threads a column);
    a row of a strip takes ``warps`` warps. When more than one, a warp owns
    ``32 - 2 warp_ghost`` columns and its ``warp_ghost`` lanes on each side
    copy the neighbouring warps' columns, refreshed every ``warp_ghost``
    steps, so the warps of one segment run that long without a barrier.
    ``reason`` says why the chooser took it."""

    strips: int
    cluster: int
    ghost: int
    rows_per_thread: int
    warp_ghost: int
    segments: int
    warps: int
    threads: int
    exchange: bool
    smem_bytes: int
    reason: str = ""

    def strip_bounds(self, C: int) -> list[tuple[int, int]]:
        """Each strip's columns ``[c0, c1)`` of a ``C``-column window."""
        return [(r * C // self.strips, (r + 1) * C // self.strips)
                for r in range(self.strips)]

    def args(self) -> tuple[int, int, int, int, int]:
        """The C entry's geometry arguments (strips, cluster, g, rt, tau)."""
        return (self.strips, self.cluster, self.ghost, self.rows_per_thread,
                self.warp_ghost)


def window_geometry(R: int, C: int, k: int, strips: int, ghost: int,
                    rows_per_thread: int, warp_ghost: int = 1,
                    reason: str = "") -> WindowGeometry:
    """The launch geometry of ``strips`` strips with ``ghost`` columns per
    side, ``rows_per_thread`` words a thread and ``warp_ghost`` copied
    lanes per warp side, for ``k`` steps over ``(R, C)`` windows; derives
    and checks it as ``csrc/bitlife_window.cu:layout`` does and raises
    ``ValueError`` where the entry would refuse it."""
    if rows_per_thread not in WINDOW_ROWS_PER_THREAD:
        raise ValueError(f"window geometry: {rows_per_thread} rows per "
                         f"thread not in {WINDOW_ROWS_PER_THREAD}")
    if not 1 <= strips <= C or ghost < 1 or not 1 <= warp_ghost <= 15:
        raise ValueError(f"window geometry: strips={strips} outside [1, "
                         f"{C}], ghost={ghost} < 1 or warp_ghost="
                         f"{warp_ghost} outside [1, 15]")
    exchange = ghost < k
    if exchange and ghost % warp_ghost:
        raise ValueError(f"window geometry: exchanged ghost {ghost} not a "
                         f"multiple of warp_ghost {warp_ghost}")
    cluster = strips if exchange else 1
    if exchange and C // strips < ghost:
        raise ValueError(f"window geometry: exchanged ghost {ghost} wider "
                         f"than the narrowest strip {C // strips}")
    if cluster > WINDOW_MAX_CLUSTER:
        raise ValueError(f"window geometry: cluster {cluster} above "
                         f"{WINDOW_MAX_CLUSTER}")
    segments = -(-R // rows_per_thread)
    lmax = -(-C // strips) + 2 * ghost
    warps = 1 if lmax <= 32 else -(-lmax // (32 - 2 * warp_ghost))
    threads = segments * 32 * warps
    if threads > WINDOW_MAX_THREADS:
        raise ValueError(f"window geometry: {threads} threads a block, "
                         f"above {WINDOW_MAX_THREADS}")
    words = ((2 * segments * 32 * warps * 2 if segments > 1 else 0)
             + (2 * 2 * segments * warps * warp_ghost * rows_per_thread
                if warps > 1 else 0)
             + (2 * 2 * ghost * segments * rows_per_thread if exchange
                else 0))
    if 4 * words > SMEM_BYTES:
        raise ValueError(f"window geometry: {4 * words} bytes of shared "
                         "memory")
    return WindowGeometry(strips, cluster, ghost, rows_per_thread,
                          warp_ghost, segments, warps, threads, exchange,
                          4 * words, reason)


# Windows taller than this many word rows have no geometry (and
# plan_sharded_bits tiles them): a block holds at most 512 threads, so a
# column splits into at most 16 segments of at most 32 words.
WINDOW_MAX_ROWS = 16 * max(WINDOW_ROWS_PER_THREAD)


def _rows_per_thread(R: int, words: int) -> int:
    """The compiled rows-per-thread that splits ``R`` rows into segments of
    about ``words`` words (at least one segment of at most 32)."""
    P = max(-(-R // max(WINDOW_ROWS_PER_THREAD)), -(-R // words))
    return min(r for r in WINDOW_ROWS_PER_THREAD if r * P >= R)


# The launch-time model window_launch_geometry minimises, in microseconds,
# fitted to window_times.py --sweep on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §6): a launch's fixed cost, a step's cost (a floor, plus the
# warps that share an SM), and a strip refresh through the cluster.
_WINDOW_US_LAUNCH = 2.0
_WINDOW_US_STEP = 0.19
_WINDOW_US_STEP_PER_WARP = 0.026
_WINDOW_US_REFRESH = 1.2


def _window_time_model_us(shards: int, k: int, geo: WindowGeometry) -> float:
    """The modelled device time of a ``bitlife_window`` launch (see the
    constants above); blocks beyond one per SM share SMs."""
    per_sm = -(-shards * geo.strips // N_SMS)
    warps = geo.threads // 32 * per_sm
    refreshes = (k - 1) // geo.ghost if geo.exchange else 0
    return (_WINDOW_US_LAUNCH
            + k * (_WINDOW_US_STEP + _WINDOW_US_STEP_PER_WARP * warps)
            + refreshes * _WINDOW_US_REFRESH)


@functools.lru_cache(maxsize=256)
def window_launch_geometry(shards: int, R: int, C: int, k: int
                           ) -> WindowGeometry:
    """The geometry :func:`window_steps` launches ``k`` steps of ``shards``
    ``(R, C)`` windows with: a plain function of the shapes, so that the
    same inputs always give the same launch (cached: the sharded runners
    ask once a round). About 4 words a thread (more threads a column hide
    more latency); then, of ghost-zone strips (16 a window, ``ghost = k``,
    cluster 1; only for ``k <= 32``, where a strip of ghosts is cheap) and
    clusters of 8 or 16 strips exchanging every 4, 8 or 16 steps with 1, 2
    or 4 copied lanes a warp side, the legal one of least
    :func:`_window_time_model_us` (the first on a tie).

    A window where none of those is legal takes the first legal one of
    more strips, more words a thread and shallower ghosts; one taller than
    :data:`WINDOW_MAX_ROWS` raises ``ValueError``."""
    if R > WINDOW_MAX_ROWS:
        raise ValueError(f"window_launch_geometry: {R} word rows, above "
                         f"{WINDOW_MAX_ROWS}")
    rt = _rows_per_thread(R, 4)
    best = None
    tries = []
    if k <= 32:
        tries.append((min(16, max(1, C // 16)), max(k, 1), "ghost zones"))
    tries += [(n, g, f"cluster of {n}, refresh every {g} steps")
              for n in (8, 16) for g in (16, 8, 4) if g < k]
    for strips, ghost, why in tries:
        for tau in (4, 2, 1):
            try:
                geo = window_geometry(R, C, k, strips, ghost, rt, tau, why)
            except ValueError:
                continue
            t = _window_time_model_us(shards, k, geo)
            if best is None or t < best[0]:
                best = (t, geo)
    if best is not None:
        return dataclasses.replace(
            best[1], reason=f"{best[1].reason}, model {best[0]:.1f} us")
    # Shapes the choices above do not fit (narrow, tall or very wide
    # windows): ghost zones over more strips, then clusters refreshing
    # every step, with more words a thread.
    for words in (4, 8, 16, 32):
        r = _rows_per_thread(R, words)
        tries = [(min(n, C), max(k, 1), "ghost zones (fallback)")
                 for n in (16, 64, 256, 1024)]
        tries += [(min(n, C), 1, "cluster, refresh every step (fallback)")
                  for n in (16, 8, 4, 2, 1)]
        for strips, ghost, why in tries:
            try:
                return window_geometry(R, C, k, strips, ghost, r, 1, why)
            except ValueError:
                pass
    raise ValueError(f"window_launch_geometry: no geometry for {shards} "
                     f"windows of {R} x {C}, k={k}")


def window_steps(ext: torch.Tensor, k: int, h: int, hx: int = 0,
                 geometry: WindowGeometry | None = None) -> torch.Tensor:
    """``k`` fused packed steps of every halo-extended shard window in the
    stack ``ext`` of shape ``(*S, nw + 2h, W + 2hx)``; returns the ``(*S,
    nw, W)`` interiors. The ``bitlife_window`` kernel on the card (each
    window over the column strips of a thread-block cluster, laid out by
    :func:`window_launch_geometry` unless ``geometry`` is given), the plain
    version on the CPU. ``k`` is at most :func:`window_max_steps`."""
    R, C = ext.shape[-2:]
    if R <= 2 * h or C <= 2 * hx or h < 1 or hx < 0:
        raise ValueError(f"window_steps: window {tuple(ext.shape)} with "
                         f"halo h={h}, hx={hx} has no interior")
    if not 0 <= k <= window_max_steps(h, hx):
        raise ValueError(
            f"window_steps: k={k} outside [0, {window_max_steps(h, hx)}] "
            f"for halo h={h}, hx={hx}")
    if ext.device.type == "cpu":
        return _window_steps_plain(ext, k, h, hx)
    if ext.device.type != "cuda":
        raise ValueError(f"window_steps: expected a CUDA or CPU tensor, got "
                         f"{ext.device}")
    _check_card_words(ext, "window_steps", ndim=ext.dim())
    lead = ext.shape[:-2]
    out = torch.empty((*lead, R - 2 * h, C - 2 * hx), dtype=torch.int32,
                      device=ext.device)
    s = out[..., 0, 0].numel()
    if s == 0:
        return out
    geo = geometry or window_launch_geometry(s, R, C, int(k))
    lib = _build.load("bitlife_window")
    with torch.cuda.device(ext.device):
        rc = lib.bitlife_window(
            ext.data_ptr(), out.data_ptr(), s, R - 2 * h, C - 2 * hx, h, hx,
            int(k), *geo.args(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "bitlife_window", rc)
    window_steps.launches += 1
    return out


window_steps.launches = 0


def window_attributes(shards: int, R: int, C: int, h: int, hx: int, k: int,
                      geometry: WindowGeometry) -> dict[str, int]:
    """What the CUDA runtime reports for the ``bitlife_window`` launch of
    this geometry (``bitlife_window_attributes``): registers and local
    (spilled) bytes a thread, static and dynamic shared bytes and threads a
    block, and the clusters the card can hold at once. Needs the card."""
    lib = _build.load("bitlife_window")
    vals = (ctypes.c_int * 6)()
    rc = lib.bitlife_window_attributes(shards, R - 2 * h, C - 2 * hx, h, hx,
                                       int(k), *geometry.args(), vals)
    _build.check(lib, "bitlife_window", rc)
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes", "max_active_clusters", "threads"),
                    vals))


# ------------------------------ kernel 1's geometry: one cluster per board


@dataclasses.dataclass(frozen=True)
class VmemGeometry:
    """How one ``bitlife_vmem`` launch spreads an ``(nw, nx)`` packed
    board: over ``strips`` column strips (widths ``floor`` or ``ceil`` of
    ``nx / strips``), one block each, all one cluster (``cluster ==
    strips``) that forms a ring over the torus, with ``ghost`` columns per
    side refreshed from the neighbouring strips every ``ghost`` steps. A
    thread holds ``rows_per_thread`` words of a column (``segments``
    threads a column); a row of a strip takes ``warps`` warps, each with
    ``warp_ghost`` copied lanes per side when more than one (as
    :class:`WindowGeometry`). ``rows_per_thread == 0`` is the one-block
    geometry: one block of 1024 threads with the whole board
    double-buffered in shared memory (``strips == cluster == 1``, ``ghost
    == warp_ghost == 0``). ``reason`` says why the chooser took it."""

    strips: int
    cluster: int
    ghost: int
    rows_per_thread: int
    warp_ghost: int
    segments: int
    warps: int
    threads: int
    smem_bytes: int
    reason: str = ""

    @property
    def one_block(self) -> bool:
        return self.rows_per_thread == 0

    def strip_bounds(self, C: int) -> list[tuple[int, int]]:
        """Each strip's columns ``[c0, c1)`` of a ``C``-column board."""
        return [(r * C // self.strips, (r + 1) * C // self.strips)
                for r in range(self.strips)]

    def args(self) -> tuple[int, int, int, int, int]:
        """The C entry's geometry arguments (strips, cluster, g, rt, tau)."""
        return (self.strips, self.cluster, self.ghost, self.rows_per_thread,
                self.warp_ghost)


VMEM_ONE_BLOCK_THREADS = 1024


def vmem_geometry(ny: int, nx: int, strips: int, ghost: int,
                  rows_per_thread: int, warp_ghost: int = 1,
                  reason: str = "") -> VmemGeometry:
    """The launch geometry of ``strips`` strips with ``ghost`` columns per
    side, ``rows_per_thread`` words a thread and ``warp_ghost`` copied
    lanes per warp side for an ``(ny, nx)`` board (``rows_per_thread ==
    0``: the one-block geometry, with ``strips == 1`` and ``ghost ==
    warp_ghost == 0``); derives and checks it as
    ``csrc/bitlife_vmem.cu:layout`` does and raises ``ValueError`` where
    the entry would refuse it. The strips' checks are
    :func:`window_geometry`'s for a window that exchanges its ghosts."""
    nw = n_words(ny)
    if rows_per_thread == 0:
        if (strips, ghost, warp_ghost) != (1, 0, 0):
            raise ValueError(f"vmem geometry: the one-block geometry takes "
                             f"strips=1, ghost=0, warp_ghost=0, got "
                             f"{strips}, {ghost}, {warp_ghost}")
        smem = BYTES_PER_WORD * nw * nx
        if smem > SMEM_BYTES:
            raise ValueError(f"vmem geometry: {smem} bytes of shared memory")
        return VmemGeometry(1, 1, 0, 0, 0, 1, VMEM_ONE_BLOCK_THREADS // 32,
                            VMEM_ONE_BLOCK_THREADS, smem, reason)
    try:
        w = window_geometry(nw, nx, ghost + 1, strips, ghost,
                            rows_per_thread, warp_ghost, reason)
    except ValueError as e:
        raise ValueError(str(e).replace("window geometry",
                                        "vmem geometry")) from None
    # Beside the window kernel's arrays: the word holding position ny,
    # published every step (two buffers x 32 columns a warp).
    smem = w.smem_bytes + (4 * 2 * 32 * w.warps if w.segments > 1 else 0)
    if smem > SMEM_BYTES:
        raise ValueError(f"vmem geometry: {smem} bytes of shared memory")
    return VmemGeometry(w.strips, w.cluster, w.ghost, w.rows_per_thread,
                        w.warp_ghost, w.segments, w.warps, w.threads, smem,
                        reason)


# The per-step model vmem_launch_geometry minimises, in microseconds: a
# step's floor, its cost per warp of a segment's row and per word a
# thread, the block barrier that segments trade through, a strip refresh
# (every ghost steps) and a warp refresh (every warp_ghost steps);
# fitted by least squares to the 2034 geometries of vmem_times.py --sweep
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6; rms 0.092 us).
_VMEM_US_STEP = 0.0276
_VMEM_US_PER_WARP = 0.0517
_VMEM_US_PER_WORD = 0.0305
_VMEM_US_SEGMENTS = 0.2116
_VMEM_US_REFRESH = 0.7479
_VMEM_US_WARP_REFRESH = 0.1007


def _vmem_step_model_us(nw: int, geo: VmemGeometry) -> float:
    """The modelled device time of one step of a ``bitlife_vmem`` launch
    (see the constants above)."""
    rows = -(-nw // geo.segments)
    return (_VMEM_US_STEP + _VMEM_US_PER_WARP * geo.warps
            + _VMEM_US_PER_WORD * rows
            + (_VMEM_US_SEGMENTS if geo.segments > 1 else 0.0)
            + _VMEM_US_REFRESH / geo.ghost
            + (_VMEM_US_WARP_REFRESH / geo.warp_ghost if geo.warps > 1
               else 0.0))


def vmem_candidates(ny: int, nx: int) -> list[VmemGeometry]:
    """Every cluster geometry :func:`vmem_launch_geometry` weighs for an
    ``(ny, nx)`` board, in the order it weighs them: each compiled
    rows-per-thread that splits a column into a different number of
    segments, 16 down to 1 strips, ghosts of 16, 8, 4, 2 and 1 columns, 4,
    2 and 1 copied lanes a warp side; the illegal ones left out."""
    nw = n_words(ny)
    rts = sorted({min(r for r in WINDOW_ROWS_PER_THREAD if r * P >= nw)
                  for P in range(1, WINDOW_MAX_THREADS // 32 + 1)
                  if max(WINDOW_ROWS_PER_THREAD) * P >= nw})
    out = []
    for rt in rts:
        for strips in range(min(WINDOW_MAX_CLUSTER, nx), 0, -1):
            for ghost in (16, 8, 4, 2, 1):
                for tau in (4, 2, 1):
                    if ghost > nx // strips or ghost % tau:
                        continue
                    try:
                        out.append(vmem_geometry(ny, nx, strips, ghost, rt,
                                                 tau))
                    except ValueError:
                        pass
    return out


@functools.lru_cache(maxsize=256)
def vmem_launch_geometry(ny: int, nx: int) -> VmemGeometry:
    """The geometry :func:`vmem_steps` launches an ``(ny, nx)`` board with:
    a plain function of the shape (cached), so that the same board always
    gets the same launch. Of :func:`vmem_candidates`, the one of least
    :func:`_vmem_step_model_us` (the first on a tie). A board with no
    cluster geometry (more than :data:`WINDOW_MAX_ROWS` word rows, or so
    wide that 16 strips of 16 warps do not hold it) takes the one-block
    geometry. Raises ``ValueError`` for a board the gate
    :func:`fits_vmem_packed` refuses."""
    if ny < 0 or nx < 1 or not fits_vmem_packed((ny, nx)):
        raise ValueError(f"vmem_launch_geometry: ({ny}, {nx}) does not fit "
                         "the resident kernel (gate fits_vmem_packed)")
    nw = n_words(ny)
    best = None
    for geo in vmem_candidates(ny, nx):
        t = _vmem_step_model_us(nw, geo)
        if best is None or t < best[0]:
            best = (t, geo)
    if best is None:
        return vmem_geometry(
            ny, nx, 1, 0, 0, 0,
            f"one block: no cluster geometry holds {nw} word rows x {nx} "
            "columns")
    t, geo = best
    return dataclasses.replace(
        geo, reason=(f"cluster of {geo.strips}, refresh every {geo.ghost} "
                     f"steps, model {t:.3f} us a step"))


def vmem_attributes(ny: int, nx: int,
                    geometry: VmemGeometry) -> dict[str, int]:
    """What the CUDA runtime reports for the ``bitlife_vmem`` launch of
    this geometry (``bitlife_vmem_attributes``): registers and local
    (spilled) bytes a thread, static and dynamic shared bytes and threads a
    block, and the clusters the card can hold at once. Needs the card."""
    lib = _build.load("bitlife_vmem")
    vals = (ctypes.c_int * 6)()
    rc = lib.bitlife_vmem_attributes(n_words(ny), nx, ny, *geometry.args(),
                                     vals)
    _build.check(lib, "bitlife_vmem", rc)
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes", "max_active_clusters", "threads"),
                    vals))


# ----------------------------------------------- frame helpers (host side)


def wrap_y(p: torch.Tensor, h: int = _FUSE_HALO_WORDS) -> torch.Tensor:
    """Extend a packed board (word rows on the second-to-last axis) with
    ``h`` torus-wrap word rows per side."""
    return torch.cat([p[..., -h:, :], p, p[..., :h, :]], dim=-2)


def take_rows(words: torch.Tensor, start: int, h: int) -> torch.Tensor:
    """Bit rows ``[start, start + 32*h)`` of packed words (word rows on the
    second-to-last axis; leading axes are a stack): a plain slice when
    word-aligned, else each word funnelled from two."""
    q, b = divmod(start, 32)
    if b == 0:
        return words[..., q : q + h, :]
    return (_srl(words[..., q : q + h, :], b)
            | (words[..., q + 1 : q + h + 1, :] << (32 - b)))


def mirror_tail(e: torch.Tensor, src: torch.Tensor, pad: int) -> torch.Tensor:
    """Rewrite the last ``pad`` bit rows of frame ``e`` with rows
    ``[0, pad)`` of ``src`` (which carries at least ``pad + 32`` rows from
    board row 0): the periodic-mirror refresh."""
    nw = e.shape[-2]
    q, b = divmod(pad, 32)
    parts = [e[..., : nw - q - (1 if b else 0), :]]
    if b:
        keep = (1 << (32 - b)) - 1
        parts.append((e[..., nw - 1 - q : nw - q, :] & keep)
                     | (src[..., :1, :] << (32 - b)))
    if q:
        parts.append(take_rows(src, b, q))
    return torch.cat(parts, dim=-2) if len(parts) > 1 else parts[0]


def wrap_y_padded(e: torch.Tensor, ny: int, h: int) -> torch.Tensor:
    """Local y-extension of a packed frame taller than the board: refresh
    the mirror rows, then add funnel-shifted torus borders (board rows
    ``[ny - 32h, ny)`` above, ``[pad, pad + 32h)`` below). Needs
    ``h + 1 + pad//32 <= nw``."""
    nw = e.shape[-2]
    pad = 32 * nw - ny
    if pad == 0:
        return wrap_y(e, h)
    s = h + 1 + pad // 32
    top = take_rows(e[..., -s:, :], 32 * s - pad - 32 * h, h)
    bot = take_rows(e[..., :s, :], pad, h)
    e = mirror_tail(e, e[..., :s, :], pad)
    return torch.cat([top, e, bot], dim=-2)


def local_wrap_y(plan: BitPlan, q: torch.Tensor) -> torch.Tensor:
    """The plan's torus extension in y: funnel wrap and mirror refresh on
    a padded frame, plain word-row wrap on an exact one."""
    if plan.pad_y:
        return wrap_y_padded(q, plan.shape[0], plan.h)
    return wrap_y(q, plan.h)


def make_plan_stepper(plan: BitPlan):
    """``step_call(k, ext) -> (py, px, nw_s, W)`` for a :class:`BitPlan`
    over stacked extended shards ``ext`` of shape ``(py, px, nw_s + 2h, W +
    2hx)``: one :func:`window_steps` launch for every shard in
    ``"window"`` mode, else :func:`fused_steps` once per shard (each
    shard's tiles spread over the card already)."""
    if plan.mode == "window":
        return lambda k, ext: window_steps(ext, k, plan.h, plan.hx)

    def tiled(k, ext):
        py, px = ext.shape[:2]
        return torch.stack([
            torch.stack([fused_steps(ext[i, j], k, plan) for j in range(px)])
            for i in range(py)])

    return tiled


def plan_overlap_supported(plan: BitPlan) -> bool:
    """Whether the plan admits the interior/edge overlap split
    (``parallel.haloplan``): window-mode row shards of an exact word frame
    (``pad_y == 0``; padded frames exchange funnel-shifted ranges and
    refresh mirrors, and an x-sharded plan's y ghosts ride after the x
    exchange for the corners), with a non-empty interior (``nw_s > 2h``)."""
    return (plan.mode == "window" and plan.y_sharded
            and not plan.x_sharded and plan.pad_y == 0
            and plan.nw_s > 2 * plan.h)


def make_overlap_steppers(plan: BitPlan):
    """``(interior_call, edge_call)`` for the overlapped packed round; gate
    on :func:`plan_overlap_supported`.

    * ``interior_call(k, q) -> (..., nw_s - 2h, W)``: the raw shard is its
      own window, its outer ``h`` words playing the halo, so word rows
      ``[h, nw_s - h)`` come from local words alone, while the ghosts move.
    * ``edge_call(k, ext3h) -> (..., h, W)``: a ``3h``-word extension
      (``cat([ghost, q[:2h]])`` or ``cat([q[-2h:], ghost])``) gives an
      edge once its ghost is there.

    Both are :func:`window_steps` launches over the stack. The junk that
    enters a window's edge walks one bit row a step, and every output row
    sits ``32h >= k`` rows from the nearest edge in all three windows, so
    ``cat([edge, interior, edge])`` equals the sequential round bit for
    bit."""
    if not plan_overlap_supported(plan):
        raise ValueError(f"plan admits no overlap split: {plan}")
    h = plan.h
    return (lambda k, q: window_steps(q, k, h, 0),
            lambda k, ext3h: window_steps(ext3h, k, h, 0))


def _run_plan(q: torch.Tensor, n: int, plan: BitPlan,
              steps_fn=None) -> torch.Tensor:
    """Rounds of ``k = min(rem, k_max)`` fused steps, the halo rebuilt
    from the frame before each round (host-side, a few copy kernels).
    ``steps_fn(ext, k, plan)`` is :func:`fused_steps` unless a caller
    substitutes a plain version to compare against on the card."""
    steps_fn = steps_fn or fused_steps
    rem = int(n)
    while rem > 0:
        k = min(rem, plan.k_max)
        e = local_wrap_y(plan, q)
        if plan.hx:
            e = torch.cat([e[:, -plan.hx:], e, e[:, : plan.hx]], dim=1)
        q = steps_fn(e, k, plan)
        rem -= k
    return q


# -------------------------------------------------------------- runners


def life_run_vmem_bits(board: torch.Tensor, n: int) -> torch.Tensor:
    """Advance ``n`` steps with the board resident for the whole loop."""
    ny, _ = board.shape
    out = vmem_steps(pack_board(board), ny, n)
    return unpack_board(out, ny).to(board.dtype)


def life_run_fused_bits(
    board: torch.Tensor, n: int, *, budget: int = SMEM_BYTES
) -> torch.Tensor:
    """Advance ``n`` steps of a word-aligned board (``ny % 32 == 0``) by
    fused rounds: one read and one write of the board per up to 128 steps.
    ``budget`` (shared-memory bytes per tile) exists so tests can force
    multi-tile splits at small shapes."""
    ny, nx = board.shape
    plan = plan_sharded_bits((ny, nx), budget=budget) if ny % 32 == 0 else None
    if plan is None or plan.h != _FUSE_HALO_WORDS:
        raise ValueError(
            f"no fused plan for {tuple(board.shape)}; gate callers on "
            "fused_bits_supported()")
    out = _run_plan(pack_board_exact(board), n, plan)
    return unpack_board_exact(out).to(board.dtype)


def life_run_frame_bits(
    board: torch.Tensor, n: int, *, budget: int = SMEM_BYTES
) -> torch.Tensor:
    """Advance ``n`` steps of any board too big for the resident kernel,
    through the padded torus frame (mirror rows and funnel-shifted wrap
    borders) and the fused kernel. Gate callers on
    ``plan_sharded_bits(shape)``."""
    ny, nx = board.shape
    plan = plan_sharded_bits((ny, nx), budget=budget)
    if plan is None:
        raise ValueError(
            f"no padded-frame plan for {tuple(board.shape)}; gate callers "
            "on plan_sharded_bits()")
    frame = torch.zeros(plan.frame, dtype=torch.uint8, device=board.device)
    frame[:ny] = board
    out = _run_plan(pack_board_exact(frame), n, plan)
    return unpack_board_exact(out)[:ny].to(board.dtype)


def life_run_bits_plain(board: torch.Tensor, n: int) -> torch.Tensor:
    """Advance ``n`` steps with the plain packed loop (any shape; the CPU
    path for boards past the resident gate)."""
    ny, _ = board.shape
    out = _vmem_steps_plain(pack_board(board), ny, n)
    return unpack_board(out, ny).to(board.dtype)


# ------------------------------------------- cell-packed stacks (batched)


def pack_boards(boards: torch.Tensor) -> torch.Tensor:
    """(B, ny, nx) 0/1 ints -> (B, n_words(ny), nx) int32: the offset-ghost
    :func:`pack_board` of every board."""
    if boards.dim() != 3:
        raise ValueError(f"pack_boards: expected (B, ny, nx), got "
                         f"{tuple(boards.shape)}")
    return pack_board(boards)


def unpack_boards(packed: torch.Tensor, ny: int) -> torch.Tensor:
    """Inverse of :func:`pack_boards`; returns (B, ny, nx) uint8."""
    return unpack_board(packed, ny)


def fits_vmem_packed_batch(shape: tuple[int, int, int]) -> bool:
    """Whether the batched resident kernel takes a (B, ny, nx) stack. On
    Hopper each board gets blocks of its own, so the gate is per board
    (:func:`fits_vmem_packed`) whatever B; the TPU's whole-stack gate (B
    times the board within one core's VMEM) has no counterpart."""
    return fits_vmem_packed((int(shape[1]), int(shape[2])))


def _vmem_batch_steps_plain(packed: torch.Tensor, ny: int, steps: int):
    for _ in range(int(steps)):
        packed = bit_step_b(packed, ny)
    return packed


# ----------------------------- kernel 4's geometry: one cluster per board

# Boards past the grid's y extent go to its z axis
# (csrc/bitlife_vmem_cluster.cuh:configure).
VMEM_BATCH_MAX_GRID_Y = 65535


def vmem_batch_waves(b: int, geo: VmemGeometry) -> int:
    """Waves of clusters a launch of ``b`` boards under ``geo`` takes, at
    one block an SM: :data:`CLUSTERS_AT_ONCE` of its cluster size at a
    time (132 boards for the one-block form). The card places more
    clusters of small blocks at once (k times as many where an SM holds k
    blocks), but blocks that share an SM slow each other: at 16 and 64
    boards of 500^2 on an H100 a stack took 0.4-1.0 of the extra waves'
    time (PERF.md §6), and 1.0 where an SM holds one block."""
    return -(-b // CLUSTERS_AT_ONCE[geo.cluster - 1])


def vmem_batch_grid(b: int, geo: VmemGeometry) -> tuple[int, int, int]:
    """The launch grid of ``b`` boards: (strips, boards along y, along z),
    as ``csrc/bitlife_vmem_cluster.cuh:configure`` sets it."""
    gy = min(b, VMEM_BATCH_MAX_GRID_Y)
    return geo.strips, gy, -(-b // gy)


def vmem_batch_candidates(ny: int, nx: int) -> list[VmemGeometry]:
    """Every geometry :func:`vmem_batch_launch_geometry` weighs for a stack
    of ``(ny, nx)`` boards, in the order it weighs them: the cluster
    geometries of :func:`vmem_candidates`, then the one-block form."""
    return vmem_candidates(ny, nx) + [vmem_geometry(ny, nx, 1, 0, 0, 0)]


# The per-step model vmem_batch_launch_geometry minimises, in microseconds:
# per wave (vmem_batch_waves), for a cluster geometry the terms of
# _vmem_step_model_us (a floor, a warp of a segment's row, a word a thread,
# the segments' barrier, a strip refresh every ghost steps, a warp refresh
# every warp_ghost steps) and a warp refresh's cost per warp of the row;
# for the one-block form a floor and a word a thread. Fitted by least
# squares of the relative error to the geometries of vmem_batch_times.py
# --sweep that run in one wave, on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §6).
_VMEM_BATCH_US = (0.0114, 0.0436, 0.0295, 0.2704, 0.7610, -0.0352, 0.0525,
                  0.5885, 0.2932)


def _vmem_batch_features(b: int, ny: int, nx: int,
                         geo: VmemGeometry) -> list[float]:
    """The terms of :func:`_vmem_batch_step_model_us`, in the order of its
    constants."""
    nw = n_words(ny)
    waves = vmem_batch_waves(b, geo)
    if geo.one_block:
        words = -(-nw * nx // VMEM_ONE_BLOCK_THREADS)
        return [0.0] * 7 + [waves, waves * words]
    rows = -(-nw // geo.segments)
    warp_refresh = 1 / geo.warp_ghost if geo.warps > 1 else 0.0
    return [waves * f for f in (1.0, geo.warps, rows, geo.segments > 1,
                                1 / geo.ghost, warp_refresh,
                                geo.warps * warp_refresh)] + [0.0, 0.0]


def _vmem_batch_step_model_us(b: int, ny: int, nx: int,
                              geo: VmemGeometry) -> float:
    """The modelled device time of one step of a ``bitlife_vmem_batch``
    launch of ``b`` boards (see the constants above)."""
    return sum(c * f for c, f in zip(_VMEM_BATCH_US,
                                     _vmem_batch_features(b, ny, nx, geo)))


@functools.lru_cache(maxsize=256)
def vmem_batch_launch_geometry(b: int, ny: int, nx: int) -> VmemGeometry:
    """The geometry :func:`vmem_batch_steps` launches a stack of ``b``
    ``(ny, nx)`` boards with, one cluster (or one block) a board: a plain
    function of the shape (cached), so that the same stack always gets the
    same launch. Of :func:`vmem_batch_candidates`, the one of least
    :func:`_vmem_batch_step_model_us` (the first on a tie): wide clusters
    step fast but the card places few at once, narrow ones put more boards
    in a wave. Raises ``ValueError`` for a stack the gate
    :func:`fits_vmem_packed_batch` refuses."""
    b, ny, nx = int(b), int(ny), int(nx)
    if b < 1 or ny < 0 or nx < 1 or not fits_vmem_packed_batch((b, ny, nx)):
        raise ValueError(f"vmem_batch_launch_geometry: ({b}, {ny}, {nx}) does "
                         "not fit the resident kernel (gate "
                         "fits_vmem_packed_batch)")
    best = None
    for geo in vmem_batch_candidates(ny, nx):
        t = _vmem_batch_step_model_us(b, ny, nx, geo)
        if best is None or t < best[0]:
            best = (t, geo)
    t, geo = best
    waves = vmem_batch_waves(b, geo)
    kind = ("one block a board" if geo.one_block else
            f"a cluster of {geo.strips} a board, refresh every {geo.ghost} "
            "steps")
    return dataclasses.replace(
        geo, reason=(f"{kind}, {waves} wave{'s' if waves > 1 else ''}, "
                     f"model {t:.3f} us a step"))


def vmem_batch_steps(packed: torch.Tensor, ny: int, steps: int,
                     geometry: VmemGeometry | None = None) -> torch.Tensor:
    """Advance a ``(B, nw, nx)`` offset-ghost packed stack ``steps`` steps:
    the ``bitlife_vmem_batch`` kernel on the card (each board over the
    column strips of a thread-block cluster of its own, or one block a
    board, laid out by :func:`vmem_batch_launch_geometry` unless
    ``geometry`` is given, in one launch), :func:`bit_step_b` looped on the
    CPU."""
    if packed.device.type == "cpu":
        return _vmem_batch_steps_plain(packed, ny, steps)
    _check_card_words(packed, "vmem_batch_steps", ndim=3)
    b, nw, nx = packed.shape
    if b < 1 or nw != n_words(ny) or not fits_vmem_packed_batch((b, ny, nx)):
        raise ValueError(
            f"vmem_batch_steps: packed {tuple(packed.shape)} for ny={ny} does "
            f"not fit the resident kernel (gate fits_vmem_packed_batch)")
    geo = geometry or vmem_batch_launch_geometry(b, ny, nx)
    out = torch.empty_like(packed)
    lib = _build.load("bitlife_vmem_batch")
    with torch.cuda.device(packed.device):
        rc = lib.bitlife_vmem_batch(
            packed.data_ptr(), out.data_ptr(), b, nw, nx, ny, int(steps),
            *geo.args(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "bitlife_vmem_batch", rc)
    vmem_batch_steps.launches += 1
    return out


vmem_batch_steps.launches = 0


def vmem_batch_attributes(b: int, ny: int, nx: int,
                          geometry: VmemGeometry) -> dict[str, int]:
    """What the CUDA runtime reports for the ``bitlife_vmem_batch`` launch
    of this geometry on ``b`` boards (``bitlife_vmem_batch_attributes``):
    registers and local (spilled) bytes a thread, static and dynamic shared
    bytes and threads a block, and the clusters the card can hold at once.
    Needs the card."""
    lib = _build.load("bitlife_vmem_batch")
    vals = (ctypes.c_int * 6)()
    rc = lib.bitlife_vmem_batch_attributes(b, n_words(ny), nx, ny,
                                           *geometry.args(), vals)
    _build.check(lib, "bitlife_vmem_batch", rc)
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes", "max_active_clusters", "threads"),
                    vals))


# The batched runners' (function, stack geometry, card) seen so far: the
# port's counterpart of the JAX package's compiled batch programs.
_RETRACED: set = set()


def _note_retrace(fn: str, geometry: tuple, card: bool) -> None:
    """Tick ``jit.retrace{fn=...}`` the first time ``fn`` runs a stack of
    this geometry (``obs.metrics``). The JAX package ticks it inside the
    jitted body, once per compiled stack shape; the step count is a
    run-time scalar in both, so a bucket of one shape counts once whatever
    its steps. The names are the JAX package's (``life_batch_xla`` is its
    name for the plain loop)."""
    metrics.inc_once(_RETRACED, (fn, geometry, card), "jit.retrace", fn=fn)


def life_run_vmem_bits_batch(boards: torch.Tensor, n: int) -> torch.Tensor:
    """Advance B stacked boards ``n`` steps in one launch, each board
    resident for the whole loop. Gate callers on
    :func:`fits_vmem_packed_batch`."""
    _note_retrace("life_batch_vmem", tuple(boards.shape), boards.is_cuda)
    ny = boards.shape[1]
    out = vmem_batch_steps(pack_boards(boards), ny, n)
    return unpack_boards(out, ny).to(boards.dtype)


def life_run_bits_plain_batch(boards: torch.Tensor, n: int) -> torch.Tensor:
    """Advance B stacked boards with the plain packed loop (any shape; the
    CPU's path for stacks the board-sliced layout does not take)."""
    _note_retrace("life_batch_xla", tuple(boards.shape), boards.is_cuda)
    ny = boards.shape[1]
    out = _vmem_batch_steps_plain(pack_boards(boards), ny, n)
    return unpack_boards(out, ny).to(boards.dtype)


def life_run_fused_bits_batch(
    boards: torch.Tensor, n: int, *, budget: int = SMEM_BYTES
) -> torch.Tensor:
    """Advance B stacked aligned big boards through
    :func:`life_run_fused_bits`, one board after another (each board's
    tiles fill the card already; the JAX package scans the stack with
    ``lax.map`` for the same reason)."""
    _note_retrace("life_batch_fused", tuple(boards.shape), boards.is_cuda)
    return torch.stack([life_run_fused_bits(b, n, budget=budget)
                        for b in boards])


def life_run_frame_bits_batch(
    boards: torch.Tensor, n: int, *, budget: int = SMEM_BYTES
) -> torch.Tensor:
    """Advance B stacked unaligned big boards through
    :func:`life_run_frame_bits`, one board after another."""
    _note_retrace("life_batch_frame", tuple(boards.shape), boards.is_cuda)
    return torch.stack([life_run_frame_bits(b, n, budget=budget)
                        for b in boards])


# -------------------------------------------- board-sliced stacks (batched)

def n_planes(b: int) -> int:
    """Board-sliced planes for a B-board stack: ``ceil(B / 32)``."""
    return -(-b // 32)


def pack_batch_bits(boards: torch.Tensor) -> torch.Tensor:
    """(B, ny, nx) 0/1 ints -> (n_planes(B), ny, nx) int32, board-sliced:
    bit ``b % 32`` of plane ``b // 32`` holds board ``b``'s cell. Ragged B
    zero-pads the high bits."""
    b, ny, nx = boards.shape
    npl = n_planes(b)
    bits = torch.zeros((npl * 32, ny, nx), dtype=torch.int32,
                       device=boards.device)
    bits[:b] = boards.to(torch.int32)
    return _or_bits(bits.view(npl, 32, ny, nx), 1)


def unpack_batch_bits(planes: torch.Tensor, b: int) -> torch.Tensor:
    """Inverse of :func:`pack_batch_bits`; returns (b, ny, nx) uint8."""
    npl, ny, nx = planes.shape
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    cells = (planes[:, None] >> shifts[:, None, None]) & 1
    return cells.reshape(npl * 32, ny, nx)[:b].to(torch.uint8)


def bitsliced_step(planes: torch.Tensor) -> torch.Tensor:
    """One Life step on a (n_planes, ny, nx) stack, the roll form: the bit
    axis is the batch, so a word's neighbours are the whole words at
    (y +- 1, x +- 1), gathered by torus rolls, under the same carry-save
    rule as the cell-packed step."""
    up = torch.roll(planes, -1, -2)
    dn = torch.roll(planes, 1, -2)
    return _carry_save_rule(planes, up, dn, *_X_ROLLS)


# ------------------------------ kernel 5's geometry: row bands over clusters

# (rows, columns) a thread that csrc/bitlife_bitsliced.cu compiles a kernel
# for (kernel_for), each with every segment full; those of at most
# SLICED_RAGGED_MAX_COLS columns also in a ragged form, for the one-band
# window of ny rows. Its block-size cap, and the largest cluster it takes
# (above 8 with cudaFuncAttributeNonPortableClusterSizeAllowed).
SLICED_KERNELS = tuple(
    (rt, ct) for ct, rts in ((1, (2, 4, 6, 8, 10, 12, 16)),
                             (2, (2, 4, 6, 8, 10, 12, 16)), (4, (2, 4, 6)))
    for rt in rts)
SLICED_RAGGED_MAX_COLS = 2
SLICED_MAX_THREADS = 512
SLICED_MAX_CLUSTER = 16


@dataclasses.dataclass(frozen=True)
class SlicedGeometry:
    """How one ``bitlife_bitsliced`` call spreads an ``(n_planes, ny, nx)``
    stack. Each plane is cut into ``bands`` row bands (heights ``floor`` or
    ``ceil`` of ``ny / bands``); a band's window is its rows plus ``halo``
    rows a side, read modulo ny (``window_rows`` in all), and a launch
    steps at most ``halo`` steps. With one band and no halo the window is
    the plane and one launch runs every step. Each band is cut into
    ``strips`` column strips (widths ``floor`` or ``ceil`` of ``nx /
    strips``), one block each, with ``ghost`` columns per side. With
    ``exchange`` (``ghost < halo``, or no halo) the strips are one cluster
    (``cluster == strips``) forming a ring over the torus, and push their
    ghosts to each other every ``ghost`` steps; else (ghost zones, ``ghost
    >= halo``) each reads its ghosts once a launch and needs no cluster
    (``cluster == 1``). A thread holds ``rows_per_thread`` words of each
    of ``cols_per_thread`` adjacent columns (``segments`` threads a
    column); a row of a strip takes ``warps`` warps, each with
    ``warp_ghost`` copied lanes a side when more than one, refreshed every
    ``warp_ghost * cols_per_thread`` steps. ``reason`` says why the
    chooser took it."""

    bands: int
    halo: int
    strips: int
    cluster: int
    ghost: int
    rows_per_thread: int
    cols_per_thread: int
    warp_ghost: int
    window_rows: int
    segments: int
    warps: int
    threads: int
    exchange: bool
    smem_bytes: int
    reason: str = ""

    def band_bounds(self, ny: int) -> list[tuple[int, int]]:
        """Each band's rows ``[r0, r1)`` of a ``ny``-row plane."""
        return [(b * ny // self.bands, (b + 1) * ny // self.bands)
                for b in range(self.bands)]

    def strip_bounds(self, nx: int) -> list[tuple[int, int]]:
        """Each strip's columns ``[c0, c1)`` of an ``nx``-column plane."""
        return [(r * nx // self.strips, (r + 1) * nx // self.strips)
                for r in range(self.strips)]

    def launches(self, steps: int) -> int:
        """Kernel launches of a call of ``steps`` steps."""
        if steps <= 0:
            return 0
        return 1 if self.halo == 0 else -(-steps // self.halo)

    def args(self) -> tuple[int, ...]:
        """The C entry's geometry arguments (bands, halo, strips, cluster,
        g, rt, ct, tau)."""
        return (self.bands, self.halo, self.strips, self.cluster, self.ghost,
                self.rows_per_thread, self.cols_per_thread, self.warp_ghost)


def sliced_geometry(ny: int, nx: int, bands: int, halo: int, strips: int,
                    ghost: int, rows_per_thread: int,
                    cols_per_thread: int = 1, warp_ghost: int = 1,
                    reason: str = "") -> SlicedGeometry:
    """The launch geometry of ``bands`` bands with ``halo`` rows a side,
    ``strips`` strips with ``ghost`` columns a side, ``rows_per_thread``
    words of ``cols_per_thread`` columns a thread and ``warp_ghost`` copied
    lanes a warp side, for ``(ny, nx)`` planes; derives and checks it as
    ``csrc/bitlife_bitsliced.cu:layout`` does and raises ``ValueError``
    where the entry would refuse it."""
    rt, ct, tau = rows_per_thread, cols_per_thread, warp_ghost
    if ny < 1 or nx < 1:
        raise ValueError(f"sliced geometry: plane ({ny}, {nx}) is empty")
    if not 1 <= bands <= ny or halo < 0 or (halo == 0 and bands != 1):
        raise ValueError(f"sliced geometry: bands={bands} outside [1, {ny}], "
                         f"or halo={halo} (0 takes one band)")
    if not 1 <= strips <= min(nx, SLICED_MAX_CLUSTER):
        raise ValueError(f"sliced geometry: strips={strips} outside [1, "
                         f"{min(nx, SLICED_MAX_CLUSTER)}]")
    if ghost < 1 or not 1 <= tau <= 15:
        raise ValueError(f"sliced geometry: ghost={ghost} < 1 or "
                         f"warp_ghost={tau} outside [1, 15]")
    rows = -(-ny // bands) + 2 * halo if halo else ny
    segments = -(-rows // rt) if rt >= 1 else 0
    window_rows = segments * rt if halo else ny
    full = window_rows == segments * rt
    if (rt, ct) not in SLICED_KERNELS or (
            not full and ct > SLICED_RAGGED_MAX_COLS):
        raise ValueError(f"sliced geometry: ({rt}, {ct}) rows and columns a "
                         f"thread not compiled{'' if full else ' ragged'} "
                         f"(of {SLICED_KERNELS})")
    exchange = halo == 0 or ghost < halo
    if exchange and ghost > nx // strips:
        raise ValueError(f"sliced geometry: exchanged ghost {ghost} wider "
                         f"than the narrowest strip {nx // strips}")
    lmax = -(-nx // strips) + 2 * ghost
    units = -(-lmax // ct)
    warps = 1 if units <= 32 else -(-units // (32 - 2 * tau))
    if warps > 1 and exchange and ghost % (tau * ct):
        raise ValueError(f"sliced geometry: exchanged ghost {ghost} not a "
                         f"multiple of warp_ghost x cols_per_thread "
                         f"{tau * ct}")
    threads = segments * 32 * warps
    if threads > SLICED_MAX_THREADS:
        raise ValueError(f"sliced geometry: {threads} threads a block, above "
                         f"{SLICED_MAX_THREADS}")
    words = ((2 * segments * 32 * warps * ct * 2 if segments > 1 else 0)
             + (2 * 2 * segments * warps * tau * ct * rt if warps > 1 else 0)
             + (2 * 2 * ghost * segments * rt if exchange else 0))
    if 4 * words > SMEM_BYTES:
        raise ValueError(f"sliced geometry: {4 * words} bytes of shared "
                         "memory")
    return SlicedGeometry(bands, halo, strips, strips if exchange else 1,
                          ghost, rt, ct, tau, window_rows, segments, warps,
                          threads, exchange, 4 * words, reason)


def sliced_waves(npl: int, geo: SlicedGeometry) -> int:
    """Waves of clusters (of blocks, without a cluster) a launch of ``npl``
    planes takes, at one block a SM (:data:`CLUSTERS_AT_ONCE`)."""
    groups = npl * geo.bands * (geo.strips // geo.cluster)
    return -(-groups // CLUSTERS_AT_ONCE[geo.cluster - 1])


# The per-step model plan_bitsliced minimises, in microseconds: a launch
# (amortised over the halo's steps it runs; its window's load and store
# and the launch gap), then per wave of clusters a step's floor (the
# segments' block barrier with it), its issue cost per warp-word of a
# block, a strip refresh through the cluster (every ghost steps) and a warp
# refresh (every warp_ghost x cols_per_thread steps). Fitted by least
# squares of the relative error to the 4137 geometries of sliced_times.py
# --sweep on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6; median
# error 7 %).
_SLICED_US_LAUNCH = 3.2350
_SLICED_US_STEP = 0.0656
_SLICED_US_WARP_WORD = 0.0068
_SLICED_US_REFRESH = 0.6766
_SLICED_US_WARP_REFRESH = 0.1257


def _sliced_features(npl: int, geo: SlicedGeometry) -> list[float]:
    """The terms of :func:`_sliced_step_model_us`, in the order of its
    constants."""
    waves = sliced_waves(npl, geo)
    h = geo.halo
    # Refreshes a step: (k - 1) // period in a launch of k = h steps.
    per = (lambda period: ((h - 1) // period) / h) if h else (
        lambda period: 1.0 / period)
    return [1.0 / h if h else 0.0, waves,
            waves * geo.segments * geo.warps * geo.rows_per_thread
            * geo.cols_per_thread,
            waves * (per(geo.ghost) if geo.exchange else 0.0),
            waves * (per(geo.warp_ghost * geo.cols_per_thread)
                     if geo.warps > 1 else 0.0)]


def _sliced_step_model_us(npl: int, geo: SlicedGeometry) -> float:
    """The modelled device time of one step of a ``bitlife_bitsliced`` call
    on ``npl`` planes (see the constants above)."""
    coef = (_SLICED_US_LAUNCH, _SLICED_US_STEP, _SLICED_US_WARP_WORD,
            _SLICED_US_REFRESH, _SLICED_US_WARP_REFRESH)
    return sum(c * f for c, f in zip(coef, _sliced_features(npl, geo)))


_SLICED_HALOS = (8, 16, 32)


def _sliced_tries(shape, halos, ghosts_of):
    """The legal geometries of each strip count, halo (and 0, one band),
    ghost (``ghosts_of(wmin, halo)``, plus ghost zones of ``halo``),
    columns and copied lanes a thread: of band counts, the fewest that fit
    a block and those that put one and two blocks on every SM, each with
    the fewest rows a thread that fit."""
    npl, ny, nx = shape
    out = []
    for strips in range(1, min(SLICED_MAX_CLUSTER, nx) + 1):
        wmin, wmax = nx // strips, -(-nx // strips)
        for halo in halos:
            ghosts = [g for g in ghosts_of(wmin, halo)
                      if halo == 0 or g < halo]
            if halo:
                ghosts.append(halo)
            for ghost in ghosts:
                for ct in (1, 2, 4):
                    units = -(-(wmax + 2 * ghost) // ct)
                    for tau in ((1,) if units <= 32 else (1, 2)):
                        warps = 1 if units <= 32 else -(-units // (32 - 2 * tau))
                        pmax = SLICED_MAX_THREADS // (32 * warps)
                        rts = [rt for rt, c in SLICED_KERNELS if c == ct]
                        if halo == 0:
                            band_opts = [1]
                        else:
                            rows_max = pmax * max(rts) - 2 * halo
                            if rows_max < 1:
                                continue
                            fewest = -(-ny // rows_max)
                            band_opts = sorted({min(ny, max(fewest, -(-n // (npl * strips))))
                                                for n in (1, N_SMS, 2 * N_SMS)})
                        for bands in band_opts:
                            rows = ny if halo == 0 else -(-ny // bands) + 2 * halo
                            for rt in rts:
                                if -(-rows // rt) > pmax:
                                    continue
                                try:
                                    out.append(sliced_geometry(
                                        ny, nx, bands, halo, strips, ghost,
                                        rt, ct, tau))
                                except ValueError:
                                    continue
                                break
    return out


def sliced_candidates(shape: tuple[int, int, int]) -> list[SlicedGeometry]:
    """Every geometry :func:`plan_bitsliced` weighs for an ``(n_planes, ny,
    nx)`` stack, in the order it weighs them: 1 to 16 strips; one band
    without a halo, then halos of 8, 16 and 32 rows; ghosts of 4 and 8
    columns (or of 2 and 1 on narrow strips) refreshed through the ring,
    and ghost zones as deep as the halo; 1, 2 and 4 columns and 1 or 2
    copied lanes a thread; the fewest bands that fit a block and those that
    fill the card once and twice; the fewest rows a thread that fit. A
    stack where none of those is legal (a plane too wide for 16 strips of
    a block each) takes the legal ones of halos of 4, 2 and 1 rows."""
    def ghosts(wmin, halo):
        return [g for g in (4, 8) if g <= wmin] or [g for g in (2, 1)
                                                   if g <= wmin][:1]
    out = _sliced_tries(shape, (0,) + _SLICED_HALOS, ghosts)
    if not out:
        out = _sliced_tries(shape, (4, 2, 1),
                            lambda wmin, halo: [1] if wmin else [])
    return out


@functools.lru_cache(maxsize=256)
def plan_bitsliced(shape: tuple[int, int, int]) -> SlicedGeometry:
    """The geometry :func:`bitsliced_steps` runs an ``(n_planes, ny, nx)``
    stack with: a plain function of the shape (cached), so that the same
    stack always gets the same launches. Of :func:`sliced_candidates`, the
    one of least :func:`_sliced_step_model_us` (the first on a tie)."""
    npl, ny, nx = (int(v) for v in shape)
    if npl < 1 or ny < 1 or nx < 1:
        raise ValueError(f"plan_bitsliced: empty stack {shape}")
    best = None
    for geo in sliced_candidates((npl, ny, nx)):
        t = _sliced_step_model_us(npl, geo)
        if best is None or t < best[0]:
            best = (t, geo)
    if best is None:
        raise ValueError(f"plan_bitsliced: no geometry for {shape}")
    t, geo = best
    kind = (f"a cluster of {geo.strips}, refresh every {geo.ghost} steps"
            if geo.exchange else f"{geo.strips} ghost-zone strips")
    return dataclasses.replace(
        geo, reason=(f"{geo.bands} bands of halo {geo.halo}, {kind}, model "
                     f"{t:.3f} us a step"))


def _bitsliced_steps_plain(planes: torch.Tensor, steps: int) -> torch.Tensor:
    for _ in range(int(steps)):
        planes = bitsliced_step(planes)
    return planes


def bitsliced_steps(planes: torch.Tensor, steps: int,
                    geometry: SlicedGeometry | None = None) -> torch.Tensor:
    """Advance a (n_planes, ny, nx) board-sliced stack ``steps`` steps: the
    ``bitlife_bitsliced`` kernel on the card - each plane's row bands over
    the column strips of thread-block clusters, a column's words in
    registers, laid out by :func:`plan_bitsliced` unless ``geometry`` is
    given, in ``geometry.launches(steps)`` launches, counted as the C entry
    point reports them - :func:`bitsliced_step` looped on the CPU."""
    if planes.device.type == "cpu":
        return _bitsliced_steps_plain(planes, steps)
    _check_card_words(planes, "bitsliced_steps", ndim=3)
    steps = int(steps)
    if steps == 0:
        return planes.clone()
    npl, ny, nx = planes.shape
    geo = geometry or plan_bitsliced((npl, ny, nx))
    out = torch.empty_like(planes)
    scratch = torch.empty_like(planes)
    launched = ctypes.c_int(0)
    lib = _build.load("bitlife_bitsliced")
    with torch.cuda.device(planes.device):
        rc = lib.bitlife_bitsliced(
            planes.data_ptr(), out.data_ptr(), scratch.data_ptr(), npl, ny,
            nx, *geo.args(), steps, torch.cuda.current_stream().cuda_stream,
            ctypes.byref(launched))
    bitsliced_steps.launches += launched.value
    _build.check(lib, "bitlife_bitsliced", rc)
    return out


bitsliced_steps.launches = 0


def bitsliced_attributes(shape: tuple[int, int, int],
                         geometry: SlicedGeometry) -> dict[str, int]:
    """What the CUDA runtime reports for the ``bitlife_bitsliced`` launch of
    this geometry on an ``(n_planes, ny, nx)`` stack
    (``bitlife_bitsliced_attributes``): registers and local (spilled) bytes
    a thread, static and dynamic shared bytes and threads a block, and the
    clusters the card can hold at once. Needs the card."""
    lib = _build.load("bitlife_bitsliced")
    vals = (ctypes.c_int * 6)()
    rc = lib.bitlife_bitsliced_attributes(*(int(v) for v in shape),
                                          *geometry.args(), vals)
    _build.check(lib, "bitlife_bitsliced", rc)
    return dict(zip(("registers", "local_bytes", "static_smem_bytes",
                     "dynamic_smem_bytes", "max_active_clusters", "threads"),
                    vals))


def life_run_bitsliced_batch(boards: torch.Tensor, n: int) -> torch.Tensor:
    """Advance B stacked boards ``n`` steps through the board-sliced layout:
    pack to planes, step, unpack, drop the ragged padding (one retrace
    tick per plane stack, as the JAX package compiles per plane shape)."""
    b, ny, nx = boards.shape
    _note_retrace("life_batch_bitsliced", (n_planes(b), ny, nx),
                  boards.is_cuda)
    out = bitsliced_steps(pack_batch_bits(boards), n)
    return unpack_batch_bits(out, boards.shape[0]).to(boards.dtype)
