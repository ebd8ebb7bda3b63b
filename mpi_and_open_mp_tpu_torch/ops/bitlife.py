"""Bit-packed Life on one board: 32 cells per 32-bit word, bitwise rule.

Counterpart of ``mpi_and_open_mp_tpu/ops/bitlife.py`` (its single-board
subset). The packing is the same bit for bit: 32 cells per word along y,
and the rule is the same carry-save adder form, ``(n0 | alive) & n1 & ~n2``
over the mod-8 neighbour count (at least 17 funnel-shift and 3-input
logic instructions per 32 cells on the card, y shifts included).

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

Two hand-written Hopper kernels carry the packed engines on the card (see
``csrc/``), each with a plain PyTorch version beside it:

* :func:`vmem_steps` - the whole packed board resident in one thread
  block's shared memory for the entire step loop (``"vmem"``), replacing
  ``_vmem_bits_kernel``;
* :func:`fused_steps` - one tile plus a 128-row (4-word) y halo, and on
  column-tiled plans a ``k``-column x halo, per block, ``k <= 128`` steps in
  shared memory, interior written back (``"fused"`` and ``"frame"``),
  replacing ``_fused_tiles_kernel``.

A wrapper takes the plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.

The Hopper gates differ from the TPU's: a block has at most 227 KB of
dynamic shared memory (:data:`SMEM_BYTES`), and both kernels keep a double
buffer of the resident words, 8 bytes per word. The port never pads x to a
lane multiple: the kernels index columns modulo the window width, so the
TPU's wrap-column patch (``nx_exact``) has no counterpart here and the
padded frame pads rows only.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

# Dynamic shared memory one H100 thread block may use (227 KB), and the
# bytes each resident packed word costs in the kernels (two 4-byte
# buffers: the step reads one and writes the other).
SMEM_BYTES = 232_448
BYTES_PER_WORD = 8
# Streaming multiprocessors of an H100 SXM: the tile planner's wave size.
N_SMS = 132

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


def _or_rows(rows: torch.Tensor) -> torch.Tensor:
    """(nw, 32, nx) 0/1 int32 -> (nw, nx) words, bit b from rows[:, b]."""
    out = torch.zeros(
        (rows.shape[0], rows.shape[2]), dtype=torch.int32, device=rows.device)
    for b in range(32):
        out |= rows[:, b] << b
    return out


def _bits_to_rows(packed: torch.Tensor) -> torch.Tensor:
    """(nw, nx) words -> (32*nw, nx) 0/1 uint8 rows."""
    nw, nx = packed.shape
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    rows = (packed[:, None, :] >> shifts[None, :, None]) & 1
    return rows.reshape(nw * 32, nx).to(torch.uint8)


def pack_board(board: torch.Tensor) -> torch.Tensor:
    """(ny, nx) 0/1 ints -> (n_words(ny), nx) int32, offset-ghost layout.

    Ghost bits are left zero: every step refreshes them first."""
    ny, nx = board.shape
    nw = n_words(ny)
    rows = torch.zeros((nw * 32, nx), dtype=torch.int32, device=board.device)
    rows[1 : ny + 1] = board.to(torch.int32)
    return _or_rows(rows.view(nw, 32, nx))


def unpack_board(packed: torch.Tensor, ny: int) -> torch.Tensor:
    """Inverse of :func:`pack_board`; returns (ny, nx) uint8."""
    return _bits_to_rows(packed)[1 : ny + 1]


def pack_board_exact(board: torch.Tensor) -> torch.Tensor:
    """(ny, nx) 0/1 ints -> (ny/32, nx) int32 with no ghost offset: bit
    ``b`` of word row ``w`` holds board row ``32*w + b``. Needs
    ``ny % 32 == 0`` (the torus wrap is then word-aligned)."""
    ny, nx = board.shape
    if ny % 32:
        raise ValueError(f"pack_board_exact needs ny % 32 == 0, got {ny}")
    return _or_rows(board.to(torch.int32).reshape(ny // 32, 32, nx))


def unpack_board_exact(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_board_exact`; returns (ny, nx) uint8."""
    return _bits_to_rows(packed)


def state_from_jax(
    packed: np.ndarray,
    ny: int,
    nx: int,
    layout: str = "offset-ghost",
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Carry a JAX packed board across: ``packed`` is the uint32 output of
    the JAX package's ``pack_board`` (``layout="offset-ghost"``, possibly
    lane-padded past ``nx``) or ``pack_board_exact`` (``layout="exact"``).
    Returns the port's int32 ``(words, nx)`` tensor with the same bits."""
    dev = resolve_device(device)
    words = np.asarray(packed)
    if words.dtype != np.uint32 or words.ndim != 2:
        raise ValueError(f"expected 2-D uint32 words, got {words.dtype} "
                         f"{words.shape}")
    if layout == "offset-ghost":
        rows = n_words(ny)
    elif layout == "exact":
        if ny % 32:
            raise ValueError(f"exact layout needs ny % 32 == 0, got {ny}")
        rows = ny // 32
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if words.shape[0] != rows or words.shape[1] < nx:
        raise ValueError(
            f"packed shape {words.shape} does not hold a {layout} "
            f"({ny}, {nx}) board ({rows} word rows, >= {nx} columns)")
    own = np.ascontiguousarray(words[:, :nx]).view(np.int32)
    return torch.from_numpy(own.copy()).to(dev)


# ------------------------------------------------------ the plain packed step


def _refresh_ghosts(p: torch.Tensor, ny: int) -> torch.Tensor:
    """Rewrite the two torus ghost bits from live board state: position
    0 := position ny (board row ny-1); position ny+1 := position 1 (board
    row 0). Returns a new tensor."""
    p = p.clone()
    w_lo, b_lo = divmod(ny, 32)
    p[0] = (p[0] & _i32(0xFFFFFFFE)) | ((p[w_lo] >> b_lo) & 1)
    w_hi, b_hi = divmod(ny + 1, 32)
    src = (p[0] >> 1) & 1
    p[w_hi] = (p[w_hi] & _i32(0xFFFFFFFF ^ (1 << b_hi))) | (src << b_hi)
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


def _window_step(w: torch.Tensor) -> torch.Tensor:
    """One packed step over a whole window, both axes wrapping at the
    window's edge: single-bit y shifts through the words (carries from
    the neighbouring word row) and column rolls. On a whole board this is
    the torus step; on a halo window the wrap feeds junk in at the edges,
    one bit row (and one column) per step, which never reaches the valid
    interior within the halo's depth."""
    dn = (w << 1) | _srl(torch.roll(w, 1, 0), 31)
    up = _srl(w, 1) | (torch.roll(w, -1, 0) << 31)
    return _carry_save_rule(
        w, up, dn,
        lambda x: torch.roll(x, 1, 1),
        lambda x: torch.roll(x, -1, 1),
    )


def bit_step(p: torch.Tensor, ny: int) -> torch.Tensor:
    """One Life step on an offset-ghost packed board (ghost refresh, then
    the bitwise rule). The board is never lane-padded here, so its width
    is the torus width."""
    return _window_step(_refresh_ghosts(p, ny))


# ------------------------------------------------- kernel 1: resident board


def _check_card_words(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got "
                         f"{t.device}")
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous 2-D int32 words, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _vmem_steps_plain(packed: torch.Tensor, ny: int, steps: int):
    for _ in range(int(steps)):
        packed = bit_step(packed, ny)
    return packed


def vmem_steps(packed: torch.Tensor, ny: int, steps: int) -> torch.Tensor:
    """Advance an offset-ghost packed board ``steps`` steps: the
    ``bitlife_vmem`` kernel (one block, board resident in shared memory for
    the whole loop) on the card, :func:`bit_step` looped on the CPU."""
    if packed.device.type == "cpu":
        return _vmem_steps_plain(packed, ny, steps)
    _check_card_words(packed, "vmem_steps")
    nw, nx = packed.shape
    if nw != n_words(ny) or not fits_vmem_packed((ny, nx)):
        raise ValueError(
            f"vmem_steps: packed {tuple(packed.shape)} for ny={ny} does not "
            f"fit the resident kernel (gate fits_vmem_packed)")
    out = torch.empty_like(packed)
    lib = _build.load("bitlife_vmem")
    with torch.cuda.device(packed.device):
        rc = lib.bitlife_vmem(
            packed.data_ptr(), out.data_ptr(), nw, nx, ny, int(steps),
            torch.cuda.current_stream().cuda_stream)
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


def _fused_tile_words(nw, nx, h, budget):
    """Best ``(cost, tr)`` for full-width row tiles (x wraps inside the
    window, no x halo), or None when no row tile fits."""
    best = None
    for tr in range(1, nw + 1):
        cost = _tile_cost(nw, nx, tr, nx, h, 0, budget)
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
    """How one board runs through the fused kernel: the padded frame, the
    halo depths and fuse budget, and the tile split. Produced by
    :func:`plan_sharded_bits`."""

    shape: tuple[int, int]   # logical (ny, nx)
    frame: tuple[int, int]   # stored (32 * nw, nx): rows padded only
    pad_y: int               # mirror rows below the board
    nw: int                  # packed word rows of the frame
    h: int                   # y halo words per side
    hx: int                  # x halo columns per side (0 = full-width tiles)
    k_max: int               # fused steps per round
    tr: int                  # tile word rows (the last tile may be shorter)
    cx: int                  # tile columns (nx for full-width tiles)


@functools.lru_cache(maxsize=64)
def plan_sharded_bits(
    shape: tuple[int, int], budget: int = SMEM_BYTES
) -> BitPlan | None:
    """Plan the fused packed path for any board on one device: a frame of
    ``ceil(ny/32)`` word rows whose last ``pad_y`` rows mirror board rows
    ``[0, pad_y)``, a ``min(4, ...)``-word y halo, and the cheapest tile
    split that fits ``budget`` bytes of shared memory (full-width row
    tiles, else 2-D tiles with a ``k_max``-column x halo). Returns None
    when the board is too short to carry a halo beside its padding.

    The single-device plan of the JAX package's ``plan_sharded_bits``;
    sharded plans come with the sharded layouts (ROADMAP Queue 1 item 3)."""
    ny, nx = shape
    if ny < 8 or nx < 8:
        return None
    nw = -(-ny // 32)
    pad_y = 32 * nw - ny
    # The wrap funnel reads h + 1 words past the mirror rows.
    h = min(_FUSE_HALO_WORDS, nw - 1 if pad_y else nw)
    if h < 1:
        return None
    k_max = min(32 * h, FUSE_MAX_STEPS)
    rows = _fused_tile_words(nw, nx, h, budget)
    cols = _col_tile_plan(nw, nx, h, k_max, budget)
    if rows is None and cols is None:
        return None
    if cols is not None and (rows is None or cols[0] < rows[0]):
        _, tr, cx = cols
        hx = k_max
    else:
        _, tr = rows
        cx, hx = nx, 0
    return BitPlan(
        shape=(ny, nx), frame=(32 * nw, nx), pad_y=pad_y, nw=nw, h=h,
        hx=hx, k_max=k_max, tr=tr, cx=cx,
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
    h, hx, nw, nx = plan.h, plan.hx, plan.nw, plan.frame[1]
    w = ext
    for _ in range(int(k)):
        w = _window_step(w)
    return w[h : h + nw, hx : hx + nx]


def fused_steps(ext: torch.Tensor, k: int, plan: BitPlan) -> torch.Tensor:
    """``k <= plan.k_max`` fused steps over the halo-extended packed frame
    ``ext`` of shape ``(nw + 2h, nx + 2hx)``; returns the ``(nw, nx)``
    interior. The ``bitlife_fused`` kernel on the card (one block per
    tile), the plain version on the CPU."""
    nw, nx = plan.nw, plan.frame[1]
    if tuple(ext.shape) != (nw + 2 * plan.h, nx + 2 * plan.hx):
        raise ValueError(f"fused_steps: ext {tuple(ext.shape)} does not "
                         f"match the plan's extended frame")
    if not 0 <= k <= plan.k_max:
        raise ValueError(f"fused_steps: k={k} outside [0, {plan.k_max}]")
    if ext.device.type == "cpu":
        return _fused_steps_plain(ext, k, plan)
    _check_card_words(ext, "fused_steps")
    out = torch.empty((nw, nx), dtype=torch.int32, device=ext.device)
    lib = _build.load("bitlife_fused")
    with torch.cuda.device(ext.device):
        rc = lib.bitlife_fused(
            ext.data_ptr(), out.data_ptr(), nw, nx, plan.h, plan.hx,
            plan.tr, plan.cx, int(k), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "bitlife_fused", rc)
    fused_steps.launches += 1
    return out


fused_steps.launches = 0


# ----------------------------------------------- frame helpers (host side)


def wrap_y(p: torch.Tensor, h: int = _FUSE_HALO_WORDS) -> torch.Tensor:
    """Extend a packed board with ``h`` torus-wrap word rows per side."""
    return torch.cat([p[-h:], p, p[:h]], dim=0)


def take_rows(words: torch.Tensor, start: int, h: int) -> torch.Tensor:
    """Bit rows ``[start, start + 32*h)`` of a packed word stack: a plain
    slice when word-aligned, else each word funnelled from two."""
    q, b = divmod(start, 32)
    if b == 0:
        return words[q : q + h]
    return _srl(words[q : q + h], b) | (words[q + 1 : q + h + 1] << (32 - b))


def mirror_tail(e: torch.Tensor, src: torch.Tensor, pad: int) -> torch.Tensor:
    """Rewrite the last ``pad`` bit rows of frame ``e`` with rows
    ``[0, pad)`` of ``src`` (which carries at least ``pad + 32`` rows from
    board row 0): the periodic-mirror refresh."""
    nw = e.shape[0]
    q, b = divmod(pad, 32)
    parts = [e[: nw - q - (1 if b else 0)]]
    if b:
        keep = (1 << (32 - b)) - 1
        parts.append(((e[nw - 1 - q] & keep) | (src[0] << (32 - b)))[None])
    if q:
        parts.append(take_rows(src, b, q))
    return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]


def wrap_y_padded(e: torch.Tensor, ny: int, h: int) -> torch.Tensor:
    """Local y-extension of a packed frame taller than the board: refresh
    the mirror rows, then add funnel-shifted torus borders (board rows
    ``[ny - 32h, ny)`` above, ``[pad, pad + 32h)`` below). Needs
    ``h + 1 + pad//32 <= nw``."""
    nw = e.shape[0]
    pad = 32 * nw - ny
    if pad == 0:
        return wrap_y(e, h)
    s = h + 1 + pad // 32
    top = take_rows(e[-s:], 32 * s - pad - 32 * h, h)
    bot = take_rows(e[:s], pad, h)
    e = mirror_tail(e, e[:s], pad)
    return torch.cat([top, e, bot], dim=0)


def local_wrap_y(plan: BitPlan, q: torch.Tensor) -> torch.Tensor:
    """The plan's torus extension in y: funnel wrap and mirror refresh on
    a padded frame, plain word-row wrap on an exact one."""
    if plan.pad_y:
        return wrap_y_padded(q, plan.shape[0], plan.h)
    return wrap_y(q, plan.h)


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
