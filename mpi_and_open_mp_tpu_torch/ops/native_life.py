"""Dispatch over the hand-written Life kernels, for one board and for stacks.

Counterpart of ``mpi_and_open_mp_tpu/ops/pallas_life.py`` (its dispatch).
For one board, :func:`native_path` picks the engine for a board shape and
:func:`life_run_vmem` runs it:

* ``"vmem"`` - the whole packed board resident in one block's shared
  memory for the entire step loop (``bitlife.life_run_vmem_bits``);
* ``"fused"`` - word-aligned boards past that gate: fused rounds of up to
  128 steps over halo tiles (``bitlife.life_run_fused_bits``);
* ``"frame"`` - any other board past the gate, in a row-padded torus frame
  through the same fused kernel (``bitlife.life_run_frame_bits``);
* ``"plain"`` - the plain packed loop, the CPU's path for boards past the
  resident gate (the counterpart of the JAX package's ``"xla"`` rung).

For a (B, ny, nx) stack, :func:`native_path_batch` picks the path and
:func:`life_run_vmem_batch` runs it: ``"bitsliced"`` (board-sliced planes,
32 boards per word), ``"vmem-grid"`` (one resident block per board),
``"fused"`` and ``"frame"`` (the big-board engines, board after board), and
``"plain"`` on the CPU. The JAX package's ``"vmem"`` (whole stack resident
in one program) has no counterpart: on Hopper a block holds one board, so
both TPU forms are ``"vmem-grid"``. Installed tuned plans
(``pallas_life.planned_path``) are not ported yet.

On the card only the kernel paths exist: a shape none of them covers
raises. On the CPU the resident and board-sliced paths run their plain
versions, and other shapes take ``"plain"``, as the JAX package's CPU
dispatch takes its XLA loop.

For the sharded layouts, :func:`life_step_padded_native` steps the
interiors of 1-padded blocks (the JAX package's
``life_step_padded_pallas``) on the Life rule of the hand-written
``csrc/stencil_padded.cu``.
"""

from __future__ import annotations

import contextlib
import os

import torch

from mpi_and_open_mp_tpu_torch.ops import bitlife, life_ops, native_stencil
from mpi_and_open_mp_tpu_torch.stencils import spec as spec_lib

# MOMP_BITSLICE=0 pins every batched dispatch to the cell-packed ladder
# (for triage; the answers do not change, only the path).
_BITSLICE = os.environ.get("MOMP_BITSLICE", "1") != "0"

# Below this batch a plane is more than 75 % padding, and the cell-packed
# ladder (whose work scales with B, not ceil(B / 32)) takes the stack. The
# JAX package's figure, kept until the tuning port. On an H100 the measured
# line has moved with each kernel's redesign (chip_smoke.py phase 6,
# PERF.md): "bitsliced" was the faster at every stack of 8 to 512 boards
# measured after its own, and "vmem-grid", one cluster a board, is the
# faster at every stack of 1 to 512 boards measured after its own.
BITSLICE_MIN_BATCH = 8


@contextlib.contextmanager
def _bitslice_pinned(value: bool):
    """Pin the board-sliced layout gate for the duration (the flag is read
    when a dispatch picks its path)."""
    global _BITSLICE
    prev = _BITSLICE
    _BITSLICE = value
    try:
        yield
    finally:
        _BITSLICE = prev


def native_path(shape: tuple[int, int], on_card: bool = True) -> str:
    """Which path :func:`life_run_vmem` takes for ``shape``: ``"vmem"``,
    ``"fused"`` or ``"frame"`` on the card (raising for a shape no kernel
    covers), ``"vmem"`` or ``"plain"`` on the CPU."""
    shape = (int(shape[0]), int(shape[1]))
    if bitlife.fits_vmem_packed(shape):
        return "vmem"
    if not on_card:
        return "plain"
    return _big_board_path(shape)


def _big_board_path(shape: tuple[int, int]) -> str:
    if bitlife.fused_bits_supported(shape):
        return "fused"
    if bitlife.plan_sharded_bits(shape) is not None:
        return "frame"
    raise ValueError(
        f"no kernel covers a {shape} board: it is past the resident gate "
        "and too short for a fused halo")


def life_run_vmem(board: torch.Tensor, n: int) -> torch.Tensor:
    """Advance ``board`` (on the card or the CPU) ``n`` steps on the path
    :func:`native_path` picks."""
    path = native_path(board.shape, on_card=board.device.type == "cuda")
    if path == "vmem":
        return bitlife.life_run_vmem_bits(board, n)
    if path == "fused":
        return bitlife.life_run_fused_bits(board, n)
    if path == "frame":
        return bitlife.life_run_frame_bits(board, n)
    return bitlife.life_run_bits_plain(board, n)


def native_path_batch(
    shape: tuple[int, int, int], on_card: bool = True,
    allow_bitsliced: bool = True,
) -> str:
    """Which path :func:`life_run_vmem_batch` takes for a (B, ny, nx)
    stack: ``"bitsliced"`` from :data:`BITSLICE_MIN_BATCH` boards up, for
    boards under the resident gate (on every device, unless
    ``MOMP_BITSLICE=0`` or ``allow_bitsliced=False``), else on the card
    ``"vmem-grid"``, ``"fused"`` or ``"frame"`` (raising for a shape no
    kernel covers), and on the CPU ``"plain"``.

    The bitsliced kernel tiles a plane of any size and has no gate of its
    own. Boards past the resident gate stay on the big-board ladder, which
    tiles each board over the card already, as the JAX package's VMEM gate
    (``fits_vmem_bitsliced``) hands boards past about 1000^2 to it."""
    b, ny, nx = (int(s) for s in shape)
    resident = bitlife.fits_vmem_packed((ny, nx))
    if allow_bitsliced and _BITSLICE and b >= BITSLICE_MIN_BATCH and resident:
        return "bitsliced"
    if not on_card:
        return "plain"
    if resident:
        return "vmem-grid"
    return _big_board_path((ny, nx))


def batch_pack_layout(shape: tuple[int, int, int], on_card: bool = True) -> str:
    """The pack layout :func:`life_run_vmem_batch` uses for a stack:
    ``"bitsliced"`` (bit axis = batch) or ``"cell-packed"`` (bit axis =
    space), derived from :func:`native_path_batch` so the two agree."""
    path = native_path_batch(shape, on_card=on_card)
    return "bitsliced" if path == "bitsliced" else "cell-packed"


def batch_slice_width(shape: tuple[int, int]) -> int | None:
    """Plane width (32) when (ny, nx) boards take the board-sliced path at
    some batch size (on every device), else None. The serve layer pads
    such buckets to multiples of 32: a board-sliced dispatch costs the same
    for every B within a plane."""
    ny, nx = shape
    if _BITSLICE and bitlife.fits_vmem_packed((ny, nx)):
        return 32
    return None


def life_run_vmem_batch(boards: torch.Tensor, n: int) -> torch.Tensor:
    """Advance a (B, ny, nx) stack (on the card or the CPU) ``n`` steps on
    the path :func:`native_path_batch` picks; bit-exact per board against
    the single-board engines."""
    path = native_path_batch(boards.shape, on_card=boards.device.type == "cuda")
    if path == "bitsliced":
        return bitlife.life_run_bitsliced_batch(boards, n)
    if path == "vmem-grid":
        return bitlife.life_run_vmem_bits_batch(boards, n)
    if path == "fused":
        return bitlife.life_run_fused_bits_batch(boards, n)
    if path == "frame":
        return bitlife.life_run_frame_bits_batch(boards, n)
    return bitlife.life_run_bits_plain_batch(boards, n)


def life_step_padded_native(padded: torch.Tensor) -> torch.Tensor:
    """One Life step of the interiors of ``(*lead, h + 2, w + 2)`` blocks
    whose ghost cells hold the neighbouring state (uint8 or int32 cells);
    returns ``(*lead, h, w)`` in the same dtype. On the card, one launch
    of ``csrc/stencil_padded.cu`` with its Life rule (rule 0) over the
    whole stack - the kernel computes ``life_ops.life_step_padded``
    exactly, tiles any extent and takes a leading stack axis, so it serves
    the JAX package's ``life_step_padded_pallas`` as it stands. On the
    CPU, ``life_ops.life_step_padded``. The JAX package's VMEM gate
    (``fits_vmem``, big blocks to jnp) has no counterpart here."""
    if padded.dim() < 2 or padded.shape[-2] < 3 or padded.shape[-1] < 3:
        raise ValueError(f"life_step_padded_native: expected (..., h+2, "
                         f"w+2) blocks, got {tuple(padded.shape)}")
    if padded.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"life_step_padded_native: uint8 or int32 cells, "
                         f"got {padded.dtype}")
    if padded.device.type == "cpu":
        return life_ops.life_step_padded(padded)
    cells = padded.to(torch.uint8).contiguous()
    out = native_stencil._launch(spec_lib.LIFE, cells)
    if out.numel():
        life_step_padded_native.launches += 1
    return out.to(padded.dtype)


life_step_padded_native.launches = 0
