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
both TPU forms are ``"vmem-grid"``. A tuned plan installed for the stack's
shape (:func:`install_planned_path`, by ``tune.plans.PlanStore.install``)
is consulted first and taken wherever :func:`_planned_legal` allows it on
this device; the static ladder below it is the fallback and the no-plans
behaviour.

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
# JAX package's figure, and the ladder's: a stack whose best path was
# measured on the card (``tune``) takes it through an installed plan
# instead. On an H100 the measured line has moved with each kernel's
# redesign (chip_smoke.py phases 6 and 24, PERF.md): "vmem-grid", one
# cluster a board, was the faster at every stack of 1 to 512 boards
# measured after its own.
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


# Installed tuned plans: (workload, *stack shape) -> engine path, filled by
# tune.plans.PlanStore.install() once a record passed its CRC, fingerprint
# and parity gates, and consulted by native_path_batch before the static
# ladder. MOMP_TUNE=0 is the kill switch, read at each call.
_PLANNED_PATHS: dict[tuple, str] = {}


def _tune_enabled() -> bool:
    return os.environ.get("MOMP_TUNE", "1") != "0"


def _plan_key(workload: str, shape) -> tuple:
    return (str(workload), *(int(x) for x in shape))


def install_planned_path(workload: str, shape, path: str) -> None:
    """Install a tuned engine path for one (workload, stack shape). Only
    ``tune`` calls this, after the record passed its gates; nothing here
    validates it again."""
    _PLANNED_PATHS[_plan_key(workload, shape)] = str(path)


def planned_path(workload: str, shape) -> str | None:
    """The installed tuned path for (workload, stack shape), or None when
    none is installed or ``MOMP_TUNE=0``. A ``stencil:sep``/``stencil:fft``
    plan whose family the ``MOMP_ENGINE_FAMILY`` pin disallows is None
    too, from the next dispatch on."""
    if not _tune_enabled():
        return None
    path = _PLANNED_PATHS.get(_plan_key(workload, shape))
    if path is not None and path.startswith("stencil:"):
        from mpi_and_open_mp_tpu_torch.stencils import engine as stencil_engine

        if not stencil_engine.family_allowed(
                stencil_engine.family_for_path(path)):
            return None
    return path


def clear_planned_paths() -> None:
    _PLANNED_PATHS.clear()


@contextlib.contextmanager
def _planned_pinned(workload: str, shape, path: str | None):
    """Pin one (workload, shape) plan entry for the block (``None`` removes
    it): ``tune.plans.fingerprint_for`` keys a plan with its path pinned
    in, so ``<digest>.plan`` and ``<digest>.aot`` share one digest, and
    ``tune.space.heuristic_path`` asks the ladder with it pinned out."""
    key = _plan_key(workload, shape)
    missing = object()
    prev = _PLANNED_PATHS.get(key, missing)
    if path is None:
        _PLANNED_PATHS.pop(key, None)
    else:
        _PLANNED_PATHS[key] = str(path)
    try:
        yield
    finally:
        if prev is missing:
            _PLANNED_PATHS.pop(key, None)
        else:
            _PLANNED_PATHS[key] = prev


def _planned_legal(path: str, shape: tuple[int, int, int], on_card: bool,
                   allow_bitsliced: bool) -> bool:
    """Whether an installed plan's path may run a (B, ny, nx) stack here.
    The gates are the port's own: the resident gate for the board-sliced
    and cell-packed kernels, the big-board plans for the fused kernel, and
    the runtime pins (``MOMP_BITSLICE=0``, ``allow_bitsliced=False``). A
    plan may override :data:`BITSLICE_MIN_BATCH`, never a gate; the plain
    loop is legal off the card only, and the JAX package's own names
    (``vmem``, ``xla``) nowhere."""
    _, ny, nx = (int(s) for s in shape)
    if path == "bitsliced":
        return (allow_bitsliced and _BITSLICE
                and bitlife.fits_vmem_packed((ny, nx)))
    if path == "vmem-grid":
        return on_card and bitlife.fits_vmem_packed((ny, nx))
    if path == "fused":
        return on_card and bitlife.fused_bits_supported((ny, nx))
    if path == "frame":
        return on_card and bitlife.plan_sharded_bits((ny, nx)) is not None
    return path == "plain" and not on_card


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
    (``fits_vmem_bitsliced``) hands boards past about 1000^2 to it.

    An installed tuned plan (:func:`planned_path`) comes first wherever
    :func:`_planned_legal` allows it."""
    b, ny, nx = (int(s) for s in shape)
    planned = planned_path("life", (b, ny, nx))
    if planned is not None and _planned_legal(
            planned, (b, ny, nx), on_card, allow_bitsliced):
        return planned
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
    return run_path_batch(
        native_path_batch(boards.shape, on_card=boards.device.type == "cuda"),
        boards, n)


def run_path_batch(path: str, boards: torch.Tensor, n: int) -> torch.Tensor:
    """Advance a (B, ny, nx) stack ``n`` steps on the named batched path,
    whatever the ladder or a plan would pick. Raises ValueError on a name
    that is not a path, and on ``"plain"`` for a stack on the card: no
    caller makes the card run the plain loop."""
    if path == "bitsliced":
        return bitlife.life_run_bitsliced_batch(boards, n)
    if path == "vmem-grid":
        return bitlife.life_run_vmem_bits_batch(boards, n)
    if path == "fused":
        return bitlife.life_run_fused_bits_batch(boards, n)
    if path == "frame":
        return bitlife.life_run_frame_bits_batch(boards, n)
    if path == "plain":
        if boards.device.type == "cuda":
            raise ValueError("the plain batched loop runs on the CPU only; "
                             "a stack on the card takes a kernel path")
        return bitlife.life_run_bits_plain_batch(boards, n)
    raise ValueError(f"unknown life engine path {path!r}")


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
