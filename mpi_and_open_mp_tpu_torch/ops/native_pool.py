"""The resident-session pool's step and lane IO as hand-written kernels.

A pool slab is a board-sliced stack ``(P, ny, nx)`` of int32 words (the
layout of ``ops.bitlife.pack_batch_bits``): bit ``l % 32`` of plane
``l // 32`` holds lane ``l``'s whole board. Three wrappers launch the
entry points of ``csrc/pool_lanes.cu`` on a CUDA slab and run their plain
versions, beside them here, on a CPU slab; neither falls back to the
other, and each counts its launches:

* :func:`pool_step_tail` - one Life step of ``prev``, merged into the slab
  in place under a per-plane lane mask, and the per-plane change word
  ``prev ^ cur`` ORed over both spatial axes (JAX
  ``ops/bitlife.py:lane_change_bits``);
* :func:`pool_lane_write` - one 0/1 board into one lane, in place;
* :func:`pool_lane_read` - one lane as a ``(ny, nx)`` uint8 board.

:func:`pool_step` is a pool dispatch of ``s`` steps:
``ops.bitlife.bitsliced_steps`` (the ``bitlife_bitsliced`` kernel) for the
first ``s - 1`` steps, then one :func:`pool_step_tail`. The JAX package
runs the same masked step as one XLA program that donates the slab
(``mpi_and_open_mp_tpu/serve/pool.py:153-208``); here the slab is updated
in place. Lane masks and change words are int32 tensors whose bits are
JAX's uint32 words (``np.ndarray.view``); lane 31 is the sign bit, and
every right shift of the plain versions is masked (``bitlife._srl``).
"""

from __future__ import annotations

import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.ops.bitlife import (
    _i32, _srl, bitsliced_step, bitsliced_steps)

LIB = "pool_lanes"


def _card_slab(slab: torch.Tensor, name: str) -> None:
    if slab.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU slab, got "
                         f"{slab.device}")
    if (slab.dtype != torch.int32 or slab.dim() != 3
            or not slab.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous (P, ny, nx) int32 "
                         f"slab, got {slab.dtype} {tuple(slab.shape)}")


def _check_lane(slab: torch.Tensor, plane: int, bit: int, name: str) -> None:
    if not 0 <= plane < slab.shape[0] or not 0 <= bit < 32:
        raise ValueError(f"{name}: lane (plane {plane}, bit {bit}) outside "
                         f"a slab of {slab.shape[0]} planes")


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ------------------------------------------------------------ plain versions

def _or_reduce(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR of each row of a 2-D int32 tensor, by halving."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, torch.zeros_like(x[:, :1])], 1)
        x = x[:, 0::2] | x[:, 1::2]
    return x[:, 0]


def lane_change_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P,) int32: bit ``l`` of word ``p`` set iff lane ``l`` of plane ``p``
    differs anywhere between the two (P, ny, nx) slabs - ``a ^ b`` ORed over
    both spatial axes (JAX ``ops/bitlife.py:lane_change_bits``)."""
    return _or_reduce((a ^ b).reshape(a.shape[0], -1))


def _merge(cur: torch.Tensor, slab: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    m = mask[:, None, None]
    return (cur & m) | (slab & ~m)


def _pool_step_tail_plain(prev: torch.Tensor, slab: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    cur = bitsliced_step(prev)
    change = lane_change_bits(prev, cur)
    slab.copy_(_merge(cur, slab, mask))
    return change


def _pool_step_plain(slab: torch.Tensor, steps: int,
                     mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``_pool_step_jit`` as a function: ``(merged slab, change
    word)`` after ``steps`` :func:`ops.bitlife.bitsliced_step` steps of
    every lane, the last pair of consecutive states compared, masked lanes
    taken from the stepped slab. The input is not written."""
    prev = cur = slab
    for _ in range(int(steps)):
        prev, cur = cur, bitsliced_step(cur)
    return _merge(cur, slab, mask), lane_change_bits(prev, cur)


def _lane_write_plain(slab: torch.Tensor, board: torch.Tensor, plane: int,
                      bit: int) -> None:
    word = slab[plane]
    word.copy_((word & _i32(~(1 << bit))) | ((board != 0).to(torch.int32)
                                             << bit))


def _lane_read_plain(slab: torch.Tensor, plane: int,
                     bit: int) -> torch.Tensor:
    row = slab[plane]
    return ((_srl(row, bit) if bit else row) & 1).to(torch.uint8)


# ------------------------------------------------------------------ wrappers

def pool_step_tail(prev: torch.Tensor, slab: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """One step of ``prev`` merged into ``slab`` in place under ``mask``
    ((P,) int32: masked lanes take the step, the others keep their bits);
    returns the change word ``lane_change_bits(prev, step(prev))``, (P,)
    int32. ``prev`` is never written. The ``pool_step_tail`` kernel on the
    card (one launch), the plain version on the CPU."""
    if slab.device.type == "cpu":
        return _pool_step_tail_plain(prev, slab, mask)
    _card_slab(slab, "pool_step_tail")
    _card_slab(prev, "pool_step_tail")
    if prev.shape != slab.shape or prev.device != slab.device:
        raise ValueError(f"pool_step_tail: prev {tuple(prev.shape)} on "
                         f"{prev.device} against a slab "
                         f"{tuple(slab.shape)} on {slab.device}")
    if (mask.dtype != torch.int32 or mask.shape != slab.shape[:1]
            or mask.device != slab.device or not mask.is_contiguous()):
        raise ValueError(f"pool_step_tail: expected a ({slab.shape[0]},) "
                         f"int32 mask on {slab.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    npl, ny, nx = slab.shape
    change = torch.zeros(npl, dtype=torch.int32, device=slab.device)
    lib = _build.load(LIB)
    with torch.cuda.device(slab.device):
        rc = lib.pool_step_tail(prev.data_ptr(), slab.data_ptr(),
                                mask.data_ptr(), change.data_ptr(), npl, ny,
                                nx, _stream())
    pool_step_tail.launches += 1
    _build.check(lib, LIB, rc)
    return change


pool_step_tail.launches = 0


def pool_step(slab: torch.Tensor, steps: int,
              mask: torch.Tensor) -> torch.Tensor:
    """Advance the masked lanes of ``slab`` ``steps`` steps in place (the
    others pass through bit for bit); returns the change word of the last
    step, (P,) int32 on the slab's device. ``bitsliced_steps(slab, steps -
    1)`` gives the state before the last step (a device copy of the slab
    when ``steps`` is 1), then one :func:`pool_step_tail`. No launch at 0
    steps (a zero word)."""
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"pool_step: steps must be >= 0, got {steps}")
    if steps == 0:
        return torch.zeros(slab.shape[0], dtype=torch.int32,
                           device=slab.device)
    prev = bitsliced_steps(slab, steps - 1) if steps > 1 else slab.clone()
    return pool_step_tail(prev, slab, mask)


def pool_lane_write(slab: torch.Tensor, board: torch.Tensor, plane: int,
                    bit: int) -> None:
    """Write one (ny, nx) board (cells 0 or not) into bit ``bit`` of plane
    ``plane`` of ``slab``, in place: the ``pool_lane_write`` kernel on the
    card, the plain version on the CPU."""
    plane, bit = int(plane), int(bit)
    _check_lane(slab, plane, bit, "pool_lane_write")
    if tuple(board.shape) != tuple(slab.shape[1:]):
        raise ValueError(f"pool_lane_write: a {tuple(board.shape)} board "
                         f"for {tuple(slab.shape[1:])} planes")
    if slab.device.type == "cpu":
        _lane_write_plain(slab, board, plane, bit)
        return
    _card_slab(slab, "pool_lane_write")
    if (board.dtype != torch.uint8 or board.device != slab.device
            or not board.is_contiguous()):
        raise ValueError(f"pool_lane_write: expected a contiguous uint8 "
                         f"board on {slab.device}, got {board.dtype} on "
                         f"{board.device}")
    npl, ny, nx = slab.shape
    lib = _build.load(LIB)
    with torch.cuda.device(slab.device):
        rc = lib.pool_lane_write(slab.data_ptr(), board.data_ptr(), npl, ny,
                                 nx, plane, bit, _stream())
    pool_lane_write.launches += 1
    _build.check(lib, LIB, rc)


pool_lane_write.launches = 0


def pool_lane_read(slab: torch.Tensor, plane: int, bit: int) -> torch.Tensor:
    """Bit ``bit`` of plane ``plane`` of ``slab`` as a (ny, nx) uint8
    board on the slab's device: the ``pool_lane_read`` kernel on the card,
    the plain version on the CPU."""
    plane, bit = int(plane), int(bit)
    _check_lane(slab, plane, bit, "pool_lane_read")
    if slab.device.type == "cpu":
        return _lane_read_plain(slab, plane, bit)
    _card_slab(slab, "pool_lane_read")
    npl, ny, nx = slab.shape
    out = torch.empty((ny, nx), dtype=torch.uint8, device=slab.device)
    lib = _build.load(LIB)
    with torch.cuda.device(slab.device):
        rc = lib.pool_lane_read(slab.data_ptr(), out.data_ptr(), npl, ny, nx,
                                plane, bit, _stream())
    pool_lane_read.launches += 1
    _build.check(lib, LIB, rc)
    return out


pool_lane_read.launches = 0
