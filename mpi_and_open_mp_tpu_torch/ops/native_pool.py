"""The resident-session pool's masked step and lane IO as hand-written
kernels.

A pool slab is a board-sliced stack ``(P, ny, nx)`` of int32 words (the
layout of ``ops.bitlife.pack_batch_bits``): bit ``l % 32`` of plane
``l // 32`` holds lane ``l``'s whole board. Three wrappers launch their
kernels on a CUDA slab and run their plain versions, beside them here, on
a CPU slab; neither falls back to the other, and each counts its launches:

* :func:`pool_step` - a pool dispatch of ``s`` steps, JAX's
  ``_pool_step_jit`` (``mpi_and_open_mp_tpu/serve/pool.py:169-189``): the
  masked lanes stepped, the others passed through, and the per-plane change
  word of the last step (JAX ``ops/bitlife.py:lane_change_bits``). On the
  card one ``bitlife_bitsliced_pool`` call (``csrc/bitlife_bitsliced.cu``):
  row 5's kernel in ``plan_bitsliced(shape).launches(s)`` launches, the
  last in its tail mode, which merges and ORs the change word as it writes
  back; nothing else runs but a memset of the change word;
* :func:`pool_lane_write` - one board (cells 0 or not) into one lane, in
  place (``csrc/pool_lanes.cu``);
* :func:`pool_lane_read` - one lane as a ``(ny, nx)`` uint8 board (the
  same source).

On the card the lane kernels take the board where it lies, in page-locked
host memory: the write reads it and the read writes it across PCIe inside
its one launch, through the buffer's mapped device pointer. A pageable or
device board raises ``ValueError``; nothing stages it.

Like JAX, which donates the slab and rebinds it, :func:`pool_step`
returns a new slab and leaves its input unwritten. Lane masks and change
words are int32 tensors whose bits are JAX's uint32 words
(``np.ndarray.view``); lane 31 is the sign bit, and every right shift of
the plain versions is masked (``bitlife._srl``).
"""

from __future__ import annotations

import ctypes

import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.ops.bitlife import (
    _i32, _srl, bitsliced_step, bitsliced_steps, plan_bitsliced)

LIB = "pool_lanes"
STEP_LIB = "bitlife_bitsliced"
# pool_lanes.cu's kErrHost: the board is not page-locked memory the card
# can map.
_ERR_HOST = -4


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


def _host_board(board, shape: tuple, name: str) -> None:
    """Refuse what the lane kernels cannot reach: anything but a
    contiguous page-locked host uint8 board of ``shape``."""
    if not isinstance(board, torch.Tensor):
        got = type(board).__name__
    else:
        if (board.device.type == "cpu" and board.dtype == torch.uint8
                and tuple(board.shape) == shape and board.is_contiguous()
                and board.is_pinned()):
            return
        got = f"{board.dtype} {tuple(board.shape)} on {board.device}"
        if board.device.type == "cpu" and not board.is_pinned():
            got += ", pageable"
    raise ValueError(f"{name}: on the card the board is a contiguous "
                     f"page-locked host uint8 tensor of {shape}, got {got}")


def _lane_launch(fn, slab: torch.Tensor, board: torch.Tensor, plane: int,
                 bit: int) -> None:
    """Launch the lane kernel of wrapper ``fn`` (its entry point has its
    name) and count it in ``fn.launches``."""
    name = fn.__name__
    npl, ny, nx = slab.shape
    lib = _build.load(LIB)
    with torch.cuda.device(slab.device):
        rc = getattr(lib, name)(slab.data_ptr(), board.data_ptr(), npl, ny,
                                nx, plane, bit, _stream())
    if rc == _ERR_HOST:
        raise ValueError(f"{name}: the host board is not page-locked memory "
                         "mapped for the card")
    fn.launches += 1
    _build.check(lib, LIB, rc)


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

def pool_step(slab: torch.Tensor, steps: int, mask: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance the lanes of ``slab`` that ``mask`` ((P,) int32) sets
    ``steps`` steps; the others pass through bit for bit. Returns ``(new
    slab, change word)``: the change word, (P,) int32, ORs the last step's
    old ^ new over each plane (a lane's bit is clear iff its last step
    changed nothing). The input is never written. At 0 steps the input and
    a zero word, no launch. On the card one ``bitlife_bitsliced_pool``
    call in ``plan_bitsliced(slab.shape).launches(steps)`` launches,
    counted in :attr:`launches` and in ``bitsliced_steps.launches`` (the
    kernel is row 5's), each call in :attr:`dispatches`; on the CPU the
    plain version."""
    steps = int(steps)
    if steps < 0:
        raise ValueError(f"pool_step: steps must be >= 0, got {steps}")
    if steps == 0:
        return slab, torch.zeros(slab.shape[0], dtype=torch.int32,
                                 device=slab.device)
    if slab.device.type == "cpu":
        return _pool_step_plain(slab, steps, mask)
    _card_slab(slab, "pool_step")
    if (mask.dtype != torch.int32 or mask.shape != slab.shape[:1]
            or mask.device != slab.device or not mask.is_contiguous()):
        raise ValueError(f"pool_step: expected a ({slab.shape[0]},) int32 "
                         f"mask on {slab.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    npl, ny, nx = slab.shape
    geo = plan_bitsliced((npl, ny, nx))
    out = torch.empty_like(slab)
    scratch = torch.empty_like(slab)
    change = torch.empty(npl, dtype=torch.int32, device=slab.device)
    launched = ctypes.c_int(0)
    lib = _build.load(STEP_LIB)
    with torch.cuda.device(slab.device):
        rc = lib.bitlife_bitsliced_pool(
            slab.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            mask.data_ptr(), change.data_ptr(), npl, ny, nx, *geo.args(),
            steps, _stream(), ctypes.byref(launched))
    pool_step.launches += launched.value
    bitsliced_steps.launches += launched.value
    pool_step.dispatches += 1
    _build.check(lib, STEP_LIB, rc)
    return out, change


pool_step.launches = 0
pool_step.dispatches = 0


def pool_lane_write(slab: torch.Tensor, board: torch.Tensor, plane: int,
                    bit: int) -> None:
    """Write one (ny, nx) board (cells 0 or not) into bit ``bit`` of plane
    ``plane`` of ``slab``, in place. On a CUDA slab the board is a
    page-locked host uint8 tensor, which the ``pool_lane_write`` kernel
    reads across PCIe (one launch, counted in :attr:`launches`; the board
    must not be rewritten before the stream passes the launch); on a CPU
    slab the plain version, any board."""
    plane, bit = int(plane), int(bit)
    _check_lane(slab, plane, bit, "pool_lane_write")
    if tuple(board.shape) != tuple(slab.shape[1:]):
        raise ValueError(f"pool_lane_write: a {tuple(board.shape)} board "
                         f"for {tuple(slab.shape[1:])} planes")
    if slab.device.type == "cpu":
        _lane_write_plain(slab, board, plane, bit)
        return
    _card_slab(slab, "pool_lane_write")
    _host_board(board, tuple(slab.shape[1:]), "pool_lane_write")
    _lane_launch(pool_lane_write, slab, board, plane, bit)


pool_lane_write.launches = 0


def pool_lane_read(slab: torch.Tensor, plane: int, bit: int,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Bit ``bit`` of plane ``plane`` of ``slab`` as a (ny, nx) uint8
    board. On a CUDA slab the ``pool_lane_read`` kernel writes it across
    PCIe into ``out``, a page-locked host uint8 tensor the caller passes
    (one launch, counted in :attr:`launches`; ``out`` holds the board once
    the stream passes the launch); on a CPU slab the plain version, into
    ``out`` where one is given. Returns the board."""
    plane, bit = int(plane), int(bit)
    _check_lane(slab, plane, bit, "pool_lane_read")
    if slab.device.type == "cpu":
        got = _lane_read_plain(slab, plane, bit)
        return got if out is None else out.copy_(got)
    _card_slab(slab, "pool_lane_read")
    if out is None:
        raise ValueError("pool_lane_read: on the card the board is read into "
                         "a page-locked host uint8 tensor `out`")
    _host_board(out, tuple(slab.shape[1:]), "pool_lane_read")
    _lane_launch(pool_lane_read, slab, out, plane, bit)
    return out


pool_lane_read.launches = 0
