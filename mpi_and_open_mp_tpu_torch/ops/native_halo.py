"""The RDMA rung's ghost moves, as two hand-written kernels.

Both are counterparts of ``mpi_and_open_mp_tpu/parallel/haloplan.py:
_rdma_edge_pair`` (the TPU kernel at ``:286``, which moves both edges of an
axis by remote copy).

:func:`halo_frame` takes the stacked shards ``(py, px, *C, h, w)``
(``parallel.mesh``) and returns every shard's ghost-padded frame ``(py,
px, *C, h + 2d, w + 2d)``, corners included: what the TPU kernel's rounds
deliver once both rings' edges have landed beside each shard's cells. On
a CUDA tensor it is one launch of ``csrc/halo_frame.cu``; on a CPU tensor
the plain version, ``parallel.haloplan.padded_round_block``
(:func:`halo_frame_plain`). The rung's coupled rounds take it.

:func:`edge_pair` takes the forward and backward edges of the
stacked shards ``(py, px, *C, e, w)`` or ``(py, px, *C, h, e)``
(``parallel.mesh``) and returns ``(from_prev, from_next)``: each shard's
ring predecessor's forward edge and its successor's backward edge along
``axis_name``. On a CUDA tensor it launches ``csrc/halo_edge_pair.cu``,
both directions in one launch, reading the edges in place through their
strides; on a CPU tensor it runs the plain version, the two ring
``ppermute`` calls of ``parallel.halo`` (:func:`edge_pair_plain`).

Each kernel takes each shard's sources from a table of element offsets,
built on the host once per geometry and kept on the card
(:func:`_offset_table`, :func:`frame_table`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.parallel import halo
from mpi_and_open_mp_tpu_torch.parallel.mesh import SHARD_DIM

# gridDim.y of the launch: one row of blocks per shard (both kernels);
# gridDim.z of the frame kernel: one layer of blocks per channel.
MAX_SHARDS = 65535
MAX_CHANNELS = 65535
# Output rows of one frame-kernel block: one warp a row, eight warps.
FRAME_BAND_ROWS = 8
# Launch records kept (one per block geometry; a run uses a few).
MAX_FRAME_LAUNCHES = 256
# The (dy, dx) of each of a shard's nine sources, in the order of the
# frame table's rows: the shard above-left, above, above-right, ..., below-
# right; (0, 0) is the shard itself.
FRAME_SOURCES = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
# Which rings each layout exchanges over; its other axis wraps locally (a
# 1-shard ring whatever the mesh holds).
FRAME_RINGS = {"row": ("y",), "col": ("x",), "cart": ("y", "x")}


def edge_pair_plain(fwd_edge: torch.Tensor, bwd_edge: torch.Tensor,
                    axis_name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: ``(ppermute(fwd, +1), ppermute(bwd,
    -1))`` along ``axis_name``."""
    return (halo.ppermute(fwd_edge, axis_name, 1),
            halo.ppermute(bwd_edge, axis_name, -1))


def _check(fwd_edge: torch.Tensor, bwd_edge: torch.Tensor,
           axis_name: str) -> None:
    if axis_name not in SHARD_DIM:
        raise ValueError(f"edge_pair: axis must be 'y' or 'x', got "
                         f"{axis_name!r}")
    if fwd_edge.dim() < 4:
        raise ValueError(f"edge_pair: expected stacked shard edges (py, px, "
                         f"*C, rows, cols), got {tuple(fwd_edge.shape)}")
    if (fwd_edge.shape != bwd_edge.shape or fwd_edge.dtype != bwd_edge.dtype
            or fwd_edge.device != bwd_edge.device):
        raise ValueError(
            f"edge_pair: the two edges differ: {tuple(fwd_edge.shape)} "
            f"{fwd_edge.dtype} on {fwd_edge.device} against "
            f"{tuple(bwd_edge.shape)} {bwd_edge.dtype} on {bwd_edge.device}")


def edge_pair(fwd_edge: torch.Tensor, bwd_edge: torch.Tensor,
              axis_name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(from_prev, from_next)`` along ``axis_name``: the
    ``halo_edge_pair`` kernel on the card (one launch), :func:`edge_pair_plain`
    on the CPU. The outputs are contiguous, of the edges' shape and dtype."""
    _check(fwd_edge, bwd_edge, axis_name)
    if fwd_edge.device.type == "cpu":
        return edge_pair_plain(fwd_edge, bwd_edge, axis_name)
    out = _launch(fwd_edge, bwd_edge, axis_name)
    if fwd_edge.numel():
        edge_pair.launches += 1
    return out


def _edge_strides(t: torch.Tensor, what: str = "edge_pair: an edge"
                  ) -> tuple[int, int, int]:
    """Element strides of the channel, row and column dimensions of a
    stacked edge (or block), its channel axes merged into one; raises
    where they do not merge (a layout that the kernels do not take)."""
    dims = [(n, s) for n, s in zip(t.shape[2:-2], t.stride()[2:-2]) if n != 1]
    sc = dims[-1][1] if dims else 0
    inner = 1
    for n, s in reversed(dims):
        if s != sc * inner:
            raise ValueError(
                f"{what} of shape {tuple(t.shape)} and strides {t.stride()}: "
                "its channel axes do not merge")
        inner *= n
    return sc, t.stride(-2), t.stride(-1)


@functools.lru_cache(maxsize=256)
def _offset_table(py: int, px: int, axis_name: str,
                  fwd_strides: tuple[int, int], bwd_strides: tuple[int, int],
                  per_shard: int, device: torch.device) -> torch.Tensor:
    """int64 ``(4, py * px)`` on ``device``, shard ``s = i * px + j`` in
    each row: the forward and backward edges' element offsets from their
    base pointers, then the offsets in ``from_prev`` (the successor's slot)
    and ``from_next`` (the predecessor's slot) that receive them."""
    i, j = np.meshgrid(np.arange(py), np.arange(px), indexing="ij")
    if axis_name == "y":
        succ = ((i + 1) % py) * px + j
        pred = ((i - 1) % py) * px + j
    else:
        succ = i * px + (j + 1) % px
        pred = i * px + (j - 1) % px
    table = np.stack([i * fwd_strides[0] + j * fwd_strides[1],
                      i * bwd_strides[0] + j * bwd_strides[1],
                      succ * per_shard, pred * per_shard]).reshape(4, -1)
    return torch.from_numpy(table.astype(np.int64)).to(device)


def _launch(fwd_edge: torch.Tensor, bwd_edge: torch.Tensor,
            axis_name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on the card (checked by the caller, which
    counts the launch)."""
    if fwd_edge.device.type != "cuda":
        raise ValueError(f"edge_pair: expected a CUDA or CPU tensor, got "
                         f"{fwd_edge.device}")
    py, px = fwd_edge.shape[:2]
    prev_out = torch.empty(fwd_edge.shape, dtype=fwd_edge.dtype,
                           device=fwd_edge.device)
    next_out = torch.empty_like(prev_out)
    if fwd_edge.numel() == 0:
        return prev_out, next_out
    if py * px > MAX_SHARDS:
        raise ValueError(f"edge_pair: {py * px} shards, past {MAX_SHARDS}")
    per_shard = fwd_edge[0, 0].numel()
    f_sc, f_sr, f_sw = _edge_strides(fwd_edge)
    b_sc, b_sr, b_sw = _edge_strides(bwd_edge)
    table = _offset_table(py, px, axis_name, tuple(fwd_edge.stride()[:2]),
                          tuple(bwd_edge.stride()[:2]), per_shard,
                          fwd_edge.device)
    rows, cols = fwd_edge.shape[-2:]
    lib = _build.load("halo_edge_pair")
    with torch.cuda.device(fwd_edge.device):
        rc = lib.halo_edge_pair(
            fwd_edge.data_ptr(), bwd_edge.data_ptr(), prev_out.data_ptr(),
            next_out.data_ptr(), table.data_ptr(), py * px, per_shard, rows,
            cols, f_sc, f_sr, f_sw, b_sc, b_sr, b_sw,
            fwd_edge.element_size(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "halo_edge_pair", rc)
    return prev_out, next_out


edge_pair.launches = 0


# ------------------------------------------------------------ the frame


def halo_frame_plain(block: torch.Tensor, depth: int,
                     layout: str) -> torch.Tensor:
    """The frame kernel's plain version, the sequential round's padded
    shards (``parallel.haloplan.padded_round_block``): ``row``'s x axis
    and ``col``'s y axis wrap locally, the sharded axes exchange over
    their rings, x before y on ``cart`` so that the rows carry the
    corners."""
    d = depth
    if layout == "row":
        wrapped = torch.cat([block[..., -d:], block, block[..., :d]], dim=-1)
        return halo.halo_pad_y(wrapped, "y", d)
    if layout == "col":
        wrapped = torch.cat([block[..., -d:, :], block, block[..., :d, :]],
                            dim=-2)
        return halo.halo_pad_x(wrapped, "x", d)
    return halo.halo_pad_2d(block, "y", "x", d)


def _check_frame(block: torch.Tensor, depth: int, layout: str) -> None:
    if layout not in FRAME_RINGS:
        raise ValueError(f"halo_frame: layout must be one of "
                         f"{tuple(FRAME_RINGS)}, got {layout!r}")
    if block.dim() < 4:
        raise ValueError(f"halo_frame: expected stacked shards (py, px, *C, "
                         f"h, w), got {tuple(block.shape)}")
    h, w = block.shape[-2:]
    if not 1 <= depth <= min(h, w):
        # Past a shard's extent the ring slices clamp, and the padded
        # round would silently build a frame of the wrong shape.
        raise ValueError(f"halo_frame: depth {depth} outside [1, {min(h, w)}]"
                         f" for shards of {h} x {w} (a ghost band deeper "
                         "than a shard is not one neighbour's cells)")


def halo_frame(block: torch.Tensor, depth: int, layout: str) -> torch.Tensor:
    """Every shard's ghost-padded frame ``(py, px, *C, h + 2 depth, w + 2
    depth)``, contiguous, of ``block``'s dtype: the ``halo_frame`` kernel
    on the card (one launch), :func:`halo_frame_plain` on the CPU. Refuses
    a depth below 1 or past a shard's extent."""
    key = (block.shape, block.stride(), block.dtype, block.device, depth,
           layout)
    launch = _FRAME_LAUNCHES.get(key)
    if launch is None:
        _check_frame(block, depth, layout)
        if block.device.type == "cpu":
            return halo_frame_plain(block, depth, layout)
        if len(_FRAME_LAUNCHES) >= MAX_FRAME_LAUNCHES:
            _FRAME_LAUNCHES.clear()
        launch = _FRAME_LAUNCHES[key] = _FrameLaunch(block, depth, layout)
    return launch(block)


def frame_table(py: int, px: int, layout: str, shard_strides: tuple[int, int],
                device: torch.device) -> torch.Tensor:
    """int64 ``(9, py * px)``: for shard ``s = i * px + j`` in each column,
    the element offsets of its nine sources (:data:`FRAME_SOURCES`) from
    the block's base pointer: shard ``(i + dy, j + dx)`` modulo the ring
    on each axis ``layout`` exchanges over, shard ``(i, j)`` itself on
    the axis it wraps locally."""
    rings = FRAME_RINGS[layout]
    i, j = np.meshgrid(np.arange(py), np.arange(px), indexing="ij")
    rows = []
    for dy, dx in FRAME_SOURCES:
        si = (i + dy) % py if "y" in rings else i
        sj = (j + dx) % px if "x" in rings else j
        rows.append(si * shard_strides[0] + sj * shard_strides[1])
    table = np.stack(rows).reshape(9, -1).astype(np.int64)
    return torch.from_numpy(table).to(device)


@dataclasses.dataclass(frozen=True)
class FrameGeometry:
    """One frame launch's geometry: the merged channels, a shard's
    extent, the depth, the block's element strides (channel, row,
    column) and the grid: bands of :data:`FRAME_BAND_ROWS` output rows,
    shards, channels."""

    shards: int
    channels: int
    h: int
    w: int
    d: int
    sc: int
    sr: int
    sw: int
    grid: tuple[int, int, int]


def frame_geometry(block: torch.Tensor, depth: int) -> FrameGeometry:
    """The launch geometry of :func:`halo_frame` for ``block`` (checked by
    the caller)."""
    py, px = block.shape[:2]
    h, w = block.shape[-2:]
    channels = int(np.prod(block.shape[2:-2], dtype=np.int64))
    sc, sr, sw = _edge_strides(block, "halo_frame: a block")
    bands = -(-(h + 2 * depth) // FRAME_BAND_ROWS)
    return FrameGeometry(py * px, channels, h, w, depth, sc, sr, sw,
                         (bands, py * px, channels))


class _FrameLaunch:
    """One launch record of :func:`halo_frame` per (shape, strides,
    dtype, device, depth, layout): the source table on the card, the
    output shape and the library call's arguments, so that a round costs
    one ``torch.empty`` and one library call."""

    def __init__(self, block: torch.Tensor, depth: int, layout: str):
        if block.device.type != "cuda":
            raise ValueError(f"halo_frame: expected a CUDA or CPU tensor, "
                             f"got {block.device}")
        self.shape = (*block.shape[:-2], block.shape[-2] + 2 * depth,
                      block.shape[-1] + 2 * depth)
        self.dtype, self.device = block.dtype, block.device
        self.empty = block.numel() == 0
        if self.empty:
            return
        if block.element_size() not in (1, 2, 4, 8):
            raise ValueError(f"halo_frame: elements of 1, 2, 4 or 8 bytes, "
                             f"got {block.dtype}")
        g = frame_geometry(block, depth)
        if g.shards > MAX_SHARDS or g.channels > MAX_CHANNELS:
            raise ValueError(f"halo_frame: {g.shards} shards of {g.channels} "
                             f"channels, past {MAX_SHARDS} or {MAX_CHANNELS}")
        py, px = block.shape[:2]
        self.table = frame_table(py, px, layout, tuple(block.stride()[:2]),
                                 block.device)
        self.fn = _build.load("halo_frame").halo_frame
        self.args = (self.table.data_ptr(), g.shards, g.channels, g.h, g.w,
                     g.d, g.sc, g.sr, g.sw, block.element_size())

    def __call__(self, block: torch.Tensor) -> torch.Tensor:
        if not self.empty and self.device.index != torch.cuda.current_device():
            with torch.cuda.device(self.device):
                return self(block)
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        if self.empty:
            return out
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self.fn(block.data_ptr(), out.data_ptr(), *self.args, stream)
        if rc:
            _build.check(_build.load("halo_frame"), "halo_frame", rc)
        halo_frame.launches += 1
        return out


_FRAME_LAUNCHES: dict[tuple, _FrameLaunch] = {}
halo_frame.launches = 0
