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

On a mesh across processes (``parallel.procs``) a stack holds this
process's run of the shards of the spanning axis, and its ring neighbours'
shards lie in other processes. On the card both kernels then read them in
place, through the RDMA rung's windows (``parallel.peers``): a round copies
the run's block (or its fresh edge strips) into this rank's window slot
(one device copy), publishes it (an event, a handshake with the two ring
neighbours, the waits) and launches the unchanged kernel on a table of
element offsets from that slot into its own slot and the neighbours'
(:func:`run_frame_table`, :func:`run_edge_table`, built once per geometry;
:class:`_RunFrameLaunch`, :class:`_RunEdgePair`). No cell goes through host
memory. On a CPU tensor the plain versions cross the processes through
``parallel.halo.ppermute``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.parallel import halo, peers, procs
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
    if procs.span(axis_name):
        out = _run_edge_pair(fwd_edge, bwd_edge, axis_name)
    else:
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
           layout, procs.spanning())
    launch = _FRAME_LAUNCHES.get(key)
    if launch is None:
        _check_frame(block, depth, layout)
        if block.device.type == "cpu":
            return halo_frame_plain(block, depth, layout)
        if len(_FRAME_LAUNCHES) >= MAX_FRAME_LAUNCHES:
            _FRAME_LAUNCHES.clear()
        spans = [a for a in FRAME_RINGS[layout] if procs.span(a)]
        launch = _FRAME_LAUNCHES[key] = (
            _RunFrameLaunch(block, depth, layout, spans[0]) if spans
            else _FrameLaunch(block, depth, layout))
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
        src = self._source(block)
        g = frame_geometry(src, depth)
        if g.shards > MAX_SHARDS or g.channels > MAX_CHANNELS:
            raise ValueError(f"halo_frame: {g.shards} shards of {g.channels} "
                             f"channels, past {MAX_SHARDS} or {MAX_CHANNELS}")
        self.table = self._table(src, layout)
        self.fn = _build.load("halo_frame").halo_frame
        self.args = (self.table.data_ptr(), g.shards, g.channels, g.h, g.w,
                     g.d, g.sc, g.sr, g.sw, block.element_size())

    def _source(self, block: torch.Tensor) -> torch.Tensor:
        """The stack the kernel reads, whose strides the launch takes: the
        block itself."""
        return block

    def _table(self, src: torch.Tensor, layout: str) -> torch.Tensor:
        py, px = src.shape[:2]
        return frame_table(py, px, layout, tuple(src.stride()[:2]),
                           src.device)

    def _src_ptr(self, block: torch.Tensor) -> int:
        """The kernel's source pointer for this round's ``block``."""
        return block.data_ptr()

    def __call__(self, block: torch.Tensor) -> torch.Tensor:
        if not self.empty and self.device.index != torch.cuda.current_device():
            with torch.cuda.device(self.device):
                return self(block)
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        if self.empty:
            return out
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self.fn(self._src_ptr(block), out.data_ptr(), *self.args,
                     stream)
        if rc:
            _build.check(_build.load("halo_frame"), "halo_frame", rc)
        halo_frame.launches += 1
        return out


_FRAME_LAUNCHES: dict[tuple, _FrameLaunch] = {}
halo_frame.launches = 0


# ------------------------------------------------ runs across processes


def _run_geometry(mesh_axes: tuple[int, int], span_axis: str, procs_: int,
                  rank: int):
    """This process's run of a ``mesh_axes`` mesh whose ``span_axis`` is
    cut into ``procs_`` runs: its extents ``(ly, lx)``, the run length ``n``
    and each local shard's global indices ``(gi, gj)``."""
    py, px = mesh_axes
    n = (py if span_axis == "y" else px) // procs_
    ly, lx = (n, px) if span_axis == "y" else (py, n)
    i, j = np.meshgrid(np.arange(ly), np.arange(lx), indexing="ij")
    if span_axis == "y":
        return (ly, lx), n, (i + rank * n, j)
    return (ly, lx), n, (i, j + rank * n)


def _holder(si, sj, span_axis: str, n: int, strides: tuple[int, int]):
    """The rank holding global shard ``(si, sj)`` and its element offset in
    that rank's run (a stack of ``strides``)."""
    if span_axis == "y":
        return si // n, (si % n) * strides[0] + sj * strides[1]
    return sj // n, si * strides[0] + (sj % n) * strides[1]


def run_frame_table(mesh_axes: tuple[int, int], layout: str, span_axis: str,
                    procs_: int, rank: int, shard_strides: tuple[int, int]
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The frame table of process ``rank``'s run (:func:`frame_table`'s
    sources, ``mesh_axes`` the global mesh, ``span_axis`` cut into
    ``procs_`` runs): ``(owners, offsets)``, int64 ``(9, shards of the
    run)``, for local shard ``s = i * lx + j`` in each column the rank that
    holds each of its nine sources and the source's element offset in that
    rank's run (a stack of ``shard_strides``, as the window slot holds
    it)."""
    rings = FRAME_RINGS[layout]
    py, px = mesh_axes
    _, n, (gi, gj) = _run_geometry(mesh_axes, span_axis, procs_, rank)
    owners, offsets = [], []
    for dy, dx in FRAME_SOURCES:
        si = (gi + dy) % py if "y" in rings else gi
        sj = (gj + dx) % px if "x" in rings else gj
        r, off = _holder(si, sj, span_axis, n, shard_strides)
        owners.append(r)
        offsets.append(off)
    return (np.stack(owners).reshape(9, -1).astype(np.int64),
            np.stack(offsets).reshape(9, -1).astype(np.int64))


def run_edge_table(mesh_axes: tuple[int, int], axis_name: str, procs_: int,
                   rank: int, per_shard: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The edge-pair table of process ``rank``'s run along the spanning
    ``axis_name`` (cut into ``procs_`` runs), read-side where
    :func:`_offset_table` is write-side: ``(owners, offsets)``, int64
    ``(2, shards)`` and ``(4, shards)``. For local shard ``t``, row 0 is
    the holder and element offset of its predecessor's forward edge (its
    ``from_prev``), row 1 of its successor's backward edge (its
    ``from_next``), in that rank's window slot, which holds the run's
    forward edges and then its backward edges, ``per_shard`` elements a
    shard; rows 2 and 3 of ``offsets`` are ``t``'s place in the two
    outputs."""
    py, px = mesh_axes
    (ly, lx), n, (gi, gj) = _run_geometry(mesh_axes, axis_name, procs_,
                                          rank)
    local = ly * lx
    strides = (lx * per_shard, per_shard)
    if axis_name == "y":
        pred, succ = ((gi - 1) % py, gj), ((gi + 1) % py, gj)
    else:
        pred, succ = (gi, (gj - 1) % px), (gi, (gj + 1) % px)
    r_prev, o_prev = _holder(*pred, axis_name, n, strides)
    r_next, o_next = _holder(*succ, axis_name, n, strides)
    mine = np.arange(local).reshape(ly, lx) * per_shard
    owners = np.stack([r_prev, r_next]).reshape(2, -1).astype(np.int64)
    offsets = np.stack([o_prev, o_next + local * per_shard, mine, mine])
    return owners, offsets.reshape(4, -1).astype(np.int64)


def _device_table(window: "peers.Window", owners: np.ndarray,
                  offsets: np.ndarray, elem: int,
                  device: torch.device) -> torch.Tensor:
    """``offsets`` (rows of sources first, as many as ``owners`` has) made
    relative to this rank's window slot, on the card."""
    table = offsets.copy()
    k = owners.shape[0]
    table[:k] = window.offsets(owners, offsets[:k], elem)
    return torch.from_numpy(table).to(device)


class _RunFrameLaunch(_FrameLaunch):
    """:func:`halo_frame` over this process's run on the card, the ring
    ``span_axis`` crossing the processes: the kernel reads a window of one
    block a slot (``parallel.peers``) on the run's frame table. A round
    copies the block into the window, publishes it and launches the kernel
    on the slot (module docstring)."""

    def __init__(self, block: torch.Tensor, depth: int, layout: str,
                 span_axis: str):
        self.span_axis = span_axis
        super().__init__(block, depth, layout)

    def _source(self, block: torch.Tensor) -> torch.Tensor:
        nbytes = block.numel() * block.element_size()
        self.window = peers.Window(nbytes, block.device)
        self.slots = [s[:nbytes].view(block.dtype).view(block.shape)
                      for s in self.window.slots]
        return self.slots[0]

    def _table(self, src: torch.Tensor, layout: str) -> torch.Tensor:
        w = procs.span(self.span_axis)
        mesh_axes = (halo.axis_size(src, "y"), halo.axis_size(src, "x"))
        owners, offsets = run_frame_table(mesh_axes, layout, self.span_axis,
                                          w.procs, w.rank,
                                          tuple(src.stride()[:2]))
        return _device_table(self.window, owners, offsets,
                             src.element_size(), src.device)

    def _src_ptr(self, block: torch.Tensor) -> int:
        self.slots[self.window.parity].copy_(block)
        return self.window.publish()


class _RunEdgePair:
    """:func:`edge_pair` along an axis that crosses the processes, on the
    card: a window of the run's forward and backward edges a slot, the
    run's read-side table (:func:`run_edge_table`) on the card and the
    library call's arguments."""

    def __init__(self, fwd_edge: torch.Tensor, axis_name: str):
        w = procs.span(axis_name)
        self.shape, self.dtype = fwd_edge.shape, fwd_edge.dtype
        self.device = fwd_edge.device
        shards = fwd_edge.shape[0] * fwd_edge.shape[1]
        if shards > MAX_SHARDS:
            raise ValueError(f"edge_pair: {shards} shards, past {MAX_SHARDS}")
        nbytes = fwd_edge.numel() * fwd_edge.element_size()
        self.window = peers.Window(2 * nbytes, fwd_edge.device)
        self.slots = [(s[:nbytes].view(self.dtype).view(self.shape),
                       s[nbytes:2 * nbytes].view(self.dtype).view(self.shape))
                      for s in self.window.slots]
        per_shard = fwd_edge[0, 0].numel()
        mesh_axes = (halo.axis_size(fwd_edge, "y"),
                     halo.axis_size(fwd_edge, "x"))
        owners, offsets = run_edge_table(mesh_axes, axis_name, w.procs,
                                         w.rank, per_shard)
        self.table = _device_table(self.window, owners, offsets,
                                   fwd_edge.element_size(), self.device)
        sc, sr, sw = _edge_strides(self.slots[0][0])
        rows, cols = fwd_edge.shape[-2:]
        self.fn = _build.load("halo_edge_pair").halo_edge_pair
        self.args = (self.table.data_ptr(), shards, per_shard, rows, cols,
                     sc, sr, sw, sc, sr, sw, fwd_edge.element_size())

    def __call__(self, fwd_edge: torch.Tensor, bwd_edge: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        fwd_slot, bwd_slot = self.slots[self.window.parity]
        fwd_slot.copy_(fwd_edge)
        bwd_slot.copy_(bwd_edge)
        src = self.window.publish()
        prev_out = torch.empty(self.shape, dtype=self.dtype,
                               device=self.device)
        next_out = torch.empty_like(prev_out)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self.fn(src, src, prev_out.data_ptr(), next_out.data_ptr(),
                     *self.args, stream)
        if rc:
            _build.check(_build.load("halo_edge_pair"), "halo_edge_pair", rc)
        return prev_out, next_out


def _run_edge_pair(fwd_edge: torch.Tensor, bwd_edge: torch.Tensor,
                   axis_name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``halo_edge_pair`` over this process's run (checked by
    the caller, which counts the launch)."""
    if fwd_edge.device.type != "cuda":
        raise ValueError(f"edge_pair: expected a CUDA or CPU tensor, got "
                         f"{fwd_edge.device}")
    if fwd_edge.numel() == 0:
        empty = torch.empty(fwd_edge.shape, dtype=fwd_edge.dtype,
                            device=fwd_edge.device)
        return empty, torch.empty_like(empty)
    key = (fwd_edge.shape, fwd_edge.dtype, fwd_edge.device, axis_name,
           procs.spanning())
    pair = _EDGE_RUNS.get(key)
    if pair is None:
        pair = _EDGE_RUNS[key] = _RunEdgePair(fwd_edge, axis_name)
    with torch.cuda.device(fwd_edge.device):
        return pair(fwd_edge, bwd_edge)


_EDGE_RUNS: dict[tuple, _RunEdgePair] = {}


def _forget_runs() -> None:
    """Drop the launch records of runs across processes (their windows
    close with the run, ``procs.shutdown``)."""
    for key in [k for k, v in _FRAME_LAUNCHES.items()
                if isinstance(v, _RunFrameLaunch)]:
        del _FRAME_LAUNCHES[key]
    _EDGE_RUNS.clear()


procs.at_shutdown(_forget_runs)
