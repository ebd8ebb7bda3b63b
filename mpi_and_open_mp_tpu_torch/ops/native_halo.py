"""The ghost-pair exchange of one mesh axis, as one hand-written kernel.

Counterpart of ``mpi_and_open_mp_tpu/parallel/haloplan.py:_rdma_edge_pair``
(the TPU kernel at ``:286``, which moves both edges of an axis by remote
copy). :func:`edge_pair` takes the forward and backward edges of the
stacked shards ``(py, px, *C, e, w)`` or ``(py, px, *C, h, e)``
(``parallel.mesh``) and returns ``(from_prev, from_next)``: each shard's
ring predecessor's forward edge and its successor's backward edge along
``axis_name``. On a CUDA tensor it launches ``csrc/halo_edge_pair.cu``,
both directions in one launch, reading the edges in place through their
strides; on a CPU tensor it runs the plain version, the two ring
``ppermute`` calls of ``parallel.halo`` (:func:`edge_pair_plain`).

The kernel takes each shard's source and destination from a table of
element offsets, built on the host once per geometry and kept on the card
(:func:`_offset_table`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.parallel import halo
from mpi_and_open_mp_tpu_torch.parallel.mesh import SHARD_DIM

# gridDim.y of the launch: one row of blocks per shard.
MAX_SHARDS = 65535


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


def _edge_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides of the channel, row and column dimensions of a
    stacked edge, its channel axes merged into one; raises where they do
    not merge (a layout that the kernel does not take)."""
    dims = [(n, s) for n, s in zip(t.shape[2:-2], t.stride()[2:-2]) if n != 1]
    sc = dims[-1][1] if dims else 0
    inner = 1
    for n, s in reversed(dims):
        if s != sc * inner:
            raise ValueError(
                f"edge_pair: the channel axes of an edge of shape "
                f"{tuple(t.shape)} and strides {t.stride()} do not merge")
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
