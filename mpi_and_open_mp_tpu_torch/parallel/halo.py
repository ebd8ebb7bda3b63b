"""Halo (ghost-cell) exchange between the stacked shards of a mesh.

Counterpart of ``mpi_and_open_mp_tpu/parallel/halo.py``, the JAX
package's ``lax.ppermute`` ghost exchange (itself the reference's ghost
``MPI_Send``/``MPI_Recv`` pairs, ``3-life/life_mpi.c:198-209`` for rows,
``4-life/life_mpi.c:197-208`` for strided columns,
``6-cartesian/life_cart.c:225-279`` for the 2-D sequence).

Every ghost exchange takes the stacked shards ``(py, px, *C, h, w)`` of
one device (``parallel.mesh``); :func:`ppermute` and :func:`all_to_all`
also serve the ``"sp"`` stacks of attention operands (ring attention's
K/V rotations and Ulysses' re-shards, ``parallel/context.py``). A ring ``ppermute`` along a mesh axis is one
``torch.roll`` along that axis's shard dimension (:func:`ppermute`), and
the per-shard branches of the JAX package (``lax.axis_index`` under
``jnp.where``) become slices of the first and last shard on the axis
(:func:`_with_shard`). Corners come by sequencing the two axes: pad x
first, then exchange the x-padded rows along y, the reference's
two-phase trick at ``life_cart.c:257-279``.

On a mesh across processes (``parallel.procs``) a stack holds this
process's run of the shards of the spanning axis: :func:`ppermute` shifts
the run and trades the wrapping shards with the neighbouring processes,
:func:`all_to_all` trades blocks in one ``all_to_all_single``,
:func:`axis_size` counts every process's shards, and the shard branches
take global indices through :func:`local_index` (a process without shard
0 or the last shard has no branch to take).

Every exchange passes its incoming top ghost (y) and left ghost (x)
through :func:`_chaos_ghost`, the fault injection of ``robust.chaos``,
where the JAX package's ``_chaos_ghost`` sits; the packed paths wrap the
incoming block only, never the refresh of the last shard's mirror rows or
columns, which is live board state.

Every exchange also passes through :func:`_note_exchange`, the JAX
package's count of exchanges traced (``halo.exchange.traced{kind=...,
axis=...}``, ``obs.metrics``): there once per compiled program, here once
per distinct exchange geometry, so the count never grows with the steps.
"""

from __future__ import annotations

import torch

from mpi_and_open_mp_tpu_torch.obs import metrics
from mpi_and_open_mp_tpu_torch.ops import bitlife
from mpi_and_open_mp_tpu_torch.parallel import procs
from mpi_and_open_mp_tpu_torch.parallel.mesh import AXIS_SP, SHARD_DIM
from mpi_and_open_mp_tpu_torch.robust import chaos


def ring_perm(p: int, shift: int = 1) -> list[tuple[int, int]]:
    """Permutation sending each ring member's value to ``(i + shift) % p``."""
    return [(i, (i + shift) % p) for i in range(p)]


def axis_size(x: torch.Tensor, axis_name: str) -> int:
    """Shards along mesh axis ``axis_name`` of stacked shards ``x``: every
    process's, when the axis spans the processes."""
    w = procs.span(axis_name)
    return x.shape[SHARD_DIM[axis_name]] * (w.procs if w else 1)


def first_shard(x: torch.Tensor, axis_name: str) -> int:
    """The global index on ``axis_name`` of the first shard of ``x``: 0
    unless the axis spans the processes."""
    w = procs.span(axis_name)
    return x.shape[SHARD_DIM[axis_name]] * w.rank if w else 0


def local_index(x: torch.Tensor, axis_name: str, i: int) -> int | None:
    """The index in ``x`` of global shard ``i`` on ``axis_name``, or None
    when another process holds it."""
    j = i - first_shard(x, axis_name)
    return j if 0 <= j < x.shape[SHARD_DIM[axis_name]] else None


def ppermute(x: torch.Tensor, axis_name: str, shift: int) -> torch.Tensor:
    """``lax.ppermute(x, axis_name, ring_perm(p, shift))`` on stacked
    shards: shard ``i`` receives what shard ``i - shift`` holds. One
    ``torch.roll``; on an axis across processes, the shift of this
    process's run and a trade of the wrapping shards with its neighbours
    (``parallel.procs.ring_shift``)."""
    if procs.span(axis_name):
        return procs.ring_shift(x, SHARD_DIM[axis_name], shift)
    return torch.roll(x, shift, SHARD_DIM[axis_name])


def all_to_all(x: torch.Tensor, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)`` on
    a stack of shards along dimension 0 (the ``"sp"`` stacks of
    ``parallel/context.py``): shard ``i`` cuts its axis ``split_axis``
    into p blocks and sends block ``j`` to shard ``j``, which concatenates
    what it receives along ``concat_axis`` in the order of the senders.
    Axes count within a shard, as in the JAX call. One permuted copy; on
    an ``"sp"`` axis across processes, one ``all_to_all_single`` between
    them (:class:`_AllToAll`, differentiable)."""
    if procs.span(AXIS_SP):
        return _AllToAll.apply(x, split_axis, concat_axis)
    p = x.shape[0]
    s, c = split_axis + 1, concat_axis + 1
    shape = list(x.shape)
    if shape[s] % p:
        raise ValueError(f"all_to_all: axis {split_axis} of size {shape[s]} "
                         f"does not split over {p} shards")
    y = x.reshape(*shape[:s], p, shape[s] // p, *shape[s + 1:])
    # (sender, ..., receiver, block, ...) -> (receiver, sender, ...), then
    # the sender just before the concatenated axis, merged into it.
    y = y.movedim(s, 0).movedim(1, c)
    out = list(y.shape)
    return y.reshape(*out[:c], p * out[c + 1], *out[c + 2:])


def _all_to_all_procs(x: torch.Tensor, split_axis: int,
                      concat_axis: int) -> torch.Tensor:
    """:func:`all_to_all` when this process holds ``n`` of the ``p = n *
    P`` shards: block ``j`` of a shard goes to global shard ``j``, so the
    blocks are grouped by the process that holds their receiver and
    traded in one ``all_to_all_single``, then each receiver concatenates
    its blocks in the order of the senders (processes, then shards)."""
    n = x.shape[0]
    P = procs.spanning().procs
    p = n * P
    s, c = split_axis + 1, concat_axis + 1
    shape = list(x.shape)
    if shape[s] % p:
        raise ValueError(f"all_to_all: axis {split_axis} of size {shape[s]} "
                         f"does not split over {p} shards")
    y = x.reshape(*shape[:s], p, shape[s] // p, *shape[s + 1:])
    # (sender, ..., receiver, block, ...) -> (receiver, sender, ...): the
    # receivers of process r are the r-th run of n.
    y = procs.all_to_all(y.movedim(s, 0).contiguous())
    # (P senders' processes x n receivers, n senders, ...) -> (n
    # receivers, P x n senders, ...), then as the one-process form.
    y = y.reshape(P, n, n, *y.shape[2:]).transpose(0, 1)
    y = y.reshape(n, p, *y.shape[3:]).movedim(1, c)
    out = list(y.shape)
    return y.reshape(*out[:c], p * out[c + 1], *out[c + 2:])


class _AllToAll(torch.autograd.Function):
    """The all-to-all across processes, whose backward is the all-to-all
    back (split and concatenated axes swapped)."""

    @staticmethod
    def forward(ctx, x, split_axis, concat_axis):
        ctx.axes = (split_axis, concat_axis)
        return _all_to_all_procs(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all_procs(g.contiguous(), concat_axis,
                                 split_axis), None, None


def _chaos_ghost(ghost: torch.Tensor) -> torch.Tensor:
    """The chaos hook of an incoming ghost block: ``ghost`` itself (the
    same object, nothing launched) unless a ``MOMP_CHAOS`` halo fault is
    active, else the faulted block (``robust.chaos.corrupt_ghost``)."""
    spec = chaos.halo_ghost_spec()
    if spec is None:
        return ghost
    return chaos.corrupt_ghost(ghost, spec)


# The exchange geometries noted so far (kind, axis, shape, dtype, card,
# depth): the port's counterpart of the JAX package's traced programs.
_EXCHANGES: set = set()


def _note_exchange(kind: str, axis_name: str, x: torch.Tensor,
                   depth: int) -> None:
    """Tick ``halo.exchange.traced{kind, axis}`` the first time this
    exchange runs at this geometry: the JAX package ticks it when a
    program that exchanges is traced, so a count of 0 means the sharded
    path never engaged, and a steady run adds nothing."""
    metrics.inc_once(_EXCHANGES, (kind, axis_name, x.shape, x.dtype,
                                  x.is_cuda, depth),
                     "halo.exchange.traced", kind=kind, axis=axis_name)


def _with_shard(x: torch.Tensor, axis_name: str, i: int,
                value: torch.Tensor) -> torch.Tensor:
    """``x`` with its shard ``i`` (an index into ``x``, :func:`local_index`
    of a global one) of axis ``axis_name`` replaced by ``value`` (one shard
    thick along that axis)."""
    dim = SHARD_DIM[axis_name]
    p = x.shape[dim]
    parts = [x.narrow(dim, 0, i)] if i else []
    parts.append(value)
    if i < p - 1:
        parts.append(x.narrow(dim, i + 1, p - 1 - i))
    return torch.cat(parts, dim) if len(parts) > 1 else value


def _shard_of(x: torch.Tensor, axis_name: str, i: int) -> torch.Tensor:
    return x.narrow(SHARD_DIM[axis_name], i, 1)


def halo_pad_y(block: torch.Tensor, axis_name: str = "y",
               depth: int = 1) -> torch.Tensor:
    """Pad the rows (second-to-last axis) of every shard with ``depth``
    ghost rows from its ring neighbours on ``axis_name``: the previous
    shard's last rows on top, the next shard's first rows below. With one
    shard on the axis this is the torus self-wrap. Channel axes ride
    along; any dtype."""
    _note_exchange("y", axis_name, block, depth)
    top = _chaos_ghost(ppermute(block[..., -depth:, :], axis_name, 1))
    bot = ppermute(block[..., :depth, :], axis_name, -1)
    return torch.cat([top, block, bot], dim=-2)


def halo_pad_x(block: torch.Tensor, axis_name: str = "x",
               depth: int = 1) -> torch.Tensor:
    """Pad the columns (last axis) of every shard with ``depth`` ghost
    columns from its ring neighbours: the reference's strided
    ``MPI_Type_vector`` exchange (``4-life/life_mpi.c:106-109``) as a
    slice and a roll."""
    _note_exchange("x", axis_name, block, depth)
    left = _chaos_ghost(ppermute(block[..., -depth:], axis_name, 1))
    right = ppermute(block[..., :depth], axis_name, -1)
    return torch.cat([left, block, right], dim=-1)


def halo_pad_2d(block: torch.Tensor, axis_y: str = "y", axis_x: str = "x",
                depth: int = 1) -> torch.Tensor:
    """Full 2-D halo with corners: columns first, then the rows of the
    x-padded shards, so the row ghosts carry the corner cells
    (``6-cartesian/life_cart.c:275-279``)."""
    return halo_pad_y(halo_pad_x(block, axis_x, depth), axis_y, depth)


def packed_halo_y(e: torch.Tensor, axis_name: str = "y", h: int = 4, *,
                  pad: int = 0) -> torch.Tensor:
    """y halo of bit-packed frame shards (word rows x cell columns).

    ``h`` ghost words per side travel the ring. When the frame carries
    ``pad`` mirror rows (the board height padded to ``32 * nw_s * py``,
    ``ops.bitlife.plan_sharded_bits``), the wrap edges are funnel-shifted
    onto the logical board height: shard 0's top ghost is board rows
    ``[ny - 32h, ny)``, an unaligned range of the last shard, and the last
    shard's bottom ghost starts at board row ``pad``; the last shard also
    refreshes its mirror rows from shard 0's live rows. ``pad == 0`` is
    :func:`halo_pad_y`. With one shard on the axis this is
    ``bitlife.wrap_y_padded``."""
    if pad == 0:
        return halo_pad_y(e, axis_name, h)
    _note_exchange("packed_y", axis_name, e, h)
    s = h + 1 + pad // 32
    up = _chaos_ghost(ppermute(e[..., -s:, :], axis_name, 1))
    dn = ppermute(e[..., :s, :], axis_name, -1)
    # Shard 0 and the last shard, where this process holds them.
    first = local_index(e, axis_name, 0)
    last = local_index(e, axis_name, axis_size(e, axis_name) - 1)
    top = up[..., s - h:, :]
    if first is not None:
        top = _with_shard(top, axis_name, first, bitlife.take_rows(
            _shard_of(up, axis_name, first), 32 * s - pad - 32 * h, h))
    bot = dn[..., :h, :]
    if last is not None:
        dn_last = _shard_of(dn, axis_name, last)
        bot = _with_shard(bot, axis_name, last,
                          bitlife.take_rows(dn_last, pad, h))
        e = _with_shard(e, axis_name, last,
                        bitlife.mirror_tail(_shard_of(e, axis_name, last),
                                            dn_last, pad))
    return torch.cat([top, e, bot], dim=-2)


def packed_halo_x(block: torch.Tensor, axis_name: str = "x", hx: int = 128,
                  *, pad: int = 0) -> torch.Tensor:
    """x halo of packed frame shards, ``hx`` ghost columns per side.

    The column twin of :func:`packed_halo_y`: with ``pad`` mirror columns
    (the board width padded to ``W * px``), shard 0's left ghost skips the
    last shard's mirror columns, the last shard's right ghost starts past
    shard 0's first ``pad`` columns, and the last shard's mirror columns
    are refreshed from shard 0. Packed columns are whole cell columns, so
    there is no funnel, only offset slices. ``pad == 0`` is
    :func:`halo_pad_x`."""
    if pad == 0:
        return halo_pad_x(block, axis_name, hx)
    _note_exchange("packed_x", axis_name, block, hx)
    s = hx + pad
    left = _chaos_ghost(ppermute(block[..., -s:], axis_name, 1))
    right = ppermute(block[..., :s], axis_name, -1)
    first = local_index(block, axis_name, 0)
    last = local_index(block, axis_name, axis_size(block, axis_name) - 1)
    lb = left[..., pad:]
    if first is not None:
        lb = _with_shard(lb, axis_name, first,
                         _shard_of(left, axis_name, first)[..., :hx])
    rb = right[..., :hx]
    if last is not None:
        right_last = _shard_of(right, axis_name, last)
        rb = _with_shard(rb, axis_name, last, right_last[..., pad:pad + hx])
        mirrored = torch.cat([_shard_of(block, axis_name, last)[..., :-pad],
                              right_last[..., :pad]], dim=-1)
        block = _with_shard(block, axis_name, last, mirrored)
    return torch.cat([lb, block, rb], dim=-1)
