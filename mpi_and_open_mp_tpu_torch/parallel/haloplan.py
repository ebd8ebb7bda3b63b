"""Persistent halo plans: the interior/boundary overlap schedule.

Counterpart of ``mpi_and_open_mp_tpu/parallel/haloplan.py``. A frozen
:class:`HaloPlan`, derived once per (layout, mesh, shard shape, depth,
pack layout), splits each fused round of ``k`` steps (ghost depth ``d =
k * radius``) into

* an interior partition - rows ``[d, h - d)`` of each shard (columns for
  ``col``), computable from local cells alone: ``k`` steps of the raw
  shard, each consuming ``radius`` per side; and
* a boundary partition - two depth-``d`` edge strips, each computed from
  a ``3d``-deep extension ``cat([ghost, edge_2d])`` once the ghosts are
  there.

The boundary may itself be partitioned (``boundary_steps <
fuse_steps``): each edge strip advances in ``boundary_steps``-deep
sub-rounds, each sub-round's ghosts cut from the neighbour strip's fresh
cells. Interior and boundary apply the same per-cell arithmetic to the
same neighbourhoods as the sequential round, so the reassembled shards
equal it bit for bit (and value for value for floats).

The overlap is a schedule, not a different result. On the port's stacked
shards (``parallel.mesh``) the ghost moves and the three partitions run
one after another on the current stream; running the ghost copies on a
side stream beside the interior is later work (ROADMAP Queue 1 item 3).

Engine stamps, as the JAX package's:

* ``overlap:deferred`` - the ghosts move by ring ``ppermute`` (two
  ``torch.roll`` copies a pair), every device;
* ``overlap:rdma`` - ``MOMP_HALO_RDMA=1`` on shards that live on a CUDA
  device (:func:`on_card`, the counterpart of the JAX package's
  ``jax.default_backend() == "tpu"``): a coupled round's ghosts come as
  one launch of the hand-written ``csrc/halo_frame.cu``
  (:func:`_rdma_frame`), every shard's ghost-padded frame with the
  diagonal corners read from the diagonal shard, and the round's three
  partitions are slices of it; a partitioned sub-round moves each edge
  pair through one launch of ``csrc/halo_edge_pair.cu``
  (:func:`_rdma_edge_pair`). On a mesh across processes the stack is this
  process's run, and the same two kernels read the ring neighbours' shards
  in their device memory through CUDA IPC windows (``parallel.peers``,
  ``ops/native_halo.py``): a round copies the run's block or fresh edges
  into this rank's window, trades one host token with each ring neighbour
  and waits on their events, then launches; no cell goes through host
  memory, as the JAX package's remote copies reach other processes'
  devices on a multi-host slice. Off the card the flag gives
  ``overlap:deferred``, as the JAX package off a TPU (on a mesh across
  processes too: the JAX package's two-process CPU run stamps
  ``overlap:deferred`` under the flag);
* ``...:pb{b}`` - suffix on either stamp when the boundary is partitioned
  at ``boundary_steps = b < fuse_steps``;
* ``overlap:packed`` - the bit-packed twin
  (``ops.bitlife.make_overlap_steppers``), whatever the RDMA flag says;
* ``seq:halo`` / ``seq:packed`` - the sequential round, with the reason
  in :attr:`HaloPlan.why`.

``MOMP_HALO_OVERLAP=0`` is the kill switch. Both flags are read when a plan
is made and are part of the cache key, with whether the shards are on the
card.

Every ghost pair passes its top (y) or left (x) ghost through
``halo._chaos_ghost``, where the JAX package's schedules call it. On the
rung's frame (:func:`_rdma_frame`) the hook fills the rows and columns
those ghosts would fill: the first ``depth`` rows of a frame that carries
the y ring (row, cart), the first ``depth`` columns of one that carries
the x ring (col, cart); on cart that is also where the JAX package's
corner forwarding carries its faulted ghosts. With no halo fault active the
hook is one check on the host and the frame is returned as it came.

Counts (``obs.metrics``): ``halo.schedule.traced{engine=...,layout=...}``
ticks when a plan is built (:func:`_note_schedule`; the JAX package ticks
it when a round's program is traced), and the deferred ghost pairs note
their exchanges as ``halo._note_exchange`` does (``y-overlap``,
``x-overlap``, ``packed_y-overlap``, ``y-part``, ``x-part``), once per
geometry.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import torch

from mpi_and_open_mp_tpu_torch.obs import metrics
from mpi_and_open_mp_tpu_torch.ops import native_halo
from mpi_and_open_mp_tpu_torch.parallel import halo
from mpi_and_open_mp_tpu_torch.robust import chaos

ENV_OVERLAP = "MOMP_HALO_OVERLAP"
ENV_RDMA = "MOMP_HALO_RDMA"

LAYOUTS = ("row", "col", "cart")


def overlap_enabled() -> bool:
    """The ``MOMP_HALO_OVERLAP`` kill switch (default on)."""
    return os.environ.get(ENV_OVERLAP, "1") != "0"


def rdma_requested() -> bool:
    """Whether ``MOMP_HALO_RDMA=1`` asks for the remote-copy ghost rung
    (default off)."""
    return os.environ.get(ENV_RDMA, "0") == "1"


def on_card(device) -> bool:
    """Whether shards on ``device`` can take the RDMA rung: a CUDA device.
    The tests fake the card by replacing this predicate."""
    return device is not None and torch.device(device).type == "cuda"


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """One (mesh, shard shape, depth, pack layout) exchange schedule,
    derived once and reused every round."""

    layout: str                  # row | col | cart
    mesh_axes: tuple[int, int]   # (py, px) mesh axis sizes
    shard_shape: tuple[int, int] # local (h, w) cell extent per shard
    radius: int
    fuse_steps: int
    boundary_steps: int          # edge sub-round depth; == fuse_steps
                                 # for the coupled (one-exchange) round
    channels: int
    pack_layout: str             # "cell" | "packed"
    depth: int                   # radius * fuse_steps, ghost cells/side
    overlap: bool                # interior/boundary schedule active
    engine: str                  # provenance stamp (module docstring)
    why: str                     # reason overlap was declined ("" if on)


def _overlap_axis(layout: str) -> str:
    """The axis whose exchange the plan overlaps: y for ``row`` and
    ``cart`` (cart's x exchange stays sequential on the deferred path: its
    ghosts feed the y ghosts' corners; the RDMA rung's frame carries both),
    x for ``col``."""
    return "x" if layout == "col" else "y"


def _note_schedule(plan: HaloPlan) -> HaloPlan:
    """Tick ``halo.schedule.traced{engine, layout}`` for a plan just built
    (module docstring): no overlap tick means the overlap path never
    engaged."""
    metrics.inc("halo.schedule.traced", engine=plan.engine,
                layout=plan.layout)
    return plan


@functools.lru_cache(maxsize=512)
def _plan(*key) -> HaloPlan:
    """The plan of one geometry, built and counted once."""
    return _note_schedule(_derive_plan(*key))


def _derive_plan(layout: str, mesh_axes: tuple[int, int],
                 shard_shape: tuple[int, int], radius: int,
                 fuse_steps: int, boundary_steps: int, channels: int,
                 pack_layout: str, enabled: bool, rdma: bool,
                 card: bool) -> HaloPlan:
    depth = radius * fuse_steps
    py, px = mesh_axes
    h, w = shard_shape
    axis = _overlap_axis(layout)
    shards = py if axis == "y" else px
    extent = h if axis == "y" else w

    def seq(why: str) -> HaloPlan:
        stamp = "seq:packed" if pack_layout == "packed" else "seq:halo"
        return HaloPlan(layout, mesh_axes, shard_shape, radius,
                        fuse_steps, fuse_steps, channels, pack_layout,
                        depth, False, stamp, why)

    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if (boundary_steps < 1 or boundary_steps > fuse_steps
            or fuse_steps % boundary_steps):
        raise ValueError(
            f"boundary_steps={boundary_steps} must divide "
            f"fuse_steps={fuse_steps}")
    if pack_layout == "packed" and boundary_steps != fuse_steps:
        raise ValueError(
            "packed frames keep the coupled boundary depth "
            "(boundary_steps == fuse_steps)")
    if not enabled:
        return seq(f"{ENV_OVERLAP}=0")
    if shards <= 1:
        return seq(f"1-shard {axis} axis: nothing to overlap")
    if extent <= 2 * depth:
        return seq(
            f"shard {axis} extent {extent} <= 2*depth {2 * depth}: "
            "empty interior")
    if pack_layout == "packed":
        engine = "overlap:packed"
    elif rdma and card:
        engine = "overlap:rdma"
    else:
        engine = "overlap:deferred"
    if boundary_steps != fuse_steps:
        engine += f":pb{boundary_steps}"
    return HaloPlan(layout, mesh_axes, shard_shape, radius, fuse_steps,
                    boundary_steps, channels, pack_layout, depth, True,
                    engine, "")


def plan_halo(layout: str, mesh_axes: tuple[int, int],
              shard_shape: tuple[int, int], radius: int,
              fuse_steps: int = 1, *, boundary_steps: int | None = None,
              channels: int = 1, pack_layout: str = "cell",
              device: str | torch.device | None = None) -> HaloPlan:
    """Derive (or fetch) the persistent plan for one geometry of shards
    on ``device``. The kill switch, the RDMA opt-in and :func:`on_card`
    are part of the cache key, so flipping ``MOMP_HALO_OVERLAP`` or
    ``MOMP_HALO_RDMA`` mid-process gives a fresh plan. ``boundary_steps``
    (default: coupled, ``== fuse_steps``) must divide ``fuse_steps``."""
    bs = fuse_steps if boundary_steps is None else int(boundary_steps)
    return _plan(layout, tuple(mesh_axes), tuple(shard_shape),
                 int(radius), int(fuse_steps), bs, int(channels),
                 pack_layout, overlap_enabled(), rdma_requested(),
                 on_card(device))


# --------------------------------------------------------------- ghost moves


def ghosts_y(block: torch.Tensor, depth: int, axis_name: str = "y",
             kind: str = "y-overlap") -> tuple[torch.Tensor, torch.Tensor]:
    """The y ghost pair ``(top, bot)``: the slices :func:`halo.halo_pad_y`
    concatenates, without the concatenation (chaos hook on ``top``),
    noted as an exchange of ``kind``."""
    halo._note_exchange(kind, axis_name, block, depth)
    top = halo._chaos_ghost(
        halo.ppermute(block[..., -depth:, :], axis_name, 1))
    bot = halo.ppermute(block[..., :depth, :], axis_name, -1)
    return top, bot


def ghosts_x(block: torch.Tensor, depth: int,
             axis_name: str = "x") -> tuple[torch.Tensor, torch.Tensor]:
    """The x ghost pair ``(left, right)``, :func:`ghosts_y` on the last
    axis (chaos hook on ``left``)."""
    halo._note_exchange("x-overlap", axis_name, block, depth)
    left = halo._chaos_ghost(
        halo.ppermute(block[..., -depth:], axis_name, 1))
    right = halo.ppermute(block[..., :depth], axis_name, -1)
    return left, right


def packed_ghosts_y(q: torch.Tensor, h: int,
                    axis_name: str = "y") -> tuple[torch.Tensor, torch.Tensor]:
    """Packed-frame y ghost pair ``(top, bot)``, ``h`` words per side: the
    deferred form of ``halo.packed_halo_y``'s ``pad == 0`` path (the packed
    overlap is gated to exact frames)."""
    return ghosts_y(q, h, axis_name, "packed_y-overlap")


# ------------------------------------------------ the RDMA rung's transport

# The JAX package's collective ids of the two rings (13 for y, 14 for x).
COLLECTIVE_IDS = {"y": 13, "x": 14}


def _rdma_edge_pair(fwd_edge: torch.Tensor, bwd_edge: torch.Tensor,
                    axis_name: str, p: int, *, collective_id: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One ghost-pair exchange over the ``axis_name`` ring of ``p`` shards:
    ``(from_prev, from_next)``, the predecessor's ``fwd_edge`` and the
    successor's ``bwd_edge`` (``ops.native_halo.edge_pair``: one launch of
    ``halo_edge_pair`` on the card; on a mesh across processes, over this
    process's run, the neighbour ranks' edges read through their windows).
    ``collective_id`` is the JAX package's ring id, checked; here it
    carries no meaning. The partitioned sub-rounds take it: their ghosts
    come from fresh strips, not from a block."""
    if collective_id != COLLECTIVE_IDS.get(axis_name):
        raise ValueError(f"collective_id {collective_id} is not the "
                         f"{axis_name!r} ring's ({COLLECTIVE_IDS})")
    if p != halo.axis_size(fwd_edge, axis_name):
        raise ValueError(f"p={p}, but the edges hold "
                         f"{halo.axis_size(fwd_edge, axis_name)} shards on "
                         f"axis {axis_name!r}")
    return native_halo.edge_pair(fwd_edge, bwd_edge, axis_name)


def _rdma_frame(block: torch.Tensor, plan: HaloPlan, *,
                collective_ids: tuple[int, ...]) -> torch.Tensor:
    """A coupled round's ghost-padded shards by the RDMA transport
    (``ops.native_halo.halo_frame``: one launch of ``halo_frame`` on the
    card), equal to :func:`padded_round_block`: the y ring's ghosts on
    row, the x ring's on col, both and the diagonal corners on cart.
    ``block`` is the stack of every shard, or this process's run of them on
    a mesh across processes (the kernel then reads the neighbour ranks'
    shards through their windows). ``collective_ids`` are the JAX
    package's ids of the rings it carries (``COLLECTIVE_IDS``, y before x),
    checked; here they carry no meaning. The frame takes the place of the
    JAX package's ghost pairs and the concatenations around them; an
    active ``MOMP_CHAOS`` halo fault lands on it as the module docstring
    says, on every shard of the run as on every shard of one process."""
    want = tuple(COLLECTIVE_IDS[a]
                 for a in native_halo.FRAME_RINGS[plan.layout])
    if tuple(collective_ids) != want:
        raise ValueError(f"collective_ids {tuple(collective_ids)} are not "
                         f"the {plan.layout!r} rings' {want}")
    shards = (halo.axis_size(block, "y"), halo.axis_size(block, "x"))
    if shards != plan.mesh_axes:
        raise ValueError(f"the plan's mesh is {plan.mesh_axes}, but the "
                         f"block holds {tuple(block.shape[:2])} shards, "
                         f"{shards} with the other processes' runs")
    frame = native_halo.halo_frame(block, plan.depth, plan.layout)
    spec = chaos.halo_ghost_spec()
    if spec is None:
        return frame
    # The rows and columns the JAX package's faulted ghosts fill (module
    # docstring); the frame is this call's own tensor.
    d, v = plan.depth, chaos.ghost_value(spec)
    rings = native_halo.FRAME_RINGS[plan.layout]
    if "y" in rings:
        frame[..., :d, :] = v
    if "x" in rings:
        frame[..., :, :d] = v
    return frame


# --------------------------------------------------------- fused schedules


def _steps(step_fn, padded: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        padded = step_fn(padded)
    return padded


def _wrap_y(block: torch.Tensor, d: int) -> torch.Tensor:
    return torch.cat([block[..., -d:, :], block, block[..., :d, :]], dim=-2)


def _wrap_x(block: torch.Tensor, d: int) -> torch.Tensor:
    return torch.cat([block[..., -d:], block, block[..., :d]], dim=-1)


def overlap_fused_step(plan: HaloPlan, step_fn, block: torch.Tensor
                       ) -> torch.Tensor:
    """One overlapped fused round of ``k = plan.fuse_steps`` steps over
    the stacked shards ``block``. ``step_fn`` consumes one ``radius`` of
    halo per side per call (``stencils.engine.step_padded``'s contract).
    The ghosts are cut first and consumed last; the three partitions
    reassemble into the sequential round's result."""
    if not plan.overlap:
        return sequential_fused_step(plan, step_fn, block)
    if plan.boundary_steps != plan.fuse_steps:
        return _partitioned_fused_step(plan, step_fn, block)
    k, d = plan.fuse_steps, plan.depth
    if plan.engine.startswith("overlap:rdma"):
        return _rdma_fused_step(plan, step_fn, block)
    if plan.layout == "col":
        # x-mirror of the row schedule: the unsharded y axis wraps itself.
        left, right = ghosts_x(block, d)
        interior = _steps(step_fn, _wrap_y(block, d), k)
        lead = torch.cat([left, block[..., : 2 * d]], dim=-1)
        tail = torch.cat([block[..., -2 * d:], right], dim=-1)
        lead = _steps(step_fn, _wrap_y(lead, d), k)
        tail = _steps(step_fn, _wrap_y(tail, d), k)
        return torch.cat([lead, interior, tail], dim=-1)
    # row / cart: overlap the y exchange. Cart first completes the x
    # exchange (its ghost columns feed the y ghosts' corners); row wraps x
    # locally. Either way `base` carries d ghost columns.
    base = (halo.halo_pad_x(block, "x", d) if plan.layout == "cart"
            else _wrap_x(block, d))
    top, bot = ghosts_y(base, d)
    interior = _steps(step_fn, base, k)
    lead = _steps(step_fn, torch.cat([top, base[..., : 2 * d, :]], dim=-2), k)
    tail = _steps(step_fn, torch.cat([base[..., -2 * d:, :], bot], dim=-2), k)
    return torch.cat([lead, interior, tail], dim=-2)


def _rdma_fused_step(plan: HaloPlan, step_fn, block: torch.Tensor
                     ) -> torch.Tensor:
    """The RDMA rung's coupled round: every ring's ghosts first, as one
    frame (:func:`_rdma_frame`); the interior and the two edge strips the
    deferred schedule builds by concatenation are slices of it, along y
    (row, cart) or x (col). Each strip is the deferred schedule's input,
    so the round equals it bit for bit."""
    k, d = plan.fuse_steps, plan.depth
    frame = _rdma_frame(block, plan, collective_ids=tuple(
        COLLECTIVE_IDS[a] for a in native_halo.FRAME_RINGS[plan.layout]))
    dim = -1 if plan.layout == "col" else -2
    n = block.shape[dim]
    interior = _steps(step_fn, frame.narrow(dim, d, n), k)
    lead = _steps(step_fn, frame.narrow(dim, 0, 3 * d), k)
    tail = _steps(step_fn, frame.narrow(dim, n - d, 3 * d), k)
    return torch.cat([lead, interior, tail], dim=dim)


def _partitioned_fused_step(plan: HaloPlan, step_fn, block: torch.Tensor
                            ) -> torch.Tensor:
    """The partitioned-boundary round: the interior keeps the full ``k``;
    each edge strip advances in ``b = boundary_steps`` sub-rounds, each
    exchanging ``radius * b``-deep ghosts cut from the neighbour strip's
    fresh cells. Sub-round ``j``'s ghost is the neighbour strip at step
    ``j * b``, so the shards equal the coupled round bit for bit."""
    k, d, b = plan.fuse_steps, plan.depth, plan.boundary_steps
    e = plan.radius * b
    rdma = plan.engine.startswith("overlap:rdma")
    py, px = plan.mesh_axes
    if plan.layout == "col":
        base = _wrap_y(block, d)
        interior = _steps(step_fn, base, k)
        lead, tail = base[..., : 2 * d], base[..., -2 * d:]
        for _ in range(k // b):
            halo._note_exchange("x-part", "x", tail, e)
            if rdma:
                left, right = _rdma_edge_pair(
                    tail[..., -e:], lead[..., :e], "x", px,
                    collective_id=COLLECTIVE_IDS["x"])
            else:
                left = halo.ppermute(tail[..., -e:], "x", 1)
                right = halo.ppermute(lead[..., :e], "x", -1)
            left = halo._chaos_ghost(left)
            lead = _steps(step_fn, torch.cat([left, lead], dim=-1), b)
            tail = _steps(step_fn, torch.cat([tail, right], dim=-1), b)
        return torch.cat([lead, interior, tail], dim=-1)
    # row / cart: bands along y, each starting with d ghost columns and
    # narrowing by e per side per sub-round.
    base = (halo.halo_pad_x(block, "x", d) if plan.layout == "cart"
            else _wrap_x(block, d))
    interior = _steps(step_fn, base, k)
    lead, tail = base[..., : 2 * d, :], base[..., -2 * d:, :]
    for _ in range(k // b):
        halo._note_exchange("y-part", "y", tail, e)
        if rdma:
            top, bot = _rdma_edge_pair(
                tail[..., -e:, :], lead[..., :e, :], "y", py,
                collective_id=COLLECTIVE_IDS["y"])
        else:
            top = halo.ppermute(tail[..., -e:, :], "y", 1)
            bot = halo.ppermute(lead[..., :e, :], "y", -1)
        top = halo._chaos_ghost(top)
        lead = _steps(step_fn, torch.cat([top, lead], dim=-2), b)
        tail = _steps(step_fn, torch.cat([tail, bot], dim=-2), b)
    return torch.cat([lead, interior, tail], dim=-2)


def sequential_fused_step(plan: HaloPlan, step_fn, block: torch.Tensor
                          ) -> torch.Tensor:
    """The sequential round: the whole halo-padded shards first
    (:func:`padded_round_block`), then ``k`` steps."""
    return _steps(step_fn, padded_round_block(plan.layout, block, plan.depth),
                  plan.fuse_steps)


def fused_step(plan: HaloPlan, step_fn, block: torch.Tensor) -> torch.Tensor:
    """One fused round by the plan's schedule."""
    if plan.overlap:
        return overlap_fused_step(plan, step_fn, block)
    return sequential_fused_step(plan, step_fn, block)


# ------------------------------------------------- padded frames for engines


def padded_round_block(layout: str, block: torch.Tensor,
                       depth: int) -> torch.Tensor:
    """One round's halo-padded shards, exchanged as the sequential
    schedule pads them: the unsharded axis wraps locally, sharded axes
    exchange (x before y on ``cart``, for the corners). The frame
    kernel's plain version (``ops.native_halo.halo_frame_plain``)."""
    return native_halo.halo_frame_plain(block, depth, layout)


def padded_round_block_local(layout: str, block: torch.Tensor,
                             depth: int) -> torch.Tensor:
    """The zero-sentinel twin of :func:`padded_round_block`: unsharded
    axes wrap locally, sharded axes pad with zeros and nothing is
    exchanged. Equal to it when every shard's boundary band is dead (the
    caller's decision)."""
    d = depth
    pad_y, pad_x = {"row": ((d, d), (0, 0)), "col": ((0, 0), (d, d)),
                    "cart": ((d, d), (d, d))}[layout]
    if layout == "row":
        block = _wrap_x(block, d)
    elif layout == "col":
        block = _wrap_y(block, d)
    return torch.nn.functional.pad(block, (*pad_x, *pad_y))
