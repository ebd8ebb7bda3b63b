"""Shape-bucketed micro-batch dispatcher for stencil boards.

Counterpart of ``mpi_and_open_mp_tpu/serve/batcher.py``. A queue of
submitted boards on the host; one :meth:`ShapeBucketBatcher.flush` drains
it bucket by bucket, turning R same-shape requests into
``ceil(R / max_batch)`` stacked dispatches instead of R. Buckets key on
``(shape, dtype, workload)``: Life stacks ride the batched Life kernels
(``ops.native_life.life_run_vmem_batch``), every other registered
``stencils`` workload the spec's roll engine
(``stencils.run_roll_batch``, path ``stencil:<name>``), as in the JAX
package. Padding boards are zeros; boards never interact, and results are
cut to the live requests. With a ``pool`` (``serve.pool.SessionPool``),
:meth:`ShapeBucketBatcher.submit_session` queues resident-session steps:
``flush`` groups them by (current slab, steps) into one in-place
``step_group`` each, however few lanes are live, and their results are
``None`` (the board stays on the device).

Each stack runs in a ``serve.batch`` span (``obs.trace``) and ticks
``serve.requests``, ``serve.batches`` and ``serve.padding``
(``obs.metrics``), as in the JAX package. :func:`retrace_counts` reads the
batched runners' ``jit.retrace`` ticks, one per stack geometry
(``ops.bitlife._note_retrace``): a flush over K shape buckets sums to K.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.obs import metrics, trace
from mpi_and_open_mp_tpu_torch.ops import native_life
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device


def bucket_batch_size(
    n_requests: int, max_batch: int, slice_width: int | None = None
) -> int:
    """The padded batch a dispatch of ``n_requests`` same-shape boards
    uses: the next power of two, capped at ``max_batch``.

    ``slice_width`` (``native_life.batch_slice_width``) rounds to plane
    multiples instead when the shape is board-sliced: such a dispatch costs
    the same for every live count within a 32-board plane, so 20 requests
    pad to 32 and 65 to 96 (not pow2's 128). Chunks below
    ``BITSLICE_MIN_BATCH`` keep the pow2 rule (their stack dispatches
    cell-packed), as do widths past ``max_batch`` (the plane can never
    dispatch whole)."""
    if n_requests < 1:
        raise ValueError(f"bucket_batch_size: need >= 1 request, got {n_requests}")
    if (slice_width and slice_width <= max_batch
            and n_requests >= native_life.BITSLICE_MIN_BATCH):
        padded = -(-n_requests // slice_width) * slice_width
        if padded <= max_batch:
            return padded
    b = 1
    while b < n_requests and b < max_batch:
        b *= 2
    return min(b, max_batch)


# The batched engines' retrace names (the JAX package's).
_BATCH_FNS = (
    "life_batch_bitsliced",
    "life_batch_vmem",
    "life_batch_xla",
    "life_batch_fused",
    "life_batch_frame",
    "pool_step",
)


def retrace_counts() -> dict[str, int]:
    """Stack geometries built per batched engine since the last
    ``obs.metrics.reset()``: after a flush over K shape buckets (one padded
    size each) the values sum to K. Engines at zero are left out."""
    out = {}
    for fn in _BATCH_FNS:
        n = metrics.get("jit.retrace", fn=fn)
        if n:
            out[fn] = int(n)
    return out


@dataclass
class _Request:
    ticket: int
    board: np.ndarray
    steps: int
    workload: str = "life"


@dataclass
class _BatchStat:
    """One dispatched stack, as reported by ``last_flush_stats``."""

    shape: tuple[int, int]
    steps: int
    requests: int
    padded_batch: int
    path: str
    tickets: tuple[int, ...] = field(default_factory=tuple)


class ShapeBucketBatcher:
    """Collect independent stencil requests; flush them in shape buckets.

    ``submit(board, steps, workload)`` enqueues one board and returns a
    ticket;
    ``flush()`` advances everything queued and returns the results in
    submission (ticket) order, one host array per request. Boards bucket
    by ``(shape, dtype, workload)``; inside a bucket, requests with the same
    step count share a dispatch (all boards of a stack advance together),
    chunked at ``max_batch``. Stacks run on ``device``: the card unless the
    caller asks for the CPU. Resident-session steps (``submit_session``)
    need a ``pool`` and run on its device."""

    def __init__(self, max_batch: int = 8,
                 device: str | torch.device = "cuda", pool=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.device = resolve_device(device)
        self._queue: list[_Request] = []
        # Resident-session steps (ticket, session, steps), coalesced at
        # flush by slab: a lone lane and 32 slab-mates are one dispatch.
        self._pool = pool
        self._session_queue: list[tuple[int, str, int]] = []
        self._next_ticket = 0
        self.last_flush_stats: list[_BatchStat] = []

    def __len__(self) -> int:
        return len(self._queue) + len(self._session_queue)

    def submit(self, board: np.ndarray, steps: int,
               workload: str = "life") -> int:
        """Enqueue one board for ``steps`` steps of ``workload`` (a
        registered ``stencils`` name, default life); returns a ticket (the
        request's index in the next flush's result list)."""
        try:
            spec = stencils.get(workload)
        except KeyError as e:
            raise ValueError(str(e)) from None
        board = np.asarray(board)
        if (board.ndim < 2
                or board.shape != spec.board_shape(*board.shape[-2:])):
            want = ("3D (channels, ny, nx)" if spec.channels > 1
                    else "2D (ny, nx)")
            raise ValueError(
                f"submit: workload {workload!r} wants one {want} board "
                f"per request, got shape {board.shape} (stacks are the "
                "engine layout; the batcher builds them)")
        steps = int(steps)
        if steps < 0:
            raise ValueError(f"submit: steps must be >= 0, got {steps}")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._queue.append(_Request(ticket, board, steps, str(workload)))
        return ticket

    def submit_session(self, session: str, steps: int) -> int:
        """Enqueue one resident-session step (needs a ``pool``); returns a
        ticket like :meth:`submit`. Its flush result is ``None``: the
        board stays on the device."""
        if self._pool is None:
            raise ValueError(
                "submit_session: this batcher has no session pool")
        steps = int(steps)
        if steps < 0:
            raise ValueError(
                f"submit_session: steps must be >= 0, got {steps}")
        if not self._pool.has(str(session)):
            raise ValueError(
                f"submit_session: unknown session {session!r}")
        ticket = self._next_ticket
        self._next_ticket += 1
        self._session_queue.append((ticket, str(session), steps))
        return ticket

    def _slab_of(self, sid: str) -> int:
        h = self._pool.handle(sid)
        return -1 if h is None else h.slab  # spilled: placed at flush

    def bucket_keys(self) -> list[tuple]:
        """The distinct buckets currently queued, in first-submission
        order: ``(shape, dtype, workload)`` for boards, ``("slab",
        slab_id, steps)`` for resident-session steps."""
        seen: dict[tuple, None] = {}
        for r in self._queue:
            seen.setdefault((r.board.shape, r.board.dtype.str, r.workload),
                            None)
        for _, sid, steps in self._session_queue:
            seen.setdefault(("slab", self._slab_of(sid), steps), None)
        return list(seen)

    def flush(self) -> list[np.ndarray]:
        """Advance every queued request; results in submission order."""
        on_card = self.device.type == "cuda"
        results: dict[int, np.ndarray] = {}
        stats: list[_BatchStat] = []
        buckets: dict[tuple, list[_Request]] = {}
        for r in self._queue:
            buckets.setdefault(
                (r.board.shape, r.board.dtype.str, r.workload), []).append(r)
        for (shape, _dtype, workload), reqs in buckets.items():
            by_steps: dict[int, list[_Request]] = {}
            for r in reqs:
                by_steps.setdefault(r.steps, []).append(r)
            # Plane rounding is a Life layout; other workloads pad on the
            # plain pow2 ladder.
            width = (native_life.batch_slice_width(shape)
                     if workload == "life" else None)
            for steps, group in by_steps.items():
                for lo in range(0, len(group), self.max_batch):
                    chunk = group[lo:lo + self.max_batch]
                    padded = bucket_batch_size(
                        len(chunk), self.max_batch, slice_width=width)
                    stack = np.zeros((padded, *shape),
                                     dtype=chunk[0].board.dtype)
                    for i, r in enumerate(chunk):
                        stack[i] = r.board
                    dev_stack = torch.from_numpy(stack).to(self.device)
                    path = (native_life.native_path_batch(
                        stack.shape, on_card=on_card)
                        if workload == "life" else f"stencil:{workload}")
                    with trace.span(
                            "serve.batch", shape=f"{shape[-2]}x{shape[-1]}",
                            steps=steps, requests=len(chunk), padded=padded,
                            path=path, workload=workload) as sp:
                        if workload == "life":
                            out = native_life.life_run_vmem_batch(dev_stack,
                                                                  steps)
                        else:
                            out = stencils.run_roll_batch(
                                stencils.get(workload), dev_stack, steps)
                        sp.anchor(out)
                    host = out[: len(chunk)].cpu().numpy()
                    for i, r in enumerate(chunk):
                        results[r.ticket] = host[i]
                    metrics.inc("serve.requests", len(chunk))
                    metrics.inc("serve.batches")
                    if padded > len(chunk):
                        metrics.inc("serve.padding", padded - len(chunk))
                    stats.append(_BatchStat(
                        shape=shape, steps=steps, requests=len(chunk),
                        padded_batch=padded, path=path,
                        tickets=tuple(r.ticket for r in chunk)))
        # Resident-session steps: one in-place step_group per (current
        # slab, steps), however few lanes are live.
        groups: dict[tuple, list[tuple[int, str]]] = {}
        for ticket, sid, steps in self._session_queue:
            groups.setdefault((self._slab_of(sid), steps), []).append(
                (ticket, sid))
        for (slab, steps), members in groups.items():
            sids = [sid for _, sid in members]
            with trace.span("serve.batch", slab=slab, steps=steps,
                            requests=len(sids), path="pool"):
                self._pool.step_group(sids, steps)
            for ticket, _ in members:
                results[ticket] = None
            metrics.inc("serve.requests", len(sids))
            metrics.inc("serve.batches")
            stats.append(_BatchStat(
                shape=("slab", slab), steps=steps, requests=len(sids),
                padded_batch=len(sids), path="pool",
                tickets=tuple(t for t, _ in members)))
        ordered = [results[t] for t in sorted(results)]
        self._queue.clear()
        self._session_queue.clear()
        self.last_flush_stats = stats
        return ordered
