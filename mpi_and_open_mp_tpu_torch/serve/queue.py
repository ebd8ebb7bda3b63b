"""Bounded, admission-controlled, checkpointable request queue.

Counterpart of ``mpi_and_open_mp_tpu/serve/queue.py``. The serving
daemon's ticket ledger: every submission becomes a :class:`Ticket` that
ends in exactly one terminal state, ``DONE`` with a result and an engine
stamp, or ``SHED`` with a reason from the ``serve.policy`` vocabulary. A
drain snapshots the pending tickets (boards, step counts, order, queued
seconds) through the crash-atomic state frame
(``utils.checkpoint.save_state``), and :meth:`ServeQueue.restore`
re-admits them unconditionally: admission applies at the door, not to
requests already accepted. The snapshot's tree is the JAX package's, so a
drain checkpoint written by either package restores in the other.

Tickets hold host ``numpy`` boards: the daemon moves a stack to the
device once per dispatch and the result back once, so a ticket never
holds a tensor, and the journal and the checkpoint pickle numpy only.

Buckets key on ``(shape, dtype, steps, workload)``: all boards of a stack
advance together, and a heat board and a Life board of one shape run
different kernels. The queue keeps the deadlines (the oldest pending
ticket of each bucket); the policy decides when a bucket is due, the
daemon dispatches it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.obs import metrics, trace
from mpi_and_open_mp_tpu_torch.ops import native_life
from mpi_and_open_mp_tpu_torch.serve import policy as policy_mod
from mpi_and_open_mp_tpu_torch.serve.policy import ServePolicy

PENDING = "pending"
DONE = "done"
SHED = "shed"

STATE_SCHEMA = "momp-serve-queue/1"


@dataclasses.dataclass
class Ticket:
    """One request's life, admission through terminal state."""

    id: int
    #: The payload for ship-every-ticket requests; ``None`` for a
    #: resident session step — the board never leaves the device, the
    #: ticket carries only the pool handle.
    board: np.ndarray | None
    steps: int
    submitted_at: float
    state: str = PENDING
    result: np.ndarray | None = None
    reason: str | None = None  # shed reason (policy.SHED_*)
    engine: str | None = None  # provenance stamp of the resolving dispatch
    resolved_at: float | None = None
    resumed: bool = False  # restored from a drain checkpoint
    #: Fleet affinity key: requests sharing a ``session`` route to the
    #: same worker (consistent hash in ``serve.router``). ``None`` for
    #: single-daemon use — affinity then falls back to a per-ticket key.
    session: str | None = None
    #: Seconds this request already spent queued in PREVIOUS processes.
    #: ``submitted_at`` is re-stamped against the resuming clock
    #: (monotonic timestamps don't cross a process boundary), so without
    #: this carry a resumed ticket's latency would silently forget its
    #: pre-crash queue time and post-resume p99 would flatter the tail.
    queued_before_s: float = 0.0
    #: Device-resident handle (``serve.pool.Handle``) for a session step
    #: ticket. Set iff ``board`` is ``None``.
    handle: object | None = None
    #: Stencil workload name (``stencils.get``): which rule advances this
    #: board. Part of the bucket key — a heat board and a life board of
    #: the same shape must never share a dispatch.
    workload: str = "life"

    @property
    def bucket_key(self) -> tuple:
        if self.handle is not None:
            # Resident steps bucket by slab: every lane of a slab is
            # advanced by the SAME donated dispatch, so slab-mates with
            # equal step counts coalesce into one program invocation.
            return ("pool", self.handle.slab, self.steps)
        return (self.board.shape, self.board.dtype.str, self.steps,
                self.workload)

    @property
    def latency_s(self) -> float | None:
        """True end-to-end seconds, first submission to terminal state,
        across every process that held the ticket (``None`` while
        pending)."""
        if self.resolved_at is None:
            return None
        return self.resolved_at - self.submitted_at + self.queued_before_s


class ServeQueue:
    """Ticket store + admission gate. All times come from the caller
    (``now`` arguments) so tests drive deadlines with a fake clock."""

    def __init__(self, policy: ServePolicy | None = None):
        self.policy = policy or ServePolicy()
        self._tickets: dict[int, Ticket] = {}
        self._next_ticket = 0
        self._width_cache: dict[tuple, int | None] = {}

    # -- intake ------------------------------------------------------------

    def submit(self, board: np.ndarray, steps: int, now: float,
               session: str | None = None,
               workload: str = "life") -> Ticket:
        """Admit or reject one request; ALWAYS returns a ticket. A
        rejected ticket is already terminal (``SHED`` with the admission
        reason) so callers account for every submission the same way.
        ``workload`` names the stencil rule (``stencils.get``); the
        board must match the spec's layout — 2D, or channels-leading 3D
        for multi-channel rules like gray_scott."""
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
                f"per request, got shape {board.shape}")
        steps = int(steps)
        if steps < 0:
            raise ValueError(f"submit: steps must be >= 0, got {steps}")
        t = Ticket(self._next_ticket, board, steps, float(now),
                   session=session, workload=str(workload))
        self._next_ticket += 1
        counts = self._bucket_counts()
        counts[t.bucket_key] = counts.get(t.bucket_key, 0) + 1
        reason = policy_mod.admit(
            self.policy, self.depth(),
            [(n, self._slice_width(key)) for key, n in counts.items()
             if key[0] != "pool"])
        self._tickets[t.id] = t
        metrics.inc("serve.requests")
        if reason is not None:
            self._shed(t, reason, now)
        else:
            metrics.inc("serve.admitted")
            trace.event("serve.admit", ticket=t.id,
                        shape=f"{board.shape[-2]}x{board.shape[-1]}",
                        steps=steps, workload=t.workload)
        return t

    def submit_session(self, session: str, handle, steps: int,
                       now: float) -> Ticket:
        """Admit or reject one resident session step. The padding-waste
        gate does not apply — a pool dispatch advances whole planes in
        place, so a partly-live slab costs exactly what a full one does
        and there is no dead-padding denominator to project. Depth still
        gates (pending handles queue host bookkeeping and dispatch
        latency like any ticket)."""
        steps = int(steps)
        if steps < 0:
            raise ValueError(
                f"submit_session: steps must be >= 0, got {steps}")
        t = Ticket(self._next_ticket, None, steps, float(now),
                   session=str(session), handle=handle)
        self._next_ticket += 1
        metrics.inc("serve.requests")
        if self.depth() >= self.policy.max_depth:
            self._tickets[t.id] = t
            self._shed(t, policy_mod.SHED_DEPTH, now)
            return t
        self._tickets[t.id] = t
        metrics.inc("serve.admitted")
        trace.event("serve.admit", ticket=t.id, session=str(session),
                    steps=steps, resident=True)
        return t

    def restore_ticket(self, board: np.ndarray, steps: int,
                       now: float, queued_s: float = 0.0,
                       session: str | None = None,
                       workload: str = "life") -> Ticket:
        """Re-admit one drained ticket from a checkpoint — NO admission
        gate (it was already admitted once; dropping it now would break
        the never-lose-a-ticket contract). The deadline clock restarts at
        ``now``: monotonic timestamps don't survive a process boundary,
        so the seconds already spent queued arrive as ``queued_s`` and
        keep accruing into :attr:`Ticket.latency_s`."""
        t = Ticket(self._next_ticket, np.asarray(board), int(steps),
                   float(now), resumed=True, session=session,
                   queued_before_s=float(queued_s),
                   workload=str(workload))
        self._next_ticket += 1
        self._tickets[t.id] = t
        metrics.inc("serve.requests")
        metrics.inc("serve.admitted")
        metrics.inc("serve.resumed_tickets")
        return t

    # -- queries -----------------------------------------------------------

    def depth(self) -> int:
        return sum(1 for t in self._tickets.values() if t.state == PENDING)

    def pending(self) -> list[Ticket]:
        """Pending tickets in submission order (dict preserves it)."""
        return [t for t in self._tickets.values() if t.state == PENDING]

    def tickets(self) -> list[Ticket]:
        """Every ticket ever submitted, in submission order."""
        return list(self._tickets.values())

    def _bucket_counts(self) -> dict[tuple, int]:
        counts: dict[tuple, int] = {}
        for t in self.pending():
            counts[t.bucket_key] = counts.get(t.bucket_key, 0) + 1
        return counts

    def _slice_width(self, bucket_key: tuple) -> int | None:
        """The pad width the dispatcher rounds this bucket with
        (``ops.native_life.batch_slice_width``), so that admission's
        padding-waste projection matches the dispatch. Cached per shape:
        the gate is arithmetic on (ny, nx) and one environment flag, both
        fixed for the process. Other workloads pad on the pow2 ladder."""
        if bucket_key[-1] != "life":
            return None
        shape = bucket_key[0]
        if shape not in self._width_cache:
            self._width_cache[shape] = native_life.batch_slice_width(shape)
        return self._width_cache[shape]

    def buckets(self) -> dict[tuple, list[Ticket]]:
        """Pending tickets grouped by bucket, submission order inside."""
        out: dict[tuple, list[Ticket]] = {}
        for t in self.pending():
            out.setdefault(t.bucket_key, []).append(t)
        return out

    def due_chunks(self, now: float, drain: bool = False) -> list[list[Ticket]]:
        """Dispatchable chunks: every full ``max_batch`` slice of every
        bucket, plus the remainder of any bucket whose oldest pending
        ticket has waited ``max_wait_s`` (or everything when draining).
        Chunks come out in oldest-ticket-first order so a starved bucket
        is served before a fresh full one."""
        chunks: list[list[Ticket]] = []
        for key, group in self.buckets().items():
            # A pool bucket's natural chunk is the slab's lane count:
            # one donated dispatch advances every lane of one plane, so
            # there is no reason to split below — or batch above — 32.
            mb = 32 if key[0] == "pool" else self.policy.max_batch
            due = drain or (now - group[0].submitted_at
                            >= self.policy.max_wait_s)
            lo = 0
            while len(group) - lo >= mb:
                chunks.append(group[lo:lo + mb])
                lo += mb
            if due and lo < len(group):
                chunks.append(group[lo:])
        chunks.sort(key=lambda c: c[0].id)
        return chunks

    def next_deadline(self) -> float | None:
        """The earliest instant any bucket becomes due, or ``None`` when
        nothing is pending — the daemon's idle-sleep horizon."""
        oldest = [g[0].submitted_at for g in self.buckets().values()]
        if not oldest:
            return None
        return min(oldest) + self.policy.max_wait_s

    # -- terminal transitions ---------------------------------------------

    def resolve(self, ticket: Ticket, result: np.ndarray, engine: str,
                now: float) -> None:
        ticket.state = DONE
        ticket.result = result
        ticket.engine = engine
        ticket.resolved_at = float(now)
        metrics.inc("serve.resolved")
        metrics.observe("serve.latency_seconds", ticket.latency_s)

    def shed_ticket(self, ticket: Ticket, reason: str, now: float) -> None:
        self._shed(ticket, reason, now)

    def _shed(self, ticket: Ticket, reason: str, now: float) -> None:
        if reason not in policy_mod.SHED_REASONS:
            raise ValueError(f"unknown shed reason {reason!r} "
                             f"(want one of {policy_mod.SHED_REASONS})")
        ticket.state = SHED
        ticket.reason = reason
        ticket.resolved_at = float(now)
        metrics.inc("serve.shed", reason=reason)
        trace.event("serve.shed", ticket=ticket.id, reason=reason)

    # -- checkpoint round trip --------------------------------------------

    def snapshot(self, now: float | None = None) -> dict:
        """The pending set as a picklable tree for
        ``utils.checkpoint.save_state`` — ticket order, payloads, step
        counts, the original ids (provenance: an operator can map a
        resumed ticket back to the pre-preemption submission), and each
        ticket's cumulative queued seconds as of ``now`` (pass the
        drain clock so a resumed ticket's latency keeps counting from
        its FIRST submission, not the restore). Resident session
        tickets (``board is None``) are EXCLUDED: their durable state is
        the WAL's handle-lifecycle frames, not the queue — restoring
        one here would double-apply its step on resume."""
        return {
            "schema": STATE_SCHEMA,
            "next_ticket": self._next_ticket,
            "pending": [
                {"id": t.id, "board": np.asarray(t.board), "steps": t.steps,
                 "session": t.session, "workload": t.workload,
                 "queued_s": (t.queued_before_s
                              + (float(now) - t.submitted_at
                                 if now is not None else 0.0))}
                for t in self.pending() if t.board is not None
            ],
        }

    def restore(self, state: dict, now: float) -> list[Ticket]:
        """Re-admit every pending ticket of a :meth:`snapshot` tree, in
        its original order. Raises ``ValueError`` on a tree that isn't a
        serve-queue snapshot (wrong schema / missing fields)."""
        if not isinstance(state, dict) or state.get("schema") != STATE_SCHEMA:
            raise ValueError(
                "not a serve-queue checkpoint: schema is "
                f"{state.get('schema') if isinstance(state, dict) else type(state)!r},"
                f" want {STATE_SCHEMA!r}")
        pending = state.get("pending")
        if not isinstance(pending, list):
            raise ValueError(
                "serve-queue checkpoint is missing its pending list")
        out = []
        for item in pending:
            try:
                board, steps = item["board"], item["steps"]
            except (TypeError, KeyError) as e:
                raise ValueError(
                    f"serve-queue checkpoint entry is malformed: {item!r}"
                ) from e
            out.append(self.restore_ticket(
                board, steps, now,
                queued_s=float(item.get("queued_s", 0.0)),
                session=item.get("session"),
                workload=str(item.get("workload", "life"))))
        return out
