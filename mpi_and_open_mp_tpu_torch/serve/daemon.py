"""Supervised serving daemon: deadline scheduling and a recovery ladder.

Counterpart of ``mpi_and_open_mp_tpu/serve/daemon.py``, its ticket path.
One process keeps a bounded, admission-controlled queue (``serve.queue``),
flushes a shape bucket when it fills or when its oldest ticket reaches the
policy's deadline (padding traded against p99), and wraps every batch
dispatch in a supervision envelope, so that one poisoned request or failed
engine cannot take the process down:

* **Engine ladder** (``robust.guards.with_fallback``). A Life stack on the
  card: the launch-record rung ``aot:<path>`` when a cache is attached,
  then ``batch:<path>`` (``ops.native_life.life_run_vmem_batch``: an
  installed plan first, then the static ladder), then under ``bitsliced``
  the cell-packed kernel with the layout pinned off, then a clean re-run
  of the primary path under ``chaos.suppressed()``. A recovery on the card
  never runs the plain version or the NumPy oracle. On the CPU the JAX
  package's ladder: those rungs that exist there, ``batch:plain`` (JAX's
  ``batch:xla``) and ``oracle`` last. A stencil stack: the roll engine
  ``batch:stencil:<name>``, the padded kernel's rung
  ``batch:stencil-native:<name>`` (JAX's ``batch:stencil-pallas:<name>``)
  where ``native_batch_supported`` allows it, the ``sep``/``fft`` families
  where ``family_allowed``; an installed plan's rung leads, and ``oracle``
  closes the ladder on the CPU only. A self-healed dispatch carries the
  ``:recovered`` suffix on every ticket it resolved and lands in the
  recovery log.
* **Bounded retry**: a failure of the whole ladder retries behind the
  ``robust.watchdog`` capped-exponential backoff with seeded jitter, never
  past ``max_retries`` or a member ticket's end-to-end timeout; then the
  chunk sheds with ``dispatch-failed`` (or ``timeout``).
* **Preemption**: SIGTERM/SIGINT land as a flag checked between batch
  dispatches (``robust.preempt``); the in-flight batch completes, the
  pending queue snapshots through ``utils.checkpoint.save_state``, and
  :class:`Preempted` propagates, so drivers exit 75. ``MOMP_CHAOS
  preempt=<k>`` does the same after ``k`` batches, ``serve_fail=<k>``
  fails the first ``k`` primary engines.
* **Hard-kill durability**: with ``wal_path`` set, every ticket transition
  is journaled (``serve.wal``) before the daemon acts on it, so
  :meth:`ServingDaemon.resume_any` rebuilds the pending set, in-flight
  batch included, from a process that died at any instruction. Resume
  ladder: journal, then drain checkpoint, then fresh. ``MOMP_CHAOS
  crash=<site>:<k>`` kills at the instrumented sites.

Tickets hold host boards; a stack goes to ``device`` once per dispatch and
comes back once. Resident sessions live in a ``serve.pool.SessionPool`` on
``device``, built at the first ``create_session``: each session method
journals its frame (CREATE, STEP, SNAPSHOT, EVICT) before the pool acts, a
``submit_session`` ticket carries a handle instead of a board and resolves
stamped ``pool:bitsliced``, and ``resume_any`` re-materializes the pool
from the journal's create boards and step totals. Every admission, shed,
retry, degrade and drain ticks ``serve.*`` metrics and trace events
(``obs``): requests == resolved + shed, always.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.obs import metrics, trace
from mpi_and_open_mp_tpu_torch.ops import native_life
from mpi_and_open_mp_tpu_torch.robust import chaos, guards, watchdog
from mpi_and_open_mp_tpu_torch.robust.preempt import (
    EXIT_PREEMPTED, Preempted, SimulatedPreemption, flush_on_signal)
from mpi_and_open_mp_tpu_torch.serve import policy as policy_mod
from mpi_and_open_mp_tpu_torch.serve import wal as wal_mod
from mpi_and_open_mp_tpu_torch.serve.batcher import bucket_batch_size
from mpi_and_open_mp_tpu_torch.serve.policy import ServePolicy, percentile
from mpi_and_open_mp_tpu_torch.serve.queue import (
    DONE, PENDING, SHED, ServeQueue, Ticket)
from mpi_and_open_mp_tpu_torch.utils import checkpoint as checkpoint_mod
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device


class ServingDaemon:
    """One supervised worker loop over a :class:`ServeQueue`, dispatching
    on ``device`` (the card unless the caller asks for the CPU).

    ``clock``/``sleep`` are injectable, so tests drive deadlines and
    backoff without wall time; the default clock is monotonic, and ticket
    timestamps never cross a process boundary raw (the checkpoint and the
    journal carry queued seconds and wall time instead)."""

    def __init__(self, policy: ServePolicy | None = None, *,
                 checkpoint_path: str | None = None,
                 wal_path: str | None = None,
                 wal_fsync: str = "every-record",
                 wal_compact_bytes: int = 1 << 20,
                 aot_cache=None,
                 plan_store=None,
                 worker_index: int | None = None,
                 pool_budget_bytes: int | None = None,
                 device: str | torch.device = "cuda",
                 clock=time.monotonic, sleep=time.sleep):
        self.device = resolve_device(device)
        self.policy = policy or ServePolicy()
        # Which worker of a fleet this is (the kill_worker=<i>:<k> drill
        # targets one index); None for a single daemon.
        self.worker_index = worker_index
        self.queue = ServeQueue(self.policy)
        self.checkpoint_path = checkpoint_path
        self._clock = clock
        self._sleep = sleep
        self._batches = 0
        self._retries = 0
        self._degraded = 0
        # Launch-record store (serve.aotcache.AOTCache): the Life ladder's
        # top rung, and resume warms the pending buckets' records.
        self._aot = aot_cache
        # Tuned-plan store (tune.plans.PlanStore), installed here so that
        # every resume rung comes up with its plans before the first
        # dispatch.
        self._plans_summary = (plan_store.install()
                               if plan_store is not None else None)
        self._created_at = self._clock()
        self._first_result_s: float | None = None  # cold-start latency
        # Under every-chunk the buffer never holds more records than one
        # batch admits: the "one chunk" loss bound is literal.
        self._wal = (wal_mod.TicketWAL(
            wal_path, fsync=wal_fsync,
            chunk_records=self.policy.max_batch,
            compact_bytes=wal_compact_bytes)
            if wal_path else None)
        # The session pool, built at the first create_session; the session
        # log is the host mirror of the journal's live sessions ({id,
        # board, steps, wall}): compaction snapshots it without touching
        # the device, and resume rebuilds both from the journal.
        self._pool = None
        self._pool_budget = pool_budget_bytes
        self._session_log: dict[str, dict] = {}

    # -- intake ------------------------------------------------------------

    def submit(self, board: np.ndarray, steps: int,
               session: str | None = None,
               workload: str = "life") -> Ticket:
        """Admit (or reject with a reason) one request; see
        :meth:`ServeQueue.submit`. An admitted ticket is journaled before
        this returns, so under ``every-record`` the caller's ack implies
        durability. A ticket shed at the door never touches the journal.
        ``session`` is the fleet affinity key; ``workload`` names the
        stencil rule, which buckets the dispatch and picks the ladder."""
        t = self.queue.submit(board, steps, self._clock(), session=session,
                              workload=workload)
        if t.state == PENDING and self._wal is not None:
            # Crash site: admitted in memory, not journaled. A death here
            # loses a ticket whose submit() never returned: never acked.
            if chaos.crash_armed("post-admit"):
                chaos.crash_now()
            self._wal.admit(t.id, t.board, t.steps, session=t.session,
                            workload=t.workload)
        return t

    # -- device-resident sessions -------------------------------------------

    @property
    def pool(self):
        """The device-resident session pool on ``device``, built on first
        use."""
        if self._pool is None:
            from mpi_and_open_mp_tpu_torch.serve.pool import SessionPool

            kw = {}
            if self._pool_budget is not None:
                kw["device_budget_bytes"] = self._pool_budget
            self._pool = SessionPool(device=self.device, **kw)
        return self._pool

    def _live(self, session, what: str) -> str:
        session = str(session)
        if session not in self._session_log:
            raise ValueError(f"{what}: unknown session {session!r}")
        return session

    def create_session(self, session: str, board: np.ndarray):
        """Admit a board into the pool under ``session`` (the one time the
        board goes to the device). The CREATE frame is durable before the
        pool sees it. Returns the handle."""
        session = str(session)
        if session in self._session_log:
            raise ValueError(
                f"create_session: session {session!r} is already live")
        board = np.asarray(board)
        wall = time.time()
        if self._wal is not None:
            self._wal.pool_create(session, board, wall=wall)
            if chaos.crash_armed("post-create"):
                chaos.crash_now()
        handle = self.pool.create(session, board)
        self._session_log[session] = {
            "id": session, "board": board.copy(), "steps": 0, "wall": wall}
        return handle

    def step_session(self, session: str, steps: int) -> int:
        """Advance one resident session ``steps`` steps in place, at once
        (the ticketed path is :meth:`submit_session`). The STEP frame is
        write-ahead and authoritative."""
        return self.step_sessions([str(session)], steps)

    def step_sessions(self, sessions: list[str], steps: int) -> int:
        steps = int(steps)
        sids = [self._live(sid, "step_sessions") for sid in sessions]
        if self._wal is not None:
            for sid in sids:
                self._wal.pool_step(sid, steps)
            if chaos.crash_armed("post-step"):
                chaos.crash_now()
        n = self.pool.step_group(sids, steps)
        for sid in sids:
            self._session_log[sid]["steps"] += steps
        return n

    def submit_session(self, session: str, steps: int) -> Ticket:
        """Admit one resident step as a ticket: one STEP frame (no
        ADMIT/DISPATCH/RESOLVE), write-ahead and authoritative, so the ack
        this return implies holds whether the dispatch happens here or is
        replayed into the pool on resume. A door-shed ticket never touches
        the journal."""
        session = self._live(session, "submit_session")
        t = self.queue.submit_session(
            session, self.pool.handle(session), steps, self._clock())
        if t.state == PENDING:
            if self._wal is not None:
                self._wal.pool_step(session, t.steps)
                if chaos.crash_armed("post-step"):
                    chaos.crash_now()
            self._session_log[session]["steps"] += t.steps
        return t

    def snapshot_session(self, session: str) -> np.ndarray:
        """A resident session's board (one read from the device): the
        create board advanced by the journaled step total."""
        session = self._live(session, "snapshot_session")
        if self._wal is not None:
            self._wal.pool_snapshot(
                session, int(self._session_log[session]["steps"]))
            if chaos.crash_armed("post-snapshot"):
                chaos.crash_now()
        return self.pool.snapshot(session)

    def evict_session(self, session: str) -> np.ndarray:
        """Remove a session from the pool, returning its final board. The
        EVICT frame lands first, so a crash mid-evict replays to the
        evicted state."""
        session = self._live(session, "evict_session")
        if self._wal is not None:
            self._wal.pool_evict(session)
            if chaos.crash_armed("post-evict"):
                chaos.crash_now()
        board = self.pool.evict(session)
        del self._session_log[session]
        return board

    def adopt_session(self, session: str, board: np.ndarray, steps: int):
        """The destination half of a pool re-home: journal a fresh CREATE
        and STEP lifetime here, then replay the advance on the device
        (``board`` is the origin's create board). ``post-rejoin`` fires
        between the journal and the pool: a kill there leaves the session
        live in both journals, duplicated and never lost."""
        session = str(session)
        board = np.asarray(board)
        steps = int(steps)
        wall = time.time()
        if self._wal is not None:
            self._wal.pool_create(session, board, wall=wall)
            if steps:
                self._wal.pool_step(session, steps)
            if chaos.crash_armed("post-rejoin"):
                chaos.crash_now()
        handle = self.pool.create(session, board)
        if steps:
            self.pool.step(session, steps)
        self._session_log[session] = {
            "id": session, "board": board.copy(), "steps": steps,
            "wall": wall}
        return handle

    def sessions(self) -> list[str]:
        return list(self._session_log)

    def _rematerialize_pool(self, pool_sessions: dict[str, dict]) -> int:
        """Rebuild the pool from a journal replay's sessions: each create
        board enters the pool and advances by its journaled step total (a
        journaled but unacked step is applied: at least once for unacked
        work, no acked loss)."""
        for sid, entry in pool_sessions.items():
            board = np.asarray(entry["board"])
            steps = int(entry["steps"])
            self.pool.create(sid, board)
            if steps:
                self.pool.step(sid, steps)
            self._session_log[sid] = {
                "id": sid, "board": board.copy(), "steps": steps,
                "wall": float(entry.get("wall", 0.0))}
        return len(pool_sessions)

    # -- fleet worker-mode hooks -------------------------------------------

    def release(self, tickets: list[Ticket],
                now: float | None = None) -> list[dict]:
        """Hand a group of pending tickets off this worker's books (the
        source half of a re-home or a work steal): each sheds here with
        ``re-homed``, journal frame first, so a replay of this worker's
        journal never re-dispatches work that now lives elsewhere, and
        comes back as a portable entry for :meth:`adopt`. Tickets that
        are no longer pending are skipped."""
        now = self._clock() if now is None else now
        live = [t for t in tickets
                if t.state == PENDING and t.board is not None]
        entries = self.export(live, now)
        self._shed_batch(live, policy_mod.SHED_REHOMED, now)
        return entries

    def export(self, tickets: list[Ticket],
               now: float | None = None) -> list[dict]:
        """Portable entries ``{board, steps, session, wall, workload,
        queued_s}`` for pending tickets, without closing this worker's
        books (the read half of :meth:`release`: a graceful drain adopts
        at the destination first, so a crash between the halves
        duplicates work rather than losing it)."""
        now = self._clock() if now is None else now
        wall = time.time()
        return [
            {"board": np.asarray(t.board), "steps": t.steps,
             "session": t.session, "wall": wall,
             "workload": t.workload,
             "queued_s": t.queued_before_s + (now - t.submitted_at)}
            for t in tickets if t.state == PENDING and t.board is not None
        ]

    def adopt(self, entries: list[dict],
              now: float | None = None) -> list[Ticket]:
        """Admit re-homed entries (the destination half of
        :meth:`release`, or a dead worker's journal replay). No admission
        gate: the fleet accepted this work once. The carried
        ``queued_s``/``wall`` keep each latency honest across the move,
        and the tickets are journaled like fresh admissions."""
        now = self._clock() if now is None else now
        wall_now = time.time()
        out = []
        for e in entries:
            queued = float(e.get("queued_s", 0.0))
            wall = float(e.get("wall", 0.0))
            if wall:
                queued += max(0.0, wall_now - wall)
            t = self.queue.restore_ticket(
                e["board"], e["steps"], now, queued_s=queued,
                session=e.get("session"),
                workload=str(e.get("workload", "life")))
            if self._wal is not None:
                self._wal.admit(t.id, t.board, t.steps,
                                queued_s=queued, session=t.session,
                                workload=t.workload)
            out.append(t)
        return out

    # -- resume -------------------------------------------------------------

    @classmethod
    def resume(cls, checkpoint_path: str,
               policy: ServePolicy | None = None, **kw) -> "ServingDaemon":
        """A daemon whose queue starts from a drain checkpoint (written by
        either package): every pending ticket is re-admitted
        unconditionally. Raises ``ValueError`` on a missing, corrupt or
        foreign checkpoint."""
        state = checkpoint_mod.restore_state(checkpoint_path)
        daemon = cls(policy, checkpoint_path=checkpoint_path, **kw)
        restored = daemon.queue.restore(state, daemon._clock())
        trace.event("serve.resume", tickets=len(restored))
        if daemon._wal is not None:
            daemon._compact_wal()
        return daemon

    @classmethod
    def resume_any(cls, *, wal_path: str | None = None,
                   checkpoint_path: str | None = None,
                   policy: ServePolicy | None = None,
                   wal_fsync: str = "every-record",
                   **kw) -> tuple["ServingDaemon", str, dict]:
        """The resume ladder: journal, then drain checkpoint, then fresh.
        Returns ``(daemon, source, detail)``, ``source`` one of ``"wal"``,
        ``"checkpoint"``, ``"fresh"``, ``detail`` the replay accounting
        and any error met on the way.

        A journal with a torn tail replays to its last whole frame;
        tickets of an open DISPATCH come back pending (dispatch is pure,
        so redoing it is idempotent). The journal is compacted at once:
        the restored tickets carry new ids in this process, and rotation
        re-anchors the journal on them. An unreadable journal or
        checkpoint is quarantined to a stamped ``.corrupt.<stamp>``
        sibling and the ladder falls through. The journal's live pool
        sessions are re-materialized into the pool before the rotation.
        With an ``aot_cache``, every rung ends by warming the pending
        buckets' launch records (``detail["aot_preload"]``)."""
        detail: dict = {}
        if wal_path and os.path.exists(wal_path):
            try:
                rep = wal_mod.replay(wal_path)
            except ValueError as e:
                detail["wal_error"] = str(e)[:300]
                trace.event("serve.resume.wal_error", error=str(e)[:200])
                # Fresh frames behind a bad head would poison every later
                # replay: move the journal aside, forensics intact.
                q = checkpoint_mod.quarantine(wal_path)
                if q:
                    detail["wal_quarantine"] = q
            else:
                daemon = cls(policy, checkpoint_path=checkpoint_path,
                             wal_path=wal_path, wal_fsync=wal_fsync, **kw)
                daemon._wal._generation = rep.generation
                now = daemon._clock()
                wall_now = time.time()
                for entry in rep.pending:
                    queued = float(entry.get("queued_s", 0.0))
                    wall = float(entry.get("wall", 0.0))
                    if wall:
                        # Seconds in the dead process and the gap until
                        # this restart: wall time crosses processes.
                        queued += max(0.0, wall_now - wall)
                    daemon.queue.restore_ticket(
                        entry["board"], entry["steps"], now, queued_s=queued,
                        session=entry.get("session"),
                        workload=str(entry.get("workload", "life")))
                # The pool before the rotation: rotation snapshots the
                # session log, which must hold every replayed session.
                if rep.pool_sessions:
                    daemon._rematerialize_pool(rep.pool_sessions)
                daemon._compact_wal()
                detail["wal_replay"] = rep.counts()
                trace.event("serve.resume", source="wal",
                            tickets=len(rep.pending))
                daemon._aot_preload(detail)
                daemon._plans_note(detail)
                return daemon, "wal", detail
        if checkpoint_path and os.path.exists(checkpoint_path):
            try:
                daemon = cls.resume(checkpoint_path, policy,
                                    wal_path=wal_path,
                                    wal_fsync=wal_fsync, **kw)
            except ValueError as e:
                detail["checkpoint_error"] = str(e)[:300]
                trace.event("serve.resume.checkpoint_error",
                            error=str(e)[:200])
                q = checkpoint_mod.quarantine(checkpoint_path)
                if q:
                    detail["checkpoint_quarantine"] = q
            else:
                daemon._aot_preload(detail)
                daemon._plans_note(detail)
                return daemon, "checkpoint", detail
        daemon = cls(policy, checkpoint_path=checkpoint_path,
                     wal_path=wal_path, wal_fsync=wal_fsync, **kw)
        trace.event("serve.resume", source="fresh", tickets=0)
        daemon._plans_note(detail)
        return daemon, "fresh", detail

    def _aot_preload(self, detail: dict | None = None) -> dict | None:
        """Ensure the launch record of every bucket size up to
        ``max_batch`` for each pending Life (shape, dtype) before the first
        dispatch; returns (and records in ``detail``) the pass's stats."""
        if self._aot is None:
            return None
        boards = {(t.board.shape, str(np.asarray(t.board).dtype))
                  for t in self.queue.pending()
                  if t.board is not None and t.workload == "life"}
        if not boards:
            return None
        summary = self._aot.warm(sorted(boards), self.policy.max_batch)
        if detail is not None:
            detail["aot_preload"] = summary
        return summary

    def _plans_note(self, detail: dict | None = None) -> dict | None:
        """Record the construction's plan install in a resume detail."""
        if self._plans_summary is not None and detail is not None:
            detail["plans"] = self._plans_summary
        return self._plans_summary

    # -- the supervised loop ----------------------------------------------

    def serve(self, *, watch_signals: bool = True,
              idle_tick_s: float = 0.005) -> None:
        """Dispatch until every admitted ticket is terminal. Raises
        :class:`Preempted` (after checkpointing the queue) on SIGTERM or
        SIGINT or a chaos preemption."""
        with flush_on_signal(watch_signals) as watch:
            while True:
                dispatched = self.pump(watch=watch)
                if not self.queue.pending():
                    if self._wal is not None:
                        self._wal.sync()
                    return
                if dispatched == 0:
                    self._check_interrupts(watch)
                    horizon = self.queue.next_deadline()
                    wait = idle_tick_s
                    if horizon is not None:
                        wait = max(1e-4, horizon - self._clock())
                    self._sleep(wait)

    def pump(self, now: float | None = None, *, drain: bool = False,
             watch=None) -> int:
        """Dispatch every chunk due now (all of them when ``drain``);
        returns the number dispatched. Interrupts are honoured between
        chunks: an in-flight batch always completes."""
        now = self._clock() if now is None else now
        n = 0
        for chunk in self.queue.due_chunks(now, drain=drain):
            self._check_interrupts(watch)
            self._dispatch_chunk(chunk)
            n += 1
        if self._wal is not None and self._wal.should_compact():
            self._compact_wal()
        if self._pool is not None:
            # Lane hygiene between rounds: repack planes left sparse by
            # evicted sessions.
            self._pool.maybe_compact()
        return n

    def drain(self) -> None:
        """Flush everything pending regardless of deadlines."""
        while self.queue.pending():
            self.pump(drain=True)

    # -- internals ---------------------------------------------------------

    def _compact_wal(self) -> None:
        """Rotate the journal around the pending set, queued seconds
        folded to now."""
        now = self._clock()
        wall = time.time()
        entries = [
            {"id": t.id, "board": np.asarray(t.board), "steps": t.steps,
             "wall": wall, "session": t.session, "workload": t.workload,
             "queued_s": t.queued_before_s + (now - t.submitted_at)}
            for t in self.queue.pending() if t.board is not None
        ]
        self._wal.compact(entries, pool_sessions=self._session_log)

    def _shed_batch(self, tickets: list[Ticket], reason: str,
                    now: float) -> None:
        """Shed a group terminally, journal first (one SHED frame)."""
        if self._wal is not None and tickets:
            self._wal.shed([t.id for t in tickets], reason)
        for t in tickets:
            self.queue.shed_ticket(t, reason, now)

    def _check_interrupts(self, watch) -> None:
        if watch is not None and watch.fired is not None:
            self._preempt(signum=watch.fired)
        plan = chaos.active_plan()
        if (plan is not None and plan.preempt_pending(0)
                and self._batches >= plan.preempt_step):
            plan.preempt_fired = True
            self._preempt(simulated=True)

    def _preempt(self, signum: int | None = None,
                 simulated: bool = False) -> None:
        """Checkpoint the pending queue and stop (a ``serve.drain``
        event carries the counts and the path)."""
        path = None
        if self._wal is not None:
            self._wal.sync()
        if self.checkpoint_path:
            checkpoint_mod.save_state(
                self.checkpoint_path, self.queue.snapshot(self._clock()))
            path = self.checkpoint_path
        metrics.inc("serve.preempted")
        trace.event("serve.drain", batches=self._batches,
                    pending=self.queue.depth(), checkpoint=path or "")
        cls = SimulatedPreemption if simulated else Preempted
        raise cls(self._batches, checkpoint=path, signum=signum)

    def _validator(self, stack_shape: tuple, spec=None):
        """The check every rung's output passes before it resolves
        tickets: shape and binary cells for Life, the spec's own
        invariant (state range, finiteness) for other rules."""
        if spec is None or spec.name == "life":
            def ok(out) -> bool:
                a = np.asarray(out)
                return a.shape == stack_shape and bool((a <= 1).all())
        else:
            def ok(out) -> bool:
                a = np.asarray(out)
                return (a.shape == stack_shape
                        and all(spec.valid_board(b) for b in a))

        return ok

    def _on_device(self, stack: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(stack).to(self.device)

    def _engines(self, stack: np.ndarray, steps: int, spec=None):
        """The ladder of ``(stamp, thunk)`` rungs for one padded host
        stack (module docstring); each thunk returns a host array. The
        primary rung is the one a ``serve_fail`` fault fails; every later
        rung runs under ``chaos.suppressed()``."""
        on_card = self.device.type == "cuda"
        if spec is not None and spec.name != "life":
            return self._stencil_engines(stack, steps, spec, on_card)

        def fault() -> None:
            if chaos.take_serve_fault():
                raise RuntimeError("chaos: injected serve dispatch fault")

        try:
            path = native_life.native_path_batch(stack.shape,
                                                 on_card=on_card)
        except ValueError as e:  # no kernel covers this shape on the card
            msg = str(e)

            def no_kernel():
                raise ValueError(msg)

            return [("batch:none", no_kernel)]

        def run(runner):
            return runner(self._on_device(stack), steps).cpu().numpy()

        rungs = []
        if self._aot is not None:
            digest, record, status = self._aot.ensure(stack.shape,
                                                      stack.dtype)
            if record is not None:
                stamp = (f"aot:{path}" if status in ("memory", "hit")
                         else f"aot:{path}:{status}")

                def aot():
                    fault()
                    return self._aot.call_verified(digest, stack, steps)

                rungs.append((stamp, aot))

        def primary():
            fault()
            return run(native_life.life_run_vmem_batch)

        rungs.append((f"batch:{path}", primary))
        if path == "bitsliced":
            # One rung down: the same stack on the cell-packed ladder. On
            # the CPU that ladder is the plain loop, the rung below.
            cp_path = native_life.native_path_batch(
                stack.shape, on_card=on_card, allow_bitsliced=False)
            if cp_path != "plain":

                def cellpacked():
                    with chaos.suppressed(), \
                            native_life._bitslice_pinned(False):
                        return run(native_life.life_run_vmem_batch)

                rungs.append((f"batch:{cp_path}", cellpacked))
        if on_card:
            # The card's last rung: the primary path again, clean.
            def rerun():
                with chaos.suppressed():
                    return run(lambda s, n: native_life.run_path_batch(
                        path, s, n))

            rungs.append((f"batch:{path}", rerun))
            return rungs

        def plain():
            with chaos.suppressed():
                return run(lambda s, n: native_life.run_path_batch(
                    "plain", s, n))

        def oracle():
            with chaos.suppressed():
                return self._oracle(stencils.get("life"), stack, steps)

        return rungs + [("batch:plain", plain), ("oracle", oracle)]

    def _stencil_engines(self, stack: np.ndarray, steps: int, spec,
                         on_card: bool):
        """Every legal engine of a non-Life spec, in the JAX package's
        order (roll, padded kernel, ``sep``, ``fft``), an installed plan's
        rung first; the oracle closes the ladder off the card."""
        def rung(runner, guarded: bool):
            def go():
                if guarded and chaos.take_serve_fault():
                    raise RuntimeError(
                        "chaos: injected serve dispatch fault")
                with (contextlib.nullcontext() if guarded
                      else chaos.suppressed()):
                    return runner(spec, self._on_device(stack),
                                  steps).cpu().numpy()
            return go

        avail = [(f"batch:stencil:{spec.name}", "stencil:roll",
                  stencils.run_roll_batch)]
        if stencils.native_batch_supported(spec, stack.shape):
            avail.append((f"batch:stencil-native:{spec.name}",
                          "stencil:native", stencils.run_padded_native_batch))
        for family, ok in (("sep", stencils.separable_supported(spec)),
                           ("fft", stencils.fft_supported(spec))):
            if ok and stencils.family_allowed(family):
                avail.append((
                    f"batch:stencil-{family}:{spec.name}",
                    f"stencil:{family}",
                    lambda sp, s, n, f=family: stencils.run_family_batch(
                        sp, s, n, f)))
        planned = native_life.planned_path(spec.name, stack.shape)
        avail.sort(key=lambda e: e[1] != planned)
        rungs = [(name, rung(runner, i == 0))
                 for i, (name, _, runner) in enumerate(avail)]
        if on_card:
            return rungs

        def oracle():
            with chaos.suppressed():
                return self._oracle(spec, stack, steps)

        return rungs + [("oracle", oracle)]

    @staticmethod
    def _oracle(spec, stack: np.ndarray, steps: int) -> np.ndarray:
        out = np.array(stack, copy=True)
        for b in range(out.shape[0]):
            out[b] = stencils.oracle_run(spec, out[b], steps)
        return out

    def _dispatch_pool_chunk(self, chunk: list[Ticket]) -> None:
        """Resolve one slab group of resident step tickets with in-place
        pool dispatches. No journal frame here (each STEP frame was written
        at submit) and no timeout shed (the step is promised durable, so
        it must happen exactly once)."""
        steps = chunk[0].steps
        # Two steps of one session in one chunk would collapse in the lane
        # mask (the lane advances once, both tickets resolve): waves of
        # distinct sessions, in arrival order.
        waves: list[list[Ticket]] = []
        for t in chunk:
            for wave in waves:
                if all(w.session != t.session for w in wave):
                    wave.append(t)
                    break
            else:
                waves.append([t])
        with trace.span("serve.dispatch.pool", requests=len(chunk),
                        steps=steps):
            for wave in waves:
                self.pool.step_group([t.session for t in wave], steps)
        now = self._clock()
        for t in chunk:
            self.queue.resolve(t, None, "pool:bitsliced", now)
        if self._first_result_s is None:
            self._first_result_s = now - self._created_at
        self._batches += 1
        metrics.inc("serve.batches")

    def _dispatch_chunk(self, chunk: list[Ticket]) -> None:
        if chunk and chunk[0].handle is not None:
            self._dispatch_pool_chunk(chunk)
            return
        p = self.policy
        now = self._clock()
        # A ticket past its end-to-end budget sheds here, before the
        # device works for nobody.
        live, stale = [], []
        for t in chunk:
            if now - t.submitted_at > p.request_timeout_s:
                stale.append(t)
            else:
                live.append(t)
        self._shed_batch(stale, policy_mod.SHED_TIMEOUT, now)
        if not live:
            return

        if self._wal is not None:
            # DISPATCH before any engine runs: a death before the RESOLVE
            # frame replays these tickets as the in-flight batch.
            self._wal.dispatch_begin([t.id for t in live])
        # The fleet drill: this worker dies mid-dispatch, DISPATCH
        # journaled, no RESOLVE ever.
        if chaos.kill_worker_armed(self.worker_index):
            chaos.crash_now()
        spec = stencils.get(live[0].workload)
        shape = live[0].board.shape
        steps = live[0].steps
        padded = bucket_batch_size(
            len(live), p.max_batch,
            slice_width=self.queue._slice_width(live[0].bucket_key))
        stack = np.zeros((padded, *shape), dtype=live[0].board.dtype)
        for i, t in enumerate(live):
            stack[i] = t.board
        # Life keeps the two-argument call; other rules pass their spec.
        if spec.name == "life":
            engines = self._engines(stack, steps)
        else:
            engines = self._engines(stack, steps, spec)
        validator = self._validator(stack.shape, spec)
        # One jittered schedule per chunk, seeded off the lead ticket:
        # requeued daemons desynchronise, one run stays reproducible.
        waits = watchdog.backoff(p.backoff_base_s, p.backoff_cap_s,
                                 jitter=p.backoff_jitter,
                                 seed=p.seed + live[0].id)
        deadline = min(t.submitted_at for t in live) + p.request_timeout_s
        attempt = 0
        while True:
            delay = chaos.dispatch_delay()
            if delay:
                self._sleep(delay)
            try:
                with trace.span(
                    "serve.dispatch", shape=f"{shape[-2]}x{shape[-1]}",
                    steps=steps, requests=len(live), padded=padded,
                    workload=spec.name, attempt=attempt,
                ):
                    out, stamp, _notes = guards.with_fallback(
                        engines, validator=validator)
                break
            except guards.FallbackExhausted as e:
                attempt += 1
                self._retries += 1
                metrics.inc("serve.retries")
                trace.event("serve.retry", attempt=attempt,
                            notes="; ".join(e.notes)[:200])
                now = self._clock()
                if attempt > p.max_retries:
                    self._shed_batch(live, policy_mod.SHED_DISPATCH, now)
                    return
                wait = next(waits)
                if now + wait > deadline:
                    self._shed_batch(live, policy_mod.SHED_TIMEOUT, now)
                    return
                self._sleep(wait)

        if stamp.endswith(":recovered"):
            self._degraded += 1
            metrics.inc("serve.degraded")
            guards.record_recovery(f"serve:{stamp}")
        now = self._clock()
        host = np.asarray(out)[:len(live)]
        if self._wal is not None:
            # Crash site: batch computed, RESOLVE not journaled; a resume
            # redoes the batch (its results were never surfaced).
            if chaos.crash_armed("post-dispatch"):
                chaos.crash_now()
            self._wal.resolve([t.id for t in live], engine=stamp)
        for i, t in enumerate(live):
            self.queue.resolve(t, host[i], stamp, now)
        if self._first_result_s is None:
            self._first_result_s = now - self._created_at
        self._batches += 1
        metrics.inc("serve.batches")
        if padded > len(live):
            metrics.inc("serve.padding", padded - len(live))

    # -- accounting --------------------------------------------------------

    def summary(self) -> dict:
        """Every ticket in exactly one terminal bucket, latency
        percentiles over the resolved set, engine and reason counts, and
        the journal's, cache's and plans' own numbers."""
        tickets = self.queue.tickets()
        done = [t for t in tickets if t.state == DONE]
        shed = [t for t in tickets if t.state == SHED]
        lat = [t.latency_s for t in done]
        out = {
            "requests": len(tickets),
            "resolved": len(done),
            "shed": len(shed),
            "pending": self.queue.depth(),
            "batches": self._batches,
            "retries": self._retries,
            "degraded": self._degraded,
            "shed_reasons": dict(collections.Counter(
                t.reason for t in shed)),
            "engines": dict(collections.Counter(t.engine for t in done)),
            "p50_latency_s": round(percentile(lat, 50), 6),
            "p99_latency_s": round(percentile(lat, 99), 6),
        }
        if self._first_result_s is not None:
            out["cold_first_result_s"] = round(self._first_result_s, 6)
        if self._pool is not None:
            s = self._pool.stats()
            out["pool"] = s
            for key in ("sessions", "hits", "misses", "evictions", "spills",
                        "compactions", "settled_skips"):
                out[f"pool_{key}"] = s[key]
        if self._wal is not None:
            out["wal"] = self._wal.stats()
        if self._aot is not None:
            s = self._aot.stats()
            out["aot"] = s
            out["aot_hits"] = s["hits"]
            out["aot_misses"] = s["misses"]
            out["aot_corrupt"] = s["corrupt"]
            out["aot_stale"] = s["stale"]
            out["aot_deserialize_s"] = s["deserialize_s"]
            out["aot_build_s"] = s["build_s"]
        if self._plans_summary is not None:
            out["plans"] = self._plans_summary
            out["plans_installed"] = self._plans_summary["installed"]
        return out


# -- CLI -------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_and_open_mp_tpu_torch.serve.daemon",
        description="Fault-tolerant stencil serving daemon (PyTorch/CUDA "
        "port): submit a seeded mixed-shape burst, drain it under the "
        "supervision ladder, print ONE JSON summary line. SIGTERM "
        "checkpoints the queue and exits 75; --resume continues it.")
    p.add_argument("--requests", type=int, default=32, metavar="N",
                   help="burst size (default 32; 0 with --resume drains "
                   "the checkpoint only)")
    p.add_argument("--shapes", default="48x48,64x64", metavar="S",
                   help="comma-separated NYxNX request shapes, cycled "
                   "over the burst (default %(default)s)")
    p.add_argument("--steps", default="4,8", metavar="K",
                   help="comma-separated step counts, cycled (default "
                   "%(default)s)")
    p.add_argument("--workload", default="life", metavar="NAME",
                   help="stencil workload of the burst (life, heat, "
                   "gray_scott, wireworld, ...; default %(default)s): "
                   "boards from the spec's own seeder, dispatched through "
                   "its engine ladder")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-depth", type=int, default=4096)
    p.add_argument("--max-wait", type=float, default=0.02, metavar="S",
                   help="per-bucket deadline seconds (default 0.02)")
    p.add_argument("--timeout", type=float, default=60.0, metavar="S",
                   help="per-request end-to-end budget (default 60)")
    p.add_argument("--retries", type=int, default=2)
    p.add_argument("--max-padding-frac", type=float, default=0.375,
                   metavar="F",
                   help="admission budget for the estimated dead-padding "
                   "share of the pending set (default %(default)s)")
    p.add_argument("--backoff", default="0.05:1.0:0.5", metavar="B[:C[:J]]",
                   help="retry backoff base[:cap[:jitter]] seconds "
                   "(default %(default)s)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="queue drain checkpoint file (written on "
                   "SIGTERM/preemption)")
    p.add_argument("--wal", default=None, metavar="PATH",
                   help="write-ahead ticket journal: every transition is "
                   "durable before the daemon acts on it, so --resume "
                   "recovers from kill -9 at any instruction")
    p.add_argument("--wal-fsync", default="every-record",
                   choices=list(wal_mod.FSYNC_POLICIES),
                   help="journal durability: every-record = zero acked "
                   "loss; every-chunk = at most one batch of records; "
                   "off = page cache only (default %(default)s)")
    p.add_argument("--aot-cache", default=None, metavar="DIR",
                   help="launch-record cache directory (default "
                   "$MOMP_AOT_CACHE): the Life ladder's aot:<path> rung, "
                   "each record held against the NumPy oracle on first "
                   "use; a corrupt or stale record is quarantined and "
                   "rebuilt")
    p.add_argument("--plans", default=None, metavar="DIR",
                   help="tuned-plan store (default $MOMP_TUNE_PLANS): "
                   "records validated, parity-gated and installed before "
                   "the first dispatch; MOMP_TUNE=0 ignores the store")
    p.add_argument("--resume", action="store_true",
                   help="restore drained tickets before serving the "
                   "(possibly empty) new burst: journal replay first, "
                   "then the drain checkpoint, then fresh (needs --wal "
                   "and/or --checkpoint)")
    p.add_argument("--verify", action="store_true",
                   help="hold every resolved board against the NumPy "
                   "oracle before reporting")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where stacks run (default the card)")
    return p


def _parse_backoff(spec: str) -> tuple[float, float, float]:
    """``base[:cap[:jitter]]`` -> the three ServePolicy backoff numbers
    (missing fields keep the policy defaults)."""
    parts = [p for p in str(spec).split(":") if p != ""]
    if not 1 <= len(parts) <= 3:
        raise ValueError(
            f"--backoff wants base[:cap[:jitter]], got {spec!r}")
    base = float(parts[0])
    cap = float(parts[1]) if len(parts) > 1 else 1.0
    jitter = float(parts[2]) if len(parts) > 2 else 0.5
    return base, cap, jitter


def _parse_shapes(spec: str) -> list[tuple[int, int]]:
    shapes = []
    for tok in spec.split(","):
        ny, _, nx = tok.strip().partition("x")
        shapes.append((int(ny), int(nx)))
    return shapes


def _burst(daemon: ServingDaemon, args) -> None:
    spec = stencils.get(args.workload)
    shapes = _parse_shapes(args.shapes)
    steps = [int(s) for s in args.steps.split(",")]
    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        ny, nx = shapes[i % len(shapes)]
        daemon.submit(spec.init(rng, (ny, nx)), steps[i % len(steps)],
                      workload=spec.name)


def _verify(daemon: ServingDaemon) -> bool:
    for t in daemon.queue.tickets():
        if t.state != DONE:
            continue
        spec = stencils.get(t.workload)
        ref = stencils.oracle_run(spec, np.asarray(t.board), t.steps)
        if not stencils.parity_ok(spec, t.result, ref):
            return False
    return True


def run(argv=None) -> tuple[int, dict, ServingDaemon | None]:
    """The CLI's work: ``(exit code, the JSON record, the daemon)``;
    :func:`main` prints the record. The daemon is None when it could not
    be built."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.resume and not (args.checkpoint or args.wal):
        parser.error("--resume requires --checkpoint and/or --wal")
    resolve_device(args.device)  # no quiet fallback off the card
    aot_dir = args.aot_cache or os.environ.get("MOMP_AOT_CACHE") or None
    plans_dir = args.plans or os.environ.get("MOMP_TUNE_PLANS") or None
    try:
        backoff_base, backoff_cap, backoff_jitter = _parse_backoff(
            args.backoff)
    except ValueError as e:
        parser.error(str(e))
    policy = ServePolicy(
        max_batch=args.max_batch, max_depth=args.max_depth,
        max_padding_frac=args.max_padding_frac,
        max_wait_s=args.max_wait, request_timeout_s=args.timeout,
        max_retries=args.retries, backoff_base_s=backoff_base,
        backoff_cap_s=backoff_cap, backoff_jitter=backoff_jitter,
        seed=args.seed)
    rec: dict = {"daemon": "serve", "resume": bool(args.resume),
                 "workload": args.workload, "device": args.device}
    aot = plan_store = daemon = None
    if aot_dir:
        from mpi_and_open_mp_tpu_torch.serve.aotcache import AOTCache

        aot = AOTCache(aot_dir, device=args.device)
        rec["aot_cache"] = os.path.abspath(aot_dir)
    if plans_dir:
        from mpi_and_open_mp_tpu_torch.tune.plans import PlanStore

        plan_store = PlanStore(plans_dir, device=args.device)
        rec["plan_store"] = os.path.abspath(plans_dir)
    try:
        kw = dict(wal_fsync=args.wal_fsync, aot_cache=aot,
                  plan_store=plan_store, device=args.device)
        if args.resume:
            daemon, source, detail = ServingDaemon.resume_any(
                wal_path=args.wal, checkpoint_path=args.checkpoint,
                policy=policy, **kw)
            rec["resume_source"] = source
            rec.update(detail)
            rec["resumed_tickets"] = daemon.queue.depth()
        else:
            daemon = ServingDaemon(
                policy, checkpoint_path=args.checkpoint, wal_path=args.wal,
                **kw)
        if aot is not None and args.requests > 0 and args.workload == "life":
            # Records for every bucket the burst can need, before the
            # first dispatch (the resume warmed pending shapes only).
            rec["aot_warm"] = aot.warm(
                [(s, "uint8") for s in _parse_shapes(args.shapes)],
                policy.max_batch)
        _burst(daemon, args)
        t0 = time.perf_counter()
        daemon.serve()
        wall = time.perf_counter() - t0
    except Preempted as e:
        rec.update({"preempted": True, "resume": True,
                    "batches": e.step, "checkpoint": e.checkpoint,
                    **{k: v for k, v in daemon.summary().items()
                       if k != "engines"}})
        return EXIT_PREEMPTED, rec, daemon
    except Exception as e:  # noqa: BLE001 - the line is the contract
        rec["error"] = f"{type(e).__name__}: {e}"[:300]
        return 1, rec, daemon
    rec.update({"preempted": False, "wall_sec": round(wall, 4),
                **daemon.summary()})
    if daemon._wal is not None:
        daemon._wal.close()
    if rec["resolved"] and wall > 0:
        rec["requests_per_sec"] = round(rec["resolved"] / wall, 2)
    if args.verify:
        rec["verified"] = _verify(daemon)
    if metrics.metrics_on():
        rec["metrics"] = metrics.snapshot()
    if args.verify and not rec["verified"]:
        return 1, rec, daemon
    return 0, rec, daemon


def main(argv=None) -> int:
    rc, rec, _ = run(argv)
    print(json.dumps(rec))
    return rc


if __name__ == "__main__":
    sys.exit(main())
