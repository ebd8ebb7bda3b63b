"""Fault-isolating fleet router: N worker daemons, one queue contract.

Counterpart of ``mpi_and_open_mp_tpu/serve/router.py``, over the port's
daemons. The router holds no tensors: it moves host boards, journal
entries and session records between workers, and each worker's daemon
puts them on its own device (a re-homed session's advance is replayed on
the destination's card, rows 5 and 12 of PERF.md's kernel table). The
ring hashes exactly as the JAX package's does, so a burst partitioned or
a journal written by either package lands on the same worker.

One hardened :class:`~mpi_and_open_mp_tpu_torch.serve.daemon.ServingDaemon` is
a single failure domain — one wedge takes down the whole serving
surface, and one queue cannot drain millions-of-users traffic. This
module shards the EXISTING contract across a fleet: same
:class:`~mpi_and_open_mp_tpu_torch.serve.queue.Ticket` state machine, same
``serve.policy`` shed vocabulary, same WAL/exit-75 semantics per worker
— the router adds placement, global admission, and failure isolation on
top, never a second request lifecycle. Four responsibilities:

**Affinity** — :class:`ConsistentHashRing` maps a request's ``session``
key to a worker through a hashlib-seeded virtual-node ring. The hash is
``sha256`` over explicit strings, never Python's salted ``hash()``, so
the mapping is identical in every process that builds the same ring —
the cross-process determinism the fleet CLI leans on (the parent
partitions a burst; each worker subprocess can recompute its own slice).
Movement on resize is structurally bounded: removing a worker moves
ONLY the sessions it owned (every other session's first clockwise point
is untouched), adding one moves only sessions that now land on the new
worker's points — expected ``sessions/(N+1)``, the bounded-movement
property PAPERS.md's process-to-node mapping work asks of a placement
function under topology change.

**Global admission** — per-worker depth/padding budgets roll up into a
single :func:`serve.policy.rollup` projection; the router's door judges
the candidate against fleet-wide depth and the merged per-bucket
padding estimate BEFORE routing, then the target worker's own door
applies its local budgets. A hot shard therefore sheds (its own
``queue-depth`` / ``padding-waste``) while cold shards keep admitting —
overload degrades one shard's tail, not the fleet.

**Work stealing** — an idle worker takes the oldest whole bucket from
the deepest backlogged worker (:meth:`FleetRouter.steal`). Whole
buckets only: a bucket is one dispatch's worth of same-shape work (one
launch path and geometry), and for bitsliced shapes one 32-board plane
group — splitting it
would spend two padded dispatches where one sufficed.

**Failure isolation** — workers heartbeat by pumping; a worker that
misses ``heartbeat_miss_k`` intervals is declared wedged
(:meth:`FleetRouter.check_health`), its WAL is replayed BY THE ROUTER,
and every pending/in-flight entry re-homes to the ring minus the
victim. The DESIGN.md §10 acked-loss bounds survive fleet-wide: a
re-homed ticket sheds ``re-homed`` at the source (journal frame first,
so a second replay of the victim's WAL is idempotent) and adopts under
a fresh journaled ADMIT at its new owner, so the fleet books —
``admitted == resolved + shed + re-homed-resolved`` — balance with the
request counted exactly once, at its final owner.

The router is clock-free like ``ServeQueue`` (every decision takes
``now``), owns no threads and no IO of its own, and works against any
worker handle exposing ``index`` / ``daemon`` / ``wal_path`` /
``last_beat`` / ``wedged`` — ``serve.fleet`` provides the in-process
and subprocess harnesses.
"""

from __future__ import annotations

import bisect
import hashlib

import numpy as np

from mpi_and_open_mp_tpu_torch.obs import metrics, trace
from mpi_and_open_mp_tpu_torch.obs import telemetry as telemetry_mod
from mpi_and_open_mp_tpu_torch.robust import chaos
from mpi_and_open_mp_tpu_torch.serve import policy as policy_mod
from mpi_and_open_mp_tpu_torch.serve import wal as wal_mod
from mpi_and_open_mp_tpu_torch.serve.queue import PENDING, SHED, Ticket

#: Virtual nodes per worker. 64 points spread each worker's arc finely
#: enough that a 3-worker fleet shards a dozen sessions within ±2 of
#: even (measured in the ring property tests) while ring rebuilds stay
#: a few hundred hashes.
DEFAULT_VNODES = 64

#: Heartbeats a worker may miss before the router declares it wedged.
DEFAULT_MISS_K = 3


def _h64(s: str) -> int:
    """First 8 bytes of sha256 as an int — deterministic across
    processes and platforms (Python's builtin ``hash`` is salted per
    process; a ring built on it would shard differently in every
    worker)."""
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


class ConsistentHashRing:
    """Session→worker placement with bounded movement under resize.

    Each worker owns ``vnodes`` pseudo-random points on a 2^64 ring;
    a key maps to the worker owning the first point clockwise of the
    key's hash. ``seed`` salts every hash input, so independent fleets
    (or a test wanting a different shard pattern) get independent rings
    while any two processes with the same ``(workers, vnodes, seed)``
    agree exactly.
    """

    def __init__(self, workers=(), *, vnodes: int = DEFAULT_VNODES,
                 seed: int = 0):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self._vnodes = int(vnodes)
        self._seed = int(seed)
        self._workers: set[int] = set()
        self._points: list[tuple[int, int]] = []  # (ring point, worker)
        self._keys: list[int] = []
        for w in workers:
            self._workers.add(int(w))
        self._rebuild()

    @property
    def workers(self) -> tuple[int, ...]:
        return tuple(sorted(self._workers))

    def _rebuild(self) -> None:
        pts = []
        for w in self._workers:
            for r in range(self._vnodes):
                pts.append((_h64(f"momp-fleet/{self._seed}/w{w}/{r}"), w))
        pts.sort()
        self._points = pts
        self._keys = [p for p, _ in pts]

    def add_worker(self, worker: int) -> None:
        self._workers.add(int(worker))
        self._rebuild()

    def remove_worker(self, worker: int) -> None:
        self._workers.discard(int(worker))
        self._rebuild()

    def lookup(self, key: str) -> int:
        """The worker owning ``key``. Raises on an empty ring — routing
        with zero live workers is a fleet-down condition the caller must
        surface, not a placement question."""
        if not self._points:
            raise RuntimeError("consistent-hash ring has no live workers")
        h = _h64(f"momp-fleet/{self._seed}/key/{key}")
        i = bisect.bisect_right(self._keys, h) % len(self._points)
        return self._points[i][1]


def affinity_key(session: str | None, ticket_id: int | None = None) -> str:
    """The ring key for a request: its ``session`` when it has one, else
    a per-ticket key (no affinity to preserve — spread it)."""
    if session is not None:
        return str(session)
    return f"ticket/{ticket_id if ticket_id is not None else 0}"


class FleetRollup:
    """Merge per-worker telemetry series into fleet-wide rates/quantiles.

    The ingestion-side twin of :class:`~mpi_and_open_mp_tpu_torch.obs.
    telemetry.WorkerTelemetry`: each shipped snapshot folds its latency-
    histogram DELTA into one fleet histogram (quantiles over the merged
    buckets — no raw samples cross the wire) and supersedes the worker's
    cumulative counters. Loss accounting is per worker by sequence
    number: ``expected = max_seq + 1`` per worker lifetime, anything
    missing (ring eviction before shipping, a frame lost to a kill)
    is ``lost`` — so ``loss()`` states exactly how much of the series
    the rollup never saw, instead of silently summing what arrived.
    """

    def __init__(self, bounds=None):
        self.hist = telemetry_mod.LatencyHist(
            bounds if bounds is not None else telemetry_mod.DEFAULT_BOUNDS)
        #: worker → {"seq": last seq, "received": n, "counters": {...},
        #: "first_mono"/"last_mono"/"last_wall": clock stamps}.
        self.workers: dict[int, dict] = {}
        self.snapshots = 0
        self.rejected = 0
        #: Truncated sidecar frames folded in by the CLI reader — each
        #: is at most one lost interval, charged to loss() below.
        self.truncated = 0

    def ingest(self, snap: dict, *, worker=None) -> bool:
        """Fold one snapshot; False (and counted) on a schema mismatch.
        Out-of-order arrival is fine — seq gaps, not order, are loss.
        ``worker`` overrides the stream key: a recovery worker re-uses a
        surviving INDEX but restarts its sequence numbers, so its stream
        must roll up under its own key or the seq-gap loss accounting
        would read the restart as loss."""
        if (not isinstance(snap, dict)
                or snap.get("v") != telemetry_mod.SNAPSHOT_SCHEMA):
            self.rejected += 1
            return False
        w = int(snap["worker"]) if worker is None else worker
        st = self.workers.setdefault(w, {
            "seq": -1, "received": 0, "counters": {},
            "first_mono": float(snap["mono"]),
            "last_mono": float(snap["mono"]),
            "last_wall": float(snap["wall"]),
        })
        st["received"] += 1
        if snap["seq"] > st["seq"]:
            st["seq"] = int(snap["seq"])
            st["counters"] = dict(snap.get("counters") or {})
            st["last_mono"] = float(snap["mono"])
            st["last_wall"] = float(snap["wall"])
        st["first_mono"] = min(st["first_mono"], float(snap["mono"]))
        self.hist.merge_counts(snap.get("hist") or {})
        self.snapshots += 1
        return True

    def counter(self, name: str) -> float:
        """Fleet-wide sum of a cumulative counter's latest value."""
        return sum(st["counters"].get(name, 0)
                   for st in self.workers.values())

    def rate(self, name: str) -> float:
        """Fleet-wide rate: the summed counter over the widest
        first→last snapshot span any worker covered (one shared clock
        in-process; per-process monotonic spans are still each worker's
        own honest denominator cross-process)."""
        span = max((st["last_mono"] - st["first_mono"]
                    for st in self.workers.values()), default=0.0)
        if span <= 0:
            return 0.0
        return self.counter(name) / span

    def quantile(self, q: float) -> float:
        return self.hist.quantile(q)

    def loss(self) -> dict:
        """Snapshot-loss accounting: per-worker seq gaps plus truncated
        sidecar frames, over everything the workers ever numbered."""
        expected = sum(st["seq"] + 1 for st in self.workers.values())
        received = sum(st["received"] for st in self.workers.values())
        lost = max(expected - received, 0) + self.truncated
        expected += self.truncated
        return {
            "expected": expected, "received": received, "lost": lost,
            "truncated": self.truncated,
            "frac": round(lost / expected, 6) if expected else 0.0,
        }

    def clock_offsets(self) -> dict[int, float]:
        """Per-worker monotonic→wall offsets from the latest heartbeat
        exchange pair — the alignment the merged timeline applies."""
        return {w: round(st["last_wall"] - st["last_mono"], 6)
                for w, st in self.workers.items()}

    def summary(self) -> dict:
        h = self.hist.to_dict()
        return {
            "workers": sorted(self.workers, key=str),
            "snapshots": self.snapshots,
            "rejected": self.rejected,
            "resolved": self.counter("resolved"),
            "shed": self.counter("shed"),
            "resolved_rps": round(self.rate("resolved"), 3),
            "p50_s": h["p50_s"], "p99_s": h["p99_s"],
            "p999_s": h["p999_s"],
            "hist_count": h["count"],
            "loss": self.loss(),
        }


class FleetRouter:
    """The fault-isolating front of a worker fleet.

    ``workers`` are handles with ``index`` (stable int id), ``daemon``
    (a :class:`ServingDaemon`), ``wal_path`` (``None`` = re-home from
    the live queue instead of a journal replay), ``last_beat``
    (caller-maintained monotonic stamp) and ``wedged`` (set by the
    router, never cleared — a wedged worker leaves the fleet). The
    router never advances clocks: the fleet loop stamps beats and
    passes ``now``.
    """

    def __init__(self, workers, *, vnodes: int = DEFAULT_VNODES,
                 seed: int = 0, heartbeat_interval_s: float = 0.05,
                 heartbeat_miss_k: int = DEFAULT_MISS_K):
        ws = list(workers)
        if not ws:
            raise ValueError("FleetRouter needs at least one worker")
        if heartbeat_miss_k < 1:
            raise ValueError(
                f"heartbeat_miss_k must be >= 1, got {heartbeat_miss_k}")
        self._workers: dict[int, object] = {w.index: w for w in ws}
        if len(self._workers) != len(ws):
            raise ValueError("worker indices must be unique")
        self.ring = ConsistentHashRing(self._workers, vnodes=vnodes,
                                       seed=seed)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_miss_k = int(heartbeat_miss_k)
        self._rollup = policy_mod.rollup(
            w.daemon.policy for w in self.live_workers())
        #: The fleet-wide telemetry aggregator: the fleet loop ships
        #: each worker's snapshots here (in-process piggybacked on the
        #: heartbeat; cross-process read back from the sidecar streams).
        self.telemetry = FleetRollup()
        # Door accounting: submissions the ROUTER refused before any
        # worker saw them (fleet-wide budget breach).
        self.door_shed: dict[str, int] = {}
        self.submitted = 0
        self.rehomes = 0  # re-home MOVES (one ticket moved twice = 2)
        self.pool_rehomed = 0  # resident sessions moved off wedged workers
        self.steals = 0
        self.rejoins = 0
        self.drains = 0
        self.wedged_workers: list[int] = []
        self.drained_workers: list[int] = []
        #: Tickets adopted during the most recent wedge re-home — a kill
        #: drill reads their ``resolved_at`` stamps to measure recovery
        #: time.
        self.last_rehomed: list[Ticket] = []
        #: Whole buckets released by a donor but not yet adopted by the
        #: thief — the transfer window of a deferred steal. The door
        #: counts these against the fleet (they are admitted work) while
        #: neither worker's queue holds them, so a stolen bucket is
        #: counted against exactly ONE owner at every instant: donor
        #: before release, this ledger in transit, thief after adopt.
        self._in_transit: list[dict] = []
        #: Handles replaced by a REJOIN — their queues still hold the
        #: shed/resolved history of the pre-failure lifetime, which the
        #: fleet books must keep counting (a rejoin is a new lifetime
        #: for the INDEX, not an amnesty for the old one's ledger).
        self._retired: list = []
        #: Session → worker-index directory. The ring names a session's
        #: BIRTH worker; whole-slab-group migration (drain, rejoin
        #: claims) may land a session off its ring point, and the verbs
        #: must follow the session, not the hash.
        self._session_home: dict[str, int] = {}

    # -- topology ----------------------------------------------------------

    def live_workers(self) -> list:
        return [w for w in self._workers.values()
                if not w.wedged and not getattr(w, "drained", False)]

    def worker(self, index: int):
        return self._workers[index]

    def _recompute_rollup(self) -> None:
        live = self.live_workers()
        if live:
            self._rollup = policy_mod.rollup(w.daemon.policy for w in live)

    def add_worker(self, worker) -> None:
        """Admit a worker to the fleet mid-burst: into the worker table,
        onto the ring (bounded movement — only sessions landing on the
        new worker's points move), and — the part that used to be
        missed — into the admission projection: the door's rolled-up
        depth budget must widen the moment capacity joins, exactly as it
        narrows on a wedge, or the fleet sheds against yesterday's
        fleet size."""
        index = int(worker.index)
        if index in self._workers:
            raise ValueError(f"worker index {index} already in the fleet")
        self._workers[index] = worker
        self.ring.add_worker(index)
        self._recompute_rollup()
        trace.event("serve.fleet.join", worker=index,
                    live=len(self.live_workers()))

    def rejoin_worker(self, worker, now: float) -> int:
        """Re-admit a recovered worker under its old index — the
        membership inverse of :meth:`declare_wedged` and the missing
        half of :meth:`add_worker`.

        Three rungs, in order. (1) **Ledger continuity**: the failed
        lifetime's handle retires but its queue keeps counting in
        :meth:`books` — a rejoin is a new lifetime for the index, never
        an amnesty for the old one's re-homed sheds. (2) **Bounded
        ring re-entry**: the index returns to its OLD ring points
        (``_h64`` is a pure function of ``(seed, index, replica)``), so
        exactly the keys that left when it wedged come back — expected
        ``sessions/(N+1)`` movement, nothing else shifts. (3) **The
        claim pass**: every whole slab group whose lead session now
        lands on the rejoiner's points migrates back — journaled
        destination-first (``adopt_session`` writes CREATE+STEP on the
        rejoiner's WAL, the ``post-rejoin`` crash site fires between
        the handshake halves, then the donor's EVICT closes its books)
        and bit-exact (the claim carries the ORIGIN create board plus
        the journaled step total; the rejoiner's device replays the
        advance). Pending tickets do NOT move — they finish at their
        current owners; only placement-sticky resident state follows
        the ring. Returns the number of sessions claimed.

        The caller hands in a FRESH handle (new daemon resumed from the
        victim's own journal — which a completed wedge re-home left
        empty, so the rejoiner adopts nothing it no longer owns) and is
        responsible for the warming heartbeat cover until the rejoiner's
        first pump (``serve.fleet`` stamps ``warming`` handles in the
        shared post-round beat)."""
        index = int(worker.index)
        old = self._workers.get(index)
        if old is worker:
            raise ValueError(
                f"worker {index} rejoin needs a fresh handle, not the "
                "failed lifetime's own")
        if old is not None:
            if not (old.wedged or getattr(old, "drained", False)):
                raise ValueError(
                    f"worker {index} is live; rejoin re-admits a wedged "
                    "or drained worker (add_worker admits new ones)")
            self._retired.append(old)
        if worker.wedged or getattr(worker, "drained", False):
            raise ValueError(
                f"worker {index} rejoin handle arrives pre-failed")
        self._workers[index] = worker
        self.ring.add_worker(index)
        self._recompute_rollup()
        claimed = self._claim_sessions(worker, now)
        self.rejoins += 1
        metrics.inc("serve.fleet.rejoins")
        trace.event("serve.fleet.rejoin", worker=index, claimed=claimed,
                    live=len(self.live_workers()))
        return claimed

    def _claim_sessions(self, dest, now: float) -> int:
        """Move every whole slab group whose LEAD session's ring
        affinity is ``dest`` from its current owner. Whole groups only:
        slab-mates advance under one donated dispatch, and the lead
        (first-created) session decides the group's placement so one
        hash lookup moves one program's worth of state."""
        claimed = 0
        for src in list(self.live_workers()):
            if src.index == dest.index:
                continue
            groups = (src.daemon.pool.slab_groups()
                      if src.daemon._pool is not None
                      else {None: list(src.daemon._session_log)})
            for _, sids in groups.items():
                sids = [s for s in sids if s in src.daemon._session_log]
                if not sids:
                    continue
                if self.ring.lookup(str(sids[0])) != dest.index:
                    continue
                for sid in sids:
                    self._migrate_session(src, dest, sid)
                    claimed += 1
        return claimed

    def _migrate_session(self, src, dest, sid: str) -> None:
        """One session's membership move, destination-journal-first:
        the dest WAL gets a fresh CREATE+STEP lifetime (bit-exact —
        origin create board + journaled step total), then the source's
        EVICT frame closes its books. A crash between the halves leaves
        the session live in BOTH journals with identical resumable
        state: duplicated, never lost."""
        entry = src.daemon._session_log[sid]
        dest.daemon.adopt_session(sid, entry["board"], int(entry["steps"]))
        src.daemon.evict_session(sid)
        self._session_home[str(sid)] = dest.index
        self.pool_rehomed += 1

    # -- routing + global admission ----------------------------------------

    def target_for(self, session: str | None) -> int:
        """Affinity worker index for a session (ring over LIVE workers
        only — wedged workers left the ring when declared)."""
        return self.ring.lookup(affinity_key(session, self.submitted))

    def submit(self, board, steps: int, now: float,
               session: str | None = None) -> Ticket:
        """Route one request. Door order: (1) fleet-wide budget — the
        rolled-up depth cap and the padding estimate over every live
        worker's pending buckets plus the candidate; (2) the affinity
        worker's own door (its local depth/padding budgets — the
        hot-shard shed). Always returns a ticket; a router-door shed is
        terminal with the standard vocabulary reason, owned by no
        worker (it never existed anywhere worth replaying)."""
        self.submitted += 1
        board = np.asarray(board)
        target = self._workers[self.target_for(session)]
        reason = self._door_verdict(board, steps, target)
        if reason is not None:
            self.door_shed[reason] = self.door_shed.get(reason, 0) + 1
            t = Ticket(-self.submitted, board, int(steps), float(now),
                       state=SHED, reason=reason, resolved_at=float(now),
                       session=session)
            return t
        return target.daemon.submit(board, steps, session=session)

    def _door_verdict(self, board, steps: int, target) -> str | None:
        depth = 0
        counts: dict[tuple, int] = {}
        widths: dict[tuple, int | None] = {}
        for w in self.live_workers():
            q = w.daemon.queue
            depth += q.depth()
            for key, n in q._bucket_counts().items():
                counts[key] = counts.get(key, 0) + n
                widths.setdefault(key, q._slice_width(key))
        # Buckets parked in a steal/drain transfer window belong to the
        # fleet but to NEITHER queue right now — without this the door
        # would judge a depth that forgets admitted work mid-move (the
        # historical bug was worse: the synchronous steal double-counted
        # the bucket at donor AND thief for one round of estimates).
        for parked in self._in_transit:
            for e in parked["entries"]:
                b = np.asarray(e["board"])
                key = (b.shape, b.dtype.str, int(e["steps"]),
                       str(e.get("workload", "life")))
                depth += 1
                counts[key] = counts.get(key, 0) + 1
                widths.setdefault(key,
                                  target.daemon.queue._slice_width(key))
        cand = ((board.shape, board.dtype.str, int(steps)))
        counts[cand] = counts.get(cand, 0) + 1
        widths.setdefault(cand, target.daemon.queue._slice_width(cand))
        return policy_mod.admit(
            self._rollup, depth,
            [(n, widths[key]) for key, n in counts.items()])

    # -- device-resident sessions ------------------------------------------
    #
    # The consistent-hash ring IS the session→worker pool map: a
    # session's boards live in exactly one worker's device pool, the one
    # its key hashes to. These methods route the four lifecycle verbs;
    # a wedge re-homes the sessions themselves (create board + journaled
    # step total — one board crosses the wire, the destination's device
    # replays the advance).

    def _home_worker(self, session: str):
        """The worker actually holding ``session``. The directory
        (``_session_home``) wins over the ring: whole-slab-group moves
        (drain, rejoin claims) may place a session off its hash point,
        and a verb routed by hash alone would miss it."""
        sid = str(session)
        idx = self._session_home.get(sid)
        if idx is not None:
            w = self._workers.get(idx)
            if (w is not None and not w.wedged
                    and not getattr(w, "drained", False)):
                return w
        return self._workers[self.ring.lookup(sid)]

    def create_session(self, session: str, board, now: float):
        w = self._workers[self.ring.lookup(str(session))]
        handle = w.daemon.create_session(session, board)
        self._session_home[str(session)] = w.index
        return handle

    def step_session(self, session: str, steps: int, now: float) -> Ticket:
        # A resident step is a submission like any other: it admits a
        # ticket at its home worker, and the books identity
        # ``submitted == admitted + door_shed`` must keep holding when
        # traffic mixes one-shot boards with session steps.
        self.submitted += 1
        return self._home_worker(session).daemon \
            .submit_session(session, steps)

    def snapshot_session(self, session: str):
        return self._home_worker(session).daemon.snapshot_session(session)

    def evict_session(self, session: str):
        board = self._home_worker(session).daemon.evict_session(session)
        self._session_home.pop(str(session), None)
        return board

    # -- failure isolation -------------------------------------------------

    def check_health(self, now: float) -> list[int]:
        """Declare every worker whose beat is older than
        ``miss_k * interval`` wedged and re-home its pending set.
        Returns the indices declared THIS call."""
        horizon = self.heartbeat_miss_k * self.heartbeat_interval_s
        declared = []
        for w in list(self.live_workers()):
            if len(self.live_workers()) <= 1:
                break  # nobody left to re-home onto
            if now - w.last_beat > horizon:
                self.declare_wedged(w.index, now)
                declared.append(w.index)
        return declared

    def declare_wedged(self, index: int, now: float) -> list[Ticket]:
        """The isolation ladder for one failed worker: out of the ring →
        WAL replay (the durable truth; the live queue only cross-checks
        it) → ``re-homed`` sheds journaled back to the victim → adoption
        on the survivors by consistent hash. Returns the adopted
        tickets (also kept in :attr:`last_rehomed`)."""
        victim = self._workers[index]
        if victim.wedged:
            return []
        survivors = [w for w in self.live_workers() if w.index != index]
        if not survivors:
            raise RuntimeError(
                f"worker {index} wedged with no survivors to re-home to")
        victim.wedged = True
        self.ring.remove_worker(index)
        self.wedged_workers.append(index)
        self._recompute_rollup()

        # The whole re-home runs under chaos suppression — it is a
        # RECOVERY path, and by the repo's convention (daemon fallback
        # engines, fleet CLI strip_chaos) the fault that killed the
        # victim must not re-kill the redo. Planned membership moves
        # (rejoin claims, graceful drains) stay instrumented: their
        # ``post-rejoin``/``mid-drain`` sites fire outside this block.
        with chaos.suppressed():
            entries, pool_sessions = self._drain_victim(victim, now)
            adopted: list[Ticket] = []
            by_target: dict[int, list[dict]] = {}
            for e in entries:
                key = affinity_key(e.get("session"), e.get("id"))
                by_target.setdefault(self.ring.lookup(key), []).append(e)
            for tgt_index, group in by_target.items():
                adopted.extend(
                    self._workers[tgt_index].daemon.adopt(group, now))
            # Re-home the victim's RESIDENT SESSIONS: the ring minus the
            # victim names each session's new pool, and adopt_session
            # journals a fresh CREATE+STEP lifetime there before the
            # destination device replays the advance — the re-home
            # carries a snapshot-equivalent (create board + step total),
            # never the raw slab.
            for sid, entry in pool_sessions.items():
                tgt = self._workers[self.ring.lookup(str(sid))]
                tgt.daemon.adopt_session(sid, entry["board"],
                                         int(entry["steps"]))
                self._session_home[str(sid)] = tgt.index
                # Close the victim's books: an EVICT frame per moved
                # session (the pool twin of the re-homed SHED) makes a
                # second replay of the victim's journal find nothing
                # live.
                if victim.daemon._wal is not None:
                    victim.daemon._wal.pool_evict(sid)
                victim.daemon._session_log.pop(sid, None)
                self.pool_rehomed += 1
        self.rehomes += len(entries)
        self.last_rehomed = adopted
        metrics.inc("serve.fleet.wedged")
        metrics.inc("serve.fleet.rehomed", len(entries))
        if pool_sessions:
            metrics.inc("serve.fleet.pool_rehomed", len(pool_sessions))
        trace.event("serve.fleet.wedged", worker=index,
                    rehomed=len(entries), pool=len(pool_sessions),
                    survivors=len(survivors))
        return adopted

    def _drain_victim(self, victim, now: float) -> tuple[list[dict], dict]:
        """The victim's outstanding entries, from its journal when it
        has one (a wedged process's memory is not trustworthy; its WAL
        is), else from the live queue. Either way the victim's own books
        close: every drained ticket sheds ``re-homed`` in its queue and
        — via :meth:`ServingDaemon.release` — in its journal, so a
        second replay finds nothing pending. Returns ``(entries,
        pool_sessions)``: the second element is the victim's live
        resident-session map (WAL-replayed ``{sid: {board, steps,
        wall}}``; the in-memory session log when there is no journal)."""
        pending = victim.daemon.queue.pending()
        if victim.wal_path is None:
            return (victim.daemon.release(pending, now),
                    dict(victim.daemon._session_log))
        rep = wal_mod.replay(victim.wal_path)
        # Close the in-memory books with the same re-homed sheds (this
        # also appends the SHED frames that make the journal replay
        # idempotent). In-process the two views must agree; the journal
        # wins on any disagreement because it is what a cross-process
        # recovery would see.
        victim.daemon.release(pending, now)
        entries = []
        for e in rep.pending:
            entries.append({
                "id": e["id"], "board": e["board"], "steps": e["steps"],
                "session": e.get("session"), "wall": e.get("wall", 0.0),
                "queued_s": e.get("queued_s", 0.0),
            })
        return entries, rep.pool_sessions

    # -- graceful drain ----------------------------------------------------

    def drain_worker(self, index: int, now: float) -> dict:
        """Gracefully remove a LIVE worker — the planned inverse of
        :meth:`declare_wedged`, with the luxury a wedge never has: the
        worker is still trustworthy, so the handoff can be ordered for
        zero loss instead of reconstructed from a journal post mortem.

        The ladder: (1) **cordon** — off the ring and out of the
        rolled-up door budget, so no new work routes to it while its
        backlog unwinds; (2) **board buckets migrate whole** — each
        pending bucket adopts at ONE survivor picked by its lead
        ticket's affinity, destination journal first (the ``mid-drain``
        crash site fires between the adopt and the source's
        ``re-homed`` SHED — a kill there duplicates one bucket, never
        loses it); (3) **resident-step tickets finish locally** — their
        STEP frames are already journaled and authoritative here, so
        they dispatch before the pool moves rather than risk a
        double-apply; (4) **resident sessions migrate whole slab
        groups** (never splitting one — slab-mates share a donated
        dispatch) to each group's lead-session affinity; (5) **WAL
        compact + handoff** — the drained journal rotates around its
        now-empty pending set and syncs, so the handoff receipt is
        durable: a later replay of the drained worker's journal finds
        nothing live. Returns the migration stats dict."""
        victim = self._workers[index]
        if victim.wedged or getattr(victim, "drained", False):
            raise ValueError(
                f"worker {index} already left the fleet; drain is for "
                "live workers (a wedge is declared, not drained)")
        survivors = [w for w in self.live_workers() if w.index != index]
        if not survivors:
            raise RuntimeError(
                f"cannot drain worker {index}: no survivors to adopt "
                "its work")
        # (1) Cordon at the door: off the ring, out of the rollup. The
        # worker stays pumpable (not wedged/drained yet) so its pool
        # tickets can finish below.
        victim.cordoned = True
        self.ring.remove_worker(index)
        self._recompute_rollup_excluding(index)
        trace.event("serve.fleet.cordon", worker=index)

        # (2) Whole board buckets, destination-journal-first.
        moved_tickets = 0
        for key, group in list(victim.daemon.queue.buckets().items()):
            if key[0] == "pool":
                continue
            lead = group[0]
            tgt = self._workers[self.ring.lookup(
                affinity_key(lead.session, lead.id))]
            entries = victim.daemon.export(group, now)
            tgt.daemon.adopt(entries, now)
            # Instrumented crash site: the bucket is journaled at the
            # destination, the source's re-homed SHED is not — a kill
            # here re-dispatches the bucket at both on recovery
            # (duplicated, dispatch is pure) instead of at neither.
            if chaos.crash_armed("mid-drain"):
                chaos.crash_now()
            victim.daemon._shed_batch(group, policy_mod.SHED_REHOMED, now)
            moved_tickets += len(entries)
            self.rehomes += len(entries)

        # (3) Resident-step tickets finish here: their journaled STEP
        # frames are authoritative on THIS worker until the session
        # moves; migrating the session below carries their effect.
        rounds = 0
        while any(t.handle is not None
                  for t in victim.daemon.queue.pending()):
            victim.daemon.pump(now, drain=True)
            rounds += 1
            if rounds > 1000:
                raise RuntimeError(
                    f"worker {index} failed to finish its resident-step "
                    "tickets while draining")

        # (4) Resident sessions, whole slab groups, lead-session
        # affinity.
        moved_sessions = 0
        groups = (victim.daemon.pool.slab_groups()
                  if victim.daemon._pool is not None
                  else {None: list(victim.daemon._session_log)})
        for _, sids in groups.items():
            sids = [s for s in sids if s in victim.daemon._session_log]
            if not sids:
                continue
            tgt = self._workers[self.ring.lookup(str(sids[0]))]
            for sid in sids:
                self._migrate_session(victim, tgt, sid)
                moved_sessions += 1

        # (5) Compact + hand off the journal: the rotation snapshot is
        # the receipt — pending and pool both empty, durably.
        if victim.daemon._wal is not None:
            victim.daemon._compact_wal()
            victim.daemon._wal.sync()
        victim.drained = True
        self.drains += 1
        self.drained_workers.append(index)
        metrics.inc("serve.fleet.drains")
        trace.event("serve.fleet.drained", worker=index,
                    tickets=moved_tickets, sessions=moved_sessions,
                    survivors=len(survivors))
        return {"worker": index, "tickets_moved": moved_tickets,
                "sessions_moved": moved_sessions,
                "survivors": len(survivors)}

    def _recompute_rollup_excluding(self, index: int) -> None:
        live = [w for w in self.live_workers()
                if w.index != index and not getattr(w, "cordoned", False)]
        if live:
            self._rollup = policy_mod.rollup(w.daemon.policy for w in live)

    # -- work stealing -----------------------------------------------------

    def steal(self, now: float, *, defer: bool = False) -> int:
        """Move the oldest whole bucket from the deepest backlogged
        worker to an idle one. Whole buckets only — a bucket is one
        dispatch's worth of same-shape work (one 32-board plane group
        when bitsliced); splitting it buys a second padded
        dispatch for zero latency win. The donor keeps at least one
        bucket (stealing its last one just moves the wait). Returns the
        number of tickets moved (0 = no steal this round).

        The move is two-phase: the donor releases the bucket into the
        router's in-transit ledger, then the thief adopts it from
        there. Between the phases the bucket is counted against the
        LEDGER at the door (see :meth:`_door_verdict`) and against
        neither queue — so a stolen bucket has exactly one owner at
        every instant, where the old synchronous move briefly showed
        the same depth at donor and thief. ``defer=True`` stops after
        the park (the fleet pump delivers at the next round start, so
        the thief's door estimate settles before it adopts);
        ``defer=False`` keeps the synchronous contract for direct
        callers by delivering immediately."""
        live = self.live_workers()
        idle = [w for w in live if w.daemon.queue.depth() == 0]
        if not idle:
            return 0
        donors = [(w.daemon.queue.depth(), w) for w in live
                  if len(w.daemon.queue.buckets()) >= 2]
        if not donors:
            return 0
        _, donor = max(donors, key=lambda dw: dw[0])
        buckets = donor.daemon.queue.buckets()
        # Oldest lead ticket first: that bucket has waited longest and
        # the idle worker will dispatch it immediately.
        _, group = min(buckets.items(), key=lambda kv: kv[1][0].id)
        thief = min(idle, key=lambda w: w.index)
        entries = donor.daemon.release(group, now)
        self._in_transit.append({
            "entries": entries, "donor": donor.index,
            "thief": thief.index,
        })
        moved = len(entries)
        if not defer:
            self.deliver_in_transit(now)
        return moved

    def deliver_in_transit(self, now: float) -> int:
        """Land every parked steal at its thief. If the thief left the
        fleet while the bucket was in transit (wedged or drained
        between park and delivery), the bucket re-routes by its lead
        entry's ring affinity — parked work is admitted work; it never
        evaporates with its intended recipient. Returns tickets
        delivered."""
        delivered = 0
        parked, self._in_transit = self._in_transit, []
        for move in parked:
            entries = move["entries"]
            thief = self._workers.get(move["thief"])
            if (thief is None or thief.wedged
                    or getattr(thief, "drained", False)):
                lead = entries[0]
                thief = self._workers[self.ring.lookup(
                    affinity_key(lead.get("session"), lead.get("id")))]
            thief.daemon.adopt(entries, now)
            delivered += len(entries)
            self.steals += 1
            self.rehomes += len(entries)
            metrics.inc("serve.fleet.steals")
            trace.event("serve.fleet.steal", donor=move["donor"],
                        thief=thief.index, tickets=len(entries))
        return delivered

    def in_transit_depth(self) -> int:
        """Tickets parked between a donor's release and the thief's
        adopt. Part of the fleet's pending surface: drain loops must not
        declare the fleet empty while a bucket is mid-move."""
        return sum(len(m["entries"]) for m in self._in_transit)

    # -- accounting --------------------------------------------------------

    def books(self) -> dict:
        """Fleet-wide accounting across every worker that ever held a
        ticket — including handles retired by a REJOIN, whose queues
        still carry the failed lifetime's history. Each request is
        counted once, at its final owner: a re-home is one ``re-homed``
        shed at the source plus one adopted ticket at the destination
        (or one parked in-transit entry mid-steal), and the two must
        cancel — ``balanced`` asserts the shed/adopt pairing and the
        books equation ``admitted == resolved + shed + pending`` with
        re-homed moves netted out and the in-transit window counted as
        pending-elsewhere."""
        admitted = resolved = shed_real = rehomed_shed = pending = 0
        adopted = rehomed_resolved = 0
        for w in list(self._workers.values()) + list(self._retired):
            for t in w.daemon.queue.tickets():
                if t.resumed:
                    adopted += 1
                else:
                    admitted += 1
                if t.state == PENDING:
                    pending += 1
                elif t.reason == policy_mod.SHED_REHOMED:
                    rehomed_shed += 1
                elif t.state == SHED:
                    shed_real += 1
                else:
                    resolved += 1
                    if t.resumed:
                        rehomed_resolved += 1
        door = sum(self.door_shed.values())
        in_transit = self.in_transit_depth()
        return {
            "submitted": self.submitted,
            "door_shed": door,
            "admitted": admitted,
            "resolved": resolved,
            "shed": shed_real,
            "pending": pending,
            "rehomed": rehomed_shed,
            "rehomed_resolved": rehomed_resolved,
            "steals": self.steals,
            "rejoins": self.rejoins,
            "drains": self.drains,
            "in_transit": in_transit,
            "balanced": (rehomed_shed == adopted + in_transit
                         and admitted
                         == resolved + shed_real + pending + in_transit
                         and self.submitted == admitted + door),
        }
