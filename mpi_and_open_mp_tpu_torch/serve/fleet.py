"""Serving fleet harnesses: N workers under one FleetRouter.

Counterpart of ``mpi_and_open_mp_tpu/serve/fleet.py``, over the port's
daemons. Two deployments of the same :class:`~mpi_and_open_mp_tpu_torch.
serve.router.FleetRouter` contract:

* :class:`Fleet` — N in-process :class:`ServingDaemon` workers sharing
  one injectable clock, each on ``device`` (the card unless the caller
  asks for the CPU; the workers share the card and its stream). The
  tests and ``chip_smoke.py`` drive it: deterministic, no subprocess
  spawn tax, wedges simulated by halting a worker's pump (its heartbeat
  stops, the router declares it, the WAL replay + re-home ladder runs for
  real against the worker's real journal).
* The module CLI (``python -m mpi_and_open_mp_tpu_torch.serve.fleet``) —
  the cross-process deployment: a parent partitions a seeded burst by
  consistent hash, writes one spool per worker, spawns one subprocess per
  worker (``--worker-main``, each on ``--device``), and when a worker dies
  (rc 137 from the ``kill_worker=<i>:<k>`` chaos token —
  indistinguishable from ``kill -9``) replays the victim's WAL, journals
  the ``re-homed`` sheds back to it, and spawns recovery workers for the
  re-homed entries on the surviving ring. One JSON line with the fleet
  books; the parity gate (``--verify``) covers every resolved ticket
  INCLUDING the re-homed ones. On the card the parent builds the kernel
  libraries (``ops._build``) before it spawns, so that N workers do not
  each run ``nvcc`` on the same sources.

Spools, journals and telemetry frames carry numpy arrays and JSON only,
never tensors, so the JAX package reads them (``utils.checkpoint``,
``serve.wal``, ``obs.telemetry``). The unit of failure is one worker,
the unit of recovery is one ticket, and the books must balance
fleet-wide either way (``docs/DESIGN.md`` §13).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.obs import metrics as obs_metrics
from mpi_and_open_mp_tpu_torch.obs import telemetry as telemetry_mod
from mpi_and_open_mp_tpu_torch.obs import trace as obs_trace
from mpi_and_open_mp_tpu_torch.serve import policy as policy_mod
from mpi_and_open_mp_tpu_torch.serve import wal as wal_mod
from mpi_and_open_mp_tpu_torch.serve.daemon import (
    ServingDaemon, _parse_shapes, _verify)
from mpi_and_open_mp_tpu_torch.serve.policy import ServePolicy, percentile
from mpi_and_open_mp_tpu_torch.serve.queue import DONE, SHED, Ticket
from mpi_and_open_mp_tpu_torch.serve.router import (
    DEFAULT_MISS_K, DEFAULT_VNODES, ConsistentHashRing, FleetRollup,
    FleetRouter, affinity_key)
from mpi_and_open_mp_tpu_torch.utils import checkpoint as checkpoint_mod
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

SPOOL_SCHEMA = "momp-fleet-spool/1"

#: The kernel libraries a Life worker can launch (the batched ladder's
#: paths and the session pool's), built by the CLI's parent before it
#: spawns workers on the card.
WORKER_LIBRARIES = ("bitlife_vmem_batch", "bitlife_bitsliced",
                    "bitlife_fused", "bitlife_window", "pool_lanes")


@dataclasses.dataclass
class WorkerHandle:
    """One worker as the router sees it: identity, daemon, journal
    path, and liveness. ``halted`` is the in-process wedge simulation
    (the fleet loop stops pumping it, so its heartbeat goes stale);
    ``wedged`` is the router's verdict and is never cleared.

    The membership flags: ``warming`` marks a worker after a spawn or
    REJOIN, still loading its launch records and kernel libraries —
    alive but not yet pumping, so the fleet loop stamps its beat in the
    shared post-round beat (the same cover a slow first dispatch gets)
    until its first completed pump clears the flag. ``cordoned`` means the router
    took it off the ring mid-drain; ``drained`` is the graceful-exit
    terminal state (like ``wedged``, never cleared — a returning worker
    REJOINS under a fresh handle)."""

    index: int
    daemon: ServingDaemon
    wal_path: str | None = None
    last_beat: float = 0.0
    wedged: bool = False
    halted: bool = False
    warming: bool = False
    cordoned: bool = False
    drained: bool = False


class Fleet:
    """N in-process workers behind one router, one injectable clock.

    ``policies`` (one per worker) overrides the uniform ``policy`` —
    fleet workers may run heterogeneous budgets (the rollup projection
    and the per-worker doors are exercised either way). With a
    ``wal_dir`` every worker journals to ``<wal_dir>/worker<i>.wal``
    and a wedge re-homes from the journal replay; without one the
    re-home falls back to the live queue snapshot. Every daemon the fleet
    builds (at construction, spawn and rejoin) runs on ``device``: the
    card unless the caller asks for the CPU, with no quiet fallback.
    """

    def __init__(self, n_workers: int, policy: ServePolicy | None = None,
                 *, policies: list[ServePolicy] | None = None,
                 wal_dir: str | None = None,
                 wal_fsync: str = "every-record",
                 heartbeat_interval_s: float = 0.02,
                 heartbeat_miss_k: int = DEFAULT_MISS_K,
                 steal: bool = True,
                 elasticity: policy_mod.ElasticityPolicy | None = None,
                 elastic_window_s: float = 1.0,
                 telemetry: bool | None = None,
                 telemetry_interval_s: float | None = None,
                 vnodes: int = DEFAULT_VNODES, seed: int = 0,
                 device: str = "cuda",
                 clock=time.monotonic, sleep=time.sleep):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        if policies is not None and len(policies) != n_workers:
            raise ValueError(
                f"got {len(policies)} policies for {n_workers} workers")
        if policies is None:
            policies = [policy or ServePolicy()] * n_workers
        self.device = resolve_device(device)
        self._clock = clock
        self._sleep = sleep
        self._steal_enabled = steal
        self._wal_dir = wal_dir
        self._wal_fsync = wal_fsync
        self._spawn_policy = policies[-1]
        #: SLO-driven scaling: None = fixed fleet (the default — scaling
        #: is an OPERATOR policy, opted into per deployment). With a
        #: policy, every pump round feeds the hysteresis controller a
        #: rolling-window p99 + fleet depth; ``add`` spawns a warming
        #: worker, ``drain`` gracefully retires the shallowest one.
        self.controller = (policy_mod.ElasticController(elasticity)
                           if elasticity is not None else None)
        self._elastic_window_s = float(elastic_window_s)
        #: The telemetry plane: per-worker snapshot recorders shipped
        #: into the router's FleetRollup on the shared post-round beat
        #: (snapshots piggyback the heartbeat — a worker alive enough to
        #: beat is alive enough to report), plus the multi-window SLO
        #: burn-rate monitor whose window values every scale/drain
        #: decision records. ``MOMP_TELEMETRY=0`` (or telemetry=False)
        #: turns the whole plane off.
        self._telemetry_on = (telemetry_mod.telemetry_on()
                              if telemetry is None else bool(telemetry))
        self._telemetry_interval_s = (
            telemetry_mod.snapshot_interval_s()
            if telemetry_interval_s is None else float(telemetry_interval_s))
        epol = elasticity or policy_mod.ElasticityPolicy()
        self.burn = telemetry_mod.BurnRateMonitor(
            slo_p99_s=epol.slo_p99_s, goodput_frac=epol.slo_goodput_frac,
            short_window_s=self._elastic_window_s / 4,
            long_window_s=self._elastic_window_s,
        ) if self._telemetry_on else None
        #: Recorded elasticity decisions, each carrying the burn-rate
        #: window values that triggered it — the queryable record the
        #: "every decision explainable from recorded data" rule asks
        #: for (also emitted as ``serve.fleet.scale`` trace events).
        self.decisions: list[dict] = []
        self._wtel: dict[int, telemetry_mod.WorkerTelemetry] = {}
        self._tel_seen: dict[int, set] = {}
        self._tel_counts: dict[int, dict] = {}
        self._door_seen = 0
        self.handles: list[WorkerHandle] = []
        for i in range(n_workers):
            wal_path = (os.path.join(wal_dir, f"worker{i}.wal")
                        if wal_dir else None)
            d = ServingDaemon(policies[i], wal_path=wal_path,
                              wal_fsync=wal_fsync, worker_index=i,
                              device=self.device, clock=clock, sleep=sleep)
            self.handles.append(WorkerHandle(
                index=i, daemon=d, wal_path=wal_path, last_beat=clock()))
        self.router = FleetRouter(
            self.handles, vnodes=vnodes, seed=seed,
            heartbeat_interval_s=heartbeat_interval_s,
            heartbeat_miss_k=heartbeat_miss_k)

    # -- traffic -----------------------------------------------------------

    def submit(self, board, steps: int, session: str | None = None) -> Ticket:
        return self.router.submit(board, steps, self._clock(),
                                  session=session)

    def create_session(self, session: str, board):
        """Admit a resident session into its affinity worker's device
        pool (the ring is the session→pool map)."""
        return self.router.create_session(session, board, self._clock())

    def step_session(self, session: str, steps: int) -> Ticket:
        return self.router.step_session(session, steps, self._clock())

    def snapshot_session(self, session: str):
        return self.router.snapshot_session(session)

    def evict_session(self, session: str):
        return self.router.evict_session(session)

    def wedge(self, index: int) -> None:
        """Simulate a wedged worker: stop pumping it. Its heartbeat
        goes stale and the ROUTER must notice (``check_health``) —
        nothing here shortcuts the detection ladder."""
        for h in self.handles:
            if h.index == index:
                h.halted = True
                return
        raise ValueError(f"no worker with index {index}")

    # -- elastic membership --------------------------------------------------

    def _handle_at(self, index: int) -> WorkerHandle:
        for h in self.handles:
            if h.index == index:
                return h
        raise ValueError(f"no worker with index {index}")

    def rejoin_worker(self, index: int) -> int:
        """Bring a wedged (or drained) worker back: resume a FRESH
        daemon from the victim's own journal — the WAL handshake; a
        completed wedge re-home left it holding only the work the fleet
        never reassigned, so the rejoiner adopts exactly its claimed
        sessions and nothing else — then re-enter the ring under the
        old index (bounded movement: the old points come back, nothing
        else shifts) and claim back the whole slab groups that hash to
        it. The handle rejoins WARMING: the shared post-round beat
        covers it until its first pump, so the wedge horizon cannot
        re-declare it mid-warmup. Returns the number of
        sessions claimed."""
        old = self._handle_at(index)
        if not (old.wedged or old.drained):
            raise ValueError(
                f"worker {index} is live; rejoin re-admits a wedged or "
                "drained worker")
        d, _source, detail = ServingDaemon.resume_any(
            wal_path=old.wal_path, policy=old.daemon.policy,
            wal_fsync=self._wal_fsync, worker_index=index,
            device=self.device, clock=self._clock, sleep=self._sleep)
        fresh = WorkerHandle(index=index, daemon=d,
                             wal_path=old.wal_path,
                             last_beat=self._clock(), warming=True)
        claimed = self.router.rejoin_worker(fresh, self._clock())
        # The old handle leaves the pump loop but stays on the router's
        # retired list: its queue's history keeps counting in the books.
        self.handles[self.handles.index(old)] = fresh
        return claimed

    def drain_worker(self, index: int) -> dict:
        """Gracefully retire a live worker: cordon, migrate whole
        buckets and whole slab groups to the survivors, compact + sync
        its journal as the handoff receipt. Zero acked loss by
        construction — every pending entry adopts at its destination
        before the source sheds it."""
        return self.router.drain_worker(index, self._clock())

    def spawn_worker(self) -> WorkerHandle:
        """Add a brand-new worker under the next free index (the
        elasticity ``add`` verb). It joins WARMING — the post-round beat
        covers it until its first pump — and the ring/rollup widen via
        :meth:`FleetRouter.add_worker`."""
        index = max(h.index for h in self.handles) + 1
        wal_path = (os.path.join(self._wal_dir, f"worker{index}.wal")
                    if self._wal_dir else None)
        d = ServingDaemon(self._spawn_policy, wal_path=wal_path,
                          wal_fsync=self._wal_fsync, worker_index=index,
                          device=self.device, clock=self._clock,
                          sleep=self._sleep)
        h = WorkerHandle(index=index, daemon=d, wal_path=wal_path,
                         last_beat=self._clock(), warming=True)
        self.router.add_worker(h)
        self.handles.append(h)
        return h

    def _autoscale(self, now: float) -> None:
        """One elasticity tick: rolling-window p99 + fleet depth into
        the hysteresis controller; act on its verdict. The controller
        owns the flap protection (breach/surplus streaks + cooldown);
        the fleet owns the verbs."""
        window = self._elastic_window_s
        lat = [t.latency_s for t in self.resolved_tickets()
               if t.resolved_at is not None
               and now - t.resolved_at <= window]
        p99 = percentile(lat, 99) if lat else 0.0
        live = self.router.live_workers()
        depth = self.pending()
        verdict = self.controller.observe(
            p99_s=p99, depth=depth, workers=len(live))
        if verdict is not None:
            # Every scale/drain verdict lands as recorded telemetry
            # WITH the burn-rate window values that triggered it — the
            # decision must be explainable from the recorded data alone.
            decision = {
                "action": verdict, "p99_s": round(p99, 6), "depth": depth,
                "workers": len(live), "mono": round(now, 6),
                **(self.burn.windows(now) if self.burn is not None else {}),
            }
            self.decisions.append(decision)
            obs_metrics.inc("serve.fleet.scale_decisions", action=verdict)
            obs_trace.event("serve.fleet.scale", **decision)
        if verdict == policy_mod.SCALE_ADD:
            self.spawn_worker()
        elif verdict == policy_mod.SCALE_DRAIN and len(live) > 1:
            # The shallowest live worker has the least to migrate; never
            # the last one.
            victim = min(
                (w for w in live if not getattr(w, "warming", False)),
                key=lambda w: w.daemon.queue.depth(), default=None)
            if victim is not None and len(live) > 1:
                self.router.drain_worker(victim.index, now)

    # -- the fleet loop ----------------------------------------------------

    def pump(self, *, drain: bool = False) -> int:
        """One fleet round: deliver any bucket parked mid-steal, every
        live worker pumps (its beat), then health check, a steal round,
        and the elasticity tick. Returns batches dispatched."""
        self.router.deliver_in_transit(self._clock())
        n = 0
        pumped = []
        for h in self.handles:
            if h.wedged or h.halted or h.drained:
                continue
            n += h.daemon.pump(self._clock(), drain=drain)
            pumped.append(h)
        # One shared post-round beat: a worker that just pumped is alive
        # by definition, however long the round took (N daemons share one
        # card and its stream, and a worker's first dispatch loads its
        # kernel libraries — per-worker stamps taken mid-round would look
        # stale against the round-end clock and false-wedge healthy
        # workers). The beat also covers WARMING workers — a rejoiner is
        # alive but has not pumped yet; without the stamp the wedge horizon would re-
        # declare it mid-warmup (the rejoin twin of the slow-pump
        # false wedge). Only never-pumped (halted) workers go stale.
        now = self._clock()
        for h in pumped:
            h.last_beat = now
            h.warming = False  # first completed pump ends the warmup
        for h in self.handles:
            if h.warming and not (h.wedged or h.drained):
                h.last_beat = now
        self.router.check_health(now)
        if self._steal_enabled:
            self.router.steal(self._clock(), defer=True)
        if self._telemetry_on:
            # Snapshot shipping rides the same post-round beat: the
            # telemetry tick runs BEFORE the elasticity tick, so a
            # burn-rate alert is on the record before any decision it
            # triggers (the merged timeline shows cause, then action).
            self._telemetry_tick(now)
        if self.controller is not None:
            self._autoscale(now)
        return n

    # -- telemetry ---------------------------------------------------------

    def _worker_telemetry(self, h: WorkerHandle):
        """The recorder for one handle LIFETIME (a rejoin's fresh handle
        gets a fresh series under the same worker index)."""
        wt = self._wtel.get(id(h))
        if wt is None:
            wt = telemetry_mod.WorkerTelemetry(
                h.index, interval_s=self._telemetry_interval_s)
            self._wtel[id(h)] = wt
            self._tel_seen[id(h)] = set()
            self._tel_counts[id(h)] = {"resolved": 0, "shed": 0}
        return wt

    def _telemetry_tick(self, now: float, *, force: bool = False) -> None:
        """Ship every due worker's snapshot into the router's rollup and
        feed the burn monitor the interval's good/bad counts. Interval-
        gated per worker; ``force`` flushes everyone (the end-of-run
        sample that makes surviving workers lose zero telemetry)."""
        good = bad = 0
        sampled = False
        for h in self.handles:
            if h.wedged or h.drained:
                continue  # frozen books; the last live sample stands
            wt = self._worker_telemetry(h)
            if not (force or wt.due(now)):
                continue
            seen = self._tel_seen[id(h)]
            counts = self._tel_counts[id(h)]
            for t in h.daemon.queue.tickets():
                if t.id in seen:
                    continue
                if t.state == DONE:
                    seen.add(t.id)
                    counts["resolved"] += 1
                    wt.observe_latency(t.latency_s)
                    if self.burn is not None and \
                            self.burn.is_bad(t.latency_s):
                        bad += 1
                    else:
                        good += 1
                elif (t.state == SHED
                      and t.reason != policy_mod.SHED_REHOMED):
                    # A real shed spends error budget; a re-homed ticket
                    # is a move, not an outcome — it resolves (or sheds)
                    # at its final owner and is judged there.
                    seen.add(t.id)
                    counts["shed"] += 1
                    bad += 1
            snap = wt.sample(now, {
                **counts, "depth": h.daemon.queue.depth(),
            }, force=force)
            if snap is not None:
                self.router.telemetry.ingest(snap)
                sampled = True
        if self.burn is None or not sampled:
            return
        door = sum(self.router.door_shed.values())
        bad += door - self._door_seen
        self._door_seen = door
        win = self.burn.observe(now, good, bad)
        if win.pop("alert_edge", False):
            obs_metrics.inc("serve.fleet.burn_alerts")
            obs_trace.event("serve.fleet.burn", mono=round(now, 6), **win)

    def pending(self) -> int:
        return (sum(h.daemon.queue.depth() for h in self.handles)
                + self.router.in_transit_depth())

    def serve_until_drained(self, *, drain: bool = False,
                            timeout_s: float = 120.0) -> None:
        """Pump until every admitted ticket fleet-wide is terminal. A
        halted worker's pending set drains via the wedge ladder: its
        beat goes stale while the loop idles, ``check_health`` declares
        it, and the re-homed tickets finish on the survivors."""
        start = self._clock()
        while self.pending():
            n = self.pump(drain=drain)
            if n == 0:
                self._sleep(max(1e-4, self.router.heartbeat_interval_s))
            if self._clock() - start > timeout_s:
                raise RuntimeError(
                    f"fleet failed to drain within {timeout_s}s "
                    f"({self.pending()} tickets pending)")
        if self._telemetry_on:
            # Final forced flush: every surviving worker's last interval
            # ships, so the rollup loses zero telemetry from survivors
            # (dead workers lose at most their final interval, counted).
            self._telemetry_tick(self._clock(), force=True)
        for h in self.handles:
            if h.daemon._wal is not None and not h.wedged:
                h.daemon._wal.sync()

    # -- accounting --------------------------------------------------------

    def resolved_tickets(self) -> list[Ticket]:
        """Every resolved ticket fleet-wide, INCLUDING the pre-failure
        lifetimes of rejoined workers (retired handles) — the parity
        gate and latency percentiles must cover work resolved before a
        membership change, not just the current roster's."""
        handles = list(self.handles) + list(self.router._retired)
        return [t for h in handles
                for t in h.daemon.queue.tickets() if t.state == DONE]

    def summary(self) -> dict:
        """Fleet books + aggregate latency over every resolved ticket
        (re-homed tickets carry their full cross-worker latency via the
        queued-seconds carry)."""
        books = self.router.books()
        lat = [t.latency_s for t in self.resolved_tickets()]
        books.update({
            "workers": len(self.handles),
            "wedged": list(self.router.wedged_workers),
            "drained": list(self.router.drained_workers),
            "p50_latency_s": round(percentile(lat, 50), 6),
            "p99_latency_s": round(percentile(lat, 99), 6),
        })
        return books


# -- cross-process CLI -----------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_and_open_mp_tpu_torch.serve.fleet",
        description="Sharded serving fleet driver: partition a seeded "
        "burst across N worker subprocesses by consistent-hash session "
        "affinity, survive worker deaths by WAL replay + re-home, print "
        "ONE JSON line with the fleet books. The MOMP_CHAOS "
        "kill_worker=<i>:<k> token hard-kills worker <i> mid-dispatch "
        "(rc 137) — the books must still balance with zero acked loss.")
    p.add_argument("--workers", type=int, default=3, metavar="N")
    p.add_argument("--requests", type=int, default=48, metavar="R")
    p.add_argument("--sessions", type=int, default=12, metavar="S",
                   help="distinct session keys cycled over the burst "
                   "(default %(default)s)")
    p.add_argument("--shapes", default="48x48,64x64", metavar="S")
    p.add_argument("--steps", default="4,8", metavar="K")
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-depth", type=int, default=4096)
    p.add_argument("--max-wait", type=float, default=0.02, metavar="S")
    p.add_argument("--timeout", type=float, default=60.0, metavar="S")
    p.add_argument("--max-padding-frac", type=float, default=0.375)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vnodes", type=int, default=DEFAULT_VNODES)
    p.add_argument("--dir", default=None, metavar="PATH",
                   help="state directory for spools/journals/worker "
                   "logs (default: a fresh temp dir)")
    p.add_argument("--verify", action="store_true",
                   help="each worker gates every resolved board "
                   "bit-exact against the NumPy oracle (a Life board on "
                   "the card: against the plain packed loop on the card) "
                   "— including the re-homed tickets on recovery workers")
    p.add_argument("--slo-p99", type=float, default=0.25, metavar="S",
                   help="latency SLO threshold the telemetry plane "
                   "classifies resolved tickets against (default "
                   "%(default)s s)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where every worker's stacks and sessions run "
                   "(default the card)")
    # Internal: run as one fleet worker over a spool file.
    p.add_argument("--worker-main", type=int, default=None, metavar="I",
                   help=argparse.SUPPRESS)
    p.add_argument("--spool", default=None, help=argparse.SUPPRESS)
    p.add_argument("--wal", default=None, help=argparse.SUPPRESS)
    p.add_argument("--telemetry-sidecar", default=None,
                   help=argparse.SUPPRESS)
    return p


def _policy(args) -> ServePolicy:
    return ServePolicy(
        max_batch=args.max_batch, max_depth=args.max_depth,
        max_padding_frac=args.max_padding_frac,
        max_wait_s=args.max_wait, request_timeout_s=args.timeout,
        seed=args.seed)


def _worker_main(args) -> int:
    """One fleet worker: drain a spool under the full daemon contract
    (WAL, chaos sites, supervision ladder), print one JSON line."""
    idx = args.worker_main
    spool = checkpoint_mod.restore_state(args.spool)
    if spool.get("schema") != SPOOL_SCHEMA:
        print(json.dumps({"worker": idx, "error": "bad spool schema"}))
        return 1
    try:
        daemon = ServingDaemon(_policy(args), wal_path=args.wal,
                               worker_index=idx, device=args.device)
    except Exception as e:  # noqa: BLE001 — the line IS the contract
        print(json.dumps({"worker": idx,
                          "error": f"{type(e).__name__}: {e}"[:300]}))
        return 1
    rehomed = [e for e in spool["entries"] if e.get("rehomed")]
    fresh = [e for e in spool["entries"] if not e.get("rehomed")]
    daemon.adopt(rehomed)
    for e in fresh:
        daemon.submit(e["board"], e["steps"], session=e.get("session"))

    shipper = None
    if args.telemetry_sidecar and telemetry_mod.telemetry_on():
        # The sidecar stream: a daemon thread frames periodic snapshots
        # into the per-worker file the parent merges post-run. A kill -9
        # stops the writer mid-frame at worst — the CRC framing bounds
        # the loss to this worker's final interval, and the parent
        # COUNTS it (`telemetry.loss`).
        seen: set = set()
        counts = {"resolved": 0, "shed": 0, "good": 0, "bad": 0}

        def _sample():
            new_lat = []
            for t in daemon.queue.tickets():
                if t.id in seen:
                    continue
                if t.state == DONE:
                    seen.add(t.id)
                    counts["resolved"] += 1
                    new_lat.append(t.latency_s)
                    if t.latency_s > args.slo_p99:
                        counts["bad"] += 1
                    else:
                        counts["good"] += 1
                elif t.state == SHED:
                    seen.add(t.id)
                    counts["shed"] += 1
                    if t.reason != policy_mod.SHED_REHOMED:
                        counts["bad"] += 1
            return (dict(counts, depth=daemon.queue.depth()), new_lat)

        shipper = telemetry_mod.SnapshotShipper(
            args.telemetry_sidecar, idx, _sample).start()

    t0 = time.perf_counter()
    try:
        daemon.serve(watch_signals=True)
    except Exception as e:  # noqa: BLE001 — the line IS the contract
        print(json.dumps({"worker": idx,
                          "error": f"{type(e).__name__}: {e}"[:300]}))
        return 1
    finally:
        if shipper is not None:
            shipper.stop()
    rec = {"worker": idx, "wall_sec": round(time.perf_counter() - t0, 4),
           **{k: v for k, v in daemon.summary().items() if k != "engines"}}
    if args.verify:
        rec["verified"] = _verify_worker(daemon)
    if daemon._wal is not None:
        daemon._wal.close()
    print(json.dumps(rec))
    return 0 if (not args.verify or rec.get("verified")) else 1


def _verify_worker(daemon: ServingDaemon) -> bool:
    """``--verify`` for one worker: every resolved board bit-exact. On the
    CPU, and for other stencil rules, against the NumPy oracle (the
    daemon's ``_verify``, JAX's gate). A Life board on the card is held
    instead against the plain packed loop on the card, one call a
    (shape, steps) bucket: the oracle's loop on the host takes seconds a
    500x500 board at 1000 steps, and the plain loop shares no code with
    the kernels that served the board."""
    if daemon.device.type != "cuda":
        return _verify(daemon)
    import torch

    from mpi_and_open_mp_tpu_torch.ops import bitlife

    groups: dict[tuple, list[Ticket]] = {}
    others = []
    for t in daemon.queue.tickets():
        if t.state != DONE or t.board is None:
            continue
        if t.workload == "life":
            groups.setdefault((t.board.shape, t.steps), []).append(t)
        else:
            others.append(t)
    for (_, steps), ts in groups.items():
        stack = torch.from_numpy(np.stack([t.board for t in ts])).to(
            daemon.device)
        want = bitlife.life_run_bits_plain_batch(stack, steps).cpu().numpy()
        if not np.array_equal(np.stack([t.result for t in ts]), want):
            return False
    for t in others:
        spec = stencils.get(t.workload)
        ref = stencils.oracle_run(spec, np.asarray(t.board), t.steps)
        if not stencils.parity_ok(spec, t.result, ref):
            return False
    return True


def _spawn_worker(args, idx: int, spool_path: str, wal_path: str,
                  out_path: str, *, strip_chaos: bool = False):
    cmd = [sys.executable, "-m", "mpi_and_open_mp_tpu_torch.serve.fleet",
           "--worker-main", str(idx), "--spool", spool_path,
           "--wal", wal_path, "--device", args.device,
           "--max-batch", str(args.max_batch),
           "--max-depth", str(args.max_depth),
           "--max-wait", str(args.max_wait),
           "--timeout", str(args.timeout),
           "--max-padding-frac", str(args.max_padding_frac),
           "--seed", str(args.seed),
           "--slo-p99", str(args.slo_p99)]
    if args.verify:
        cmd.append("--verify")
    env = dict(os.environ)
    stem = out_path[:-4] if out_path.endswith(".out") else out_path
    if telemetry_mod.telemetry_on():
        cmd += ["--telemetry-sidecar", stem + ".telemetry.bin"]
    if obs_trace.enabled():
        # Per-worker trace sink: every subprocess appends to its OWN
        # JSONL next to its stdout, so the merged Perfetto timeline
        # (analysis/fleet_report.py) gets one track per worker without
        # interleaved writes to the parent's file.
        env["MOMP_TRACE"] = stem + ".trace.jsonl"
    if strip_chaos:
        # Recovery workers run clean by the same convention as the
        # in-process ladder's chaos.suppressed(): the fault that killed
        # the victim must not re-kill the redo.
        env.pop("MOMP_CHAOS", None)
    out = open(out_path, "wb")
    err = open(out_path + ".err", "wb")
    return subprocess.Popen(cmd, stdout=out, stderr=err, env=env)


def _read_worker_line(out_path: str) -> dict | None:
    try:
        with open(out_path, "rb") as fd:
            lines = [ln for ln in fd.read().decode(
                "utf-8", "replace").splitlines() if ln.strip()]
    except OSError:
        return None
    for ln in reversed(lines):
        try:
            return json.loads(ln)
        except json.JSONDecodeError:
            continue
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker_main is not None:
        if not (args.spool and args.wal):
            build_parser().error("--worker-main requires --spool and --wal")
        return _worker_main(args)

    # No quiet fallback off the card; on the card, one build of every
    # library a worker can launch before any worker starts.
    resolve_device(args.device)
    if args.device == "cuda":
        from mpi_and_open_mp_tpu_torch.ops import _build

        _build.build(WORKER_LIBRARIES)

    state_dir = args.dir or tempfile.mkdtemp(prefix="momp-fleet-")
    os.makedirs(state_dir, exist_ok=True)
    n = args.workers
    policy = _policy(args)
    roll = policy_mod.rollup([policy] * n)
    ring = ConsistentHashRing(range(n), vnodes=args.vnodes, seed=args.seed)

    # Partition the seeded burst by session affinity, with the parent
    # door applying the rolled-up + per-worker DEPTH budgets (padding
    # projection stays at each worker's own door — the parent holds no
    # queue to estimate against).
    shapes = _parse_shapes(args.shapes)
    step_list = [int(s) for s in args.steps.split(",")]
    rng = np.random.default_rng(args.seed)
    spools: dict[int, list[dict]] = {i: [] for i in range(n)}
    door_shed = 0
    for i in range(args.requests):
        ny, nx = shapes[i % len(shapes)]
        board = (rng.random((ny, nx)) < 0.3).astype(np.uint8)
        session = f"s{i % max(1, args.sessions):04d}"
        w = ring.lookup(affinity_key(session))
        total = sum(len(v) for v in spools.values())
        if total >= roll.max_depth or len(spools[w]) >= policy.max_depth:
            door_shed += 1
            continue
        spools[w].append({"board": board, "steps":
                          step_list[i % len(step_list)],
                          "session": session})

    t_start = time.perf_counter()
    procs = {}
    wal_paths = {}
    for i in range(n):
        spool_path = os.path.join(state_dir, f"worker{i}.spool")
        wal_paths[i] = os.path.join(state_dir, f"worker{i}.wal")
        checkpoint_mod.save_state(spool_path, {
            "schema": SPOOL_SCHEMA, "worker": i, "entries": spools[i]})
        procs[i] = _spawn_worker(
            args, i, spool_path, wal_paths[i],
            os.path.join(state_dir, f"worker{i}.out"))
    # -- failure domain: as soon as a worker dies, replay its WAL, journal
    # the re-homed sheds back to it and start its recovery workers, beside
    # the survivors still serving --------------------------------------
    rcs: dict[int, int] = {}
    victims: list[int] = []
    deaths: list[tuple[int, float, int]] = []  # (victim, wall, pending)
    recovery: list[tuple[int, int, str, subprocess.Popen]] = []
    rehomed = 0
    victim_resolved = victim_shed = 0
    t_kill = None
    while len(rcs) < n:
        for v, proc in procs.items():
            if v in rcs or proc.poll() is None:
                continue
            rcs[v] = proc.returncode
            if rcs[v] == 0:
                continue
            victims.append(v)
            if t_kill is None:
                t_kill = time.perf_counter()
            rep = wal_mod.replay(wal_paths[v])
            victim_resolved += len(rep.resolved_ids)
            victim_shed += len(rep.shed_ids)
            if not rep.pending:
                continue
            # Journal the re-homed sheds back to the victim so a SECOND
            # replay (another recovery pass, forensics) finds nothing
            # pending — the same idempotence the in-process router keeps.
            w = wal_mod.TicketWAL(wal_paths[v])
            w.shed([e["id"] for e in rep.pending], policy_mod.SHED_REHOMED)
            w.close()
            ring.remove_worker(v)
            by_target: dict[int, list[dict]] = {}
            for e in rep.pending:
                key = affinity_key(e.get("session"), e.get("id"))
                by_target.setdefault(ring.lookup(key), []).append(e)
            rehomed += len(rep.pending)
            deaths.append((v, time.time(), len(rep.pending)))
            for tgt, group in by_target.items():
                stem = os.path.join(state_dir, f"worker{tgt}.rehome{v}")
                checkpoint_mod.save_state(stem + ".spool", {
                    "schema": SPOOL_SCHEMA, "worker": tgt,
                    "entries": [{**e, "rehomed": True} for e in group]})
                recovery.append((v, tgt, stem, _spawn_worker(
                    args, tgt, stem + ".spool", stem + ".wal",
                    stem + ".out", strip_chaos=True)))
        if len(rcs) < n:
            time.sleep(0.02)
    recovery_rcs = [proc.wait() for *_, proc in recovery]
    recovery_s = time.perf_counter() - t_kill if victims else 0.0
    wall = time.perf_counter() - t_start
    lines = {i: _read_worker_line(os.path.join(state_dir, f"worker{i}.out"))
             for i in range(n)}
    recovery_lines = [_read_worker_line(stem + ".out") or {}
                      for _, _, stem, _ in recovery]

    # -- telemetry rollup: merge every worker's sidecar stream ---------
    tel_on = telemetry_mod.telemetry_on()
    rollup = FleetRollup() if tel_on else None
    burn = (telemetry_mod.BurnRateMonitor(slo_p99_s=args.slo_p99)
            if tel_on else None)
    scale_decisions: list[dict] = []
    if tel_on:
        # Every stream's good/bad counter deltas and every death, merge-
        # sorted on the shared WALL timeline (each worker stamps wall
        # beside mono, the clock-alignment exchange): the monitor's window
        # pruning wants a monotone feed. A recovery worker re-uses index
        # `tgt` but is a new lifetime: its stream rolls up under its own
        # key. Truncated tail frames charge loss.
        feed = []
        streams = [(os.path.join(state_dir, f"worker{i}"), None)
                   for i in range(n)]
        streams += [(stem, f"{tgt}.rehome{v}")
                    for v, tgt, stem, _ in recovery]
        for stem, key in streams:
            rep = telemetry_mod.read_frames(stem + ".telemetry.bin")
            rollup.truncated += rep["truncated"]
            pg = pb = 0
            for snap in rep["snapshots"]:
                rollup.ingest(snap, worker=key)
                c = snap.get("counters") or {}
                g, b = int(c.get("good", 0)), int(c.get("bad", 0))
                feed.append((float(snap["wall"]), g - pg, b - pb, None))
                pg, pb = g, b
        feed += [(wall_t, 0, pending, v) for v, wall_t, pending in deaths]
        for wall_t, g, b, v in sorted(feed, key=lambda f: f[:3]):
            win = burn.observe(wall_t, g, b)
            edge = win.pop("alert_edge", False)
            if edge:
                obs_metrics.inc("serve.fleet.burn_alerts")
            if v is None:
                if edge:
                    obs_trace.event("serve.fleet.burn",
                                    wall=round(wall_t, 6), **win)
                continue
            # The kill lands on the record BEFORE the autoscale verb: the
            # victim's lost pending set spends error budget at its death,
            # the burn event carries the window values, and only then
            # does the scale decision (recovery capacity) follow — the
            # merged timeline shows cause, then action.
            obs_trace.event("serve.fleet.burn", wall=round(wall_t, 6),
                            worker=v, pending=b, **win)
            decision = {
                "action": "add", "reason": "worker-death", "worker": v,
                "pending": b, "wall": round(wall_t, 6),
                **burn.windows(wall_t),
            }
            scale_decisions.append(decision)
            obs_metrics.inc("serve.fleet.scale_decisions", action="add")
            obs_trace.event("serve.fleet.scale", **decision)

    # -- fleet books -------------------------------------------------------
    survivor_lines = [lines[i] or {} for i in range(n) if i not in victims]
    resolved = (sum(ln.get("resolved", 0) for ln in survivor_lines)
                + victim_resolved
                + sum(ln.get("resolved", 0) for ln in recovery_lines))
    shed = (sum(ln.get("shed", 0) for ln in survivor_lines)
            + victim_shed
            + sum(ln.get("shed", 0) for ln in recovery_lines))
    rehomed_resolved = sum(ln.get("resolved", 0) for ln in recovery_lines)
    acked = args.requests - door_shed
    acked_loss = acked - resolved - shed
    verified = None
    if args.verify:
        verified = all(ln.get("verified", False)
                       for ln in survivor_lines + recovery_lines)
    rec = {
        "fleet": n, "device": args.device,
        "requests": args.requests, "sessions": args.sessions,
        "door_shed": door_shed,
        "worker_rcs": [rcs[i] for i in range(n)],
        "victims": sorted(victims),
        "recovery_rcs": recovery_rcs,
        "rehomed": rehomed,
        "rehomed_resolved": rehomed_resolved,
        "resolved": resolved, "shed": shed,
        "acked_loss": acked_loss,
        "books_balance": acked_loss == 0,
        "fleet_requests_per_sec": (round(resolved / wall, 2)
                                   if wall > 0 and resolved else 0.0),
        "fleet_p99_latency_s": round(max(
            [ln.get("p99_latency_s", 0.0)
             for ln in survivor_lines + recovery_lines] or [0.0]), 6),
        "fleet_kill_recovery_s": round(recovery_s, 4),
        "wall_sec": round(wall, 4),
        "state_dir": state_dir,
    }
    errors = {str(i): (lines[i] or {}).get("error") for i in range(n)
              if (lines[i] or {}).get("error")}
    errors.update({f"recovery{k}": ln["error"]
                   for k, ln in enumerate(recovery_lines) if ln.get("error")})
    if errors:
        # A worker that failed to build, launch or verify names why.
        rec["worker_errors"] = errors
    if verified is not None:
        rec["verified"] = verified
        rec["rehomed_parity"] = all(
            ln.get("verified", False) for ln in recovery_lines)
    if tel_on:
        rec["telemetry"] = {
            **rollup.summary(),
            **burn.summary(),
            "clock_offsets": rollup.clock_offsets(),
            "decisions": scale_decisions,
        }
    print(json.dumps(rec))
    ok = (rec["books_balance"]
          and all(rc == 0 for rc in recovery_rcs)
          and all(rcs[i] in (0, 137) for i in range(n))
          and (verified is None or verified))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
