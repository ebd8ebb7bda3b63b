"""Open-loop load generation: drive the fleet to saturation, honestly.

Counterpart of ``mpi_and_open_mp_tpu/serve/loadgen.py``: the same seeded
arrivals, schedule and report, against the port's :class:`~mpi_and_open_
mp_tpu_torch.serve.fleet.Fleet`. It holds no tensors: boards are numpy
arrays, and the fleet's workers put them on their own device.

The reference repo's capacity story was a PBS sweep — ``qsub -l
nodes=N`` once per node count, eyeball the wall-clock table. Two things
are wrong with porting that shape to a serving fleet. First, it is
**closed-loop**: each client submits its next request only after the
previous one returns, so the generator slows down exactly when the
system does, and the measured latency at "full load" is a flattering
fiction (coordinated omission — the requests that WOULD have arrived
during a stall are simply never sent). Second, it measures throughput
alone; a serving fleet's contract is a latency SLO at an offered rate,
and throughput without the tail is not a capacity number.

This module is the open-loop replacement. Arrivals are a **schedule**,
not a reaction: :func:`arrivals_poisson` draws exponential
inter-arrival gaps for a target rate (:func:`arrivals_trace` replays a
recorded one), and :func:`run_open_loop` submits each request at its
scheduled instant whether or not the fleet has finished the previous
ones. When the fleet falls behind, queues deepen, the door sheds, and
the tail grows — which is the point: those are the numbers the SLO
judges. One run yields a :class:`LoadgenReport` (goodput + nearest-rank
p50/p99/p999 + shed breakdown + the fleet books); :func:`sweep` runs a
monotone offered-load ladder on fresh fleets and :func:`saturation_knee`
reads off the last rung that still meets the :class:`SLO` — the
capacity number the JAX bench's ``--loadgen`` line publishes.

Traffic is a :class:`ScenarioMix`, because a fleet that only ever sees
one-shot same-shape tickets is not under real load: the mix weights
one-shot batch tickets (mixed shapes — distinct buckets),
resident-session steps (the pool fast path, placement-sticky), and
snapshot reads (synchronous device→host crossings that steal dispatch
time). Every request kind resolves to something the oracle can check —
the report keeps the resident create-boards so the caller can gate
snapshots bit-exact, and resolved tickets carry their boards for the
usual parity sweep.

Determinism: everything is seeded ``np.random.default_rng``; with the
fleet's injectable clock (tests use a fake clock whose ``sleep``
advances it) a run is exactly reproducible.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpi_and_open_mp_tpu_torch.serve.policy import percentile
from mpi_and_open_mp_tpu_torch.serve.queue import DONE, SHED

#: Scenario kinds a mix can weight. ``batch`` = one-shot board ticket
#: (no session affinity — spreads over the ring); ``resident`` = one
#: step ticket against a long-lived pooled session; ``snapshot`` = a
#: synchronous read of a pooled session's board.
SCENARIO_KINDS = ("batch", "resident", "snapshot")


@dataclasses.dataclass(frozen=True)
class ScenarioMix:
    """Weighted traffic composition for one loadgen run.

    ``shapes`` are the one-shot board shapes (each distinct shape is a
    distinct bucket and launch geometry — mixing them loads the padding
    door and the launch records, not just the queue); ``steps`` the per-request step
    counts; ``sessions`` the number of long-lived resident sessions the
    run creates up front and then steps/snapshots at random. Weights
    are relative, not normalized."""

    batch: float = 1.0
    resident: float = 0.0
    snapshot: float = 0.0
    shapes: tuple = ((48, 48), (64, 64))
    steps: tuple = (2, 4)
    sessions: int = 0
    fill: float = 0.3

    def __post_init__(self):
        for kind in SCENARIO_KINDS:
            w = getattr(self, kind)
            if w < 0:
                raise ValueError(f"mix weight {kind} must be >= 0, got {w}")
        if self.batch + self.resident + self.snapshot <= 0:
            raise ValueError("mix weights must sum to > 0")
        if (self.resident > 0 or self.snapshot > 0) and self.sessions < 1:
            raise ValueError(
                "resident/snapshot traffic needs sessions >= 1")
        if not self.shapes or not self.steps:
            raise ValueError("mix needs at least one shape and one step")
        if not 0.0 < self.fill < 1.0:
            raise ValueError(f"fill must be in (0, 1), got {self.fill}")

    def weights(self) -> np.ndarray:
        w = np.array([self.batch, self.resident, self.snapshot], float)
        return w / w.sum()


@dataclasses.dataclass(frozen=True)
class SLO:
    """The declared service-level objective a run is judged against.

    ``p99_s``/``p999_s`` bound the measured latency percentiles over
    resolved tickets; ``goodput_frac`` demands the fleet actually
    complete that fraction of the offered rate (a fleet that sheds 60%
    of traffic can have a beautiful p99 — the survivors were cheap).
    ``p999_s=None`` skips the extreme-tail bound (short runs cannot
    estimate it honestly)."""

    p99_s: float = 0.25
    p999_s: float | None = None
    goodput_frac: float = 0.9

    def __post_init__(self):
        if self.p99_s <= 0:
            raise ValueError(f"p99_s must be > 0, got {self.p99_s}")
        if self.p999_s is not None and self.p999_s < self.p99_s:
            raise ValueError(
                f"p999_s ({self.p999_s}) must be >= p99_s ({self.p99_s})")
        if not 0.0 < self.goodput_frac <= 1.0:
            raise ValueError(
                f"goodput_frac must be in (0, 1], got {self.goodput_frac}")

    def verdict(self, *, goodput_rps: float, offered_rps: float,
                p99_s: float, p999_s: float) -> bool:
        ok = p99_s <= self.p99_s
        if self.p999_s is not None:
            ok = ok and p999_s <= self.p999_s
        return ok and goodput_rps >= self.goodput_frac * offered_rps


def arrivals_poisson(rate_rps: float, duration_s: float, *,
                     seed: int = 0) -> list[float]:
    """Poisson-process arrival offsets: exponential inter-arrival gaps
    at ``rate_rps``, truncated at ``duration_s``. The schedule exists
    BEFORE the run — an open-loop generator never consults the system
    under test about when to send."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if duration_s <= 0:
        raise ValueError(f"duration_s must be > 0, got {duration_s}")
    rng = np.random.default_rng(seed)
    out: list[float] = []
    t = 0.0
    # Draw in chunks: the expected count is rate*duration; 2x + slack
    # covers the tail in one draw almost always, the loop covers the
    # rest exactly.
    while True:
        gaps = rng.exponential(1.0 / rate_rps,
                               size=max(16, int(2 * rate_rps * duration_s)))
        for g in gaps:
            t += float(g)
            if t >= duration_s:
                return out
            out.append(t)


def arrivals_trace(offsets) -> list[float]:
    """Validate a recorded arrival trace: offsets in seconds from run
    start, non-negative and non-decreasing. Replaying a trace turns a
    production incident into a regression test."""
    out = [float(x) for x in offsets]
    if any(x < 0 for x in out):
        raise ValueError("trace offsets must be >= 0")
    if any(b < a for a, b in zip(out, out[1:])):
        raise ValueError("trace offsets must be non-decreasing")
    return out


@dataclasses.dataclass
class LoadgenReport:
    """One open-loop run's results. ``resident_boards`` maps each
    resident session to its CREATE board so the caller can oracle-gate
    final snapshots; ``shed`` is reason→count over door + worker sheds
    combined."""

    offered_rps: float
    duration_s: float
    offered: int
    submitted: int
    resolved: int
    snapshots: int
    shed: dict
    goodput_rps: float
    p50_s: float
    p99_s: float
    p999_s: float
    slo_ok: bool
    wall_s: float
    books: dict
    resident_boards: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        """The JSON-line projection (drops the board payloads)."""
        return {
            "offered_rps": round(self.offered_rps, 3),
            "offered": self.offered,
            "resolved": self.resolved,
            "goodput_rps": round(self.goodput_rps, 3),
            "p50_s": round(self.p50_s, 6),
            "p99_s": round(self.p99_s, 6),
            "p999_s": round(self.p999_s, 6),
            "shed": dict(self.shed),
            "slo_ok": bool(self.slo_ok),
        }


def _build_schedule(arrivals: list[float], mix: ScenarioMix,
                    seed: int) -> list[tuple]:
    """Bind each arrival instant to a concrete request: kind, payload.
    Seeded separately from the arrival draw so the same traffic rides
    every rung of a sweep (the mix is the controlled variable, the
    rate is the swept one)."""
    rng = np.random.default_rng(seed + 1)
    kinds = rng.choice(len(SCENARIO_KINDS), size=len(arrivals),
                       p=mix.weights())
    schedule = []
    for off, k in zip(arrivals, kinds):
        kind = SCENARIO_KINDS[int(k)]
        if kind == "batch":
            ny, nx = mix.shapes[int(rng.integers(len(mix.shapes)))]
            board = (rng.random((ny, nx)) < mix.fill).astype(np.uint8)
            steps = int(mix.steps[int(rng.integers(len(mix.steps)))])
            schedule.append((off, "batch", board, steps))
        elif kind == "resident":
            sid = f"r{int(rng.integers(mix.sessions)):04d}"
            steps = int(mix.steps[int(rng.integers(len(mix.steps)))])
            schedule.append((off, "resident", sid, steps))
        else:
            sid = f"r{int(rng.integers(mix.sessions)):04d}"
            schedule.append((off, "snapshot", sid, 0))
    return schedule


def run_open_loop(fleet, rate_rps: float, duration_s: float, *,
                  mix: ScenarioMix | None = None,
                  slo: SLO | None = None, seed: int = 0,
                  trace=None, events=None,
                  drain_timeout_s: float = 120.0) -> LoadgenReport:
    """Drive ``fleet`` open-loop for ``duration_s`` at ``rate_rps``
    (or over an explicit ``trace``), then drain, then judge.

    The loop per round: submit every request whose scheduled instant
    has passed (REGARDLESS of completions — that is the open loop),
    fire any due ``events`` (``[(frac_of_duration, fn(fleet)), ...]``
    — the membership drill hooks: wedge at 0.25, rejoin at 0.45, drain
    at 0.65), pump once, and sleep only when both the schedule and the
    queues are idle. Resident sessions are created up front and are
    NOT evicted — the report carries their create boards so the caller
    can snapshot + oracle-gate after the run.

    Latency honesty: a request's clock starts at its SCHEDULED
    submission (the fleet queue stamps it at ``submit``, which this
    loop calls at — not after — the scheduled instant), and sheds are
    never latency samples; they are failures, reported in ``shed`` and
    charged against goodput."""
    mix = mix or ScenarioMix()
    slo = slo or SLO()
    clock = fleet._clock
    sleep = fleet._sleep
    if trace is not None:
        arrivals = arrivals_trace(trace)
        duration_s = max([duration_s] + arrivals)
    else:
        arrivals = arrivals_poisson(rate_rps, duration_s, seed=seed)
    schedule = _build_schedule(arrivals, mix, seed)
    pending_events = sorted(events or [], key=lambda e: e[0])

    resident_boards: dict[str, np.ndarray] = {}
    rng = np.random.default_rng(seed + 2)
    for i in range(mix.sessions if (mix.resident or mix.snapshot) else 0):
        ny, nx = mix.shapes[int(rng.integers(len(mix.shapes)))]
        board = (rng.random((ny, nx)) < mix.fill).astype(np.uint8)
        sid = f"r{i:04d}"
        fleet.create_session(sid, board)
        resident_boards[sid] = board

    tickets = []
    snapshots = 0
    snapshot_lat: list[float] = []
    t0 = clock()
    i = 0
    ei = 0
    while i < len(schedule):
        now = clock()
        el = now - t0
        while i < len(schedule) and schedule[i][0] <= el:
            _, kind, payload, steps = schedule[i]
            if kind == "batch":
                tickets.append(fleet.submit(payload, steps))
            elif kind == "resident":
                tickets.append(fleet.step_session(payload, steps))
            else:
                s0 = clock()
                fleet.snapshot_session(payload)
                snapshot_lat.append(clock() - s0)
                snapshots += 1
            i += 1
        while ei < len(pending_events) and \
                pending_events[ei][0] * duration_s <= el:
            pending_events[ei][1](fleet)
            ei += 1
        n = fleet.pump()
        if n == 0 and i < len(schedule):
            gap = schedule[i][0] - (clock() - t0)
            if gap > 0:
                sleep(min(gap, fleet.router.heartbeat_interval_s))
    # Late events (frac >= the last arrival's instant) still fire —
    # a drill scheduled at 0.9 must not silently vanish on a sparse
    # schedule.
    while ei < len(pending_events):
        pending_events[ei][1](fleet)
        ei += 1
    fleet.serve_until_drained(drain=True, timeout_s=drain_timeout_s)
    wall = max(clock() - t0, 1e-9)

    resolved = [t for t in tickets if t.state == DONE]
    shed: dict[str, int] = {}
    for t in tickets:
        if t.state == SHED:
            shed[t.reason] = shed.get(t.reason, 0) + 1
    lat = sorted(t.latency_s for t in resolved)
    p50 = percentile(lat, 50)
    p99 = percentile(lat, 99)
    p999 = percentile(lat, 99.9)
    goodput = len(resolved) / wall
    offered_rps = len(schedule) / max(duration_s, 1e-9)
    return LoadgenReport(
        offered_rps=offered_rps, duration_s=duration_s,
        offered=len(schedule), submitted=len(tickets),
        resolved=len(resolved), snapshots=snapshots, shed=shed,
        goodput_rps=goodput, p50_s=p50, p99_s=p99, p999_s=p999,
        slo_ok=slo.verdict(goodput_rps=goodput, offered_rps=offered_rps,
                           p99_s=p99, p999_s=p999),
        wall_s=wall, books=fleet.router.books(),
        resident_boards=resident_boards)


def sweep(fleet_factory, rates, duration_s: float, *,
          mix: ScenarioMix | None = None, slo: SLO | None = None,
          seed: int = 0) -> list[LoadgenReport]:
    """The offered-load ladder: one FRESH fleet per rung (warm state
    from a lower rate would flatter a higher one), strictly increasing
    rates, same seeded mix on every rung. Returns one report per
    rung; feed them to :func:`saturation_knee`."""
    rates = [float(r) for r in rates]
    if not rates:
        raise ValueError("sweep needs at least one rate")
    if any(b <= a for a, b in zip(rates, rates[1:])):
        raise ValueError(f"rates must be strictly increasing, got {rates}")
    return [run_open_loop(fleet_factory(), r, duration_s, mix=mix,
                          slo=slo, seed=seed) for r in rates]


def saturation_knee(reports: list[LoadgenReport]) -> dict:
    """Read the knee off a sweep: the highest offered rate that still
    met the SLO (``knee_rps``) and the first that breached
    (``breach_rps``; ``None`` while the fleet keeps up everywhere).
    ``knee_rps`` is the capacity number: offered load beyond it buys
    shed + tail, not goodput."""
    if not reports:
        raise ValueError("saturation_knee needs at least one report")
    knee = None
    breach = None
    for r in reports:
        if r.slo_ok:
            knee = r.offered_rps
        elif breach is None:
            breach = r.offered_rps
    return {
        "knee_rps": round(knee, 3) if knee is not None else None,
        "breach_rps": round(breach, 3) if breach is not None else None,
        "points": [r.to_dict() for r in reports],
    }
