"""Fleet telemetry plane: time-series snapshots, quantile histograms,
SLO burn rate, and the cross-process sidecar frame format.

Counterpart of ``mpi_and_open_mp_tpu/obs/telemetry.py``, standard library
only. The two modules write the same snapshots and frames byte for byte
(the same keys in the same order, the same JSON separators), so either
package's reader, ``FleetRollup`` and ``analysis/fleet_report.py`` read
the other's sidecars.

The metrics registry (``obs.metrics``) answers "how many, how long
altogether, worst case" for ONE process at the instant you ask. A fleet
is run on different questions: what is each worker doing NOW, how fast
is the error budget burning, and — after a worker dies — what did its
last interval look like. This module is the layer between the registry
and those questions, stdlib-only and off-path like the rest of ``obs``:

``LatencyHist``
    Fixed geometric buckets with p50/p99/p999 readout — the latency
    series replacement for the registry's min/max-only histograms. The
    bucket ratio is DECLARED (:data:`BUCKET_REL_ERR`): a quantile read
    off the histogram is the bucket's upper edge, so it can overstate
    the exact sample quantile by at most one bucket ratio, and two
    readings agree when their buckets are within one step
    (:meth:`LatencyHist.agrees`). Bucket-count DELTAS are what ships:
    a merged fleet histogram is the sum of shipped deltas, so losing a
    snapshot loses exactly that interval's counts, never the series.
``WorkerTelemetry``
    One worker's recorder: a bounded ring of periodic snapshots (seq,
    monotonic + wall stamps, cumulative counters, histogram delta).
    Bounded means bounded — the ring evicts oldest first and COUNTS the
    evictions, so memory is capped and loss is observable, both.
``BurnRateMonitor``
    Multi-window error-budget consumption over the declared loadgen
    :class:`~mpi_and_open_mp_tpu_torch.serve.loadgen.SLO`. ``burn = bad-frac
    / (1 - goodput_frac)``: burn 1.0 spends the budget exactly at the
    allowed rate; the short window trips fast on a kill, the long
    window filters blips — alerting fires only when BOTH are over
    (the standard multi-window burn-rate alert shape). The windows are
    the recorded, queryable input the elasticity controller's verdicts
    carry (``serve.fleet`` stamps them on every scale/drain decision).
``write_frame`` / ``read_frames``
    The sidecar stream a worker SUBPROCESS ships snapshots over:
    length-prefixed CRC32-framed JSON, append-only. A ``kill -9``
    truncates at worst one partial frame; the reader checks length and
    CRC and soft-lands at the first bad frame, so snapshot loss from a
    death is bounded to the victim's last interval.
``clock_offset``
    Monotonic→wall alignment for the merged timeline: every snapshot
    carries a ``(mono, wall)`` pair sampled together (the heartbeat
    exchange), and the median of ``wall - mono`` is the process's
    offset. Records stamped with monotonic fleet-clock values (the
    scale decisions) map onto the shared wall timeline through it.

Knobs, house convention (default on, ``=0`` disables):
``MOMP_TELEMETRY=0`` turns every recorder into a no-op;
``MOMP_TELEMETRY_INTERVAL`` (seconds, default 0.05) paces snapshots;
``MOMP_TELEMETRY_CAPACITY`` (default 512) bounds each worker ring.
"""

from __future__ import annotations

import collections
import json
import math
import os
import struct
import threading
import time
import zlib

_ENV = "MOMP_TELEMETRY"
_ENV_INTERVAL = "MOMP_TELEMETRY_INTERVAL"
_ENV_CAPACITY = "MOMP_TELEMETRY_CAPACITY"

#: Snapshot schema version (rides every frame; readers reject unknowns).
SNAPSHOT_SCHEMA = 1

#: Latency bucket edges: geometric, 12 per decade from 100 µs to 100 s.
#: Upper edges; an observation lands in the first bucket whose edge is
#: >= the value, values past the last edge land in the overflow bucket.
BUCKET_RATIO = 10.0 ** (1.0 / 12.0)
DEFAULT_BOUNDS = tuple(1e-4 * BUCKET_RATIO ** i for i in range(73))

#: The declared relative quantile error of the default buckets: a
#: histogram quantile is its bucket's upper edge, at most one ratio
#: above the exact sample value in that bucket.
BUCKET_REL_ERR = BUCKET_RATIO - 1.0


def telemetry_on() -> bool:
    """Collection is on unless ``MOMP_TELEMETRY=0``."""
    return os.environ.get(_ENV, "1") != "0"


def snapshot_interval_s() -> float:
    """The configured snapshot cadence (``MOMP_TELEMETRY_INTERVAL``)."""
    try:
        v = float(os.environ.get(_ENV_INTERVAL, "0.05"))
    except ValueError:
        return 0.05
    return v if v > 0 else 0.05


def ring_capacity() -> int:
    """Per-worker snapshot ring size (``MOMP_TELEMETRY_CAPACITY``)."""
    try:
        v = int(os.environ.get(_ENV_CAPACITY, "512"))
    except ValueError:
        return 512
    return v if v > 0 else 512


class LatencyHist:
    """Fixed-bucket latency histogram with quantile readout.

    Buckets are closed on the right: value ``v`` lands in the first
    bucket whose upper edge is >= ``v``; anything past the last edge
    lands in one overflow bucket whose readout is the observed max (the
    honest answer when the tail left the declared range). NaN drops,
    like ``metrics.observe``.
    """

    __slots__ = ("bounds", "counts", "count", "total", "vmin", "vmax")

    def __init__(self, bounds: tuple = DEFAULT_BOUNDS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0

    def bucket_index(self, v: float) -> int:
        import bisect

        return min(bisect.bisect_left(self.bounds, v), len(self.bounds))

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return
        self.counts[self.bucket_index(v)] += 1
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def merge_counts(self, counts, *, total: float = 0.0,
                     vmin: float = math.inf, vmax: float = 0.0) -> None:
        """Fold a shipped bucket-count delta (sparse ``{index: n}`` or
        dense list) into this histogram — how a fleet rollup merges
        worker series without ever seeing the raw samples."""
        items = (counts.items() if isinstance(counts, dict)
                 else enumerate(counts))
        for i, n in items:
            i = int(i)
            n = int(n)
            if 0 <= i < len(self.counts) and n > 0:
                self.counts[i] += n
                self.count += n
        self.total += float(total)
        self.vmin = min(self.vmin, float(vmin))
        self.vmax = max(self.vmax, float(vmax))

    def quantile(self, q: float) -> float:
        """The ``q``-th percentile (``q`` in [0, 100]) as the holding
        bucket's upper edge — within :data:`BUCKET_REL_ERR` of the exact
        nearest-rank sample quantile by construction. 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = max(1, min(self.count, int(-(-q * self.count // 100))))
        seen = 0
        for i, n in enumerate(self.counts):
            seen += n
            if seen >= rank:
                if i >= len(self.bounds):
                    return self.vmax
                return self.bounds[i]
        return self.vmax

    def agrees(self, estimate: float, exact: float) -> bool:
        """Whether two latency readings sit within the declared bucket
        error — same or adjacent bucket (quantile readout rounds up,
        nearest-rank rounds to a sample; one bucket step covers both)."""
        return abs(self.bucket_index(estimate)
                   - self.bucket_index(exact)) <= 1

    def snapshot_counts(self) -> list[int]:
        return list(self.counts)

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "total_s": round(self.total, 6),
            "min_s": round(self.vmin, 6) if self.count else None,
            "max_s": round(self.vmax, 6) if self.count else None,
            "p50_s": round(self.quantile(50), 6),
            "p99_s": round(self.quantile(99), 6),
            "p999_s": round(self.quantile(99.9), 6),
        }


def _sparse_delta(prev: list[int], cur: list[int]) -> dict[str, int]:
    """Bucket-count delta as a sparse ``{str(index): n}`` map (JSON
    object keys are strings; most intervals touch a few buckets)."""
    return {str(i): c - p for i, (p, c) in enumerate(zip(prev, cur))
            if c != p}


class WorkerTelemetry:
    """One worker's bounded time-series recorder.

    ``sample`` is interval-gated (``due``/``force``): each accepted
    sample appends one snapshot — sequence number, paired monotonic +
    wall stamps (the clock-alignment exchange), the caller's cumulative
    counters, and the latency-histogram delta since the previous
    snapshot — to a bounded ring. Eviction increments ``dropped`` so
    the loss a too-small ring causes is itself observable.
    """

    def __init__(self, worker: int, *, interval_s: float | None = None,
                 capacity: int | None = None, bounds: tuple = DEFAULT_BOUNDS):
        self.worker = int(worker)
        self.interval_s = (snapshot_interval_s() if interval_s is None
                           else float(interval_s))
        self.ring: collections.deque = collections.deque(
            maxlen=capacity if capacity is not None else ring_capacity())
        self.hist = LatencyHist(bounds)
        self.dropped = 0
        self.seq = 0
        self._last_mono: float | None = None
        self._last_counts = self.hist.snapshot_counts()

    def observe_latency(self, seconds: float) -> None:
        self.hist.observe(seconds)

    def due(self, now: float) -> bool:
        return (self._last_mono is None
                or now - self._last_mono >= self.interval_s)

    def sample(self, now: float, counters: dict | None = None, *,
               force: bool = False, wall: float | None = None) -> dict | None:
        """Record one snapshot if the interval elapsed (or ``force``).
        Returns the snapshot dict (also kept in the ring) or ``None``."""
        if not force and not self.due(now):
            return None
        cur = self.hist.snapshot_counts()
        snap = {
            "v": SNAPSHOT_SCHEMA,
            "worker": self.worker,
            "seq": self.seq,
            "mono": float(now),
            "wall": time.time() if wall is None else float(wall),
            "counters": dict(counters or {}),
            "hist": _sparse_delta(self._last_counts, cur),
            "hist_count": self.hist.count,
        }
        self.seq += 1
        self._last_mono = now
        self._last_counts = cur
        if len(self.ring) == self.ring.maxlen:
            self.dropped += 1
        self.ring.append(snap)
        return snap

    def series(self) -> list[dict]:
        return list(self.ring)


class BurnRateMonitor:
    """Multi-window SLO error-budget burn over a good/bad event stream.

    ``observe(now, good, bad)`` feeds one interval's counts (bad = shed
    or over-SLO-latency); ``windows(now)`` reads the burn rate over the
    short and long trailing windows. Burn 1.0 = spending the budget
    exactly as fast as the SLO allows; the alert condition is BOTH
    windows over :attr:`alert_burn` — the short window makes a real
    incident (a worker kill) visible within seconds, the long window
    keeps a one-interval blip from paging. Crossing into alert is
    edge-triggered (``alerts`` counts crossings, not intervals).
    """

    def __init__(self, *, slo_p99_s: float = 0.25,
                 goodput_frac: float = 0.9,
                 short_window_s: float = 0.25, long_window_s: float = 1.0,
                 alert_burn: float = 1.0):
        if long_window_s < short_window_s:
            raise ValueError(
                f"long window ({long_window_s}) must be >= short "
                f"({short_window_s})")
        self.slo_p99_s = float(slo_p99_s)
        #: Error budget: the bad-request fraction the SLO tolerates.
        self.budget = max(1.0 - float(goodput_frac), 1e-6)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.alert_burn = float(alert_burn)
        self._obs: collections.deque = collections.deque()
        self.peak_short = 0.0
        self.peak_long = 0.0
        self.alerts = 0
        self._alerting = False

    @classmethod
    def from_slo(cls, slo, **kw) -> "BurnRateMonitor":
        """Build over a declared ``serve.loadgen.SLO``."""
        return cls(slo_p99_s=slo.p99_s, goodput_frac=slo.goodput_frac,
                   **kw)

    def is_bad(self, latency_s: float) -> bool:
        return latency_s > self.slo_p99_s

    def _burn(self, now: float, window_s: float) -> float:
        good = bad = 0
        for t, g, b in reversed(self._obs):
            if now - t > window_s:
                break
            good += g
            bad += b
        if good + bad == 0:
            return 0.0
        return (bad / (good + bad)) / self.budget

    def observe(self, now: float, good: int, bad: int) -> dict:
        """Feed one interval; returns the window values, with
        ``alert_edge`` True exactly when this observation crossed into
        the both-windows-burning state."""
        self._obs.append((float(now), int(good), int(bad)))
        while self._obs and now - self._obs[0][0] > self.long_window_s:
            self._obs.popleft()
        win = self.windows(now)
        self.peak_short = max(self.peak_short, win["burn_short"])
        self.peak_long = max(self.peak_long, win["burn_long"])
        alerting = (win["burn_short"] > self.alert_burn
                    and win["burn_long"] > self.alert_burn)
        win["alert_edge"] = alerting and not self._alerting
        if win["alert_edge"]:
            self.alerts += 1
        self._alerting = alerting
        return win

    def windows(self, now: float) -> dict:
        """The queryable burn-rate input: both windows, plus peaks."""
        return {
            "burn_short": round(self._burn(now, self.short_window_s), 4),
            "burn_long": round(self._burn(now, self.long_window_s), 4),
            "short_window_s": self.short_window_s,
            "long_window_s": self.long_window_s,
            "budget": round(self.budget, 6),
        }

    def summary(self) -> dict:
        return {
            "burn_peak_short": round(self.peak_short, 4),
            "burn_peak_long": round(self.peak_long, 4),
            "burn_alerts": self.alerts,
            "budget": round(self.budget, 6),
        }


# -- the cross-process sidecar stream ---------------------------------------
#
# Frame layout, little-endian:  u32 payload length | u32 CRC32(payload)
# | payload (UTF-8 JSON snapshot). Append-only; a reader stops at the
# first frame whose length runs past EOF or whose CRC mismatches — the
# kill -9 truncation contract: at most one partial frame is lost, and
# the loss is COUNTED, not papered over.

_FRAME_HEADER = struct.Struct("<II")
#: Defensive bound: no snapshot is megabytes; a corrupt length field
#: must not allocate the file size.
_MAX_FRAME = 1 << 20


def write_frame(fd, snap: dict) -> int:
    """Append one CRC-framed snapshot; returns bytes written."""
    payload = json.dumps(snap, separators=(",", ":")).encode()
    fd.write(_FRAME_HEADER.pack(len(payload), zlib.crc32(payload)))
    fd.write(payload)
    return _FRAME_HEADER.size + len(payload)


def read_frames(path: str) -> dict:
    """Read every intact frame: ``{"snapshots": [...], "truncated": n,
    "bytes": total}``. ``truncated`` counts the bad tail (0 or 1 for a
    clean kill; >1 only for real corruption) — the reader NEVER raises
    on a short/garbled tail, because a dead worker's stream ending
    mid-frame is the expected shape of the failure being measured."""
    snaps: list[dict] = []
    truncated = 0
    try:
        blob = open(path, "rb").read()
    except OSError:
        return {"snapshots": snaps, "truncated": 0, "bytes": 0}
    off = 0
    n = len(blob)
    while off + _FRAME_HEADER.size <= n:
        length, crc = _FRAME_HEADER.unpack_from(blob, off)
        start = off + _FRAME_HEADER.size
        if length > _MAX_FRAME or start + length > n:
            truncated += 1
            break
        payload = blob[start:start + length]
        if zlib.crc32(payload) != crc:
            truncated += 1
            break
        try:
            snap = json.loads(payload)
        except ValueError:
            truncated += 1
            break
        if isinstance(snap, dict) and snap.get("v") == SNAPSHOT_SCHEMA:
            snaps.append(snap)
        off = start + length
    else:
        if off < n:
            truncated += 1
    return {"snapshots": snaps, "truncated": truncated, "bytes": n}


class SnapshotShipper:
    """Background sidecar writer for a worker subprocess.

    Samples ``sample_fn() -> (counters, new_latencies)`` every interval
    on a daemon thread, observes the latencies into a
    :class:`WorkerTelemetry`, and appends each accepted snapshot as one
    CRC frame. ``stop()`` takes one final forced sample so a CLEAN exit
    ships its last interval; a killed worker simply stops writing — the
    framing bounds that loss to the final interval by construction.

    ``sample_fn`` runs on the shipper's thread, beside the worker's
    dispatch: it must read host state only (the queue's tickets and their
    stamps), never a tensor on the card, whose read would sync the
    stream the worker is dispatching on."""

    def __init__(self, path: str, worker: int, sample_fn, *,
                 interval_s: float | None = None):
        self.path = path
        self.telemetry = WorkerTelemetry(worker, interval_s=interval_s)
        self._sample_fn = sample_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._fd = open(path, "ab", buffering=0)
        self._lock = threading.Lock()

    def _ship(self, *, force: bool = False) -> None:
        now = time.monotonic()
        if not force and not self.telemetry.due(now):
            return
        counters, latencies = self._sample_fn()
        for v in latencies:
            self.telemetry.observe_latency(v)
        snap = self.telemetry.sample(now, counters, force=force)
        if snap is not None:
            with self._lock:
                write_frame(self._fd, snap)

    def _run(self) -> None:
        while not self._stop.wait(self.telemetry.interval_s / 4):
            try:
                self._ship()
            except Exception:  # noqa: BLE001 — telemetry must not kill
                # serving, and a transient race (sampling the queue
                # mid-mutation) must not end the stream: skip the tick.
                continue

    def start(self) -> "SnapshotShipper":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        try:
            self._ship(force=True)
        finally:
            self._fd.close()


def clock_offset(snapshots: list[dict]) -> float | None:
    """The process's monotonic→wall offset: median of ``wall - mono``
    over its snapshots (each pair sampled together on the heartbeat, so
    the spread is scheduling jitter, and the median rejects it)."""
    pairs = sorted(s["wall"] - s["mono"] for s in snapshots
                   if isinstance(s.get("wall"), (int, float))
                   and isinstance(s.get("mono"), (int, float)))
    if not pairs:
        return None
    mid = len(pairs) // 2
    if len(pairs) % 2:
        return pairs[mid]
    return 0.5 * (pairs[mid - 1] + pairs[mid])
