"""Process-wide metrics registry: counters, gauges, histograms.

Counterpart of ``mpi_and_open_mp_tpu/obs/metrics.py``, with the same calls,
keys and rendered names, so :func:`snapshot` equals the JAX package's for
the same calls. Host-side only: recorders are plain dict updates under a
lock, cheap enough for a segment boundary, a plan's first build or a
checkpoint write, and never inside a step loop. Collection is on by
default; ``MOMP_METRICS=0`` turns every recorder into an immediate return.

Keys are ``(name, sorted label items)``; :func:`snapshot` renders them
``name{k=v,...}``. Histograms keep count, total, min and max. Label
cardinality is capped per metric name (``MOMP_METRICS_MAX_LABELSETS``,
default 256): a new label set past the cap is dropped and ticks
``metrics.dropped_labels``.

What lands here:

* ``jit.retrace{fn=...}`` - the JAX package ticks it inside jitted bodies,
  once per compiled program. The port compiles nothing per shape, so it
  ticks once per distinct launch geometry, on the miss of the structure
  that keys it (a sim's step counts, the batched dispatch's stack shapes,
  the sharded attention's operand shapes), never per step;
* ``ring.hops.fwd{engine=...}`` / ``ring.steps.traced`` - ring-attention
  hops of the traced hop-by-hop dispatch;
* ``halo.exchange.traced{kind=...,axis=...}`` and
  ``halo.schedule.traced{engine=...,layout=...}`` - once per distinct
  exchange geometry and per halo plan built (the JAX package's counts of
  traced exchanges and schedules);
* ``guard.validation{engine=...}`` / ``guard.validation_failed{...}`` /
  ``recovery{stamp=...}`` - the guards (``robust.guards``);
* ``checkpoint.saves`` / ``checkpoint.save.bytes`` /
  ``checkpoint.save_seconds`` (histogram), the ``restore`` twins, and the
  ``state_save``/``state_restore`` counters (``utils.checkpoint``);
* ``serve.requests`` / ``serve.batches`` / ``serve.padding`` - the
  batcher's flushes.
"""

from __future__ import annotations

import math
import os
import threading

_ENV = "MOMP_METRICS"
_ENV_MAX_LABELSETS = "MOMP_METRICS_MAX_LABELSETS"

#: Overflow counter ticked when the cardinality guard drops a record.
DROPPED_LABELS = "metrics.dropped_labels"

_LOCK = threading.Lock()
_COUNTERS: dict[tuple, float] = {}
_GAUGES: dict[tuple, float] = {}
_HISTS: dict[tuple, list[float]] = {}  # [count, total, min, max]
_LABELSETS: dict[str, int] = {}  # distinct label sets seen per name


def max_labelsets() -> int:
    """Distinct label sets admitted per metric name before the guard drops
    new ones (``MOMP_METRICS_MAX_LABELSETS``, default 256)."""
    try:
        v = int(os.environ.get(_ENV_MAX_LABELSETS, "256"))
    except ValueError:
        return 256
    return v if v > 0 else 256


def _admit(k: tuple, store: dict) -> bool:
    """Cardinality guard, called under ``_LOCK``: an existing key always
    updates; a new key is admitted only while its metric name is under the
    label-set cap. Drops tick :data:`DROPPED_LABELS` (label-free, so never
    dropped itself)."""
    if k in store:
        return True
    name = k[0]
    if _LABELSETS.get(name, 0) >= max_labelsets():
        dk = (DROPPED_LABELS, ())
        _COUNTERS[dk] = _COUNTERS.get(dk, 0) + 1
        return False
    _LABELSETS[name] = _LABELSETS.get(name, 0) + 1
    return True


def metrics_on() -> bool:
    """Collection is on unless ``MOMP_METRICS=0``."""
    return os.environ.get(_ENV, "1") != "0"


def _key(name: str, labels: dict) -> tuple:
    # Label values stringify, so keys always sort and compare.
    return (name, tuple(sorted((a, str(b)) for a, b in labels.items())))


def inc(name: str, value: float = 1, **labels) -> None:
    """Add to a monotonic counter."""
    if not metrics_on():
        return
    k = _key(name, labels)
    with _LOCK:
        if _admit(k, _COUNTERS):
            _COUNTERS[k] = _COUNTERS.get(k, 0) + value


def gauge(name: str, value: float, **labels) -> None:
    """Set a last-value-wins gauge."""
    if not metrics_on():
        return
    k = _key(name, labels)
    with _LOCK:
        if _admit(k, _GAUGES):
            _GAUGES[k] = value


def observe(name: str, value: float, **labels) -> None:
    """Record one histogram observation (count, total, min, max). A NaN is
    dropped: a no-op span's clock must not poison the aggregate."""
    if not metrics_on() or math.isnan(value):
        return
    k = _key(name, labels)
    with _LOCK:
        h = _HISTS.get(k)
        if h is None:
            if not _admit(k, _HISTS):
                return
            _HISTS[k] = [1, value, value, value]
        else:
            h[0] += 1
            h[1] += value
            h[2] = min(h[2], value)
            h[3] = max(h[3], value)


def inc_once(seen: set, key, name: str, **labels) -> None:
    """Tick counter ``name`` when ``key`` is new to ``seen``, the caller's
    record of the geometries it has launched: the port's count of what the
    JAX package ticks once per compiled program. :func:`reset` leaves
    ``seen`` alone, as it leaves the JAX package's compile caches."""
    if key in seen:
        return
    seen.add(key)
    inc(name, **labels)


def get(name: str, **labels) -> float:
    """Current counter value (0 when never incremented)."""
    with _LOCK:
        return _COUNTERS.get(_key(name, labels), 0)


def _render(k: tuple) -> str:
    name, items = k
    if not items:
        return name
    return name + "{" + ",".join(f"{a}={b}" for a, b in items) + "}"


def snapshot() -> dict:
    """The registry as plain JSON-ready dicts (always all three sections)."""
    with _LOCK:
        return {
            "counters": {_render(k): v for k, v in sorted(_COUNTERS.items())},
            "gauges": {_render(k): v for k, v in sorted(_GAUGES.items())},
            "histograms": {
                _render(k): {"count": h[0], "total": h[1],
                             "min": h[2], "max": h[3]}
                for k, h in sorted(_HISTS.items())
            },
        }


def delta(before: dict, after: dict) -> dict:
    """The registry's movement between two :func:`snapshot` calls, in
    snapshot shape: counters and histogram count/total subtract (no
    movement drops out); gauges report those touched at their ``after``
    value; a histogram whose count moved reports ``after``'s min and max."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    b, a = before.get("counters", {}), after.get("counters", {})
    for key, v in a.items():
        moved = v - b.get(key, 0)
        if moved:
            out["counters"][key] = moved
    bg, ag = before.get("gauges", {}), after.get("gauges", {})
    for key, v in ag.items():
        if key not in bg or bg[key] != v:
            out["gauges"][key] = v
    bh, ah = before.get("histograms", {}), after.get("histograms", {})
    for key, h in ah.items():
        prev = bh.get(key, {"count": 0, "total": 0.0})
        moved = h["count"] - prev["count"]
        if moved:
            out["histograms"][key] = {
                "count": moved, "total": h["total"] - prev["total"],
                "min": h["min"], "max": h["max"],
            }
    return out


def reset() -> None:
    """Empty the registry (tests; fresh measurement phases)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
        _LABELSETS.clear()
