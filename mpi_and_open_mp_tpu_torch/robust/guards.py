"""Validation guards and the engine-fallback retry policy.

Counterpart of ``mpi_and_open_mp_tpu/robust/guards.py``: run a ranked list
of engines, validate each result, fall through on failure, and stamp the
provenance of whichever engine survived. A recovery carries the
``:recovered`` suffix and lands in a process-wide log, so that a run that
healed itself is never reported as a clean one.

Guards are armed only by an active chaos plan without ``noguard``
(``MOMP_CHAOS``) or by ``MOMP_GUARD=1``: a validator is a host fetch,
which would stall the card's queue if it ran on every segment of the
default path, and a guard must never hide a kernel fault there.

Each validation ticks ``guard.validation{engine=...}`` and each rejected
one ``guard.validation_failed{engine=...}``; each recovery ticks
``recovery{stamp=...}`` and writes a ``recovery`` trace event (``obs``),
as in the JAX package. The log keeps the stamps in order.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.obs import metrics, trace
from mpi_and_open_mp_tpu_torch.robust import chaos


class FallbackExhausted(RuntimeError):
    """Every engine in a :func:`with_fallback` chain failed validation."""

    def __init__(self, notes: list[str]):
        self.notes = list(notes)
        super().__init__(
            "all engines failed: " + ("; ".join(notes) or "(no notes)")
        )


def with_fallback(engines, validator=None, *, retries: int = 1):
    """Run ``(name, thunk)`` engines in order until one validates.

    ``validator(result) -> bool`` decides acceptance (``None`` accepts the
    first result that does not raise); each engine gets up to ``retries``
    attempts. Returns ``(result, stamp, notes)``, ``stamp`` the engine's
    name, suffixed ``:recovered`` whenever anything failed before it.
    Raises :class:`FallbackExhausted` when the chain runs dry.
    """
    notes: list[str] = []
    clean = True
    for name, thunk in engines:
        for _ in range(max(1, retries)):
            try:
                result = thunk()
            except Exception as e:
                notes.append(f"{name}: {type(e).__name__}: {e}"[:160])
                clean = False
                continue
            if validator is not None:
                metrics.inc("guard.validation", engine=name)
                try:
                    ok = bool(validator(result))
                except Exception as e:
                    notes.append(
                        f"{name} validator: {type(e).__name__}: {e}"[:160])
                    ok = False
                if not ok:
                    metrics.inc("guard.validation_failed", engine=name)
                    if not notes or not notes[-1].startswith(f"{name} "):
                        notes.append(f"{name} failed validation")
                    clean = False
                    continue
            return result, (name if clean else f"{name}:recovered"), notes
    raise FallbackExhausted(notes)


def all_finite(x) -> bool:
    """NaN/Inf validator of a tensor or array (a host sync on the card)."""
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return bool(np.isfinite(np.asarray(x)).all())


def guard_env() -> bool:
    """``MOMP_GUARD=1`` arms the guards without a chaos plan."""
    return os.environ.get("MOMP_GUARD", "0") == "1"


def guards_active() -> bool:
    """Whether validators run: an unsuppressed chaos plan that did not opt
    out with ``noguard``, or ``MOMP_GUARD=1``."""
    plan = chaos.active_plan()
    return (plan is not None and plan.guard) or guard_env()


# The ordered recent stamps, capped so that a pathological loop of
# recoveries cannot grow the process without bound.
RECOVERY_LOG_CAP = 256
_RECOVERIES: collections.deque[str] = collections.deque(
    maxlen=RECOVERY_LOG_CAP)


def record_recovery(stamp: str) -> None:
    """The one funnel every recovery passes through: the log, the
    ``recovery{stamp=...}`` counter and a ``recovery`` trace event."""
    _RECOVERIES.append(stamp)
    metrics.inc("recovery", stamp=stamp)
    trace.event("recovery", stamp=stamp)


def recovery_log() -> list[str]:
    """The most recent recovery stamps, oldest first (at most
    :data:`RECOVERY_LOG_CAP`)."""
    return list(_RECOVERIES)


def reset_recovery_log() -> None:
    """Empty the log (the registry's counters stay: ``obs.metrics.reset``
    empties those)."""
    _RECOVERIES.clear()
