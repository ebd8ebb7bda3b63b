"""Deterministic fault injection, driven by ``MOMP_CHAOS``.

Counterpart of ``mpi_and_open_mp_tpu/robust/chaos.py``. A spec is a
semicolon-separated list of tokens::

    MOMP_CHAOS="halo=corrupt;delay=0.01;preempt=60;seed=7"

:meth:`FaultPlan.parse` reads the JAX package's whole grammar, so one
string means the same plan in both packages and a bad token raises the
same error. Tokens with a hook in the port:

``halo=corrupt`` / ``halo=drop``
    Every ghost exchange's incoming top ghost (y) and left ghost (x) is
    filled with a seeded out-of-range value, or zeroed (the exchange
    "never arrived"): ``parallel.halo._chaos_ghost``, and on the RDMA
    rung's frame the rows and columns those ghosts fill
    (``parallel.haloplan._rdma_frame``).
``delay=<seconds>``
    A host-side delay before every segment of a ``LifeSim.run`` that runs
    segments, inside ``parallel.fabric.ping``'s timed bracket, and before
    each attempt of a serving dispatch (:func:`dispatch_delay`: a
    congested fabric, as in the JAX package).
``preempt=<step>``
    :class:`~mpi_and_open_mp_tpu_torch.robust.preempt.SimulatedPreemption`
    when a ``LifeSim.run`` crosses global step ``<step>``, after flushing a
    checkpoint when one is configured; the serving daemon reads it in
    batches: it drains after dispatching ``<step>`` batches.
``nan_hop=<j>`` / ``inf_hop=<j>``
    Ring attention's K/V blocks arrive at hop ``j`` of the forward with a
    NaN or Inf added, on every shard of the stack: the hop engines and the
    plain fold of ``parallel/context.py`` read :func:`hop_poison_spec` at
    each call and wrap their fold in :func:`poisoned_fold` (hop 0 through
    :func:`poison_hop`). Under the guards ``ring_attention`` then recovers
    on a clean re-run of the same engine
    (``ring_attention:<engine>:recovered``).
``seed=<int>``
    Seed of the corrupted value (default 0).
``noguard``
    Inject without arming the guards: the run must then diverge, which
    shows that the fault landed.

``aot_corrupt=<kind>:<k>``
    The first ``k`` launch records ``serve.aotcache.save_artifact`` writes
    are damaged on disk after the clean write (:func:`take_aot_corrupt`):
    ``bitflip`` flips one bit mid-file (the next load is ``corrupt``),
    ``skew`` rewrites the key with a foreign ``torch`` version (``stale``).

``serve_fail=<k>``
    The first ``k`` batch dispatches of the serving daemon fail at their
    primary engine (:func:`take_serve_fault`), which drives the daemon's
    engine ladder and retries (``serve.daemon``).
``crash=<site>:<k>``
    ``os._exit(CRASH_EXIT)`` (137, as a SIGKILL reports: no atexit, no
    ``finally``, no flush) at the ``k``-th arrival at the named site
    (:func:`crash_armed`, :func:`crash_now`). Hooked: ``post-admit`` (a
    ticket admitted, its journal record not yet written), ``mid-frame``
    (half a journal frame written, ``serve.wal``) and ``post-dispatch`` (a
    batch computed, its RESOLVE record not yet written); the session
    pool's ``post-create``, ``post-step``, ``post-snapshot`` and
    ``post-evict`` (the daemon's CREATE, STEP, SNAPSHOT or EVICT frame
    journaled, the pool not yet acted on it) and ``post-rejoin``
    (``adopt_session``'s CREATE and STEP frames journaled, the session not
    yet in the pool) and ``mid-drain`` (``serve.router.FleetRouter.
    drain_worker``: a bucket adopted at the destination, the source's
    ``re-homed`` SHED not yet journaled).
``kill_worker=<i>:<k>``
    The daemon whose ``worker_index`` is ``i`` dies as ``crash`` does at
    its ``k``-th batch dispatch, after the DISPATCH record is journaled
    (:func:`kill_worker_armed`). A daemon's index is its constructor's
    ``worker_index``: ``serve.fleet`` numbers its workers 0..N-1, in
    process (:class:`~mpi_and_open_mp_tpu_torch.serve.fleet.Fleet`) and as
    worker processes (the CLI's ``--worker-main``; recovery workers run
    with ``MOMP_CHAOS`` stripped).

Hit counters (:attr:`FaultPlan.serve_failed`, ``crash_hits``,
``kill_worker_hits``, ``aot_corrupted``) count in this process, as the JAX
package's do.

The JAX package decides injection when it traces a program, so a fault
stays in that program until a rebuild under :func:`suppressed`. The port's
hooks run at every exchange call: inside :func:`suppressed` they inject
nothing, so a recovery re-runs its segment clean without a rebuild, and
the boards are the same as the JAX package's. ``MOMP_CHAOS`` is read once
per process (again after :func:`reset`), as a JAX stepper keeps the plan
it was traced under. With it unset, :func:`active_plan` is ``None`` and
every hook returns its input after two attribute tests: no launch, no
copy, no host sync, no read of the environment.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

ENV = "MOMP_CHAOS"

_HALO_KINDS = ("corrupt", "drop")

#: Sites of the ``crash=<site>:<k>`` token (the serving layer's).
CRASH_SITES = ("post-admit", "mid-frame", "post-dispatch",
               "post-create", "post-step", "post-snapshot", "post-evict",
               "post-rejoin", "mid-drain")

#: The exit status of an injected hard kill: 128 + SIGKILL, so a requeue
#: loop cannot tell it from a real ``kill -9``.
CRASH_EXIT = 137

#: Artifact-damage modes of the ``aot_corrupt=<kind>:<k>`` token.
AOT_CORRUPT_KINDS = ("bitflip", "skew")


@dataclasses.dataclass
class FaultPlan:
    """A parsed ``MOMP_CHAOS`` spec and its runtime state: the preemption
    latch and the hit counters, the JAX package's fields."""

    raw: str
    seed: int = 0
    hop_poison: tuple[str, int] | None = None  # ("nan"|"inf", hop index)
    halo_fault: str | None = None  # "corrupt" | "drop"
    delay_s: float = 0.0
    preempt_step: int | None = None
    guard: bool = True
    preempt_fired: bool = False  # in-process refire latch
    serve_fail: int = 0  # serve-dispatch faults to inject
    serve_failed: int = 0  # of them spent (take_serve_fault)
    crash_site: str | None = None
    crash_at: int = 0  # the arrival at crash_site that kills, 1-based
    crash_hits: int = 0  # arrivals counted (crash_armed)
    kill_worker_idx: int | None = None
    kill_worker_at: int = 0  # the dispatch of that worker that kills
    kill_worker_hits: int = 0  # its dispatches counted (kill_worker_armed)
    aot_corrupt_kind: str | None = None
    aot_corrupt: int = 0
    aot_corrupted: int = 0  # artifact faults spent (take_aot_corrupt)

    @classmethod
    def parse(cls, raw: str) -> "FaultPlan":
        plan = cls(raw=raw)
        for token in raw.split(";"):
            token = token.strip()
            if not token:
                continue
            key, _, val = token.partition("=")
            try:
                if key in ("nan_hop", "inf_hop"):
                    plan.hop_poison = (key[:3], int(val))
                elif key == "halo":
                    if val not in _HALO_KINDS:
                        raise ValueError(f"want one of {_HALO_KINDS}")
                    plan.halo_fault = val
                elif key == "delay":
                    plan.delay_s = float(val)
                    if plan.delay_s < 0:
                        raise ValueError("negative delay")
                elif key == "preempt":
                    plan.preempt_step = int(val)
                elif key == "serve_fail":
                    plan.serve_fail = int(val)
                    if plan.serve_fail < 0:
                        raise ValueError("negative serve_fail")
                elif key == "crash":
                    site, _, k = val.partition(":")
                    if site not in CRASH_SITES:
                        raise ValueError(f"want one of {CRASH_SITES}")
                    plan.crash_site = site
                    plan.crash_at = int(k) if k else 1
                    if plan.crash_at < 1:
                        raise ValueError("crash count must be >= 1")
                elif key == "kill_worker":
                    idx, _, k = val.partition(":")
                    plan.kill_worker_idx = int(idx)
                    if plan.kill_worker_idx < 0:
                        raise ValueError("worker index must be >= 0")
                    plan.kill_worker_at = int(k) if k else 1
                    if plan.kill_worker_at < 1:
                        raise ValueError("kill count must be >= 1")
                elif key == "aot_corrupt":
                    kind, _, k = val.partition(":")
                    if kind not in AOT_CORRUPT_KINDS:
                        raise ValueError(f"want one of {AOT_CORRUPT_KINDS}")
                    plan.aot_corrupt_kind = kind
                    plan.aot_corrupt = int(k) if k else 1
                    if plan.aot_corrupt < 1:
                        raise ValueError("aot_corrupt count must be >= 1")
                elif key == "seed":
                    plan.seed = int(val)
                elif key == "noguard" and not val:
                    plan.guard = False
                else:
                    raise ValueError("unknown token")
            except ValueError as e:
                raise ValueError(
                    f"MOMP_CHAOS: bad token {token!r} in {raw!r} ({e})"
                ) from None
        return plan

    def preempt_pending(self, step: int) -> bool:
        """Will the preemption still fire for a run now at ``step``? False
        once it fired in this process, and when the run starts at or past
        the preempt step: a ``--resume`` of the same spec continues."""
        return (
            self.preempt_step is not None
            and not self.preempt_fired
            and step < self.preempt_step
        )


_UNREAD = object()
_PLAN = _UNREAD  # the parsed MOMP_CHAOS (or None): read once, until reset()
_HALO: tuple[str, int] | None = None  # the plan's halo fault, read with it
_SUPPRESS = 0


def _read() -> FaultPlan | None:
    global _PLAN, _HALO
    raw = os.environ.get(ENV, "")
    plan = FaultPlan.parse(raw) if raw else None
    _PLAN = plan
    _HALO = (None if plan is None or plan.halo_fault is None
             else (plan.halo_fault, plan.seed))
    return plan


def active_plan() -> FaultPlan | None:
    """The live :class:`FaultPlan`, or ``None`` when ``MOMP_CHAOS`` is
    unset or empty, or injection is :func:`suppressed`. The variable is
    read at the first call and again only after :func:`reset`, so the
    runtime state (the preemption latch) persists and an idle hook reads
    no environment."""
    if _SUPPRESS:
        return None
    return _read() if _PLAN is _UNREAD else _PLAN


def reset() -> None:
    """Drop the cached plan: the next call reads ``MOMP_CHAOS`` again (a
    process that changes the variable calls this after)."""
    global _PLAN, _HALO
    _PLAN, _HALO = _UNREAD, None


@contextlib.contextmanager
def suppressed():
    """No injection inside (re-entrant): a recovery re-runs its segment
    here, so a fault does not fire again on the retry."""
    global _SUPPRESS
    _SUPPRESS += 1
    try:
        yield
    finally:
        _SUPPRESS -= 1


def hop_poison_spec() -> tuple[str, int] | None:
    """``(kind, hop)`` for the ring fold engines to poison, or ``None`` (no
    plan, :func:`suppressed`, or no hop fault)."""
    plan = active_plan()
    return None if plan is None else plan.hop_poison


def poison_hop(kb, vb, j: int, spec):
    """A ring hop's K/V blocks, with a NaN or Inf added to every element
    when ``j`` is the planned hop, else the blocks themselves. ``kb`` and
    ``vb`` are tensors or tuples of tensors (the zigzag halves)."""
    kind, hop = spec
    if j != hop:
        return kb, vb
    bad = float("nan") if kind == "nan" else float("inf")

    def poison(x):
        return tuple(y + bad for y in x) if isinstance(x, tuple) else x + bad

    return poison(kb), poison(vb)


def poisoned_fold(fold, spec):
    """Wrap a ring fold ``(j, state, kb, vb) -> state`` so the planned
    hop's K/V arrive poisoned."""

    def wrapped(j, state, kb, vb):
        kb, vb = poison_hop(kb, vb, j, spec)
        return fold(j, state, kb, vb)

    return wrapped


def halo_ghost_spec() -> tuple[str, int] | None:
    """``(kind, seed)`` of the halo fault to apply to incoming ghosts, or
    ``None``: once the plan is read, two module attribute tests."""
    if _PLAN is _UNREAD:
        _read()
    if _HALO is None or _SUPPRESS:
        return None
    return _HALO


def ghost_value(spec: tuple[str, int]) -> int:
    """The value a faulted ghost holds: 0 for ``drop``, for ``corrupt``
    the JAX package's seeded draw from ``[2, 200)``."""
    kind, seed = spec
    if kind == "drop":
        return 0
    return int(np.random.default_rng(seed).integers(2, 200))


def corrupt_ghost(ghost, spec):
    """A faulted ghost block of ``ghost``'s shape, dtype and device: zeroed
    (``drop``) or filled with :func:`ghost_value` (``corrupt``)."""
    return torch.full_like(ghost, ghost_value(spec))


def dispatch_delay() -> float:
    """Seconds of host-side delay to inject per guarded dispatch (0.0
    when inactive)."""
    plan = active_plan()
    return 0.0 if plan is None else plan.delay_s


def take_aot_corrupt() -> str | None:
    """Spend one artifact fault of the plan's ``aot_corrupt`` budget: the
    kind (``"bitflip"`` or ``"skew"``) to apply to the artifact just saved,
    or None. The first ``k`` saves are damaged and every later one stays
    clean; None whenever no plan is active or injection is
    :func:`suppressed`."""
    plan = active_plan()
    if plan is None or plan.aot_corrupted >= plan.aot_corrupt:
        return None
    plan.aot_corrupted += 1
    return plan.aot_corrupt_kind


def take_serve_fault() -> bool:
    """Spend one serve-dispatch fault of the plan's ``serve_fail`` budget:
    True means this dispatch must fail (the daemon's primary engine
    raises). The first ``k`` calls return True and every later one False;
    False whenever no plan is active or injection is :func:`suppressed`,
    so a recovery rung runs clean."""
    plan = active_plan()
    if plan is None or plan.serve_failed >= plan.serve_fail:
        return False
    plan.serve_failed += 1
    return True


def crash_armed(site: str) -> bool:
    """Count one arrival at ``site``; True exactly when it is the plan's
    ``k``-th there. The caller then tears what the site tears (half a
    frame, or nothing) and calls :func:`crash_now`. No counting when no
    plan targets ``site`` or injection is :func:`suppressed`."""
    plan = active_plan()
    if plan is None or plan.crash_site != site:
        return False
    plan.crash_hits += 1
    return plan.crash_hits == plan.crash_at


def kill_worker_armed(worker_index: int | None) -> bool:
    """Count one batch dispatch of worker ``worker_index``; True exactly
    when it is the planned victim's ``k``-th, and the caller then calls
    :func:`crash_now`. No counting for a daemon without an index, another
    index, no plan, or :func:`suppressed` injection."""
    plan = active_plan()
    if (plan is None or worker_index is None
            or plan.kill_worker_idx != worker_index):
        return False
    plan.kill_worker_hits += 1
    return plan.kill_worker_hits == plan.kill_worker_at


def crash_now() -> None:
    """Die as hard as ``kill -9``: ``os._exit`` runs no atexit hook, no
    ``finally`` and flushes nothing, so only what was already written to
    the journal survives."""
    os._exit(CRASH_EXIT)
