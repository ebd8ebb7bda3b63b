"""Serving policy: admission control, load shedding, deadline budgets.

Counterpart of ``mpi_and_open_mp_tpu/serve/policy.py``, whole. Pure
decision logic (no clock, no IO, no torch), so every admission and shed
rule is a unit test without a daemon: ``serve.daemon`` owns the side
effects, this module the numbers they are judged against.

The two admission budgets guard what a shape-bucketed server can run out
of:

* **Depth**: a queue deeper than the worker can drain inside the
  per-request timeout is already lost, so it is cheaper, and honest, to
  reject at the door with a reason than to time the request out later.
* **Padding waste**: a bucket chunk pads its live requests up to a power
  of two, or to a multiple of a 32-board plane where the shape is
  board-sliced (``serve.batcher.bucket_batch_size``), so a hostile mix
  could make the card step mostly dead zero-boards. :func:`padding_waste`
  estimates that share over the pending set; admission rejects a request
  that would push it past budget.

Shed reasons are a closed vocabulary (the ``SHED_*`` names): every
rejected or abandoned ticket carries exactly one, and metrics count them
per reason (``serve.shed{reason=...}``).

The elastic half (:class:`ElasticityPolicy`, :class:`ElasticController`)
is the fleet's scaling loop (``serve.fleet.Fleet``'s elasticity tick).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

from mpi_and_open_mp_tpu_torch.serve.batcher import bucket_batch_size

#: Admission rejected: pending depth at ``max_depth``.
SHED_DEPTH = "queue-depth"
#: Admission rejected: estimated padding waste past ``max_padding_frac``.
SHED_PADDING = "padding-waste"
#: Abandoned: the ticket aged past ``request_timeout_s`` before a
#: dispatch could resolve it (pathological shapes must not starve peers).
SHED_TIMEOUT = "timeout"
#: Abandoned: every engine of every retry of the recovery ladder failed.
SHED_DISPATCH = "dispatch-failed"
#: Handed off: the ticket left THIS worker's books for another fleet
#: worker (wedged-worker re-home or a whole-bucket work steal). Not a
#: terminal outcome for the REQUEST — the router pairs every re-homed
#: shed with an adoption elsewhere, and the fleet books count the
#: request once, at its final owner.
SHED_REHOMED = "re-homed"

SHED_REASONS = (SHED_DEPTH, SHED_PADDING, SHED_TIMEOUT, SHED_DISPATCH,
                SHED_REHOMED)


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """The serving daemon's knobs, one immutable bundle.

    ``max_wait_s`` is the padding-vs-latency trade: a bucket that never
    fills to ``max_batch`` still flushes once its oldest ticket has
    waited this long, bounding p99 at the cost of a padded dispatch.
    ``request_timeout_s`` is the end-to-end budget per ticket; the
    retry/backoff ladder never sleeps past it. Backoff is the
    ``robust.watchdog`` capped-exponential schedule with seeded jitter
    (thundering-herd guard when a queue loop requeues several daemons at
    once).
    """

    max_batch: int = 8
    max_depth: int = 64
    max_padding_frac: float = 0.375
    max_wait_s: float = 0.05
    request_timeout_s: float = 30.0
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0
    backoff_jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {self.max_depth}")
        if not 0.0 <= self.max_padding_frac <= 1.0:
            raise ValueError(
                f"max_padding_frac must be in [0, 1], got "
                f"{self.max_padding_frac}")
        for name in ("max_wait_s", "request_timeout_s", "backoff_base_s",
                     "backoff_cap_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")


def padding_waste(
    bucket_counts: Iterable[int | tuple[int, int | None]],
    max_batch: int,
) -> float:
    """Estimated dead-padding fraction of dispatching these buckets now.

    Each bucket of ``r`` live requests dispatches as full ``max_batch``
    chunks plus one remainder chunk padded by
    ``serve.batcher.bucket_batch_size``; the waste is padded slots minus
    live requests over padded slots. 0.0 for an empty queue (nothing to
    dispatch wastes nothing).

    Items may be plain counts or ``(count, slice_width)`` pairs — the
    width the dispatcher will ACTUALLY pad that bucket's shape with
    (``ops.native_life.batch_slice_width``: 32 for board-sliced
    shapes, ``None`` for the pow2 ladder). Admission must project with
    the same width the dispatcher rounds with, or tickets get shed
    against the wrong denominator. For a width bucket that denominator
    is the PLANE, not the board slot: the board-sliced engine's cost
    unit is one plane of vector work, a partly-dead plane costs exactly
    what a full one does, and ``ceil(r/width)`` planes is already the
    minimum any dispatch of ``r`` such requests can pay — so plane
    padding is not avoidable waste, and the bucket counts as its plane
    quanta, fully live. (Counting dead board SLOTS here was the cliff
    this rule replaces: request 9 of a 64² bucket projected 72% "waste"
    and was shed, while its true marginal cost was zero.) Pow2 buckets
    keep the board-slot math: there each padded board costs a board's
    work."""
    live = padded = 0
    for item in bucket_counts:
        r, width = item if isinstance(item, tuple) else (item, None)
        if r <= 0:
            continue
        full, rest = divmod(r, max_batch)
        if width and width <= max_batch:
            boards = full * max_batch
            if rest:
                boards += bucket_batch_size(rest, max_batch,
                                            slice_width=width)
            quanta = -(-boards // width)
            live += quanta
            padded += quanta
            continue
        live += r
        padded += full * max_batch
        if rest:
            padded += bucket_batch_size(rest, max_batch, slice_width=width)
    if padded == 0:
        return 0.0
    return (padded - live) / padded


def admit(policy: ServePolicy, depth: int,
          bucket_counts_after: Iterable[int | tuple[int, int | None]],
          ) -> str | None:
    """Admission verdict for one candidate request: ``None`` to accept,
    else the shed reason. ``depth`` is the pending count BEFORE the
    candidate; ``bucket_counts_after`` are per-bucket pending counts
    WITH the candidate already placed in its bucket — plain counts or
    ``(count, slice_width)`` pairs, as :func:`padding_waste` takes."""
    if depth >= policy.max_depth:
        return SHED_DEPTH
    if padding_waste(bucket_counts_after,
                     policy.max_batch) > policy.max_padding_frac:
        return SHED_PADDING
    return None


def rollup(policies: Iterable[ServePolicy]) -> ServePolicy:
    """One fleet-wide admission projection over per-worker budgets — the
    policy the router's door gate judges against BEFORE a request is
    routed to its affinity worker.

    Capacity budgets ADD across the fleet (``max_depth``: N workers
    drain N queues concurrently) while every per-request knob takes the
    most conservative worker's value (``max_padding_frac``, deadlines,
    timeouts, retries): the door must never promise latitude some shard
    cannot honor, or a hot shard wedges on work the fleet as a whole
    "had room" for. ``max_batch`` takes the max — padding-waste
    projection at the door needs the coarsest chunk quantum any worker
    will actually pad with. Raises ``ValueError`` on an empty fleet."""
    ps = list(policies)
    if not ps:
        raise ValueError("rollup: need at least one worker policy")
    return ServePolicy(
        max_batch=max(p.max_batch for p in ps),
        max_depth=sum(p.max_depth for p in ps),
        max_padding_frac=min(p.max_padding_frac for p in ps),
        max_wait_s=min(p.max_wait_s for p in ps),
        request_timeout_s=min(p.request_timeout_s for p in ps),
        max_retries=min(p.max_retries for p in ps),
        backoff_base_s=min(p.backoff_base_s for p in ps),
        backoff_cap_s=min(p.backoff_cap_s for p in ps),
        backoff_jitter=ps[0].backoff_jitter,
        seed=ps[0].seed,
    )


@dataclasses.dataclass(frozen=True)
class ElasticityPolicy:
    """Knobs for the SLO-driven scaling loop, one immutable bundle.

    The loop judges a live ``(p99, goodput/offered, depth)`` signal
    against a declared SLO and decides ``add`` / ``drain`` / nothing.
    Hysteresis is structural, not tuned-by-hope: an action needs
    ``breach_k`` (or ``surplus_k``) CONSECUTIVE observations on the
    same side, and after any action the controller holds still for
    ``cooldown_k`` observations — a signal oscillating inside one
    window can never flap the fleet, because neither streak completes.

    ``surplus_p99_frac``/``surplus_depth`` define "provably idle":
    scale-down needs the tail comfortably under SLO AND an (almost)
    empty fleet-wide queue — draining a worker that still holds depth
    would trade capacity for migration traffic at the worst moment.
    """

    slo_p99_s: float = 0.25
    slo_goodput_frac: float = 0.9
    min_workers: int = 1
    max_workers: int = 8
    breach_k: int = 3
    surplus_k: int = 6
    cooldown_k: int = 4
    surplus_p99_frac: float = 0.5
    surplus_depth: int = 0

    def __post_init__(self):
        if self.slo_p99_s <= 0:
            raise ValueError(
                f"slo_p99_s must be > 0, got {self.slo_p99_s}")
        if not 0.0 < self.slo_goodput_frac <= 1.0:
            raise ValueError(
                f"slo_goodput_frac must be in (0, 1], got "
                f"{self.slo_goodput_frac}")
        if self.min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1, got {self.min_workers}")
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) must be >= "
                f"min_workers ({self.min_workers})")
        for name in ("breach_k", "surplus_k"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.cooldown_k < 0:
            raise ValueError(
                f"cooldown_k must be >= 0, got {self.cooldown_k}")
        if not 0.0 <= self.surplus_p99_frac < 1.0:
            raise ValueError(
                f"surplus_p99_frac must be in [0, 1), got "
                f"{self.surplus_p99_frac}")


#: Controller verdicts (:meth:`ElasticController.observe`).
SCALE_ADD = "add"
SCALE_DRAIN = "drain"


class ElasticController:
    """Pure hysteresis state machine over the elasticity policy.

    Clock-free and IO-free like everything else in this module: the
    fleet loop feeds it one observation per evaluation window and acts
    on the verdict; unit tests feed it synthetic signals and assert it
    cannot flap. ``observe`` returns :data:`SCALE_ADD`,
    :data:`SCALE_DRAIN`, or ``None``.
    """

    def __init__(self, policy: ElasticityPolicy | None = None):
        self.policy = policy or ElasticityPolicy()
        self.breach_streak = 0
        self.surplus_streak = 0
        self.cooldown = 0
        self.actions: list[str] = []

    def observe(self, *, p99_s: float, depth: int, workers: int,
                goodput_rps: float | None = None,
                offered_rps: float | None = None) -> str | None:
        """Judge one evaluation window. ``p99_s`` is the live tail over
        the window (0.0 = nothing resolved, which counts as a breach
        only when work was offered), ``depth`` the fleet-wide pending
        count, ``workers`` the current live worker count."""
        pol = self.policy
        starved = bool(offered_rps) and not goodput_rps
        breach = p99_s > pol.slo_p99_s or starved
        if (goodput_rps is not None and offered_rps is not None
                and offered_rps > 0):
            breach = breach or (goodput_rps
                                < pol.slo_goodput_frac * offered_rps)
        surplus = (p99_s < pol.surplus_p99_frac * pol.slo_p99_s
                   and depth <= pol.surplus_depth and not starved)
        if breach:
            self.breach_streak += 1
            self.surplus_streak = 0
        elif surplus:
            self.surplus_streak += 1
            self.breach_streak = 0
        else:
            self.breach_streak = 0
            self.surplus_streak = 0
        if self.cooldown > 0:
            self.cooldown -= 1
            return None
        if (self.breach_streak >= pol.breach_k
                and workers < pol.max_workers):
            return self._acted(SCALE_ADD)
        if (self.surplus_streak >= pol.surplus_k
                and workers > pol.min_workers):
            return self._acted(SCALE_DRAIN)
        return None

    def _acted(self, verdict: str) -> str:
        self.actions.append(verdict)
        self.breach_streak = 0
        self.surplus_streak = 0
        self.cooldown = self.policy.cooldown_k
        return verdict


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]) — the p50/p99 the
    bench line publishes. 0.0 on an empty list so a fully-shed run still
    renders a line."""
    if not values:
        return 0.0
    xs = sorted(values)
    if q <= 0:
        return xs[0]
    idx = max(0, min(len(xs) - 1, int(-(-q * len(xs) // 100)) - 1))
    return xs[idx]
