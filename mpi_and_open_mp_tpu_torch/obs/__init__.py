"""Observability: span tracing, a metrics registry, trace reporting and
the fleet's telemetry plane.

Counterpart of ``mpi_and_open_mp_tpu/obs``, standard library and torch
only, and free when off:

``trace``
    Nestable spans (a context manager), wall durations on
    ``utils.timing.Timer``, process and host ids, and a JSONL sink named by
    ``MOMP_TRACE=path``. ``span.anchor(x)`` closes a span through a sync of
    the card, so its duration covers the device work it launched. With
    ``MOMP_TRACE`` unset every call is one env lookup returning a shared
    no-op span.
``metrics``
    Process-wide counters, gauges and histograms: retraces (here, distinct
    launch geometries), ring hops per engine, halo exchanges and
    schedules, guard validations and recoveries, checkpoint bytes and
    seconds, batcher requests. On by default; ``MOMP_METRICS=0`` turns
    every recorder off.
``report``
    Host-side analysis of a trace file: the phase breakdown, the ring hop
    fit, recoveries and retraces, and a Chrome trace-event export
    (``to_chrome``).
``telemetry``
    The fleet's time series: quantile histograms on declared geometric
    buckets, per-worker snapshot rings, the SLO burn-rate monitor and the
    CRC-framed sidecar stream a worker process ships (byte-compatible with
    the JAX package's).

The JAX package's other two modules wait for their callers: ``profile``
(compiled cost analysis against per-device peaks) and ``ledger`` (the
cross-run JSONL ledger) come with the port's bench entry, their only
callers being ``bench.py`` and ``analysis/regression_sentinel.py``
(ROADMAP Queue 1 item 4).
"""

from mpi_and_open_mp_tpu_torch.obs import (  # noqa: F401
    metrics,
    report,
    telemetry,
    trace,
)
