"""Observability: span tracing, a metrics registry, and trace reporting.

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

The JAX package's other three modules wait for their callers:
``profile`` (compiled cost analysis against per-device peaks) and
``ledger`` (the cross-run JSONL ledger) come with the port's bench entry,
their only callers being ``bench.py`` and
``analysis/regression_sentinel.py``; ``telemetry`` (the fleet time series)
comes with the serving stack, whose router and fleet first call it
(ROADMAP Queue 1 items 4 and 9).
"""

from mpi_and_open_mp_tpu_torch.obs import metrics, report, trace  # noqa: F401
