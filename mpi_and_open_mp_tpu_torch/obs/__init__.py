"""Observability: span tracing, a metrics registry, trace reporting, the
fleet's telemetry plane, the run ledger and work models.

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

``ledger``
    The cross-run JSONL ledger, byte-compatible with the JAX package's:
    every bench line stamped with git SHA, platform, device kind and a
    configuration key, the store ``analysis/regression_sentinel.py``
    judges a new run against. Standard library only.
``profile``
    Work models and rooflines in the card's terms: ``cost`` counts a plain
    PyTorch function's operations and bytes on ``meta`` tensors,
    ``roofline`` places a measured time against the H100's data-sheet
    peaks (the JAX package's table beside them), ``record_memory_gauges``
    gauges live and in-use bytes; and the card's issue rates and the
    bound functions ``chip_smoke.py`` holds each kernel to.
"""

from mpi_and_open_mp_tpu_torch.obs import (  # noqa: F401
    ledger,
    metrics,
    report,
    telemetry,
    trace,
)
