"""Fault injection, guards, preemption-safe resume.

Counterpart of ``mpi_and_open_mp_tpu/robust``, three small modules:

``chaos``
    ``MOMP_CHAOS``-driven deterministic fault injection: corrupted or
    dropped halo ghosts, a poisoned ring-attention hop, a per-segment
    delay, a simulated preemption. The
    variable is read once; when it is unset every hook is an attribute
    test.
``guards``
    ``with_fallback(engines, validator)``, the engine-ranked retry with
    ``:recovered`` provenance that ``LifeSim``'s guarded step and
    ``ring_attention``'s guarded dispatch run, the validators, and the
    process-wide recovery log.
``preempt``
    SIGTERM/SIGINT, then a checkpoint flush at a segment boundary, then
    exit 75, and the :class:`Preempted` contract drivers key on.

The JAX package's fourth module, ``watchdog`` (the device probe with
backoff), waits for its first caller, the serving daemon's port (ROADMAP
Queue 1 item 9).
"""
