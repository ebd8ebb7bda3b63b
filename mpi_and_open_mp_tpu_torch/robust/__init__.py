"""Fault injection, guards, preemption-safe resume.

Counterpart of ``mpi_and_open_mp_tpu/robust``, four small modules:

``chaos``
    ``MOMP_CHAOS``-driven deterministic fault injection: corrupted or
    dropped halo ghosts, a poisoned ring-attention hop, a per-segment
    delay, a simulated preemption, and the serving daemon's faults (a
    failed dispatch, a hard kill at a journal site). The variable is read
    once; when it is unset every hook is an attribute test.
``guards``
    ``with_fallback(engines, validator)``, the engine-ranked retry with
    ``:recovered`` provenance that ``LifeSim``'s guarded step,
    ``ring_attention``'s guarded dispatch and the serving daemon's engine
    ladder run, the validators, and the process-wide recovery log.
``preempt``
    SIGTERM/SIGINT, then a checkpoint flush at a segment boundary, then
    exit 75, and the :class:`Preempted` contract drivers key on.
``watchdog``
    The device probe in a child process, and the bounded, seeded backoff
    the serving daemon retries behind.
"""
