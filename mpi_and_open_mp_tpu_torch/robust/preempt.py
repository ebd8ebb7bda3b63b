"""Preemption-safe shutdown: a signal asks for a checkpoint flush.

Counterpart of ``mpi_and_open_mp_tpu/robust/preempt.py``. The reference's
answer to a preempted job was to requeue it and start again from step 0.
Here a SIGTERM or SIGINT only sets a flag, which ``LifeSim.run`` reads at
its segment boundaries: the loop flushes a checkpoint and raises
:class:`Preempted`, which the Life CLI turns into exit code 75
(EX_TEMPFAIL); a queue that requeues on 75 continues the run with
``--resume`` from the flushed step.

The handler does nothing but set the flag: no file or device work runs
inside it. The flush happens in the run loop, between segments, where the
board is a whole step.
"""

from __future__ import annotations

import contextlib
import signal
import threading

EXIT_PREEMPTED = 75  # EX_TEMPFAIL: transient, resumable - requeue me


class Preempted(RuntimeError):
    """A run stopped early with its state flushed; resume to continue."""

    def __init__(self, step: int, checkpoint: str | None = None,
                 signum: int | None = None):
        self.step = int(step)
        self.checkpoint = checkpoint
        self.signum = signum
        how = (f"signal {signum}" if signum is not None else "chaos plan")
        where = f"; checkpoint {checkpoint}" if checkpoint else ""
        super().__init__(f"preempted at step {step} by {how}{where}")


class SimulatedPreemption(Preempted):
    """The ``MOMP_CHAOS`` ``preempt=<k>`` fault: the same recovery contract
    as a real signal, without the dying process."""


class SignalWatch:
    """The flag a run loop polls; ``fired`` is the signum or ``None``."""

    def __init__(self):
        self.fired: int | None = None


@contextlib.contextmanager
def flush_on_signal(enabled: bool = True):
    """Arm SIGTERM and SIGINT to ask for a checkpoint flush at the next
    segment boundary. Yields a :class:`SignalWatch`; the previous handlers
    are restored on exit. A no-op (a watch that never fires) when disabled
    or off the main thread, where ``signal.signal`` would raise."""
    watch = SignalWatch()
    if not enabled or threading.current_thread() is not threading.main_thread():
        yield watch
        return
    prev = {}

    def handler(signum, frame):
        watch.fired = signum

    try:
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[s] = signal.signal(s, handler)
            except (ValueError, OSError):  # an unusual embedding: no-op
                pass
        yield watch
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
