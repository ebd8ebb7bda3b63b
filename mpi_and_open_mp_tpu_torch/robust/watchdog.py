"""Watchdogged device discovery and bounded backoff.

Counterpart of ``mpi_and_open_mp_tpu/robust/watchdog.py``. Device
discovery is probed in a child process first (``torch.cuda.init()`` and a
device count of at least one), so a CUDA stack that hangs there hangs the
child, not the caller, and a caller whose probes run dry gets an honest
``degraded`` result instead of a hang.

Two rules, the JAX package's:

* A hung probe child is abandoned, never killed: killing a client in the
  middle of a device claim can leave the device worse than the hang.
* Backoff is bounded and deterministic (capped exponential, jitter drawn
  from a seeded ``random.Random``): the same seed gives the same waits to
  the bit in both packages, and an unbounded retry against a wedged
  device is only a slower hang.

The serving daemon draws its retry schedule from :func:`backoff`.
"""

from __future__ import annotations

import dataclasses
import random
import subprocess
import sys
import tempfile
import time
from typing import Iterator

#: What the probe child runs: CUDA discovery, and at least one device.
PROBE_CODE = ("import sys, torch; torch.cuda.init(); "
              "sys.exit(0 if torch.cuda.device_count() >= 1 else 3)")


def probe_once(timeout_s: float) -> tuple[bool, str]:
    """Can a child process finish CUDA device discovery in time?

    On timeout the child is abandoned un-killed (module docstring); the
    tail of its stderr rides the failure note, as the CUDA error in it
    is what an operator needs."""
    with tempfile.TemporaryFile() as err:
        child = subprocess.Popen([sys.executable, "-c", PROBE_CODE],
                                 stdout=subprocess.DEVNULL, stderr=err)

        def tail() -> str:
            err.seek(0)
            text = err.read().decode(errors="replace").strip()
            return f": ...{text[-160:]}" if text else ""

        try:
            rc = child.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return False, ("TimeoutExpired: discovery hung; probe "
                           "abandoned un-killed" + tail())
        if rc == 0:
            return True, ""
        return False, f"probe exit {rc}" + tail()


def backoff(base_s: float = 2.0, cap_s: float = 60.0, *,
            jitter: float = 0.0, seed: int | None = None,
            ) -> Iterator[float]:
    """Capped-exponential waits as a pure generator: base, 2·base,
    4·base, ... up to ``cap_s``, each scaled by a seeded jitter factor
    drawn uniformly from ``[1 - jitter, 1]``. The jitter spreads retries
    of several requeued processes apart while any one schedule stays
    reproducible; ``jitter=0`` is the plain schedule. The generator never
    sleeps and never ends: a caller takes as many waits as its budget
    allows."""
    if not 0.0 <= jitter <= 1.0:
        raise ValueError(f"jitter must be in [0, 1], got {jitter}")
    rng = random.Random(seed)
    i = 0
    while True:
        wait = min(cap_s, base_s * (2 ** i))
        if jitter:
            wait *= 1.0 - jitter * rng.random()
        yield wait
        # Past the cap the exponent no longer matters; freezing it keeps
        # the generator unbounded without growing the integer.
        if base_s * (2 ** i) < cap_s:
            i += 1


def backoff_schedule(n: int, base_s: float = 2.0, cap_s: float = 60.0,
                     *, jitter: float = 0.0,
                     seed: int | None = None) -> list[float]:
    """The first ``n`` waits of :func:`backoff` as a list."""
    gen = backoff(base_s, cap_s, jitter=jitter, seed=seed)
    return [next(gen) for _ in range(max(0, n))]


@dataclasses.dataclass
class ProbeResult:
    ok: bool
    why: str  # last failure note ("" on success)
    attempts: int
    waited_s: float  # total backoff slept

    @property
    def degraded(self) -> bool:
        """The one boolean a recorder puts in its JSON line."""
        return not self.ok


def probe_devices(timeout_s: float, attempts: int = 1,
                  backoff_s: float = 2.0, cap_s: float = 60.0,
                  probe=probe_once, sleep=time.sleep, *,
                  jitter: float = 0.0,
                  seed: int | None = None) -> ProbeResult:
    """Probe device discovery up to ``attempts`` times, with the bounded
    (optionally seeded-jittered) backoff of :func:`backoff` between
    failures. ``probe`` and ``sleep`` are injectable for tests. Never
    raises: running out of attempts is an outcome, not an error."""
    attempts = max(1, int(attempts))
    waits = backoff_schedule(attempts - 1, backoff_s, cap_s,
                             jitter=jitter, seed=seed)
    why = ""
    waited = 0.0
    for a in range(attempts):
        ok, why = probe(timeout_s)
        if ok:
            return ProbeResult(True, "", a + 1, waited)
        if a < len(waits):
            sleep(waits[a])
            waited += waits[a]
    return ProbeResult(False, why, attempts, waited)
