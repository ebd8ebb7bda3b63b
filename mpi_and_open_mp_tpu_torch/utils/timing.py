"""Wall-clock timing with the reference's measurement contract.

Counterpart of ``mpi_and_open_mp_tpu/utils/timing.py``. The reference
brackets its hot loop with ``MPI_Wtime`` and prints bare elapsed seconds
(``3-life/life_mpi.c:50,64-67``). Here the bracket is ``time.perf_counter``
around device work that has finished: CUDA launches return before the card
is done, so a timed section ends in :func:`sync` (the JAX package's
``anchor_sync``).
"""

from __future__ import annotations

import os
import time

import torch


def sync(t: torch.Tensor) -> None:
    """Wait until all queued work on ``t``'s device has finished."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Timer:
    """Context manager measuring wall seconds.

    ``.elapsed`` reads the running total inside the ``with`` block (a live
    ``perf_counter`` difference) and freezes at exit, as the JAX package's
    ``Timer``. It does not wait for the card: end the block with
    :func:`sync` where device work is timed.
    """

    def __enter__(self) -> "Timer":
        self.start = time.perf_counter()
        self._stopped: float | None = None
        return self

    @property
    def elapsed(self) -> float:
        if self._stopped is None:
            return time.perf_counter() - self.start
        return self._stopped

    def __exit__(self, *exc) -> None:
        self._stopped = time.perf_counter() - self.start


def append_times_txt(path: str, seconds: float) -> None:
    """Append one wall-clock entry, matching the ``gtime -o times.txt -a``
    accumulation of the reference launchers (``3-life/run_life.sh:5``)."""
    with open(path, "a") as fd:
        fd.write(f"{seconds:.3f}\n")


def write_csv_rows(path: str, rows: list[str]) -> None:
    """(Re)write a CSV artifact whole, creating its directory: a sweep
    calls this after every recorded point, so a crash mid-sweep keeps the
    rows already measured."""
    outdir = os.path.dirname(path)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as fd:
        fd.write("\n".join(rows) + "\n")
