"""Wall-clock timing with the reference's measurement contract.

The reference brackets its hot loop with ``MPI_Wtime`` and prints bare
elapsed seconds (``3-life/life_mpi.c:50,64-67``). Here the bracket is
``time.perf_counter`` around device work that has finished: CUDA launches
return before the card is done, so a timed section ends in :func:`sync`.
"""

from __future__ import annotations

import torch


def sync(t: torch.Tensor) -> None:
    """Wait until all queued work on ``t``'s device has finished."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def append_times_txt(path: str, seconds: float) -> None:
    """Append one wall-clock entry, matching the ``gtime -o times.txt -a``
    accumulation of the reference launchers (``3-life/run_life.sh:5``)."""
    with open(path, "a") as fd:
        fd.write(f"{seconds:.3f}\n")
