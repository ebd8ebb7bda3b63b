"""The trapezoid rule for ``f_circle`` as a hand-written kernel.

:func:`trapezoid_circle` integrates the reference's √(4 − x²) over
``[a, b]`` by ``n`` trapezoids on ``shards`` shards of one device. On a
CUDA device it launches ``csrc/quadrature.cu`` (a chunk-sum pass and a
per-shard Kahan pass, two kernels, one float32 result); on the CPU it runs
the plain version, ``ops.quadrature.trapezoid_shard_sum`` with
``f_circle``. Neither falls back to the other: a build or launch failure
raises.

The kernel replaces no Pallas kernel. The JAX package runs the sum as one
jitted ``lax.fori_loop`` over chunks (``mpi_and_open_mp_tpu/ops/
quadrature.py:75-121``); see the source's note for why the port needs a
kernel and what bounds it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.ops.quadrature import (
    CHUNK, _chunk_grid, f_circle, trapezoid_shard_sum)

# The kernel's limits (csrc/quadrature.cu): one block a chunk (gridDim.x),
# each shard's partial in the Kahan pass's shared memory.
MAX_CHUNKS = 2**31 - 1
MAX_SHARDS = 4096


def _check(n: int, shards: int) -> tuple[int, int, int, int]:
    """``(n_chunks, last_chunk, last_lane, per)``; raises on what the kernel
    does not take."""
    if n < 1:
        raise ValueError(f"need at least one trapezoid, got n={n}")
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"quadrature: {shards} shards outside "
                         f"[1, {MAX_SHARDS}]")
    n_chunks, last_chunk, last_lane = _chunk_grid(n)
    if n_chunks > MAX_CHUNKS:
        raise ValueError(f"quadrature: n={n} needs {n_chunks} chunks of "
                         f"{CHUNK}, past {MAX_CHUNKS}")
    return n_chunks, last_chunk, last_lane, -(-n_chunks // shards)


def _run_chunks(n_chunks: int, per: int, first: int, count: int) -> int:
    """The chunks of shards ``[first, first + count)`` (the kernel's
    ``run_chunks``)."""
    return max(min((first + count) * per, n_chunks) - first * per, 0)


def launch(a: float, b: float, n: int, shards: int, device: torch.device,
           *, first: int = 0, count: int | None = None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One call of the kernel on the card over shards ``[first, first +
    count)`` (all of them by default): ``(value, chunk_sums, partials)``, a
    0-dim float32 (those shards' partials summed in shard order, times
    f32(h): the integral when the call takes every shard), the float32 sum
    of each of their chunks, and each shard's Kahan partial. Counts its
    launches on :func:`trapezoid_circle`."""
    if device.type != "cuda":
        raise ValueError(f"quadrature: expected a CUDA device, got {device}")
    n_chunks, last_chunk, last_lane, per = _check(n, shards)
    count = shards - first if count is None else int(count)
    if not (0 <= first and 1 <= count <= shards - first):
        raise ValueError(f"quadrature: shards [{first}, {first + count}) "
                         f"outside the {shards} shards")
    h = (b - a) / n
    sums = torch.empty(max(1, _run_chunks(n_chunks, per, first, count)),
                       dtype=torch.float32, device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    partials = torch.empty(count, dtype=torch.float32, device=device)
    launched = ctypes.c_int(0)
    lib = _build.load("quadrature")
    with torch.cuda.device(device):
        rc = lib.quadrature(
            sums.data_ptr(), out.data_ptr(), partials.data_ptr(), n_chunks,
            last_chunk, last_lane, shards, per, first, count,
            float(np.float32(a)), float(np.float32(h)),
            float(np.float32(CHUNK * h)),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    trapezoid_circle.launches += launched.value
    _build.check(lib, "quadrature", rc)
    return out, sums, partials


def trapezoid_circle(a: float, b: float, n: int, shards: int = 1,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """∫_a^b √(4 − x²) dx by ``n`` trapezoids over ``shards`` shards: a
    0-dim float32 tensor on ``device``. The kernel (two launches) on a CUDA
    device, the plain version on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        _check(n, shards)
        return trapezoid_shard_sum(f_circle, a, b, n, shards, dev)
    return launch(a, b, n, shards, dev)[0]


trapezoid_circle.launches = 0
