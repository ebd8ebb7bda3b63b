"""Latency and bandwidth probe between the shards of a mesh: the analogue
of the reference's MPI ping-pong (``2-network-params/mpi_send_recv.c``).

Counterpart of ``mpi_and_open_mp_tpu/parallel/fabric.py``. The reference
times blocking Send/Recv round trips between two ranks for message sizes
1..10^6 bytes and prints ``size,half-RTT µs`` rows (``mpi_send_recv.c:20-39``);
the JAX package times a ``lax.ppermute`` ring shift of each device's
buffer over the accelerator fabric. Here every shard of the mesh lives on
one device (``parallel.mesh``): the buffers are one int8 stack, ``(p, n)``
on a ``"y"`` mesh (``(1, p, n)`` on ``"x"``), and a hop is
``parallel.halo.ppermute``, a roll along the shard dimension. On one card
that is a device copy and one launch, not a fabric: the probe measures the
card's copy and its launch floor (with one shard, the roll of a single
shard: the dispatch floor, as the JAX package's ``run_pingpong.sh`` says of
``--devices 1``). On a mesh across processes (``parallel.procs``) each
process holds its own shards' payloads, and a hop that crosses to the next
process goes by the run's transport (gloo, NCCL, or gloo staged through
page-locked host memory when the processes share a card): the probe then
times that transport.

The α+βn fit (the reference's ``plot.ipynb`` cells 5-6) is
:func:`fit_alpha_beta`: α the latency intercept, 1/β the asymptotic
bandwidth, the same numbers as the JAX package's on the same rows.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.parallel import halo, mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.parallel.mesh import SHARD_DIM
from mpi_and_open_mp_tpu_torch.robust import chaos
from mpi_and_open_mp_tpu_torch.utils.timing import Timer, sync, write_csv_rows

# Message sizes in bytes: 10^0 .. 10^6, matching mpi_send_recv.c:22.
DEFAULT_SIZES = tuple(10**k for k in range(7))


def _axis(mesh: mesh_lib.Mesh) -> str:
    if len(mesh.axis_names) != 1:
        raise ValueError(f"the probe wants a 1-D mesh, got {mesh.shape}")
    return mesh.axis_names[0]


def buffer(mesh: mesh_lib.Mesh, msg_bytes: int) -> torch.Tensor:
    """Zeroed int8 payloads of ``max(1, msg_bytes)`` bytes, one a shard of
    this process, stacked along the mesh axis's shard dimension on the
    mesh's device."""
    shape = [1, max(1, msg_bytes)]
    if SHARD_DIM[_axis(mesh)] == 0:
        shape[0] = mesh.local_size
    else:
        shape.insert(1, mesh.local_size)
    return torch.zeros(shape, dtype=torch.int8, device=mesh.device)


def ring_shift(buf: torch.Tensor, axis: str, reps: int) -> torch.Tensor:
    """``reps`` one-hop ring shifts of every shard's payload along mesh
    axis ``axis`` (the JAX package's ``_ring_shift_loop``)."""
    for _ in range(reps):
        buf = halo.ppermute(buf, axis, 1)
    return buf


def ping(mesh: mesh_lib.Mesh, msg_bytes: int, reps: int = 100) -> float:
    """Mean seconds per one-hop shift of a ``msg_bytes`` payload a shard:
    ``reps`` hops after a warm-up of as many, in a ``perf_counter`` bracket
    that ends when the device has finished."""
    axis = _axis(mesh)
    buf = buffer(mesh, msg_bytes)
    sync(ring_shift(buf, axis, reps))  # warm-up: first launches, allocator
    # Chaos hook (robust.chaos): a host-side delay inside the timed bracket
    # stands for a congested fabric, so consumers of these probes (the fit,
    # the CSV writers) can be tested against pathological timings. Nothing
    # when MOMP_CHAOS is unset.
    delay = chaos.dispatch_delay()
    with Timer() as t:
        if delay:
            time.sleep(delay)
        sync(ring_shift(buf, axis, reps))
    return t.elapsed / reps


def sweep(mesh: mesh_lib.Mesh | None = None,
          sizes: tuple[int, ...] = DEFAULT_SIZES,
          reps: int = 100) -> list[tuple[int, float]]:
    """Probe each message size; ``(bytes, microseconds_per_hop)`` rows, the
    reference's CSV schema (``mpi_send_recv.c:38``). The default mesh is
    one shard per card."""
    if mesh is None:
        mesh = mesh_lib.make_mesh_1d()
    return [(s, ping(mesh, s, reps) * 1e6) for s in sizes]


def write_csv(path: str, rows: list[tuple[int, float]]) -> None:
    """``size,time`` CSV, byte for byte the JAX package's (the reference's
    ``out_*.csv`` files that its ``plot.ipynb`` reads)."""
    write_csv_rows(path, ["size,time"] + [f"{s},{us:.6f}" for s, us in rows])


class Fit(NamedTuple):
    """α+βn fit with its quality: a consumer must tell a measured bandwidth
    from fit noise (a β ≤ 0 slope must not read as infinite bandwidth)."""

    alpha_us: float
    bandwidth_mb_s: float  # math.inf when unidentifiable: check the flag
    r2: float  # of the unconstrained linear fit
    identifiable: bool  # False when β ≤ 0 (a noise-dominated probe)

    def render(self) -> str:
        """The one rendering every consumer (CLI stderr, fit files) uses."""
        bw = (f"{self.bandwidth_mb_s:.1f}MB/s" if self.identifiable
              else "unidentifiable(beta<=0)")
        return f"alpha={self.alpha_us:.3f}us bandwidth={bw} r2={self.r2:.3f}"

    def as_json(self) -> dict:
        """JSON-ready view: an unidentifiable fit gives ``None`` bandwidth
        and ``0.0`` beta, never the ``inf`` sentinel (``json.dumps`` would
        write a bare ``Infinity``, which strict parsers reject)."""
        # bandwidth is 1/β with β in µs/byte (bytes/µs ≡ MB/s numerically).
        beta = (1.0 / self.bandwidth_mb_s) if self.identifiable else 0.0
        return {
            "alpha_us": round(float(self.alpha_us), 6),
            "beta_us_per_byte": round(float(beta), 12),
            "bandwidth_mb_s": (round(float(self.bandwidth_mb_s), 3)
                               if self.identifiable else None),
            "r2": round(float(self.r2), 6),
            "identifiable": bool(self.identifiable),
        }


def fit_alpha_beta(rows: list[tuple[int, float]]) -> Fit:
    """Linear model t = α + β·n over the probe rows (times in µs), as the
    reference's ``plot.ipynb`` cell 5 ``np.polyfit(buffer_size, time, 1)``,
    with R² and an ``identifiable`` flag. A β ≤ 0 fit is refitted with
    β = 0: α is then the mean latency, the bandwidth ``inf`` and
    ``identifiable`` False."""
    sizes = np.array([r[0] for r in rows], dtype=np.float64)
    times = np.array([r[1] for r in rows], dtype=np.float64)
    beta, alpha = np.polyfit(sizes, times, 1)
    ss_tot = float(((times - times.mean()) ** 2).sum())
    ss_res = float(((times - (alpha + beta * sizes)) ** 2).sum())
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    if beta <= 0:
        # Constrained refit with β = 0: the best constant model.
        return Fit(float(times.mean()), float("inf"), r2, False)
    return Fit(float(alpha), float(1.0 / beta), r2, True)
