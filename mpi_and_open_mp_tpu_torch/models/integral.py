"""Trapezoidal quadrature over a mesh of virtual shards.

Counterpart of ``mpi_and_open_mp_tpu/models/integral.py``, the re-design of
the reference's ``1-integral/integral.c``: the N trapezoids cut into
contiguous blocks of chunks over a 1-D mesh, each shard's partial sum
Kahan-compensated, one float32 sum of the partials in place of the
reference's Send/Recv reduction star (``integral.c:39-43``). The
reference never prints the value (``integral.c:27,44`` comment it out);
:meth:`Integral.compute` returns it.

The mesh is the port's (``parallel/mesh.py``): every shard on one device,
or, across processes, each process's run of the shards on its device, the
partials gathered and summed in shard order.
Only its shard count matters here, so JAX's axis name ``"i"`` has no
counterpart (the port's meshes name ``"y"`` or ``"x"``). The reference's
integrand ``f_circle`` runs the hand-written kernel on the card
(``ops/native_quadrature.py``, engine ``"kernel:quadrature"``); a caller's
own torch callable ``f``, and every integrand on the CPU, runs the plain
version on the mesh's device (engine ``"plain"``).
"""

from __future__ import annotations

from typing import Callable

import torch

from mpi_and_open_mp_tpu_torch.ops import native_quadrature, quadrature
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib, procs


class Integral:
    """∫_a^b f(x) dx by N trapezoids over a mesh of shards.

    ``mesh`` defaults to one shard per device of ``device``'s type (one on
    one card, one on the CPU); a given mesh brings its own device.
    """

    def __init__(self, n: int, a: float = 0.0, b: float = 2.0,
                 f: Callable = quadrature.f_circle,
                 mesh: mesh_lib.Mesh | None = None,
                 device: str | torch.device = "cuda"):
        if n < 1:
            raise ValueError(f"need at least one trapezoid, got n={n}")
        self.n = int(n)  # a Python int: no 32-bit atoi truncation here
        self.a, self.b, self.f = float(a), float(b), f
        self.mesh = (mesh if mesh is not None
                     else mesh_lib.make_mesh_1d(device=device))
        self.device = self.mesh.device
        kernel = f is quadrature.f_circle and self.device.type == "cuda"
        self.engine = "kernel:quadrature" if kernel else "plain"

    def compute(self) -> float:
        """Run the quadrature; returns once the value is on the host. On a
        mesh across processes every process returns the same value, the
        one-process run's to the bit (a collective)."""
        p = self.mesh.size
        if self.mesh.procs > 1:
            return self._compute_across_processes(p)
        if self.engine == "kernel:quadrature":
            out = native_quadrature.launch(self.a, self.b, self.n, p,
                                           self.device)[0]
        else:
            out = quadrature.trapezoid_shard_sum(
                self.f, self.a, self.b, self.n, p, self.device)
        return float(out.item())

    def _compute_across_processes(self, p: int) -> float:
        """Each process computes its shards' Kahan partials (the kernel's
        run of shards on the card); every process gathers all of them and
        sums them in shard order in float32 (JAX's ``psum``), the
        operations the one-process run's last step does."""
        first, count = self.mesh.first_shard, self.mesh.local_size
        if self.engine == "kernel:quadrature":
            partials = native_quadrature.launch(
                self.a, self.b, self.n, p, self.device, first=first,
                count=count)[2]
        else:
            partials = quadrature.shard_partials(
                self.f, self.a, self.b, self.n, p, first, count, self.device)
        every = procs.all_gather(partials).cpu()
        return float(quadrature.sum_partials(every, (self.b - self.a)
                                             / self.n).item())
