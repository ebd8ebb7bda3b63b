"""Bootstrap and ring-messaging demo.

Counterpart of the JAX package's ``apps/hello.py``. Reference:
``0-intro/hello_world.c`` (init, print size and rank) and
``0-intro/send.c`` (each rank sends a greeting to ``(r + 1) % size`` and
receives from ``(r - 1 + size) % size``). Here: the process and its shards
(``process 0 of 1``, the device's name for each shard), then one ring hop
of each shard's token ``arange(n)`` over the mesh (``parallel.halo.
ppermute``) and a line for what each shard received, then ``ring ok``
(exit 0) or ``ring BROKEN`` (exit 1).

    python -m mpi_and_open_mp_tpu_torch.apps.hello --devices 8
    python -m mpi_and_open_mp_tpu_torch.apps.hello --devices 8 --device cpu

With more shards than cards the shards are virtual shards of the one
device (``parallel/mesh.py``). With ``--distributed`` the ring spans the
processes (``parallel.procs``): each prints its own header and its own
shards' lines, and checks the whole ring, gathered::

    python -m mpi_and_open_mp_tpu_torch.apps.hello --device cpu --distributed --coordinator localhost:29500 --num-processes 2 --process-id 0
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.apps._common import (
    add_platform_args, apply_platform_args, check_devices, finish,
    virtual_shards)
from mpi_and_open_mp_tpu_torch.parallel import halo, mesh as mesh_lib, procs
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mpi_and_open_mp_tpu_torch.apps.hello")
    p.add_argument("--devices", type=int, default=None,
                   help="N shards (default: one per device, or per process "
                        "across processes)")
    add_platform_args(p)
    args = p.parse_args(argv)
    apply_platform_args(p, args)

    dev = resolve_device(args.device)
    n = (args.devices or virtual_shards(args)
         or mesh_lib.default_shards(dev))
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    world = procs.world()
    rank, size = (world.rank, world.procs) if world else (0, 1)
    print(f"process {rank} of {size}; {n} device(s): {[kind] * n}")

    check_devices(args, (n,))
    mesh = mesh_lib.make_mesh_1d(n, device=dev,
                                 virtual=bool(args.virtual_devices))
    axis = mesh.axis_names[0]
    first = mesh.first_shard
    tokens = torch.arange(first, first + mesh.local_size, dtype=torch.int32,
                          device=mesh.device)
    received = halo.ppermute(tokens, axis, 1)
    for i, src in enumerate(received.cpu().numpy()):
        print(f"device {first + i} received hello from device {int(src)}")
    # Every process checks the whole ring (send.c: each rank's token
    # reaches (r + 1) % size).
    ring = procs.all_gather(received).cpu().numpy()
    ok = np.array_equal(ring, np.roll(np.arange(n), 1))
    print("ring ok" if ok else "ring BROKEN")
    return finish(0 if ok else 1)


if __name__ == "__main__":
    sys.exit(main())
