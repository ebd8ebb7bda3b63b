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
device (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.apps._common import (
    add_platform_args, apply_platform_args, check_devices)
from mpi_and_open_mp_tpu_torch.parallel import halo, mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device


def _process() -> tuple[int, int]:
    """(rank, world size): (0, 1) unless ``torch.distributed`` is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mpi_and_open_mp_tpu_torch.apps.hello")
    p.add_argument("--devices", type=int, default=None,
                   help="N shards (default: one per device)")
    add_platform_args(p)
    args = p.parse_args(argv)
    apply_platform_args(p, args)

    dev = resolve_device(args.device)
    n = (args.devices or args.virtual_devices
         or mesh_lib.device_count(dev))
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rank, world = _process()
    print(f"process {rank} of {world}; {n} device(s): {[kind] * n}")

    check_devices(args, (n,))
    mesh = mesh_lib.make_mesh_1d(n, device=dev,
                                 virtual=bool(args.virtual_devices))
    axis = mesh.axis_names[0]
    tokens = torch.arange(n, dtype=torch.int32, device=mesh.device)
    received = halo.ppermute(tokens, axis, 1).cpu().numpy()
    for i, src in enumerate(received):
        print(f"device {i} received hello from device {int(src)}")
    ok = np.array_equal(received, np.roll(np.arange(n), 1))
    print("ring ok" if ok else "ring BROKEN")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
