"""Quadrature command-line entry point.

Contract (reference ``1-integral/integral.c:9-60``, kept by the JAX
package's ``apps/integral.py``): positional N, elapsed seconds on stdout.
The value is printed only with ``--print-value`` (``repr`` to stderr; the
reference comments its printf out, ``integral.c:27,44``). N is a Python
int: the reference's 32-bit ``atoi`` truncation (``integral.c:12``) is not
reproduced unless ``--truncate-32bit`` asks for it (N mod 2^32).

    python -m mpi_and_open_mp_tpu_torch.apps.integral 1000000000000 --devices 8 --print-value
    python -m mpi_and_open_mp_tpu_torch.apps.integral 100000 --devices 8 --device cpu

``--devices N`` cuts the trapezoids over N virtual shards of the device.
One warm-up ``compute()`` (it builds the kernel) precedes the timed one.
With ``--distributed`` the shards span the processes: each computes its
own shards' partials, all of them are gathered and summed in shard order
(the one-process value to the bit), and the primary prints.
"""

from __future__ import annotations

import argparse
import sys

from mpi_and_open_mp_tpu_torch.apps._common import (
    add_platform_args, apply_platform_args, check_devices, finish,
    is_primary, virtual_shards)
from mpi_and_open_mp_tpu_torch.models.integral import Integral
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.utils.timing import Timer, append_times_txt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mpi_and_open_mp_tpu_torch.apps.integral")
    p.add_argument("n", type=int, help="number of trapezoids")
    p.add_argument("--devices", type=int, default=None,
                   help="N virtual shards of the device")
    p.add_argument("--print-value", action="store_true")
    p.add_argument("--truncate-32bit", action="store_true",
                   help="reproduce the reference's unsigned-32-bit N overflow")
    p.add_argument("--times-file", default=None)
    add_platform_args(p)
    args = p.parse_args(argv)
    apply_platform_args(p, args)

    n = args.n
    if args.truncate_32bit:
        n = n % (1 << 32)
    shards = args.devices or virtual_shards(args)
    mesh = None
    if shards:
        check_devices(args, (shards,))
        mesh = mesh_lib.make_mesh_1d(shards, device=args.device,
                                     virtual=bool(args.virtual_devices))
    integral = Integral(n, mesh=mesh, device=args.device)
    integral.compute()  # warm-up: builds the kernel outside the timed region

    with Timer() as t:
        value = integral.compute()  # returns once the value is on the host
    elapsed = t.elapsed

    if is_primary():  # print-from-one-rank (1-integral/integral.c:45-46)
        print(f"{elapsed:.6f}")
        if args.times_file:
            append_times_txt(args.times_file, elapsed)
        if args.print_value:
            print(f"{value!r}", file=sys.stderr)
    return finish(0)


if __name__ == "__main__":
    sys.exit(main())
