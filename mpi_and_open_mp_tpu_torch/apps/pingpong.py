"""Shard-to-shard probe command-line entry point.

Contract (reference ``2-network-params/mpi_send_recv.c:36-39``, kept by
the JAX package's ``apps/pingpong.py``): a ``size,time`` header and one
CSV row per message size on stdout (µs per hop), which the reference's
``plot.ipynb`` α+βn analysis reads. ``--fit`` also prints the fitted
latency α (µs) and bandwidth 1/β (MB/s) to stderr, and one
``{"metric": "pingpong_fit", ...}`` JSON line (``Fit.as_json``) as the last
stdout line.

    python -m mpi_and_open_mp_tpu_torch.apps.pingpong --devices 8 --fit
    python -m mpi_and_open_mp_tpu_torch.apps.pingpong --devices 2 --reps 2 --max-power 2 --device cpu

The shards are virtual shards of one device (``parallel/fabric.py``): on
one card a hop is a device copy and one launch, not a fabric. With
``--distributed`` the shards span the processes and a hop that crosses
them goes by the run's transport, which the fit's JSON line names
(``"transport"``)::

    python -m mpi_and_open_mp_tpu_torch.apps.pingpong --device cpu --fit --distributed --coordinator localhost:29500 --num-processes 2 --process-id 0
"""

from __future__ import annotations

import argparse
import json
import sys

from mpi_and_open_mp_tpu_torch.apps._common import (
    add_platform_args, apply_platform_args, check_devices, finish,
    is_primary, virtual_shards)
from mpi_and_open_mp_tpu_torch.parallel import procs
from mpi_and_open_mp_tpu_torch.parallel import fabric, mesh as mesh_lib


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mpi_and_open_mp_tpu_torch.apps.pingpong")
    p.add_argument("--devices", type=int, default=None,
                   help="N virtual shards of the device")
    p.add_argument("--reps", type=int, default=100)
    p.add_argument("--max-power", type=int, default=6,
                   help="probe sizes 10^0..10^k bytes (default 6)")
    p.add_argument("--out", default=None, help="also write CSV here")
    p.add_argument("--fit", action="store_true")
    add_platform_args(p)
    args = p.parse_args(argv)
    apply_platform_args(p, args)

    n = args.devices or virtual_shards(args)
    if n:
        check_devices(args, (n,))
    mesh = mesh_lib.make_mesh_1d(n, device=args.device,
                                 virtual=bool(args.virtual_devices))
    sizes = tuple(10**k for k in range(args.max_power + 1))
    rows = fabric.sweep(mesh, sizes=sizes, reps=args.reps)

    if is_primary():  # CSV from one rank (mpi_send_recv.c:36-39, rank 0)
        print("size,time")
        for s, us in rows:
            print(f"{s},{us:.6f}")
        if args.out:
            fabric.write_csv(args.out, rows)
        if args.fit:
            fit = fabric.fit_alpha_beta(rows)
            print(fit.render(), file=sys.stderr)
            # The machine-readable twin of the stderr line, as the last
            # stdout line: harnesses take the CSV rows above as they are
            # and parse this one.
            world = procs.world()
            transport = {"transport": world.transport} if world else {}
            print(json.dumps({"metric": "pingpong_fit", **fit.as_json(),
                              **transport}))
    return finish(0)


if __name__ == "__main__":
    sys.exit(main())
