"""Life command-line entry point.

Contract (reference ``3-life/life_mpi.c:38-72``, kept by the JAX package's
``apps/life.py``): positional ``.cfg``, VTK snapshots under ``--outdir`` at
the cfg's save cadence, and ONE line on stdout - elapsed wall seconds of
the timed step loop - so the reference's ``times.txt`` harness reads the
port's runs unchanged. The timer brackets the whole run (saves included)
after a warm-up run that builds the kernels.

    python -m mpi_and_open_mp_tpu_torch.apps.life configs/gun_big_500x500.cfg --layout serial
    python -m mpi_and_open_mp_tpu_torch.apps.life configs/gun_big_500x500.cfg --layout serial --batch 64
    python -m mpi_and_open_mp_tpu_torch.apps.life configs/gun_big_500x500.cfg --layout cart --mesh 4,2 --virtual-devices 8

The sharded layouts run on a mesh of shards that all live on one device
(``parallel.mesh``): ``--virtual-devices N`` asks for N of them (the JAX
package's "simulate N devices"), ``--mesh PY,PX`` for a 2-D mesh,
``--devices N`` for N shards on a 1-D mesh. Without these the mesh has one
shard per device of ``--device``'s type: one on one card or on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from mpi_and_open_mp_tpu_torch.models.life import IMPLS, LAYOUTS, LifeSim
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.utils.config import load_config
from mpi_and_open_mp_tpu_torch.utils.timing import append_times_txt


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_and_open_mp_tpu_torch.apps.life",
        description="Game of Life on a periodic torus (PyTorch/CUDA port)",
    )
    p.add_argument("cfg", help="board config file (steps/save_steps/nx ny/cells)")
    p.add_argument("--layout", choices=LAYOUTS, default="row")
    p.add_argument("--impl", choices=IMPLS, default="auto",
                   help="native = the hand-written kernels (the JAX "
                        "package's pallas); auto = native (serial) or "
                        "bitfused (sharded) on the card")
    p.add_argument("--fuse-steps", type=int, default=1, metavar="K",
                   help="halo depth: exchange once per K local steps")
    p.add_argument("--mesh", metavar="PY,PX",
                   help="explicit 2-D mesh shape (cart layout)")
    p.add_argument("--devices", type=int, metavar="N",
                   help="N shards (1-D layouts; cart factorises N)")
    p.add_argument("--virtual-devices", type=int, default=None, metavar="N",
                   help="N virtual shards, all on the one device")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--batch", type=int, default=0, metavar="B",
                   help="throughput mode: advance B stacked copies of the "
                        "cfg board together (batched LifeSim; excludes "
                        "--outdir). The elapsed line then covers B boards' "
                        "worth of updates, and the final population is the "
                        "sum over the stack")
    p.add_argument("--outdir", default=None,
                   help="write VTK snapshots here (default: no saves)")
    p.add_argument("--times-file", default=None,
                   help="append elapsed seconds to this file (times.txt contract)")
    p.add_argument("--print-final-population", action="store_true")
    p.add_argument("--debug-check", action="store_true",
                   help="assert one step matches the oracle before and "
                        "after the run")
    return p


def _check_devices(args, mesh_shape: tuple[int, ...]) -> None:
    """Refuse a mesh of more shards than ``--virtual-devices N``, with the
    JAX package's text (its mesh of N simulated devices raises so)."""
    n = args.virtual_devices
    if n and int(np.prod(mesh_shape)) > n:
        raise ValueError(f"Number of devices {n} must be >= the product of "
                         f"mesh_shape {mesh_shape}")


def make_mesh(args):
    """The mesh the flags ask for, or None for LifeSim's default (one
    shard per device)."""
    if args.layout == "serial":
        return None
    virtual = bool(args.virtual_devices)
    kw = dict(device=args.device, virtual=virtual)
    if args.mesh:
        py, px = (int(v) for v in args.mesh.split(","))
        _check_devices(args, (py, px))
        return mesh_lib.make_mesh_2d(py, px, **kw)
    n = args.devices or args.virtual_devices
    if not n:
        return None
    if args.layout == "cart":
        shape = mesh_lib.dims_create(n, 2)
        _check_devices(args, shape)
        return mesh_lib.make_mesh_2d(*shape, **kw)
    _check_devices(args, (n,))
    axis = "x" if args.layout == "col" else "y"
    return mesh_lib.make_mesh_1d(n, axis=axis, **kw)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.batch < 0:
        parser.error("--batch must be >= 1")
    if args.batch and args.layout != "serial":
        parser.error("--batch needs --layout serial "
                     "(a batch is one single-program dispatch)")
    if args.batch and args.outdir:
        parser.error("--batch is a throughput mode: drop --outdir")
    cfg = load_config(args.cfg)
    # B stacked copies of the cfg board: the work does not depend on the
    # boards' content, so copies time what B distinct requests would.
    stack = np.stack([cfg.board()] * args.batch) if args.batch else None
    sim = LifeSim(cfg, layout=args.layout, impl=args.impl,
                  mesh=make_mesh(args), fuse_steps=args.fuse_steps,
                  device=args.device, outdir=args.outdir, initial_board=stack)
    sim.warmup()
    if args.debug_check:
        sim.debug_check()
    t0 = time.perf_counter()
    final = sim.run()  # collect() at the end waits for the device
    elapsed = time.perf_counter() - t0
    if args.debug_check:
        sim.debug_check()
    print(f"{elapsed:.6f}")
    if args.times_file:
        append_times_txt(args.times_file, elapsed)
    if args.print_final_population:
        print(int(final.sum()), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
