"""Life command-line entry point.

Contract (reference ``3-life/life_mpi.c:38-72``, kept by the JAX package's
``apps/life.py``): positional ``.cfg``, VTK snapshots under ``--outdir`` at
the cfg's save cadence, and ONE line on stdout - elapsed wall seconds of
the timed step loop - so the reference's ``times.txt`` harness reads the
port's runs unchanged. The timer brackets the whole run (saves included)
after a warm-up run that builds the kernels.

    python -m mpi_and_open_mp_tpu_torch.apps.life configs/gun_big_500x500.cfg --layout serial
"""

from __future__ import annotations

import argparse
import sys
import time

from mpi_and_open_mp_tpu_torch.models.life import IMPLS, LifeSim
from mpi_and_open_mp_tpu_torch.utils.config import load_config
from mpi_and_open_mp_tpu_torch.utils.timing import append_times_txt


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_and_open_mp_tpu_torch.apps.life",
        description="Game of Life on a periodic torus (PyTorch/CUDA port)",
    )
    p.add_argument("cfg", help="board config file (steps/save_steps/nx ny/cells)")
    p.add_argument("--layout", choices=("serial",), default="serial",
                   help="only the serial layout is ported")
    p.add_argument("--impl", choices=IMPLS, default="auto",
                   help="native = the hand-written kernels (the JAX "
                        "package's pallas); auto = native on the card")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--outdir", default=None,
                   help="write VTK snapshots here (default: no saves)")
    p.add_argument("--times-file", default=None,
                   help="append elapsed seconds to this file (times.txt contract)")
    p.add_argument("--print-final-population", action="store_true")
    p.add_argument("--debug-check", action="store_true",
                   help="assert one step matches the oracle before and "
                        "after the run")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.cfg)
    sim = LifeSim(cfg, layout=args.layout, impl=args.impl,
                  device=args.device, outdir=args.outdir)
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
