"""Shared CLI plumbing: device selection, virtual shards, the bootstrap of
a run across processes and the primary process.

Counterpart of ``mpi_and_open_mp_tpu/apps/_common.py``. The reference's
process bootstrap is ``MPI_Init`` under ``mpirun``
(``0-intro/hello_world.c:8``); the JAX package splits it into
``--virtual-devices N`` (N simulated CPU devices) and ``--distributed``
(a multi-host bootstrap). In the port:

* ``--device {cuda,cpu}`` picks the device every shard of this process
  lives on (the card unless asked for the CPU);
* ``--virtual-devices N`` asks for N virtual shards of that device
  (``parallel.mesh``) in each process, and a CLI refuses a mesh of more
  shards than every process's together with the JAX package's text
  (:func:`check_devices`);
* ``--distributed`` joins a run across processes
  (``parallel.procs.init``: ``torch.distributed``). Its address, size and
  rank come from ``--coordinator``/``--num-processes``/``--process-id``,
  or else the ``JOB_COORDINATOR``/``JOB_NUM_PROCS``/``JOB_PROC_ID``
  environment of the ``launchers/job_*.sh`` scripts (flags first, as in
  the JAX package); what neither gives, torch's ``env://`` variables
  (``MASTER_ADDR`` and ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) give, in
  the place of JAX's cluster auto-detection, and a run none of them
  describes exits 2. Every mesh the CLI then makes
  spans the processes, and the run's transport (``gloo``, ``nccl`` or
  ``gloo-staged``, decided at the bootstrap) is stamped on stderr as one
  JSON line from the primary (:func:`note_transport`). Without
  ``--distributed`` the other three flags are ignored, as in the JAX
  package.

Output discipline: one process owns stdout and file artifacts
(:func:`is_primary`), the reference's write-from-one-rank rule.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from mpi_and_open_mp_tpu_torch.parallel import procs


def add_platform_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the device every shard lives on (default: the "
                             "card)")
    parser.add_argument(
        "--virtual-devices", type=int, default=None, metavar="N",
        help="N virtual shards, all on the one device")
    add_distributed_args(parser)


def add_distributed_args(parser: argparse.ArgumentParser) -> None:
    """The JAX package's four multi-process flags."""
    parser.add_argument(
        "--distributed", action="store_true",
        help="join a run across processes (torch.distributed)")
    parser.add_argument(
        "--coordinator", metavar="HOST:PORT", default=None,
        help="the run's address for --distributed (default: "
             "$JOB_COORDINATOR, else torch's env://)")
    parser.add_argument(
        "--num-processes", type=int, default=None, metavar="N",
        help="process count for --distributed (default: $JOB_NUM_PROCS)")
    parser.add_argument(
        "--process-id", type=int, default=None, metavar="I",
        help="this process's rank for --distributed (default: $JOB_PROC_ID)")


def apply_platform_args(parser: argparse.ArgumentParser, args) -> None:
    """Join the run across processes that ``--distributed`` asks for; a
    run it cannot describe (no address, size or rank anywhere, or a rank
    outside the size) exits 2 with the reason."""
    if not args.distributed:
        return
    env = os.environ.get
    coord = args.coordinator or env("JOB_COORDINATOR")
    nprocs = (args.num_processes if args.num_processes is not None
              else int(env("JOB_NUM_PROCS", 0)) or None)
    proc_id = (args.process_id if args.process_id is not None
               else (int(env("JOB_PROC_ID"))
                     if env("JOB_PROC_ID") is not None else None))
    missing = [flag for flag, given, torch_env in (
        ("--coordinator", coord, env("MASTER_ADDR") and env("MASTER_PORT")),
        ("--num-processes", nprocs, env("WORLD_SIZE")),
        ("--process-id", proc_id, env("RANK"))) if given is None
        and not torch_env]
    if missing:
        parser.error(
            f"--distributed needs {', '.join(missing)} (or $JOB_COORDINATOR, "
            "$JOB_NUM_PROCS, $JOB_PROC_ID, or torch's env:// variables "
            "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    size = nprocs if nprocs is not None else int(env("WORLD_SIZE"))
    rank = proc_id if proc_id is not None else int(env("RANK"))
    if size < 1 or not 0 <= rank < size:
        parser.error(f"--distributed: process {rank} outside a run of "
                     f"{size} processes")
    procs.init(coord, size, rank, device=args.device)
    note_transport()


def note_transport() -> None:
    """The run's transport as one JSON line on stderr, from the primary."""
    world = procs.world()
    if world is not None and is_primary():
        print(json.dumps(world.as_json()), file=sys.stderr, flush=True)


def finish(rc: int) -> int:
    """``rc``, after leaving the run across processes (if any): a rank
    that failed leaves the others waiting at the barrier until the run's
    timeout, so a failure in any rank fails the run."""
    if procs.world() is not None and rc == 0:
        procs.shutdown()
    return rc


def check_devices(args, mesh_shape: tuple[int, ...]) -> None:
    """Refuse a mesh of more shards than ``--virtual-devices N`` gives
    every process together, with the JAX package's text (its mesh of N
    simulated devices a process raises so)."""
    world = procs.world()
    n = args.virtual_devices and args.virtual_devices * (
        world.procs if world is not None else 1)
    if n and int(np.prod(mesh_shape)) > n:
        raise ValueError(f"Number of devices {n} must be >= the product of "
                         f"mesh_shape {mesh_shape}")


def virtual_shards(args) -> int | None:
    """The shard count a CLI takes when ``--devices`` names none:
    ``--virtual-devices N`` in every process, else None (the mesh's
    default)."""
    if not args.virtual_devices:
        return None
    world = procs.world()
    return args.virtual_devices * (world.procs if world is not None else 1)


def is_primary() -> bool:
    """True in the process that owns stdout and artifact writes: always,
    unless ``torch.distributed`` is initialised with a rank other than 0."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)
