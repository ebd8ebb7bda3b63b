"""Shared CLI plumbing: device selection, virtual shards and the primary
process.

Counterpart of ``mpi_and_open_mp_tpu/apps/_common.py``. The reference's
process bootstrap is ``MPI_Init`` under ``mpirun``
(``0-intro/hello_world.c:8``); the JAX package splits it into
``--virtual-devices N`` (N simulated CPU devices) and ``--distributed``
(a multi-host bootstrap). In the port:

* ``--device {cuda,cpu}`` picks the one device every shard lives on (the
  card unless asked for the CPU);
* ``--virtual-devices N`` asks for N virtual shards of that device
  (``parallel.mesh``), and a CLI refuses a mesh of more shards with the
  JAX package's text (:func:`check_devices`);
* ``--distributed``, ``--coordinator``, ``--num-processes`` and
  ``--process-id`` parse as in the JAX package but are refused (exit 2):
  meshes across processes are not ported (ROADMAP Queue 1, entry 7: the
  last part of item 3).

Output discipline: one process owns stdout and file artifacts
(:func:`is_primary`), the reference's write-from-one-rank rule.
"""

from __future__ import annotations

import argparse

import numpy as np

DISTRIBUTED_FLAGS = ("distributed", "coordinator", "num_processes",
                     "process_id")


def add_platform_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="the device every shard lives on (default: the "
                             "card)")
    parser.add_argument(
        "--virtual-devices", type=int, default=None, metavar="N",
        help="N virtual shards, all on the one device")
    parser.add_argument("--distributed", action="store_true",
                        help="not ported: refused")
    parser.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                        help="not ported: refused")
    parser.add_argument("--num-processes", type=int, default=None,
                        metavar="N", help="not ported: refused")
    parser.add_argument("--process-id", type=int, default=None, metavar="I",
                        help="not ported: refused")


def apply_platform_args(parser: argparse.ArgumentParser, args) -> None:
    """Refuse the JAX package's multi-process flags (exit 2)."""
    given = [f"--{name.replace('_', '-')}" for name in DISTRIBUTED_FLAGS
             if getattr(args, name) is not None
             and getattr(args, name) is not False]
    if given:
        parser.error(
            f"{', '.join(given)}: meshes across processes are not ported "
            "(ROADMAP Queue 1, entry 7: the last part of item 3); the port "
            "runs virtual shards of one device (--virtual-devices N)")


def check_devices(args, mesh_shape: tuple[int, ...]) -> None:
    """Refuse a mesh of more shards than ``--virtual-devices N``, with the
    JAX package's text (its mesh of N simulated devices raises so)."""
    n = args.virtual_devices
    if n and int(np.prod(mesh_shape)) > n:
        raise ValueError(f"Number of devices {n} must be >= the product of "
                         f"mesh_shape {mesh_shape}")


def is_primary() -> bool:
    """True in the process that owns stdout and artifact writes: always,
    unless ``torch.distributed`` is initialised with a rank other than 0."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()
                and dist.get_rank() != 0)
