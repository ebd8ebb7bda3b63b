"""Shard meshes: the port's counterpart of the JAX package's device mesh.

Counterpart of ``mpi_and_open_mp_tpu/parallel/mesh.py``. The JAX package
runs one program over a ``jax.sharding.Mesh`` of devices (1-D over axis
``"y"`` or ``"x"``, or 2-D ``("y", "x")``), and its tests put every
sharded layout on 8 virtual CPU devices of one host. The port's
:class:`Mesh` names the same axes and sizes, and every shard of it lives
on ONE ``torch.device``: the virtual shards of the CPU in the tests, and
virtual shards of one card on a GPU. A mesh of one process that would span
several CUDA devices raises.

A mesh made while ``torch.distributed`` runs more than one process
(``parallel.procs.init``, the CLIs' ``--distributed``) spans the
processes, as the JAX package's mesh spans the devices of every process
of a ``jax.distributed`` run: its first axis (``y`` of a 2-D mesh or of a
row mesh, ``x`` of a column mesh, ``sp``) is cut into ``procs`` contiguous
runs, and process ``rank`` holds shards ``[first_shard, first_shard +
local_sizes[0])`` of it, every other axis whole. :func:`local_part` cuts a
full stack to this process's shards, :func:`gather` puts the full stack
back together (a collective). The mesh registers its axes with
``parallel.procs`` when it is made, so the exchanges of
``parallel.halo`` know which axis crosses the processes.

A sharded board is one stacked tensor ``(py, px, *C, hs, ws)``
(:func:`shard`): shard ``(i, j)`` holds rows ``[i*hs, (i+1)*hs)`` and
columns ``[j*ws, (j+1)*ws)`` of the global board, channel axes (if any)
after the two shard axes. The ring ``ppermute`` of the JAX package's halo
exchange is then one ``torch.roll`` along a shard axis
(``parallel.halo.ppermute``), and one kernel launch over the stack
advances every shard at once, as one ``shard_map`` program does.

Axis naming follows the JAX package: ``"y"`` shards the row dimension
(axis 0 of the ``(ny, nx)`` board), ``"x"`` the column dimension, and
``"sp"`` (``parallel/context.py``'s ``AXIS_SP``) the sequence of attention
operands, stacked as ``(p, heads, seq/p, head_dim)`` with the shard
dimension first.
"""

from __future__ import annotations

import dataclasses

import torch

from mpi_and_open_mp_tpu_torch.parallel import procs as procs_lib
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

AXIS_Y = "y"
AXIS_X = "x"
AXIS_SP = "sp"
# The stacked tensor's dimension that carries each mesh axis.
SHARD_DIM = {AXIS_Y: 0, AXIS_X: 1, AXIS_SP: 0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes, every shard of this process on
    ``device``; ``procs`` processes hold contiguous runs of the first axis
    (module docstring), this one run ``rank``."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device
    procs: int = 1
    rank: int = 0

    @property
    def local_sizes(self) -> tuple[int, ...]:
        """The axis sizes of this process's shards."""
        return (self.axis_sizes[0] // self.procs, *self.axis_sizes[1:])

    @property
    def first_shard(self) -> int:
        """This process's first shard on the first axis."""
        return self.rank * self.local_sizes[0]

    @property
    def local_size(self) -> int:
        n = 1
        for s in self.local_sizes:
            n *= s
        return n

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def dims_create(n: int, ndims: int = 2) -> tuple[int, ...]:
    """Balanced factorisation of ``n`` over ``ndims`` mesh axes.

    Same contract as ``MPI_Dims_create`` (used by the reference at
    ``6-cartesian/life_cart.c:118``): dimensions as close to each other as
    possible, in non-increasing order. Deterministic greedy algorithm:
    repeatedly peel the largest factor <= the remaining ``ndims``-th root.
    """
    if n < 1 or ndims < 1:
        raise ValueError(f"dims_create({n}, {ndims})")
    dims = []
    remaining = n
    for d in range(ndims, 0, -1):
        if d == 1:
            dims.append(remaining)
            break
        # Largest divisor of `remaining` that is <= remaining ** (1/d),
        # searched downward from the integer root.
        target = round(remaining ** (1.0 / d))
        best = 1
        for cand in range(target, 0, -1):
            if remaining % cand == 0:
                best = cand
                break
        # Try upward too: pick whichever divisor is closest to the root.
        for cand in range(target + 1, remaining + 1):
            if remaining % cand == 0:
                if abs(cand - remaining ** (1.0 / d)) < abs(best - remaining ** (1.0 / d)):
                    best = cand
                break
        dims.append(best)
        remaining //= best
    return tuple(sorted(dims, reverse=True))


def decomposition(n: int, p: int, k: int) -> tuple[int, int]:
    """Reference shard map: rank ``k`` of ``p`` owns ``[start, stop)`` of ``n``.

    Floor-chunking with the LAST shard absorbing the remainder - the exact
    semantics of the reference's ``decomposition()``
    (``3-life/life_mpi.c:178-183``, identical in ``4-life``/``5-gather``/
    ``6-cartesian``). Used for host-side partitioning bookkeeping and for
    documenting parity; the stacked shards are even blocks, with the
    global roll step handling any residue.
    """
    chunk = n // p
    start = k * chunk
    stop = n if k == p - 1 else (k + 1) * chunk
    return start, stop


def device_count(device: str | torch.device = "cuda") -> int:
    """Devices of ``device``'s type: the CUDA device count, or 1 for the
    CPU (which holds any number of virtual shards)."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def default_shards(device: str | torch.device = "cuda") -> int:
    """A mesh's shards when the caller names none: one a process in a run
    across processes (each holds one device), else :func:`device_count`."""
    world = procs_lib.spanning()
    return world.procs if world is not None else device_count(device)


def _make(names: tuple[str, ...], sizes: tuple[int, ...],
          device: str | torch.device, virtual: bool) -> Mesh:
    dev = resolve_device(device)
    n = 1
    for s in sizes:
        if s < 1:
            raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
        n *= s
    world = procs_lib.spanning()
    if world is not None:
        if dev.type != world.device.type:
            raise ValueError(f"a mesh on {dev} in a run whose processes "
                             f"hold their shards on {world.device}")
        if sizes[0] % world.procs:
            raise ValueError(
                f"mesh axis {names[0]!r} of {sizes[0]} shards does not "
                f"split over {world.procs} processes")
        procs_lib.register_axes(names)
        return Mesh(names, sizes, world.device, world.procs, world.rank)
    count = device_count(dev)
    if not virtual and 1 < n <= count:
        raise NotImplementedError(
            f"a {n}-shard mesh over {count} CUDA devices would span several "
            "cards in one process; the port runs one process's meshes as "
            "virtual shards of one device (ask for more shards than "
            "devices, or virtual=True), and a mesh across cards as one "
            "process a card (--distributed, parallel.procs; ROADMAP Queue 1 "
            "item 3)")
    return Mesh(names, sizes, dev)


def make_mesh_1d(n: int | None = None, axis: str = AXIS_Y,
                 device: str | torch.device = "cuda",
                 virtual: bool = False) -> Mesh:
    """1-D mesh of ``n`` shards on axis ``axis`` (default:
    :func:`default_shards`, as the JAX package defaults to all devices). More
    shards than devices, or ``virtual=True`` (the CLI's
    ``--virtual-devices``), put every shard on the one device."""
    if axis not in SHARD_DIM:
        raise ValueError(f"axis must be one of {tuple(SHARD_DIM)}, got "
                         f"{axis!r}")
    if n is None:
        n = default_shards(device)
    return _make((axis,), (int(n),), device, virtual)


def make_mesh_2d(py: int | None = None, px: int | None = None,
                 device: str | torch.device = "cuda",
                 virtual: bool = False) -> Mesh:
    """2-D ``("y", "x")`` mesh. With no sizes, factorises
    :func:`default_shards` like ``MPI_Dims_create``
    (``6-cartesian/life_cart.c:117-118``)."""
    if py is None and px is None:
        py, px = dims_create(default_shards(device), 2)
    elif py is None or px is None:
        raise ValueError("pass both py and px, or neither")
    return _make((AXIS_Y, AXIS_X), (int(py), int(px)), device, virtual)


def shard(board: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """``(*C, ny, nx)`` -> the stacked ``(py, px, *C, ny/py, nx/px)``
    shards (a contiguous copy). Both extents must divide."""
    *lead, ny, nx = board.shape
    if ny % py or nx % px:
        raise ValueError(f"board {tuple(board.shape)} does not divide into "
                         f"{py} x {px} shards")
    c = len(lead)
    t = board.reshape(*lead, py, ny // py, px, nx // px)
    order = (c, c + 2, *range(c), c + 1, c + 3)
    return t.permute(order).contiguous()


def unshard(stack: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`shard`: ``(py, px, *C, hs, ws)`` -> ``(*C,
    py*hs, px*ws)``."""
    py, px, *lead, hs, ws = stack.shape
    c = len(lead)
    order = (*range(2, 2 + c), 0, 2 + c, 1, 3 + c)
    return stack.permute(order).reshape(*lead, py * hs, px * ws)


def _span_dim(mesh: Mesh) -> int:
    return SHARD_DIM[mesh.axis_names[0]]


def local_part(stack: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The shards of ``stack`` (the full stack of ``mesh``: :func:`shard`'s
    for y and x, ``(p, ...)`` for sp) that this process holds: itself on a
    mesh of one process."""
    if mesh.procs == 1:
        return stack
    dim = _span_dim(mesh)
    if stack.shape[dim] != mesh.axis_sizes[0]:
        raise ValueError(
            f"a stack of {stack.shape[dim]} shards on axis "
            f"{mesh.axis_names[0]!r}, whose mesh has {mesh.axis_sizes[0]}; "
            "a run across processes shards the mesh's first axis")
    return stack.narrow(dim, mesh.first_shard,
                        mesh.local_sizes[0]).contiguous()


def gather(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Inverse of :func:`local_part`: the full stack, from every process's
    shards (a collective: every process calls it); ``local`` itself on a
    mesh of one process."""
    if mesh.procs == 1:
        return local
    return procs_lib.all_gather(local, _span_dim(mesh))
