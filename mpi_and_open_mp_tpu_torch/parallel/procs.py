"""Meshes across processes: the bootstrap, the transport rule and the
exchanges between processes.

Counterpart of the JAX package's multi-process runtime
(``jax.distributed.initialize``, ``mpi_and_open_mp_tpu/apps/_common.py:30-85``
and ``tests/_dist_worker.py``), itself the reference's ``MPI_Init`` under
``mpirun`` (``0-intro/hello_world.c:8``). :func:`init` starts
``torch.distributed`` with an explicit address, world size and rank.

The transport is decided once, in :func:`init`, by this rule, and stamped
on the :class:`World` (``transport``); nothing ever chooses it by catching
an error:

* ``"gloo"`` - shards on the CPU;
* ``"nccl"`` - shards on the card, every rank of a host with a card of its
  own (``torch.cuda.device_count() >= LOCAL_WORLD_SIZE``, which defaults to
  the world size: the ranks are taken to share one host unless the
  environment says otherwise); rank ``LOCAL_RANK`` (default: the rank) takes
  card ``LOCAL_RANK``;
* ``"gloo-staged"`` - shards on the card, ranks sharing a card (NCCL
  refuses two ranks on one GPU): every exchange copies the card's tensor
  into a page-locked host buffer, moves it by gloo and copies it back. A
  CUDA tensor is never handed to gloo.

A mesh made while a world of more than one process is up spans the
processes (``parallel.mesh``): its first axis is cut into ``procs``
contiguous runs of shards, run ``rank`` in this process. The mesh
registers its axes here when it is made (:func:`register_axes`): the first
axis spans the processes, the others stay inside each process, and
:func:`span` answers for an axis name. So the exchanges of
``parallel.halo`` (``ppermute``, ``all_to_all``), which take an axis name
and no mesh, find the process layout by the name. One axis name cannot
span the processes for one mesh and stay local for another in the same
run (:func:`register_axes` raises).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch

# Seconds a collective may wait for a peer before it raises (a rank that
# died leaves the others waiting).
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class World:
    """The processes of a run: ``procs`` of them, this one ``rank``, the
    ``transport`` decided at :func:`init`, the ``device`` the shards live
    on."""

    procs: int
    rank: int
    transport: str
    device: torch.device

    def as_json(self) -> dict:
        return {"transport": self.transport, "processes": self.procs,
                "rank": self.rank, "device": str(self.device)}


_WORLD: World | None = None
# Axis name -> whether it spans the processes, for the meshes made so far.
_AXES: dict[str, bool] = {}
# Page-locked staging buffers of the gloo-staged transport, by (bytes,
# role): reused, so a steady exchange allocates nothing.
_STAGING: dict = {}


def transport_for(device: torch.device, procs: int) -> str:
    """The transport rule (module docstring)."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", procs))
    return "nccl" if torch.cuda.device_count() >= local else "gloo-staged"


def init(coordinator: str | None, num_processes: int | None,
         process_id: int | None, device: str | torch.device = "cuda"
         ) -> World:
    """Join the run: at ``coordinator`` ``HOST:PORT`` (``tcp://``), or,
    without one, torch's ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``),
    which stands where the JAX package runs its cluster auto-detection; the
    world size and rank as given, else from ``WORLD_SIZE`` and ``RANK``.
    Raises when no CUDA device is present and ``device`` asks for one."""
    global _WORLD
    import torch.distributed as dist

    from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

    if _WORLD is not None:
        raise RuntimeError("torch.distributed is already initialised")
    dev = resolve_device(device)
    env = os.environ.get
    procs = int(num_processes if num_processes is not None
                else env("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env("RANK", 0))
    transport = transport_for(dev, procs)
    if transport == "nccl":
        local_rank = int(env("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    dist.init_process_group(
        backend="nccl" if transport == "nccl" else "gloo",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=procs, rank=rank,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    _WORLD = World(dist.get_world_size(), dist.get_rank(), transport, dev)
    return _WORLD


def world() -> World | None:
    """The run's :class:`World`, or None when :func:`init` has not run."""
    return _WORLD


def spanning() -> World | None:
    """The :class:`World` when it holds more than one process, else None."""
    return _WORLD if _WORLD is not None and _WORLD.procs > 1 else None


def shutdown() -> None:
    """Leave the run (a barrier first, so no rank leaves a peer waiting)."""
    global _WORLD
    import torch.distributed as dist

    if _WORLD is None:
        return
    barrier()
    dist.destroy_process_group()
    _WORLD = None
    _AXES.clear()
    _STAGING.clear()


def register_axes(names: tuple[str, ...]) -> None:
    """Record that a mesh over ``names`` spans the processes: its first
    axis across them, the rest inside each. Raises when an axis was
    registered the other way by an earlier mesh of this run."""
    for i, name in enumerate(names):
        spans = i == 0
        if _AXES.setdefault(name, spans) != spans:
            raise ValueError(
                f"mesh axis {name!r} {'stays inside' if spans else 'spans'} "
                "the processes for an earlier mesh of this run; a run across "
                "processes keeps one role for each axis name")


def span(axis_name: str) -> World | None:
    """The :class:`World` when ``axis_name`` spans the processes, else
    None (no world, one process, or an axis inside each process)."""
    w = spanning()
    return w if w is not None and _AXES.get(axis_name) else None


# ---------------------------------------------------------------- exchanges
#
# Every exchange moves bytes: a tensor goes on the wire as its contiguous
# bytes (so any dtype travels, bfloat16 and bool too) and comes off in its
# own shape and dtype.


def _staged(n: int, role: str) -> torch.Tensor:
    key = (n, role)
    buf = _STAGING.get(key)
    if buf is None:
        buf = _STAGING[key] = torch.empty(n, dtype=torch.uint8,
                                          pin_memory=True)
    return buf


def _to_wire(x: torch.Tensor, w: World, role: str) -> torch.Tensor:
    """``x``'s bytes as the transport moves them: a flat uint8 view for
    gloo on the CPU and for NCCL, a page-locked host copy for the staged
    transport."""
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    if w.transport != "gloo-staged":
        return raw
    buf = _staged(raw.numel(), role)
    buf.copy_(raw)
    return buf


def _empty_wire(n: int, w: World, role: str) -> torch.Tensor:
    if w.transport == "gloo-staged":
        return _staged(n, role)
    return torch.empty(n, dtype=torch.uint8, device=w.device)


def _from_wire(raw: torch.Tensor, like: torch.Tensor, w: World
               ) -> torch.Tensor:
    """The bytes ``raw`` as a tensor of ``like``'s shape and dtype on the
    shards' device (a copy off a staging buffer)."""
    if w.transport == "gloo-staged":
        raw = raw.to(w.device)
    return raw.view(like.dtype).reshape(like.shape)


def exchange(send: torch.Tensor, to: int, frm: int) -> torch.Tensor:
    """Send ``send`` to rank ``to`` and receive a tensor of its shape and
    dtype from rank ``frm``: one isend and one irecv, both waited."""
    import torch.distributed as dist

    w = spanning()
    wire = _to_wire(send, w, "send")
    out = _empty_wire(wire.numel(), w, "recv")
    ops = [dist.P2POp(dist.isend, wire, to), dist.P2POp(dist.irecv, out, frm)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _from_wire(out, send, w)


def ring_shift(x: torch.Tensor, dim: int, shift: int) -> torch.Tensor:
    """The ring ``ppermute`` of a process-spanning axis: ``x`` holds this
    process's run of shards along ``dim``; the result's shard ``i``
    (global) holds what shard ``i - shift`` held. A local shift of the
    run, then the ``|shift|`` shards that wrap past its end traded with the
    neighbouring processes."""
    w = spanning()
    n = x.shape[dim]
    m = abs(int(shift))
    if m == 0:
        return x
    if m > n:
        raise ValueError(f"a shift of {shift} past the {n} shards a process "
                         "holds")
    if shift > 0:
        got = exchange(x.narrow(dim, n - m, m), (w.rank + 1) % w.procs,
                       (w.rank - 1) % w.procs)
        return torch.cat([got, x.narrow(dim, 0, n - m)], dim)
    got = exchange(x.narrow(dim, 0, m), (w.rank - 1) % w.procs,
                   (w.rank + 1) % w.procs)
    return torch.cat([x.narrow(dim, m, n - m), got], dim)


def all_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every process's ``x`` (equal shapes) concatenated along ``dim`` in
    rank order; ``x`` itself without a world."""
    import torch.distributed as dist

    w = spanning()
    if w is None:
        return x
    mine = _to_wire(x, w, "gather")
    parts = [torch.empty_like(mine) for _ in range(w.procs)]
    dist.all_gather(parts, mine)
    return torch.cat([_from_wire(p, x, w) for p in parts], dim)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """``all_to_all_single`` over dimension 0 in equal parts: part ``r`` of
    this process's ``x`` goes to rank ``r``, and part ``r`` of the result
    came from rank ``r``."""
    import torch.distributed as dist

    w = spanning()
    if x.shape[0] % w.procs:
        raise ValueError(f"all_to_all: {x.shape[0]} rows do not split over "
                         f"{w.procs} processes")
    mine = _to_wire(x, w, "a2a-send")
    out = _empty_wire(mine.numel(), w, "a2a-recv")
    dist.all_to_all_single(out, mine)
    return _from_wire(out, x, w)


def agree(ok: bool) -> bool:
    """Whether ``ok`` holds in every process (an all-reduce of the flag);
    ``ok`` itself without a world."""
    import torch.distributed as dist

    w = spanning()
    if w is None:
        return bool(ok)
    dev = w.device if w.transport == "nccl" else torch.device("cpu")
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def barrier() -> None:
    """Wait for every process (nothing without a world)."""
    import torch.distributed as dist

    w = spanning()
    if w is None:
        return
    if w.transport == "nccl":
        dist.barrier(device_ids=[w.device.index])
    else:
        dist.barrier()
