"""The RDMA rung across processes: windows onto the ring neighbours' device
memory, through CUDA IPC.

Counterpart of the remote half of the JAX package's ``_rdma_edge_pair``
(``mpi_and_open_mp_tpu/parallel/haloplan.py:263-320``): there each device
signals a barrier semaphore on both ring neighbours, waits for two, and
copies its edges into buffers of the logical devices ``nxt`` and ``prv``,
which on a multi-host slice belong to other processes. Here the rung's
kernels (``csrc/halo_frame.cu``, ``csrc/halo_edge_pair.cu``) read the
neighbours' cells where they lie: every rank owns a :class:`Window`, a
device buffer of two slots (the round's parity) allocated by
``csrc/peer_window.cu`` with an interprocess event, and maps its ring
neighbours' windows into its address space (``cudaIpcOpenMemHandle`` with
``cudaIpcMemLazyEnablePeerAccess``). The handles travel once a window,
over ``procs.all_gather_bytes`` on the host, never once a round. The
kernels take their sources from tables of element offsets from the rank's
own slot (``ops/native_halo.py``); a slot lies at the same place in every
rank's window, so one table serves both parities.

The sync rule. A round's kernel may read a neighbour's slot only after the
neighbour has recorded the event that follows its write to it; a
neighbour may overwrite a slot only after every reader of it has launched
the kernel that reads it. A round (:meth:`Window.publish`, after the
rank's writes to its slot are enqueued) records the rank's event, meets
both ring neighbours on the host (``procs.handshake``, a page of host
memory the ranks share: the counterpart of the JAX kernel's neighbour
barrier), so that the neighbours' records of this round are enqueued, then
makes the current stream wait for them (``cudaStreamWaitEvent``). A slot is written again two rounds later, after
that rank's next round waited for its neighbours' next records, which
follow their reads of it in their streams. No kernel spins on a flag in
peer memory: two processes on one card time-slice it, and nothing here
starts MPS.

No fallback: a handle that does not open, a neighbour on another host or
without peer access (``cudaDeviceCanAccessPeer``, the ``nccl`` form of a
card a rank, unverified on the one H100 here), or windows of different
sizes raise, naming the cause. :func:`close_all` (run by
``procs.shutdown``) waits for the card, closes the opened windows, then
frees the rank's own.
"""

from __future__ import annotations

import ctypes
import socket
import struct

import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.parallel import procs

# A slot starts on a multiple of this many bytes (cudaMalloc gives 256).
ALIGN = 256
# Bytes of a cudaIpcMemHandle_t and of a cudaIpcEventHandle_t.
HANDLE_BYTES = 64
# Bytes of the host name in a window's record.
HOST_BYTES = 64

# Every open window of this process, in the order they were made.
_OPEN: list["Window"] = []


class _DeviceBytes:
    """``n`` bytes of device memory at ``ptr`` as a CUDA array (the
    interface ``torch.as_tensor`` reads), so that a window's slot is a
    tensor without a copy."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {
            "shape": (n,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc:
        msg = lib.peer_window_error(rc).decode()
        raise RuntimeError(f"peer window: {what} failed: CUDA error {rc} "
                           f"({msg})")


class Window:
    """This rank's window of two slots of ``slot_bytes`` on ``device``
    (a collective: every rank of the run makes it at the same point), with
    its ring neighbours' windows opened. ``parity`` is the slot of the next
    round."""

    def __init__(self, slot_bytes: int, device: torch.device):
        w = procs.spanning()
        if w is None:
            raise RuntimeError("a peer window needs a run across processes "
                               "(parallel.procs.init)")
        if device.type != "cuda":
            raise ValueError(f"a peer window lives on the card, not {device}")
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        self.device = torch.device("cuda", index)
        self.rank = w.rank
        # The ring neighbours: one rank where there are two processes.
        self.neighbours = sorted({(w.rank - 1) % w.procs,
                                  (w.rank + 1) % w.procs})
        self.slot_bytes = -(-max(int(slot_bytes), 1) // ALIGN) * ALIGN
        self.lib = lib = _build.load("peer_window")
        ptr, event = ctypes.c_void_p(), ctypes.c_void_p()
        mem_h = ctypes.create_string_buffer(HANDLE_BYTES)
        event_h = ctypes.create_string_buffer(HANDLE_BYTES)
        with torch.cuda.device(self.device):
            _check(lib, lib.peer_window_alloc(
                2 * self.slot_bytes, ctypes.byref(ptr), ctypes.byref(event),
                mem_h, event_h), "cudaMalloc of a window and its IPC handles")
        self.ptrs, self.events = {self.rank: ptr.value}, {self.rank: event.value}
        self.closed = False
        _OPEN.append(self)
        host = socket.gethostname().encode()[:HOST_BYTES]
        mine = (mem_h.raw + event_h.raw
                + struct.pack("<iq", index, self.slot_bytes)
                + host.ljust(HOST_BYTES, b"\0"))
        records = procs.all_gather_bytes(mine)
        for r in self.neighbours:
            self._open(r, records[r], index, host)
        self.parity = 0
        self.slots = [torch.as_tensor(
            _DeviceBytes(self.ptrs[self.rank] + p * self.slot_bytes,
                         self.slot_bytes), device=self.device)
            for p in (0, 1)]

    def _open(self, r: int, record: bytes, index: int, host: bytes) -> None:
        lib = self.lib
        h = 2 * HANDLE_BYTES
        peer_index, peer_bytes = struct.unpack("<iq", record[h:h + 12])
        peer_host = record[h + 12:].rstrip(b"\0")
        if peer_host != host:
            raise RuntimeError(
                f"rank {r}, a ring neighbour of rank {self.rank}, runs on "
                f"host {peer_host.decode()!r}, not {host.decode()!r}: the "
                "RDMA rung across processes maps the neighbours' device "
                "memory through CUDA IPC, which stays inside one host")
        if peer_bytes != self.slot_bytes:
            raise RuntimeError(
                f"rank {r}'s window slot holds {peer_bytes} bytes, rank "
                f"{self.rank}'s {self.slot_bytes}: the ranks' runs differ")
        can = ctypes.c_int()
        _check(lib, lib.peer_window_can_access(index, peer_index,
                                               ctypes.byref(can)),
               "cudaDeviceCanAccessPeer")
        if not can.value:
            raise RuntimeError(
                f"card {index} of rank {self.rank} cannot access card "
                f"{peer_index} of rank {r} (cudaDeviceCanAccessPeer): the "
                "RDMA rung across processes needs peer access between the "
                "ring neighbours' cards")
        ptr, event = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(self.device):
            _check(lib, lib.peer_window_open(
                record[:HANDLE_BYTES], record[HANDLE_BYTES:h],
                ctypes.byref(ptr), ctypes.byref(event)),
                f"cudaIpcOpenMemHandle of rank {r}'s window")
        self.ptrs[r], self.events[r] = ptr.value, event.value

    def offsets(self, owners, offsets, elem: int):
        """Element offsets from this rank's slot: ``offsets`` (elements
        into the slot of the rank in ``owners``, numpy arrays of one
        shape) plus each owner's window's distance from this rank's. Raises
        where a distance does not divide by ``elem``."""
        out = offsets.copy()
        for r in set(owners.ravel().tolist()):
            delta = self.ptrs[r] - self.ptrs[self.rank]
            if delta % elem:
                raise ValueError(
                    f"rank {r}'s window lies {delta} bytes from rank "
                    f"{self.rank}'s, not a multiple of the {elem}-byte "
                    "elements the kernel's offsets count")
            out[owners == r] += delta // elem
        return out

    def publish(self) -> int:
        """Close this round's writes to slot ``parity`` (enqueued on the
        current stream): record the event, meet both ring neighbours
        (``procs.handshake``), make the stream wait for their records;
        returns the slot's address for the round's kernel and turns the
        parity."""
        lib = self.lib
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(lib, lib.peer_window_record(self.events[self.rank], stream),
               "cudaEventRecord")
        procs.handshake()
        for r in self.neighbours:
            _check(lib, lib.peer_window_wait(self.events[r], stream),
                   f"cudaStreamWaitEvent on rank {r}'s event")
        p = self.parity
        self.parity ^= 1
        return self.ptrs[self.rank] + p * self.slot_bytes


def close_all() -> None:
    """Close every window of this process (every rank at once, from
    ``procs.shutdown``): wait for the card, so that no kernel still reads a
    neighbour's window, close the opened windows, then free this rank's
    own once every rank has closed its mappings."""
    if not _OPEN:
        return
    for dev in {w.device for w in _OPEN}:
        torch.cuda.synchronize(dev)
    procs.barrier()
    for w in _OPEN:
        for r in [r for r in w.neighbours if r in w.ptrs]:
            with torch.cuda.device(w.device):
                _check(w.lib, w.lib.peer_window_close(
                    ctypes.c_void_p(w.ptrs[r]), ctypes.c_void_p(w.events[r]),
                    0), f"closing rank {r}'s window")
    procs.barrier()
    for w in _OPEN:
        w.slots = []
        with torch.cuda.device(w.device):
            _check(w.lib, w.lib.peer_window_close(
                ctypes.c_void_p(w.ptrs[w.rank]),
                ctypes.c_void_p(w.events[w.rank]), 1), "freeing a window")
        w.closed = True
    _OPEN.clear()


procs.at_shutdown(close_all)
