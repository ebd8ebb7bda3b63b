"""Device-resident session pool: handle-based serving state.

Counterpart of ``mpi_and_open_mp_tpu/serve/pool.py``. A live Life session
stays on the device between requests as a :class:`Handle`, a (slab,
bit-lane) pair over a board-sliced ``(n_planes, ny, nx)`` int32 slab (bit
``lane % 32`` of plane ``lane // 32`` is one whole board, the layout of
``ops.bitlife.pack_batch_bits``). A board crosses between host and device
on three occasions only: session **create**, **snapshot** and **evict**
(and a spill or a revival). Everything in between is a handle-sized
dispatch.

**Masked stepping.** A dispatch of a slab group is
``ops.native_pool.pool_step``: the ``bitlife_bitsliced`` kernel's rounds,
the last in its tail mode, which merges ``(cur & mask) | (slab & ~mask)``
into a new slab as it writes back and ORs each plane's change word. The
slab group rebinds its planes to the new slab, as the JAX package rebinds
the slab it donated to its XLA program; everything reads ``planes`` fresh
from the group. The step count and the lane mask are run-time values, so a
lone session and 32 slab-mates take the same launches;
``jit.retrace{fn=pool_step}`` ticks once per plane shape, as the JAX
package compiles once per plane shape. Unmasked lanes come back bit for
bit. :meth:`SessionPool.program_digest` keys the launch record
(``serve.aotcache.fingerprint(..., program="pool-step", donated=True)``).

**Settled skip.** The change word (``lane_change_bits`` of the last two
consecutive states) is copied to pinned host memory behind the dispatch
and read at the slab's next step, when its settled bits (``~change &
mask``) are resolved (waiting on that dispatch's event alone); when
every session of a group is a proven fixed point (a period-k oscillator
never is), the dispatch is skipped and only ``steps_applied`` moves. A
rewrite (create, revive) clears the flag, and a compaction or a freed slab
drops the pending word: settledness is re-proven, never carried.

**Lane IO.** On the card a board crosses PCIe inside one lane kernel
launch (``ops.native_pool.pool_lane_write``/``pool_lane_read``), read
from or written to page-locked host memory: no staging tensor on the card
and no copy launch. The pool holds a small fixed ring of page-locked slots
a plane shape (:class:`_LaneRing`, :data:`LANE_RING_SLOTS` boards), each
with an event after the last launch that used it. A write fills a slot
with ``board != 0`` in one numpy pass (after waiting on that slot's event
alone) and launches; a read launches into a slot, waits on its event
alone and copies the slot into a new pageable board that the caller owns.
The ring's page-locked bytes never grow with sessions, spills or
snapshots; on the CPU there is no ring and the plain versions run.

**Lane allocation, spills, compaction** are the JAX package's: the lowest
free lane of the fullest slab of the board's shape, else a new slab
under the hard ``device_budget_bytes``, else the least-recently-used
unpinned sessions spill to host boards (revived on their next step as a
``pool.miss``; a snapshot of a spilled session reads the host copy).
:meth:`SessionPool.compact` repacks a fragmented shape's survivors 32 at
a time through ``unpack_batch_bits``/``pack_batch_bits`` into the fewest
slabs. Counts, ``stats()``, ``pool.*`` metrics, gauges and trace events
carry the JAX package's names.

Durability is the caller's: the serving daemon journals CREATE, STEP,
SNAPSHOT and EVICT frames write-ahead (``serve.wal``) and re-materializes
the pool on resume.
"""

from __future__ import annotations

import dataclasses
import sys
from collections import OrderedDict

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.obs import metrics, trace
from mpi_and_open_mp_tpu_torch.ops import native_pool
from mpi_and_open_mp_tpu_torch.ops.bitlife import (
    _note_retrace, pack_batch_bits, unpack_batch_bits)
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

#: Boards per bit-plane: the word width of the sliced layout.
LANES_PER_PLANE = 32

#: Default hard budget for live slab bytes on the device (64 MiB).
DEFAULT_DEVICE_BUDGET = 64 << 20

#: Page-locked boards a plane shape's lane ring holds on the card. Three:
#: on an NVIDIA H100 80GB HBM3 at 700 W, 64 back-to-back creates of 500^2
#: boards took ~0.10 ms each through 2 slots against ~0.06-0.08 through 3
#: or 4 (host clock).
LANE_RING_SLOTS = 3


class PoolError(ValueError):
    """A session-pool contract violation (duplicate create, unknown
    session, a budget too small to hold even one slab)."""


@dataclasses.dataclass(frozen=True)
class Handle:
    """Where a resident session lives: ``lane % 32`` is the bit, ``lane
    // 32`` the plane, inside slab ``slab``. Compaction moves handles;
    sessions are addressed by id."""

    slab: int
    lane: int


@dataclasses.dataclass
class _Slab:
    shape: tuple[int, int]
    planes: torch.Tensor  # (P, ny, nx) int32 on the pool's device
    free: int  # bitmap over 32*P lanes; bit set = lane free
    lanes: dict[int, str] = dataclasses.field(default_factory=dict)

    @property
    def capacity(self) -> int:
        return int(self.planes.shape[0]) * LANES_PER_PLANE

    @property
    def live(self) -> int:
        return len(self.lanes)


@dataclasses.dataclass
class _Session:
    sid: str
    shape: tuple[int, int]
    handle: Handle | None = None  # None = spilled to host
    host: np.ndarray | None = None  # the board, when spilled
    steps_applied: int = 0
    #: Proven still life: the last dispatch's final step changed nothing on
    #: this lane. False on create and revive.
    settled: bool = False


# ------------------------------------------------------------ device calls
#
# One retrace tick per plane shape for each of the three, as the JAX
# package compiles each once per plane shape.


def _pool_step(planes: torch.Tensor, steps: int,
               mask: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    _note_retrace("pool_step", tuple(planes.shape), planes.is_cuda)
    m = torch.from_numpy(mask.view(np.int32)).to(planes.device)
    return native_pool.pool_step(planes, steps, m)


def _fetch_later(change: torch.Tensor) -> tuple:
    """A change word on its way to the host. On the card, a copy into
    pinned memory queued behind the dispatch and an event after it:
    resolving waits for that dispatch alone (a plain ``.cpu()`` would wait
    for everything queued since), and the dispatch never waits."""
    if not change.is_cuda:
        return change, None
    host = torch.empty(change.shape, dtype=change.dtype, pin_memory=True)
    host.copy_(change, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _fetched(word: tuple) -> np.ndarray:
    host, done = word
    if done is not None:
        done.synchronize()
    return host.numpy().view(np.uint32)


class _LaneRing:
    """A plane shape's page-locked slots for lane IO on the card: each a
    ``(ny, nx)`` uint8 board the lane kernels reach across PCIe, and an
    event recorded after the last launch that read or wrote it. The host
    waits on a slot's event alone before it writes that slot again; the
    ring keeps its own tensors and events, since a ctypes launch does not
    tell torch's host allocator that a block is in use. Its bytes are fixed
    when it is made."""

    def __init__(self, shape: tuple[int, int], device: torch.device):
        self.device = device
        self.slots = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                      for _ in range(LANE_RING_SLOTS)]
        self.cells = [slot.numpy() for slot in self.slots]
        self.done = [torch.cuda.Event() for _ in self.slots]
        self._next = 0

    @property
    def nbytes(self) -> int:
        return sum(slot.numel() for slot in self.slots)

    def _take(self) -> int:
        k = self._next
        self._next = (k + 1) % len(self.slots)
        self.done[k].synchronize()  # the launch that last used slot k
        return k

    def _launched(self, k: int) -> None:
        self.done[k].record(torch.cuda.current_stream(self.device))

    def write(self, planes: torch.Tensor, board: np.ndarray, plane: int,
              bit: int) -> None:
        k = self._take()
        np.not_equal(board, 0, out=self.cells[k].view(np.bool_))
        native_pool.pool_lane_write(planes, self.slots[k], plane, bit)
        self._launched(k)

    def read(self, planes: torch.Tensor, plane: int, bit: int) -> np.ndarray:
        k = self._take()
        native_pool.pool_lane_read(planes, plane, bit, out=self.slots[k])
        self._launched(k)
        self.done[k].synchronize()
        return self.cells[k].copy()

    def __del__(self):
        # A freed slot goes back to torch's host allocator, which may hand
        # it to the next page-locked tensor at once: let the launches on
        # the slots end first (at interpreter exit nothing reuses them).
        if not sys.is_finalizing():
            for done in self.done:
                done.synchronize()


def _lane_write(planes: torch.Tensor, board: np.ndarray, lane: int,
                ring: _LaneRing | None = None) -> None:
    """Write ``board != 0`` into ``lane``: through ``ring`` on the card
    (one ``pool_lane_write`` launch from a page-locked slot), the plain
    version on a CPU slab."""
    _note_retrace("pool_lane_write", tuple(planes.shape), planes.is_cuda)
    plane, bit = divmod(lane, LANES_PER_PLANE)
    if ring is not None:
        ring.write(planes, board, plane, bit)
        return
    cells = torch.from_numpy(np.not_equal(board, 0).view(np.uint8))
    native_pool.pool_lane_write(planes, cells, plane, bit)


def _lane_read(planes: torch.Tensor, lane: int,
               ring: _LaneRing | None = None) -> np.ndarray:
    """``lane`` as a new (ny, nx) uint8 board the caller owns: through
    ``ring`` on the card (one ``pool_lane_read`` launch into a page-locked
    slot, then a copy), the plain version on a CPU slab."""
    _note_retrace("pool_lane_read", tuple(planes.shape), planes.is_cuda)
    plane, bit = divmod(lane, LANES_PER_PLANE)
    if ring is not None:
        return ring.read(planes, plane, bit)
    return native_pool.pool_lane_read(planes, plane, bit).numpy()


class SessionPool:
    """The device-resident session pool. Host-side manager, clock-free, no
    threads, no IO: slabs on ``device`` (the card unless the caller asks
    for the CPU), bitmaps, an LRU and a host spill dict.

    ``planes_per_slab`` sets slab capacity (32 lanes a plane); one plane
    keeps the masked step's wasted work bounded by one word of lanes."""

    def __init__(self, *, device_budget_bytes: int = DEFAULT_DEVICE_BUDGET,
                 planes_per_slab: int = 1,
                 device: str | torch.device = "cuda"):
        if planes_per_slab < 1:
            raise PoolError(
                f"planes_per_slab must be >= 1, got {planes_per_slab}")
        if device_budget_bytes < 1:
            raise PoolError(
                f"device_budget_bytes must be >= 1, got {device_budget_bytes}")
        self.device = resolve_device(device)
        self._budget = int(device_budget_bytes)
        self._planes_per_slab = int(planes_per_slab)
        self._slabs: dict[int, _Slab] = {}
        self._next_slab = 0
        self._sessions: dict[str, _Session] = {}
        self._lru: OrderedDict[str, None] = OrderedDict()  # resident only
        self._pinned: set[str] = set()  # in-flight group, spill-exempt
        self._program_digests: dict[tuple, str] = {}
        # Page-locked lane IO slots a plane shape, on the card only.
        self._rings: dict[tuple[int, int], _LaneRing] = {}
        self.counts = {
            "creates": 0, "hits": 0, "misses": 0, "evictions": 0,
            "spills": 0, "revivals": 0, "compactions": 0, "migrated": 0,
            "slabs_freed": 0, "dispatches": 0, "steps_applied": 0,
            "settled_skips": 0,
        }
        # Deferred change words: slab_id -> (the word on its way to the
        # host, the dispatch's mask, [(sess, lane)]). Read at the slab's
        # NEXT step, so the dispatch itself never waits on the device.
        self._pending_settled: dict[int, tuple] = {}

    # -- geometry ----------------------------------------------------------

    def _slab_bytes(self, shape: tuple[int, int]) -> int:
        ny, nx = shape
        return self._planes_per_slab * ny * nx * 4

    def device_bytes(self) -> int:
        return sum(self._slab_bytes(s.shape) for s in self._slabs.values())

    def _capacity(self) -> int:
        return self._planes_per_slab * LANES_PER_PLANE

    # -- introspection -----------------------------------------------------

    def sessions(self) -> list[str]:
        return list(self._sessions)

    def has(self, sid: str) -> bool:
        return sid in self._sessions

    def handle(self, sid: str) -> Handle | None:
        """The session's current handle (``None`` when spilled): a grouping
        hint only; compaction and spills move it."""
        return self._require(sid).handle

    def slab_groups(self) -> dict[int | None, list[str]]:
        """Live sessions grouped by resident slab (``None`` = spilled): the
        unit a membership change migrates."""
        out: dict[int | None, list[str]] = {}
        for sid, s in self._sessions.items():
            key = s.handle.slab if s.handle is not None else None
            out.setdefault(key, []).append(sid)
        return out

    def steps_applied(self, sid: str) -> int:
        return self._require(sid).steps_applied

    def program_digest(self, shape: tuple[int, int]) -> str:
        """The launch-record digest of this shape's in-place step: plane
        shape, ``program="pool-step"`` and ``donated=True`` in the key, so
        a pool step is never taken for a bucket of the same stack shape."""
        key = (self._planes_per_slab, *shape)
        if key not in self._program_digests:
            from mpi_and_open_mp_tpu_torch.serve import aotcache

            self._program_digests[key] = aotcache.digest_for(
                aotcache.fingerprint(key, np.uint32, program="pool-step",
                                     donated=True, device=self.device))
        return self._program_digests[key]

    def stats(self) -> dict:
        resident = sum(1 for s in self._sessions.values()
                       if s.handle is not None)
        out = dict(self.counts)
        out.update({
            "sessions": len(self._sessions),
            "resident": resident,
            "spilled": len(self._sessions) - resident,
            "slabs": len(self._slabs),
            "lanes_live": sum(s.live for s in self._slabs.values()),
            "lanes_free": sum(s.capacity - s.live
                              for s in self._slabs.values()),
            "device_bytes": self.device_bytes(),
            "device_budget_bytes": self._budget,
        })
        return out

    def _gauges(self) -> None:
        s = self.stats()
        for name in ("slabs", "lanes_live", "lanes_free", "device_bytes",
                     "spilled"):
            metrics.gauge(f"pool.{name}", s[name])

    # -- internals ---------------------------------------------------------

    def _ring(self, shape: tuple[int, int]) -> _LaneRing | None:
        """The plane shape's lane ring on the card, made at its first lane
        IO and kept for the pool's life; ``None`` on the CPU."""
        if self.device.type != "cuda":
            return None
        ring = self._rings.get(shape)
        if ring is None:
            ring = self._rings[shape] = _LaneRing(shape, self.device)
        return ring

    def lane_ring_bytes(self) -> int:
        """Page-locked bytes the lane rings hold: ``LANE_RING_SLOTS`` boards
        a plane shape used, whatever the sessions, spills and snapshots."""
        return sum(ring.nbytes for ring in self._rings.values())

    def _require(self, sid: str) -> _Session:
        try:
            return self._sessions[sid]
        except KeyError:
            raise PoolError(f"unknown session {sid!r}") from None

    def _touch(self, sid: str) -> None:
        self._lru[sid] = None
        self._lru.move_to_end(sid)

    def _alloc_lane(self, shape: tuple[int, int]) -> Handle:
        """A free lane for one board of ``shape``: the fullest slab first,
        else a new slab under the budget, else spill LRU sessions until one
        of those works."""
        while True:
            candidates = [(sl.live, slab_id) for slab_id, sl
                          in self._slabs.items()
                          if sl.shape == shape and sl.free]
            if candidates:
                _, slab_id = max(candidates)
                slab = self._slabs[slab_id]
                lane = (slab.free & -slab.free).bit_length() - 1
                slab.free &= ~(1 << lane)
                return Handle(slab_id, lane)
            if self.device_bytes() + self._slab_bytes(shape) <= self._budget:
                slab_id = self._new_slab(shape)
                self._slabs[slab_id].free &= ~1
                return Handle(slab_id, 0)
            if not self._spill_one():
                raise PoolError(
                    f"device budget {self._budget} B cannot hold one "
                    f"{shape} slab ({self._slab_bytes(shape)} B) with "
                    "every resident session pinned")

    def _new_slab(self, shape: tuple[int, int]) -> int:
        slab_id = self._next_slab
        self._next_slab += 1
        planes = torch.zeros((self._planes_per_slab, *shape),
                             dtype=torch.int32, device=self.device)
        self._slabs[slab_id] = _Slab(
            shape=shape, planes=planes, free=(1 << self._capacity()) - 1)
        return slab_id

    def _free_lane(self, h: Handle) -> None:
        slab = self._slabs[h.slab]
        slab.free |= 1 << h.lane
        slab.lanes.pop(h.lane, None)
        if not slab.lanes:
            del self._slabs[h.slab]
            self._pending_settled.pop(h.slab, None)
            self.counts["slabs_freed"] += 1

    def _spill_one(self) -> bool:
        """Spill the least-recently-used unpinned resident session to the
        host tier; ``False`` when nothing is spillable."""
        for sid in self._lru:
            if sid in self._pinned:
                continue
            sess = self._sessions[sid]
            sess.host = _lane_read(self._slabs[sess.handle.slab].planes,
                                   sess.handle.lane, self._ring(sess.shape))
            self._free_lane(sess.handle)
            sess.handle = None
            del self._lru[sid]
            self.counts["spills"] += 1
            metrics.inc("pool.spill")
            return True
        return False

    def _resolve_settled(self, slab_id: int) -> None:
        """Fetch a slab's deferred change word (if one is pending) and fan
        its settled bits out to the sessions that dispatch stepped."""
        pending = self._pending_settled.pop(slab_id, None)
        if pending is None:
            return
        word, mask, lanes = pending
        settled = ~_fetched(word) & mask
        for sess, lane in lanes:
            sess.settled = bool(
                (int(settled[lane // LANES_PER_PLANE])
                 >> (lane % LANES_PER_PLANE)) & 1)

    def _resident(self, sid: str) -> _Session:
        """The session, revived onto a lane if it was spilled (a
        ``pool.miss``: one board back to the device)."""
        sess = self._require(sid)
        if sess.handle is not None:
            self.counts["hits"] += 1
            metrics.inc("pool.hit")
            self._touch(sid)
            return sess
        self.counts["misses"] += 1
        self.counts["revivals"] += 1
        metrics.inc("pool.miss")
        h = self._alloc_lane(sess.shape)
        _lane_write(self._slabs[h.slab].planes, sess.host, h.lane,
                    self._ring(sess.shape))
        self._slabs[h.slab].lanes[h.lane] = sid
        sess.handle, sess.host = h, None
        sess.settled = False  # re-prove after any rewrite, never carry
        self._touch(sid)
        return sess

    # -- the session lifecycle ---------------------------------------------

    def create(self, sid: str, board: np.ndarray) -> Handle:
        """Admit one live session: the board crosses to the device once,
        into a lane of a slab. Raises on a duplicate id: create and evict
        are the lifecycle, not an upsert."""
        if sid in self._sessions:
            raise PoolError(f"session {sid!r} already exists")
        board = np.asarray(board)
        if board.ndim != 2:
            raise PoolError(
                f"create: one 2D board per session, got {board.shape}")
        shape = (int(board.shape[0]), int(board.shape[1]))
        h = self._alloc_lane(shape)
        _lane_write(self._slabs[h.slab].planes, board, h.lane,
                    self._ring(shape))
        self._slabs[h.slab].lanes[h.lane] = sid
        self._sessions[sid] = _Session(sid=sid, shape=shape, handle=h)
        self._touch(sid)
        self.counts["creates"] += 1
        metrics.inc("pool.create")
        trace.event("pool.create", sid=sid, slab=h.slab, lane=h.lane,
                    shape=f"{shape[0]}x{shape[1]}")
        self._gauges()
        return h

    def step(self, sid: str, steps: int) -> None:
        """Advance one session in place: no board moves. A lone step and a
        32-lane group step take the same launches (the mask is data)."""
        self.step_group([sid], steps)

    def step_group(self, sids: list[str], steps: int) -> int:
        """Advance many sessions ``steps`` steps with as few dispatches as
        their slab placement allows: the lanes of one slab ride one masked
        dispatch. Returns the dispatch count."""
        steps = int(steps)
        if steps < 0:
            raise PoolError(f"steps must be >= 0, got {steps}")
        if not sids:
            return 0
        self._pinned.update(sids)
        try:
            by_slab: dict[int, list[_Session]] = {}
            for sid in sids:
                sess = self._resident(sid)
                by_slab.setdefault(sess.handle.slab, []).append(sess)
        finally:
            self._pinned.difference_update(sids)
        if steps == 0:
            return 0
        dispatches = skips = 0
        for slab_id, group in by_slab.items():
            slab = self._slabs[slab_id]
            self._resolve_settled(slab_id)
            if all(sess.settled for sess in group):
                # Every lane of the group is a proven fixed point: any step
                # count is the identity, so only the logical count moves.
                # Journaled STEP frames stay authoritative: a replay
                # re-proves settledness and lands on the same bits.
                skips += 1
                for sess in group:
                    sess.steps_applied += steps
                trace.event("pool.settled_skip", slab=slab_id,
                            lanes=len(group), steps=steps)
                continue
            mask = np.zeros(self._planes_per_slab, np.uint32)
            for sess in group:
                lane = sess.handle.lane
                mask[lane // LANES_PER_PLANE] |= np.uint32(
                    1 << (lane % LANES_PER_PLANE))
            slab.planes, change = _pool_step(slab.planes, steps, mask)
            word = _fetch_later(change)
            self._pending_settled[slab_id] = (
                word, mask, [(sess, sess.handle.lane) for sess in group])
            dispatches += 1
            for sess in group:
                sess.steps_applied += steps
            trace.event("pool.step", slab=slab_id, lanes=len(group),
                        steps=steps)
        self.counts["dispatches"] += dispatches
        self.counts["steps_applied"] += steps * len(sids)
        self.counts["settled_skips"] += skips
        metrics.inc("pool.dispatches", dispatches)
        if skips:
            metrics.inc("pool.settled_skips", skips)
        return dispatches

    def snapshot(self, sid: str) -> np.ndarray:
        """The session's current board on the host (uint8): one
        board-sized read for a resident session, a copy of the host board
        for a spilled one (no revival)."""
        sess = self._require(sid)
        if sess.handle is None:
            return np.array(sess.host, dtype=np.uint8)
        self._touch(sid)
        return _lane_read(self._slabs[sess.handle.slab].planes,
                          sess.handle.lane, self._ring(sess.shape))

    def evict(self, sid: str) -> np.ndarray:
        """End the session: its final board comes back, its lane frees,
        an emptied slab is released."""
        sess = self._require(sid)
        board = self.snapshot(sid)
        if sess.handle is not None:
            self._free_lane(sess.handle)
            self._lru.pop(sid, None)
        del self._sessions[sid]
        self.counts["evictions"] += 1
        metrics.inc("pool.evict")
        trace.event("pool.evict", sid=sid, steps=sess.steps_applied)
        self._gauges()
        return board

    # -- lane compaction ---------------------------------------------------

    def fragmented_shapes(self) -> list[tuple[int, int]]:
        """Shapes whose live lanes would fit in fewer slabs than they
        occupy: the compaction trigger."""
        by_shape: dict[tuple[int, int], tuple[int, int]] = {}
        for slab in self._slabs.values():
            n, live = by_shape.get(slab.shape, (0, 0))
            by_shape[slab.shape] = (n + 1, live + slab.live)
        cap = self._capacity()
        return [shape for shape, (n, live) in by_shape.items()
                if n > max(1, -(-live // cap)) or (n and live == 0)]

    def maybe_compact(self) -> dict | None:
        """Compact iff fragmented (the daemon polls this between pump
        rounds); ``None`` when there is nothing to do."""
        return self.compact() if self.fragmented_shapes() else None

    def compact(self) -> dict:
        """Repack every fragmented shape's survivors ``32 * P`` at a time
        through ``unpack_batch_bits``/``pack_batch_bits`` into the fewest
        slabs, on the device, free the emptied slabs and re-point the
        handles. A migrated session keeps its bits."""
        migrated = freed = 0
        cap = self._capacity()
        for shape in self.fragmented_shapes():
            slab_ids = sorted(s_id for s_id, sl in self._slabs.items()
                              if sl.shape == shape)
            boards: list[torch.Tensor] = []
            sids: list[str] = []
            for s_id in slab_ids:
                slab = self._slabs[s_id]
                if slab.lanes:
                    stack = unpack_batch_bits(slab.planes, cap)
                    for lane, sid in sorted(slab.lanes.items()):
                        boards.append(stack[lane])
                        sids.append(sid)
                del self._slabs[s_id]
                # Lanes move: a pending word indexed by the old lanes must
                # not resolve against the new layout (settled stays False).
                self._pending_settled.pop(s_id, None)
                freed += 1
            for lo in range(0, len(sids), cap):
                chunk_sids = sids[lo:lo + cap]
                chunk = torch.stack(boards[lo:lo + cap])
                slab_id = self._next_slab
                self._next_slab += 1
                pad = cap - len(chunk_sids)
                if pad:
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        (pad, *shape))])
                self._slabs[slab_id] = _Slab(
                    shape=shape, planes=pack_batch_bits(chunk).contiguous(),
                    free=((1 << cap) - 1) & ~((1 << len(chunk_sids)) - 1),
                    lanes={i: sid for i, sid in enumerate(chunk_sids)})
                for i, sid in enumerate(chunk_sids):
                    old = self._sessions[sid].handle
                    if (old.slab, old.lane) != (slab_id, i):
                        migrated += 1
                    self._sessions[sid].handle = Handle(slab_id, i)
                freed -= 1
        self.counts["compactions"] += 1
        self.counts["migrated"] += migrated
        self.counts["slabs_freed"] += max(freed, 0)
        metrics.inc("pool.compactions")
        if migrated:
            metrics.inc("pool.migrated", migrated)
        trace.event("pool.compact", migrated=migrated, freed=freed)
        self._gauges()
        return {"migrated": migrated, "slabs_freed": max(freed, 0),
                "slabs": len(self._slabs)}
