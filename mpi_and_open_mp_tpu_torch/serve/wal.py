"""Write-ahead ticket journal: durability at arbitrary crash points.

Counterpart of ``mpi_and_open_mp_tpu/serve/wal.py``, whole and
byte-compatible: a journal written by either package replays in the
other. Records pickle numpy arrays and plain types only, never a tensor.

The drain checkpoint (``utils.checkpoint.save_state``) survives only a
cooperative preemption: SIGTERM lands as a flag, the in-flight batch
completes, the pending queue snapshots, the process exits 75. A
``kill -9``, an OOM kill or a lost node never runs that code. Here every
ticket transition is appended, and fsynced as the policy says, before the
daemon acts on it, so the admitted set can be rebuilt from disk whatever
instruction the process died on.

File format (``momp-serve-wal/1``)::

    momp-serve-wal/1\\n                      # ASCII magic line
    [frame]*                                # append-only record frames

    frame := >I payload-length | >I CRC32(payload) | payload
    payload := pickle((rtype, dict))        # one record

Record types and what :func:`replay` does with them:

``ADMIT {id, board, steps, wall, queued_s[, session][, workload]}``
    Ticket enters the pending set. ``wall`` is ``time.time()`` at the
    append (monotonic clocks don't survive a process boundary; wall time
    lets the resuming process carry true queued seconds forward).
    ``session`` is the optional fleet affinity key — the router
    (``serve.router.FleetRouter.declare_wedged``) re-homes a dead
    worker's pending set by consistent-hashing it, so the key
    must survive the journal round trip (absent in pre-fleet journals;
    replay surfaces ``None``). ``workload`` names the stencil rule
    (absent in pre-stencil journals; replay surfaces ``"life"`` — which
    is exactly what those journals ran).
``DISPATCH {ids}``
    A chunk went to the engines. Pending membership is unchanged — a
    ``DISPATCH`` without a later ``RESOLVE``/``SHED`` covering its ids
    means the process died mid-batch, and because dispatch is *pure*
    (same boards + steps → same result, no external side effects) the
    resumed daemon simply re-runs it. Replay reports these ids as
    ``in_flight`` for the accounting line.
``RESOLVE {ids, engine}`` / ``SHED {ids, reason}``
    Tickets leave the pending set (terminal). Results are deliberately
    NOT journaled: the WAL's contract is the *pending set*, not the
    response cache — a resolved ticket's answer either reached its
    caller or is reproducible by redispatch.
``COMPACT {generation, count}``
    Head frame of a rotated journal: the full pending set lives in the
    crash-atomic ``save_state`` snapshot at ``<path>.snap.<generation>``
    and the frames after this one are the tail written since rotation.
    Pool sessions rotate with it: the snapshot's ``pool`` list carries
    ``{id, board, steps, wall}`` per live session (the create board
    plus the *total* journaled step count), so a rotated journal
    re-materializes the pool exactly as a never-rotated one would.

Handle-lifecycle records (the device-resident session pool,
``serve.pool``; the daemon re-materializes the pool from them on resume).
These journal *state transitions of resident sessions* rather than
tickets — resident step traffic writes exactly one frame per request
(no ADMIT/DISPATCH/RESOLVE triple), which is what makes the WAL cheap
enough to sit on the handle fast path:

``CREATE {id, board, steps:0, wall}``
    A session entered the pool with this board. The board crosses the
    wire (and the journal) exactly once, here. Re-creating an id that
    is live is an inconsistency error; re-creating after an ``EVICT``
    is a legitimate new lifetime.
``STEP {id, steps}``
    The session advanced ``steps`` generations in place. Write-ahead
    and *authoritative*: resume state is the create board advanced by
    the sum of journaled steps, so a journaled-but-unacked step is
    applied on resume (at-least-once on unacked work, zero acked loss
    — the ack only returns after the frame is durable).
``SNAPSHOT {id, steps_applied}``
    The caller read the session's board. Nothing to replay — the frame
    exists so the crash matrix can kill between a snapshot and the
    next transition and prove the books still balance.
``EVICT {id}``
    The session left the pool (terminal for this lifetime).

**Torn-tail tolerance.** A crash mid-append (SIGKILL between the two
``write``s, a filled disk, the injected ``crash=mid-frame:<k>`` chaos
fault) leaves a torn final frame. :func:`replay` stops at the first
frame that fails its length or CRC check and recovers the clean prefix
— the same discipline as ``utils.checkpoint.restore_state``, applied
per record instead of per file. A torn frame can only be a record whose
append never *returned*, so no acked transition is ever inside the torn
region (the fsync-ladder table below makes that precise).

**The fsync ladder** (``fsync=`` policy) trades durability for append
latency; the loss bound is what the crash-matrix test proves at every
instrumented crash site:

================  ==========================================  =========================
policy            behaviour per append                          loss bound on hard kill
================  ==========================================  =========================
``every-record``  write + flush + fsync                        zero acked records
``every-chunk``   buffer in-process; write+flush+fsync at      ≤ one chunk
                  chunk-lifecycle records (DISPATCH/RESOLVE/    (< ``chunk_records``
                  SHED/COMPACT) or every ``chunk_records``      buffered ADMITs)
                  buffered records, whichever first
``off``           write + flush (OS-buffered, never fsync)     zero on process death;
                                                               unbounded on power cut
================  ==========================================  =========================

``every-chunk`` buffers frames in *user space* — not just skipping the
fsync — so the bound is honest under SIGKILL too (a flushed-but-not-
fsynced record survives process death in the page cache; only the
power-cut story would differ, and that cannot be rehearsed in CI).

**Compaction.** The journal grows with traffic, not with queue depth;
:meth:`TicketWAL.compact` rotates it once ``bytes_since_compact``
crosses the threshold: (1) the pending set goes to
``<path>.snap.<generation>`` through the existing crash-atomic
``save_state`` (tmp sibling + fsync + ``os.replace`` + directory
fsync), (2) a fresh journal containing only the ``COMPACT`` head frame
replaces the old one with the same tmp/replace/dir-fsync discipline,
(3) the superseded snapshot is unlinked. A crash between (1) and (2)
leaves the OLD self-contained journal authoritative (the orphan
snapshot's generation is referenced by no ``COMPACT`` head and is
overwritten by the next rotation); a crash after (2) is the new
journal, complete. No interleaving exposes a state that replays wrong.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import struct
import time
import zlib

import numpy as np

from mpi_and_open_mp_tpu_torch.obs import metrics, trace
from mpi_and_open_mp_tpu_torch.robust import chaos
from mpi_and_open_mp_tpu_torch.utils import checkpoint as checkpoint_mod
from mpi_and_open_mp_tpu_torch.utils.timing import Timer

WAL_MAGIC = b"momp-serve-wal/1\n"
WAL_SNAP_SCHEMA = "momp-serve-wal-snap/1"

_FRAME = struct.Struct(">II")  # payload length, CRC32(payload)
#: Ceiling on a single frame's payload — anything larger in a length
#: field is corruption, not data (the biggest real record is one ADMIT
#: board; bench boards are KBs).
MAX_FRAME_BYTES = 64 << 20

FSYNC_POLICIES = ("every-record", "every-chunk", "off")

#: Record types whose append closes a chunk lifecycle step — the
#: ``every-chunk`` policy syncs on these (and on a full buffer) so a
#: dispatched batch is never less durable than its admits.
_CHUNK_BOUNDARY = ("DISPATCH", "RESOLVE", "SHED", "COMPACT",
                   "CREATE", "STEP", "EVICT")


def _snap_path(path: str, generation: int) -> str:
    return f"{path}.snap.{generation}"


@dataclasses.dataclass
class WALReplay:
    """What :func:`replay` reconstructed from a journal.

    ``pending`` holds admit-ordered entries ``{id, board, steps, wall,
    queued_s}`` — every admitted ticket with no terminal record,
    including the ``in_flight_ids`` of an open ``DISPATCH`` (redispatch
    is idempotent, so they simply rejoin the queue). ``resolved_ids`` /
    ``shed_ids`` close the books: every id the dead process journaled
    terminal. ``shed_reasons`` splits the shed set per policy reason —
    a membership audit needs to tell a ``re-homed`` handoff (which must
    pair with an adoption on some OTHER worker's journal) from a real
    terminal shed. ``pool_sessions`` maps live session id → ``{id,
    board, steps, wall}`` — the create board plus the summed journaled
    step count, which *is* the session's resumable state (re-materialize
    by advancing ``board`` ``steps`` generations). ``truncated_at`` is
    the byte offset of a torn tail (``None`` for a clean EOF).
    """

    pending: list[dict]
    in_flight_ids: set[int]
    resolved_ids: set[int]
    shed_ids: set[int]
    shed_reasons: dict[str, set[int]] = dataclasses.field(
        default_factory=dict)
    pool_sessions: dict[str, dict] = dataclasses.field(default_factory=dict)
    generation: int = 0
    frames: int = 0
    truncated_at: int | None = None

    @property
    def truncated(self) -> bool:
        return self.truncated_at is not None

    def counts(self) -> dict:
        """The accounting sub-object the resume CLI line publishes."""
        return {
            "pending": len(self.pending),
            "in_flight": len(self.in_flight_ids),
            "resolved": len(self.resolved_ids),
            "shed": len(self.shed_ids),
            "pool_sessions": len(self.pool_sessions),
            "generation": self.generation,
            "frames": self.frames,
            "truncated": self.truncated,
        }


def _encode(rtype: str, payload: dict) -> bytes:
    blob = pickle.dumps((rtype, payload), protocol=pickle.HIGHEST_PROTOCOL)
    return _FRAME.pack(len(blob), zlib.crc32(blob)) + blob


def replay(path: str | os.PathLike) -> WALReplay:
    """Reconstruct the exact pending set (plus any in-flight batch) from
    a journal, tolerating a torn tail.

    Raises ``ValueError`` only when the file cannot be a journal at all
    (missing, bad magic) or its ``COMPACT`` head references a snapshot
    that is missing/corrupt/mismatched — the cases where *no* safe
    reconstruction exists and the resume ladder must fall to the drain
    checkpoint. A torn or corrupt tail is NOT an error: replay stops at
    the first bad frame and returns the clean prefix.
    """
    path = os.path.abspath(os.fspath(path))
    try:
        with open(path, "rb") as fd:
            blob = fd.read()
    except OSError as e:
        raise ValueError(
            f"no readable ticket journal at {path} "
            f"({type(e).__name__}: {e})") from e
    if not blob.startswith(WAL_MAGIC):
        raise ValueError(
            f"ticket journal at {path} has a bad magic header — not a "
            "momp-serve-wal/1 file (or corrupted at offset 0)")

    pending: dict[int, dict] = {}
    rep = WALReplay(pending=[], in_flight_ids=set(),
                    resolved_ids=set(), shed_ids=set())
    off = len(WAL_MAGIC)
    while off < len(blob):
        if len(blob) - off < _FRAME.size:
            rep.truncated_at = off
            break
        length, want_crc = _FRAME.unpack_from(blob, off)
        body = off + _FRAME.size
        if length > MAX_FRAME_BYTES or body + length > len(blob):
            rep.truncated_at = off
            break
        payload = blob[body:body + length]
        if zlib.crc32(payload) != want_crc:
            rep.truncated_at = off
            break
        try:
            rtype, rec = pickle.loads(payload)
        except Exception:  # noqa: BLE001 — CRC passed but undecodable
            rep.truncated_at = off
            break
        if rtype == "ADMIT":
            tid = int(rec["id"])
            if tid in pending or tid in rep.resolved_ids | rep.shed_ids:
                raise ValueError(
                    f"ticket journal at {path} re-admits ticket {tid} "
                    f"at frame {rep.frames} — the journal is internally "
                    "inconsistent, refusing to guess a pending set")
            pending[tid] = {
                "id": tid, "board": np.asarray(rec["board"]),
                "steps": int(rec["steps"]),
                "wall": float(rec.get("wall", 0.0)),
                "queued_s": float(rec.get("queued_s", 0.0)),
                "session": rec.get("session"),
                # Pre-stencil journals carry no workload: life, exactly.
                "workload": str(rec.get("workload", "life")),
            }
        elif rtype == "DISPATCH":
            for tid in rec["ids"]:
                if tid in pending:
                    rep.in_flight_ids.add(int(tid))
        elif rtype == "RESOLVE":
            for tid in rec["ids"]:
                pending.pop(int(tid), None)
                rep.in_flight_ids.discard(int(tid))
                rep.resolved_ids.add(int(tid))
        elif rtype == "SHED":
            reason = str(rec.get("reason", ""))
            for tid in rec["ids"]:
                pending.pop(int(tid), None)
                rep.in_flight_ids.discard(int(tid))
                rep.shed_ids.add(int(tid))
                rep.shed_reasons.setdefault(reason, set()).add(int(tid))
        elif rtype == "CREATE":
            sid = str(rec["id"])
            if sid in rep.pool_sessions:
                raise ValueError(
                    f"ticket journal at {path} re-creates live pool "
                    f"session {sid!r} at frame {rep.frames} — the "
                    "journal is internally inconsistent")
            rep.pool_sessions[sid] = {
                "id": sid, "board": np.asarray(rec["board"]),
                "steps": int(rec.get("steps", 0)),
                "wall": float(rec.get("wall", 0.0)),
            }
        elif rtype == "STEP":
            sid = str(rec["id"])
            if sid not in rep.pool_sessions:
                raise ValueError(
                    f"ticket journal at {path} steps unknown pool "
                    f"session {sid!r} at frame {rep.frames}")
            rep.pool_sessions[sid]["steps"] += int(rec["steps"])
        elif rtype == "SNAPSHOT":
            sid = str(rec["id"])
            if sid not in rep.pool_sessions:
                raise ValueError(
                    f"ticket journal at {path} snapshots unknown pool "
                    f"session {sid!r} at frame {rep.frames}")
            # Nothing to mutate: a snapshot is a read. The frame exists
            # so the crash matrix can land between it and the next
            # transition and prove the replayed state is unaffected.
        elif rtype == "EVICT":
            sid = str(rec["id"])
            if sid not in rep.pool_sessions:
                raise ValueError(
                    f"ticket journal at {path} evicts unknown pool "
                    f"session {sid!r} at frame {rep.frames}")
            del rep.pool_sessions[sid]
        elif rtype == "COMPACT":
            if rep.frames != 0:
                raise ValueError(
                    f"ticket journal at {path} carries a COMPACT record "
                    f"at frame {rep.frames}; a rotated journal starts "
                    "with it — the file is inconsistent")
            gen = int(rec["generation"])
            try:
                snap = checkpoint_mod.restore_state(_snap_path(path, gen))
            except ValueError as e:
                raise ValueError(
                    f"ticket journal at {path} references compaction "
                    f"snapshot generation {gen} but the snapshot is "
                    f"unreadable ({e})"[:400]) from e
            if (not isinstance(snap, dict)
                    or snap.get("schema") != WAL_SNAP_SCHEMA
                    or int(snap.get("generation", -1)) != gen):
                raise ValueError(
                    f"ticket journal at {path} references compaction "
                    f"snapshot generation {gen} but "
                    f"{_snap_path(path, gen)} does not match it")
            rep.generation = gen
            for entry in snap["pending"]:
                pending[int(entry["id"])] = {
                    "id": int(entry["id"]),
                    "board": np.asarray(entry["board"]),
                    "steps": int(entry["steps"]),
                    "wall": float(entry.get("wall", 0.0)),
                    "queued_s": float(entry.get("queued_s", 0.0)),
                    "session": entry.get("session"),
                    "workload": str(entry.get("workload", "life")),
                }
            for entry in snap.get("pool", []):
                sid = str(entry["id"])
                rep.pool_sessions[sid] = {
                    "id": sid, "board": np.asarray(entry["board"]),
                    "steps": int(entry["steps"]),
                    "wall": float(entry.get("wall", 0.0)),
                }
        else:
            raise ValueError(
                f"ticket journal at {path} carries unknown record type "
                f"{rtype!r} at frame {rep.frames}")
        rep.frames += 1
        off = body + length

    rep.pending = list(pending.values())
    metrics.inc("serve.wal.replays")
    trace.event("serve.wal.replay", path=path, **rep.counts())
    return rep


class TicketWAL:
    """The append side of the journal — one instance per daemon.

    ``chunk_records`` bounds the ``every-chunk`` buffer (the daemon
    passes its ``max_batch``, making "≤ one chunk" literal);
    ``compact_bytes`` is the rotation threshold the daemon polls via
    :meth:`should_compact`. Opening an existing journal appends to it;
    the daemon's resume path rotates immediately instead, so a live
    journal is always internally consistent with the writing process's
    ticket ids.
    """

    def __init__(self, path: str | os.PathLike, *,
                 fsync: str = "every-record", chunk_records: int = 8,
                 compact_bytes: int = 1 << 20):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"unknown WAL fsync policy {fsync!r} "
                f"(want one of {FSYNC_POLICIES})")
        if chunk_records < 1:
            raise ValueError(
                f"chunk_records must be >= 1, got {chunk_records}")
        self.path = os.path.abspath(os.fspath(path))
        self.fsync = fsync
        self.chunk_records = int(chunk_records)
        self.compact_bytes = int(compact_bytes)
        self._generation = 0
        self._buf: list[bytes] = []
        self._bytes_since_compact = 0
        self.stats_records = 0
        self.stats_bytes = 0
        self.stats_syncs = 0
        self.stats_sync_seconds = 0.0
        self.stats_compactions = 0
        outdir = os.path.dirname(self.path)
        if outdir:
            os.makedirs(outdir, exist_ok=True)
        fresh = (not os.path.exists(self.path)
                 or os.path.getsize(self.path) == 0)
        self._fd = open(self.path, "ab")
        if fresh:
            self._fd.write(WAL_MAGIC)
            self._fd.flush()
            self._sync_fd()
            checkpoint_mod._fsync_dir(self.path)

    # -- record appends ----------------------------------------------------

    def admit(self, ticket_id: int, board, steps: int, *,
              wall: float | None = None, queued_s: float = 0.0,
              session: str | None = None,
              workload: str = "life") -> None:
        self._append("ADMIT", {
            "id": int(ticket_id), "board": np.asarray(board),
            "steps": int(steps),
            "wall": time.time() if wall is None else float(wall),
            "queued_s": float(queued_s),
            "session": session,
            "workload": str(workload),
        })

    def dispatch_begin(self, ticket_ids: list[int]) -> None:
        self._append("DISPATCH", {"ids": [int(i) for i in ticket_ids]})

    def resolve(self, ticket_ids: list[int], engine: str | None = None) -> None:
        self._append("RESOLVE", {"ids": [int(i) for i in ticket_ids],
                                 "engine": engine})

    def shed(self, ticket_ids: list[int], reason: str) -> None:
        self._append("SHED", {"ids": [int(i) for i in ticket_ids],
                              "reason": str(reason)})

    # -- pool handle-lifecycle appends --------------------------------------

    def pool_create(self, session: str, board, *,
                    wall: float | None = None) -> None:
        self._append("CREATE", {
            "id": str(session), "board": np.asarray(board), "steps": 0,
            "wall": time.time() if wall is None else float(wall),
        })

    def pool_step(self, session: str, steps: int) -> None:
        self._append("STEP", {"id": str(session), "steps": int(steps)})

    def pool_snapshot(self, session: str, steps_applied: int) -> None:
        self._append("SNAPSHOT", {"id": str(session),
                                  "steps_applied": int(steps_applied)})

    def pool_evict(self, session: str) -> None:
        self._append("EVICT", {"id": str(session)})

    # -- compaction --------------------------------------------------------

    def should_compact(self) -> bool:
        return self._bytes_since_compact >= self.compact_bytes

    def compact(self, pending_entries: list[dict],
                pool_sessions: dict[str, dict] | None = None) -> None:
        """Rotate the journal: pending set to a crash-atomic snapshot,
        journal file atomically replaced by a COMPACT-headed fresh one.
        ``pending_entries`` are ``{id, board, steps, wall, queued_s}``
        dicts in admit order (the daemon computes ``queued_s`` against
        its own clock at rotation time). ``pool_sessions`` maps live
        session id → ``{id, board, steps, wall}`` — the create board
        plus total journaled steps, i.e. the same resumable shape
        ``replay`` reconstructs, so the rotation never touches the
        device (no snapshot reads at compact time)."""
        gen = self._generation + 1
        entries = [{
            "id": int(e["id"]), "board": np.asarray(e["board"]),
            "steps": int(e["steps"]), "wall": float(e.get("wall", 0.0)),
            "queued_s": float(e.get("queued_s", 0.0)),
            "session": e.get("session"),
            "workload": str(e.get("workload", "life")),
        } for e in pending_entries]
        pool = [{
            "id": str(s["id"]), "board": np.asarray(s["board"]),
            "steps": int(s["steps"]), "wall": float(s.get("wall", 0.0)),
        } for s in (pool_sessions or {}).values()]
        with trace.span("serve.wal.compact", generation=gen,
                        pending=len(entries), pool=len(pool)):
            checkpoint_mod.save_state(_snap_path(self.path, gen), {
                "schema": WAL_SNAP_SCHEMA, "generation": gen,
                "pending": entries, "pool": pool,
            })
            head = WAL_MAGIC + _encode(
                "COMPACT", {"generation": gen, "count": len(entries)})
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as fd:
                fd.write(head)
                fd.flush()
                os.fsync(fd.fileno())
            self._fd.close()
            os.replace(tmp, self.path)
            checkpoint_mod._fsync_dir(self.path)
            self._fd = open(self.path, "ab")
        # The superseded snapshot is referenced by nothing now; best
        # effort — a leftover file can only waste bytes, never replay.
        try:
            os.unlink(_snap_path(self.path, self._generation))
        except OSError:
            pass
        self._generation = gen
        self._buf.clear()
        self._bytes_since_compact = 0
        self.stats_compactions += 1
        metrics.inc("serve.wal.compactions")

    # -- durability plumbing -----------------------------------------------

    def _append(self, rtype: str, payload: dict) -> None:
        frame = _encode(rtype, payload)
        if chaos.crash_armed("mid-frame"):
            # The injected torn write: half a frame reaches the OS, then
            # the process dies as hard as a SIGKILL would — replay must
            # truncate here and recover the clean prefix.
            self._fd.write(frame[:max(1, len(frame) // 2)])
            self._fd.flush()
            os.fsync(self._fd.fileno())
            chaos.crash_now()
        if self.fsync == "every-chunk":
            self._buf.append(frame)
            if (rtype in _CHUNK_BOUNDARY
                    or len(self._buf) >= self.chunk_records):
                self._flush_buffer(sync=True)
        else:
            self._fd.write(frame)
            self._fd.flush()
            if self.fsync == "every-record":
                self._sync_fd()
        self.stats_records += 1
        self.stats_bytes += len(frame)
        self._bytes_since_compact += len(frame)
        metrics.inc("serve.wal.records", type=rtype)
        metrics.inc("serve.wal.bytes", len(frame))

    def _flush_buffer(self, sync: bool) -> None:
        if self._buf:
            self._fd.write(b"".join(self._buf))
            self._buf.clear()
        self._fd.flush()
        if sync:
            self._sync_fd()

    def _sync_fd(self) -> None:
        with Timer() as t:
            os.fsync(self._fd.fileno())
        self.stats_syncs += 1
        self.stats_sync_seconds += t.elapsed

    def sync(self) -> None:
        """Force buffered records to durable storage regardless of
        policy — the preemption drain and clean shutdown call this so a
        polite exit is never less durable than a crash."""
        self._flush_buffer(sync=True)

    def close(self) -> None:
        self._flush_buffer(sync=self.fsync != "off")
        self._fd.close()

    def stats(self) -> dict:
        """The journal-overhead numbers the bench line publishes."""
        return {
            "fsync": self.fsync,
            "records": self.stats_records,
            "bytes": self.stats_bytes,
            "syncs": self.stats_syncs,
            "sync_seconds": round(self.stats_sync_seconds, 6),
            "compactions": self.stats_compactions,
            "generation": self._generation,
        }
