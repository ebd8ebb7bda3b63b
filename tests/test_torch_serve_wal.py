"""The port's write-ahead ticket journal, held against the JAX package's.

The JAX package's journal cases (``tests/test_serve_wal.py``) run again on
the port: round trip, in-flight replay, rejection of what is not a
journal, the seeded torn-write fuzzers, ``every-chunk`` buffering in user
space, fsync counts, compaction and its crash windows, the daemon's
resume ladder and the CLI's ``--wal``. Across packages: a journal written
by either package's ``TicketWAL`` (pool frames and a compaction included)
replays in the other to the same ``WALReplay``, and the same seeded
appends give byte-identical files. The crash matrix: a real port daemon in
a subprocess (``tests/_torch_wal_crash_driver.py``) hard-killed at each of
3 sites under each of 3 fsync policies, JAX's loss bounds over exactly the
acked tickets, then ``resume_any`` drained to the oracle's boards. The
membership cells: the driver's 3-worker fleet killed at ``post-rejoin``
and ``mid-drain`` duplicates and never loses (every worker journal read by
both packages' replays), and the unkilled controls balance the books.
"""

import glob
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import oracle_n
from mpi_and_open_mp_tpu.serve import wal as jwal

from mpi_and_open_mp_tpu_torch.robust import chaos
from mpi_and_open_mp_tpu_torch.serve import ServePolicy, ServingDaemon
from mpi_and_open_mp_tpu_torch.serve import daemon as daemon_cli
from mpi_and_open_mp_tpu_torch.serve import wal
from mpi_and_open_mp_tpu_torch.serve.queue import DONE
from mpi_and_open_mp_tpu_torch.utils import checkpoint as checkpoint_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(REPO, "tests", "_torch_wal_crash_driver.py")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch calls: one thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.delenv("MOMP_CHAOS", raising=False)
    chaos.reset()
    yield
    chaos.reset()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _board(rng, n=12):
    return (rng.random((n, n)) < 0.3).astype(np.uint8)


def _daemon(policy, clk=None, **kw):
    clk = clk or FakeClock()
    return ServingDaemon(policy, clock=clk, sleep=clk.sleep, device="cpu",
                         **kw), clk


# ------------------------------------------------------------------ basics


def test_wal_roundtrip_replay(tmp_path, rng):
    w = wal.TicketWAL(tmp_path / "t.wal")
    boards = [_board(rng) for _ in range(3)]
    for i, b in enumerate(boards):
        w.admit(i, b, 2, queued_s=0.5 * i)
    w.dispatch_begin([0, 1])
    w.resolve([0, 1], engine="batch:plain")
    w.shed([7], "queue-depth")  # an id never admitted: terminal only
    w.close()

    rep = wal.replay(tmp_path / "t.wal")
    assert not rep.truncated and rep.frames == 6
    assert {e["id"] for e in rep.pending} == {2}
    np.testing.assert_array_equal(rep.pending[0]["board"], boards[2])
    assert rep.pending[0]["steps"] == 2
    assert rep.pending[0]["queued_s"] == pytest.approx(1.0)
    assert rep.pending[0]["wall"] == pytest.approx(time.time(), abs=60)
    assert rep.resolved_ids == {0, 1} and rep.shed_ids == {7}
    assert rep.in_flight_ids == set() and rep.counts()["pending"] == 1


def test_wal_open_dispatch_replays_as_in_flight(tmp_path, rng):
    w = wal.TicketWAL(tmp_path / "t.wal")
    for i in range(4):
        w.admit(i, _board(rng), 2)
    w.dispatch_begin([0, 1, 2, 3])
    w.close()
    rep = wal.replay(tmp_path / "t.wal")
    assert {e["id"] for e in rep.pending} == {0, 1, 2, 3}
    assert rep.in_flight_ids == {0, 1, 2, 3}


def test_wal_rejects_non_journal_and_inconsistency(tmp_path, rng):
    with pytest.raises(ValueError, match="no readable"):
        wal.replay(tmp_path / "missing.wal")
    bad = tmp_path / "bad.wal"
    bad.write_bytes(b"definitely not a journal\n" * 4)
    with pytest.raises(ValueError, match="magic"):
        wal.replay(bad)

    w = wal.TicketWAL(tmp_path / "dup.wal")
    w.admit(5, _board(rng), 1)
    w.admit(5, _board(rng), 1)
    w.close()
    with pytest.raises(ValueError, match="re-admits"):
        wal.replay(tmp_path / "dup.wal")

    w = wal.TicketWAL(tmp_path / "late.wal")
    w.admit(0, _board(rng), 1)
    w._append("COMPACT", {"generation": 1, "count": 0})  # not at the head
    w.close()
    with pytest.raises(ValueError, match="COMPACT"):
        wal.replay(tmp_path / "late.wal")

    w = wal.TicketWAL(tmp_path / "unk.wal")
    w._append("FROB", {"x": 1})
    w.close()
    with pytest.raises(ValueError, match="unknown record type"):
        wal.replay(tmp_path / "unk.wal")

    with pytest.raises(ValueError, match="fsync policy"):
        wal.TicketWAL(tmp_path / "x.wal", fsync="sometimes")


# --------------------------------------------------------------- torn tails


def _parse_frames(path):
    """An independent parser: byte spans and records of every frame."""
    blob = open(path, "rb").read()
    assert blob.startswith(wal.WAL_MAGIC)
    off = len(wal.WAL_MAGIC)
    frames = []
    while off < len(blob):
        length, _crc = wal._FRAME.unpack_from(blob, off)
        end = off + wal._FRAME.size + length
        rtype, rec = pickle.loads(blob[off + wal._FRAME.size:end])
        frames.append({"start": off, "end": end, "rtype": rtype,
                       "rec": rec})
        off = end
    return blob, frames


def _expected_state(frames):
    pending, in_flight, resolved, shed = {}, set(), set(), set()
    for f in frames:
        r = f["rec"]
        if f["rtype"] == "ADMIT":
            pending[r["id"]] = r
        elif f["rtype"] == "DISPATCH":
            in_flight.update(i for i in r["ids"] if i in pending)
        elif f["rtype"] in ("RESOLVE", "SHED"):
            for i in r["ids"]:
                pending.pop(i, None)
                in_flight.discard(i)
                (resolved if f["rtype"] == "RESOLVE" else shed).add(i)
    return pending, in_flight, resolved, shed


def _build_journal(path, rng):
    w = wal.TicketWAL(path)
    nxt = 0
    for _ in range(5):
        batch = []
        for _ in range(int(rng.integers(2, 5))):
            w.admit(nxt, _board(rng, 8), int(rng.integers(1, 4)))
            batch.append(nxt)
            nxt += 1
        w.dispatch_begin(batch)
        if rng.random() < 0.7:
            w.resolve(batch, engine="batch:plain")
        else:
            w.shed(batch, "dispatch-failed")
    w.admit(nxt, _board(rng, 8), 2)  # one left pending
    w.close()


def test_torn_write_fuzzer_random_cuts(tmp_path):
    """The journal cut at any byte replays to the state of its whole-frame
    prefix: never raises, never resurrects or drops a ticket."""
    rng = np.random.default_rng(20260805)
    _build_journal(tmp_path / "full.wal", rng)
    blob, frames = _parse_frames(tmp_path / "full.wal")
    ends = {f["end"] for f in frames}
    cuts = sorted({int(c) for c in rng.integers(
        len(wal.WAL_MAGIC), len(blob), size=60)} | {len(blob) - 1})
    for cut in cuts:
        p = tmp_path / "cut.wal"
        p.write_bytes(blob[:cut])
        rep = wal.replay(p)
        keep = [f for f in frames if f["end"] <= cut]
        pending, in_flight, resolved, shed = _expected_state(keep)
        assert {e["id"] for e in rep.pending} == set(pending), f"cut={cut}"
        assert rep.in_flight_ids == in_flight, f"cut={cut}"
        assert rep.resolved_ids == resolved and rep.shed_ids == shed
        assert rep.truncated == (cut not in ends), f"cut={cut}"
        if rep.truncated:
            assert rep.truncated_at == (keep[-1]["end"] if keep
                                        else len(wal.WAL_MAGIC))


def test_torn_write_fuzzer_byte_flips(tmp_path):
    """One flipped byte past the magic truncates replay at its frame."""
    rng = np.random.default_rng(48)
    _build_journal(tmp_path / "full.wal", rng)
    blob, frames = _parse_frames(tmp_path / "full.wal")
    offs = sorted({int(o) for o in rng.integers(
        len(wal.WAL_MAGIC), len(blob), size=40)})
    for off in offs:
        flipped = bytearray(blob)
        flipped[off] ^= 0x5A
        p = tmp_path / "flip.wal"
        p.write_bytes(bytes(flipped))
        rep = wal.replay(p)
        hit = next(f for f in frames if f["start"] <= off < f["end"])
        keep = [f for f in frames if f["end"] <= hit["start"]]
        pending, _, resolved, shed = _expected_state(keep)
        assert {e["id"] for e in rep.pending} == set(pending), f"off={off}"
        assert rep.resolved_ids == resolved and rep.shed_ids == shed
        assert rep.truncated and rep.truncated_at == hit["start"]


# ------------------------------------------------------------- fsync ladder


def test_every_chunk_buffers_in_user_space(tmp_path, rng):
    path = tmp_path / "c.wal"
    w = wal.TicketWAL(path, fsync="every-chunk", chunk_records=4)
    for i in range(3):
        w.admit(i, _board(rng), 1)
    assert wal.replay(path).counts()["pending"] == 0  # still buffered
    w.admit(3, _board(rng), 1)  # the 4th record fills the buffer
    assert wal.replay(path).counts()["pending"] == 4
    w.admit(4, _board(rng), 1)
    assert wal.replay(path).counts()["pending"] == 4
    w.dispatch_begin([0, 1, 2, 3])  # a chunk boundary flushes everything
    rep = wal.replay(path)
    assert rep.counts()["pending"] == 5 and rep.in_flight_ids == {0, 1, 2, 3}
    w.admit(5, _board(rng), 1)
    w.sync()
    assert wal.replay(path).counts()["pending"] == 6
    w.close()


def test_fsync_policy_stats(tmp_path, rng):
    per_record = wal.TicketWAL(tmp_path / "r.wal", fsync="every-record")
    off = wal.TicketWAL(tmp_path / "o.wal", fsync="off")
    for i in range(6):
        per_record.admit(i, _board(rng), 1)
        off.admit(i, _board(rng), 1)
    # +1: a fresh journal syncs its magic header, whatever the policy.
    assert per_record.stats()["syncs"] == 7
    assert off.stats()["syncs"] == 1
    assert per_record.stats()["records"] == off.stats()["records"] == 6
    assert per_record.stats()["bytes"] == off.stats()["bytes"] > 0
    per_record.close()
    off.close()


# -------------------------------------------------------------- compaction


def test_compaction_rotates_and_replays(tmp_path, rng):
    path = tmp_path / "c.wal"
    w = wal.TicketWAL(path, compact_bytes=1)
    boards = {i: _board(rng) for i in range(6)}
    for i in range(6):
        w.admit(i, boards[i], 3, queued_s=float(i))
    w.resolve([0, 1], engine="batch:plain")
    assert w.should_compact()
    size_before = os.path.getsize(path)
    w.compact([{"id": i, "board": boards[i], "steps": 3,
                "wall": time.time(), "queued_s": float(i)}
               for i in (2, 3, 4, 5)])
    assert os.path.getsize(path) < size_before
    assert os.path.exists(wal._snap_path(str(path), 1))
    assert w.stats()["compactions"] == 1 and w.stats()["generation"] == 1
    rep = wal.replay(path)
    assert rep.generation == 1 and not rep.truncated
    assert {e["id"] for e in rep.pending} == {2, 3, 4, 5}
    np.testing.assert_array_equal(rep.pending[0]["board"], boards[2])
    w.resolve([2, 3], engine="batch:plain")
    assert {e["id"] for e in wal.replay(path).pending} == {4, 5}
    w.compact([{"id": 4, "board": boards[4], "steps": 3}])
    assert not os.path.exists(wal._snap_path(str(path), 1))
    assert os.path.exists(wal._snap_path(str(path), 2))
    assert wal.replay(path).counts()["pending"] == 1
    w.close()


def test_compaction_crash_windows(tmp_path, rng):
    """An orphan next-generation snapshot is ignored; a COMPACT head whose
    snapshot is missing is a ValueError (no safe reconstruction)."""
    path = tmp_path / "c.wal"
    w = wal.TicketWAL(path)
    for i in range(3):
        w.admit(i, _board(rng), 2)
    w.close()
    checkpoint_mod.save_state(wal._snap_path(str(path), 1), {
        "schema": wal.WAL_SNAP_SCHEMA, "generation": 1, "pending": []})
    rep = wal.replay(path)
    assert rep.generation == 0 and rep.counts()["pending"] == 3

    w = wal.TicketWAL(path, compact_bytes=1)
    w.compact([{"id": 0, "board": _board(rng), "steps": 2}])
    w.close()
    os.unlink(wal._snap_path(str(path), 1))
    with pytest.raises(ValueError, match="snapshot"):
        wal.replay(path)


# ------------------------------------------------------- across packages


def _write_journal(mod, path, seed, *, pool=True, wall=1.0e9):
    """The same seeded appends through either package's ``TicketWAL``:
    tickets through every record type, pool frames, a compaction, and a
    tail after it. Walls are fixed so the two files can agree to the
    byte."""
    rng = np.random.default_rng(seed)
    w = mod.TicketWAL(path, compact_bytes=1 << 30)
    boards = {}
    for i in range(8):
        shape = [(12, 12), (8, 16), (20, 9)][i % 3]
        boards[i] = (rng.random(shape) < 0.3).astype(np.uint8)
        w.admit(i, boards[i], int(rng.integers(1, 5)), wall=wall + i,
                queued_s=0.25 * i, session=f"s{i % 2}" if i % 4 else None,
                workload="wireworld" if i == 5 else "life")
    w.dispatch_begin([0, 1, 2])
    w.resolve([0, 1], engine="batch:bitsliced")
    w.shed([2], "dispatch-failed")
    w.dispatch_begin([3, 4])
    if pool:
        w.pool_create("p0", boards[6], wall=wall)
        w.pool_step("p0", 2)
        w.pool_create("p1", boards[7], wall=wall)
        w.pool_snapshot("p0", 2)
        w.pool_evict("p1")
    pending = [{"id": i, "board": boards[i], "steps": 2, "wall": wall,
                "queued_s": 1.0} for i in (3, 4, 5, 6, 7)]
    w.compact(pending, pool_sessions={
        "p0": {"id": "p0", "board": boards[6], "steps": 2, "wall": wall}}
        if pool else None)
    w.admit(8, boards[0], 3, wall=wall + 8)
    w.resolve([3], engine="batch:plain")
    w.shed([4], "re-homed")
    if pool:
        w.pool_step("p0", 4)
    w.close()


def _same_replay(a, b):
    assert a.counts() == b.counts()
    assert a.resolved_ids == b.resolved_ids and a.shed_ids == b.shed_ids
    assert a.in_flight_ids == b.in_flight_ids
    assert a.shed_reasons == b.shed_reasons
    assert (a.generation, a.frames, a.truncated_at, a.truncated) \
        == (b.generation, b.frames, b.truncated_at, b.truncated)
    assert len(a.pending) == len(b.pending)
    for x, y in zip(a.pending, b.pending):
        assert {k: v for k, v in x.items() if k != "board"} \
            == {k: v for k, v in y.items() if k != "board"}
        assert x["board"].dtype == y["board"].dtype
        np.testing.assert_array_equal(x["board"], y["board"])
    assert a.pool_sessions.keys() == b.pool_sessions.keys()
    for sid in a.pool_sessions:
        x, y = a.pool_sessions[sid], b.pool_sessions[sid]
        assert (x["steps"], x["wall"]) == (y["steps"], y["wall"])
        np.testing.assert_array_equal(x["board"], y["board"])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("torn", [False, True])
def test_journal_replays_across_packages(tmp_path, writer, torn):
    """A journal written by one package, pool frames and a compaction
    included (and with a torn tail), replays in the other to the same
    ``WALReplay``."""
    path = str(tmp_path / "x.wal")
    _write_journal(jwal if writer == "jax" else wal, path, seed=3)
    if torn:
        with open(path, "ab") as fd:
            fd.write(wal._FRAME.pack(999, 0) + b"\x00" * 10)
    ours, theirs = wal.replay(path), jwal.replay(path)
    assert ours.generation == 1 and ours.pool_sessions["p0"]["steps"] == 6
    assert ours.truncated == torn
    _same_replay(ours, theirs)


@pytest.mark.parametrize("fsync", ["every-record", "every-chunk", "off"])
def test_same_appends_give_identical_bytes(tmp_path, fsync):
    """The same seeded appends through both packages' writers give
    byte-identical journals and compaction snapshots: each frame is the
    same pickle of numpy arrays and plain types under the same protocol,
    framed by the same header."""
    paths = {}
    for name, mod in (("jax", jwal), ("port", wal)):
        d = tmp_path / name
        d.mkdir()
        paths[name] = str(d / "j.wal")
        _write_journal(mod, paths[name], seed=11)
    for suffix in ("", ".snap.1"):
        with open(paths["jax"] + suffix, "rb") as a, \
                open(paths["port"] + suffix, "rb") as b:
            assert a.read() == b.read(), suffix


def test_resume_any_refuses_pool_sessions(tmp_path):
    """A JAX-written journal holding a live pool session (created, stepped
    2 + 4 across a compaction) resumes in the port with the session
    re-materialized: its board equal to the oracle's and to the JAX
    daemon's resume of a copy of the same files, the pending tickets the
    same, and the rotated journal carrying the session."""
    from mpi_and_open_mp_tpu.serve import ServingDaemon as JaxDaemon

    paths = {}
    for name in ("port", "jax"):
        d = tmp_path / name
        d.mkdir()
        paths[name] = str(d / "pool.wal")
    _write_journal(jwal, paths["port"], seed=5)
    for src in glob.glob(paths["port"] + "*"):
        with open(src, "rb") as a, open(
                paths["jax"] + src[len(paths["port"]):], "wb") as b:
            b.write(a.read())
    board = wal.replay(paths["port"]).pool_sessions["p0"]["board"]
    d, source, detail = ServingDaemon.resume_any(wal_path=paths["port"],
                                                 device="cpu")
    jd, jsource, jdetail = JaxDaemon.resume_any(wal_path=paths["jax"])
    assert source == jsource == "wal"
    assert detail["wal_replay"] == jdetail["wal_replay"]
    assert detail["wal_replay"]["pool_sessions"] == 1
    assert d.sessions() == jd.sessions() == ["p0"]
    got = d.snapshot_session("p0")
    np.testing.assert_array_equal(got, oracle_n(board, 6))
    np.testing.assert_array_equal(got, jd.snapshot_session("p0"))
    assert ([t.steps for t in d.queue.pending()]
            == [t.steps for t in jd.queue.pending()])
    d._wal.sync()
    assert wal.replay(paths["port"]).pool_sessions["p0"]["steps"] == 6


# ---------------------------------------------------------- daemon + ladder


def test_daemon_wal_resume_zero_loss_in_flight_redispatch(
        tmp_path, make_board):
    """A daemon that vanishes with one batch resolved and one DISPATCH
    open: resume_any rebuilds every unresolved ticket, redispatches the
    in-flight batch, and the books balance at the oracle's boards."""
    path = str(tmp_path / "serve.wal")
    pol = ServePolicy(max_batch=4, max_wait_s=0.0)
    d, clk = _daemon(pol, wal_path=path)
    boards = [make_board(16, 16) for _ in range(12)]
    for b in boards:
        d.submit(b, 2)
    d._dispatch_chunk(d.queue.due_chunks(clk.t, drain=True)[0])
    d._wal.dispatch_begin([4, 5, 6, 7])  # died with this batch open

    d2, source, detail = ServingDaemon.resume_any(wal_path=path, policy=pol,
                                                  device="cpu")
    assert source == "wal"
    assert detail["wal_replay"]["pending"] == 8
    assert detail["wal_replay"]["in_flight"] == 4
    assert detail["wal_replay"]["resolved"] == 4
    d2.drain()
    s = d2.summary()
    assert s["resolved"] == 8 and s["shed"] == 0 and s["pending"] == 0
    for t, b in zip(d2.queue.tickets(), boards[4:]):
        np.testing.assert_array_equal(t.board, b)
        np.testing.assert_array_equal(t.result, oracle_n(b, 2))
    rep = wal.replay(path)
    assert rep.generation >= 1 and rep.counts()["pending"] == 0


def test_daemon_journals_sheds(tmp_path, make_board):
    path = str(tmp_path / "s.wal")
    d, clk = _daemon(ServePolicy(max_wait_s=0.0, request_timeout_s=1.0),
                     wal_path=path)
    d.submit(make_board(8, 8), 1)
    clk.t = 5.0  # ages past its budget while queued
    d.serve()
    rep = wal.replay(path)
    assert rep.counts()["pending"] == 0 and rep.shed_ids == {0}


def test_daemon_wal_queued_seconds_survive_process_gap(tmp_path, make_board):
    path = str(tmp_path / "q.wal")
    w = wal.TicketWAL(path)
    w.admit(0, make_board(8, 8), 1, wall=time.time() - 30.0, queued_s=5.0)
    w.close()
    d2, source, _ = ServingDaemon.resume_any(
        wal_path=path, policy=ServePolicy(max_wait_s=0.0), device="cpu")
    assert source == "wal"
    (t,) = d2.queue.pending()
    assert t.queued_before_s == pytest.approx(35.0, abs=5.0)
    d2.drain()
    assert t.latency_s >= 30.0


def test_resume_any_ladder_order(tmp_path, make_board):
    """Journal over checkpoint over fresh; an unreadable journal is
    quarantined and the ladder falls through with the error recorded."""
    pol = ServePolicy(max_wait_s=0.0)
    kw = dict(policy=pol, device="cpu")
    d, source, _ = ServingDaemon.resume_any(
        wal_path=str(tmp_path / "none.wal"),
        checkpoint_path=str(tmp_path / "none.ck"), **kw)
    assert source == "fresh" and d.queue.depth() == 0
    assert os.path.exists(tmp_path / "none.wal")

    ck = str(tmp_path / "q.ck")
    q = ServingDaemon(pol, device="cpu").queue
    q.submit(make_board(8, 8), 1, 0.0)
    checkpoint_mod.save_state(ck, q.snapshot(0.0))
    d, source, _ = ServingDaemon.resume_any(
        wal_path=str(tmp_path / "sub" / "never.wal"), checkpoint_path=ck,
        **kw)
    assert source == "checkpoint" and d.queue.depth() == 1

    walp = str(tmp_path / "q.wal")
    w = wal.TicketWAL(walp)
    for i in range(2):
        w.admit(i, make_board(8, 8), 1)
    w.close()
    d, source, _ = ServingDaemon.resume_any(wal_path=walp,
                                            checkpoint_path=ck, **kw)
    assert source == "wal" and d.queue.depth() == 2

    bad = str(tmp_path / "bad.wal")
    with open(bad, "wb") as fd:
        fd.write(b"garbage, not a journal")
    d, source, detail = ServingDaemon.resume_any(wal_path=bad,
                                                 checkpoint_path=ck, **kw)
    assert source == "checkpoint" and "magic" in detail["wal_error"]
    quarantined = glob.glob(bad + ".corrupt.*")
    assert len(quarantined) == 1
    assert detail["wal_quarantine"] == quarantined[0]
    assert d.queue.depth() == 1


def test_daemon_cli_wal_clean_run_and_resume_flags(tmp_path, capsys):
    walp = str(tmp_path / "cli.wal")
    rc = daemon_cli.main(["--requests", "6", "--max-batch", "4",
                          "--max-wait", "0", "--wal", walp, "--verify",
                          "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and line["verified"] is True
    assert line["wal"]["fsync"] == "every-record"
    assert line["wal"]["records"] >= 6 and line["wal"]["syncs"] > 0
    rep = wal.replay(walp)
    assert rep.counts()["pending"] == 0 and len(rep.resolved_ids) == 6
    # The JAX package's replay reads the port daemon's journal the same.
    assert jwal.replay(walp).counts() == rep.counts()

    rc = daemon_cli.main(["--requests", "0", "--resume", "--wal", walp,
                          "--verify", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and line["resume_source"] == "wal"
    assert line["wal_replay"]["pending"] == 0
    assert line["resumed_tickets"] == 0
    with pytest.raises(SystemExit) as ei:
        daemon_cli.main(["--resume"])  # neither --wal nor --checkpoint
    assert ei.value.code == 2


# ------------------------------------------------------------- crash matrix


#: (site, k): where the injected os._exit(137) lands. post-admit and
#: mid-frame fire in the submit loop, post-dispatch after the first batch
#: computed, before its RESOLVE is journaled.
CRASH_CELLS = [("post-admit", 4), ("mid-frame", 4), ("post-dispatch", 1)]


@pytest.mark.parametrize("fsync", list(wal.FSYNC_POLICIES))
@pytest.mark.parametrize("site,k", CRASH_CELLS)
def test_crash_matrix_loss_bounds(tmp_path, site, k, fsync):
    """A real port daemon hard-killed at each site under each policy: no
    acked ticket lost under every-record and off, at most one chunk (4)
    under every-chunk; the survivors resume and drain to the oracle."""
    walp = str(tmp_path / "crash.wal")
    ackp = str(tmp_path / "acked.ids")
    env = dict(os.environ, MOMP_CHAOS=f"crash={site}:{k}")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, DRIVER, walp, fsync, ackp, "6"],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == chaos.CRASH_EXIT == 137, (
        f"crash never fired: rc={proc.returncode} "
        f"out={proc.stdout!r} err={proc.stderr!r}")
    acked = ({int(line) for line in open(ackp)} if os.path.exists(ackp)
             else set())
    assert acked, "the child acked nothing: the cell tested nothing"
    rep = wal.replay(walp)
    assert jwal.replay(walp).counts() == rep.counts()
    accounted = ({e["id"] for e in rep.pending}
                 | rep.resolved_ids | rep.shed_ids)
    lost = acked - accounted
    if fsync == "every-chunk":
        assert len(lost) <= 4, (site, fsync, sorted(lost))
    else:  # every-record: durable before the ack; off: the page cache
        assert lost == set(), (site, fsync, sorted(lost))

    d, source, _ = ServingDaemon.resume_any(
        wal_path=walp, policy=ServePolicy(max_batch=4, max_wait_s=0.0),
        device="cpu")
    assert source == "wal" and d.queue.depth() == len(rep.pending)
    d.drain()
    s = d.summary()
    assert s["resolved"] == len(rep.pending) and s["pending"] == 0
    for t in d.queue.tickets():
        assert t.state == DONE
        np.testing.assert_array_equal(t.result, oracle_n(t.board, t.steps))


# ------------------------------------------------ membership crash matrix


def _run_fleet_driver(tmp_path, mode, momp_chaos=None, n=6):
    wal_dir = str(tmp_path / "fleet")
    os.makedirs(wal_dir, exist_ok=True)
    ackp = str(tmp_path / "acked.txt")
    env = dict(os.environ)
    env.pop("MOMP_CHAOS", None)
    env.pop("PYTHONPATH", None)
    if momp_chaos:
        env["MOMP_CHAOS"] = momp_chaos
    proc = subprocess.run(
        [sys.executable, DRIVER, wal_dir, "every-record", ackp, str(n),
         mode, "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    return proc, wal_dir, ackp


def _parse_acks(ackp):
    created, steps, tickets = [], {}, 0
    for line in open(ackp):
        parts = line.split()
        if parts[0] == "C":
            created.append(parts[1])
            steps.setdefault(parts[1], 0)
        elif parts[0] == "S":
            steps[parts[1]] += int(parts[2])
        elif parts[0] == "T":
            tickets += 1
    return created, steps, tickets


MEMBERSHIP_CELLS = [("rejoin", "post-rejoin"), ("drain", "mid-drain")]


@pytest.mark.parametrize("mode,site", MEMBERSHIP_CELLS)
def test_membership_crash_duplication_not_loss(tmp_path, mode, site):
    """A kill inside the membership handshake, post-rejoin (destination
    CREATE and STEP journaled, the source's EVICT not) and mid-drain (the
    destination's ADMITs journaled, the source's re-homed SHED not):
    every acked session is in at least one worker journal with its acked
    step total, bit-equal wherever it is in two, and the tickets over all
    journals are ``acked <= total <= acked + one bucket``."""
    proc, wal_dir, ackp = _run_fleet_driver(
        tmp_path, mode, momp_chaos=f"crash={site}:1")
    assert proc.returncode == chaos.CRASH_EXIT == 137, (
        f"crash never fired: rc={proc.returncode} "
        f"out={proc.stdout!r} err={proc.stderr!r}")
    created, steps, acked_tickets = _parse_acks(ackp)
    assert created, "driver acked nothing: the cell tested nothing"

    paths = [os.path.join(wal_dir, f"worker{i}.wal") for i in range(3)]
    replays = [wal.replay(p) for p in paths]
    for p, rep in zip(paths, replays):
        assert jwal.replay(p).counts() == rep.counts()

    for sid in created:
        copies = [rep.pool_sessions[sid] for rep in replays
                  if sid in rep.pool_sessions]
        assert copies, f"acked session {sid} lost across the crash"
        for c in copies:
            assert int(c["steps"]) == steps[sid], (sid, c["steps"])
            np.testing.assert_array_equal(c["board"], copies[0]["board"])
    if mode == "rejoin":
        dup = [sid for sid in created if sum(
            sid in rep.pool_sessions for rep in replays) == 2]
        assert dup, "post-rejoin kill left no duplicated session"

    from mpi_and_open_mp_tpu_torch.serve import SHED_REHOMED

    total = 0
    for rep in replays:
        non_rehomed_shed = sum(
            len(ids) for reason, ids in rep.shed_reasons.items()
            if reason != SHED_REHOMED)
        total += len(rep.pending) + len(rep.resolved_ids) \
            + non_rehomed_shed
    assert acked_tickets <= total <= acked_tickets + 6, (
        mode, acked_tickets, total)


@pytest.mark.parametrize("mode", ["rejoin", "drain"])
def test_membership_clean_run_books_balance(tmp_path, mode):
    """The unkilled controls: the rejoin claims its sessions back, the
    drain moves whole buckets and slab groups, and the books balance."""
    proc, _wal_dir, _ackp = _run_fleet_driver(tmp_path, mode)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["balanced"], line
    if mode == "rejoin":
        assert line["rejoins"] == 1 and line["claimed"] >= 3, line
    else:
        assert line["drains"] == 1, line
        assert line["tickets_moved"] == 6, line
        assert line["sessions_moved"] == 2, line
