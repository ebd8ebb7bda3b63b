"""The port's resident-session pool, held against the JAX package's.

The plain versions beside ``csrc/pool_lanes.cu`` (``ops/native_pool.py``:
the step tail with its change word, ``lane_change_bits``, the lane write
and read) against the JAX programs they replace
(``serve/pool.py:_pool_step_jit``, ``_lane_write_jit``, ``_lane_read_jit``,
``ops/bitlife.py:lane_change_bits``) on the same numpy words, bit for bit,
lane 31 (the sign bit of an int32 word) included; a dispatch's calls of
``bitsliced_steps`` (row 5) and ``pool_step_tail`` (row 12) pinned. Then
the two ``SessionPool``\\ s fed the same boards and operations: boards and
``stats()`` equal after each. Then the JAX package's ``tests/test_pool.py``
cases on the port (handles, lane isolation, one retrace per plane shape,
compaction, the spill tier, journal records, the daemon's session paths,
the batcher, the settled skip), journals with live sessions resumed across
the two packages both ways, and the pool crash matrix through the port's
driver (``tests/_torch_wal_crash_driver.py``) in a subprocess killed at
each pool site. Small boards, one torch thread.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import oracle_n
from mpi_and_open_mp_tpu import serve as jserve
from mpi_and_open_mp_tpu.obs import metrics as jmetrics
from mpi_and_open_mp_tpu.ops import bitlife as jbits
from mpi_and_open_mp_tpu.robust import chaos as jchaos
from mpi_and_open_mp_tpu.serve import pool as jpool

from mpi_and_open_mp_tpu_torch.obs import metrics
from mpi_and_open_mp_tpu_torch.ops import native_pool
from mpi_and_open_mp_tpu_torch.robust import chaos
from mpi_and_open_mp_tpu_torch.serve import (
    DEFAULT_DEVICE_BUDGET, LANES_PER_PLANE, Handle, PoolError, ServePolicy,
    ServingDaemon, SessionPool, ShapeBucketBatcher, wal)
from mpi_and_open_mp_tpu_torch.serve.queue import DONE, PENDING, SHED

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
    for mod in (chaos, jchaos):
        mod.reset()
    yield
    for mod in (chaos, jchaos):
        mod.reset()


def _board(rng, n=16):
    return (rng.random((n, n)) < 0.35).astype(np.uint8)


def _still_life(n):
    b = np.zeros((n, n), np.uint8)
    b[n // 2:n // 2 + 2, n // 2:n // 2 + 2] = 1  # block
    return b


def _blinker(n):
    b = np.zeros((n, n), np.uint8)
    b[n // 2, n // 2 - 1:n // 2 + 2] = 1
    return b


def _words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy words as the port's int32 tensor, the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _pools(**kw):
    return SessionPool(device="cpu", **kw), jpool.SessionPool(**kw)


def _hl(h):
    return None if h is None else (h.slab, h.lane)


def _same(pool, jax_pool):
    """Every session's board and the stats dicts equal in the two pools."""
    assert pool.sessions() == jax_pool.sessions()
    for sid in pool.sessions():
        np.testing.assert_array_equal(pool.snapshot(sid),
                                      jax_pool.snapshot(sid))
    assert pool.stats() == jax_pool.stats()
    assert ([_hl(pool.handle(s)) for s in pool.sessions()]
            == [_hl(jax_pool.handle(s)) for s in jax_pool.sessions()])


# ------------------------------------------------ plain versions against JAX

SHAPES = [(1, 1, 7), (1, 7, 1), (2, 3, 3), (1, 12, 12), (2, 9, 14)]
MASKS = ("random", "all", "empty", "lane31")


def _mask(rng, kind, planes) -> np.ndarray:
    if kind == "random":
        return _words(rng, (planes,))
    if kind == "all":
        return np.full(planes, 0xFFFFFFFF, np.uint32)
    if kind == "empty":
        return np.zeros(planes, np.uint32)
    return np.full(planes, 1 << 31, np.uint32)


@pytest.mark.parametrize("shape", SHAPES)
def test_lane_change_bits_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    a = _words(rng, shape)
    b = a.copy()
    # Lanes 0, 5 and 31 (the sign bit) differ in one word each.
    for lane, at in ((0, (0, 0, 0)), (5, (-1, -1, -1)), (31, (0, -1, 0))):
        b[at] ^= np.uint32(1 << lane)
    got = native_pool.lane_change_bits(_t(a), _t(b))
    want = np.asarray(jbits.lane_change_bits(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.int32 and got.shape == (shape[0],)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        _u32(native_pool.lane_change_bits(_t(a), _t(a))), 0)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("steps", [0, 1, 7])
@pytest.mark.parametrize("shape", SHAPES)
def test_pool_step_matches_jax(shape, steps, mask_kind):
    """JAX's masked donated step against the plain step and against
    ``pool_step`` (row 5's wrapper for ``steps - 1``, then the tail), in
    place: merged words equal, JAX's settled word equal to ``~change &
    mask``."""
    rng = np.random.default_rng(steps * 131 + sum(shape))
    planes = _words(rng, shape)
    mask = _mask(rng, mask_kind, shape[0])
    out, settled = jpool._pool_step_jit(
        jnp.asarray(planes), jnp.int32(steps), jnp.asarray(mask))
    out, settled = np.asarray(out), np.asarray(settled)
    merged, change = native_pool._pool_step_plain(_t(planes), steps,
                                                  _t(mask))
    np.testing.assert_array_equal(_u32(merged), out)
    np.testing.assert_array_equal(~_u32(change) & mask, settled)
    slab = _t(planes)
    change = native_pool.pool_step(slab, steps, _t(mask))
    np.testing.assert_array_equal(_u32(slab), out)
    np.testing.assert_array_equal(~_u32(change) & mask, settled)


@pytest.mark.parametrize("lane", [0, 31, 32, 63])
def test_lane_write_and_read_match_jax(lane):
    rng = np.random.default_rng(lane)
    planes = _words(rng, (2, 9, 14))
    board = _board(rng, 14)[:9]
    plane, bit = divmod(lane, LANES_PER_PLANE)
    want = np.asarray(jpool._lane_write_jit(
        jnp.asarray(planes), jnp.asarray(board, jnp.uint32),
        jnp.int32(plane), jnp.uint32(bit)))
    slab = _t(planes)
    native_pool.pool_lane_write(slab, torch.from_numpy(board), plane, bit)
    np.testing.assert_array_equal(_u32(slab), want)
    read = native_pool.pool_lane_read(slab, plane, bit)
    jread = np.asarray(jpool._lane_read_jit(
        jnp.asarray(want), jnp.int32(plane), jnp.uint32(bit)))
    assert read.dtype == torch.uint8
    np.testing.assert_array_equal(read.numpy(), board)
    np.testing.assert_array_equal(read.numpy(), jread)
    with pytest.raises(ValueError, match="outside"):
        native_pool.pool_lane_read(slab, 2, 0)


def _counting(monkeypatch):
    """Count the calls a dispatch makes of row 5's and row 12's wrappers
    (the CPU path runs their plain versions, so the launch counts stay 0:
    the calls are what a card dispatch would launch)."""
    calls = {"bitsliced_steps": [], "pool_step_tail": 0}
    real_steps, real_tail = (native_pool.bitsliced_steps,
                             native_pool.pool_step_tail)

    def steps(planes, n, *a, **kw):
        calls["bitsliced_steps"].append(int(n))
        return real_steps(planes, n, *a, **kw)

    def tail(*a):
        calls["pool_step_tail"] += 1
        return real_tail(*a)

    monkeypatch.setattr(native_pool, "bitsliced_steps", steps)
    monkeypatch.setattr(native_pool, "pool_step_tail", tail)
    return calls


def test_a_dispatch_is_row5_for_s_minus_1_steps_then_one_tail(monkeypatch):
    rng = np.random.default_rng(3)
    tail = native_pool.pool_step_tail
    calls = _counting(monkeypatch)
    pool = SessionPool(device="cpu")
    boards = {f"s{i}": _board(rng, 20) for i in range(3)}
    for sid, b in boards.items():
        pool.create(sid, b)
    pool.step_group(list(boards), 5)
    assert calls == {"bitsliced_steps": [4], "pool_step_tail": 1}
    pool.step("s0", 1)  # no row-5 call: prev is a copy of the slab
    assert calls == {"bitsliced_steps": [4], "pool_step_tail": 2}
    assert pool.step_group(list(boards), 0) == 0
    assert calls == {"bitsliced_steps": [4], "pool_step_tail": 2}
    pool.create("q", _still_life(20))
    pool.step("q", 3)
    pool.step("q", 3)  # settled: skipped, no call at all
    assert calls == {"bitsliced_steps": [4, 2], "pool_step_tail": 3}
    assert pool.counts["settled_skips"] == 1
    assert tail.launches == native_pool.pool_lane_write.launches == 0
    for sid, b in boards.items():
        want = 6 if sid == "s0" else 5
        np.testing.assert_array_equal(pool.snapshot(sid), oracle_n(b, want))


# --------------------------------------------------- the two pools, one script


def test_stats_equal_to_jax_through_every_operation():
    """create, step, masked step_group, settled skip, evict, compact,
    spill and revive, snapshot of a spilled session: after each, the two
    pools hold the same boards and the same ``stats()``, and at the end
    the same ``pool.*`` counters and gauges."""
    rng = np.random.default_rng(23)
    metrics.reset()
    jmetrics.reset()
    pool, jp = _pools(device_budget_bytes=3 * 16 * 16 * 4)
    both = (pool, jp)
    a = {f"a{i:02d}": _board(rng) for i in range(40)}
    for sid, b in a.items():
        assert _hl(pool.create(sid, b)) == _hl(jp.create(sid, b))
    for i in range(3):
        for p in both:
            p.create(f"q{i}", _still_life(16))
    _same(pool, jp)
    assert {p.step_group(list(a), 3) for p in both} == {2}
    assert {p.step_group(["a00", "a05", "a33"], 2) for p in both} == {2}
    _same(pool, jp)
    qs = ["q0", "q1", "q2"]
    assert [p.step_group(qs, 2) for p in both] == [1, 1]
    assert [p.step_group(qs, 2) for p in both] == [0, 0]
    _same(pool, jp)
    for sid in [s for s in a if pool.handle(s).slab == 0][1:]:
        np.testing.assert_array_equal(pool.evict(sid), jp.evict(sid))
    assert pool.fragmented_shapes() == jp.fragmented_shapes() == [(16, 16)]
    assert pool.maybe_compact() == jp.maybe_compact()
    _same(pool, jp)
    for shape in ((8, 8), (20, 20), (12, 12)):
        b = (rng.random(shape) < 0.35).astype(np.uint8)
        name = f"b{shape[0]}"
        assert _hl(pool.create(name, b)) == _hl(jp.create(name, b))
        _same(pool, jp)
    assert pool.stats()["spills"] > 0
    spilled = [s for s in pool.sessions() if pool.handle(s) is None]
    assert spilled == [s for s in jp.sessions() if jp.handle(s) is None]
    for p in both:
        p.step(spilled[0], 2)
    _same(pool, jp)
    assert pool.stats()["misses"] == 1
    assert pool.slab_groups() == jp.slab_groups()
    assert ([pool.steps_applied(s) for s in pool.sessions()]
            == [jp.steps_applied(s) for s in jp.sessions()])
    ours, theirs = metrics.snapshot(), jmetrics.snapshot()
    for part in ("counters", "gauges"):
        assert ({k: v for k, v in ours[part].items() if k.startswith("pool.")}
                == {k: v for k, v in theirs[part].items()
                    if k.startswith("pool.")})


# ---------------------------------------- the JAX package's pool cases, ported


def test_create_snapshot_roundtrip_and_errors(rng):
    pool = SessionPool(device="cpu")
    boards = {f"s{i}": _board(rng) for i in range(5)}
    for sid, b in boards.items():
        h = pool.create(sid, b)
        assert isinstance(h, Handle) and 0 <= h.lane < 32
    for sid, b in boards.items():
        np.testing.assert_array_equal(pool.snapshot(sid), b)
    assert pool.stats()["slabs"] == 1
    with pytest.raises(PoolError, match="exists"):
        pool.create("s0", boards["s0"])
    with pytest.raises(PoolError, match="unknown"):
        pool.step("nope", 1)
    with pytest.raises(PoolError, match="unknown"):
        pool.snapshot("nope")
    with pytest.raises(PoolError, match="2D"):
        pool.create("flat", np.zeros(16, np.uint8))
    with pytest.raises(PoolError, match="steps"):
        pool.step("s1", -1)
    pool.evict("s0")
    pool.create("s0", boards["s0"])
    np.testing.assert_array_equal(pool.snapshot("s0"), boards["s0"])
    assert DEFAULT_DEVICE_BUDGET == jpool.DEFAULT_DEVICE_BUDGET == 64 << 20
    assert LANES_PER_PLANE == jpool.LANES_PER_PLANE
    with pytest.raises(PoolError, match="planes_per_slab"):
        SessionPool(planes_per_slab=0, device="cpu")


def test_step_group_parity_and_lane_isolation(rng):
    pool, jp = _pools()
    boards = {f"s{i:02d}": _board(rng) for i in range(40)}
    for sid, b in boards.items():
        pool.create(sid, b)
        jp.create(sid, b)
    assert pool.step_group(list(boards), 3) == jp.step_group(
        list(boards), 3) == 2
    for sid, b in boards.items():
        np.testing.assert_array_equal(pool.snapshot(sid), oracle_n(b, 3))
    pool.step("s00", 5)
    jp.step("s00", 5)
    np.testing.assert_array_equal(pool.snapshot("s00"),
                                  oracle_n(boards["s00"], 8))
    for sid in list(boards)[1:]:
        np.testing.assert_array_equal(pool.snapshot(sid),
                                      oracle_n(boards[sid], 3))
    _same(pool, jp)


def test_lone_and_group_steps_share_one_compiled_program(rng):
    """One retrace per plane shape (ROADMAP Queue 3, "What a retrace
    counts"): a full slab, a lone lane and a cross-slab subset all count
    once, and so do the lane writes and reads."""
    metrics.reset()
    pool = SessionPool(device="cpu")
    for i in range(33):  # a shape no other test uses
        pool.create(f"s{i:02d}", _board(rng, 24))
    pool.step_group([f"s{i:02d}" for i in range(33)], 2)
    pool.step("s00", 1)
    pool.step_group(["s05", "s09", "s32"], 4)
    pool.snapshot("s05")
    pool.snapshot("s32")
    assert metrics.get("jit.retrace", fn="pool_step") == 1
    assert metrics.get("jit.retrace", fn="pool_lane_write") == 1
    assert metrics.get("jit.retrace", fn="pool_lane_read") == 1


def test_compaction_drill_evict_31_of_32(rng):
    metrics.reset()
    pool, jp = _pools()
    boards = {f"s{i:02d}": _board(rng) for i in range(40)}
    for p in (pool, jp):
        for sid, b in boards.items():
            p.create(sid, b)
        p.step_group(list(boards), 2)
    assert pool.stats()["slabs"] == 2
    slab0 = [sid for sid in boards if pool.handle(sid).slab == 0]
    assert len(slab0) == 32
    survivor = slab0[0]
    for p in (pool, jp):
        for sid in slab0[1:]:
            p.evict(sid)
    before = pool.snapshot(survivor)
    assert pool.fragmented_shapes() == [(16, 16)]
    res = pool.maybe_compact()
    assert res == jp.maybe_compact()
    assert res["migrated"] >= 1 and res["slabs_freed"] >= 1
    assert pool.stats()["slabs"] == 1 and pool.fragmented_shapes() == []
    gauges = metrics.snapshot()["gauges"]
    assert gauges["pool.slabs"] == 1 and gauges["pool.lanes_live"] == 9
    np.testing.assert_array_equal(pool.snapshot(survivor), before)
    for p in (pool, jp):
        p.step(survivor, 2)
    np.testing.assert_array_equal(pool.snapshot(survivor),
                                  oracle_n(boards[survivor], 4))
    assert pool.maybe_compact() is None
    _same(pool, jp)


def test_lru_spill_and_revival_under_hard_budget(rng):
    pool, jp = _pools(device_budget_bytes=16 * 16 * 4)
    boards = {sid: _board(rng) for sid in ("a", "b", "c")}
    small = (rng.random((8, 8)) < 0.35).astype(np.uint8)
    for p in (pool, jp):
        for sid, b in boards.items():
            p.create(sid, b)
        p.create("d", small)
    st = pool.stats()
    assert st["spilled"] == 3 and st["resident"] == 1 and st["spills"] == 3
    assert pool.device_bytes() <= 16 * 16 * 4
    for sid, b in boards.items():
        np.testing.assert_array_equal(pool.snapshot(sid), b)
    assert pool.stats()["revivals"] == 0
    for p in (pool, jp):
        p.step("a", 2)
    st = pool.stats()
    assert st["revivals"] == 1 and st["misses"] == 1
    np.testing.assert_array_equal(pool.snapshot("a"), oracle_n(boards["a"], 2))
    np.testing.assert_array_equal(pool.snapshot("d"), small)
    _same(pool, jp)
    with pytest.raises(PoolError, match="budget"):
        pool.create("big", (rng.random((64, 64)) < 0.35).astype(np.uint8))


def test_wal_pool_records_roundtrip_and_compaction_carry(tmp_path, rng):
    w = wal.TicketWAL(tmp_path / "p.wal")
    b0, b1 = _board(rng), _board(rng)
    w.pool_create("alpha", b0)
    w.pool_create("beta", b1)
    w.pool_step("alpha", 2)
    w.pool_step("alpha", 3)
    w.pool_snapshot("alpha", 5)
    w.pool_evict("beta")
    w.close()
    rep = wal.replay(tmp_path / "p.wal")
    assert rep.counts()["pool_sessions"] == 1
    entry = rep.pool_sessions["alpha"]
    np.testing.assert_array_equal(entry["board"], b0)
    assert entry["steps"] == 5
    w2 = wal.TicketWAL(tmp_path / "p.wal")
    w2.compact([], pool_sessions={"alpha": entry})
    w2.pool_step("alpha", 1)
    w2.close()
    rep2 = wal.replay(tmp_path / "p.wal")
    assert rep2.pool_sessions["alpha"]["steps"] == 6
    np.testing.assert_array_equal(rep2.pool_sessions["alpha"]["board"], b0)


def test_wal_pool_record_validation(tmp_path, rng):
    w = wal.TicketWAL(tmp_path / "bad.wal")
    w.pool_create("a", _board(rng))
    w.pool_create("a", _board(rng))
    w.close()
    with pytest.raises(ValueError, match="re-creates live pool session"):
        wal.replay(tmp_path / "bad.wal")
    w = wal.TicketWAL(tmp_path / "bad2.wal")
    w.pool_step("ghost", 2)
    w.close()
    with pytest.raises(ValueError, match="unknown pool session"):
        wal.replay(tmp_path / "bad2.wal")


def _session_script(daemon, boards):
    """The JAX test's daemon script: five sessions, a ticketed step each
    through ``pump``, a direct step, an evict."""
    for sid, b in boards.items():
        daemon.create_session(sid, b)
    tickets = [daemon.submit_session(sid, 2) for sid in boards]
    daemon.pump(drain=True)
    daemon.step_session("w0", 3)
    daemon.evict_session("w4")
    daemon._wal.sync()
    return tickets


def test_daemon_resume_rematerializes_pool(tmp_path, rng):
    policy = dict(max_batch=4, max_wait_s=0.0)
    boards = {f"w{i}": _board(rng, 12) for i in range(5)}
    walp, jwalp = str(tmp_path / "d.wal"), str(tmp_path / "j.wal")
    dm = ServingDaemon(ServePolicy(**policy), wal_path=walp, device="cpu")
    jd = jserve.ServingDaemon(jserve.ServePolicy(**policy), wal_path=jwalp)
    tickets = _session_script(dm, boards)
    _session_script(jd, boards)
    assert all(t.state == DONE and t.engine == "pool:bitsliced"
               for t in tickets)
    dm2, source, detail = ServingDaemon.resume_any(
        wal_path=walp, policy=ServePolicy(**policy), device="cpu")
    jd2, _, jdetail = jserve.ServingDaemon.resume_any(
        wal_path=jwalp, policy=jserve.ServePolicy(**policy))
    assert source == "wal"
    assert detail["wal_replay"] == jdetail["wal_replay"]
    assert detail["wal_replay"]["pool_sessions"] == 4
    assert sorted(dm2.sessions()) == ["w0", "w1", "w2", "w3"]
    for sid in dm2.sessions():
        steps = 2 + (3 if sid == "w0" else 0)
        got = dm2.snapshot_session(sid)
        np.testing.assert_array_equal(got, oracle_n(boards[sid], steps))
        np.testing.assert_array_equal(got, jd2.snapshot_session(sid))
    assert dm2.summary()["pool"] == jd2.summary()["pool"]
    assert dm2.summary()["pool_sessions"] == 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_with_live_sessions_resumes_across_packages(tmp_path, rng,
                                                           writer):
    """A journal with live sessions, steps on both sides of a rotation,
    written by one package's daemon and resumed by the other's: every
    session the oracle's board and the writer's own snapshot."""
    policy = dict(max_batch=4, max_wait_s=0.0)
    walp = str(tmp_path / "x.wal")
    if writer == "jax":
        w = jserve.ServingDaemon(jserve.ServePolicy(**policy), wal_path=walp)
    else:
        w = ServingDaemon(ServePolicy(**policy), wal_path=walp, device="cpu")
    boards = {f"w{i}": _board(rng, 12) for i in range(5)}
    boards["still"] = _still_life(12)
    _session_script(w, boards)
    w._compact_wal()
    w.step_sessions(["w1", "still"], 4)
    w.submit_session("w2", 1)
    w.pump(drain=True)
    w._wal.sync()
    want = {sid: w.snapshot_session(sid) for sid in w.sessions()}
    if writer == "jax":
        r, source, _ = ServingDaemon.resume_any(
            wal_path=walp, policy=ServePolicy(**policy), device="cpu")
    else:
        r, source, _ = jserve.ServingDaemon.resume_any(
            wal_path=walp, policy=jserve.ServePolicy(**policy))
    assert source == "wal" and sorted(r.sessions()) == sorted(want)
    totals = {"w0": 5, "w1": 6, "w2": 3, "w3": 2, "still": 6}
    for sid, board in want.items():
        np.testing.assert_array_equal(
            board, oracle_n(boards[sid], totals[sid]))
        np.testing.assert_array_equal(r.snapshot_session(sid), board)


def test_submit_session_depth_gate_and_unknown(rng):
    dm = ServingDaemon(ServePolicy(max_batch=4, max_depth=2, max_wait_s=0.0),
                       device="cpu")
    with pytest.raises(ValueError, match="unknown session"):
        dm.submit_session("ghost", 1)
    for i in range(4):
        dm.create_session(f"s{i}", _board(rng, 12))
    states = [dm.submit_session(f"s{i}", 2).state for i in range(4)]
    assert states.count(PENDING) == 2 and states.count(SHED) == 2
    dm.pump(drain=True)
    for i in range(4):
        steps = 2 if states[i] == PENDING else 0
        np.testing.assert_array_equal(
            dm.snapshot_session(f"s{i}"),
            oracle_n(dm._session_log[f"s{i}"]["board"], steps))
    with pytest.raises(ValueError, match="already live"):
        dm.create_session("s0", _board(rng, 12))


def test_concurrent_steps_same_session_all_apply(rng):
    dm = ServingDaemon(ServePolicy(max_batch=8, max_wait_s=0.0),
                       device="cpu")
    b0, b1 = _board(rng, 16), _board(rng, 16)
    dm.create_session("dup", b0)
    dm.create_session("other", b1)
    tks = [dm.submit_session("dup", 3), dm.submit_session("other", 3),
           dm.submit_session("dup", 3), dm.submit_session("dup", 3)]
    dm.pump(drain=True)
    assert all(t.state == DONE for t in tks)
    np.testing.assert_array_equal(dm.snapshot_session("dup"), oracle_n(b0, 9))
    np.testing.assert_array_equal(dm.snapshot_session("other"),
                                  oracle_n(b1, 3))
    assert dm.pool.counts["dispatches"] == 3  # three waves


def test_adopt_session_replays_the_advance(tmp_path, rng):
    """The destination half of a re-home: CREATE and STEP journaled, the
    board advanced on the device; a kill at ``post-rejoin`` lands after
    both frames."""
    walp = str(tmp_path / "a.wal")
    dm = ServingDaemon(ServePolicy(max_wait_s=0.0), wal_path=walp,
                       device="cpu")
    b = _board(rng, 12)
    h = dm.adopt_session("moved", b, 5)
    assert h == Handle(0, 0) and dm.sessions() == ["moved"]
    np.testing.assert_array_equal(dm.snapshot_session("moved"),
                                  oracle_n(b, 5))
    dm._wal.sync()
    assert wal.replay(walp).pool_sessions["moved"]["steps"] == 5


# ------------------------------------------------------------- crash matrix

#: (site, k): where the injected ``os._exit(137)`` lands in the crash
#: script's pool lifecycle (4 sessions: 4 creates, 8 steps, 1 snapshot, 1
#: evict).
POOL_CRASH_CELLS = [("post-create", 3), ("post-step", 5),
                    ("post-snapshot", 1), ("post-evict", 1),
                    ("mid-frame", 6)]


def _run_driver(tmp_path, mode, chaos_spec):
    walp = str(tmp_path / "pool.wal")
    ackp = str(tmp_path / "acked.ops")
    env = {k: v for k, v in os.environ.items() if k != "MOMP_CHAOS"}
    if chaos_spec:
        env["MOMP_CHAOS"] = chaos_spec
    proc = subprocess.run(
        [sys.executable, DRIVER, walp, "every-record", ackp, "4", mode],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    acked = ([ln.split() for ln in open(ackp).read().splitlines() if ln]
             if os.path.exists(ackp) else [])
    return walp, proc, acked


def _resume_equals_oracle(walp):
    rep = wal.replay(walp)
    d, source, _ = ServingDaemon.resume_any(
        wal_path=walp, policy=ServePolicy(max_batch=4, max_wait_s=0.0),
        device="cpu")
    assert source == "wal"
    assert sorted(d.sessions()) == sorted(rep.pool_sessions)
    for sid, entry in rep.pool_sessions.items():
        np.testing.assert_array_equal(
            d.snapshot_session(sid),
            oracle_n(np.asarray(entry["board"]), int(entry["steps"])))
    return rep, d


@pytest.mark.parametrize("site,k", POOL_CRASH_CELLS)
def test_pool_crash_matrix_resume_parity(tmp_path, site, k):
    """A port daemon in a subprocess, hard-killed at each pool site under
    ``every-record``: every acked op durable (at most one journaled op
    unacked), and the resume re-materializes every surviving session to
    the oracle's board."""
    walp, proc, acked = _run_driver(tmp_path, "pool", f"crash={site}:{k}")
    assert proc.returncode == chaos.CRASH_EXIT == 137, (
        f"crash never fired: rc={proc.returncode} err={proc.stderr!r}")
    assert acked, "driver acked nothing: the cell tested nothing"
    acked_creates = {op[1] for op in acked if op[0] == "C"}
    acked_evicts = {op[1] for op in acked if op[0] == "E"}
    acked_steps: dict[str, int] = {}
    for op in acked:
        if op[0] == "S":
            acked_steps[op[1]] = acked_steps.get(op[1], 0) + int(op[2])
    rep = wal.replay(walp)
    missing = [sid for sid in acked_creates - acked_evicts
               if sid not in rep.pool_sessions]
    assert len(missing) <= 1, (site, missing)
    for sid in acked_evicts:
        assert sid not in rep.pool_sessions, (site, sid)
    for sid, steps in acked_steps.items():
        if sid in rep.pool_sessions:
            got = rep.pool_sessions[sid]["steps"]
            assert got in (steps, steps + 2), (site, sid, got, steps)
    _resume_equals_oracle(walp)


def test_pool_driver_clean_run(tmp_path):
    walp, proc, acked = _run_driver(tmp_path, "pool", None)
    assert proc.returncode == 0, proc.stderr[-800:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["sessions"] == 3 and len(acked) == 4 + 8 + 2
    rep = wal.replay(walp)
    assert sorted(rep.pool_sessions) == ["p0", "p1", "p2"]
    assert all(e["steps"] == 4 for e in rep.pool_sessions.values())


def test_settled_session_crash_resume_parity(tmp_path):
    """A kill at ``post-step`` with the settled skip engaged on the still
    life p0: the journal's STEP frames are authoritative, so the resume
    lands every session on the oracle's board at its journaled total,
    steps never dispatched before the kill included."""
    walp, proc, acked = _run_driver(tmp_path, "settled",
                                    "crash=post-step:15")
    assert proc.returncode == chaos.CRASH_EXIT == 137, proc.stderr[-800:]
    acked_p0 = sum(int(op[2]) for op in acked
                   if op[0] == "S" and op[1] == "p0")
    assert acked_p0 >= 6, "skip never got to engage"
    _, d = _resume_equals_oracle(walp)
    assert "pool_settled_skips" in d.summary()
    # The same drill without the kill: the skip did engage on p0.
    clean = tmp_path / "clean"
    clean.mkdir()
    _, proc, _ = _run_driver(clean, "settled", None)
    assert proc.returncode == 0, proc.stderr[-800:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])[
        "settled_skips"] >= 3


# ------------------------------------------------------- batcher coalescing


def test_batcher_coalesces_small_session_groups(rng):
    metrics.reset()
    pool, jp = _pools()
    boards = {f"s{i}": _board(rng, 40) for i in range(3)}
    for p in (pool, jp):
        for sid, b in boards.items():
            p.create(sid, b)
    bat = ShapeBucketBatcher(max_batch=8, device="cpu", pool=pool)
    jbat = jserve.ShapeBucketBatcher(max_batch=8, pool=jp)
    extra = _board(rng, 40)
    for b in (bat, jbat):
        t_board = b.submit(extra, 2)
        tks = [b.submit_session(sid, 2) for sid in boards]
        assert len(b) == 4 and ("slab", 0, 2) in b.bucket_keys()
    assert bat.bucket_keys() == jbat.bucket_keys()
    out, jout = bat.flush(), jbat.flush()
    assert np.array_equal(out[t_board], oracle_n(extra, 2))
    assert np.array_equal(out[t_board], np.asarray(jout[t_board]))
    assert all(out[t] is None and jout[t] is None for t in tks)
    pool_stats = [s for s in bat.last_flush_stats if s.path == "pool"]
    assert len(pool_stats) == 1 and pool_stats[0].requests == 3
    assert pool_stats[0].tickets == tuple(tks)
    _same(pool, jp)
    bat.submit_session("s0", 2)
    bat.flush()
    assert metrics.get("jit.retrace", fn="pool_step") == 1
    with pytest.raises(ValueError, match="unknown session"):
        bat.submit_session("ghost", 1)
    with pytest.raises(ValueError, match="steps"):
        bat.submit_session("s0", -1)


# ------------------------------------------------------------- settled skip


def test_settled_group_skips_dispatch():
    pool, jp = _pools()
    boards = {f"q{i}": _still_life(18) for i in range(3)}
    sids = list(boards)
    for p in (pool, jp):
        for sid, b in boards.items():
            p.create(sid, b)
        assert p.step_group(sids, 2) == 1
        assert p.counts["settled_skips"] == 0
        assert p.step_group(sids, 2) == 0
        assert p.step_group(sids, 2) == 0
    assert pool.counts["settled_skips"] == 2
    assert pool.counts["steps_applied"] == 18
    for sid, b in boards.items():
        np.testing.assert_array_equal(pool.snapshot(sid), b)
    _same(pool, jp)


def test_oscillator_never_reads_as_settled():
    pool, jp = _pools()
    for p in (pool, jp):
        p.create("osc", _blinker(18))
        for _ in range(4):
            assert p.step_group(["osc"], 2) == 1
    assert pool.counts["settled_skips"] == 0
    np.testing.assert_array_equal(pool.snapshot("osc"),
                                  oracle_n(_blinker(18), 8))
    _same(pool, jp)


def test_mixed_slab_group_never_skips():
    pool, jp = _pools()
    for p in (pool, jp):
        p.create("still", _still_life(20))
        p.create("osc", _blinker(20))
        for _ in range(3):
            assert p.step_group(["still", "osc"], 2) == 1
    assert pool.counts["settled_skips"] == 0
    np.testing.assert_array_equal(pool.snapshot("still"), _still_life(20))
    np.testing.assert_array_equal(pool.snapshot("osc"),
                                  oracle_n(_blinker(20), 6))
    _same(pool, jp)


def test_compaction_drops_a_pending_settled_word(rng):
    """A still life stepped once (its word pending), then moved by a
    compaction: the word is dropped, so its next step dispatches and
    re-proves the fixed point rather than reading another lane's bit."""
    pool, jp = _pools()
    for p in (pool, jp):
        for i in range(32):
            p.create(f"f{i:02d}", _board(np.random.default_rng(i), 16))
        p.create("still", _still_life(16))  # slab 1, lane 0
        p.step("still", 2)  # its settled word pending on slab 1
        for i in range(1, 32):
            p.evict(f"f{i:02d}")
        p.compact()  # "still" moves to the survivors' new slab
        assert p.step("still", 2) is None
    assert pool.counts["dispatches"] == 2 and pool.counts["settled_skips"] == 0
    np.testing.assert_array_equal(pool.snapshot("still"), _still_life(16))
    _same(pool, jp)


def test_program_digest_keys_the_plane_shape():
    pool = SessionPool(device="cpu")
    a, b = pool.program_digest((16, 16)), pool.program_digest((16, 24))
    assert a != b and a == pool.program_digest((16, 16)) and len(a) == 32
