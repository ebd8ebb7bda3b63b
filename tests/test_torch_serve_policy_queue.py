"""The port's serving policy, queue and watchdog backoff, held against the
JAX package's on the CPU.

The JAX package's policy and queue cases (``tests/test_serve_daemon.py``)
run again on the port: padding-waste math, admission order, percentiles,
validation, deadlines and chunk order, the snapshot round trip and its
queued seconds. Then the two packages side by side on seeded inputs:
``padding_waste``, ``admit``, ``due_chunks`` and the pad widths equal; a
drain checkpoint written by either package's queue restores in the other
to the same pending tickets; ``watchdog.backoff_schedule`` equal for seeds
0-3 with jitter; the fleet's ``rollup`` and elastic controller equal on
seeded signals. Host code only: no kernel, no torch tensor.
"""

import itertools

import numpy as np
import pytest

from mpi_and_open_mp_tpu.robust import watchdog as jwatchdog
from mpi_and_open_mp_tpu.serve import policy as jpolicy
from mpi_and_open_mp_tpu.serve import queue as jqueue
from mpi_and_open_mp_tpu.serve.batcher import bucket_batch_size as jbbs
from mpi_and_open_mp_tpu.utils import checkpoint as jcheckpoint

from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.robust import watchdog
from mpi_and_open_mp_tpu_torch.serve import (
    SHED_REASONS, ServePolicy, ServeQueue, bucket_batch_size)
from mpi_and_open_mp_tpu_torch.serve import policy as policy_mod
from mpi_and_open_mp_tpu_torch.serve.queue import (
    DONE, PENDING, SHED, STATE_SCHEMA)
from mpi_and_open_mp_tpu_torch.utils import checkpoint


def _board(rng, ny, nx):
    return (rng.random((ny, nx)) < 0.35).astype(np.uint8)


# ------------------------------------------------------------------ policy


def test_padding_waste_math():
    pw = policy_mod.padding_waste
    assert pw([], 8) == 0.0
    assert pw([8], 8) == 0.0  # a full chunk wastes nothing
    assert pw([3], 8) == pytest.approx(1 / 4)  # 3 live in a pow2-4 pad
    assert pw([5], 8) == pytest.approx(3 / 8)
    # 11 = one full 8-chunk + a 3-remainder padded to 4.
    assert pw([11], 8) == pytest.approx(1 / 12)
    assert pw([8, 3], 8) == pytest.approx(1 / 12)  # two buckets, same sum
    # A board-sliced bucket counts in planes, fully live.
    assert pw([(9, 32)], 64) == 0.0


def test_admit_depth_then_padding():
    pol = ServePolicy(max_batch=8, max_depth=4, max_padding_frac=0.2)
    assert policy_mod.admit(pol, 0, [1]) is None
    assert policy_mod.admit(pol, 4, [5]) == policy_mod.SHED_DEPTH
    # 3 pending in one bucket pads to 4: waste 0.25 > 0.2.
    assert policy_mod.admit(pol, 2, [3]) == policy_mod.SHED_PADDING


def test_percentile_nearest_rank():
    pct = policy_mod.percentile
    assert pct([], 99) == 0.0
    xs = [float(i) for i in range(1, 101)]
    assert pct(xs, 50) == 50.0
    assert pct(xs, 99) == 99.0
    assert pct(xs, 100) == 100.0
    assert pct([7.0], 99) == 7.0


def test_policy_validation():
    with pytest.raises(ValueError, match="max_batch"):
        ServePolicy(max_batch=0)
    with pytest.raises(ValueError, match="max_padding_frac"):
        ServePolicy(max_padding_frac=1.5)
    with pytest.raises(ValueError, match="max_wait_s"):
        ServePolicy(max_wait_s=-1.0)
    with pytest.raises(ValueError, match="max_workers"):
        policy_mod.ElasticityPolicy(min_workers=3, max_workers=2)


def _mix(rng):
    """A seeded bucket mix: plain counts and (count, width) pairs."""
    out = []
    for _ in range(int(rng.integers(0, 6))):
        r = int(rng.integers(0, 80))
        kind = int(rng.integers(0, 3))
        out.append(r if kind == 0 else (r, None if kind == 1 else 32))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_padding_waste_and_admit_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        mix = _mix(rng)
        mb = int(rng.choice([1, 4, 8, 32, 64]))
        assert policy_mod.padding_waste(mix, mb) == jpolicy.padding_waste(
            mix, mb), (mix, mb)
        kw = dict(max_batch=mb, max_depth=int(rng.integers(1, 40)),
                  max_padding_frac=float(rng.random()))
        depth = int(rng.integers(0, 40))
        assert policy_mod.admit(ServePolicy(**kw), depth, mix) \
            == jpolicy.admit(jpolicy.ServePolicy(**kw), depth, mix)
        n = int(rng.integers(1, 100))
        for width in (None, 32):
            assert bucket_batch_size(n, mb, width) == jbbs(n, mb, width)


def test_rollup_depth_adds_per_request_knobs_take_min():
    a = dict(max_batch=4, max_depth=10, max_padding_frac=0.5,
             max_wait_s=0.1, request_timeout_s=5.0, max_retries=3,
             backoff_base_s=0.1, backoff_cap_s=2.0)
    b = dict(max_batch=8, max_depth=6, max_padding_frac=0.25,
             max_wait_s=0.2, request_timeout_s=9.0, max_retries=1,
             backoff_base_s=0.05, backoff_cap_s=4.0)
    r = policy_mod.rollup([ServePolicy(**a), ServePolicy(**b)])
    assert r.max_depth == 16 and r.max_batch == 8
    assert r.max_padding_frac == 0.25 and r.max_wait_s == 0.1
    assert r.request_timeout_s == 5.0 and r.max_retries == 1
    assert r.backoff_base_s == 0.05 and r.backoff_cap_s == 2.0
    j = jpolicy.rollup([jpolicy.ServePolicy(**a), jpolicy.ServePolicy(**b)])
    assert vars(r) == vars(j)
    with pytest.raises(ValueError, match="at least one"):
        policy_mod.rollup([])


@pytest.mark.parametrize("seed", range(2))
def test_elastic_controller_equals_jax(seed):
    """Seeded signal windows through both controllers: the same verdicts,
    streaks and cooldowns window by window."""
    rng = np.random.default_rng(seed)
    kw = dict(slo_p99_s=0.1, min_workers=1, max_workers=4, breach_k=2,
              surplus_k=3, cooldown_k=2)
    ours = policy_mod.ElasticController(policy_mod.ElasticityPolicy(**kw))
    theirs = jpolicy.ElasticController(jpolicy.ElasticityPolicy(**kw))
    workers = 2
    for _ in range(200):
        obs = dict(p99_s=float(rng.choice([0.0, 0.02, 0.08, 0.5])),
                   depth=int(rng.choice([0, 0, 3, 50])), workers=workers)
        if rng.random() < 0.3:
            obs.update(goodput_rps=float(rng.integers(0, 50)),
                       offered_rps=float(rng.integers(0, 50)))
        v = ours.observe(**obs)
        assert v == theirs.observe(**obs)
        assert (ours.breach_streak, ours.surplus_streak, ours.cooldown) \
            == (theirs.breach_streak, theirs.surplus_streak,
                theirs.cooldown)
        workers += {policy_mod.SCALE_ADD: 1, policy_mod.SCALE_DRAIN: -1}.get(
            v, 0)
    assert ours.actions == theirs.actions and ours.actions


def test_elastic_controller_cannot_flap():
    c = policy_mod.ElasticController(policy_mod.ElasticityPolicy(
        slo_p99_s=0.1, breach_k=3, surplus_k=3, cooldown_k=2))
    for i in range(40):  # alternating breach and surplus windows
        v = (c.observe(p99_s=0.5, depth=9, workers=2) if i % 2
             else c.observe(p99_s=0.0, depth=0, workers=2))
        assert v is None
    assert c.actions == []


# ---------------------------------------------------------------- watchdog


@pytest.mark.parametrize("seed", range(4))
def test_backoff_schedule_equals_jax(seed):
    """The same seed gives the same waits to the bit in both packages."""
    for base, cap, jitter in ((0.05, 1.0, 0.5), (2.0, 60.0, 0.25),
                              (1.0, 8.0, 1.0)):
        ours = watchdog.backoff_schedule(12, base, cap, jitter=jitter,
                                         seed=seed)
        assert ours == jwatchdog.backoff_schedule(12, base, cap,
                                                  jitter=jitter, seed=seed)
        gen = watchdog.backoff(base, cap, jitter=jitter, seed=seed)
        assert list(itertools.islice(gen, 12)) == ours
    assert watchdog.backoff_schedule(5, base_s=2.0, cap_s=10.0) == [
        2.0, 4.0, 8.0, 10.0, 10.0]
    with pytest.raises(ValueError, match="jitter"):
        next(watchdog.backoff(jitter=1.5))


def test_probe_devices_backs_off_then_degrades_or_succeeds():
    probes, slept = [], []

    def probe(timeout_s):
        probes.append(timeout_s)
        return False, "still wedged"

    res = watchdog.probe_devices(3.0, attempts=3, backoff_s=2.0, cap_s=60.0,
                                 probe=probe, sleep=slept.append)
    assert not res.ok and res.degraded and res.attempts == 3
    assert probes == [3.0] * 3 and slept == [2.0, 4.0]
    assert res.waited_s == 6.0 and res.why == "still wedged"

    flips = iter([(False, "once"), (True, "")])
    slept = []
    res = watchdog.probe_devices(1.0, attempts=4, probe=lambda t: next(flips),
                                 sleep=slept.append)
    assert res.ok and not res.degraded and res.attempts == 2
    assert len(slept) == 1


def test_probe_once_reports_discovery():
    """A real child process: on a machine without a card it fails with a
    note, never hangs the caller; with one it succeeds."""
    import torch

    ok, why = watchdog.probe_once(120.0)
    assert ok == torch.cuda.is_available()
    assert (why == "") == ok


# ------------------------------------------------------------------- queue


def test_queue_admission_sheds_with_reason(rng):
    q = ServeQueue(ServePolicy(max_batch=8, max_depth=2))
    t0 = q.submit(_board(rng, 16, 16), 2, now=0.0)
    t1 = q.submit(_board(rng, 16, 16), 2, now=0.0)
    t2 = q.submit(_board(rng, 16, 16), 2, now=0.0)
    assert t0.state == t1.state == PENDING
    assert t2.state == SHED and t2.reason == policy_mod.SHED_DEPTH
    assert q.depth() == 2 and len(q.tickets()) == 3
    with pytest.raises(ValueError, match="unknown shed reason"):
        q.shed_ticket(t0, "bored", 0.0)
    assert set(SHED_REASONS) >= {t2.reason}


def test_queue_rejects_bad_requests(rng):
    q = ServeQueue()
    with pytest.raises(ValueError, match="2D"):
        q.submit(np.zeros((2, 8, 8), np.uint8), 1, now=0.0)
    with pytest.raises(ValueError, match="steps"):
        q.submit(_board(rng, 8, 8), -1, now=0.0)
    with pytest.raises(ValueError, match="unknown|registered|stencil"):
        q.submit(_board(rng, 8, 8), 1, now=0.0, workload="no-such-rule")


def test_queue_deadline_and_chunk_order(rng):
    """A full chunk is always due; a remainder waits for max_wait; chunks
    come out oldest lead ticket first across interleaved buckets."""
    q = ServeQueue(ServePolicy(max_batch=4, max_wait_s=1.0))
    q.submit(_board(rng, 8, 8), 2, now=0.0)  # ticket 0: the starved bucket
    for _ in range(4):  # tickets 1-4: a full chunk of the other shape
        q.submit(_board(rng, 16, 16), 2, now=0.5)
    assert [len(c) for c in q.due_chunks(now=0.6)] == [4]
    assert q.next_deadline() == 1.0
    chunks = q.due_chunks(now=1.0)
    assert [[t.id for t in c] for c in chunks] == [[0], [1, 2, 3, 4]]
    assert q.due_chunks(now=0.0, drain=True)  # drain ignores deadlines


def test_queue_snapshot_restore_roundtrip_and_rejects_foreign(rng):
    q = ServeQueue(ServePolicy())
    boards = [_board(rng, 12, 12) for _ in range(3)]
    for b in boards:
        q.submit(b, 5, now=0.0)
    snap = q.snapshot()
    q2 = ServeQueue(ServePolicy())
    restored = q2.restore(snap, now=7.0)
    assert [t.steps for t in restored] == [5, 5, 5]
    assert all(t.resumed and t.submitted_at == 7.0 for t in restored)
    for t, b in zip(restored, boards):
        np.testing.assert_array_equal(t.board, b)
    with pytest.raises(ValueError, match="schema"):
        q2.restore({"schema": "something-else"}, now=0.0)
    with pytest.raises(ValueError, match="malformed"):
        q2.restore({"schema": STATE_SCHEMA, "pending": [{"id": 1}]},
                   now=0.0)


def test_queue_snapshot_carries_queued_seconds(rng):
    """A ticket queued 3 s before the drain keeps counting from its first
    submission after the restore, across a second drain too."""
    q = ServeQueue(ServePolicy())
    q.submit(_board(rng, 8, 8), 1, now=10.0)
    snap = q.snapshot(now=13.0)
    assert snap["pending"][0]["queued_s"] == pytest.approx(3.0)
    q2 = ServeQueue(ServePolicy())
    (t,) = q2.restore(snap, now=0.0)
    assert t.queued_before_s == pytest.approx(3.0)
    q2.resolve(t, t.board, "oracle", now=2.0)
    assert t.state == DONE and t.latency_s == pytest.approx(5.0)
    q2._tickets.clear()
    q2.restore(snap, now=5.0)
    assert q2.snapshot(now=9.0)["pending"][0]["queued_s"] \
        == pytest.approx(7.0)


def _seeded_burst(seed):
    """(board, steps, now, workload) requests of mixed shapes, steps and
    rules, submission times rising."""
    rng = np.random.default_rng(seed)
    shapes = [(16, 16), (24, 16), (48, 48), (12, 20)]
    out, now = [], 0.0
    for _ in range(int(rng.integers(10, 40))):
        workload = str(rng.choice(["life", "life", "heat", "wireworld"]))
        spec = stencils.get(workload)
        shape = shapes[int(rng.integers(0, len(shapes)))]
        out.append((spec.init(rng, shape), int(rng.integers(1, 4)), now,
                    workload))
        now += float(rng.random() * 0.01)
    return out


def _twin_queues(seed):
    kw = dict(max_batch=4, max_depth=25, max_padding_frac=0.6,
              max_wait_s=0.02)
    ours, theirs = ServeQueue(ServePolicy(**kw)), jqueue.ServeQueue(
        jpolicy.ServePolicy(**kw))
    for board, steps, now, workload in _seeded_burst(seed):
        a = ours.submit(board, steps, now, workload=workload)
        b = theirs.submit(board, steps, now, workload=workload)
        assert (a.id, a.state, a.reason, a.bucket_key) \
            == (b.id, b.state, b.reason, b.bucket_key)
        assert ours._slice_width(a.bucket_key) \
            == theirs._slice_width(b.bucket_key)
    return ours, theirs


@pytest.mark.parametrize("seed", range(4))
def test_admission_and_due_chunks_equal_jax(seed):
    ours, theirs = _twin_queues(seed)
    assert ours.depth() == theirs.depth()
    assert ours.next_deadline() == theirs.next_deadline()
    for now in (0.0, 0.01, 0.05, 1.0):
        assert [[t.id for t in c] for c in ours.due_chunks(now)] \
            == [[t.id for t in c] for c in theirs.due_chunks(now)]
    assert [[t.id for t in c] for c in ours.due_chunks(0.0, drain=True)] \
        == [[t.id for t in c] for c in theirs.due_chunks(0.0, drain=True)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_drain_checkpoint_restores_across_packages(tmp_path, writer):
    """A drain checkpoint written through either package's ``save_state``
    restores in the other to the same pending tickets."""
    ours, theirs = _twin_queues(7)
    path = str(tmp_path / "serve_queue.state")
    if writer == "jax":
        jcheckpoint.save_state(path, theirs.snapshot(now=3.0))
        restored = ServeQueue().restore(checkpoint.restore_state(path),
                                        now=0.0)
        source = theirs
    else:
        checkpoint.save_state(path, ours.snapshot(now=3.0))
        restored = jqueue.ServeQueue().restore(
            jcheckpoint.restore_state(path), now=0.0)
        source = ours
    pending = source.pending()
    assert len(restored) == len(pending) > 0
    for got, want in zip(restored, pending):
        assert (got.steps, got.workload, got.session) \
            == (want.steps, want.workload, want.session)
        assert got.queued_before_s == pytest.approx(3.0 - want.submitted_at)
        assert got.board.dtype == want.board.dtype
        np.testing.assert_array_equal(got.board, want.board)
