"""The port's serving daemon, held against the JAX package's on the CPU.

One seeded burst (48x48, 64x64 and 95x130 Life boards at 4 and 8 steps, a
heat bucket and a wireworld bucket, ``max_batch`` 8) goes through both
daemons under a fake clock: every ticket's state, result (Life and
wireworld to the bit, heat within ``parity_tol_for("offset")``) and shed
reason, and ``summary()`` less its latencies, are equal, the stamps mapped
(JAX's ``batch:xla`` is the port's ``batch:plain``, its
``batch:stencil-pallas:<name>`` the port's ``batch:stencil-native:<name>``).
The same under ``serve_fail=1``, under ``preempt=2`` then a checkpoint
resume, under timeout shedding, and under retry exhaustion. Then the JAX
package's own daemon cases on the port, its CLI's exit 75 and ``--resume
--verify`` in this process, and the Life CLI's ``--serve`` against the JAX
CLI's boards. Small boards, one torch thread.
"""

import glob
import json

import numpy as np
import pytest
import torch

from conftest import oracle_n
from mpi_and_open_mp_tpu.apps import life as jlife_app
from mpi_and_open_mp_tpu import serve as jserve
from mpi_and_open_mp_tpu.robust import chaos as jchaos
from mpi_and_open_mp_tpu.robust import guards as jguards
from mpi_and_open_mp_tpu.robust import preempt as jpreempt

from mpi_and_open_mp_tpu_torch import serve as tserve
from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.apps import life as life_app
from mpi_and_open_mp_tpu_torch.robust import chaos, guards, preempt
from mpi_and_open_mp_tpu_torch.serve import (
    SHED_REASONS, ServePolicy, ServingDaemon)
from mpi_and_open_mp_tpu_torch.serve import daemon as daemon_cli
from mpi_and_open_mp_tpu_torch.serve import policy as policy_mod
from mpi_and_open_mp_tpu_torch.serve.queue import DONE, SHED

GLIDER = "tests/fixtures/glider_10x10.cfg"

#: The JAX package's stamps, in the port's vocabulary.
STAMPS = (("batch:xla", "batch:plain"),
          ("batch:stencil-pallas:", "batch:stencil-native:"))


def port_stamp(stamp: str | None) -> str | None:
    if stamp is None:
        return None
    for jax_name, port_name in STAMPS:
        stamp = stamp.replace(jax_name, port_name)
    return stamp


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.delenv("MOMP_CHAOS", raising=False)
    for mod in (chaos, jchaos):
        mod.reset()
    guards.reset_recovery_log()
    jguards.clear_recovery_log()
    yield
    for mod in (chaos, jchaos):
        mod.reset()
    guards.reset_recovery_log()
    jguards.clear_recovery_log()


def _set_chaos(monkeypatch, spec):
    if spec:
        monkeypatch.setenv("MOMP_CHAOS", spec)
    else:
        monkeypatch.delenv("MOMP_CHAOS", raising=False)
    chaos.reset()
    jchaos.reset()


class FakeClock:
    """Deterministic monotonic clock; ``sleep`` advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _daemon(policy, clk=None, **kw) -> tuple[ServingDaemon, FakeClock]:
    clk = clk or FakeClock()
    return ServingDaemon(policy, clock=clk, sleep=clk.sleep, device="cpu",
                         **kw), clk


# ------------------------------------------------- the two daemons, one burst


#: Life buckets of the burst: (shape, steps, tickets). 12 tickets make a
#: full board-sliced chunk of 8 and a remainder of 4.
LIFE_BUCKETS = (((48, 48), 4, 12), ((64, 64), 8, 4), ((95, 130), 4, 4),
                ((95, 130), 8, 2))
N_BURST = sum(n for _, _, n in LIFE_BUCKETS) + 8


def _burst(seed=22):
    """(board, steps, workload): Life boards of three shapes at 4 and 8
    steps, a heat bucket and a wireworld bucket, in a seeded order."""
    rng = np.random.default_rng(seed)
    life = stencils.get("life")
    reqs = [(life.init(rng, shape), steps, "life")
            for shape, steps, n in LIFE_BUCKETS for _ in range(n)]
    reqs += [(stencils.get("heat").init(rng, (48, 48)), 4, "heat")
             for _ in range(4)]
    reqs += [(stencils.get("wireworld").init(rng, (64, 64)), 8, "wireworld")
             for _ in range(4)]
    order = rng.permutation(len(reqs))
    return [reqs[i] for i in order]


POLICY = dict(max_batch=8, max_depth=64, max_padding_frac=0.9,
              max_wait_s=0.05)


def _pair(policy=POLICY, **kw):
    """A port daemon and a JAX daemon, each on its own fake clock."""
    ca, cb = FakeClock(), FakeClock()
    ours = ServingDaemon(ServePolicy(**policy), clock=ca, sleep=ca.sleep,
                         device="cpu", **kw.get("ours", {}))
    theirs = jserve.ServingDaemon(jserve.ServePolicy(**policy), clock=cb,
                                  sleep=cb.sleep, **kw.get("theirs", {}))
    return (ours, ca), (theirs, cb)


def _submit_both(ours, theirs, reqs):
    for board, steps, workload in reqs:
        a = ours.submit(board, steps, workload=workload)
        b = theirs.submit(board, steps, workload=workload)
        assert (a.id, a.state, a.reason) == (b.id, b.state, b.reason)


def _held_equal(ours, theirs):
    """Every ticket and the summary (latencies aside) equal."""
    ta, tb = ours.queue.tickets(), theirs.queue.tickets()
    assert len(ta) == len(tb)
    for a, b in zip(ta, tb):
        assert (a.id, a.state, a.reason, a.steps, a.workload) \
            == (b.id, b.state, b.reason, b.steps, b.workload)
        assert a.engine == port_stamp(b.engine), (a.id, a.engine, b.engine)
        np.testing.assert_array_equal(a.board, np.asarray(b.board))
        if a.state != DONE:
            continue
        spec = stencils.get(a.workload)
        if spec.is_float:
            assert stencils.parity_ok(
                spec, a.result, np.asarray(b.result),
                **stencils.parity_tol_for("offset")), a.id
        else:
            np.testing.assert_array_equal(a.result, np.asarray(b.result))
    sa, sb = ours.summary(), theirs.summary()
    skip = ("p50_latency_s", "p99_latency_s", "cold_first_result_s")
    sb["engines"] = {port_stamp(k): v for k, v in sb["engines"].items()}
    assert {k: v for k, v in sa.items() if k not in skip} \
        == {k: v for k, v in sb.items() if k not in skip}
    return sa


@pytest.mark.parametrize("chaos_spec", [None, "serve_fail=1"])
def test_burst_equals_jax_daemon(monkeypatch, chaos_spec):
    _set_chaos(monkeypatch, chaos_spec)
    (ours, ca), (theirs, cb) = _pair()
    _submit_both(ours, theirs, _burst())
    ours.serve(watch_signals=False)
    theirs.serve(watch_signals=False)
    s = _held_equal(ours, theirs)
    assert s["resolved"] == N_BURST and s["shed"] == 0
    assert ca.t == cb.t  # the same deadlines slept
    if chaos_spec:
        assert s["degraded"] == 1
        assert [port_stamp(x) for x in jguards.recovery_log()] \
            == guards.recovery_log()
        (stamp,) = [e for e in s["engines"] if e.endswith(":recovered")]
        assert stamp.startswith(("batch:plain", "batch:stencil-native:"))
    else:
        assert set(s["engines"]) == {
            "batch:bitsliced", "batch:plain", "batch:stencil:heat",
            "batch:stencil:wireworld"}


def test_burst_preempt_then_checkpoint_resume_equals_jax(monkeypatch,
                                                          tmp_path):
    """preempt=2: both daemons drain after two batches and checkpoint the
    same pending set; each resumes from the OTHER package's checkpoint and
    the resumed books are equal, every result the oracle's."""
    _set_chaos(monkeypatch, "preempt=2")
    ck_ours, ck_theirs = str(tmp_path / "ours.state"), str(
        tmp_path / "theirs.state")
    (ours, ca), (theirs, cb) = _pair(
        ours={"checkpoint_path": ck_ours},
        theirs={"checkpoint_path": ck_theirs})
    reqs = _burst()
    _submit_both(ours, theirs, reqs)
    with pytest.raises(preempt.SimulatedPreemption) as ea:
        ours.serve(watch_signals=False)
    with pytest.raises(jpreempt.SimulatedPreemption) as eb:
        theirs.serve(watch_signals=False)
    assert ea.value.step == eb.value.step == 2
    _held_equal(ours, theirs)
    assert 0 < ours.queue.depth() == theirs.queue.depth() < N_BURST

    _set_chaos(monkeypatch, None)
    r_ours = ServingDaemon.resume(ck_theirs, ServePolicy(**POLICY),
                                  clock=ca, sleep=ca.sleep, device="cpu")
    r_theirs = jserve.ServingDaemon.resume(
        ck_ours, jserve.ServePolicy(**POLICY), clock=cb, sleep=cb.sleep)
    assert all(t.resumed for t in r_ours.queue.pending())
    r_ours.serve(watch_signals=False)
    r_theirs.serve(watch_signals=False)
    s = _held_equal(r_ours, r_theirs)
    assert s["resolved"] + ours.summary()["resolved"] == N_BURST
    for t in r_ours.queue.tickets():
        spec = stencils.get(t.workload)
        want = stencils.oracle_run(spec, t.board, t.steps)
        assert stencils.parity_ok(spec, t.result, want,
                                  **stencils.parity_tol_for("offset"))


def test_burst_timeout_shedding_equals_jax(monkeypatch):
    """A request budget shorter than the bucket deadline: full chunks
    resolve at once, every remainder sheds ``timeout`` at its dispatch,
    in both daemons alike."""
    pol = dict(POLICY, request_timeout_s=0.01)
    (ours, _), (theirs, _) = _pair(pol)
    _submit_both(ours, theirs, _burst())
    ours.serve(watch_signals=False)
    theirs.serve(watch_signals=False)
    s = _held_equal(ours, theirs)
    assert s["resolved"] > 0
    assert s["shed_reasons"] == {policy_mod.SHED_TIMEOUT: s["shed"]} \
        and s["shed"] > 0


def test_burst_retry_exhaustion_equals_jax(monkeypatch):
    """Every engine failing: both daemons retry behind the same seeded
    backoff (the fake clocks end equal), then shed ``dispatch-failed``."""
    pol = dict(POLICY, max_retries=2, backoff_base_s=0.01,
               backoff_jitter=0.5, request_timeout_s=100.0)
    (ours, ca), (theirs, cb) = _pair(pol)

    def boom():
        raise RuntimeError("wedged engine")

    for d in (ours, theirs):
        d._engines = lambda stack, steps, spec=None: [("a", boom),
                                                      ("b", boom)]
    _submit_both(ours, theirs, _burst()[:12])
    ours.serve(watch_signals=False)
    theirs.serve(watch_signals=False)
    s = _held_equal(ours, theirs)
    assert s["resolved"] == 0 and s["shed"] == 12
    assert s["shed_reasons"] == {policy_mod.SHED_DISPATCH: 12}
    # Each chunk: max_retries waits, then the exhausted attempt sheds.
    assert s["retries"] > 0 and s["retries"] % 3 == 0
    assert ca.t == cb.t > 0


# ------------------------------------------------------------ chaos hooks


@pytest.mark.parametrize("spec", [
    "serve_fail=3", "crash=post-admit:2", "crash=mid-frame:1",
    "crash=post-dispatch:3", "kill_worker=1:2", "serve_fail=1;seed=4"])
def test_serve_chaos_hooks_count_as_jax(monkeypatch, spec):
    """The serving hooks' verdicts and hit counters, call by call, equal to
    the JAX package's; inside ``suppressed()`` neither counts."""
    _set_chaos(monkeypatch, spec)
    calls = [("take_serve_fault", ()), ("crash_armed", ("post-admit",)),
             ("crash_armed", ("mid-frame",)),
             ("crash_armed", ("post-dispatch",)),
             ("kill_worker_armed", (1,)), ("kill_worker_armed", (None,)),
             ("kill_worker_armed", (0,))]
    rng = np.random.default_rng(len(spec))
    for i in rng.integers(0, len(calls), size=40):
        name, args = calls[int(i)]
        assert getattr(chaos, name)(*args) == getattr(jchaos, name)(*args)
    ours, theirs = chaos.active_plan(), jchaos.active_plan()
    for field in ("serve_failed", "crash_hits", "kill_worker_hits"):
        assert getattr(ours, field) == getattr(theirs, field), field
    with chaos.suppressed():
        assert not chaos.take_serve_fault()
        assert not chaos.crash_armed("post-admit")
    assert chaos.CRASH_EXIT == jchaos.CRASH_EXIT == 137


# --------------------------------------------------- the JAX package's cases


def test_daemon_zero_requests_noop():
    d, _ = _daemon(ServePolicy())
    d.serve()
    assert d.pump() == 0
    s = d.summary()
    assert s["requests"] == s["resolved"] == s["shed"] == s["batches"] == 0
    assert s["p50_latency_s"] == s["p99_latency_s"] == 0.0


def test_daemon_never_full_bucket_flushes_at_max_wait(make_board):
    d, clk = _daemon(ServePolicy(max_batch=8, max_wait_s=0.5))
    boards = [make_board(16, 16) for _ in range(3)]
    for b in boards:
        d.submit(b, 4)
    assert d.pump() == 0  # not due yet
    d.serve()
    assert clk.t >= 0.5
    s = d.summary()
    assert s["resolved"] == 3 and s["shed"] == 0 and s["batches"] == 1
    for t, b in zip(d.queue.tickets(), boards):
        assert t.state == DONE and t.engine == "batch:plain"
        np.testing.assert_array_equal(t.result, oracle_n(b, 4))
    assert s["p99_latency_s"] >= 0.5


def test_daemon_ticket_order_stable_under_interleaved_buckets(make_board):
    d, _ = _daemon(ServePolicy(max_batch=4, max_wait_s=0.0))
    shapes = [(16, 16), (24, 16), (16, 16), (24, 16)]
    subs = []
    for i in range(12):
        b = make_board(*shapes[i % len(shapes)])
        steps = (i % 3) + 1
        subs.append((b, steps, d.submit(b, steps)))
    d.drain()
    assert [t.id for t in d.queue.tickets()] == list(range(12))
    for b, steps, t in subs:
        assert t.state == DONE
        np.testing.assert_array_equal(t.result, oracle_n(b, steps))


def test_daemon_degrades_on_chaos_fault_with_provenance(monkeypatch,
                                                        make_board):
    _set_chaos(monkeypatch, "serve_fail=1")
    d, _ = _daemon(ServePolicy(max_batch=4, max_wait_s=0.0))
    boards = [make_board(16, 16) for _ in range(4)]
    for b in boards:
        d.submit(b, 3)
    d.serve()
    s = d.summary()
    assert s["resolved"] == 4 and s["degraded"] == 1 and s["retries"] == 0
    assert list(s["engines"]) == ["batch:plain:recovered"]
    assert guards.recovery_log() == ["serve:batch:plain:recovered"]
    for t, b in zip(d.queue.tickets(), boards):
        np.testing.assert_array_equal(t.result, oracle_n(b, 3))


def test_cpu_ladders():
    """The CPU ladders: JAX's, with the port's stamps; the oracle last."""
    d, _ = _daemon(ServePolicy(max_batch=8))
    stack = np.zeros((8, 16, 16), np.uint8)
    assert [n for n, _ in d._engines(stack, 1)] == [
        "batch:bitsliced", "batch:plain", "oracle"]
    assert [n for n, _ in d._engines(stack[:4], 1)] == [
        "batch:plain", "batch:plain", "oracle"]
    heat = stencils.get("heat")
    assert [n for n, _ in d._engines(stack.astype(np.float32), 1, heat)] \
        == ["batch:stencil:heat", "batch:stencil-native:heat", "oracle"]


def test_shape_without_a_kernel_sheds_instead_of_stopping(monkeypatch,
                                                          make_board):
    """A shape the dispatch cannot place (``native_path_batch`` raises, as
    it does on the card past every kernel's gate) is a failing rung: the
    chunk retries and sheds ``dispatch-failed``, the daemon serves on."""
    from mpi_and_open_mp_tpu_torch.ops import native_life

    real = native_life.native_path_batch

    def picky(shape, **kw):
        if tuple(shape[1:]) == (8, 8):
            raise ValueError("no kernel covers a (8, 8) board")
        return real(shape, **kw)

    monkeypatch.setattr(native_life, "native_path_batch", picky)
    d, _ = _daemon(ServePolicy(max_batch=4, max_wait_s=0.0, max_retries=1,
                               backoff_jitter=0.0))
    bad = d.submit(make_board(8, 8), 1)
    good = d.submit(make_board(16, 16), 1)
    d.serve()
    assert bad.state == SHED and bad.reason == policy_mod.SHED_DISPATCH
    assert good.state == DONE


def test_daemon_retry_exhaustion_sheds_dispatch_failed(make_board):
    d, _ = _daemon(ServePolicy(
        max_batch=4, max_wait_s=0.0, max_retries=1, backoff_base_s=0.01,
        backoff_jitter=0.0, request_timeout_s=100.0))

    def boom():
        raise RuntimeError("wedged engine")

    d._engines = lambda stack, steps: [("a", boom), ("b", boom)]
    tickets = [d.submit(make_board(8, 8), 1) for _ in range(2)]
    d.serve()
    s = d.summary()
    assert s["resolved"] == 0 and s["shed"] == 2
    assert s["shed_reasons"] == {policy_mod.SHED_DISPATCH: 2}
    assert s["retries"] == 2
    assert all(t.reason == policy_mod.SHED_DISPATCH for t in tickets)


def test_daemon_timeout_during_backoff_sheds_timeout(make_board):
    d, _ = _daemon(ServePolicy(
        max_batch=4, max_wait_s=0.0, max_retries=5, backoff_base_s=5.0,
        backoff_jitter=0.0, request_timeout_s=1.0))

    def boom():
        raise RuntimeError("still wedged")

    d._engines = lambda stack, steps: [("a", boom)]
    t = d.submit(make_board(8, 8), 1)
    d.serve()
    assert t.state == SHED and t.reason == policy_mod.SHED_TIMEOUT


def test_daemon_sheds_stale_tickets_before_dispatch(make_board):
    d, clk = _daemon(ServePolicy(max_wait_s=0.0, request_timeout_s=1.0))
    t = d.submit(make_board(8, 8), 1)
    clk.t = 5.0
    d.serve()
    assert t.state == SHED and t.reason == policy_mod.SHED_TIMEOUT
    assert d.summary()["batches"] == 0


def test_chaos_preempt_checkpoint_resume_zero_loss(monkeypatch, tmp_path,
                                                   make_board):
    _set_chaos(monkeypatch, "preempt=1")
    ck = tmp_path / "queue.state"
    pol = ServePolicy(max_batch=4, max_wait_s=0.0)
    d, clk = _daemon(pol, checkpoint_path=str(ck))
    boards = [make_board(16, 16) for _ in range(12)]
    for b in boards:
        d.submit(b, 2)
    with pytest.raises(preempt.SimulatedPreemption) as ei:
        d.serve()
    assert ei.value.step == 1 and ei.value.checkpoint == str(ck)
    assert d.summary()["resolved"] == 4 and d.queue.depth() == 8
    _set_chaos(monkeypatch, None)
    d2 = ServingDaemon.resume(str(ck), pol, clock=clk, sleep=clk.sleep,
                              device="cpu")
    assert d2.queue.depth() == 8
    assert all(t.resumed for t in d2.queue.pending())
    d2.serve()
    s2 = d2.summary()
    assert s2["resolved"] == 8 and s2["shed"] == 0
    for t, b in zip(d2.queue.tickets(), boards[4:]):
        np.testing.assert_array_equal(t.board, b)
        np.testing.assert_array_equal(t.result, oracle_n(b, 2))


def test_resume_rejects_corrupt_checkpoint(tmp_path):
    bad = tmp_path / "garbage.state"
    bad.write_bytes(b"this is not a MOMP-STATE file")
    with pytest.raises(ValueError, match="magic"):
        ServingDaemon.resume(str(bad), device="cpu")
    with pytest.raises(ValueError, match="no readable"):
        ServingDaemon.resume(str(tmp_path / "missing.state"), device="cpu")


def test_resume_any_quarantines_corrupt_checkpoint_and_serves(tmp_path):
    bad = tmp_path / "skewed.state"
    bad.write_bytes(b"MOMP-STATE/9\n" + b"\x00" * 32)
    d, source, detail = ServingDaemon.resume_any(
        checkpoint_path=str(bad), policy=ServePolicy(max_batch=2),
        device="cpu")
    assert source == "fresh" and d.queue.depth() == 0
    assert "magic" in detail["checkpoint_error"]
    copies = glob.glob(str(bad) + ".corrupt.*")
    assert len(copies) == 1 and detail["checkpoint_quarantine"] == copies[0]
    assert not bad.exists()
    bad.write_bytes(b"second independent corruption")
    _, source2, detail2 = ServingDaemon.resume_any(
        checkpoint_path=str(bad), policy=ServePolicy(max_batch=2),
        device="cpu")
    assert source2 == "fresh"
    copies2 = sorted(glob.glob(str(bad) + ".corrupt.*"))
    assert len(copies2) == 2 and detail2["checkpoint_quarantine"] in copies2


def test_chaos_soak_every_ticket_terminal(monkeypatch, make_board):
    _set_chaos(monkeypatch, "serve_fail=3;delay=0.001")
    d, _ = _daemon(ServePolicy(
        max_batch=4, max_depth=10, max_padding_frac=0.5, max_wait_s=0.01,
        backoff_base_s=0.01))
    shapes = [(16, 16), (24, 16)]
    subs = []
    for i in range(16):
        b = make_board(*shapes[i % 2])
        subs.append((b, d.submit(b, 2)))
    d.serve()
    s = d.summary()
    assert s["requests"] == 16
    assert s["resolved"] + s["shed"] == 16 and s["pending"] == 0
    assert s["shed_reasons"].get(policy_mod.SHED_DEPTH, 0) == 6
    assert s["degraded"] == 3
    for b, t in subs:
        assert t.state in (DONE, SHED)
        if t.state == DONE:
            np.testing.assert_array_equal(t.result, oracle_n(b, 2))
        else:
            assert t.reason in SHED_REASONS


def test_pool_methods_name_the_pool_split(make_board):
    """The session methods on the same inputs in both daemons: a create,
    a ticketed step through ``pump``, a direct step, the lazily built
    pool, the sessions, a snapshot and the summary's pool fields; unknown
    sessions and a pool-less batcher refused with the same errors."""
    d, _ = _daemon(ServePolicy(max_wait_s=0.0))
    jd = jserve.ServingDaemon(ServePolicy(max_wait_s=0.0))
    board = make_board(8, 8)
    for daemon in (d, jd):
        assert daemon.sessions() == []
        with pytest.raises(ValueError, match="unknown session"):
            daemon.submit_session("s", 1)
        with pytest.raises(ValueError, match="unknown session"):
            daemon.step_session("s", 1)
        h = daemon.create_session("s", board)
        assert (h.slab, h.lane) == (0, 0)
        t = daemon.submit_session("s", 1)
        daemon.pump(drain=True)
        assert (t.state, t.engine) == (DONE, "pool:bitsliced")
        assert daemon.step_session("s", 2) == 1
        assert daemon.sessions() == ["s"]
        assert daemon.pool.has("s")
    np.testing.assert_array_equal(d.snapshot_session("s"), oracle_n(board, 3))
    np.testing.assert_array_equal(d.snapshot_session("s"),
                                  jd.snapshot_session("s"))
    ours, theirs = d.summary(), jd.summary()
    assert ours["pool"] == theirs["pool"]
    assert ({k: v for k, v in ours.items() if k.startswith("pool_")}
            == {k: v for k, v in theirs.items() if k.startswith("pool_")})
    for batcher in (tserve.ShapeBucketBatcher(device="cpu"),
                    jserve.ShapeBucketBatcher()):
        with pytest.raises(ValueError, match="no session pool"):
            batcher.submit_session("s", 1)


def test_release_export_adopt_move_tickets(tmp_path, make_board):
    """A bucket released by one daemon and adopted by another: shed
    ``re-homed`` at the source (journal first), resolved at the
    destination with its queued seconds carried."""
    src, clk = _daemon(ServePolicy(max_wait_s=10.0),
                       wal_path=str(tmp_path / "src.wal"))
    boards = [make_board(16, 16) for _ in range(3)]
    tickets = [src.submit(b, 2) for b in boards]
    clk.t = 2.0
    assert len(src.export(tickets)) == 3 and src.queue.depth() == 3
    entries = src.release(tickets)
    assert src.summary()["shed_reasons"] == {policy_mod.SHED_REHOMED: 3}
    assert tserve.replay(str(tmp_path / "src.wal")).shed_reasons == {
        policy_mod.SHED_REHOMED: {0, 1, 2}}
    dst, _ = _daemon(ServePolicy(max_wait_s=0.0))
    adopted = dst.adopt(entries)
    assert all(t.queued_before_s >= 2.0 for t in adopted)
    dst.drain()
    for t, b in zip(adopted, boards):
        np.testing.assert_array_equal(t.result, oracle_n(b, 2))


# --------------------------------------------------------------------- CLIs


def test_daemon_cli_preempt_exits_75_then_resume_verifies(
        monkeypatch, tmp_path, capsys):
    ck = tmp_path / "q.state"
    _set_chaos(monkeypatch, "preempt=1")
    rc = daemon_cli.main(["--requests", "8", "--max-batch", "4",
                          "--max-wait", "0", "--checkpoint", str(ck),
                          "--seed", "3", "--device", "cpu"])
    line1 = json.loads(capsys.readouterr().out.strip())
    assert rc == preempt.EXIT_PREEMPTED == 75
    assert line1["preempted"] is True and line1["resume"] is True
    assert line1["checkpoint"] == str(ck) and ck.exists()
    _set_chaos(monkeypatch, None)
    rc = daemon_cli.main(["--requests", "0", "--resume", "--checkpoint",
                          str(ck), "--verify", "--device", "cpu"])
    line2 = json.loads(capsys.readouterr().out.strip())
    assert rc == 0 and line2["resume_source"] == "checkpoint"
    assert line2["verified"] is True and line2["preempted"] is False
    assert line2["resumed_tickets"] == line2["resolved"]
    assert (line1["resolved"] + line1["shed"]
            + line2["resolved"] + line2["shed"]) == 8


def test_daemon_cli_line_equals_jax(capsys):
    """One seeded burst through both CLIs: the same keys (the port adds
    ``device``) and the same accounting."""
    from mpi_and_open_mp_tpu.serve import daemon as jdaemon_cli

    argv = ["--requests", "12", "--shapes", "16x16,24x16", "--steps", "2,3",
            "--max-batch", "4", "--seed", "5", "--verify"]
    assert daemon_cli.main(argv + ["--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip())
    assert jdaemon_cli.main(argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip())
    assert set(ours) - set(theirs) == {"device"}
    assert set(theirs) <= set(ours)
    for key in ("requests", "resolved", "shed", "batches", "retries",
                "degraded", "shed_reasons", "verified"):
        assert ours[key] == theirs[key], key
    assert ours["engines"] == {port_stamp(k): v
                               for k, v in theirs["engines"].items()}


def test_daemon_cli_resume_requires_checkpoint():
    with pytest.raises(SystemExit) as ei:
        daemon_cli.main(["--resume", "--device", "cpu"])
    assert ei.value.code == 2


def _capture_daemons(monkeypatch, module):
    """Record every ServingDaemon the CLI builds (through ``module``'s
    package namespace, where the CLI looks it up)."""
    made = []
    base = module.ServingDaemon

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(module, "ServingDaemon", Recording)
    return made


def test_life_cli_serve_equals_jax(monkeypatch, capsys):
    """``--serve 8 --device cpu`` on the glider prints one elapsed line,
    the summary on stderr, and every board is the JAX CLI's."""
    ours = _capture_daemons(monkeypatch, tserve)
    theirs = _capture_daemons(monkeypatch, jserve)
    rc = life_app.main([GLIDER, "--layout", "serial", "--serve", "8",
                        "--device", "cpu"])
    out, err = capsys.readouterr()
    assert rc == 0 and len(out.strip().splitlines()) == 1
    float(out)
    assert "served 8/8 (shed 0, degraded 0, p99" in err
    assert jlife_app.main([GLIDER, "--layout", "serial", "--serve", "8"]) \
        == 0
    capsys.readouterr()
    (a,), (b,) = ours, theirs
    ta, tb = a.queue.tickets(), b.queue.tickets()
    assert len(ta) == len(tb) == 8
    for x, y in zip(ta, tb):
        assert x.state == y.state == DONE
        assert x.engine == port_stamp(y.engine)
        np.testing.assert_array_equal(x.result, np.asarray(y.result))


def test_life_cli_serve_preempt_then_resume(monkeypatch, tmp_path, capsys):
    """A preempted ``--serve`` exits 75 with the queue checkpointed; a bare
    ``--resume`` re-enters serving and the boards are the oracle's."""
    from mpi_and_open_mp_tpu_torch.utils.config import load_config

    made = _capture_daemons(monkeypatch, tserve)
    ck = str(tmp_path / "ck")
    _set_chaos(monkeypatch, "preempt=1")
    argv = [GLIDER, "--layout", "serial", "--serve", "8", "--batch", "4",
            "--device", "cpu", "--checkpoint-dir", ck]
    assert life_app.main(argv) == preempt.EXIT_PREEMPTED
    assert "requeue with --serve --resume" in capsys.readouterr().err
    _set_chaos(monkeypatch, None)
    assert life_app.main([GLIDER, "--layout", "serial", "--device", "cpu",
                          "--checkpoint-dir", ck, "--resume", "--batch",
                          "4"]) == 0
    out, err = capsys.readouterr()
    assert "resuming 4 queued tickets" in err and len(out.split()) == 1
    cfg = load_config(GLIDER)
    want = oracle_n(cfg.board(), cfg.steps)
    done = [t for d in made for t in d.queue.tickets() if t.state == DONE]
    assert len(done) == 8
    for t in done:
        np.testing.assert_array_equal(t.result, want)


def test_life_cli_serve_refusals(capsys):
    for extra, msg in ((["--layout", "row"], "--layout serial"),
                       (["--layout", "serial", "--outdir", "x"],
                        "drop --outdir")):
        with pytest.raises(SystemExit) as ei:
            life_app.main([GLIDER, "--serve", "2", "--device", "cpu",
                           *extra])
        assert ei.value.code == 2
        assert msg in capsys.readouterr().err


def test_serve_entry_points_raise_without_cuda(make_board):
    """No quiet fallback: the daemon, its CLI and ``--serve`` default to
    the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    for entry in (lambda: ServingDaemon(),
                  lambda: daemon_cli.main(["--requests", "1"]),
                  lambda: life_app.main([GLIDER, "--layout", "serial",
                                         "--serve", "2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
