"""The port's serving fleet (``serve.router``, ``serve.fleet``), held
against the JAX package's on the CPU.

The ring against JAX's for 2 000 keys over several vnode counts and seeds;
one seeded burst through JAX ``Fleet(3)`` and the port's ``Fleet(3,
device="cpu")`` under one fake clock each (the same placement, the same
``books()``, the same resolved boards), with and without a wedge and a
journal; each package's worker journals replayed by the other; rejoin and
drain with resident sessions, every snapshot equal to JAX's and to the
oracle; the fleet CLI's worker processes, clean and under
``kill_worker=1:2``, their spools read by JAX ``restore_state`` and their
journals by JAX ``replay``. Then the JAX package's ``tests/test_fleet.py``
cases on the port. Small boards, one torch thread.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import oracle_n
from mpi_and_open_mp_tpu import serve as jserve
from mpi_and_open_mp_tpu.robust import chaos as jchaos
from mpi_and_open_mp_tpu.serve import router as jrouter
from mpi_and_open_mp_tpu.serve import wal as jwal
from mpi_and_open_mp_tpu.utils import checkpoint as jcheckpoint

from mpi_and_open_mp_tpu_torch.robust import chaos
from mpi_and_open_mp_tpu_torch.serve import (
    SPOOL_SCHEMA, ConsistentHashRing, Fleet, ServePolicy, ServingDaemon,
    TicketWAL, WorkerHandle)
from mpi_and_open_mp_tpu_torch.serve import fleet as fleet_mod
from mpi_and_open_mp_tpu_torch.serve import policy as policy_mod
from mpi_and_open_mp_tpu_torch.serve import router as router_mod
from mpi_and_open_mp_tpu_torch.serve import wal as wal_mod
from mpi_and_open_mp_tpu_torch.serve.daemon import _parse_backoff
from mpi_and_open_mp_tpu_torch.serve.queue import DONE, PENDING, SHED
from mpi_and_open_mp_tpu_torch.serve.router import affinity_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _fleet(n, policy, clk=None, **kw) -> tuple[Fleet, FakeClock]:
    clk = clk or FakeClock()
    return Fleet(n, policy, clock=clk, sleep=clk.sleep, device="cpu",
                 **kw), clk


def _jfleet(n, policy, clk=None, **kw):
    clk = clk or FakeClock()
    return jserve.Fleet(n, policy, clock=clk, sleep=clk.sleep, **kw), clk


def _session_for(fleet, worker: int) -> str:
    """A session key whose affinity worker is ``worker``."""
    for i in range(10_000):
        s = f"probe-{i}"
        if fleet.router.target_for(s) == worker:
            return s
    raise AssertionError(f"no session found for worker {worker}")


# ------------------------------------------------- the ring against JAX's


@pytest.mark.parametrize("vnodes,seed", [(1, 0), (8, 3), (64, 0), (64, 9),
                                         (128, 271828)])
def test_ring_lookups_equal_jax(vnodes, seed):
    """2 000 keys (session names and the per-ticket fallback keys) land on
    the same worker in both packages' rings, before and after a resize."""
    keys = ([f"s{i:04d}" for i in range(1000)]
            + [affinity_key(None, i) for i in range(1000)])
    ours = ConsistentHashRing(range(5), vnodes=vnodes, seed=seed)
    theirs = jrouter.ConsistentHashRing(range(5), vnodes=vnodes, seed=seed)
    assert [ours.lookup(k) for k in keys] == [theirs.lookup(k)
                                              for k in keys]
    for ring in (ours, theirs):
        ring.remove_worker(3)
        ring.add_worker(7)
    assert ours.workers == theirs.workers
    assert [ours.lookup(k) for k in keys] == [theirs.lookup(k)
                                              for k in keys]
    assert router_mod._h64("momp-fleet/0/key/x") == jrouter._h64(
        "momp-fleet/0/key/x")


# --------------------------------------- one seeded burst through both fleets


def _burst_both(wedge: bool, wal_root=None, steal=True):
    """The same seeded 36-ticket burst through both fleets, fake clocks;
    returns both fleets and the victim (or None)."""
    out = []
    for pkg in ("port", "jax"):
        kw = dict(steal=steal, heartbeat_interval_s=0.02)
        if wal_root is not None:
            kw["wal_dir"] = os.path.join(wal_root, pkg)
            os.makedirs(kw["wal_dir"])
        pol = ServePolicy(max_batch=4, max_wait_s=0.05)
        f, _ = (_fleet(3, pol, **kw) if pkg == "port"
                else _jfleet(3, jserve.ServePolicy(max_batch=4,
                                                   max_wait_s=0.05), **kw))
        rng = np.random.default_rng(3)
        for i in range(36):
            n = (16, 24)[i % 2]
            f.submit((rng.random((n, n)) < 0.3).astype(np.uint8),
                     (i % 3) + 1, session=f"s{i % 8}")
        victim = None
        if wedge:
            victim = max(f.handles, key=lambda h: h.daemon.queue.depth()
                         ).index
            f.wedge(victim)
        f.serve_until_drained()
        out.append((f, victim))
    return out


def _placement(fleet):
    """Per worker index, the sorted (board, steps, state) of every ticket
    it ever held, across retired lifetimes too."""
    handles = list(fleet.handles) + list(fleet.router._retired)
    out = {}
    for h in handles:
        out.setdefault(h.index, []).extend(
            (t.board.tobytes(), t.steps, t.state, t.reason)
            for t in h.daemon.queue.tickets() if t.board is not None)
    return {k: sorted(v) for k, v in out.items()}


def _results(fleet):
    """Every resolved ticket's (board or session, steps, result)."""
    return sorted((t.board.tobytes().hex() if t.board is not None
                   else f"session {t.session}",
                   t.steps, np.asarray(t.result).tobytes())
                  for t in fleet.resolved_tickets())


@pytest.mark.parametrize("wedge,journal", [(False, False), (True, False),
                                           (True, True)],
                         ids=["clean", "wedge", "wedge-wal"])
def test_burst_equals_jax_fleet(tmp_path, wedge, journal):
    (ours, v0), (theirs, v1) = _burst_both(
        wedge, str(tmp_path) if journal else None)
    assert v0 == v1
    assert ours.router.books() == theirs.router.books()
    assert ours.router.books()["balanced"]
    assert _placement(ours) == _placement(theirs)
    assert _results(ours) == _results(theirs)
    s0, s1 = ours.summary(), theirs.summary()
    for key in ("p50_latency_s", "p99_latency_s"):
        s0.pop(key), s1.pop(key)
    assert s0 == s1
    for t in ours.resolved_tickets():
        np.testing.assert_array_equal(t.result, oracle_n(t.board, t.steps))


def test_worker_journals_replay_across_packages(tmp_path):
    """Each port worker's journal replays under JAX ``serve.wal.replay``
    to the JAX fleet's own journal's counts, and the reverse."""
    (ours, _), (theirs, _) = _burst_both(True, str(tmp_path))
    for i in range(3):
        port_wal = str(tmp_path / "port" / f"worker{i}.wal")
        jax_wal = str(tmp_path / "jax" / f"worker{i}.wal")
        assert jwal.replay(port_wal).counts() == wal_mod.replay(
            port_wal).counts()
        assert wal_mod.replay(jax_wal).counts() == jwal.replay(
            jax_wal).counts()
        assert wal_mod.replay(port_wal).counts() == jwal.replay(
            jax_wal).counts()


def test_jax_worker_journal_resumes_on_the_port(tmp_path):
    """A JAX fleet worker's journal with pending tickets (admitted, never
    pumped) resumes in a port daemon and drains to the oracle; a port
    worker's journal does the same in a JAX daemon."""
    pol = jserve.ServePolicy(max_batch=4, max_wait_s=100.0)
    theirs, _ = _jfleet(3, pol, wal_dir=str(tmp_path / "jax"), steal=False)
    ours, _ = _fleet(3, ServePolicy(max_batch=4, max_wait_s=100.0),
                     wal_dir=str(tmp_path / "port"), steal=False)
    os.makedirs(tmp_path / "jax", exist_ok=True)
    rng = np.random.default_rng(8)
    for i in range(12):
        b = (rng.random((16, 16)) < 0.3).astype(np.uint8)
        theirs.submit(b, 2, session=f"s{i % 5}")
        ours.submit(b, 2, session=f"s{i % 5}")
    for f in (theirs, ours):
        for h in f.handles:
            h.daemon._wal.sync()
    for i in range(3):
        d, src, _ = ServingDaemon.resume_any(
            wal_path=str(tmp_path / "jax" / f"worker{i}.wal"),
            policy=ServePolicy(max_batch=4, max_wait_s=0.0), device="cpu")
        jd, jsrc, _ = jserve.ServingDaemon.resume_any(
            wal_path=str(tmp_path / "port" / f"worker{i}.wal"),
            policy=jserve.ServePolicy(max_batch=4, max_wait_s=0.0))
        assert src == jsrc == "wal"
        assert d.queue.depth() == jd.queue.depth() == len(
            [t for t in theirs.handles[i].daemon.queue.pending()])
        d.drain()
        jd.drain()
        for t in d.queue.tickets() + jd.queue.tickets():
            assert t.state == DONE
            np.testing.assert_array_equal(t.result,
                                          oracle_n(t.board, t.steps))


# ------------------------------------ membership with resident sessions


def _membership_both(tmp_path, which: str):
    """Resident sessions through both fleets, then a wedge and a rejoin
    (``which == "rejoin"``) or a drain; returns (fleet, boards, steps,
    moved) per package."""
    out = {}
    for pkg in ("port", "jax"):
        wal_dir = str(tmp_path / pkg)
        os.makedirs(wal_dir)
        if pkg == "port":
            f, clk = _fleet(3, ServePolicy(max_batch=4, max_wait_s=0.0),
                            wal_dir=wal_dir, steal=False,
                            heartbeat_interval_s=0.02)
            ring_cls = ConsistentHashRing
        else:
            f, clk = _jfleet(3, jserve.ServePolicy(max_batch=4,
                                                   max_wait_s=0.0),
                             wal_dir=wal_dir, steal=False,
                             heartbeat_interval_s=0.02)
            ring_cls = jrouter.ConsistentHashRing
        rng = np.random.default_rng(21)
        boards = {f"sess-{i}": (rng.random((16, 16)) < 0.35).astype(np.uint8)
                  for i in range(9)}
        steps = dict.fromkeys(boards, 0)
        for sid, b in boards.items():
            f.create_session(sid, b)
        for sid in boards:
            f.step_session(sid, 2)
            steps[sid] += 2
        f.serve_until_drained()
        victim = f.router.target_for("sess-0")
        if which == "rejoin":
            f.wedge(victim)
            for _ in range(6):
                f.pump()
                clk.sleep(0.02)
            assert f.handles[victim].wedged
            full = ring_cls(range(3))
            i = 0
            while sum(1 for s in boards if s.startswith("claim")) < 3:
                name = f"claim-{i}"
                i += 1
                if full.lookup(name) == victim:
                    n = 18 + 2 * sum(1 for s in boards
                                     if s.startswith("claim"))
                    boards[name] = (rng.random((n, 16)) < 0.35).astype(
                        np.uint8)
                    f.create_session(name, boards[name])
                    f.step_session(name, 2)
                    steps[name] = 2
            f.serve_until_drained()
            moved = f.rejoin_worker(victim)
        else:
            t = f.submit((rng.random((16, 16)) < 0.35).astype(np.uint8), 3,
                         session="sess-0")
            assert t.state == PENDING
            moved = f.drain_worker(victim)
        f.serve_until_drained(drain=True)
        out[pkg] = (f, boards, steps, moved)
    return out


@pytest.mark.parametrize("which", ["rejoin", "drain"])
def test_membership_with_sessions_equals_jax(tmp_path, which):
    runs = _membership_both(tmp_path, which)
    (ours, boards, steps, moved), (theirs, _, _, jmoved) = (
        runs["port"], runs["jax"])
    assert moved == jmoved
    assert ours.router.books() == theirs.router.books()
    assert ours.router.books()["balanced"]
    assert ours.router.pool_rehomed == theirs.router.pool_rehomed
    for sid, b in boards.items():
        assert (ours.router._home_worker(sid).index
                == theirs.router._home_worker(sid).index)
        snap = ours.snapshot_session(sid)
        np.testing.assert_array_equal(snap, theirs.snapshot_session(sid))
        np.testing.assert_array_equal(snap, oracle_n(b, steps[sid]))
    assert _results(ours) == _results(theirs)


# ------------------------------------------------ the fleet CLI's processes


def _cli(state_dir: str, chaos_spec: str | None = None, *extra):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("MOMP_CHAOS", None)
    env.pop("MOMP_TRACE", None)
    if chaos_spec:
        env["MOMP_CHAOS"] = chaos_spec
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_and_open_mp_tpu_torch.serve.fleet",
         "--device", "cpu", "--workers", "3", "--verify", "--dir",
         state_dir, *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    return proc, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The fleet CLI once clean and once with worker 1 killed at its second
    dispatch, 48 requests over 12 sessions at 48x48 and 64x64."""
    root = tmp_path_factory.mktemp("fleet_cli")
    clean = _cli(str(root / "clean"))
    killed = _cli(str(root / "killed"), "kill_worker=1:2")
    return {"clean": (clean, str(root / "clean")),
            "killed": (killed, str(root / "killed"))}


def test_cli_clean_books_balance(cli_runs):
    (proc, line), _ = cli_runs["clean"]
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert line["books_balance"] and line["verified"]
    assert line["device"] == "cpu"
    assert line["worker_rcs"] == [0, 0, 0] and line["victims"] == []
    assert line["resolved"] == 48 and line["acked_loss"] == 0
    assert line["telemetry"]["loss"]["lost"] == 0


def test_cli_kill_worker_recovers(cli_runs):
    (proc, line), state = cli_runs["killed"]
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert line["worker_rcs"][1] == chaos.CRASH_EXIT == 137
    assert line["victims"] == [1] and line["rehomed"] > 0
    assert line["recovery_rcs"] and all(rc == 0
                                        for rc in line["recovery_rcs"])
    assert line["books_balance"] and line["verified"]
    assert line["rehomed_parity"] and line["resolved"] == 48
    assert line["rehomed_resolved"] == line["rehomed"]
    decisions = line["telemetry"]["decisions"]
    assert [d["reason"] for d in decisions] == ["worker-death"]
    # The victim's journal closed its books: JAX's replay finds nothing
    # pending, as the port's does.
    victim_wal = os.path.join(state, "worker1.wal")
    assert jwal.replay(victim_wal).pending == []
    assert wal_mod.replay(victim_wal).pending == []


def test_cli_line_keys_equal_jax(cli_runs):
    """The port's line carries every key of JAX's ``fleet.main`` record
    (and ``device`` more)."""
    (_, line), _ = cli_runs["killed"]
    jax_keys = {"fleet", "requests", "sessions", "door_shed", "worker_rcs",
                "victims", "recovery_rcs", "rehomed", "rehomed_resolved",
                "resolved", "shed", "acked_loss", "books_balance",
                "fleet_requests_per_sec", "fleet_p99_latency_s",
                "fleet_kill_recovery_s", "wall_sec", "state_dir",
                "verified", "rehomed_parity", "telemetry"}
    assert jax_keys <= set(line)
    assert set(line) - jax_keys == {"device"}


def test_cli_spools_read_by_jax(cli_runs):
    """A port-written spool (``momp-fleet-spool/1`` through the port's
    ``save_state``) reads back under JAX ``restore_state``, entry for
    entry, and partitions the burst as JAX's ring does."""
    (_, line), state = cli_runs["clean"]
    ring = jrouter.ConsistentHashRing(range(3))
    total = 0
    for i in range(3):
        spool = jcheckpoint.restore_state(os.path.join(state,
                                                       f"worker{i}.spool"))
        assert spool["schema"] == SPOOL_SCHEMA and spool["worker"] == i
        for e in spool["entries"]:
            assert isinstance(e["board"], np.ndarray)
            assert ring.lookup(jrouter.affinity_key(e["session"])) == i
        total += len(spool["entries"])
    assert total == line["requests"] - line["door_shed"]


def test_cli_worker_journals_replay_under_jax(cli_runs):
    for run in ("clean", "killed"):
        _, state = cli_runs[run]
        for name in sorted(os.listdir(state)):
            if name.endswith(".wal"):
                path = os.path.join(state, name)
                assert jwal.replay(path).counts() == wal_mod.replay(
                    path).counts(), (run, name)


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_mod.main(["--workers", "2", "--requests", "4",
                        "--dir", str(tmp_path)])
    assert not any(n.endswith(".spool") for n in os.listdir(tmp_path))


# --------------------------------------- the JAX package's fleet cases


def test_ring_cross_process_determinism():
    """The same (workers, vnodes, seed) ring shards identically in a
    fresh interpreter with a DIFFERENT hash salt."""
    keys = [f"s{i:03d}" for i in range(32)]
    ring = ConsistentHashRing(range(5), vnodes=32, seed=9)
    local = [ring.lookup(k) for k in keys]
    code = (
        "import json\n"
        "from mpi_and_open_mp_tpu_torch.serve.router import "
        "ConsistentHashRing\n"
        "r = ConsistentHashRing(range(5), vnodes=32, seed=9)\n"
        "print(json.dumps([r.lookup(f's{i:03d}') for i in range(32)]))\n")
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONHASHSEED="271828")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr[-800:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == local


def test_ring_removal_moves_only_the_victims_keys():
    ring = ConsistentHashRing(range(4), vnodes=64, seed=7)
    keys = [f"sess-{i}" for i in range(500)]
    before = {k: ring.lookup(k) for k in keys}
    ring.remove_worker(2)
    for k in keys:
        after = ring.lookup(k)
        if before[k] != 2:
            assert after == before[k]
        else:
            assert after != 2


def test_ring_addition_claims_only_its_own_points():
    ring = ConsistentHashRing(range(3), vnodes=64, seed=1)
    keys = [f"sess-{i}" for i in range(1000)]
    before = {k: ring.lookup(k) for k in keys}
    ring.add_worker(3)
    moved = [k for k in keys if ring.lookup(k) != before[k]]
    assert all(ring.lookup(k) == 3 for k in moved)
    assert 0 < len(moved) / len(keys) < 0.45


def test_ring_empty_lookup_raises_and_affinity_key_fallback():
    ring = ConsistentHashRing((), vnodes=8)
    with pytest.raises(RuntimeError, match="no live workers"):
        ring.lookup("s")
    with pytest.raises(ValueError, match="vnodes"):
        ConsistentHashRing((0,), vnodes=0)
    assert affinity_key("sess-a", 7) == "sess-a"
    assert affinity_key(None, 7) == "ticket/7"
    assert affinity_key(None) == "ticket/0"


def test_fleet_wedge_rehomes_from_wal_books_balance(tmp_path, make_board):
    pol = ServePolicy(max_batch=4, max_wait_s=0.05)
    f, clk = _fleet(3, pol, wal_dir=str(tmp_path), steal=False,
                    heartbeat_interval_s=0.02)
    for i in range(18):
        f.submit(make_board(16, 16), (i % 3) + 1, session=f"s{i % 6}")
    victim = max(f.handles, key=lambda h: h.daemon.queue.depth()).index
    depth_before = f.handles[victim].daemon.queue.depth()
    assert depth_before > 0
    f.wedge(victim)
    f.serve_until_drained()
    s = f.summary()
    assert s["balanced"] and s["pending"] == 0
    assert s["wedged"] == [victim]
    assert s["rehomed"] == depth_before == s["rehomed_resolved"]
    assert s["resolved"] == 18 and s["shed"] == 0
    rep = wal_mod.replay(str(tmp_path / f"worker{victim}.wal"))
    assert rep.pending == []
    for t in f.resolved_tickets():
        np.testing.assert_array_equal(
            t.result, oracle_n(t.board, t.steps),
            err_msg=f"ticket {t.id} lost parity across the re-home")


def test_fleet_wedge_without_journal_rehomes_from_live_queue(make_board):
    pol = ServePolicy(max_batch=4, max_wait_s=0.05)
    f, _ = _fleet(3, pol, steal=False, heartbeat_interval_s=0.02)
    for i in range(12):
        f.submit(make_board(16, 16), 2, session=f"s{i % 4}")
    victim = max(f.handles, key=lambda h: h.daemon.queue.depth()).index
    f.wedge(victim)
    f.serve_until_drained()
    s = f.summary()
    assert s["balanced"] and s["resolved"] == 12 and s["pending"] == 0


def test_slow_pump_round_does_not_false_wedge(make_board):
    """One worker's dispatch taking far longer than the heartbeat horizon
    (a first dispatch loading its libraries) must not wedge the workers
    that pumped earlier in the same round."""
    pol = ServePolicy(max_batch=4, max_wait_s=0.0)
    f, clk = _fleet(3, pol, steal=False, heartbeat_interval_s=0.02)
    slow = f.handles[1].daemon
    orig = slow.pump

    def glacial_pump(now=None, **kw):
        clk.sleep(5.0)
        return orig(clk(), **kw)

    slow.pump = glacial_pump
    for i in range(6):
        f.submit(make_board(16, 16), 2, session=f"s{i}")
    f.pump()
    assert not any(h.wedged for h in f.handles)
    f.wedge(0)
    for _ in range(6):
        f.pump()
        clk.sleep(0.02)
    assert f.handles[0].wedged and not f.handles[2].wedged


def test_hot_shard_sheds_while_cold_shard_admits(make_board):
    pol = ServePolicy(max_batch=4, max_depth=2, max_wait_s=100.0)
    f, _ = _fleet(2, pol, steal=False)
    hot = _session_for(f, 0)
    cold = _session_for(f, 1)
    b = make_board(16, 16)
    assert f.submit(b, 2, session=hot).state == PENDING
    assert f.submit(b, 2, session=hot).state == PENDING
    t = f.submit(b, 2, session=hot)
    assert t.state == SHED and t.reason == policy_mod.SHED_DEPTH
    assert t.id >= 0
    assert f.submit(b, 2, session=cold).state == PENDING
    assert f.submit(b, 2, session=cold).state == PENDING
    t = f.submit(b, 2, session=cold)
    assert t.state == SHED and t.id < 0
    assert f.router.door_shed.get(policy_mod.SHED_DEPTH) == 1
    assert f.router.books()["balanced"]


def test_steal_moves_oldest_whole_bucket_to_idle_worker(make_board):
    pol = ServePolicy(max_batch=4, max_wait_s=100.0)
    f, clk = _fleet(2, pol, steal=False)
    donor_sess = _session_for(f, 0)
    for _ in range(3):
        f.submit(make_board(16, 16), 2, session=donor_sess)
    for _ in range(2):
        f.submit(make_board(24, 24), 2, session=donor_sess)
    assert [h.daemon.queue.depth() for h in f.handles] == [5, 0]
    moved = f.router.steal(clk())
    assert moved == 3
    assert [h.daemon.queue.depth() for h in f.handles] == [2, 3]
    assert f.router.steals == 1
    assert f.router.steal(clk()) == 0
    f.serve_until_drained(drain=True)
    s = f.summary()
    assert s["balanced"] and s["resolved"] == 5


def test_steal_never_splits_or_empties_a_single_bucket(make_board):
    pol = ServePolicy(max_batch=4, max_wait_s=100.0)
    f, clk = _fleet(2, pol, steal=False)
    donor_sess = _session_for(f, 0)
    for _ in range(3):
        f.submit(make_board(16, 16), 2, session=donor_sess)
    assert f.router.steal(clk()) == 0
    assert [h.daemon.queue.depth() for h in f.handles] == [3, 0]


def test_kill_worker_token_parse_and_validation():
    plan = chaos.FaultPlan.parse("kill_worker=2:3")
    assert plan.kill_worker_idx == 2 and plan.kill_worker_at == 3
    assert chaos.FaultPlan.parse("kill_worker=1").kill_worker_at == 1
    with pytest.raises(ValueError):
        chaos.FaultPlan.parse("kill_worker=-1:2")
    with pytest.raises(ValueError):
        chaos.FaultPlan.parse("kill_worker=0:0")


def test_kill_worker_arms_only_matching_index_at_kth_hit(monkeypatch):
    monkeypatch.setenv("MOMP_CHAOS", "kill_worker=1:2")
    chaos.reset()
    assert not chaos.kill_worker_armed(0)
    assert not chaos.kill_worker_armed(None)
    assert not chaos.kill_worker_armed(1)
    assert chaos.kill_worker_armed(1)
    assert not chaos.kill_worker_armed(1)


def test_wal_admit_carries_session_through_replay(tmp_path, make_board):
    path = str(tmp_path / "w.wal")
    w = TicketWAL(path)
    b = make_board(8, 8)
    w.admit(0, b, 3, session="sess-a")
    w.admit(1, b, 2)
    w.close()
    rep = wal_mod.replay(path)
    assert [e["session"] for e in rep.pending] == ["sess-a", None]
    w = TicketWAL(path)
    w.compact(rep.pending)
    w.close()
    rep2 = wal_mod.replay(path)
    assert [e["session"] for e in rep2.pending] == ["sess-a", None]


def test_parse_backoff_spec():
    assert _parse_backoff("0.1") == (0.1, 1.0, 0.5)
    assert _parse_backoff("0.1:2.0") == (0.1, 2.0, 0.5)
    assert _parse_backoff("0.1:2.0:0.0") == (0.1, 2.0, 0.0)
    with pytest.raises(ValueError):
        _parse_backoff("1:2:3:4")


def test_daemon_cli_exposes_padding_and_backoff_knobs():
    from mpi_and_open_mp_tpu_torch.serve.daemon import build_parser

    args = build_parser().parse_args(
        ["--requests", "0", "--max-padding-frac", "0.2",
         "--backoff", "0.01:0.5:0.0"])
    assert args.max_padding_frac == 0.2
    assert _parse_backoff(args.backoff) == (0.01, 0.5, 0.0)


def test_fleet_and_router_validation(make_board):
    with pytest.raises(ValueError, match="n_workers"):
        Fleet(0, device="cpu")
    with pytest.raises(ValueError, match="policies"):
        Fleet(2, policies=[ServePolicy()], device="cpu")
    with pytest.raises(ValueError, match="at least one worker"):
        router_mod.FleetRouter([])
    f, clk = _fleet(2, ServePolicy(max_batch=4, max_wait_s=100.0))
    f.wedge(0)
    clk.sleep(10.0)
    assert f.router.check_health(clk()) == [0]
    clk.sleep(10.0)
    assert f.router.check_health(clk()) == []
    assert not f.handles[1].wedged


def test_sentinel_polarity_for_fleet_fields():
    """The regression sentinel watches the fleet CLI line's three headline
    fields with the right polarity (the port's line keeps JAX's names)."""
    sys.path.insert(0, os.path.join(REPO, "analysis"))
    import regression_sentinel as rs

    for field in ("fleet_requests_per_sec", "fleet_p99_latency_s",
                  "fleet_kill_recovery_s"):
        assert field in rs.WATCH_FIELDS
    assert rs.direction_for("fleet_requests_per_sec") == "higher"
    assert rs.direction_for("fleet_p99_latency_s") == "lower"
    assert rs.direction_for("fleet_kill_recovery_s") == "lower"


def test_add_worker_rerolls_admission_live(make_board):
    pol = ServePolicy(max_batch=4, max_depth=2, max_wait_s=100.0)
    f, clk = _fleet(2, pol, steal=False)
    b = make_board(16, 16)
    admitted = 0
    i = 0
    while admitted < 4:
        t = f.submit(b, 2, session=f"fill-{i}")
        admitted += t.state == PENDING
        i += 1
    t = f.submit(b, 2, session="overflow")
    assert t.state == SHED and t.id < 0
    door_shed_before = f.router.door_shed.get(policy_mod.SHED_DEPTH)

    d = ServingDaemon(pol, worker_index=2, clock=clk, sleep=clk.sleep,
                      device="cpu")
    h = WorkerHandle(index=2, daemon=d, last_beat=clk())
    f.router.add_worker(h)
    f.handles.append(h)
    sess = _session_for(f, 2)
    assert f.submit(b, 2, session=sess).state == PENDING
    assert f.router.door_shed.get(policy_mod.SHED_DEPTH) == door_shed_before
    with pytest.raises(ValueError, match="already in the fleet"):
        f.router.add_worker(h)
    f.serve_until_drained()
    assert f.summary()["balanced"]


def test_fleet_wedge_rehomes_pool_sessions(tmp_path, make_board):
    pol = ServePolicy(max_batch=4, max_wait_s=0.0)
    f, clk = _fleet(3, pol, wal_dir=str(tmp_path), steal=False,
                    heartbeat_interval_s=0.02)
    boards = {f"sess-{i}": make_board(16, 16) for i in range(12)}
    for sid, b in boards.items():
        f.create_session(sid, b)
    tickets = [f.step_session(sid, 2) for sid in boards]
    f.serve_until_drained()
    assert all(t.state == DONE for t in tickets)

    victim = f.router.target_for("sess-0")
    moved = [sid for sid in boards if f.router.target_for(sid) == victim]
    f.wedge(victim)
    for _ in range(6):
        f.pump()
        clk.sleep(0.02)
    assert f.handles[victim].wedged
    assert f.router.pool_rehomed == len(moved)
    for sid, b in boards.items():
        assert f.router.target_for(sid) != victim
        np.testing.assert_array_equal(
            f.snapshot_session(sid), oracle_n(b, 2),
            err_msg=f"session {sid} lost parity across the re-home")
    rep = wal_mod.replay(str(tmp_path / f"worker{victim}.wal"))
    assert rep.pool_sessions == {}
    t = f.step_session("sess-0", 3)
    f.serve_until_drained()
    assert t.state == DONE
    np.testing.assert_array_equal(
        f.snapshot_session("sess-0"), oracle_n(boards["sess-0"], 5))


def _claimable_sessions(fleet, worker, count, make_board):
    """Session names whose full-ring affinity is ``worker``, each a
    distinct shape (its own slab group)."""
    full = ConsistentHashRing(sorted({h.index for h in fleet.handles}))
    out, i = {}, 0
    while len(out) < count:
        name = f"claim-{i}"
        i += 1
        if full.lookup(name) == worker:
            shape = 18 + 2 * len(out)
            out[name] = make_board(shape, 16)
    return out


def test_rejoin_reenters_ring_and_claims_bit_exact(tmp_path, make_board):
    pol = ServePolicy(max_batch=4, max_wait_s=0.0)
    f, clk = _fleet(3, pol, wal_dir=str(tmp_path), steal=False,
                    heartbeat_interval_s=0.02)
    boards = {f"sess-{i}": make_board(16, 16) for i in range(9)}
    for sid, b in boards.items():
        f.create_session(sid, b)
    for sid in boards:
        f.step_session(sid, 2)
    f.serve_until_drained()

    victim = f.router.target_for("sess-0")
    f.wedge(victim)
    for _ in range(6):
        f.pump()
        clk.sleep(0.02)
    assert f.handles[victim].wedged

    claim = _claimable_sessions(f, victim, 3, make_board)
    for sid, b in claim.items():
        f.create_session(sid, b)
        f.step_session(sid, 2)
    f.serve_until_drained()

    with pytest.raises(ValueError, match="is live"):
        f.rejoin_worker((victim + 1) % 3)
    claimed = f.rejoin_worker(victim)
    fresh = next(h for h in f.handles if h.index == victim)
    assert fresh.warming and not fresh.wedged
    assert fresh.daemon.device == torch.device("cpu")
    assert claimed >= len(claim)
    assert f.router.rejoins == 1
    assert f.router.target_for("sess-0") == victim
    for sid, b in claim.items():
        assert f.router._home_worker(sid).index == victim
        np.testing.assert_array_equal(
            f.snapshot_session(sid), oracle_n(b, 2),
            err_msg=f"claimed session {sid} lost parity across rejoin")
    t = f.step_session("sess-0", 3)
    f.serve_until_drained()
    assert t.state == DONE
    s = f.summary()
    assert s["balanced"] and s["rejoins"] == 1
    assert fresh.warming is False


def test_rejoin_warming_worker_not_false_wedged(tmp_path, make_board):
    pol = ServePolicy(max_batch=4, max_wait_s=0.0)
    f, clk = _fleet(3, pol, wal_dir=str(tmp_path), steal=False,
                    heartbeat_interval_s=0.02)
    for i in range(6):
        f.submit(make_board(16, 16), 2, session=f"s{i}")
    victim = 0
    f.wedge(victim)
    f.serve_until_drained()
    assert f.handles[victim].wedged

    f.rejoin_worker(victim)
    fresh = next(h for h in f.handles if h.index == victim)
    assert fresh.warming
    fresh.halted = True
    for i in range(8):
        f.submit(make_board(16, 16), 2, session=f"w{i}")
        f.pump()
        clk.sleep(0.05)
    assert not fresh.wedged, "warming worker was false-wedged"
    fresh.halted = False
    f.serve_until_drained()
    assert not fresh.warming and not fresh.wedged
    assert f.summary()["balanced"]
    f.wedge(2)
    for _ in range(6):
        f.pump()
        clk.sleep(0.05)
    assert f.handles[2].wedged


def test_steal_in_transit_counted_once_at_door(make_board):
    pol = ServePolicy(max_batch=4, max_depth=3, max_wait_s=100.0)
    f, clk = _fleet(2, pol, steal=False)
    donor = _session_for(f, 0)
    b16, b24 = make_board(16, 16), make_board(24, 24)
    for _ in range(2):
        f.submit(b16, 2, session=donor)
    f.submit(b24, 2, session=donor)

    moved = f.router.steal(clk(), defer=True)
    assert moved == 2
    assert f.router.in_transit_depth() == 2
    assert [h.daemon.queue.depth() for h in f.handles] == [1, 0]
    assert f.pending() == 3
    books = f.router.books()
    assert books["in_transit"] == 2 and books["balanced"], books

    cold = _session_for(f, 1)
    for _ in range(3):
        assert f.submit(b16, 2, session=cold).state == PENDING
    t = f.submit(b16, 2, session=donor)
    assert t.state == SHED and t.id < 0, (
        "door forgot the in-transit bucket")

    delivered = f.router.deliver_in_transit(clk())
    assert delivered == 2 and f.router.in_transit_depth() == 0
    assert f.router.steals == 1
    f.serve_until_drained(drain=True)
    s = f.summary()
    assert s["balanced"] and s["resolved"] == 6 and s["in_transit"] == 0


def test_steal_in_transit_reroutes_if_thief_dies(make_board):
    pol = ServePolicy(max_batch=4, max_wait_s=100.0)
    f, clk = _fleet(3, pol, steal=False, heartbeat_interval_s=0.02)
    donor = _session_for(f, 0)
    for _ in range(2):
        f.submit(make_board(16, 16), 2, session=donor)
    f.submit(make_board(24, 24), 2, session=donor)
    moved = f.router.steal(clk(), defer=True)
    assert moved == 2
    thief = f.router._in_transit[0]["thief"]
    f.router.declare_wedged(thief, clk())
    assert f.handles[thief].wedged
    assert f.router.deliver_in_transit(clk()) == 2
    f.serve_until_drained(drain=True)
    s = f.summary()
    assert s["balanced"] and s["resolved"] == 3 and s["pending"] == 0


def test_drain_worker_moves_whole_buckets_zero_loss(tmp_path, make_board):
    pol = ServePolicy(max_batch=4, max_wait_s=100.0)
    f, clk = _fleet(3, pol, wal_dir=str(tmp_path), steal=False)
    victim = 0
    vsess = _session_for(f, victim)
    boards = [make_board(16, 16) for _ in range(3)]
    tickets = [f.submit(b, 2, session=vsess) for b in boards]
    assert all(t.state == PENDING for t in tickets)
    assert f.handles[victim].daemon.queue.depth() == 3
    sb = make_board(16, 16)
    f.create_session(vsess, sb)
    st = f.step_session(vsess, 2)

    stats = f.drain_worker(victim)
    assert f.handles[victim].drained and f.handles[victim].cordoned
    assert stats["tickets_moved"] == 3 and stats["sessions_moved"] == 1
    assert st.state == DONE
    depths = [h.daemon.queue.depth() for h in f.handles
              if h.index != victim]
    assert sorted(depths) == [0, 3]
    assert all(f.router.target_for(f"probe-{i}") != victim
               for i in range(50))
    rep = wal_mod.replay(str(tmp_path / f"worker{victim}.wal"))
    assert rep.pending == [] and rep.pool_sessions == {}

    f.serve_until_drained(drain=True)
    s = f.summary()
    assert s["balanced"] and s["drains"] == 1
    assert s["drained"] == [victim]
    assert s["resolved"] == 4 and s["pending"] == 0
    for t in f.resolved_tickets():
        if t.board is not None:
            np.testing.assert_array_equal(
                t.result, oracle_n(t.board, t.steps),
                err_msg=f"ticket {t.id} lost parity across the drain")
    np.testing.assert_array_equal(f.snapshot_session(vsess),
                                  oracle_n(sb, 2))
    with pytest.raises(ValueError, match="already left"):
        f.drain_worker(victim)


def test_drain_last_survivor_refused():
    f, _clk = _fleet(2, ServePolicy(max_batch=4, max_wait_s=0.0))
    f.drain_worker(0)
    with pytest.raises(RuntimeError, match="no survivors"):
        f.drain_worker(1)


def test_autoscale_adds_on_breach_drains_on_surplus(make_board):
    elastic = policy_mod.ElasticityPolicy(
        slo_p99_s=0.01, min_workers=2, max_workers=3,
        breach_k=2, surplus_k=3, cooldown_k=2)
    pol = ServePolicy(max_batch=4, max_wait_s=0.0)
    f, clk = _fleet(2, pol, steal=False, elasticity=elastic,
                    elastic_window_s=5.0)
    assert f.controller is not None

    rounds_before = len(f.handles)
    for i in range(4):
        f.submit(make_board(16, 16), 2, session=f"s{i}")
        clk.sleep(0.05)
        f.pump()
    assert len(f.handles) == rounds_before + 1 == 3
    assert f.controller.actions == [policy_mod.SCALE_ADD]
    new = f.handles[-1]
    assert new.index == 2 and not new.wedged
    assert new.daemon.device == torch.device("cpu")
    for i in range(6):
        f.submit(make_board(16, 16), 2, session=f"b{i}")
        clk.sleep(0.05)
        f.pump()
    assert len(f.handles) == 3

    f.serve_until_drained(drain=True)
    clk.sleep(10.0)
    for _ in range(8):
        f.pump()
        clk.sleep(0.01)
    assert f.controller.actions == [policy_mod.SCALE_ADD,
                                    policy_mod.SCALE_DRAIN]
    assert len(f.router.live_workers()) == 2
    assert f.summary()["balanced"]
