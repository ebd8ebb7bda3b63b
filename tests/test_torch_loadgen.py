"""The port's open-loop load generator (``serve.loadgen``), held against
the JAX package's on the CPU.

``arrivals_poisson`` and the bound schedule against JAX's for the same
seeds; ``run_open_loop`` through the port's ``Fleet(device="cpu")`` and
JAX's under fake clocks (the same counts: offered, submitted, resolved,
snapshots, shed; the same create boards; every resident snapshot equal to
JAX's and to the oracle), with and without the membership drill. Then the
JAX package's ``tests/test_loadgen.py`` cases on the port. Small boards,
one torch thread.
"""

import os
import sys

import numpy as np
import pytest
import torch

from conftest import oracle_n
from mpi_and_open_mp_tpu import serve as jserve
from mpi_and_open_mp_tpu.serve import loadgen as jloadgen

from mpi_and_open_mp_tpu_torch.serve import (
    SLO,
    Fleet,
    LoadgenReport,
    ScenarioMix,
    ServePolicy,
    arrivals_poisson,
    arrivals_trace,
    run_open_loop,
    saturation_knee,
    sweep,
)
from mpi_and_open_mp_tpu_torch.serve import loadgen
from mpi_and_open_mp_tpu_torch.serve import policy as policy_mod
from mpi_and_open_mp_tpu_torch.serve.queue import DONE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch calls: one thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


def _fleet(n=2, **kw):
    clk = FakeClock()
    pol = kw.pop("policy", ServePolicy(max_batch=4, max_wait_s=0.0))
    return Fleet(n, pol, clock=clk, sleep=clk.sleep, steal=False,
                 device="cpu", **kw), clk


def _jfleet(n=2, **kw):
    clk = FakeClock()
    pol = kw.pop("policy", jserve.ServePolicy(max_batch=4, max_wait_s=0.0))
    return jserve.Fleet(n, pol, clock=clk, sleep=clk.sleep, steal=False,
                        **kw), clk


#: Small boards; two shapes still load distinct buckets at the door.
MIX = ScenarioMix(batch=0.6, resident=0.3, snapshot=0.1,
                  shapes=((12, 12), (16, 16)), steps=(2, 4), sessions=3)
JMIX = jloadgen.ScenarioMix(batch=0.6, resident=0.3, snapshot=0.1,
                            shapes=((12, 12), (16, 16)), steps=(2, 4),
                            sessions=3)


# --------------------------------------------------- the same as JAX's


@pytest.mark.parametrize("rate,duration,seed", [(50.0, 4.0, 3),
                                                (7.5, 2.0, 0),
                                                (400.0, 0.5, 11)])
def test_arrivals_poisson_equal_jax(rate, duration, seed):
    assert arrivals_poisson(rate, duration, seed=seed) == \
        jloadgen.arrivals_poisson(rate, duration, seed=seed)


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_schedule_equal_jax(seed):
    arrivals = arrivals_poisson(40.0, 2.0, seed=seed)
    ours = loadgen._build_schedule(arrivals, MIX, seed)
    theirs = jloadgen._build_schedule(arrivals, JMIX, seed)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
        if a[1] == "batch":
            np.testing.assert_array_equal(a[2], b[2])
        else:
            assert a[2] == b[2]
    assert SLO().verdict(goodput_rps=9.0, offered_rps=10.0, p99_s=0.25,
                         p999_s=1.0) == jloadgen.SLO().verdict(
        goodput_rps=9.0, offered_rps=10.0, p99_s=0.25, p999_s=1.0)


def _counts(rep):
    return {k: getattr(rep, k) for k in ("offered", "submitted", "resolved",
                                         "snapshots", "shed")}


def _drill(which):
    """The bench's membership cycle: wedge at 0.25, rejoin at 0.45, drain
    at 0.65 (worker 0 wedged and rejoined, worker 1 drained)."""
    if which == "none":
        return None
    return [(0.25, lambda fl: fl.wedge(0)),
            (0.45, lambda fl: fl.rejoin_worker(0)
             if fl.handles[0].wedged else None),
            (0.65, lambda fl: fl.drain_worker(1))]


@pytest.mark.parametrize("drill", ["none", "membership"])
def test_run_open_loop_equals_jax(tmp_path, drill):
    """One run of each package under a fake clock: the same counts and
    create boards, every resident snapshot equal to JAX's and the
    oracle's, every one-shot board equal to the oracle's."""
    kw = {}
    if drill != "none":
        kw = dict(wal_dir=str(tmp_path / "port"),
                  heartbeat_interval_s=0.02)
        os.makedirs(tmp_path / "port")
    ours, _ = _fleet(3, **kw)
    if drill != "none":
        kw["wal_dir"] = str(tmp_path / "jax")
        os.makedirs(tmp_path / "jax")
    theirs, _ = _jfleet(3, **kw)
    rep = run_open_loop(ours, 30.0, 2.0, mix=MIX, seed=4,
                        slo=SLO(p99_s=10.0, goodput_frac=0.5),
                        events=_drill(drill))
    jrep = jloadgen.run_open_loop(theirs, 30.0, 2.0, mix=JMIX, seed=4,
                                  slo=jloadgen.SLO(p99_s=10.0,
                                                   goodput_frac=0.5),
                                  events=_drill(drill))
    assert _counts(rep) == _counts(jrep)
    assert rep.books == jrep.books and rep.books["balanced"]
    assert rep.offered_rps == jrep.offered_rps
    assert sorted(rep.resident_boards) == sorted(jrep.resident_boards)
    steps = {}
    for t in ours.resolved_tickets():
        if t.board is None:
            steps[t.session] = steps.get(t.session, 0) + t.steps
        else:
            np.testing.assert_array_equal(t.result,
                                          oracle_n(t.board, t.steps))
    for sid, board in rep.resident_boards.items():
        assert isinstance(board, np.ndarray)
        np.testing.assert_array_equal(board, jrep.resident_boards[sid])
        snap = ours.snapshot_session(sid)
        np.testing.assert_array_equal(snap, theirs.snapshot_session(sid))
        np.testing.assert_array_equal(
            snap, oracle_n(board, steps.get(sid, 0)),
            err_msg=f"resident session {sid} lost parity")
    if drill != "none":
        assert rep.books["rejoins"] == rep.books["drains"] == 1


# --------------------------------------- the JAX package's loadgen cases


def test_arrivals_poisson_deterministic_and_rate_true():
    a = arrivals_poisson(50.0, 4.0, seed=3)
    b = arrivals_poisson(50.0, 4.0, seed=3)
    assert a == b
    assert arrivals_poisson(50.0, 4.0, seed=4) != a
    assert all(0 <= x < 4.0 for x in a)
    assert all(y >= x for x, y in zip(a, a[1:]))
    assert 200 - 5 * np.sqrt(200) < len(a) < 200 + 5 * np.sqrt(200)


def test_arrivals_validation():
    with pytest.raises(ValueError, match="rate_rps"):
        arrivals_poisson(0.0, 1.0)
    with pytest.raises(ValueError, match="duration_s"):
        arrivals_poisson(1.0, -1.0)
    assert arrivals_trace([0.0, 0.5, 0.5, 2.0]) == [0.0, 0.5, 0.5, 2.0]
    with pytest.raises(ValueError, match=">= 0"):
        arrivals_trace([-0.1, 0.5])
    with pytest.raises(ValueError, match="non-decreasing"):
        arrivals_trace([0.5, 0.1])


def test_mix_and_slo_validation():
    with pytest.raises(ValueError, match="weight"):
        ScenarioMix(batch=-1.0)
    with pytest.raises(ValueError, match="sum to > 0"):
        ScenarioMix(batch=0.0)
    with pytest.raises(ValueError, match="sessions"):
        ScenarioMix(resident=1.0, sessions=0)
    with pytest.raises(ValueError, match="fill"):
        ScenarioMix(fill=1.5)
    w = ScenarioMix(batch=3.0, resident=1.0, sessions=2).weights()
    np.testing.assert_allclose(w, [0.75, 0.25, 0.0])

    with pytest.raises(ValueError, match="p99_s"):
        SLO(p99_s=0.0)
    with pytest.raises(ValueError, match="p999_s"):
        SLO(p99_s=0.5, p999_s=0.1)
    with pytest.raises(ValueError, match="goodput_frac"):
        SLO(goodput_frac=0.0)
    slo = SLO(p99_s=0.1, p999_s=0.5, goodput_frac=0.9)
    assert slo.verdict(goodput_rps=9.5, offered_rps=10.0,
                       p99_s=0.05, p999_s=0.4)
    assert not slo.verdict(goodput_rps=9.5, offered_rps=10.0,
                           p99_s=0.2, p999_s=0.4)
    assert not slo.verdict(goodput_rps=9.5, offered_rps=10.0,
                           p99_s=0.05, p999_s=0.6)
    assert not slo.verdict(goodput_rps=8.0, offered_rps=10.0,
                           p99_s=0.05, p999_s=0.4)


def test_run_open_loop_mixed_traffic_oracle_gated():
    f, _clk = _fleet(2)
    rep = run_open_loop(f, 40.0, 2.0, mix=MIX, seed=5,
                        slo=SLO(p99_s=10.0, goodput_frac=0.5))
    assert rep.offered == rep.submitted + rep.snapshots > 0
    assert rep.snapshots > 0
    assert rep.resolved + sum(rep.shed.values()) == rep.submitted
    assert rep.shed == {}
    assert rep.goodput_rps > 0 and rep.books["balanced"]
    assert rep.p50_s <= rep.p99_s <= rep.p999_s
    assert rep.slo_ok
    done = [t for h in f.handles for t in h.daemon.queue.tickets()
            if t.state == DONE and t.board is not None]
    assert done
    for t in done:
        np.testing.assert_array_equal(t.result, oracle_n(t.board, t.steps))
    steps_by_sid: dict = {}
    for h in f.handles:
        for t in h.daemon.queue.tickets():
            if t.state == DONE and t.session in rep.resident_boards:
                steps_by_sid[t.session] = (
                    steps_by_sid.get(t.session, 0) + t.steps)
    for sid, board in rep.resident_boards.items():
        np.testing.assert_array_equal(
            f.snapshot_session(sid),
            oracle_n(board, steps_by_sid.get(sid, 0)),
            err_msg=f"resident session {sid} lost parity")


def test_run_open_loop_is_deterministic():
    ra = run_open_loop(_fleet(2)[0], 30.0, 1.5, mix=MIX, seed=9)
    rb = run_open_loop(_fleet(2)[0], 30.0, 1.5, mix=MIX, seed=9)
    assert ra.to_dict() == rb.to_dict()


def test_run_open_loop_submits_on_schedule_not_on_completion():
    f, _clk = _fleet(1, policy=ServePolicy(max_batch=4, max_depth=8,
                                           max_wait_s=0.0))
    f.handles[0].halted = True
    trace = [i * 0.01 for i in range(30)]
    mix = ScenarioMix(batch=1.0, shapes=((12, 12),), steps=(2,))
    with pytest.raises(RuntimeError, match="failed to drain"):
        run_open_loop(f, 0.0, 0.30, mix=mix, trace=trace,
                      drain_timeout_s=0.5)
    books = f.router.books()
    assert books["submitted"] == 30
    assert books["admitted"] == 8
    assert books["door_shed"] == 22


def test_run_open_loop_fires_events():
    seen = []
    f, _clk = _fleet(2)
    run_open_loop(f, 20.0, 1.0, mix=MIX, seed=2,
                  events=[(0.5, lambda fl: seen.append(("mid", fl))),
                          (0.99, lambda fl: seen.append(("late", fl)))])
    assert [k for k, _ in seen] == ["mid", "late"]
    assert all(fl is f for _, fl in seen)


def test_sweep_monotone_ladder_and_knee():
    with pytest.raises(ValueError, match="strictly increasing"):
        sweep(lambda: _fleet(2)[0], [10.0, 10.0], 1.0)
    with pytest.raises(ValueError, match="at least one rate"):
        sweep(lambda: _fleet(2)[0], [], 1.0)

    reports = sweep(lambda: _fleet(2)[0], [10.0, 20.0], 1.5,
                    mix=MIX, slo=SLO(p99_s=10.0, goodput_frac=0.5),
                    seed=1)
    assert len(reports) == 2
    assert reports[0].offered_rps < reports[1].offered_rps
    knee = saturation_knee(reports)
    assert knee["knee_rps"] == round(reports[1].offered_rps, 3)
    assert knee["breach_rps"] is None
    assert [p["offered_rps"] for p in knee["points"]] == \
        [round(r.offered_rps, 3) for r in reports]


def test_saturation_knee_reads_last_passing_rung():
    def rep(rate, ok):
        return LoadgenReport(
            offered_rps=rate, duration_s=1.0, offered=int(rate),
            submitted=int(rate), resolved=int(rate), snapshots=0,
            shed={}, goodput_rps=rate, p50_s=0.01, p99_s=0.02,
            p999_s=0.03, slo_ok=ok, wall_s=1.0, books={})

    knee = saturation_knee([rep(10, True), rep(20, True),
                            rep(40, False), rep(80, False)])
    assert knee["knee_rps"] == 20.0 and knee["breach_rps"] == 40.0
    knee = saturation_knee([rep(10, False)])
    assert knee["knee_rps"] is None and knee["breach_rps"] == 10.0
    with pytest.raises(ValueError, match="at least one report"):
        saturation_knee([])


def _ctl(**kw):
    defaults = dict(slo_p99_s=0.1, min_workers=1, max_workers=4,
                    breach_k=3, surplus_k=3, cooldown_k=2)
    defaults.update(kw)
    return policy_mod.ElasticController(
        policy_mod.ElasticityPolicy(**defaults))


def test_controller_needs_consecutive_breaches():
    c = _ctl()
    assert c.observe(p99_s=0.5, depth=9, workers=2) is None
    assert c.observe(p99_s=0.5, depth=9, workers=2) is None
    assert c.observe(p99_s=0.08, depth=9, workers=2) is None
    assert c.observe(p99_s=0.5, depth=9, workers=2) is None
    assert c.observe(p99_s=0.5, depth=9, workers=2) is None
    assert c.observe(p99_s=0.5, depth=9, workers=2) \
        == policy_mod.SCALE_ADD
    assert c.actions == [policy_mod.SCALE_ADD]


def test_controller_cooldown_blocks_back_to_back_actions():
    c = _ctl(breach_k=1, cooldown_k=3)
    assert c.observe(p99_s=0.5, depth=9, workers=2) \
        == policy_mod.SCALE_ADD
    for _ in range(3):
        assert c.observe(p99_s=0.5, depth=9, workers=3) is None
    assert c.observe(p99_s=0.5, depth=9, workers=3) \
        == policy_mod.SCALE_ADD
    assert c.actions == [policy_mod.SCALE_ADD] * 2


def test_controller_cannot_flap_on_oscillating_signal():
    c = _ctl()
    for i in range(40):
        v = (c.observe(p99_s=0.5, depth=9, workers=2) if i % 2
             else c.observe(p99_s=0.0, depth=0, workers=2))
        assert v is None
    assert c.actions == []


def test_controller_respects_worker_bounds():
    c = _ctl(breach_k=1, surplus_k=1, cooldown_k=0)
    assert c.observe(p99_s=0.5, depth=9, workers=4) is None
    assert c.observe(p99_s=0.0, depth=0, workers=1) is None
    assert c.observe(p99_s=0.5, depth=9, workers=3) \
        == policy_mod.SCALE_ADD
    assert c.observe(p99_s=0.0, depth=0, workers=2) \
        == policy_mod.SCALE_DRAIN


def test_controller_starvation_counts_as_breach():
    c = _ctl(breach_k=2, cooldown_k=0)
    for _ in range(2):
        v = c.observe(p99_s=0.0, depth=50, workers=2,
                      goodput_rps=0.0, offered_rps=40.0)
    assert v == policy_mod.SCALE_ADD
    c = _ctl(breach_k=1, cooldown_k=0)
    assert c.observe(p99_s=0.01, depth=0, workers=2, goodput_rps=30.0,
                     offered_rps=40.0) == policy_mod.SCALE_ADD


def test_controller_surplus_needs_empty_queue():
    c = _ctl(surplus_k=1, cooldown_k=0)
    assert c.observe(p99_s=0.0, depth=5, workers=3) is None
    assert c.observe(p99_s=0.0, depth=0, workers=3) \
        == policy_mod.SCALE_DRAIN


def test_sentinel_polarity_for_loadgen_fields():
    sys.path.insert(0, os.path.join(REPO, "analysis"))
    import regression_sentinel as sentinel

    assert sentinel.direction_for("loadgen_goodput_rps") == "higher"
    assert sentinel.direction_for("loadgen_knee_rps") == "higher"
    assert sentinel.direction_for("loadgen_p999_latency_s") == "lower"
    assert sentinel.direction_for("rejoin_recovery_s") == "lower"
    for field in ("loadgen_goodput_rps", "loadgen_p999_latency_s",
                  "rejoin_recovery_s"):
        assert field in sentinel.WATCH_FIELDS
