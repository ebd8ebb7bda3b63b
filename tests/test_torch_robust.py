"""The port's robust layer held against the JAX package's.

Mirrors the plan, guard, Life-halo and preemption cases of
``tests/test_robust.py``: the ``MOMP_CHAOS`` parser (one string, the same
plan and the same errors in both packages), no injection when it is unset,
the engine-fallback ladder, halo faults caught by the guarded step (which
never hides a fault of a stepper on the card), simulated and signal-driven preemption with a flushed
checkpoint and a bit-identical resume, and the CLI's exit 75.

The JAX package injects halo faults when it traces a program, the port at
every exchange call; under ``halo=drop;noguard`` the two must end on the
same board, which shows the port faults the same ghosts. A ``corrupt``
ghost (a value in [2, 200)) overflows differently in the two packages'
Life rules, so there they are compared only on "the guard detects and
recovers". The JAX side runs on the 8 virtual CPU devices of
``conftest.py``, the port on meshes of virtual CPU shards.
"""

import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

from jax import lax

from conftest import oracle_n
from mpi_and_open_mp_tpu.apps import life as jax_life_app
from mpi_and_open_mp_tpu.models.life import LifeSim as JaxSim
from mpi_and_open_mp_tpu.parallel import halo as jhalo
from mpi_and_open_mp_tpu.parallel import haloplan as jhp
from mpi_and_open_mp_tpu.parallel import mesh as jmesh
from mpi_and_open_mp_tpu.robust import chaos as jchaos
from mpi_and_open_mp_tpu.robust import guards as jguards
from mpi_and_open_mp_tpu.utils.config import LifeConfig as JaxConfig

from mpi_and_open_mp_tpu_torch.apps import life as life_app
from mpi_and_open_mp_tpu_torch.models.life import LifeSim
from mpi_and_open_mp_tpu_torch.parallel import halo, haloplan
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.robust import chaos, guards, preempt
from mpi_and_open_mp_tpu_torch.utils import checkpoint
from mpi_and_open_mp_tpu_torch.utils.config import (
    config_from_board, save_config)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small array operations: one torch thread beside the other test
    processes of a parallel run, and the pool handed back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_chaos():
    """Fresh plan caches and recovery logs in both packages around every
    test: a plan carries runtime state (the preemption latch)."""
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
    monkeypatch.setenv("MOMP_CHAOS", spec)
    chaos.reset()
    jchaos.reset()


def _mesh(layout, shape):
    if layout == "cart":
        return mesh_lib.make_mesh_2d(*shape, device="cpu")
    axis = "x" if layout == "col" else "y"
    return mesh_lib.make_mesh_1d(shape[0], axis=axis, device="cpu")


def _jmesh(layout, shape):
    if layout == "cart":
        return jmesh.make_mesh_2d(*shape)
    return jmesh.make_mesh_1d(shape[0], axis="x" if layout == "col" else "y")


def _sim(cfg, layout="row", impl="halo", shape=(4,), **kw):
    return LifeSim(cfg, layout=layout, impl=impl, mesh=_mesh(layout, shape),
                   device="cpu", **kw)


def _jax_cfg(cfg):
    return JaxConfig(steps=cfg.steps, save_steps=cfg.save_steps, nx=cfg.nx,
                     ny=cfg.ny, cells=cfg.cells)


def _soup(shape, seed, density=0.35):
    return (np.random.default_rng(seed).random(shape) < density).astype(
        np.uint8)


# --------------------------------------------------------------- plan parsing


def test_fault_plan_parses_full_spec():
    plan = chaos.FaultPlan.parse(
        "nan_hop=1;halo=corrupt;delay=0.25;preempt=60;seed=7")
    assert plan.hop_poison == ("nan", 1)
    assert plan.halo_fault == "corrupt"
    assert plan.delay_s == 0.25
    assert plan.preempt_step == 60
    assert plan.seed == 7
    assert plan.guard
    plan = chaos.FaultPlan.parse("inf_hop=3;halo=drop;noguard")
    assert plan.hop_poison == ("inf", 3)
    assert plan.halo_fault == "drop"
    assert not plan.guard


BAD = ["nan_hop=x", "halo=melt", "delay=-1", "preempt=ten", "bogus=1",
       "noguard=1", "crash=elsewhere:1", "crash=mid-frame:0",
       "crash=post-admit:x", "serve_fail=-2", "kill_worker=-1",
       "kill_worker=0:0", "aot_corrupt=melt:1", "aot_corrupt=bitflip:0",
       "seed=1.5"]


@pytest.mark.parametrize("bad", BAD)
def test_fault_plan_rejects_bad_tokens_as_jax_does(bad):
    with pytest.raises(ValueError, match="MOMP_CHAOS") as ours:
        chaos.FaultPlan.parse(f"seed=1;{bad}")
    with pytest.raises(ValueError) as theirs:
        jchaos.FaultPlan.parse(f"seed=1;{bad}")
    assert str(ours.value) == str(theirs.value)


GOOD = ["", "halo=drop", "halo=corrupt;seed=11", "halo=drop;noguard",
        "preempt=5000;noguard", "delay=0.05;noguard",
        " preempt=3 ; ;halo=drop ",
        "nan_hop=1;halo=corrupt;delay=0.25;preempt=60;seed=7",
        "inf_hop=3;serve_fail=2", "crash=mid-frame:3", "crash=post-admit",
        "kill_worker=1:4", "kill_worker=2", "aot_corrupt=skew",
        "aot_corrupt=bitflip:3;seed=-4"]


@pytest.mark.parametrize("spec", GOOD)
def test_chaos_strings_parse_alike_in_both_packages(spec):
    """One MOMP_CHAOS string, one plan: every field of the port's plan
    equals the JAX package's (whose hit counters of unported hooks the
    port leaves out)."""
    ours = dataclasses.asdict(chaos.FaultPlan.parse(spec))
    theirs = dataclasses.asdict(jchaos.FaultPlan.parse(spec))
    assert ours == {k: theirs[k] for k in ours}


def test_active_plan_is_cached_per_spec(monkeypatch):
    _set_chaos(monkeypatch, "preempt=10")
    plan = chaos.active_plan()
    plan.preempt_fired = True
    assert chaos.active_plan() is plan  # the latch persists
    _set_chaos(monkeypatch, "preempt=11")
    assert chaos.active_plan().preempt_step == 11
    monkeypatch.setenv("MOMP_CHAOS", "")
    assert chaos.active_plan().preempt_step == 11  # read once, until reset
    chaos.reset()
    assert chaos.active_plan() is None


def test_preempt_pending_latch_and_resume_semantics():
    plan = chaos.FaultPlan.parse("preempt=60")
    assert plan.preempt_pending(0) and plan.preempt_pending(59)
    assert not plan.preempt_pending(60)
    assert not plan.preempt_pending(80)
    plan.preempt_fired = True
    assert not plan.preempt_pending(0)


def test_no_injection_when_unset(monkeypatch):
    """The hooks return their input, the same object, when no plan is
    active: nothing is launched or copied on the default path."""
    monkeypatch.delenv("MOMP_CHAOS", raising=False)
    chaos.reset()
    assert chaos.active_plan() is None
    assert chaos.halo_ghost_spec() is None
    ghost = torch.ones((2, 8))
    assert halo._chaos_ghost(ghost) is ghost
    _set_chaos(monkeypatch, "preempt=5")  # a plan without a halo fault
    assert chaos.halo_ghost_spec() is None
    assert halo._chaos_ghost(ghost) is ghost


def test_suppressed_hides_an_active_plan(monkeypatch):
    _set_chaos(monkeypatch, "halo=drop")
    assert chaos.active_plan() is not None
    with chaos.suppressed():
        assert chaos.active_plan() is None
        with chaos.suppressed():
            assert chaos.active_plan() is None
        assert chaos.active_plan() is None
    assert chaos.active_plan() is not None


@pytest.mark.parametrize("spec", ["halo=drop", "halo=corrupt",
                                  "halo=corrupt;seed=3",
                                  "halo=corrupt;seed=11"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.float32])
def test_corrupt_ghost_matches_jax(monkeypatch, spec, dtype):
    """The faulted ghost holds the JAX package's value: 0, or its seeded
    draw from [2, 200)."""
    import jax.numpy as jnp

    _set_chaos(monkeypatch, spec)
    ghost = torch.arange(6, dtype=dtype).reshape(2, 3)
    ours = halo._chaos_ghost(ghost)
    assert ours.dtype == dtype and ours.shape == ghost.shape
    theirs = jhalo._chaos_ghost(jnp.asarray(ghost.numpy()))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


# ------------------------------------------------------------ with_fallback


def test_with_fallback_first_engine_clean():
    out, stamp, notes = guards.with_fallback(
        [("a", lambda: 1), ("b", lambda: 2)])
    assert (out, stamp, notes) == (1, "a", [])


def test_with_fallback_recovers_with_provenance():
    def boom():
        raise RuntimeError("kernel fault")

    out, stamp, notes = guards.with_fallback(
        [("a", boom), ("b", lambda: 2)])
    assert out == 2 and stamp == "b:recovered"
    assert notes == ["a: RuntimeError: kernel fault"]


def test_with_fallback_validator_failure_and_exhaustion():
    out, stamp, _ = guards.with_fallback(
        [("a", lambda: float("nan")), ("b", lambda: 1.0)],
        validator=guards.all_finite)
    assert out == 1.0 and stamp == "b:recovered"
    with pytest.raises(guards.FallbackExhausted, match="a failed validation"):
        guards.with_fallback([("a", lambda: torch.tensor([np.inf]))],
                             validator=guards.all_finite)


def test_with_fallback_retries_same_engine():
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) == 1:
            raise RuntimeError("transient")
        return 42

    out, stamp, _ = guards.with_fallback([("a", flaky)], retries=2)
    assert out == 42 and stamp == "a:recovered" and len(attempts) == 2


@pytest.mark.parametrize("spec,guard_env,want", [
    ("", "0", False), ("", "1", True), ("halo=drop", "0", True),
    ("halo=drop;noguard", "0", False), ("preempt=4;noguard", "1", True)])
def test_guards_active_as_jax(monkeypatch, spec, guard_env, want):
    monkeypatch.setenv("MOMP_GUARD", guard_env)
    _set_chaos(monkeypatch, spec)
    assert guards.guards_active() is want is jguards.guards_active()


def test_recovery_log_is_capped():
    for i in range(guards.RECOVERY_LOG_CAP + 10):
        guards.record_recovery(f"s{i}")
    log = guards.recovery_log()
    assert len(log) == guards.RECOVERY_LOG_CAP and log[-1] == f"s{i}"
    guards.reset_recovery_log()
    assert guards.recovery_log() == []


# ------------------------------------------------------- LifeSim halo guard


def test_halo_drop_noguard_diverges(monkeypatch, make_board):
    board = make_board(32, 32)
    cfg = config_from_board(board, steps=6, save_steps=0)
    _set_chaos(monkeypatch, "halo=drop;noguard")
    sim = _sim(cfg)
    final = sim.run(save=False)
    assert not np.array_equal(final, oracle_n(board, 6))
    assert sim.recoveries == [] and guards.recovery_log() == []


@pytest.mark.parametrize("fault", ["corrupt", "drop"])
def test_halo_fault_guard_recovers_bit_identical(monkeypatch, make_board,
                                                 fault):
    board = make_board(32, 32)
    cfg = config_from_board(board, steps=12, save_steps=4)
    _set_chaos(monkeypatch, f"halo={fault};seed=3")
    sim = _sim(cfg)
    final = sim.run(save=False)
    np.testing.assert_array_equal(final, oracle_n(board, 12))
    assert sim.recoveries and "life_step:halo:recovered" in sim.recoveries[0]
    assert guards.recovery_log() == ["life_step:halo:recovered"]


def test_halo_guard_cart_layout(monkeypatch, make_board):
    board = make_board(32, 24)
    cfg = config_from_board(board, steps=8, save_steps=0)
    _set_chaos(monkeypatch, "halo=corrupt;seed=11")
    sim = _sim(cfg, "cart", "halo", (2, 2))
    np.testing.assert_array_equal(sim.run(save=False), oracle_n(board, 8))
    assert sim.recoveries


def test_guard_falls_back_to_the_oracle(monkeypatch, make_board):
    """A stepper that diverges even with injection suppressed: the guard
    replays the segment on the NumPy oracle and stamps it."""
    board = make_board(24, 24)
    cfg = config_from_board(board, steps=9, save_steps=0)
    monkeypatch.setenv("MOMP_GUARD", "1")
    sim = _sim(cfg, "row", "halo", (2,))
    healthy = sim._advance
    sim._advance = lambda b, n: healthy(b, n + 1)
    np.testing.assert_array_equal(sim.run(), oracle_n(board, 9))
    assert guards.recovery_log() == ["life_step:numpy-oracle:recovered"]
    assert "diverge" in sim.recoveries[0]


def test_guard_raises_on_the_card_when_the_clean_rerun_diverges(
        monkeypatch, make_board):
    """On the card a stepper that diverges even with injection suppressed
    is a kernel fault: the guard raises, naming both divergences, and
    never replays the card's segment on the host oracle. The card is
    faked: the sim says cuda, its tensors stay on the CPU."""
    board = make_board(24, 24)
    cfg = config_from_board(board, steps=9, save_steps=0)
    monkeypatch.setenv("MOMP_GUARD", "1")
    sim = _sim(cfg, "row", "halo", (2,))
    sim.debug_check()  # places the probe board while the sim is on the CPU
    monkeypatch.setattr(sim, "device", torch.device("cuda"))
    healthy = sim._advance
    sim._advance = lambda b, n: healthy(b, n + 1)
    with pytest.raises(guards.FallbackExhausted) as ei:
        sim.run()
    assert len(ei.value.notes) == 2
    assert all(n.startswith("life_step:halo: AssertionError: ")
               and "diverge" in n for n in ei.value.notes)
    assert sim.recoveries == [] and guards.recovery_log() == []


def test_halo_fault_guard_recovers_on_the_card_without_the_oracle(
        monkeypatch, make_board):
    """A halo fault on the (faked) card is healed by the clean re-run
    alone, which is all the card's guard may do."""
    board = make_board(32, 32)
    cfg = config_from_board(board, steps=12, save_steps=4)
    sim = _sim(cfg, "row", "native", (2,))
    sim.debug_check()  # before the plan: the probe board, placed clean
    monkeypatch.setattr(sim, "device", torch.device("cuda"))
    _set_chaos(monkeypatch, "halo=corrupt;seed=5")
    np.testing.assert_array_equal(sim.run(save=False), oracle_n(board, 12))
    assert guards.recovery_log() == ["life_step:native:recovered"]


def test_guard_env_clean_run_records_nothing(monkeypatch, make_board):
    """MOMP_GUARD=1 on a healthy run checks every segment and never
    replaces a board: no recovery without a fault."""
    board = make_board(32, 32)
    cfg = config_from_board(board, steps=20, save_steps=5)
    monkeypatch.setenv("MOMP_GUARD", "1")
    for layout, impl, shape in [("row", "native", (2,)),
                                ("cart", "bitfused", (1, 1))]:
        sim = _sim(cfg, layout, impl, shape)
        np.testing.assert_array_equal(sim.run(), oracle_n(board, 20))
        assert sim.recoveries == []
    assert guards.recovery_log() == []


def test_delay_token_paces_segments(monkeypatch, make_board):
    from mpi_and_open_mp_tpu_torch.models import life as life_model

    cfg = config_from_board(make_board(16, 16), steps=20, save_steps=0)
    slept = []
    monkeypatch.setattr(life_model.time, "sleep", slept.append)
    _set_chaos(monkeypatch, "delay=0.25;preempt=10;noguard")
    with pytest.raises(preempt.SimulatedPreemption):
        _sim(cfg, "row", "halo", (2,)).run()
    assert slept == [0.25]


# (impl, layout, mesh shape): the port's impl and the JAX package's.
PARITY = [("halo", "row", (2,)), ("halo", "cart", (2, 2)),
          ("native", "row", (2,)), ("native", "cart", (2, 2)),
          ("bitfused", "row", (2,)), ("halo", "col", (4,)),
          ("roll", "cart", (2, 2))]
JAX_IMPL = {"native": "pallas"}


@pytest.mark.parametrize("impl,layout,shape", PARITY,
                         ids=[f"{a}-{b}" for a, b, _ in PARITY])
def test_halo_drop_noguard_matches_jax(monkeypatch, impl, layout, shape):
    """Under halo=drop;noguard both packages fault the same ghosts: the
    boards agree bit for bit, and differ from the oracle (the fault
    landed; roll exchanges no ghosts and stays on the oracle)."""
    board = _soup((64, 64), 17)
    steps = 40 if impl == "bitfused" else 12
    cfg = config_from_board(board, steps=steps, save_steps=0)
    _set_chaos(monkeypatch, "halo=drop;noguard")
    ours = _sim(cfg, layout, impl, shape).run()
    theirs = np.asarray(JaxSim(_jax_cfg(cfg), layout=layout,
                               impl=JAX_IMPL.get(impl, impl),
                               mesh=_jmesh(layout, shape)).run())
    np.testing.assert_array_equal(ours, theirs)
    assert np.array_equal(ours, oracle_n(board, steps)) is (impl == "roll")


@pytest.mark.parametrize("impl,layout,shape", PARITY[:4],
                         ids=[f"{a}-{b}" for a, b, _ in PARITY[:4]])
def test_halo_corrupt_guard_recovers_in_both_packages(monkeypatch, impl,
                                                      layout, shape):
    board = _soup((32, 32), 19)
    cfg = config_from_board(board, steps=8, save_steps=4)
    _set_chaos(monkeypatch, "halo=corrupt;seed=5")
    sim = _sim(cfg, layout, impl, shape)
    ours = sim.run()
    jsim = JaxSim(_jax_cfg(cfg), layout=layout,
                  impl=JAX_IMPL.get(impl, impl), mesh=_jmesh(layout, shape))
    theirs = np.asarray(jsim.run())
    want = oracle_n(board, 8)
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(theirs, want)
    assert sim.recoveries and jsim.recoveries
    stamp = f"life_step:{impl}:recovered"
    assert guards.recovery_log()[0] == stamp
    assert jguards.recovery_log()[0] == (
        f"life_step:{JAX_IMPL.get(impl, impl)}:recovered")


def _arm_rdma(monkeypatch):
    """The RDMA rung in both packages off the card, as
    ``test_torch_halo_rdma.py`` arms it: the flag on, the JAX backend and
    the port's card faked, JAX's transport a ppermute pair."""
    def jax_pair(fwd, bwd, axis_name, p, *, collective_id):
        return (lax.ppermute(fwd, axis_name, jhalo.ring_perm(p, 1)),
                lax.ppermute(bwd, axis_name, jhalo.ring_perm(p, -1)))

    monkeypatch.setenv(jhp.ENV_RDMA, "1")
    monkeypatch.setattr(jhp.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jhp, "_rdma_edge_pair", jax_pair)
    monkeypatch.setattr(haloplan, "on_card", lambda device: True)
    jhp._plan.cache_clear()
    haloplan._plan.cache_clear()


@pytest.mark.parametrize("layout,shape", [("row", (4,)), ("col", (4,)),
                                          ("cart", (2, 2)), ("cart", (4, 1))])
@pytest.mark.parametrize("fault", ["drop", "corrupt"])
def test_rdma_frame_faults_the_ghosts_jax_faults(monkeypatch, layout, shape,
                                                 fault):
    """On the rung the port faults its frame's rows and columns where the
    JAX package's pair calls fault their ghosts: under drop the boards
    agree bit for bit, and the frame hook alone (over an unhooked frame)
    gives the hooked sequential round's frame: the first d rows on a y
    ring, the first d columns on an x ring."""
    _arm_rdma(monkeypatch)
    try:
        board = _soup((48, 48), 23)
        cfg = config_from_board(board, steps=10, save_steps=0)
        _set_chaos(monkeypatch, f"halo={fault};noguard;seed=2")
        sim = _sim(cfg, layout, "halo", shape, fuse_steps=2)
        assert sim.plan_note == "overlap:rdma"
        ours = sim.run()
        if fault == "drop":
            theirs = np.asarray(JaxSim(
                _jax_cfg(cfg), layout=layout, impl="halo", fuse_steps=2,
                mesh=_jmesh(layout, shape)).run())
            np.testing.assert_array_equal(ours, theirs)
        assert not np.array_equal(ours, oracle_n(board, 10))
        block = mesh_lib.shard(torch.from_numpy(board), sim._py, sim._px)
        plan = sim._halo_plan(2)
        plain = haloplan.padded_round_block(layout, block, plan.depth)

        def unhooked(b, depth, lay):
            with chaos.suppressed():
                return haloplan.native_halo.halo_frame_plain(b, depth, lay)

        monkeypatch.setattr(haloplan.native_halo, "halo_frame", unhooked)
        rings = haloplan.native_halo.FRAME_RINGS[layout]
        hooked = haloplan._rdma_frame(block, plan, collective_ids=tuple(
            haloplan.COLLECTIVE_IDS[a] for a in rings))
        assert torch.equal(hooked, plain)
        d, v = plan.depth, chaos.ghost_value((fault, 2))
        assert bool((hooked[..., :d, :] == v).all()) is ("y" in rings)
        assert bool((hooked[..., :, :d] == v).all()) is ("x" in rings)
    finally:
        jhp._plan.cache_clear()
        haloplan._plan.cache_clear()


# ------------------------------------------------------ preemption + resume


def test_simulated_preemption_checkpoint_resume_bit_identity(
        monkeypatch, make_board, tmp_path):
    board = make_board(32, 32)
    cfg = config_from_board(board, steps=100, save_steps=0)
    ck = tmp_path / "ck"
    _set_chaos(monkeypatch, "preempt=60")
    sim = _sim(cfg, checkpoint_dir=ck, checkpoint_every=20)
    with pytest.raises(preempt.SimulatedPreemption) as ei:
        sim.run()
    assert ei.value.step == 60 and ei.value.signum is None
    assert ei.value.checkpoint.endswith("step_000060.state")
    assert sorted(os.listdir(ck)) == [
        "step_000020.state", "step_000040.state", "step_000060.state"]
    chaos.reset()  # a fresh process: a new latch, the same spec
    resumed = LifeSim.from_checkpoint(
        ck / "step_000060.state", cfg, layout="cart", impl="halo",
        mesh=_mesh("cart", (2, 2)), device="cpu", checkpoint_dir=ck,
        checkpoint_every=20)
    assert resumed.step_count == 60
    np.testing.assert_array_equal(resumed.run(), oracle_n(board, 100))


def test_preemption_without_checkpoint_dir(monkeypatch, make_board):
    cfg = config_from_board(make_board(16, 16), steps=20, save_steps=0)
    _set_chaos(monkeypatch, "preempt=10;noguard")
    sim = _sim(cfg, "row", "halo", (2,))
    with pytest.raises(preempt.SimulatedPreemption) as ei:
        sim.run(save=True)
    assert ei.value.checkpoint is None and ei.value.step == 10


@pytest.mark.parametrize("layout,impl,shape", [
    ("row", "halo", (4,)), ("serial", "native", None),
    ("row", "bitfused", (2,))])
def test_sigterm_flushes_checkpoint_and_resumes(monkeypatch, make_board,
                                                tmp_path, layout, impl,
                                                shape):
    """A real SIGTERM, delivered by a wrapped step after its third segment:
    the handler only sets a flag; the loop flushes a checkpoint at the next
    boundary and raises Preempted(signum=SIGTERM); the resume is
    bit-identical."""
    board = _soup((64, 64), 29)
    cfg = config_from_board(board, steps=100, save_steps=0)
    ck = tmp_path / "ck"
    sim = LifeSim(cfg, layout=layout, impl=impl, device="cpu",
                  mesh=None if shape is None else _mesh(layout, shape),
                  checkpoint_dir=ck, checkpoint_every=15)
    step, calls = sim.step, []

    def step_then_signal(n=1):
        step(n)
        calls.append(n)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    sim.step = step_then_signal
    # A late SIGTERM must meet this no-op, not pytest's default handler.
    prev = signal.signal(signal.SIGTERM, lambda *a: None)
    try:
        with pytest.raises(preempt.Preempted) as ei:
            sim.run()
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert ei.value.signum == signal.SIGTERM and ei.value.step == 45
    assert ei.value.checkpoint.endswith("step_000045.state")
    assert sorted(os.listdir(ck)) == [
        "step_000015.state", "step_000030.state", "step_000045.state"]
    path, at = life_app.find_latest_checkpoint(str(ck))
    assert at == 45
    resumed = LifeSim.from_checkpoint(path, cfg, layout="row", impl="halo",
                                      mesh=_mesh("row", (2,)), device="cpu")
    np.testing.assert_array_equal(resumed.run(save=False),
                                  oracle_n(board, 100))


def test_flush_on_signal_restores_handlers():
    prev = signal.getsignal(signal.SIGTERM)
    with preempt.flush_on_signal() as watch:
        assert watch.fired is None
        assert signal.getsignal(signal.SIGTERM) is not prev
    assert signal.getsignal(signal.SIGTERM) is prev
    with preempt.flush_on_signal(enabled=False):
        assert signal.getsignal(signal.SIGTERM) is prev


def test_flush_on_signal_is_a_noop_off_the_main_thread():
    import threading

    seen = {}

    def body():
        prev = signal.getsignal(signal.SIGTERM)
        with preempt.flush_on_signal() as watch:
            seen["same"] = signal.getsignal(signal.SIGTERM) is prev
            seen["fired"] = watch.fired

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert seen == {"same": True, "fired": None}


def test_preempted_message_as_jax():
    from mpi_and_open_mp_tpu.robust import preempt as jpreempt

    for args in [(10,), (12, "ck/step_000012.state"), (7, None, 15)]:
        assert str(preempt.Preempted(*args)) == str(jpreempt.Preempted(*args))
    assert preempt.EXIT_PREEMPTED == jpreempt.EXIT_PREEMPTED == 75


# ------------------------------------------------------------------- the CLI


def test_life_cli_preempt_exits_75(tmp_path, capsys, make_board,
                                   monkeypatch):
    cfg = config_from_board(make_board(16, 16), steps=20, save_steps=0)
    cfg_path = tmp_path / "run.cfg"
    save_config(cfg_path, cfg)
    ck = tmp_path / "ck"
    _set_chaos(monkeypatch, "preempt=10;noguard")
    argv = [str(cfg_path), "--layout", "row", "--impl", "halo",
            "--virtual-devices", "2", "--device", "cpu",
            "--checkpoint-dir", str(ck)]
    assert life_app.main(argv + ["--checkpoint-every", "5"]) == 75
    assert "requeue with --resume" in capsys.readouterr().err
    assert "step_000010.state" in os.listdir(ck)
    monkeypatch.delenv("MOMP_CHAOS")
    chaos.reset()
    assert life_app.main(argv + ["--resume"]) == 0
    assert "resuming from checkpoint" in capsys.readouterr().err


def test_cli_preempt_and_resume_match_jax(tmp_path, capsys, monkeypatch):
    """Both CLIs on one command line under MOMP_CHAOS=preempt=K: exit 75 at
    the same step with the same message, then --resume (the spec still
    set, as a requeued job sees it) to the same final population."""
    board = _soup((40, 40), 31)
    cfg = config_from_board(board, steps=60, save_steps=0)
    cfg_path = tmp_path / "run.cfg"
    save_config(cfg_path, cfg)
    _set_chaos(monkeypatch, "preempt=35;noguard")
    common = [str(cfg_path), "--layout", "row", "--impl", "halo",
              "--checkpoint-every", "10", "--print-final-population"]
    port = ["--device", "cpu", "--virtual-devices", "4", "--devices", "4"]
    out = {}
    for name, main, extra in [("port", life_app.main, port),
                              ("jax", jax_life_app.main, [])]:
        ck = str(tmp_path / name)
        argv = common + extra + ["--checkpoint-dir", ck]
        assert main(argv) == 75
        err = capsys.readouterr().err.strip().splitlines()[-1]
        chaos.reset()
        jchaos.reset()
        assert main(argv + ["--resume"]) == 0
        out[name] = (err.replace(ck, "CK").replace(".state", ""),
                     capsys.readouterr().err.strip().splitlines()[-1])
    assert out["port"] == out["jax"]
    assert out["port"][0] == ("preempted at step 35 by chaos plan; checkpoint"
                              " CK/step_000035 -- requeue with --resume")
    assert int(out["port"][1]) == int(oracle_n(board, 60).sum())


def test_cli_prints_recoveries(tmp_path, capsys, monkeypatch):
    board = _soup((32, 32), 37)
    cfg = config_from_board(board, steps=12, save_steps=0)
    cfg_path = tmp_path / "run.cfg"
    save_config(cfg_path, cfg)
    _set_chaos(monkeypatch, "halo=drop")
    assert life_app.main([str(cfg_path), "--layout", "cart", "--impl",
                          "native", "--virtual-devices", "4", "--device",
                          "cpu", "--print-final-population"]) == 0
    err = capsys.readouterr().err.strip().splitlines()
    assert err[0].startswith("recovered: life_step:native:recovered (")
    assert int(err[-1]) == int(oracle_n(board, 12).sum())


def test_checkpoint_flush_holds_the_boundary_board(monkeypatch, tmp_path):
    """The flushed file holds the board at the boundary it names."""
    board = _soup((32, 32), 41)
    cfg = config_from_board(board, steps=40, save_steps=0)
    _set_chaos(monkeypatch, "preempt=23;noguard")
    sim = _sim(cfg, "cart", "native", (2, 2), checkpoint_dir=tmp_path)
    with pytest.raises(preempt.SimulatedPreemption):
        sim.run()
    got, step = checkpoint.restore(tmp_path / "step_000023.state")
    assert step == 23
    np.testing.assert_array_equal(got, oracle_n(board, 23))
