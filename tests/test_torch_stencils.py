"""The port's stencil subsystem held against the JAX package's.

Boards are numpy arrays from a seeded ``spec.init``, handed to both
packages. The JAX side runs its jnp paths, its NumPy oracle, and its
Pallas stencil kernel in interpret mode (as ``tests/test_tune.py`` runs
it); the port runs on the CPU, where ``ops.native_stencil``'s wrapper
takes the kernel's plain version (the CUDA kernel is held against that on
the card by ``chip_smoke.py``).

Tolerances: integer specs (life, wireworld) exact. Float specs (heat,
gray_scott, lenia) within ``parity_tol_for(family)`` of the JAX package's
``stencils/engine.py`` - offset rtol 1e-5 / atol 1e-6, sep 1e-4 / 1e-5,
fft 1e-3 / 1e-4 - since torch and XLA round float sums, ``exp`` and FFTs
in their own ways. The two NumPy oracles run the same numpy code: exact.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_and_open_mp_tpu import stencils as J
from mpi_and_open_mp_tpu.models.life import LifeSim as JaxSim
from mpi_and_open_mp_tpu.ops import pallas_life as jpl
from mpi_and_open_mp_tpu.serve import ShapeBucketBatcher as JaxBatcher
from mpi_and_open_mp_tpu.stencils import engine as JE
from mpi_and_open_mp_tpu.stencils import spec as JS
from mpi_and_open_mp_tpu.stencils.sparse import ActiveTileEngine as JaxTiles
from mpi_and_open_mp_tpu.utils.config import load_config as jax_load_config
from mpi_and_open_mp_tpu_torch import LifeSim, load_config
from mpi_and_open_mp_tpu_torch import stencils as T
from mpi_and_open_mp_tpu_torch.ops import native_stencil as ns
from mpi_and_open_mp_tpu_torch.serve import ShapeBucketBatcher
from mpi_and_open_mp_tpu_torch.stencils import engine as TE
from mpi_and_open_mp_tpu_torch.stencils import spec as TS
from mpi_and_open_mp_tpu_torch.stencils.sparse import ActiveTileEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLIDER = os.path.join(ROOT, "tests", "fixtures", "glider_10x10.cfg")

NAMES = ("gray_scott", "heat", "lenia", "life", "wireworld")
RADII = (2, 3, 4, 8, 16)
SHAPES = [(24, 32), (17, 23)]


def _pair(name):
    return J.get(name), T.get(name)


def _board(name, shape, seed=46):
    return J.get(name).init(np.random.default_rng(seed), shape)


def _stack(name, shape, seed=46):
    spec = J.get(name)
    b, ny, nx = shape
    rng = np.random.default_rng(seed)
    return np.stack([spec.init(rng, (ny, nx)) for _ in range(b)])


def _pad_wrap(board, r):
    width = [(0, 0)] * (board.ndim - 2) + [(r, r), (r, r)]
    return np.pad(board, width, mode="wrap")


def _agree(jspec, got, want, family="offset"):
    """Integer specs exact; float specs within parity_tol_for(family)."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype == jspec.np_dtype
    assert JE.parity_ok(jspec, got, want, **JE.parity_tol_for(family)), (
        jspec.name, float(np.abs(got.astype(np.float64) - want).max()))


# ----------------------------------------------------------- registry, tables


def test_registry_names_match():
    assert T.names() == J.names() == NAMES


@pytest.mark.parametrize("make", [f"reg:{n}" for n in NAMES]
                         + [f"lenia_r{r}" for r in RADII])
def test_spec_tables_match(make):
    if make.startswith("reg:"):
        jspec, tspec = _pair(make[4:])
    else:
        r = int(make.split("_r")[1])
        jspec, tspec = JS.make_lenia(r), TS.make_lenia(r)
    for field in ("name", "radius", "dtype", "weights", "channels",
                  "boundary", "states"):
        assert getattr(tspec, field) == getattr(jspec, field), field
    assert TE.offsets(tspec) == JE.offsets(jspec)
    assert tspec.separable_rank == jspec.separable_rank
    assert TE._sep_factors(tspec) == JE._sep_factors(jspec)
    assert TE.separable_supported(tspec) == JE.separable_supported(jspec)
    assert TE.fft_supported(tspec) == JE.fft_supported(jspec)


@pytest.mark.parametrize("name", NAMES)
def test_init_draws_the_same_boards(name):
    jspec, tspec = _pair(name)
    for shape in [(24, 32), (64, 64), (17, 23)]:
        a = jspec.init(np.random.default_rng(7), shape)
        b = tspec.init(np.random.default_rng(7), shape)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert b.shape == tspec.board_shape(*shape)
        assert tspec.valid_board(b)


def test_register_refuses_bad_tables():
    bad = TS.StencilSpec(name="bad", radius=1, dtype="uint8",
                         weights=((1, 1, 1), (1, 1, 1), (1, 1, 1)),
                         update=TS._life_update)
    with pytest.raises(ValueError, match="center"):
        TS.register(bad)
    with pytest.raises(ValueError, match="already registered"):
        TS.register(T.LIFE)
    with pytest.raises(KeyError, match="registered"):
        T.get("warp-drive")


# --------------------------------------------------------------- the steps


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", NAMES)
def test_steps_match_jax(name, shape):
    """step_roll, step_padded and step_numpy, 5 chained steps each."""
    jspec, tspec = _pair(name)
    board = _board(name, shape)
    r = tspec.radius
    want_roll = board
    got_roll = torch.from_numpy(board)
    want_pad = board
    got_pad = torch.from_numpy(board)
    want_np = got_np = board
    for _ in range(5):
        want_roll = JE.step_roll(jspec, jnp.asarray(want_roll))
        got_roll = TE.step_roll(tspec, got_roll)
        want_pad = JE.step_padded(jspec, jnp.asarray(
            _pad_wrap(np.asarray(want_pad), r)))
        got_pad = TE.step_padded(tspec, torch.from_numpy(
            _pad_wrap(got_pad.numpy(), r)))
        want_np = JE.step_numpy(jspec, want_np)
        got_np = TE.step_numpy(tspec, got_np)
    _agree(jspec, got_roll.numpy(), want_roll)
    _agree(jspec, got_pad.numpy(), want_pad)
    assert np.array_equal(got_np, want_np)  # the same numpy arithmetic
    _agree(jspec, got_roll.numpy(), want_np)
    assert np.array_equal(TE.oracle_run(tspec, board, 5), want_np)


@pytest.mark.parametrize("name", NAMES)
def test_run_roll_and_batch_match_jax(name):
    jspec, tspec = _pair(name)
    board = _board(name, (16, 20), seed=3)
    got = TE.run_roll(tspec, torch.from_numpy(board), 5)
    _agree(jspec, got.numpy(), JE.run_roll(jspec, jnp.asarray(board), 5))
    stack = _stack(name, (3, 16, 20), seed=4)
    got = TE.run_roll_batch(tspec, torch.from_numpy(stack), 5)
    want = JE.run_roll_batch(jspec, jnp.asarray(stack), 5)
    assert got.shape == stack.shape
    _agree(jspec, got.numpy(), want)
    for i in range(3):
        _agree(jspec, got[i].numpy(), JE.oracle_run(jspec, stack[i], 5))


# ------------------------------------------------------------ engine families


@pytest.mark.parametrize("family", ["sep", "fft"])
@pytest.mark.parametrize("which", ["lenia", "lenia_r4"])
def test_run_family_and_batch_match_jax(which, family):
    if which == "lenia":
        jspec, tspec = _pair("lenia")
    else:
        jspec, tspec = JS.make_lenia(4), TS.make_lenia(4)
    board = jspec.init(np.random.default_rng(11), (24, 24))
    got = TE.run_family(tspec, torch.from_numpy(board), 5, family)
    want = JE.run_family(jspec, jnp.asarray(board), 5, family)
    _agree(jspec, got.numpy(), want, family)
    _agree(jspec, got.numpy(), JE.oracle_run(jspec, board, 5), family)
    rng = np.random.default_rng(12)
    stack = np.stack([jspec.init(rng, (16, 16)) for _ in range(2)])
    got = TE.run_family_batch(tspec, torch.from_numpy(stack), 5, family)
    want = JE.run_family_batch(jspec, jnp.asarray(stack), 5, family)
    _agree(jspec, got.numpy(), want, family)
    # The padded twins, one step over a wrap-padded block.
    r = tspec.radius
    padded = _pad_wrap(board, r)
    got = TE.step_padded_family(tspec, torch.from_numpy(padded), family)
    want = JE.step_padded_family(jspec, jnp.asarray(padded), family)
    _agree(jspec, got.numpy(), want, family)


def test_family_refusals_raise():
    heat, life = T.get("heat"), T.get("life")
    board = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="do not factor"):
        TE.run_family(heat, board, 1, "sep")
    with pytest.raises(ValueError, match="float dtype"):
        TE.run_family(life, board.to(torch.uint8), 1, "fft")
    with pytest.raises(ValueError, match="do not factor"):
        TE.run_family_batch(heat, board[None], 1, "sep")
    with pytest.raises(ValueError, match="unknown engine family"):
        TE.run_family(heat, board, 1, "warp")
    with pytest.raises(ValueError, match="unknown engine family"):
        TE.parity_tol_for("warp")
    for fam in TE.ENGINE_FAMILIES:
        assert TE.parity_tol_for(fam) == JE.parity_tol_for(fam)
    assert TE.FFT_MIN_RADIUS == JE.FFT_MIN_RADIUS
    assert [TE.family_for_path(p) for p in
            ("stencil:sep", "stencil:fft", "stencil:roll")] == [
        "sep", "fft", "offset"]


def test_engine_family_pin(monkeypatch):
    monkeypatch.delenv(TE.ENV_FAMILY, raising=False)
    assert TE.family_pinned() is None
    assert all(TE.family_allowed(f) for f in TE.ENGINE_FAMILIES)
    monkeypatch.setenv(TE.ENV_FAMILY, "sep")
    assert TE.family_pinned() == JE.family_pinned() == "sep"
    assert [TE.family_allowed(f) for f in TE.ENGINE_FAMILIES] == [
        JE.family_allowed(f) for f in JE.ENGINE_FAMILIES] == [
        True, True, False]
    monkeypatch.setenv(TE.ENV_FAMILY, "warp")
    with pytest.raises(ValueError, match="MOMP_ENGINE_FAMILY"):
        TE.family_pinned()


# ------------------------------------------------------ the kernel's wrapper


def _padded_case(name, shape):
    jspec, tspec = _pair(name)
    board = _board(name, shape, seed=9)
    return jspec, tspec, _pad_wrap(board, tspec.radius)


@pytest.mark.parametrize("shape", [(24, 32), (17, 23), (5, 6)],
                         ids=["24x32", "17x23", "5x6"])
@pytest.mark.parametrize("name", NAMES)
def test_stencil_step_padded_matches_pallas(name, shape):
    """Every spec against the JAX Pallas kernel in interpret mode;
    gray_scott as one (2, h+2, w+2) block. At 5x6, lenia's radius-8 halo
    is wider than the board (wrapped more than once)."""
    jspec, tspec, padded = _padded_case(name, shape)
    got = ns.stencil_step_padded(tspec, torch.from_numpy(padded))
    want = jpl.stencil_step_padded_pallas(jspec, jnp.asarray(padded))
    assert got.shape == tuple(want.shape) == tspec.board_shape(*shape)
    _agree(jspec, got.numpy(), want)
    _agree(jspec, got.numpy(), JE.step_numpy(jspec, _board(name, shape, 9)))


@pytest.mark.parametrize("name,shape,r", [
    ("lenia", (5, 6), 8), ("gray_scott", (7, 4), 3), ("life", (17, 23), 1)])
def test_torus_pad_matches_numpy_wrap(name, shape, r):
    """One gather pads any depth, also wider than the board (lenia's
    radius 8 on 5x6), channels riding through."""
    board = _board(name, shape, seed=2)
    got = TE.torus_pad(torch.from_numpy(board), r)
    assert np.array_equal(got.numpy(), _pad_wrap(board, r))


def test_stencil_step_padded_refuses_bad_blocks():
    gs = T.get("gray_scott")
    with pytest.raises(ValueError, match="third-to-last"):
        ns.stencil_step_padded(gs, torch.zeros((3, 3, 6, 6)))
    # A stack of 2-channel boards, channels third from last, steps each.
    stack = torch.from_numpy(np.stack(
        [gs.init(np.random.default_rng(s), (4, 4)) for s in (1, 2)]))
    padded = TE.torus_pad(stack, 1)
    both = ns.stencil_step_padded(gs, padded)
    for i in range(2):
        assert torch.equal(both[i], ns.stencil_step_padded(gs, padded[i]))
    with pytest.raises(ValueError, match="extents"):
        ns.stencil_step_padded(T.get("lenia"), torch.zeros((16, 30)))


@pytest.mark.parametrize("name", ["life", "heat", "wireworld", "lenia"])
def test_run_padded_native_batch_matches_pallas_batch(name):
    jspec, tspec = _pair(name)
    stack = _stack(name, (3, 16, 16))
    assert TE.native_batch_supported(tspec, stack.shape)
    assert JE.pallas_batch_supported(jspec, stack.shape)
    got = TE.run_padded_native_batch(tspec, torch.from_numpy(stack), 5)
    want = JE.run_padded_pallas_batch(jspec, jnp.asarray(stack), 5)
    _agree(jspec, got.numpy(), want)
    for i in range(3):
        _agree(jspec, got[i].numpy(), JE.oracle_run(jspec, stack[i], 5))


def test_native_batch_supported_matches_jax():
    for name in NAMES:
        jspec, tspec = _pair(name)
        for shape in [(4, 8, 8), (8, 8), (4, 2, 8, 8)]:
            assert (TE.native_batch_supported(tspec, shape)
                    == JE.pallas_batch_supported(jspec, shape))


def test_kernel_rule_lookup():
    """The wrapper picks the rule by the update function: every
    make_lenia(r) is lenia; a spec with no kernel rule raises."""
    assert [ns.kernel_rule(T.get(n)).rule for n in
            ("life", "heat", "gray_scott", "wireworld", "lenia")] == [
        0, 1, 2, 3, 4]
    for r in RADII:
        assert ns.kernel_rule(TS.make_lenia(r)).rule == 4
        assert ns.fits_shared_memory(TS.make_lenia(r))
    # The kernel's block holds lenia's tile and weights up to r = 61.
    assert ns.fits_shared_memory(TS.make_lenia(55))
    assert ns.fits_shared_memory(TS.make_lenia(61))
    assert not ns.fits_shared_memory(TS.make_lenia(62))

    def majority(center, agg, xp):
        return TS.cast(agg >= 5, center)

    odd = TS.StencilSpec(name="majority", radius=1, dtype="uint8",
                         weights=TS.BOX3, update=majority)
    with pytest.raises(ValueError, match="no rule"):
        ns.kernel_rule(odd)
    # Heat's rule on an integer board is not the kernel's rule either.
    int_heat = TS.StencilSpec(name="int_heat", radius=1, dtype="uint8",
                              weights=TS.CROSS3, update=TS._heat_update)
    with pytest.raises(ValueError, match="no rule"):
        ns.kernel_rule(int_heat)
    # On the CPU the wrapper still runs the plain step for such a spec.
    padded = np.random.default_rng(0).integers(0, 2, (6, 7), np.uint8)
    got = ns.stencil_step_padded(odd, torch.from_numpy(padded))
    want = TE.step_padded(odd, padded, np)
    assert np.array_equal(got.numpy(), want)


# -------------------------------------------------------------- sparse tiles


def test_active_tiles_match_jax_on_a_glider_crossing_tiles():
    board = np.zeros((256, 256), np.uint8)
    board[30:33, 30:33] = [[0, 1, 0], [0, 0, 1], [1, 1, 1]]
    ours = ActiveTileEngine(T.get("life"), board, tile=32, device="cpu")
    theirs = JaxTiles(J.get("life"), board, tile=32)
    got = ours.step(200)
    want = theirs.step(200)
    assert np.array_equal(got, want)
    assert np.array_equal(got, JE.oracle_run(J.get("life"), board, 200))
    assert ours.counters() == theirs.counters()
    assert ours.engine_stamp == theirs.engine_stamp == "sparse:t32"


def test_active_tiles_gray_scott_and_crossover_match_jax():
    jspec, tspec = _pair("gray_scott")
    board = _board("gray_scott", (64, 64), seed=5)
    ours = ActiveTileEngine(tspec, board, tile=32, device="cpu")
    theirs = JaxTiles(jspec, board, tile=32)
    _agree(jspec, ours.step(6), theirs.step(6))
    assert ours.counters() == theirs.counters()
    life = _board("life", (64, 64), seed=6)
    ours = ActiveTileEngine(T.get("life"), life, tile=16, crossover=0.25,
                            device="cpu")
    theirs = JaxTiles(J.get("life"), life, tile=16, crossover=0.25)
    assert np.array_equal(ours.step(4), theirs.step(4))
    assert ours.counters() == theirs.counters()
    assert ours.engine_stamp == theirs.engine_stamp
    with pytest.raises(ValueError, match="must divide"):
        ActiveTileEngine(T.get("life"), np.zeros((60, 64), np.uint8),
                         tile=32, device="cpu")


# ------------------------------------------------------------------ LifeSim


@pytest.mark.parametrize("workload,steps", [
    ("heat", None), ("gray_scott", None), ("wireworld", None), ("lenia", 8)])
def test_lifesim_workload_matches_jax(workload, steps):
    """The serial LifeSim on glider_10x10.cfg's geometry: heat, gray_scott
    and wireworld over the cfg's 100 steps, lenia over 8 (its noise grows
    ~1.5x a step)."""
    ours = LifeSim(load_config(GLIDER), layout="serial", workload=workload,
                   device="cpu")
    theirs = JaxSim(jax_load_config(GLIDER), layout="serial",
                    workload=workload)
    assert ours.impl == theirs.impl == "roll"
    assert np.array_equal(ours.collect(), theirs.collect())
    if steps is None:
        got, want = ours.run(), theirs.run()
    else:
        ours.step(steps)
        theirs.step(steps)
        got, want = ours.collect(), theirs.collect()
    _agree(J.get(workload), got, want)
    ours.debug_check()


def test_lifesim_workload_refusals():
    cfg = load_config(GLIDER)
    with pytest.raises(ValueError, match="native"):
        LifeSim(cfg, workload="heat", impl="native", layout="serial", device="cpu")
    with pytest.raises(ValueError, match="no batched mode"):
        LifeSim(cfg, workload="heat", layout="serial", device="cpu",
                initial_board=np.zeros((3, 10, 10), np.float32))
    with pytest.raises(ValueError, match="no batched mode"):
        LifeSim(cfg, workload="gray_scott", layout="serial", device="cpu",
                initial_board=np.zeros((3, 2, 10, 10), np.float32))
    with pytest.raises(ValueError, match="expected"):
        LifeSim(cfg, workload="gray_scott", layout="serial", device="cpu",
                initial_board=np.zeros((10, 10), np.float32))
    with pytest.raises(KeyError, match="registered"):
        LifeSim(cfg, workload="warp-drive", layout="serial", device="cpu")
    sim = LifeSim(cfg, workload="heat", layout="serial", device="cpu")
    sim._advance = lambda board, n: board  # a stepper that never steps
    with pytest.raises(AssertionError, match="diverge"):
        sim.debug_check()


# ------------------------------------------------------------------ batcher


def test_batcher_mixed_workloads_match_jax():
    rng = np.random.default_rng(21)
    reqs = []
    for i in range(9):
        name = ("life", "heat", "wireworld", "gray_scott")[i % 4]
        shape = (12, 16) if i % 3 else (10, 10)
        reqs.append((J.get(name).init(rng, shape), 3 + (i % 2), name))
    ours = ShapeBucketBatcher(max_batch=4, device="cpu")
    theirs = JaxBatcher(max_batch=4)
    for board, steps, name in reqs:
        assert ours.submit(board, steps, workload=name) == theirs.submit(
            board, steps, workload=name)
    assert ours.bucket_keys() == theirs.bucket_keys()
    got, want = ours.flush(), theirs.flush()
    for (board, steps, name), g, w in zip(reqs, got, want):
        _agree(J.get(name), g, np.asarray(w))
        _agree(J.get(name), g, JE.oracle_run(J.get(name), board, steps))
    def stats(batcher):
        # Life's path names its engine, which differs by package on the
        # CPU (the JAX package's "xla" loop is the port's "plain"); every
        # other workload's path is "stencil:<name>" in both.
        return [(s.shape, s.steps, s.requests, s.padded_batch,
                 s.path if s.path.startswith("stencil:") else "life",
                 s.tickets) for s in batcher.last_flush_stats]

    assert stats(ours) == stats(theirs)
    assert {s[4] for s in stats(ours)} == {
        "life", "stencil:heat", "stencil:wireworld", "stencil:gray_scott"}
