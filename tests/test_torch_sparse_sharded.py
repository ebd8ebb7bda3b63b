"""The port's sparse sharded engine (``stencils/sparse_sharded.py``) against
the JAX package's on the same numpy boards.

The JAX engine runs on the conftest 8-device CPU mesh; the port's on a
mesh of 8 virtual shards of the CPU (cart: 4 x 2, as the JAX package's
``make_mesh_2d()`` factorises 8). Integer boards are held bit for bit,
heat within ``parity_tol_for("offset")``; ``counters()``, ``engine_stamp``
and the plans' ``enabled``/``why`` are held equal on every case. The cases
are the JAX package's own (``tests/test_sparse_sharded.py``).
"""

import numpy as np
import pytest
import torch

from tests.conftest import oracle_n, random_board

from mpi_and_open_mp_tpu import stencils as jst
from mpi_and_open_mp_tpu.parallel import mesh as jmesh
from mpi_and_open_mp_tpu.stencils import sparse_sharded as jss

from mpi_and_open_mp_tpu_torch import stencils as tst
from mpi_and_open_mp_tpu_torch.parallel import mesh as tmesh
from mpi_and_open_mp_tpu_torch.stencils import engine as tengine
from mpi_and_open_mp_tpu_torch.stencils import sparse_sharded as tss

GLIDER = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], np.uint8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch operations a round: one thread keeps the module
    from spinning the pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes(layout):
    if layout == "cart":
        return jmesh.make_mesh_2d(), tmesh.make_mesh_2d(4, 2, device="cpu")
    axis = "x" if layout == "col" else "y"
    return (jmesh.make_mesh_1d(axis=axis),
            tmesh.make_mesh_1d(8, axis=axis, device="cpu"))


def _engines(name, board, layout="row", **kw):
    jm, tm = _meshes(layout)
    je = jss.SparseShardedEngine(jst.get(name), board, mesh=jm,
                                 layout=layout, **kw)
    te = tss.SparseShardedEngine(tst.get(name), board, mesh=tm,
                                 layout=layout, **kw)
    return je, te


def _same(je, te, name="life"):
    got, want = te.snapshot(), np.asarray(je.snapshot())
    if name == "heat":
        assert tengine.parity_ok(tst.get(name), got, want,
                                 **tengine.parity_tol_for("offset"))
    else:
        np.testing.assert_array_equal(got, want)
    assert te.counters() == je.counters()
    assert te.engine_stamp == je.engine_stamp
    assert (te.plan.enabled, te.plan.why, te.plan.engine) == (
        je.plan.enabled, je.plan.why, je.plan.engine)
    np.testing.assert_array_equal(te.active, je.active)


def _glider_board():
    """The JAX tests' 128^2 board: a glider crossing every row and column
    shard edge over 80 steps, a blinker and a domino that dies."""
    board = np.zeros((128, 128), np.uint8)
    board[1:4, 1:4] = GLIDER
    board[60, 60:63] = 1
    board[100:102, 36:38] = 1
    board[100:102, 38] = 0
    return board


@pytest.mark.parametrize("layout", ["row", "col", "cart"])
def test_glider_crosses_shard_edges(layout):
    board = _glider_board()
    je, te = _engines("life", board, layout, tile=16)
    done = 0
    # 5 and 37 land mid-round, so the tail rounds are held too.
    for n in (5, 16, 37, 80):
        te.step(n - done)
        je.step(n - done)
        done = n
        _same(je, te)
        np.testing.assert_array_equal(te.snapshot(), oracle_n(board, n))
    assert te.engine_stamp == f"sparse-sharded:{layout}:t16"
    c = te.counters()
    assert c["sparse_steps"] > 0 and c["tiles_skipped"] > c["tiles_stepped"]


@pytest.mark.parametrize("skip", [True, False])
def test_exchange_skip(skip):
    """Blinkers in shard interiors: with the skip, dead-boundary rounds
    ship no ghosts and the board stays the always-exchange board."""
    board = np.zeros((256, 256), np.uint8)
    board[8, 100:103] = 1
    board[72, 40:43] = 1
    je, te = _engines("life", board, "row", tile=32, fuse=4,
                      exchange_skip=skip)
    te.step(48)
    je.step(48)
    _same(je, te)
    np.testing.assert_array_equal(te.snapshot(), oracle_n(board, 48))
    c = te.counters()
    assert (c["exchange_skips"] > 0) == skip
    assert c["exchange_rounds"] > 0


def test_oscillator_period_divides_fuse():
    """A period-2 blinker at fuse 2: the consecutive-state wake diff keeps
    its tile awake."""
    board = np.zeros((128, 128), np.uint8)
    board[40, 40:43] = 1
    je, te = _engines("life", board, "row", tile=16, fuse=2)
    te.step(13)
    je.step(13)
    _same(je, te)
    assert te.active.any()


def test_settled_board_stops_launching():
    board = np.zeros((128, 128), np.uint8)
    board[40:42, 40:42] = 1  # block
    je, te = _engines("life", board, "row", tile=16)
    te.step(96)
    je.step(96)
    _same(je, te)
    np.testing.assert_array_equal(te.snapshot(), board)
    assert te.counters()["settled_steps"] > 0 and not te.active.any()


@pytest.mark.parametrize("layout", ["row", "cart"])
def test_soup_past_the_crossover(layout):
    board = random_board(np.random.default_rng(20260729), 128, 128)
    je, te = _engines("life", board, layout, tile=16, crossover=0.05)
    te.step(8)
    je.step(8)
    _same(je, te)
    assert te.engine_stamp == "dense:crossover"
    assert te.counters()["sparse_steps"] == 0


def test_soup_settles_back_to_sparse():
    """A soup that crosses over dense first, then sparse once the mask
    thins: the dense rung's mask rebuild feeds the sparse rounds."""
    board = np.zeros((128, 128), np.uint8)
    board[:32, :32] = random_board(np.random.default_rng(7), 32, 32)
    je, te = _engines("life", board, "row", tile=16, crossover=0.6, fuse=4)
    for _ in range(6):
        te.step(8)
        je.step(8)
        _same(je, te)
    c = te.counters()
    assert c["dense_steps"] > 0 and c["sparse_steps"] > 0


def test_bit_identity_vs_dense_sharded():
    board = _glider_board()
    _, tm = _meshes("row")
    te = tss.SparseShardedEngine(tst.get("life"), board, mesh=tm,
                                 layout="row", tile=16)
    te.step(64)
    run, _plan = tengine.make_sharded_runner(tst.get("life"), tm, "row",
                                             board.shape)
    dense = run(torch.from_numpy(board), 64)
    np.testing.assert_array_equal(te.snapshot(), dense.numpy())


def test_kill_switch_downgrades_to_dense_sharded(monkeypatch):
    monkeypatch.setenv(tss.ENV_SPARSE_SHARDED, "0")
    assert jss.ENV_SPARSE_SHARDED == tss.ENV_SPARSE_SHARDED
    board = _glider_board()
    je, te = _engines("life", board, "row", tile=16)
    assert not te.plan.enabled and tss.ENV_SPARSE_SHARDED in te.plan.why
    te.step(32)
    je.step(32)
    _same(je, te)
    assert te.engine_stamp == "dense:sharded"


@pytest.mark.parametrize("args", [
    ("row", (8, 1), (16, 128), 1, 32),
    ("row", (8, 1), (32, 256), 1, 32),
    ("cart", (4, 2), (32, 64), 8, 16),
    ("col", (1, 8), (128, 16), 17, 16),
])
def test_plan_gates(args):
    jp, tp = jss.plan_sparse_sharded(*args), tss.plan_sparse_sharded(*args)
    assert tp == tss.SparseShardedPlan(*(getattr(jp, f) for f in (
        "layout", "mesh_axes", "shard_shape", "tile", "crossover",
        "enabled", "engine", "why")))


def test_refusals_keep_the_jax_texts():
    _, tm = _meshes("row")
    jm, _ = _meshes("row")
    cases = [("gray_scott", np.zeros((2, 128, 128), np.float32), {}),
             ("life", np.zeros((128, 128), np.uint8), {"tile": 24}),
             ("life", np.zeros((120, 128), np.uint8), {"tile": 8}),
             ("life", np.zeros((124, 128), np.uint8), {"tile": 4}),
             ("lenia", np.zeros((128, 128), np.float32), {"tile": 4})]
    for name, board, kw in cases:
        with pytest.raises(ValueError) as want:
            jss.SparseShardedEngine(jst.get(name), board, mesh=jm, **kw)
        with pytest.raises(ValueError) as got:
            tss.SparseShardedEngine(tst.get(name), board, mesh=tm, **kw)
        assert str(got.value) == str(want.value)


def _wireworld_board():
    """A mostly empty 128^2 wireworld board: a conductor loop that an
    electron (head, tail) circles across the row-shard edge at y = 16,
    and a straight wire with one electron in another tile."""
    b = np.zeros((128, 128), np.uint8)
    b[10, 20:40] = 3
    b[22, 20:40] = 3
    b[10:23, 20] = 3
    b[10:23, 39] = 3
    b[10, 25], b[10, 24] = 1, 2
    b[90, 70:110] = 3
    b[90, 75], b[90, 74] = 1, 2
    return b


@pytest.mark.parametrize("layout", ["row", "cart"])
def test_wireworld(layout):
    board = _wireworld_board()
    je, te = _engines("wireworld", board, layout, tile=16, fuse=4)
    for _ in range(3):
        te.step(10)
        je.step(10)
        _same(je, te, "wireworld")


def test_heat_within_the_offset_tolerance():
    board = np.zeros((128, 128), np.float32)
    board[30:34, 14:18] = 1.0  # a hot spot astride a row-shard edge
    je, te = _engines("heat", board, "row", tile=16, fuse=4)
    for _ in range(3):
        te.step(6)
        je.step(6)
        _same(je, te, "heat")
