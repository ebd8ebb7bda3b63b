"""The port's remote-copy ghost rung (``MOMP_HALO_RDMA=1``) held against the
JAX package's.

The JAX package stamps ``overlap:rdma`` only on a TPU and moves its ghost
pairs through a Pallas remote-copy kernel that has no interpret mode. Its
own tests run the rung's schedule on the 8-device CPU mesh of
``conftest.py`` by setting the flag, faking the backend and stubbing the
transport with a ``ppermute`` pair (``tests/test_partitioned_halo.py``);
this file arms it the same way. The port stamps ``overlap:rdma`` for
shards on a CUDA device; here its card predicate ``haloplan.on_card`` is
faked instead, and the transport, ``ops.native_halo.edge_pair``, takes its
plain version because the shards lie on the CPU. The kernel itself is held
against that plain version on the card by ``chip_smoke.py``.

Life boards must match exactly, float specs within
``parity_tol_for("offset")`` against the JAX package and bit for bit
against the port's own deferred schedule.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from conftest import oracle_n
from mpi_and_open_mp_tpu import stencils as jstencils
from mpi_and_open_mp_tpu.models.life import LifeSim as JaxSim
from mpi_and_open_mp_tpu.parallel import halo as jhalo
from mpi_and_open_mp_tpu.parallel import haloplan as jhp
from mpi_and_open_mp_tpu.parallel import mesh as jmesh
from mpi_and_open_mp_tpu.stencils import engine as jengine
from mpi_and_open_mp_tpu.utils.config import LifeConfig as JaxConfig

from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.models.life import LifeSim
from mpi_and_open_mp_tpu_torch.ops import native_halo
from mpi_and_open_mp_tpu_torch.parallel import haloplan
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.utils.config import LifeConfig

TOL = stencils.parity_tol_for("offset")


@pytest.fixture(autouse=True)
def _clean_plans():
    """Both plan caches key on the flags; the faked backend and card are
    not part of JAX's key, so no armed plan may outlive its test."""
    jhp._plan.cache_clear()
    haloplan._plan.cache_clear()
    yield
    jhp._plan.cache_clear()
    haloplan._plan.cache_clear()


def _soup(shape, seed, density=0.35):
    return (np.random.default_rng(seed).random(shape) < density).astype(
        np.uint8)


def _arm(monkeypatch, calls=None):
    """Arm the rung in both packages: the flag on, the JAX backend and the
    port's card faked, and each transport wrapped to record its calls (JAX
    records calls as it traces a round). JAX's entries are ``(axis,
    collective_id)``, one per ghost pair; the port's are ``(kind,
    ((axis, collective_id), ...))``, one per transport call: ``"pair"``
    for an edge pair, ``"frame"`` for a coupled round's frame, which
    carries every ring of its layout."""
    calls = {"jax": [], "port": []} if calls is None else calls

    def jax_pair(fwd, bwd, axis_name, p, *, collective_id):
        calls["jax"].append((axis_name, collective_id))
        return (lax.ppermute(fwd, axis_name, jhalo.ring_perm(p, 1)),
                lax.ppermute(bwd, axis_name, jhalo.ring_perm(p, -1)))

    port_pair = haloplan._rdma_edge_pair
    port_frame = haloplan._rdma_frame

    def counted_pair(fwd, bwd, axis_name, p, *, collective_id):
        calls["port"].append(("pair", ((axis_name, collective_id),)))
        return port_pair(fwd, bwd, axis_name, p, collective_id=collective_id)

    def counted_frame(block, plan, *, collective_ids):
        rings = native_halo.FRAME_RINGS[plan.layout]
        calls["port"].append(("frame", tuple(zip(rings, collective_ids))))
        return port_frame(block, plan, collective_ids=collective_ids)

    monkeypatch.setenv(jhp.ENV_RDMA, "1")
    monkeypatch.setattr(jhp.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jhp, "_rdma_edge_pair", jax_pair)
    monkeypatch.setattr(haloplan, "on_card", lambda device: True)
    monkeypatch.setattr(haloplan, "_rdma_edge_pair", counted_pair)
    monkeypatch.setattr(haloplan, "_rdma_frame", counted_frame)
    jhp._plan.cache_clear()
    haloplan._plan.cache_clear()
    return calls


def _rings(port_calls):
    """Every (axis, collective_id) the port's transport calls carried."""
    return [ring for _, rings in port_calls for ring in rings]


# ------------------------------------------------ the transport, per shard

# (mesh shape, axis exchanged): row 8, col 8, cart 4x2 on both axes, and a
# 1-shard x axis (the self-wrap).
EXCHANGES = [((8, 1), "y"), ((1, 8), "x"), ((4, 2), "y"), ((4, 2), "x"),
             ((8, 1), "x")]
DTYPES = [("uint8", 1), ("int32", 1), ("float32", 1), ("float32", 2)]


def _board(dtype, channels, seed, shape=(64, 48)):
    rng = np.random.default_rng(seed)
    full = (channels, *shape) if channels > 1 else shape
    if dtype == "float32":
        return rng.random(full).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, full, dtype=dtype,
                        endpoint=True)


def _edges(b, depth, edge):
    """(forward, backward) edge slices of a block, JAX's orientation."""
    if edge == "y":
        return b[..., -depth:, :], b[..., :depth, :]
    return b[..., -depth:], b[..., :depth]


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("edge", ["y", "x"])
@pytest.mark.parametrize("exchange", EXCHANGES,
                         ids=lambda e: f"{e[0][0]}x{e[0][1]}-{e[1]}")
def test_edge_pair_plain_matches_jax_ppermute(exchange, edge, depth):
    """``edge_pair_plain`` (and ``edge_pair`` on CPU tensors) against a JAX
    ``lax.ppermute`` pair inside ``shard_map``, shard by shard, exactly:
    uint8, int32, float32 and a 2-channel float32 stack."""
    (py, px), axis = exchange
    jm = jmesh.make_mesh_2d(py, px)
    cat = -2 if edge == "y" else -1
    for dtype, channels in DTYPES:
        board = _board(dtype, channels, 10 * py + px + depth)
        lead = (None,) * (board.ndim - 2)
        spec = P(*lead, "y", "x")

        def fn(b):
            fwd, bwd = _edges(b, depth, edge)
            return jnp.concatenate(
                [lax.ppermute(fwd, axis, jhalo.ring_perm(jm.shape[axis], 1)),
                 lax.ppermute(bwd, axis,
                              jhalo.ring_perm(jm.shape[axis], -1))], cat)

        arr = jax.device_put(jnp.asarray(board), NamedSharding(jm, spec))
        want = np.asarray(jax.jit(jmesh.shard_map(
            fn, mesh=jm, in_specs=spec, out_specs=spec,
            check_vma=False))(arr))
        stack = mesh_lib.shard(torch.from_numpy(board), py, px)
        fwd, bwd = _edges(stack, depth, edge)
        got = native_halo.edge_pair_plain(fwd, bwd, axis)
        assert all(torch.equal(a, b) for a, b in zip(
            got, native_halo.edge_pair(fwd, bwd, axis)))
        ours = mesh_lib.unshard(torch.cat(got, cat)).numpy()
        assert ours.dtype == want.dtype
        assert np.array_equal(ours, want), (dtype, channels)


def test_edge_pair_refuses_mismatched_edges():
    stack = torch.zeros((4, 2, 8, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="differ"):
        native_halo.edge_pair(stack[..., :1, :], stack[..., :2, :], "y")
    with pytest.raises(ValueError, match="axis"):
        native_halo.edge_pair(stack[..., :1, :], stack[..., -1:, :], "z")
    with pytest.raises(ValueError, match="collective_id"):
        haloplan._rdma_edge_pair(stack[..., :1, :], stack[..., -1:, :], "y",
                                 4, collective_id=14)
    with pytest.raises(ValueError, match="p=2"):
        haloplan._rdma_edge_pair(stack[..., :1, :], stack[..., -1:, :], "y",
                                 2, collective_id=13)


def test_edge_strides_merge_channel_axes():
    """The kernel's strides: channel axes merge into one, x edges keep the
    row pitch, a layout whose channels do not merge is refused."""
    block = torch.zeros((4, 2, 3, 2, 16, 24))
    assert native_halo._edge_strides(block[..., -3:]) == (16 * 24, 24, 1)
    assert native_halo._edge_strides(block[:, :, 0, 0, :2, :]) == (0, 24, 1)
    with pytest.raises(ValueError, match="merge"):
        native_halo._edge_strides(block[:, :, :, :1].transpose(2, 3)
                                  .expand(4, 2, 2, 3, 16, 24))
    table = native_halo._offset_table(4, 2, "y", (10, 5), (10, 5), 7,
                                      torch.device("cpu"))
    # shard (0, 1) sends its forward edge to (1, 1) and its backward edge
    # to (3, 1)
    assert table[:, 1].tolist() == [5, 5, 3 * 7, 7 * 7]


# ------------------------------------------------------------ plan stamps

GEOMETRIES = [
    ("row", (4, 1), (64, 128), 1, 1, None, "cell"),
    ("row", (4, 1), (64, 128), 1, 4, 2, "cell"),
    ("col", (1, 8), (64, 16), 1, 2, 1, "cell"),
    ("cart", (4, 2), (12, 24), 1, 4, None, "cell"),
    ("cart", (4, 2), (12, 24), 2, 2, 1, "cell"),
    ("row", (2, 1), (128, 128), 32, 1, None, "packed"),
    ("row", (1, 1), (64, 128), 1, 1, None, "cell"),
    ("row", (4, 1), (2, 128), 1, 1, None, "cell"),
]


def _plans(geometry, device="cpu"):
    layout, axes, shard, radius, k, bs, pack = geometry
    ours = haloplan.plan_halo(layout, axes, shard, radius, k,
                              boundary_steps=bs, pack_layout=pack,
                              device=device)
    theirs = jhp.plan_halo(layout, axes, shard, radius, k,
                           boundary_steps=bs, pack_layout=pack)
    return ours, theirs


@pytest.mark.parametrize("armed", [True, False], ids=["card", "cpu"])
@pytest.mark.parametrize("geometry", GEOMETRIES,
                         ids=lambda g: f"{g[0]}-{g[1]}-{g[2]}-r{g[3]}k{g[4]}"
                                       f"b{g[5]}-{g[6]}")
def test_plan_stamps_match_jax_under_the_flag(monkeypatch, geometry, armed):
    """With the flag set: the card faked against JAX armed (``overlap:rdma``
    and ``overlap:rdma:pb1``), the CPU against JAX off a TPU
    (``overlap:deferred``); packed plans stay ``overlap:packed`` and
    degenerate geometry ``seq:*``, with the same ``why``."""
    if armed:
        _arm(monkeypatch)
    else:
        monkeypatch.setenv(haloplan.ENV_RDMA, "1")
    ours, theirs = _plans(geometry)
    assert ours == haloplan.HaloPlan(**theirs.__dict__)
    if geometry[-1] == "packed":
        assert ours.engine == "overlap:packed"
    elif ours.overlap:
        base = "overlap:rdma" if armed else "overlap:deferred"
        assert ours.engine.split(":pb")[0] == base
    assert haloplan.plan_halo(*geometry[:5], boundary_steps=geometry[5],
                              pack_layout=geometry[6], device="cpu") is ours


def test_plan_kill_switch_flag_flip_and_device(monkeypatch):
    """``MOMP_HALO_OVERLAP=0`` wins over the flag; flipping the flag gives
    a fresh plan object; the real predicate takes only a CUDA device."""
    geometry = GEOMETRIES[0]
    _arm(monkeypatch)
    armed, _ = _plans(geometry)
    assert armed.engine == "overlap:rdma"
    monkeypatch.setenv(haloplan.ENV_OVERLAP, "0")
    ours, theirs = _plans(geometry)
    assert ours.engine == theirs.engine == "seq:halo"
    assert ours.why == theirs.why
    monkeypatch.delenv(haloplan.ENV_OVERLAP)
    monkeypatch.setenv(haloplan.ENV_RDMA, "0")
    off, theirs = _plans(geometry)
    assert off.engine == theirs.engine == "overlap:deferred"
    assert off is not armed
    monkeypatch.setenv(haloplan.ENV_RDMA, "1")
    assert _plans(geometry)[0] is armed
    monkeypatch.undo()
    assert not haloplan.on_card(None)
    assert not haloplan.on_card("cpu")
    assert haloplan.on_card(torch.device("cuda", 0))


# --------------------------------------- the rung's schedule, end to end


def _runs(spec_name, board, steps, layout, boundary, mesh_shape=(4, 2)):
    """(port board, JAX board, port plan, JAX plan) of one run_sharded."""
    mesh = mesh_lib.make_mesh_2d(*mesh_shape, device="cpu")
    got = stencils.engine.run_sharded(
        stencils.get(spec_name), board, steps, mesh=mesh, layout=layout,
        fuse_steps=2, boundary_steps=boundary).numpy()
    plan = stencils.engine.run_sharded.last_plan
    want = np.asarray(jengine.run_sharded(
        jstencils.get(spec_name), board, steps,
        mesh=jmesh.make_mesh_2d(*mesh_shape), layout=layout, fuse_steps=2,
        boundary_steps=boundary))
    return got, want, plan, jengine.run_sharded.last_plan


@pytest.mark.parametrize("boundary", [None, 1], ids=["coupled", "pb1"])
@pytest.mark.parametrize("layout", ["row", "col", "cart"])
def test_rdma_schedule_matches_jax(monkeypatch, layout, boundary):
    """Life on 48^2, a 4x2 mesh, fuse_steps=2, 6 steps (3 rounds): boards
    bit-equal to JAX's armed run, stamps equal, collective ids 13 for y
    and 14 for x. The transport calls per round: JAX traces its round
    once, with one pair call per exchange (two on coupled cart: the
    corner exchange); the port calls per round. A partitioned round
    makes JAX's pair calls; a coupled round one frame call carrying the
    rings of JAX's pair calls."""
    calls = _arm(monkeypatch)
    board = _soup((48, 48), 48)
    got, want, plan, jplan = _runs("life", board, 6, layout, boundary)
    assert plan.engine == jplan.engine == (
        "overlap:rdma" + (":pb1" if boundary else ""))
    assert np.array_equal(got, want)
    assert np.array_equal(got, oracle_n(board, 6))
    assert calls["jax"]
    if boundary:
        assert _rings(calls["port"]) == calls["jax"] * 3
        assert {kind for kind, _ in calls["port"]} == {"pair"}
    else:
        assert calls["port"] == [("frame", tuple(calls["jax"]))] * 3
    for axis, cid in _rings(calls["port"]):
        assert cid == {"y": 13, "x": 14}[axis]
    exchanges = {("row", None): 1, ("col", None): 1, ("cart", None): 1,
                 ("row", 1): 2, ("col", 1): 2, ("cart", 1): 2}
    assert len(calls["port"]) == 3 * exchanges[layout, boundary]


@pytest.mark.parametrize("boundary", [None, 1], ids=["coupled", "pb1"])
@pytest.mark.parametrize("layout", ["row", "col", "cart"])
@pytest.mark.parametrize("workload", ["heat", "lenia"])
def test_rdma_float_stencils(monkeypatch, workload, layout, boundary):
    """Heat and lenia (r = 8) on the armed rung: bit-equal to the port's
    own deferred schedule, within ``parity_tol_for("offset")`` of JAX's
    armed run."""
    spec = stencils.get(workload)
    s = max(48, 20 * spec.radius)
    board = spec.init(np.random.default_rng(46), (s, s))
    mesh = mesh_lib.make_mesh_2d(4, 2, device="cpu")
    deferred = stencils.engine.run_sharded(
        spec, board, 4, mesh=mesh, layout=layout, fuse_steps=2,
        boundary_steps=boundary)
    assert stencils.engine.run_sharded.last_plan.engine.startswith(
        "overlap:deferred")
    calls = _arm(monkeypatch)
    got, want, plan, jplan = _runs(workload, board, 4, layout, boundary)
    assert plan.engine == jplan.engine
    assert plan.engine.startswith("overlap:rdma") and calls["port"]
    assert np.array_equal(got, deferred.numpy())
    assert stencils.parity_ok(spec, got, want, **TOL)


def _corner_glider_board(edge=64):
    """A glider aimed through the (4, 2) cart mesh's interior shard corner
    at (16, 32), as the JAX package's corner test places it."""
    b = np.zeros((edge, edge), np.uint8)
    b[10:13, 26:29] = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], np.uint8)
    return b


@pytest.mark.parametrize("boundary", [None, 1], ids=["coupled", "pb1"])
def test_cart_corner_glider_on_the_rung(monkeypatch, boundary):
    """The glider crosses the y edge, the x edge and the diagonal corner
    words (JAX's second phase forwards them; the port's coupled frame
    reads them from the diagonal shard); both packages' armed runs equal
    the oracle at 7 steps (a remainder round) and 24."""
    calls = _arm(monkeypatch)
    board = _corner_glider_board()
    for steps in (7, 24):
        got, want, plan, jplan = _runs("life", board, steps, "cart",
                                       boundary)
        assert plan.engine == jplan.engine
        assert plan.engine.startswith("overlap:rdma")
        assert np.array_equal(got, oracle_n(board, steps)), steps
        assert np.array_equal(want, oracle_n(board, steps)), steps
    assert ("x", 14) in _rings(calls["port"])
    assert ("y", 13) in _rings(calls["port"])


@pytest.mark.parametrize("fuse", [1, 3])
@pytest.mark.parametrize("layout,mshape", [("cart", (4, 2)), ("row", (8,))])
def test_lifesim_halo_on_the_rung_matches_jax(monkeypatch, layout, mshape,
                                              fuse):
    """``LifeSim(impl="halo")`` under the armed rung: the board and
    ``plan_note`` equal JAX's armed ``LifeSim``; the port's transport runs
    once a round, one frame (JAX's: two pairs on cart 4x2, one on row 8),
    carrying the rings of JAX's round."""
    calls = _arm(monkeypatch)
    board = _soup((64, 64), 70 + fuse)
    steps = 30
    kw = dict(steps=steps, save_steps=0, nx=64, ny=64,
              cells=np.zeros((0, 2), np.int64))
    if layout == "cart":
        mesh, jm = (mesh_lib.make_mesh_2d(*mshape, device="cpu"),
                    jmesh.make_mesh_2d(*mshape))
    else:
        mesh, jm = (mesh_lib.make_mesh_1d(8, device="cpu"),
                    jmesh.make_mesh_1d(8))
    sim = LifeSim(LifeConfig(**kw), layout=layout, impl="halo", mesh=mesh,
                  fuse_steps=fuse, initial_board=board)
    jsim = JaxSim(JaxConfig(**kw), layout=layout, impl="halo", mesh=jm,
                  fuse_steps=fuse, initial_board=board)
    got = sim.run()
    assert sim.plan_note == jsim.plan_note == "overlap:rdma"
    assert np.array_equal(got, np.asarray(jsim.run()))
    assert np.array_equal(got, oracle_n(board, steps))
    jax_round = [("y", 13), ("x", 14)] if layout == "cart" else [("y", 13)]
    assert set(calls["jax"]) == set(jax_round)
    assert calls["port"] == [("frame", tuple(jax_round))] * (steps // fuse)
