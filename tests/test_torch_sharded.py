"""The port's sharded Life layouts held against the JAX package's.

The JAX side runs on the 8 virtual CPU devices of ``conftest.py``; the
port runs the same layouts on meshes of 8 virtual shards of the CPU
(``parallel.mesh``), where every kernel wrapper takes its plain version.
Inputs are made from numpy seeds and handed to both. Life, Wireworld and
packed words must match exactly; float specs within
``stencils.engine.parity_tol_for("offset")`` (rtol 1e-5, atol 1e-6). The
JAX oracle is its cheap XLA impls (``roll``, ``halo``); its interpret-mode
Pallas kernels run only where the port's counterpart of that kernel is
under test.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_and_open_mp_tpu import stencils as jstencils
from mpi_and_open_mp_tpu.apps import life as jax_life_app
from mpi_and_open_mp_tpu.models.life import LifeSim as JaxSim
from mpi_and_open_mp_tpu.ops import bitlife as jbits
from mpi_and_open_mp_tpu.ops import pallas_life as jpl
from mpi_and_open_mp_tpu.parallel import halo as jhalo
from mpi_and_open_mp_tpu.parallel import haloplan as jhp
from mpi_and_open_mp_tpu.parallel import mesh as jmesh
from mpi_and_open_mp_tpu.utils.config import LifeConfig as JaxConfig

from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.apps import life as life_app
from mpi_and_open_mp_tpu_torch.models import life as life_model
from mpi_and_open_mp_tpu_torch.models.life import LifeSim, state_from_jax_sim
from mpi_and_open_mp_tpu_torch.ops import bitlife, native_life
from mpi_and_open_mp_tpu_torch.parallel import halo, haloplan
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.utils.config import LifeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLIDER = os.path.join(ROOT, "tests", "fixtures", "glider_10x10.cfg")
TOL = stencils.parity_tol_for("offset")

# (layout, mesh shape): 8 shards each, as the JAX tests' meshes.
LAYOUTS = {"row": (8,), "col": (8,), "cart": (4, 2)}


def _soup(shape, seed, density=0.35):
    return (np.random.default_rng(seed).random(shape) < density).astype(
        np.uint8)


def _cfg(board, steps):
    ny, nx = board.shape[-2:]
    kw = dict(steps=steps, save_steps=0, nx=nx, ny=ny,
              cells=np.zeros((0, 2), np.int64))
    return LifeConfig(**kw), JaxConfig(**kw)


def _meshes(layout, shape=None):
    """(port mesh on the CPU, JAX mesh) of the same shape."""
    shape = shape or LAYOUTS[layout]
    if layout == "cart":
        return (mesh_lib.make_mesh_2d(*shape, device="cpu"),
                jmesh.make_mesh_2d(*shape))
    axis = "x" if layout == "col" else "y"
    return (mesh_lib.make_mesh_1d(shape[0], axis=axis, device="cpu"),
            jmesh.make_mesh_1d(shape[0], axis=axis))


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX package's board after a run (cached per case): its halo
    impl where the board divides the mesh, else its roll impl."""
    shape, seed, layout, mshape, steps, workload = case
    board = (_soup(shape, seed) if workload == "life" else
             jstencils.get(workload).init(np.random.default_rng(seed), shape))
    _, jcfg = _cfg(board, steps)
    _, jm = _meshes(layout, mshape)
    py = mshape[0] if layout in ("row", "cart") else 1
    px = mshape[-1] if layout in ("col", "cart") else 1
    impl = "halo" if shape[0] % py == 0 and shape[1] % px == 0 else "roll"
    sim = JaxSim(jcfg, layout=layout, impl=impl, mesh=jm, initial_board=board,
                 workload=workload)
    return board, np.asarray(sim.run())


# --------------------------------------------------------------- mesh module


@pytest.mark.parametrize("ndims", [1, 2, 3])
def test_dims_create_and_decomposition_match_jax(ndims):
    for n in range(1, 65):
        assert mesh_lib.dims_create(n, ndims) == jmesh.dims_create(n, ndims)
        for p in range(1, 9):
            for k in range(p):
                assert (mesh_lib.decomposition(n, p, k)
                        == jmesh.decomposition(n, p, k))


def test_mesh_shapes_and_shard_round_trip():
    m = mesh_lib.make_mesh_2d(4, 2, device="cpu")
    assert m.shape == {"y": 4, "x": 2} and m.size == 8
    assert m.device == torch.device("cpu")
    assert mesh_lib.make_mesh_1d(device="cpu").shape == {"y": 1}
    assert mesh_lib.make_mesh_2d(device="cpu").shape == {"y": 1, "x": 1}
    with pytest.raises(ValueError, match="both"):
        mesh_lib.make_mesh_2d(4, device="cpu")
    board = torch.arange(3 * 8 * 6).reshape(3, 8, 6)
    stack = mesh_lib.shard(board, 4, 2)
    assert tuple(stack.shape) == (4, 2, 3, 2, 3)
    assert torch.equal(stack[1, 1], board[:, 2:4, 3:6])
    assert torch.equal(mesh_lib.unshard(stack), board)


def test_mesh_across_cards_raises(monkeypatch):
    """A mesh that would span several CUDA devices raises instead of
    folding onto card 0; more shards than cards are virtual."""
    monkeypatch.setattr(mesh_lib, "resolve_device",
                        lambda d="cuda": torch.device(d))
    monkeypatch.setattr(mesh_lib, "device_count", lambda d="cuda": 4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3") as err:
        mesh_lib.make_mesh_1d(device="cuda")
    assert "Queue 2" not in str(err.value)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        mesh_lib.make_mesh_2d(2, 2, device="cuda")
    assert mesh_lib.make_mesh_1d(8, device="cuda").size == 8
    assert mesh_lib.make_mesh_1d(2, device="cuda", virtual=True).size == 2


# --------------------------------------------------------------- halo module


def _jax_per_shard(fn, board, layout, mshape=None):
    """``fn`` under the JAX package's shard_map over ``board`` (numpy), its
    output split back into per-shard blocks ``[i][j]``."""
    _, jm = _meshes(layout, mshape)
    spec = {"row": P("y", None), "col": P(None, "x"),
            "cart": P("y", "x")}[layout]
    arr = jax.device_put(jnp.asarray(board), NamedSharding(jm, spec))
    out = np.asarray(jax.jit(jmesh.shard_map(
        fn, mesh=jm, in_specs=spec, out_specs=spec, check_vma=False))(arr))
    py = jm.shape.get("y", 1) if layout != "col" else 1
    px = jm.shape.get("x", 1) if layout != "row" else 1
    h, w = out.shape[0] // py, out.shape[1] // px
    return [[out[i * h:(i + 1) * h, j * w:(j + 1) * w] for j in range(px)]
            for i in range(py)]


@pytest.mark.parametrize("layout,depth", [("row", 1), ("row", 3),
                                          ("col", 2), ("cart", 1),
                                          ("cart", 3)])
def test_halo_pad_matches_jax_per_shard(layout, depth):
    board = _soup((64, 48), 3 + depth)
    py, px = {"row": (8, 1), "col": (1, 8), "cart": (4, 2)}[layout]
    if layout == "row":
        jfn, fn = jhalo.halo_pad_y, halo.halo_pad_y
        args = ("y", depth)
    elif layout == "col":
        jfn, fn = jhalo.halo_pad_x, halo.halo_pad_x
        args = ("x", depth)
    else:
        jfn, fn = jhalo.halo_pad_2d, halo.halo_pad_2d
        args = ("y", "x", depth)
    want = _jax_per_shard(lambda b: jfn(b, *args), board, layout)
    got = fn(mesh_lib.shard(torch.from_numpy(board), py, px), *args).numpy()
    for i in range(py):
        for j in range(px):
            assert np.array_equal(got[i, j], want[i][j]), (i, j)


@pytest.mark.parametrize("layout", ["row", "col", "cart"])
def test_round_blocks_and_pspec_match_jax(layout):
    """The sequential round's padded shards and the zero-sentinel twin,
    per shard, and the board's mesh axes, as the JAX package's."""
    board = _soup((64, 48), 9)
    py, px = {"row": (8, 1), "col": (1, 8), "cart": (4, 2)}[layout]
    stack = mesh_lib.shard(torch.from_numpy(board), py, px)
    for ours, theirs in ((haloplan.padded_round_block,
                          jhp.padded_round_block),
                         (haloplan.padded_round_block_local,
                          jhp.padded_round_block_local)):
        want = _jax_per_shard(lambda b: theirs(layout, b, 2), board, layout)
        got = ours(layout, stack, 2).numpy()
        for i in range(py):
            for j in range(px):
                assert np.array_equal(got[i, j], want[i][j]), (i, j)
    for channels in (1, 2):
        assert (stencils.sharded_pspec(layout, channels)
                == tuple(jstencils.engine.sharded_pspec(layout, channels)))
    assert halo.ring_perm(8, -1) == jhalo.ring_perm(8, -1)


@pytest.mark.parametrize("shape,py,h,pad", [
    ((256, 64), 4, 1, 26),    # nw_s = 2: funnel-shifted wrap, mirror rows
    ((512, 40), 4, 1, 90),    # pad past one word: a word-aligned mirror part
    ((256, 64), 4, 2, 0),     # exact frame: the plain ring exchange
])
def test_packed_halo_y_matches_jax_per_shard(shape, py, h, pad):
    frame = _soup(shape, 7 + pad)
    words = np.asarray(jbits.pack_board_exact(jnp.asarray(frame)))
    want = _jax_per_shard(
        lambda q: jhalo.packed_halo_y(q, "y", h, pad=pad), words, "row",
        (py,))
    stack = mesh_lib.shard(torch.from_numpy(words.view(np.int32).copy()), py, 1)
    got = halo.packed_halo_y(stack, "y", h, pad=pad).numpy()
    for i in range(py):
        assert np.array_equal(got[i, 0].view(np.uint32), want[i][0]), i


@pytest.mark.parametrize("nx,px,hx,pad", [
    (460, 4, 112, 3),         # the port's pitch for 457 columns over 4
    (504, 8, 59, 4),          # 500 columns over 8: W = 63, pad_x = 4
    (256, 4, 64, 0),          # exact: the plain ring exchange
])
def test_packed_halo_x_matches_jax_per_shard(nx, px, hx, pad):
    frame = _soup((64, nx), 11 + px)
    words = np.asarray(jbits.pack_board_exact(jnp.asarray(frame)))
    want = _jax_per_shard(
        lambda q: jhalo.packed_halo_x(q, "x", hx, pad=pad), words, "col",
        (px,))
    stack = mesh_lib.shard(torch.from_numpy(words.view(np.int32).copy()), 1, px)
    got = halo.packed_halo_x(stack, "x", hx, pad=pad).numpy()
    for j in range(px):
        assert np.array_equal(got[0, j].view(np.uint32), want[0][j]), j


# ------------------------------------------------------------ haloplan module

PLAN_GEOMETRIES = [
    ("row", (4, 1), (64, 128), 1, 1, "cell"),
    ("row", (4, 1), (64, 128), 1, 3, "cell"),
    ("row", (4, 1), (64, 128), 2, 3, "cell"),
    ("row", (2, 1), (128, 128), 32, 1, "packed"),
    ("row", (1, 1), (64, 128), 1, 1, "cell"),
    ("row", (4, 1), (2, 128), 1, 1, "cell"),
    ("row", (2, 1), (64, 128), 32, 1, "packed"),
    ("col", (4, 1), (64, 128), 1, 1, "cell"),
    ("col", (1, 8), (64, 6), 1, 1, "cell"),
    ("cart", (4, 2), (12, 24), 1, 4, "cell"),
]


@pytest.mark.parametrize("geometry", PLAN_GEOMETRIES,
                         ids=lambda g: f"{g[0]}-{g[1]}-{g[2]}-r{g[3]}k{g[4]}")
def test_plan_halo_stamps_match_jax(geometry):
    layout, axes, shard, radius, k, pack = geometry
    ours = haloplan.plan_halo(layout, axes, shard, radius, k,
                              pack_layout=pack)
    theirs = jhp.plan_halo(layout, axes, shard, radius, k, pack_layout=pack)
    assert ours == haloplan.HaloPlan(**theirs.__dict__)
    assert haloplan.plan_halo(layout, axes, shard, radius, k,
                              pack_layout=pack) is ours
    part = haloplan.plan_halo("row", (4, 1), (64, 128), 1, 4,
                              boundary_steps=2)
    assert part.engine == jhp.plan_halo("row", (4, 1), (64, 128), 1, 4,
                                        boundary_steps=2).engine


def test_plan_halo_kill_switch_and_rdma(monkeypatch):
    assert haloplan.plan_halo("row", (4, 1), (64, 128), 1, 1).overlap
    monkeypatch.setenv(haloplan.ENV_OVERLAP, "0")
    p = haloplan.plan_halo("row", (4, 1), (64, 128), 1, 1)
    assert not p.overlap and haloplan.ENV_OVERLAP in p.why
    monkeypatch.delenv(haloplan.ENV_OVERLAP)
    assert haloplan.plan_halo("row", (4, 1), (64, 128), 1, 1).overlap
    # Off the card the RDMA flag gives the deferred schedule, as the JAX
    # package's flag does off a TPU.
    monkeypatch.setenv(haloplan.ENV_RDMA, "1")
    ours = haloplan.plan_halo("row", (4, 1), (64, 128), 1, 1, device="cpu")
    theirs = jhp.plan_halo("row", (4, 1), (64, 128), 1, 1)
    assert ours.engine == theirs.engine == "overlap:deferred"
    assert ours == haloplan.HaloPlan(**theirs.__dict__)


@pytest.mark.parametrize("layout", ["row", "col", "cart"])
def test_overlap_bit_equals_sequential_every_spec(layout):
    """Overlap and sequential schedules give the same boards, and both the
    oracle's, for every registered spec, at fuse depth 1 and 4 (with a
    partitioned boundary at depth 4)."""
    for name in sorted(stencils.names()):
        spec = stencils.get(name)
        s = max(48, 12 * spec.radius)
        board = spec.init(np.random.default_rng(46), (s, s))
        mesh, _ = _meshes(layout)
        want = stencils.oracle_run(spec, board, 5)
        for fuse, bs in ((1, None), (4, None), (4, 2)):
            if not stencils.engine.fused_steps_valid(
                    spec, (s // 8, s // 2) if layout == "cart"
                    else (s // 8, s), fuse):
                continue
            got = stencils.engine.run_sharded(
                spec, board, 5, mesh=mesh, layout=layout, fuse_steps=fuse,
                boundary_steps=bs)
            plan = stencils.engine.run_sharded.last_plan
            seq = stencils.engine.run_sharded(
                spec, board, 5, mesh=mesh, layout=layout, fuse_steps=fuse,
                boundary_steps=bs, overlap=False)
            assert stencils.engine.run_sharded.last_plan.engine == "seq:halo"
            assert torch.equal(got, seq), (name, fuse, bs, plan.engine)
            assert stencils.parity_ok(spec, got.numpy(), want, **TOL), name


# ----------------------------------------------------- kernels' plain versions


@pytest.mark.parametrize("nw,W,h,hx", [(2, 128, 1, 0), (4, 64, 3, 16)])
def test_window_steps_plain_matches_jax_window_stepper(nw, W, h, hx):
    """The window kernel's plain version against the JAX package's
    ``make_window_stepper`` in interpret mode, k in {1, k_max}."""
    words = np.random.default_rng(nw * W).integers(
        0, 2 ** 32, (nw + 2 * h, W + 2 * hx), dtype=np.uint32)
    call = jbits.make_window_stepper(nw, W, h=h, halo_x=hx, interpret=True)
    k_max = bitlife.window_max_steps(h, hx)
    assert k_max == min(32 * h, hx or 128)
    for k in (1, k_max):
        want = np.asarray(call(jnp.asarray([k], jnp.int32),
                               jnp.asarray(words)))
        got = bitlife.window_steps(torch.from_numpy(words.view(np.int32)), k,
                                   h, hx)
        assert np.array_equal(got.numpy().view(np.uint32), want), k
    stack = torch.from_numpy(np.stack([words, words[::-1]]).view(np.int32))
    two = bitlife.window_steps(stack, 3, h, hx)
    assert torch.equal(two[0], bitlife.window_steps(stack[0], 3, h, hx))
    with pytest.raises(ValueError, match="outside"):
        bitlife.window_steps(stack, k_max + 1, h, hx)


@pytest.mark.parametrize("shape", [(10, 12), (34, 66)])
def test_life_step_padded_native_matches_jax_pallas(shape):
    block = _soup(shape, sum(shape)).astype(np.int32)
    want = np.asarray(jpl.life_step_padded_pallas(jnp.asarray(block)))
    got = native_life.life_step_padded_native(torch.from_numpy(block))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    stack = torch.from_numpy(np.stack([block, 1 - block]).astype(np.uint8))
    both = native_life.life_step_padded_native(stack)
    assert both.dtype == torch.uint8
    assert np.array_equal(both[0].numpy(), want)


def test_sharded_plans_follow_the_port_gates():
    """The port's own frame (no lane pitch): the unsharded plan is the
    serial frame runner's, and sharded plans carry W, pad_x and mode."""
    serial = bitlife.plan_sharded_bits((1000, 1000))
    assert (serial.py, serial.px, serial.mode) == (1, 1, "tiled")
    assert (serial.nw_s, serial.W) == (serial.nw, 1000)
    row = bitlife.plan_sharded_bits((500, 500), 8, 1, True, False)
    assert (row.nw_s, row.h, row.k_max, row.pad_y, row.mode) == (
        2, 1, 32, 12, "window")
    col = bitlife.plan_sharded_bits((500, 500), 1, 8, False, True)
    assert (col.W, col.pad_x, col.hx, col.k_max, col.frame) == (
        63, 4, 59, 59, (512, 504))
    big = bitlife.plan_sharded_bits((10000, 10000), 2, 2, True, True)
    assert big.mode == "tiled" and big.hx == 128 and big.k_max == 128
    ovl = bitlife.plan_sharded_bits((1024, 1024), 2, 1, True, False)
    assert bitlife.plan_overlap_supported(ovl) and ovl.nw_s == 16
    assert bitlife.plan_sharded_bits((64, 64), 8, 1, True, False) is None


# ------------------------------------------------------------- LifeSim parity

CASES = {
    "div256": ((256, 256), 21, 70),   # divides every mesh; fuse_steps 3
    "uneven500": ((500, 500), 22, 100),  # several k_max rounds, pad_y/x
}


@pytest.mark.parametrize("impl", ["roll", "halo", "native", "bitfused"])
@pytest.mark.parametrize("layout", ["row", "col", "cart"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lifesim_matches_jax(case, layout, impl):
    shape, seed, steps = CASES[case]
    board, want = _jax_run((shape, seed, layout, LAYOUTS[layout], steps,
                            "life"))
    cfg, _ = _cfg(board, steps)
    mesh, _ = _meshes(layout)
    py, px = life_model._mesh_divisors(layout, mesh)
    if impl in ("halo", "native") and (shape[0] % py or shape[1] % px):
        with pytest.raises(ValueError, match="divisible"):
            LifeSim(cfg, layout=layout, impl=impl, mesh=mesh,
                    initial_board=board)
        return
    for fuse in ((1, 3) if impl in ("halo", "native") else (1,)):
        sim = LifeSim(cfg, layout=layout, impl=impl, mesh=mesh,
                      fuse_steps=fuse, initial_board=board)
        got = sim.run()
        assert got.shape == shape and np.array_equal(got, want), fuse
        sim.debug_check()
        sim.reset()
        assert np.array_equal(sim.collect(), board)
    if impl == "bitfused":
        assert sim.plan_note == "window"
        assert sim.padded_shape == sim._plan.frame


@pytest.mark.parametrize("shape,layout,mshape,note", [
    ((1024, 1024), "row", (2,), "window+overlap:packed"),
    ((300, 263), "cart", (2, 2), "window"),       # pad_y 20, pad_x 1
    ((200, 700), "col", (4,), "window"),
    ((512, 200), "row", (8,), "window"),          # 2 words a shard, h = 2
])
def test_bitfused_geometries_match_jax(shape, layout, mshape, note):
    steps = 150
    board, want = _jax_run((shape, 31, layout, mshape, steps, "life"))
    cfg, _ = _cfg(board, steps)
    mesh, _ = _meshes(layout, mshape)
    sim = LifeSim(cfg, layout=layout, impl="bitfused", mesh=mesh,
                  initial_board=board)
    assert sim.plan_note == note
    assert np.array_equal(sim.run(), want)


def test_bitfused_overlap_kill_switch(monkeypatch):
    board, want = _jax_run(((1024, 1024), 31, "row", (2,), 150, "life"))
    monkeypatch.setenv(haloplan.ENV_OVERLAP, "0")
    cfg, _ = _cfg(board, 150)
    sim = LifeSim(cfg, layout="row", impl="bitfused",
                  mesh=_meshes("row", (2,))[0], initial_board=board)
    assert sim.plan_note == "window+seq:packed"
    assert np.array_equal(sim.run(), want)


@pytest.mark.parametrize("layout,mshape", [("cart", (2, 2)), ("row", (4,)),
                                           ("col", (2,))])
def test_bitfused_tiled_mode_matches_jax(monkeypatch, layout, mshape):
    """Shards past the window gate run the fused kernel per shard: a small
    shared-memory budget forces the tiled mode at test size."""
    plan_fn = bitlife.plan_sharded_bits

    def small_budget(shape, py=1, px=1, y_sharded=False, x_sharded=False):
        return plan_fn(shape, py, px, y_sharded, x_sharded, budget=24_000)

    monkeypatch.setattr(bitlife, "plan_sharded_bits", small_budget)
    shape, steps = (450, 420), 140
    board, want = _jax_run((shape, 41, layout, mshape, steps, "life"))
    cfg, _ = _cfg(board, steps)
    sim = LifeSim(cfg, layout=layout, impl="bitfused",
                  mesh=_meshes(layout, mshape)[0], initial_board=board)
    assert sim.plan_note == "tiled"
    assert np.array_equal(sim.run(), want)


def test_glider_crosses_a_cart_corner():
    """A glider placed just above-left of the shard corner at (32, 32) of a
    64x64 board on 2x2 shards crosses into the diagonal shard."""
    board = np.zeros((64, 64), np.uint8)
    for y, x in ((27, 28), (28, 29), (29, 27), (29, 28), (29, 29)):
        board[y, x] = 1
    steps = 40
    _, jcfg = _cfg(board, steps)
    want = np.asarray(JaxSim(jcfg, layout="cart", impl="halo",
                             mesh=jmesh.make_mesh_2d(2, 2),
                             initial_board=board).run())
    assert np.array_equal(want, np.roll(board, (10, 10), (0, 1)))
    cfg, _ = _cfg(board, steps)
    mesh = mesh_lib.make_mesh_2d(2, 2, device="cpu")
    for impl in ("roll", "halo", "native", "bitfused"):
        sim = LifeSim(cfg, layout="cart", impl=impl, mesh=mesh,
                      initial_board=board)
        assert np.array_equal(sim.run(), want), impl


@pytest.mark.parametrize("workload", ["heat", "wireworld"])
@pytest.mark.parametrize("layout", ["row", "cart"])
def test_stencil_workloads_match_jax(workload, layout):
    steps = 30
    board, want = _jax_run(((64, 64), 5, layout, LAYOUTS[layout], steps,
                            workload))
    cfg, _ = _cfg(board, steps)
    mesh, _ = _meshes(layout)
    spec = stencils.get(workload)
    for impl in ("halo", "native"):
        sim = LifeSim(cfg, layout=layout, impl=impl, mesh=mesh,
                      fuse_steps=2, initial_board=board, workload=workload)
        got = sim.run()
        assert got.dtype == spec.np_dtype
        assert stencils.parity_ok(spec, got, want, **TOL), impl
    auto = LifeSim(cfg, layout=layout, mesh=mesh, initial_board=board,
                   workload=workload)
    assert auto.impl == "halo"
    with pytest.raises(ValueError, match="bit-packed"):
        LifeSim(cfg, layout=layout, impl="bitfused", mesh=mesh,
                workload=workload)


def test_run_restarts_from_jax_state():
    """The JAX sim runs 60 steps of an uneven board (its padded frame
    stored), the port carries on from that state to 150 on every
    layout, and the JAX sim's own 150 steps agree."""
    board = _soup((500, 500), 51)
    _, jcfg = _cfg(board, 150)
    jsim = JaxSim(jcfg, layout="row", impl="roll",
                  mesh=jmesh.make_mesh_1d(8, axis="y"), initial_board=board)
    jsim.step(60)
    state = np.asarray(jax.device_get(jsim.board))
    assert state.shape == tuple(jsim.padded_shape) == (504, 500)
    jsim.step(90)
    want = np.asarray(jsim.collect())
    cfg, _ = _cfg(board, 150)
    for layout in ("row", "col", "cart"):
        sim = state_from_jax_sim(cfg, state, 60, layout=layout,
                                 impl="bitfused", mesh=_meshes(layout)[0])
        assert sim.step_count == 60
        assert np.array_equal(sim.run(), want), layout


def test_one_shard_meshes_and_defaults(monkeypatch):
    """The default layout is row (as the JAX package's): one shard on the
    CPU. A 1-shard bitfused mesh runs the exchange machinery on the CPU,
    or the serial kernels where the dispatch is on."""
    cfg = LifeConfig(steps=30, save_steps=0, nx=256, ny=256,
                     cells=np.zeros((0, 2), np.int64))
    board = _soup((256, 256), 61)
    want = _jax_run(((256, 256), 61, "row", (1,), 30, "life"))[1]
    sim = LifeSim(cfg, device="cpu", initial_board=board)
    assert sim.layout == "row" and sim.mesh.size == 1 and sim.impl == "halo"
    assert np.array_equal(sim.run(), want)
    one = mesh_lib.make_mesh_1d(1, device="cpu")
    sim = LifeSim(cfg, impl="bitfused", mesh=one, initial_board=board)
    assert sim.plan_note == "window"
    assert np.array_equal(sim.run(), want)
    monkeypatch.setattr(life_model, "_BITFUSED_1DEV_SERIAL_ON_CPU", True)
    sim = LifeSim(cfg, impl="bitfused", mesh=one, initial_board=board)
    assert sim.plan_note == "serial-1dev:vmem"
    assert np.array_equal(sim.run(), want)
    sim = LifeSim(cfg, impl="native", mesh=one, initial_board=board)
    assert sim.native_path == "vmem" and np.array_equal(sim.run(), want)


def test_cli_cart_matches_jax_cli(capsys):
    jax_life_app.main([GLIDER, "--layout", "cart", "--mesh", "4,2",
                       "--print-final-population"])
    jax_out = capsys.readouterr()
    assert life_app.main([GLIDER, "--layout", "cart", "--mesh", "4,2",
                          "--virtual-devices", "8", "--device", "cpu",
                          "--print-final-population"]) == 0
    ours = capsys.readouterr()
    assert len(ours.out.strip().splitlines()) == 1
    float(ours.out)
    assert (ours.err.strip().splitlines()[-1]
            == jax_out.err.strip().splitlines()[-1] == "5")
    with pytest.raises(SystemExit):
        life_app.main([GLIDER, "--batch", "2", "--device", "cpu"])
