"""The port's batched Life held against the JAX package's, bit-exact.

Stacks are numpy soups from a seed, handed to both packages. The JAX side
runs its Pallas kernels in interpret mode or through its XLA references,
as ``tests/test_batched.py`` and ``tests/test_bitlife.py`` run them; the
port runs on the CPU, where each kernel wrapper takes its plain PyTorch
version (the CUDA kernels' tiles and blocks are held against those on the
card by ``chip_smoke.py``). Tolerance: exact equality, since the state is
0/1 integers and packed words.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import oracle_n as _oracle

from mpi_and_open_mp_tpu.models.life import LifeSim as JaxSim
from mpi_and_open_mp_tpu.ops import bitlife as jb
from mpi_and_open_mp_tpu.ops import pallas_life as jpl
from mpi_and_open_mp_tpu.serve import ShapeBucketBatcher as JaxBatcher
from mpi_and_open_mp_tpu.serve import bucket_batch_size as jax_bucket
from mpi_and_open_mp_tpu.utils.config import config_from_board as jax_cfg
from mpi_and_open_mp_tpu_torch import LifeSim
from mpi_and_open_mp_tpu_torch.apps import life as life_app
from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
from mpi_and_open_mp_tpu_torch.ops import native_life as tnl
from mpi_and_open_mp_tpu_torch.serve import ShapeBucketBatcher
from mpi_and_open_mp_tpu_torch.serve import bucket_batch_size
from mpi_and_open_mp_tpu_torch.utils.config import config_from_board

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLIDER = os.path.join(ROOT, "tests", "fixtures", "glider_10x10.cfg")

SHAPES = [(3, 5), (10, 10), (31, 8), (33, 37), (100, 33)]
BATCHES = [1, 31, 32, 33, 64]


def _stack(b, ny, nx, seed=0, density=0.4):
    rng = np.random.default_rng(seed)
    return (rng.random((b, ny, nx)) < density).astype(np.uint8)


def _words(t: torch.Tensor) -> np.ndarray:
    """Port words reinterpreted as the JAX package's uint32."""
    return t.numpy().view(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a)


# ------------------------------------------------------------- pack words


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("ny,nx", [(3, 5), (33, 37)])
def test_pack_words_match_jax(b, ny, nx):
    """Both stack layouts' words, ragged B included, and their round trips."""
    s = _stack(b, ny, nx, seed=b * 100 + ny)
    cells = tb.pack_boards(_t(s))
    assert cells.dtype == torch.int32
    assert cells.shape == (b, tb.n_words(ny), nx)
    assert np.array_equal(_words(cells), np.asarray(jb.pack_boards(jnp.asarray(s))))
    assert np.array_equal(tb.unpack_boards(cells, ny).numpy(), s)
    planes = tb.pack_batch_bits(_t(s))
    assert planes.shape == (tb.n_planes(b), ny, nx) == (jb.n_planes(b), ny, nx)
    assert np.array_equal(_words(planes),
                          np.asarray(jb.pack_batch_bits(jnp.asarray(s))))
    assert np.array_equal(tb.unpack_batch_bits(planes, b).numpy(), s)


# ------------------------------------------------------ cell-packed stacks


@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("ny,nx", SHAPES)
def test_vmem_bits_batch_matches_jax(ny, nx, resident):
    """The port's one batched resident form against both TPU forms (the
    whole stack in one program, and one board per grid step)."""
    s = _stack(4, ny, nx, seed=ny * nx)
    want = np.asarray(jb.life_run_vmem_bits_batch(
        jnp.asarray(s), 7, interpret=True, resident=resident))
    got = tb.life_run_vmem_bits_batch(_t(s), 7).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("ny,nx,steps", [(37, 45, 0), (30, 8, 5), (95, 130, 3)])
def test_vmem_batch_packed_words_match_jax(ny, nx, steps):
    """Every bit of the packed stack, ghosts and junk bits included, against
    the JAX kernel on the unpadded words (grid form)."""
    s = _stack(3, ny, nx, seed=2)
    packed = jb.pack_boards(jnp.asarray(s))
    want = np.asarray(jb._run_vmem_bits_batch_jit(
        packed, jnp.asarray([steps], jnp.int32), ny=ny, nx=nx,
        interpret=True, resident=False))
    ours = tb.vmem_batch_steps(tb.pack_boards(_t(s)), ny, steps)
    assert np.array_equal(_words(ours), want)


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_bits_plain_batch_matches_jax_xla(ny, nx):
    s = _stack(5, ny, nx, seed=7)
    want = np.asarray(jb.life_run_bits_xla_batch(jnp.asarray(s), 6))
    assert np.array_equal(tb.life_run_bits_plain_batch(_t(s), 6).numpy(), want)


@pytest.mark.parametrize("runner,shape", [
    ("fused", (256, 128)), ("frame", (100, 40)),
])
def test_big_board_batches_match_jax(runner, shape):
    s = _stack(2, *shape, seed=3)
    jax_fn = getattr(jb, f"life_run_{runner}_bits_batch")
    want = np.asarray(jax_fn(jnp.asarray(s), 5, interpret=True))
    got = getattr(tb, f"life_run_{runner}_bits_batch")(_t(s), 5).numpy()
    assert np.array_equal(got, want)
    for b in range(2):
        assert np.array_equal(got[b], _oracle(s[b], 5))


def test_fits_vmem_packed_batch_is_per_board():
    """One block per board: the gate does not scale with B, unlike the
    TPU's whole-stack gate."""
    assert tb.fits_vmem_packed_batch((4096, 500, 500))
    assert not tb.fits_vmem_packed_batch((1, 1000, 1000))


# ---------------------------------------------------- board-sliced stacks


@pytest.mark.parametrize("b,shape,steps,use_kernel", [
    (5, (13, 17), 6, True), (32, (13, 17), 6, True), (33, (13, 17), 6, True),
    *[(b, (16, 20), 13, False) for b in BATCHES],
    *[(9, shape, 5, False) for shape in [(1, 8), (8, 1), (2, 2), (3, 3)]],
])
def test_bitsliced_matches_jax(b, shape, steps, use_kernel):
    """The roll form against the Pallas kernel (interpret mode) and against
    the halo-fused XLA twin, ragged B and degenerate extents included."""
    s = _stack(b, *shape, seed=b + shape[0] * 100 + shape[1])
    want = np.asarray(jb.life_run_bitsliced_batch(
        jnp.asarray(s), steps, use_kernel=use_kernel, interpret=use_kernel))
    got = tb.life_run_bitsliced_batch(_t(s), steps).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("steps", [0, 1, 13])
def test_bitsliced_planes_match_jax(steps):
    """The stepped planes, pad bits included, against the JAX XLA twin:
    the pad bits of a ragged plane stay dead."""
    s = _stack(40, 12, 15, seed=8)
    want = np.asarray(jb._run_bitsliced_xla_jit(
        jb.pack_batch_bits(jnp.asarray(s)), jnp.asarray([steps], jnp.int32)))
    got = tb.bitsliced_steps(tb.pack_batch_bits(_t(s)), steps)
    assert np.array_equal(_words(got), want)
    assert not (want[1] >> 8).any()  # boards 40..63 are padding


def test_bitsliced_glider_blinker_isolation():
    """A glider in board 0, a blinker in board 40 (second plane), empty
    elsewhere: 100 steps with torus wraps; a bit leaking between boards
    would kill a pattern or wake a dead board."""
    s = np.zeros((48, 10, 10), np.uint8)
    for j, i in [(0, 1), (1, 2), (2, 0), (2, 1), (2, 2)]:
        s[0, j, i] = 1
    s[40, 4, 3:6] = 1
    got = tb.life_run_bitsliced_batch(_t(s), 100).numpy()
    want = np.asarray(jb.life_run_bitsliced_batch(
        jnp.asarray(s), 100, use_kernel=False))
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], _oracle(s[0], 100)) and got[0].sum() == 5
    assert np.array_equal(got[40], _oracle(s[40], 100))
    assert np.delete(got, (0, 40), axis=0).sum() == 0


def test_bitsliced_keeps_dtype_and_cpu_launch_count():
    s = _stack(8, 16, 16, seed=2).astype(np.int32)
    before = (tb.bitsliced_steps.launches, tb.vmem_batch_steps.launches)
    got = tb.life_run_bitsliced_batch(_t(s), 0)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), s)
    tb.life_run_bitsliced_batch(_t(s), 3)
    tb.life_run_vmem_bits_batch(_t(s), 3)
    # The CPU path runs the plain versions and launches nothing.
    assert (tb.bitsliced_steps.launches,
            tb.vmem_batch_steps.launches) == before


@pytest.mark.parametrize("shape,min_blocks", [
    ((2, 500, 500), 66), ((8, 500, 500), 132), ((1, 1, 8), 1),
    ((2, 37, 45), 2),
])
def test_plan_bitsliced(shape, min_blocks):
    """The plan's bands and strips cover each plane once, its blocks fit
    the card (threads, shared memory, a cluster of at most 16), a launch
    steps at most the halo, and the planner spreads the stack over at
    least ``min_blocks`` blocks (B = 64 at 500^2: half the SMs or more)."""
    npl, ny, nx = shape
    geo = tb.plan_bitsliced(shape)
    assert [r for a, b in geo.band_bounds(ny) for r in range(a, b)] == list(
        range(ny))
    assert [c for a, b in geo.strip_bounds(nx) for c in range(a, b)] == list(
        range(nx))
    assert geo.threads <= tb.SLICED_MAX_THREADS
    assert geo.smem_bytes <= tb.SMEM_BYTES
    assert geo.cluster in (1, geo.strips) and geo.strips <= 16
    assert geo.launches(1000) == (1 if geo.halo == 0
                                  else -(-1000 // geo.halo))
    assert npl * geo.bands * geo.strips >= min_blocks


# --------------------------------------------------------------- dispatch


def test_native_path_batch_policy():
    """The JAX package's ladder, with its names: ``vmem`` (whole stack in
    one program) becomes ``vmem-grid`` (a block per board), ``xla`` the
    CPU's ``plain``."""
    for on_card in (True, False):
        for shape in [(8, 500, 500), (64, 64, 64), (4, 64, 64), (2, 500, 500),
                      (32, 20, 24)]:
            want = jpl.native_path_batch(shape, on_tpu=False)
            assert tnl.native_path_batch(shape, on_card=on_card) == (
                want if want == "bitsliced"
                else ("vmem-grid" if on_card else "plain")), shape
    assert tnl.native_path_batch((8, 500, 500), on_card=False,
                                 allow_bitsliced=False) == "plain"
    assert tnl.native_path_batch((8, 500, 500),
                                 allow_bitsliced=False) == "vmem-grid"
    assert tnl.native_path_batch((2, 16384, 16384)) == "fused"
    assert tnl.native_path_batch((2, 10000, 10000)) == "frame"
    assert tnl.native_path_batch((64, 2048, 2048)) == "fused"
    assert tnl.native_path_batch((64, 2048, 2048), on_card=False) == "plain"
    with pytest.raises(ValueError, match="no kernel covers"):
        tnl.native_path_batch((2, 20, 40000))


def test_layout_vocabulary_and_kill_switch():
    """The kill switch changes the path, never the answer."""
    assert tnl.batch_pack_layout((32, 64, 64)) == "bitsliced"
    assert tnl.batch_pack_layout((2, 64, 64)) == "cell-packed"
    assert tnl.batch_slice_width((64, 64)) == 32
    assert tnl.batch_slice_width((4096, 4096)) is None
    assert jpl.batch_slice_width((4096, 4096)) is None
    s = _t(_stack(32, 20, 24, seed=11))
    fast = tnl.life_run_vmem_batch(s, 6).numpy()
    with tnl._bitslice_pinned(False):
        assert tnl.native_path_batch((32, 64, 64), on_card=False) == "plain"
        assert tnl.batch_pack_layout((32, 64, 64)) == "cell-packed"
        assert tnl.batch_slice_width((64, 64)) is None
        pinned = tnl.life_run_vmem_batch(s, 6).numpy()
    assert np.array_equal(fast, pinned)
    assert tnl.batch_pack_layout((32, 64, 64)) == "bitsliced"
    want = np.asarray(jpl.life_run_vmem_batch(jnp.asarray(s.numpy()), 6))
    assert np.array_equal(fast, want)


@pytest.mark.parametrize("b,shape", [(6, (33, 37)), (9, (33, 37)),
                                     (3, (300, 40))])
def test_life_run_vmem_batch_matches_jax(b, shape):
    s = _stack(b, *shape, seed=1)
    want = np.asarray(jpl.life_run_vmem_batch(jnp.asarray(s), 7))
    assert np.array_equal(tnl.life_run_vmem_batch(_t(s), 7).numpy(), want)


# ------------------------------------------------------------ batched sim


def _cfgs(ny, nx, steps):
    zero = np.zeros((ny, nx), np.uint8)
    return (config_from_board(zero, steps=steps, save_steps=0),
            jax_cfg(zero, steps=steps, save_steps=0))


@pytest.mark.parametrize("impl,b", [("auto", 4), ("native", 4),
                                    ("native", 9), ("roll", 4)])
def test_lifesim_batched_matches_jax(impl, b):
    s = _stack(b, 33, 37, seed=2)
    cfg, jcfg = _cfgs(33, 37, 7)
    sim = LifeSim(cfg, layout="serial", impl=impl, device="cpu",
                  initial_board=s)
    ref = JaxSim(jcfg, layout="serial",
                 impl="pallas" if impl == "native" else impl, initial_board=s)
    assert sim.batch == ref.batch == b
    got = sim.run()
    assert got.shape == (b, 33, 37)
    assert np.array_equal(got, np.asarray(ref.run()))
    sim.debug_check()
    if impl == "roll":
        assert sim.native_path is None
    else:
        assert sim.impl == "native"
        assert sim.native_path == ref.plan_note.replace("xla", "plain")


def test_lifesim_batched_constructor_gates():
    cfg, _ = _cfgs(10, 10, 1)
    s = _stack(2, 10, 10)
    with pytest.raises(ValueError, match="serial"):
        LifeSim(cfg, layout="row", device="cpu", initial_board=s)
    for kw in (dict(impl="halo"), dict(impl="pallas"), dict(outdir="nope"),
               dict(checkpoint_dir="nope")):
        with pytest.raises(ValueError):
            LifeSim(cfg, layout="serial", device="cpu", initial_board=s, **kw)
    with pytest.raises(ValueError, match="expected"):
        LifeSim(cfg, layout="serial", device="cpu",
                initial_board=_stack(2, 11, 10))


def test_lifesim_batched_debug_check_names_diverging_board():
    cfg, _ = _cfgs(12, 12, 4)
    sim = LifeSim(cfg, layout="serial", device="cpu",
                  initial_board=_stack(5, 12, 12, seed=4))
    sim.step(2)
    sim.debug_check()
    good = sim._advance

    def corrupt(board, n):
        out = good(board, n).clone()
        out[3] ^= 1  # board 3 flips every cell
        return out

    sim._advance = corrupt
    with pytest.raises(AssertionError, match=r"board 3: 144\)"):
        sim.debug_check()
    # The probe leg names boards too: a live stack the stepper cannot break.
    sim2 = LifeSim(cfg, layout="serial", device="cpu",
                   initial_board=np.zeros((5, 12, 12), np.uint8))
    sim2._advance = lambda board, n: (good(board, n) if not board.any()
                                      else board)
    with pytest.raises(AssertionError, match=r"\(board 0: .*probe board"):
        sim2.debug_check()


def test_cli_batch_matches_jax_cli(capsys):
    """``--batch 3`` on the glider: one elapsed line, the population summed
    over the stack, as the JAX CLI prints it."""
    from mpi_and_open_mp_tpu.apps import life as jax_app

    assert life_app.main([GLIDER, "--layout", "serial", "--batch", "3",
                          "--device", "cpu", "--print-final-population",
                          "--debug-check"]) == 0
    out, err = capsys.readouterr()
    assert len(out.strip().splitlines()) == 1 and float(out) >= 0
    assert err.strip() == "15"
    assert jax_app.main([GLIDER, "--layout", "serial", "--batch", "3",
                         "--print-final-population"]) == 0
    _, jax_err = capsys.readouterr()
    assert jax_err.strip().splitlines()[-1] == "15"
    with pytest.raises(SystemExit):
        life_app.main([GLIDER, "--layout", "serial", "--batch", "3",
                       "--device", "cpu", "--outdir", "nope"])


# ---------------------------------------------------------------- batcher


@pytest.mark.parametrize("n,cap,width", [
    (n, 8, None) for n in (1, 2, 3, 4, 5, 7, 8)
] + [(3, 2, None), (20, 64, 32), (32, 64, 32), (33, 64, 32), (65, 128, 32),
     (1, 64, 32), (7, 64, 32), (8, 64, 32), (5, 8, 32), (20, 64, None)])
def test_bucket_batch_size_matches_jax(n, cap, width):
    assert bucket_batch_size(n, cap, width) == jax_bucket(n, cap, width)


def _flush_both(max_batch, requests):
    ours = ShapeBucketBatcher(max_batch=max_batch, device="cpu")
    theirs = JaxBatcher(max_batch=max_batch)
    for board, steps in requests:
        assert ours.submit(board, steps) == theirs.submit(board, steps)
    assert ours.bucket_keys() == theirs.bucket_keys()
    return ours, ours.flush(), theirs, theirs.flush()


def test_batcher_order_and_padding_match_jax():
    """Interleaved shapes and step counts: results in submission order,
    the same chunks and padding as the JAX batcher, each board exact."""
    boards = [_stack(1, 20, 20, seed=i)[0] for i in range(3)]
    other = _stack(1, 10, 10, seed=9)[0]
    requests = [(boards[0], 4), (other, 2), (boards[1], 4), (boards[2], 6)]
    ours, got, theirs, want = _flush_both(4, requests)
    assert len(got) == 4 and len(ours) == 0
    for (board, steps), g, w in zip(requests, got, want):
        assert np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, _oracle(board, steps))
    stats = [(s.shape, s.steps, s.requests, s.padded_batch, s.tickets,
              s.path.replace("xla", "plain")) for s in theirs.last_flush_stats]
    assert [(s.shape, s.steps, s.requests, s.padded_batch, s.tickets, s.path)
            for s in ours.last_flush_stats] == stats


def test_batcher_pads_bitsliced_bucket_to_plane():
    boards = [_stack(1, 64, 64, seed=100 + i)[0] for i in range(20)]
    ours, got, theirs, want = _flush_both(64, [(b, 3) for b in boards])
    (stat,) = ours.last_flush_stats
    assert (stat.requests, stat.padded_batch, stat.path) == (20, 32, "bitsliced")
    (jstat,) = theirs.last_flush_stats
    assert (jstat.padded_batch, jstat.path) == (32, "bitsliced")
    for b, g, w in zip(boards, got, want):
        assert np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, _oracle(b, 3))


def test_batcher_rejects_bad_and_unported_submissions():
    bat = ShapeBucketBatcher(max_batch=4, device="cpu")
    with pytest.raises(ValueError, match="2D"):
        bat.submit(_stack(2, 8, 8), 1)
    with pytest.raises(ValueError, match="steps"):
        bat.submit(_stack(1, 8, 8)[0], -1)
    with pytest.raises(ValueError, match="max_batch"):
        ShapeBucketBatcher(max_batch=0, device="cpu")
    with pytest.raises(ValueError, match="unknown stencil workload"):
        bat.submit(_stack(1, 8, 8)[0], 1, workload="warp-drive")
    with pytest.raises(ValueError, match="3D"):
        bat.submit(_stack(1, 8, 8)[0], 1, workload="gray_scott")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        bat.submit_session("s0", 1)
    assert len(bat) == 0 and bat.flush() == []


# ------------------------------------------------------------ state across


@pytest.mark.parametrize("ny,nx", [(500, 500), (33, 37), (30, 8)])
def test_state_from_jax_cell_packed_stack(ny, nx):
    """A lane-padded JAX stack (as life_run_vmem_bits_batch packs it)."""
    s = _stack(3, ny, nx, seed=12)
    nxp = -(-nx // 128) * 128
    jax_words = np.asarray(jb.pack_boards(
        jnp.pad(jnp.asarray(s), ((0, 0), (0, 0), (0, nxp - nx)))))
    t = tb.state_from_jax(jax_words, ny, nx, device="cpu")
    assert t.shape == (3, tb.n_words(ny), nx)
    assert torch.equal(t, tb.pack_boards(_t(s)))
    assert np.array_equal(tb.unpack_boards(t, ny).numpy(), s)


@pytest.mark.parametrize("b", [8, 33, 64])
def test_state_from_jax_board_sliced(b):
    s = _stack(b, 21, 30, seed=b)
    planes = np.asarray(jb.pack_batch_bits(jnp.asarray(s)))
    t = tb.state_from_jax(planes, 21, 30, layout="board-sliced", device="cpu")
    assert torch.equal(t, tb.pack_batch_bits(_t(s)))
    assert np.array_equal(tb.unpack_batch_bits(t, b).numpy(), s)
    # Stepped on either side, the planes stay equal.
    want = np.asarray(jb._run_bitsliced_xla_jit(
        jnp.asarray(planes), jnp.asarray([5], jnp.int32)))
    assert np.array_equal(_words(tb.bitsliced_steps(t, 5)), want)
    with pytest.raises(ValueError, match="3-D"):
        tb.state_from_jax(planes[0], 21, 30, layout="board-sliced",
                          device="cpu")
    with pytest.raises(ValueError, match="word rows"):
        tb.state_from_jax(planes, 20, 30, layout="board-sliced", device="cpu")
