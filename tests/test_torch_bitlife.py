"""The port's packed Life engine held against the JAX package, bit-exact.

Inputs are numpy soups from a seed, handed to both packages. The JAX side
runs its Pallas kernels in interpret mode, as ``tests/test_bitlife.py``
does; the port's side runs on the CPU, where each kernel wrapper takes its
plain PyTorch version (the fused one steps the whole extended frame as
one window; the CUDA kernel's tile seams are held against it on the card,
by ``chip_smoke.py``). Tolerance: exact equality, since the state is 0/1
integers and packed words.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import oracle_n as _oracle

from mpi_and_open_mp_tpu.ops import bitlife as jb
from mpi_and_open_mp_tpu.ops import pallas_life as jpl
from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
from mpi_and_open_mp_tpu_torch.ops import native_life as tnl


def _soup(ny, nx, seed=0, density=0.4):
    rng = np.random.default_rng(seed)
    return (rng.random((ny, nx)) < density).astype(np.uint8)


def _words(t: torch.Tensor) -> np.ndarray:
    """Port words reinterpreted as the JAX package's uint32."""
    return t.numpy().view(np.uint32)


SHAPES = [(3, 5), (10, 10), (30, 8), (31, 8), (32, 8), (33, 37), (100, 33)]


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_pack_board_matches_jax(ny, nx):
    b = _soup(ny, nx)
    ours = tb.pack_board(torch.from_numpy(b))
    assert ours.dtype == torch.int32 and ours.shape == (tb.n_words(ny), nx)
    assert np.array_equal(_words(ours),
                          np.asarray(jb.pack_board(jnp.asarray(b))))
    assert np.array_equal(tb.unpack_board(ours, ny).numpy(), b)


@pytest.mark.parametrize("ny,nx", [(32, 8), (96, 33), (64, 5)])
def test_pack_board_exact_matches_jax(ny, nx):
    b = _soup(ny, nx, seed=5)
    ours = tb.pack_board_exact(torch.from_numpy(b))
    assert np.array_equal(_words(ours),
                          np.asarray(jb.pack_board_exact(jnp.asarray(b))))
    assert np.array_equal(tb.unpack_board_exact(ours).numpy(), b)


@pytest.mark.parametrize("ny,nx", SHAPES + [(62, 45), (95, 130)])
def test_vmem_bits_matches_jax(ny, nx):
    b = _soup(ny, nx, seed=1)
    want = np.asarray(jb.life_run_vmem_bits(jnp.asarray(b), 7, interpret=True))
    got = tb.life_run_vmem_bits(torch.from_numpy(b), 7).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, want), (ny, nx)


@pytest.mark.parametrize("ny,nx,steps", [(37, 45, 0), (10, 10, 100),
                                         (30, 8, 5), (95, 130, 3)])
def test_vmem_packed_words_match_jax(ny, nx, steps):
    """Every bit of the packed state - ghosts and junk bits included -
    agrees with the JAX kernel run on the unpadded words, at word-boundary
    ghosts (ny % 32 in {30, 31}), one-word boards and n = 0."""
    b = _soup(ny, nx, seed=2)
    packed = jb.pack_board(jnp.asarray(b))
    want = np.asarray(jb._run_vmem_bits_jit(
        packed, jnp.asarray([steps], jnp.int32), ny=ny, nx=nx,
        interpret=True))
    ours = tb.vmem_steps(tb.pack_board(torch.from_numpy(b)), ny, steps)
    assert np.array_equal(_words(ours), want)


def test_vmem_glider_torus():
    b = np.zeros((10, 10), np.uint8)
    for j, i in [(0, 1), (1, 2), (2, 0), (2, 1), (2, 2)]:
        b[j, i] = 1
    got = tb.life_run_vmem_bits(torch.from_numpy(b), 100).numpy()
    assert np.array_equal(got, _oracle(b, 100))
    assert got.sum() == 5


@pytest.mark.parametrize("ny,nx,steps", [(256, 128, 7), (512, 256, 33),
                                         (256, 128, 0), (256, 128, 127),
                                         (256, 128, 128), (256, 128, 129),
                                         (256, 128, 256)])
def test_fused_bits_matches_jax(ny, nx, steps):
    """Default plan; 127 to 129 straddle a fused round, 256 is exactly
    two rounds, 0 none."""
    b = _soup(ny, nx, seed=3)
    assert tb.fused_bits_supported((ny, nx))
    want = np.asarray(jb.life_run_fused_bits(
        jnp.asarray(b), steps, interpret=True))
    got = tb.life_run_fused_bits(torch.from_numpy(b), steps).numpy()
    assert np.array_equal(got, want), (ny, nx, steps)


@pytest.mark.parametrize("steps", [5, 40])
def test_fused_bits_multitile_row_seams(steps):
    """Both sides planned onto several full-width row tiles (the JAX budget
    gives 4 tiles of 8 words, the port's 13 KB budget tiles of at most 5
    words); the JAX side steps them tile by tile, so a seam off by one
    there corrupts rows at every tile edge."""
    b = _soup(1024, 128, seed=6)
    jax_budget = (8 + 2 * jb._FUSE_HALO_WORDS) * 4 * 128
    budget = (5 + 2 * tb._FUSE_HALO_WORDS) * 128 * tb.BYTES_PER_WORD
    plan = tb.plan_sharded_bits((1024, 128), budget=budget)
    assert plan.hx == 0 and plan.tr <= 5
    want = np.asarray(jb.life_run_fused_bits(
        jnp.asarray(b), steps, interpret=True, tile_budget_bytes=jax_budget))
    got = tb.life_run_fused_bits(
        torch.from_numpy(b), steps, budget=budget).numpy()
    assert np.array_equal(got, want), steps


@pytest.mark.parametrize("steps", [5, 130])
def test_fused_bits_column_tiled(steps):
    """2-D tiles with a 128-column x halo on both sides, seams in both
    axes, and (130 steps) the x halo rebuilt between rounds."""
    b = _soup(512, 512, seed=7)
    jax_budget = 4 * (8 + 8) * (128 + 256)
    budget = 14 * 416 * tb.BYTES_PER_WORD
    plan = tb.plan_sharded_bits((512, 512), budget=budget)
    assert plan.hx == plan.k_max == 128 and 1 < plan.cx < 512
    assert plan.tr < plan.nw
    want = np.asarray(jb.life_run_fused_bits(
        jnp.asarray(b), steps, interpret=True, tile_budget_bytes=jax_budget))
    got = tb.life_run_fused_bits(
        torch.from_numpy(b), steps, budget=budget).numpy()
    assert np.array_equal(got, want), steps


@pytest.mark.parametrize("shape,jax_budget,budget,steps,col_tiled", [
    ((100, 130), jb._PACKED_VMEM_LIMIT, tb.SMEM_BYTES, 110, False),
    ((740, 250), 20_000, 20_000, 140, False),
    ((740, 1000), jb._PACKED_VMEM_LIMIT, tb.SMEM_BYTES, 5, True),
])
def test_frame_bits_matches_jax(shape, jax_budget, budget, steps, col_tiled):
    """The row-padded frame (mirror rows, funnel wrap borders) at
    unaligned shapes, crossing fused rounds; the last case runs 2-D tiles
    over an unaligned width."""
    b = _soup(*shape, seed=33)
    plan = tb.plan_sharded_bits(shape, budget=budget)
    assert plan is not None and plan.pad_y > 0
    assert (plan.hx > 0) == col_tiled
    want = np.asarray(jb.life_run_frame_bits(
        jnp.asarray(b), steps, interpret=True, budget=jax_budget))
    got = tb.life_run_frame_bits(
        torch.from_numpy(b), steps, budget=budget).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ny,nx", [(300, 33), (257, 16), (600, 9)])
def test_bits_plain_matches_jax_xla(ny, nx):
    b = _soup(ny, nx, seed=1)
    want = np.asarray(jb.life_run_bits_xla(jnp.asarray(b), 5))
    got = tb.life_run_bits_plain(torch.from_numpy(b), 5).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape,steps", [((500, 500), 9), ((37, 45), 3),
                                         ((1000, 40), 4)])
def test_native_life_matches_pallas_life(shape, steps):
    """The dispatcher end to end on the CPU against the JAX package's
    (``"vmem"`` in both, then ``"plain"`` against ``"xla"``)."""
    b = _soup(*shape, seed=4)
    assert tnl.native_path(shape, on_card=False) == jpl.native_path(
        shape, on_tpu=False).replace("xla", "plain")
    want = np.asarray(jpl.life_run_vmem(jnp.asarray(b), steps))
    got = tnl.life_run_vmem(torch.from_numpy(b), steps).numpy()
    assert np.array_equal(got, want)


def test_native_path_on_card():
    assert tnl.native_path((500, 500)) == "vmem"
    assert tnl.native_path((4096, 4096)) == "fused"
    assert tnl.native_path((16384, 16384)) == "fused"
    assert tnl.native_path((10000, 10000)) == "frame"
    assert tnl.native_path((1000, 1000)) == "frame"
    assert tnl.native_path((1000, 1000), on_card=False) == "plain"
    with pytest.raises(ValueError, match="no kernel covers"):
        tnl.native_path((20, 40000))


def test_hopper_gates():
    """Shared-memory gates: 8 bytes per resident word (double buffer)
    within 227 KB; every fused tile window fits the same budget."""
    assert tb.fits_vmem_packed((500, 500))       # 16 x 500 = 8000 words
    assert tb.fits_vmem_packed((900, 900))       # 29 x 900 = 26100 words
    assert not tb.fits_vmem_packed((1000, 1000))  # 32 x 1000 = 32000 words
    for shape in [(4096, 4096), (16384, 16384), (10000, 10000), (1000, 1000)]:
        p = tb.plan_sharded_bits(shape)
        window = (p.tr + 2 * p.h) * (p.cx + 2 * p.hx)
        assert window * tb.BYTES_PER_WORD <= tb.SMEM_BYTES, shape
        assert p.k_max == tb.FUSE_MAX_STEPS and p.h == 4


def test_rule_exhaustive_all_512_neighbourhoods():
    """Every 3x3 neighbourhood through the packed rule: on a 3x3 torus a
    cell's 8 neighbours are exactly the other 8 cells, so the 512 boards
    enumerate the rule's truth table, checked against birth-on-3 /
    survive-on-2-or-3 directly."""
    for cfg in range(512):
        b = np.array([(cfg >> k) & 1 for k in range(9)],
                     dtype=np.uint8).reshape(3, 3)
        got = tb.life_run_bits_plain(torch.from_numpy(b), 1).numpy()
        n = b.sum() - b[1, 1]
        want_centre = 1 if (n == 3 or (b[1, 1] and n == 2)) else 0
        assert got[1, 1] == want_centre, (cfg, b, got)


def test_take_rows_matches_jax():
    b = _soup(96, 16, seed=11)
    jp = jb.pack_board_exact(jnp.asarray(b))
    tp = tb.pack_board_exact(torch.from_numpy(b))
    for start, h in [(0, 1), (32, 2), (5, 1), (37, 1), (1, 2), (63, 1)]:
        assert np.array_equal(_words(tb.take_rows(tp, start, h)),
                              np.asarray(jb.take_rows(jp, start, h)))


@pytest.mark.parametrize("pad", [1, 12, 31, 32, 45, 64])
def test_mirror_tail_matches_jax(pad):
    b = _soup(128, 16, seed=3)
    jp = jb.pack_board_exact(jnp.asarray(b))
    tp = tb.pack_board_exact(torch.from_numpy(b))
    want = jb.mirror_tail(jp, jb.take_rows(jp, 0, 3), pad)
    got = tb.mirror_tail(tp, tb.take_rows(tp, 0, 3), pad)
    assert np.array_equal(_words(got), np.asarray(want))


@pytest.mark.parametrize("ny,h", [(100, 2), (97, 1), (128, 2), (70, 1)])
def test_wrap_y_padded_matches_jax(ny, h):
    nw = -(-ny // 32)
    frame = np.zeros((32 * nw, 24), np.uint8)
    frame[:ny] = _soup(ny, 24, seed=9)
    want = jb.wrap_y_padded(jb.pack_board_exact(jnp.asarray(frame)), ny, h)
    got = tb.wrap_y_padded(tb.pack_board_exact(torch.from_numpy(frame)), ny, h)
    assert np.array_equal(_words(got), np.asarray(want))


@pytest.mark.parametrize("ny,nx", [(500, 500), (30, 8), (33, 37)])
def test_state_from_jax_offset_ghost(ny, nx):
    """A lane-padded JAX board (what life_run_vmem_bits packs) carries
    across to the port's words for the first nx columns and round-trips."""
    b = _soup(ny, nx, seed=12)
    nxp = -(-nx // 128) * 128
    jax_words = np.asarray(jb.pack_board(
        jnp.pad(jnp.asarray(b), ((0, 0), (0, nxp - nx)))))
    t = tb.state_from_jax(jax_words, ny, nx, device="cpu")
    assert t.dtype == torch.int32 and t.shape == (tb.n_words(ny), nx)
    assert torch.equal(t, tb.pack_board(torch.from_numpy(b)))
    assert np.array_equal(tb.unpack_board(t, ny).numpy(), b)
    assert np.array_equal(_words(t), jax_words[:, :nx])


def test_state_from_jax_exact_and_errors():
    b = _soup(64, 40, seed=13)
    jax_words = np.asarray(jb.pack_board_exact(jnp.asarray(b)))
    t = tb.state_from_jax(jax_words, 64, 40, layout="exact", device="cpu")
    assert np.array_equal(tb.unpack_board_exact(t).numpy(), b)
    with pytest.raises(ValueError):
        tb.state_from_jax(jax_words, 63, 40, layout="exact", device="cpu")
    with pytest.raises(ValueError):
        tb.state_from_jax(jax_words, 64, 41, layout="exact", device="cpu")
    with pytest.raises(ValueError):
        tb.state_from_jax(jax_words.view(np.int32), 64, 40, layout="exact",
                          device="cpu")


def test_fused_steps_checks_and_cpu_launch_count():
    plan = tb.plan_sharded_bits((256, 128))
    e = torch.zeros((plan.nw + 2 * plan.h, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        tb.fused_steps(e, plan.k_max + 1, plan)
    with pytest.raises(ValueError, match="does not match"):
        tb.fused_steps(e[1:], 1, plan)
    before = (tb.fused_steps.launches, tb.vmem_steps.launches)
    tb.fused_steps(e, 3, plan)
    tb.vmem_steps(tb.pack_board(torch.zeros((10, 10), dtype=torch.uint8)),
                  10, 3)
    # The CPU path runs the plain versions and launches nothing.
    assert (tb.fused_steps.launches, tb.vmem_steps.launches) == before
