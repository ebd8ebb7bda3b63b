"""The schedule of ``csrc/bitlife_vmem_batch.cu``, emulated on the CPU.

The CUDA kernel cannot run here, so this file replays its launch in plain
torch and holds the result word for word, ghost and junk bits included,
against the plain version the card compares it with
(``bitlife._vmem_batch_steps_plain``), and on small stacks against the JAX
package's ``_run_vmem_bits_batch_jit`` in interpret mode, in both of its
``resident`` forms. The replay takes its geometry from
``vmem_batch_launch_geometry`` (or a geometry given) and walks the launch
grid as the kernel does (``vmem_batch_grid``: x the strips of a board's
cluster, y and past the grid's y extent z the board): the stack's words
lie in one flat buffer with fresh poison past the last board, the result
goes into a flat buffer of poison, and each cluster reads and writes its
board's words only, at the board's offset. Each board then runs the
single-board replay of ``tests/test_torch_vmem_cluster.py``, which puts
fresh poison past every strip, warp and segment edge. So a word that one
board's cluster read or wrote past its board, or a board that no cluster
or two clusters stepped, shows.

Separate cases pin the geometry function: every column of every board
covered once, the cluster at most 16, shared memory within a block's,
waves counted from the card's table of clusters placed at once, the same
inputs giving the same answer, a geometry for every stack the gate
admits, and the one-block form where no cluster holds the board.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import test_torch_vmem_cluster as single
from mpi_and_open_mp_tpu.ops import bitlife as jbits
from mpi_and_open_mp_tpu_torch import load_config
from mpi_and_open_mp_tpu_torch.ops import bitlife as tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUN_BIG = os.path.join(ROOT, "configs", "gun_big_500x500.cfg")


def _words(shape, seed) -> torch.Tensor:
    """Random words: live, ghost and junk bits all random."""
    w = np.random.default_rng(seed).integers(0, 2 ** 32, shape,
                                             dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32))


def _grid(b: int, geo: tb.VmemGeometry, max_y: int) -> tuple[int, int, int]:
    if max_y == tb.VMEM_BATCH_MAX_GRID_Y:
        return tb.vmem_batch_grid(b, geo)
    gy = min(b, max_y)
    return geo.strips, gy, -(-b // gy)


def replay_batch(packed: torch.Tensor, ny: int, steps: int,
                 geo: tb.VmemGeometry, seed: int = 0,
                 max_y: int = tb.VMEM_BATCH_MAX_GRID_Y
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``bitlife_vmem_batch``'s launch of ``steps`` steps of the packed
    stack ``packed`` under ``geo`` (module docstring); ``max_y`` stands in
    for the grid's y extent. Returns the stack, the output buffer's words
    past it, and the poison they held before the launch."""
    B, R, C = packed.shape
    n = R * C
    gen = torch.Generator().manual_seed(seed + 7)
    flat_in = torch.cat([packed.reshape(-1), single._junk((n,), gen)])
    flat_out = single._junk(((B + 1) * n,), gen)
    poison = flat_out[B * n:].clone()
    _, gy, gz = _grid(B, geo, max_y)
    stepped = set()
    for z in range(gz):
        for y in range(gy):
            board = y + gy * z
            if board >= B:
                continue  # an idle cluster of the last z row
            assert board not in stepped
            stepped.add(board)
            base = board * n
            words = flat_in[base:base + n].view(R, C)
            flat_out[base:base + n] = single.replay(
                words, ny, steps, geo, seed + board).reshape(-1)
    assert stepped == set(range(B))
    return flat_out[:B * n].view(B, R, C), flat_out[B * n:], poison


def _check(packed, ny, steps, geo=None, seed=0, max_y=None):
    geo = geo or tb.vmem_batch_launch_geometry(*packed.shape[:1], ny,
                                               packed.shape[2])
    got, tail, poison = replay_batch(packed, ny, steps, geo, seed,
                                     max_y or tb.VMEM_BATCH_MAX_GRID_Y)
    want = tb._vmem_batch_steps_plain(packed, ny, steps)
    assert torch.equal(got, want), (tuple(packed.shape), ny, steps, geo)
    assert torch.equal(tail, poison)
    return geo


def _main_path_stack() -> tuple[torch.Tensor, int]:
    """The main path's 4-board stack: p46gun_big and three soups."""
    board = load_config(GUN_BIG).board()
    rng = np.random.default_rng(21)
    stack = (rng.random((4, *board.shape)) < 0.4).astype(np.uint8)
    stack[0] = board
    return tb.pack_boards(torch.from_numpy(stack)), board.shape[0]


@pytest.mark.parametrize("steps", [0, 1, 9])
def test_main_path_stack_matches_plain(steps):
    """The 4 x 500^2 stack of the main path under its chosen geometry, a
    cluster of more than one strip a board."""
    packed, ny = _main_path_stack()
    geo = tb.vmem_batch_launch_geometry(4, ny, packed.shape[2])
    assert not geo.one_block and geo.strips > 1
    _check(packed, ny, steps, geo, seed=steps)


# (B, ny, nx) stacks of random words: chip_smoke.py phase 4's shapes at
# B in {1, 3, 7}; ny % 32 == 30 and 31 (positions ny and ny + 1 at a word
# edge); one word a column; one column; the glider's board.
STACKS = [(1, 37, 45), (3, 37, 45), (7, 95, 130), (2, 254, 40), (2, 255, 40),
          (5, 30, 8), (3, 10, 10), (4, 40, 1), (9, 3, 2)]


@pytest.mark.parametrize("b,ny,nx", STACKS)
def test_stacks_match_plain(b, ny, nx):
    packed = _words((b, tb.n_words(ny), nx), b * 1000 + ny * 10 + nx)
    geo = tb.vmem_batch_launch_geometry(b, ny, nx)
    steps = sorted({1, 7} | ({geo.ghost, geo.ghost + 1}
                             if not geo.one_block else set()))
    for n in steps:
        _check(packed, ny, n, geo, seed=n)


@pytest.mark.parametrize("family", ["cluster of 16", "cluster of 2",
                                    "one block"])
def test_geometry_families_at_four_boards(family):
    """B = 4 under each family of geometry, forced, at the geometry's g
    and g + 1 steps (the first strip refresh) and past the second."""
    ny, nx = 95, 130
    geo = {"cluster of 16": tb.vmem_geometry(ny, nx, 16, 8, 4, 4),
           "cluster of 2": tb.vmem_geometry(ny, nx, 2, 8, 4, 4),
           "one block": tb.vmem_geometry(ny, nx, 1, 0, 0, 0)}[family]
    packed = _words((4, tb.n_words(ny), nx), 404)
    for n in sorted({geo.ghost, geo.ghost + 1, 2 * max(geo.ghost, 1) + 3}):
        _check(packed, ny, n, geo, seed=n)


def test_boards_past_the_grid_y_extent():
    """Boards past the grid's y extent go to z, and the last z row's idle
    clusters write nothing: here with an extent of 3 boards, a stack of 7
    (a grid of 3 x 3 clusters, 2 idle)."""
    packed = _words((7, tb.n_words(37), 45), 77)
    geo = tb.vmem_batch_launch_geometry(7, 37, 45)
    _check(packed, 37, 9, geo, max_y=3)
    assert _grid(7, geo, 3) == (geo.strips, 3, 3)


@pytest.mark.parametrize("b", [1, 7, 65535, 65536, 200_001])
def test_grid_covers_every_board_once(b):
    geo = tb.vmem_batch_launch_geometry(b, 37, 45)
    x, gy, gz = tb.vmem_batch_grid(b, geo)
    assert x == geo.strips and gy <= tb.VMEM_BATCH_MAX_GRID_Y
    assert gz <= tb.VMEM_BATCH_MAX_GRID_Y
    boards = (np.arange(gy)[:, None] + gy * np.arange(gz)[None, :]).ravel()
    boards = boards[boards < b]
    assert boards.size == b and np.array_equal(np.sort(boards), np.arange(b))


@pytest.mark.parametrize("b,ny,nx", [(3, 37, 45), (2, 30, 8), (4, 10, 10),
                                     (2, 40, 1)])
def test_schedule_matches_jax_kernel(b, ny, nx):
    """The replay against the JAX ``_run_vmem_bits_batch_jit`` in
    interpret mode, both ``resident`` forms, every bit of the words, steps
    in {1, 9}, under the chosen geometry and the one-block form."""
    packed = _words((b, tb.n_words(ny), nx), b * ny * nx)
    words = jnp.asarray(packed.numpy().view(np.uint32))
    geos = (tb.vmem_batch_launch_geometry(b, ny, nx),
            tb.vmem_geometry(ny, nx, 1, 0, 0, 0))
    for steps in (1, 9):
        for resident in (True, False):
            want = np.asarray(jbits._run_vmem_bits_batch_jit(
                words, jnp.asarray([steps], jnp.int32), ny=ny, nx=nx,
                interpret=True, resident=resident))
            for geo in geos:
                got, _, _ = replay_batch(packed, ny, steps, geo, seed=steps)
                assert np.array_equal(got.numpy().view(np.uint32), want), (
                    steps, resident, geo)


def test_wrapper_on_the_cpu_runs_the_plain_version():
    """On a CPU tensor the wrapper takes the plain version, with or without
    a geometry, and launches nothing."""
    packed = _words((3, tb.n_words(37), 45), 5)
    before = tb.vmem_batch_steps.launches
    want = tb._vmem_batch_steps_plain(packed, 37, 5)
    assert torch.equal(tb.vmem_batch_steps(packed, 37, 5), want)
    geo = tb.vmem_geometry(37, 45, 2, 4, 4, 1)
    assert torch.equal(tb.vmem_batch_steps(packed, 37, 5, geometry=geo), want)
    assert tb.vmem_batch_steps.launches == before


# ------------------------------------------------- the geometry function

GEO_STACKS = STACKS + [(1, 500, 500), (4, 500, 500), (7, 500, 500),
                       (8, 500, 500), (16, 500, 500), (64, 500, 500),
                       (512, 500, 500), (64, 95, 130), (2, 16400, 24),
                       (3, 30, 29056), (2, 900, 900), (1, 0, 5), (100, 1, 1)]


@pytest.mark.parametrize("b,ny,nx", GEO_STACKS)
def test_geometry_covers_every_column_once(b, ny, nx):
    geo = tb.vmem_batch_launch_geometry(b, ny, nx)
    cols = [c for c0, c1 in geo.strip_bounds(nx) for c in range(c0, c1)]
    assert cols == list(range(nx))
    assert all(c1 > c0 for c0, c1 in geo.strip_bounds(nx))
    x, gy, gz = tb.vmem_batch_grid(b, geo)
    assert x == geo.strips == geo.cluster and gy * gz >= b > gy * (gz - 1)


@pytest.mark.parametrize("b,ny,nx", GEO_STACKS)
def test_geometry_fits_the_card(b, ny, nx):
    geo = tb.vmem_batch_launch_geometry(b, ny, nx)
    single._assert_fits(geo, ny, nx)
    assert geo.cluster <= 16 and geo.smem_bytes <= tb.SMEM_BYTES


@pytest.mark.parametrize("b,ny,nx", GEO_STACKS)
def test_geometry_is_a_function_of_its_inputs(b, ny, nx):
    first = tb.vmem_batch_launch_geometry(b, ny, nx)
    assert tb.vmem_batch_launch_geometry(b, ny, nx) == first
    tb.vmem_batch_launch_geometry.cache_clear()
    assert tb.vmem_batch_launch_geometry(b, ny, nx) == first
    assert first.reason
    assert first == tb.vmem_geometry(ny, nx, first.strips, first.ghost,
                                     first.rows_per_thread,
                                     first.warp_ghost, first.reason)


@pytest.mark.parametrize("b,ny,nx", GEO_STACKS)
def test_waves_count_from_the_table(b, ny, nx):
    """Waves: the boards over the clusters the card places at once at one
    block an SM (``CLUSTERS_AT_ONCE``, 132 blocks for the one-block
    form), as the reason says."""
    geo = tb.vmem_batch_launch_geometry(b, ny, nx)
    at_once = tb.CLUSTERS_AT_ONCE[geo.cluster - 1]
    assert tb.vmem_batch_waves(b, geo) == -(-b // at_once)
    waves = tb.vmem_batch_waves(b, geo)
    assert f" {waves} wave{'s' if waves > 1 else ''}," in geo.reason


def test_waves_of_each_cluster_size():
    """The card's table (cudaOccupancyMaxActiveClusters at one block an
    SM, NVIDIA H100 80GB HBM3): 7 clusters of 16 at once, not 8, so 8
    boards of 500^2 under clusters of 16 take two waves; 66 clusters of 2,
    so 64 boards take one and 67 two."""
    sixteen = tb.vmem_geometry(500, 500, 16, 8, 4, 4)
    assert [tb.vmem_batch_waves(b, sixteen) for b in (1, 7, 8, 14, 15)] == [
        1, 1, 2, 2, 3]
    two = tb.vmem_geometry(500, 500, 2, 16, 16, 4)
    assert [tb.vmem_batch_waves(b, two) for b in (64, 66, 67)] == [1, 1, 2]
    one = tb.vmem_geometry(500, 500, 1, 0, 0, 0)
    assert [tb.vmem_batch_waves(b, one) for b in (132, 133)] == [1, 2]
    assert tb.CLUSTERS_AT_ONCE[15] == 7 and tb.CLUSTERS_AT_ONCE[0] == tb.N_SMS


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 100_000), ny=st.integers(0, 20000),
       nx=st.integers(1, 29056))
def test_every_gated_stack_has_a_geometry(b, ny, nx):
    """A geometry, legal on the card, for every stack the gate admits (and
    a ValueError for every other)."""
    if not tb.fits_vmem_packed_batch((b, ny, nx)):
        with pytest.raises(ValueError, match="gate"):
            tb.vmem_batch_launch_geometry(b, ny, nx)
        return
    geo = tb.vmem_batch_launch_geometry(b, ny, nx)
    single._assert_fits(geo, ny, nx)
    assert tb.vmem_batch_waves(b, geo) >= 1
    if geo.one_block:
        assert geo.args() == (1, 1, 0, 0, 0)


@pytest.mark.parametrize("b,ny,nx", [(1, 16400, 24), (4, 16400, 24),
                                     (64, 16384, 8), (2, 30, 29056)])
def test_one_block_where_no_cluster_holds_the_board(b, ny, nx):
    """More than 512 word rows, or too wide for 16 strips of 16 warps: no
    cluster geometry, so the one-block form."""
    assert not tb.vmem_candidates(ny, nx)
    geo = tb.vmem_batch_launch_geometry(b, ny, nx)
    assert geo.one_block and geo.args() == (1, 1, 0, 0, 0)
    assert "one block" in geo.reason


def test_few_boards_take_wide_clusters():
    """A stack of a few 500^2 boards, one wave of clusters of 16 strips
    each; 64 boards take narrower clusters, so that all fit one wave."""
    for b in range(1, 8):
        geo = tb.vmem_batch_launch_geometry(b, 500, 500)
        assert geo.strips == 16 and tb.vmem_batch_waves(b, geo) == 1
    wide = tb.vmem_batch_launch_geometry(64, 500, 500)
    assert wide.strips < 16 and tb.vmem_batch_waves(64, wide) == 1


def test_model_terms_match_its_constants():
    for b, ny, nx in [(4, 500, 500), (64, 95, 130)]:
        for geo in tb.vmem_batch_candidates(ny, nx)[::50]:
            feats = tb._vmem_batch_features(b, ny, nx, geo)
            assert len(feats) == len(tb._VMEM_BATCH_US)
            assert tb._vmem_batch_step_model_us(b, ny, nx, geo) > 0
