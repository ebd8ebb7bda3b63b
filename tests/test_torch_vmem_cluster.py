"""The schedule of ``csrc/bitlife_vmem.cu``, emulated on the CPU.

The CUDA kernel cannot run here, so this file replays its decomposition in
plain torch and holds the result word for word, ghost and junk bits
included, against the plain version the card compares it with
(``bitlife._vmem_steps_plain``), and on small boards against the JAX
package's ``_run_vmem_bits_jit`` in interpret mode. The replay takes its
geometry from ``vmem_launch_geometry`` (or a geometry given). Each strip of
the cluster is held as its lanes (a lane per local column, the strip's own
columns plus ``ghost`` per side; ``32 - 2 warp_ghost`` owned columns a warp
when a row takes several warps) and each lane's words split into the
segments of the kernel's threads. A step, segment by segment: the segment
reads the words above and below it that the owners of its column traded
(the owners' words, not its own lane's), applies the torus ghosts
(position 0 takes position ny, which the last segment published; position
ny + 1 takes word 0's bit 1), then each warp steps alone with poison
(random words, new each step) in a column past each side and in a row past
the traded words. Every ``ghost`` steps the owners of a strip's ghost
columns take the ring neighbours' own columns; every ``warp_ghost`` steps
the copy lanes take their owners' words; lanes past the strip hold poison.
So a junk word that strays past a strip, warp or segment edge shows.

Separate cases pin the geometry function: every column covered once, the
cluster at most 16, ``ghost`` within the narrowest strip, at most 512
threads, shared memory within a block's, the same inputs giving the same
answer, and a geometry for every shape the gate admits.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

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


def _junk(shape, gen) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                         dtype=torch.int32)


def lane_columns(geo: tb.VmemGeometry) -> torch.Tensor:
    """The local column of each lane of a segment's row of warps, as
    ``csrc/bitlife_vmem.cu`` maps them: one warp takes all 32 lanes; with
    more, warp q's lane j holds column ``(32 - 2 tau) q - tau + j``."""
    lanes = torch.arange(32 * geo.warps)
    if geo.warps == 1:
        return lanes
    return (32 - 2 * geo.warp_ghost) * (lanes // 32) - geo.warp_ghost + lanes % 32


def _owned_lanes(geo: tb.VmemGeometry) -> torch.Tensor:
    j = torch.arange(32 * geo.warps) % 32
    if geo.warps == 1:
        return torch.ones_like(j, dtype=torch.bool)
    return (j >= geo.warp_ghost) & (j < 32 - geo.warp_ghost)


def _warp_step(t: torch.Tensor, warps: int, gen) -> torch.Tensor:
    """One step of every warp's 32 lanes on its own over ``t`` (S, rows,
    lanes), a fresh poison column past each side of a warp (where the
    kernel's shuffles hand an edge lane its own sums)."""
    S, rows, lanes = t.shape
    w = t.reshape(S, rows, warps, 32).movedim(2, 1)
    junk = _junk((S, warps, rows, 2), gen)
    padded = torch.cat([junk[..., :1], w, junk[..., 1:]], dim=-1)
    out = tb._window_step(padded)[..., 1:-1]
    return out.movedim(1, 2).reshape(S, rows, lanes)


def replay(packed: torch.Tensor, ny: int, steps: int,
           geo: tb.VmemGeometry, seed: int = 0) -> torch.Tensor:
    """``bitlife_vmem``'s decomposition of ``steps`` steps of the packed
    board ``packed`` under ``geo``, in plain torch (module docstring)."""
    R, C = packed.shape
    if geo.one_block:
        # bitlife_common.cuh:resident_steps: every column's ghosts, then
        # the whole board stepped from shared memory.
        w = packed
        for _ in range(steps):
            w = tb._window_step(tb._refresh_ghosts(w, ny))
        return w
    gen = torch.Generator().manual_seed(seed)
    S, g, tau, P, nq = (geo.strips, geo.ghost, geo.warp_ghost, geo.segments,
                        geo.warps)
    bounds = geo.strip_bounds(C)
    widths = torch.tensor([c1 - c0 for c0, c1 in bounds])
    col = lane_columns(geo)
    owned = _owned_lanes(geo)
    valid = (col[None] >= 0) & (col[None] < (widths + 2 * g)[:, None])
    copy = valid & ~owned[None]
    # The lane that owns each local column, and each lane's owner lane.
    lane_of = {int(c): i for i, c in enumerate(col.tolist())
               if owned[i] and c >= 0}
    owner_of = torch.tensor([lane_of.get(int(c), i)
                             for i, c in enumerate(col.tolist())])
    src = torch.stack([(c0 - g + col.clamp(min=0)) % C for c0, _ in bounds])
    x = packed[:, src].movedim(1, 0)  # (S, R, lanes)
    x = torch.where(valid[:, None], x, _junk(x.shape, gen))
    segs = [(p * R // P, (p + 1) * R // P) for p in range(P)]
    w_lo, b_lo = divmod(ny, 32)
    hi = tb._i32(1 << ((ny + 1) % 32))

    def set_bit(word, mask, on):
        return (word & ~mask) | torch.where(on, mask, 0).to(torch.int32)

    def bit(word, b):
        return (tb._srl(word, b) if b else word) & 1

    exchange = g < steps
    for s in range(1, steps + 1):
        xo = x[..., owner_of]  # the words each column's owner holds
        new = []
        for p, (r0, r1) in enumerate(segs):
            n = r1 - r0
            own = x[:, r0:r1].clone()
            if P == 1:
                own[:, 0] = set_bit(own[:, 0], 1, bit(own[:, w_lo], b_lo) == 1)
                own[:, n - 1] = set_bit(own[:, n - 1], hi,
                                        (own[:, 0] & 2) != 0)
                above, below = own[:, n - 1], own[:, 0]
            else:
                above = xo[:, segs[p - 1][1] - 1]
                below = xo[:, segs[(p + 1) % P][0]]
                ny_bit = bit(xo[:, w_lo], b_lo)
                if p == 0:
                    above = set_bit(above, hi, (own[:, 0] & 2) != 0)
                    own[:, 0] = set_bit(own[:, 0], 1, ny_bit == 1)
                if p == P - 1:
                    own[:, n - 1] = set_bit(own[:, n - 1], hi,
                                            (below & 2) != 0)
                    below = set_bit(below, 1, ny_bit == 1)
            t = torch.cat([_junk((S, 1, own.shape[-1]), gen), above[:, None],
                           own, below[:, None],
                           _junk((S, 1, own.shape[-1]), gen)], dim=1)
            new.append(_warp_step(t, nq, gen)[:, 2 : n + 2])
        x = torch.cat(new, dim=1)
        x = torch.where(valid[:, None], x, _junk(x.shape, gen))
        if exchange and s % g == 0 and s < steps:
            fresh = x.clone()
            for r in range(S):
                wl, L = int(widths[r - 1]), int(widths[r]) + 2 * g
                for t_ in range(g):
                    fresh[r, :, lane_of[t_]] = x[r - 1, :, lane_of[wl + t_]]
                    fresh[r, :, lane_of[L - g + t_]] = (
                        x[(r + 1) % S, :, lane_of[g + t_]])
            x = fresh
        if nq > 1 and s % tau == 0 and s < steps:
            x = torch.where(copy[:, None], x[..., owner_of], x)
    out = torch.empty_like(packed)
    for r, (c0, c1) in enumerate(bounds):
        for c in range(c1 - c0):
            out[:, c0 + c] = x[r, :, lane_of[g + c]]
    return out


def _check(packed, ny, steps, geo=None, seed=0):
    geo = geo or tb.vmem_launch_geometry(ny, packed.shape[1])
    got = replay(packed, ny, steps, geo, seed)
    want = tb._vmem_steps_plain(packed, ny, steps)
    assert torch.equal(got, want), (tuple(packed.shape), ny, steps, geo)
    return geo


def _gun_big() -> tuple[torch.Tensor, int]:
    board = load_config(GUN_BIG).board()
    return tb.pack_board(torch.from_numpy(board)), board.shape[0]


@pytest.mark.parametrize("which", range(6))
def test_p46gun_big_schedule_matches_plain(which):
    """p46gun_big at its true size under its chosen geometry, steps in
    {0, 1, 7, g, g + 1, 129}."""
    packed, ny = _gun_big()
    geo = tb.vmem_launch_geometry(ny, packed.shape[1])
    assert not geo.one_block and geo.strips > 1
    steps = [0, 1, 7, geo.ghost, geo.ghost + 1, 129][which]
    _check(packed, ny, steps, geo, seed=which)


# (ny, nx) of the cases the card also holds the kernel to (chip_smoke.py
# phase 2): the phase's own shapes; ny % 32 == 30, where position ny + 1
# is bit 31 of the last word, which segment 0 reads as its word above;
# ny % 32 == 31, where position ny lies a word before position ny + 1 (the
# same segment: with more than one, each holds at least 2 words); one word
# a column; the glider board on one strip; one column.
SHAPES = [(37, 45), (62, 1000), (95, 130), (254, 300), (255, 300), (30, 8),
          (10, 10), (40, 1), (3, 1)]


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_edge_shapes_match_plain(ny, nx):
    packed = _words((tb.n_words(ny), nx), ny * 1000 + nx)
    geo = tb.vmem_launch_geometry(ny, nx)
    for steps in sorted({1, 7, geo.ghost, geo.ghost + 1, 129}):
        _check(packed, ny, steps, geo, seed=steps)


def test_glider_board_on_one_strip():
    """The 10x10 glider: one strip, a ring with itself, its x wrap
    through ghosts refreshed from its own edge columns."""
    b = np.zeros((10, 10), np.uint8)
    for j, i in [(0, 1), (1, 2), (2, 0), (2, 1), (2, 2)]:
        b[j, i] = 1
    packed = tb.pack_board(torch.from_numpy(b))
    geo = tb.vmem_launch_geometry(10, 10)
    assert geo.strips == geo.cluster == 1
    got = replay(packed, 10, 40, geo)
    assert torch.equal(got, tb._vmem_steps_plain(packed, 10, 40))
    assert int(tb.unpack_board(got, 10).sum()) == 5


@pytest.mark.parametrize("ny,nx,strips,ghost,rt,tau", [
    (500, 500, 16, 8, 4, 4),    # the issue's sizing: 4 segments, 2 warps
    (500, 500, 16, 4, 8, 2),
    (500, 500, 8, 16, 16, 4),   # one segment, a row of 3 warps
    (500, 500, 3, 2, 32, 1),
    (254, 300, 16, 4, 4, 4),
    (255, 300, 7, 3, 4, 1),
    (95, 130, 2, 1, 4, 1),      # a ring of two strips
    (95, 130, 1, 5, 6, 1),
    (62, 1000, 16, 2, 4, 2),
    (30, 8, 1, 1, 4, 1),
    (30, 8, 2, 4, 4, 2),
    (300, 40, 1, 8, 4, 8),      # 3 segments of 4 warps, 8 copied lanes
])
def test_geometries_match_plain(ny, nx, strips, ghost, rt, tau):
    """Exchanging strips under geometries the chooser does not pick."""
    packed = _words((tb.n_words(ny), nx), ny + nx + strips)
    geo = tb.vmem_geometry(ny, nx, strips, ghost, rt, tau)
    for steps in sorted({1, ghost + 1, 2 * ghost + 3}):
        _check(packed, ny, steps, geo, seed=steps)


def test_tall_board_takes_one_block():
    """More than 512 word rows: the one-block geometry, chosen by shape,
    replayed and held against the JAX kernel."""
    ny, nx = 16400, 24
    geo = tb.vmem_launch_geometry(ny, nx)
    assert geo.one_block and geo.args() == (1, 1, 0, 0, 0)
    assert geo.threads == 1024 and "one block" in geo.reason
    packed = _words((tb.n_words(ny), nx), 7)
    want = np.asarray(jbits._run_vmem_bits_jit(
        jnp.asarray(packed.numpy().view(np.uint32)),
        jnp.asarray([3], jnp.int32), ny=ny, nx=nx, interpret=True))
    got = replay(packed, ny, 3, geo)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    _check(packed, ny, 3, geo)


@pytest.mark.parametrize("ny,nx", [(37, 45), (254, 40), (255, 40), (30, 8),
                                   (10, 10), (40, 1)])
def test_schedule_matches_jax_kernel(ny, nx):
    """The replay against the JAX ``_run_vmem_bits_jit`` in interpret
    mode, every bit of the words, steps in {1, 9}, under the chosen
    geometry and a second one."""
    packed = _words((tb.n_words(ny), nx), ny * nx)
    words = jnp.asarray(packed.numpy().view(np.uint32))
    second = tb.vmem_geometry(ny, nx, min(2, nx), 1, 4)
    for steps in (1, 9):
        want = np.asarray(jbits._run_vmem_bits_jit(
            words, jnp.asarray([steps], jnp.int32), ny=ny, nx=nx,
            interpret=True))
        for geo in (tb.vmem_launch_geometry(ny, nx), second):
            got = replay(packed, ny, steps, geo, seed=steps)
            assert np.array_equal(got.numpy().view(np.uint32), want), (
                steps, geo)


# ------------------------------------------------- the geometry function

GEO_SHAPES = SHAPES + [(500, 500), (900, 900), (16400, 24), (30, 29056),
                       (16350, 56), (2000, 300), (1, 1), (0, 5)]


@pytest.mark.parametrize("ny,nx", GEO_SHAPES)
def test_geometry_covers_every_column_once(ny, nx):
    geo = tb.vmem_launch_geometry(ny, nx)
    cols = [c for c0, c1 in geo.strip_bounds(nx) for c in range(c0, c1)]
    assert cols == list(range(nx))
    assert all(c1 > c0 for c0, c1 in geo.strip_bounds(nx))
    if not geo.one_block:
        nw = tb.n_words(ny)
        assert geo.segments == -(-nw // geo.rows_per_thread)
        assert geo.rows_per_thread in tb.WINDOW_ROWS_PER_THREAD


def _assert_fits(geo: tb.VmemGeometry, ny: int, nx: int) -> None:
    assert geo.smem_bytes <= tb.SMEM_BYTES
    if geo.one_block:
        assert geo.args() == (1, 1, 0, 0, 0) and geo.threads == 1024
        assert geo.smem_bytes == tb.BYTES_PER_WORD * tb.n_words(ny) * nx
        return
    assert 1 <= geo.strips <= tb.WINDOW_MAX_CLUSTER
    assert geo.cluster == geo.strips
    assert 1 <= geo.ghost <= nx // geo.strips
    assert geo.ghost % geo.warp_ghost == 0
    assert geo.threads <= tb.WINDOW_MAX_THREADS and geo.threads % 32 == 0
    assert geo.threads == 32 * geo.warps * geo.segments
    lmax = -(-nx // geo.strips) + 2 * geo.ghost
    own = 32 - 2 * geo.warp_ghost
    assert geo.warps == (1 if lmax <= 32 else -(-lmax // own))
    if geo.segments > 1:
        # Every segment holds at least 2 words, so position ny lies in the
        # last one.
        nw = tb.n_words(ny)
        assert nw // geo.segments >= 2


@pytest.mark.parametrize("ny,nx", GEO_SHAPES)
def test_geometry_fits_the_card(ny, nx):
    _assert_fits(tb.vmem_launch_geometry(ny, nx), ny, nx)


@pytest.mark.parametrize("ny,nx", GEO_SHAPES)
def test_geometry_is_a_function_of_its_inputs(ny, nx):
    first = tb.vmem_launch_geometry(ny, nx)
    assert tb.vmem_launch_geometry(ny, nx) == first
    tb.vmem_launch_geometry.cache_clear()
    assert tb.vmem_launch_geometry(ny, nx) == first
    assert first.reason
    assert first == tb.vmem_geometry(ny, nx, first.strips, first.ghost,
                                     first.rows_per_thread,
                                     first.warp_ghost, first.reason)


@settings(max_examples=60, deadline=None)
@given(ny=st.integers(0, 20000), nx=st.integers(1, 29056))
def test_every_gated_shape_has_a_geometry(ny, nx):
    """A geometry, legal on the card, for every shape the gate admits (and
    a ValueError for every other)."""
    if not tb.fits_vmem_packed((ny, nx)):
        with pytest.raises(ValueError, match="gate"):
            tb.vmem_launch_geometry(ny, nx)
        return
    geo = tb.vmem_launch_geometry(ny, nx)
    _assert_fits(geo, ny, nx)
    assert geo.one_block == (
        tb.n_words(ny) > tb.WINDOW_MAX_ROWS or not tb.vmem_candidates(ny, nx))


def test_p46gun_big_geometry():
    """p46gun_big (16 x 500 words) spreads over a cluster of more than one
    strip, not one block."""
    geo = tb.vmem_launch_geometry(500, 500)
    assert geo.strips > 1 and geo.cluster == geo.strips
    assert not geo.one_block


def test_geometry_shared_memory_figures():
    """The shared-memory words of ``csrc/bitlife_vmem.cu:layout``: the
    window kernel's vertical words, warp edges and ghosts of an exchanging
    window, plus the word holding position ny (two buffers x 32 columns a
    warp) when a column has several segments."""
    one = tb.vmem_geometry(500, 500, 16, 8, 4, 4)
    assert (one.segments, one.warps, one.threads) == (4, 2, 256)
    assert one.smem_bytes == 4 * (2 * 4 * 64 * 2 + 2 * 64
                                  + 2 * 2 * 4 * 2 * 4 * 4
                                  + 2 * 2 * 8 * 4 * 4)
    single = tb.vmem_geometry(10, 10, 1, 8, 4, 4)
    assert (single.segments, single.warps) == (1, 1)
    assert single.smem_bytes == 4 * 2 * 2 * 8 * 1 * 4
    block = tb.vmem_geometry(16400, 24, 1, 0, 0, 0)
    assert block.one_block and block.smem_bytes == 8 * 513 * 24


@pytest.mark.parametrize("args,match", [
    ((500, 500, 16, 4, 5, 1), "rows per thread"),
    ((500, 500, 0, 4, 4, 1), "strips"),
    ((500, 500, 17, 4, 4, 1), "cluster"),
    ((500, 500, 16, 40, 4, 4), "wider than the narrowest strip"),
    ((500, 500, 16, 6, 4, 4), "not a multiple of warp_ghost"),
    ((500, 500, 2, 16, 4, 1), "threads"),
    ((500, 500, 2, 1, 0, 0), "one-block"),
    ((20000, 50, 1, 0, 0, 0), "shared memory"),
])
def test_geometry_refuses_what_the_entry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        tb.vmem_geometry(*args)
