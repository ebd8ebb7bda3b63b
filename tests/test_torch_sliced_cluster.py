"""The schedule of ``csrc/bitlife_bitsliced.cu``, emulated on the CPU.

The CUDA kernel cannot run here, so this file replays its decomposition in
plain torch and holds the result word for word, pad bits of a ragged stack
included, against the plain version the card compares it with
(``bitlife._bitsliced_steps_plain``), and on small stacks against the JAX
package's ``_run_bitsliced_xla_jit`` and its Pallas kernel in interpret
mode. The replay takes its geometry from ``plan_bitsliced`` (or a geometry
given). A call runs ``geo.launches(steps)`` launches of at most ``halo``
steps (one without a halo). In a launch every band of every plane is a
window of its rows plus ``halo`` rows a side read modulo ny, and every
strip of a band is held as its lanes (a lane per ``cols_per_thread``
adjacent local columns, the strip's own columns plus ``ghost`` per side;
``32 - 2 warp_ghost`` owned lanes a warp when a row takes several warps),
each lane's words split into the segments of the kernel's threads. A step,
segment by segment: the segment reads the words above and below it that
the owners of its columns traded (its own, wrapped, with one segment),
then each warp steps alone with poison (random words, new each step) in a
column past each side and in a row past the traded words. Every ``ghost``
steps the owners of a strip's ghost columns take the ring neighbours' own
columns; every ``warp_ghost * cols_per_thread`` steps the copy lanes take
their owners' words; columns past the strip hold poison. The window's own
edge rows are poison too (past the halo). So a junk word that strays past
a band, strip, warp or segment edge shows.

Separate cases pin the geometry function: every row in one band and every
column in one strip, the cluster at most 16, ``ghost`` within the
narrowest strip, at most 512 threads, shared memory within a block's, the
same inputs giving the same answer, and a geometry for every stack the
dispatch sends here.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from mpi_and_open_mp_tpu.ops import bitlife as jb
from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
from mpi_and_open_mp_tpu_torch.ops import native_life as tnl
from mpi_and_open_mp_tpu_torch.ops.native_pool import (
    _or_reduce, _pool_step_plain)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The replay is many small torch operations: beside the other test
    processes of a parallel run, torch's thread pool spins on each of
    them (the fused replay beside five busy processes took over 900 s on
    the default pool, about 2 minutes on one thread), so this module runs
    on one thread and hands the pool back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(shape, seed) -> torch.Tensor:
    """Random words: every bit a live cell of some board."""
    w = np.random.default_rng(seed).integers(0, 2 ** 32, shape,
                                             dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32))


def _junk(shape, gen) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                         dtype=torch.int32)


def lane_units(geo: tb.SlicedGeometry) -> torch.Tensor:
    """The unit of each lane of a segment's row of warps, as
    ``csrc/bitlife_bitsliced.cu`` maps them (a unit is ``cols_per_thread``
    adjacent local columns): one warp takes all 32 lanes; with more, warp
    q's lane j holds unit ``(32 - 2 tau) q - tau + j``."""
    lanes = torch.arange(32 * geo.warps)
    if geo.warps == 1:
        return lanes
    tau = geo.warp_ghost
    return (32 - 2 * tau) * (lanes // 32) - tau + lanes % 32


def _owned_lanes(geo: tb.SlicedGeometry) -> torch.Tensor:
    j = torch.arange(32 * geo.warps) % 32
    if geo.warps == 1:
        return torch.ones_like(j, dtype=torch.bool)
    return (j >= geo.warp_ghost) & (j < 32 - geo.warp_ghost)


def _warp_step(t: torch.Tensor, warps: int, gen) -> torch.Tensor:
    """One step of every warp's columns on its own over ``t`` (..., rows,
    warps * cols): a fresh poison column past each side of a warp (where
    the kernel's shuffles hand an edge lane its own sums)."""
    *lead, rows, cols = t.shape
    w = t.reshape(*lead, rows, warps, cols // warps).movedim(-2, -3)
    junk = _junk((*w.shape[:-1], 2), gen)
    padded = torch.cat([junk[..., :1], w, junk[..., 1:]], dim=-1)
    out = tb.bitsliced_step(padded)[..., 1:-1]
    return out.movedim(-3, -2).reshape(*lead, rows, cols)


def _launch(planes: torch.Tensor, k: int, geo: tb.SlicedGeometry, gen,
            tail: tuple | None = None):
    """One launch of ``k`` steps (module docstring). With ``tail`` (the
    call's first input and a (P,) lane mask), the tail mode's launch:
    returns the merged words and the change word, which ORs the last
    step's old ^ new of the written-back words only."""
    npl, ny, nx = planes.shape
    S, g, P, nq, ct = (geo.strips, geo.ghost, geo.segments, geo.warps,
                       geo.cols_per_thread)
    h, R = geo.halo, geo.window_rows
    bands = geo.band_bounds(ny)
    strips = geo.strip_bounds(nx)
    widths = torch.tensor([c1 - c0 for c0, c1 in strips])
    unit = lane_units(geo)
    owned_lane = _owned_lanes(geo)
    # Local column of each (lane, column of the lane), flattened.
    col = (unit[:, None] * ct + torch.arange(ct)[None]).reshape(-1)
    owned = owned_lane[:, None].expand(-1, ct).reshape(-1)
    lane_ok = (unit[:, None] >= 0).expand(-1, ct).reshape(-1)
    L = widths + 2 * g
    valid = lane_ok[None] & (col[None] < L[:, None])  # (S, cols)
    copy = valid & ~owned[None]
    # The position of the owner of each local column, and each position's
    # owner position (its own where it owns or holds nothing).
    pos_of = {int(c): i for i, c in enumerate(col.tolist())
              if owned[i] and lane_ok[i]}
    owner_of = torch.tensor([pos_of.get(int(c), i) if lane_ok[i] else i
                             for i, c in enumerate(col.tolist())])
    rows = torch.stack([(b0 - h + torch.arange(R)) % ny for b0, _ in bands])
    cols = torch.stack([(c0 - g + col.clamp(min=0)) % nx for c0, _ in strips])
    # x: (planes, bands, strips, R, positions).
    x = planes[:, rows[:, None, :, None], cols[None, :, None, :]]
    x = torch.where(valid[None, None, :, None], x, _junk(x.shape, gen))
    if P == 1 or h:
        segs = [(p * (R // P), (p + 1) * (R // P)) for p in range(P)]
    else:
        segs = [(p * R // P, (p + 1) * R // P) for p in range(P)]
    assert segs[-1][1] == R and all(r1 - r0 <= geo.rows_per_thread
                                    for r0, r1 in segs)
    exchange = g < k
    wper = geo.warp_ghost * ct
    for s in range(1, k + 1):
        if tail is not None and s == k:
            before = x.clone()
        xo = x[..., owner_of]  # the words each column's owner holds
        new = []
        for p, (r0, r1) in enumerate(segs):
            own = x[..., r0:r1, :]
            if P == 1:
                above, below = own[..., -1, :], own[..., 0, :]
            else:
                above = xo[..., segs[p - 1][1] - 1, :]
                below = xo[..., segs[(p + 1) % P][0], :]
            shape = (*own.shape[:-2], 1, own.shape[-1])
            t = torch.cat([_junk(shape, gen), above[..., None, :], own,
                           below[..., None, :], _junk(shape, gen)], dim=-2)
            new.append(_warp_step(t, nq, gen)[..., 2 : r1 - r0 + 2, :])
        x = torch.cat(new, dim=-2)
        # The window's edge rows wrap onto each other in the kernel; past
        # the halo they are junk whatever they hold.
        if h:
            x[..., 0, :] = _junk(x[..., 0, :].shape, gen)
            x[..., -1, :] = _junk(x[..., -1, :].shape, gen)
        x = torch.where(valid[None, None, :, None], x, _junk(x.shape, gen))
        if exchange and s % g == 0 and s < k:
            fresh = x.clone()
            xo = x[..., owner_of]
            for r in range(S):
                wl, Lr = int(widths[r - 1]), int(L[r])
                for j in range(g):
                    fresh[:, :, r, :, pos_of[j]] = xo[:, :, r - 1, :,
                                                      pos_of[wl + j]]
                    fresh[:, :, r, :, pos_of[Lr - g + j]] = (
                        xo[:, :, (r + 1) % S, :, pos_of[g + j]])
            x = fresh
        if nq > 1 and s % wper == 0 and s < k:
            x = torch.where(copy[None, None, :, None], x[..., owner_of], x)
    out = torch.empty_like(planes)
    diff = torch.empty_like(planes)
    for bi, (b0, b1) in enumerate(bands):
        for r, (c0, c1) in enumerate(strips):
            for c in range(c1 - c0):
                out[:, b0:b1, c0 + c] = x[:, bi, r, h : h + b1 - b0,
                                          pos_of[g + c]]
                if tail is not None:
                    diff[:, b0:b1, c0 + c] = (
                        before[:, bi, r, h : h + b1 - b0, pos_of[g + c]]
                        ^ out[:, b0:b1, c0 + c])
    if tail is None:
        return out
    orig, mask = tail
    m = mask[:, None, None]
    return (out & m) | (orig & ~m), _or_reduce(diff.reshape(npl, -1))


def replay(planes: torch.Tensor, steps: int, geo: tb.SlicedGeometry,
           seed: int = 0) -> torch.Tensor:
    """``bitlife_bitsliced``'s decomposition of ``steps`` steps of the plane
    stack ``planes`` under ``geo``, in plain torch (module docstring)."""
    gen = torch.Generator().manual_seed(seed)
    kmax = geo.halo or steps
    done = 0
    while done < steps:
        k = min(kmax, steps - done)
        planes = _launch(planes, k, geo, gen)
        done += k
    assert geo.launches(steps) == (0 if steps == 0 else -(-steps // kmax))
    return planes.clone()


def replay_pool(planes: torch.Tensor, steps: int, mask: torch.Tensor,
                geo: tb.SlicedGeometry, seed: int = 0):
    """``bitlife_bitsliced_pool``'s ``steps`` >= 1 steps: :func:`replay`'s
    launches, the last in the tail mode; returns (merged, change)."""
    gen = torch.Generator().manual_seed(seed)
    kmax = geo.halo or steps
    orig, done = planes, 0
    while steps - done > kmax:
        planes = _launch(planes, kmax, geo, gen)
        done += kmax
    return _launch(planes, steps - done, geo, gen, tail=(orig, mask))


def _check(planes, steps, geo=None, seed=0):
    geo = geo or tb.plan_bitsliced(tuple(planes.shape))
    got = replay(planes, steps, geo, seed)
    want = tb._bitsliced_steps_plain(planes, steps)
    assert torch.equal(got, want), (tuple(planes.shape), steps, geo)
    return geo


def _stack(b, ny, nx, seed):
    return np.random.default_rng(seed).integers(0, 2, (b, ny, nx),
                                                dtype=np.uint8)


@pytest.mark.parametrize("which", range(7))
def test_main_path_stack_schedule_matches_plain(which):
    """64 x 500^2 (2 planes) at its true size under its chosen geometry,
    steps in {0, 1, g, g + 1, k, k + 1, 2k + 3}."""
    planes = _words((2, 500, 500), 64)
    geo = tb.plan_bitsliced((2, 500, 500))
    assert geo.halo > 0 and geo.bands * geo.strips > 1
    k = geo.halo
    steps = [0, 1, geo.ghost, geo.ghost + 1, k, k + 1, 2 * k + 3][which]
    _check(planes, steps, geo, seed=which)


# (n_planes, ny, nx) of the cases the card also holds the kernel to
# (chip_smoke.py phase 4), and the degenerate extents: a plane narrower
# than a strip of one, shorter than the halo, one column.
SHAPES = [(1, 37, 45), (2, 95, 130), (1, 1, 8), (1, 8, 1), (1, 2, 2),
          (1, 3, 3), (2, 40, 1)]


@pytest.mark.parametrize("shape", SHAPES)
def test_edge_shapes_match_plain(shape):
    planes = _words(shape, sum(shape))
    geo = tb.plan_bitsliced(shape)
    k = geo.halo or 20
    for steps in sorted({1, geo.ghost, geo.ghost + 1, k, k + 1}):
        _check(planes, steps, geo, seed=steps)


@pytest.mark.parametrize("shape,args", [
    # (bands, halo, strips, ghost, rt, ct, tau)
    ((2, 500, 500), (4, 16, 16, 4, 10, 2, 1)),   # a ring of 16 strips
    ((2, 500, 500), (8, 8, 12, 8, 6, 2, 1)),     # 12 ghost-zone strips
    ((1, 95, 130), (1, 0, 4, 8, 6, 2, 1)),       # one band, ragged segments
    ((1, 95, 130), (1, 0, 2, 8, 16, 2, 2)),      # ring of 2, 2 warps a row
    ((1, 37, 45), (1, 0, 1, 4, 16, 2, 1)),       # a strip of one, a ring
    ((1, 37, 45), (5, 8, 3, 2, 4, 4, 1)),        # 4 columns a thread
    ((2, 61, 70), (3, 8, 2, 4, 12, 1, 2)),       # 2 warps a row, exchange
    ((1, 50, 300), (2, 16, 4, 16, 16, 2, 4)),    # ghost zones, 3 warps
    ((1, 30, 29), (1, 16, 1, 16, 10, 2, 1)),     # one band with a halo
])
def test_geometries_match_plain(shape, args):
    """Exchanging and ghost-zone strips under geometries the chooser does
    not pick."""
    planes = _words(shape, sum(shape) + sum(args))
    geo = tb.sliced_geometry(shape[1], shape[2], *args)
    k = geo.halo or 3 * geo.ghost + 2
    for steps in sorted({1, geo.ghost + 1, k, k + 1}):
        _check(planes, steps, geo, seed=steps)


def test_ragged_stack_pads_stay_dead():
    """B = 33 (2 planes, 31 pad boards): the replay's pad bits stay 0 and
    its boards equal JAX's kernel in interpret mode."""
    s = _stack(33, 37, 45, seed=33)
    planes = tb.pack_batch_bits(torch.from_numpy(s))
    geo = tb.plan_bitsliced(tuple(planes.shape))
    got = replay(planes, 9, geo)
    assert not (got[1] >> 1).any()
    boards = tb.unpack_batch_bits(got, 33).numpy()
    want = np.asarray(jb.life_run_bitsliced_batch(
        jnp.asarray(s), 9, use_kernel=True, interpret=True))
    assert np.array_equal(boards, want)


def test_more_clusters_than_one_wave():
    """B = 512 at 500^2 (16 planes) takes several waves of clusters, by the
    model's count of the card's GPCs; a stack of 20 planes over clusters of
    16 strips (three waves) replays word for word."""
    assert tb.sliced_waves(16, tb.plan_bitsliced((16, 500, 500))) > 1
    geo = tb.sliced_geometry(40, 64, 1, 0, 16, 4, 4, 1)
    assert geo.cluster == 16 and tb.sliced_waves(20, geo) == 3
    _check(_words((20, 40, 64), 512), 9, geo)


@pytest.mark.parametrize("shape", [(1, 13, 17), (2, 12, 15), (1, 1, 8),
                                   (1, 8, 1), (1, 2, 2), (1, 3, 3)])
def test_schedule_matches_jax(shape):
    """The replay against JAX's ``_run_bitsliced_xla_jit``, every bit of
    the planes, and its boards against the Pallas kernel in interpret
    mode, steps in {1, 9}, under the chosen geometry and a second one."""
    planes = _words(shape, 7 * sum(shape))
    words = jnp.asarray(planes.numpy().view(np.uint32))
    npl, ny, nx = shape
    second = tb.sliced_geometry(ny, nx, min(2, ny), 4, 1, 4, 4)
    for steps in (1, 9):
        want = np.asarray(jb._run_bitsliced_xla_jit(
            words, jnp.asarray([steps], jnp.int32)))
        for geo in (tb.plan_bitsliced(shape), second):
            got = replay(planes, steps, geo, seed=steps)
            assert np.array_equal(got.numpy().view(np.uint32), want), (
                steps, geo)
    boards = tb.unpack_batch_bits(planes, 32 * npl)
    kernel = np.asarray(jb.life_run_bitsliced_batch(
        jnp.asarray(boards.numpy()), 9, use_kernel=True, interpret=True))
    got = tb.unpack_batch_bits(replay(planes, 9, tb.plan_bitsliced(shape)),
                               32 * npl).numpy()
    assert np.array_equal(got, kernel)


# ------------------------------------------------- the geometry function

GEO_SHAPES = [(2, 500, 500), (8, 500, 500), (16, 500, 500), (1, 37, 45),
              (2, 95, 130), (16, 95, 130), (1, 1, 8), (1, 8, 1), (1, 2, 2),
              (1, 3, 3), (1, 1, 1), (3, 2000, 300), (1, 30, 29056),
              (1, 929790, 1), (4, 16350, 56)]


@pytest.mark.parametrize("steps", [1, 2, 8, 9, 17])
@pytest.mark.parametrize("shape", [(1, 1, 7), (1, 7, 1), (2, 3, 3),
                                   (1, 48, 48), (2, 95, 130)])
def test_tail_mode_matches_pool_step_plain(shape, steps):
    """The pool's dispatch (``bitlife_bitsliced_pool``): the rounds of
    ``plan_bitsliced``'s geometry, the last in the tail mode, whose change
    word ORs only the words a block writes back (junk halo rows and ghost
    columns hold poison), word for word and change word for word against
    ``native_pool._pool_step_plain``. (1, 7, 1) takes 7 one-row bands with
    a halo of 8 rows, (1, 48, 48) one launch at every step count."""
    planes = _words(shape, 7 * steps + sum(shape))
    mask = _words(shape[:1], steps)
    geo = tb.plan_bitsliced(shape)
    got, change = replay_pool(planes, steps, mask, geo, seed=steps)
    want, want_change = _pool_step_plain(planes, steps, mask)
    assert torch.equal(got, want), (shape, steps, geo)
    assert torch.equal(change, want_change), (shape, steps, geo)
    assert torch.equal(planes, _words(shape, 7 * steps + sum(shape)))


@pytest.mark.parametrize("shape", GEO_SHAPES)
def test_geometry_covers_every_row_and_column_once(shape):
    _, ny, nx = shape
    geo = tb.plan_bitsliced(shape)
    rows = [r for r0, r1 in geo.band_bounds(ny) for r in range(r0, r1)]
    cols = [c for c0, c1 in geo.strip_bounds(nx) for c in range(c0, c1)]
    assert rows == list(range(ny)) and cols == list(range(nx))
    assert all(r1 > r0 for r0, r1 in geo.band_bounds(ny))
    assert all(c1 > c0 for c0, c1 in geo.strip_bounds(nx))


def _assert_fits(geo: tb.SlicedGeometry, shape) -> None:
    _, ny, nx = shape
    assert 1 <= geo.strips <= tb.SLICED_MAX_CLUSTER
    assert geo.cluster == (geo.strips if geo.exchange else 1)
    assert geo.exchange == (geo.halo == 0 or geo.ghost < geo.halo)
    if geo.exchange:
        assert 1 <= geo.ghost <= nx // geo.strips
    if geo.halo == 0:
        assert geo.bands == 1 and geo.window_rows == ny
    if geo.halo:
        # Every segment full, and room for the halo on both sides.
        assert geo.window_rows == geo.segments * geo.rows_per_thread
        assert geo.window_rows >= -(-ny // geo.bands) + 2 * geo.halo
    assert geo.segments == -(-geo.window_rows // geo.rows_per_thread)
    assert (geo.rows_per_thread, geo.cols_per_thread) in tb.SLICED_KERNELS
    assert geo.threads <= tb.SLICED_MAX_THREADS and geo.threads % 32 == 0
    assert geo.threads == 32 * geo.warps * geo.segments
    assert geo.smem_bytes <= tb.SMEM_BYTES
    lmax = -(-nx // geo.strips) + 2 * geo.ghost
    units = -(-lmax // geo.cols_per_thread)
    own = 32 - 2 * geo.warp_ghost
    assert geo.warps == (1 if units <= 32 else -(-units // own))


@pytest.mark.parametrize("shape", GEO_SHAPES)
def test_geometry_fits_the_card(shape):
    _assert_fits(tb.plan_bitsliced(shape), shape)


@pytest.mark.parametrize("shape", GEO_SHAPES)
def test_geometry_is_a_function_of_its_inputs(shape):
    first = tb.plan_bitsliced(shape)
    assert tb.plan_bitsliced(shape) == first
    tb.plan_bitsliced.cache_clear()
    assert tb.plan_bitsliced(shape) == first
    assert first.reason
    _, ny, nx = shape
    assert first == tb.sliced_geometry(ny, nx, *first.args()[:3],
                                       *first.args()[4:], first.reason)


@settings(max_examples=60, deadline=None)
@given(npl=st.integers(1, 64), ny=st.integers(1, 20000),
       nx=st.integers(1, 29056))
def test_every_dispatched_stack_has_a_geometry(npl, ny, nx):
    """A geometry, legal on the card, for every stack the dispatch sends
    to ``"bitsliced"``: any number of planes of a board the resident gate
    admits."""
    if not tb.fits_vmem_packed((ny, nx)):
        return
    assert tnl.native_path_batch((32 * npl, ny, nx)) == "bitsliced"
    geo = tb.plan_bitsliced((npl, ny, nx))
    _assert_fits(geo, (npl, ny, nx))
    assert tb.sliced_candidates((npl, ny, nx))


def test_main_path_geometry_fills_the_card():
    """64 x 500^2: more than one band or strip a plane, clusters of at most
    16, and blocks on most of the 132 SMs."""
    geo = tb.plan_bitsliced((2, 500, 500))
    blocks = 2 * geo.bands * geo.strips
    assert geo.halo > 0 and 66 <= blocks <= 2 * 132


def test_geometry_shared_memory_figures():
    """The shared-memory words of ``csrc/bitlife_bitsliced.cu:layout``:
    the segments' traded pairs, warp edges, and the ring's ghosts."""
    one = tb.sliced_geometry(500, 500, 4, 16, 16, 4, 10, 2, 1)
    assert (one.segments, one.warps, one.threads) == (16, 1, 512)
    assert one.window_rows == 160 and one.exchange and one.cluster == 16
    assert one.smem_bytes == 4 * (2 * 16 * 64 * 2 + 2 * 2 * 4 * 16 * 10)
    zones = tb.sliced_geometry(500, 500, 4, 16, 16, 16, 10, 2, 1)
    assert not zones.exchange and zones.cluster == 1
    assert zones.smem_bytes == 4 * 2 * 16 * 64 * 2
    warps = tb.sliced_geometry(95, 130, 1, 0, 4, 8, 16, 1, 2)
    assert (warps.segments, warps.warps, warps.window_rows) == (6, 2, 95)
    assert warps.smem_bytes == 4 * (2 * 6 * 64 * 2 + 2 * 2 * 6 * 2 * 2 * 16
                                    + 2 * 2 * 8 * 6 * 16)


@pytest.mark.parametrize("args,match", [
    ((500, 500, 4, 16, 16, 4, 5, 1, 1), "not compiled"),
    ((500, 500, 4, 16, 16, 4, 6, 4, 1), "threads"),
    ((95, 130, 1, 0, 4, 8, 6, 4, 1), "ragged"),
    ((500, 500, 0, 16, 16, 4, 10, 2, 1), "bands"),
    ((500, 500, 2, 0, 16, 4, 10, 2, 1), "halo"),
    ((500, 500, 4, 16, 17, 4, 10, 2, 1), "strips"),
    ((500, 500, 1, 0, 16, 40, 10, 2, 1), "wider than the narrowest strip"),
    ((300, 500, 4, 16, 4, 5, 10, 1, 2), "multiple of warp_ghost"),
    ((500, 500, 4, 16, 16, 0, 10, 2, 1), "ghost"),
])
def test_geometry_refuses_what_the_entry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        tb.sliced_geometry(*args)
