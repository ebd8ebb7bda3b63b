"""The schedule of ``csrc/bitlife_window.cu``, emulated on the CPU.

The CUDA kernel cannot run here, so this file replays its decomposition in
plain torch and holds the result bit for bit against the plain version the
card compares it with (``bitlife._window_steps_plain``), and on two small
shapes against the JAX package's ``make_window_stepper`` in interpret
mode. The replay takes its strips from ``window_launch_geometry`` (or a
geometry given): each strip is stepped alone from its own columns plus
``ghost`` columns per side, and what lies past those reads poison (random
words, new each step) where the kernel reads whatever its edge lanes
hold, so a junk column that strays into a strip's own columns shows. With
``exchange`` the ghosts are refreshed every ``ghost`` steps from the ring
neighbours' columns as they stand after that step (the kernel's pushes
through distributed shared memory); without, they come once from the
window. Inside a strip each warp steps alone, the lanes it copies from
its neighbouring warps refreshed every ``warp_ghost`` steps; a column's
segments (rows split over threads) trade exact words every step, so a
column is stepped whole here.

Separate cases pin the geometry function: every column covered once, the
cluster at most 16, shared memory within a block's, ``ghost`` within the
exchanged depth and the block size, and the same inputs giving the same
answer.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_and_open_mp_tpu.ops import bitlife as jbits
from mpi_and_open_mp_tpu_torch.ops import bitlife as tb


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


# (shards, nw, W, h, hx): the five windows of chip_smoke.py phase 13 at
# their true sizes: p46gun_big on row 8, col 8 and cart 4x2, and the
# 1024^2 row-2 overlap split's interior and edges.
PHASE13 = {
    "row 8": (8, 2, 500, 1, 0),
    "col 8": (8, 16, 63, 4, 59),
    "cart 4x2": (8, 4, 250, 3, 128),
    "1024 interior": (2, 8, 1024, 4, 0),
    "1024 edge": (2, 4, 1024, 4, 0),
}


def _words(shape, seed) -> torch.Tensor:
    w = np.random.default_rng(seed).integers(0, 2 ** 32, shape,
                                             dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32))


def _junk(shape, gen) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                         dtype=torch.int32)


def lane_columns(geo: tb.WindowGeometry, L: int) -> torch.Tensor:
    """The local column of each lane of a segment's row of warps (-1 for a
    lane past the strip), as ``csrc/bitlife_window.cu`` maps them: one warp
    takes all 32 lanes; with more, warp q's lane j holds column
    ``(32 - 2 tau) q - tau + j``."""
    lanes = torch.arange(32 * geo.warps)
    if geo.warps == 1:
        cols = lanes
    else:
        q, j = lanes // 32, lanes % 32
        cols = (32 - 2 * geo.warp_ghost) * q - geo.warp_ghost + j
    return torch.where((cols >= 0) & (cols < L), cols, -1)


def lane_owners(geo: tb.WindowGeometry, cols: torch.Tensor) -> torch.Tensor:
    j = torch.arange(cols.numel()) % 32
    tau = geo.warp_ghost
    inner = (j >= tau) & (j < 32 - tau) if geo.warps > 1 else j >= 0
    return inner & (cols >= 0)


def _warp_step(x: torch.Tensor, gen) -> torch.Tensor:
    """One step of every warp's 32 lanes on its own, a fresh poison column
    past each side of a warp (where the kernel's shuffles hand an edge lane
    its own sums), rows wrapping within the window."""
    *lead, R, n = x.shape
    w = x.reshape(*lead, R, n // 32, 32).movedim(-2, -3)
    junk = _junk((*w.shape[:-1], 2), gen)
    padded = torch.cat([junk[..., :1], w, junk[..., 1:]], dim=-1)
    out = tb._window_step(padded)[..., 1:-1]
    return out.movedim(-3, -2).reshape(x.shape)


def replay(ext: torch.Tensor, k: int, h: int, hx: int,
           geo: tb.WindowGeometry, seed: int = 0) -> torch.Tensor:
    """``bitlife_window``'s decomposition of ``k`` steps over the windows
    ``ext`` (a stack), in plain torch; returns the interiors. Each strip is
    held as its lanes: every warp steps alone; every ``warp_ghost`` steps
    each copy lane takes its column's owner's words; every ``ghost`` steps
    (``exchange``) the owners of a strip's ghost columns take the ring
    neighbours' own columns. Lanes past the strip hold poison."""
    R, C = ext.shape[-2:]
    lead = ext.shape[:-2]
    g, tau = geo.ghost, geo.warp_ghost
    gen = torch.Generator().manual_seed(seed)
    bounds = geo.strip_bounds(C)
    cols, owners, lanes = [], [], []
    for c0, c1 in bounds:
        cl = lane_columns(geo, c1 - c0 + 2 * g)
        cols.append(cl)
        owners.append(lane_owners(geo, cl))
        x = ext[..., (c0 - g + cl.clamp(min=0)) % C]
        lanes.append(torch.where(cl >= 0, x, _junk(x.shape, gen)))

    def owner_words(r: int, c: int) -> torch.Tensor:
        """Strip r's words of its local column c, from the lane owning it."""
        lane = int(torch.nonzero(owners[r] & (cols[r] == c))[0])
        return lanes[r][..., lane]

    for s in range(1, k + 1):
        lanes = [_warp_step(x, gen) for x in lanes]
        lanes = [torch.where(cl >= 0, x, _junk(x.shape, gen))
                 for x, cl in zip(lanes, cols)]
        if geo.exchange and s % g == 0 and s < k:
            n = len(lanes)
            fresh = [x.clone() for x in lanes]
            for r, (c0, c1) in enumerate(bounds):
                L = c1 - c0 + 2 * g
                wl = bounds[r - 1][1] - bounds[r - 1][0]
                for t in range(g):
                    for c, src_r, src_c in ((t, r - 1, wl + t),
                                            (L - g + t, (r + 1) % n, g + t)):
                        lane = int(torch.nonzero(owners[r] & (cols[r] == c))[0])
                        fresh[r][..., lane] = owner_words(src_r % n, src_c)
            lanes = fresh
        if geo.warps > 1 and s % tau == 0 and s < k:
            for r in range(len(lanes)):
                copies = torch.nonzero(~owners[r] & (cols[r] >= 0))[:, 0]
                for lane in copies.tolist():
                    lanes[r][..., lane] = owner_words(r, int(cols[r][lane]))
    out = []
    for r, (c0, c1) in enumerate(bounds):
        out += [owner_words(r, g + c) for c in range(c1 - c0)]
    own = torch.stack(out, dim=-1)
    return own[..., h : R - h, hx : C - hx]


def _check(shards, nw, W, h, hx, k, geo=None, seed=0):
    R, C = nw + 2 * h, W + 2 * hx
    ext = _words((shards, R, C), seed)
    geo = geo or tb.window_launch_geometry(shards, R, C, k)
    got = replay(ext, k, h, hx, geo, seed)
    want = tb._window_steps_plain(ext, k, h, hx)
    assert torch.equal(got, want), (shards, R, C, k, geo)
    return geo


def _ks(h, hx):
    return sorted({1, 7, tb.window_max_steps(h, hx)})


@pytest.mark.parametrize("name", sorted(PHASE13))
@pytest.mark.parametrize("which", [0, 1, 2])
def test_phase13_schedule_matches_plain(name, which):
    """The chosen geometry at each phase-13 window, k in {1, 7, k_max},
    bit for bit against the plain version."""
    shards, nw, W, h, hx = PHASE13[name]
    ks = _ks(h, hx)
    if which < len(ks):
        _check(shards, nw, W, h, hx, ks[which], seed=which)


@pytest.mark.parametrize("strips,ghost,k,tau", [
    (16, 1, 32, 1), (16, 4, 32, 1), (8, 32, 32, 1), (4, 7, 32, 1),
    (3, 10, 31, 1), (2, 1, 9, 1), (2, 5, 9, 1), (2, 3, 20, 1),
    (16, 4, 32, 2), (8, 8, 32, 4), (4, 8, 32, 8), (16, 32, 32, 3),
    (4, 12, 31, 6), (16, 12, 32, 6)])
def test_row8_geometries_match_plain(strips, ghost, k, tau):
    """Row 8's windows (hx = 0: the wrap is the torus, so the strips'
    ring must be exact) under exchanged and ghost-zone strips, a ring of
    two strips (each the other's left and right neighbour), and warps
    refreshing their copied lanes every ``tau`` steps."""
    shards, nw, W, h, hx = PHASE13["row 8"]
    R, C = nw + 2 * h, W + 2 * hx
    geo = tb.window_geometry(R, C, k, strips, ghost, 4, tau)
    assert geo.exchange == (ghost < k) and geo.warps > 1
    _check(shards, nw, W, h, hx, k, geo, seed=strips + ghost)


@pytest.mark.parametrize("ghost,k", [(1, 9), (5, 9), (9, 9), (2, 32)])
def test_single_strip_ring_matches_plain(ghost, k):
    """One strip a window: its left and right neighbour is itself, so an
    exchange pushes its own first and last columns into its own ghosts."""
    geo = tb.window_geometry(4, 40, k, 1, ghost, 4)
    assert geo.cluster == 1 and geo.exchange == (ghost < k)
    _check(3, 2, 40, 1, 0, k, geo, seed=ghost)


@pytest.mark.parametrize("shards,nw,W,h,hx,k", [
    (1, 3, 37, 2, 5, 5),      # C = 47 not a multiple of the strip
    (3, 2, 10, 1, 0, 32),     # C = 10 below the cluster's 16 strips
    (1, 1, 8, 1, 0, 32),      # a single shard, the narrowest board
    (2, 5, 61, 3, 17, 17),    # hx > 0 at k = hx
    (2, 4, 200, 2, 0, 64),    # hx == 0 at k = 32 h
    (1, 40, 30, 4, 6, 6),     # R = 48 rows: 12 segments a column
    (2, 70, 9, 1, 4, 4),      # R = 72 rows: 9 segments of 8
    (1, 292, 82, 4, 41, 41),  # R = 300: 32 rows a thread, refresh every step
])
def test_edge_shapes_match_plain(shards, nw, W, h, hx, k):
    for kk in sorted({1, min(7, k), k}):
        _check(shards, nw, W, h, hx, kk, seed=nw + W + kk)


@pytest.mark.parametrize("nw,W,h,hx", [(2, 128, 1, 0), (4, 64, 3, 16)])
def test_schedule_matches_jax_window_stepper(nw, W, h, hx):
    """The replay against the JAX ``make_window_stepper`` in interpret
    mode, k in {1, k_max}, under the chosen geometry and an exchanging
    one."""
    words = np.random.default_rng(nw * W).integers(
        0, 2 ** 32, (nw + 2 * h, W + 2 * hx), dtype=np.uint32)
    call = jbits.make_window_stepper(nw, W, h=h, halo_x=hx, interpret=True)
    R, C = words.shape
    for k in (1, tb.window_max_steps(h, hx)):
        want = np.asarray(call(jnp.asarray([k], jnp.int32),
                               jnp.asarray(words)))
        ext = torch.from_numpy(words.view(np.int32))
        for geo in (tb.window_launch_geometry(1, R, C, k),
                    tb.window_geometry(R, C, k, 4, 1, 8)):
            got = replay(ext, k, h, hx, geo)
            assert np.array_equal(got.numpy().view(np.uint32), want), (k, geo)


# ------------------------------------------------- the geometry function

SHAPES = [(s, nw + 2 * h, W + 2 * hx, k)
          for s, nw, W, h, hx in PHASE13.values()
          for k in _ks(h, hx)] + [
    (1, 3, 8, 1), (1, 3, 8, 32), (3, 4, 10, 32), (1, 48, 42, 6),
    (2, 72, 17, 4), (1, 300, 90, 32), (8, 6, 4000, 128), (1, 10, 2900, 5),
    (4, 33, 700, 96), (2, 16, 1024, 0)]


@pytest.mark.parametrize("shards,R,C,k", SHAPES)
def test_geometry_covers_every_column_once(shards, R, C, k):
    geo = tb.window_launch_geometry(shards, R, C, k)
    cols = [c for c0, c1 in geo.strip_bounds(C) for c in range(c0, c1)]
    assert cols == list(range(C))
    assert all(c1 > c0 for c0, c1 in geo.strip_bounds(C))
    assert geo.segments * geo.rows_per_thread >= R
    assert geo.segments == -(-R // geo.rows_per_thread)
    assert geo.rows_per_thread in tb.WINDOW_ROWS_PER_THREAD


@pytest.mark.parametrize("shards,R,C,k", SHAPES)
def test_geometry_fits_the_card(shards, R, C, k):
    geo = tb.window_launch_geometry(shards, R, C, k)
    assert 1 <= geo.cluster <= tb.WINDOW_MAX_CLUSTER
    assert geo.cluster in (1, geo.strips)
    assert geo.smem_bytes <= 232_448
    assert geo.threads <= tb.WINDOW_MAX_THREADS and geo.threads % 32 == 0
    assert geo.ghost >= 1
    assert geo.exchange == (geo.ghost < k)
    if geo.exchange:
        assert geo.cluster == geo.strips and geo.ghost <= C // geo.strips
    else:
        assert geo.ghost >= k
    k_max = max(k, 1)
    assert geo.ghost <= k_max
    lmax = -(-C // geo.strips) + 2 * geo.ghost
    own = 32 - 2 * geo.warp_ghost
    assert geo.warps == (1 if lmax <= 32 else -(-lmax // own))
    if geo.exchange:
        assert geo.ghost % geo.warp_ghost == 0
    assert geo.threads == 32 * geo.warps * geo.segments


@pytest.mark.parametrize("shards,R,C,k", SHAPES)
def test_geometry_is_a_function_of_its_inputs(shards, R, C, k):
    first = tb.window_launch_geometry(shards, R, C, k)
    assert tb.window_launch_geometry(shards, R, C, k) == first
    assert first.reason
    assert first == tb.window_geometry(R, C, k, first.strips, first.ghost,
                                       first.rows_per_thread,
                                       first.warp_ghost, first.reason)


def test_geometry_shared_memory_figures():
    """The shared-memory words of ``csrc/bitlife_window.cu:layout``:
    vertical words (two buffers x segments x 32 columns a warp x top and
    bottom), warp-edge columns (two buffers x two sides x segments x warps
    x copied lanes x rows), exchanged ghosts (two buffers x two sides x
    ghost x segments x rows)."""
    one = tb.window_geometry(4, 500, 32, 16, 4, 4)
    assert (one.segments, one.warps, one.exchange) == (1, 2, True)
    assert one.smem_bytes == 4 * (2 * 2 * 1 * 2 * 1 * 4 + 2 * 2 * 4 * 1 * 4)
    two = tb.window_geometry(48, 42, 6, 1, 6, 24)
    assert (two.segments, two.warps, two.exchange) == (2, 2, False)
    assert two.smem_bytes == 4 * (2 * 2 * 64 * 2 + 2 * 2 * 2 * 2 * 1 * 24)
    zone = tb.window_geometry(4, 500, 32, 16, 32, 4, 4)
    assert (zone.exchange, zone.cluster, zone.warps) == (False, 1, 4)
    assert zone.smem_bytes == 4 * 2 * 2 * 1 * 4 * 4 * 4
    small = tb.window_geometry(4, 20, 32, 1, 5, 4)
    assert (small.warps, small.smem_bytes) == (1, 4 * 2 * 2 * 5 * 4)
    wide = tb.window_geometry(10, 506, 96, 8, 8, 4, 4)
    assert (wide.segments, wide.warps, wide.threads) == (3, 4, 384)
    assert wide.smem_bytes == 4 * (2 * 3 * 128 * 2 + 2 * 2 * 3 * 4 * 4 * 4
                                   + 2 * 2 * 8 * 3 * 4)


@pytest.mark.parametrize("args,match", [
    ((4, 500, 32, 16, 4, 5), "rows per thread"),
    ((4, 500, 32, 0, 4, 4), "strips"),
    ((4, 500, 32, 16, 0, 4), "strips"),
    ((4, 500, 32, 32, 4, 4), "cluster"),
    ((4, 500, 64, 16, 40, 4), "wider than the narrowest strip"),
    ((4, 500, 128, 2, 126, 4), "threads"),
    ((4, 500, 32, 16, 6, 4, 4), "not a multiple of warp_ghost"),
    ((4, 500, 32, 16, 4, 4, 16), "warp_ghost"),
])
def test_geometry_refuses_what_the_entry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        tb.window_geometry(*args)
