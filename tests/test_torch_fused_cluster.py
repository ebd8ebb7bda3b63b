"""The schedule of ``csrc/bitlife_fused.cu``, emulated on the CPU.

The CUDA kernel cannot run here, so this file replays its decomposition in
plain torch and holds the result bit for bit against the plain version the
card compares it with (``bitlife._fused_steps_plain``: the whole extended
frame stepped as one window), and on two small boards against the JAX
package's ``life_run_fused_bits`` and ``life_run_frame_bits`` in interpret
mode. The replay takes its geometry from ``fused_launch_geometry`` (or a
geometry given) and holds every block of the launch side by side, as the
kernel's grid does: row bands, each of one tile (the frame's whole width)
or of 2-D tiles with ``wall`` columns a side, each tile of column strips
with ``ghost`` columns a side. Each strip is stepped alone as its lanes:
every warp on its own, with a fresh poison column past each side of a warp
and a fresh poison word row above and below the band's window every step
(the kernel's shuffles and its window's y wrap hand those edges junk), and
poison in every lane past the strip and in every window row past the
band's halo. With ``exchange`` the ghosts are refreshed every ``ghost``
steps from the ring neighbours' own columns (the kernel's pushes through
distributed shared memory); without, they come once from the frame. Every
``warp_ghost`` steps each copy lane takes its column's owner's words. A
column's segments trade exact words every step, so a column is stepped
whole here.

Separate cases pin the geometry function: every output word covered once,
the cluster at most 16, shared memory within a block's, an exchanged ghost
no wider than a strip, a wall of at least k columns wherever a tile's
window ends inside the frame, and the same inputs giving the same answer.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_and_open_mp_tpu.ops import bitlife as jb
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


# (plan arguments) of the main paths' four frames, cut to CPU size with
# their features kept: the 10000^2 padded frame (pad_y > 0, 128 wall
# columns), 16384^2 and 4096^2 aligned (128 wall columns), one shard of
# 10000^2 on cart 2x2 (exchanged columns, pad_y > 0); then an hx = 0 frame
# (the ring over the width is the torus) and a padded one of h = 3 whose
# 130 columns do not divide into 16 strips.
FRAMES = {
    "10000^2 frame": ((740, 1000), 1, 1, False, False, tb.SMEM_BYTES),
    "16384^2": ((1024, 1024), 1, 1, False, False, tb.SMEM_BYTES),
    "4096^2": ((512, 512), 1, 1, False, False, 14 * 416 * 8),
    "cart 2x2 shard": ((700, 600), 2, 2, True, True, tb.SMEM_BYTES),
    "hx 0 ring": ((256, 128), 1, 1, False, False, tb.SMEM_BYTES),
    "130 columns": ((100, 130), 1, 1, False, False, tb.SMEM_BYTES),
}


def _plan(name):
    return tb.plan_sharded_bits(*FRAMES[name])


def _frame_args(plan):
    return plan.nw_s, plan.W, plan.h, plan.hx


def _words(shape, seed) -> torch.Tensor:
    w = np.random.default_rng(seed).integers(0, 2 ** 32, shape,
                                             dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32))


def _junk(shape, gen) -> torch.Tensor:
    return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                         dtype=torch.int32)


def lanes_of(geo: tb.FusedGeometry) -> tuple[torch.Tensor, torch.Tensor]:
    """The local column of each lane of a segment's row of warps (before
    the strip's width cuts it) and whether the lane owns it, as
    ``csrc/bitlife_fused.cu`` maps them: one warp takes all 32 lanes; with
    more, warp q's lane j holds column ``(32 - 2 tau) q - tau + j`` and
    owns it for ``tau <= j < 32 - tau``."""
    lanes = torch.arange(32 * geo.warps)
    q, j = lanes // 32, lanes % 32
    if geo.warps == 1:
        return lanes, torch.ones_like(lanes, dtype=torch.bool)
    tau = geo.warp_ghost
    return (32 - 2 * tau) * q - tau + j, (j >= tau) & (j < 32 - tau)


def blocks_of(nw, W, hx, geo):
    """Every block of the launch in grid order: (band rows b0, b1, tile
    columns t0, t1, the tile window's width Ct and first frame column x0,
    the strip's columns c0, c1 of the tile window)."""
    out = []
    for b0, b1 in geo.band_bounds(nw):
        for t0, t1 in geo.tile_bounds(W):
            Ct = t1 - t0 + 2 * geo.wall
            for c0, c1 in geo.strip_bounds(Ct):
                out.append((b0, b1, t0, t1, Ct, hx + t0 - geo.wall, c0, c1))
    return out


def replay(ext: torch.Tensor, k: int, nw: int, W: int, h: int, hx: int,
           geo: tb.FusedGeometry, seed: int = 0) -> torch.Tensor:
    """``bitlife_fused``'s decomposition of ``k`` steps over the frame
    ``ext`` of an ``(nw, W)`` interior, in plain torch; returns the
    interior. All blocks are one ``(blocks, rows, lanes)`` tensor."""
    E = W + 2 * hx
    g, tau, R = geo.ghost, geo.warp_ghost, geo.rows
    gen = torch.Generator().manual_seed(seed)
    blocks = blocks_of(nw, W, hx, geo)
    col, own = lanes_of(geo)
    n = col.numel()
    B = len(blocks)
    L = torch.tensor([c1 - c0 + 2 * g for *_, c0, c1 in blocks])
    cols = col.expand(B, n)
    valid = (cols >= 0) & (cols < L[:, None])
    owner = valid & own
    # Rows of each band's window that the kernel needs: the band and its
    # halo; the rest (the round-up to segments, rows past the frame) are
    # poison.
    need = torch.tensor([b1 - b0 + 2 * h for b0, b1, *_ in blocks])
    rows_ok = torch.arange(R)[None, :] < need[:, None]
    x = torch.empty((B, R, n), dtype=torch.int32)
    for i, (b0, b1, t0, t1, Ct, x0, c0, c1) in enumerate(blocks):
        cw = (c0 - g + cols[i].clamp(min=0)) % Ct
        rows = torch.arange(b0, b0 + R).clamp(max=ext.shape[0] - 1)
        x[i] = ext[rows][:, (x0 + cw) % E]
    mask = valid[:, None, :] & rows_ok[:, :, None]

    def poison(t):
        return torch.where(mask, t, _junk(t.shape, gen))

    x = poison(x)
    # The owner lane of each (block, local column).
    owner_lane = {}
    for i in range(B):
        for lane in torch.nonzero(owner[i])[:, 0].tolist():
            owner_lane[i, int(cols[i, lane])] = lane
    # Strip refresh: each ghost column's owner takes the ring neighbour's
    # own column (its first g owned from the right neighbour, its last g
    # owned from the left), within the tile.
    per_tile = geo.strips
    ex_dst, ex_src = [], []
    for i, blk in enumerate(blocks):
        base, r = i - i % per_tile, i % per_tile
        left, right = base + (r - 1) % per_tile, base + (r + 1) % per_tile
        wl = int(L[left]) - 2 * g
        Li = int(L[i])
        for t in range(g):
            ex_dst += [(i, owner_lane[i, t]), (i, owner_lane[i, Li - g + t])]
            ex_src += [(left, owner_lane[left, wl + t]),
                       (right, owner_lane[right, g + t])]
    # Warp refresh: each copy lane takes its column's owner's words.
    cp_dst, cp_src = [], []
    for i in range(B):
        for lane in torch.nonzero(valid[i] & ~own)[:, 0].tolist():
            cp_dst.append((i, lane))
            cp_src.append((i, owner_lane[i, int(cols[i, lane])]))

    def refresh(t, dst, src):
        if dst:
            (db, dl), (sb, sl) = zip(*dst), zip(*src)
            t[list(db), :, list(dl)] = t[list(sb), :, list(sl)]

    for s in range(1, k + 1):
        w = x.reshape(B, R, geo.warps, 32).movedim(2, 1)
        w = torch.cat([_junk((B, geo.warps, R, 1), gen), w,
                       _junk((B, geo.warps, R, 1), gen)], dim=-1)
        w = torch.cat([_junk((B, geo.warps, 1, 34), gen), w,
                       _junk((B, geo.warps, 1, 34), gen)], dim=-2)
        w = tb._window_step(w)[..., 1:-1, 1:-1]
        x = poison(w.movedim(1, 2).reshape(B, R, n))
        if geo.exchange and s % g == 0 and s < k:
            refresh(x, ex_dst, ex_src)
        if geo.warps > 1 and s % tau == 0 and s < k:
            refresh(x, cp_dst, cp_src)
    out = torch.full((nw, W), 7, dtype=torch.int32)
    written = torch.zeros((nw, W), dtype=torch.int32)
    for i, (b0, b1, t0, t1, Ct, x0, c0, c1) in enumerate(blocks):
        for c in range(c0, c1):
            if geo.wall <= c < Ct - geo.wall:
                lane = owner_lane[i, c - c0 + g]
                out[b0:b1, t0 + c - geo.wall] = x[i, h : h + b1 - b0, lane]
                written[b0:b1, t0 + c - geo.wall] += 1
    assert bool((written == 1).all()), "an output word written != once"
    return out


def _check(plan, k, geo=None, seed=0):
    nw, W, h, hx = _frame_args(plan)
    ext = _words((nw + 2 * h, W + 2 * hx), seed)
    geo = geo or tb.fused_launch_geometry(nw, W, h, hx, k)
    got = replay(ext, k, nw, W, h, hx, geo, seed)
    want = tb._fused_steps_plain(ext, k, plan)
    assert torch.equal(got, want), (nw, W, h, hx, k, geo)
    return geo


def _ks(plan):
    geo = tb.fused_launch_geometry(*_frame_args(plan), plan.k_max)
    return sorted({1, geo.ghost, geo.ghost + 1, plan.k_max - 1, plan.k_max}
                  & set(range(1, plan.k_max + 1)))


@pytest.mark.parametrize("name", sorted(FRAMES))
@pytest.mark.parametrize("which", range(5))
def test_chosen_geometry_matches_plain(name, which):
    """The chosen geometry at each frame, k in {1, g, g + 1, k_max - 1,
    k_max} (127 and 128 at h = 4), bit for bit against the plain
    version."""
    plan = _plan(name)
    ks = _ks(plan)
    if which < len(ks):
        _check(plan, ks[which], seed=which)


# (frame, k, bands, tiles, wall, strips, ghost, rt, tau): each family of
# geometry forced - one tile as a ring of a cluster, several segments a
# column, 2-D tiles with their walls, ghost-zone strips (no cluster), a
# strip of one (a ring with itself), several warps a row with 1, 2 or 4
# copied lanes, an hx = 0 ring, and tiles and strips of unequal widths.
FORCED = [
    ("hx 0 ring", 128, 2, 1, 0, 16, 4, 12, 1),
    ("hx 0 ring", 33, 1, 1, 0, 3, 8, 4, 2),
    ("hx 0 ring", 128, 1, 3, 128, 2, 16, 16, 4),
    ("hx 0 ring", 20, 4, 5, 20, 1, 20, 8, 1),
    ("hx 0 ring", 9, 3, 1, 0, 1, 4, 8, 1),
    ("130 columns", 96, 1, 1, 0, 16, 4, 4, 1),
    ("130 columns", 96, 2, 2, 96, 7, 8, 8, 2),
    ("4096^2", 128, 4, 1, 128, 16, 16, 4, 4),
    ("4096^2", 128, 3, 2, 128, 5, 32, 12, 2),
    ("4096^2", 17, 2, 3, 17, 16, 17, 8, 1),
    ("10000^2 frame", 128, 8, 1, 128, 16, 8, 8, 1),
    ("10000^2 frame", 65, 1, 4, 65, 4, 8, 32, 1),
    ("cart 2x2 shard", 128, 1, 1, 128, 11, 8, 20, 2),
    ("cart 2x2 shard", 100, 3, 2, 100, 8, 4, 8, 4),
]


@pytest.mark.parametrize("case", FORCED, ids=lambda c: f"{c[0]}-{c[1:]}")
def test_forced_geometry_matches_plain(case):
    name, k, bands, tiles, wall, strips, ghost, rt, tau = case
    plan = _plan(name)
    for kk in sorted({ghost + 1, k} & set(range(1, k + 1))):
        geo = tb.fused_geometry(*_frame_args(plan), kk, bands, tiles, wall,
                                strips, ghost, rt, tau)
        _check(plan, kk, geo, seed=kk + bands)


def test_forced_families_are_distinct():
    """The forced cases above cover every family: exchange and ghost zones,
    one and several segments, warps and tiles, a strip of one."""
    geos = [tb.fused_geometry(*_frame_args(_plan(c[0])), *c[1:])
            for c in FORCED]
    assert {g.exchange for g in geos} == {True, False}
    assert {g.segments > 1 for g in geos} == {True, False}
    assert {g.warps > 1 for g in geos} == {True, False}
    assert {g.tiles > 1 for g in geos} == {True, False}
    assert any(g.strips == 1 and g.exchange for g in geos)
    assert {g.warp_ghost for g in geos if g.warps > 1} == {1, 2, 4}


def _run_replayed(plan, q, n, seed):
    def steps(ext, k, plan):
        geo = tb.fused_launch_geometry(*_frame_args(plan), k)
        return replay(ext, k, *_frame_args(plan), geo, seed)
    return tb._run_plan(q, n, plan, steps)


def test_replay_matches_jax_fused_bits():
    """An aligned board through the runner with the replay for the
    kernel, two rounds (128 + 2 steps), against the JAX package's
    ``life_run_fused_bits`` in interpret mode."""
    rng = np.random.default_rng(3)
    b = (rng.random((256, 128)) < 0.4).astype(np.uint8)
    plan = tb.plan_sharded_bits((256, 128))
    want = np.asarray(jb.life_run_fused_bits(jnp.asarray(b), 130,
                                             interpret=True))
    out = _run_replayed(plan, tb.pack_board_exact(torch.from_numpy(b)), 130,
                        seed=1)
    assert np.array_equal(tb.unpack_board_exact(out).numpy(), want)


def test_replay_matches_jax_frame_bits():
    """A padded frame (pad_y = 28, h = 3) through the runner with the
    replay, two rounds (96 + 14 steps), against ``life_run_frame_bits``."""
    rng = np.random.default_rng(33)
    b = (rng.random((100, 130)) < 0.4).astype(np.uint8)
    plan = tb.plan_sharded_bits((100, 130))
    want = np.asarray(jb.life_run_frame_bits(
        jnp.asarray(b), 110, interpret=True, budget=jb._PACKED_VMEM_LIMIT))
    frame = torch.zeros(plan.frame, dtype=torch.uint8)
    frame[:100] = torch.from_numpy(b)
    out = _run_replayed(plan, tb.pack_board_exact(frame), 110, seed=2)
    assert np.array_equal(tb.unpack_board_exact(out)[:100].numpy(), want)


# ------------------------------------------------- the geometry function

# (nw, W, h, hx, k): the frames above at each k, and the main paths' four
# frames at their true sizes (10000^2 padded, 16384^2, 4096^2, a cart 2x2
# shard of 10000^2) at k_max and at a last round's remainder.
SHAPES = sorted({(*_frame_args(_plan(n)), k) for n in FRAMES
                 for k in _ks(_plan(n))} | {
    (313, 10000, 4, 128, 128), (313, 10000, 4, 128, 44),
    (512, 16384, 4, 128, 128), (128, 4096, 4, 128, 128),
    (128, 4096, 4, 128, 44), (157, 5000, 4, 128, 128)})


@pytest.mark.parametrize("nw,W,h,hx,k", SHAPES)
def test_geometry_covers_every_word_once(nw, W, h, hx, k):
    geo = tb.fused_launch_geometry(nw, W, h, hx, k)
    rows = [r for b0, b1 in geo.band_bounds(nw) for r in range(b0, b1)]
    assert rows == list(range(nw))
    cols = [c for t0, t1 in geo.tile_bounds(W) for c in range(t0, t1)]
    assert cols == list(range(W))
    for t0, t1 in geo.tile_bounds(W):
        Ct = t1 - t0 + 2 * geo.wall
        strips = [c for c0, c1 in geo.strip_bounds(Ct)
                  for c in range(c0, c1)]
        assert strips == list(range(Ct))
        assert all(c1 > c0 for c0, c1 in geo.strip_bounds(Ct))
    tallest = max(b1 - b0 for b0, b1 in geo.band_bounds(nw))
    assert geo.rows >= tallest + 2 * h
    assert geo.segments == -(-(tallest + 2 * h) // geo.rows_per_thread)
    assert geo.rows_per_thread in tb.FUSED_ROWS_PER_THREAD


@pytest.mark.parametrize("nw,W,h,hx,k", SHAPES)
def test_geometry_fits_the_card(nw, W, h, hx, k):
    geo = tb.fused_launch_geometry(nw, W, h, hx, k)
    assert 1 <= geo.cluster <= tb.WINDOW_MAX_CLUSTER
    assert geo.cluster == (geo.strips if geo.exchange else 1)
    assert geo.smem_bytes <= 232_448
    assert geo.threads <= tb.WINDOW_MAX_THREADS and geo.threads % 32 == 0
    assert geo.threads == 32 * geo.warps * geo.segments
    assert geo.exchange == (geo.ghost < k)
    cmin = W // geo.tiles + 2 * geo.wall
    if geo.exchange:
        assert geo.ghost <= cmin // geo.strips
        assert geo.ghost % geo.warp_ghost == 0
    # Junk enters a band's window one bit row a step, and a tile's window
    # one column a step where it ends inside the frame.
    assert 32 * h >= k
    if geo.tiles > 1:
        assert geo.wall >= k
    else:
        assert geo.wall == hx and (hx == 0 or hx >= k)
    lmax = -(-(-(-W // geo.tiles) + 2 * geo.wall) // geo.strips) + 2 * geo.ghost
    own = 32 - 2 * geo.warp_ghost
    assert geo.warps == (1 if lmax <= 32 else -(-lmax // own))


@pytest.mark.parametrize("nw,W,h,hx,k", SHAPES)
def test_geometry_is_a_function_of_its_inputs(nw, W, h, hx, k):
    first = tb.fused_launch_geometry(nw, W, h, hx, k)
    tb.fused_launch_geometry.cache_clear()
    assert tb.fused_launch_geometry(nw, W, h, hx, k) == first
    assert first.reason
    assert first == tb.fused_geometry(nw, W, h, hx, k, first.bands,
                                      first.tiles, first.wall, first.strips,
                                      first.ghost, first.rows_per_thread,
                                      first.warp_ghost, first.reason)


def test_geometry_shared_memory_figures():
    """The shared-memory words of ``csrc/bitlife_fused.cu:layout``:
    vertical word pairs (two buffers x segments x 32 columns a warp x top
    and bottom), warp-edge columns (two buffers x two sides x segments x
    warps x copied lanes x rows), exchanged ghosts (two buffers x two
    sides x ghost x segments x rows)."""
    one = tb.fused_geometry(8, 128, 4, 0, 128, 1, 1, 0, 16, 4, 16, 1)
    assert (one.segments, one.warps, one.exchange) == (1, 1, True)
    assert one.smem_bytes == 4 * 2 * 2 * 4 * 1 * 16
    two = tb.fused_geometry(8, 128, 4, 0, 128, 2, 1, 0, 2, 16, 4, 2)
    assert (two.segments, two.warps, two.exchange) == (3, 4, True)
    assert two.smem_bytes == 4 * (2 * 3 * 128 * 2 + 2 * 2 * 3 * 4 * 2 * 4
                                  + 2 * 2 * 16 * 3 * 4)
    zone = tb.fused_geometry(16, 512, 4, 128, 17, 2, 3, 17, 16, 17, 8, 1)
    assert (zone.exchange, zone.cluster, zone.segments, zone.warps) == (
        False, 1, 2, 2)
    assert zone.smem_bytes == 4 * (2 * 2 * 64 * 2 + 2 * 2 * 2 * 2 * 1 * 8)


@pytest.mark.parametrize("args,match", [
    ((8, 128, 4, 0, 128, 1, 1, 0, 16, 4, 6, 1), "rows per thread"),
    ((8, 128, 4, 0, 128, 9, 1, 0, 16, 4, 16, 1), "bands"),
    ((8, 128, 4, 0, 128, 1, 1, 0, 17, 4, 16, 1), "strips"),
    ((8, 128, 4, 0, 128, 1, 1, 5, 16, 4, 16, 1), "one tile"),
    ((8, 128, 4, 0, 128, 1, 2, 100, 16, 4, 16, 1), "wall of at least"),
    ((8, 128, 4, 0, 128, 1, 1, 0, 16, 12, 16, 1), "wider than"),
    ((8, 128, 4, 0, 128, 1, 1, 0, 16, 6, 16, 4), "multiple of warp_ghost"),
    ((8, 128, 4, 0, 128, 1, 1, 0, 1, 4, 4, 1), "threads"),
])
def test_geometry_refuses_what_the_entry_refuses(args, match):
    with pytest.raises(ValueError, match=match):
        tb.fused_geometry(*args)


def test_fused_steps_takes_a_geometry_on_the_cpu():
    """The wrapper's ``geometry`` is the card's: on the CPU the plain
    version runs whatever it says, and launches nothing."""
    plan = _plan("hx 0 ring")
    ext = _words((plan.nw_s + 2 * plan.h, plan.W), 5)
    geo = tb.fused_geometry(*_frame_args(plan), 9, 3, 1, 0, 1, 4, 8, 1)
    before = tb.fused_steps.launches
    got = tb.fused_steps(ext, 9, plan, geometry=geo)
    assert torch.equal(got, tb._fused_steps_plain(ext, 9, plan))
    assert tb.fused_steps.launches == before


def test_plain_version_is_the_whole_frame_window():
    """``_fused_steps_plain`` steps the frame as one window: the replay's
    reference, unchanged by the kernel's redesign."""
    plan = types.SimpleNamespace(h=2, hx=3, nw_s=4, W=20)
    ext = _words((8, 26), 9)
    w = ext
    for _ in range(5):
        w = tb._window_step(w)
    assert torch.equal(tb._fused_steps_plain(ext, 5, plan), w[2:6, 3:23])
