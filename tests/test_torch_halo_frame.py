"""The RDMA rung's frame: ``ops.native_halo.halo_frame`` and the order of
work of ``csrc/halo_frame.cu``, on the CPU.

``halo_frame_plain`` (the sequential round's ``padded_round_block``) is
held bit for bit against the JAX package's ``haloplan.padded_round_block``
on the 8-device CPU mesh, over row, col and cart on four meshes, four
dtypes and depths up to a shard's extent; past it ``halo_frame`` refuses.

The CUDA kernel cannot run here, so this file replays its decomposition
on the bytes of a buffer: every block's band of rows, each row's three
runs (left ghosts, body, right ghosts) read from the shard the offset
table (``native_halo.frame_table``) names, and each run's head and tail
elements, its whole 16-byte words (loaded as one 16-byte, two 8-byte or
four 4-byte words, or funnel-shifted from five aligned 4-byte words; at
most two a lane a run on a short row, loaded before any store, else four
a lane at a time) and the element path of a column-strided block. The source buffer holds
poison past every edge of the block (row pitch padding, gaps between
shards and channels, bytes before and after), and the output buffer
poison past the frame's end; every frame byte must be written once, the
poison after it never, and the frame must equal the plain version's.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_and_open_mp_tpu.parallel import haloplan as jhp
from mpi_and_open_mp_tpu.parallel import mesh as jmesh
from mpi_and_open_mp_tpu_torch.ops import native_halo
from mpi_and_open_mp_tpu_torch.parallel import haloplan
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The replay is many small array operations: this module runs on one
    torch thread beside the other test processes of a parallel run, and
    hands the pool back after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LAYOUTS = ["row", "col", "cart"]
MESHES = [(8, 1), (1, 8), (4, 2), (2, 4)]
DTYPES = [("uint8", 1), ("int32", 1), ("float32", 1), ("float32", 2)]
BOARD = (64, 48)


def _board(dtype, channels, seed, shape=BOARD):
    rng = np.random.default_rng(seed)
    full = (channels, *shape) if channels > 1 else shape
    if dtype == "float32":
        return rng.random(full).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, full, dtype=dtype, endpoint=True)


def _jax_frames(board, layout, mesh_shape, depth):
    """JAX's ``padded_round_block`` under shard_map over ``board``, as
    the stacked per-shard frames ``(py, px, *C, H, W)``."""
    py, px = mesh_shape
    jm = jmesh.make_mesh_2d(py, px)
    spec = P(*(None,) * (board.ndim - 2), "y", "x")
    arr = jax.device_put(jnp.asarray(board), NamedSharding(jm, spec))
    out = np.array(jax.jit(jmesh.shard_map(
        lambda b: jhp.padded_round_block(layout, b, depth), mesh=jm,
        in_specs=spec, out_specs=spec, check_vma=False))(arr))
    return mesh_lib.shard(torch.from_numpy(out), py, px).numpy()


def _extent(mesh_shape):
    return min(BOARD[0] // mesh_shape[0], BOARD[1] // mesh_shape[1])


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("depth", [1, 3, "extent"])
@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_frame_plain_matches_jax(layout, mesh_shape, depth, dtype):
    """``halo_frame_plain`` and ``halo_frame`` on CPU shards equal the JAX
    package's ``padded_round_block``, shard by shard, bit for bit."""
    py, px = mesh_shape
    d = _extent(mesh_shape) if depth == "extent" else depth
    board = _board(*dtype, seed=100 * py + 10 * px + d)
    want = _jax_frames(board, layout, mesh_shape, d)
    stack = mesh_lib.shard(torch.from_numpy(board), py, px)
    got = native_halo.halo_frame_plain(stack, d, layout)
    assert got.is_contiguous() and got.dtype == stack.dtype
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(native_halo.halo_frame(stack, d, layout), got)
    assert torch.equal(haloplan.padded_round_block(layout, stack, d), got)


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_frame_past_the_extent_is_refused(layout, mesh_shape):
    """Past a shard's extent the padded round's ring slices clamp, so the
    JAX package and the port's plain version build frames of the wrong
    shape (``h + 2 min(d, h)``); ``halo_frame`` refuses instead, as it
    does a depth below 1."""
    py, px = mesh_shape
    h, w = BOARD[0] // py, BOARD[1] // px
    d = _extent(mesh_shape) + 1
    board = _board("int32", 1, seed=7)
    stack = mesh_lib.shard(torch.from_numpy(board), py, px)
    plain = native_halo.halo_frame_plain(stack, d, layout)
    assert plain.shape[-2:] != (h + 2 * d, w + 2 * d)
    assert np.array_equal(plain.numpy(),
                          _jax_frames(board, layout, mesh_shape, d))
    for bad in (d, 0, -1):
        with pytest.raises(ValueError, match="depth"):
            native_halo.halo_frame(stack, bad, layout)


def test_frame_refuses_what_the_kernel_does_not_take():
    block = torch.zeros((4, 2, 8, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="layout"):
        native_halo.halo_frame(block, 1, "diag")
    with pytest.raises(ValueError, match="stacked"):
        native_halo.halo_frame(block[0], 1, "cart")
    # No fallback: a block on neither the CPU nor a CUDA device is refused.
    with pytest.raises(ValueError, match="CUDA or CPU"):
        native_halo.halo_frame(block.to("meta"), 1, "cart")
    with pytest.raises(ValueError, match="merge"):
        native_halo.frame_geometry(
            torch.zeros((4, 2, 3, 2, 8, 6)).transpose(2, 3), 1)


def test_rdma_frame_checks_rings_and_mesh():
    """``haloplan._rdma_frame`` checks the collective ids of the rings it
    carries (y before x) and the plan's mesh against the block."""
    block = torch.arange(4 * 2 * 12 * 24, dtype=torch.int32).reshape(
        4, 2, 12, 24)
    plan = haloplan.plan_halo("cart", (4, 2), (12, 24), 1, 2)
    frame = haloplan._rdma_frame(block, plan, collective_ids=(13, 14))
    assert torch.equal(frame, haloplan.padded_round_block("cart", block, 2))
    for ids in ((13,), (14, 13), (13, 13)):
        with pytest.raises(ValueError, match="collective_ids"):
            haloplan._rdma_frame(block, plan, collective_ids=ids)
    row = haloplan.plan_halo("row", (4, 1), (12, 24), 1, 2)
    with pytest.raises(ValueError, match="mesh"):
        haloplan._rdma_frame(block, row, collective_ids=(13,))
    assert torch.equal(
        haloplan._rdma_frame(block[:, :1], row, collective_ids=(13,)),
        haloplan.padded_round_block("row", block[:, :1], 2))


def test_frame_table():
    """Shard (1, 0) of a 4x2 cart mesh reads shards (0, 1), (0, 0), (0, 1),
    (1, 1), (1, 0), (1, 1), (2, 1), (2, 0), (2, 1); on row its x
    neighbours are itself, on col its y neighbours."""
    strides = (100, 10)
    for layout, want in (
            ("cart", [(0, 1), (0, 0), (0, 1), (1, 1), (1, 0), (1, 1),
                      (2, 1), (2, 0), (2, 1)]),
            ("row", [(0, 0)] * 3 + [(1, 0)] * 3 + [(2, 0)] * 3),
            ("col", [(1, 1), (1, 0), (1, 1)] * 3)):
        table = native_halo.frame_table(4, 2, layout, strides,
                                        torch.device("cpu"))
        assert table.shape == (9, 8) and table.dtype == torch.int64
        assert table[:, 2].tolist() == [i * 100 + j * 10 for i, j in want]
    assert native_halo.FRAME_SOURCES[4] == (0, 0)


# ------------------------------------------------- the kernel's order of work


class Replay:
    """``csrc/halo_frame.cu`` on the bytes of one source buffer.

    ``storage`` is the flat byte buffer that the block views (poison
    outside the block), addresses are byte offsets into it (the card's
    allocations start on 256 bytes, so an offset's alignment is the
    address's); the frame is written into a fresh buffer with ``spare``
    poison bytes past its end."""

    SPARE = 64

    def __init__(self, storage: np.ndarray, block: torch.Tensor, depth: int,
                 layout: str):
        self.src = storage
        self.block, self.d, self.layout = block, depth, layout
        self.E = block.element_size()
        self.modes = collections.Counter()

    def run(self) -> tuple[np.ndarray, np.ndarray]:
        """(frame bytes plus the poison past them, writes per byte)."""
        block, d, E = self.block, self.d, self.E
        g = native_halo.frame_geometry(block, d)
        py, px = block.shape[:2]
        table = native_halo.frame_table(
            py, px, self.layout, tuple(block.stride()[:2]),
            torch.device("cpu")).numpy()
        H, W = g.h + 2 * d, g.w + 2 * d
        nbytes = g.shards * g.channels * H * W * E
        rng = np.random.default_rng(nbytes)
        self.out = rng.integers(0, 256, nbytes + self.SPARE, dtype=np.uint8)
        self.writes = np.zeros(nbytes + self.SPARE, np.int64)
        base = block.storage_offset()
        bands, shards, channels = g.grid
        assert (shards, channels) == (g.shards, g.channels)
        assert bands * native_halo.FRAME_BAND_ROWS >= H
        for bx in range(bands):
            for s in range(shards):
                for ch in range(channels):
                    for warp in range(native_halo.FRAME_BAND_ROWS):
                        r = bx * native_halo.FRAME_BAND_ROWS + warp
                        if r >= H:
                            continue
                        if r < d:
                            dy, row = 0, g.h - d + r
                        elif r < g.h + d:
                            dy, row = 1, r - d
                        else:
                            dy, row = 2, r - g.h - d
                        out_row = ((s * channels + ch) * H + r) * W
                        at = base + ch * g.sc + row * g.sr
                        runs = [((table[3 * dy + k, s] + at + first) * E,
                                 (out_row + col) * E, n)
                                for k, (col, n, first) in enumerate((
                                    (0, d, (g.w - d) * g.sw), (d, g.w, 0),
                                    (d + g.w, d, 0)))]
                        short = g.sw == 1 and all(
                            self.words(dst, n) <= 32 * SHORT_WORDS
                            for _, dst, n in runs)
                        if g.sw == 1:
                            self.modes["short row" if short
                                       else "long row"] += 1
                        for src, dst, n in runs:
                            self.copy_run(src, dst, n, g.sw, short)
        return self.out, self.writes

    def words(self, dst: int, n: int) -> int:
        """Whole 16-byte words of a run past its head elements."""
        head = min(((16 - dst % 16) % 16) // self.E, n)
        return (n - head) * self.E // 16

    def _read(self, lo: int, n: int) -> np.ndarray:
        assert 0 <= lo and lo + n <= self.src.size, "read past the buffer"
        return self.src[lo:lo + n]

    def _write(self, lo: int, data: np.ndarray) -> None:
        self.out[lo:lo + data.size] = data
        self.writes[lo:lo + data.size] += 1

    def _elems(self, src: int, dst: int, lo: int, hi: int, step: int = 1):
        E = self.E
        for q in range(lo, hi):
            self._write(dst + q * E, self._read(src + q * step * E, E))

    def copy_run(self, src: int, dst: int, n: int, sw: int,
                 short: bool) -> None:
        E = self.E
        if sw != 1:
            self.modes["strided"] += 1
            self._elems(src, dst, 0, n, sw)
            return
        head = min(((16 - dst % 16) % 16) // E, n)
        chunks = (n - head) * E // 16
        tail = head + chunks * 16 // E
        if head or tail < n:
            self.modes["elements"] += 1
        self._elems(src, dst, 0, head)
        self._elems(src, dst, tail, n)
        if not chunks:
            return
        s, t = src + head * E, dst + head * E
        assert t % 16 == 0
        _lanes_cover(chunks, short)
        mis = s % 16
        if mis % 4:
            self.modes["funnel"] += 1
            lo = s & ~3
            words = self._read(lo, 16 * chunks + 4).view("<u4").astype(
                np.uint64)
            sh = 8 * (mis & 3)
            pairs = (words[1:] << np.uint64(32)) | words[:-1]
            shifted = ((pairs >> np.uint64(sh)) & np.uint64(0xFFFFFFFF))
            self._write(t, shifted.astype("<u4").view(np.uint8))
            return
        self.modes["v16" if mis == 0 else "v8" if mis == 8 else "v4"] += 1
        self._write(t, self._read(s, 16 * chunks))


# 16-byte words a lane holds per run on a short row (the kernel's
# kShortWords).
SHORT_WORDS = 2
_COVERED: set[tuple[int, bool]] = set()


def _lanes_cover(chunks: int, short: bool) -> None:
    """The lanes' loops over a run's 16-byte words take each word once: on
    a short row words ``lane + 32 j`` for ``j < SHORT_WORDS``, else four a
    lane at a time, then one."""
    if (chunks, short) in _COVERED:
        return
    seen = []
    for lane in range(32):
        if short:
            seen += [lane + 32 * j for j in range(SHORT_WORDS)
                     if lane + 32 * j < chunks]
            continue
        c = lane
        while c + 96 < chunks:
            seen += [c, c + 32, c + 64, c + 96]
            c += 128
        while c < chunks:
            seen.append(c)
            c += 32
    assert sorted(seen) == list(range(chunks))
    _COVERED.add((chunks, short))


def _strided_block(dtype: torch.dtype, shape, *, pitch=0, gap=0, offset=0,
                   col_step=1, shard_order=(0, 1), seed=0):
    """A block of ``shape`` (py, px, *C, h, w) viewing a poisoned byte
    buffer: rows ``w * col_step + pitch`` elements apart, ``gap`` elements
    between channel planes and between shards (shards laid out in
    ``shard_order``, outermost first), starting ``offset`` elements in.
    Returns (byte buffer, block); the block holds random values."""
    E = torch.empty((), dtype=dtype).element_size()
    py, px, *chans, h, w = shape
    sw = col_step
    sr = w * col_step + pitch
    strides = [0] * len(shape)
    strides[-1], strides[-2] = sw, sr
    inner = h * sr + gap
    for i in range(len(chans) - 1, -1, -1):
        strides[2 + i] = inner
        inner *= chans[i]
    inner += gap
    sizes = (py, px)
    for dim in reversed(shard_order):
        strides[dim] = inner
        inner *= sizes[dim]
    span = offset + inner + 8
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, span * E + 24, dtype=np.uint8)
    view = torch.from_numpy(buf[:span * E]).view(dtype)
    block = view.as_strided(shape, strides, offset)
    # Random bytes, NaN patterns included: the kernel copies raw bytes.
    block.copy_(torch.from_numpy(
        rng.integers(0, 256, block.numel() * E, dtype=np.uint8)).view(
            dtype).reshape(shape))
    return buf, block


def _replay_case(buf, block, depth, layout):
    """Replay one launch and hold its bytes against the plain version's."""
    rep = Replay(buf, block, depth, layout)
    out, writes = rep.run()
    want = native_halo.halo_frame_plain(block, depth, layout)
    want = want.contiguous().numpy().view(np.uint8).reshape(-1)
    assert (writes[:want.size] == 1).all(), "a frame byte not written once"
    assert not writes[want.size:].any(), "a write past the frame"
    assert np.array_equal(out[:want.size], want)
    return rep.modes


REPLAY_DTYPES = [torch.uint8, torch.int16, torch.int32, torch.float32,
                 torch.float64]


@pytest.mark.parametrize("depth", [1, 3, "extent"])
@pytest.mark.parametrize("dtype", REPLAY_DTYPES, ids=str)
@pytest.mark.parametrize("layout,mesh_shape", [
    ("row", (4, 1)), ("col", (1, 4)), ("cart", (4, 2)), ("cart", (2, 4)),
    ("cart", (4, 1)), ("row", (4, 2)), ("col", (2, 4))],
    ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_replay_contiguous(layout, mesh_shape, dtype, depth):
    """A contiguous stack of 12 x 20 shards. On row over 4x2 and col over
    2x4 the axis the layout wraps locally holds two shards, each its own
    neighbour in the table."""
    py, px = mesh_shape
    d = 12 if depth == "extent" else depth
    buf, block = _strided_block(dtype, (py, px, 12, 20), seed=d)
    _replay_case(buf, block, d, layout)


@pytest.mark.parametrize("depth", [1, 3, 5])
@pytest.mark.parametrize("dtype", REPLAY_DTYPES, ids=str)
@pytest.mark.parametrize("layout,mesh_shape", [
    ("row", (4, 1)), ("col", (1, 4)), ("cart", (4, 2))],
    ids=lambda v: v if isinstance(v, str) else f"{v[0]}x{v[1]}")
def test_replay_strided_merged_channels(layout, mesh_shape, dtype, depth):
    """Two channel axes (2, 3) that merge into one, rows padded by 3
    elements, gaps of 5 between planes and shards, shards stored x-major,
    the block 7 elements into its buffer: the runs start at every
    alignment, so the 16-, 8- and 4-byte and funnel paths all run."""
    py, px = mesh_shape
    buf, block = _strided_block(dtype, (py, px, 2, 3, 9, 37), pitch=3,
                                gap=5, offset=7, shard_order=(1, 0),
                                seed=depth)
    assert native_halo.frame_geometry(block, depth).channels == 6
    _replay_case(buf, block, depth, layout)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32], ids=str)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_replay_column_strided(layout, dtype):
    """A block whose columns are 2 elements apart takes the element
    path."""
    mesh_shape = {"row": (4, 1), "col": (1, 4), "cart": (2, 2)}[layout]
    buf, block = _strided_block(dtype, (*mesh_shape, 2, 6, 10), col_step=2,
                                pitch=1, offset=3, seed=5)
    modes = _replay_case(buf, block, 2, layout)
    assert set(modes) == {"strided"}


def test_replay_takes_every_path():
    """Across a few launches every path of a run is taken: head and tail
    elements, 16-, 8- and 4-byte words, the funnel for bytes and 2-byte
    elements, and the column-strided elements."""
    modes = collections.Counter()
    for dtype in (torch.uint8, torch.int16, torch.float32, torch.float64):
        for offset in range(4):
            buf, block = _strided_block(dtype, (2, 2, 5, 70), pitch=offset,
                                        offset=offset, seed=offset)
            modes += _replay_case(buf, block, 3, "cart")
    buf, block = _strided_block(torch.uint8, (2, 2, 5, 20), col_step=3)
    modes += _replay_case(buf, block, 2, "cart")
    buf, block = _strided_block(torch.float32, (2, 2, 5, 300), pitch=1)
    modes += _replay_case(buf, block, 2, "cart")
    assert set(modes) == {"elements", "v16", "v8", "v4", "funnel",
                          "strided", "short row", "long row"}, modes


# The blocks the rung's coupled rounds hand the kernel on the main paths
# (chip_smoke.py phases 16-17): p46gun_big's uint8 shards on cart 4x2 and
# row 4 at depth 1, and heat's and lenia's float32 500^2 shards on cart
# 4x2 at fuse_steps 2 (depth 2 and 16).
MAIN_PATH = {
    "native cart 4x2": (torch.uint8, (4, 2, 125, 250), 1, "cart"),
    "native row 4": (torch.uint8, (4, 1, 125, 500), 1, "row"),
    "heat cart 4x2": (torch.float32, (4, 2, 125, 250), 2, "cart"),
    "lenia cart 4x2": (torch.float32, (4, 2, 125, 250), 16, "cart"),
}


@pytest.mark.parametrize("what", list(MAIN_PATH))
def test_replay_main_path_blocks(what):
    dtype, shape, depth, layout = MAIN_PATH[what]
    buf, block = _strided_block(dtype, shape, seed=len(what))
    assert block.is_contiguous()
    _replay_case(buf, block, depth, layout)
