"""The schedule of ``csrc/stencil_padded.cu``, emulated on the CPU.

The CUDA kernel cannot run here, so this file replays its order of work in
plain torch and holds the result bit for bit against the plain version the
card compares it with (``stencils.engine.step_padded``), and within
``parity_tol_for("offset")`` against the JAX package's Pallas kernel in
interpret mode (``test_torch_stencils.py:test_stencil_step_padded_matches_pallas``
runs it so). The replay follows the kernel's ``native_stencil.layout``: 32-row
output tiles of eight strips of ``strip`` cells in a row, for each tap row
in order a row segment read in pieces of ``chunk`` taps (the dense weight
grid), each piece's taps applied in dx order to all cells of a strip, a zero weight skipped, a
weight of 1 added without a multiply, the sum starting at -0.0, every
float32 operation rounded on its own. Cells past the interior, which the
last tile and the last strip of a row compute and never store, read
poison (NaN, or live cells for the integer rules) where the kernel reads
whatever its shared memory holds, so a read that strays into a stored
cell shows.

It also pins the kernel's shared memory (``native_stencil.smem_bytes``,
``fits_shared_memory``) against figures derived here from
``bitlife.SMEM_BYTES``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_and_open_mp_tpu import stencils as J
from mpi_and_open_mp_tpu.ops import pallas_life as jpl
from mpi_and_open_mp_tpu.stencils import engine as JE
from mpi_and_open_mp_tpu_torch import stencils as T
from mpi_and_open_mp_tpu_torch.ops import native_stencil as ns
from mpi_and_open_mp_tpu_torch.ops.bitlife import SMEM_BYTES
from mpi_and_open_mp_tpu_torch.stencils import engine as TE
from mpi_and_open_mp_tpu_torch.stencils import spec as TS

NAMES = ("gray_scott", "heat", "lenia", "life", "wireworld")
LENIA_RADII = (1, 3, 8, 13)


def _weight_grid(spec):
    """The kernel's dense weight grid: (2r + 1) rows of ``wp`` weights in
    float32 (int for the integer rules), 0 where ``offsets`` has no tap."""
    lay = ns.layout(spec)
    r = spec.radius
    grid = np.zeros((2 * r + 1, lay["wp"]),
                    np.float32 if spec.is_float else np.int64)
    for dy, dx, w in TE.offsets(spec):
        grid[dy + r, dx + r] = np.float32(w) if spec.is_float else int(w)
    return grid, lay["chunk"]


def blocked_step(spec, padded: torch.Tensor) -> torch.Tensor:
    """One step of ``spec`` over ``padded`` ((C, H, W) for a multi-channel
    rule, else (L, H, W) or (H, W)) in the kernel's order of work."""
    r = spec.radius
    H, W = padded.shape[-2:]
    h, w = H - 2 * r, W - 2 * r
    grid, chunk = _weight_grid(spec)
    wp = grid.shape[1]
    lay = ns.layout(spec)
    V, tile_w = lay["strip"], lay["tile_w"]
    # The tiles' whole extent: every strip of every tile, the last ones past
    # the interior, and what their last piece reads past the staged cells.
    rows = -(-h // ns.TILE_ROWS) * ns.TILE_ROWS
    strips = -(-w // tile_w) * tile_w // V
    ext_h, ext_w = rows + 2 * r, strips * V + wp + V
    field = padded if spec.pre is None else spec.pre(padded, torch)
    if spec.is_float:
        ext = torch.full((*padded.shape[:-2], ext_h, ext_w), float("nan"))
        acc = torch.full((*padded.shape[:-2], rows, strips, V), -0.0)
    else:
        field = field.to(torch.int32)
        ext = torch.ones((*padded.shape[:-2], ext_h, ext_w),
                         dtype=torch.int32)
        acc = torch.zeros((*padded.shape[:-2], rows, strips, V),
                          dtype=torch.int32)
    ext[..., :H, :W] = field
    starts = torch.arange(strips) * V
    for dy in range(2 * r + 1):
        band = ext[..., dy:dy + rows, :]
        for q in range(wp // chunk):
            u = q * chunk
            # The strip's row segment for this piece: cells s * V + u + k.
            cols = starts[:, None] + u + torch.arange(V + chunk)[None, :]
            seg = band[..., cols]  # (..., rows, strips, V + chunk)
            ws = grid[dy, u:u + chunk]
            for j in range(chunk):
                term = seg[..., j:j + V]
                if not spec.is_float:
                    acc = acc + int(ws[j]) * term
                    continue
                if ws[j] == 0:
                    continue
                if ws[j] != 1:
                    term = term * torch.tensor(ws[j])
                acc = acc + term
    agg = acc.reshape(*acc.shape[:-2], strips * V)[..., :h, :w]
    center = padded[..., r:r + h, r:r + w]
    if not spec.is_float:
        center = center.to(torch.int32)
    return TS.cast(spec.update(center, agg, torch), padded)


def _padded(spec, shape, seed, count=None):
    """A torus-padded board (or a stack of ``count``) from ``spec.init``."""
    rng = np.random.default_rng(seed)
    if count is None:
        board = spec.init(rng, shape)
    else:
        board = np.stack([spec.init(rng, shape) for _ in range(count)])
    return TE.torus_pad(torch.from_numpy(board), spec.radius)


# Each kernel the build holds: every rule at its registered radius (1;
# lenia's 8) has a kernel of its own, any other radius the generic one,
# run here at r = 2 and 8 for the rules registered at 1 and by lenia at 1,
# 3 and 13.
VARIANTS = tuple(f"{n}@{r}" for n in ("life", "heat", "gray_scott",
                                      "wireworld") for r in (2, 8))
SPECS = NAMES + tuple(f"lenia_r{r}" for r in LENIA_RADII) + VARIANTS


def _radius_variant(base, r):
    """``base``'s rule (update, pre, dtype, channels, init) over radius
    ``r``: all-ones integer weights, or make_lenia(r)'s table."""
    side = 2 * r + 1
    weights = (TS.make_lenia(r).weights if base.is_float else
               tuple(tuple(int((i, j) != (r, r)) for j in range(side))
                     for i in range(side)))
    return dataclasses.replace(base, name=f"{base.name}_r{r}", radius=r,
                               weights=weights, oracle_step=None)


def _spec(name):
    if name.startswith("lenia_r"):
        return TS.make_lenia(int(name[len("lenia_r"):]))
    if "@" in name:
        base, r = name.split("@")
        return _radius_variant(T.get(base), int(r))
    return T.get(name)


# Interior shapes: narrower than a strip, a strip +- 1, a tile +- 1, more
# than one tile each way, and (at small extents) a halo wider than the board.
SHAPES = [(5, 1), (3, 7), (9, 9), (37, 63), (33, 65), (4, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", SPECS)
def test_blocked_order_equals_step_padded(name, shape):
    """The kernel's schedule gives ``engine.step_padded``'s result bit
    for bit: every rule, lenia at r in {1, 3, 8, 13}, and every rule at
    r = 2 and 8."""
    spec = _spec(name)
    count = None if spec.channels > 1 else 2
    padded = _padded(spec, shape, seed=sum(shape) + spec.radius, count=count)
    got = blocked_step(spec, padded)
    want = TE.step_padded(spec, padded, torch)
    assert got.dtype == want.dtype == padded.dtype
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.uint8) if spec.is_float else got,
                       want.view(torch.uint8) if spec.is_float else want)


def test_blocked_order_with_a_halo_wider_than_the_board():
    """Lenia's radius-13 halo around a 2 x 3 board wraps it several times."""
    spec = TS.make_lenia(13)
    padded = _padded(spec, (2, 3), seed=3, count=3)
    assert padded.shape[-2:] == (28, 29)
    assert torch.equal(blocked_step(spec, padded),
                       TE.step_padded(spec, padded, torch))


def test_blocked_order_is_the_row_major_sum():
    """A float table where the order shows: the blocked sum of a row of
    mixed magnitudes equals the row-major sum and differs from the same
    taps summed in reverse."""
    weights = ((1.0, 3.0, 0.0), (1e8, 0.0, -1e8), (0.5, 1.0, 0.25))
    spec = TS.StencilSpec(name="order", radius=1, dtype="float32",
                          weights=weights, update=TS._heat_update)
    padded = _padded(T.get("heat"), (6, 11), seed=1, count=2)
    got = blocked_step(spec, padded)
    assert torch.equal(got, TE.step_padded(spec, padded, torch))
    agg = None
    for dy, dx, w in reversed(TE.offsets(spec)):
        term = padded[..., 1 + dy:7 + dy, 1 + dx:12 + dx]
        term = term if w == 1 else term * w
        agg = term if agg is None else agg + term
    reverse = TS._heat_update(padded[..., 1:7, 1:12], agg, torch)
    assert not torch.equal(got, reverse)


@pytest.mark.parametrize("shape", [(24, 32), (17, 23), (5, 6)],
                         ids=["24x32", "17x23", "5x6"])
@pytest.mark.parametrize("name", NAMES)
def test_blocked_order_matches_pallas(name, shape):
    """Against the JAX Pallas kernel in interpret mode, within
    ``parity_tol_for("offset")``; gray_scott as one (2, h+2, w+2) block."""
    jspec, tspec = J.get(name), T.get(name)
    board = jspec.init(np.random.default_rng(9), shape)
    width = [(0, 0)] * (board.ndim - 2) + [(tspec.radius, tspec.radius)] * 2
    padded = np.pad(board, width, mode="wrap")
    got = blocked_step(tspec, torch.from_numpy(padded)).numpy()
    want = np.asarray(jpl.stencil_step_padded_pallas(jspec,
                                                     jnp.asarray(padded)))
    assert got.dtype == want.dtype == jspec.np_dtype
    assert JE.parity_ok(jspec, got, want, **JE.parity_tol_for("offset"))


def _expected_smem(channels, radius, itemsize, fixed):
    """The layout's bytes, derived here: taps in chunks of a whole tap row
    in a kernel ``fixed`` at its radius (the rule's registered one), else
    8; strips of 4 cells for two channels, 8 in a kernel fixed at r = 1,
    else 16, eight strips across a tile of 32 rows; each staged row the
    tile's cells plus the padded tap row, rounded up to 16 bytes, then to
    16 past a multiple of 128, two such tiles for uint8 fixed at r = 1;
    then the 4-byte weight grid and one 4-byte kind per chunk, each rounded
    up to 16 bytes."""
    def r16(n):
        return -(-n // 16) * 16

    taps = 2 * radius + 1
    chunk = taps if fixed else 8
    strip = 4 if channels > 1 else 8 if fixed and radius == 1 else 16
    wp = -(-taps // chunk) * chunk
    row = r16((8 * strip + wp) * itemsize)
    row += (16 - row % 128) % 128
    buffers = 2 if fixed and radius == 1 and itemsize == 1 else 1
    return (buffers * channels * (32 + 2 * radius) * row
            + r16(taps * wp * 4) + r16(taps * (wp // chunk) * 4))


def test_shared_memory_of_the_layout():
    """``smem_bytes`` and ``fits_shared_memory`` give the layout's figures;
    the largest float32 lenia that fits is the largest radius whose bytes
    stay within ``SMEM_BYTES``, and make_lenia(55) still fits."""
    assert ns.TILE_ROWS == 32 and ns.STRIPS_ACROSS == 8
    assert ns.smem_bytes(T.get("life")) == 9856 == _expected_smem(
        1, 1, 1, fixed=True)
    assert ns.smem_bytes(T.get("wireworld")) == 9856
    assert ns.smem_bytes(T.get("heat")) == 9312 == _expected_smem(
        1, 1, 4, fixed=True)
    assert ns.smem_bytes(T.get("gray_scott")) == 9856 == _expected_smem(
        2, 1, 4, fixed=True)
    assert ns.smem_bytes(T.get("lenia")) == 32736 == _expected_smem(
        1, 8, 4, fixed=True)
    for r in (1, 2, 3, 13, 16, 31, 55):
        assert ns.smem_bytes(TS.make_lenia(r)) == _expected_smem(
            1, r, 4, fixed=False)
    r_max = max(r for r in range(1, 100)
                if _expected_smem(1, r, 4, fixed=r == 8) <= SMEM_BYTES)
    assert r_max == 61
    assert ns.fits_shared_memory(TS.make_lenia(55))
    assert ns.fits_shared_memory(TS.make_lenia(r_max))
    assert not ns.fits_shared_memory(TS.make_lenia(r_max + 1))


@pytest.mark.parametrize("name", SPECS)
def test_kernel_of_each_rule_and_radius(name):
    """A spec runs its rule's fixed kernel only at the rule's registered
    radius (lenia 8, the others 1): a whole tap row a chunk, strips of 8
    cells at r = 1 (4 for two channels); at any other radius the generic
    kernel's chunks of 8 taps and strips of 16 (4 for two channels)."""
    spec = _spec(name)
    registered = T.get("lenia" if ns.kernel_rule(spec).rule == ns.LENIA_RULE
                       else "life").radius
    fixed = spec.radius == registered
    lay = ns.layout(spec)
    assert ns.fixed_radius(ns.kernel_rule(spec).rule, spec.radius) == (
        spec.radius if fixed else 0)
    assert lay["chunk"] == (2 * spec.radius + 1 if fixed else 8)
    assert lay["strip"] == (4 if spec.channels > 1
                            else 8 if fixed and spec.radius == 1 else 16)
    assert lay["tile_w"] == ns.STRIPS_ACROSS * lay["strip"]
    assert lay["total"] == ns.smem_bytes(spec) == _expected_smem(
        spec.channels, spec.radius, spec.np_dtype.itemsize, fixed)
