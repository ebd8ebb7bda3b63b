"""One stencil step of any registered rule over halo-padded blocks.

Counterpart of ``mpi_and_open_mp_tpu/ops/pallas_life.py:
stencil_step_padded_pallas``. :func:`stencil_step_padded` takes
``(*lead, h+2r, w+2r)`` and returns ``(*lead, h, w)``; the leading axes
are a stack of single-channel boards, or the channels of one board. On a
CUDA tensor it launches the hand-written kernel ``csrc/stencil_padded.cu``;
on a CPU tensor it runs the kernel's plain version,
``stencils.engine.step_padded``.

The kernel implements five rules, picked by the spec's ``update`` (and
``pre``) functions rather than its name, so every ``make_lenia(r)`` maps
to lenia (:func:`kernel_rule`). A spec whose rule the kernel lacks raises
on the card. The JAX package's 4 MB VMEM gate has no counterpart: the
kernel tiles a board over thread blocks of :data:`TILE_ROWS` rows, a
thread a strip of 4, 8 or 16 cells in one row (:func:`strip_cells`) with
the taps blocked in registers, so any extent runs. Each rule has a kernel
of its own at its registered radius (:func:`fixed_radius`) and a generic
one for any other. Only the radius is
bounded, by a block's shared memory, which holds the tile and its r-wide
halo in the cells' own type, the offset table as a dense weight grid, and
one kind per chunk of taps (:func:`layout`, :func:`fits_shared_memory`: up
to r = 61 for a float32 lenia).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.ops.bitlife import SMEM_BYTES
from mpi_and_open_mp_tpu_torch.stencils import engine, spec as spec_lib

# A tile's rows and the thread strips across it (csrc/stencil_padded.cu:
# kThreadsY, kThreadsX).
TILE_ROWS = 32
STRIPS_ACROSS = 8
LENIA_RULE = 4


def fixed_radius(rule: int, radius: int) -> int:
    """The radius fixed at compile time in the kernel that runs ``rule``
    at ``radius`` (csrc/stencil_padded.cu: fixed_radius): the rule's
    registered radius (8 for lenia, 1 for the others), whose tap rows are
    one chunk, else 0 for the generic kernel."""
    return radius if radius == (8 if rule == LENIA_RULE else 1) else 0


def strip_cells(fixed: int, channels: int) -> int:
    """Cells of a thread's strip (csrc/stencil_padded.cu: strip_cells): 4
    for two channels, 8 in a kernel fixed at r = 1, else 16."""
    if channels > 1:
        return 4
    return 8 if fixed == 1 else 16


@dataclass(frozen=True)
class KernelRule:
    """One device rule of the kernel and the spec fields it assumes."""

    rule: int
    dtype: str
    channels: int


# Keyed by the spec's (update, pre); the rule numbers are the kernel's.
RULES = {
    (spec_lib._life_update, None): KernelRule(0, "uint8", 1),
    (spec_lib._heat_update, None): KernelRule(1, "float32", 1),
    (spec_lib._gray_scott_update, None): KernelRule(2, "float32", 2),
    (spec_lib._wireworld_update, spec_lib._wireworld_pre):
        KernelRule(3, "uint8", 1),
    (spec_lib._lenia_update, None): KernelRule(LENIA_RULE, "float32", 1),
}


def kernel_rule(spec: spec_lib.StencilSpec) -> KernelRule:
    """The kernel's rule for ``spec``; raises ValueError when the kernel
    implements none (another update, another dtype or channel count,
    non-integer weights on an integer rule, or no taps)."""
    rule = RULES.get((spec.update, spec.pre))
    if (rule is None or rule.dtype != spec.dtype
            or rule.channels != spec.channels):
        raise ValueError(
            f"stencil {spec.name!r}: the stencil_padded kernel has no rule "
            f"for update={getattr(spec.update, '__name__', spec.update)} "
            f"(dtype {spec.dtype}, {spec.channels} channel(s)); its rules "
            "are life, heat, gray_scott, wireworld and lenia")
    taps = engine.offsets(spec)
    if not taps:
        raise ValueError(f"stencil {spec.name!r}: no nonzero weights")
    if not spec.is_float and any(float(w) != int(w) for _, _, w in taps):
        raise ValueError(
            f"stencil {spec.name!r}: an integer rule needs integer weights")
    return rule


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def layout(spec: spec_lib.StencilSpec) -> dict[str, int]:
    """The kernel's tiling and shared memory for ``spec`` (csrc/
    stencil_padded.cu: layout): taps in chunks of ``chunk`` (a whole tap
    row, 2r + 1, at the rule's registered radius, else 8: :func:
    `fixed_radius`); a thread's strip of ``strip`` cells
    (:func:`strip_cells`); a tile of
    :data:`TILE_ROWS` x ``tile_w`` outputs; each tap row of the dense
    weight grid ``wp`` wide (2r + 1 rounded up to a chunk); ``channels``
    planes of 32 + 2r staged rows of ``row_bytes`` (tile_w + wp cells of
    the spec's dtype, rounded up to 16 bytes, then to 16 past a multiple of
    128), in two ``buffers`` for uint8 at r = 1 (the next board is staged
    while this one is computed), else one; the grid's 4-byte weights; one
    4-byte kind per chunk. ``total`` is what a block asks for. Raises
    ValueError for a spec the kernel has no rule for (:func:`kernel_rule`).
    """
    r = spec.radius
    fixed = fixed_radius(kernel_rule(spec).rule, r)
    chunk = 2 * fixed + 1 if fixed else 8
    strip = strip_cells(fixed, spec.channels)
    tile_w = strip * STRIPS_ACROSS
    wp = -(-(2 * r + 1) // chunk) * chunk
    itemsize = spec.np_dtype.itemsize
    row = _round16((tile_w + wp) * itemsize)
    row_bytes = row + (16 - row % 128) % 128
    out = {"chunk": chunk, "strip": strip, "tile_w": tile_w, "wp": wp,
           "row_bytes": row_bytes,
           "tile_bytes": spec.channels * (TILE_ROWS + 2 * r) * row_bytes,
           "buffers": 2 if fixed == 1 and itemsize == 1 else 1,
           "weight_bytes": _round16((2 * r + 1) * wp * 4),
           "kind_bytes": _round16((2 * r + 1) * (wp // chunk) * 4)}
    out["total"] = (out["buffers"] * out["tile_bytes"]
                    + out["weight_bytes"] + out["kind_bytes"])
    return out


def smem_bytes(spec: spec_lib.StencilSpec) -> int:
    """Dynamic shared memory one block of the kernel asks for on ``spec``:
    :func:`layout`'s total."""
    return layout(spec)["total"]


def fits_shared_memory(spec: spec_lib.StencilSpec) -> bool:
    return smem_bytes(spec) <= SMEM_BYTES


def _offset_table(spec: spec_lib.StencilSpec,
                  device: torch.device) -> torch.Tensor:
    """(n_off, 3) int32 on ``device``: dy, dx and the float32 bits of the
    weight, in ``engine.offsets`` order (a float32 field times a Python
    float weight multiplies by the weight rounded to float32)."""
    taps = engine.offsets(spec)
    table = np.empty((len(taps), 3), np.int32)
    for k, (dy, dx, w) in enumerate(taps):
        table[k] = (dy, dx, np.float32(w).view(np.int32))
    return torch.from_numpy(table).to(device)


def _check_block(spec: spec_lib.StencilSpec, padded: torch.Tensor) -> None:
    r = spec.radius
    if padded.dim() < 2 or padded.shape[-2] <= 2 * r \
            or padded.shape[-1] <= 2 * r:
        raise ValueError(
            f"stencil_step_padded: a block with a {r}-wide halo needs both "
            f"last extents > {2 * r}, got {tuple(padded.shape)}")
    if spec.channels > 1 and (padded.dim() < 3
                              or padded.shape[-3] != spec.channels):
        raise ValueError(
            f"stencil_step_padded: {spec.name!r} takes "
            f"(..., {spec.channels}, h+2r, w+2r) boards (channels on the "
            f"third-to-last axis), got {tuple(padded.shape)}")


def step_padded_plain(spec: spec_lib.StencilSpec,
                      padded: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version, ``engine.step_padded``, on blocks laid
    out as the kernel takes them: a multi-channel rule indexes its
    channels on the leading axis, so a stack ``(*S, C, H, W)`` goes
    channels first and back."""
    return engine.channels_first(
        spec, padded, lambda b: engine.step_padded(spec, b, torch))


def stencil_step_padded(spec: spec_lib.StencilSpec,
                        padded: torch.Tensor) -> torch.Tensor:
    """One step of ``spec`` over the interior of ``padded``: the
    ``stencil_padded`` kernel on the card, :func:`step_padded_plain` on
    the CPU. The result has ``padded``'s dtype."""
    _check_block(spec, padded)
    if padded.device.type == "cpu":
        return step_padded_plain(spec, padded)
    out = _launch(spec, padded)
    if out.numel():
        stencil_step_padded.launches += 1
    return out


# What a launch needs of a spec, found once per spec object and device:
# kernel_rule and the shared-memory check read the spec, and hashing a wide
# weight table for a cache (lenia's 289 weights) takes longer than a
# radius-1 kernel runs.
_PLANS: dict = {}


def _launch_plan(spec: spec_lib.StencilSpec, device: torch.device) -> tuple:
    """``(spec, kernel_rule(spec), its offset table on device)``; raises
    ValueError for a spec the kernel cannot take."""
    key = (id(spec), device)
    plan = _PLANS.get(key)
    if plan is None or plan[0] is not spec:
        rule = kernel_rule(spec)
        if not fits_shared_memory(spec):
            raise ValueError(
                f"stencil_step_padded: radius {spec.radius} needs "
                f"{smem_bytes(spec)} bytes of shared memory per block, past "
                f"{SMEM_BYTES}")
        if len(_PLANS) >= 256:
            _PLANS.clear()
        plan = _PLANS[key] = (spec, rule, _offset_table(spec, device))
    return plan


def _launch(spec: spec_lib.StencilSpec, padded: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel over ``padded`` on the card (checked by
    the caller, which counts the launch)."""
    if padded.device.type != "cuda":
        raise ValueError(f"stencil_step_padded: expected a CUDA or CPU "
                         f"tensor, got {padded.device}")
    _, rule, table = _launch_plan(spec, padded.device)
    if padded.dtype != spec.torch_dtype:
        raise ValueError(f"stencil_step_padded: {spec.name!r} takes "
                         f"{spec.dtype} cells, got {padded.dtype}")
    padded = padded.contiguous()
    r = spec.radius
    H, W = padded.shape[-2:]
    out = torch.empty((*padded.shape[:-2], H - 2 * r, W - 2 * r),
                      dtype=padded.dtype, device=padded.device)
    groups = padded.numel() // (H * W * spec.channels)
    if groups == 0:
        return out
    lib = _build.load("stencil_padded")
    with torch.cuda.device(padded.device):
        rc = lib.stencil_padded(
            padded.data_ptr(), out.data_ptr(), table.data_ptr(),
            table.shape[0], groups, H, W, r, rule.rule,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "stencil_padded", rc)
    return out


stencil_step_padded.launches = 0
