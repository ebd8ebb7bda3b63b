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
kernel tiles a board over thread blocks (32 x 32 outputs each plus the
r-wide halo in shared memory), so any extent runs; only the radius is
bounded, by a block's shared memory, which holds the tile and the offset
table (:func:`fits_shared_memory`: up to r = 55 for a full lenia table).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.ops.bitlife import SMEM_BYTES
from mpi_and_open_mp_tpu_torch.stencils import engine, spec as spec_lib

# The kernel's output tile and the bytes of one offset-table entry (its
# csrc/stencil_padded.cu:kTileH, kTileW and sizeof(Tap)).
TILE = 32
_TAP_BYTES = 12


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
    (spec_lib._lenia_update, None): KernelRule(4, "float32", 1),
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


def smem_bytes(spec: spec_lib.StencilSpec) -> int:
    """Shared memory one block of the kernel uses for ``spec``: the
    offset table plus every channel's (32 + 2r)^2 tile of 4-byte cells."""
    side = TILE + 2 * spec.radius
    return (_TAP_BYTES * len(engine.offsets(spec))
            + 4 * spec.channels * side * side)


def fits_shared_memory(spec: spec_lib.StencilSpec) -> bool:
    return smem_bytes(spec) <= SMEM_BYTES


@functools.lru_cache(maxsize=None)
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


def _launch(spec: spec_lib.StencilSpec, padded: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel over ``padded`` on the card (checked by
    the caller, which counts the launch)."""
    if padded.device.type != "cuda":
        raise ValueError(f"stencil_step_padded: expected a CUDA or CPU "
                         f"tensor, got {padded.device}")
    rule = kernel_rule(spec)
    if padded.dtype != spec.torch_dtype:
        raise ValueError(f"stencil_step_padded: {spec.name!r} takes "
                         f"{spec.dtype} cells, got {padded.dtype}")
    if not fits_shared_memory(spec):
        raise ValueError(
            f"stencil_step_padded: radius {spec.radius} needs "
            f"{smem_bytes(spec)} bytes of shared memory per block, past "
            f"{SMEM_BYTES}")
    padded = padded.contiguous()
    r = spec.radius
    H, W = padded.shape[-2:]
    out = torch.empty((*padded.shape[:-2], H - 2 * r, W - 2 * r),
                      dtype=padded.dtype, device=padded.device)
    groups = padded[..., 0, 0].numel() // spec.channels
    if groups == 0:
        return out
    table = _offset_table(spec, padded.device)
    lib = _build.load("stencil_padded")
    with torch.cuda.device(padded.device):
        rc = lib.stencil_padded(
            padded.data_ptr(), out.data_ptr(), table.data_ptr(),
            table.shape[0], groups, H, W, r, rule.rule,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "stencil_padded", rc)
    return out


stencil_step_padded.launches = 0
