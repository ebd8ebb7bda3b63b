"""Single-board dispatch over the hand-written Life kernels.

Counterpart of ``mpi_and_open_mp_tpu/ops/pallas_life.py`` (its
single-board part): :func:`native_path` picks the engine for a board
shape and :func:`life_run_vmem` runs it.

* ``"vmem"`` - the whole packed board resident in one block's shared
  memory for the entire step loop (``bitlife.life_run_vmem_bits``);
* ``"fused"`` - word-aligned boards past that gate: fused rounds of up to
  128 steps over halo tiles (``bitlife.life_run_fused_bits``);
* ``"frame"`` - any other board past the gate, in a row-padded torus frame
  through the same fused kernel (``bitlife.life_run_frame_bits``);
* ``"plain"`` - the plain packed loop, the CPU's path for boards past the
  resident gate (the counterpart of the JAX package's ``"xla"`` rung).

On the card only the three kernel paths exist: a shape none of them covers
raises. On the CPU the resident path runs its plain version, and bigger
boards take ``"plain"``, as the JAX package's CPU dispatch takes its XLA
loop.
"""

from __future__ import annotations

import torch

from mpi_and_open_mp_tpu_torch.ops import bitlife


def native_path(shape: tuple[int, int], on_card: bool = True) -> str:
    """Which path :func:`life_run_vmem` takes for ``shape``: ``"vmem"``,
    ``"fused"`` or ``"frame"`` on the card (raising for a shape no kernel
    covers), ``"vmem"`` or ``"plain"`` on the CPU."""
    shape = (int(shape[0]), int(shape[1]))
    if bitlife.fits_vmem_packed(shape):
        return "vmem"
    if not on_card:
        return "plain"
    if bitlife.fused_bits_supported(shape):
        return "fused"
    if bitlife.plan_sharded_bits(shape) is not None:
        return "frame"
    raise ValueError(
        f"no kernel covers a {shape} board: it is past the resident gate "
        "and too short for a fused halo")


def life_run_vmem(board: torch.Tensor, n: int) -> torch.Tensor:
    """Advance ``board`` (on the card or the CPU) ``n`` steps on the path
    :func:`native_path` picks."""
    path = native_path(board.shape, on_card=board.device.type == "cuda")
    if path == "vmem":
        return bitlife.life_run_vmem_bits(board, n)
    if path == "fused":
        return bitlife.life_run_fused_bits(board, n)
    if path == "frame":
        return bitlife.life_run_frame_bits(board, n)
    return bitlife.life_run_bits_plain(board, n)
