"""The flash backward's block gradients against a saved logsumexp, on the
card.

Counterpart of ``mpi_and_open_mp_tpu/ops/flash_hop_bwd.py``: the ring
backward's per-hop gradients, here run over a whole single-device sequence
as one hop (``parallel/context.py:_FlashKernel``); the sharded ring slice
reuses them per hop. :func:`hop_block_grads` launches two kernels of
``csrc/flash_hop_bwd.cu`` on a CUDA tensor - :func:`flash_hop_dq`, which
accumulates ``dq`` over the k tiles, and :func:`flash_hop_dkv`, which
accumulates ``dk`` and ``dv`` over the q tiles and, under GQA, over the g
query heads of its K/V head - and on a CPU tensor runs their plain
version, :func:`hop_block_grads_plain` (``context._flash_block_grads`` over
chunked blocks). One thread block owns each output tile, so no atomics are
needed. The arithmetic is ``_flash_block_grads``'s::

    p  = exp(s - L)            (s = q kᵀ·scale, causal-masked)
    dv = pᵀ do ;  t = p∘(do vᵀ - D)
    dq = scale · t k ;  dk = scale · tᵀ q

Operands: ``q``, ``do`` ``(h, n, d)`` and ``kb``, ``vb`` ``(hkv, n, d)``,
float32 or bfloat16 alike; ``L`` (the logsumexp) and ``D = rowsum(do·o)``
``(h, n)`` float32. The JAX kernels take L and D lane-broadcast to ``(h, n,
128)``, the TPU's lane layout; the port takes the rows as they are.
``causal`` keeps ``k <= q`` in local coordinates (a ring's diagonal hop;
here the whole sequence). Outputs float32.

Kernels. bf16 operands run on the tensor cores: two warpgroups of 64 rows
issue Hopper's ``wgmma`` (bf16 in, float32 accumulators), the block's own
128 rows stay in shared memory (q, do for dq; k, v for dk/dv) and the
streamed 64-row tiles (k, v; q, do with their L, D rows) arrive by
``cp.async`` into a two-stage ring in the 128-byte swizzle. ``s`` and ``do
vᵀ`` take both operands from shared memory; ``p`` and ``t`` stay in
registers as the A operand of the second products. A bf16 product would
round them, which the JAX kernels and SDPA do and which misses the float32
fold by several times the 5e-4 the gradients are held to; so each is split,
``hi = bf16(x)``, ``lo = bf16(x - hi)``, and the second product runs on both
into the float32 accumulator (exact to about 2^-16 of ``p`` and ``t``).
On a causal diagonal tile dq sums ``do vᵀ`` again on the FP32 units, in
order of ``d``: there lie the first rows, whose gradient cancels (row 0's
exactly) and so is the rounding of that sum alone. float32 operands keep the first design: float32 tiles of 64 rows padded by
one word, every product on the FMA units. :func:`smem_bytes` gives each
block's shared memory; the JAX package's ``MAX_BLOCK = 512`` is a VMEM
budget and has no counterpart.
"""

from __future__ import annotations

import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.ops.native_flash import (
    DTYPE_CODES, check_aligned, check_kernel_operands, check_operands)

BLOCK = 64       # the float32 kernels' tile rows (csrc/flash_common.cuh)
OWN_ROWS = 128   # rows a bf16 block owns: two warpgroups of 64
STREAM_ROWS = 64  # rows of a bf16 block's streamed tiles
STAGES = 2       # the streamed tiles' ring


def smem_bytes(d: int, dtype: torch.dtype = torch.bfloat16) -> dict[str, int]:
    """Shared memory of one block of each kernel at head width ``d``
    (``csrc/flash_hop_bwd.cu``: ``dq_smem``, ``dkv_smem`` for bf16)."""
    if dtype == torch.float32:
        tile = BLOCK * (d + 1)
        scores = BLOCK * (BLOCK + 1)
        return {"dq": 4 * (4 * tile + scores),
                "dkv": 4 * (4 * tile + 2 * scores + 2 * BLOCK)}
    own = 2 * OWN_ROWS * d * 2          # q, do (dq) or k, v (dk/dv)
    stream = 2 * STREAM_ROWS * d * 2    # k, v (dq) or q, do (dk/dv)
    return {"dq": 1024 + own + STAGES * stream,
            "dkv": 1024 + own + STAGES * (stream + 2 * STREAM_ROWS * 4)}


def _check(what, q, do, L, D, kb, vb) -> None:
    check_operands(what, q, kb, vb)
    if do.shape != q.shape or L.shape != q.shape[:2] or D.shape != L.shape:
        raise ValueError(f"{what}: expected do {tuple(q.shape)} and L, D "
                         f"{tuple(q.shape[:2])}, got {tuple(do.shape)}, "
                         f"{tuple(L.shape)}, {tuple(D.shape)}")


def _launch(name: str, q, do, L, D, kb, vb, outs, causal: bool) -> None:
    """One launch of kernel ``name`` on contiguous operands."""
    check_kernel_operands(name, q, do, kb, vb)
    if L.dtype != torch.float32 or D.dtype != torch.float32:
        raise ValueError(f"{name}: L and D must be float32")
    check_aligned(name, q, do, kb, vb)
    h, n, d = q.shape
    lib = _build.load("flash_hop_bwd")
    args = [x.data_ptr() for x in (q, kb, vb, do, L, D)]
    with torch.cuda.device(q.device):
        rc = getattr(lib, name)(
            *args, *(o.data_ptr() for o in outs), h, kb.shape[0], n, d,
            int(causal), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "flash_hop_bwd", rc)


def flash_hop_dq(q, do, L, D, kb, vb, *, causal: bool) -> torch.Tensor:
    """``dq`` float32 ``(h, n, d)``: the ``flash_hop_dq`` kernel on the
    card, the plain version on the CPU."""
    _check("flash_hop_dq", q, do, L, D, kb, vb)
    if q.device.type == "cpu":
        return hop_block_grads_plain(q, do, L, D, kb, vb, causal=causal)[0]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if q.shape[1]:
        q, do, L, D, kb, vb = (x.contiguous() for x in (q, do, L, D, kb, vb))
        _launch("flash_hop_dq", q, do, L, D, kb, vb, (dq,), causal)
        flash_hop_dq.launches += 1
    return dq


flash_hop_dq.launches = 0


def flash_hop_dkv(q, do, L, D, kb, vb, *,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` float32 ``(hkv, n, d)``, summed over each K/V head's
    query group: the ``flash_hop_dkv`` kernel on the card, the plain
    version on the CPU."""
    _check("flash_hop_dkv", q, do, L, D, kb, vb)
    if q.device.type == "cpu":
        return hop_block_grads_plain(q, do, L, D, kb, vb, causal=causal)[1:]
    dk = torch.empty(kb.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    if q.shape[1]:
        q, do, L, D, kb, vb = (x.contiguous() for x in (q, do, L, D, kb, vb))
        _launch("flash_hop_dkv", q, do, L, D, kb, vb, (dk, dv), causal)
        flash_hop_dkv.launches += 1
    return dk, dv


flash_hop_dkv.launches = 0


def hop_block_grads(q, do, L, D, kb, vb, *, causal: bool):
    """One hop's block gradients ``(dq, dk, dv)``, all float32: two kernel
    launches on the card (:func:`flash_hop_dq`, :func:`flash_hop_dkv`),
    the plain version on the CPU. The JAX function's ``blk`` has no
    counterpart: the tiles are the kernels' own (:data:`OWN_ROWS`,
    :data:`STREAM_ROWS`; :data:`BLOCK` for float32)."""
    _check("hop_block_grads", q, do, L, D, kb, vb)
    if q.device.type == "cpu":
        return hop_block_grads_plain(q, do, L, D, kb, vb, causal=causal)
    return (flash_hop_dq(q, do, L, D, kb, vb, causal=causal),
            *flash_hop_dkv(q, do, L, D, kb, vb, causal=causal))


def hop_block_grads_plain(q, do, L, D, kb, vb, *, causal: bool):
    """The kernels' plain version: ``context._chunked_grads``, blocks of
    ``context._flash_block_grads`` over the plain engine's chunks."""
    from mpi_and_open_mp_tpu_torch.parallel import context

    return context._chunked_grads(causal, q, do, L, D, kb, vb)
