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

Tiles: BLOCK = 64 rows of q and of k per step, float32 in shared memory
with rows padded by one word: the dq block holds q, do, k, v tiles and the
t tile (148 736 bytes at d = 128), the dk/dv block k, v, q, do tiles and
the p and t tiles (165 888 bytes), inside the 227 KB a block may take. The
JAX package's ``MAX_BLOCK = 512`` is a VMEM budget and has no counterpart.
"""

from __future__ import annotations

import torch

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.ops.native_flash import (
    DTYPE_CODES, check_kernel_operands, check_operands)

BLOCK = 64


def smem_bytes(d: int) -> dict[str, int]:
    """Shared memory of one block of each kernel at head width ``d``."""
    tile = BLOCK * (d + 1)
    scores = BLOCK * (BLOCK + 1)
    return {"dq": 4 * (4 * tile + scores),
            "dkv": 4 * (4 * tile + 2 * scores + 2 * BLOCK)}


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
    counterpart: the tile is the kernels' own (:data:`BLOCK`)."""
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
