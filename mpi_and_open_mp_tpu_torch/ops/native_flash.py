"""Flash attention forward on the card: ``o = softmax(q kᵀ·scale) v`` and the
per-row logsumexp ``L = m + log l`` of the scaled scores.

Counterpart of the flash forward the JAX package runs on a TPU
(``mpi_and_open_mp_tpu/parallel/context.py:_pallas_flash`` and
``_hop_flash_block``, which call JAX's bundled Pallas kernel).
:func:`flash_fwd` launches the hand-written kernel ``csrc/flash_fwd.cu`` on
a CUDA tensor and runs its plain version, :func:`flash_fwd_plain` (the plain
chunked engine's forward), on a CPU tensor.

Operands ``q`` ``(h, n, d)`` and ``k``, ``v`` ``(hkv, n, d)``, float32 or
bfloat16 alike, ``hkv`` dividing ``h``: query head ``i`` reads K/V head
``i // (h // hkv)``, so GQA K/V are never expanded. ``scale = 1/sqrt(d)``
multiplies the product, as in ``attention_reference``. Results: ``o`` in
q's dtype and ``L`` ``(h, n)`` float32 (the JAX engines keep ``L`` folded
``(hkv, n*g)``; :func:`flash_fwd_plain` unfolds it).

Kernels, chosen by dtype alone. bfloat16 operands run ``flash_fwd_tc`` on
the tensor cores: a block owns 128 q rows of one head (two warpgroups of
64, Hopper's ``wgmma``, bf16 in and float32 accumulators), keeps its q tile
in shared memory and streams k, v tiles of 64 keys through a four-stage
``cp.async`` ring in the 128-byte swizzle; ``s = q kᵀ`` takes both operands
from shared memory, the online softmax runs in registers in log2 units, and
``p`` stays there as the A operand of ``o += p v``, which runs while the
next tile's softmax does. One bf16 rounding of ``p`` there (what the JAX
kernel and SDPA do) misses the bf16 rule ``o`` is held to on the card more
than twice over, so ``p`` is split into a bf16 hi + lo pair and that
product runs on both. float32 operands keep the first kernel: a ``BLOCK``
= 64-row q tile, q, k, v and the 64 x 64 probability tile as float32 rows
padded by one word, every product on the FMA units. :func:`smem_bytes`
gives a block's shared memory (164 864 bytes bf16 and 115 712 float32 at
d = 128, inside the 227 KB a block may take). ``d`` is 64 or 128. The
bf16 kernel loads rows in 16-byte pieces, so its operands must start on 16
bytes (:func:`check_aligned`).
"""

from __future__ import annotations

import torch

from mpi_and_open_mp_tpu_torch.ops import _build

# The float32 kernels' tile edge and the head widths (csrc/flash_common.cuh:
# kBlock and the instantiations in csrc/flash_fwd.cu, csrc/flash_hop_bwd.cu).
BLOCK = 64
HEAD_DIMS = (64, 128)
# dtype codes of the C entry points.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The bf16 forward's block (csrc/flash_fwd.cu: kTcOwn, kKStep, kTcStages,
# which follow these): q rows it owns (two warpgroups of BLOCK), keys of a
# streamed k, v tile, and the ring's stages. chip_smoke.py holds
# smem_bytes to the dynamic shared memory the CUDA runtime reports for each
# built kernel.
OWN_ROWS = 2 * BLOCK
KEY_STEP = BLOCK
STAGES = 4


def smem_bytes(d: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of one forward block at head width ``d``: for bf16
    (``csrc/flash_fwd.cu:tc_smem``) 1024 bytes of alignment, the owned q
    tile and per stage a k and a v tile, all bf16; for float32 q, k, v
    tiles of BLOCK x (d + 1) float32 and the BLOCK x (BLOCK + 1)
    probability tile."""
    if dtype == torch.float32:
        return 4 * (3 * BLOCK * (d + 1) + BLOCK * (BLOCK + 1))
    return 1024 + 2 * (OWN_ROWS * d + STAGES * 2 * KEY_STEP * d)


def check_operands(what: str, q, k, v) -> None:
    """Shapes every attention wrapper takes: q ``(h, n, d)``, k and v
    ``(hkv, n, d)`` with ``hkv`` dividing ``h``, one device."""
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"{what}: expected q (h, n, d) and k, v (hkv, n, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    h, n, d = q.shape
    if k.shape[1:] != (n, d) or h % k.shape[0]:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same n and d, kv heads dividing "
                         "the query heads)")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: operands on {q.device}, {k.device}, "
                         f"{v.device}")


def check_aligned(what: str, *xs) -> None:
    """Operands of the kernels that load rows in 16-byte pieces
    (``cp.async``) must start on 16 bytes: a contiguous view at another
    offset would fault on the card and spoil its CUDA context."""
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError(f"{what}: the operands must start on 16 bytes (the "
                         "kernel loads rows in 16-byte pieces), got offsets "
                         f"{[x.data_ptr() % 16 for x in xs]}")


def check_kernel_operands(what: str, *xs) -> None:
    """What the attention kernels take on the card: CUDA tensors of one
    dtype, float32 or bfloat16, head width 64 or 128, fewer than 65 536
    heads (a grid axis)."""
    q = xs[0]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got "
                         f"{q.device}")
    if q.dtype not in DTYPE_CODES or any(x.dtype != q.dtype for x in xs):
        raise ValueError(f"{what}: the kernel takes float32 or bfloat16 "
                         f"operands of one dtype, got "
                         f"{[str(x.dtype) for x in xs]}")
    if q.shape[-1] not in HEAD_DIMS or q.shape[0] >= 65536:
        raise ValueError(f"{what}: the kernel is built for head_dim in "
                         f"{HEAD_DIMS} and fewer than 65536 heads, got "
                         f"{tuple(q.shape)}")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, L)`` of attention over ``q``, ``k``, ``v``: the ``flash_fwd``
    kernels on the card (``flash_fwd_tc`` for bfloat16, the FMA kernel for
    float32), :func:`flash_fwd_plain` on the CPU."""
    check_operands("flash_fwd", q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    check_kernel_operands("flash_fwd", q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16:
        check_aligned("flash_fwd", q, k, v)
    h, n, d = q.shape
    o = torch.empty_like(q)
    L = torch.empty((h, n), dtype=torch.float32, device=q.device)
    if n == 0:
        return o, L
    lib = _build.load("flash_fwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            L.data_ptr(), h, k.shape[0], n, d, int(causal),
            DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, "flash_fwd", rc)
    flash_fwd.launches += 1
    return o, L


flash_fwd.launches = 0


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: ``context._flash_forward`` with ``L``
    unfolded to ``(h, n)``."""
    from mpi_and_open_mp_tpu_torch.parallel import context

    h, n, _ = q.shape
    hkv = k.shape[0]
    g = h // hkv
    o, L = context._flash_forward(causal, q, k, v)
    return o, context._unfold_groups(L[:, : n * g], hkv, g)
