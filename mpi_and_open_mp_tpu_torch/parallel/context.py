"""Long-context attention on one card: flash attention, forward and full
backward, and the single-device forms of ring and Ulysses attention.

Counterpart of ``mpi_and_open_mp_tpu/parallel/context.py`` (its
single-device part). Shapes ``(heads, seq, head_dim)``; K/V may carry
fewer heads than q (GQA/MQA) as long as they divide q's, and 4-D
``(B, heads, seq, head_dim)`` operands fold the request batch into the
head axis (:func:`_fold_batch`).

Engines. ``flash_attention`` keeps the JAX package's order: a sequence of
at most :data:`_Q_CHUNK` tokens takes the dense oracle
(:func:`attention_reference`); a longer one on the card takes
:class:`_FlashKernel`, whose forward is the hand-written flash kernel
(``ops/native_flash.py``, ``csrc/flash_fwd.cu``) and whose backward is the
per-hop dq and dk/dv kernels (``ops/flash_hop_bwd.py``,
``csrc/flash_hop_bwd.cu``) run over the whole sequence as one hop; on the
CPU it takes :class:`_FlashChunked`, the plain chunked engine
(:func:`_flash_forward`, :func:`_flash_chunked_bwd`), which is also what
``engine="plain"`` asks for on the card. Both save only ``(q, k, v, o,
L)`` for the backward, ``L`` the per-row logsumexp of the scaled scores.
On a TPU the JAX package runs the bundled Pallas kernel's own backward
here; the port runs the repo's hop kernels, which give the same gradients.

The multi-device ring, zigzag and Ulysses schedules belong to the sharded
slice of the port (ROADMAP Queue 1 item 3): ``ring_attention`` and
``ulysses_attention`` take one device, where the JAX package itself runs
:func:`_attention_chunked`, and raise for more.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from mpi_and_open_mp_tpu_torch.ops import flash_hop_bwd, native_flash
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

# Finite "minus infinity" for masked scores: exp() of a masked-vs-unmasked
# gap underflows to 0, and NEG - NEG = 0 stays exact (no -inf - -inf = nan
# in the online softmax).
_NEG = -1e30

# Chunk of the plain engine: q and k/v are scanned in _Q_CHUNK slices, so
# only a (heads, _Q_CHUNK, _Q_CHUNK) score block is ever live; sequences of
# at most _Q_CHUNK tokens take the dense oracle. Read at call time, so
# tests may monkeypatch it.
_Q_CHUNK = 512

ENGINES = ("auto", "plain")

_SHARDED = ("the multi-device ring, zigzag and Ulysses schedules belong to "
            "the sharded slice of the port (ROADMAP Queue 1 item 3); this "
            "slice runs one device")


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Plain single-device softmax attention, the parity oracle.

    Shapes ``(heads, seq, head_dim)``; float32 softmax whatever the input
    dtype, result cast back to ``q.dtype``.
    """
    h, n, d = q.shape
    s = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if causal:
        pos = torch.arange(n, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s,
                        torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, v.float()).to(q.dtype)


@functools.lru_cache(maxsize=64)
def zigzag_order(n: int, p: int) -> np.ndarray:
    """Natural token position held at each zigzag slot of a ``p``-ring:
    ``x_zig = x[..., zigzag_order(n, p), :]``. Host numpy, cached."""
    if n % (2 * p):
        raise ValueError(f"zigzag needs seq % (2*mesh) == 0, got {n}/{p}")
    nl = n // p
    half = nl // 2
    slot = np.arange(n)
    shard, r = slot // nl, slot % nl
    lo = r < half
    chunk = np.where(lo, shard, 2 * p - 1 - shard)
    out = chunk * half + np.where(lo, r, r - half)
    out.setflags(write=False)  # cached: a caller mutation must not poison it
    return out


@functools.lru_cache(maxsize=64)
def _zigzag_inverse(n: int, p: int) -> np.ndarray:
    out = np.argsort(zigzag_order(n, p))
    out.setflags(write=False)
    return out


def _take_seq(x: torch.Tensor, order: np.ndarray) -> torch.Tensor:
    return torch.index_select(
        x, 1, torch.from_numpy(order.copy()).to(x.device))


def zigzag_shard(x: torch.Tensor, p: int) -> torch.Tensor:
    """Permute ``(heads, seq, d)`` from natural to zigzag ring order."""
    return _take_seq(x, zigzag_order(x.shape[1], p))


def zigzag_unshard(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard` (zigzag order back to natural)."""
    return _take_seq(x, _zigzag_inverse(x.shape[1], p))


def _mask_from_pos(qpos, kpos, n: int | None, causal: bool):
    """Boolean ``(nq, nk)`` allow-mask from position vectors: ``kpos < n``
    validity (padding) when ``n`` is given, causality when ``causal``;
    None when everything is allowed."""
    valid = None
    if n is not None:
        valid = kpos[None, :] < n
    if causal:
        c = qpos[:, None] >= kpos[None, :]
        valid = c if valid is None else valid & c
    return valid


def _block_update(q32, k, v, qpos, kpos, n, causal, o, m, l):
    """One online-softmax accumulation of a K/V block into ``(o, m, l)``:
    ``o`` (hq, nq, d) unnormalised output, ``m`` (hq, nq) running max,
    ``l`` (hq, nq) running denominator, all float32. The allow-mask is
    built from the position vectors (``n`` = valid k length, or None)."""
    d = q32.shape[-1]
    mask = _mask_from_pos(qpos, kpos, n, causal)
    s = torch.einsum("hqd,hkd->hqk", q32, k.float()) * (1.0 / math.sqrt(d))
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = p * mask  # exp(NEG - NEG) = 1 on fully-masked rows; zero it
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    o = o * corr[..., None] + torch.einsum("hqk,hkd->hqd", p, v.float())
    return o, m_new, l


def _flash_block_grads(qc, doc, Lc, Dc, kb, vb, mask, scale: float):
    """One block of the flash backward, the arithmetic the chunked backward
    and the hop kernels share::

        p  = exp(s - L)            (recomputed; ``mask`` = allow or None)
        dv = pᵀ do ;  t = p∘(do vᵀ - D)
        dq = scale · t k ;  dk = scale · tᵀ q

    All operands float32. Folded GQA q rows carry all g groups, so dk and
    dv come out summed over the group. Returns ``(dq, dk, dv)``.
    """
    s = torch.einsum("hqd,hkd->hqk", qc, kb) * scale
    p = torch.exp(s - Lc[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.einsum("hqd,hkd->hqk", doc, vb)
    t = p * (dp - Dc[..., None])
    return (scale * torch.einsum("hqk,hkd->hqd", t, kb),
            scale * torch.einsum("hqk,hqd->hkd", t, qc),
            torch.einsum("hqk,hqd->hkd", p, doc))


def _chunk(x: torch.Tensor, nc: int, c: int) -> torch.Tensor:
    """(h, nc*c, d...) -> (nc, h, c, d...) chunk-leading view."""
    h = x.shape[0]
    return x.reshape(h, nc, c, *x.shape[2:]).transpose(0, 1)


def _unchunk(x: torch.Tensor) -> torch.Tensor:
    h, c = x.shape[1], x.shape[2]
    return x.transpose(0, 1).reshape(h, x.shape[0] * c, *x.shape[3:])


def _fold_groups(x: torch.Tensor, hkv: int, g: int) -> torch.Tensor:
    """(hkv*g, n, d...) -> (hkv, n*g, d...): GQA query heads folded into
    the row axis, g group-rows per position, so every block runs against
    the un-expanded (hkv, ...) K/V and dk/dv come out group-summed. Row
    ``r`` of the folded array holds position ``r // g``."""
    if g == 1:
        return x
    n = x.shape[1]
    return x.reshape(hkv, g, n, *x.shape[2:]).transpose(1, 2).reshape(
        hkv, n * g, *x.shape[2:])


def _unfold_groups(x: torch.Tensor, hkv: int, g: int) -> torch.Tensor:
    if g == 1:
        return x
    ng = x.shape[1]
    return x.reshape(hkv, ng // g, g, *x.shape[2:]).transpose(1, 2).reshape(
        hkv * g, ng // g, *x.shape[2:])


def _pad_seq(x: torch.Tensor, pad: int, fill: float = 0.0) -> torch.Tensor:
    """Pad axis 1 of a (h, n) or (h, n, d) tensor by ``pad`` rows."""
    widths = (0, pad) if x.dim() == 2 else (0, 0, 0, pad)
    return F.pad(x, widths, value=fill)


def _flash_forward(causal: bool, q, k, v):
    """The plain chunked forward, returning ``(o, L)``: the attention
    output and the per-row logsumexp ``L = m + log l`` of the scaled
    scores. Padded or fully-masked rows get ``L = -_NEG`` so recomputed
    probabilities underflow to 0. ``L`` is in the FOLDED GQA layout,
    ``(hkv, nc*_Q_CHUNK*g)``, padding included; the backward reads it
    directly."""
    h, n, d = q.shape
    hkv = k.shape[0]
    g = h // hkv
    c = _Q_CHUNK
    cg = c * g
    nc = -(-n // c)
    pad = nc * c - n
    dev = q.device
    qs = _chunk(_fold_groups(_pad_seq(q.float(), pad), hkv, g), nc, cg)
    ks = _chunk(_pad_seq(k, pad), nc, c)
    vs = _chunk(_pad_seq(v, pad), nc, c)
    rep = torch.arange(cg, device=dev) // g  # folded row -> chunk position
    ar = torch.arange(c, device=dev)
    n_valid = n if pad else None  # the padded k tail needs masking
    outs, lses = [], []
    for ci in range(nc):
        qpos = ci * c + rep
        o = torch.zeros((hkv, cg, d), dtype=torch.float32, device=dev)
        m = torch.full((hkv, cg), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((hkv, cg), dtype=torch.float32, device=dev)
        # Causal: k chunks wholly in this q chunk's future are skipped.
        for kj in range(ci + 1 if causal else nc):
            o, m, l = _block_update(qs[ci], ks[kj], vs[kj], qpos,
                                    kj * c + ar, n_valid, causal, o, m, l)
        live = l > 0
        lses.append(torch.where(
            live, m + torch.log(torch.clamp_min(l, 1e-37)),
            torch.full_like(l, -_NEG)))
        outs.append(o / torch.where(live, l, torch.ones_like(l))[..., None])
    o = _unfold_groups(_unchunk(torch.stack(outs)), hkv, g)[:, :n]
    return o.to(q.dtype), _unchunk(torch.stack(lses))


def _chunked_grads(causal: bool, q, do, L, D, k, v):
    """The flash backward's gradients from the row statistics ``L`` (the
    logsumexp) and ``D = rowsum(do·o)``, both ``(h, n)`` float32, as
    float32 ``(dq, dk, dv)``: one pass over the allowed (q chunk, k chunk)
    blocks of :func:`_flash_block_grads` in the folded GQA layout, padded
    to whole chunks (padded rows at ``L = -_NEG``, so their recomputed p
    underflows to 0); causal blocks wholly in a q chunk's future are
    skipped. Each block's p and dp feed dq, dk and dv together."""
    h, n, d = q.shape
    hkv = k.shape[0]
    g = h // hkv
    c = _Q_CHUNK
    cg = c * g
    nc = -(-n // c)
    pad = nc * c - n

    def chunks(x, rows, fill=0.0):
        return _chunk(_fold_groups(_pad_seq(x.float(), pad, fill), hkv,
                                   rows // c), nc, rows)

    qs, dos, Ls, Ds = (chunks(q, cg), chunks(do, cg), chunks(L, cg, -_NEG),
                       chunks(D, cg))
    ks, vs = chunks(k, c), chunks(v, c)
    scale = 1.0 / math.sqrt(d)
    ar = torch.arange(c, device=q.device)
    rep = torch.arange(cg, device=q.device) // g
    dks = torch.zeros((nc, hkv, c, d), dtype=torch.float32, device=q.device)
    dvs = torch.zeros_like(dks)
    dqs = []
    for ci in range(nc):
        dqc = torch.zeros((hkv, cg, d), dtype=torch.float32, device=q.device)
        for kj in range(ci + 1 if causal else nc):
            mask = _mask_from_pos(ci * c + rep, kj * c + ar, n, causal)
            dqj, dkj, dvj = _flash_block_grads(qs[ci], dos[ci], Ls[ci],
                                               Ds[ci], ks[kj], vs[kj], mask,
                                               scale)
            dqc += dqj
            dks[kj] += dkj
            dvs[kj] += dvj
        dqs.append(dqc)
    dq = _unfold_groups(_unchunk(torch.stack(dqs)), hkv, g)
    return dq[:, :n], _unchunk(dks)[:, :n], _unchunk(dvs)[:, :n]


def _flash_chunked_bwd(causal: bool, res, do):
    """The plain flash backward: :func:`_chunked_grads` from the saved
    logsumexp, with ``D = rowsum(do * o)`` from the saved ``o`` in its
    dtype cast to float32. Gradients come back in the operands' dtypes."""
    q, k, v, o, L = res
    h, n, _ = q.shape
    hkv = k.shape[0]
    g = h // hkv
    D = (do.float() * o.float()).sum(dim=-1)
    dq, dk, dv = _chunked_grads(
        causal, q, do, _unfold_groups(L[:, : n * g], hkv, g), D, k, v)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashChunked(torch.autograd.Function):
    """The plain chunked engine: :func:`_flash_forward` and
    :func:`_flash_chunked_bwd`, saving only ``(q, k, v, o, L)``."""

    @staticmethod
    def forward(ctx, causal, q, k, v):
        o, L = _flash_forward(causal, q, k, v)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, L)
        return o

    @staticmethod
    def backward(ctx, do):
        return (None, *_flash_chunked_bwd(ctx.causal, ctx.saved_tensors,
                                          do))


class _FlashKernel(torch.autograd.Function):
    """The kernel engine: the ``flash_fwd`` kernel forward, saving only
    ``(q, k, v, o, L)`` with ``L`` as ``(h, n)``, and the per-hop
    ``flash_hop_dq`` and ``flash_hop_dkv`` kernels over the whole sequence
    as the backward (one hop of a ring of one)."""

    @staticmethod
    def forward(ctx, causal, q, k, v):
        o, L = native_flash.flash_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, L)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, L = ctx.saved_tensors
        D = (do.float() * o.float()).sum(dim=-1)
        dq, dk, dv = flash_hop_bwd.hop_block_grads(
            q, do.to(q.dtype), L, D, k, v, causal=ctx.causal)
        return None, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _merge_partials(o1, L1, o2, L2):
    """Online-softmax combine of two NORMALISED attention partials over
    disjoint key sets: ``L = logaddexp(L1, L2)``, ``o = o1·exp(L1-L) +
    o2·exp(L2-L)``. Exact and associative. ``o`` rows ``(h, n, d)``, ``L``
    ``(h, n)``, all float32. The sharded ring's hop schedule merges its
    hops with it."""
    L = torch.logaddexp(L1, L2)
    return (o1 * torch.exp(L1 - L)[..., None]
            + o2 * torch.exp(L2 - L)[..., None]), L


def _check_gqa(q, k, v, what: str) -> int:
    """Validate GQA/MQA head counts; returns the group count hq // hkv."""
    hq, hkv = q.shape[0], k.shape[0]
    if v.shape[0] != hkv:
        raise ValueError(
            f"{what}: v has {v.shape[0]} kv heads but k has {hkv}")
    if hq % hkv:
        raise ValueError(
            f"{what}: {hq} query heads not a multiple of {hkv} kv heads")
    return hq // hkv


def _repeat_heads(k, v, groups: int):
    """Broadcast K/V heads across query-head groups (head ``i`` of K/V
    serves query heads ``i*groups ... i*groups + groups - 1``). Only the
    dense oracle path uses it; the engines fold query groups instead."""
    if groups == 1:
        return k, v
    return (torch.repeat_interleave(k, groups, dim=0),
            torch.repeat_interleave(v, groups, dim=0))


def _fold_batch(x: torch.Tensor) -> torch.Tensor:
    """Fold a (B, h, n, d) request batch into the head axis: (B*h, n, d).
    Under GQA, folded q head ``b*H + h`` integer-divides by g to kv head
    ``b*Hkv + h//g``, exactly request ``b``'s own kv heads."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown attention engine {engine!r}; "
                         f"choose from {ENGINES}")


def _use_kernel(q, engine: str = "auto") -> bool:
    """Whether these operands take the kernel engine: a CUDA tensor and
    ``engine="auto"``; else the plain chunked engine runs."""
    _check_engine(engine)
    return engine == "auto" and q.device.type == "cuda"


def flash_engine_for(q, k, v, engine: str = "auto") -> str:
    """The engine ``flash_attention`` runs THESE operands on: ``"dense"``
    for at most :data:`_Q_CHUNK` tokens, ``"plain"`` for the chunked
    engine, else ``cuda:flash_fwd:b<tile>`` with the kernels' own tile
    (set by shared memory, ``ops/native_flash.py``), plus ``:g<groups>``
    for GQA (K/V read un-expanded). 4-D operands fold the batch like
    ``flash_attention`` and gain ``:b{B}``."""
    if q.dim() == 4:
        return flash_engine_for(_fold_batch(q), _fold_batch(k),
                                _fold_batch(v), engine) + f":b{q.shape[0]}"
    _check_engine(engine)
    if q.shape[1] <= _Q_CHUNK:  # mirrors _attention_chunked's order
        return "dense"
    if not _use_kernel(q, engine):
        return "plain"
    groups = q.shape[0] // k.shape[0]
    stamp = f"cuda:flash_fwd:b{native_flash.BLOCK}"
    return stamp + f":g{groups}" if groups > 1 else stamp


def _attention_chunked(q, k, v, causal: bool, engine: str = "auto"):
    """Full local attention: the dense oracle for at most :data:`_Q_CHUNK`
    tokens, else the kernel engine on a CUDA tensor and the plain chunked
    engine on a CPU tensor or with ``engine="plain"``. Both are exact
    softmax with an O(seq·d) backward (``(q, k, v, o, L)`` saved, each
    score block recomputed), and both take GQA K/V un-expanded."""
    _check_engine(engine)
    h, n, d = q.shape
    if n <= _Q_CHUNK:
        return attention_reference(
            q, *_repeat_heads(k, v, h // k.shape[0]), causal=causal)
    if _use_kernel(q, engine):
        return _FlashKernel.apply(causal, q, k, v)
    return _FlashChunked.apply(causal, q, k, v)


def _on_device(device, *xs):
    dev = resolve_device(device)
    return tuple(torch.as_tensor(x, device=dev) for x in xs)


def flash_attention(q, k, v, causal: bool = False, *,
                    device: str | torch.device = "cuda",
                    engine: str = "auto") -> torch.Tensor:
    """Single-device flash attention, exact softmax in O(chunk·seq) memory
    with an O(seq·d) backward. Shapes ``(heads, seq, head_dim)``, K/V with
    as many heads as q or a divisor of that; 4-D ``(B, heads, seq,
    head_dim)`` operands fold the request batch into the head axis
    (:func:`_fold_batch`) and unfold on the way out. Operands are moved to
    ``device`` (the card unless the caller asks for the CPU; raises when
    there is no card). ``engine="plain"`` asks for the plain chunked
    engine on the card too."""
    q, k, v = _on_device(device, q, k, v)
    if q.dim() == 4:
        if not (k.dim() == v.dim() == 4 and k.shape[0] == q.shape[0]):
            raise ValueError(
                f"flash_attention: batched q {tuple(q.shape)} needs k/v with "
                f"the same leading batch, got {tuple(k.shape)} / "
                f"{tuple(v.shape)}")
        out = flash_attention(_fold_batch(q), _fold_batch(k), _fold_batch(v),
                              causal=causal, device=q.device, engine=engine)
        return out.reshape(q.shape)
    _check_gqa(q, k, v, "flash_attention")
    return _attention_chunked(q, k, v, causal, engine)


def _one_device(devices: int | None, what: str) -> None:
    if devices not in (None, 1):
        raise ValueError(f"{what}: {devices} devices asked for; {_SHARDED}")


def ring_attention(q, k, v, devices: int | None = None, causal: bool = False,
                   layout: str = "contiguous", *,
                   device: str | torch.device = "cuda",
                   engine: str = "auto") -> torch.Tensor:
    """Sequence-parallel attention over a ring of ``devices`` cards. This
    slice runs a ring of one, which is full local attention under either
    layout (the 1-device zigzag order is the identity), as in the JAX
    package: :func:`flash_attention`, 4-D operands included. More devices
    raise."""
    _one_device(devices, "ring_attention")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout == "zigzag" and q.shape[-2] % 2:
        raise ValueError(
            f"ring_attention zigzag layout needs seq % (2*mesh) == 0, got "
            f"seq {q.shape[-2]} over 1 device")
    return flash_attention(q, k, v, causal, device=device, engine=engine)


def ulysses_attention(q, k, v, devices: int | None = None,
                      causal: bool = False, *,
                      device: str | torch.device = "cuda",
                      engine: str = "auto") -> torch.Tensor:
    """All-to-all (Ulysses) sequence-parallel attention. On one device the
    two all-to-alls are the identity and it is full local attention
    (:func:`flash_attention`), as in the JAX package; more devices
    raise."""
    _one_device(devices, "ulysses_attention")
    return flash_attention(q, k, v, causal, device=device, engine=engine)


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 products in full float32 on the card (TF32 off), restored
    on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gated_parity_check(heads: int = 8, n: int = 2048, dim: int = 128,
                       seed: int = 0, for_seq: int | None = None,
                       kv_heads: int | None = None, *,
                       device: str | torch.device = "cuda",
                       ) -> tuple[bool, str, list[str]]:
    """The gate an attention recorder runs before recording: the engine
    :func:`flash_attention` dispatches to, held against the dense oracle,
    forward (2e-4) AND full (q, k, v) gradients of ``sum(o**2)`` (5e-4),
    causal, float32 with TF32 off.

    ``for_seq`` aims the gate at a timed length: one of at most
    :data:`_Q_CHUNK` tokens takes the dense path, so the gate runs at
    ``for_seq`` itself; a length that leaves a ragged last kernel tile
    makes the gate's last tile ragged by as much. ``kv_heads`` gates a
    GQA/MQA configuration.

    Returns ``(ok, engine, notes)``: ``engine`` is the engine checked; a
    failure, numeric or raised, returns ``ok=False`` with a note. Nothing
    switches engines: a kernel that fails stays failed.
    """
    dev = resolve_device(device)
    hkv = kv_heads or heads
    if for_seq is not None:
        if for_seq <= _Q_CHUNK:
            n = for_seq
        else:
            n += for_seq % native_flash.BLOCK
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((heads, n, dim))).float().to(dev)
    k, v = (torch.from_numpy(rng.standard_normal((hkv, n, dim))).float().to(
        dev) for _ in range(2))
    engine = flash_engine_for(q, k, v)

    def close(a, b, tol):
        return bool(torch.allclose(a, b, rtol=tol, atol=tol))

    def oracle(a, b, c):
        # Expanding inside the differentiated function keeps the oracle's
        # dk/dv group-summed to the (hkv, ...) shapes the engine gives.
        return attention_reference(a, *_repeat_heads(b, c, heads // hkv),
                                   causal=True)

    def grads(fn):
        args = [x.clone().requires_grad_(True) for x in (q, k, v)]
        loss = (fn(*args) ** 2).sum()
        return torch.autograd.grad(loss, args)

    def flash(a, b, c):
        return flash_attention(a, b, c, causal=True, device=dev)

    notes: list[str] = []
    try:
        with _full_f32_matmul():
            ok = close(flash(q, k, v), oracle(q, k, v), 2e-4) and all(
                close(a, b, 5e-4)
                for a, b in zip(grads(flash), grads(oracle)))
    except Exception as e:  # a kernel that fails to launch fails the gate
        notes.append(f"{engine} engine: {type(e).__name__}: {e}"[:160])
        return False, engine, notes
    if not ok:
        notes.append(f"{engine} engine failed parity")
    return ok, engine, notes
