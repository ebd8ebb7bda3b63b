"""Long-context attention: flash attention on one card, forward and full
backward, and ring and Ulysses attention over virtual shards of it.

Counterpart of ``mpi_and_open_mp_tpu/parallel/context.py``. Shapes
``(heads, seq, head_dim)``; K/V may carry fewer heads than q (GQA/MQA) as
long as they divide q's, and 4-D ``(B, heads, seq, head_dim)`` operands
fold the request batch into the head axis (:func:`_fold_batch`).

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

Sequence parallelism (:func:`ring_attention`, :func:`ulysses_attention`)
runs over a mesh of virtual shards of one device on the ``"sp"`` axis
(``parallel/mesh.py``), the operands stacked ``(p, heads, seq/p,
head_dim)``. The ring's K/V rotate by ``parallel/halo.py:ppermute`` and
every live hop is one launch of the same kernels over the shards folded
into the head axis (:class:`_RingFlash`); Ulysses re-shards by
``halo.all_to_all`` around one local launch. On a mesh across processes
(``parallel.procs``) each process holds its run of the shards: the
rotations and the all-to-all cross the processes, every shard index adds
the process's first shard (:func:`_ring_positions` takes global ones,
:func:`_held` cuts a hop's live shards to the run), and both calls take
the global operands and return the calling process's rows
(:func:`local_rows`).

Observability (``obs``), as the JAX package's: with ``MOMP_TRACE`` set
and no chaos plan or guard, a contiguous ring of more than one shard runs
its forward hop by hop under spans (the JAX package's
``_ring_attention_traced``): a ``ring_attention`` span with
``traced_dispatch=True`` around ``ring.fold.resident`` (hop 0),
``ring.hop.transfer`` (each K/V rotation, with its ``bytes``) and
``ring.hop.fold`` (each later hop), each anchored on the card, and the
``ring.hops.fwd{engine=...}`` and ``ring.steps.traced`` counters. These
spans wrap the same hops and launches as the untraced ring; only the
rotations move from one hop ahead to just before their fold. Causal
zigzag, a ring of one and ``MOMP_TRACE_HOPS=0`` get one whole-call
``ring_attention`` span; the guarded dispatch one with ``guarded=True``.
Each distinct sharded call ticks ``jit.retrace{fn=sharded_attention}``
(``obs.metrics``) once, where the JAX package compiles its program.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from mpi_and_open_mp_tpu_torch.obs import metrics, trace
from mpi_and_open_mp_tpu_torch.ops import flash_hop_bwd, native_flash
from mpi_and_open_mp_tpu_torch.parallel import halo
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.robust import chaos, guards
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

AXIS_SP = mesh_lib.AXIS_SP

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


# ---------------------------------------------------------------------------
# Sequence parallelism over a ring of p virtual shards of one device.
#
# The operands of a ring live as stacks (p, heads, n/p, d) on the "sp" axis
# (parallel/mesh.py): shard i holds tokens [i n/p, (i+1) n/p) of the
# operand's order (the zigzag order under layout="zigzag"). The JAX
# package's per-device ring body runs here once over the stack: its
# ppermute of K/V is halo.ppermute, one torch.roll of the stack a rotation,
# and its per-device hop kernel is one launch over the shards that are live
# at that hop, folded into the kernel's head axis (shards x heads; GQA K/V
# fold the same way, so query head i still reads K/V head i // g). The
# rotations stay, although views would do on one card, so that the hop
# structure and the chaos poison map one to one onto the JAX package's, and
# a ring across cards can swap the roll for a send. The plain fold runs only
# under engine="plain", on the causal-zigzag backward (as in the JAX
# package) and as the CPU's last stage of the guarded recovery.


def _ring_positions(layout: str, dev: int, p: int, nl: int,
                    rows: torch.Tensor) -> torch.Tensor:
    """Global token positions of local rows ``rows`` of ring shard ``dev``:
    ``dev * nl + rows`` in the contiguous layout; in the zigzag layout the
    shard holds half-chunks ``dev`` and ``2p-1-dev`` of ``nl/2`` tokens."""
    if layout == "zigzag":
        if nl % 2:
            raise ValueError(
                f"zigzag layout needs an even local length, got {nl}")
        half = nl // 2
        lo = rows < half
        return (torch.where(lo, dev, 2 * p - 1 - dev) * half
                + torch.where(lo, rows, rows - half))
    if layout != "contiguous":
        raise ValueError(f"unknown ring layout {layout!r}")
    return dev * nl + rows


def _hop_kernels_take(q, k, p: int) -> bool:
    """Whether the per-hop engines take these operands (heads at
    ``shape[-3]``, head width last) over ``p`` shards: on a CPU tensor their
    plain versions take any; on the card the kernels' dtypes (float32 or
    bfloat16, one for all), head widths and head count (a grid axis)."""
    if q.device.type != "cuda":
        return True
    return (q.dtype in native_flash.DTYPE_CODES and k.dtype == q.dtype
            and q.shape[-1] in native_flash.HEAD_DIMS
            and p * q.shape[-3] < 65536)


def _hop_stamp(q, k, kernel: str, plain: str) -> str:
    groups = q.shape[-3] // k.shape[-3]
    stamp = (f"cuda:{kernel}:b{native_flash.BLOCK}"
             if q.device.type == "cuda" else f"cpu:{plain}")
    return stamp + f":g{groups}" if groups > 1 else stamp


def _ring_hop_plan(q, k, p: int, causal: bool, layout: str,
                   engine: str = "auto") -> str | None:
    """The per-hop FORWARD engine's stamp for a ring of ``p`` shards, or
    ``None`` for the plain fold: ``engine="plain"``, and
    :func:`_hop_kernels_take`. Causal zigzag runs the kernel on
    half-chunks."""
    if engine == "plain" or not _hop_kernels_take(q, k, p):
        return None
    return _hop_stamp(q, k, "flash_fwd", "flash_fwd_plain")


def _ring_hop_bwd_plan(q, k, p: int, causal: bool, layout: str,
                       engine: str = "auto") -> str | None:
    """The per-hop BACKWARD engine's stamp (the ``flash_hop_dq`` and
    ``flash_hop_dkv`` kernels), or ``None`` for the plain fold. Causal
    zigzag always folds, as in the JAX package: its half-chunk gradient
    decomposition is not written (ROADMAP Queue 2)."""
    if engine == "plain" or (causal and layout == "zigzag"):
        return None
    if not _hop_kernels_take(q, k, p):
        return None
    return _hop_stamp(q, k, "flash_hop_bwd", "hop_block_grads_plain")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and starting on 16 bytes (the bf16 kernels' loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _to_shards(x: torch.Tensor, p: int) -> torch.Tensor:
    """``(h, n, d)`` -> the ``(p, h, n/p, d)`` stack of the ``"sp"`` axis."""
    h, n, d = x.shape
    return _aligned(x.reshape(h, p, n // p, d).transpose(0, 1))


def _held_shards(x: torch.Tensor, p: int,
                 mesh: mesh_lib.Mesh) -> torch.Tensor:
    """The ``(p, h, n/p, d)`` stack of ``x``'s shards this process holds:
    all of them, or its run on a mesh across processes."""
    return _aligned(mesh_lib.local_part(_to_shards(x, p), mesh))


def local_rows(x: torch.Tensor, mesh: mesh_lib.Mesh) -> torch.Tensor:
    """The rows ``(h, n, d) -> (h, n * held / p, d)`` of a sequence-parallel
    call's global operand that belong to this process's shards (all of
    them on a mesh of one process): what :func:`ring_attention` and
    :func:`ulysses_attention` return there, in the operand's order."""
    p = mesh.axis_sizes[0]
    nl = x.shape[1] // p
    return x[:, mesh.first_shard * nl:(mesh.first_shard
                                       + mesh.local_sizes[0]) * nl]


def _from_shards(x: torch.Tensor) -> torch.Tensor:
    p, h, nl, d = x.shape
    return x.transpose(0, 1).reshape(h, p * nl, d)


# The traced forward's span attributes: the hop engine's stamp and the
# bytes of one shard's K/V block pair.
_HopTrace = collections.namedtuple("_HopTrace", "engine bytes")


def _ring_trip(blocks, p: int, hops: _HopTrace | None = None):
    """``(j, blocks after j ring rotations)`` for hops ``j = 0 .. p-1``.
    Each rotation (:func:`halo.ppermute` of every stack of ``blocks``) is
    started one hop ahead, as the JAX package's single-slot hop loop does:
    hop ``j+1``'s before hop ``j`` folds; ``p - 1`` rotations in all.

    With ``hops`` (the traced forward, module docstring) each rotation runs
    just before its hop in a ``ring.hop.transfer`` span, and the caller's
    work on each hop runs inside a ``ring.fold.resident`` (hop 0) or
    ``ring.hop.fold`` span; every span is anchored on the card."""
    held = blocks
    for j in range(p):
        if hops is None:
            ahead = (tuple(halo.ppermute(x, AXIS_SP, 1) for x in held)
                     if j + 1 < p else None)
            yield j, held
            held = ahead
            continue
        if j:
            with trace.span("ring.hop.transfer", hop=j,
                            bytes=hops.bytes) as sp:
                held = tuple(halo.ppermute(x, AXIS_SP, 1) for x in held)
                sp.anchor(held)
            fold = trace.span("ring.hop.fold", hop=j, engine=hops.engine)
        else:
            fold = trace.span("ring.fold.resident", engine=hops.engine)
        with fold as sp:
            yield j, held
            sp.anchor(held)


_Folder = collections.namedtuple("_Folder", "state0 fold finish")


def _make_folder(causal: bool, g: int, npos: int, qsub, qpos_of):
    """The ``_Folder`` ``(state0, fold, finish)`` of the plain fold for one
    shard's q subset of ``npos`` positions (folded GQA rows ``npos*g``,
    float32), as the JAX package's ``make_folder``: q rows in
    :data:`_Q_CHUNK` chunks past that length (padded rows computed and
    sliced off by ``finish``); ``qpos_of`` maps subset positions to global
    token positions."""
    hkv, _, d = qsub.shape
    chunked = npos > _Q_CHUNK
    nc = -(-npos // _Q_CHUNK)
    npp = nc * _Q_CHUNK if chunked else npos
    if npp != npos:
        qsub = _pad_seq(qsub, (npp - npos) * g)
    rows, dev, cg = npp * g, qsub.device, _Q_CHUNK * g
    state0 = (torch.zeros((hkv, rows, d), dtype=torch.float32, device=dev),
              torch.full((hkv, rows), _NEG, dtype=torch.float32, device=dev),
              torch.zeros((hkv, rows), dtype=torch.float32, device=dev))

    def fold(state, kb, vb, kpos):
        if not chunked:
            qpos = qpos_of(torch.arange(npos * g, device=dev) // g)
            return _block_update(qsub, kb, vb, qpos, kpos, None, causal,
                                 *state)
        parts = []
        for ci in range(nc):
            sl = slice(ci * cg, (ci + 1) * cg)
            qpos = qpos_of(ci * _Q_CHUNK + torch.arange(cg, device=dev) // g)
            parts.append(_block_update(qsub[:, sl], kb, vb, qpos, kpos, None,
                                       causal, *(x[:, sl] for x in state)))
        return tuple(torch.cat(x, dim=1) for x in zip(*parts))

    def finish(state):
        return tuple(x[:, : npos * g] for x in state)

    return _Folder(state0, fold, finish)


def _ring_fold_forward(causal: bool, layout: str, q, k, v,
                       hops: _HopTrace | None = None):
    """The plain rotate-and-fold forward (the JAX package's jnp fold, its
    per-device body run for each shard of the stacks) and the oracle of the
    hop engines: ``(o, L)``, ``o`` in q's dtype, ``L`` the per-row
    logsumexp ``(p, h, nl)`` float32. Contiguous causal shards skip blocks
    wholly in their future; causal zigzag folds only the live (q-half,
    k-half) pairs: ``(lo, lo)`` iff ``src <= idx``, ``(hi, lo)`` always,
    ``(hi, hi)`` iff ``src >= idx``."""
    n_held, h, nl, d = q.shape
    p, first = halo.axis_size(q, AXIS_SP), halo.first_shard(q, AXIS_SP)
    hkv = k.shape[1]
    g = h // hkv
    half = nl // 2
    zz = causal and layout == "zigzag"
    dev = q.device

    def folders(idx):
        q32 = _fold_groups(q[idx - first].float(), hkv, g)
        if not zz:
            return (_make_folder(causal, g, nl, q32, lambda r: (
                _ring_positions(layout, idx, p, nl, r))),)
        hg = half * g
        return (_make_folder(causal, g, half, q32[:, :hg],
                             lambda r: idx * half + r),
                _make_folder(causal, g, half, q32[:, hg:],
                             lambda r: (2 * p - 1 - idx) * half + r))

    shards = [folders(first + i) for i in range(n_held)]
    rows, rows_half = torch.arange(nl, device=dev), torch.arange(half,
                                                                 device=dev)

    def fold(j, state, kb, vb):
        new = []
        for i, (fs, st) in enumerate(zip(shards, state)):
            # After j rotations shard idx holds the block of shard src.
            idx = first + i
            src = (idx - j) % p
            kbi, vbi = kb[i], vb[i]
            if not zz:
                if causal and src > idx:  # wholly in this shard's future
                    new.append(st)
                    continue
                kpos = _ring_positions(layout, src, p, nl, rows)
                new.append((fs[0].fold(st[0], kbi, vbi, kpos),))
                continue
            fold_lo, fold_hi = fs[0].fold, fs[1].fold
            s_lo, s_hi = st
            k_lo, k_hi = kbi[:, :half], kbi[:, half:]
            v_lo, v_hi = vbi[:, :half], vbi[:, half:]
            kpos_lo = src * half + rows_half
            kpos_hi = (2 * p - 1 - src) * half + rows_half
            if src <= idx:
                s_lo = fold_lo(s_lo, k_lo, v_lo, kpos_lo)
            s_hi = fold_hi(s_hi, k_lo, v_lo, kpos_lo)
            if src >= idx:
                s_hi = fold_hi(s_hi, k_hi, v_hi, kpos_hi)
            new.append((s_lo, s_hi))
        return new

    poison = chaos.hop_poison_spec()
    if poison is not None:
        fold = chaos.poisoned_fold(fold, poison)
    state = [tuple(f.state0 for f in fs) for fs in shards]
    for j, (kb, vb) in _ring_trip((k, v), p, hops):
        state = fold(j, state, kb, vb)
    outs, lses = [], []
    for fs, st in zip(shards, state):
        o, m, l = (torch.cat(parts, dim=1) for parts in zip(
            *(f.finish(s) for f, s in zip(fs, st))))
        live = l > 0
        lses.append(_unfold_groups(torch.where(
            live, m + torch.log(torch.clamp_min(l, 1e-37)),
            torch.full_like(l, -_NEG)), hkv, g))
        outs.append(_unfold_groups(
            o / torch.where(live, l, torch.ones_like(l))[..., None], hkv, g))
    return torch.stack(outs).to(q.dtype), torch.stack(lses)


def _make_bwd(causal: bool, g: int, scale: float, npos: int, qsub, dosub,
              Lsub, Dsub, qpos_of):
    """One shard's per-hop ``(dq, dk, dv)`` contribution of a q subset of
    ``npos`` positions against a K/V block, as the JAX package's
    ``make_bwd``: :func:`_flash_block_grads` over the same q chunks as the
    forward's folder, padded rows at ``L = -_NEG`` (their p underflows to
    0). ``dq`` in the folded GQA layout, dk and dv group-summed."""
    chunked = npos > _Q_CHUNK
    nc = -(-npos // _Q_CHUNK)
    npp = nc * _Q_CHUNK if chunked else npos
    if npp != npos:
        pad = (npp - npos) * g
        qsub, dosub, Dsub = (_pad_seq(x, pad) for x in (qsub, dosub, Dsub))
        Lsub = _pad_seq(Lsub, pad, -_NEG)
    dev, cg = qsub.device, _Q_CHUNK * g

    def block(sl, qpos, kb32, vb32, kpos):
        mask = _mask_from_pos(qpos, kpos, None, causal)
        return _flash_block_grads(qsub[:, sl], dosub[:, sl], Lsub[:, sl],
                                  Dsub[:, sl], kb32, vb32, mask, scale)

    def contribution(kb32, vb32, kpos):
        if not chunked:
            return block(slice(None),
                         qpos_of(torch.arange(npos * g, device=dev) // g),
                         kb32, vb32, kpos)
        dqs, dk, dv = [], 0.0, 0.0
        for ci in range(nc):
            qpos = qpos_of(ci * _Q_CHUNK + torch.arange(cg, device=dev) // g)
            dqc, dkc, dvc = block(slice(ci * cg, (ci + 1) * cg), qpos, kb32,
                                  vb32, kpos)
            dqs.append(dqc)
            dk, dv = dk + dkc, dv + dvc
        return torch.cat(dqs, dim=1)[:, : npos * g], dk, dv

    return contribution


def _ring_fold_backward(causal: bool, layout: str, res, do):
    """The plain travelling-dk/dv backward (the JAX package's jnp
    ``_ring_flash_bwd``, per shard): K/V make a second trip round the
    ring, each block carrying its ``(dk, dv)`` accumulator, rotated after
    every hop (p rotations: home again); each shard adds its recomputed
    block gradients to its ``dq`` and to the accumulators in hand. Causal
    skipping and the zigzag live pairs as in :func:`_ring_fold_forward`."""
    q, k, v, o, L = res
    n_held, h, nl, d = q.shape
    p, first = halo.axis_size(q, AXIS_SP), halo.first_shard(q, AXIS_SP)
    hkv = k.shape[1]
    g = h // hkv
    half = nl // 2
    hg = half * g
    zz = causal and layout == "zigzag"
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    def shard_bwd(idx):
        q32, do32, o32 = (_fold_groups(x[idx - first].float(), hkv, g)
                          for x in (q, do, o))
        D = (do32 * o32).sum(dim=-1)
        Lf = _fold_groups(L[idx - first], hkv, g)
        if not zz:
            return (_make_bwd(causal, g, scale, nl, q32, do32, Lf, D,
                              lambda r: _ring_positions(layout, idx, p, nl,
                                                        r)),)
        return tuple(
            _make_bwd(causal, g, scale, half, *(x[:, sl] for x in (
                q32, do32, Lf, D)), qpos_of)
            for sl, qpos_of in (
                (slice(None, hg), lambda r: idx * half + r),
                (slice(hg, None), lambda r: (2 * p - 1 - idx) * half + r)))

    bwds = [shard_bwd(first + i) for i in range(n_held)]
    rows, rows_half = torch.arange(nl, device=dev), torch.arange(half,
                                                                 device=dev)
    dq = torch.zeros((n_held, hkv, nl * g, d), dtype=torch.float32,
                     device=dev)
    dkb = torch.zeros((n_held, hkv, nl, d), dtype=torch.float32, device=dev)
    dvb = torch.zeros_like(dkb)
    for j, (kb, vb) in _ring_trip((k, v), p):
        for i in range(n_held):
            idx = first + i
            src = (idx - j) % p
            kb32, vb32 = kb[i].float(), vb[i].float()
            if not zz:
                if causal and src > idx:
                    continue
                dqj, dkj, dvj = bwds[i][0](
                    kb32, vb32, _ring_positions(layout, src, p, nl, rows))
                dq[i] += dqj
                dkb[i] += dkj
                dvb[i] += dvj
                continue
            bwd_lo, bwd_hi = bwds[i]
            k_lo, k_hi = kb32[:, :half], kb32[:, half:]
            v_lo, v_hi = vb32[:, :half], vb32[:, half:]
            kpos_lo = src * half + rows_half
            kpos_hi = (2 * p - 1 - src) * half + rows_half
            if src <= idx:
                dqj, dkj, dvj = bwd_lo(k_lo, v_lo, kpos_lo)
                dq[i, :, :hg] += dqj
                dkb[i, :, :half] += dkj
                dvb[i, :, :half] += dvj
            dqj, dkj, dvj = bwd_hi(k_lo, v_lo, kpos_lo)
            dq[i, :, hg:] += dqj
            dkb[i, :, :half] += dkj
            dvb[i, :, :half] += dvj
            if src >= idx:
                dqj, dkj, dvj = bwd_hi(k_hi, v_hi, kpos_hi)
                dq[i, :, hg:] += dqj
                dkb[i, :, half:] += dkj
                dvb[i, :, half:] += dvj
        dkb, dvb = (halo.ppermute(x, AXIS_SP, 1) for x in (dkb, dvb))
    dq = torch.stack([_unfold_groups(x, hkv, g) for x in dq])
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


def _hop_partial(q, kb, vb, causal: bool):
    """One ``flash_fwd`` launch over stacks of shards folded into the head
    axis: the normalised partial ``(o, L)`` of each shard's q against the
    block in hand, float32, shaped like the stacks."""
    o, L = native_flash.flash_fwd(q.flatten(0, 1), kb.flatten(0, 1),
                                  vb.flatten(0, 1), causal)
    return o.float().reshape(q.shape), L.reshape(q.shape[:-1])


def _merge_into(state, lo: int, hi: int, part) -> None:
    """Merge the partial ``part`` of shards ``lo .. hi-1`` into ``state``."""
    o, L = state
    o[lo:hi], L[lo:hi] = _merge_partials(o[lo:hi], L[lo:hi], *part)


def _held(lo: int, hi: int, x: torch.Tensor) -> tuple[int, int]:
    """Global ring shards ``[lo, hi)`` as a slice ``[a, b)`` of the stack
    ``x`` (empty when ``a >= b``): itself unless the ring spans the
    processes, where ``x`` holds this process's run."""
    first, n = halo.first_shard(x, AXIS_SP), x.shape[0]
    return max(lo - first, 0), min(max(hi - first, 0), n)


def _ring_forward_hopflash(causal: bool, p: int, q, k, v,
                           hops: _HopTrace | None = None):
    """The ring forward with ``flash_fwd`` as the per-hop engine
    (contiguous layout, or any layout without causality): hop 0 is the
    resident diagonal block, the kernel's causal flag, over every shard;
    after ``j`` rotations shard ``i`` holds the block of shard ``i - j``,
    in the past of shards ``j .. p-1`` and wholly in the future of the
    rest, so each later hop is one unmasked launch over shards ``j ..
    p-1`` (every shard without causality), merged by
    :func:`_merge_partials`. Returns ``(o, L)`` as the fold does."""
    poison = chaos.hop_poison_spec()

    def fold(j, state, kb, vb):
        lo, hi = _held(j if causal else 0, p, q)
        if lo < hi:
            _merge_into(state, lo, hi, _hop_partial(
                q[lo:hi], kb[lo:hi], vb[lo:hi], False))
        return state

    if poison is not None:
        fold = chaos.poisoned_fold(fold, poison)
    for j, (kb, vb) in _ring_trip((k, v), p, hops):
        if j:
            state = fold(j, state, kb, vb)
            continue
        if poison is not None:
            kb, vb = chaos.poison_hop(kb, vb, 0, poison)
        state = _hop_partial(q, kb, vb, causal)
    o, L = state
    return o.to(q.dtype), L


def _halves(x: torch.Tensor):
    half = x.shape[2] // 2
    return _aligned(x[:, :, :half]), _aligned(x[:, :, half:])


def _ring_forward_hopflash_zz(p: int, q, k, v):
    """The causal-zigzag ring forward on ``flash_fwd`` over half-chunks:
    the fold's live-pair table as launches over contiguous runs of shards.
    Hop 0: ``(lo, lo)`` and ``(hi, hi)`` the kernel's causal triangles,
    ``(hi, lo)`` unmasked, all shards. Hop ``j >= 1``, all unmasked:
    ``(lo, lo)`` on shards ``j .. p-1`` (``src < idx``), ``(hi, lo)`` on
    every shard, ``(hi, hi)`` on shards ``0 .. j-1`` (``src > idx``). K/V
    travel as their half stacks, so each launch reads contiguous slices.
    Returns ``(o, L)`` in the lo-then-hi row order of each shard."""
    poison = chaos.hop_poison_spec()
    q_lo, q_hi = _halves(q)

    def fold(j, state, kb, vb):
        s_lo, s_hi = state
        (k_lo, k_hi), (v_lo, v_hi) = kb, vb
        lo, hi = _held(j, p, q)
        if lo < hi:
            _merge_into(s_lo, lo, hi, _hop_partial(
                q_lo[lo:hi], k_lo[lo:hi], v_lo[lo:hi], False))
        _merge_into(s_hi, 0, q.shape[0], _hop_partial(q_hi, k_lo, v_lo,
                                                       False))
        lo, hi = _held(0, j, q)
        if lo < hi:
            _merge_into(s_hi, lo, hi, _hop_partial(
                q_hi[lo:hi], k_hi[lo:hi], v_hi[lo:hi], False))
        return state

    if poison is not None:
        fold = chaos.poisoned_fold(fold, poison)
    for j, (k_lo, k_hi, v_lo, v_hi) in _ring_trip(
            (*_halves(k), *_halves(v)), p):
        kb, vb = (k_lo, k_hi), (v_lo, v_hi)
        if j:
            state = fold(j, state, kb, vb)
            continue
        if poison is not None:
            kb, vb = chaos.poison_hop(kb, vb, 0, poison)
        (k_lo, k_hi), (v_lo, v_hi) = kb, vb
        s_hi = _hop_partial(q_hi, k_lo, v_lo, False)
        _merge_into(s_hi, 0, q.shape[0], _hop_partial(q_hi, k_hi, v_hi,
                                                      True))
        state = (_hop_partial(q_lo, k_lo, v_lo, True), s_hi)
    (o_lo, L_lo), (o_hi, L_hi) = state
    return torch.cat([o_lo, o_hi], dim=2).to(q.dtype), torch.cat(
        [L_lo, L_hi], dim=2)


def _ring_backward_hopflash(causal: bool, p: int, res, do):
    """The travelling-dk/dv ring backward with ``flash_hop_dq`` and
    ``flash_hop_dkv`` as the per-hop engine (contiguous layout, or any
    without causality): ``D = rowsum(do·o)`` once; hop 0 the kernels'
    causal flag over every shard, each later hop one unmasked pair of
    launches over its live shards (those of :func:`_ring_forward_hopflash`);
    the dk/dv accumulators, summed over each K/V head's query group inside
    the kernels, rotate after every hop and are home after p rotations."""
    q, k, v, o, L = res
    D = (do.float() * o.float()).sum(dim=-1)
    do = _aligned(do.to(q.dtype))

    def grads(lo, hi, kb, vb, diag):
        return flash_hop_bwd.hop_block_grads(
            *(x[lo:hi].flatten(0, 1) for x in (q, do, L, D, kb, vb)),
            causal=diag)

    for j, (kb, vb) in _ring_trip((k, v), p):
        if not j:
            dq, dk, dv = grads(0, q.shape[0], kb, vb, causal)
            dq, dk, dv = (x.reshape(s.shape)
                          for x, s in ((dq, q), (dk, k), (dv, v)))
        else:
            lo, hi = _held(j if causal else 0, p, q)
            if lo < hi:
                dqj, dkj, dvj = grads(lo, hi, kb, vb, False)
                dq[lo:hi] += dqj.reshape(q[lo:hi].shape)
                dk[lo:hi] += dkj.reshape(k[lo:hi].shape)
                dv[lo:hi] += dvj.reshape(v[lo:hi].shape)
        dk, dv = (halo.ppermute(x, AXIS_SP, 1) for x in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """Ring attention over the ``(p, h, nl, d)`` stacks, saving only ``(q,
    k, v, o, L)``. The forward runs the per-hop engine its plan grants
    (:func:`_ring_forward_hopflash`, or ``_zz`` for causal zigzag), else
    the plain fold; the backward's engine is decided with the forward's
    (``engine="plain"`` folds both directions)."""

    @staticmethod
    def forward(ctx, causal, layout, engine, hops, q, k, v):
        p = halo.axis_size(q, AXIS_SP)
        if _ring_hop_plan(q, k, p, causal, layout, engine) is None:
            o, L = _ring_fold_forward(causal, layout, q, k, v, hops)
        elif causal and layout == "zigzag":
            o, L = _ring_forward_hopflash_zz(p, q, k, v)
        else:
            o, L = _ring_forward_hopflash(causal, p, q, k, v, hops)
        ctx.causal, ctx.layout, ctx.p = causal, layout, p
        ctx.hop_bwd = _ring_hop_bwd_plan(q, k, p, causal, layout,
                                         engine) is not None
        ctx.save_for_backward(q, k, v, o, L)
        return o

    @staticmethod
    def backward(ctx, do):
        res = ctx.saved_tensors
        if ctx.hop_bwd:
            grads = _ring_backward_hopflash(ctx.causal, ctx.p, res, do)
        else:
            grads = _ring_fold_backward(ctx.causal, ctx.layout, res, do)
        return (None, None, None, None, *grads)


def ring_hop_engine_for(q, k, v, *, p: int | None = None, causal: bool = True,
                        layout: str = "contiguous",
                        engine: str = "auto") -> str:
    """The engine each K/V hop of a ``ring_attention`` over these GLOBAL
    operands on ``p`` shards runs: ``cuda:flash_fwd:b<tile>`` (``:g<groups>``
    under GQA) for the kernel on the card, ``cpu:flash_fwd_plain`` for its
    plain version on the CPU, ``plain`` for the fold; ``:zz`` marks the
    causal-zigzag half-chunk decomposition. A ring of one (``p`` defaults to 1) is local attention,
    ``local:<flash_engine_for>``. 4-D operands fold the batch and gain
    ``:b{B}``."""
    if q.dim() == 4:
        return ring_hop_engine_for(
            _fold_batch(q), _fold_batch(k), _fold_batch(v), p=p,
            causal=causal, layout=layout, engine=engine) + f":b{q.shape[0]}"
    _check_engine(engine)
    p = p or 1
    if p == 1:
        return "local:" + flash_engine_for(q, k, v, engine)
    stamp = _ring_hop_plan(q, k, p, causal, layout, engine)
    if stamp is None:
        return "plain"
    return stamp + ":zz" if causal and layout == "zigzag" else stamp


def ring_hop_bwd_engine_for(q, k, v, *, p: int | None = None,
                            causal: bool = True, layout: str = "contiguous",
                            engine: str = "auto") -> str:
    """The ring BACKWARD's per-hop engine for these global operands:
    ``cuda:flash_hop_bwd:b<tile>`` (the dq and dk/dv kernels; ``:g<groups>``
    under GQA, K/V read un-expanded), ``cpu:hop_block_grads_plain`` on the
    CPU, ``plain`` for the fold (causal zigzag always, as in the JAX
    package; ``engine="plain"``). ``:b{B}`` and ``local:`` as
    :func:`ring_hop_engine_for`."""
    if q.dim() == 4:
        return ring_hop_bwd_engine_for(
            _fold_batch(q), _fold_batch(k), _fold_batch(v), p=p,
            causal=causal, layout=layout, engine=engine) + f":b{q.shape[0]}"
    _check_engine(engine)
    p = p or 1
    if p == 1:
        return "local:" + flash_engine_for(q, k, v, engine)
    stamp = _ring_hop_bwd_plan(q, k, p, causal, layout, engine)
    return "plain" if stamp is None else stamp


def ring_partial_magnitude(q, k, v, p: int, causal: bool = True,
                           layout: str = "contiguous",
                           rows: int = 4096) -> torch.Tensor:
    """``M = sum_j w_j |o_j|``, float32, shaped like ``q`` ``(h, n, d)``:
    the magnitude, merged as the ring merges it, of the normalised partial
    ``o_j`` that each hop's launch writes, ``w_j`` its merge weight. A hop
    whose kernel rounds ``o_j`` to the operands' dtype can move the ring's
    output by at most one rounding of this, so a check of a bfloat16 ring
    adds one bf16 spacing of ``M`` to its limit.

    Computed from the dense softmax ``P`` alone, independent of the ring's
    schedule: ``w_j o_j = sum_{key in G_j} P_key v_key`` for ``G_j`` the
    keys of hop ``j``'s launch, so ``M = sum_G |P[:, G] @ v[G]|``. The
    groups are the ring's key blocks of ``n/p`` tokens in the operands'
    order, halved to the zigzag half-chunks under causal zigzag; positions
    follow ``layout``. Rows in slices of ``rows``, one head at a time."""
    h, n, d = q.shape
    g = h // k.shape[0]
    nl = n // p
    width = nl // 2 if causal and layout == "zigzag" else nl
    pos = (torch.tensor(zigzag_order(n, p), device=q.device)
           if layout == "zigzag" else torch.arange(n, device=q.device))
    out = torch.empty((h, n, d), dtype=torch.float32, device=q.device)
    with _full_f32_matmul():
        for head in range(h):
            kh, vh = k[head // g].float(), v[head // g].float()
            vg = vh.reshape(n // width, width, d)
            for r0 in range(0, n, rows):
                s = q[head, r0:r0 + rows].float() @ kh.T / math.sqrt(d)
                if causal:
                    s.masked_fill_(pos[r0:r0 + rows, None] < pos[None, :],
                                   -math.inf)
                pr = torch.softmax(s, dim=-1).reshape(len(s), n // width,
                                                      width)
                out[head, r0:r0 + rows] = torch.einsum(
                    "rgk,gkd->rgd", pr, vg).abs().sum(1)
    return out


def _check_seq(n: int, p: int, what: str) -> None:
    if n % p:
        raise ValueError(
            f"{what}: sequence length {n} not divisible by mesh size {p}; "
            "pad the sequence to a multiple (the framework's uneven-board "
            "handling pads globally the same way)")


def _sp_mesh(devices, mesh, axis: str, device) -> mesh_lib.Mesh:
    """The mesh a sharded call runs on: ``mesh``, or ``devices`` virtual
    shards of ``device`` on ``axis`` (one shard when neither is given)."""
    if mesh is None:
        return mesh_lib.make_mesh_1d(devices or 1, axis=axis, device=device,
                                     virtual=True)
    if devices is not None:
        raise ValueError("pass devices or mesh, not both")
    return mesh


def _guarded_ring(dispatch, name: str, on_card: bool,
                  attrs: dict | None = None):
    """:func:`ring_attention`'s dispatch under the robust layer, the policy
    of ``LifeSim``'s guarded step. With no chaos plan and no
    ``MOMP_GUARD=1`` (the default path) it is ``dispatch()`` alone; under
    ``noguard`` the fault lands. Armed, the output is validated (a host
    sync); a non-finite one is recomputed on the same engine with
    injection suppressed, then, for operands on the CPU only, on the plain
    fold (``dispatch(fold=True)``). Operands on the card whose clean re-run
    still diverges are a kernel fault: ``guards.FallbackExhausted``, never
    the plain version. A recovery is recorded as ``<name>:recovered``
    (``name`` the engine that ran, ``ring_attention:plain`` for the fold).
    An exception (a build or launch error) is no fault to recover from: it
    is raised. Armed, the call is one ``ring_attention`` span (``attrs``
    and ``guarded=True``) stamped with the engine that held."""
    if not guards.guards_active():
        return dispatch()
    raised = []

    def kept(fold=False, clean=True):
        def run():
            try:
                with chaos.suppressed() if clean else contextlib.nullcontext():
                    return dispatch(fold)
            except Exception as e:  # re-raised below, never recovered
                raised.append(e)
                return None
        return run

    engines = [(name, kept(clean=False)), (name, kept())]
    if not on_card:
        engines.append(("ring_attention:plain", kept(fold=True)))
    with trace.span("ring_attention", **(attrs or {}),
                    guarded=True) as sp:
        out, stamp, _ = guards.with_fallback(
            engines, validator=lambda o: o is None or guards.all_finite(o))
        sp.set(engine=stamp)
        if raised:
            raise raised[0]
        if stamp.endswith(":recovered"):
            # The funnel's trace event lands inside this span.
            guards.record_recovery(stamp)
        sp.anchor(out)
    return out


# The sharded attention calls seen so far (variant, shapes, dtype, shards,
# causality, layout, engine, card): the port's counterpart of the JAX
# package's compiled sharded programs.
_SHARDED: set = set()


def _note_sharded(*key) -> None:
    metrics.inc_once(_SHARDED, key, "jit.retrace", fn="sharded_attention")


def ring_attention(q, k, v, devices: int | None = None, causal: bool = False,
                   layout: str = "contiguous", *,
                   mesh: mesh_lib.Mesh | None = None, axis: str = AXIS_SP,
                   device: str | torch.device = "cuda",
                   engine: str = "auto") -> torch.Tensor:
    """Sequence-parallel attention over a ring of shards: ``mesh``'s axis
    ``axis``, or ``devices`` virtual shards of ``device`` (the card unless
    the caller asks for the CPU). Shapes ``(heads, seq, head_dim)`` with
    ``seq`` split over the shards; K/V may carry fewer heads (GQA/MQA)
    dividing q's; 4-D ``(B, heads, seq, head_dim)`` operands run B requests
    in one ring trip (:func:`_fold_batch`).

    K/V blocks rotate round the ring, one hop a step, folded into each
    shard's online softmax; on the card every live hop launches
    ``flash_fwd`` and the backward ``flash_hop_dq`` and ``flash_hop_dkv``
    (:func:`ring_hop_engine_for`, :func:`ring_hop_bwd_engine_for` name
    them); ``engine="plain"`` asks for the plain fold. ``layout="zigzag"``
    balances causal work: operands arrive in zigzag order
    (:func:`zigzag_shard`; invert with :func:`zigzag_unshard`), and
    ``seq % (2 * shards) == 0``. A ring of one is local attention under
    either layout."""
    _check_engine(engine)
    mesh = _sp_mesh(devices, mesh, axis, device)
    q, k, v = _on_device(mesh.device, q, k, v)
    if q.dim() == 4:
        if not (k.dim() == v.dim() == 4 and k.shape[0] == q.shape[0]):
            raise ValueError(
                f"ring_attention: batched q {tuple(q.shape)} needs k/v with "
                f"the same leading batch, got {tuple(k.shape)} / "
                f"{tuple(v.shape)}")
        out = ring_attention(_fold_batch(q), _fold_batch(k), _fold_batch(v),
                             causal=causal, layout=layout, mesh=mesh,
                             axis=axis, engine=engine)
        return out.reshape(q.shape)
    p = mesh.shape[axis]
    _check_seq(q.shape[1], p, "ring_attention")
    _check_gqa(q, k, v, "ring_attention")
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout == "zigzag" and q.shape[1] % (2 * p):
        raise ValueError(
            f"ring_attention zigzag layout needs seq % (2*mesh) == 0, got "
            f"seq {q.shape[1]} over {p} devices")

    def dispatch(fold=False, hops=None):
        eng = "plain" if fold else engine
        if hops is None:
            _note_sharded("ring", q.shape, k.shape, q.dtype, p, causal,
                          layout, eng, q.is_cuda)
        if p == 1:
            return _attention_chunked(q, k, v, causal, eng)
        return _from_shards(_RingFlash.apply(
            causal, layout, eng, hops, *(_held_shards(x, p, mesh)
                                         for x in (q, k, v))))

    stamp = ring_hop_engine_for(q, k, v, p=p, causal=causal, layout=layout,
                                engine=engine)
    attrs = dict(devices=p, seq=q.shape[1], layout=layout, causal=causal)
    if chaos.active_plan() is not None or guards.guard_env():
        return _guarded_ring(dispatch, "ring_attention:" + stamp,
                             q.device.type == "cuda", attrs)
    if trace.hop_spans_active() and p > 1 and layout == "contiguous":
        # The traced hop-by-hop forward (module docstring).
        with trace.span("ring_attention", devices=p, seq=q.shape[1],
                        heads=q.shape[0], causal=causal, engine=stamp,
                        traced_dispatch=True) as sp:
            out = dispatch(hops=_HopTrace(stamp, (k.nbytes + v.nbytes) // p))
            metrics.inc("ring.hops.fwd", p - 1, engine=stamp)
            metrics.inc("ring.steps.traced")
            sp.anchor(out)
        return out
    with trace.span("ring_attention", **attrs, engine=stamp) as sp:
        out = dispatch()
        sp.anchor(out)
    return out


def _ulysses_kv(k, v, p: int, heads: int):
    """K/V for the all-to-all: un-expanded when the kv heads split over the
    ``p`` shards, else expanded just enough to split (the smallest count
    divisible by p that divides the query heads; all of them at worst)."""
    hkv = k.shape[0]
    if hkv % p == 0:
        return k, v
    e = hkv * (p // math.gcd(hkv, p))
    factor = e // hkv if heads % e == 0 else heads // hkv
    return _repeat_heads(k, v, factor)


def ulysses_attention(q, k, v, devices: int | None = None,
                      causal: bool = False, *,
                      mesh: mesh_lib.Mesh | None = None, axis: str = AXIS_SP,
                      device: str | torch.device = "cuda",
                      engine: str = "auto") -> torch.Tensor:
    """All-to-all (Ulysses) sequence-parallel attention over the shards of
    :func:`ring_attention`'s ``mesh``/``devices``: an all-to-all
    (:func:`halo.all_to_all`) re-shards the stacks from sequence-split to
    head-split, each shard runs full local attention on its ``heads/p``
    heads (:func:`_attention_chunked`, one launch over the shards folded
    into the head axis: ``_FlashKernel`` on the card), and a second
    all-to-all returns the sequence split. ``heads`` must divide over the
    shards; GQA/MQA K/V stay un-expanded when their heads split, else are
    expanded just enough. 4-D operands fold the batch into the heads."""
    _check_engine(engine)
    mesh = _sp_mesh(devices, mesh, axis, device)
    q, k, v = _on_device(mesh.device, q, k, v)
    if q.dim() == 4:
        if not (k.dim() == v.dim() == 4 and k.shape[0] == q.shape[0]):
            raise ValueError(
                f"ulysses_attention: batched q {tuple(q.shape)} needs k/v "
                f"with the same leading batch, got {tuple(k.shape)} / "
                f"{tuple(v.shape)}")
        out = ulysses_attention(_fold_batch(q), _fold_batch(k),
                                _fold_batch(v), causal=causal, mesh=mesh,
                                axis=axis, engine=engine)
        return out.reshape(q.shape)
    p = mesh.shape[axis]
    _check_seq(q.shape[1], p, "ulysses_attention")
    _check_gqa(q, k, v, "ulysses_attention")
    if q.shape[0] % p:
        raise ValueError(
            f"ulysses_attention: {q.shape[0]} heads not divisible by mesh "
            f"size {p}; use ring_attention (no head constraint) instead")
    k, v = _ulysses_kv(k, v, p, q.shape[0])
    _note_sharded("ulysses", q.shape, k.shape, q.dtype, p, causal, engine,
                  q.is_cuda)
    # (p, h, n/p, d) -> (p, h/p, n, d): scatter heads, gather the sequence.
    qh, kh, vh = (halo.all_to_all(_held_shards(x, p, mesh), 0, 1)
                  for x in (q, k, v))
    oh = _attention_chunked(qh.flatten(0, 1), kh.flatten(0, 1),
                            vh.flatten(0, 1), causal, engine)
    return _from_shards(halo.all_to_all(oh.reshape(qh.shape), 1, 0))


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
