"""The port's attention held against the JAX package's, on the CPU.

The same numpy arrays, made from a seed, go through both packages. The JAX
side runs its jnp engines (on the CPU ``flash_attention`` takes the
chunked jnp engine and its ``custom_vjp`` backward); the port runs its
plain engine, which is what the CPU takes (the CUDA kernels are held
against it on the card by ``chip_smoke.py``). The JAX Pallas hop kernels
are not run: their interpret mode fails on the installed JAX (ROADMAP
Queue 3), so the port is held against the module's own oracles,
``attention_reference``, ``_flash_forward``, ``_flash_block_grads`` and
the chunked engine.

Tolerances, float32: forward 1e-5 and gradients 1e-4 against the JAX
engine (two float32 engines summing in their own orders); the hop
gradients 2e-4, as the JAX package's own kernel test; 1e-6 for the
online-softmax merge. bfloat16 operands: 0.1 against the float32 oracle.
The bf16 hop kernels' split arithmetic, emulated here: 5e-4 absolute plus
5e-4 relative, the limit chip_smoke.py holds the kernels to on the card;
the bf16 forward's, its bf16 rule for o (two bf16 spacings of the value +
1e-3 of the row's largest + 1e-6 of the tensor's) and 2e-4 for L.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_and_open_mp_tpu.parallel import context as J
from mpi_and_open_mp_tpu_torch.ops import flash_hop_bwd as fb
from mpi_and_open_mp_tpu_torch.ops import native_flash as nf
from mpi_and_open_mp_tpu_torch.parallel import context as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def small_chunks(monkeypatch):
    """Shrink ``_Q_CHUNK`` in both packages so the chunked engines run at
    test sizes. The JAX value is baked in at trace time and is not a jit
    cache key, so its caches are cleared before and after."""

    def set_chunk(n):
        monkeypatch.setattr(J, "_Q_CHUNK", n)
        monkeypatch.setattr(T, "_Q_CHUNK", n)
        jax.clear_caches()

    yield set_chunk
    jax.clear_caches()


def _arrays(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _qkv(h, hkv, n, d, seed=0):
    return _arrays([(h, n, d), (hkv, n, d), (hkv, n, d)], seed)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("h,n,d", [(4, 128, 32), (1, 64, 16), (3, 256, 8)])
def test_attention_reference_matches_jax(causal, h, n, d):
    q, k, v = _qkv(h, h, n, d)
    got = T.attention_reference(*_t(q, k, v), causal=causal)
    want = J.attention_reference(*map(jnp.asarray, (q, k, v)), causal=causal)
    _close(got, want, 1e-5)


def _torch_grads(fn, q, k, v):
    args = [x.clone().requires_grad_(True) for x in _t(q, k, v)]
    out = fn(*args)
    grads = torch.autograd.grad((out.float() ** 2).sum(), args)
    return out.detach(), grads


def _jax_grads(fn, q, k, v):
    """Output and jax.grad of sum(o**2), jitted (faster than eager here)."""
    args = [jnp.asarray(x) for x in (q, k, v)]
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(fn(a, b, c).astype(jnp.float32) ** 2),
        argnums=(0, 1, 2)))(*args)
    return out, grads


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [72, 96])
@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 1)])
def test_flash_attention_matches_jax(small_chunks, causal, n, h, hkv):
    """Forward and full (q, k, v) gradients of sum(o**2) through the
    chunked engines (n = 72 leaves a ragged last chunk of 16)."""
    small_chunks(16)
    q, k, v = _qkv(h, hkv, n, 8, seed=n + h)
    got, g_got = _torch_grads(
        lambda a, b, c: T.flash_attention(a, b, c, causal, device="cpu"),
        q, k, v)
    want, g_want = _jax_grads(
        lambda a, b, c: J.flash_attention(a, b, c, causal=causal), q, k, v)
    assert T.flash_engine_for(*_t(q, k, v)) == "plain"
    _close(got, want, 1e-5)
    for name, a, b in zip(("dq", "dk", "dv"), g_got, g_want):
        assert a.shape == b.shape, name
        _close(a, b, 1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_chunked_matches_jax(small_chunks, causal):
    small_chunks(16)
    q, k, v = _qkv(2, 2, 96, 8, seed=3)
    got = T._attention_chunked(*_t(q, k, v), causal)
    want = jax.jit(J._attention_chunked, static_argnums=3)(
        *map(jnp.asarray, (q, k, v)), causal)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_attention_batched_matches_jax(small_chunks, causal, hkv):
    """The 4-D request-batched form folds the batch into the heads."""
    small_chunks(16)
    q, k, v = _arrays([(3, 4, 72, 8), (3, hkv, 72, 8), (3, hkv, 72, 8)], 5)
    got, g_got = _torch_grads(
        lambda a, b, c: T.flash_attention(a, b, c, causal, device="cpu"),
        q, k, v)
    want, g_want = _jax_grads(
        lambda a, b, c: J.flash_attention(a, b, c, causal=causal), q, k, v)
    assert got.shape == (3, 4, 72, 8)
    _close(got, want, 1e-5)
    for a, b in zip(g_got, g_want):
        _close(a, b, 1e-4)
    assert T.flash_engine_for(*_t(q, k, v)) == "plain:b3"


@pytest.mark.parametrize("n", [72, 16])  # the chunked engine; the dense path
def test_bf16_in_bf16_grads_out(small_chunks, n):
    small_chunks(16)
    q, k, v = _qkv(4, 2, n, 8, seed=9)
    bf = [x.to(torch.bfloat16) for x in _t(q, k, v)]
    args = [x.clone().requires_grad_(True) for x in bf]
    out = T.flash_attention(*args, causal=True, device="cpu")
    grads = torch.autograd.grad((out.float() ** 2).sum(), args)
    assert out.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    want, g_want = _torch_grads(
        lambda a, b, c: T.attention_reference(
            a, *T._repeat_heads(b, c, 2), causal=True),
        *(x.float().numpy() for x in bf))
    _close(out.detach().float(), want, 0.1)
    for a, b in zip(grads, g_want):
        _close(a.float(), b, 0.1)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n,h,hkv", [(72, 2, 2), (96, 4, 2), (40, 8, 1)])
def test_flash_forward_matches_jax(small_chunks, causal, n, h, hkv):
    """The plain forward's (o, L), L folded and padded as the JAX engine
    keeps it; and the kernel wrapper's plain version on the CPU, L
    unfolded to (h, n)."""
    small_chunks(16)
    q, k, v = _qkv(h, hkv, n, 8, seed=n)
    o, L = T._flash_forward(causal, *_t(q, k, v))
    jo, jL = jax.jit(J._flash_forward, static_argnums=0)(
        causal, *map(jnp.asarray, (q, k, v)))
    assert L.shape == jL.shape
    _close(o, jo, 1e-5)
    _close(L, jL, 1e-5)
    o2, L2 = nf.flash_fwd(*_t(q, k, v), causal)
    assert L2.shape == (h, n) and L2.dtype == torch.float32
    torch.testing.assert_close(o2, o, rtol=0, atol=0)
    g = h // hkv
    want = np.asarray(J._unfold_groups(jL[:, : n * g], hkv, g))
    _close(L2, want, 1e-5)


def _hop_inputs(causal, h=2, n=256, d=128, seed=11, bf16_values=False):
    """The construction of the JAX package's hop kernel test: L the exact
    logsumexp of the scaled (masked) scores, D = rowsum(do * o); with
    ``bf16_values`` q, k, v and do are first rounded to bfloat16."""
    q, k, v, do = _arrays([(h, n, d)] * 4, seed)
    if bf16_values:
        q, k, v, do = (torch.from_numpy(x).bfloat16().float().numpy()
                       for x in (q, k, v, do))
    s = np.einsum("hqd,hkd->hqk", q, k) / np.sqrt(d)
    if causal:
        s = np.where(np.tril(np.ones((n, n), bool)), s, -1e30)
    m = s.max(-1, keepdims=True)
    L = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    o = np.einsum("hqk,hkd->hqd", np.exp(s - L[..., None]), v)
    D = (do * o).sum(-1)
    return [x.astype(np.float32) for x in (q, k, v, do, L, D)]


@pytest.mark.parametrize("chunk", [512, 64])
@pytest.mark.parametrize("causal", [False, True])
def test_hop_block_grads_plain_matches_jax(monkeypatch, causal, chunk):
    """hop_block_grads on the CPU (the kernels' plain version, over one
    chunk or 4 x 4 chunked blocks) against the JAX _flash_block_grads on
    the whole block."""
    monkeypatch.setattr(T, "_Q_CHUNK", chunk)
    q, k, v, do, L, D = _hop_inputs(causal)
    n, d = q.shape[1:]
    pos = jnp.arange(n)
    mask = J._mask_from_pos(pos, pos, None, causal)
    want = J._flash_block_grads(*map(jnp.asarray, (q, do, L, D, k, v)),
                                mask, 1.0 / np.sqrt(d))
    got = fb.hop_block_grads(*_t(q, do, L, D, k, v), causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32, name
        _close(a, b, 2e-4)
    dq = fb.flash_hop_dq(*_t(q, do, L, D, k, v), causal=causal)
    dk, dv = fb.flash_hop_dkv(*_t(q, do, L, D, k, v), causal=causal)
    for a, b in zip((dq, dk, dv), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_hop_block_grads_gqa_sums_the_group(monkeypatch):
    """Under GQA the dk/dv of a K/V head sum its query group: the same as
    the expanded heads' gradients summed."""
    monkeypatch.setattr(T, "_Q_CHUNK", 32)
    q, k, v, do = _arrays([(4, 80, 16), (2, 80, 16), (2, 80, 16),
                           (4, 80, 16)], 13)
    q, k, v, do = _t(q, k, v, do)
    o, L = nf.flash_fwd(q, k, v, True)
    D = (do * o).sum(-1)
    dq, dk, dv = fb.hop_block_grads(q, do, L, D, k, v, causal=True)
    ek, ev = T._repeat_heads(k, v, 2)
    edq, edk, edv = fb.hop_block_grads(q, do, L, D, ek, ev, causal=True)
    torch.testing.assert_close(dq, edq, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dk, edk.reshape(2, 2, 80, 16).sum(1),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dv, edv.reshape(2, 2, 80, 16).sum(1),
                               rtol=1e-5, atol=1e-5)


def _split_products(q, do, L, D, k, v, causal, split=True):
    """The bf16 hop kernels' arithmetic (csrc/flash_hop_bwd.cu), emulated
    in float32: the first products of bf16 values with float32 sums, p by
    exp2 with log2 e folded into scale and L, and p and t split into a bf16
    hi + lo pair, each second product run on both halves into one float32
    sum. ``split=False`` drops lo: p and t rounded once to bf16, as the
    JAX kernels and SDPA feed them to their second products."""
    n, d = q.shape[1:]
    scale = 1.0 / math.sqrt(d)
    log2e = 1.4426950408889634
    s = torch.einsum("hqd,hkd->hqk", q, k)
    p = torch.exp2(s * (scale * log2e) - (L * log2e)[..., None])
    if causal:
        p = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), p, 0.0)
    t = p * (torch.einsum("hqd,hkd->hqk", do, v) - D[..., None])

    def split_pair(x):
        hi = x.bfloat16().float()
        return hi, (x - hi).bfloat16().float() * split

    (p_hi, p_lo), (t_hi, t_lo) = split_pair(p), split_pair(t)
    dq = scale * (torch.einsum("hqk,hkd->hqd", t_hi, k)
                  + torch.einsum("hqk,hkd->hqd", t_lo, k))
    dk = scale * (torch.einsum("hqk,hqd->hkd", t_hi, q)
                  + torch.einsum("hqk,hqd->hkd", t_lo, q))
    dv = (torch.einsum("hqk,hqd->hkd", p_hi, do)
          + torch.einsum("hqk,hqd->hkd", p_lo, do))
    return dq, dk, dv


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_split_products_within_the_gate(causal, d):
    """The bf16 kernels' split of p and t keeps their gradients within the
    gradient limit that chip_smoke.py holds them to on the card (5e-4
    absolute plus 5e-4 relative) of the JAX package's float32 fold,
    _flash_block_grads, on bf16-valued operands; p and t rounded once
    instead miss it."""
    q, k, v, do, L, D = _hop_inputs(causal, n=512, d=d, seed=23,
                                    bf16_values=True)
    pos = jnp.arange(q.shape[1])
    mask = J._mask_from_pos(pos, pos, None, causal)
    want = [np.asarray(x) for x in J._flash_block_grads(
        *map(jnp.asarray, (q, do, L, D, k, v)), mask, 1.0 / np.sqrt(d))]

    def within(got):
        return [bool((np.abs(a.numpy() - b) <= 5e-4 + 5e-4 * np.abs(b)).all())
                for a, b in zip(got, want)]

    operands = _t(q, do, L, D, k, v)
    assert within(_split_products(*operands, causal)) == [True] * 3
    assert not all(within(_split_products(*operands, causal, split=False)))


def _fwd_products(q, k, v, causal, split=True):
    """The bf16 forward kernel's arithmetic (csrc/flash_fwd.cu:
    flash_fwd_tc), emulated in float32 on bf16-valued operands: s = q kᵀ
    with a float32 sum, x = s·(scale·log2 e), 64-key tiles folded by the
    online softmax in log2 units (running max from -1e30, corr and p by
    exp2, l the float32 sum of the unsplit p), p split into a bf16 hi + lo
    pair and o += p_hi v + p_lo v, o rounded to bf16 and L = m·ln 2 +
    log l in float32. ``split=False`` drops lo: p rounded once to bf16, as
    the JAX kernel and SDPA feed it to their second product."""
    h, n, d = q.shape
    k, v = (x.repeat_interleave(h // k.shape[0], 0) for x in (k, v))
    sl2 = (torch.tensor(1.0 / math.sqrt(d))
           * torch.tensor(1.4426950408889634))  # float32, as the kernel
    x = torch.einsum("hqd,hkd->hqk", q, k) * sl2
    if causal:
        x = torch.where(torch.ones(n, n, dtype=torch.bool).tril(), x,
                        -math.inf)
    m = torch.full((h, n, 1), -1e30)
    l = torch.zeros((h, n, 1))
    acc = torch.zeros((h, n, d))
    for k0 in range(0, n, 64):
        xt, vt = x[..., k0:k0 + 64], v[:, k0:k0 + 64]
        m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() * split
        acc = acc * corr + hi @ vt + lo @ vt
        m = m_new
    o = (acc / l).bfloat16()
    L = m * math.log(2.0) + torch.log(l.clamp_min(1e-37))
    return o, L[..., 0]


def _within_bf16_rule(got, want):
    """chip_smoke.py's rule for a bf16 result: |got - want| <= 2·2^-7
    |want| + 1e-3 of the row's largest |want| + 1e-6 of the tensor's."""
    a = np.abs(want)
    limit = (2 * 2.0 ** -7 * a + 1e-3 * a.max(-1, keepdims=True)
             + 1e-6 * a.max())
    return bool((np.abs(got.float().numpy() - want) <= limit).all())


@pytest.mark.parametrize("d,hkv", [(64, 2), (128, 2), (128, 1)])
@pytest.mark.parametrize("causal", [False, True])
def test_fwd_split_products_within_the_gate(causal, d, hkv):
    """The bf16 forward's split of p keeps o within the bf16 rule that
    chip_smoke.py holds the kernel to on the card, and L within its 2e-4
    absolute plus 2e-4 relative, of the JAX package's float32
    attention_reference and _flash_forward on bf16-valued operands at
    n = 2048 (hkv = 1: GQA, two query heads on one K/V head); p rounded
    once instead misses the rule."""
    h, n = 2, 2048
    q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
               for x in _qkv(h, hkv, n, d, seed=31 + d + hkv))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = np.asarray(J.attention_reference(
        jq, *J._repeat_heads(jk, jv, h // hkv), causal=causal))
    jo, jL = jax.jit(J._flash_forward, static_argnums=0)(causal, jq, jk, jv)
    jL = np.asarray(J._unfold_groups(jL[:, : n * (h // hkv)], hkv,
                                     h // hkv))
    operands = _t(q, k, v)
    o, L = _fwd_products(*operands, causal)
    assert o.dtype == torch.bfloat16 and L.shape == (h, n)
    assert _within_bf16_rule(o, ref) and _within_bf16_rule(o, np.asarray(jo))
    assert bool((np.abs(L.numpy() - jL) <= 2e-4 + 2e-4 * np.abs(jL)).all())
    o1, _ = _fwd_products(*operands, causal, split=False)
    assert not _within_bf16_rule(o1, ref)


def test_engine_stamps(monkeypatch):
    """The engine stamps of the CPU, and the kernel's (what the card
    reports), built from the kernels' tile and the group count."""
    q, k, v = _t(*_qkv(4, 1, 600, 8))
    assert not T._use_kernel(q)  # a CPU tensor
    assert not T._use_kernel(q, "plain")
    monkeypatch.setattr(T, "_use_kernel", lambda q, engine="auto": True)
    assert T.flash_engine_for(q, k, v) == f"cuda:flash_fwd:b{nf.BLOCK}:g4"
    assert T.flash_engine_for(q, q, q) == f"cuda:flash_fwd:b{nf.BLOCK}"
    monkeypatch.undo()
    assert T.flash_engine_for(q, k, v) == "plain"
    assert T.flash_engine_for(q[:, :512], k[:, :512], v[:, :512]) == "dense"


def test_kernel_tiles_fit_a_block():
    """The tiles' shared memory, as the modules document it, fits the
    227 KB a block may take (ops/bitlife.py:SMEM_BYTES)."""
    from mpi_and_open_mp_tpu_torch.ops.bitlife import SMEM_BYTES

    assert nf.smem_bytes(128, torch.float32) == 115_712
    assert nf.smem_bytes(128, torch.bfloat16) == 164_864
    assert nf.smem_bytes(64, torch.bfloat16) == 82_944
    assert fb.smem_bytes(128, torch.float32) == {"dq": 148_736,
                                                 "dkv": 165_888}
    assert fb.smem_bytes(128, torch.bfloat16) == {"dq": 132_096,
                                                  "dkv": 133_120}
    for d in nf.HEAD_DIMS:
        for dtype in nf.DTYPE_CODES:
            assert nf.smem_bytes(d, dtype) <= SMEM_BYTES
            assert max(fb.smem_bytes(d, dtype).values()) <= SMEM_BYTES


@pytest.mark.parametrize("shapes", [
    [(4, 16, 8), (3, 16, 8), (3, 16, 8)],     # kv heads not dividing
    [(4, 16, 8), (2, 12, 8), (2, 12, 8)],     # another length
    [(4, 16, 8), (2, 16, 4), (2, 16, 4)],     # another width
    [(16, 8), (16, 8), (16, 8)],              # no head axis
])
def test_kernel_wrappers_refuse_bad_shapes(shapes):
    q, k, v = _t(*_arrays(shapes))
    with pytest.raises(ValueError, match="flash_fwd"):
        nf.flash_fwd(q, k, v, True)
    if q.dim() == 3 and k.shape[1] == q.shape[1]:
        L = torch.zeros(q.shape[:2])
        with pytest.raises(ValueError, match="hop_block_grads"):
            fb.hop_block_grads(q, q, L, L, k, v, causal=True)


@pytest.mark.parametrize("offset", [0, 1, 8])
def test_kernel_alignment_check(offset):
    """The tensor-core kernels' wrappers refuse operands that do not start
    on 16 bytes (nf.check_aligned, called by flash_fwd for bf16 and by the
    hop kernels' launches) before anything reaches the card."""
    base = torch.zeros(2 * 64 * 64 + 16, dtype=torch.bfloat16)
    q = base[offset:offset + 2 * 64 * 64].view(2, 64, 64)
    aligned = torch.zeros(2, 64, 64, dtype=torch.bfloat16)
    assert q.is_contiguous() and aligned.data_ptr() % 16 == 0
    if q.data_ptr() % 16:
        with pytest.raises(ValueError, match="start on 16 bytes"):
            nf.check_aligned("flash_fwd", aligned, q, aligned)
    else:
        nf.check_aligned("flash_fwd", q, aligned, aligned)


def test_merge_partials_matches_jax():
    o1, o2 = _arrays([(2, 24, 8), (2, 24, 8)], 17)
    L1, L2 = _arrays([(2, 24), (2, 24)], 19)
    got = T._merge_partials(*_t(o1, L1, o2, L2))
    want = J._merge_partials(*map(jnp.asarray, (o1, L1, o2, L2)))
    for a, b in zip(got, want):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("n,p", [(64, 8), (272, 8), (96, 4), (10, 1)])
def test_zigzag_order_matches_jax(n, p):
    np.testing.assert_array_equal(T.zigzag_order(n, p), J.zigzag_order(n, p))
    x = torch.arange(3 * n * 2, dtype=torch.float32).reshape(3, n, 2)
    z = T.zigzag_shard(x, p)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(J.zigzag_shard(jnp.asarray(x.numpy()), p)))
    torch.testing.assert_close(T.zigzag_unshard(z, p), x, rtol=0, atol=0)


def test_gated_parity_check_on_cpu(small_chunks):
    small_chunks(16)
    ok, engine, notes = T.gated_parity_check(heads=2, n=80, dim=16,
                                             device="cpu")
    assert (ok, engine, notes) == (True, "plain", [])
    ok, engine, notes = T.gated_parity_check(heads=4, kv_heads=2, n=64,
                                             dim=16, for_seq=100, device="cpu")
    assert (ok, engine, notes) == (True, "plain", [])
    ok, engine, _ = T.gated_parity_check(heads=2, n=64, dim=16, for_seq=12,
                                         device="cpu")
    assert (ok, engine) == (True, "dense")


def test_gated_parity_check_reports_a_failing_engine(small_chunks,
                                                     monkeypatch):
    """A wrong engine fails the gate with a note; nothing switches."""
    small_chunks(16)
    real = T._flash_forward

    def wrong_forward(causal, q, k, v):
        o, L = real(causal, q, k, v)
        return o * 1.01, L

    monkeypatch.setattr(T, "_flash_forward", wrong_forward)
    ok, engine, notes = T.gated_parity_check(heads=2, n=64, dim=16,
                                             device="cpu")
    assert not ok and engine == "plain"
    assert notes == ["plain engine failed parity"]


def test_flash_backward_saves_no_score_matrix(small_chunks):
    """The flash backward's memory contract (the port's twin of
    test_context.py::test_flash_backward_residuals_bounded): through a
    chain of three calls, no tensor saved for the backward holds as many
    elements as the (h, n, n) score matrix."""
    small_chunks(16)
    h, n, d = 2, 96, 8
    q, k, v = _t(*_qkv(h, h, n, d))
    q.requires_grad_(True)
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        c = q
        for _ in range(3):
            c = T._attention_chunked(c, k, v, True)
        loss = (c ** 2).sum()
    (g,) = torch.autograd.grad(loss, [q])
    assert saved and torch.isfinite(g).all()
    assert max(int(np.prod(s)) for s in saved) < h * n * n, saved


@pytest.mark.parametrize("variant", ["ring", "ulysses"])
def test_single_device_variants_are_local_attention(small_chunks, variant):
    small_chunks(16)
    q, k, v = _qkv(4, 2, 72, 8, seed=21)
    fn = T.ring_attention if variant == "ring" else T.ulysses_attention
    got = fn(*_t(q, k, v), causal=True, device="cpu")
    want = jax.jit(lambda a, b, c: J.flash_attention(a, b, c, causal=True))(
        *map(jnp.asarray, (q, k, v)))
    _close(got, want, 1e-5)
    if variant == "ring":
        zig = T.ring_attention(*_t(q, k, v), devices=1, causal=True,
                               layout="zigzag", device="cpu")
        torch.testing.assert_close(zig, got, rtol=0, atol=0)


def test_errors():
    q, k, v = _t(*_arrays([(3, 16, 8), (2, 16, 8), (2, 16, 8)]))
    with pytest.raises(ValueError, match="not a multiple"):
        T.flash_attention(q, k, v, device="cpu")
    q, k, v = _t(*_qkv(2, 2, 16, 8))
    # Two devices now run the sharded schedules: the same attention.
    want = T.flash_attention(q, k, v, device="cpu")
    for fn in (T.ring_attention, T.ulysses_attention):
        _close(fn(q, k, v, devices=2, device="cpu"), want, 1e-5)
    with pytest.raises(ValueError, match="unknown ring layout"):
        T.ring_attention(q, k, v, layout="striped", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        T.flash_attention(q, k, v, device="cpu", engine="jnp")


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run(
        [sys.executable, "-m", "mpi_and_open_mp_tpu_torch.apps.attention",
         *argv], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)


def test_cli_flash_grad_on_cpu():
    res = _cli("--device", "cpu", "--variant", "flash", "--seq", "640",
               "--heads", "2", "--head-dim", "16", "--causal", "--grad")
    assert res.returncode == 0, res.stderr
    assert len(res.stdout.strip().splitlines()) == 1
    float(res.stdout)
    assert "parity ok" in res.stderr
    assert "engine=plain tflops=" in res.stderr


def test_cli_refuses_more_devices():
    """``--devices 2`` runs a ring of two virtual shards; more shards than
    ``--virtual-devices`` are refused with the JAX CLI's text."""
    res = _cli("--device", "cpu", "--devices", "2", "--seq", "64")
    assert res.returncode == 0, res.stderr
    assert "parity ok" in res.stderr and " devices=2 " in res.stderr
    res = _cli("--device", "cpu", "--devices", "4", "--virtual-devices", "2",
               "--seq", "64")
    assert res.returncode == 1
    assert res.stderr.strip().splitlines()[-1] == (
        "ValueError: Number of devices 2 must be >= the product of "
        "mesh_shape (4,)")


def test_cli_forward_checks_the_timed_output(tmp_path, monkeypatch, capsys):
    """In forward mode both CLIs check the timed output: under
    ``MOMP_TRACE`` each writes 2 ``ring_attention`` spans (the warm-up and
    the timed call), the port no third for its parity check. The JAX CLI
    runs in this process through its own ``main``."""
    from mpi_and_open_mp_tpu.apps import attention as japp
    from mpi_and_open_mp_tpu.obs import trace as jtrace
    from mpi_and_open_mp_tpu_torch.apps import attention as tapp
    from mpi_and_open_mp_tpu_torch.obs import report
    from mpi_and_open_mp_tpu_torch.obs import trace as ttrace

    argv = ["--variant", "ring", "--devices", "4", "--seq", "256",
            "--heads", "2", "--head-dim", "64", "--causal"]
    spans = {}
    for name, main, tracer, extra in (
            ("jax", japp.main, jtrace, []),
            ("port", tapp.main, ttrace, ["--device", "cpu"])):
        path = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("MOMP_TRACE", str(path))
        tracer.reset()
        try:
            assert main(argv + extra) == 0
        finally:
            monkeypatch.delenv("MOMP_TRACE")
            tracer.reset()
        assert "parity ok" in capsys.readouterr().err
        spans[name] = [r["name"] for r in report.load(str(path))].count(
            "ring_attention")
    assert spans == {"jax": 2, "port": 2}
