"""The port's ring (contiguous and zigzag) and Ulysses attention on virtual
shards of one device, held against the JAX package's 8-device CPU mesh.

The same numpy arrays, made from a seed, go through both packages. The JAX
side runs ``ring_attention``/``ulysses_attention`` on
``make_mesh_1d(p, axis="sp")`` of the conftest's 8 CPU devices: its jnp
fold (its interpret-mode Pallas path is red on the installed JAX, ROADMAP
Queue 3). The port runs ``device="cpu"`` with p in {2, 4, 8}, where the
hop schedule the card runs takes the kernels' plain per-hop versions
(``flash_fwd_plain``, ``hop_block_grads_plain``), so tier-1 holds the
decomposition the card launches; ``engine="plain"`` runs the plain fold.
Gradients come through ``torch.autograd`` with a seeded cotangent.

Tolerances. float32: 2e-5 absolute and relative against JAX on the
forward, 5e-5 on the gradients. bfloat16: PERF.md section 2's rule, ``|got
- want| <= 2 s |want| + 1e-3 r + 1e-6 m`` (``s = 2^-7``, ``r`` the row's
largest ``|want|``, ``m`` the tensor's), for every result of one bf16
rounding: the plain fold's output and gradients against JAX's, Ulysses',
and the hop schedule's gradients against the JAX package's single-device
flash backward given the port's own forward output. The hop schedule's
forward rounds each hop's normalised partial to bf16 before the merge (the
kernel writes ``o`` in its operands' dtype, as JAX's bundled kernel does on
a TPU), which the one-rounding rule misses by up to ~3.6x; it is held to
the rule plus one bf16 spacing of ``M = sum_j w_j |o_j|``, the merged
magnitudes of its partials (a rounding moves each by at most half a
spacing), computed apart from the schedule under test from the dense
softmax and the ring's key blocks (``ring_partial_magnitude``, which
``chip_smoke.py`` uses too).
"""

import contextlib
import io
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_and_open_mp_tpu.parallel import context as J
from mpi_and_open_mp_tpu.parallel import mesh as JM
from mpi_and_open_mp_tpu_torch.apps import attention as attention_app
from mpi_and_open_mp_tpu_torch.ops import flash_hop_bwd as fb
from mpi_and_open_mp_tpu_torch.ops import native_flash as nf
from mpi_and_open_mp_tpu_torch.parallel import context as T
from mpi_and_open_mp_tpu_torch.parallel import halo
from mpi_and_open_mp_tpu_torch.robust import chaos, guards

F32_FWD, F32_GRAD = 2e-5, 5e-5
BF16_SPACING = 2.0 ** -7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small torch operations: one thread, beside the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def small_chunks(monkeypatch):
    """Shrink ``_Q_CHUNK`` in both packages (a trace-time value in JAX,
    whose caches are cleared around it)."""

    def set_chunk(n):
        monkeypatch.setattr(J, "_Q_CHUNK", n)
        monkeypatch.setattr(T, "_Q_CHUNK", n)
        jax.clear_caches()

    yield set_chunk
    jax.clear_caches()


@pytest.fixture
def chaos_env(monkeypatch):
    """Set ``MOMP_CHAOS`` for the test; the plan and the recovery log are
    dropped before and after."""

    def arm(spec):
        monkeypatch.setenv(chaos.ENV, spec)
        chaos.reset()
        guards.reset_recovery_log()

    yield arm
    monkeypatch.delenv(chaos.ENV, raising=False)
    chaos.reset()
    guards.reset_recovery_log()


def _arrays(h, hkv, n, d, seed, batch=()):
    rng = np.random.default_rng(seed)
    shapes = [(*batch, h, n, d), (*batch, hkv, n, d), (*batch, hkv, n, d),
              (*batch, h, n, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_run(p, q, k, v, do, *, causal, layout="contiguous",
             variant="ring"):
    """JAX output and (q, k, v) gradients (float32 numpy) of the sharded
    variant on its CPU mesh of ``p`` devices."""
    mesh = JM.make_mesh_1d(p, axis=J.AXIS_SP)
    if variant == "ring":
        def fn(a, b, c):
            return J.ring_attention(a, b, c, mesh=mesh, causal=causal,
                                    layout=layout)
    else:
        def fn(a, b, c):
            return J.ulysses_attention(a, b, c, mesh=mesh, causal=causal)
    o, vjp = jax.vjp(fn, q, k, v)
    return (np.asarray(o.astype(jnp.float32)),
            [np.asarray(g.astype(jnp.float32)) for g in vjp(do)])


def _port_run(fn, q, k, v, do, **kw):
    """Port output and (q, k, v) gradients through autograd."""
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fn(*qkv, device="cpu", **kw)
    return o.detach(), torch.autograd.grad(o, qkv, do)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _bf16_rule(got, want, extra=0.0, what=""):
    """PERF.md section 2's bf16 rule, plus ``extra`` (the module
    docstring)."""
    g, w = _f32(got), _f32(want)
    a = np.abs(w)
    limit = (2 * BF16_SPACING * a + 1e-3 * a.max(-1, keepdims=True)
             + 1e-6 * a.max() + extra)
    share = float((np.abs(g - w) / limit).max())
    assert np.isfinite(g).all() and share <= 1, f"{what}: {share:.3g} of " \
        "the limit"


def _magnitude_run(monkeypatch, q, k, v, **kw):
    """The hop schedule on these operands (as float32) with every hop's
    partial replaced by its magnitude, the merge weights unchanged: the
    schedule's own ``sum_j w_j |o_j|``."""
    real = nf.flash_fwd

    def magnitude(*args):
        o, L = real(*args)
        return o.abs(), L

    with monkeypatch.context() as m:
        m.setattr(nf, "flash_fwd", magnitude)
        return T.ring_attention(q.float(), k.float(), v.float(),
                                device="cpu", **kw).numpy()


def _zz(x, p, layout):
    return x if layout != "zigzag" else np.array(J.zigzag_shard(x, p))


RING_F32 = [
    # p, layout, causal, h, hkv, n, d
    (2, "contiguous", True, 4, 4, 128, 16),
    (4, "contiguous", False, 4, 4, 128, 16),
    (8, "contiguous", True, 4, 4, 256, 16),
    (2, "zigzag", True, 4, 4, 128, 16),
    (4, "zigzag", False, 4, 4, 128, 16),
    (8, "zigzag", True, 4, 4, 128, 16),
    (4, "contiguous", True, 8, 2, 128, 16),   # GQA 8q/2kv
    (8, "zigzag", True, 8, 2, 128, 16),
    (4, "contiguous", True, 4, 1, 128, 16),   # MQA
    (4, "zigzag", True, 4, 1, 128, 16),
]


@pytest.mark.parametrize("p,layout,causal,h,hkv,n,d", RING_F32)
def test_ring_matches_jax(p, layout, causal, h, hkv, n, d):
    """Both engines, the hop schedule and the plain fold, against the JAX
    fold: forward and (q, k, v) gradients, float32."""
    q, k, v, do = _arrays(h, hkv, n, d, seed=p * 100 + n + hkv)
    q, k, v = (_zz(x, p, layout) for x in (q, k, v))
    want_o, want_g = _jax_run(p, *map(jnp.asarray, (q, k, v, do)),
                              causal=causal, layout=layout)
    for engine in ("auto", "plain"):
        o, grads = _port_run(T.ring_attention, *map(torch.from_numpy,
                                                    (q, k, v, do)),
                             devices=p, causal=causal, layout=layout,
                             engine=engine)
        _close(o, want_o, F32_FWD)
        for a, b in zip(grads, want_g):
            _close(a, b, F32_GRAD)


@pytest.mark.parametrize("layout,chunk", [("contiguous", 16),
                                          ("zigzag", 24)])
def test_ring_chunked_shards_match_jax(small_chunks, layout, chunk):
    """Local shards longer than the q chunk (24 leaves a padded last
    chunk): both packages' folds and the port's hop schedule chunk."""
    small_chunks(chunk)
    p, n = 4, 256
    q, k, v, do = _arrays(4, 2, n, 16, seed=31)
    q, k, v = (_zz(x, p, layout) for x in (q, k, v))
    want_o, want_g = _jax_run(p, *map(jnp.asarray, (q, k, v, do)),
                              causal=True, layout=layout)
    for engine in ("auto", "plain"):
        o, grads = _port_run(T.ring_attention, *map(torch.from_numpy,
                                                    (q, k, v, do)),
                             devices=p, causal=True, layout=layout,
                             engine=engine)
        _close(o, want_o, F32_FWD)
        for a, b in zip(grads, want_g):
            _close(a, b, F32_GRAD)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_ring_batched_matches_jax(layout):
    """4-D (B, h, n, d) operands: B requests in one ring trip."""
    p = 4
    q, k, v, do = _arrays(2, 1, 128, 16, seed=41, batch=(2,))
    if layout == "zigzag":
        q, k, v = (np.stack([np.array(J.zigzag_shard(x[b], p))
                             for b in range(2)])
                   for x in (q, k, v))
    want_o, want_g = _jax_run(p, *map(jnp.asarray, (q, k, v, do)),
                              causal=True, layout=layout)
    o, grads = _port_run(T.ring_attention, *map(torch.from_numpy,
                                                (q, k, v, do)),
                         devices=p, causal=True, layout=layout)
    assert o.shape == q.shape
    _close(o, want_o, F32_FWD)
    for a, b in zip(grads, want_g):
        _close(a, b, F32_GRAD)


@pytest.mark.parametrize("p,layout,causal,hkv", [
    (4, "contiguous", True, 2), (4, "zigzag", True, 4),
    (2, "contiguous", False, 1)])
def test_ring_bf16_matches_jax(p, layout, causal, hkv):
    """bfloat16 operands (the module docstring's rules): the plain fold's
    output and gradients against JAX's under PERF.md section 2's rule; the
    hop schedule's output under the rule plus one spacing of its partials'
    merged magnitude, its gradients under the rule against JAX's
    single-device backward given the port's output."""
    h, n, d = 4, 256, 32
    q, k, v, do = _arrays(h, hkv, n, d, seed=50 + p)
    q, k, v = (_zz(x, p, layout) for x in (q, k, v))
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    kw = dict(devices=p, causal=causal, layout=layout)
    want_o, want_g = _jax_run(p, *jb, causal=causal, layout=layout)
    o, grads = _port_run(T.ring_attention, *tb, engine="plain", **kw)
    _bf16_rule(o, want_o, what="plain o")
    for what, a, b in zip("qkv", grads, want_g):
        _bf16_rule(a, b, what=f"plain d{what}")

    o, grads = _port_run(T.ring_attention, *tb, **kw)
    M = T.ring_partial_magnitude(*tb[:3], p, causal, layout).numpy()
    _bf16_rule(o, want_o, BF16_SPACING * M, what="hop o")

    def natural(x):
        x = jnp.asarray(_f32(x), jnp.bfloat16)
        return x if layout != "zigzag" else J.zigzag_unshard(x, p)

    qn, kn, vn = (natural(x) for x in tb[:3])
    _, L = J._flash_forward(causal, qn, kn, vn)
    want = J._flash_chunked_bwd(causal, (qn, kn, vn, natural(o), L),
                                natural(tb[3]))
    for what, a, b in zip("qkv", grads, want):
        _bf16_rule(natural(a), b, what=f"hop d{what}")


@pytest.mark.parametrize("p,layout,causal", [
    (4, "contiguous", True), (8, "zigzag", True), (4, "zigzag", False),
    (2, "contiguous", False)])
def test_partial_magnitude_matches_the_hop_partials(monkeypatch, p, layout,
                                                    causal):
    """``ring_partial_magnitude`` (the dense softmax over the ring's key
    blocks) equals the hop schedule's own merged partial magnitudes, GQA
    operands, with rows in slices that do not divide the sequence."""
    q, k, v, _ = map(torch.from_numpy, _arrays(4, 2, 128, 16, seed=57 + p))
    got = T.ring_partial_magnitude(q, k, v, p, causal, layout, rows=48)
    want = _magnitude_run(monkeypatch, q, k, v, devices=p, causal=causal,
                          layout=layout)
    _close(got, want, F32_FWD)


@pytest.mark.parametrize("p,causal,h,hkv,dtype", [
    (4, True, 8, 4, "float32"),   # kv heads split over the shards
    (4, True, 8, 2, "float32"),   # they do not: expanded pre-wire
    (2, False, 4, 1, "float32"),  # MQA
    (8, True, 8, 8, "float32"),
    (4, True, 4, 4, "bfloat16"),
])
def test_ulysses_matches_jax(p, causal, h, hkv, dtype):
    n = 640 if p == 8 else 128  # 640: the local engine's chunked path
    q, k, v, do = _arrays(h, hkv, n, 16, seed=60 + p + hkv)
    if dtype == "float32":
        want_o, want_g = _jax_run(p, *map(jnp.asarray, (q, k, v, do)),
                                  causal=causal, variant="ulysses")
        o, grads = _port_run(T.ulysses_attention, *map(torch.from_numpy,
                                                       (q, k, v, do)),
                             devices=p, causal=causal)
        _close(o, want_o, F32_FWD)
        for a, b in zip(grads, want_g):
            _close(a, b, F32_GRAD)
        return
    want_o, want_g = _jax_run(
        p, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)),
        causal=causal, variant="ulysses")
    o, grads = _port_run(T.ulysses_attention, *(
        torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)),
        devices=p, causal=causal)
    _bf16_rule(o, want_o, what="o")
    for what, a, b in zip("qkv", grads, want_g):
        _bf16_rule(a, b, what=f"d{what}")


@pytest.mark.parametrize("layout,causal", [("contiguous", True),
                                           ("zigzag", True),
                                           ("contiguous", False)])
def test_ring_hop_kill_switch_matches_hop_schedule(monkeypatch, layout,
                                                   causal):
    """``engine="plain"``, the ring's one switch to the plain fold, folds
    both directions and agrees with the hop schedule."""
    p = 4
    q, k, v, do = map(torch.from_numpy, _arrays(4, 2, 128, 16, seed=70))
    kw = dict(devices=p, causal=causal, layout=layout)
    o, grads = _port_run(T.ring_attention, q, k, v, do, **kw)
    assert T.ring_hop_engine_for(q, k, v, p=p, causal=causal,
                                 layout=layout).startswith("cpu:")
    assert T.ring_hop_engine_for(q, k, v, p=p, causal=causal, layout=layout,
                                 engine="plain") == "plain"
    assert T.ring_hop_bwd_engine_for(q, k, v, p=p, causal=causal,
                                     layout=layout, engine="plain") == "plain"
    calls = _counting(monkeypatch)
    fo, fgrads = _port_run(T.ring_attention, q, k, v, do, engine="plain",
                           **kw)
    assert calls == {"flash_fwd": 0, "hop_block_grads": 0}
    _close(fo, o, F32_FWD)
    for a, b in zip(fgrads, grads):
        _close(a, b, F32_GRAD)


def _counting(monkeypatch):
    """Count the per-hop engines' calls: ``flash_fwd`` and
    ``hop_block_grads`` (the two backward kernels together)."""
    calls = {"flash_fwd": 0, "hop_block_grads": 0}
    for mod, name in ((nf, "flash_fwd"), (fb, "hop_block_grads")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("p,layout,causal,want", [
    (4, "contiguous", True, (4, 4)),
    (4, "contiguous", False, (4, 4)),
    (4, "zigzag", True, (12, 0)),     # 3 half-chunk launches a hop, fold
    (4, "zigzag", False, (4, 4)),
])
def test_ring_launches_per_hop_engine(monkeypatch, p, layout, causal, want):
    """A ring call's per-hop engine calls: one forward launch a hop (three
    half-chunk launches under causal zigzag) and one dq, dk/dv pair a hop
    in the backward (none under causal zigzag, which folds); the plain
    engine none."""
    calls = _counting(monkeypatch)
    q, k, v, do = map(torch.from_numpy, _arrays(4, 2, 128, 16, seed=80))
    kw = dict(devices=p, causal=causal, layout=layout)
    _port_run(T.ring_attention, q, k, v, do, **kw)
    assert (calls["flash_fwd"], calls["hop_block_grads"]) == want
    calls.update(flash_fwd=0, hop_block_grads=0)
    _port_run(T.ring_attention, q, k, v, do, engine="plain", **kw)
    assert calls == {"flash_fwd": 0, "hop_block_grads": 0}


def test_ring_prefetch_starts_the_same_rotations(monkeypatch):
    """``_ring_trip`` starts p - 1 rotations, hop j + 1's before hop j
    folds (the JAX package's single-slot order; its two-slot prefetch only
    reorders issue points, which one card's one stream does not overlap),
    and hands hop j the blocks rolled j places."""
    p = 5
    x = torch.arange(p * 3.0).reshape(p, 3)
    started = []
    real = halo.ppermute

    def traced(t, axis, shift):
        started.append(len(trace))
        return real(t, axis, shift)

    monkeypatch.setattr(halo, "ppermute", traced)
    trace = []
    for j, (blk,) in T._ring_trip((x,), p):
        torch.testing.assert_close(blk, torch.roll(x, j, 0))
        trace.append(j)
    # started[i]: how many hops had folded when rotation i + 1 left.
    assert started == [0, 1, 2, 3] and trace == list(range(p))


def test_ring_positions_match_jax():
    rows = np.arange(8)
    for layout in ("contiguous", "zigzag"):
        for dev in range(4):
            got = T._ring_positions(layout, dev, 4, 8, torch.from_numpy(rows))
            want = J._ring_positions(layout, dev, 4, 8, jnp.asarray(rows))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fake(shape, dtype=torch.bfloat16, device="cuda"):
    """An operand's device, dtype and shape, without a card."""
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 shape=shape, dim=lambda: len(shape))


def test_provenance_stamps():
    q, k, v, _ = map(torch.from_numpy, _arrays(8, 2, 128, 16, seed=90))
    stamp = T.ring_hop_engine_for
    bwd = T.ring_hop_bwd_engine_for
    assert stamp(q, k, v, p=4, causal=True) == "cpu:flash_fwd_plain:g4"
    assert stamp(q, k, v, p=2, causal=True) == "cpu:flash_fwd_plain:g4"
    assert (stamp(q, k, v, p=4, causal=True, layout="zigzag")
            == "cpu:flash_fwd_plain:g4:zz")
    assert stamp(q, k, v, p=4, causal=False, layout="zigzag") == (
        "cpu:flash_fwd_plain:g4")
    assert bwd(q, k, v, p=4, causal=True) == "cpu:hop_block_grads_plain:g4"
    assert bwd(q, k, v, p=4, causal=True, layout="zigzag") == "plain"
    assert stamp(q, k, v, p=4, engine="plain") == "plain"
    assert stamp(q, k, v, p=1) == "local:dense"
    assert stamp(q, k, v) == "local:dense"
    q4, k4, v4 = (x[None].expand(3, *x.shape) for x in (q, k, v))
    assert stamp(q4, k4, v4, p=4) == "cpu:flash_fwd_plain:g4:b3"
    assert bwd(q4, k4, v4, p=4) == "cpu:hop_block_grads_plain:g4:b3"
    # On the card: the kernels' own eligibility (dtype, head width).
    cq, ck = _fake((8, 32768, 128)), _fake((2, 32768, 128))
    assert stamp(cq, ck, ck, p=8) == "cuda:flash_fwd:b64:g4"
    assert (stamp(cq, ck, ck, p=8, layout="zigzag")
            == "cuda:flash_fwd:b64:g4:zz")
    assert bwd(cq, cq, cq, p=8) == "cuda:flash_hop_bwd:b64"
    assert bwd(cq, cq, cq, p=8, layout="zigzag") == "plain"
    narrow = _fake((8, 4096, 32), torch.float32)
    assert stamp(narrow, narrow, narrow, p=8) == "plain"
    half = _fake((8, 4096, 128), torch.float16)
    assert bwd(half, half, half, p=8) == "plain"


def _raised(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


@pytest.mark.parametrize("case", [
    "seq", "gqa", "kv", "layout", "zigzag", "batch", "ulysses_heads",
    "ulysses_seq"])
def test_errors_match_jax(case):
    """Every validation error, word for word the JAX package's."""
    p = 8
    mesh = JM.make_mesh_1d(p, axis=J.AXIS_SP)
    shapes = {"seq": ((2, 100, 8), (2, 100, 8)),
              "gqa": ((3, 64, 8), (2, 64, 8)),
              "kv": ((2, 64, 8), (2, 64, 8), (1, 64, 8)),
              "layout": ((2, 64, 8), (2, 64, 8)),
              "zigzag": ((2, 24, 8), (2, 24, 8)),
              "batch": ((2, 2, 64, 8), (3, 2, 64, 8)),
              "ulysses_heads": ((3, 64, 8), (3, 64, 8)),
              "ulysses_seq": ((8, 100, 8), (8, 100, 8))}[case]
    qs, ks, vs = (*shapes, shapes[-1])[:3]
    q, k, v = (np.zeros(s, np.float32) for s in (qs, ks, vs))
    layout = {"layout": "striped", "zigzag": "zigzag"}.get(case,
                                                           "contiguous")
    if case.startswith("ulysses"):
        want = _raised(lambda: J.ulysses_attention(
            *map(jnp.asarray, (q, k, v)), mesh=mesh))
        got = _raised(lambda: T.ulysses_attention(
            *map(torch.from_numpy, (q, k, v)), devices=p, device="cpu"))
    else:
        want = _raised(lambda: J.ring_attention(
            *map(jnp.asarray, (q, k, v)), mesh=mesh, layout=layout))
        got = _raised(lambda: T.ring_attention(
            *map(torch.from_numpy, (q, k, v)), devices=p, layout=layout,
            device="cpu"))
    assert got == want


def test_mesh_argument():
    """``mesh=`` (an ``sp`` mesh of virtual shards) and ``devices=`` are
    the same ring; passing both is refused."""
    from mpi_and_open_mp_tpu_torch.parallel import mesh as pm

    q, k, v, _ = map(torch.from_numpy, _arrays(4, 2, 128, 16, seed=95))
    mesh = pm.make_mesh_1d(4, axis="sp", device="cpu", virtual=True)
    a = T.ring_attention(q, k, v, mesh=mesh, causal=True)
    b = T.ring_attention(q, k, v, devices=4, causal=True, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not both"):
        T.ring_attention(q, k, v, devices=4, mesh=mesh)


def test_all_to_all_round_trip():
    """``halo.all_to_all`` as ``lax.all_to_all(tiled=True)``: shard i's
    block j lands on shard j at the sender's place; back again."""
    p, h, nl, d = 4, 8, 3, 2
    x = torch.arange(p * h * nl * d).reshape(p, h, nl, d)
    y = halo.all_to_all(x, 0, 1)
    assert y.shape == (p, h // p, p * nl, d)
    for j in range(p):
        for s in range(p):
            torch.testing.assert_close(
                y[j, :, s * nl:(s + 1) * nl], x[s, j * 2:(j + 1) * 2])
    torch.testing.assert_close(halo.all_to_all(y, 1, 0), x)


@pytest.mark.parametrize("spec", ["nan_hop=3", "inf_hop=1"])
@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
def test_chaos_hop_poison(chaos_env, spec, layout):
    """A planned hop poisoned: under the guard the call recovers on the
    clean re-run of the same hop engine (stamped with its name and logged,
    output and gradients clean); with ``noguard`` the fault reaches the
    output."""
    q, k, v, do = map(torch.from_numpy, _arrays(4, 2, 128, 16, seed=99))
    kw = dict(devices=4, causal=True, layout=layout)
    clean, clean_g = _port_run(T.ring_attention, q, k, v, do, **kw)
    chaos_env(spec)
    o, grads = _port_run(T.ring_attention, q, k, v, do, **kw)
    zz = ":zz" if layout == "zigzag" else ""
    assert guards.recovery_log() == [
        f"ring_attention:cpu:flash_fwd_plain:g2{zz}:recovered"]
    _close(o, clean, F32_FWD)
    for a, b in zip(grads, clean_g):
        _close(a, b, F32_GRAD)
    chaos_env(spec + ";noguard")
    with torch.no_grad():
        o = T.ring_attention(q, k, v, device="cpu", **kw)
    assert not torch.isfinite(o).all()
    assert guards.recovery_log() == []


def test_guard_folds_only_on_the_cpu(monkeypatch):
    """A hop engine that still diverges on its clean re-run: operands on
    the CPU recover on the plain fold (``ring_attention:plain:recovered``);
    on the card the guard raises ``FallbackExhausted`` and never runs the
    plain version."""
    real = nf.flash_fwd

    def poisoned(*args):
        o, L = real(*args)
        return torch.full_like(o, math.nan), L

    monkeypatch.setenv("MOMP_GUARD", "1")
    guards.reset_recovery_log()
    q, k, v, _ = map(torch.from_numpy, _arrays(4, 2, 128, 16, seed=13))
    want = T.ring_attention(q, k, v, devices=4, causal=True, device="cpu",
                            engine="plain")
    monkeypatch.setattr(nf, "flash_fwd", poisoned)
    got = T.ring_attention(q, k, v, devices=4, causal=True, device="cpu")
    assert guards.recovery_log() == ["ring_attention:plain:recovered"]
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    guards.reset_recovery_log()
    folds = []

    def on_card(fold=False):
        folds.append(fold)
        return torch.full((2,), math.nan)

    with pytest.raises(guards.FallbackExhausted):
        T._guarded_ring(on_card, "ring_attention:cuda:flash_fwd:b64", True)
    assert folds == [False, False] and guards.recovery_log() == []


def test_guard_does_not_hide_a_raise(chaos_env, monkeypatch):
    """An exception in the hop engine (a build or launch error on the
    card) is raised, not recovered on the fold."""
    def broken(*a, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(nf, "flash_fwd", broken)
    chaos_env("nan_hop=3")
    q, k, v, _ = map(torch.from_numpy, _arrays(4, 2, 128, 16, seed=7))
    with pytest.raises(RuntimeError, match="launch failed"):
        T.ring_attention(q, k, v, devices=4, causal=True, device="cpu")
    assert guards.recovery_log() == []


def _cli(*argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = attention_app.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("extra,engine", [
    ((), "engine=cpu:flash_fwd_plain "
         "bwd_engine=cpu:hop_block_grads_plain"),
    (("--ring-layout", "zigzag"), "engine=cpu:flash_fwd_plain:zz "
                                  "bwd_engine=plain"),
    (("--variant", "ulysses"), "engine=plain"),
], ids=["ring", "zigzag", "ulysses"])
def test_cli_sharded_on_cpu(extra, engine):
    rc, out, err = _cli("--devices", "4", "--device", "cpu", "--seq", "1024",
                        "--heads", "4", "--head-dim", "32", "--causal",
                        "--grad", *extra)
    assert rc == 0, err
    float(out)
    assert "parity ok" in err
    assert f"seq=1024 devices=4 {engine} tflops=" in err


def test_cli_virtual_devices_size_the_ring():
    rc, _, err = _cli("--virtual-devices", "2", "--device", "cpu", "--seq",
                      "64", "--heads", "2", "--head-dim", "16", "--dtype",
                      "float32")
    assert rc == 0 and "devices=2 " in err
    with pytest.raises(ValueError) as exc:
        _cli("--devices", "4", "--virtual-devices", "2", "--device", "cpu",
             "--seq", "64")
    assert str(exc.value) == ("Number of devices 2 must be >= the product of "
                              "mesh_shape (4,)")
    with pytest.raises(SystemExit):
        _cli("--variant", "flash", "--devices", "4", "--device", "cpu")


def test_ring_scale_is_the_head_width():
    """The ring's hops scale scores by 1/sqrt(d) of the head width, as the
    single-device engines (a d that is not a square)."""
    q, k, v, _ = map(torch.from_numpy, _arrays(2, 2, 64, 12, seed=3))
    got = T.ring_attention(q, k, v, devices=4, causal=True, device="cpu")
    s = torch.einsum("hqd,hkd->hqk", q, k) / math.sqrt(12)
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), -1e30)
    torch.testing.assert_close(got, torch.softmax(s, -1) @ v, rtol=1e-5,
                               atol=1e-5)
