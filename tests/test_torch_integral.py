"""The port's quadrature (``ops/quadrature.py``, ``models/integral.py``)
against the JAX package's on the CPU, and a replay of the kernel's order
of operations (``csrc/quadrature.cu``) against JAX's chunk sums.

Both packages run the same algorithm (chunks of 2^17 points, masked tail,
half weight at the global ends, Kahan over each shard's chunks in chunk
order, a float32 sum of the shard partials). Their float32 sums are taken
in other orders (XLA's reduction, torch's, the kernel's tree), so results
are held to the JAX package's own 2e-6 relative (``tests/test_integral.py``)
and single chunk sums to 1e-6.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_and_open_mp_tpu.models.integral import Integral as JaxIntegral
from mpi_and_open_mp_tpu.ops import quadrature as jq
from mpi_and_open_mp_tpu.parallel import mesh as jax_mesh
from mpi_and_open_mp_tpu_torch.models.integral import Integral
from mpi_and_open_mp_tpu_torch.ops import native_quadrature as nq
from mpi_and_open_mp_tpu_torch.ops import quadrature as q
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib

PI = math.pi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The Kahan loop is many small torch operations: one torch thread
    beside the other test processes of a parallel run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax(n, p, **kw):
    return JaxIntegral(n, mesh=jax_mesh.make_mesh_1d(p, axis="i"),
                       **kw).compute()


def _port(n, p, **kw):
    integral = Integral(n, mesh=mesh_lib.make_mesh_1d(p, device="cpu"), **kw)
    return integral.compute(), integral


@pytest.mark.parametrize("p", [1, 8])
@pytest.mark.parametrize("n", [10, 1000, 12_345, 131_072, 131_073, 999_983])
def test_integral_matches_jax(n, p):
    got, integral = _port(n, p)
    assert integral.engine == "plain"
    assert got == pytest.approx(_jax(n, p), rel=2e-6)


def test_large_n_matches_jax_and_pi():
    """At 10^8 (96 chunks a shard on 8) Kahan keeps the sum at float32
    noise, in both packages."""
    got, _ = _port(10**8, 8)
    assert got == pytest.approx(_jax(10**8, 8), rel=2e-6)
    assert abs(got - PI) < 2e-5


@pytest.mark.parametrize("n", [131_072, 131_073])
def test_chunk_sums_match_jax_block_sum(n):
    """Chunk 0 and the last chunk (which holds only point n when n is a
    multiple of CHUNK) against JAX's ``_block_sum``."""
    h = 2.0 / n
    _, last_chunk, _ = q._chunk_grid(n)
    for g in (0, last_chunk):
        want = float(jq._block_sum(jq.f_circle, 0.0, h, jnp.int32(g), n))
        got = float(q._block_sum(q.f_circle, 0.0, h,
                                 torch.tensor([g], dtype=torch.int64), n)[0])
        assert got == pytest.approx(want, rel=1e-6), (n, g)


def test_more_shards_than_chunks():
    """Shards past the last chunk add 0.0 through their compensation: the
    partials of shards 1..7 are 0 and the total is the serial one."""
    n = 1000  # one chunk
    sums = q.chunk_sums(q.f_circle, 0.0, 2.0, n)
    partials = q.kahan_shards(sums, 8)
    assert partials.shape == (8,)
    assert torch.equal(partials[1:], torch.zeros(7))
    got, _ = _port(n, 8)
    assert got == _port(n, 1)[0]
    assert got == pytest.approx(_jax(n, 8), rel=2e-6)


def test_large_n_int64_no_truncation():
    n = (1 << 32) + 7
    integral = Integral(n, device="cpu")
    assert integral.n == n and isinstance(integral.n, int)
    n_chunks, last_chunk, last_lane = q._chunk_grid(10**12)
    assert (n_chunks, last_chunk, last_lane) == (7629395, 7629394, 69632)


def test_invalid_n():
    with pytest.raises(ValueError, match="at least one trapezoid"):
        Integral(0, device="cpu")


def test_custom_integrand_runs_the_plain_version():
    """A caller's own torch callable runs the plain version, whatever the
    device: only ``f_circle`` has a kernel."""
    got, integral = _port(100_000, 8, a=0.0, b=1.0, f=lambda x: x * x)
    assert integral.engine == "plain"
    want = _jax(100_000, 8, a=0.0, b=1.0, f=lambda x: x * x)
    assert got == pytest.approx(want, rel=2e-6)
    assert got == pytest.approx(1.0 / 3.0, abs=1e-5)


def test_wrapper_on_cpu_is_the_plain_version_and_refuses_what_the_kernel_does():
    n, p = 999_983, 8
    got = nq.trapezoid_circle(0.0, 2.0, n, p, "cpu")
    want = q.trapezoid_shard_sum(q.f_circle, 0.0, 2.0, n, p, "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        nq.launch(0.0, 2.0, n, p, torch.device("cpu"))
    with pytest.raises(ValueError, match="shards outside"):
        nq.trapezoid_circle(0.0, 2.0, n, nq.MAX_SHARDS + 1, "cpu")
    with pytest.raises(ValueError, match="chunks"):
        nq._check(q.CHUNK * nq.MAX_CHUNKS, 1)
    assert nq._check(10**12, 8) == (7629395, 7629394, 69632, 953675)


# ------------------------------------------------ the kernel's order, replayed

THREADS, SUMS, GROUP = 256, 8, 8


def _f32(x):
    return np.float32(x)


def _tree8(v):
    """((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7)) in float32."""
    return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]))


def _block_tree(s: np.ndarray) -> np.float32:
    """csrc/quadrature.cu:block_sum over the block's 256 per-thread sums:
    a butterfly of shuffles in each warp, then lane 0 of each of the 8
    warps into a butterfly of 8 in warp 0."""
    s = s.astype(np.float32).reshape(THREADS // 32, 32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, lanes ^ o]
    red = s[:, 0].copy()
    for o in (4, 2, 1):
        red = red + red[np.arange(8) ^ o]
    return red[0]


def _kernel_chunk_sum(a, h, g, n):
    """The float32 sum that quadrature_chunk_kernel writes for chunk g, in
    the kernel's order (``thread_sum``): each thread's lanes tid + 256 k in
    8 trips of 8 groups of 8 points, a group summed as a tree and added to
    running sum u, then a tree over the 8 sums and the block's tree. On
    the first and the last chunk a point is weighted 0 past point n and
    0.5 at the global ends."""
    _, last_chunk, last_lane = q._chunk_grid(n)
    a32, h32, ch32 = _f32(a), _f32(h), _f32(q.CHUNK * h)
    base = _f32(a32 + _f32(_f32(g) * ch32))
    edge = g == 0 or g == last_chunk
    tid = np.arange(THREADS)
    acc = np.zeros((SUMS, THREADS), np.float32)
    k = 0
    for _ in range(q.CHUNK // (THREADS * SUMS * GROUP)):
        for u in range(SUMS):
            ys = []
            for _ in range(GROUP):
                r = tid + THREADS * k
                x = base + r.astype(np.float32) * h32
                v = np.maximum(_f32(4.0) - x * x, _f32(0.0))
                y = np.sqrt(v)
                if edge:
                    w = np.where((g == last_chunk) & (r > last_lane), 0.0,
                                 np.where(((g == 0) & (r == 0))
                                          | ((g == last_chunk)
                                             & (r == last_lane)), 0.5, 1.0))
                    y = w.astype(np.float32) * y
                ys.append(y.astype(np.float32))
                k += 1
            acc[u] = acc[u] + _tree8(ys)
    return _block_tree(_tree8(acc))


@pytest.mark.parametrize("n,g", [
    (131_072, 0), (131_072, 1),        # chunk 0; the last holds point n only
    (131_073, 1),                      # the last chunk, two points
    (1000, 0),                         # n < CHUNK: the one chunk is both ends
    (10**12, 0), (10**12, 3_000_000),  # the reference's N: an interior chunk
    (10**12, 7_629_394),               # and its last
])
def test_kernel_chunk_order_matches_jax(n, g):
    h = 2.0 / n
    want = float(jq._block_sum(jq.f_circle, 0.0, h, jnp.int32(g), n))
    got = float(_kernel_chunk_sum(0.0, h, g, n))
    if want == 0.0:
        assert got == 0.0
    else:
        assert got == pytest.approx(want, rel=1e-6)


def test_kernel_replay_total_matches_jax():
    """Every chunk in the kernel's order, then the Kahan pass and the
    shard sum as the plain version runs them (the kernel's pass 2 is that
    order), at 3 chunks over 2 shards."""
    n, p = 3 * q.CHUNK - 5, 2
    h = 2.0 / n
    sums = torch.tensor([_kernel_chunk_sum(0.0, h, g, n) for g in range(3)])
    partials = q.kahan_shards(sums, p)
    got = float((partials[0] + partials[1]) * torch.tensor(_f32(h)))
    assert got == pytest.approx(_jax(n, p), rel=2e-6)
