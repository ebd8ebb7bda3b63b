"""Trapezoidal quadrature: the plain PyTorch version.

Counterpart of ``mpi_and_open_mp_tpu/ops/quadrature.py``. Reference:
``1-integral/integral.c``, ∫₀² √(4−x²) dx ≈ π by N trapezoids of width
h = 2/N (``integral.c:12-13``), partial sums per rank (``:50-53``) reduced
to the root by Send/Recv (``:39-43``).

The algorithm is the JAX package's. A grid point ``i ∈ [0, n]`` is ``(g,
r)``, global chunk ``g = i // CHUNK`` and lane ``r = i % CHUNK``; it
contributes ``w·f(x)`` with half weight at the two global endpoints and
abscissa ``x = (f32(a) + f32(g)·f32(CHUNK·h)) + f32(r)·f32(h)``, each factor
rounded to float32 on the host from the double, as ``jnp.float32(CHUNK *
h)`` is. Lanes past point n are masked. Each chunk has a float32 sum; the
chunks of a shard are accumulated with Kahan compensation in chunk order;
shard ``k`` of ``p`` owns the contiguous chunks ``[k·per, (k+1)·per)``,
``per = ceil(n_chunks / p)`` (past the last chunk a chunk adds 0.0 through
the compensation, as JAX's masked ``fori_loop`` does); the shard partials
are summed in float32 in shard order (JAX's ``lax.psum``) and multiplied by
``f32(h)``.

Here :func:`_block_sum` evaluates a batch of B chunks as one ``(B, CHUNK)``
tensor per torch operation, and the Kahan loop runs over the ``(p, per)``
chunk sums, one column (every shard at once) per step. The tests run it on
the CPU. On the card the integrand ``f_circle`` takes the hand-written
kernel (``ops/native_quadrature.py``); this version runs there only for a
caller's own ``f`` and in ``chip_smoke.py``'s comparison.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# Grid points of one chunk (the JAX package's CHUNK).
CHUNK = 1 << 17
# Chunks evaluated per torch operation: B x CHUNK float32 lanes (8 MB at 16).
BATCH_CHUNKS = 16


def f_circle(x: torch.Tensor) -> torch.Tensor:
    """The reference integrand √(4 − x²) (``integral.c:7``)."""
    return torch.sqrt(torch.clamp_min(4.0 - x * x, 0.0))


def _chunk_grid(n: int) -> tuple[int, int, int]:
    """``(n_chunks, last_chunk, last_lane)`` for grid points 0..n, in
    Python ints (no 32-bit wrap at n = 10^12)."""
    last_chunk = n // CHUNK  # the chunk holding point n
    last_lane = n % CHUNK
    return last_chunk + 1, last_chunk, last_lane


def _f32(x: float, device) -> torch.Tensor:
    """``x`` rounded to float32 on the host, as a 0-dim tensor."""
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)


def _block_sum(f: Callable, a: float, h: float, g: torch.Tensor,
               n: int) -> torch.Tensor:
    """Float32 weighted Σ f over the CHUNK points of each global chunk in
    ``g`` (int64, shape ``(B,)``), masking lanes past point ``n`` and
    half-weighting the global endpoints: shape ``(B,)`` on ``g``'s device."""
    _, last_chunk, last_lane = _chunk_grid(n)
    dev = g.device
    r = torch.arange(CHUNK, dtype=torch.int64, device=dev)
    gc = g[:, None]
    in_range = (gc < last_chunk) | ((gc == last_chunk) & (r <= last_lane))
    ends = ((gc == 0) & (r == 0)) | ((gc == last_chunk) & (r == last_lane))
    w = torch.where(ends, _f32(0.5, dev), _f32(1.0, dev))
    x = ((_f32(a, dev) + gc.to(torch.float32) * _f32(CHUNK * h, dev))
         + r.to(torch.float32) * _f32(h, dev))
    return torch.where(in_range, w * f(x), _f32(0.0, dev)).sum(dim=1)


def chunk_sums(f: Callable, a: float, b: float, n: int,
               device: str | torch.device = "cpu", lo: int = 0,
               hi: int | None = None) -> torch.Tensor:
    """Float32 sum of every chunk ``[lo, hi)`` (default: all of them),
    ``(hi - lo,)`` in chunk order."""
    h = (b - a) / n
    n_chunks, _, _ = _chunk_grid(n)
    hi = n_chunks if hi is None else min(hi, n_chunks)
    dev = torch.device(device)
    out = torch.empty(max(hi - lo, 0), dtype=torch.float32, device=dev)
    for g0 in range(lo, hi, BATCH_CHUNKS):
        g = torch.arange(g0, min(g0 + BATCH_CHUNKS, hi),
                         dtype=torch.int64, device=dev)
        out[g0 - lo:g0 - lo + len(g)] = _block_sum(f, a, h, g, n)
    return out


def kahan_shards(sums: torch.Tensor, shards: int,
                 per: int | None = None) -> torch.Tensor:
    """Each shard's Kahan-compensated float32 sum of its contiguous
    ``per`` chunk sums (default ``ceil(len(sums) / shards)``), in chunk
    order; chunks past the last add 0.0. Shape ``(shards,)``."""
    n_chunks = sums.numel()
    per = -(-n_chunks // shards) if per is None else per
    vals = torch.zeros(shards * per, dtype=torch.float32, device=sums.device)
    vals[:n_chunks] = sums
    vals = vals.view(shards, per)
    acc = torch.zeros(shards, dtype=torch.float32, device=sums.device)
    comp = torch.zeros_like(acc)
    for c in range(per):
        y = vals[:, c] - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc


def trapezoid_shard_sum(f: Callable, a: float, b: float, n: int,
                        shards: int,
                        device: str | torch.device = "cpu") -> torch.Tensor:
    """∫_a^b f by ``n`` trapezoids over ``shards`` shards of one device: the
    shard partials (:func:`kahan_shards`) summed in float32 in shard order,
    times ``f32(h)``. A 0-dim float32 tensor on ``device``."""
    return shard_total(chunk_sums(f, a, b, n, device), shards, (b - a) / n)


def shard_partials(f: Callable, a: float, b: float, n: int, shards: int,
                   first: int, count: int,
                   device: str | torch.device = "cpu") -> torch.Tensor:
    """The Kahan partials of shards ``[first, first + count)`` of
    ``shards``, float32 ``(count,)``: their chunks only, each shard's as in
    :func:`kahan_shards` of every chunk (a process of a mesh across
    processes computes its shards' so; :func:`sum_partials` of everyone's
    is the one-process integral)."""
    n_chunks, _, _ = _chunk_grid(n)
    per = -(-n_chunks // shards)
    sums = chunk_sums(f, a, b, n, device, first * per, (first + count) * per)
    return kahan_shards(sums, count, per)


def sum_partials(partials: torch.Tensor, h: float) -> torch.Tensor:
    """The shard partials summed in float32 in shard order, times
    ``f32(h)`` (JAX's ``lax.psum``, then the width). A 0-dim float32."""
    total = partials[0]
    for k in range(1, partials.numel()):
        total = total + partials[k]
    return total * _f32(h, partials.device)


def shard_total(sums: torch.Tensor, shards: int, h: float) -> torch.Tensor:
    """The integral from the chunk sums in chunk order: each shard's
    :func:`kahan_shards` partial, the partials summed in float32 in shard
    order, times ``f32(h)``. A 0-dim float32 tensor on ``sums``' device."""
    return sum_partials(kahan_shards(sums, shards), h)


def trapezoid_serial(f: Callable, a: float, b: float, n: int,
                     device: str | torch.device = "cpu") -> torch.Tensor:
    """The one-shard sum (``integral.c:20-29``, the ``size == 1`` path)."""
    return trapezoid_shard_sum(f, a, b, n, 1, device)
