"""Declarative stencil specifications and the workload registry.

Counterpart of ``mpi_and_open_mp_tpu/stencils/spec.py``, kept as the
port's own copy (that module imports no JAX, but the port imports nothing
of the JAX package). A :class:`StencilSpec` factors a rule out of the
engine: neighbourhood weights (radius), cell dtype, channel count,
boundary, and a pure ``update(center, neighbor_agg, xp) -> next``.

``update`` and ``pre`` receive ``xp``, which is ``numpy`` or ``torch``, so
one rule body serves the NumPy oracle and every torch path. Torch tensors
have no ``astype``: the bodies cast through :func:`cast`, and use only
calls both backends share (``xp.stack``, ``xp.exp``, ``xp.clip``, infix
arithmetic and comparisons). The constants, weight tables and ``init``
builders are the JAX package's, so a board made from a seed is the same
numpy array in both packages.

Registered workloads (``get(name)`` / ``names()``):

* ``life`` - Conway's rule, bit-exact (uint8, radius-1 box);
* ``heat`` - float32 5-point diffusion (explicit Euler, alpha=0.1);
* ``gray_scott`` - two-channel float32 reaction-diffusion;
* ``wireworld`` - 4-state automaton (empty/head/tail/conductor);
* ``lenia`` - radius-8 float32 smooth-growth automaton, whose Gaussian
  ring kernel factors exactly at rank 2 (the separable family's case).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

#: Radius-1 all-neighbour box (Moore neighbourhood), center zero.
BOX3 = ((1, 1, 1), (1, 0, 1), (1, 1, 1))
#: Radius-1 5-point cross (von Neumann), center zero.
CROSS3 = ((0, 1, 0), (1, 0, 1), (0, 1, 0))

#: Singular values below ``s_max * _SEP_RANK_CUTOFF`` are factorization
#: noise, not rank.
_SEP_RANK_CUTOFF = 1e-12


def cast(x, like):
    """``x`` in the dtype of ``like``, for NumPy arrays and torch tensors
    alike (the JAX bodies' ``.astype(center.dtype)``)."""
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype)
    return np.asarray(x).astype(like.dtype)


@functools.lru_cache(maxsize=None)
def _separable_factors(weights: tuple, radius: int):
    """Low-rank row x col factorization of a weight table, or None.

    Returns ``((u_0, v_0), ..., (u_{k-1}, v_{k-1}))`` float64 vectors with
    ``w == sum_k outer(u_k, v_k)`` to float64-SVD exactness, where ``k`` is
    the table's numerical rank; None when ``k > radius`` (past that the
    row + col passes stop beating the offset walk). A zero center makes
    every table at least rank 2, so no radius-1 table factors."""
    w = np.asarray(weights, np.float64)
    u, s, vt = np.linalg.svd(w)
    if s[0] == 0.0:
        return None
    rank = int((s > s[0] * _SEP_RANK_CUTOFF).sum())
    if rank > radius:
        return None
    return tuple((u[:, k] * s[k], vt[k, :]) for k in range(rank))


@dataclass(frozen=True)
class StencilSpec:
    """One servable stencil workload.

    ``weights`` is a ``(2*radius+1)``-square nested tuple with a zero
    center: the engine aggregates ``sum(w * neighbour)`` over nonzero
    entries in row-major order (bit-exact for integer dtypes, one fixed
    order for floats). ``pre(board, xp)`` optionally maps the board to the
    field being aggregated (wireworld counts electron heads).
    ``update(center, agg, xp)`` is the pure rule. Multi-channel boards
    carry channels on the leading axis.
    """

    name: str
    radius: int
    dtype: str
    weights: tuple
    update: Callable
    channels: int = 1
    boundary: str = "torus"
    pre: Callable | None = None
    init: Callable | None = None
    states: int | None = None
    #: Independent NumPy oracle; None derives it from the offset table
    #: (``engine.step_numpy``). ``life`` pins ``ops.life_ops``'s oracle.
    oracle_step: Callable | None = None
    extra: tuple = field(default=())

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_float(self) -> bool:
        return np.issubdtype(self.np_dtype, np.floating)

    @functools.cached_property
    def separable_rank(self) -> int | None:
        """Numerical rank of the weight table when it factors into
        ``rank <= radius`` row x col passes, else None."""
        f = _separable_factors(self.weights, self.radius)
        return None if f is None else len(f)

    def board_shape(self, ny: int, nx: int) -> tuple:
        """Full board shape for an ``ny x nx`` grid (channels leading)."""
        return (self.channels, ny, nx) if self.channels > 1 else (ny, nx)

    def valid_board(self, board: np.ndarray) -> bool:
        """Domain check: automata states in range, float fields finite."""
        board = np.asarray(board)
        if self.states is not None:
            return bool(np.isin(board, np.arange(self.states)).all())
        if self.is_float:
            return bool(np.isfinite(board).all())
        return True


# --------------------------------------------------------------------------
# Rule bodies (module-level so specs stay hashable; the kernel wrapper
# picks its device rule by these functions' identity).

def _life_update(center, agg, xp):
    # Birth on 3, survival on 2 (ops.life_ops.life_rule).
    return cast((agg == 3) | ((agg == 2) & (center == 1)), center)


HEAT_ALPHA = 0.1


def _heat_update(center, agg, xp):
    # Explicit Euler 5-point diffusion; agg - 4c is the discrete Laplacian.
    return cast(center + HEAT_ALPHA * (agg - 4 * center), center)


GS_DU, GS_DV, GS_F, GS_K, GS_DT = 0.16, 0.08, 0.04, 0.06, 1.0


def _gray_scott_update(center, agg, xp):
    # center/agg: (2, ny, nx); channel 0 is U, channel 1 is V.
    u, v = center[0], center[1]
    lu = agg[0] - 4 * u
    lv = agg[1] - 4 * v
    uvv = u * v * v
    un = u + (GS_DU * lu - uvv + GS_F * (1 - u)) * GS_DT
    vn = v + (GS_DV * lv + uvv - (GS_F + GS_K) * v) * GS_DT
    return cast(xp.stack([un, vn]), center)


#: Lenia growth-bell parameters. Weights sum to 1, so the aggregate is a
#: weighted mean in [0, 1]; one step amplifies float noise ~1.5x, so
#: parity windows stay at 8 steps.
LENIA_MU, LENIA_SIGMA, LENIA_DT = 0.35, 0.25, 0.1


def _lenia_update(center, agg, xp):
    # Gaussian bell mapped to [-1, 1], explicit Euler, clipped to [0, 1].
    g = 2.0 * xp.exp(
        -((agg - LENIA_MU) ** 2) / (2.0 * LENIA_SIGMA ** 2)) - 1.0
    return cast(xp.clip(center + LENIA_DT * g, 0.0, 1.0), center)


def _wireworld_pre(board, xp):
    # The aggregate counts electron heads only.
    return cast(board == 1, board)


def _wireworld_update(center, agg, xp):
    # 0 empty stays, 1 head -> tail (2), 2 tail -> conductor (3),
    # 3 conductor -> head (1) iff 1 or 2 head neighbours, else stays.
    is_head = center == 1
    is_tail = center == 2
    is_cond = center == 3
    excite = (agg == 1) | (agg == 2)
    nxt = is_head * 2 + is_tail * 3 + is_cond * (3 - 2 * excite)
    return cast(nxt, center)


# --------------------------------------------------------------------------
# Initial-board builders (NumPy; rng is np.random.Generator). They draw the
# JAX package's numbers in the JAX package's order.

def _life_init(rng, shape):
    ny, nx = shape
    return (rng.random((ny, nx)) < 0.33).astype(np.uint8)


def _heat_init(rng, shape):
    ny, nx = shape
    return rng.random((ny, nx)).astype(np.float32)


def _gray_scott_init(rng, shape):
    ny, nx = shape
    u = np.ones((ny, nx), np.float32)
    v = np.zeros((ny, nx), np.float32)
    # A few perturbation squares; the bulk stays at (U=1, V=0).
    for _ in range(max(1, (ny * nx) // 4096)):
        cy = int(rng.integers(0, ny))
        cx = int(rng.integers(0, nx))
        s = 4
        ys = np.arange(cy - s, cy + s) % ny
        xs = np.arange(cx - s, cx + s) % nx
        u[np.ix_(ys, xs)] = 0.5
        v[np.ix_(ys, xs)] = 0.25
    return np.stack([u, v])


def _wireworld_init(rng, shape):
    ny, nx = shape
    return rng.choice(
        np.arange(4, dtype=np.uint8), size=(ny, nx),
        p=[0.55, 0.05, 0.05, 0.35]).astype(np.uint8)


def _lenia_init(rng, shape):
    ny, nx = shape
    return rng.random((ny, nx)).astype(np.float32)


def make_lenia(radius: int, name: str | None = None) -> StencilSpec:
    """Wide-radius smooth automaton at any radius (only radius 8 is
    registered, as ``"lenia"``). The kernel is a normalized Gaussian ring
    ``outer(g, g)`` with the center zeroed: exactly rank 2 at any radius
    >= 2."""
    side = 2 * radius + 1
    g = np.exp(-0.5 * ((np.arange(side) - radius) / (0.35 * radius)) ** 2)
    w = np.outer(g, g)
    w[radius, radius] = 0.0
    w /= w.sum()
    weights = tuple(tuple(float(x) for x in row) for row in w)
    return StencilSpec(
        name=name or f"lenia_r{radius}", radius=radius, dtype="float32",
        weights=weights, update=_lenia_update, init=_lenia_init)


def _life_oracle(board):
    from mpi_and_open_mp_tpu_torch.ops import life_ops

    return life_ops.life_step_numpy(board)


# --------------------------------------------------------------------------
# Registry.

_REGISTRY: dict[str, StencilSpec] = {}


def register(spec: StencilSpec) -> StencilSpec:
    """Validate and register: square table, zero center, finite weights.
    ``separable_rank`` is computed here, so later gates read a cached
    attribute."""
    if spec.name in _REGISTRY:
        raise ValueError(f"stencil {spec.name!r} already registered")
    side = 2 * spec.radius + 1
    w = np.asarray(spec.weights)
    if w.shape != (side, side):
        raise ValueError(
            f"stencil {spec.name!r}: weights shape {w.shape} != "
            f"({side}, {side}) for radius {spec.radius}")
    if w[spec.radius, spec.radius] != 0:
        raise ValueError(
            f"stencil {spec.name!r}: weights center must be 0 (the rule "
            "sees the center via the `center` argument)")
    if not np.isfinite(w.astype(np.float64)).all():
        raise ValueError(f"stencil {spec.name!r}: weights must be finite")
    spec.separable_rank
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> StencilSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown stencil workload {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


LIFE = register(StencilSpec(
    name="life", radius=1, dtype="uint8", weights=BOX3,
    update=_life_update, states=2, init=_life_init,
    oracle_step=_life_oracle))

HEAT = register(StencilSpec(
    name="heat", radius=1, dtype="float32", weights=CROSS3,
    update=_heat_update, init=_heat_init))

GRAY_SCOTT = register(StencilSpec(
    name="gray_scott", radius=1, dtype="float32", weights=CROSS3,
    update=_gray_scott_update, channels=2, init=_gray_scott_init))

WIREWORLD = register(StencilSpec(
    name="wireworld", radius=1, dtype="uint8", weights=BOX3,
    update=_wireworld_update, pre=_wireworld_pre, states=4,
    init=_wireworld_init))

LENIA = register(make_lenia(8, "lenia"))
