"""Generic stencil steps: one spec, every single-device path.

Counterpart of ``mpi_and_open_mp_tpu/stencils/engine.py`` (its
single-device part; the sharded runners come with the sharded layouts).
Every path derives from the same offset table (nonzero ``weights``
entries in row-major order), so the NumPy oracle and the torch paths
aggregate in the same order: bit-exact for integer dtypes, within
:func:`parity_tol_for` for floats.

Paths (``xp`` is ``torch`` by default, or ``numpy``):

* :func:`step_roll` - torus step by shifts of the last two axes (channels
  ride the leading axis). The radius-1 all-ones box (Life's neighbourhood)
  takes the row-sum/col-sum form, 4 shifts instead of 8.
* :func:`step_padded` - interior step over a board carrying a
  ``radius``-wide halo on the last two axes; slicing only.
* :func:`step_numpy` - the NumPy oracle (per-offset roll loop, or the
  spec's pinned ``oracle_step``).
* :func:`run_roll` and :func:`run_roll_batch` - ``n`` chained torus steps
  of one board or of a stack.
* :func:`run_padded_native_batch` - ``n`` steps of a single-channel stack
  through the hand-written padded kernel (``ops.native_stencil``): the
  JAX package's ``run_padded_pallas_batch`` (its ``pallas`` is the port's
  ``native``). :func:`native_batch_supported` is its
  ``pallas_batch_supported``.

Sharded runners (the JAX package's ``shard_map`` halo rounds), over a
``parallel.mesh.Mesh`` of shards on one device:

* :func:`make_sharded_runner` and :func:`run_sharded` - rounds of
  ``fuse_steps`` steps scheduled by a persistent ``parallel.haloplan``
  plan (overlap or sequential), on the stacked shards;
  :func:`sharded_pspec`, :func:`mesh_axes_for` and
  :func:`fused_steps_valid` are their helpers; ``stencils.sparse_sharded``
  steps only the active tiles of such a board.

Engine families restructure the aggregation for wide float kernels:

* ``sep`` (:func:`step_sep`, :func:`step_padded_sep`) - the weight table
  factors into ``rank`` row x col passes (``spec.separable_rank``);
  refused (ValueError) when it does not.
* ``fft`` (:func:`step_fft`, :func:`step_padded_fft`) - the torus
  aggregate as a circular convolution through ``rfft2`` with a cached
  complex64 kernel transform; float specs only.

``MOMP_ENGINE_FAMILY`` pins one family (offset|sep|fft); the offset walk
always stays allowed.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.stencils.spec import (
    BOX3,
    StencilSpec,
    _separable_factors,
    cast,
)


@functools.lru_cache(maxsize=None)
def offsets(spec: StencilSpec) -> tuple:
    """Nonzero ``(dy, dx, weight)`` neighbour displacements, row-major. A
    neighbour at ``(dy, dx)`` contributes ``weight * board[y + dy, x + dx]``
    to the aggregate."""
    r = spec.radius
    out = []
    for j, row in enumerate(spec.weights):
        for i, w in enumerate(row):
            if w:
                out.append((j - r, i - r, w))
    return tuple(out)


def _is_box3(spec: StencilSpec) -> bool:
    return spec.radius == 1 and spec.weights == BOX3


def _shift(field, dy, dx, xp):
    # roll(-dy) moves the value at y+dy into row y (and likewise for x).
    # Positional axis arguments: numpy's ``axis`` is torch's ``dims``.
    out = field
    if dy:
        out = xp.roll(out, -dy, -2)
    if dx:
        out = xp.roll(out, -dx, -1)
    return out


def aggregate_roll(spec: StencilSpec, board, xp=torch):
    """The weighted neighbour sum of a torus board (last two axes)."""
    field = board if spec.pre is None else spec.pre(board, xp)
    if _is_box3(spec):
        rows = field + xp.roll(field, 1, -2) + xp.roll(field, -1, -2)
        return (rows + xp.roll(rows, 1, -1) + xp.roll(rows, -1, -1)
                - field)
    agg = None
    for dy, dx, w in offsets(spec):
        term = _shift(field, dy, dx, xp)
        if w != 1:
            term = term * w
        agg = term if agg is None else agg + term
    return agg


def step_roll(spec: StencilSpec, board, xp=torch):
    """One torus step via rolls, under torch or numpy."""
    return spec.update(board, aggregate_roll(spec, board, xp), xp)


def step_padded(spec: StencilSpec, padded, xp=torch):
    """One interior step over a halo-padded block: ``padded`` carries a
    ``spec.radius``-deep halo on the last two axes; returns the updated
    interior. The plain version of ``ops.native_stencil``'s kernel."""
    r = spec.radius
    h = padded.shape[-2] - 2 * r
    w = padded.shape[-1] - 2 * r
    field = padded if spec.pre is None else spec.pre(padded, xp)
    center = padded[..., r:r + h, r:r + w]
    if _is_box3(spec):
        rows = (field[..., 0:h, :] + field[..., 1:h + 1, :]
                + field[..., 2:h + 2, :])
        agg = (rows[..., 0:w] + rows[..., 1:w + 1] + rows[..., 2:w + 2]
               - field[..., 1:h + 1, 1:w + 1])
    else:
        agg = None
        for dy, dx, wt in offsets(spec):
            term = field[..., r + dy:r + dy + h, r + dx:r + dx + w]
            if wt != 1:
                term = term * wt
            agg = term if agg is None else agg + term
    return spec.update(center, agg, xp)


def step_numpy(spec: StencilSpec, board: np.ndarray) -> np.ndarray:
    """The spec's NumPy oracle step (its ``oracle_step`` when pinned, else
    the per-offset roll loop)."""
    board = np.asarray(board, dtype=spec.np_dtype)
    if spec.oracle_step is not None:
        return spec.oracle_step(board)
    field = board if spec.pre is None else spec.pre(board, np)
    agg = None
    for dy, dx, w in offsets(spec):
        term = _shift(field, dy, dx, np)
        if w != 1:
            term = term * w
        agg = term if agg is None else agg + term
    return np.asarray(spec.update(board, agg, np), dtype=spec.np_dtype)


def oracle_run(spec: StencilSpec, board: np.ndarray, n: int) -> np.ndarray:
    out = np.asarray(board, dtype=spec.np_dtype)
    for _ in range(int(n)):
        out = step_numpy(spec, out)
    return out


def parity_ok(spec: StencilSpec, got, want, *, rtol=1e-5, atol=1e-6) -> bool:
    """The per-spec parity predicate: exact for integer dtypes, allclose
    for floats."""
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape:
        return False
    if spec.is_float:
        return bool(np.allclose(got, want, rtol=rtol, atol=atol))
    return bool(np.array_equal(got, want))


def channels_first(spec: StencilSpec, blocks: torch.Tensor, step):
    """``step(blocks)`` for ``(*S, C, H, W)`` blocks of a multi-channel
    rule, which indexes its channels on the leading axis: the stack goes
    channels first and back. Single-channel blocks and one ``(C, H, W)``
    board pass straight through."""
    if spec.channels == 1 or blocks.dim() == 3:
        return step(blocks)
    return step(blocks.movedim(-3, 0)).movedim(0, -3)


def _on_stack(spec: StencilSpec, stack: torch.Tensor, run):
    """``run(boards)`` over a (B, *board) stack. A multi-channel rule
    indexes ``center[0]``/``center[1]``, so its stack goes channels first,
    (C, B, ny, nx), and each channel slice is a stack of boards (the JAX
    package vmaps over the stack instead)."""
    if spec.channels == 1:
        return run(stack)
    return run(stack.transpose(0, 1)).transpose(0, 1).contiguous()


def run_roll(spec: StencilSpec, board, n: int) -> torch.Tensor:
    """``n`` chained :func:`step_roll` steps of one board."""
    board = torch.as_tensor(board)
    for _ in range(int(n)):
        board = step_roll(spec, board)
    return board


def run_roll_batch(spec: StencilSpec, stack, n: int) -> torch.Tensor:
    """``n`` chained torus steps of a stack of boards (B on the leading
    axis): the serve layer's generic batch engine."""
    return _on_stack(spec, torch.as_tensor(stack),
                     lambda s: run_roll(spec, s, n))


def native_batch_supported(spec: StencilSpec, shape) -> bool:
    """Whether the padded kernel serves a batched ``(B, ny, nx)`` stack of
    this spec: single-channel rules only (a multi-channel rule would read
    the stack axis as channels; gray_scott stays on the roll engine). The
    JAX package's ``pallas_batch_supported``."""
    return int(spec.channels) == 1 and len(tuple(shape)) == 3


@functools.lru_cache(maxsize=64)
def _torus_index(ny: int, nx: int, r: int, device: torch.device):
    """Flat ``y * nx + x`` source of every cell of the ``r``-padded torus
    board, rows and columns taken modulo the extent."""
    rows = torch.arange(-r, ny + r, device=device) % ny
    cols = torch.arange(-r, nx + r, device=device) % nx
    return (rows[:, None] * nx + cols[None, :]).reshape(-1)


def torus_pad(board: torch.Tensor, r: int) -> torch.Tensor:
    """``board`` with an ``r``-wide torus halo on its last two axes, in one
    gather: a halo of any depth, also one wider than the extent (which
    ``F.pad(mode="circular")`` refuses)."""
    *lead, ny, nx = board.shape
    flat = _torus_index(ny, nx, r, board.device)
    return board.reshape(*lead, ny * nx).index_select(-1, flat).view(
        *lead, ny + 2 * r, nx + 2 * r)


def run_padded_native_batch(spec: StencilSpec, stack: torch.Tensor,
                            n: int) -> torch.Tensor:
    """``n`` chained steps of a single-channel ``(B, ny, nx)`` stack
    through the spec-generic padded kernel
    (``ops.native_stencil.stencil_step_padded``): each step gathers the
    torus halo (:func:`torus_pad`) and launches the kernel once, so two
    launches per step on the card. On a CPU tensor the kernel's plain
    version runs. Counterpart of the JAX package's
    ``run_padded_pallas_batch``, without its 4 MB VMEM gate: the kernel
    tiles the board over blocks and takes any size. Gate callers on
    :func:`native_batch_supported`."""
    from mpi_and_open_mp_tpu_torch.ops import native_stencil

    for _ in range(int(n)):
        stack = native_stencil.stencil_step_padded(
            spec, torus_pad(stack, spec.radius))
    return stack


# --------------------------------------------------------- engine families

#: Closed vocabulary of engine families.
ENGINE_FAMILIES = ("offset", "sep", "fft")

#: Below this radius the FFT's setup constant cannot win.
FFT_MIN_RADIUS = 4

#: Kill switch: pin one family (offset|sep|fft); offset stays allowed.
ENV_FAMILY = "MOMP_ENGINE_FAMILY"

#: Gate-owned parity tolerances per family (offset keeps parity_ok's).
_FAMILY_TOL = {
    "offset": {},
    "sep": {"rtol": 1e-4, "atol": 1e-5},
    "fft": {"rtol": 1e-3, "atol": 1e-4},
}


def parity_tol_for(family: str) -> dict:
    """kwargs for :func:`parity_ok` when gating ``family`` output."""
    if family not in ENGINE_FAMILIES:
        raise ValueError(f"unknown engine family {family!r}; "
                         f"expected one of {ENGINE_FAMILIES}")
    return dict(_FAMILY_TOL[family])


def family_pinned() -> str | None:
    """The ``MOMP_ENGINE_FAMILY`` pin, validated; None when unset."""
    v = os.environ.get(ENV_FAMILY, "").strip()
    if not v:
        return None
    if v not in ENGINE_FAMILIES:
        raise ValueError(
            f"{ENV_FAMILY}={v!r}: expected one of {ENGINE_FAMILIES}")
    return v


def family_allowed(family: str) -> bool:
    """Whether ``family`` may be served under the pin (offset always)."""
    pin = family_pinned()
    return pin is None or family == pin or family == "offset"


def family_for_path(path: str) -> str:
    """Engine family of a path string (``stencil:sep`` -> ``sep``;
    everything else is the offset walk)."""
    if path.endswith(":sep"):
        return "sep"
    if path.endswith(":fft"):
        return "fft"
    return "offset"


def separable_supported(spec: StencilSpec) -> bool:
    """Whether the sep family serves this spec exactly."""
    return spec.separable_rank is not None


def fft_supported(spec: StencilSpec) -> bool:
    """FFT legality: float dtype, periodic boundary, radius past the
    setup constant."""
    return (spec.is_float and spec.boundary == "torus"
            and spec.radius >= FFT_MIN_RADIUS)


@functools.lru_cache(maxsize=None)
def _sep_factors(spec: StencilSpec):
    """The spec's row x col factor pairs as plain-float tuples, or None."""
    f = _separable_factors(spec.weights, spec.radius)
    if f is None:
        return None
    return tuple((tuple(float(x) for x in u), tuple(float(x) for x in v))
                 for u, v in f)


def _require_sep(spec: StencilSpec):
    facs = _sep_factors(spec)
    if facs is None:
        raise ValueError(
            f"stencil {spec.name!r}: weights do not factor at rank <= "
            f"radius ({spec.radius}); separable family refused")
    return facs


def _require_fft(spec: StencilSpec):
    if not spec.is_float:
        raise ValueError(
            f"stencil {spec.name!r}: fft family needs a float dtype, "
            f"got {spec.dtype}")
    if spec.boundary != "torus":
        raise ValueError(
            f"stencil {spec.name!r}: fft family is periodic-native; "
            f"boundary {spec.boundary!r} unsupported")


def _require_family(spec: StencilSpec, family: str) -> None:
    if family == "sep":
        _require_sep(spec)
    elif family == "fft":
        _require_fft(spec)
    elif family != "offset":
        raise ValueError(f"unknown engine family {family!r}; "
                         f"expected one of {ENGINE_FAMILIES}")


def aggregate_sep(spec: StencilSpec, board, xp=torch):
    """The torus neighbour sum as ``rank`` row-pass x col-pass sweeps:
    2 * rank * (2r+1) rolls instead of (2r+1)^2 - 1."""
    facs = _require_sep(spec)
    field = board if spec.pre is None else spec.pre(board, xp)
    r = spec.radius
    agg = None
    for u, v in facs:
        rows = None
        for j, uw in enumerate(u):
            if not uw:
                continue
            term = xp.roll(field, r - j, -2) if j != r else field
            if uw != 1:
                term = term * uw
            rows = term if rows is None else rows + term
        part = None
        for i, vw in enumerate(v):
            if not vw:
                continue
            term = xp.roll(rows, r - i, -1) if i != r else rows
            if vw != 1:
                term = term * vw
            part = term if part is None else part + term
        agg = part if agg is None else agg + part
    return agg


def step_sep(spec: StencilSpec, board, xp=torch):
    """One torus step via the separable family; raises ValueError on
    weights that do not factor."""
    return spec.update(board, aggregate_sep(spec, board, xp), xp)


@functools.lru_cache(maxsize=None)
def _fft_kernel_rfft(spec: StencilSpec, ny: int, nx: int) -> np.ndarray:
    """rfft2 of the spec's kernel image on an ``ny x nx`` torus, complex64.
    The aggregate is a cross-correlation, so the convolution kernel is the
    offset table point-reflected (``+=``: on boards narrower than the
    table, wrapped taps pile up as the roll path wraps them)."""
    k = np.zeros((ny, nx), np.float64)
    for dy, dx, w in offsets(spec):
        k[(-dy) % ny, (-dx) % nx] += w
    return np.fft.rfft2(k).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _fft_kernel_tensor(spec: StencilSpec, ny: int, nx: int,
                       device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_fft_kernel_rfft(spec, ny, nx)).to(device)


def _fft_aggregate(spec: StencilSpec, field, xp):
    ny, nx = int(field.shape[-2]), int(field.shape[-1])
    if xp is np:
        kf = _fft_kernel_rfft(spec, ny, nx)
    else:
        kf = _fft_kernel_tensor(spec, ny, nx, field.device)
    return xp.fft.irfft2(xp.fft.rfft2(field) * kf, s=(ny, nx))


def step_fft(spec: StencilSpec, board, xp=torch):
    """One torus step via the FFT family: rfft2 of the field times the
    cached kernel transform, transformed back. Float specs only."""
    _require_fft(spec)
    field = board if spec.pre is None else spec.pre(board, xp)
    agg = cast(_fft_aggregate(spec, field, xp), board)
    return spec.update(board, agg, xp)


def step_padded_sep(spec: StencilSpec, padded, xp=torch):
    """Interior separable step over a halo-padded block (slicing only):
    row passes slice ``[j:j+h]``, col passes ``[i:i+w]``."""
    facs = _require_sep(spec)
    r = spec.radius
    h = padded.shape[-2] - 2 * r
    w = padded.shape[-1] - 2 * r
    field = padded if spec.pre is None else spec.pre(padded, xp)
    center = padded[..., r:r + h, r:r + w]
    agg = None
    for u, v in facs:
        rows = None
        for j, uw in enumerate(u):
            if not uw:
                continue
            term = field[..., j:j + h, :]
            if uw != 1:
                term = term * uw
            rows = term if rows is None else rows + term
        part = None
        for i, vw in enumerate(v):
            if not vw:
                continue
            term = rows[..., i:i + w]
            if vw != 1:
                term = term * vw
            part = term if part is None else part + term
        agg = part if agg is None else agg + part
    return spec.update(center, agg, xp)


def step_padded_fft(spec: StencilSpec, padded, xp=torch):
    """Interior FFT step over a halo-padded block: circular convolution on
    the padded extent, interior crop (taps never wrap the padded block for
    interior rows, so the result equals the linear gather)."""
    _require_fft(spec)
    r = spec.radius
    h = padded.shape[-2] - 2 * r
    w = padded.shape[-1] - 2 * r
    field = padded if spec.pre is None else spec.pre(padded, xp)
    full = _fft_aggregate(spec, field, xp)
    agg = cast(full[..., r:r + h, r:r + w], padded)
    center = padded[..., r:r + h, r:r + w]
    return spec.update(center, agg, xp)


def step_family(spec: StencilSpec, board, family: str = "offset",
                xp=torch):
    """One torus step through the named engine family."""
    if family == "offset":
        return step_roll(spec, board, xp)
    if family == "sep":
        return step_sep(spec, board, xp)
    if family == "fft":
        return step_fft(spec, board, xp)
    raise ValueError(f"unknown engine family {family!r}; "
                     f"expected one of {ENGINE_FAMILIES}")


def step_padded_family(spec: StencilSpec, padded, family: str = "offset",
                       xp=torch):
    """One interior halo-padded step through the named engine family."""
    if family == "offset":
        return step_padded(spec, padded, xp)
    if family == "sep":
        return step_padded_sep(spec, padded, xp)
    if family == "fft":
        return step_padded_fft(spec, padded, xp)
    raise ValueError(f"unknown engine family {family!r}; "
                     f"expected one of {ENGINE_FAMILIES}")


def run_family(spec: StencilSpec, board, n: int,
               family: str = "offset") -> torch.Tensor:
    """``n`` chained steps of one engine family (the family twin of
    :func:`run_roll`). Refusals (non-factorizable sep, integer fft) raise
    before any step."""
    _require_family(spec, family)
    board = torch.as_tensor(board)
    for _ in range(int(n)):
        board = step_family(spec, board, family)
    return board


def run_family_batch(spec: StencilSpec, stack, n: int,
                     family: str = "offset") -> torch.Tensor:
    """Batched :func:`run_family`, with :func:`run_roll_batch`'s calling
    convention."""
    _require_family(spec, family)
    return _on_stack(spec, torch.as_tensor(stack),
                     lambda s: run_family(spec, s, n, family))


# ------------------------------------------------------- sharded halo steps
#
# The engine-level sharded entry: halo rounds over the stacked shards of a
# mesh (parallel.mesh), scheduled by a persistent HaloPlan
# (parallel.haloplan), so the model layer and the runners measure the same
# two schedules.


def sharded_pspec(layout: str, channels: int) -> tuple:
    """The board axes' mesh axes under ``layout`` (None = unsharded),
    channels leading: the JAX package's ``PartitionSpec`` for the board,
    as a tuple."""
    axes = {"row": ("y", None), "col": (None, "x"),
            "cart": ("y", "x")}[layout]
    return (None, *axes) if channels > 1 else axes


def mesh_axes_for(layout: str, mesh) -> tuple[int, int]:
    """(py, px) shard counts per board axis under ``layout``."""
    py = mesh.shape.get("y", 1) if layout in ("row", "cart") else 1
    px = mesh.shape.get("x", 1) if layout in ("col", "cart") else 1
    return py, px


def fused_steps_valid(spec: StencilSpec, shard_shape: tuple[int, int],
                      fuse_steps: int) -> bool:
    """Whether ``fuse_steps`` fuses legally on this shard: the halo depth
    ``fuse_steps * radius`` cannot exceed the smallest shard extent (a
    deeper halo would wrap a neighbour's neighbour)."""
    return fuse_steps * spec.radius <= min(shard_shape)


def make_sharded_runner(spec: StencilSpec, mesh, layout: str,
                        shape: tuple[int, int], *, fuse_steps: int = 1,
                        boundary_steps: int | None = None,
                        overlap: bool | None = None,
                        family: str = "offset"):
    """Build ``(run, plan)`` for a board sharded over ``mesh``:
    ``run(board, n)`` advances a ``(*C, ny, nx)`` board on the mesh's
    device ``n`` torus steps by plan-scheduled halo rounds over its
    stacked shards, and returns the board. On a mesh across processes
    (``parallel.procs``) each process steps its run of the shards and the
    board comes back gathered in every process (a collective).

    ``overlap=None`` lets the plan decide (geometry and the
    ``MOMP_HALO_OVERLAP`` kill switch); ``False`` forces the sequential
    schedule and stamps ``why``. ``boundary_steps`` partitions each
    round's boundary (it must divide ``fuse_steps``); ``family`` picks
    the per-shard aggregation (:func:`step_padded_family`). A remainder
    round gets its own coupled plan of the smaller depth."""
    import dataclasses as _dc

    from mpi_and_open_mp_tpu_torch.parallel import haloplan
    from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib

    _require_family(spec, family)
    ny, nx = shape
    py, px = mesh_axes_for(layout, mesh)
    if ny % py or nx % px:
        raise ValueError(
            f"board {shape} does not divide mesh {mesh.shape} under "
            f"layout={layout!r}")
    shard = (ny // py, nx // px)
    if not fused_steps_valid(spec, shard, fuse_steps):
        raise ValueError(
            f"fuse_steps={fuse_steps} x radius {spec.radius} exceeds "
            f"shard {shard}")

    def plan_for(k: int):
        bs = boundary_steps if k == fuse_steps else None
        p = haloplan.plan_halo(layout, (py, px), shard, spec.radius, k,
                               boundary_steps=bs, channels=spec.channels,
                               device=mesh.device)
        if overlap is False and p.overlap:
            p = _dc.replace(p, overlap=False, engine="seq:halo",
                            why="forced sequential (A/B baseline)")
        return p

    plan = plan_for(fuse_steps)

    def step_fn(padded):
        return channels_first(
            spec, padded,
            lambda b: step_padded_family(spec, b, family, torch))

    def run(board, n):
        stack = mesh_lib.local_part(mesh_lib.shard(
            torch.as_tensor(board, device=mesh.device), py, px), mesh)
        rounds, rem = divmod(int(n), fuse_steps)
        for _ in range(rounds):
            stack = haloplan.fused_step(plan, step_fn, stack)
        if rem:
            stack = haloplan.fused_step(plan_for(rem), step_fn, stack)
        return mesh_lib.unshard(mesh_lib.gather(stack, mesh))

    return run, plan


def run_sharded(spec: StencilSpec, board, n: int, *, mesh,
                layout: str = "row", fuse_steps: int = 1,
                boundary_steps: int | None = None,
                overlap: bool | None = None, family: str = "offset"):
    """Advance ``board`` (host or device; placed on the mesh's device in
    the spec's dtype) ``n`` sharded steps; returns the board on the
    mesh's device. The plan rides on ``run_sharded.last_plan``. The run is
    one ``halo.overlap`` or ``halo.seq`` span (``obs.trace``), anchored on
    the board while tracing is on."""
    from mpi_and_open_mp_tpu_torch.obs import trace

    board = torch.as_tensor(np.asarray(board, dtype=spec.np_dtype)
                            if not isinstance(board, torch.Tensor) else board)
    board = board.to(device=mesh.device, dtype=spec.torch_dtype)
    run, plan = make_sharded_runner(
        spec, mesh, layout, tuple(board.shape[-2:]),
        fuse_steps=fuse_steps, boundary_steps=boundary_steps,
        overlap=overlap, family=family)
    run_sharded.last_plan = plan
    name = "halo.overlap" if plan.overlap else "halo.seq"
    with trace.span(name, engine=plan.engine, layout=layout,
                    workload=spec.name, steps=int(n),
                    fuse_steps=int(fuse_steps), family=family) as sp:
        out = run(board, int(n))
        sp.anchor(out)
    return out


run_sharded.last_plan = None
