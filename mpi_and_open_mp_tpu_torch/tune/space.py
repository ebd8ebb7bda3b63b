"""Candidate space: every legal plan for one configuration.

Counterpart of ``mpi_and_open_mp_tpu/tune/space.py``, on the port's paths
and gates. A :class:`Candidate` names one complete plan: the engine path,
the pack layout it implies, the batch-bucket rounding the serve layer
would use for it, and the decomposition axis order. A candidate is listed
only where this process can dispatch it (the port's gates, the device),
and the heuristic's own choice is always in the list, which keeps the
measured ``vs_heuristic`` at 1.0 or more.

The path names are the port's: ``plain`` is the JAX package's ``xla`` (the
CPU's packed loop, never a candidate on the card), the JAX package's
``vmem`` (a whole stack in one program) has no counterpart, and the padded
stencil kernel's path is ``stencil:native`` (``impl="native"``), with
``stencil:pallas`` accepted for it (:func:`runner_for`).
"""

from __future__ import annotations

import dataclasses
import os

#: Bucket-rounding vocabulary: the serve batcher pads board-sliced buckets
#: to 32-board plane multiples and everything else to the pow2 ladder.
BUCKET_PLANE32 = "plane32"
BUCKET_POW2 = "pow2"

#: The padded stencil kernel's path, and the JAX package's name for it.
STENCIL_NATIVE = "stencil:native"
STENCIL_NATIVE_ALIASES = (STENCIL_NATIVE, "stencil:pallas")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One complete tunable plan for a (workload, stack shape) pair."""

    workload: str
    #: Engine path: ``native_path_batch``'s vocabulary for life
    #: (``bitsliced``/``vmem-grid``/``fused``/``frame``/``plain``), or
    #: ``stencil:roll``/``stencil:native``/``stencil:sep``/``stencil:fft``.
    path: str
    #: ``bitsliced`` / ``cell-packed`` for life, ``-`` for stencil paths.
    pack_layout: str
    #: Batch-bucket rounding the path wants (plane32 iff bitsliced).
    bucket_rounding: str
    #: Decomposition axis order (single-process profiling: "row").
    axis_order: str = "row"
    #: Halo schedule of a sharded candidate ("overlap"/"seq", or "sparse"
    #: for ``sparse_sharded:*``); "-" for single-device paths.
    halo_overlap: str = "-"
    #: Steps fused per ghost round of a sharded candidate; 1 elsewhere.
    fuse_steps: int = 1
    #: Boundary sub-round depth of a sharded overlap candidate
    #: (``== fuse_steps``: the coupled one-exchange round).
    boundary_steps: int = 1


#: Tile edge the sparse-sharded candidates profile at.
SPARSE_SHARDED_TILE = 64

#: The sparse-sharded engine's default fuse depth, always the first rung
#: of its slate (clamped as the engine clamps it).
SPARSE_FUSE_HEURISTIC = 16


def sparse_fuse_depths(radius: int, tile: int) -> tuple[int, ...]:
    """Legal sparse-sharded fuse depths, the heuristic's first: ``radius *
    fuse <= tile``. ``MOMP_TUNE_SPARSE_FUSE`` (comma list, default
    "4,16,64") adds the measured rungs."""
    cap = max(1, int(tile) // max(1, int(radius)))
    heur = min(SPARSE_FUSE_HEURISTIC, cap)
    raw = os.environ.get("MOMP_TUNE_SPARSE_FUSE", "4,16,64")
    out = [heur]
    for tok in raw.split(","):
        if not tok.strip():
            continue
        f = max(1, int(tok))
        if f <= cap and f not in out:
            out.append(f)
    return tuple(out)


def sharded_fuse_depths() -> tuple[int, ...]:
    """Interior fuse depths of the sharded space: ``MOMP_TUNE_FUSE_DEPTHS``
    (comma list, default "1,2"); depth 1, the heuristic's, always in."""
    raw = os.environ.get("MOMP_TUNE_FUSE_DEPTHS", "1,2")
    depths = sorted({max(1, int(tok)) for tok in raw.split(",") if tok})
    return tuple(depths) if 1 in depths else (1, *depths)


def _boundary_depths(fuse_steps: int) -> tuple[int, ...]:
    """Legal boundary sub-round depths for one interior depth: every
    divisor, the coupled one (``== fuse_steps``) first."""
    return tuple(b for b in range(fuse_steps, 0, -1)
                 if fuse_steps % b == 0)


def axis_orders(device_count: int = 1,
                mesh_axes: tuple[int, int] | None = None) -> tuple[str, ...]:
    """Legal decomposition axis orders: one shard has only "row"; more add
    "col", and a real 2-D mesh (both axes > 1) "cart"."""
    if int(device_count) <= 1:
        return ("row",)
    orders = ("row", "col")
    if mesh_axes is not None:
        py, px = (int(a) for a in mesh_axes)
        if py > 1 and px > 1:
            orders = ("row", "col", "cart")
    return orders


def sharded_candidates(workload: str, shape: tuple[int, int],
                       mesh) -> list[Candidate]:
    """Every legal sharded candidate for (workload, board shape) on
    ``mesh`` (``parallel.mesh.Mesh``): each layout whose axes the mesh
    shards and the board divides, with the "overlap" schedule where the
    halo plan accepts the geometry and "seq" always (the historic
    schedule stays in the race), the deeper interior and boundary depths
    the plan accepts, and for single-channel rules the
    ``sparse_sharded:<layout>`` path where its plan accepts the tile."""
    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.parallel import haloplan
    from mpi_and_open_mp_tpu_torch.stencils import engine as stencil_engine
    from mpi_and_open_mp_tpu_torch.stencils import sparse_sharded

    spec = stencils.get(workload)
    ny, nx = (int(x) for x in shape)
    mesh_axes = (mesh.shape.get("y", 1), mesh.shape.get("x", 1))
    out = []
    for layout in axis_orders(mesh.size, mesh_axes):
        py, px = stencil_engine.mesh_axes_for(layout, mesh)
        if py * px <= 1 or ny % py or nx % px:
            continue
        shard = (ny // py, nx // px)
        if not stencil_engine.fused_steps_valid(spec, shard, 1):
            continue
        plan = haloplan.plan_halo(layout, (py, px), shard, spec.radius, 1,
                                  channels=spec.channels, device=mesh.device)
        schedules = ("overlap", "seq") if plan.overlap else ("seq",)
        for sched in schedules:
            out.append(Candidate(
                workload=str(workload), path=f"sharded:{layout}",
                pack_layout="-", bucket_rounding=BUCKET_POW2,
                axis_order=layout, halo_overlap=sched))
        if plan.overlap:
            for k in sharded_fuse_depths():
                if not stencil_engine.fused_steps_valid(spec, shard, k):
                    continue
                for b in _boundary_depths(k):
                    if (k, b) == (1, 1):
                        continue
                    pk = haloplan.plan_halo(
                        layout, (py, px), shard, spec.radius, k,
                        boundary_steps=b, channels=spec.channels,
                        device=mesh.device)
                    if not pk.overlap:
                        continue
                    out.append(Candidate(
                        workload=str(workload), path=f"sharded:{layout}",
                        pack_layout="-", bucket_rounding=BUCKET_POW2,
                        axis_order=layout, halo_overlap="overlap",
                        fuse_steps=k, boundary_steps=b))
        if spec.channels == 1:
            sp = sparse_sharded.plan_sparse_sharded(
                layout, (py, px), shard, spec.radius, SPARSE_SHARDED_TILE)
            if sp.enabled:
                for f in sparse_fuse_depths(spec.radius,
                                            SPARSE_SHARDED_TILE):
                    out.append(Candidate(
                        workload=str(workload),
                        path=f"sparse_sharded:{layout}",
                        pack_layout="-", bucket_rounding=BUCKET_POW2,
                        axis_order=layout, halo_overlap="sparse",
                        fuse_steps=f))
    return out


def life_paths(shape: tuple[int, int, int], on_card: bool) -> list[str]:
    """Every batched Life path this process can dispatch for ``shape``.
    ``bitsliced`` ignores :data:`BITSLICE_MIN_BATCH` (the line the tuner
    measures again) but keeps its gates (the resident gate,
    ``MOMP_BITSLICE=0``); on the card the kernel paths whose gates pass,
    on the CPU the plain loop."""
    from mpi_and_open_mp_tpu_torch.ops import bitlife, native_life

    b, ny, nx = (int(x) for x in shape)
    paths = []
    if native_life._BITSLICE and bitlife.fits_vmem_packed((ny, nx)):
        paths.append("bitsliced")
    if on_card:
        if bitlife.fits_vmem_packed((ny, nx)):
            paths.append("vmem-grid")
        if bitlife.fused_bits_supported((ny, nx)):
            paths.append("fused")
        if bitlife.plan_sharded_bits((ny, nx)) is not None:
            paths.append("frame")
    else:
        paths.append("plain")
    return paths


def stencil_paths(spec, shape: tuple[int, int, int]) -> list[str]:
    """Legal batched paths of a non-Life stencil spec: the roll engine
    always, the padded kernel (``stencil:native``) for single-channel
    stacks, and the separable and FFT families where their gates and the
    ``MOMP_ENGINE_FAMILY`` pin allow them."""
    from mpi_and_open_mp_tpu_torch.stencils import engine as stencil_engine

    paths = ["stencil:roll"]
    if stencil_engine.native_batch_supported(spec, shape):
        paths.append(STENCIL_NATIVE)
    if (stencil_engine.separable_supported(spec)
            and stencil_engine.family_allowed("sep")):
        paths.append("stencil:sep")
    if (stencil_engine.fft_supported(spec)
            and stencil_engine.family_allowed("fft")):
        paths.append("stencil:fft")
    return paths


def pack_layout_for(path: str) -> str:
    if path == "bitsliced":
        return "bitsliced"
    if path.startswith("stencil:"):
        return "-"
    return "cell-packed"


def bucket_rounding_for(path: str) -> str:
    return BUCKET_PLANE32 if path == "bitsliced" else BUCKET_POW2


def heuristic_path(workload: str, shape: tuple[int, int, int],
                   on_card: bool) -> str:
    """The path the static ladder picks, asked with any installed plan for
    the shape pinned out, so a tuning pass never grades a plan against
    itself."""
    from mpi_and_open_mp_tpu_torch.ops import native_life

    if workload == "life":
        with native_life._planned_pinned(workload, shape, None):
            return native_life.native_path_batch(tuple(shape),
                                                 on_card=on_card)
    return "stencil:roll"


def candidates(workload: str, shape: tuple[int, int, int], *,
               on_card: bool = True,
               device_count: int = 1) -> list[Candidate]:
    """Every legal candidate for (workload, stack shape, topology) on the
    card (``on_card=True``) or the CPU, the heuristic's first (the
    runner's ties then keep it)."""
    if workload == "life":
        paths = life_paths(shape, on_card)
    else:
        from mpi_and_open_mp_tpu_torch import stencils

        paths = stencil_paths(stencils.get(workload), shape)
    heur = heuristic_path(workload, shape, on_card)
    if heur in paths:
        paths = [heur] + [p for p in paths if p != heur]
    out = []
    for axis in axis_orders(device_count):
        for p in paths:
            out.append(Candidate(
                workload=str(workload), path=p,
                pack_layout=pack_layout_for(p),
                bucket_rounding=bucket_rounding_for(p),
                axis_order=axis))
    return out


def runner_for(workload: str, path: str):
    """The callable ``(stack, n) -> stack`` that runs one candidate path
    directly (past the dispatcher, which would plan again). Raises
    ``ValueError`` on a path this package does not run, so a stale or
    foreign plan record never runs another engine; the Life ``plain`` loop
    raises for a stack on the card."""
    if workload == "life":
        from mpi_and_open_mp_tpu_torch.ops import native_life

        if path not in ("bitsliced", "vmem-grid", "fused", "frame", "plain"):
            raise ValueError(f"unknown life engine path {path!r}")
        return lambda s, n: native_life.run_path_batch(path, s, n)
    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.stencils import engine as stencil_engine

    spec = stencils.get(workload)
    if path == "stencil:roll":
        return lambda s, n: stencils.run_roll_batch(spec, s, n)
    if path in STENCIL_NATIVE_ALIASES:
        return lambda s, n: stencil_engine.run_padded_native_batch(
            spec, s, n)
    if path in ("stencil:sep", "stencil:fft"):
        family = stencil_engine.family_for_path(path)
        return lambda s, n: stencil_engine.run_family_batch(
            spec, s, n, family)
    raise ValueError(f"unknown stencil engine path {path!r} "
                     f"for workload {workload!r}")
