"""Measured candidate profiling, with the repo's timing discipline.

Counterpart of ``mpi_and_open_mp_tpu/tune/runner.py``. Every candidate is
dispatched and held against the NumPy oracle first (an engine that misses
the rule never wins, however fast), then timed by chain differencing: one
warm dispatch outside the brackets, then two brackets of ``steps`` and
``steps * mult`` steps, each the least of ``reps`` host-clock runs closed
by a sync of the stack's device (``utils.timing.sync``); the steady cost a
step is their difference over the extra steps, so launch and set-up costs
cancel (the short bracket alone where the difference is not positive).
Each timed candidate is a ``tune.candidate`` span and a
``tune.candidate{status}`` count.

The heuristic's own choice is candidate 0 and a tie keeps it (a strict
``<`` dethrones), so ``vs_heuristic`` is 1.0 or more. A candidate that
raises is a rejection with its reason, as in the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.tune import plans as plans_mod
from mpi_and_open_mp_tpu_torch.tune import space
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device
from mpi_and_open_mp_tpu_torch.utils.timing import sync

_TUNE_SEED = 46


def _build_stack(spec, shape) -> np.ndarray:
    b, ny, nx = shape
    rng = np.random.default_rng(_TUNE_SEED)
    return np.stack([spec.init(rng, (ny, nx)) for _ in range(b)]).astype(
        spec.np_dtype)


def _steady(bench_once, steps: int, mult: int, reps: int
            ) -> tuple[float, bool]:
    """Seconds a step, chain-differenced over brackets of ``steps`` and
    ``steps * mult`` (each the least of ``reps`` runs), and whether the
    difference was used."""

    def timed(n):
        best = float("inf")
        for _ in range(max(1, int(reps))):
            t0 = time.perf_counter()
            bench_once(n)
            best = min(best, time.perf_counter() - t0)
        return best

    t1, t2 = timed(steps), timed(steps * mult)
    if t2 > t1:
        return (t2 - t1) / (steps * (mult - 1)), True
    return t1 / steps, False


def _argmin(measurements: list[dict]) -> dict:
    best = measurements[0]
    for m in measurements[1:]:
        if m["steady_s_per_step"] < best["steady_s_per_step"]:
            best = m
    return best


def tune(workload: str, shape, *, steps: int = 64, store=None,
         reps: int = 2, mult: int = 5,
         parity_steps: int = plans_mod.PARITY_STEPS,
         device: str | torch.device = "cuda") -> dict:
    """One bounded tuning pass for (workload, stack shape) on ``device``:
    enumerate the legal candidates, hold each against the oracle, time the
    survivors, install the winner in this process, and with ``store`` (a
    ``PlanStore``) persist it as a ``momp-plan/1`` record, for Life with
    its launch record beside it under the same digest
    (``serve.aotcache.AOTCache(store.root).ensure``)."""
    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.obs import metrics, trace
    from mpi_and_open_mp_tpu_torch.ops import native_life
    from mpi_and_open_mp_tpu_torch.serve import aotcache

    dev = resolve_device(device)
    shape = tuple(int(x) for x in shape)
    b, ny, nx = shape
    spec = stencils.get(workload)
    stack = _build_stack(spec, shape)
    stack_t = torch.as_tensor(stack, device=dev)
    cells = b * ny * nx
    on_card = dev.type == "cuda"
    heur = space.heuristic_path(workload, shape, on_card)
    cands = space.candidates(workload, shape, on_card=on_card)
    want = [stencils.oracle_run(spec, stack[i], parity_steps)
            for i in range(b)]

    measurements, rejected = [], []
    for cand in cands:
        with trace.span("tune.candidate", workload=str(workload),
                        path=cand.path, axis_order=cand.axis_order):
            try:
                run = space.runner_for(workload, cand.path)
                got = run(stack_t, parity_steps).cpu().numpy()
                tol = stencils.parity_tol_for(
                    stencils.family_for_path(cand.path))
                ok = got.shape == stack.shape and all(
                    stencils.parity_ok(spec, got[i], want[i], **tol)
                    for i in range(b))
            except Exception as e:  # noqa: BLE001 - a candidate that
                # cannot dispatch is a rejection, never a crash
                metrics.inc("tune.candidate", status="error")
                rejected.append({
                    "path": cand.path,
                    "reason": f"{type(e).__name__}: {e}"[:200]})
                continue
            if not ok:
                metrics.inc("tune.candidate", status="parity_rejected")
                rejected.append({"path": cand.path, "reason": "parity"})
                continue

            def bench_once(n, run=run):
                sync(run(stack_t, int(n)))

            bench_once(steps)  # warm, outside the brackets
            steady, differenced = _steady(bench_once, steps, mult, reps)
            metrics.inc("tune.candidate", status="timed")
            measurements.append({
                "path": cand.path,
                "pack_layout": cand.pack_layout,
                "bucket_rounding": cand.bucket_rounding,
                "axis_order": cand.axis_order,
                "steady_s_per_step": steady,
                "cups": round(cells / steady, 1),
                "is_differenced": differenced,
            })
    if not measurements:
        raise RuntimeError(
            f"autotune found no parity-clean candidate for "
            f"{workload} {shape} (rejected: {rejected})")
    best = _argmin(measurements)
    heur_meas = next((m for m in measurements if m["path"] == heur), None)
    vs = (round(heur_meas["steady_s_per_step"]
                / best["steady_s_per_step"], 3) if heur_meas else None)

    native_life.install_planned_path(workload, shape, best["path"])
    result = {
        "workload": str(workload),
        "shape": list(shape),
        "dtype": str(spec.np_dtype),
        "steps_budget": int(steps),
        "heuristic": heur_meas,
        "heuristic_path": heur,
        "tuned": best,
        "vs_heuristic": vs,
        "measurements": measurements,
        "rejected": rejected,
    }
    if store is not None:
        key = plans_mod.fingerprint_for(workload, shape, spec.np_dtype,
                                        best["path"], device=dev)
        record = {
            "schema": plans_mod.PLAN_SCHEMA,
            "key": key,
            "choice": {
                "workload": str(workload), "shape": list(shape),
                "dtype": str(spec.np_dtype), "path": best["path"],
                "pack_layout": best["pack_layout"],
                "bucket_rounding": best["bucket_rounding"],
                "axis_order": best["axis_order"],
            },
            "heuristic": heur_meas,
            "tuned": best,
            "vs_heuristic": vs,
            "steps_budget": int(steps),
            "measurements": measurements,
            "rejected": rejected,
        }
        result["plan_file"] = store.save(record)
        result["digest"] = aotcache.digest_for(key)
        if workload == "life":
            # The plan is installed, so the cache keys the bucket with the
            # same fingerprint: <digest>.aot lands beside <digest>.plan.
            _, _, status = aotcache.AOTCache(store.root, device=dev).ensure(
                shape, spec.np_dtype)
            result["aot_export"] = status
    trace.event("tune.done", workload=str(workload), path=best["path"],
                vs_heuristic=vs or 0.0)
    return result


def tune_sharded(workload: str, shape, *, mesh=None, steps: int = 32,
                 store=None, reps: int = 2, mult: int = 5,
                 parity_steps: int = plans_mod.PARITY_STEPS,
                 device: str | torch.device = "cuda") -> dict:
    """One bounded sharded tuning pass for (workload, board shape) on
    ``mesh`` (default: ``make_mesh_2d`` over ``device``'s devices): every
    legal (layout, schedule, depth) candidate held against the oracle and
    timed as :func:`tune` times, the sequential schedule first (ties keep
    it). A mesh with no legal candidate raises."""
    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.obs import metrics, trace
    from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
    from mpi_and_open_mp_tpu_torch.serve import aotcache
    from mpi_and_open_mp_tpu_torch.stencils import engine as stencil_engine

    if mesh is None:
        mesh = mesh_lib.make_mesh_2d(device=device)
    shape = tuple(int(x) for x in shape)
    ny, nx = shape
    spec = stencils.get(workload)
    board = spec.init(np.random.default_rng(_TUNE_SEED), (ny, nx))
    want = stencils.oracle_run(spec, board, parity_steps)
    cells = ny * nx
    cands = space.sharded_candidates(workload, shape, mesh)
    if not cands:
        raise RuntimeError(
            f"no legal sharded candidate for {workload} {shape} on mesh "
            f"{dict(mesh.shape)} (1-shard axes and non-dividing layouts "
            "are gated out)")
    cands = sorted(cands, key=lambda c: c.halo_overlap != "seq")

    measurements, rejected = [], []
    for cand in cands:
        layout = cand.axis_order
        ovl = None if cand.halo_overlap == "overlap" else False
        with trace.span("tune.candidate", workload=str(workload),
                        path=cand.path, axis_order=layout,
                        halo_overlap=cand.halo_overlap):
            try:
                if cand.path.startswith("sparse_sharded:"):
                    # A fresh engine each run: the tile mask is the
                    # engine's state, and a warmer mask would time less.
                    def bench_once(n, fuse=cand.fuse_steps):
                        eng = stencils.SparseShardedEngine(
                            spec, board, mesh=mesh, layout=layout,
                            tile=space.SPARSE_SHARDED_TILE, fuse=fuse)
                        sync(eng.step(int(n)))
                        return eng

                    parity_eng = bench_once(int(parity_steps))
                    got = parity_eng.snapshot()
                    engine_stamp = parity_eng.engine_stamp
                else:
                    run, plan = stencil_engine.make_sharded_runner(
                        spec, mesh, layout, shape,
                        fuse_steps=cand.fuse_steps,
                        boundary_steps=cand.boundary_steps, overlap=ovl)
                    dev_board = torch.as_tensor(
                        np.asarray(board, spec.np_dtype), device=mesh.device)

                    def bench_once(n, run=run, dev_board=dev_board):
                        sync(run(dev_board, int(n)))

                    got = run(dev_board, int(parity_steps)).cpu().numpy()
                    engine_stamp = plan.engine
                ok = stencils.parity_ok(spec, got, want)
            except Exception as e:  # noqa: BLE001 - a rejection, not a crash
                metrics.inc("tune.candidate", status="error")
                rejected.append({
                    "path": cand.path, "halo_overlap": cand.halo_overlap,
                    "reason": f"{type(e).__name__}: {e}"[:200]})
                continue
            if not ok:
                metrics.inc("tune.candidate", status="parity_rejected")
                rejected.append({"path": cand.path,
                                 "halo_overlap": cand.halo_overlap,
                                 "reason": "parity"})
                continue
            bench_once(steps)
            steady, differenced = _steady(bench_once, steps, mult, reps)
            metrics.inc("tune.candidate", status="timed")
            measurements.append({
                "path": cand.path,
                "axis_order": layout,
                "halo_overlap": cand.halo_overlap,
                "fuse_steps": cand.fuse_steps,
                "boundary_steps": cand.boundary_steps,
                "engine": engine_stamp,
                "steady_s_per_step": steady,
                "cups": round(cells / steady, 1),
                "is_differenced": differenced,
            })
    if not measurements:
        raise RuntimeError(
            f"sharded autotune found no parity-clean candidate for "
            f"{workload} {shape} (rejected: {rejected})")
    best = _argmin(measurements)
    baseline = measurements[0]  # the seq leg, sorted first
    vs = round(baseline["steady_s_per_step"]
               / best["steady_s_per_step"], 3)
    # The coupled-depth heuristic (overlap at depth 1) is in every race
    # where overlap is legal; elsewhere the sequential baseline is it.
    heur = next((m for m in measurements
                 if m["halo_overlap"] == "overlap"
                 and m["fuse_steps"] == 1), baseline)
    vs_heur = round(heur["steady_s_per_step"]
                    / best["steady_s_per_step"], 3)

    py, px = (mesh.shape.get("y", 1), mesh.shape.get("x", 1))
    result = {
        "workload": str(workload),
        "shape": list(shape),
        "dtype": str(spec.np_dtype),
        "mesh_axes": [py, px],
        "steps_budget": int(steps),
        "baseline": baseline,
        "heuristic": heur,
        "tuned": best,
        "vs_sequential": vs,
        "vs_heuristic": vs_heur,
        "measurements": measurements,
        "rejected": rejected,
    }
    if store is not None:
        key = plans_mod.fingerprint_for(workload, shape, spec.np_dtype,
                                        best["path"], device=mesh.device)
        record = {
            "schema": plans_mod.PLAN_SCHEMA,
            "key": key,
            "choice": {
                "workload": str(workload), "shape": list(shape),
                "dtype": str(spec.np_dtype), "path": best["path"],
                "pack_layout": "-",
                "bucket_rounding": space.BUCKET_POW2,
                "axis_order": best["axis_order"],
                "halo_overlap": best["halo_overlap"],
                "fuse_steps": best["fuse_steps"],
                "boundary_steps": best["boundary_steps"],
                "mesh_axes": [py, px],
                # A sparse winner's parity gate rebuilds the engine at the
                # profiled tile.
                **({"tile": space.SPARSE_SHARDED_TILE}
                   if best["path"].startswith("sparse_sharded:") else {}),
            },
            "heuristic": heur,
            "tuned": best,
            "vs_heuristic": vs_heur,
            "vs_sequential": vs,
            "steps_budget": int(steps),
            "measurements": measurements,
            "rejected": rejected,
        }
        result["plan_file"] = store.save(record)
        result["digest"] = aotcache.digest_for(key)
    trace.event("tune.sharded.done", workload=str(workload),
                path=best["path"], axis_order=best["axis_order"],
                halo_overlap=best["halo_overlap"],
                fuse_steps=best["fuse_steps"],
                boundary_steps=best["boundary_steps"],
                vs_sequential=vs, vs_heuristic=vs_heur)
    return result
