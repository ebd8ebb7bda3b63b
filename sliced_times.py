"""Time the ``bitlife_bitsliced`` kernel of one checkout on the card.

    python3 sliced_times.py [--root DIR] [--steps N] [--reps N] [--sweep]
                            [--only TEXT] [--json PATH]

Imports ``mpi_and_open_mp_tpu_torch`` from DIR (by default this script's
own checkout), builds its ``bitlife_bitsliced`` kernel there (printing each
kernel's registers and spills from ``-Xptxas -v``), and times one call of N
steps (10 000, the main path's) on the board-sliced stacks of
:data:`SHAPES`: the batched main path's 64 boards of 500^2 (board 0
p46gun_big, 63 soups) and ``chip_smoke.py`` phase 4's shapes (random
soups; ``--only TEXT`` keeps the stacks whose name holds TEXT, as
``--only main`` the main path's). Each time comes two ways: device time
from a ``torch.profiler`` trace (``chip_smoke.py:device_span_ms``: the union of the kernel records'
intervals, as a call's launches may overlap) and CUDA events around
``--reps`` calls; and us a step from CUDA events around 2000 and 12 000
steps, differenced. It prints the card's name and power limit, each stack's bound for the card,
and, for a checkout that chooses a cluster geometry (``plan_bitsliced``
returning a ``SlicedGeometry``), the geometry, the bound for the SMs its
blocks occupy, and what the CUDA runtime reports for it (registers, local
bytes, shared memory, the clusters the card holds at once). To compare two
checkouts, run it on both, one after the other on one card, in the order
parent, change, change, parent.

Such a checkout also prints how many clusters of 1 to 16 blocks of 512
threads the card places at once (``cudaOccupancyMaxActiveClusters``).
``--sweep`` (a checkout with ``sliced_candidates``) also runs every
candidate geometry at the stacks of :data:`SWEEP`: each one first word for
word against the plain version at steps in {1, g + 1, k + 1} (k the halo,
or 2g + 1 without one), then timed at 2000 steps by CUDA events, and marks
the one ``plan_bitsliced`` chooses; then fits the chooser's per-step model
(``_sliced_step_model_us``'s constants) to every candidate's us a step by
least squares of the relative error and prints the fit. Then one JSON line
(written to PATH with ``--json``, the sweeps' rows too).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# (what, boards, ny, nx): the batched main path's stack and chip_smoke.py
# phase 4's (the side-by-side stacks of phase 6 among them).
SHAPES = [("64x500^2 (main path)", 64, 500, 500), ("8x500^2", 8, 500, 500),
          ("256x500^2", 256, 500, 500), ("512x500^2", 512, 500, 500),
          ("64x37x45", 64, 37, 45), ("64x95x130", 64, 95, 130),
          ("512x95x130", 512, 95, 130), ("8x1x8", 8, 1, 8),
          ("8x8x1", 8, 8, 1), ("8x2x2", 8, 2, 2)]
SWEEP = ("64x500^2 (main path)", "256x500^2", "64x37x45", "64x95x130")
SWEEP_STEPS = 2000


def _helpers():
    """``chip_smoke.py``'s timing helpers, from this script's checkout (a
    compared checkout's own ``chip_smoke.py`` may differ). Call it after the
    checkout under test is first on ``sys.path``: the helpers import the
    card's rates and bounds from its ``obs/profile.py``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launches(tb, fn) -> int:
    """Kernel launches of one call of ``fn()``, by the wrapper's count."""
    tb.bitsliced_steps.launches = 0
    fn()
    return tb.bitsliced_steps.launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sliced_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _helpers()
    from mpi_and_open_mp_tpu_torch import load_config
    from mpi_and_open_mp_tpu_torch.ops import _build
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb

    if not os.path.abspath(tb.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {tb.__file__}, not from {root}")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    log = _build.build(["bitlife_bitsliced"], force=True)["bitlife_bitsliced"]
    print(f"  built in {_build.BUILD_SECONDS['bitlife_bitsliced']:.2f} s",
          flush=True)
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    clusters = hasattr(tb, "sliced_candidates")
    out, fit_rows = {}, []
    if clusters:
        # The clusters of 1..16 blocks the card places at once, one block
        # of 512 threads a SM (the choosers' CLUSTERS_AT_ONCE).
        at_once = [tb.bitsliced_attributes(
            (1, 256, 30 * c), tb.sliced_geometry(256, 30 * c, 1, 0, c, 1, 16)
        )["max_active_clusters"] for c in range(1, 17)]
        out["clusters_at_once"] = at_once
        print(f"  clusters of 1..16 blocks the card holds at once (one "
              f"512-thread block a SM): {at_once} [{card}]", flush=True)
    for i, (what, b, ny, nx) in enumerate(SHAPES):
        if args.only not in what:
            continue
        cells = cs.soup((b, ny, nx), 500 + i)
        if what.endswith("(main path)"):
            cells[0] = torch.from_numpy(load_config(os.path.join(
                HERE, "configs", "gun_big_500x500.cfg")).board()).cuda()
        planes = tb.pack_batch_bits(cells)
        del cells

        def call(n=args.steps, geo=None):
            if geo is None:
                return tb.bitsliced_steps(planes, n)
            return tb.bitsliced_steps(planes, n, geometry=geo)

        call(100)  # builds on first use, then a warm-up
        launches = _launches(tb, call)
        # At least 30 launches a trace: the card's tracer can lose every
        # record of a short one.
        reps = max(args.reps, -(-30 // launches))
        try:
            dev, kept = cs.device_span_ms(call, reps, "bitlife_bitsliced",
                                          launches)
        except RuntimeError as e:
            print(f"  {what}: device time not measured ({e})", flush=True)
            dev, kept = None, 0
        events = cs.cuda_ms(call, args.reps)
        us = min((cs.cuda_ms(lambda: call(12000))
                  - cs.cuda_ms(lambda: call(2000))) / 10000 * 1e3
                 for _ in range(2))
        words = planes.numel()
        bound, by = cs.bound_ms(
            cs.OPS_PER_SLICED_WORD_STEP * words * args.steps, 2 * 4 * words)
        rec = {"boards": b, "planes": list(planes.shape), "words": words,
               "steps": args.steps, "launches": launches, "device_ms": dev,
               "device_records_kept": kept,
               "events_ms": events, "us_per_step": us,
               "bound_ms_card": bound, "bound_by": by}
        dev_text = ("not measured" if dev is None else
                    f"{dev:.4f} ms ({kept} of {reps * launches} records)")
        line = (f"  {what} {tuple(planes.shape)}, {args.steps} steps in "
                f"{launches} launches: device {dev_text}, events "
                f"{events:.4f} ms a call, {us:.4f} us/step (differenced "
                f"12000-2000); bound {bound:.4f} ms for the card")
        plan = tb.plan_bitsliced(tuple(planes.shape))
        if clusters:
            blocks = planes.shape[0] * plan.bands * plan.strips
            sms = min(blocks, cs.N_SMS)
            at = tb.bitsliced_attributes(tuple(planes.shape), plan)
            stepped = blocks * plan.window_rows * (
                -(-nx // plan.strips) + 2 * plan.ghost)
            rec.update(geometry=dataclasses.asdict(plan),
                       bound_ms_occupied=bound * cs.N_SMS / sms,
                       stepped_over_useful=stepped / words, runtime=at,
                       waves=tb.sliced_waves(planes.shape[0], plan))
            line += (f", {bound * cs.N_SMS / sms:.4f} ms for its {sms} SMs; "
                     f"(bands, halo, strips, cluster, g, rt, ct, tau) = "
                     f"{plan.args()}, {plan.threads} threads, "
                     f"{stepped / words:.3f}x the useful words stepped, "
                     f"{at['registers']} registers, {at['local_bytes']} "
                     f"local bytes, {at['dynamic_smem_bytes']} bytes shared, "
                     f"the card holds {at['max_active_clusters']} clusters "
                     f"at once ({plan.reason})")
        else:
            rec["tile"] = [plan.tr, plan.tc, plan.k]
            line += f"; tile {plan.tr}x{plan.tc}, k = {plan.k}"
        print(line + f" [{card}]", flush=True)
        if args.sweep and clusters and what in SWEEP:
            npl = planes.shape[0]
            want: dict[int, torch.Tensor] = {}
            sweep = []
            for geo in tb.sliced_candidates(tuple(planes.shape)):
                k = geo.halo or 2 * geo.ghost + 1
                for n in sorted({1, geo.ghost + 1, k + 1}):
                    if n not in want:
                        want[n] = tb._bitsliced_steps_plain(planes, n)
                    bad = int((call(n, geo) != want[n]).sum())
                    if bad:
                        raise AssertionError(
                            f"{what}: geometry {geo.args()} steps={n}: {bad} "
                            "words differ from the plain version")
                t = cs.cuda_ms(lambda geo=geo: call(SWEEP_STEPS, geo), 3)
                t_us = t / SWEEP_STEPS * 1e3
                mine = geo.args() == plan.args()
                sweep.append({"geometry": list(geo.args()),
                              "threads": geo.threads, "us_per_step": t_us,
                              "model_us": tb._sliced_step_model_us(npl, geo),
                              "chosen": mine})
                fit_rows.append((tb._sliced_features(npl, geo), t_us))
            sweep.sort(key=lambda r: r["us_per_step"])
            rank = next(i for i, r in enumerate(sweep) if r["chosen"])
            rec["sweep"] = sweep
            print(f"    sweep: {len(sweep)} geometries word for word at "
                  f"steps 1, g + 1, k + 1; fastest {sweep[0]['geometry']} "
                  f"{sweep[0]['us_per_step']:.4f} us/step, slowest "
                  f"{sweep[-1]['us_per_step']:.4f}; the chosen one "
                  f"{sweep[rank]['us_per_step']:.4f} (rank {rank + 1}) "
                  f"[{card}]", flush=True)
            for r in sweep[:8]:
                at = tb.bitsliced_attributes(
                    tuple(planes.shape), tb.sliced_geometry(
                        ny, nx, *r["geometry"][:3], *r["geometry"][4:]))
                print(f"      {r['geometry']} threads {r['threads']}: "
                      f"{r['us_per_step']:.4f} us/step (model "
                      f"{r['model_us']:.4f}), {at['registers']} registers, "
                      f"the card holds {at['max_active_clusters']} clusters",
                      flush=True)
        out[what] = rec
        del planes
        torch.cuda.empty_cache()
        result = {"root": root, "card": card, "steps": args.steps,
                  "reps": args.reps, "bitlife_bitsliced": out}
        if args.json:  # after every stack, so a cut run keeps what it got
            with open(args.json, "w") as f:
                json.dump(result, f, indent=1)
    if fit_rows:
        a = np.array([f for f, _ in fit_rows])
        b = np.array([t for _, t in fit_rows])
        # Least squares of the relative error: the times span 0.2-75 us.
        coef, *_ = np.linalg.lstsq(a / b[:, None], np.ones_like(b),
                                   rcond=None)
        rel = np.abs(a @ coef / b - 1)
        names = ["launch", "step", "warp_word", "refresh", "warp_refresh"]
        result["model_fit_us"] = dict(zip(names, coef.tolist()))
        result["model_fit_median_rel_err"] = float(np.median(rel))
        print("  model fit (us a step): " + ", ".join(
            f"{n} {c:.4f}" for n, c in zip(names, coef))
            + f"; median relative error {np.median(rel):.3f} over "
            f"{len(fit_rows)} geometries [{card}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    # The sweeps' rows only in the --json file.
    for rec in out.values():
        if isinstance(rec, dict):
            rec.pop("sweep", None)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
