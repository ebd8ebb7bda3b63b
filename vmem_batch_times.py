"""Time the ``bitlife_vmem_batch`` kernel of one checkout on the card.

    python3 vmem_batch_times.py [--root DIR] [--steps N] [--reps N]
                                [--sweep] [--json PATH]

Imports ``mpi_and_open_mp_tpu_torch`` from DIR (by default this script's
own checkout), builds its ``bitlife_vmem_batch`` kernel there (printing
each kernel's registers and spills from ``-Xptxas -v``), and times one
launch of N steps (10 000, the main path's) on the cell-packed stacks of
:data:`SHAPES`: the batched main path's ``"vmem-grid"`` stack of 4 boards
of 500^2 (board 0 p46gun_big, 3 soups) and more stacks of random soups.
Each time comes three ways: device time from a ``torch.profiler`` trace of
``--reps`` launches (``chip_smoke.py:device_ms``), CUDA events around the
same launches, and us a step from CUDA events around 2000 and 12 000
steps, differenced. It prints the card's name and power limit and each
stack's bound for the card; a checkout that chooses a geometry
(``vmem_batch_launch_geometry``) also prints it, its waves, the bound for
the SMs its blocks occupy, and what the CUDA runtime reports for it
(registers, local bytes, shared memory, the clusters the card places at
once). To compare two checkouts, run it on
both, one after the other on one card, in the order parent, change,
change, parent.

``--sweep`` (a checkout with ``vmem_batch_candidates``) also runs every
candidate geometry at the stacks of :data:`SWEEP`: each one first word for
word against the plain version at steps in {1, g + 1, 2g + 3}, then timed
at 2000 steps by CUDA events, with the clusters the card places at once
(``cudaOccupancyMaxActiveClusters``), and marks the one the chooser picks;
then fits the chooser's per-step model (``_vmem_batch_step_model_us``'s
constants) to the us a step of every candidate that runs in one wave
(``vmem_batch_waves``) by least squares of the relative error and prints
the fit. Then one JSON line (written to PATH with ``--json``, the sweeps'
rows too).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# (what, boards, ny, nx): the batched main path's "vmem-grid" stack, and
# stacks of chip_smoke.py's shapes from one board to several waves.
SHAPES = [("4x500^2 (main path)", 4, 500, 500), ("1x500^2", 1, 500, 500),
          ("7x500^2", 7, 500, 500), ("16x500^2", 16, 500, 500),
          ("32x500^2", 32, 500, 500), ("64x500^2", 64, 500, 500),
          ("128x500^2", 128, 500, 500), ("256x500^2", 256, 500, 500),
          ("8x95x130", 8, 95, 130), ("16x95x130", 16, 95, 130),
          ("64x95x130", 64, 95, 130), ("4x37x45", 4, 37, 45),
          ("64x37x45", 64, 37, 45), ("2x254x300", 2, 254, 300)]
SWEEP = tuple(what for what, *_ in SHAPES)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vmem_batch_times: no CUDA device", file=sys.stderr)
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
    log = _build.build(["bitlife_vmem_batch"], force=True)["bitlife_vmem_batch"]
    print(f"  built in {_build.BUILD_SECONDS['bitlife_vmem_batch']:.2f} s",
          flush=True)
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    chooses = hasattr(tb, "vmem_batch_launch_geometry")
    out, fit_rows = {}, []
    for i, (what, b, ny, nx) in enumerate(SHAPES):
        cells = cs.soup((b, ny, nx), 700 + i)
        if what.endswith("(main path)"):
            cells[0] = torch.from_numpy(load_config(os.path.join(
                HERE, "configs", "gun_big_500x500.cfg")).board()).cuda()
        packed = tb.pack_boards(cells)
        del cells

        def launch(n=args.steps, geo=None):
            if geo is None:
                return tb.vmem_batch_steps(packed, ny, n)
            return tb.vmem_batch_steps(packed, ny, n, geometry=geo)

        launch(100)  # builds on first use, then a warm-up
        try:
            dev = cs.device_ms(launch, args.reps, "bitlife_vmem")
        except RuntimeError as e:  # the tracer kept no record
            print(f"  {what}: device time not measured ({e})", flush=True)
            dev = None
        events = cs.cuda_ms(launch, args.reps)
        us = min((cs.cuda_ms(lambda: launch(12000))
                  - cs.cuda_ms(lambda: launch(2000))) / 10000 * 1e3
                 for _ in range(2))
        words = packed.numel()
        bound, by = cs.bound_ms(cs.OPS_PER_WORD_STEP * words * args.steps,
                                2 * 4 * words)
        rec = {"boards": b, "shape": [ny, nx], "words": words,
               "steps": args.steps, "device_ms": dev, "events_ms": events,
               "us_per_step": us, "bound_ms_card": bound, "bound_by": by}
        dev_text = "not measured" if dev is None else f"{dev:.4f} ms"
        line = (f"  {what}, {words} words, {args.steps} steps: device "
                f"{dev_text}, events {events:.4f} ms a launch, {us:.4f} "
                f"us/step (differenced 12000-2000); bound {bound:.4f} ms for "
                "the card")
        if chooses:
            geo = tb.vmem_batch_launch_geometry(b, ny, nx)
            sms = min(cs.N_SMS, b * geo.strips)
            at = tb.vmem_batch_attributes(b, ny, nx, geo)
            rec.update(geometry=list(geo.args()), threads=geo.threads,
                       smem_bytes=geo.smem_bytes, reason=geo.reason,
                       waves=tb.vmem_batch_waves(b, geo),
                       bound_ms_occupied=bound * cs.N_SMS / sms, runtime=at)
            line += (f", {bound * cs.N_SMS / sms:.4f} ms for its {sms} SMs; "
                     f"(strips, cluster, g, rt, tau) = {geo.args()}, "
                     f"{geo.threads} threads, {at['registers']} registers, "
                     f"{at['local_bytes']} local bytes, "
                     f"{at['dynamic_smem_bytes']} bytes shared, the card "
                     f"holds {at['max_active_clusters']} clusters at once "
                     f"({geo.reason})")
        print(line + f" [{card}]", flush=True)
        if args.sweep and chooses and what in SWEEP:
            chosen = tb.vmem_batch_launch_geometry(b, ny, nx)
            want: dict[int, torch.Tensor] = {}
            sweep = []
            for geo in tb.vmem_batch_candidates(ny, nx):
                g = max(geo.ghost, 1)
                for n in sorted({1, g + 1, 2 * g + 3}):
                    if n not in want:
                        want[n] = tb._vmem_batch_steps_plain(packed, ny, n)
                    bad = int((launch(n, geo) != want[n]).sum())
                    if bad:
                        raise AssertionError(
                            f"{what}: geometry {geo.args()} steps={n}: {bad} "
                            "words differ from the plain version")
                t = cs.cuda_ms(lambda geo=geo: launch(SWEEP_STEPS, geo), 2)
                t_us = t / SWEEP_STEPS * 1e3
                at = tb.vmem_batch_attributes(b, ny, nx, geo)
                sweep.append({"geometry": list(geo.args()),
                              "threads": geo.threads, "us_per_step": t_us,
                              "model_us": tb._vmem_batch_step_model_us(
                                  b, ny, nx, geo),
                              "registers": at["registers"],
                              "clusters_at_once": at["max_active_clusters"],
                              "waves": tb.vmem_batch_waves(b, geo),
                              "chosen": geo.args() == chosen.args()})
                if tb.vmem_batch_waves(b, geo) == 1:
                    fit_rows.append((tb._vmem_batch_features(b, ny, nx, geo),
                                     t_us))
            sweep.sort(key=lambda r: r["us_per_step"])
            rank = next(i for i, r in enumerate(sweep) if r["chosen"])
            rec["sweep"] = sweep
            print(f"    sweep: {len(sweep)} geometries word for word at "
                  f"steps 1, g + 1, 2g + 3; fastest {sweep[0]['geometry']} "
                  f"{sweep[0]['us_per_step']:.4f} us/step, slowest "
                  f"{sweep[-1]['us_per_step']:.4f}; the chosen one "
                  f"{sweep[rank]['us_per_step']:.4f} (rank {rank + 1}) "
                  f"[{card}]", flush=True)
            for r in sweep[:6]:
                print(f"      {r['geometry']} threads {r['threads']}: "
                      f"{r['us_per_step']:.4f} us/step (model "
                      f"{r['model_us']:.4f}), {r['registers']} registers, "
                      f"{r['clusters_at_once']} clusters at once, "
                      f"{r['waves']} wave(s) by the model", flush=True)
            del want
        out[what] = rec
        del packed
        torch.cuda.empty_cache()
        result = {"root": root, "card": card, "steps": args.steps,
                  "reps": args.reps, "bitlife_vmem_batch": out}
        if args.json:  # after every stack, so a cut run keeps what it got
            with open(args.json, "w") as f:
                json.dump(result, f, indent=1)
    if fit_rows:
        a = np.array([f for f, _ in fit_rows])
        t = np.array([t for _, t in fit_rows])
        # Least squares of the relative error: the times span a wide range.
        coef, *_ = np.linalg.lstsq(a / t[:, None], np.ones_like(t),
                                   rcond=None)
        rel = np.abs(a @ coef / t - 1)
        result["model_fit_us"] = coef.tolist()
        result["model_fit_median_rel_err"] = float(np.median(rel))
        print("  model fit (us a step, in the order of _VMEM_BATCH_US): "
              + ", ".join(f"{c:.4f}" for c in coef)
              + f"; median relative error {np.median(rel):.3f} over "
              f"{len(fit_rows)} geometries of one wave [{card}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    # The sweeps' rows only in the --json file.
    for rec in out.values():
        rec.pop("sweep", None)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
