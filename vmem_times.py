"""Time the ``bitlife_vmem`` kernel of one checkout on the card.

    python3 vmem_times.py [--root DIR] [--steps N] [--reps N] [--sweep]
                          [--json PATH]

Imports ``mpi_and_open_mp_tpu_torch`` from DIR (by default this script's
own checkout), builds its ``bitlife_vmem`` kernel there (printing each
kernel's registers and spills from ``-Xptxas -v``), and times one launch of
N steps (10 000, the main path's) at p46gun_big and at the shapes of
``chip_smoke.py`` phase 2 (:data:`SHAPES`), on random soups packed as the
main path packs them. Each time comes three ways: device time from a
``torch.profiler`` trace of ``--reps`` launches
(``chip_smoke.py:device_ms``), CUDA events around the same launches, and
us a step from CUDA events around 2000 and 12 000 steps, differenced. A
checkout that chooses a launch geometry (``vmem_launch_geometry``) also
prints it and the bound for the SMs its blocks occupy. To compare two
checkouts, run it on both, one after the other on one card, in the order
parent, change, change, parent.

``--sweep`` (a checkout whose ``vmem_steps`` takes a geometry) also runs
every candidate geometry (``vmem_candidates``) at each shape: each one
first word for word against the plain version at steps in {1, 7, 129},
then timed at 2000 steps by CUDA events, and marks the one
``vmem_launch_geometry`` chooses; then fits the chooser's per-step model
(``_vmem_step_model_us``'s constants) to every candidate's us a step by
least squares and prints the fit. Prints the card's name and power limit,
then one JSON line (also written to PATH with ``--json``).
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

# (what, ny, nx): p46gun_big (its own board) and chip_smoke.py phase 2's
# shapes (random soups).
SHAPES = [("p46gun_big", 500, 500), ("37x45", 37, 45), ("62x1000", 62, 1000),
          ("95x130", 95, 130), ("254x300", 254, 300), ("255x300", 255, 300),
          ("30x8", 30, 8), ("10x10", 10, 10), ("40x1", 40, 1),
          ("16400x24 (tall)", 16400, 24)]
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


def _features(nw: int, geo) -> list[float]:
    """The terms of ``_vmem_step_model_us``, in the order of its
    constants: floor, warps of a segment's row, words a thread, segments >
    1, a strip refresh per ghost steps, a warp refresh per warp_ghost
    steps."""
    return [1.0, geo.warps, -(-nw // geo.segments),
            1.0 if geo.segments > 1 else 0.0, 1.0 / geo.ghost,
            1.0 / geo.warp_ghost if geo.warps > 1 else 0.0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vmem_times: no CUDA device", file=sys.stderr)
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
    log = _build.build(["bitlife_vmem"], force=True)["bitlife_vmem"]
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    chooses = hasattr(tb, "vmem_launch_geometry")
    out, fit_rows = {}, []
    for i, (what, ny, nx) in enumerate(SHAPES):
        if what == "p46gun_big":
            board = torch.from_numpy(load_config(os.path.join(
                HERE, "configs", "gun_big_500x500.cfg")).board()).cuda()
        else:
            board = cs.soup((ny, nx), 300 + i)
        packed = tb.pack_board(board)

        def launch(n=args.steps, geo=None):
            if geo is None:
                return tb.vmem_steps(packed, ny, n)
            return tb.vmem_steps(packed, ny, n, geometry=geo)

        launch(100)  # builds on first use, then a warm-up
        dev = cs.device_ms(launch, args.reps, "bitlife_vmem")
        events = cs.cuda_ms(launch, args.reps)
        us = min((cs.cuda_ms(lambda: launch(12000))
                  - cs.cuda_ms(lambda: launch(2000))) / 10000 * 1e3
                 for _ in range(2))
        words = packed.numel()
        bound, by = cs.bound_ms(cs.OPS_PER_WORD_STEP * words * args.steps,
                                2 * 4 * words)
        rec = {"shape": [ny, nx], "words": words, "steps": args.steps,
               "device_ms": dev, "events_ms": events, "us_per_step": us,
               "bound_ms_card": bound, "bound_by": by}
        line = (f"  {what} ({ny}, {nx}), {words} words, {args.steps} steps: "
                f"device {dev:.4f} ms, events {events:.4f} ms a launch, "
                f"{us:.4f} us/step (differenced 12000-2000); bound "
                f"{bound:.4f} ms for the card")
        if chooses:
            geo = tb.vmem_launch_geometry(ny, nx)
            sms = geo.strips
            rec.update(geometry=list(geo.args()), threads=geo.threads,
                       smem_bytes=geo.smem_bytes, reason=geo.reason,
                       bound_ms_occupied=bound * cs.N_SMS / sms)
            line += (f", {bound * cs.N_SMS / sms:.4f} ms for its {sms} "
                     f"SMs; (strips, cluster, g, rt, tau) = {geo.args()}, "
                     f"{geo.threads} threads ({geo.reason})")
        print(line + f" [{card}]", flush=True)
        if args.sweep and chooses and not tb.vmem_launch_geometry(
                ny, nx).one_block:
            chosen = tb.vmem_launch_geometry(ny, nx)
            want = {n: tb._vmem_steps_plain(packed, ny, n)
                    for n in (1, 7, 129)}
            nw = tb.n_words(ny)
            sweep = []
            for geo in tb.vmem_candidates(ny, nx):
                for n, w in want.items():
                    bad = int((launch(n, geo) != w).sum())
                    if bad:
                        raise AssertionError(
                            f"{what}: geometry {geo.args()} steps={n}: {bad} "
                            "words differ from the plain version")
                t = cs.cuda_ms(lambda geo=geo: launch(SWEEP_STEPS, geo), 3)
                t_us = t / SWEEP_STEPS * 1e3
                mine = geo.args() == chosen.args()
                sweep.append({"geometry": list(geo.args()),
                              "threads": geo.threads, "us_per_step": t_us,
                              "chosen": mine})
                fit_rows.append((_features(nw, geo), t_us))
            sweep.sort(key=lambda r: r["us_per_step"])
            rank = next(i for i, r in enumerate(sweep) if r["chosen"])
            rec["sweep"] = sweep
            print(f"    sweep: {len(sweep)} geometries word for word at "
                  f"steps 1, 7, 129; fastest {sweep[0]['geometry']} "
                  f"{sweep[0]['us_per_step']:.4f} us/step, slowest "
                  f"{sweep[-1]['us_per_step']:.4f}; the chosen one "
                  f"{sweep[rank]['us_per_step']:.4f} (rank {rank + 1}) "
                  f"[{card}]", flush=True)
            for r in sweep[:5]:
                print(f"      {r['geometry']} threads {r['threads']}: "
                      f"{r['us_per_step']:.4f} us/step", flush=True)
        out[what] = rec
    result = {"root": root, "card": card, "steps": args.steps,
              "reps": args.reps, "bitlife_vmem": out}
    if fit_rows:
        a = np.array([f for f, _ in fit_rows])
        b = np.array([t for _, t in fit_rows])
        coef, *_ = np.linalg.lstsq(a, b, rcond=None)
        resid = a @ coef - b
        names = ["step", "per_warp", "per_word", "segments", "refresh",
                 "warp_refresh"]
        result["model_fit_us"] = dict(zip(names, coef.tolist()))
        result["model_fit_rms_us"] = float(np.sqrt((resid ** 2).mean()))
        print("  model fit (us a step): " + ", ".join(
            f"{n} {c:.4f}" for n, c in zip(names, coef))
            + f"; rms {result['model_fit_rms_us']:.4f} over "
            f"{len(fit_rows)} geometries [{card}]", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
