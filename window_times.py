"""Time the ``bitlife_window`` kernel of one checkout on the card.

    python3 window_times.py [--root DIR] [--reps N] [--sweep] [--runners]
                            [--json PATH]

Imports ``mpi_and_open_mp_tpu_torch`` from DIR (by default this script's
own checkout), builds its ``bitlife_window`` kernel there, and times one
launch at k = k_max at the five shard-window shapes of ``chip_smoke.py``
phase 13: p46gun_big's windows on row 8, col 8 and cart 4x2 (8 windows
each) and the interior and edge windows of the 1024^2 row-2 overlap split
(2 each), on random words. Each time comes two ways, over N launches:
device time from a ``torch.profiler`` trace (``chip_smoke.py:device_ms``)
and CUDA events around the N back-to-back launches (which also take in
the host's time between launches). To compare two checkouts, run it on
both, one after the other on one card, in the order parent, change,
change, parent.

``--runners`` also times the checkout's ``bitfused`` sharded runners on
p46gun_big (row 8, col 8, cart 4x2; ``LifeSim._advance``): us a step from
CUDA events around 2000 and 12000 steps, differenced, best of three, as
``chip_smoke.py`` phase 15 takes them.

``--sweep`` (a checkout whose ``window_steps`` takes a geometry) also runs
every candidate geometry of :func:`candidates` at each shape: each one
first bit for bit against the plain version at k in {1, 7, k_max}, then
timed by device time, and marks the one ``window_launch_geometry``
chooses. Prints the card's name and power limit, then one JSON line
(also written to PATH with ``--json``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


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


def candidates(tb, R: int, C: int, k: int) -> list:
    """The geometries the sweep tries for k steps of (R, C) windows: every
    compiled rows-per-thread that splits a column into segments of nearly
    equal height, under clusters of 8 and 16 strips exchanging every 2 to
    16 steps and ghost-zone strips (ghost = k, no exchange) at 16 and 32
    strips; the illegal ones left out."""
    rts = sorted({min(r for r in tb.WINDOW_ROWS_PER_THREAD
                      if r >= -(-R // P))
                  for P in range(1, R + 1)
                  if -(-R // P) <= max(tb.WINDOW_ROWS_PER_THREAD)})
    tries = [(s, g) for s in (8, 16) for g in (4, 8, 16) if g < k]
    tries += [(s, max(k, 1)) for s in (16, 32)]
    out = []
    for rt in rts:
        for strips, g in tries:
            for tau in (1, 2, 4, 8):
                try:
                    out.append(tb.window_geometry(R, C, k, strips, g, rt,
                                                  tau))
                except ValueError:
                    pass
    return out


def runners(cs, card) -> dict[str, float]:
    """us a step of the checkout's bitfused runners on p46gun_big."""
    import numpy as np

    from mpi_and_open_mp_tpu_torch import LifeSim, load_config
    from mpi_and_open_mp_tpu_torch.parallel import mesh as pm
    from mpi_and_open_mp_tpu_torch.utils.config import LifeConfig

    board = load_config(os.path.join(HERE, "configs",
                                     "gun_big_500x500.cfg")).board()
    ny, nx = board.shape
    out = {}
    for layout, shape in (("row", (8,)), ("col", (8,)), ("cart", (4, 2))):
        mesh = (pm.make_mesh_2d(*shape) if layout == "cart" else
                pm.make_mesh_1d(shape[0], axis="x" if layout == "col"
                                else "y"))
        cfg = LifeConfig(steps=12000, save_steps=0, nx=nx, ny=ny,
                         cells=np.zeros((0, 2), np.int64))
        sim = LifeSim(cfg, layout=layout, impl="bitfused", mesh=mesh,
                      initial_board=board)
        sim._advance(sim.board, 2000)  # warm-up
        us = min((cs.cuda_ms(lambda: sim._advance(sim.board, 12000))
                  - cs.cuda_ms(lambda: sim._advance(sim.board, 2000)))
                 / 10000 * 1e3 for _ in range(3))
        out[f"bitfused {layout}"] = us
        print(f"  runner bitfused {layout} p46gun_big: {us:.4f} us/step "
              f"(differenced 12000-2000, best of 3) [{card}]", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--runners", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("window_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _helpers()
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb

    if not os.path.abspath(tb.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {tb.__file__}, not from {root}")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for what, shards, nw, W, h, hx in cs.window_shapes(tb):
        R, C = nw + 2 * h, W + 2 * hx
        ext = torch.randint(-2 ** 31, 2 ** 31 - 1, (shards, R, C),
                            generator=gen, device="cuda", dtype=torch.int32)
        k = tb.window_max_steps(h, hx)

        def launch(geo=None):
            if geo is None:
                return tb.window_steps(ext, k, h, hx)
            return tb.window_steps(ext, k, h, hx, geometry=geo)

        launch()  # builds on first use, then a warm-up
        dev = cs.device_ms(launch, args.reps, "bitlife_window")
        events = cs.cuda_ms(launch, args.reps)
        rec = {"shape": f"{shards}x{R}x{C}", "k": k, "device_ms": dev,
               "events_ms": events}
        line = (f"  {what} {shards}x{R}x{C} k={k}: device {dev:.4f} ms, "
                f"events {events:.4f} ms a launch")
        if hasattr(tb, "window_launch_geometry"):
            chosen = tb.window_launch_geometry(shards, R, C, k)
            rec["geometry"] = chosen.args()
            line += f" (strips, cluster, g, rt, tau) = {chosen.args()}"
        print(line + f" [{card}]", flush=True)
        if args.sweep:
            sweep = []
            want = {kk: tb._window_steps_plain(ext, kk, h, hx)
                    for kk in sorted({1, 7, k})}
            for geo in candidates(tb, R, C, k):
                for kk in want:
                    got = tb.window_steps(ext, kk, h, hx, geometry=geo)
                    bad = int((got != want[kk]).sum())
                    if bad:
                        raise AssertionError(
                            f"{what}: geometry {geo.args()} k={kk}: {bad} "
                            "words differ from the plain version")
                t = cs.device_ms(lambda geo=geo: launch(geo), 20,
                                 "bitlife_window")
                sweep.append({"geometry": geo.args(), "threads": geo.threads,
                              "device_ms": t})
                print(f"    {geo.args()} threads {geo.threads}: {t:.4f} ms",
                      flush=True)
            sweep.sort(key=lambda r: r["device_ms"])
            rec["sweep"] = sweep
            print(f"    fastest {sweep[0]['geometry']} "
                  f"{sweep[0]['device_ms']:.4f} ms [{card}]", flush=True)
        out[what] = rec
    result = {"root": root, "card": card, "reps": args.reps,
              "bitlife_window": out}
    if args.runners:
        result["runners_us_per_step"] = runners(cs, card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
