"""Time the RDMA ghost rung (``MOMP_HALO_RDMA=1``) of one checkout on the card.

    python3 rung_times.py [--root DIR] [--steps N] [--only NAME] [--json PATH]

Imports ``mpi_and_open_mp_tpu_torch`` from DIR (by default this script's
own checkout), builds its kernels there, and runs p46gun_big on the rung's
three geometries of ``chip_smoke.py`` phases 17-18: ``native`` on cart 4x2
and row 4, and ``halo`` on cart 4x2, each stamped ``overlap:rdma``
(``--only "native row 4"``, repeatable, keeps the named ones). For each it
reports:

- us a step from CUDA events around ``LifeSim._advance`` of N + 200 and
  200 steps, differenced, best of three (N = 1000 by default);
- the launches of every counted kernel wrapper the checkout has
  (``halo_frame``, ``edge_pair``, the Life rule) over N steps, per step;
- device kernels a step and the idle share, from a ``torch.profiler``
  trace of 200 steps;

and checks that 200 steps give the board that the same run gives under
``overlap:deferred``. To compare two checkouts, unpack the other into the
ignored ``build/`` (``git archive <commit> | tar -x -C build/parent``) and
run ``python3 rung_times.py --root build/parent`` and ``python3
rung_times.py`` one after the other on one card, in the order parent,
change, change, parent. Prints the card's name and power limit, then one
JSON line (also written to PATH with ``--json``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
RUNS = [("native cart 4x2", "cart", (4, 2), "native"),
        ("native row 4", "row", (4,), "native"),
        ("halo cart 4x2", "cart", (4, 2), "halo")]


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
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--only", action="append", default=None,
                    choices=[r[0] for r in RUNS])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rung_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _helpers()
    from mpi_and_open_mp_tpu_torch import LifeSim, load_config
    from mpi_and_open_mp_tpu_torch.ops import native_halo as nh
    from mpi_and_open_mp_tpu_torch.ops import native_life as nl
    from mpi_and_open_mp_tpu_torch.parallel import mesh as pm
    from torch.profiler import ProfilerActivity, profile

    if not os.path.abspath(nh.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {nh.__file__}, not from {root}")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    wrappers = {"edge_pair": nh.edge_pair,
                "life_padded": nl.life_step_padded_native}
    if hasattr(nh, "halo_frame"):
        wrappers["halo_frame"] = nh.halo_frame
    board = load_config(os.path.join(HERE, "configs",
                                     "gun_big_500x500.cfg")).board()

    def sim(layout, shape, impl, rdma):
        os.environ["MOMP_HALO_RDMA"] = "1" if rdma else "0"
        cfg = load_config(os.path.join(HERE, "configs",
                                       "gun_big_500x500.cfg"))
        mesh = (pm.make_mesh_2d(*shape) if layout == "cart"
                else pm.make_mesh_1d(shape[0], axis="y"))
        return LifeSim(cfg, layout=layout, impl=impl, mesh=mesh,
                       initial_board=board)

    n = args.steps
    out = {}
    for what, layout, shape, impl in RUNS:
        if args.only and what not in args.only:
            continue
        rung = sim(layout, shape, impl, True)
        deferred = sim(layout, shape, impl, False)
        if (rung.plan_note, deferred.plan_note) != ("overlap:rdma",
                                                    "overlap:deferred"):
            raise AssertionError(f"{what}: stamped {rung.plan_note} and "
                                 f"{deferred.plan_note}")
        if not torch.equal(rung._advance(rung.board, 200),
                           deferred._advance(deferred.board, 200)):
            raise AssertionError(f"{what}: the rung's board differs from "
                                 "the deferred schedule's")
        us = min((cs.cuda_ms(lambda: rung._advance(rung.board, n + 200))
                  - cs.cuda_ms(lambda: rung._advance(rung.board, 200)))
                 / n * 1e3 for _ in range(3))
        _, counts = cs.run_counted(wrappers,
                                   lambda: rung._advance(rung.board, n))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = time.perf_counter()
            rung._advance(rung.board, 200)
            torch.cuda.synchronize()
            wall = time.perf_counter() - wall
        kernels = [ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(ev.time_range.elapsed_us() for ev in kernels)
        rec = {"us_per_step": us,
               "launches_per_step": {k: c / n for k, c in counts.items()},
               "device_kernels_per_step": len(kernels) / 200,
               "idle_share": 1 - busy / (wall * 1e6)}
        out[what] = rec
        print(f"  {what}: {us:.4f} us/step (differenced {n + 200}-200, best "
              f"of 3); launches a step "
              + ", ".join(f"{k} {v:g}"
                          for k, v in rec["launches_per_step"].items())
              + f"; {rec['device_kernels_per_step']:.3f} device kernels a "
              f"step, idle share {rec['idle_share']:.3f} (profiler, 200 "
              f"steps) [{card}]", flush=True)
    result = {"root": root, "card": card, "steps": n, "rung": out}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
