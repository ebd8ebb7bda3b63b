"""Time the resident-session pool's dispatch and lane IO of one checkout on
the card.

    python3 pool_times.py [--root DIR] [--reps N] [--json PATH]
                          [--only dispatch|lanes]

Imports ``mpi_and_open_mp_tpu_torch`` from DIR (by default this script's
own checkout), builds its ``bitlife_bitsliced`` and ``pool_lanes`` kernels
there, and runs that checkout's own ``ops.native_pool.pool_step`` (a pool
dispatch: ``s`` steps of the lanes a mask sets, and the change word of the
last step) on random one- and two-plane slabs of :data:`SHAPES` at each
step count of :data:`STEPS`, under a random lane mask. For each it gives
the dispatch's device operations by name (one ``torch.profiler`` trace of
one dispatch, the fullest of three: the card's tracer loses records) and
its device time: ``chip_smoke.py:device_span_ms``, the union of the
intervals of every device record of a trace of ``--reps`` dispatches (a
call's launches may overlap; a trace that kept none is taken again),
beside the same for ``bitsliced_steps(slab, s)`` alone, in turns
(dispatch, steps, steps, dispatch). The difference is
what the dispatch adds to row 5's steps. A checkout whose ``pool_step``
returns ``(slab, change)`` leaves its input unwritten; an older one steps
the slab in place, and the repeated calls step it on (the same work).
Then the lane IO (:data:`LANE_SHAPES`): that checkout's own
``serve.pool._lane_write`` of a pageable 0/1 numpy board into lane 31 of
a one-plane slab and ``_lane_read`` of it, as its ``SessionPool`` calls
them (through a ``_LaneRing`` where the checkout has one), write then
read, each op's device records by name (as above), its device time (the
union of its records over ``--reps`` calls, as above) and its host-clock
time (``chip_smoke.py:host_clock_ms``, :data:`LANE_HOST_CALLS` calls,
synced), beside its bound (``chip_smoke.py:lane_bound_ms`` on the link
rates ``link_rates`` measures in the same run). ``--only`` runs one of
the two sections. It
prints the card's name and power limit, a line a case, then one JSON line
(written to PATH with ``--json``). To compare two checkouts, run it on
both, one after the other on one card, in the order parent, change,
change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# (ny, nx) planes: the JAX bench's resident sessions (48^2), chip_smoke.py
# phase 6's smallest stack shape (95x130) and p46gun_big's (500^2).
SHAPES = ((48, 48), (95, 130), (500, 500))
PLANES = (1, 2)
STEPS = (1, 4, 8, 9, 100, 1000)
# The lane IO's planes: p46gun_big's and the JAX bench's sessions'.
LANE_SHAPES = ((500, 500), (48, 48))
LANE_HOST_CALLS = 200


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


def short(name: str) -> str:
    """A device record's name without return type, namespace or
    arguments."""
    return re.sub(r"^void |\(anonymous namespace\)::|\(.*$|<.*$", "",
                  name).strip()[:60]


def device_ops(fn, tries: int = 3) -> dict[str, int]:
    """The device records of one traced call of ``fn()`` by short name,
    from the fullest of ``tries`` traces."""
    from torch.profiler import ProfilerActivity, profile

    best: dict[str, int] = {}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops: dict[str, int] = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                ops[short(ev.name)] = ops.get(short(ev.name), 0) + 1
        if sum(ops.values()) > sum(best.values()):
            best = ops
    return best


def dispatch_rows(cs, args, card) -> list[dict]:
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
    from mpi_and_open_mp_tpu_torch.ops import native_pool as npl

    g = torch.Generator(device="cuda").manual_seed(25)
    rows = []
    for planes in PLANES:
        for ny, nx in SHAPES:
            slab = torch.randint(-2 ** 31, 2 ** 31, (planes, ny, nx),
                                 generator=g, device="cuda",
                                 dtype=torch.int64).to(torch.int32)
            mask = torch.randint(-2 ** 31, 2 ** 31, (planes,), generator=g,
                                 device="cuda",
                                 dtype=torch.int64).to(torch.int32)
            for steps in STEPS:
                fns = {"dispatch": lambda: npl.pool_step(slab, steps, mask),
                       "steps": lambda: tb.bitsliced_steps(slab, steps)}
                for fn in fns.values():
                    fn()
                ops = {k: device_ops(fn) for k, fn in fns.items()}
                reps = args.reps if steps < 100 else max(3, args.reps // 4)
                ms: dict[str, list] = {"dispatch": [], "steps": []}
                for which in ("dispatch", "steps", "steps", "dispatch"):
                    ms[which].append(cs.device_span_ms(
                        fns[which], reps, "", sum(ops[which].values()))[0])
                d = sum(ms["dispatch"]) / 2
                b = sum(ms["steps"]) / 2
                row = {"planes": planes, "ny": ny, "nx": nx, "steps": steps,
                       "dispatch_ms": ms["dispatch"], "steps_ms": ms["steps"],
                       "added_ms": d - b, "dispatch_ops": ops["dispatch"],
                       "steps_ops": ops["steps"]}
                rows.append(row)
                print(f"  {planes} x {ny}x{nx}, {steps} steps: dispatch "
                      f"{ms['dispatch']} ms, bitsliced_steps {ms['steps']} "
                      f"ms (device time, in turns), added {d - b:.6f} ms; "
                      f"dispatch ops {ops['dispatch']} [{card}]", flush=True)
    return rows


def lane_rows(cs, args, card, rates) -> list[dict]:
    from mpi_and_open_mp_tpu_torch.serve import pool as sp

    g = torch.Generator(device="cuda").manual_seed(26)
    rows = []
    for ny, nx in LANE_SHAPES:
        slab = torch.randint(-2 ** 31, 2 ** 31, (1, ny, nx), generator=g,
                             device="cuda", dtype=torch.int64).to(torch.int32)
        board = (np.random.default_rng(ny).random((ny, nx)) < 0.4).astype(
            np.uint8)
        ring = (sp._LaneRing((ny, nx), torch.device("cuda"))
                if hasattr(sp, "_LaneRing") else None)
        extra = () if ring is None else (ring,)
        fns = {"pool_lane_write": lambda: sp._lane_write(slab, board, 31,
                                                         *extra),
               "pool_lane_read": lambda: sp._lane_read(slab, 31, *extra)}
        for name, fn in fns.items():
            for _ in range(3):
                fn()
            ops = device_ops(fn)
            ms = cs.device_span_ms(fn, args.reps, "", sum(ops.values()))[0]
            host = cs.host_clock_ms(fn, LANE_HOST_CALLS)
            bound, term = cs.lane_bound_ms(name, ny * nx, rates)
            rows.append({"op": name, "ny": ny, "nx": nx, "device_ms": ms,
                         "host_ms": host, "ops": ops, "bound_ms": bound,
                         "bound_term": term, "share": bound / ms,
                         "ring": ring is not None})
            print(f"  {name} {ny}x{nx}: {ms:.6f} ms device (the union of "
                  f"its records {ops}), {host:.6f} ms host clock; bound "
                  f"{bound:.6f} ({term}), {bound / ms:.3f} of it, ring "
                  f"{ring is not None} [{card}]", flush=True)
        del ring
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=None)
    ap.add_argument("--only", choices=("dispatch", "lanes"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pool_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _helpers()
    from mpi_and_open_mp_tpu_torch.ops import _build
    from mpi_and_open_mp_tpu_torch.ops import native_pool as npl

    if not os.path.abspath(npl.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {npl.__file__}, not from {root}")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.build(["pool_lanes"] if args.only == "lanes"
                 else ["bitlife_bitsliced", "pool_lanes"])
    result = {"root": root, "card": card, "reps": args.reps}
    if args.only != "lanes":
        result["rows"] = dispatch_rows(cs, args, card)
    if args.only != "dispatch":
        rates = cs.link_rates()
        print(f"  link: {rates['h2d'] / 1e9:.3f} GB/s to the card, "
              f"{rates['d2h'] / 1e9:.3f} GB/s back (64 MiB page-locked "
              f"copies, CUDA events); pcie {cs.pcie_line()} [{card}]",
              flush=True)
        result["link"] = rates
        result["lanes"] = lane_rows(cs, args, card, rates)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
