"""Time the ``stencil_padded`` kernel of one checkout on the card.

    python3 stencil_times.py [--root DIR] [--reps N]

Imports ``mpi_and_open_mp_tpu_torch`` from DIR (by default this script's
own checkout), builds its ``stencil_padded`` kernel there, and times one
launch at the shapes of the main paths: each registered stencil spec over
a 64 x 500^2 stack torus-padded (gray_scott: one 500^2 board, as
``chip_smoke.py`` phase 9 times it), and the Life rule over an
(8, 127, 252) uint8 block (the shape of cart 4x2's padded shards of a
500^2 board, here random cells). Each time comes two ways, over N
launches: device time from a ``torch.profiler`` trace, and CUDA events
around the N back-to-back launches (which also take in the host's time
between launches). Prints the card's name and power limit, then one JSON
line. To compare two checkouts, run it on both, one after the other on
one card, in the order parent, change, change, parent.
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
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stencil_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _helpers()
    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.ops import native_stencil as ns
    from mpi_and_open_mp_tpu_torch.stencils import engine as se

    if not os.path.abspath(ns.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {ns.__file__}, not from {root}")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    rng = np.random.default_rng(46)
    cases = {}
    for name in stencils.names():
        spec = stencils.get(name)
        shape = (500, 500) if spec.channels > 1 else (64, 500, 500)
        board = (spec.init(rng, shape) if spec.channels > 1 else
                 np.stack([spec.init(rng, shape[1:]) for _ in range(64)]))
        cases[name] = (spec, se.torus_pad(torch.from_numpy(board).cuda(),
                                          spec.radius))
    life = stencils.get("life")
    cases["life_shards"] = (life, torch.from_numpy(
        rng.integers(0, 2, (8, 127, 252), dtype=np.uint8)).cuda())
    out = {}
    for name, (spec, padded) in cases.items():
        def launch():
            return ns.stencil_step_padded(spec, padded)

        launch()  # builds on first use, then a warm-up
        dev = cs.device_ms(launch, args.reps, "stencil_padded")
        events = cs.cuda_ms(launch, args.reps)
        out[name] = {"shape": "x".join(map(str, padded.shape)),
                     "device_ms": dev, "events_ms": events}
        print(f"  {name} {tuple(padded.shape)}: device {dev:.4f} ms, "
              f"events {events:.4f} ms a launch [{card}]", flush=True)
    print(json.dumps({"root": root, "card": card, "reps": args.reps,
                      "stencil_padded": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
