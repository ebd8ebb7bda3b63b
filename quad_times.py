"""Time the ``quadrature`` kernel of one checkout on the card.

    python3 quad_times.py [--root DIR]

Imports ``mpi_and_open_mp_tpu_torch`` from DIR (by default this script's
own checkout), builds its ``quadrature`` kernel there (printing each
kernel's registers and spills from ``-Xptxas -v``), and times one call of
``trapezoid_circle`` (both passes) at ``N`` trapezoids (10^12, the
reference launcher's) on 1 and 8 shards: CUDA events around ``REPS`` calls
after a warm-up, and each pass's device time from a ``torch.profiler`` trace
(``chip_smoke.py:quadrature_pass_ms``). To compare two checkouts, run it on
both, one after the other on one card, in the order parent, change,
change, parent. Prints the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SHARDS = (1, 8)
N, REPS = 10**12, 3


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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quad_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    helpers = _helpers()
    from mpi_and_open_mp_tpu_torch.ops import _build
    from mpi_and_open_mp_tpu_torch.ops import native_quadrature as nq

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log = _build.build(["quadrature"], force=True)["quadrature"]
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")
    dev = torch.device("cuda")
    rec = {"root": root, "card": card, "n": N, "shards": {}}
    for p in SHARDS:
        def call(p=p):
            return nq.trapezoid_circle(0.0, 2.0, N, p, dev)

        value = float(call())  # warm-up
        ms = helpers.cuda_ms(call, reps=REPS)
        passes = helpers.quadrature_pass_ms(call)
        rec["shards"][p] = {"value": value, "events_ms": ms,
                            "passes_device_ms": passes}
        print(f"  {root}: n={N} p={p}: {ms:.3f} ms a call (CUDA "
              f"events, {REPS} calls), passes {passes}, value "
              f"{value!r} [{card}]")
    print(card)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
