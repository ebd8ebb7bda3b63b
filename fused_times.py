"""Time the ``bitlife_fused`` kernel of one checkout on the card.

    python3 fused_times.py [--root DIR] [--reps N] [--sweep] [--limit N]
                           [--json PATH]

Imports ``mpi_and_open_mp_tpu_torch`` from DIR (by default this script's
own checkout), builds its ``bitlife_fused`` kernel there (printing each
kernel's registers and spills from ``-Xptxas -v``), and times one launch
of k = k_max steps at the frames of ``chip_smoke.py:fused_shapes``: the
10000^2 padded frame, 16384^2 and 4096^2 aligned, and one shard of
10000^2 on cart 2x2, on random words. Each time comes two ways, over N
launches: device time from a ``torch.profiler`` trace
(``chip_smoke.py:device_ms``) and CUDA events around the N back-to-back
launches. Beside each it prints the bound on the words written (17 INT32
operations a word and step) and, for a checkout that chooses a geometry
(``fused_launch_geometry``), the geometry, its waves, the words it steps
over the useful ones and what the CUDA runtime reports for it. To compare
two checkouts, run it on both, one after the other on one card, in the
order parent, change, change, parent.

``--sweep`` (a checkout with ``fused_candidates``) also runs candidate
geometries at each frame (:func:`sweep_candidates`; ``--limit`` takes that
many of each frame's, half the chooser's best and half spread over the
rest of its ranking): each one first
bit for bit against the plain version at k in {1, 7, k_max}, then timed
at k_max by CUDA events, with the clusters the card places at once, and
marks the one the chooser picks; then fits the chooser's model
(``_fused_features``, one coefficient a term) to every candidate's time
by least squares of the relative error and prints the fit and what the
refitted chooser would pick. Prints the card's name and power limit, then
one JSON line (also written to PATH with ``--json``).
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


def sweep_candidates(tb, plan, k: int, limit: int | None) -> list:
    """The geometries the sweep runs for k steps of the plan's frame: of
    ``fused_candidates``, for each rows-per-thread, segment count, strip
    count, ghost and copied lanes, the first; with ``limit``, the chooser's
    best ``limit // 2`` by its model and the rest evenly over the others
    (the last included), and the one it chooses."""
    seen, out = set(), []
    for geo in tb.fused_candidates(plan.nw_s, plan.W, plan.h, plan.hx, k):
        key = (geo.rows_per_thread, geo.segments, geo.strips, geo.ghost,
               geo.warp_ghost)
        if key not in seen:
            seen.add(key)
            out.append(geo)
    out.sort(key=lambda g: tb._fused_time_model_us(k, g))
    if limit and len(out) > limit:
        top, rest = out[: limit // 2], out[limit // 2 :]
        idx = np.linspace(0, len(rest) - 1, limit - len(top)).round()
        out = top + [rest[i] for i in sorted(set(idx.astype(int).tolist()))]
    chosen = tb.fused_launch_geometry(plan.nw_s, plan.W, plan.h, plan.hx, k)
    if all(g.args() != chosen.args() for g in out):
        out.insert(0, chosen)
    return out


def fit(rows) -> tuple[np.ndarray, float]:
    """Coefficients of the model's terms by least squares of the relative
    error over the sweep's rows, and the median relative error."""
    A = np.array([r["features"] for r in rows], dtype=float)
    t = np.array([r["events_us"] for r in rows], dtype=float)
    coef, *_ = np.linalg.lstsq(A / t[:, None], np.ones(len(t)), rcond=None)
    err = np.abs(A @ coef - t) / t
    return coef, float(np.median(err))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _helpers()
    from mpi_and_open_mp_tpu_torch.ops import _build
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb

    if not os.path.abspath(tb.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {tb.__file__}, not from {root}")
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    log = _build.build(["bitlife_fused"], force=True)["bitlife_fused"]
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  {line.strip()}", flush=True)
    chooses = hasattr(tb, "fused_launch_geometry")
    gen = torch.Generator(device="cuda").manual_seed(11)
    out, rows = {}, []
    for what, plan in cs.fused_shapes(tb):
        nw, W, h, hx, k = plan.nw_s, plan.W, plan.h, plan.hx, plan.k_max
        ext = torch.randint(-2 ** 31, 2 ** 31 - 1, (nw + 2 * h, W + 2 * hx),
                            generator=gen, device="cuda", dtype=torch.int32)

        def launch(geo=None, kk=k):
            if geo is None:
                return tb.fused_steps(ext, kk, plan)
            return tb.fused_steps(ext, kk, plan, geometry=geo)

        launch()  # builds on first use, then a warm-up
        dev = cs.device_ms(launch, args.reps, "bitlife_fused")
        events = cs.cuda_ms(launch, args.reps)
        bound, by = cs.bound_ms(cs.OPS_PER_WORD_STEP * nw * W * k,
                                4 * (ext.numel() + nw * W))
        rec = {"frame": [nw + 2 * h, W + 2 * hx], "interior": [nw, W],
               "k": k, "device_ms": dev, "events_ms": events,
               "bound_ms": bound, "bound_by": by}
        line = (f"  {what} frame {nw + 2 * h}x{W + 2 * hx} k={k}: device "
                f"{dev:.4f} ms, events {events:.4f} ms a launch, bound "
                f"{bound:.4f} ms ({by})")
        if chooses:
            geo = tb.fused_launch_geometry(nw, W, h, hx, k)
            at = tb.fused_attributes(plan, k, geo)
            ratio = tb.fused_stepped_words(nw, W, geo) / (nw * W)
            rec.update(geometry=list(geo.args()), segments=geo.segments,
                       warps=geo.warps,
                       waves=tb.fused_waves(geo), stepped_over_useful=ratio,
                       model_us=tb._fused_time_model_us(k, geo), **at)
            line += (f"; (bands, tiles, wall, strips, cluster, g, rt, tau) "
                     f"= {geo.args()}, {geo.threads} threads, "
                     f"{tb.fused_waves(geo)} waves, stepped/useful "
                     f"{ratio:.3f}, {at['registers']} registers, "
                     f"{at['local_bytes']} local bytes, "
                     f"{at['dynamic_smem_bytes']} bytes shared, the card "
                     f"holds {at['max_active_clusters']} clusters at once")
        print(line + f" [{card}]", flush=True)
        if args.sweep:
            want = {kk: tb._fused_steps_plain(ext, kk, plan)
                    for kk in sorted({1, 7, k})}
            sweep = []
            for geo in sweep_candidates(tb, plan, k, args.limit):
                for kk in want:
                    try:
                        g_kk = tb.fused_geometry(nw, W, h, hx, kk,
                                                 *geo.args()[:4],
                                                 *geo.args()[5:])
                    except ValueError:
                        continue
                    bad = int((launch(g_kk, kk) != want[kk]).sum())
                    if bad:
                        raise AssertionError(
                            f"{what}: geometry {g_kk.args()} k={kk}: {bad} "
                            "words differ from the plain version")
                launch(geo)
                t = cs.cuda_ms(lambda geo=geo: launch(geo), args.reps)
                at = tb.fused_attributes(plan, k, geo)
                row = {"frame": what, "geometry": list(geo.args()),
                       "segments": geo.segments, "warps": geo.warps,
                       "threads": geo.threads, "waves": tb.fused_waves(geo),
                       "registers": at["registers"],
                       "local_bytes": at["local_bytes"],
                       "max_active_clusters": at["max_active_clusters"],
                       "stepped_over_useful":
                           tb.fused_stepped_words(nw, W, geo) / (nw * W),
                       "model_us": tb._fused_time_model_us(k, geo),
                       "features": tb._fused_features(k, geo),
                       "events_us": t * 1e3}
                sweep.append(row)
                rows.append(row)
                print(f"    {geo.args()} P={geo.segments} nq={geo.warps} "
                      f"waves={row['waves']} at once "
                      f"{at['max_active_clusters']} regs {at['registers']} "
                      f"stepped {row['stepped_over_useful']:.3f}: "
                      f"{t:.4f} ms (model {row['model_us'] / 1e3:.4f})",
                      flush=True)
            sweep.sort(key=lambda r: r["events_us"])
            rec["sweep_fastest"] = sweep[0]
            print(f"    fastest {sweep[0]['geometry']} "
                  f"{sweep[0]['events_us'] / 1e3:.4f} ms of {len(sweep)} "
                  f"[{card}]", flush=True)
        out[what] = rec
        del ext
        torch.cuda.empty_cache()
    result = {"root": root, "card": card, "reps": args.reps,
              "bitlife_fused": out}
    if rows:
        coef, med = fit(rows)
        result["fit"] = {"coefficients": coef.tolist(),
                         "median_relative_error": med}
        print(f"  fit: {np.array2string(coef, precision=5)} (median "
              f"relative error {med:.3f} over {len(rows)} geometries)",
              flush=True)
        for what in out:
            mine = [r for r in rows if r["frame"] == what]
            pick = min(mine, key=lambda r: float(np.dot(coef, r["features"])))
            best = min(mine, key=lambda r: r["events_us"])
            print(f"  refit picks {pick['geometry']} at {what}: "
                  f"{pick['events_us'] / best['events_us']:.3f}x the "
                  "fastest", flush=True)
        result["sweep"] = rows
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "sweep"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
