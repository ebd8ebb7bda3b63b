"""Life command-line entry point.

Contract (reference ``3-life/life_mpi.c:38-72``, kept by the JAX package's
``apps/life.py``): positional ``.cfg``, VTK snapshots under ``--outdir`` at
the cfg's save cadence, and ONE line on stdout - elapsed wall seconds of
the timed step loop - so the reference's ``times.txt`` harness reads the
port's runs unchanged. The timer brackets the whole run (saves included)
after a warm-up run that builds the kernels.

    python -m mpi_and_open_mp_tpu_torch.apps.life configs/gun_big_500x500.cfg --layout serial
    python -m mpi_and_open_mp_tpu_torch.apps.life configs/gun_big_500x500.cfg --layout serial --batch 64
    python -m mpi_and_open_mp_tpu_torch.apps.life configs/gun_big_500x500.cfg --layout cart --mesh 4,2 --virtual-devices 8

The sharded layouts run on a mesh of shards that all live on one device
(``parallel.mesh``): ``--virtual-devices N`` asks for N of them (the JAX
package's "simulate N devices"), ``--mesh PY,PX`` for a 2-D mesh,
``--devices N`` for N shards on a 1-D mesh. Without these the mesh has one
shard per device of ``--device``'s type: one on one card or on the CPU.

Checkpoint, stop and resume (the JAX package's contract)::

    python -m mpi_and_open_mp_tpu_torch.apps.life configs/gun_big_500x500.cfg --layout serial --checkpoint-dir ck --checkpoint-every 2500
    python -m mpi_and_open_mp_tpu_torch.apps.life configs/gun_big_500x500.cfg --layout serial --checkpoint-dir ck --resume

``--checkpoint-dir`` writes ``step_NNNNNN.state`` at every save point and,
with ``--checkpoint-every N``, every N steps. SIGTERM or SIGINT flushes a
checkpoint at the next segment boundary, and the run exits 75 with
``-- requeue with --resume`` on stderr; so does a ``MOMP_CHAOS=preempt=<k>``
plan. ``--resume`` continues from the newest state, checkpoint or
``--outdir`` snapshot, and refuses a JAX Orbax checkpoint newer than both.
``--impl pallas`` is the JAX package's name of ``native``.

Observability: ``--trace PATH`` sets ``MOMP_TRACE`` before any work, so
the run's spans (``life.run``, ``life.advance`` or ``life.segment``,
checkpoints, recoveries) land in PATH as JSON lines (read them with
``mpi_and_open_mp_tpu_torch.obs.report``, or with the JAX package's
``analysis/trace_report.py``); ``--profile DIR`` records the timed run
with ``torch.profiler`` (CPU and, on the card, CUDA activities) and writes
a Chrome trace into DIR.

Serving: ``--serve N`` pushes N copies of the cfg board through the
serving daemon (``serve.daemon``: admission, bucket deadlines, the engine
ladder on the card), ``--batch B`` capping a bucket (default 8). The
stdout line is the drain's elapsed seconds, and ``served r/n (shed,
degraded, p99)`` goes to stderr. SIGTERM (or ``MOMP_CHAOS=preempt=<k>``,
after ``k`` batches) drains the in-flight batch, checkpoints the queue as
``serve_queue.state`` under ``--checkpoint-dir`` and exits 75; a bare
``--resume`` over that checkpoint re-enters serving. ``--serve`` needs
``--layout serial`` and refuses ``--outdir``::

    python -m mpi_and_open_mp_tpu_torch.apps.life configs/gun_big_500x500.cfg --layout serial --serve 64 --batch 64

Tuned plans: ``--plans DIR`` (or ``MOMP_TUNE_PLANS``) names a store that
``tune`` wrote; its records are validated, held against the oracle and
installed before the sim is built, so a batched run dispatches the
measured path, and a ``--resume`` status line carries ``plans_installed``,
``plan_source`` and ``tuned_path``. ``MOMP_TUNE=0`` leaves the store
untouched and the ladder in charge.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time

import numpy as np

from mpi_and_open_mp_tpu_torch.apps._common import check_devices
from mpi_and_open_mp_tpu_torch.models.life import IMPLS, LAYOUTS, LifeSim
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.robust.preempt import EXIT_PREEMPTED, Preempted
from mpi_and_open_mp_tpu_torch.utils.config import load_config
from mpi_and_open_mp_tpu_torch.utils.timing import append_times_txt


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_and_open_mp_tpu_torch.apps.life",
        description="Game of Life on a periodic torus (PyTorch/CUDA port)",
    )
    p.add_argument("cfg", help="board config file (steps/save_steps/nx ny/cells)")
    p.add_argument("--layout", choices=LAYOUTS, default="row")
    p.add_argument("--impl", choices=IMPLS + ("pallas",), default="auto",
                   help="native = the hand-written kernels (pallas, the "
                        "JAX package's name, is accepted for it); auto = "
                        "native (serial) or bitfused (sharded) on the card")
    p.add_argument("--fuse-steps", type=int, default=1, metavar="K",
                   help="halo depth: exchange once per K local steps")
    p.add_argument("--mesh", metavar="PY,PX",
                   help="explicit 2-D mesh shape (cart layout)")
    p.add_argument("--devices", type=int, metavar="N",
                   help="N shards (1-D layouts; cart factorises N)")
    p.add_argument("--virtual-devices", type=int, default=None, metavar="N",
                   help="N virtual shards, all on the one device")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--batch", type=int, default=0, metavar="B",
                   help="throughput mode: advance B stacked copies of the "
                        "cfg board together (batched LifeSim; excludes "
                        "--outdir, --checkpoint-dir and --resume). The "
                        "elapsed line then covers B boards' worth of "
                        "updates, and the final population is the sum over "
                        "the stack")
    p.add_argument("--serve", type=int, default=0, metavar="N",
                   help="serving mode: push N copies of the cfg board "
                        "through the serving daemon (admission, bucket "
                        "deadlines, retry and recovery ladder). SIGTERM "
                        "drains the in-flight batch, checkpoints the queue "
                        "under --checkpoint-dir and exits 75; --resume "
                        "restores it. Prints the drain's elapsed seconds. "
                        "Needs --layout serial; --batch B caps the bucket "
                        "(default 8); excludes --outdir")
    p.add_argument("--outdir", default=None,
                   help="write VTK snapshots here (default: no saves)")
    p.add_argument("--times-file", default=None,
                   help="append elapsed seconds to this file (times.txt contract)")
    p.add_argument("--print-final-population", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="restart from the newest state: the latest "
                        "checkpoint in --checkpoint-dir or the latest VTK "
                        "snapshot in --outdir")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="write a checkpoint (step_NNNNNN.state) at every "
                        "save point")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N steps, whatever the save "
                        "cadence (SIGTERM flushes one and exits 75)")
    p.add_argument("--plans", default=None, metavar="DIR",
                   help="tuned-plan store (default $MOMP_TUNE_PLANS): its "
                        "records are validated, held against the oracle "
                        "and installed before the first dispatch; the "
                        "resume status line (stderr JSON) carries "
                        "plan_source")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="record the run with torch.profiler and write a "
                        "Chrome trace into DIR")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="write obs span/event JSONL here (sets MOMP_TRACE; "
                        "read it back with obs.report)")
    p.add_argument("--debug-check", action="store_true",
                   help="assert one step matches the oracle before and "
                        "after the run")
    return p


#: The Chrome trace ``--profile DIR`` writes.
PROFILE_FILE = "life_profile.trace.json"


@contextlib.contextmanager
def _profiled(outdir: str | None, device: str):
    """Record the block with ``torch.profiler`` (CPU, and CUDA activities
    for a run on the card) and write a Chrome trace into ``outdir``; a
    no-op without ``outdir``."""
    if not outdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(outdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(outdir, PROFILE_FILE))


def _find_latest(directory: str | None, pattern: str
                 ) -> tuple[str, int] | None:
    """The highest-step entry of ``directory`` whose name matches
    ``pattern`` in full (one numeric group, the step)."""
    if not directory or not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(pattern, name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (os.path.join(directory, name), step)
    return best


def find_latest_snapshot(outdir: str | None) -> tuple[str, int] | None:
    """Latest ``life_NNNNNN.vtk`` in ``outdir`` and its step index."""
    return _find_latest(outdir, r"life_(\d{6,})\.vtk")


def find_latest_checkpoint(ckpt_dir: str | None) -> tuple[str, int] | None:
    """Latest ``step_NNNNNN.state`` checkpoint in ``ckpt_dir``."""
    return _find_latest(ckpt_dir, r"step_(\d{6,})\.state")


def find_latest_orbax(ckpt_dir: str | None) -> tuple[str, int] | None:
    """Latest JAX Orbax checkpoint tree ``step_NNNNNN/`` in ``ckpt_dir``,
    which this package cannot read."""
    found = _find_latest(ckpt_dir, r"step_(\d{6,})")
    return found if found is not None and os.path.isdir(found[0]) else None


def _plan_store(args):
    """The tuned-plan store ``--plans`` / ``MOMP_TUNE_PLANS`` names, on
    ``--device``, or None (the ladder only)."""
    plans_dir = args.plans or os.environ.get("MOMP_TUNE_PLANS") or None
    if not plans_dir:
        return None
    from mpi_and_open_mp_tpu_torch.tune.plans import PlanStore

    return PlanStore(plans_dir, device=args.device)


def _plan_fields(store, cfg, batch: int) -> dict:
    """The resume status line's ``plan_source``: ``store`` when an
    installed plan covers this (workload, stack shape), with its
    ``tuned_path``, else ``heuristic`` (no store, a miss, or
    ``MOMP_TUNE=0``)."""
    fields = {"plan_source": "heuristic"}
    if store is None:
        return fields
    hit = store.lookup("life", (max(batch, 1), cfg.ny, cfg.nx))
    if hit is not None:
        fields["plan_source"] = "store"
        fields["tuned_path"] = hit["choice"]["path"]
    return fields


def _resume(args, cfg, kwargs, store=None, plans_installed=None):
    """The sim ``--resume`` continues, from the newest state (a stale
    checkpoint must not roll back past newer snapshots), or None with the
    reason on stderr."""
    ckpt = find_latest_checkpoint(args.checkpoint_dir)
    snap = find_latest_snapshot(args.outdir)
    orbax = find_latest_orbax(args.checkpoint_dir)
    ours = max((s for _, s in filter(None, (ckpt, snap))), default=None)
    if orbax is not None and (ours is None or orbax[1] > ours):
        print(f"--resume: {orbax[0]} is a JAX Orbax checkpoint (step "
              f"{orbax[1]}), newer than every state this package reads; "
              "resume it with mpi_and_open_mp_tpu.apps.life (refusing to "
              "roll back past it)", file=sys.stderr)
        return None
    if ckpt is not None and (snap is None or ckpt[1] >= snap[1]):
        path, step = ckpt
        print(f"resuming from checkpoint {path} (step {step})",
              file=sys.stderr)
        sim = LifeSim.from_checkpoint(path, cfg, **kwargs)
    elif snap is not None:
        path, step = snap
        print(f"resuming from {path} (step {step})", file=sys.stderr)
        sim = LifeSim.from_snapshot(cfg, path, step, **kwargs)
    else:
        sources = [f"no snapshots in {args.outdir!r}"]
        if args.checkpoint_dir is not None:
            sources.insert(0, f"no checkpoints in {args.checkpoint_dir!r}")
        print(f"--resume: {' and '.join(sources)}", file=sys.stderr)
        return None
    print(json.dumps({
        "resumed": os.path.basename(path), "step": step,
        **({"plans_installed": plans_installed.get("installed", 0)}
           if plans_installed is not None else {}),
        **_plan_fields(store, cfg, args.batch)}), file=sys.stderr)
    return sim


#: The serving queue's drain checkpoint under ``--checkpoint-dir``.
SERVE_CHECKPOINT = "serve_queue.state"


def serve_checkpoint(args) -> str | None:
    return (os.path.join(args.checkpoint_dir, SERVE_CHECKPOINT)
            if args.checkpoint_dir else None)


def serving(args) -> bool:
    """``--serve N``, or a bare ``--resume`` over a serving checkpoint: a
    requeued serving job must drain its tickets, not start a simulation."""
    ckpt = serve_checkpoint(args)
    return bool(args.serve or (args.resume and ckpt
                               and os.path.exists(ckpt)))


def serve(args, cfg, parser) -> tuple[int, object | None]:
    """The cfg board as ``--serve`` tickets through the serving daemon on
    ``--device``; returns the exit code and the daemon (None when it
    could not be built). The stdout line is the drain's elapsed seconds,
    the service summary goes to stderr. Preemption checkpoints the queue
    (with ``--checkpoint-dir``) and returns 75."""
    from mpi_and_open_mp_tpu_torch.obs import trace
    from mpi_and_open_mp_tpu_torch.serve import ServePolicy, ServingDaemon

    if args.layout != "serial":
        parser.error("--serve needs --layout serial "
                     "(a bucket is one single-program dispatch)")
    if args.outdir:
        parser.error("--serve is a serving mode: drop --outdir")
    ckpt = serve_checkpoint(args)
    policy = ServePolicy(max_batch=args.batch or 8,
                         max_depth=max(64, 2 * args.serve))
    # The daemon installs the store when it is built, so every resume
    # comes up tuned before its first dispatch.
    store = _plan_store(args)
    if args.resume:
        if not ckpt:
            parser.error("--serve --resume needs --checkpoint-dir")
        try:
            daemon = ServingDaemon.resume(ckpt, policy, plan_store=store,
                                          device=args.device)
        except ValueError as e:
            print(f"--serve --resume: {e}", file=sys.stderr)
            return 2, None
        print(f"resuming {daemon.queue.depth()} queued tickets from "
              f"{ckpt}", file=sys.stderr)
        print(json.dumps({
            "resumed": "serve_queue", "tickets": daemon.queue.depth(),
            **_plan_fields(store, cfg, policy.max_batch)}),
            file=sys.stderr)
    else:
        daemon = ServingDaemon(policy, checkpoint_path=ckpt,
                               plan_store=store, device=args.device)
    board = cfg.board()
    for _ in range(args.serve):
        daemon.submit(board, cfg.steps)
    t0 = time.perf_counter()
    try:
        with trace.span("life.serve", cfg=os.path.basename(args.cfg),
                        requests=args.serve, steps=cfg.steps):
            daemon.serve()
    except Preempted as e:
        print(f"{e} -- requeue with --serve --resume", file=sys.stderr)
        return EXIT_PREEMPTED, daemon
    elapsed = time.perf_counter() - t0
    print(f"{elapsed:.6f}")
    if args.times_file:
        append_times_txt(args.times_file, elapsed)
    s = daemon.summary()
    print(f"served {s['resolved']}/{s['requests']} "
          f"(shed {s['shed']}, degraded {s['degraded']}, "
          f"p99 {s['p99_latency_s']}s)", file=sys.stderr)
    return 0, daemon


def make_mesh(args):
    """The mesh the flags ask for, or None for LifeSim's default (one
    shard per device)."""
    if args.layout == "serial":
        return None
    virtual = bool(args.virtual_devices)
    kw = dict(device=args.device, virtual=virtual)
    if args.mesh:
        py, px = (int(v) for v in args.mesh.split(","))
        check_devices(args, (py, px))
        return mesh_lib.make_mesh_2d(py, px, **kw)
    n = args.devices or args.virtual_devices
    if not n:
        return None
    if args.layout == "cart":
        shape = mesh_lib.dims_create(n, 2)
        check_devices(args, shape)
        return mesh_lib.make_mesh_2d(*shape, **kw)
    check_devices(args, (n,))
    axis = "x" if args.layout == "col" else "y"
    return mesh_lib.make_mesh_1d(n, axis=axis, **kw)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.serve < 0:
        parser.error("--serve must be >= 1")
    if args.batch < 0:
        parser.error("--batch must be >= 1")
    if serving(args):
        # Serving is its own mode: the daemon owns batching, retries
        # and the queue checkpoint.
        if args.trace:
            os.environ["MOMP_TRACE"] = args.trace
        return serve(args, load_config(args.cfg), parser)[0]
    if args.batch and args.layout != "serial":
        parser.error("--batch needs --layout serial "
                     "(a batch is one single-program dispatch)")
    if args.batch and (args.outdir or args.checkpoint_dir or args.resume):
        parser.error("--batch is a throughput mode: drop --outdir/"
                     "--checkpoint-dir/--resume")
    if args.trace:
        # Before any sim work, so every span of the run lands in the sink
        # (cached per value; appends across invocations).
        os.environ["MOMP_TRACE"] = args.trace
    from mpi_and_open_mp_tpu_torch.obs import trace

    cfg = load_config(args.cfg)
    kwargs = dict(layout=args.layout,
                  impl="native" if args.impl == "pallas" else args.impl,
                  mesh=make_mesh(args), fuse_steps=args.fuse_steps,
                  device=args.device, outdir=args.outdir,
                  checkpoint_dir=args.checkpoint_dir,
                  checkpoint_every=args.checkpoint_every)
    # Plans go in before the sim exists: the batched engines consult them
    # at each dispatch, so a --resume with --plans restarts tuned.
    store = _plan_store(args)
    plans_installed = store.install() if store is not None else None
    if args.resume:
        sim = _resume(args, cfg, kwargs, store, plans_installed)
        if sim is None:
            return 2
    else:
        # B stacked copies of the cfg board: the work does not depend on
        # the boards' content, so copies time what B distinct requests
        # would.
        stack = np.stack([cfg.board()] * args.batch) if args.batch else None
        sim = LifeSim(cfg, initial_board=stack, **kwargs)
    sim.warmup()
    if args.debug_check:
        sim.debug_check()
    with _profiled(args.profile, args.device):
        t0 = time.perf_counter()
        try:
            # The whole-run root span: segments nest under it, and a
            # preempted run closes it with its error.
            with trace.span("life.run", cfg=os.path.basename(args.cfg),
                            steps=cfg.steps, impl=sim.impl,
                            layout=sim.layout):
                final = sim.run()  # collect() waits for the device
        except Preempted as e:
            # EX_TEMPFAIL: a queue keeps the job; --resume continues from
            # the flushed checkpoint.
            print(f"{e} -- requeue with --resume", file=sys.stderr)
            return EXIT_PREEMPTED
        elapsed = time.perf_counter() - t0
    if args.debug_check:
        sim.debug_check()
    for stamp in sim.recoveries:
        print(f"recovered: {stamp}", file=sys.stderr)
    print(f"{elapsed:.6f}")
    if args.times_file:
        append_times_txt(args.times_file, elapsed)
    if args.print_final_population:
        print(int(final.sum()), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
