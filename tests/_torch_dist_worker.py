"""One process of a two-process run of the port over ``torch.distributed``.

The port's counterpart of ``tests/_dist_worker.py``. Run as::

    python tests/_torch_dist_worker.py <proc_id> <nprocs> <coordinator> [--device cuda|cpu] [--out PATH]

beside the other ranks (same coordinator ``HOST:PORT``). Each process
joins the run (``parallel.procs.init``: gloo on the CPU, gloo staged
through page-locked host memory when the ranks share one card) and runs,
on meshes that span the processes:

* the integral at N = 10^6, within 1e-3 of pi;
* a row ``halo`` Life run of a 64 x 40 board for 6 steps, then
  ``collect()`` (a gather), against the NumPy oracle;
* ring attention at h 2, n 64, d 16, causal, its output and gradients
  against the dense oracle on this process's rows (1e-4 and 1e-3, the JAX
  worker's tolerances), and the zigzag layout's output;
* a snapshot, gathered by every process and written by process 0 alone
  (each process names its own directory; process 1's stays empty).

Process 0 prints ``DIST_OK``. With ``--out`` it also writes the run's
results (the integral value, the board, the gathered ring output,
gradients and zigzag output) as an ``.npz`` for a caller to hold against
the one-process run of the same meshes. It imports nothing of JAX.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi_and_open_mp_tpu_torch.models.integral import Integral  # noqa: E402
from mpi_and_open_mp_tpu_torch.models.life import LifeSim  # noqa: E402
from mpi_and_open_mp_tpu_torch.ops.life_ops import (  # noqa: E402
    life_step_numpy)
from mpi_and_open_mp_tpu_torch.parallel import context  # noqa: E402
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from mpi_and_open_mp_tpu_torch.parallel import procs  # noqa: E402
from mpi_and_open_mp_tpu_torch.utils.config import (  # noqa: E402
    config_from_board)
from mpi_and_open_mp_tpu_torch.utils.vtk import read_vtk  # noqa: E402

# The JAX worker's sizes and tolerances (tests/_dist_worker.py).
INTEGRAL_N = 1_000_000
BOARD, LIFE_STEPS = (64, 40), 6
H, N, D = 2, 64, 16
OUT_TOL, GRAD_TOL = 1e-4, 1e-3


def ring_inputs(device):
    rng = np.random.default_rng(0)
    rng.random(BOARD)  # the board's draw, as the JAX worker's one rng
    return tuple(torch.from_numpy(rng.standard_normal((H, N, D))).float()
                 .to(device) for _ in range(3))


def board0() -> np.ndarray:
    return (np.random.default_rng(0).random(BOARD) < 0.35).astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("proc_id", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("coordinator")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--snapshot-dir", default=None,
                    help="where each process names its snapshot directory "
                         "(default: TMPDIR)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    world = procs.init(args.coordinator, args.nprocs, args.proc_id,
                       device=args.device)
    assert world.procs == args.nprocs and world.rank == args.proc_id
    dev = world.device
    results = {"transport": np.array(world.transport)}

    # The integral: each process its shards' partials, summed in order.
    mesh = mesh_lib.make_mesh_1d(args.nprocs, axis="y", device=dev)
    val = Integral(INTEGRAL_N, mesh=mesh).compute()
    assert abs(val - np.pi) < 1e-3, val
    results["integral"] = np.float64(val)

    # Row halo Life whose exchange crosses the processes; collect() gathers.
    board = board0()
    cfg = config_from_board(board, steps=LIFE_STEPS, save_steps=0)
    sim = LifeSim(cfg, layout="row", impl="halo", mesh=mesh)
    sim.step(LIFE_STEPS)
    got = sim.collect()
    ref = board.copy()
    for _ in range(LIFE_STEPS):
        ref = life_step_numpy(ref)
    assert np.array_equal(got, ref), "two-process halo step lost parity"
    results["board"] = got

    # Ring attention across the processes: K/V rotations and the
    # backward's dk/dv accumulators cross them; each process checks its
    # own rows.
    sp = mesh_lib.make_mesh_1d(args.nprocs, axis=context.AXIS_SP,
                               device=dev)
    q, k, v = ring_inputs(dev)
    with context._full_f32_matmul():
        want = context.attention_reference(q, k, v, causal=True)
        qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
        g_want = torch.autograd.grad(
            (context.attention_reference(*qkv, causal=True) ** 2).sum(), qkv)
    out = context.ring_attention(q, k, v, mesh=sp, causal=True)
    mine = context.local_rows(want, sp)
    assert torch.allclose(out, mine, rtol=OUT_TOL, atol=OUT_TOL), (
        "two-process ring attention lost parity")
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad(
        (context.ring_attention(*qkv, mesh=sp, causal=True) ** 2).sum(), qkv)
    for gg, gw, name in zip(grads, g_want, "qkv"):
        assert torch.allclose(context.local_rows(gg, sp),
                              context.local_rows(gw, sp), rtol=GRAD_TOL,
                              atol=GRAD_TOL), f"two-process ring grad d{name}"
    qz, kz, vz = (context.zigzag_shard(x, args.nprocs) for x in (q, k, v))
    out_z = context.ring_attention(qz, kz, vz, mesh=sp, causal=True,
                                   layout="zigzag")
    want_z = context.local_rows(context.zigzag_shard(want, args.nprocs), sp)
    assert torch.allclose(out_z, want_z, rtol=OUT_TOL, atol=OUT_TOL), (
        "two-process zigzag ring attention lost parity")

    def gathered(x):
        return procs.all_gather(x.detach().transpose(0, 1).contiguous()
                                ).transpose(0, 1).cpu().numpy()

    results["ring"] = gathered(out)
    results["zigzag"] = gathered(out_z)
    for name, gg in zip("qkv", grads):
        results[f"d{name}"] = gathered(context.local_rows(gg, sp))

    # Snapshot: collective collect, process 0 alone writes.
    base = args.snapshot_dir or os.environ.get("TMPDIR", "/tmp")
    tag = args.coordinator.replace(":", "_")
    dirs = [os.path.join(base, f"torch_dist_vtk_{tag}_{r}")
            for r in range(args.nprocs)]
    sim.outdir = dirs[args.proc_id]
    path = sim.save_snapshot()
    procs.barrier()
    if args.proc_id == 0:
        assert np.array_equal(read_vtk(path), got)
        for d in dirs[1:]:
            assert not os.path.exists(d), f"process {d[-1]} wrote {d}"
        if args.out:
            np.savez(args.out, **results)
    procs.shutdown()
    if args.proc_id == 0:
        print("DIST_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
