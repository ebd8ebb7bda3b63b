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
  (each process names its own directory; process 1's stays empty);
* the RDMA rung's drill (:func:`rung_drill`): ``ops.native_halo.halo_frame``
  of this process's run of a cart stack (``nprocs`` x 2 shards of a 48 x
  40 board) of uint8 and of float32 at depth 1 and 2, gathered; heat
  through ``stencils.run_sharded`` on that mesh at ``fuse_steps=2,
  boundary_steps=1``, 5 steps (two partitioned rounds and a coupled one);
  the window handles' byte gather and ring handshakes. On the card under
  ``MOMP_HALO_RDMA=1`` the frames are the ``halo_frame`` kernel reading
  the neighbour rank's shards through its window, and heat's plan is
  ``overlap:rdma:pb1`` (``halo_edge_pair`` a sub-round); elsewhere the
  plain versions and ``overlap:deferred:pb1``. ``--only-rung`` runs this
  drill alone.

Process 0 prints ``DIST_OK``. With ``--out`` it also writes the run's
results (the integral value, the board, the gathered ring output,
gradients and zigzag output, the rung's gathered frames, heat board, plan
stamp and counts) as an ``.npz`` for a caller to hold against the
one-process run of the same meshes. It imports nothing of JAX.
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


# The rung's drill: a cart mesh of (nprocs, 2) shards of this board, the
# frames' dtypes and depths, heat's steps (fuse_steps 2, boundary_steps 1:
# two partitioned rounds, then a coupled round of one step) and the
# handshakes of the host drill.
RUNG_BOARD = (48, 40)
RUNG_DTYPES = ("uint8", "float32")
RUNG_DEPTHS = (1, 2)
RUNG_HEAT_STEPS = 5
RUNG_HANDSHAKES = 20


def rung_board(dtype: str) -> np.ndarray:
    """The drill's board of ``dtype``: every byte value for uint8, [0, 1)
    for float32, from one seed each."""
    rng = np.random.default_rng(29 + RUNG_DTYPES.index(dtype))
    if dtype == "uint8":
        return rng.integers(0, 256, RUNG_BOARD, dtype=np.uint8)
    return rng.random(RUNG_BOARD).astype(np.float32)


def heat_board() -> np.ndarray:
    from mpi_and_open_mp_tpu_torch import stencils

    return stencils.get("heat").init(np.random.default_rng(29), RUNG_BOARD)


def rung_drill(dev: torch.device, nprocs: int) -> dict:
    """The RDMA rung's drill (module docstring) on this process's runs;
    returns the gathered frames (``frame_<dtype>_d<depth>``), heat's board
    and stamp, the kernels' launches and ``procs.exchange`` calls in the
    frames and in heat, and the host drill's handshakes."""
    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.ops import native_halo

    out = {}
    mesh = mesh_lib.make_mesh_2d(nprocs, 2, device=dev)
    frames0, exch0 = native_halo.halo_frame.launches, procs.exchange.calls
    for dtype in RUNG_DTYPES:
        stack = mesh_lib.local_part(mesh_lib.shard(
            torch.from_numpy(rung_board(dtype)).to(dev), nprocs, 2), mesh)
        for d in RUNG_DEPTHS:
            frame = native_halo.halo_frame(stack, d, "cart")
            out[f"frame_{dtype}_d{d}"] = mesh_lib.gather(
                frame, mesh).cpu().numpy()
    out["frame_launches"] = native_halo.halo_frame.launches - frames0
    out["frame_exchanges"] = procs.exchange.calls - exch0
    pairs0, frames0 = (native_halo.edge_pair.launches,
                       native_halo.halo_frame.launches)
    exch0 = procs.exchange.calls
    heat = stencils.run_sharded(stencils.get("heat"), heat_board(),
                                RUNG_HEAT_STEPS, mesh=mesh, layout="cart",
                                fuse_steps=2, boundary_steps=1)
    out["heat"] = heat.cpu().numpy()
    out["heat_engine"] = np.array(stencils.run_sharded.last_plan.engine)
    out["heat_pair_launches"] = native_halo.edge_pair.launches - pairs0
    out["heat_frame_launches"] = native_halo.halo_frame.launches - frames0
    out["heat_exchanges"] = procs.exchange.calls - exch0
    # The host half: the handles' byte gather, then ring handshakes.
    w = procs.world()
    got = procs.all_gather_bytes(bytes([w.rank]) * 8)
    assert got == [bytes([r]) * 8 for r in range(nprocs)], got
    calls0 = procs.handshake.calls
    for _ in range(RUNG_HANDSHAKES):
        procs.handshake()
    out["handshakes"] = procs.handshake.calls - calls0
    return {f"rung_{k}": np.asarray(v) for k, v in out.items()}


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
    ap.add_argument("--only-rung", action="store_true",
                    help="run the RDMA rung's drill alone")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    world = procs.init(args.coordinator, args.nprocs, args.proc_id,
                       device=args.device)
    assert world.procs == args.nprocs and world.rank == args.proc_id
    dev = world.device
    results = {"transport": np.array(world.transport)}
    if args.only_rung:
        results.update(rung_drill(dev, args.nprocs))
        if args.proc_id == 0 and args.out:
            np.savez(args.out, **results)
        procs.shutdown()
        if args.proc_id == 0:
            print("DIST_OK", flush=True)
        return 0

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
    results.update(rung_drill(dev, args.nprocs))

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
