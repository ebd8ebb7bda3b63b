"""Driver entry points: a one-device step and a dry run of every sharded path.

Counterpart of the repository's ``__graft_entry__.py`` (the JAX package's
``entry`` and ``dryrun_multichip``), on the port. Run as::

    python -m mpi_and_open_mp_tpu_torch.graft_entry 8
    python -m mpi_and_open_mp_tpu_torch.graft_entry 8 --device cpu

:func:`entry` returns the flagship's hot step and its input;
:func:`dryrun_multichip` runs each check of the JAX dry run on ``n``
virtual shards of one device (``parallel.mesh``) with the JAX dry run's
shapes and tolerances, and raises on the first that fails. It never
degrades to another device: the JAX dry run probes the devices and falls
back to the CPU when the probe fails (``__graft_entry__.py:51-63``); here a
missing card raises (``utils.device.resolve_device``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

BOARD_SHAPE = (512, 512)


def entry(device: str | torch.device = "cuda"):
    """``(fn, args)``: one torus Life step of the flagship and its 512²
    uint8 board (``default_rng(0)``, density 0.3) on ``device``. On the
    card ``fn`` is the hand-written kernel path ``ops.native_life.
    native_path`` names for the shape, at one step; on the CPU the plain
    ``ops.life_ops.life_step_roll``."""
    from mpi_and_open_mp_tpu_torch.ops import life_ops, native_life
    from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    board = torch.from_numpy(
        (rng.random(BOARD_SHAPE) < 0.3).astype(np.uint8)).to(dev)
    if dev.type == "cuda":
        def fn(b: torch.Tensor) -> torch.Tensor:
            return native_life.life_run_vmem(b, 1)
    else:
        fn = life_ops.life_step_roll
    return fn, (board,)


def _close(got, want, tol: float, what: str) -> None:
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        err = float((got.float() - want.float()).abs().max())
        raise AssertionError(f"{what} lost parity (max |err| {err:.3g})")


def dryrun_multichip(n_devices: int,
                     device: str | torch.device = "cuda") -> None:
    """Every sharded path once on ``n_devices`` virtual shards of
    ``device``, each against its oracle (``__graft_entry__.py:23-305``):
    the cart halo step at fuse 2; ``bitfused`` row, col and cart on the
    flagship's 500² (or the JAX dry run's planner-sized fallback) across
    one fused-round boundary; the integral; the fabric sweep; causal ring
    and Ulysses attention, zigzag, GQA through both; the ring's gradients;
    Ulysses' flash gradients at a small ``_Q_CHUNK``; and the per-hop
    engines, whose stamps must name the hand-written kernels on the card
    (their plain versions on the CPU), so that a silent fold cannot pass."""
    from mpi_and_open_mp_tpu_torch.models.integral import Integral
    from mpi_and_open_mp_tpu_torch.models.life import LifeSim
    from mpi_and_open_mp_tpu_torch.ops import bitlife
    from mpi_and_open_mp_tpu_torch.ops.life_ops import life_step_numpy
    from mpi_and_open_mp_tpu_torch.parallel import context as ctx
    from mpi_and_open_mp_tpu_torch.parallel import fabric
    from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
    from mpi_and_open_mp_tpu_torch.utils.config import config_from_board
    from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    n = int(n_devices)

    def mesh_1d(axis):
        return mesh_lib.make_mesh_1d(n, axis=axis, device=dev, virtual=True)

    def oracle(board, steps):
        for _ in range(steps):
            board = life_step_numpy(board)
        return board

    py, px = mesh_lib.dims_create(n, 2)
    mesh = mesh_lib.make_mesh_2d(py, px, device=dev, virtual=True)

    # The sharded Life step: 2-D blocks, a depth-2 fused halo.
    fuse = 2
    board = (np.random.default_rng(1).random((4 * fuse * py, 4 * fuse * px))
             < 0.4).astype(np.uint8)
    cfg = config_from_board(board, steps=2 * fuse, save_steps=0)
    sim = LifeSim(cfg, layout="cart", impl="halo", mesh=mesh,
                  fuse_steps=fuse)
    if not np.array_equal(sim.run(save=False), oracle(board, cfg.steps)):
        raise AssertionError("multichip halo step lost parity")

    # The packed paths on the flagship's 500² (3-life/p46gun_big.cfg),
    # across one fused-round boundary.
    for layout, m, (py2, px2) in [("row", mesh_1d("y"), (n, 1)),
                                  ("col", mesh_1d("x"), (1, n)),
                                  ("cart", mesh, (py, px))]:
        shape = (500, 500)
        if bitlife.plan_sharded_bits(
                shape, py2, px2, y_sharded=layout in ("row", "cart"),
                x_sharded=layout in ("col", "cart")) is None:
            # Past what 500 rows or columns carry: a planner-sized slab
            # a shard on the sharded axis, the other axis unaligned.
            shape = (96 * py2 if py2 > 1 else 500,
                     96 * px2 if px2 > 1 else 500)
        board2 = (np.random.default_rng(2).random(shape)
                  < 0.35).astype(np.uint8)
        sim2 = LifeSim(config_from_board(board2, steps=1, save_steps=0),
                       layout=layout, impl="bitfused", mesh=m)
        steps = sim2._plan.k_max + 8
        sim2.step(steps)
        if not np.array_equal(sim2.collect(), oracle(board2, steps)):
            raise AssertionError(f"bitfused {layout} lost parity")

    # The quadrature's reduction (JAX's axis "i": the port's 1-D meshes
    # name "y"; only the shard count matters to the integral).
    mesh1d = mesh_1d("y")
    val = Integral(100_000, mesh=mesh1d).compute()
    if not abs(val - np.pi) < 1e-3:
        raise AssertionError(f"integral {val!r} is not pi")

    # The ring probe.
    rows = fabric.sweep(mesh1d, sizes=(1, 100), reps=2)
    if not (len(rows) == 2 and all(t > 0 for _, t in rows)):
        raise AssertionError(f"fabric sweep rows {rows}")

    # Sequence-parallel attention over an "sp" ring against the dense
    # oracle: ring and Ulysses, zigzag, GQA, gradients.
    sp = mesh_1d(ctx.AXIS_SP)
    rng = np.random.default_rng(7)

    def normal(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def loss(fn, *args):
        return (fn(*args, causal=True) ** 2).sum()

    def grads(fn, *args):
        leaves = [x.clone().requires_grad_(True) for x in args]
        return torch.autograd.grad(loss(fn, *leaves), leaves)

    def ring(q_, k_, v_, causal=True):
        return ctx.ring_attention(q_, k_, v_, mesh=sp, causal=causal)

    def ulysses(q_, k_, v_, causal=True):
        return ctx.ulysses_attention(q_, k_, v_, mesh=sp, causal=causal)

    with ctx._full_f32_matmul():
        h, nq, d = n, 8 * n, 8
        q, k, v = (normal((h, nq, d)) for _ in range(3))
        want = ctx.attention_reference(q, k, v, causal=True)
        for name, fn in (("ring_attention", ring),
                         ("ulysses_attention", ulysses)):
            _close(fn(q, k, v), want, 1e-4, name)
        got_z = ctx.zigzag_unshard(ctx.ring_attention(
            *(ctx.zigzag_shard(x, n) for x in (q, k, v)), mesh=sp,
            causal=True, layout="zigzag"), n)
        _close(got_z, want, 1e-4, "zigzag ring")

        # GQA: the ring folds query groups a hop; Ulysses keeps K/V
        # un-expanded on the wire when their heads split over the ring.
        hq = 2 * n
        qg = normal((hq, nq, d))
        for name, fn, hkv in (("ring_attention", ring, 2),
                              ("ulysses_attention", ulysses, n)):
            kg, vg = normal((hkv, nq, d)), normal((hkv, nq, d))
            want_g = ctx.attention_reference(
                qg, *ctx._repeat_heads(kg, vg, hq // hkv), causal=True)
            _close(fn(qg, kg, vg), want_g, 1e-4, f"{name} GQA")

        # The ring's backward (travelling dk/dv) against the oracle's.
        want_grads = grads(ctx.attention_reference, q, k, v)
        for gg, gw, name in zip(grads(ring, q, k, v), want_grads, "qkv"):
            _close(gg, gw, 1e-3, f"ring grad d{name}")

        # Ulysses' flash backward with the chunked engine engaged at
        # these sizes (the port reads _Q_CHUNK at call time). On the card
        # that engine is the flash kernels, built for head widths 64 and
        # 128, so the card's check takes 64 where the CPU's plain chunked
        # engine takes the JAX dry run's 8.
        qu, ku, vu = (q, k, v) if not on_card else (
            normal((h, nq, 64)) for _ in range(3))
        want_u = (want_grads if not on_card
                  else grads(ctx.attention_reference, qu, ku, vu))
        old_chunk = ctx._Q_CHUNK
        ctx._Q_CHUNK = 4
        try:
            for gg, gw, name in zip(grads(ulysses, qu, ku, vu), want_u,
                                    "qkv"):
                _close(gg, gw, 1e-3, f"flash grad d{name}")
        finally:
            ctx._Q_CHUNK = old_chunk

        # The per-hop engines at a head width and a shard length they
        # take: their stamps, then forward and gradients.
        def engaged(stamp, kernel, what):
            ok = (stamp.startswith(f"cuda:{kernel}") if on_card
                  else stamp.startswith("cpu:") and "plain" in stamp)
            if not ok:
                raise AssertionError(f"{what} engine not engaged: {stamp}")

        hf, nf, df = 2, 128 * n, 128
        qf, kf, vf = (normal((hf, nf, df)) for _ in range(3))
        engaged(ctx.ring_hop_engine_for(qf, kf, vf, p=n, causal=True),
                "flash_fwd", "hop")
        engaged(ctx.ring_hop_bwd_engine_for(qf, kf, vf, p=n, causal=True),
                "flash_hop_bwd", "hop bwd")
        _close(ring(qf, kf, vf), ctx.attention_reference(
            qf, kf, vf, causal=True), 1e-4, "hop-engine ring")
        for gg, gw, name in zip(grads(ring, qf, kf, vf),
                                grads(ctx.attention_reference, qf, kf, vf),
                                "qkv"):
            _close(gg, gw, 1e-3, f"hop grad d{name}")

        # Causal zigzag on the hop engine: half-chunk launches (":zz");
        # its backward folds, as in the JAX package.
        nz = 256 * n
        qz, kz, vz = (normal((hf, nz, df)) for _ in range(3))
        stamp_z = ctx.ring_hop_engine_for(qz, kz, vz, p=n, causal=True,
                                          layout="zigzag")
        engaged(stamp_z, "flash_fwd", "zigzag hop")
        if not stamp_z.endswith(":zz"):
            raise AssertionError(f"zigzag hop engine stamp {stamp_z}")
        stamp_zb = ctx.ring_hop_bwd_engine_for(qz, kz, vz, p=n, causal=True,
                                               layout="zigzag")
        if stamp_zb != "plain":
            raise AssertionError(f"zigzag hop bwd engine {stamp_zb}")

        def zz_ring(q_, k_, v_, causal=True):
            return ctx.ring_attention(q_, k_, v_, mesh=sp, causal=causal,
                                      layout="zigzag")

        want_z = ctx.attention_reference(qz, kz, vz, causal=True)
        zs = [ctx.zigzag_shard(x, n) for x in (qz, kz, vz)]
        _close(ctx.zigzag_unshard(zz_ring(*zs), n), want_z, 1e-4,
               "zigzag hop-engine")
        for gg, gw, name in zip(grads(zz_ring, *zs),
                                grads(ctx.attention_reference, qz, kz, vz),
                                "qkv"):
            _close(ctx.zigzag_unshard(gg, n), gw, 1e-3,
                   f"zigzag hop grad d{name}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mpi_and_open_mp_tpu_torch.graft_entry")
    p.add_argument("n", type=int, nargs="?", default=8,
                   help="virtual shards (default 8)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    print(f"dryrun_multichip({args.n}) OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
