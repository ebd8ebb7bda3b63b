"""Long-context attention command-line entry point.

Same flags and output as the JAX package's ``apps/attention.py``: one
forward pass (or, with ``--grad``, one full (q, k, v) gradient step) of the
chosen variant, timed after a warm-up run that builds the kernels, checked
against the dense oracle, the elapsed seconds on stdout, and ``parity ok
(...)`` and the ``tflops=`` line on stderr (the FLOP count of the JAX CLI:
``4 h n^2 d``, halved under causal), followed by the kernels' launch counts.
``--devices N`` runs the ring (or Ulysses) over N virtual shards of
``--device``, refused past ``--virtual-devices`` with the JAX package's
text; ``--ring-layout zigzag`` permutes the operands into zigzag order
before the timed bracket, and the check compares in that order. With
``--distributed`` the ring (or Ulysses) spans the processes: each holds
its run of the shards, returns its own rows, and checks them against the
oracle's; a miss in any process fails every one.

    python -m mpi_and_open_mp_tpu_torch.apps.attention --variant flash --seq 8192 --heads 8 --head-dim 128 --causal --grad
    python -m mpi_and_open_mp_tpu_torch.apps.attention --variant ring --devices 8 --seq 32768 --heads 8 --head-dim 128 --causal --grad --ring-layout zigzag
    python -m mpi_and_open_mp_tpu_torch.apps.attention --variant ring --devices 4 --seq 1024 --heads 4 --head-dim 32 --causal --grad --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.apps._common import (
    add_platform_args, apply_platform_args, check_devices, finish,
    is_primary, virtual_shards)
from mpi_and_open_mp_tpu_torch.ops import flash_hop_bwd, native_flash
from mpi_and_open_mp_tpu_torch.parallel import context
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib, procs
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

KERNELS = {"flash_fwd": native_flash.flash_fwd,
           "flash_hop_dq": flash_hop_bwd.flash_hop_dq,
           "flash_hop_dkv": flash_hop_bwd.flash_hop_dkv}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_and_open_mp_tpu_torch.apps.attention",
        description="long-context attention (PyTorch/CUDA port)")
    p.add_argument("--variant", choices=("ring", "ulysses", "flash"),
                   default="ring",
                   help="ring / all-to-all over the sequence shards / "
                   "single-device flash")
    p.add_argument("--seq", type=int, default=8192)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--causal", action="store_true")
    p.add_argument("--grad", action="store_true",
                   help="time a full (q, k, v) gradient step instead of a "
                   "forward (the flash backward, O(seq*d) saved)")
    p.add_argument("--kv-heads", type=int, default=None,
                   help="GQA/MQA: fewer K/V heads than query heads")
    p.add_argument("--devices", type=int, default=None,
                   help="sp ring size: N virtual shards of --device "
                   "(default: --virtual-devices, else one)")
    p.add_argument("--ring-layout", choices=("contiguous", "zigzag"),
                   default="contiguous",
                   help="ring variant only: zigzag = striped causal-"
                   "load-balanced token layout (the CLI permutes "
                   "operands in and outputs back out, so the parity "
                   "check still runs in natural order)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"),
                   default="bfloat16")
    p.add_argument("--no-check", action="store_true",
                   help="skip the oracle parity check (long sequences)")
    p.add_argument("--engine", choices=("auto", "jnp"), default="auto",
                   help="auto = the kernels on the card (the plain engine "
                   "on the CPU); jnp = the plain chunked engine")
    p.add_argument("--seed", type=int, default=0)
    add_platform_args(p)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    apply_platform_args(p, args)
    if args.ring_layout != "contiguous" and args.variant != "ring":
        p.error("--ring-layout applies to --variant ring only")
    dev = resolve_device(args.device)
    engine = "plain" if args.engine == "jnp" else "auto"
    if args.variant == "flash":
        if args.devices not in (None, 1):
            p.error(f"--variant flash is single-device; --devices "
                    f"{args.devices} would be silently ignored (use "
                    "--variant ring/ulysses for a sharded run)")
        shards, mesh = 1, None

        def fn(q, k, v):
            return context.flash_attention(q, k, v, causal=args.causal,
                                           device=dev, engine=engine)
    else:
        shards = (args.devices or virtual_shards(args)
                  or (mesh_lib.default_shards(dev) if procs.world() else 1))
        check_devices(args, (shards,))
        mesh = mesh_lib.make_mesh_1d(shards, axis=context.AXIS_SP,
                                     device=dev,
                                     virtual=bool(args.virtual_devices))
        if args.variant == "ring":
            def fn(q, k, v):
                return context.ring_attention(q, k, v, causal=args.causal,
                                              layout=args.ring_layout,
                                              mesh=mesh, engine=engine)
        else:
            def fn(q, k, v):
                return context.ulysses_attention(q, k, v, causal=args.causal,
                                                 mesh=mesh, engine=engine)
    dtype = getattr(torch, args.dtype)
    rng = np.random.default_rng(args.seed)
    hkv = args.kv_heads or args.heads
    q = torch.from_numpy(
        rng.standard_normal((args.heads, args.seq, args.head_dim))).to(
            dev, dtype)
    k, v = (torch.from_numpy(
        rng.standard_normal((hkv, args.seq, args.head_dim))).to(dev, dtype)
        for _ in range(2))
    qn, kn, vn = q, k, v  # natural order, for the oracle check
    zig = args.ring_layout == "zigzag"
    if zig:  # a deployment-time layout: permuted outside the timed bracket
        q, k, v = (context.zigzag_shard(x, shards) for x in (q, k, v))

    if args.grad:
        def run():
            qkv = [x.detach().requires_grad_(True) for x in (q, k, v)]
            loss = (fn(*qkv).float() ** 2).sum()
            return torch.autograd.grad(loss, qkv)
    else:
        def run():
            with torch.no_grad():
                return fn(q, k, v)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for kernel in KERNELS.values():
        kernel.launches = 0
    run()  # builds the kernels and warms up
    sync()
    t0 = time.perf_counter()
    result = run()
    sync()
    elapsed = time.perf_counter() - t0
    if not args.no_check:
        # --grad timed the gradients, so one more (untimed) forward gives
        # the checked output; a forward run checks the timed output.
        if args.grad:
            with torch.no_grad():
                out = fn(q, k, v)
        else:
            out = result
        groups = args.heads // hkv
        with context._full_f32_matmul():
            want = context.attention_reference(
                qn.float(), *context._repeat_heads(kn.float(), vn.float(),
                                                   groups),
                causal=args.causal)
        # Compared in the ring's order (zigzag's too), on the rows this
        # process holds (all of them but across processes).
        if zig:
            want = context.zigzag_shard(want, shards)
        if mesh is not None:
            want = context.local_rows(want, mesh)
        err = float((out.float() - want).abs().max())
        tol = 1e-4 if dtype == torch.float32 else 0.06
        if not procs.agree(err <= tol):
            print(f"PARITY FAIL: max|err|={err:.3g} > {tol} (here, or in "
                  "another process)", file=sys.stderr)
            return 1
        if is_primary():
            print(f"parity ok (max|err|={err:.3g})", file=sys.stderr)

    if args.variant == "flash":
        stamp = context.flash_engine_for(q, k, v, engine)
    elif args.variant == "ring":
        stamp = context.ring_hop_engine_for(
            q, k, v, p=shards, causal=args.causal, layout=args.ring_layout,
            engine=engine)
        if args.grad:
            stamp += " bwd_engine=" + context.ring_hop_bwd_engine_for(
                q, k, v, p=shards, causal=args.causal,
                layout=args.ring_layout, engine=engine)
    else:
        stamp = context.flash_engine_for(
            q, *context._ulysses_kv(k, v, shards, args.heads), engine)
    # 2*(softmax QK^T)*V matmuls = 4*h*n^2*d multiply-adds (x0.5 causal).
    flops = 4 * args.heads * args.seq**2 * args.head_dim
    if args.causal:
        flops //= 2
    if is_primary():  # print-from-one-rank (3-life/life_mpi.c:64-67)
        print(f"{elapsed:.6f}")
        print(f"variant={args.variant} seq={args.seq} devices={shards} "
              f"engine={stamp} tflops={flops / elapsed / 1e12:.2f}",
              file=sys.stderr)
        print("launches " + " ".join(f"{name}={kernel.launches}"
                                     for name, kernel in KERNELS.items()),
              file=sys.stderr)
    return finish(0)


if __name__ == "__main__":
    sys.exit(main())
