#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Phases, each of which raises (exit code 1) when it fails:

1. build the four kernels of ``mpi_and_open_mp_tpu_torch/csrc`` with nvcc,
   in parallel;
2. ``bitlife_vmem`` against its plain PyTorch version on the card, packed
   words bit-exact, on random soups at four shapes and n in {0, 1, 129, 1000};
3. ``bitlife_fused`` against its plain version (the whole extended frame
   stepped as one window) on the card, boards bit-exact: aligned 4096^2 and
   16384^2 at n in {1, 128, 300}, the padded frame at 10000^2 and 1000^2 at
   n = 300;
4. ``bitlife_vmem_batch`` (B in {1, 3, 4, 64}) and ``bitlife_bitsliced`` (B in
   {8, 33, 64, 256}) against their plain versions on the card, packed words
   bit-exact, at (500, 500), (37, 45) and (95, 130) and n in {0, 1, 13,
   1000}; the bitsliced kernel also at the degenerate extents 1x8, 8x1, 2x2;
5. the main paths through ``LifeSim``, the CLI and the batcher, with every
   launch count set to 0 just before each and read just after:
   p46gun_big (``configs/gun_big_500x500.cfg``, all 10 000 steps, the
   resident kernel) against the NumPy oracle (population 7288), then a
   10000^2 soup for 300 steps (the fused kernel on the padded frame)
   against the plain version's board from phase 3 and against 300 unpacked
   ``life_step_roll`` steps on the card, which share no code with the
   packed layout; then the CLI once as a subprocess. Then the batched
   paths: a 64-board stack (board 0 p46gun_big, 63 soups), all 10 000
   steps through ``"bitsliced"``, board 0 against the oracle and every
   board against the single-board ``bitlife_vmem`` kernel (a layout that
   shares no code with the board-sliced one); its first 4 boards through
   ``"vmem-grid"``; the CLI with ``--batch 64`` (population 466 432); and
   the batcher on 40 p46gun_big-size soups at two step counts, each result
   against ``bitlife_vmem``;
6. times from CUDA events after a warm-up: each kernel at the main path's
   shapes beside its plain version and its bound, per-step rates from the
   difference of two step counts, the batched path's split into pack,
   kernel, unpack and the copy to the host, and both batched kernels side by
   side at B in {64, 128, 256, 512} x 500^2 and {8, 64, 256, 512} x 95x130
   (where each wins), their boards compared.

Prints the card's name and power limit, then one JSON line with a record
for each kernel, then ``{"ok": true, "device": {...}}`` as the last line.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GUN_BIG = os.path.join(ROOT, "configs", "gun_big_500x500.cfg")

# H100 SXM peaks at the full 700 W power limit. Integer rate: 132 SMs x 64
# INT32 lanes x 1.98 GHz boost clock (the clock behind the data sheet's 67
# TFLOP/s FP32 = 132 x 128 lanes x 2 x 1.98 GHz; Hopper issues INT32 at
# half the FP32 lane count). HBM3 at 3.35 TB/s.
N_SMS = 132
INT32_OPS_PER_S = N_SMS * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# The fewest sm_90 instructions known for one packed word (32 cells) per
# step, counting each funnel shift (SHF) and each 3-input logic op (LOP3)
# as one: 2 SHF for the word's y neighbours, 2 LOP3 for its column's
# 3-cell sum (xor3, majority) and 2 for the sum without the centre (both
# shared with the words to either side), 4 to add the left and right
# column sums, 5 to add the centre column mod 8, 2 for (n0|c) & n1 & ~n2.
OPS_PER_WORD_STEP = 17
# The same count for a board-sliced word (32 boards at one cell): its eight
# neighbours are whole words, so the 2 SHF drop out.
OPS_PER_SLICED_WORD_STEP = 15


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def soup(shape, seed, density=0.4) -> torch.Tensor:
    """A random 0/1 uint8 board made on the card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.rand(shape, generator=g, device="cuda") < density).to(
        torch.uint8)


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def diff_count(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum())


def run_counted(wrappers, fn):
    """``fn()`` with every kernel wrapper's launch count set to 0 just
    before and read just after; returns its result and the counts."""
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {name: w.launches for name, w in wrappers.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mpi_and_open_mp_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mpi_and_open_mp_tpu_torch import LifeSim, load_config
    from mpi_and_open_mp_tpu_torch.ops import _build, life_ops
    from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
    from mpi_and_open_mp_tpu_torch.serve import ShapeBucketBatcher
    from mpi_and_open_mp_tpu_torch.utils.config import LifeConfig

    wrappers = {"vmem": tb.vmem_steps, "fused": tb.fused_steps,
                "vmem_batch": tb.vmem_batch_steps,
                "bitsliced": tb.bitsliced_steps}

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    logs = _build.build(force=True)
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s (set-up)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    # ------------------------------------------------ 2. vmem against plain
    t0 = time.perf_counter()
    vmem_err = 0
    seed = 100
    for shape in [(500, 500), (37, 45), (62, 1000), (95, 130)]:
        ny = shape[0]
        packed = tb.pack_board(soup(shape, seed))
        seed += 1
        for n in (0, 1, 129, 1000):
            got = tb.vmem_steps(packed, ny, n)
            want = tb._vmem_steps_plain(packed, ny, n)
            bad = diff_count(got, want)
            cells = diff_count(tb.unpack_board(got, ny),
                               tb.unpack_board(want, ny))
            vmem_err = max(vmem_err, min(cells, 1))
            log(f"  vmem {shape} n={n}: differing words {bad}")
            if bad:
                raise AssertionError(f"bitlife_vmem disagrees at {shape} n={n}")
    log(f"phase 2 vmem vs plain: ok ({time.perf_counter() - t0:.2f} s)")

    # ----------------------------------------------- 3. fused against plain
    def plain_steps(ext, k, plan):
        return tb._fused_steps_plain(ext, k, plan)

    def run_both(board, n, exact):
        ny, nx = board.shape
        plan = tb.plan_sharded_bits((ny, nx))
        if exact:
            q = tb.pack_board_exact(board)
        else:
            frame = torch.zeros(plan.frame, dtype=torch.uint8, device="cuda")
            frame[:ny] = board
            q = tb.pack_board_exact(frame)
        got = tb.unpack_board_exact(tb._run_plan(q, n, plan))[:ny]
        want = tb.unpack_board_exact(tb._run_plan(q, n, plan, plain_steps))[:ny]
        return plan, got, want

    t0 = time.perf_counter()
    fused_err = 0
    frame_plain_10k = None
    cases = [((4096, 4096), n, True) for n in (1, 128, 300)]
    cases += [((16384, 16384), n, True) for n in (1, 128, 300)]
    cases += [((10000, 10000), 300, False), ((1000, 1000), 300, False)]
    for shape, n, exact in cases:
        board = soup(shape, 7 if shape == (10000, 10000) else seed)
        seed += 1
        plan, got, want = run_both(board, n, exact)
        bad = diff_count(got, want)
        fused_err = max(fused_err, min(bad, 1))
        log(f"  fused {shape} n={n} plan tr={plan.tr} cx={plan.cx} "
            f"hx={plan.hx} pad_y={plan.pad_y}: differing cells {bad}")
        if bad:
            raise AssertionError(f"bitlife_fused disagrees at {shape} n={n}")
        if shape == (10000, 10000):
            frame_plain_10k = want
        del board, got, want
    torch.cuda.empty_cache()
    log(f"phase 3 fused vs plain: ok ({time.perf_counter() - t0:.2f} s)")

    # ------------------------------------ 4. batched kernels against plain
    t0 = time.perf_counter()
    batch_err = {"vmem_batch": 0, "bitsliced": 0}
    shapes = [(500, 500), (37, 45), (95, 130)]
    for b in (1, 3, 4, 64):
        for shape in shapes:
            ny = shape[0]
            packed = tb.pack_boards(soup((b, *shape), seed))
            seed += 1
            for n in (0, 1, 13, 1000):
                got = tb.vmem_batch_steps(packed, ny, n)
                want = tb._vmem_batch_steps_plain(packed, ny, n)
                bad = diff_count(got, want)
                batch_err["vmem_batch"] = max(batch_err["vmem_batch"],
                                              min(bad, 1))
                log(f"  vmem_batch B={b} {shape} n={n}: differing words {bad}")
                if bad:
                    raise AssertionError(
                        f"bitlife_vmem_batch disagrees at B={b} {shape} n={n}")
    for b in (8, 33, 64, 256):
        for shape in shapes + [(1, 8), (8, 1), (2, 2)]:
            planes = tb.pack_batch_bits(soup((b, *shape), seed))
            seed += 1
            plan = tb.plan_bitsliced(tuple(planes.shape))
            for n in (0, 1, 13, 1000):
                got = tb.bitsliced_steps(planes, n)
                want = tb._bitsliced_steps_plain(planes, n)
                bad = diff_count(got, want)
                batch_err["bitsliced"] = max(batch_err["bitsliced"],
                                             min(bad, 1))
                log(f"  bitsliced B={b} {shape} tile {plan.tr}x{plan.tc} "
                    f"n={n}: differing words {bad}")
                if bad:
                    raise AssertionError(
                        f"bitlife_bitsliced disagrees at B={b} {shape} n={n}")
    del packed, planes, got, want
    log(f"phase 4 batched kernels vs plain: ok "
        f"({time.perf_counter() - t0:.2f} s)")

    # --------------------------------------------------------- 5. main paths
    t0 = time.perf_counter()
    cfg = load_config(GUN_BIG)
    sim = LifeSim(cfg, layout="serial", impl="auto")
    final, launches_gun = run_counted(wrappers, sim.run)
    log(f"  main path p46gun_big: impl={sim.impl} path={sim.native_path} "
        f"steps={sim.step_count} launches={launches_gun}")
    if sim.native_path != "vmem" or launches_gun["vmem"] < 1:
        raise AssertionError("p46gun_big did not run through bitlife_vmem")
    oracle = cfg.board()
    for _ in range(cfg.steps):
        oracle = life_ops.life_step_numpy(oracle)
    population = int(final.sum())
    if not np.array_equal(final, oracle) or population != 7288:
        raise AssertionError(
            f"p46gun_big at step {cfg.steps}: population {population}, "
            f"{int((final != oracle).sum())} cells differ from the oracle")
    log(f"  p46gun_big matches the numpy oracle, population {population}")

    big = soup((10000, 10000), 7).cpu().numpy()
    big_cfg = LifeConfig(steps=300, save_steps=0, nx=10000, ny=10000,
                         cells=np.zeros((0, 2), np.int64))
    big_sim = LifeSim(big_cfg, layout="serial", impl="auto",
                      initial_board=big)
    big_final, launches_big = run_counted(wrappers, big_sim.run)
    log(f"  main path 10000^2 soup: path={big_sim.native_path} "
        f"launches={launches_big}")
    if big_sim.native_path != "frame" or launches_big["fused"] < 1:
        raise AssertionError("10000^2 did not run through bitlife_fused")
    if not np.array_equal(big_final, frame_plain_10k.cpu().numpy()):
        raise AssertionError("10000^2 LifeSim board differs from the plain "
                             "version's")
    roll = torch.from_numpy(big).cuda()
    for _ in range(big_cfg.steps):
        roll = life_ops.life_step_roll(roll)
    roll_bad = int((roll.cpu().numpy() != big_final).sum())
    if roll_bad:
        raise AssertionError(f"10000^2 LifeSim board: {roll_bad} cells differ "
                             "from unpacked life_step_roll")
    log("  10000^2 LifeSim board matches the plain version's and "
        f"{big_cfg.steps} unpacked life_step_roll steps")
    del big, big_final, big_sim, frame_plain_10k, roll
    torch.cuda.empty_cache()

    def cli_run(*extra, population):
        env = dict(os.environ, PYTHONPATH=ROOT)
        cli = subprocess.run(
            [sys.executable, "-m", "mpi_and_open_mp_tpu_torch.apps.life",
             GUN_BIG, "--layout", "serial", "--print-final-population",
             *extra],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        if cli.returncode != 0:
            raise AssertionError(f"CLI failed: {cli.stderr[-2000:]}")
        lines = cli.stdout.strip().splitlines()
        if (len(lines) != 1
                or cli.stderr.strip().splitlines()[-1] != str(population)):
            raise AssertionError(f"CLI output: {cli.stdout!r} {cli.stderr!r}")
        log(f"  CLI p46gun_big{''.join(' ' + e for e in extra)}: "
            f"{float(lines[0]):.6f} s elapsed line, population {population}")

    cli_run(population=7288)

    # The batched paths: 64 boards, board 0 p46gun_big and 63 soups.
    ny, nx = cfg.shape
    stack = soup((64, ny, nx), 21).cpu().numpy()
    stack[0] = cfg.board()
    bsim = LifeSim(cfg, layout="serial", impl="auto", initial_board=stack)
    bfinal, launches_sliced = run_counted(wrappers, bsim.run)
    log(f"  main path 64 x p46gun_big-size stack: path={bsim.native_path} "
        f"steps={bsim.step_count} launches={launches_sliced}")
    if (bsim.native_path != "batch:bitsliced"
            or launches_sliced["bitsliced"] < 1):
        raise AssertionError("the 64-board stack did not run through "
                             "bitlife_bitsliced")
    if not np.array_equal(bfinal[0], oracle):
        raise AssertionError(
            f"stack board 0: {int((bfinal[0] != oracle).sum())} cells differ "
            "from the oracle")
    for b in range(64):
        alone = tb.life_run_vmem_bits(torch.from_numpy(stack[b]).cuda(),
                                      cfg.steps).cpu().numpy()
        if not np.array_equal(bfinal[b], alone):
            raise AssertionError(
                f"stack board {b}: {int((bfinal[b] != alone).sum())} cells "
                "differ from the single-board bitlife_vmem run")
    log(f"  stack board 0 matches the oracle (population "
        f"{int(bfinal[0].sum())}); all 64 boards match bitlife_vmem")

    gsim = LifeSim(cfg, layout="serial", impl="auto", initial_board=stack[:4])
    gfinal, launches_grid = run_counted(wrappers, gsim.run)
    log(f"  main path 4-board stack: path={gsim.native_path} "
        f"launches={launches_grid}")
    if (gsim.native_path != "batch:vmem-grid"
            or launches_grid["vmem_batch"] < 1):
        raise AssertionError("the 4-board stack did not run through "
                             "bitlife_vmem_batch")
    if not np.array_equal(gfinal, bfinal[:4]):
        raise AssertionError("the 4-board vmem-grid stack differs from the "
                             "bitsliced stack's first 4 boards")
    log("  4-board vmem-grid stack matches")
    del bsim, gsim, gfinal

    cli_run("--batch", "64", population=64 * 7288)

    requests = [(soup((ny, nx), 300 + i).cpu().numpy(), 1000 if i % 5 else 2500)
                for i in range(40)]
    batcher = ShapeBucketBatcher(max_batch=64)
    for board, steps in requests:
        batcher.submit(board, steps)
    served, launches_batcher = run_counted(wrappers, batcher.flush)
    stats = [(s.steps, s.requests, s.padded_batch, s.path)
             for s in batcher.last_flush_stats]
    log(f"  batcher: 40 requests, dispatches {stats}, "
        f"launches={launches_batcher}")
    if launches_batcher["bitsliced"] < 1:
        raise AssertionError("the batcher did not run bitlife_bitsliced")
    for i, ((board, steps), got) in enumerate(zip(requests, served)):
        alone = tb.life_run_vmem_bits(torch.from_numpy(board).cuda(),
                                      steps).cpu().numpy()
        if not np.array_equal(got, alone):
            raise AssertionError(f"batcher request {i} differs from the "
                                 "single-board bitlife_vmem run")
    log("  every batcher result matches bitlife_vmem")
    del requests, served, stack, bfinal
    torch.cuda.empty_cache()
    log(f"phase 5 main paths: ok ({time.perf_counter() - t0:.2f} s)")

    # ---------------------------------------------------------- 6. timings
    t0 = time.perf_counter()
    ny, nx = cfg.shape
    gun_packed = tb.pack_board(torch.from_numpy(cfg.board()).cuda())
    n_main = cfg.steps
    tb.vmem_steps(gun_packed, ny, 100)  # warm-up
    vmem_ms = cuda_ms(lambda: tb.vmem_steps(gun_packed, ny, n_main), reps=3)
    plain_vmem_ms = cuda_ms(
        lambda: tb._vmem_steps_plain(gun_packed, ny, n_main))
    words = gun_packed.numel()
    vmem_bound, vmem_by = bound_ms(OPS_PER_WORD_STEP * words * n_main,
                                   2 * 4 * words)
    t_a = cuda_ms(lambda: tb.vmem_steps(gun_packed, ny, 2000))
    t_b = cuda_ms(lambda: tb.vmem_steps(gun_packed, ny, 12000))
    vmem_us_step = (t_b - t_a) / 10000 * 1e3
    log(f"  vmem p46gun_big {n_main} steps: {vmem_ms:.4f} ms per call, "
        f"plain {plain_vmem_ms:.2f} ms, bound {vmem_bound:.4f} ms "
        f"(card) / {vmem_bound * N_SMS:.4f} ms (one SM); "
        f"{vmem_us_step:.4f} us/step, "
        f"{ny * nx / vmem_us_step / 1e3:.3f} Gcups (differenced) [{card}]")

    rates = {}
    fused_rec = None
    for shape, exact in [((10000, 10000), False), ((16384, 16384), True),
                         ((4096, 4096), True)]:
        board = soup(shape, 11)
        plan = tb.plan_sharded_bits(shape)
        frame = board
        if not exact:
            frame = torch.zeros(plan.frame, dtype=torch.uint8, device="cuda")
            frame[: shape[0]] = board
        q = tb.pack_board_exact(frame)
        e = tb.local_wrap_y(plan, q)
        if plan.hx:
            e = torch.cat([e[:, -plan.hx:], e, e[:, : plan.hx]], dim=1)
        k = plan.k_max
        tb.fused_steps(e, k, plan)  # warm-up
        launch_ms = cuda_ms(lambda: tb.fused_steps(e, k, plan), reps=5)
        plain_ms = cuda_ms(lambda: plain_steps(e, k, plan))
        out_words = plan.nw * plan.frame[1]
        fb, fby = bound_ms(OPS_PER_WORD_STEP * out_words * k,
                           4 * (e.numel() + out_words))
        runner = tb.life_run_frame_bits if not exact else tb.life_run_fused_bits
        runner(board, k)  # warm-up
        t_a = cuda_ms(lambda: runner(board, 128))
        t_b = cuda_ms(lambda: runner(board, 640))
        us_step = (t_b - t_a) / 512 * 1e3
        rates[f"{shape[0]}x{shape[1]}"] = us_step
        log(f"  fused {shape} k={k} tr={plan.tr} cx={plan.cx} hx={plan.hx}: "
            f"{launch_ms:.4f} ms per launch, plain {plain_ms:.2f} ms, "
            f"bound {fb:.4f} ms ({fby}); runner {us_step:.4f} us/step, "
            f"{shape[0] * shape[1] / us_step / 1e3:.3f} Gcups "
            f"(differenced 640-128 steps) [{card}]")
        if shape == (10000, 10000):
            fused_rec = (launch_ms, plain_ms, fb, fby)
        del board, frame, q, e
        torch.cuda.empty_cache()

    # The batched kernels at the main path's shape: 64 boards of 500^2.
    nb = 64
    cells = soup((nb, ny, nx), 31)
    cells[0] = torch.from_numpy(cfg.board()).cuda()
    stack_packed = tb.pack_boards(cells)
    tb.vmem_batch_steps(stack_packed, ny, 100)  # warm-up
    vb_ms = cuda_ms(lambda: tb.vmem_batch_steps(stack_packed, ny, n_main),
                    reps=3)
    plain_vb_ms = cuda_ms(
        lambda: tb._vmem_batch_steps_plain(stack_packed, ny, n_main))
    vb_words = stack_packed.numel()
    vb_bound, vb_by = bound_ms(OPS_PER_WORD_STEP * vb_words * n_main,
                               2 * 4 * vb_words)
    t_a = cuda_ms(lambda: tb.vmem_batch_steps(stack_packed, ny, 2000))
    t_b = cuda_ms(lambda: tb.vmem_batch_steps(stack_packed, ny, 12000))
    vb_us_step = (t_b - t_a) / 10000 * 1e3
    log(f"  vmem_batch {nb} x {ny}x{nx} {n_main} steps: {vb_ms:.4f} ms per "
        f"call, plain {plain_vb_ms:.2f} ms, bound {vb_bound:.4f} ms (card) / "
        f"{vb_bound * N_SMS / nb:.4f} ms (the {nb} SMs it uses); "
        f"{vb_us_step:.4f} us/step, "
        f"{nb * ny * nx / vb_us_step / 1e3:.3f} Gcups (differenced) [{card}]")

    planes = tb.pack_batch_bits(cells)
    plan = tb.plan_bitsliced(tuple(planes.shape))
    tb.bitsliced_steps(planes, 100)  # warm-up
    bs_ms = cuda_ms(lambda: tb.bitsliced_steps(planes, n_main), reps=3)
    plain_bs_ms = cuda_ms(lambda: tb._bitsliced_steps_plain(planes, n_main))
    bs_words = planes.numel()
    bs_bound, bs_by = bound_ms(OPS_PER_SLICED_WORD_STEP * bs_words * n_main,
                               2 * 4 * bs_words)
    t_a = cuda_ms(lambda: tb.bitsliced_steps(planes, 2000))
    t_b = cuda_ms(lambda: tb.bitsliced_steps(planes, 12000))
    bs_us_step = (t_b - t_a) / 10000 * 1e3
    rounds = -(-n_main // plan.k)
    window = (plan.tr + 2 * plan.k) * (plan.tc + 2 * plan.k)
    blocks = (planes.shape[0] * -(-ny // plan.tr) * -(-nx // plan.tc))
    halo = blocks * window / bs_words
    log(f"  bitsliced {nb} x {ny}x{nx} {n_main} steps: {bs_ms:.4f} ms per "
        f"call ({rounds} launches of k={plan.k}, tile {plan.tr}x{plan.tc}, "
        f"{blocks} blocks, {halo:.3f}x the useful words stepped), plain "
        f"{plain_bs_ms:.2f} ms, bound {bs_bound:.4f} ms; "
        f"{bs_us_step:.4f} us/step, "
        f"{nb * ny * nx / bs_us_step / 1e3:.3f} Gcups (differenced) [{card}]")
    # Where the batched main path's device time goes: LifeSim.step packs
    # the stack, runs the kernel and unpacks; collect() copies to the host.
    stepped = tb.bitsliced_steps(planes, n_main)
    final_cells = tb.unpack_batch_bits(stepped, nb)
    split = {"pack": cuda_ms(lambda: tb.pack_batch_bits(cells), reps=3),
             "kernel": bs_ms,
             "unpack": cuda_ms(lambda: tb.unpack_batch_bits(stepped, nb),
                               reps=3),
             "to_host": cuda_ms(lambda: final_cells.cpu(), reps=3)}
    log("  bitsliced path split, ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
        + f" [{card}]")
    del cells, stack_packed, planes, stepped, final_cells
    torch.cuda.empty_cache()

    # Both batched kernels on the same stacks: which one a stack size
    # favours. Per-step times from the difference of 1200 and 200 steps.
    def per_step_us(fn):
        fn(200)  # warm-up
        t_a = cuda_ms(lambda: fn(200))
        t_b = cuda_ms(lambda: fn(1200))
        return (t_b - t_a) / 1000 * 1e3

    sweep = [((500, 500), b) for b in (64, 128, 256, 512)]
    sweep += [((95, 130), b) for b in (8, 64, 256, 512)]
    for shape, b in sweep:
        ny_s = shape[0]
        cells = soup((b, *shape), 41 + b)
        packed = tb.pack_boards(cells)
        planes = tb.pack_batch_bits(cells)
        grid_us = per_step_us(lambda n: tb.vmem_batch_steps(packed, ny_s, n))
        sliced_us = per_step_us(lambda n: tb.bitsliced_steps(planes, n))
        grid_board = tb.unpack_boards(
            tb.vmem_batch_steps(packed, ny_s, 1200), ny_s)
        sliced_board = tb.unpack_batch_bits(
            tb.bitsliced_steps(planes, 1200), b)
        bad = diff_count(grid_board, sliced_board)
        if bad:
            raise AssertionError(f"batched kernels disagree at B={b} {shape}: "
                                 f"{bad} cells")
        winner = "vmem-grid" if grid_us < sliced_us else "bitsliced"
        ratio = max(grid_us, sliced_us) / min(grid_us, sliced_us)
        cells_per_step = b * shape[0] * shape[1]
        log(f"  batched B={b} {shape[0]}x{shape[1]}: vmem-grid "
            f"{grid_us:.4f} us/step "
            f"({cells_per_step / grid_us / 1e3:.1f} Gcups), bitsliced "
            f"{sliced_us:.4f} us/step "
            f"({cells_per_step / sliced_us / 1e3:.1f} Gcups); {winner} "
            f"faster by {ratio:.3f}x, boards equal [{card}]")
        del cells, packed, planes, grid_board, sliced_board
    torch.cuda.empty_cache()
    log(f"phase 6 timings: {time.perf_counter() - t0:.2f} s")

    kernels = [
        {"name": "bitlife_vmem", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/bitlife_vmem.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/bitlife.py:236",
         "launches": launches_gun["vmem"], "max_abs_err": float(vmem_err),
         "ms": vmem_ms, "plain_ms": plain_vmem_ms, "bound_ms": vmem_bound,
         "bound_by": vmem_by, "library_ms": None,
         "shape": "p46gun_big 500x500, 10000 steps per call",
         "us_per_step": vmem_us_step},
        {"name": "bitlife_fused", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/bitlife_fused.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/bitlife.py:333",
         "launches": launches_big["fused"], "max_abs_err": float(fused_err),
         "ms": fused_rec[0], "plain_ms": fused_rec[1],
         "bound_ms": fused_rec[2], "bound_by": fused_rec[3],
         "library_ms": None,
         "shape": "10000x10000 padded frame, 128 steps per launch",
         "us_per_step": rates},
        {"name": "bitlife_vmem_batch", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/bitlife_vmem_batch.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/bitlife.py:1084",
         "launches": launches_grid["vmem_batch"],
         "max_abs_err": float(batch_err["vmem_batch"]),
         "ms": vb_ms, "plain_ms": plain_vb_ms, "bound_ms": vb_bound,
         "bound_by": vb_by, "library_ms": None,
         "shape": f"{nb} x 500x500, 10000 steps per call",
         "us_per_step": vb_us_step},
        {"name": "bitlife_bitsliced", "route": "cuda",
         "source": "mpi_and_open_mp_tpu_torch/csrc/bitlife_bitsliced.cu",
         "replaces": "mpi_and_open_mp_tpu/ops/bitlife.py:1383",
         "launches": launches_sliced["bitsliced"],
         "max_abs_err": float(batch_err["bitsliced"]),
         "ms": bs_ms, "plain_ms": plain_bs_ms, "bound_ms": bs_bound,
         "bound_by": bs_by, "library_ms": None,
         "shape": (f"{nb} x 500x500 (2 planes), 10000 steps per call in "
                   f"{rounds} launches, tile {plan.tr}x{plan.tc}"),
         "us_per_step": bs_us_step},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
