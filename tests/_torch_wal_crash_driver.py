"""Subprocess driver for the port's journal crash matrix.

Runs the port's serving daemon with a write-ahead journal and the
``MOMP_CHAOS crash=<site>:<k>`` plan the parent set, and acks every
operation that returned to a side file (write, flush, fsync, so the ack is
durable before the parent reads it). The chaos site kills the process with
``os._exit(137)``; the parent then replays the journal and checks the loss
bound over exactly the acked set.

Usage: ``python _torch_wal_crash_driver.py WAL_PATH FSYNC_POLICY ACK_PATH N
[ticket|pool|settled] [cpu|cuda]`` (default ``ticket`` on the CPU).

``ticket``: N 12x12 tickets of 2 steps, each acked by its id, then a drain.
``pool``: the resident-session lifecycle instead. N pool sessions are
created (ack ``C <sid>``), stepped 2 steps each in two rounds (``S <sid>
2``), p0 snapshotted (``N p0``) and the last evicted (``E <sid>``). The
pool's sites (``post-create``, ``post-step``, ``post-snapshot``,
``post-evict``) fire after the frame is journaled and before the pool
acts, so under ``every-record`` an acked op is durable and at most one
journaled op is unacked. ``settled``: the pool mode with p0 a still life
(a block) and five rounds, so the settled skip engages on p0 while the
chaos site is armed; the journal's STEP frames stay authoritative.

Exits 0 after a clean run (printing a one-line JSON summary); a planned
crash never reaches that code. Imports neither JAX nor the JAX package.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _pool_mode(daemon, rec, n: int, mode: str) -> dict:
    rng = np.random.default_rng(7)
    for i in range(n):
        board = (rng.random((12, 12)) < 0.3).astype(np.uint8)
        if mode == "settled" and i == 0:
            board = np.zeros((12, 12), np.uint8)
            board[5:7, 5:7] = 1
        daemon.create_session(f"p{i}", board)
        rec(f"C p{i}")
    for _ in range(5 if mode == "settled" else 2):
        for i in range(n):
            daemon.step_session(f"p{i}", 2)
            rec(f"S p{i} 2")
    daemon.snapshot_session("p0")
    rec("N p0")
    daemon.evict_session(f"p{n - 1}")
    rec(f"E p{n - 1}")
    daemon._wal.sync()
    s = daemon.summary()
    return {"sessions": s["pool_sessions"],
            "settled_skips": s["pool_settled_skips"]}


def main() -> int:
    import torch

    torch.set_num_threads(1)
    from mpi_and_open_mp_tpu_torch.serve import ServePolicy, ServingDaemon

    wal_path, fsync, ack_path = sys.argv[1], sys.argv[2], sys.argv[3]
    n = int(sys.argv[4])
    mode = sys.argv[5] if len(sys.argv) > 5 else "ticket"
    device = sys.argv[6] if len(sys.argv) > 6 else "cpu"
    if mode not in ("ticket", "pool", "settled"):
        raise ValueError(f"unknown mode {mode!r}")
    daemon = ServingDaemon(ServePolicy(max_batch=4, max_wait_s=0.0),
                           wal_path=wal_path, wal_fsync=fsync, device=device)
    with open(ack_path, "ab") as ack:
        def rec(line: str) -> None:
            ack.write((line + "\n").encode())
            ack.flush()
            os.fsync(ack.fileno())

        if mode != "ticket":
            out = _pool_mode(daemon, rec, n, mode)
            daemon._wal.close()
            print(json.dumps(out))
            return 0
        rng = np.random.default_rng(7)
        for _ in range(n):
            board = (rng.random((12, 12)) < 0.3).astype(np.uint8)
            rec(str(daemon.submit(board, 2).id))
    daemon.serve()
    s = daemon.summary()
    daemon._wal.close()
    print(json.dumps({"resolved": s["resolved"], "shed": s["shed"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
