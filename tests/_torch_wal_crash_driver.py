"""Subprocess driver for the port's journal crash matrix (ticket mode).

Runs the port's serving daemon on the CPU with a write-ahead journal and
the ``MOMP_CHAOS crash=<site>:<k>`` plan the parent test set, and acks
every ticket whose ``submit()`` returned to a side file (write, flush,
fsync, so the ack is durable before the parent reads it). The chaos site
kills the process with ``os._exit(137)``; the parent then replays the
journal and checks the fsync policy's loss bound over exactly the acked
set.

Usage: ``python _torch_wal_crash_driver.py WAL_PATH FSYNC_POLICY ACK_PATH N``

Exits 0 after a clean drain (printing a one-line JSON summary); a planned
crash never reaches that code. Imports neither JAX nor the JAX package.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> int:
    import torch

    torch.set_num_threads(1)
    from mpi_and_open_mp_tpu_torch.serve import ServePolicy, ServingDaemon

    wal_path, fsync, ack_path = sys.argv[1], sys.argv[2], sys.argv[3]
    n = int(sys.argv[4])
    daemon = ServingDaemon(ServePolicy(max_batch=4, max_wait_s=0.0),
                           wal_path=wal_path, wal_fsync=fsync, device="cpu")
    rng = np.random.default_rng(7)
    with open(ack_path, "ab") as ack:
        for _ in range(n):
            board = (rng.random((12, 12)) < 0.3).astype(np.uint8)
            t = daemon.submit(board, 2)
            ack.write(f"{t.id}\n".encode())
            ack.flush()
            os.fsync(ack.fileno())
    daemon.serve()
    s = daemon.summary()
    daemon._wal.close()
    print(json.dumps({"resolved": s["resolved"], "shed": s["shed"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
