"""Crash-atomic restart points for a Life board.

Counterpart of ``mpi_and_open_mp_tpu/utils/checkpoint.py``. The JAX
package writes its restart point as an Orbax tree, which needs JAX; the
port writes it as one ``MOMP-STATE/1`` file, the JAX package's own
single-file host-state frame (its ``save_state``/``restore_state``): an
ASCII magic line, an 8-byte big-endian payload length, a 4-byte CRC32 of
the payload, then the pickled payload. :func:`restore_state` validates
the frame, the length and the CRC before it unpickles, so a truncated or
garbage file raises a ``ValueError`` naming the failure, with the JAX
package's texts, never a pickle or struct traceback.

:func:`save` and :func:`restore` carry one board on that frame: the
payload is ``{"board": uint8 (ny, nx) numpy array, "step": int, "crc":
CRC32 of the board bytes}``, numpy and builtins only, so the JAX
package's ``restore_state`` reads a port checkpoint. Files are named
``step_NNNNNN.state`` (:func:`checkpoint_name`); the JAX package's resume
matches only ``step_\\d{6,}`` in full (its Orbax directories), so neither
package takes the other's restart point for its own.

Writes are crash-atomic: a tmp sibling, ``fsync``, ``os.replace``, then an
``fsync`` of the directory, so a kill mid-save leaves the old complete
file at the path.

Observability, as the JAX package's: spans ``checkpoint.save``,
``checkpoint.restore``, ``checkpoint.state_save`` and
``checkpoint.state_restore`` (``obs.trace``); counters
``checkpoint.saves``, ``checkpoint.save.bytes``, ``checkpoint.restores``,
``checkpoint.restore.bytes``, ``checkpoint.state_saves``,
``checkpoint.state_save.bytes`` and ``checkpoint.state_restores``, and
histograms ``checkpoint.save_seconds`` and ``checkpoint.restore_seconds``
(``obs.metrics``). A board checkpoint counts as a save, not also as a
state save, as in the JAX package, whose board checkpoints are Orbax
trees.
"""

from __future__ import annotations

import os
import pickle
import struct
import time
import zlib

import numpy as np

from mpi_and_open_mp_tpu_torch.obs import metrics, trace
from mpi_and_open_mp_tpu_torch.utils.timing import Timer

STATE_MAGIC = b"MOMP-STATE/1\n"
_STATE_HEADER = struct.Struct(">QI")  # payload length, CRC32


def checkpoint_name(step: int) -> str:
    """The file name of the restart point at ``step``."""
    return f"step_{int(step):06d}.state"


def _fsync_dir(path: str | os.PathLike) -> None:
    """fsync the directory holding ``path``: the rename of a tmp+replace
    sequence lives in the directory inode, and is durable only once that
    inode is on disk. Best-effort where a directory cannot be opened."""
    d = os.path.dirname(os.path.abspath(os.fspath(path))) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def quarantine(path: str | os.PathLike, label: str = "corrupt") -> str | None:
    """Move a bad artifact aside as ``<path>.<label>.<stamp>`` and return
    the destination (``None`` when nothing was there or the move failed).
    The stamp (UTC time, pid, a collision counter) makes every copy unique,
    so a second corruption never overwrites the first one's evidence."""
    path = os.path.abspath(os.fspath(path))
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime()) + f".{os.getpid()}"
    dst = f"{path}.{label}.{stamp}"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{path}.{label}.{stamp}.{n}"
    try:
        os.replace(path, dst)
    except OSError:
        return None
    _fsync_dir(dst)
    return dst


def _frame(state) -> bytes:
    payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    return (STATE_MAGIC
            + _STATE_HEADER.pack(len(payload), zlib.crc32(payload))
            + payload)


def _write_atomic(path: str, blob: bytes) -> None:
    outdir = os.path.dirname(path)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fd:
        fd.write(blob)
        fd.flush()
        os.fsync(fd.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)


def _read_frame(path: str):
    """The state in the ``MOMP-STATE/1`` file at ``path``, validated
    (:func:`restore_state`'s checks)."""
    try:
        with open(path, "rb") as fd:
            blob = fd.read()
    except OSError as e:
        raise ValueError(
            f"no readable state checkpoint at {path} "
            f"({type(e).__name__}: {e})") from e
    head = len(STATE_MAGIC) + _STATE_HEADER.size
    if not blob.startswith(STATE_MAGIC):
        raise ValueError(
            f"state checkpoint at {path} has a bad magic header — "
            "not a MOMP-STATE/1 file (or corrupted at offset 0)")
    if len(blob) < head:
        raise ValueError(
            f"state checkpoint at {path} is truncated inside its "
            f"header ({len(blob)} of {head} header bytes)")
    length, want_crc = _STATE_HEADER.unpack(blob[len(STATE_MAGIC):head])
    payload = blob[head:]
    if len(payload) != length:
        raise ValueError(
            f"state checkpoint at {path} is truncated: payload is "
            f"{len(payload)} bytes, header promises {length}")
    got_crc = zlib.crc32(payload)
    if got_crc != want_crc:
        raise ValueError(
            f"state checkpoint at {path} failed its CRC "
            f"(stored {want_crc:#010x}, recomputed {got_crc:#010x}) "
            "— the file is corrupt")
    try:
        return pickle.loads(payload)
    except Exception as e:  # noqa: BLE001 - any unpickle failure
        raise ValueError(
            f"state checkpoint at {path} passed its CRC but failed "
            f"to decode ({type(e).__name__}: {e})"[:400]) from e


def save_state(path: str | os.PathLike, state) -> None:
    """Write one picklable host-state tree to ``path`` atomically."""
    path = os.path.abspath(os.fspath(path))
    blob = _frame(state)
    with trace.span("checkpoint.state_save", path=path, bytes=len(blob)):
        _write_atomic(path, blob)
    metrics.inc("checkpoint.state_saves")
    metrics.inc("checkpoint.state_save.bytes", len(blob))


def restore_state(path: str | os.PathLike):
    """Read a :func:`save_state` file back, fully validated; raises
    ``ValueError`` naming the failure (missing file, bad magic, truncated
    header or payload, CRC mismatch, undecodable payload)."""
    path = os.path.abspath(os.fspath(path))
    with trace.span("checkpoint.state_restore", path=path):
        state = _read_frame(path)
    metrics.inc("checkpoint.state_restores")
    return state


def _board_crc(board: np.ndarray) -> int:
    """CRC32 of the uint8 board bytes, the manifest :func:`restore`
    verifies."""
    return zlib.crc32(np.ascontiguousarray(board, dtype=np.uint8).tobytes())


def save(path: str | os.PathLike, board, step: int) -> None:
    """Write ``{board, step, crc}`` at ``path`` atomically. ``board`` is a
    ``(ny, nx)`` host array or tensor, stored as uint8."""
    path = os.path.abspath(os.fspath(path))
    nbytes = int(getattr(board, "nbytes", 0))
    with trace.span("checkpoint.save", step=int(step), bytes=nbytes,
                    path=path), Timer() as t:
        if hasattr(board, "detach"):
            board = board.detach().cpu().numpy()
        board = np.ascontiguousarray(board, dtype=np.uint8)
        if board.ndim != 2:
            raise ValueError(f"a checkpoint holds one (ny, nx) board, got "
                             f"shape {board.shape}")
        _write_atomic(path, _frame({"board": board, "step": int(step),
                                    "crc": _board_crc(board)}))
    metrics.inc("checkpoint.saves")
    metrics.inc("checkpoint.save.bytes", nbytes)
    metrics.observe("checkpoint.save_seconds", t.elapsed)


def restore(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Read a checkpoint back to ``(board, step)``, validated as the JAX
    package's ``restore`` validates its tree: the board and step present,
    rank 2, step >= 0, and the CRC manifest (0 means unverified). The
    caller places the board on its own mesh."""
    path = os.path.abspath(os.fspath(path))
    with trace.span("checkpoint.restore", path=path), Timer() as t:
        tree = _read_frame(path)
    metrics.inc("checkpoint.restores")
    metrics.observe("checkpoint.restore_seconds", t.elapsed)
    if not isinstance(tree, dict) or "board" not in tree or "step" not in tree:
        raise ValueError(
            f"checkpoint at {path} is missing its board/step leaves "
            f"(got {sorted(tree) if isinstance(tree, dict) else type(tree)})")
    board = np.asarray(tree["board"])
    if board.ndim != 2:
        raise ValueError(
            f"checkpoint board at {path} has rank {board.ndim}, want 2")
    board = board.astype(np.uint8)
    metrics.inc("checkpoint.restore.bytes", int(board.nbytes))
    step = int(tree["step"])
    if step < 0:
        raise ValueError(f"checkpoint at {path} carries negative step {step}")
    want = int(tree.get("crc", 0))
    if want:
        got = _board_crc(board)
        if got != want:
            raise ValueError(
                f"checkpoint at {path} failed its CRC manifest "
                f"(stored {want:#010x}, recomputed {got:#010x}) — "
                "the tree is corrupt; fall back to an earlier step")
    return board, step
