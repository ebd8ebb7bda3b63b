"""Durable launch-record cache of the batched Life paths.

Counterpart of ``mpi_and_open_mp_tpu/serve/aotcache.py``, with its API
(:class:`ArtifactError`, :class:`ParityError`, :func:`code_fingerprint`,
:func:`fingerprint`, :func:`digest_for`, :func:`bucket_sizes`,
:func:`save_artifact`, :func:`load_artifact`, :class:`AOTCache`) and its
disciplines, on a design of its own. The JAX package serialises each
bucket's compiled program through ``jax.export``. The port compiles no
program per shape: what a bucket runs on the card is a hand-written kernel
library, built by ``ops/_build.py`` from ``csrc/`` into
``build/kernels/lib<name>.so``, launched under the geometry the port's
planner gives that stack. So an artifact here is a **launch record**:

* the engine path of the bucket (``native_path_batch``, an installed tuned
  plan included);
* the geometry the planner gives the bucket: ``vmem_batch_launch_geometry``
  (``vmem-grid``), ``plan_bitsliced`` (``bitsliced``), or the big-board
  plan ``plan_sharded_bits`` with ``fused_launch_geometry`` at its full
  round (``fused``, ``frame``);
* the sha256 of each ``build/kernels/lib<name>.so`` the path loads (none
  on the CPU, where the plain versions run).

**What it saves, and what it does not.** The cold-start cost on the card
is the ``nvcc`` build, seconds a source, and ``ops/_build.py`` already
keeps built libraries on disk between processes. A launch record adds no
speed: it proves that a process runs the libraries and the geometry a
tuned plan was measured with (``tune``), and fails closed when they moved.
No warm-start saving has been measured.

**Keying.** An artifact's file name is the digest of its fingerprint:
stack shape, dtype, bucket, the steps signature (a run-time argument of
every launch), the engine path and pack layout, the stencil workload,
``torch`` and its ``cuda`` version in place of ``jax``/``jaxlib``, the
platform (``cuda`` or ``cpu``), the device kind, the topology, and a hash
of the dispatch and engine sources and of every ``csrc/*.cu``/``*.cuh``
(editing a kernel makes every artifact stale). The fingerprint is stored
inside the envelope and checked on load; then the record itself is derived
again from the key: a geometry the planner no longer gives, or a library
whose hash is not the built one's, is ``stale``. A stale or corrupt
artifact is quarantined and its record built afresh: the cache fails
closed to a fresh build, never to a plain version.

**Hardened like the checkpoints.** The ``MOMP-AOT/1`` envelope (magic,
``>QI`` length and CRC32, payload) written tmp + fsync + ``os.replace`` +
directory fsync (``utils/checkpoint._fsync_dir``); a bad artifact moved
aside by ``utils.checkpoint.quarantine``; every outcome counted as
``serve.aot{status=...}`` and traced (``obs``). :meth:`AOTCache.call_verified`
holds a record's first result in each process bit for bit against the
NumPy oracle. ``MOMP_CHAOS="aot_corrupt=<bitflip|skew>:<k>"`` damages the
first ``k`` artifacts on disk after their clean write.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import pickle
import struct
import time
import zlib

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.utils import checkpoint as checkpoint_mod
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

AOT_MAGIC = b"MOMP-AOT/1\n"
_HEADER = struct.Struct(">QI")  # payload length, CRC32

#: The steps calling convention every record shares: the step count is a
#: run-time int argument of each launch, so one record serves any count.
STEPS_SIGNATURE = "runtime-scalar-int32"

#: The kernel library each batched path loads (``ops/_build.py`` names).
PATH_LIBRARIES = {"bitsliced": ("bitlife_bitsliced",),
                  "vmem-grid": ("bitlife_vmem_batch",),
                  "fused": ("bitlife_fused",), "frame": ("bitlife_fused",),
                  "plain": ()}

_PKG = pathlib.Path(__file__).resolve().parents[1]
_CODE_SOURCES = ("ops/bitlife.py", "ops/native_life.py",
                 "stencils/engine.py", "stencils/spec.py")
_CODE_FP: dict[str, str] = {}


class ArtifactError(ValueError):
    """An artifact that must not be run. ``kind`` is ``"corrupt"`` (bad
    magic, length or CRC, an undecodable payload or record) or ``"stale"``
    (an intact envelope whose key or record this process no longer
    derives: another torch, edited kernels, a rebuilt library, other
    silicon)."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


class ParityError(RuntimeError):
    """A launch record whose first result diverged from the NumPy oracle."""


def code_fingerprint(csrc: str | os.PathLike | None = None) -> str:
    """Hash of the dispatch and engine sources (``ops/bitlife.py``,
    ``ops/native_life.py``, ``stencils/engine.py``, ``stencils/spec.py``)
    and of every ``*.cu``/``*.cuh`` in ``csrc`` (default: the package's
    ``csrc/``), names and contents. Cached per directory."""
    from mpi_and_open_mp_tpu_torch.ops import _build

    csrc = pathlib.Path(csrc) if csrc is not None else _build.CSRC
    cached = _CODE_FP.get(str(csrc))
    if cached is None:
        h = hashlib.sha256()
        kernels = sorted(p for p in csrc.iterdir()
                         if p.suffix in (".cu", ".cuh"))
        for name, path in ([(s, _PKG / s) for s in _CODE_SOURCES]
                           + [(f"csrc/{p.name}", p) for p in kernels]):
            h.update(name.encode() + b"\0" + path.read_bytes())
        cached = _CODE_FP[str(csrc)] = h.hexdigest()[:16]
    return cached


def _platform(device: torch.device) -> tuple[str, str, int]:
    """(platform, device kind, device count) of ``device``."""
    if device.type == "cuda":
        return ("cuda", torch.cuda.get_device_name(device),
                torch.cuda.device_count())
    return "cpu", "cpu", 1


def fingerprint(stack_shape: tuple[int, int, int], dtype, *,
                program: str = "bucket", donated: bool = False,
                workload: str = "life",
                device: str | torch.device = "cuda") -> dict:
    """The full key of one bucket's launch record on ``device``:
    everything that can change what runs or whether it may run."""
    from mpi_and_open_mp_tpu_torch.ops import native_life

    dev = resolve_device(device)
    platform, kind, count = _platform(dev)
    on_card = platform == "cuda"
    b, ny, nx = (int(x) for x in stack_shape)
    return {
        "schema": "momp-aot/1",
        "shape": [ny, nx],
        "dtype": str(np.dtype(dtype)),
        "bucket": b,
        "program": str(program),
        "donated": bool(donated),
        "workload": str(workload),
        "steps": STEPS_SIGNATURE,
        "engine_path": "batch:" + native_life.native_path_batch(
            (b, ny, nx), on_card=on_card),
        "pack_layout": native_life.batch_pack_layout((b, ny, nx),
                                                     on_card=on_card),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "platform": platform,
        "device_kind": kind,
        "topology": f"{platform}:{count}",
        "code": code_fingerprint(),
    }


def digest_for(key: dict) -> str:
    blob = json.dumps(key, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def bucket_sizes(max_batch: int) -> list[int]:
    """Every batch size ``serve.batcher.bucket_batch_size`` can emit: powers
    of two below ``max_batch``, ``max_batch`` itself, and the 32-board plane
    multiples the board-sliced rounding pads to."""
    sizes, b = set(), 1
    while b < max_batch:
        sizes.add(b)
        b *= 2
    sizes.add(int(max_batch))
    w = 32
    while w <= max_batch:
        sizes.add(w)
        w += 32
    return sorted(sizes)


def _plain(obj):
    """``obj`` as JSON would give it back (tuples as lists)."""
    return json.loads(json.dumps(obj))


def _library_hashes(names) -> dict[str, str]:
    """sha256 of each built kernel library, built first where missing or
    older than its sources."""
    from mpi_and_open_mp_tpu_torch.ops import _build

    out = {}
    for name in names:
        _build.load(name)
        out[name] = hashlib.sha256(
            _build.lib_path(name).read_bytes()).hexdigest()
    return out


def launch_record(key: dict) -> dict:
    """The launch record ``key`` derives on this machine: its path, the
    planner's geometry for its stack, and the hash of each library the
    path loads (on the card)."""
    from mpi_and_open_mp_tpu_torch.ops import bitlife

    b = int(key["bucket"])
    ny, nx = (int(x) for x in key["shape"])
    path = str(key["engine_path"]).removeprefix("batch:")
    if path not in PATH_LIBRARIES:
        raise ValueError(f"no launch record for the path {path!r}")
    if path == "vmem-grid":
        geometry = dataclasses.asdict(
            bitlife.vmem_batch_launch_geometry(b, ny, nx))
    elif path == "bitsliced":
        geometry = dataclasses.asdict(
            bitlife.plan_bitsliced((bitlife.n_planes(b), ny, nx)))
    elif path in ("fused", "frame"):
        plan = bitlife.plan_sharded_bits((ny, nx))
        geometry = {"plan": dataclasses.asdict(plan),
                    "round": dataclasses.asdict(bitlife.fused_launch_geometry(
                        plan.nw_s, plan.W, plan.h, plan.hx, plan.k_max))}
    else:
        geometry = {}
    libs = (_library_hashes(PATH_LIBRARIES[path])
            if key["platform"] == "cuda" else {})
    return _plain({"path": path, "geometry": geometry, "libraries": libs})


def _frame(key: dict, blob: bytes) -> bytes:
    payload = pickle.dumps({"key": key, "blob": blob},
                           protocol=pickle.HIGHEST_PROTOCOL)
    return (AOT_MAGIC + _HEADER.pack(len(payload), zlib.crc32(payload))
            + payload)


def save_artifact(path: str, key: dict, blob: bytes) -> None:
    """Write one artifact crash-atomically (the ``utils.checkpoint``
    envelope, tmp + fsync + replace + directory fsync). An armed
    ``MOMP_CHAOS aot_corrupt=`` plan then damages it on disk: the record
    this process holds stays good, and the fault surfaces where bit rot
    would, in the next process's load."""
    from mpi_and_open_mp_tpu_torch.robust import chaos

    framed = _frame(key, blob)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fd:
        fd.write(framed)
        fd.flush()
        os.fsync(fd.fileno())
    os.replace(tmp, path)
    checkpoint_mod._fsync_dir(path)
    kind = chaos.take_aot_corrupt()
    if kind == "bitflip":
        with open(path, "r+b") as fd:
            fd.seek(len(framed) // 2)
            byte = fd.read(1)
            fd.seek(len(framed) // 2)
            fd.write(bytes([byte[0] ^ 0x40]))
    elif kind == "skew":
        with open(path, "wb") as fd:
            fd.write(_frame(dict(key, torch="0.0.0-chaos-skew"), blob))


def load_artifact(path: str, want_key: dict) -> dict:
    """Read one artifact back, validated before anything runs: magic,
    header, length, CRC, payload decode, the stored key against
    ``want_key``, then the stored record against the one this machine
    derives from the key (:func:`launch_record`). Returns the record;
    raises :class:`ArtifactError`."""
    try:
        with open(path, "rb") as fd:
            framed = fd.read()
    except OSError as e:
        raise ArtifactError(
            "corrupt", f"unreadable AOT artifact at {path} "
            f"({type(e).__name__}: {e})") from e
    head = len(AOT_MAGIC) + _HEADER.size
    if not framed.startswith(AOT_MAGIC):
        raise ArtifactError(
            "corrupt", f"AOT artifact at {path} has a bad magic header: "
            "not a MOMP-AOT/1 file (or corrupted at offset 0)")
    if len(framed) < head:
        raise ArtifactError(
            "corrupt", f"AOT artifact at {path} is truncated inside its "
            f"header ({len(framed)} of {head} header bytes)")
    length, want_crc = _HEADER.unpack(framed[len(AOT_MAGIC):head])
    payload = framed[head:]
    if len(payload) != length:
        raise ArtifactError(
            "corrupt", f"AOT artifact at {path} is truncated: payload is "
            f"{len(payload)} bytes, header promises {length}")
    if zlib.crc32(payload) != want_crc:
        raise ArtifactError(
            "corrupt", f"AOT artifact at {path} failed its CRC "
            f"(stored {want_crc:#010x}, recomputed "
            f"{zlib.crc32(payload):#010x}): the file is corrupt")
    try:
        doc = pickle.loads(payload)
        stored_key = doc["key"]
        record = json.loads(doc["blob"])
    except Exception as e:  # noqa: BLE001 - any decode failure
        raise ArtifactError(
            "corrupt", f"AOT artifact at {path} passed its CRC but failed "
            f"to decode ({type(e).__name__}: {e})"[:400]) from e
    if stored_key != want_key:
        drift = sorted(k for k in set(stored_key) | set(want_key)
                       if stored_key.get(k) != want_key.get(k))
        raise ArtifactError(
            "stale", f"AOT artifact at {path} is key-stale (fields "
            f"drifted: {drift}): made by another torch, kernel source or "
            "card; rebuilding")
    want = launch_record(want_key)
    if record != want:
        drift = sorted(k for k in set(record) | set(want)
                       if record.get(k) != want.get(k))
        raise ArtifactError(
            "stale", f"AOT artifact at {path} records another launch "
            f"(fields drifted: {drift}): the planner or a built library "
            "moved; rebuilding")
    return record


class AOTCache:
    """On-disk and in-memory store of the batched Life paths' launch
    records on ``device``.

    :meth:`ensure` is the one entry point: the record in memory, else
    loaded from disk (hit), else derived and persisted (miss); a bad
    artifact is quarantined and rebuilt. Every outcome lands in
    :meth:`stats`, the metrics registry (``serve.aot{status=...}``) and
    the trace. A failure of the cache itself gives ``(digest, None,
    "error")``: the caller then dispatches through the ladder."""

    def __init__(self, root: str | os.PathLike,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.root = os.path.abspath(os.fspath(root))
        os.makedirs(self.root, exist_ok=True)
        self._programs: dict[str, dict] = {}
        self._verified: set[str] = set()
        self._stats = {"hits": 0, "misses": 0, "corrupt": 0, "stale": 0,
                       "parity_failed": 0, "built": 0, "errors": 0,
                       "deserialize_s": 0.0, "build_s": 0.0}

    def stats(self) -> dict:
        out = dict(self._stats)
        out["deserialize_s"] = round(out["deserialize_s"], 6)
        out["build_s"] = round(out["build_s"], 6)
        out["programs"] = len(self._programs)
        return out

    def _note(self, status: str, **fields) -> None:
        from mpi_and_open_mp_tpu_torch.obs import metrics, trace

        metrics.inc("serve.aot", status=status)
        trace.event("serve.aot", status=status, **fields)

    def artifact_path(self, digest: str) -> str:
        return os.path.join(self.root, digest + ".aot")

    def ensure(self, stack_shape, dtype) -> tuple[str, dict | None, str]:
        """``(digest, record or None, status)`` for one bucket. ``status``:
        ``"memory"``, ``"hit"``, ``"miss"`` (derived and persisted),
        ``"corrupt"``/``"stale"`` (quarantined, then derived afresh), or
        ``"error"``."""
        try:
            key = fingerprint(stack_shape, dtype, device=self.device)
            digest = digest_for(key)
        except Exception as e:  # noqa: BLE001 - keying must not kill serve
            self._stats["errors"] += 1
            self._note("error", error=f"{type(e).__name__}: {e}"[:200])
            return "", None, "error"
        if digest in self._programs:
            return digest, self._programs[digest], "memory"
        path = self.artifact_path(digest)
        status = "miss"
        if os.path.exists(path):
            t0 = time.perf_counter()
            try:
                record = load_artifact(path, key)
            except ArtifactError as e:
                status = e.kind
                self._stats[e.kind] += 1
                quarantined = checkpoint_mod.quarantine(path, label=e.kind)
                self._note(e.kind, digest=digest,
                           quarantined=quarantined or "", error=str(e)[:200])
            else:
                self._stats["hits"] += 1
                self._stats["deserialize_s"] += time.perf_counter() - t0
                self._note("hit", digest=digest)
                self._programs[digest] = record
                return digest, record, "hit"
        if status == "miss":
            self._stats["misses"] += 1
            self._note("miss", digest=digest)
        t0 = time.perf_counter()
        try:
            record = launch_record(key)
            self._stats["build_s"] += time.perf_counter() - t0
            self._stats["built"] += 1
            save_artifact(path, key, json.dumps(record).encode())
        except Exception as e:  # noqa: BLE001 - never crash the caller
            self._stats["errors"] += 1
            self._note("error", digest=digest,
                       error=f"{type(e).__name__}: {e}"[:200])
            return digest, None, "error"
        self._programs[digest] = record
        return digest, record, status

    def warm(self, boards, max_batch: int) -> dict:
        """Ensure the record of every bucket size up to ``max_batch``
        (:func:`bucket_sizes`) for each ``(shape, dtype)``; returns this
        pass's stats delta."""
        before = dict(self._stats)
        seen = set()
        for shape, dtype in boards:
            ny, nx = (int(x) for x in shape)
            for b in bucket_sizes(max_batch):
                sig = (b, ny, nx, str(np.dtype(dtype)))
                if sig in seen:
                    continue
                seen.add(sig)
                self.ensure((b, ny, nx), dtype)
        out = {k: (round(self._stats[k] - before[k], 6)
                   if isinstance(before[k], float)
                   else self._stats[k] - before[k])
               for k in before}
        out["programs"] = len(seen)
        return out

    def call_verified(self, digest: str, stack: np.ndarray, steps: int
                      ) -> np.ndarray:
        """Run one resident record's path on ``stack`` (a host array) and
        return the boards; its first result in this process must equal the
        NumPy oracle bit for bit. A miss quarantines the artifact, evicts
        the record and raises :class:`ParityError`."""
        from mpi_and_open_mp_tpu_torch.ops import native_life
        from mpi_and_open_mp_tpu_torch.ops.life_ops import life_step_numpy

        record = self._programs[digest]
        boards = torch.as_tensor(np.asarray(stack), device=self.device)
        out = native_life.run_path_batch(
            record["path"], boards, int(steps)).cpu().numpy()
        if digest not in self._verified:
            ref = np.array(stack, copy=True)
            for b in range(ref.shape[0]):
                board = ref[b]
                for _ in range(int(steps)):
                    board = life_step_numpy(board)
                ref[b] = board
            if not np.array_equal(out, ref):
                self._stats["parity_failed"] += 1
                self._programs.pop(digest, None)
                path = self.artifact_path(digest)
                quarantined = (checkpoint_mod.quarantine(path)
                               if os.path.exists(path) else None)
                self._note("parity_failed", digest=digest,
                           quarantined=quarantined or "")
                raise ParityError(
                    f"launch record {digest} diverged from the NumPy oracle "
                    "on first use: artifact quarantined")
            self._verified.add(digest)
        return out
