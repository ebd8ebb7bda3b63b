"""Durable tuned-plan store: one fingerprint for the plan and its launch
record.

Counterpart of ``mpi_and_open_mp_tpu/tune/plans.py``, its envelope byte
for byte: a record dict framed by either package gives the same bytes, and
each package's :func:`load_plan` reads the other's files. Three gates run
before a record may steer a dispatch:

1. **Envelope**: ``MOMP-PLAN/1`` magic, ``>QI`` length and CRC32, pickle.
   A flipped bit anywhere is ``corrupt``; the file is quarantined
   (``utils.checkpoint.quarantine``) and the ladder serves unchanged.
2. **Fingerprint**: the record's key is the dict ``serve.aotcache.
   fingerprint`` computes with the plan's path pinned in
   (:func:`fingerprint_for`). Any drift (torch or CUDA version, kernel
   sources, platform, card, topology) is ``stale``. A plan the JAX package
   wrote keys ``jax``/``jaxlib`` and is stale here. The shared digest puts
   ``<digest>.plan`` beside the ``<digest>.aot`` launch record.
3. **Parity**: the plan's path must reproduce the NumPy oracle on a seeded
   stack first. A Life plan with a co-located launch record runs that
   record (after :func:`serve.aotcache.load_artifact` derived it again),
   else the live engine; a miss quarantines the plan as ``parity``.

``MOMP_TUNE=0`` short-circuits :meth:`PlanStore.install`, and the
dispatch ignores plans already installed (``ops.native_life``).
"""

from __future__ import annotations

import glob
import os
import pickle
import struct
import zlib

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch.serve import aotcache
from mpi_and_open_mp_tpu_torch.utils import checkpoint as checkpoint_mod
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

PLAN_MAGIC = b"MOMP-PLAN/1\n"
PLAN_SCHEMA = "momp-plan/1"
_HEADER = struct.Struct(">QI")  # payload length, CRC32

#: Oracle steps of the install-time parity gate.
PARITY_STEPS = 8
_PARITY_SEED = 46


class PlanError(ValueError):
    """A plan record that must not steer a dispatch. ``kind`` is
    ``"corrupt"`` (bad magic, length or CRC, an undecodable payload, a
    malformed record) or ``"stale"`` (an intact envelope of another
    schema)."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


def fingerprint_for(workload: str, shape, dtype, path: str,
                    device: str | torch.device = "cuda") -> dict:
    """The ``serve.aotcache`` fingerprint with the plan's path pinned in:
    the dict a process computes once the plan is installed, so plan and
    launch record share one digest. A non-Life plan pins the Life entry
    out. A board shape (a sharded plan) keys as a stack of one under
    ``program="sharded"``: a sharded path is no batched path, so the
    pinned key alone would equal a batched plan's for one board of that
    shape, and the two records would share one file."""
    from mpi_and_open_mp_tpu_torch.ops import native_life

    shape = tuple(int(x) for x in shape)
    program = "bucket"
    if len(shape) == 2:
        shape, program = (1, *shape), "sharded"
    pin = str(path) if workload == "life" else None
    with native_life._planned_pinned("life", shape, pin):
        return aotcache.fingerprint(shape, dtype, program=program,
                                    workload=str(workload), device=device)


def save_plan(path: str, record: dict) -> None:
    """Write one plan record crash-atomically (the CRC frame, tmp + fsync
    + replace + directory fsync)."""
    payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
    framed = (PLAN_MAGIC
              + _HEADER.pack(len(payload), zlib.crc32(payload))
              + payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fd:
        fd.write(framed)
        fd.flush()
        os.fsync(fd.fileno())
    os.replace(tmp, path)
    checkpoint_mod._fsync_dir(path)


def load_plan(path: str) -> dict:
    """Read one record back, validated before it can steer anything: magic,
    header, length, CRC, payload decode (``corrupt``), then the schema
    (``stale``) and the key and choice fields (``corrupt``). Returns the
    record; raises :class:`PlanError`."""
    try:
        with open(path, "rb") as fd:
            framed = fd.read()
    except OSError as e:
        raise PlanError(
            "corrupt", f"unreadable plan record at {path} "
            f"({type(e).__name__}: {e})") from e
    head = len(PLAN_MAGIC) + _HEADER.size
    if not framed.startswith(PLAN_MAGIC):
        raise PlanError(
            "corrupt", f"plan record at {path} has a bad magic header: "
            "not a MOMP-PLAN/1 file (or corrupted at offset 0)")
    if len(framed) < head:
        raise PlanError(
            "corrupt", f"plan record at {path} is truncated inside its "
            f"header ({len(framed)} of {head} header bytes)")
    length, want_crc = _HEADER.unpack(framed[len(PLAN_MAGIC):head])
    payload = framed[head:]
    if len(payload) != length:
        raise PlanError(
            "corrupt", f"plan record at {path} is truncated: payload is "
            f"{len(payload)} bytes, header promises {length}")
    if zlib.crc32(payload) != want_crc:
        raise PlanError(
            "corrupt", f"plan record at {path} failed its CRC "
            f"(stored {want_crc:#010x}, recomputed "
            f"{zlib.crc32(payload):#010x}): the file is corrupt")
    try:
        record = pickle.loads(payload)
    except Exception as e:  # noqa: BLE001 - any decode failure
        raise PlanError(
            "corrupt", f"plan record at {path} passed its CRC but failed "
            f"to decode ({type(e).__name__}: {e})"[:400]) from e
    if not isinstance(record, dict) or record.get("schema") != PLAN_SCHEMA:
        raise PlanError(
            "stale", f"plan record at {path} carries schema "
            f"{record.get('schema') if isinstance(record, dict) else '?'!r},"
            f" want {PLAN_SCHEMA!r}")
    if not isinstance(record.get("key"), dict) \
            or not isinstance(record.get("choice"), dict):
        raise PlanError(
            "corrupt", f"plan record at {path} decodes but is missing its "
            "key/choice fields")
    return record


class PlanStore:
    """One directory of ``<digest>.plan`` records, with the launch records
    (``<digest>.aot``) beside them, for ``device``.

    :meth:`install` scans, validates, parity-gates and hands each surviving
    choice to ``ops.native_life.install_planned_path``, which
    ``native_path_batch`` consults before the ladder. Every rejection is
    quarantined on disk, counted (``tune.plan{status=...}``) and traced;
    the fallback is always the ladder, unchanged."""

    def __init__(self, root: str | os.PathLike,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.root = os.path.abspath(os.fspath(root))
        os.makedirs(self.root, exist_ok=True)
        self._installed: dict[tuple, dict] = {}

    def plan_path(self, digest: str) -> str:
        return os.path.join(self.root, digest + ".plan")

    def save(self, record: dict) -> str:
        """Persist one tuned record under its key's digest; returns the
        file."""
        path = self.plan_path(aotcache.digest_for(record["key"]))
        save_plan(path, record)
        return path

    def lookup(self, workload: str, shape) -> dict | None:
        """The installed record for (workload, stack shape), or None."""
        from mpi_and_open_mp_tpu_torch.ops import native_life

        return self._installed.get(native_life._plan_key(workload, shape))

    def lookup_sharded(self, workload: str, shape) -> dict | None:
        """The installed sharded record for (workload, board shape), or
        None."""
        return self._installed.get(
            ("sharded", str(workload), tuple(int(x) for x in shape)))

    def _note(self, status: str, **fields) -> None:
        from mpi_and_open_mp_tpu_torch.obs import metrics, trace

        metrics.inc("tune.plan", status=status)
        trace.event("tune.plan", status=status, **fields)

    def install(self, parity_gate: bool = True) -> dict:
        """Scan the store, validate and parity-gate every record, install
        the survivors; returns the summary the CLI's status line carries."""
        from mpi_and_open_mp_tpu_torch.ops import native_life

        summary = {"scanned": 0, "installed": 0, "corrupt": 0,
                   "stale": 0, "parity_rejected": 0, "disabled": False,
                   "plans": []}
        if not native_life._tune_enabled():
            summary["disabled"] = True
            return summary
        for path in sorted(glob.glob(os.path.join(self.root, "*.plan"))):
            summary["scanned"] += 1
            try:
                record = load_plan(path)
                choice = record["choice"]
                workload = str(choice["workload"])
                shape = tuple(int(x) for x in choice["shape"])
                dtype, engine = choice["dtype"], str(choice["path"])
            except PlanError as e:
                summary[e.kind] += 1
                q = checkpoint_mod.quarantine(path, label=e.kind)
                self._note(e.kind, path=path, quarantined=q or "",
                           error=str(e)[:200])
                continue
            except Exception as e:  # noqa: BLE001 - malformed choice
                summary["corrupt"] += 1
                q = checkpoint_mod.quarantine(path, label="corrupt")
                self._note("corrupt", path=path, quarantined=q or "",
                           error=f"{type(e).__name__}: {e}"[:200])
                continue
            want = fingerprint_for(workload, shape, dtype, engine,
                                   device=self.device)
            if record["key"] != want:
                drift = sorted(k for k in set(record["key"]) | set(want)
                               if record["key"].get(k) != want.get(k))
                summary["stale"] += 1
                q = checkpoint_mod.quarantine(path, label="stale")
                self._note("stale", path=path, quarantined=q or "",
                           error=f"fingerprint drift: {drift}"[:200])
                continue
            if engine.startswith(("sharded:", "sparse_sharded:")):
                if parity_gate and not self._sharded_parity_ok(record, path):
                    summary["parity_rejected"] += 1
                    continue
                self._installed[("sharded", workload, shape)] = record
            else:
                if parity_gate and not self._parity_ok(record, path):
                    summary["parity_rejected"] += 1
                    continue
                native_life.install_planned_path(workload, shape, engine)
                self._installed[native_life._plan_key(workload, shape)] = (
                    record)
            summary["installed"] += 1
            summary["plans"].append({
                "workload": workload, "shape": list(shape), "path": engine,
                "vs_heuristic": record.get("vs_heuristic")})
            self._note("installed", path=path, workload=workload,
                       engine=engine)
        return summary

    def _reject(self, plan_file: str, ok: bool) -> bool:
        if not ok:
            q = checkpoint_mod.quarantine(plan_file, label="parity")
            self._note("parity_rejected", path=plan_file,
                       quarantined=q or "")
        return ok

    def _sharded_parity_ok(self, record: dict, plan_file: str) -> bool:
        """Parity gate of a sharded record: its mesh rebuilt on this
        store's device (virtual shards), its runner against the oracle."""
        from mpi_and_open_mp_tpu_torch import stencils
        from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib

        choice = record["choice"]
        try:
            workload = str(choice["workload"])
            ny, nx = (int(x) for x in choice["shape"])
            py, px = (int(x) for x in choice["mesh_axes"])
            spec = stencils.get(workload)
            mesh = mesh_lib.make_mesh_2d(py, px, device=self.device,
                                         virtual=True)
            board = spec.init(np.random.default_rng(_PARITY_SEED), (ny, nx))
            fuse = int(choice.get("fuse_steps", 1))
            if str(choice["path"]).startswith("sparse_sharded:"):
                eng = stencils.SparseShardedEngine(
                    spec, board, mesh=mesh,
                    layout=str(choice["axis_order"]),
                    tile=int(choice["tile"]), fuse=fuse)
                eng.step(PARITY_STEPS)
                out = eng.snapshot()
            else:
                out = stencils.run_sharded(
                    spec, board, PARITY_STEPS, mesh=mesh,
                    layout=str(choice["axis_order"]), fuse_steps=fuse,
                    boundary_steps=int(choice.get("boundary_steps", fuse)),
                    overlap=(None if choice.get("halo_overlap") == "overlap"
                             else False)).cpu().numpy()
            ok = stencils.parity_ok(
                spec, out, stencils.oracle_run(spec, board, PARITY_STEPS))
        except Exception as e:  # noqa: BLE001 - a rejection, never a crash
            ok = False
            self._note("parity_error", path=plan_file,
                       error=f"{type(e).__name__}: {e}"[:200])
        return self._reject(plan_file, ok)

    def _parity_ok(self, record: dict, plan_file: str) -> bool:
        """The plan's path against the NumPy oracle before it may steer
        anything. A Life plan with a co-located launch record runs that
        record; an unreadable or stale record quarantines itself (the next
        ``AOTCache.ensure`` derives it afresh) and the gate runs the live
        engine."""
        from mpi_and_open_mp_tpu_torch import stencils
        from mpi_and_open_mp_tpu_torch.ops import native_life
        from mpi_and_open_mp_tpu_torch.tune import space

        choice = record["choice"]
        workload = str(choice["workload"])
        shape = tuple(int(x) for x in choice["shape"])
        b, ny, nx = shape
        path = str(choice["path"])
        try:
            spec = stencils.get(workload)
            rng = np.random.default_rng(_PARITY_SEED)
            stack = np.stack([spec.init(rng, (ny, nx)) for _ in range(b)]
                             ).astype(np.dtype(choice["dtype"]))
            aot = os.path.join(
                self.root, aotcache.digest_for(record["key"]) + ".aot")
            launch = None
            if workload == "life" and os.path.exists(aot):
                try:
                    launch = aotcache.load_artifact(aot, record["key"])
                except aotcache.ArtifactError as e:
                    checkpoint_mod.quarantine(aot, label=e.kind)
                    self._note("aot_" + e.kind, path=aot, error=str(e)[:200])
            run_path = launch["path"] if launch is not None else path
            with native_life._planned_pinned(workload, shape, path):
                got = space.runner_for(workload, run_path)(
                    torch.as_tensor(stack, device=self.device),
                    PARITY_STEPS).cpu().numpy()
            tol = stencils.parity_tol_for(stencils.family_for_path(path))
            ok = got.shape == stack.shape and all(
                stencils.parity_ok(
                    spec, got[i],
                    stencils.oracle_run(spec, stack[i], PARITY_STEPS), **tol)
                for i in range(b))
        except Exception as e:  # noqa: BLE001 - a broken engine is a
            # rejection, never a crash: the ladder keeps serving.
            ok = False
            self._note("parity_error", path=plan_file,
                       error=f"{type(e).__name__}: {e}"[:200])
        return self._reject(plan_file, ok)
