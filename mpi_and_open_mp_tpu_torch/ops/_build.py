"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface (one entry point per
kernel, :data:`SIGNATURES`) and is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/lib<name>.so`` at the root of the
checkout, at first use, then loaded with ``ctypes``. A library older
than any source is rebuilt. :func:`build` compiles several sources at once,
one ``nvcc`` process each. Nothing here runs at import time, so the package
imports on machines without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Argument types of each library's C entry points (pointers and the stream
# as c_void_p: a default ctypes int would cut a pointer to 32 bits; _L is
# a 64-bit extent or stride; _F a float32; _IP is an int out-parameter): a list for the one entry point named like the
# library, or a dict of entry point -> list where one source holds several
# entry points.
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "bitlife_vmem": {
        "bitlife_vmem": [_P, _P] + [_I] * 9 + [_P],
        "bitlife_vmem_attributes": [_I] * 8 + [_IP],
    },
    "bitlife_fused": {
        "bitlife_fused": [_P, _P] + [_I] * 13 + [_P],
        "bitlife_fused_attributes": [_I] * 13 + [_IP],
    },
    "bitlife_window": {
        "bitlife_window": [_P, _P] + [_I] * 11 + [_P],
        "bitlife_window_attributes": [_I] * 11 + [_IP],
    },
    "bitlife_vmem_batch": {
        "bitlife_vmem_batch": [_P, _P] + [_I] * 10 + [_P],
        "bitlife_vmem_batch_attributes": [_I] * 9 + [_IP],
    },
    "bitlife_bitsliced": {
        "bitlife_bitsliced": [_P, _P, _P] + [_I] * 12 + [_P, _IP],
        "bitlife_bitsliced_pool": [_P] * 5 + [_I] * 12 + [_P, _IP],
        "bitlife_bitsliced_attributes": [_I] * 11 + [_IP],
    },
    "stencil_padded": {
        "stencil_padded": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "stencil_padded_attributes": [_I, _I, _IP],
    },
    "flash_fwd": {
        "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "flash_fwd_attributes": [_I, _I, _IP],
    },
    "flash_hop_bwd": {
        "flash_hop_dq": [_P] * 7 + [_I] * 6 + [_P],
        "flash_hop_dkv": [_P] * 8 + [_I] * 6 + [_P],
        "flash_hop_attributes": [_I, _I, _I, _IP],
    },
    "pool_lanes": {
        "pool_lane_write": [_P, _P] + [_I] * 5 + [_P],
        "pool_lane_read": [_P, _P] + [_I] * 5 + [_P],
    },
    "halo_edge_pair": [_P] * 5 + [_I, _L, _I, _I] + [_L] * 6 + [_I, _P],
    "halo_frame": [_P] * 3 + [_I] * 5 + [_L] * 3 + [_I, _P],
    "quadrature": [_P, _P, _P, _L, _L, _I, _I, _L, _I, _I, _F, _F, _F, _P,
                   _IP],
}

_LOADED: dict[str, ctypes.CDLL] = {}
# Wall seconds of each source's last build, from the start of its build().
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels")
    return found


def lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not out.exists():
        return True
    built = out.stat().st_mtime
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return any(s.stat().st_mtime > built for s in sources)


def build(names=tuple(SIGNATURES), force: bool = False) -> dict[str, str]:
    """Compile the named kernels that are missing or stale, all ``nvcc``
    processes at once; returns each one's compiler log (``-Xptxas -v``:
    registers, shared memory, spills) and records each one's wall seconds
    in :data:`BUILD_SECONDS`. Raises on the first failure."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        log = BUILD_DIR / f"lib{name}.log.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as out:
            procs[name] = (tmp, log, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT))
    pending = dict(procs)
    while pending:
        for name in [n for n, (*_, p) in pending.items()
                     if p.poll() is not None]:
            BUILD_SECONDS[name] = time.perf_counter() - t0
            del pending[name]
        time.sleep(0.05)
    logs = {}
    failed = []
    for name, (tmp, log, proc) in procs.items():
        logs[name] = log.read_text()
        log.unlink()
        if proc.returncode:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        entries = SIGNATURES[name]
        if not isinstance(entries, dict):
            entries = {name: entries}
        for entry, argtypes in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc:
        msg = getattr(lib, f"{name}_error")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
