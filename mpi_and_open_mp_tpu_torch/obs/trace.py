"""Span tracer: nested wall-clock spans and instant events to a JSONL sink.

Counterpart of ``mpi_and_open_mp_tpu/obs/trace.py``, writing its records
field for field, so the JAX package's ``obs/report.py`` and
``analysis/trace_report.py`` read a port trace unchanged. The
``MOMP_TRACE`` environment variable names the sink; when it is unset,
:func:`span` returns the shared no-op :data:`NULL` and :func:`event`
returns at once: one env lookup, no allocation, no file, no sync. The sink
is cached per env value and opened in append mode, so several processes
or invocations may share one trace file.

Record schema, one JSON object per line::

    {"kind": "span",  "name": ..., "ts": <epoch sec>, "dur": <sec>,
     "id": N, "parent": M|null, "pid": ..., "host": ..., "attrs": {...}}
    {"kind": "event", "name": ..., "ts": <epoch sec>,
     "id": N, "parent": M|null, "pid": ..., "host": ..., "attrs": {...}}

Spans are written at exit (children before parents; ``parent`` rebuilds
the nesting). The duration clock is ``utils.timing.Timer``.

Device work: a CUDA launch returns before the card is done, so a span
that brackets a launch times the enqueue. ``span.anchor(x)`` makes the
span close through ``utils.timing.sync`` on the first tensor of ``x`` (the
JAX package's ``anchor_sync``), so ``dur`` covers the device work queued
before it. An anchor adds one sync, and only while tracing is on.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import threading
import time

import torch

from mpi_and_open_mp_tpu_torch.utils.timing import Timer, sync

_ENV = "MOMP_TRACE"
_ENV_HOPS = "MOMP_TRACE_HOPS"

_CACHE: tuple[str | None, object | None] = (None, None)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_HOST: str | None = None
_WRITE_LOCK = threading.Lock()


def enabled() -> bool:
    """Whether tracing is on (``MOMP_TRACE`` names a sink path)."""
    return bool(os.environ.get(_ENV, ""))


def hop_spans_active() -> bool:
    """Whether the ring's per-hop spans engage: tracing on and not opted
    out by ``MOMP_TRACE_HOPS=0`` (which keeps the whole-call span only)."""
    return enabled() and os.environ.get(_ENV_HOPS, "1") != "0"


def _sink():
    """The open line-buffered sink for the current ``MOMP_TRACE`` value,
    or ``None``. Cached per value; a changed path closes the old file."""
    global _CACHE
    raw = os.environ.get(_ENV, "")
    if not raw:
        return None
    if _CACHE[0] != raw:
        if _CACHE[1] is not None:
            try:
                _CACHE[1].close()
            except OSError:
                pass
        outdir = os.path.dirname(raw)
        if outdir:
            os.makedirs(outdir, exist_ok=True)
        _CACHE = (raw, open(raw, "a", buffering=1))
    return _CACHE[1]


def reset() -> None:
    """Close and drop the cached sink (tests switch paths mid-process)."""
    global _CACHE
    if _CACHE[1] is not None:
        try:
            _CACHE[1].close()
        except OSError:
            pass
    _CACHE = (None, None)


def _host() -> str:
    global _HOST
    if _HOST is None:
        _HOST = socket.gethostname()
    return _HOST


def _stack() -> list:
    s = getattr(_LOCAL, "stack", None)
    if s is None:
        s = _LOCAL.stack = []
    return s


def _write(rec: dict) -> None:
    fd = _sink()
    if fd is None:  # the env was cleared mid-span: drop silently
        return
    line = json.dumps(rec, default=str)
    with _WRITE_LOCK:
        fd.write(line + "\n")


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (tuple, list)):
        for x in tree:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


class _NullSpan:
    """The off-path span: every method a no-op, one shared instance."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def anchor(self, tree) -> "_NullSpan":
        return self

    @property
    def elapsed(self) -> float:
        return float("nan")


NULL = _NullSpan()


class Span:
    """One live span. Use as ``with trace.span(name, **attrs) as sp``."""

    __slots__ = ("name", "attrs", "id", "parent", "_timer", "_ts", "_tree")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._tree = None

    def __enter__(self) -> "Span":
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_IDS)
        stack.append(self)
        self._ts = time.time()
        self._timer = Timer().__enter__()
        return self

    def set(self, **attrs) -> "Span":
        """Attach or override attributes mid-span."""
        self.attrs.update(attrs)
        return self

    def anchor(self, tree) -> "Span":
        """Close through a sync of the device of the first tensor in
        ``tree`` (a tensor, or tuples and lists of them): the duration
        then covers the device work queued before the close."""
        self._tree = tree
        return self

    @property
    def elapsed(self) -> float:
        """Running wall seconds (live inside the ``with`` block)."""
        return self._timer.elapsed

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._tree is not None and exc_type is None:
            t = _first_tensor(self._tree)
            if t is not None:
                sync(t)
            self._tree = None
        self._timer.__exit__()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        rec = {
            "kind": "span", "name": self.name, "ts": self._ts,
            "dur": self._timer.elapsed, "id": self.id, "parent": self.parent,
            "pid": os.getpid(), "host": _host(),
        }
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = self.attrs
        _write(rec)
        return False


def span(name: str, **attrs):
    """A new span, or the shared no-op when tracing is off."""
    if not os.environ.get(_ENV, ""):
        return NULL
    return Span(name, attrs)


def event(name: str, **attrs) -> None:
    """An instant (zero-duration) record, parented to the innermost open
    span of this thread."""
    if not os.environ.get(_ENV, ""):
        return
    stack = _stack()
    rec = {
        "kind": "event", "name": name, "ts": time.time(), "id": next(_IDS),
        "parent": stack[-1].id if stack else None,
        "pid": os.getpid(), "host": _host(),
    }
    if attrs:
        rec["attrs"] = attrs
    _write(rec)
