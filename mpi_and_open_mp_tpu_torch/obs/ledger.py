"""Cross-run performance ledger: append-only JSONL, one entry per bench line.

Counterpart of ``mpi_and_open_mp_tpu/obs/ledger.py``, standard library
only, byte-compatible with it: the same ``stamp`` gives the same entry,
``append`` writes the same bytes, ``load`` refuses the same malformed
lines with the same messages, so either package reads the other's ledger
and ``analysis/regression_sentinel.py`` judges a ledger the port wrote as
it judges the JAX package's. Every bench line lands here stamped with
what the sentinel needs to notice a number that got worse or an engine
that silently fell back: git SHA, platform, device kind, topology and the
configuration key. A port line is stamped ``platform="gpu"``,
``device_kind=torch.cuda.get_device_name()`` and ``device_count`` the
cards the run used; the sentinel ranks ``gpu`` above ``cpu``, so a run
that fell to the CPU is a downgrade.

Entry schema, one JSON object per line (append-only; multiple processes
may share one file, same discipline as the ``MOMP_TRACE`` sink)::

    {"schema": "momp-ledger/1", "ts": <epoch sec>, "git_sha": ...,
     "source": "bench.py" | "backfill:<file>#L<n>" | ...,
     "platform": "gpu"|"tpu"|"cpu", "device_kind": ..., "topology": "gpu:1",
     "key": {"metric", "topology", "shape", "dtype", "steps", "batch",
             "engine", ...},
     "record": {...the full bench JSON line...}}

The query key is (topology, shape, dtype, batch, engine, ...) plus the
metric name; :func:`config_key` renders any subset of it as a stable
string so baselines group per configuration. Keyed lookups support
subsets: the sentinel matches on the workload fields only
(metric/shape/dtype/steps/batch) so a run that fell back to the CPU still
lands in the same comparison group as its baseline on the card.

Nothing here imports torch: the sentinel and a queue's gate may run on a
host that must not touch the card.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

ENV = "MOMP_LEDGER"

#: Canonical key-field order; ``config_key`` renders them in this order.
#: Each field past the first six separates runs that must never share a
#: baseline group: ``batch_pack_layout`` a board-sliced from a cell-packed
#: stack (the sentinel treats bitsliced -> cell-packed as a provenance
#: downgrade); ``resident`` a resident session-pool run from one that
#: ships boards every call; ``workload`` a heat run from a life run of
#: the same shape (entries stamped before the field existed default to
#: "life", which is what they ran); ``plan`` a line under a tuned plan
#: ({store, fresh}) from a heuristic-routed one (tuned -> heuristic is a
#: downgrade); ``halo`` the sharded halo schedule stamp ({overlap:*,
#: seq:*}; overlap -> seq, the kill switch left on, is a downgrade);
#: ``sparse`` the active-tile engine stamp ({sparse-sharded:*, sparse:*,
#: dense:*}; sparse-sharded -> dense:sharded is a downgrade);
#: ``engine_family`` the stencil aggregation family ({offset, sep, fft};
#: fft/sep -> offset on the same workload is a downgrade).
KEY_FIELDS = ("metric", "topology", "shape", "dtype", "steps", "batch",
              "batch_pack_layout", "resident", "workload", "plan",
              "halo", "sparse", "engine_family", "engine")

_GIT_SHA: str | None = None


def ledger_path(default: str | None = None) -> str | None:
    """The ledger path from ``MOMP_LEDGER``, else ``default``."""
    return os.environ.get(ENV) or default


def git_sha(cwd: str | None = None) -> str:
    """The repo HEAD SHA (short), cached; ``"unknown"`` outside a repo."""
    global _GIT_SHA
    if _GIT_SHA is None:
        if cwd is None:
            cwd = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        try:
            _GIT_SHA = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"], cwd=cwd,
                capture_output=True, text=True, timeout=10,
            ).stdout.strip() or "unknown"
        except (OSError, subprocess.SubprocessError):
            _GIT_SHA = "unknown"
    return _GIT_SHA


def _shape_str(record: dict) -> str:
    board = record.get("board")
    if (isinstance(board, (list, tuple)) and len(board) == 2
            and all(isinstance(b, int) for b in board)):
        return f"{board[0]}x{board[1]}"
    return "?"


def stamp(record: dict, *, source: str = "bench.py",
          platform: str | None = None, device_kind: str | None = None,
          device_count: int | None = None, ts: float | None = None,
          sha: str | None = None) -> dict:
    """Wrap one bench JSON line as a ledger entry.

    ``platform``/``device_kind``/``device_count`` come from the caller
    (who has the device in hand); when omitted they fall back to what the
    record itself carries so backfilled lines stay honest about what was
    and was not recorded at the time.
    """
    platform = platform or record.get("platform") or record.get(
        "backend") or "?"
    topology = f"{platform}:{device_count if device_count else '?'}"
    key = {
        "metric": record.get("metric", "?"),
        "topology": topology,
        "shape": _shape_str(record),
        "dtype": record.get("dtype", "?"),
        "steps": record.get("steps", "?"),
        "batch": record.get("batch", 0),
        # "-" for non-batched lines (no stack, no pack layout); batched
        # lines carry the closed vocabulary {cell-packed, bitsliced}.
        "batch_pack_layout": record.get("batch_pack_layout", "-"),
        # "-" for lines without a sessions phase; "pool" when the record
        # carries device-resident session-pool measurements.
        "resident": record.get("resident", "-"),
        # Pre-stencil lines carry no workload field: life, exactly.
        "workload": record.get("workload", "life"),
        # "-" for lines that never consulted the autotuner; tuned lines
        # carry the closed vocabulary {heuristic, fresh, store}.
        "plan": record.get("plan_source", "-"),
        # "-" for lines without a sharded A/B; scheduled lines carry the
        # haloplan engine stamp ({overlap:*, seq:*}).
        "halo": record.get("sharded_halo", "-"),
        # "-" for lines without a sparse phase; the sparse-sharded A/B
        # stamp wins over the single-device one when both phases ran
        # (it is the composed engine this key exists to pin).
        "sparse": record.get("sparse_sharded_engine",
                             record.get("sparse_engine", "-")),
        # "-" for lines without a stencil engine-family phase; family
        # lines carry the closed vocabulary {offset, sep, fft}.
        "engine_family": record.get("engine_family", "-"),
        "engine": record.get("impl", "?"),
    }
    return {
        "schema": "momp-ledger/1",
        "ts": time.time() if ts is None else ts,
        "git_sha": sha if sha is not None else git_sha(),
        "source": source,
        "platform": platform,
        "device_kind": device_kind or record.get("device_kind")
        or "unrecorded",
        "topology": topology,
        "key": key,
        "record": record,
    }


def append(entry: dict, path: str) -> None:
    """Append one entry as one JSON line (parent dirs created)."""
    outdir = os.path.dirname(path)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
    with open(path, "a") as fd:
        fd.write(json.dumps(entry) + "\n")


def load(path: str) -> list[dict]:
    """Parse one entry per non-blank line; raise ``ValueError`` naming the
    first malformed line (same discipline as ``obs.report.load`` — a
    truncated tail from a killed process is a signal, not noise)."""
    entries = []
    with open(path) as fd:
        for lineno, line in enumerate(fd, 1):
            line = line.strip()
            if not line:
                continue
            try:
                entry = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: not a JSON record ({e.msg})") from e
            if not isinstance(entry, dict) or "record" not in entry:
                raise ValueError(
                    f"{path}:{lineno}: entry without a 'record' field")
            entries.append(entry)
    return entries


#: Key fields whose absence means "not applicable" rather than
#: "unrecorded": entries stamped before the field joined KEY_FIELDS must
#: keep matching new lines that carry the explicit "-" placeholder.
_KEY_DEFAULTS = {"batch_pack_layout": "-", "resident": "-",
                 "workload": "life", "plan": "-", "halo": "-",
                 "sparse": "-", "engine_family": "-"}


def config_key(entry: dict, fields: tuple[str, ...] = KEY_FIELDS) -> str:
    """Render an entry's key (or any subset of it) as a stable string,
    e.g. ``metric=life_steady_cups_p46gun_big|shape=500x500|batch=0``."""
    key = entry.get("key") or {}
    return "|".join(
        f"{f}={key.get(f, _KEY_DEFAULTS.get(f, '?'))}" for f in fields)


def query(entries: list[dict], **where) -> list[dict]:
    """Entries whose key matches every ``field=value`` given (values
    compared as strings, chronological order preserved)."""
    out = []
    for e in entries:
        key = e.get("key") or {}
        if all(str(key.get(f, "?")) == str(v) for f, v in where.items()):
            out.append(e)
    return out
