"""Trace-file analysis: phase breakdown, hop fit, recovery and retrace
summary.

Counterpart of ``mpi_and_open_mp_tpu/obs/report.py``. Reads the JSONL a
``MOMP_TRACE`` sink wrote (``obs.trace``'s schema, the JAX package's) and
reduces it to three questions:

* **Where did the wall clock go?** - per-span-name totals against the wall
  covered by root spans (``phases``).
* **What did the ring do?** - traced attention steps, per-hop span counts
  (``2 * (p - 1)`` a step), engines seen, and an alpha + beta n fit over
  the ``ring.hop.transfer`` (bytes, us) rows whenever the trace carries at
  least two distinct transfer sizes: the model of
  ``parallel.fabric.fit_alpha_beta``, which the ping-pong probe fits.
* **What went wrong and what was rebuilt?** - recovery events by stamp,
  and the ``jit.retrace{fn=...}`` counters of the last ``metrics``
  snapshot event in the stream.

``to_chrome`` exports the spans as Chrome trace-event JSON, which Perfetto
opens. The JAX package's ``analysis/trace_report.py`` reads the same files.
"""

from __future__ import annotations

import json


def load(path: str) -> list[dict]:
    """Parse one record per non-blank line; raise ``ValueError`` naming
    the first malformed line (a truncated tail from a killed process is
    a real signal, not something to paper over). A well-formed JSON
    object WITHOUT a ``kind`` field is a header line (external tooling
    prepends them), not corruption: it is skipped, so an empty or
    header-only file reports zero records instead of erroring."""
    records = []
    with open(path) as fd:
        for lineno, line in enumerate(fd, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{lineno}: not a JSON record ({e.msg})") from e
            if not isinstance(rec, dict):
                raise ValueError(
                    f"{path}:{lineno}: not a JSON object record")
            if "kind" not in rec:
                continue  # header line
            records.append(rec)
    return records


def _spans(records: list[dict], name: str | None = None) -> list[dict]:
    return [r for r in records if r.get("kind") == "span"
            and (name is None or r.get("name") == name)]


def _phase_breakdown(records: list[dict]) -> dict:
    spans = _spans(records)
    # Wall = time under root spans only; nested spans re-count their
    # parents' time, so summing every span would exceed 100%.
    wall = sum(s.get("dur", 0.0) for s in spans if s.get("parent") is None)
    phases: dict[str, dict] = {}
    for s in spans:
        ph = phases.setdefault(
            s.get("name", "?"), {"count": 0, "total_s": 0.0, "errors": 0})
        ph["count"] += 1
        ph["total_s"] += s.get("dur", 0.0)
        if "error" in s:
            ph["errors"] += 1
    for ph in phases.values():
        ph["total_s"] = round(ph["total_s"], 6)
        ph["mean_s"] = round(ph["total_s"] / ph["count"], 6)
        ph["share"] = round(ph["total_s"] / wall, 4) if wall > 0 else None
    return {"wall_s": round(wall, 6), "by_name": phases}


def _hop_fit(transfers: list[dict]) -> dict | None:
    """α+βn over (bytes, mean µs) of the transfer spans — needs two
    distinct sizes or the slope is unconstrained."""
    by_size: dict[int, list[float]] = {}
    for s in transfers:
        b = (s.get("attrs") or {}).get("bytes")
        if isinstance(b, (int, float)) and b > 0:
            by_size.setdefault(int(b), []).append(s.get("dur", 0.0) * 1e6)
    if len(by_size) < 2:
        return None
    from mpi_and_open_mp_tpu_torch.parallel import fabric

    rows = [(b, sum(us) / len(us)) for b, us in sorted(by_size.items())]
    return fabric.fit_alpha_beta(rows).as_json()


def _attention(records: list[dict]) -> dict:
    steps = [s for s in _spans(records, "ring_attention")
             if (s.get("attrs") or {}).get("traced_dispatch")]
    whole = [s for s in _spans(records, "ring_attention")
             if not (s.get("attrs") or {}).get("traced_dispatch")]
    transfers = _spans(records, "ring.hop.transfer")
    folds = _spans(records, "ring.hop.fold")
    engines = sorted({(s.get("attrs") or {}).get("engine", "?")
                      for s in folds + steps + whole})
    hop_spans = len(transfers) + len(folds)
    return {
        "traced_steps": len(steps),
        "whole_call_spans": len(whole),
        "hop_spans": hop_spans,
        "transfer_spans": len(transfers),
        "fold_spans": len(folds),
        "hop_spans_per_step": (round(hop_spans / len(steps), 3)
                               if steps else None),
        "engines": engines,
        "hop_fit": _hop_fit(transfers),
    }


def _halo(records: list[dict]) -> dict:
    """The sharded halo-schedule summary: ``halo.overlap``/``halo.seq``
    span counts with the engine stamps seen on each, plus the exposed-
    vs-hidden transfer accounting from the LAST ``halo.ab`` event (a
    schedule A/B emits one: measured transfer seconds per round, the
    exposed remainder the overlap failed to hide, and their ratio as
    overlap efficiency)."""
    overlap = _spans(records, "halo.overlap")
    seq = _spans(records, "halo.seq")
    engines = sorted({(s.get("attrs") or {}).get("engine", "?")
                      for s in overlap + seq})
    ab = None
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "halo.ab":
            ab = dict(r.get("attrs") or {})
    return {
        "overlap_spans": len(overlap),
        "seq_spans": len(seq),
        "engines": engines,
        "ab": ab,
    }


def _recoveries(records: list[dict]) -> dict:
    by_stamp: dict[str, int] = {}
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "recovery":
            stamp = (r.get("attrs") or {}).get("stamp", "?")
            by_stamp[stamp] = by_stamp.get(stamp, 0) + 1
    return {"total": sum(by_stamp.values()), "by_stamp": by_stamp}


def _retraces(records: list[dict]) -> dict:
    """``jit.retrace{fn=...}`` counters from the LAST ``metrics``
    snapshot event — the registry is cumulative, so the last snapshot
    supersedes every earlier one."""
    snap = None
    for r in records:
        if r.get("kind") == "event" and r.get("name") == "metrics":
            snap = (r.get("attrs") or {}).get("snapshot")
    if not isinstance(snap, dict):
        return {}
    out = {}
    for key, val in snap.get("counters", {}).items():
        if key.startswith("jit.retrace{"):
            fn = key[len("jit.retrace{"):-1].removeprefix("fn=")
            out[fn] = val
    return out


def report_dict(records: list[dict]) -> dict:
    """The full report as JSON-ready data (``trace_report.py --json``)."""
    return {
        "records": len(records),
        "phases": _phase_breakdown(records),
        "attention": _attention(records),
        "halo": _halo(records),
        "recoveries": _recoveries(records),
        "retraces": _retraces(records),
    }


def _track_of(rec: dict, by_id: dict) -> int:
    """The root ancestor's id — one Perfetto track per root span, so
    time-enclosure nesting on a track reproduces span parentage exactly
    (spans of one thread strictly nest; unrelated roots never share a
    track). An orphaned parent id (truncated trace) roots its subtree."""
    seen = set()
    cur = rec
    while True:
        parent = cur.get("parent")
        if parent is None or parent not in by_id or parent in seen:
            return cur.get("id", 0)
        seen.add(parent)
        cur = by_id[parent]


def to_chrome(records: list[dict]) -> dict:
    """Chrome trace-event JSON from obs records — opens in Perfetto /
    chrome://tracing, so ring-hop and batch-serve timelines are browsable
    instead of grep-able.

    Spans become complete ("X") events with microsecond ts/dur; events
    become thread-scoped instants ("i"). Span ids and parent ids ride in
    ``args`` so tooling can verify nesting against the source parentage
    (the CI chrome smoke does).
    """
    spans = _spans(records)
    by_id = {r["id"]: r for r in spans if "id" in r}
    events = []
    for r in spans:
        args = dict(r.get("attrs") or {})
        args["span_id"] = r.get("id")
        args["parent"] = r.get("parent")
        if "error" in r:
            args["error"] = r["error"]
        events.append({
            "ph": "X", "cat": "span", "name": r.get("name", "?"),
            "ts": r.get("ts", 0.0) * 1e6,
            "dur": max(r.get("dur", 0.0), 0.0) * 1e6,
            "pid": r.get("pid", 0), "tid": _track_of(r, by_id),
            "args": args,
        })
    for r in records:
        if r.get("kind") != "event":
            continue
        parent = by_id.get(r.get("parent"))
        events.append({
            "ph": "i", "s": "t", "cat": "event", "name": r.get("name", "?"),
            "ts": r.get("ts", 0.0) * 1e6,
            "pid": r.get("pid", 0),
            "tid": _track_of(parent, by_id) if parent else r.get("id", 0),
            "args": dict(r.get("attrs") or {}),
        })
    events.sort(key=lambda e: e["ts"])
    # Name each process track with its host (metadata rows sort first by
    # convention; Perfetto accepts them anywhere).
    meta = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
             "args": {"name": f"{host} (pid {pid})"}}
            for pid, host in sorted(
                {(r.get("pid", 0), r.get("host", "?")) for r in records})]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def render(rep: dict) -> str:
    """Text tables of :func:`report_dict` output for terminal reading."""
    lines = []
    ph = rep["phases"]
    lines.append(f"trace: {rep['records']} records, "
                 f"wall {ph['wall_s']:.3f}s under root spans")
    lines.append("")
    lines.append(f"{'span':<24}{'count':>7}{'total s':>12}"
                 f"{'mean s':>12}{'share':>8}")
    for name, row in sorted(ph["by_name"].items(),
                            key=lambda kv: -kv[1]["total_s"]):
        share = f"{row['share']:.1%}" if row["share"] is not None else "-"
        err = f"  ({row['errors']} errors)" if row["errors"] else ""
        lines.append(f"{name:<24}{row['count']:>7}{row['total_s']:>12.4f}"
                     f"{row['mean_s']:>12.6f}{share:>8}{err}")
    att = rep["attention"]
    if att["traced_steps"] or att["whole_call_spans"]:
        lines.append("")
        lines.append(
            f"attention: {att['traced_steps']} traced steps, "
            f"{att['hop_spans']} hop spans "
            f"({att['transfer_spans']} transfer + {att['fold_spans']} fold"
            + (f", {att['hop_spans_per_step']}/step"
               if att["hop_spans_per_step"] is not None else "")
            + f"), engines: {', '.join(att['engines'])}")
        if att["hop_fit"]:
            f = att["hop_fit"]
            bw = (f"{f['bandwidth_mb_s']}MB/s" if f["identifiable"]
                  else "unidentifiable(beta<=0)")
            lines.append(f"hop fit: alpha={f['alpha_us']}us bandwidth={bw} "
                         f"r2={f['r2']}")
    hal = rep.get("halo") or {}
    if hal.get("overlap_spans") or hal.get("seq_spans"):
        lines.append("")
        lines.append(
            f"halo: {hal['overlap_spans']} overlap + {hal['seq_spans']} "
            f"seq schedule spans, engines: {', '.join(hal['engines'])}")
        ab = hal.get("ab")
        if ab:
            lines.append(
                f"halo A/B: transfer={ab.get('transfer_s', 0):.6f}s/round "
                f"exposed={ab.get('exposed_s', 0):.6f}s "
                f"efficiency={ab.get('efficiency', 0):.1%}")
    rec = rep["recoveries"]
    if rec["total"]:
        lines.append("")
        lines.append(f"recoveries: {rec['total']}")
        for stamp, n in sorted(rec["by_stamp"].items()):
            lines.append(f"  {stamp}: {n}")
    if rep["retraces"]:
        lines.append("")
        lines.append("jit retraces (from last metrics snapshot):")
        for fn, n in sorted(rep["retraces"].items()):
            lines.append(f"  {fn}: {int(n)}")
    return "\n".join(lines)
