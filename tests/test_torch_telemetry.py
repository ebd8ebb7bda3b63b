"""The port's telemetry plane (``obs.telemetry``, the router's
``FleetRollup``), held against the JAX package's on the CPU.

Snapshots and sidecar frames byte-identical to JAX's for the same inputs;
JAX ``read_frames`` soft-landing on a port sidecar cut at every byte of its
last frame; ``LatencyHist`` quantiles and the rollup's summary equal to
JAX's for the same samples; JAX's ``analysis/fleet_report.py`` merging a
port fleet CLI's state directory. Then the JAX package's
``tests/test_telemetry.py`` cases on the port. One torch thread.
"""

import json
import math
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mpi_and_open_mp_tpu.obs import telemetry as jtelemetry
from mpi_and_open_mp_tpu.serve import router as jrouter

from mpi_and_open_mp_tpu_torch.obs import metrics, report, telemetry, trace
from mpi_and_open_mp_tpu_torch.serve.fleet import Fleet
from mpi_and_open_mp_tpu_torch.serve.policy import (
    ElasticityPolicy, ServePolicy, percentile)
from mpi_and_open_mp_tpu_torch.serve.router import FleetRollup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYSIS = os.path.join(REPO, "analysis")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_registry():
    metrics.reset()
    yield
    metrics.reset()


def _snap(worker, seq, **counters):
    return {"v": telemetry.SNAPSHOT_SCHEMA, "worker": worker, "seq": seq,
            "mono": 100.0 + seq, "wall": 1e9 + seq,
            "counters": counters, "hist": {}, "hist_count": 0}


def _samples(kind: str, n: int = 2000) -> list[float]:
    rng = np.random.default_rng(17)
    if kind == "lognormal":
        return rng.lognormal(mean=-2.0, sigma=1.0, size=n).tolist()
    if kind == "exponential":
        return rng.exponential(0.05, size=n).tolist()
    # Edges, the overflow bucket, NaN and zero.
    return ([0.0, 1e-4, 1e-4 * telemetry.BUCKET_RATIO, 99.9, 1e3,
             float("nan")] + rng.uniform(0, 200, size=n).tolist())


# ------------------------------------------------------ the same as JAX's


def test_declared_buckets_equal_jax():
    assert telemetry.BUCKET_RATIO == jtelemetry.BUCKET_RATIO
    assert telemetry.DEFAULT_BOUNDS == jtelemetry.DEFAULT_BOUNDS
    assert len(telemetry.DEFAULT_BOUNDS) == 73
    assert telemetry.DEFAULT_BOUNDS[0] == 1e-4
    assert telemetry.SNAPSHOT_SCHEMA == jtelemetry.SNAPSHOT_SCHEMA


@pytest.mark.parametrize("kind", ["lognormal", "exponential", "edges"])
def test_hist_quantiles_equal_jax(kind):
    ours, theirs = telemetry.LatencyHist(), jtelemetry.LatencyHist()
    for v in _samples(kind):
        ours.observe(v)
        theirs.observe(v)
    assert ours.counts == theirs.counts
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert ours.quantile(q) == theirs.quantile(q)
    assert ours.to_dict() == theirs.to_dict()


@pytest.mark.parametrize("kind", ["lognormal", "edges"])
def test_snapshots_and_frames_byte_identical(tmp_path, kind):
    """The same observations and samples through both recorders give the
    same snapshot dicts, in the same key order, and the same sidecar
    bytes."""
    ours = telemetry.WorkerTelemetry(3, interval_s=0.5, capacity=8)
    theirs = jtelemetry.WorkerTelemetry(3, interval_s=0.5, capacity=8)
    a, b = tmp_path / "port.bin", tmp_path / "jax.bin"
    with open(a, "ab") as fa, open(b, "ab") as fb:
        for k, v in enumerate(_samples(kind, 200)):
            ours.observe_latency(v)
            theirs.observe_latency(v)
            if k % 17 == 16:
                counters = {"resolved": k, "shed": k // 5, "depth": 3}
                s0 = ours.sample(k * 0.1, counters, wall=1e9 + k)
                s1 = theirs.sample(k * 0.1, counters, wall=1e9 + k)
                assert (s0 is None) == (s1 is None)
                if s0 is None:
                    continue
                assert json.dumps(s0) == json.dumps(s1)
                assert telemetry.write_frame(fa, s0) == \
                    jtelemetry.write_frame(fb, s1)
    assert a.read_bytes() == b.read_bytes()
    assert ours.dropped == theirs.dropped
    assert telemetry.read_frames(str(a)) == jtelemetry.read_frames(str(b))


def test_jax_reader_soft_lands_on_port_sidecar_cut(tmp_path):
    """A port shipper's sidecar, cut at every byte of its last frame (a
    worker killed mid-write), reads under JAX ``read_frames`` as the
    intact prefix plus one counted truncation, as under the port's."""
    path = str(tmp_path / "w.telemetry.bin")
    lat = []

    def sample():
        return {"resolved": len(lat), "good": len(lat), "bad": 0}, lat[-2:]

    shipper = telemetry.SnapshotShipper(path, 2, sample, interval_s=0.01)
    shipper.start()
    for _ in range(3):
        lat.append(0.01)
        time.sleep(0.03)
    shipper.stop()
    blob = open(path, "rb").read()
    full = jtelemetry.read_frames(path)
    assert full["truncated"] == 0 and full["snapshots"]
    n = len(full["snapshots"])
    last = len(blob) - 8 - len(json.dumps(
        full["snapshots"][-1], separators=(",", ":")).encode())
    cut_path = str(tmp_path / "cut.bin")
    for cut in range(last + 1, len(blob)):
        open(cut_path, "wb").write(blob[:cut])
        rep = jtelemetry.read_frames(cut_path)
        assert rep == telemetry.read_frames(cut_path)
        assert len(rep["snapshots"]) == n - 1 and rep["truncated"] == 1


def test_rollup_equals_jax(tmp_path):
    """Three workers' shipped deltas (one seq gap, one truncated frame, a
    recovery lifetime under its own key) roll up to JAX's summary."""
    rng = np.random.default_rng(11)
    ours, theirs = FleetRollup(), jrouter.FleetRollup()
    for w in range(3):
        wt = telemetry.WorkerTelemetry(w, interval_s=0.01)
        for i, v in enumerate(rng.exponential(0.05, size=150)):
            wt.observe_latency(v)
            if i % 30 == 29:
                snap = wt.sample(float(i), {"resolved": i, "shed": w},
                                 force=True, wall=1e9 + i)
                if not (w == 1 and i == 89):  # a lost interval
                    assert ours.ingest(snap) and theirs.ingest(snap)
    late = _snap(2, 0, resolved=4)
    ours.ingest(late, worker="2.rehome1")
    theirs.ingest(late, worker="2.rehome1")
    ours.truncated += 1
    theirs.truncated += 1
    assert ours.summary() == theirs.summary()
    assert ours.clock_offsets() == theirs.clock_offsets()
    assert ours.summary()["loss"]["lost"] == 2


@pytest.fixture(scope="module")
def traced_cli_dir(tmp_path_factory):
    """A port fleet CLI run (3 workers, worker 1 killed at its second
    dispatch) with tracing on: per-worker traces, sidecars and the
    parent's own trace."""
    root = tmp_path_factory.mktemp("fleet_trace")
    state = root / "state"
    env = dict(os.environ, PYTHONPATH=REPO, MOMP_CHAOS="kill_worker=1:2",
               MOMP_TRACE=str(root / "router.trace.jsonl"))
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_and_open_mp_tpu_torch.serve.fleet",
         "--device", "cpu", "--workers", "3", "--requests", "36",
         "--dir", str(state)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return root, json.loads(proc.stdout.strip().splitlines()[-1])


def test_fleet_report_merges_port_state_dir(traced_cli_dir, tmp_path):
    """JAX's ``analysis/fleet_report.py`` merges a port fleet CLI's state
    directory: one track per worker lifetime, the burn event before the
    scale decision, the sidecars' counted loss equal to the line's."""
    sys.path.insert(0, ANALYSIS)
    import fleet_report

    root, line = traced_cli_dir
    summary = fleet_report.fleet_report(
        str(root / "state"), router_trace=str(root / "router.trace.jsonl"),
        chrome_out=str(tmp_path / "merged.json"))
    assert "router" in summary["tracks"]
    assert {"worker0", "worker1", "worker2"} <= set(summary["tracks"])
    assert any(".rehome1" in t for t in summary["tracks"])
    assert summary["burn_precedes_scale"] is True
    assert summary["scale_events"][0]["action"] == "add"
    assert summary["telemetry"]["loss"] == line["telemetry"]["loss"]
    chrome = json.loads((tmp_path / "merged.json").read_text())
    assert any(e.get("ph") == "C" for e in chrome["traceEvents"])


# ---------------------------------------- the JAX package's telemetry cases


def test_hist_quantiles_within_declared_bucket_error():
    samples = _samples("lognormal")
    h = telemetry.LatencyHist()
    for v in samples:
        h.observe(v)
    assert h.count == len(samples)
    for q in (50, 99, 99.9):
        exact = percentile(samples, q)
        est = h.quantile(q)
        assert h.agrees(est, exact), (q, est, exact)
        assert est >= exact * (1 - 1e-9)
        assert est <= exact * telemetry.BUCKET_RATIO * (1 + 1e-9)


def test_hist_empty_overflow_and_nan():
    h = telemetry.LatencyHist()
    assert h.quantile(99) == 0.0
    h.observe(float("nan"))
    assert h.count == 0
    h.observe(1e6)
    assert h.quantile(99) == 1e6
    assert h.counts[-1] == 1


def test_hist_merge_counts_equals_direct_observation():
    rng = np.random.default_rng(3)
    a, b = telemetry.LatencyHist(), telemetry.LatencyHist()
    whole = telemetry.LatencyHist()
    for i, v in enumerate(rng.exponential(0.1, size=400)):
        (a if i % 2 else b).observe(v)
        whole.observe(v)
    merged = telemetry.LatencyHist()
    merged.merge_counts(a.snapshot_counts(), total=a.total,
                        vmin=a.vmin, vmax=a.vmax)
    sparse = {str(i): n for i, n in enumerate(b.counts) if n}
    merged.merge_counts(sparse, total=b.total, vmin=b.vmin, vmax=b.vmax)
    assert merged.counts == whole.counts
    assert merged.count == whole.count
    assert math.isclose(merged.total, whole.total)
    for q in (50, 99):
        assert merged.quantile(q) == whole.quantile(q)


def test_worker_ring_bounded_and_counts_evictions():
    wt = telemetry.WorkerTelemetry(0, interval_s=0.01, capacity=4)
    for k in range(10):
        snap = wt.sample(k * 1.0, {"resolved": k}, force=True)
        assert snap is not None and snap["seq"] == k
    assert len(wt.series()) == 4
    assert wt.dropped == 6
    assert [s["seq"] for s in wt.series()] == [6, 7, 8, 9]


def test_worker_sample_interval_gated_and_delta_shipped():
    wt = telemetry.WorkerTelemetry(1, interval_s=1.0)
    wt.observe_latency(0.01)
    first = wt.sample(10.0, {"resolved": 1})
    assert first is not None and first["hist_count"] == 1
    assert sum(first["hist"].values()) == 1
    assert wt.sample(10.5, {"resolved": 1}) is None
    wt.observe_latency(0.02)
    wt.observe_latency(0.03)
    second = wt.sample(11.5, {"resolved": 3})
    assert second is not None and sum(second["hist"].values()) == 2
    assert second["seq"] == 1
    assert second["mono"] == 11.5 and isinstance(second["wall"], float)


def test_knobs_read_the_environment(monkeypatch):
    monkeypatch.setenv("MOMP_TELEMETRY", "0")
    monkeypatch.setenv("MOMP_TELEMETRY_INTERVAL", "0.2")
    monkeypatch.setenv("MOMP_TELEMETRY_CAPACITY", "7")
    assert not telemetry.telemetry_on()
    assert telemetry.snapshot_interval_s() == 0.2
    assert telemetry.ring_capacity() == 7
    monkeypatch.setenv("MOMP_TELEMETRY_INTERVAL", "bogus")
    monkeypatch.setenv("MOMP_TELEMETRY_CAPACITY", "-1")
    assert telemetry.snapshot_interval_s() == 0.05
    assert telemetry.ring_capacity() == 512
    assert telemetry.WorkerTelemetry(0).ring.maxlen == 512


def test_burn_rate_windows_and_edge_trigger():
    b = telemetry.BurnRateMonitor(slo_p99_s=0.1, goodput_frac=0.9,
                                  short_window_s=1.0, long_window_s=4.0)
    assert b.budget == pytest.approx(0.1)
    assert b.is_bad(0.2) and not b.is_bad(0.05)
    for k in range(8):
        win = b.observe(k * 0.5, good=20, bad=0)
        assert not win["alert_edge"]
    assert b.alerts == 0
    edges = 0
    for k in range(8):
        win = b.observe(4.0 + k * 0.5, good=0, bad=20)
        edges += win["alert_edge"]
    assert edges == 1
    assert b.alerts == 1
    assert b.peak_short == pytest.approx(1.0 / 0.1)
    for k in range(16):
        b.observe(8.0 + k * 0.5, good=20, bad=0)
    for k in range(8):
        b.observe(16.0 + k * 0.5, good=0, bad=20)
    assert b.alerts == 2
    with pytest.raises(ValueError, match="long window"):
        telemetry.BurnRateMonitor(short_window_s=2.0, long_window_s=1.0)


def test_burn_rate_short_window_trips_before_long():
    b = telemetry.BurnRateMonitor(slo_p99_s=0.1, goodput_frac=0.9,
                                  short_window_s=0.5, long_window_s=4.0)
    for k in range(7):
        b.observe(k * 0.5, good=40, bad=0)
    win = b.observe(3.5, good=0, bad=20)
    assert win["burn_short"] > 1.0
    assert win["burn_long"] < win["burn_short"]
    assert not win["alert_edge"]


def test_burn_monitor_from_slo():
    from mpi_and_open_mp_tpu_torch.serve.loadgen import SLO

    b = telemetry.BurnRateMonitor.from_slo(SLO(p99_s=0.3,
                                               goodput_frac=0.8))
    assert b.slo_p99_s == 0.3
    assert b.budget == pytest.approx(0.2)


def test_frame_roundtrip(tmp_path):
    path = str(tmp_path / "w0.telemetry.bin")
    with open(path, "ab") as fd:
        for k in range(5):
            telemetry.write_frame(fd, _snap(0, k, resolved=k))
    rep = telemetry.read_frames(path)
    assert rep["truncated"] == 0
    assert [s["seq"] for s in rep["snapshots"]] == list(range(5))


def test_frame_truncated_tail_soft_lands(tmp_path):
    path = str(tmp_path / "w0.telemetry.bin")
    with open(path, "ab") as fd:
        for k in range(3):
            telemetry.write_frame(fd, _snap(0, k))
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[:-20])
    rep = telemetry.read_frames(path)
    assert [s["seq"] for s in rep["snapshots"]] == [0, 1]
    assert rep["truncated"] == 1


def test_frame_crc_corruption_stops_reader(tmp_path):
    path = str(tmp_path / "w0.telemetry.bin")
    with open(path, "ab") as fd:
        for k in range(3):
            telemetry.write_frame(fd, _snap(0, k))
    blob = bytearray(open(path, "rb").read())
    blob[12] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    rep = telemetry.read_frames(path)
    assert rep["snapshots"] == []
    assert rep["truncated"] == 1


def test_frame_reader_never_allocates_a_corrupt_length(tmp_path):
    path = str(tmp_path / "w0.telemetry.bin")
    open(path, "wb").write(struct.pack("<II", 1 << 30, 0) + b"x" * 64)
    rep = telemetry.read_frames(path)
    assert rep["snapshots"] == [] and rep["truncated"] == 1
    assert telemetry.read_frames(str(tmp_path / "missing.bin")) == {
        "snapshots": [], "truncated": 0, "bytes": 0}


def test_clock_offset_median():
    snaps = [dict(_snap(0, k), mono=100.0 + k, wall=500.0 + k)
             for k in range(5)]
    snaps[2]["wall"] += 3.0
    assert telemetry.clock_offset(snaps) == pytest.approx(400.0)
    assert telemetry.clock_offset([]) is None


def test_rollup_merges_counters_and_detects_seq_gaps():
    r = FleetRollup()
    for seq in (0, 1, 3):
        assert r.ingest(_snap(0, seq, resolved=seq * 2))
    assert r.ingest(_snap(1, 0, resolved=10))
    assert r.counter("resolved") == 6 + 10
    loss = r.loss()
    assert loss == {"expected": 5, "received": 4, "lost": 1,
                    "truncated": 0, "frac": pytest.approx(0.2)}
    r.truncated += 1
    assert r.loss() == {"expected": 6, "received": 4, "lost": 2,
                        "truncated": 1, "frac": pytest.approx(2 / 6)}
    r.truncated -= 1
    assert not r.ingest({"v": 999, "worker": 0, "seq": 9})
    assert r.rejected == 1


def test_rollup_worker_key_override_isolates_lifetimes():
    r = FleetRollup()
    r.ingest(_snap(2, 0, resolved=5))
    r.ingest(_snap(2, 1, resolved=8))
    r.ingest(_snap(2, 0, resolved=3), worker="2.rehome1")
    loss = r.loss()
    assert loss["lost"] == 0 and loss["expected"] == 3
    assert r.counter("resolved") == 8 + 3
    assert r.summary()["workers"] == [2, "2.rehome1"]


def test_rollup_quantiles_from_shipped_deltas():
    rng = np.random.default_rng(11)
    r = FleetRollup()
    exact = []
    for w in range(3):
        wt = telemetry.WorkerTelemetry(w, interval_s=0.01)
        for i, v in enumerate(rng.exponential(0.05, size=200)):
            wt.observe_latency(v)
            exact.append(v)
            if i % 50 == 49:
                r.ingest(wt.sample(float(i), {}, force=True))
    assert r.hist.count == len(exact)
    for q in (50, 99):
        assert r.hist.agrees(r.quantile(q), percentile(exact, q))


def _run_fleet_burst(fleet, boards=24, steps=2):
    rng = np.random.default_rng(5)
    for k in range(boards):
        fleet.submit((rng.random((32, 32)) < 0.3).astype(np.uint8), steps,
                     session=f"s{k % 6}")
    fleet.serve_until_drained(drain=True)


def test_fleet_ships_snapshots_into_rollup_with_zero_loss():
    fleet = Fleet(2, ServePolicy(max_batch=4, max_wait_s=0.0),
                  heartbeat_interval_s=0.01, telemetry_interval_s=0.005,
                  device="cpu")
    _run_fleet_burst(fleet)
    tel = fleet.router.telemetry
    s = tel.summary()
    assert s["snapshots"] > 0
    assert s["loss"] == {"expected": s["loss"]["expected"],
                         "received": s["loss"]["expected"], "lost": 0,
                         "truncated": 0, "frac": 0.0}
    assert s["resolved"] == 24
    lat = [t.latency_s for t in fleet.resolved_tickets()]
    assert tel.hist.count == len(lat)
    assert tel.hist.agrees(tel.quantile(50), percentile(lat, 50))
    assert tel.hist.agrees(tel.quantile(99), percentile(lat, 99))
    assert set(tel.clock_offsets()) == {0, 1}


def test_fleet_telemetry_off_records_nothing():
    fleet = Fleet(2, ServePolicy(max_batch=4, max_wait_s=0.0),
                  heartbeat_interval_s=0.01, telemetry=False, device="cpu")
    _run_fleet_burst(fleet, boards=8)
    assert fleet.burn is None
    assert fleet.router.telemetry.snapshots == 0
    assert fleet.decisions == []


def test_fleet_decisions_carry_burn_windows(tmp_path, monkeypatch):
    sink = tmp_path / "trace.jsonl"
    monkeypatch.setenv("MOMP_TRACE", str(sink))
    trace.reset()
    try:
        fleet = Fleet(
            2, ServePolicy(max_batch=4, max_wait_s=0.0),
            wal_dir=str(tmp_path / "wal"),
            heartbeat_interval_s=0.01, telemetry_interval_s=0.005,
            elasticity=ElasticityPolicy(
                slo_p99_s=1e-4, min_workers=1, max_workers=3,
                breach_k=1, surplus_p99_frac=0.0),
            device="cpu")
        _run_fleet_burst(fleet)
        assert fleet.decisions, "breach never produced a decision"
        for d in fleet.decisions:
            assert d["action"] == "add"
            for key in ("burn_short", "burn_long", "short_window_s",
                        "long_window_s", "p99_s", "depth", "workers"):
                assert key in d, (key, d)
        assert len(fleet.handles) == 3
        records = [json.loads(ln) for ln in
                   sink.read_text().splitlines() if ln.strip()]
        scales = [r for r in records if r.get("name") == "serve.fleet.scale"]
        burns = [r for r in records if r.get("name") == "serve.fleet.burn"]
        assert len(scales) == len(fleet.decisions)
        assert burns, "SLO-breaching traffic never raised a burn alert"
        assert burns[0]["ts"] <= scales[0]["ts"]
        assert fleet.burn.summary()["burn_alerts"] >= 1
    finally:
        trace.reset()


def test_shipper_writes_frames_and_final_flush(tmp_path):
    path = str(tmp_path / "w.telemetry.bin")
    resolved = []

    def sample():
        return {"resolved": len(resolved), "good": len(resolved),
                "bad": 0}, [v for v in resolved[-2:]]

    shipper = telemetry.SnapshotShipper(path, 7, sample, interval_s=0.01)
    shipper.start()
    for _ in range(3):
        resolved.append(0.01)
        time.sleep(0.03)
    shipper.stop()
    rep = telemetry.read_frames(path)
    assert rep["truncated"] == 0
    assert rep["snapshots"], "shipper never wrote a frame"
    last = rep["snapshots"][-1]
    assert last["counters"]["resolved"] == 3
    seqs = [s["seq"] for s in rep["snapshots"]]
    assert seqs == list(range(len(seqs)))


def _write_trace(path, pid, names, base_ts=1000.0):
    with open(path, "w") as fd:
        for k, name in enumerate(names):
            fd.write(json.dumps({
                "kind": "span", "name": name, "ts": base_ts + k,
                "dur": 0.5, "id": k + 1,
                "parent": k if k else None,
                "pid": pid, "host": "h"}) + "\n")


def test_fleet_report_merges_tracks_with_id_namespacing(tmp_path):
    """JAX's merge tool over traces and a sidecar written by the port."""
    sys.path.insert(0, ANALYSIS)
    import fleet_report

    d = tmp_path / "state"
    d.mkdir()
    _write_trace(str(d / "worker0.trace.jsonl"), 100, ["a", "b"])
    _write_trace(str(d / "worker1.trace.jsonl"), 200, ["a", "c"])
    router = tmp_path / "router.trace.jsonl"
    with open(router, "w") as fd:
        fd.write(json.dumps({"kind": "event", "name": "serve.fleet.burn",
                             "ts": 1500.0, "id": 1, "parent": None,
                             "pid": 300, "host": "h"}) + "\n")
        fd.write(json.dumps({"kind": "event", "name": "serve.fleet.scale",
                             "ts": 1501.0, "id": 2, "parent": None,
                             "pid": 300, "host": "h",
                             "attrs": {"action": "add"}}) + "\n")
    with open(d / "worker0.telemetry.bin", "ab") as fd:
        for k in range(3):
            telemetry.write_frame(fd, _snap(0, k, resolved=k, depth=1))

    summary = fleet_report.fleet_report(
        str(d), router_trace=str(router),
        chrome_out=str(tmp_path / "merged.json"))
    assert summary["tracks"] == ["router", "worker0", "worker1"]
    assert summary["records"] == 6
    assert summary["burn_events"] == 1
    assert summary["burn_precedes_scale"] is True
    assert summary["scale_events"][0]["action"] == "add"
    assert summary["telemetry"]["loss"]["lost"] == 0
    chrome = json.loads((tmp_path / "merged.json").read_text())
    evs = chrome["traceEvents"]
    xs = [e for e in evs if e.get("ph") == "X"]
    ids = [(e["args"]["span_id"], e["pid"]) for e in xs]
    assert len({i for i, _ in ids}) == len(ids)
    counters = [e for e in evs if e.get("ph") == "C"]
    assert any(e["name"] == "worker0.depth" for e in counters)


def test_fleet_report_survives_killed_writer_tail(tmp_path):
    sys.path.insert(0, ANALYSIS)
    import fleet_report

    d = tmp_path / "state"
    d.mkdir()
    _write_trace(str(d / "worker0.trace.jsonl"), 100, ["a"])
    with open(d / "worker1.trace.jsonl", "w") as fd:
        fd.write(json.dumps({"kind": "span", "name": "a", "ts": 1.0,
                             "dur": 0.1, "id": 1, "parent": None,
                             "pid": 200, "host": "h"}) + "\n")
        fd.write('{"kind": "span", "name": "tr')
    summary = fleet_report.fleet_report(str(d))
    assert summary["records"] == 2
    assert summary["load_errors"]


def test_report_soft_lands_on_empty_and_header_only(tmp_path):
    """The port's trace reader, over an empty trace and a header-only
    one."""
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    header_only = tmp_path / "header.jsonl"
    header_only.write_text('{"displayTimeUnit": "ms"}\n\n')
    for path in (empty, header_only):
        rep = report.report_dict(report.load(str(path)))
        assert rep["records"] == 0
        assert rep["phases"]["by_name"] == {}
        assert report.to_chrome(report.load(str(path)))["traceEvents"] == []
        assert isinstance(report.render(rep), str)


def test_metrics_label_cardinality_guard():
    for k in range(300):
        metrics.inc("sess.requests", session=f"s{k}")
    snap = metrics.snapshot()
    names = [key for key in snap["counters"] if key.startswith("sess.")]
    assert len(names) == metrics.max_labelsets() == 256
    assert metrics.get(metrics.DROPPED_LABELS) == 300 - 256
    metrics.inc("sess.requests", session="s0")
    assert metrics.snapshot()["counters"]["sess.requests{session=s0}"] == 2
    for k in range(300):
        metrics.gauge("sess.depth", k, session=f"s{k}")
        metrics.observe("sess.lat", 0.1, session=f"s{k}")
    snap = metrics.snapshot()
    assert sum(1 for k in snap["gauges"] if k.startswith("sess.")) == 256
    assert sum(1 for k in snap["histograms"] if k.startswith("sess.")) == 256
    metrics.reset()
    metrics.inc("sess.requests", session="s999")
    assert metrics.get("sess.requests", session="s999") == 1


def test_metrics_labelset_cap_env_override(monkeypatch):
    monkeypatch.setenv("MOMP_METRICS_MAX_LABELSETS", "4")
    for k in range(10):
        metrics.inc("m.x", label=f"v{k}")
    assert len(metrics.snapshot()["counters"]) == 5
    assert metrics.get(metrics.DROPPED_LABELS) == 6
    monkeypatch.setenv("MOMP_METRICS_MAX_LABELSETS", "bogus")
    assert metrics.max_labelsets() == 256


def test_metrics_delta_scopes_phases():
    metrics.inc("phase.a", 5)
    metrics.observe("lat", 0.1)
    before = metrics.snapshot()
    metrics.inc("phase.b", 3)
    metrics.inc("phase.a", 2)
    metrics.gauge("depth", 7)
    metrics.observe("lat", 0.3)
    d = metrics.delta(before, metrics.snapshot())
    assert d["counters"] == {"phase.a": 2, "phase.b": 3}
    assert d["gauges"] == {"depth": 7}
    assert d["histograms"]["lat"]["count"] == 1
    assert d["histograms"]["lat"]["total"] == pytest.approx(0.3)
    snap = metrics.snapshot()
    assert metrics.delta(snap, snap) == {
        "counters": {}, "gauges": {}, "histograms": {}}


def test_sentinel_polarity_for_telemetry_fields():
    sys.path.insert(0, ANALYSIS)
    import regression_sentinel as sentinel

    assert sentinel.direction_for("telemetry_snapshot_loss_frac") == "lower"
    assert sentinel.direction_for("loadgen_burn_rate_peak") == "lower"
    assert "telemetry_snapshot_loss_frac" in sentinel.WATCH_FIELDS
    assert "loadgen_burn_rate_peak" in sentinel.WATCH_FIELDS
    assert sentinel.direction_for("burnish_per_sec") == "higher"
