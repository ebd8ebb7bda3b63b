"""The port's observability layer (``obs``) against the JAX package's.

The registry's snapshot and delta equal the JAX package's after the same
calls; a trace file the port writes reads to the same report through the
JAX package's ``obs/report.py`` as through the port's; tracing off opens
no sink and syncs nothing; the hooks count what the JAX package's count on
the same runs (checkpoints, guards and recoveries, the batcher's retraces,
the traced ring); the Life CLI's ``--trace`` and ``--profile``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from conftest import oracle_n

from mpi_and_open_mp_tpu.models.life import LifeSim as JaxSim
from mpi_and_open_mp_tpu.obs import metrics as jmetrics
from mpi_and_open_mp_tpu.obs import report as jreport
from mpi_and_open_mp_tpu.obs import trace as jtrace
from mpi_and_open_mp_tpu.parallel import context as jcx
from mpi_and_open_mp_tpu.parallel import mesh as jmesh
from mpi_and_open_mp_tpu.robust import chaos as jchaos
from mpi_and_open_mp_tpu.robust import guards as jguards
from mpi_and_open_mp_tpu.serve import ShapeBucketBatcher as JaxBatcher
from mpi_and_open_mp_tpu.serve import retrace_counts as jretrace_counts
from mpi_and_open_mp_tpu.utils import checkpoint as jcheckpoint
from mpi_and_open_mp_tpu.utils.config import LifeConfig as JaxConfig

from mpi_and_open_mp_tpu_torch.apps import life as life_app
from mpi_and_open_mp_tpu_torch.models.life import LifeSim
from mpi_and_open_mp_tpu_torch.obs import metrics, report, trace
from mpi_and_open_mp_tpu_torch.ops import bitlife
from mpi_and_open_mp_tpu_torch.parallel import context as cx
from mpi_and_open_mp_tpu_torch.parallel import halo, haloplan
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.robust import chaos, guards
from mpi_and_open_mp_tpu_torch.serve import ShapeBucketBatcher
from mpi_and_open_mp_tpu_torch.serve import retrace_counts
from mpi_and_open_mp_tpu_torch.utils import checkpoint
from mpi_and_open_mp_tpu_torch.utils.config import config_from_board

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLIDER = os.path.join(ROOT, "tests", "fixtures", "glider_10x10.cfg")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh():
    """Empty registries, logs and chaos plans in both packages around every
    test, and no sink left open."""
    def clean():
        for m in (metrics, jmetrics):
            m.reset()
        for t in (trace, jtrace):
            t.reset()
        for c in (chaos, jchaos):
            c.reset()
        guards.reset_recovery_log()
        jguards.clear_recovery_log()
    clean()
    yield
    clean()


@pytest.fixture
def sink(tmp_path, monkeypatch):
    path = tmp_path / "trace.jsonl"
    monkeypatch.setenv("MOMP_TRACE", str(path))
    yield path


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]


def _qkv(seed, h, n, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((h, n, d)).astype(np.float32)
                 for _ in range(3))


def _tensors(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _jax_config(cfg):
    return JaxConfig(steps=cfg.steps, save_steps=cfg.save_steps, nx=cfg.nx,
                     ny=cfg.ny, cells=cfg.cells)


def _soup(shape, seed, density=0.35):
    return (np.random.default_rng(seed).random(shape) < density).astype(
        np.uint8)


# ------------------------------------------------------------------ metrics


def _record_calls(m):
    m.inc("a")
    m.inc("a", 2)
    m.inc("b", engine="x", n=3)
    m.inc("b", engine="x", n="3")  # a label value renders as its str
    m.gauge("g", 1.5, kind="y")
    m.gauge("g", 2.5, kind="y")
    m.observe("h", 0.25)
    m.observe("h", 0.75)
    m.observe("h", float("nan"))
    for i in range(5):
        m.inc("capped", stamp=f"s{i}")
        m.observe("capped_h", float(i), stamp=f"s{i}")


@pytest.mark.parametrize("cap", [None, "3", "bogus", "0"])
def test_snapshot_and_delta_equal_jax(monkeypatch, cap):
    if cap is not None:
        monkeypatch.setenv("MOMP_METRICS_MAX_LABELSETS", cap)
    before = metrics.snapshot(), jmetrics.snapshot()
    for m in (metrics, jmetrics):
        _record_calls(m)
    got, want = metrics.snapshot(), jmetrics.snapshot()
    assert got == want
    assert metrics.max_labelsets() == jmetrics.max_labelsets()
    assert metrics.delta(before[0], got) == jmetrics.delta(before[1], want)
    for m in (metrics, jmetrics):
        m.inc("a")
        m.gauge("g", 9.0, kind="y")
        m.observe("h", 2.0)
    assert metrics.delta(got, metrics.snapshot()) == jmetrics.delta(
        want, jmetrics.snapshot())
    assert metrics.get("b", engine="x", n=3) == jmetrics.get(
        "b", engine="x", n=3)


def test_metrics_off_switch(monkeypatch):
    monkeypatch.setenv("MOMP_METRICS", "0")
    for m in (metrics, jmetrics):
        _record_calls(m)
    assert metrics.snapshot() == jmetrics.snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}


def test_inc_once_ticks_each_key_once():
    seen = set()
    for key in (1, 2, 1, 1, 3, 2):
        metrics.inc_once(seen, key, "built", fn="f")
    assert metrics.get("built", fn="f") == 3
    metrics.reset()
    metrics.inc_once(seen, 1, "built", fn="f")
    assert metrics.get("built", fn="f") == 0  # a reset keeps what was built


# -------------------------------------------------------------- the tracer


def test_tracing_off_opens_nothing_and_syncs_nothing(monkeypatch, tmp_path):
    monkeypatch.delenv("MOMP_TRACE", raising=False)
    syncs = []
    monkeypatch.setattr(trace, "sync", lambda t: syncs.append(t))
    monkeypatch.chdir(tmp_path)
    assert trace.span("x", a=1) is trace.NULL
    with trace.span("x") as sp:
        sp.anchor(torch.zeros(2)).set(b=2)
    assert np.isnan(sp.elapsed)
    trace.event("e", a=1)
    q, k, v = _tensors(*_qkv(0, 2, 256, 16))
    cx.ring_attention(q, k, v, devices=4, causal=True, device="cpu")
    cfg = config_from_board(_soup((32, 32), 1), steps=8, save_steps=4)
    LifeSim(cfg, layout="row", impl="halo", device="cpu",
            mesh=mesh_lib.make_mesh_1d(4, device="cpu")).run(save=False)
    assert syncs == [] and trace._CACHE == (None, None)
    assert os.listdir(tmp_path) == []


def test_tracing_on_anchors(monkeypatch, sink):
    syncs = []
    monkeypatch.setattr(trace, "sync", lambda t: syncs.append(t))
    with trace.span("outer", a=1) as sp:
        with trace.span("inner") as inner:
            inner.anchor((None, [torch.ones(1)]))
        trace.event("e", stamp="s")
        sp.set(b=2)
    with pytest.raises(ValueError):
        with trace.span("bad"):
            raise ValueError("x")
    recs = _records(sink)
    assert len(syncs) == 1
    assert [r["name"] for r in recs] == ["inner", "e", "outer", "bad"]
    inner, ev, outer, bad = recs
    assert inner["parent"] == outer["id"] == ev["parent"]
    assert outer["attrs"] == {"a": 1, "b": 2} and outer["parent"] is None
    assert bad["error"] == "ValueError"
    assert set(outer) == {"kind", "name", "ts", "dur", "id", "parent", "pid",
                          "host", "attrs"}


def test_hop_spans_opt_out(monkeypatch, sink):
    assert trace.hop_spans_active() == jtrace.hop_spans_active() is True
    monkeypatch.setenv("MOMP_TRACE_HOPS", "0")
    assert trace.hop_spans_active() == jtrace.hop_spans_active() is False
    q, k, v = _tensors(*_qkv(1, 2, 256, 16))
    cx.ring_attention(q, k, v, devices=4, causal=True, device="cpu")
    recs = _records(sink)
    assert [r["name"] for r in recs] == ["ring_attention"]
    assert "traced_dispatch" not in recs[0]["attrs"]
    assert metrics.get("ring.steps.traced") == 0


# ------------------------------------------------------- the traced ring


def _tree(recs):
    """The span tree as (name, parent name, attrs without the engine)."""
    by_id = {r["id"]: r for r in recs}
    return [(r["name"], by_id[r["parent"]]["name"] if r["parent"] else None,
             {k: v for k, v in (r.get("attrs") or {}).items()
              if k != "engine"}) for r in recs]


@pytest.mark.parametrize("causal", [True, False])
def test_traced_ring_span_tree_and_hops_equal_jax(tmp_path, monkeypatch,
                                                  causal):
    """p = 4 on the CPU: the same span tree as the JAX package's traced
    ring, p - 1 transfer and fold spans, ``ring.hops.fwd = p - 1``, and the
    output bit for bit the untraced ring's."""
    p = 4
    qn, kn, vn = _qkv(2, 2, 256, 16)
    q, k, v = _tensors(qn, kn, vn)
    untraced = cx.ring_attention(q, k, v, devices=p, causal=causal,
                                 device="cpu")
    port_path, jax_path = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    monkeypatch.setenv("MOMP_TRACE", str(port_path))
    traced = cx.ring_attention(q, k, v, devices=p, causal=causal,
                               device="cpu")
    monkeypatch.setenv("MOMP_TRACE", str(jax_path))
    jout = jcx.ring_attention(qn, kn, vn, mesh=jmesh.make_mesh_1d(
        p, axis="sp"), causal=causal)
    assert torch.equal(traced, untraced)
    np.testing.assert_allclose(traced.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    mine, theirs = _records(port_path), _records(jax_path)
    assert _tree(mine) == _tree(theirs)
    names = [r["name"] for r in mine]
    assert names.count("ring.hop.transfer") == names.count(
        "ring.hop.fold") == p - 1
    stamp = cx.ring_hop_engine_for(q, k, v, p=p, causal=causal)
    assert metrics.get("ring.hops.fwd", engine=stamp) == p - 1
    assert metrics.get("ring.steps.traced") == jmetrics.get(
        "ring.steps.traced") == 1
    assert sum(v for key, v in metrics.snapshot()["counters"].items()
               if key.startswith("ring.hops.fwd")) == sum(
        v for key, v in jmetrics.snapshot()["counters"].items()
        if key.startswith("ring.hops.fwd"))


def test_zigzag_and_ulysses_get_the_whole_call_span(sink):
    q, k, v = _tensors(*_qkv(3, 4, 256, 16))
    cx.ring_attention(q, k, v, devices=4, causal=True, layout="zigzag",
                      device="cpu")
    cx.ring_attention(q, k, v, devices=1, causal=True, device="cpu")
    recs = _records(sink)
    assert [r["name"] for r in recs] == ["ring_attention"] * 2
    assert recs[0]["attrs"]["layout"] == "zigzag"
    assert recs[0]["attrs"]["engine"].endswith(":zz")


def test_sharded_attention_retraces_once_per_call_shape():
    """The JAX package compiles its sharded attention once per operand
    shape; the port ticks once per distinct call."""
    cx._SHARDED.clear()
    jax.clear_caches()
    mesh = jmesh.make_mesh_1d(4, axis="sp")
    for n in (256, 256, 512):
        qn, kn, vn = _qkv(n, 2, n, 16)
        cx.ring_attention(*_tensors(qn, kn, vn), devices=4, causal=True,
                          device="cpu")
        jcx.ring_attention(qn, kn, vn, mesh=mesh, causal=True)
    assert metrics.get("jit.retrace", fn="sharded_attention") == jmetrics.get(
        "jit.retrace", fn="sharded_attention") == 2


def test_guarded_ring_recovery_counts_equal_jax(sink, monkeypatch):
    """A poisoned hop under the guard: one recovery, counted and traced
    inside the guarded span in both packages (the stamps name each
    package's engines)."""
    qn, kn, vn = _qkv(4, 2, 128, 16)
    monkeypatch.setenv("MOMP_CHAOS", "nan_hop=1;seed=3")
    chaos.reset()
    jchaos.reset()
    try:
        out = cx.ring_attention(*_tensors(qn, kn, vn), devices=8,
                                causal=True, device="cpu")
        jout = jcx.ring_attention(qn, kn, vn, mesh=jmesh.make_mesh_1d(
            8, axis="sp"), causal=True)
    finally:
        jax.clear_caches()
    assert torch.isfinite(out).all() and np.isfinite(np.asarray(jout)).all()

    def counts(m):
        c = m.snapshot()["counters"]
        return tuple(sum(v for key, v in c.items() if key.startswith(name))
                     for name in ("recovery{", "guard.validation{",
                                  "guard.validation_failed{"))

    assert counts(metrics) == counts(jmetrics) == (1, 2, 1)
    recs = _records(sink)
    spans = [r for r in recs if r["name"] == "ring_attention"]
    events = [r for r in recs if r["name"] == "recovery"]
    assert len(spans) == len(events) == 2
    for span, event in zip(spans, events):
        assert span["attrs"]["guarded"] is True
        assert span["attrs"]["engine"].endswith(":recovered")
        assert event["parent"] == span["id"]
    assert guards.recovery_log() == [events[0]["attrs"]["stamp"]]


# ------------------------------------------------------------ the hooks


def test_checkpoint_counters_equal_jax(tmp_path, sink):
    board = _soup((16, 16), 1)
    checkpoint.save(tmp_path / "port.state", board, step=7)
    got, step = checkpoint.restore(tmp_path / "port.state")
    jcheckpoint.save(str(tmp_path / "jax"), jax.numpy.asarray(board), 7)
    jcheckpoint.restore(str(tmp_path / "jax"))
    assert step == 7 and np.array_equal(got, board)
    checkpoint.save_state(tmp_path / "s.state", {"q": [1, 2]})
    checkpoint.restore_state(tmp_path / "s.state")
    jcheckpoint.save_state(tmp_path / "j.state", {"q": [1, 2]})
    jcheckpoint.restore_state(tmp_path / "j.state")
    mine, theirs = metrics.snapshot(), jmetrics.snapshot()
    assert mine["counters"] == theirs["counters"]
    assert mine["counters"]["checkpoint.save.bytes"] == 256
    assert {k: v["count"] for k, v in mine["histograms"].items()} == {
        k: v["count"] for k, v in theirs["histograms"].items()}
    names = [r["name"] for r in _records(sink)]
    assert names == (["checkpoint.save", "checkpoint.restore"] * 2
                     + ["checkpoint.state_save",
                        "checkpoint.state_restore"] * 2)


def test_lifesim_checkpoint_run_counts_equal_jax(tmp_path):
    """A run that checkpoints at its save cadence and on a finer one, then
    resumes: the same saves, restores and bytes in both packages."""
    board = _soup((32, 32), 5)
    cfg = config_from_board(board, steps=12, save_steps=6)
    sim = LifeSim(cfg, layout="row", impl="halo", device="cpu",
                  mesh=mesh_lib.make_mesh_1d(4, device="cpu"),
                  checkpoint_dir=tmp_path / "port", checkpoint_every=4)
    jsim = JaxSim(_jax_config(cfg), layout="row", impl="halo",
                  mesh=jmesh.make_mesh_1d(4),
                  checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=4)
    final, jfinal = sim.run(), jsim.run()
    np.testing.assert_array_equal(final, np.asarray(jfinal))
    LifeSim.from_checkpoint(tmp_path / "port" / "step_000008.state", cfg,
                            layout="serial", device="cpu")
    JaxSim.from_checkpoint(str(tmp_path / "jax" / "step_000008"),
                           _jax_config(cfg), layout="serial")
    keys = ("checkpoint.saves", "checkpoint.save.bytes",
            "checkpoint.restores", "checkpoint.restore.bytes")
    got = {k: metrics.snapshot()["counters"].get(k) for k in keys}
    want = {k: jmetrics.snapshot()["counters"].get(k) for k in keys}
    # Saves at steps 0, 4, 6 and 8 (the cadence and every 4 steps).
    assert got == want and got["checkpoint.saves"] == 4


def test_lifesim_guard_recovery_counts_equal_jax(monkeypatch, sink,
                                                tmp_path):
    board = _soup((32, 32), 3)
    cfg = config_from_board(board, steps=12, save_steps=4)
    monkeypatch.setenv("MOMP_CHAOS", "halo=corrupt;seed=3")
    chaos.reset()
    jchaos.reset()
    sim = LifeSim(cfg, layout="row", impl="halo", device="cpu",
                  mesh=mesh_lib.make_mesh_1d(4, device="cpu"))
    jsim = JaxSim(_jax_config(cfg), layout="row", impl="halo",
                  mesh=jmesh.make_mesh_1d(4))
    try:
        final = sim.run(save=False)
        monkeypatch.setenv("MOMP_TRACE", str(tmp_path / "jax.jsonl"))
        jfinal = jsim.run(save=False)
    finally:
        jax.clear_caches()
    np.testing.assert_array_equal(final, oracle_n(board, 12))
    np.testing.assert_array_equal(final, np.asarray(jfinal))
    stamp = "life_step:halo:recovered"
    assert metrics.get("recovery", stamp=stamp) == jmetrics.get(
        "recovery", stamp=stamp) == 1
    recs = _records(sink)
    segments = [r for r in recs if r["name"] == "life.segment"]
    (event,) = [r for r in recs if r["name"] == "recovery"]
    assert len(segments) == 1  # run(save=False): one guarded segment
    assert [r["name"] for r in _records(tmp_path / "jax.jsonl")] == [
        r["name"] for r in recs]
    assert all(s["attrs"]["guarded"] is True for s in segments)
    assert event["attrs"] == {"stamp": stamp}
    assert event["parent"] in {s["id"] for s in segments}


def test_batcher_retrace_counts_equal_jax():
    """A flush over K shape buckets ticks K retraces, in both packages; a
    second flush over the same buckets ticks none."""
    bitlife._RETRACED.clear()
    jax.clear_caches()
    counts = []
    for cls, retraces in ((ShapeBucketBatcher, retrace_counts),
                          (JaxBatcher, jretrace_counts)):
        kw = {"device": "cpu"} if cls is ShapeBucketBatcher else {}
        bat = cls(max_batch=8, **kw)
        for steps in (2, 9):
            for i in range(4):
                bat.submit(_soup((24, 24), i), steps)
            for i in range(3):
                bat.submit(_soup((12, 40), i), steps + 1)
            for i in range(8):
                bat.submit(_soup((10, 10), i), steps)
            bat.flush()
            counts.append(retraces())
    assert counts[0] == counts[1] == counts[2] == counts[3]
    assert sum(counts[0].values()) == 3
    snap = metrics.snapshot()["counters"]
    jsnap = jmetrics.snapshot()["counters"]
    for name in ("serve.requests", "serve.batches", "serve.padding"):
        assert snap[name] == jsnap[name]


def test_batcher_spans(sink):
    bat = ShapeBucketBatcher(max_batch=4, device="cpu")
    for i in range(3):
        bat.submit(_soup((16, 16), i), 3)
    bat.submit(np.zeros((16, 16), np.float32), 2, workload="heat")
    bat.flush()
    spans = [r["attrs"] for r in _records(sink)
             if r["name"] == "serve.batch"]
    assert [(s["requests"], s["padded"], s["workload"]) for s in spans] == [
        (3, 4, "life"), (1, 1, "heat")]
    assert spans[1]["path"] == "stencil:heat" and spans[0]["shape"] == "16x16"


@pytest.mark.parametrize("impl", ["roll", "halo"])
def test_lifesim_retraces_equal_jax(impl):
    """Each advance ticks once per step count it is first run at: a run of
    segments 4, 4 and 3 ticks twice in both packages."""
    board = _soup((32, 32), 4)
    cfg = config_from_board(board, steps=11, save_steps=4)
    sim = LifeSim(cfg, layout="row", impl=impl, device="cpu",
                  mesh=mesh_lib.make_mesh_1d(4, device="cpu"))
    jsim = JaxSim(_jax_config(cfg), layout="row", impl=impl,
                  mesh=jmesh.make_mesh_1d(4))
    for s in (sim, jsim):
        s.step(4)
        s.step(4)
        s.step(3)
    fn = f"life_advance_{impl}"
    assert metrics.get("jit.retrace", fn=fn) == jmetrics.get(
        "jit.retrace", fn=fn) == 2


def test_halo_notes_once_per_geometry():
    """The halo schedule ticks when its plan is built and each exchange
    once per geometry: a longer run adds nothing."""
    haloplan._plan.cache_clear()
    halo._EXCHANGES.clear()
    board = _soup((32, 32), 6)
    counts = []
    for steps in (4, 40):
        cfg = config_from_board(board, steps=steps, save_steps=0)
        LifeSim(cfg, layout="cart", impl="halo", device="cpu",
                mesh=mesh_lib.make_mesh_2d(2, 2, device="cpu")).run()
        counts.append({k: v for k, v in metrics.snapshot()[
            "counters"].items() if k.startswith("halo.")})
    assert counts[0] == counts[1]
    c = counts[0]
    assert c["halo.schedule.traced{engine=overlap:deferred,layout=cart}"] == 1
    assert c["halo.exchange.traced{axis=x,kind=x}"] == 1
    assert c["halo.exchange.traced{axis=y,kind=y-overlap}"] == 1


def test_run_sharded_span(sink):
    from mpi_and_open_mp_tpu_torch import stencils

    mesh = mesh_lib.make_mesh_1d(4, device="cpu")
    stencils.run_sharded(stencils.get("heat"), np.zeros((32, 32),
                                                        np.float32),
                         3, mesh=mesh, layout="row")
    (rec,) = _records(sink)
    assert rec["name"] in ("halo.overlap", "halo.seq")
    assert rec["attrs"]["workload"] == "heat" and rec["attrs"]["steps"] == 3


# ----------------------------------------------------------------- reports


def _ring_trace(path, monkeypatch):
    """A trace of two traced rings at two sizes (so the hop fit is
    identifiable), a checkpoint, a recovery and a metrics snapshot."""
    monkeypatch.setenv("MOMP_TRACE", str(path))
    for n in (256, 1024):
        q, k, v = _tensors(*_qkv(n, 2, n, 16))
        cx.ring_attention(q, k, v, devices=4, causal=True, device="cpu")
    checkpoint.save(path.parent / "c.state", _soup((8, 8), 0), 1)
    with trace.span("halo.seq", engine="seq:halo"):
        guards.record_recovery("life_step:halo:recovered")
    metrics.inc("jit.retrace", fn="sharded_attention")
    trace.event("metrics", snapshot=metrics.snapshot())
    trace.event("halo.ab", transfer_s=0.5, exposed_s=0.25, efficiency=0.5)
    trace.reset()
    monkeypatch.delenv("MOMP_TRACE")


def test_jax_report_reads_a_port_trace(tmp_path, monkeypatch):
    path = tmp_path / "trace.jsonl"
    _ring_trace(path, monkeypatch)
    mine = report.report_dict(report.load(str(path)))
    theirs = jreport.report_dict(jreport.load(str(path)))
    fit, jfit = (r["attention"].pop("hop_fit") for r in (mine, theirs))
    assert mine == theirs
    assert fit.keys() == jfit.keys() and fit["identifiable"] == jfit[
        "identifiable"]
    for key in ("alpha_us", "bandwidth_mb_s", "r2"):
        assert fit[key] == pytest.approx(jfit[key], rel=1e-9)
    assert mine["attention"]["traced_steps"] == 2
    assert mine["attention"]["hop_spans_per_step"] == 6.0
    assert mine["recoveries"]["total"] == 1
    assert mine["retraces"] == {"sharded_attention": 1}
    assert mine["halo"]["seq_spans"] == 1 and mine["halo"]["ab"]
    recs = report.load(str(path))
    assert report.to_chrome(recs) == jreport.to_chrome(recs)
    mine["attention"]["hop_fit"] = fit
    theirs["attention"]["hop_fit"] = jfit
    assert report.render(mine).splitlines()[:3] == jreport.render(
        theirs).splitlines()[:3]


def test_report_load_rejects_malformed_lines(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text('{"header": 1}\n{"kind": "span", "name": "a"}\n[1]\n')
    with pytest.raises(ValueError, match=":3: not a JSON object"):
        report.load(str(path))
    path.write_text('{"header": 1}\n\n')
    assert report.load(str(path)) == jreport.load(str(path)) == []


# --------------------------------------------------------------------- CLI


def test_life_cli_trace_and_profile(tmp_path, capsys):
    trace_path = tmp_path / "t" / "life.jsonl"
    prof = tmp_path / "prof"
    argv = [GLIDER, "--layout", "row", "--devices", "2",
            "--virtual-devices", "2", "--impl", "halo", "--device", "cpu",
            "--trace", str(trace_path), "--profile", str(prof),
            "--print-final-population"]
    try:
        assert life_app.main(argv) == 0
    finally:
        os.environ.pop("MOMP_TRACE", None)
        trace.reset()
    out = capsys.readouterr()
    assert out.err.strip().splitlines()[-1] == "5"
    recs = report.load(str(trace_path))
    assert [r["name"] for r in recs] == ["life.advance", "life.run"]
    assert recs[0]["parent"] == recs[1]["id"]
    assert recs[1]["attrs"] == {"cfg": "glider_10x10.cfg", "steps": 100,
                                "impl": "halo", "layout": "row"}
    rep = jreport.report_dict(jreport.load(str(trace_path)))
    assert rep["phases"]["by_name"]["life.run"]["share"] == 1.0
    with open(prof / life_app.PROFILE_FILE) as fd:
        chrome = json.load(fd)
    assert chrome["traceEvents"]


def test_life_cli_trace_segments_and_checkpoints(tmp_path):
    trace_path = tmp_path / "life.jsonl"
    argv = [GLIDER, "--layout", "serial", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "40", "--trace", str(trace_path)]
    try:
        assert life_app.main(argv) == 0
    finally:
        os.environ.pop("MOMP_TRACE", None)
        trace.reset()
    # Stops at the cadence (25) and every 40 steps: 25, 40, 50, 75, 80,
    # 100, with a checkpoint at the start of each segment.
    names = [r["name"] for r in report.load(str(trace_path))]
    assert names.count("life.segment") == 6
    assert names.count("checkpoint.save") == 6 and names[-1] == "life.run"
    assert metrics.get("checkpoint.saves") == 6
