"""The port's ``tune`` (candidate space, runner, plan store) and its planned
dispatch, held against the JAX package's on the CPU.

The candidate lists equal the JAX package's under the port's path names
(``plain`` for ``xla``, ``stencil:native`` for ``stencil:pallas``); the
plan envelope and digest are byte-compatible both ways; and the JAX
package's ``test_tune.py`` cases run again on the port: the heuristic
first, ``vs_heuristic >= 1.0``, the plan beside its launch record, a second
process installing it, corrupt, stale, foreign and parity-failing plans
quarantined and never installed, the dispatch taking an installed plan
only where it is legal, and the ``MOMP_TUNE=0`` kill switch. Small sizes
(boards up to 64^2, stacks up to 32, ``steps=16``), one torch thread.
"""

import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi_and_open_mp_tpu.ops import pallas_life as jpl
from mpi_and_open_mp_tpu.parallel import mesh as jmesh
from mpi_and_open_mp_tpu.serve import aotcache as jaot
from mpi_and_open_mp_tpu.tune import plans as jplans
from mpi_and_open_mp_tpu.tune import space as jspace

from mpi_and_open_mp_tpu_torch.obs import report, trace
from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
from mpi_and_open_mp_tpu_torch.ops import native_life as tnl
from mpi_and_open_mp_tpu_torch.parallel import mesh as tmesh
from mpi_and_open_mp_tpu_torch.serve import aotcache as taot
from mpi_and_open_mp_tpu_torch.tune import (
    PlanError, PlanStore, fingerprint_for, load_plan, save_plan, space, tune,
    tune_sharded)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The JAX package's path names, in the port's vocabulary.
TO_PORT = {"xla": "plain", "stencil:pallas": "stencil:native"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch operations a timed bracket: one thread keeps the
    module from spinning the pool beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_plan_tables():
    """Every test starts and ends with no plan installed in either
    package: a leaked plan would reroute later dispatches."""
    tnl.clear_planned_paths()
    jpl.clear_planned_paths()
    yield
    tnl.clear_planned_paths()
    jpl.clear_planned_paths()


def _store(path):
    return PlanStore(path, device="cpu")


def _tune(shape=(8, 16, 16), workload="life", store=None):
    return tune(workload, shape, steps=16, store=store, device="cpu")


# -- the candidate space against the JAX package's --------------------------


@pytest.mark.parametrize("shape", [(1, 16, 16), (8, 64, 64), (32, 20, 24)])
def test_life_candidates_equal_jax(shape):
    """Same paths in the same order (the heuristic's first), same pack
    layouts, bucket roundings and axis orders, ``xla`` read as ``plain``."""
    want = jspace.candidates("life", shape, on_tpu=False)
    got = space.candidates("life", shape, on_card=False)
    assert [c.path for c in got] == [TO_PORT.get(c.path, c.path)
                                     for c in want]
    assert ([(c.pack_layout, c.bucket_rounding, c.axis_order) for c in got]
            == [(c.pack_layout, c.bucket_rounding, c.axis_order)
                for c in want])
    assert space.heuristic_path("life", shape, False) == TO_PORT.get(
        jspace.heuristic_path("life", shape, False),
        jspace.heuristic_path("life", shape, False))
    assert got[0].path == space.heuristic_path("life", shape, False)


@pytest.mark.parametrize("workload,shape", [
    ("heat", (2, 16, 16)), ("wireworld", (2, 16, 16)),
    ("lenia", (2, 16, 16)), ("gray_scott", (2, 2, 16, 16))])
def test_stencil_candidates_equal_jax(workload, shape):
    want = [TO_PORT.get(c.path, c.path)
            for c in jspace.candidates(workload, shape)]
    got = [c.path for c in space.candidates(workload, shape, on_card=False)]
    assert got == want
    assert all(space.pack_layout_for(p) == "-" for p in got)


def test_life_candidates_on_the_card_are_kernel_paths():
    """On the card every candidate is a kernel path: never the plain loop
    (the gates are pure functions of the shape, so no card is needed)."""
    assert [c.path for c in space.candidates("life", (64, 500, 500))] == [
        "bitsliced", "vmem-grid", "frame"]
    assert [c.path for c in space.candidates("life", (4, 500, 500))] == [
        "vmem-grid", "bitsliced", "frame"]
    assert [c.path for c in space.candidates("life", (2, 1024, 1024))] == [
        "fused", "frame"]
    with tnl._bitslice_pinned(False):
        assert "bitsliced" not in space.life_paths((64, 500, 500), True)


def _tuples(cands):
    return [(c.path, c.axis_order, c.halo_overlap, c.fuse_steps,
             c.boundary_steps) for c in cands]


@pytest.mark.parametrize("workload", ["life", "heat"])
@pytest.mark.parametrize("axes", [(4, 2), (8, 1)], ids=["4x2", "8x1"])
def test_sharded_candidates_equal_jax(workload, axes):
    """The port's 8 virtual shards against the JAX package's 8-device CPU
    mesh: equal (path, layout, schedule, fuse, boundary) tuples."""
    want = jspace.sharded_candidates(workload, (64, 64),
                                     jmesh.make_mesh_2d(*axes))
    got = space.sharded_candidates(workload, (64, 64),
                                   tmesh.make_mesh_2d(*axes, device="cpu"))
    assert _tuples(got) == _tuples(want) and got


def test_sharded_candidates_gates():
    mesh = tmesh.make_mesh_2d(4, 2, device="cpu")
    by = {(c.axis_order, c.halo_overlap)
          for c in space.sharded_candidates("life", (48, 48), mesh)}
    assert by == {(lo, s) for lo in ("row", "col", "cart")
                  for s in ("overlap", "seq")}
    rows = {c.halo_overlap for c in space.sharded_candidates(
        "life", (8, 48), mesh) if c.axis_order == "row"}
    assert rows == {"seq"}
    assert space.sharded_candidates(
        "life", (48, 48), tmesh.make_mesh_1d(1, device="cpu")) == []


def test_sharded_fuse_depths_env_override(monkeypatch):
    for raw, want in ((None, (1, 2)), ("4", (1, 4)), ("8,2,2", (1, 2, 8))):
        if raw is None:
            monkeypatch.delenv("MOMP_TUNE_FUSE_DEPTHS", raising=False)
        else:
            monkeypatch.setenv("MOMP_TUNE_FUSE_DEPTHS", raw)
        assert space.sharded_fuse_depths() == jspace.sharded_fuse_depths() \
            == want
    assert space._boundary_depths(4) == jspace._boundary_depths(4) \
        == (4, 2, 1)
    assert space.sparse_fuse_depths(8, 64) == jspace.sparse_fuse_depths(
        8, 64)


def test_runner_for_paths():
    """An unknown path raises; ``stencil:pallas`` is ``stencil:native``."""
    with pytest.raises(ValueError, match="unknown"):
        space.runner_for("life", "warp-drive")
    for foreign in ("xla", "vmem"):
        with pytest.raises(ValueError, match="unknown"):
            space.runner_for("life", foreign)
    with pytest.raises(ValueError, match="unknown"):
        space.runner_for("heat", "stencil:warp")
    stack = torch.from_numpy(np.random.default_rng(1).random(
        (2, 12, 12)).astype(np.float32))
    assert torch.equal(space.runner_for("heat", "stencil:pallas")(stack, 3),
                       space.runner_for("heat", "stencil:native")(stack, 3))
    with pytest.raises(ValueError, match="unknown"):
        tnl.run_path_batch("xla", torch.zeros((1, 8, 8), dtype=torch.uint8),
                           1)


# -- framing and keys --------------------------------------------------------


def _record(key, shape=(8, 16, 16), path="plain"):
    return {"schema": "momp-plan/1", "key": key,
            "choice": {"workload": "life", "shape": list(shape),
                       "dtype": "uint8", "path": path,
                       "pack_layout": "cell-packed",
                       "bucket_rounding": "pow2", "axis_order": "row"},
            "vs_heuristic": 1.25}


def test_plan_bytes_and_digest_equal_jax(tmp_path):
    """One record dict framed by either package gives the same bytes; each
    package reads the other's file; one key dict gives one digest."""
    key = fingerprint_for("life", (8, 16, 16), np.uint8, "plain",
                          device="cpu")
    rec = _record(key)
    save_plan(str(tmp_path / "port.plan"), rec)
    jplans.save_plan(str(tmp_path / "jax.plan"), rec)
    assert (tmp_path / "port.plan").read_bytes() == (
        tmp_path / "jax.plan").read_bytes()
    assert jplans.load_plan(str(tmp_path / "port.plan")) == rec
    assert load_plan(str(tmp_path / "jax.plan")) == rec
    assert taot.digest_for(key) == jaot.digest_for(key)
    jkey = jplans.fingerprint_for("life", (8, 16, 16), np.uint8, "xla")
    assert taot.digest_for(jkey) == jaot.digest_for(jkey)
    assert jplans.PLAN_MAGIC == b"MOMP-PLAN/1\n" and taot.AOT_MAGIC == (
        jaot.AOT_MAGIC)


def test_jax_written_plan_is_stale_here(tmp_path, monkeypatch):
    """A plan the JAX package wrote loads in the port (the envelope is
    shared) and ``install`` quarantines it ``stale``: its key names
    ``jax``. Nothing is installed."""
    shape = (8, 16, 16)
    jkey = jplans.fingerprint_for("life", shape, np.uint8, "xla")
    jstore = jplans.PlanStore(tmp_path)
    plan_file = jstore.save(_record(jkey, path="xla"))
    assert load_plan(plan_file)["key"] == jkey
    sink = tmp_path / "trace.jsonl"
    monkeypatch.setenv("MOMP_TRACE", str(sink))
    trace.reset()
    try:
        summary = _store(tmp_path).install()
    finally:
        monkeypatch.delenv("MOMP_TRACE")
        trace.reset()
    assert summary["stale"] == 1 and summary["installed"] == 0
    assert glob.glob(plan_file + ".stale.*") and not os.path.exists(
        plan_file)
    (event,) = [r for r in report.load(str(sink))
                if r["name"] == "tune.plan"]
    assert event["attrs"]["status"] == "stale"
    assert "'jax'" in event["attrs"]["error"]
    assert tnl.planned_path("life", shape) is None


# -- the measured pass and the store ----------------------------------------


def test_tune_vs_heuristic_floor_and_colocation(tmp_path):
    store = _store(tmp_path)
    res = _tune(store=store)
    assert res["rejected"] == []
    assert res["vs_heuristic"] >= 1.0
    assert res["measurements"][0]["path"] == res["heuristic_path"] == (
        "bitsliced")
    assert {m["path"] for m in res["measurements"]} == {"bitsliced",
                                                        "plain"}
    assert tnl.planned_path("life", (8, 16, 16)) == res["tuned"]["path"]
    digest = res["digest"]
    assert os.path.exists(tmp_path / (digest + ".plan"))
    assert os.path.exists(tmp_path / (digest + ".aot"))
    assert res["aot_export"] == "miss"
    rec = load_plan(res["plan_file"])
    assert taot.digest_for(rec["key"]) == digest
    assert rec["choice"]["path"] == res["tuned"]["path"]
    assert jplans.load_plan(res["plan_file"]) == rec  # JAX reads it too


def test_tune_stencil_races_roll_and_kernel(tmp_path):
    res = _tune((2, 16, 16), "heat", _store(tmp_path))
    assert res["rejected"] == [] and res["vs_heuristic"] >= 1.0
    assert [m["path"] for m in res["measurements"]] == [
        "stencil:roll", "stencil:native"]
    assert "aot_export" not in res
    tnl.clear_planned_paths()
    summary = _store(tmp_path).install()
    assert summary["installed"] == 1
    assert tnl.planned_path("heat", (2, 16, 16)) == res["tuned"]["path"]


def test_second_process_installs_plan(tmp_path):
    """A fresh process validates, parity-gates (on the co-located launch
    record) and installs the plan, and its dispatch takes it."""
    res = _tune((4, 16, 16), store=_store(tmp_path))
    code = (
        "import json, sys\n"
        "from mpi_and_open_mp_tpu_torch.ops import native_life as nl\n"
        "from mpi_and_open_mp_tpu_torch.tune import PlanStore\n"
        f"s = PlanStore({str(tmp_path)!r}, device='cpu').install()\n"
        "s['path'] = nl.native_path_batch((4, 16, 16), on_card=False)\n"
        "print(json.dumps(s))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)
    assert summary["installed"] == summary["scanned"] == 1
    assert summary["corrupt"] == summary["stale"] == 0
    assert summary["parity_rejected"] == 0
    assert summary["path"] == res["tuned"]["path"]


def _only_plan(tmp_path):
    (plan_file,) = glob.glob(str(tmp_path / "*.plan"))
    return plan_file


def test_corrupt_plan_quarantined_ladder_unchanged(tmp_path):
    _tune(store=_store(tmp_path))
    tnl.clear_planned_paths()
    plan_file = _only_plan(tmp_path)
    size = os.path.getsize(plan_file)
    with open(plan_file, "r+b") as fd:
        fd.seek(size // 2)
        byte = fd.read(1)
        fd.seek(size // 2)
        fd.write(bytes([byte[0] ^ 0xFF]))
    summary = _store(tmp_path).install()
    assert summary["corrupt"] == 1 and summary["installed"] == 0
    assert glob.glob(plan_file + ".corrupt.*")
    assert not os.path.exists(plan_file)
    assert tnl.planned_path("life", (8, 16, 16)) is None
    assert tnl.native_path_batch((8, 16, 16), on_card=False) == "bitsliced"


def test_stale_plan_quarantined_on_fingerprint_drift(tmp_path):
    _tune(store=_store(tmp_path))
    tnl.clear_planned_paths()
    plan_file = _only_plan(tmp_path)
    rec = load_plan(plan_file)
    save_plan(plan_file, dict(rec, key=dict(rec["key"], torch="0.0.0")))
    summary = _store(tmp_path).install()
    assert summary["stale"] == 1 and summary["installed"] == 0
    assert glob.glob(plan_file + ".stale.*")
    assert tnl.planned_path("life", (8, 16, 16)) is None


def test_bad_schema_is_stale_missing_choice_is_corrupt(tmp_path):
    p = str(tmp_path / "x.plan")
    save_plan(p, {"schema": "momp-plan/0", "key": {}, "choice": {}})
    with pytest.raises(PlanError, match="schema") as ei:
        load_plan(p)
    assert ei.value.kind == "stale"
    save_plan(p, {"schema": "momp-plan/1", "key": {}})
    with pytest.raises(PlanError, match="key/choice") as ei:
        load_plan(p)
    assert ei.value.kind == "corrupt"
    with open(p, "wb") as fd:
        fd.write(b"MOMP-PLAN/1\n\x00")
    with pytest.raises(PlanError, match="truncated") as ei:
        load_plan(p)
    assert ei.value.kind == "corrupt"
    summary = _store(tmp_path).install()
    assert summary["corrupt"] == 1 and summary["installed"] == 0


def test_parity_failing_plan_rejected_never_installed(tmp_path, monkeypatch):
    """A CRC-valid plan whose engine computes the wrong function (here the
    plain loop replaced by the identity) fails the install-time oracle
    gate: quarantined as ``parity``, never installed, whatever it claims to
    win."""
    shape = (1, 12, 12)
    key = fingerprint_for("life", shape, np.uint8, "plain", device="cpu")
    store = _store(tmp_path)
    plan_file = store.save(_record(key, shape, "plain"))
    monkeypatch.setattr(tb, "life_run_bits_plain_batch",
                        lambda boards, n: boards)
    summary = _store(tmp_path).install()
    assert summary["parity_rejected"] == 1 and summary["installed"] == 0
    assert glob.glob(plan_file + ".parity.*")
    assert tnl.planned_path("life", shape) is None


def test_stale_launch_record_falls_back_to_the_live_engine(tmp_path):
    """A co-located launch record that no longer derives (its geometry
    edited) is quarantined ``stale`` at install; the plan is gated on the
    live engine instead, and installed."""
    res = _tune(store=_store(tmp_path))
    tnl.clear_planned_paths()
    aot = str(tmp_path / (res["digest"] + ".aot"))
    rec = load_plan(res["plan_file"])
    blob = json.dumps({"path": res["tuned"]["path"],
                       "geometry": {"bands": 99}, "libraries": {}})
    taot.save_artifact(aot, rec["key"], blob.encode())
    summary = _store(tmp_path).install()
    assert summary["installed"] == 1 and summary["parity_rejected"] == 0
    assert glob.glob(aot + ".stale.*") and not os.path.exists(aot)


# -- the dispatch ------------------------------------------------------------


def test_native_path_batch_consults_installed_plan(monkeypatch):
    """A plan may override the BITSLICE_MIN_BATCH line (B = 4 routes
    bitsliced when planned) but no gate (``allow_bitsliced=False``), and
    ``MOMP_TUNE=0`` restores the ladder without uninstalling anything: the
    JAX package's case, step for step, beside it."""
    shape = (4, 64, 64)
    for nl, kw, ladder in ((tnl, {"on_card": False}, "plain"),
                           (jpl, {"on_tpu": False}, "xla")):
        assert nl.native_path_batch(shape, **kw) == ladder
        nl.install_planned_path("life", shape, "bitsliced")
        assert nl.native_path_batch(shape, **kw) == "bitsliced"
        assert nl.native_path_batch(shape, allow_bitsliced=False,
                                    **kw) == ladder
        monkeypatch.setenv("MOMP_TUNE", "0")
        assert nl.native_path_batch(shape, **kw) == ladder
        assert nl.planned_path("life", shape) is None
        monkeypatch.delenv("MOMP_TUNE")
        assert nl.native_path_batch(shape, **kw) == "bitsliced"
        nl.clear_planned_paths()
        assert nl.native_path_batch(shape, **kw) == ladder


@pytest.mark.parametrize("plan,on_card,legal", [
    ("vmem-grid", False, False),   # a kernel path off the card
    ("frame", False, False),
    ("xla", False, False),         # the JAX package's names, anywhere
    ("xla", True, False),
    ("vmem", True, False),
    ("plain", True, False),        # never the plain loop on the card
    ("plain", False, True),
    ("vmem-grid", True, True),
    ("frame", True, True),
    ("fused", True, False),        # 500 rows are not word-aligned
])
@pytest.mark.parametrize("b", [4, 64])
def test_illegal_plans_are_ignored(plan, on_card, legal, b):
    shape = (b, 500, 500)
    ladder = tnl.native_path_batch(shape, on_card=on_card)
    tnl.install_planned_path("life", shape, plan)
    assert tnl.native_path_batch(shape, on_card=on_card) == (
        plan if legal else ladder)
    assert tnl.planned_path("life", shape) == plan


def test_batch_stays_on_the_ladder_without_plans():
    """The ladder under the plan is unchanged: BITSLICE_MIN_BATCH = 8."""
    assert tnl.BITSLICE_MIN_BATCH == 8
    assert tnl.native_path_batch((7, 500, 500)) == "vmem-grid"
    assert tnl.native_path_batch((8, 500, 500)) == "bitsliced"


def test_planned_pinned_and_family_pin(monkeypatch):
    shape = (2, 16, 16)
    tnl.install_planned_path("life", shape, "bitsliced")
    with tnl._planned_pinned("life", shape, None):
        assert tnl.planned_path("life", shape) is None
        assert space.heuristic_path("life", shape, False) == "plain"
    assert tnl.planned_path("life", shape) == "bitsliced"
    tnl.install_planned_path("lenia", shape, "stencil:sep")
    jpl.install_planned_path("lenia", shape, "stencil:sep")
    monkeypatch.setenv("MOMP_ENGINE_FAMILY", "fft")
    assert tnl.planned_path("lenia", shape) is None
    assert jpl.planned_path("lenia", shape) is None
    monkeypatch.setenv("MOMP_ENGINE_FAMILY", "sep")
    assert tnl.planned_path("lenia", shape) == "stencil:sep"


def test_kill_switch_short_circuits_install(tmp_path, monkeypatch):
    _tune(store=_store(tmp_path))
    tnl.clear_planned_paths()
    monkeypatch.setenv("MOMP_TUNE", "0")
    summary = _store(tmp_path).install()
    assert summary == {"scanned": 0, "installed": 0, "corrupt": 0,
                       "stale": 0, "parity_rejected": 0,
                       "disabled": True, "plans": []}
    assert glob.glob(str(tmp_path / "*.plan"))  # the store untouched


# -- the sharded pass --------------------------------------------------------


def test_tune_sharded_seq_baseline_and_store_roundtrip(tmp_path):
    """On 4 x 2 virtual shards: the sequential schedule opens the race,
    the coupled-depth heuristic is in it (``vs_heuristic >= 1.0``), and a
    fresh store installs the record after its sharded parity gate."""
    mesh = tmesh.make_mesh_2d(4, 2, device="cpu")
    res = tune_sharded("life", (64, 64), mesh=mesh, steps=16,
                       store=_store(tmp_path))
    assert res["rejected"] == []
    assert res["baseline"]["halo_overlap"] == "seq"
    assert res["vs_sequential"] > 0 and res["vs_heuristic"] >= 1.0
    assert res["heuristic"]["halo_overlap"] == "overlap"
    assert res["heuristic"]["fuse_steps"] == 1
    assert len(res["measurements"]) == len(
        space.sharded_candidates("life", (64, 64), mesh))
    # A batched plan for one board of the same shape keys apart
    # (program="sharded"): both records survive in one store.
    single = _tune((1, 64, 64), store=_store(tmp_path))
    assert single["digest"] != res["digest"]
    fresh = _store(tmp_path)
    summary = fresh.install()
    assert summary["installed"] == 2 and summary["parity_rejected"] == 0
    hit = fresh.lookup_sharded("life", (64, 64))
    assert hit["choice"]["path"].startswith("sharded:")
    assert fresh.lookup("life", (1, 64, 64))["choice"]["path"] == (
        single["tuned"]["path"])
    assert {"fuse_steps", "boundary_steps"} <= set(hit["choice"])
    with pytest.raises(RuntimeError, match="no legal sharded candidate"):
        tune_sharded("life", (64, 64),
                     mesh=tmesh.make_mesh_1d(1, device="cpu"), steps=16)


# -- the CLI -----------------------------------------------------------------


def _status_line(err: str) -> dict:
    lines = [ln for ln in err.splitlines() if ln.startswith("{")]
    assert lines, f"no JSON status line on stderr: {err!r}"
    return json.loads(lines[-1])


def _run_cli(main, argv) -> tuple[int, str]:
    """``main(argv)`` in this process: (exit code, stderr)."""
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, err.getvalue()


def _resume_status(main, tmp_path, board, plans, extra):
    from mpi_and_open_mp_tpu.utils.config import (
        config_from_board, save_config)

    cfg = config_from_board(board, steps=20, save_steps=5)
    tmp_path.mkdir()
    cfg_path = tmp_path / "run.cfg"
    save_config(cfg_path, cfg)
    out = tmp_path / "vtk"
    base = [str(cfg_path), "--layout", "row", "--outdir", str(out), *extra]
    assert _run_cli(main, base)[0] == 0
    argv = base + ["--resume"] + (["--plans", str(plans)] if plans else [])
    rc, err = _run_cli(main, argv)
    assert rc == 0, err
    assert "resuming from" in err
    return _status_line(err)


def test_resume_consumes_installed_plans(tmp_path, make_board):
    """The JAX package's ``test_resume_consumes_installed_plans`` on both
    CLIs: a resumed run with a populated store installs the records before
    the first dispatch and stamps ``plan_source=store``; without a store,
    ``heuristic``. The status lines are equal apart from ``tuned_path``'s
    vocabulary."""
    from mpi_and_open_mp_tpu.apps import life as jlife
    from mpi_and_open_mp_tpu.tune import tune as jtune
    from mpi_and_open_mp_tpu_torch.apps import life as tlife

    board = make_board(16, 16)
    jtune("life", (1, 16, 16), steps=16,
          store=jplans.PlanStore(tmp_path / "jplans"))
    _tune((1, 16, 16), store=_store(tmp_path / "tplans"))
    jstat = _resume_status(jlife.main, tmp_path / "j", board,
                           tmp_path / "jplans", [])
    tstat = _resume_status(tlife.main, tmp_path / "t", board,
                           tmp_path / "tplans", ["--device", "cpu"])
    assert tstat["plans_installed"] >= 1 and tstat["plan_source"] == "store"
    assert tstat["tuned_path"] in ("plain", "bitsliced")
    assert TO_PORT.get(jstat["tuned_path"], jstat["tuned_path"]) in (
        "plain", "bitsliced")
    assert ({k: v for k, v in tstat.items() if k != "tuned_path"}
            == {k: v for k, v in jstat.items() if k != "tuned_path"})
    assert set(tstat) == set(jstat)
    tnl.clear_planned_paths()
    jpl.clear_planned_paths()
    jbare = _resume_status(jlife.main, tmp_path / "j2", board, None, [])
    tbare = _resume_status(tlife.main, tmp_path / "t2", board, None,
                           ["--device", "cpu"])
    assert tbare == jbare and tbare["plan_source"] == "heuristic"
    assert "plans_installed" not in tbare
