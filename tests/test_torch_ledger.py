"""``obs/ledger.py`` of the port against the JAX package's, and the Life
launcher's ``times.txt``.

The ledger is byte-compatible: the same record through both packages'
``stamp`` gives equal entries, both ``append``s write identical bytes,
each package's ``load``, ``config_key`` and ``query`` read the other's
file, and both refuse the same malformed lines with the same messages.
The JAX package's ``analysis/regression_sentinel.py``, run unchanged on a
ledger the port wrote, gives the verdicts it gives on the JAX package's
own. ``launchers/run_life_torch.sh`` appends one bare-seconds line a run,
which ``analysis/plot_life.py`` reads unchanged.
"""

import json
import os
import subprocess
import sys

import pytest

from mpi_and_open_mp_tpu.obs import ledger as jledger
from mpi_and_open_mp_tpu_torch.obs import ledger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "analysis"))

import plot_life  # noqa: E402
import regression_sentinel  # noqa: E402

GLIDER = os.path.join(ROOT, "tests", "fixtures", "glider_10x10.cfg")


def _record(value=100.0, **extra):
    rec = {"metric": "life_steady_cups_p46gun_big", "value": value,
           "unit": "cell_updates_per_sec", "board": [500, 500],
           "steps": 10_000, "dtype": "uint8", "backend": "gpu",
           "impl": "vmem"}
    rec.update(extra)
    return rec


STAMPS = {
    "flagship-gpu": (_record(1.2e12), dict(
        platform="gpu", device_kind="NVIDIA H100 80GB HBM3",
        device_count=1)),
    "batched": (_record(3.4e12, batch=64, batch_pack_layout="bitsliced",
                        plan_source="store", impl="batch:bitsliced"),
                dict(platform="gpu", device_kind="NVIDIA H100 80GB HBM3",
                     device_count=1)),
    "stencil-sharded": (_record(2.0e11, workload="heat",
                                sharded_halo="overlap:rdma",
                                sparse_sharded_engine="sparse-sharded:t64",
                                engine_family="offset", board=[2048, 2048]),
                        dict(platform="gpu", device_kind="NVIDIA H100",
                             device_count=4)),
    "cpu-fallback": (_record(1.0e8, fallback_reason="no card"),
                     dict(platform="cpu", device_kind="cpu",
                          device_count=1)),
    "from-the-record": ({"metric": "m", "backend": "tpu", "impl": "roll",
                         "board": [3, "x"]}, {}),
    "bare": ({}, dict(device_count=0)),
}


@pytest.mark.parametrize("case", list(STAMPS))
def test_stamp_equals_jax(case):
    record, kw = STAMPS[case]
    args = dict(kw, source="chip_smoke.py", ts=1234.5, sha="feedcafe")
    assert ledger.stamp(record, **args) == jledger.stamp(record, **args)


def test_names_and_schema_are_the_jax_packages():
    assert ledger.KEY_FIELDS == jledger.KEY_FIELDS
    assert ledger._KEY_DEFAULTS == jledger._KEY_DEFAULTS
    assert ledger.ENV == jledger.ENV
    entry = ledger.stamp(_record(), ts=1.0, sha="s")
    assert entry["schema"] == "momp-ledger/1"


def _entries(mod):
    return [mod.stamp(record, source="chip_smoke.py", ts=float(i),
                      sha="feedcafe", **kw)
            for i, (record, kw) in enumerate(STAMPS.values())]


def test_appends_write_identical_bytes_and_read_across(tmp_path):
    mine = str(tmp_path / "port" / "ledger.jsonl")  # parent dirs made
    theirs = str(tmp_path / "jax" / "ledger.jsonl")
    for e in _entries(ledger):
        ledger.append(e, mine)
    for e in _entries(jledger):
        jledger.append(e, theirs)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for reader in (ledger, jledger):
        for path in (mine, theirs):
            got = reader.load(path)
            assert got == json.loads(json.dumps(_entries(jledger)))
            for fields in (reader.KEY_FIELDS, ("shape", "dtype"),
                           ("metric", "workload", "engine_family")):
                assert ([ledger.config_key(e, fields) for e in got]
                        == [jledger.config_key(e, fields) for e in got])
            for where in ({"topology": "gpu:1"}, {"engine": "vmem"},
                          {"workload": "heat", "shape": "2048x2048"},
                          {"metric": "nope"}):
                assert (ledger.query(got, **where)
                        == jledger.query(got, **where))
    assert len(ledger.query(ledger.load(theirs), topology="gpu:1")) == 2


@pytest.mark.parametrize("line", [
    "not json {", '{"no_record": true}', "[1, 2]", '"a string"',
    '{"schema": "momp-ledger/1", "record"'],
    ids=["junk", "no-record", "list", "string", "truncated"])
def test_load_refuses_malformed_lines_alike(tmp_path, line):
    path = tmp_path / "bad.jsonl"
    good = json.dumps(ledger.stamp(_record(), ts=1.0, sha="s"))
    path.write_text(good + "\n\n" + line + "\n")
    with pytest.raises(ValueError) as jerr:
        jledger.load(str(path))
    with pytest.raises(ValueError, match="bad.jsonl:3") as err:
        ledger.load(str(path))
    assert str(err.value) == str(jerr.value)


def test_git_sha_outside_a_repo_and_in_it(tmp_path, monkeypatch):
    monkeypatch.setattr(ledger, "_GIT_SHA", None)
    assert ledger.git_sha(cwd=str(tmp_path)) == "unknown"
    # Both resolve the repository's root from their own file.
    monkeypatch.setattr(ledger, "_GIT_SHA", None)
    monkeypatch.setattr(jledger, "_GIT_SHA", None)
    assert ledger.git_sha() == jledger.git_sha()


def test_ledger_path_reads_the_env(monkeypatch):
    monkeypatch.delenv("MOMP_LEDGER", raising=False)
    assert ledger.ledger_path("d.jsonl") == "d.jsonl"
    monkeypatch.setenv("MOMP_LEDGER", "/x/l.jsonl")
    assert ledger.ledger_path("d.jsonl") == jledger.ledger_path() == (
        "/x/l.jsonl")


# The sentinel's cases: (records stamped in order, each with its platform;
# the exit code and verdict it must give).
def _gpu(value, **extra):
    return (_record(value, **extra), "gpu")


SENTINEL_CASES = {
    "identical-runs": ([_gpu(100.0) for _ in range(4)], 0, "pass"),
    "cups-drop": ([_gpu(100.0) for _ in range(5)] + [_gpu(80.0)], 1,
                  "fail"),
    "within-noise": ([_gpu(100.0) for _ in range(3)] + [_gpu(95.0)], 0,
                     "pass"),
    "gpu-to-cpu": ([_gpu(100.0) for _ in range(3)]
                   + [(_record(100.0, backend="cpu",
                               fallback_reason="no card"), "cpu")], 1,
                   "fail"),
    "first-run": ([_gpu(1.0, board=[64, 64], steps=100), _gpu(100.0)], 0,
                  "no-baseline"),
}


def _sentinel(mod, path, cases, capsys, *argv):
    for i, (record, platform) in enumerate(cases):
        mod.append(mod.stamp(record, source="chip_smoke.py",
                             platform=platform,
                             device_kind="NVIDIA H100 80GB HBM3",
                             device_count=1, ts=float(i), sha="feedcafe"),
                   path)
    capsys.readouterr()
    rc = regression_sentinel.main([path, *argv])
    return rc, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("case", list(SENTINEL_CASES))
def test_sentinel_judges_a_port_ledger_as_the_jax_packages(case, tmp_path,
                                                           capsys):
    cases, want_rc, want = SENTINEL_CASES[case]
    rc, verdict = _sentinel(ledger, str(tmp_path / "port.jsonl"), cases,
                            capsys, "--noise", "0.1")
    jrc, jverdict = _sentinel(jledger, str(tmp_path / "jax.jsonl"), cases,
                              capsys, "--noise", "0.1")
    assert (rc, verdict) == (jrc, jverdict)
    assert (rc, verdict["verdict"]) == (want_rc, want)
    if case == "gpu-to-cpu":
        (down,) = verdict["downgrades"]
        assert (down["field"], down["new"], down["baseline_best"]) == (
            "platform", "cpu", "gpu")
        assert down["fallback_reason"] == "no card"
    if case == "cups-drop":
        (reg,) = verdict["regressions"]
        assert reg["field"] == "value" and reg["drop"] == pytest.approx(0.2)


@pytest.mark.parametrize("tail", ["junk\n", '{"schema": "momp-ledger/1"\n'],
                         ids=["junk", "killed-writer"])
def test_sentinel_exits_2_on_an_unreadable_port_ledger(tail, tmp_path,
                                                       capsys):
    path = tmp_path / "port.jsonl"
    ledger.append(ledger.stamp(_record(), platform="gpu", device_count=1,
                               ts=1.0, sha="s"), str(path))
    with open(path, "a") as fd:
        fd.write(tail)
    assert regression_sentinel.main([str(path)]) == 2
    assert "port.jsonl:2" in capsys.readouterr().err


@pytest.mark.parametrize("layout", ["row", "col", "cart"])
def test_life_launcher_appends_one_line_a_shard_count(layout, tmp_path):
    times = tmp_path / "times.txt"
    res = subprocess.run(
        ["bash", os.path.join(ROOT, "launchers", "run_life_torch.sh"),
         f"--cfg={GLIDER}", "--max-dev=2", "--device=cpu",
         f"--layout={layout}", f"--times-file={times}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = times.read_text().strip().split("\n")
    assert len(lines) == 2
    assert [float(v) for v in lines] == list(plot_life.load_times(str(times)))


def test_life_launcher_refuses_an_unknown_flag(tmp_path):
    res = subprocess.run(
        ["bash", os.path.join(ROOT, "launchers", "run_life_torch.sh"),
         "--bogus"], cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert res.returncode == 2 and "unknown arg: --bogus" in res.stderr
