"""The port's launch-record cache (``serve/aotcache.py``) against the JAX
package's AOT cache contract, on the CPU.

The JAX package's ``test_aotcache.py`` cases on the port: bucket sizes
equal to the JAX package's, every key field moving the digest (a
``csrc`` edit moves ``code``), a cold derive then a warm hit with every
board oracle-exact, a truncated artifact quarantined and rebuilt, a
stale key rejected, the first-use parity gate catching a wrong engine, and
the ``MOMP_CHAOS aot_corrupt`` drills. Then what is the port's own: a
record whose geometry or library hash no longer derives is ``stale``.
"""

import dataclasses
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import oracle_n
from mpi_and_open_mp_tpu.robust import chaos as jchaos
from mpi_and_open_mp_tpu.serve import aotcache as jaot

from mpi_and_open_mp_tpu_torch.ops import _build
from mpi_and_open_mp_tpu_torch.ops import bitlife as tb
from mpi_and_open_mp_tpu_torch.ops import native_life as tnl
from mpi_and_open_mp_tpu_torch.robust import chaos
from mpi_and_open_mp_tpu_torch.serve import aotcache


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_plans():
    tnl.clear_planned_paths()
    yield
    tnl.clear_planned_paths()


def _cache(path):
    return aotcache.AOTCache(path, device="cpu")


def _key(shape=(4, 16, 16), dtype=np.uint8):
    return aotcache.fingerprint(shape, dtype, device="cpu")


# -- keying ------------------------------------------------------------------


@pytest.mark.parametrize("max_batch", [1, 6, 8, 33, 64, 100])
def test_bucket_sizes_equal_jax(max_batch):
    assert aotcache.bucket_sizes(max_batch) == jaot.bucket_sizes(max_batch)


def test_fingerprint_sensitivity():
    """Every field that can change what runs changes the digest; equal
    inputs give it again (the file name is the key). The port keys torch
    and CUDA where the JAX package keys jax and jaxlib."""
    base = _key()
    assert base["steps"] == aotcache.STEPS_SIGNATURE
    assert base["bucket"] == 4 and base["shape"] == [16, 16]
    assert base["engine_path"] == "batch:plain"
    assert base["platform"] == "cpu" and base["topology"] == "cpu:1"
    assert base["torch"] == torch.__version__
    assert base["code"] == aotcache.code_fingerprint()
    assert "jax" not in base and "jaxlib" not in base
    d = aotcache.digest_for(base)
    assert d == aotcache.digest_for(_key())
    others = [
        _key((8, 16, 16)),                  # bucket (and path)
        _key((4, 16, 24)),                  # shape
        _key(dtype=np.int32),               # dtype
        dict(base, torch="0.0.0"),          # version skew
        dict(base, code="f" * 16),          # edited kernels
        dict(base, device_kind="NVIDIA H100 80GB HBM3"),
    ]
    digests = {aotcache.digest_for(k) for k in others}
    assert d not in digests and len(digests) == len(others)
    tnl.install_planned_path("life", (4, 16, 16), "bitsliced")
    planned = _key()
    assert planned["engine_path"] == "batch:bitsliced"
    assert planned["pack_layout"] == "bitsliced"
    assert aotcache.digest_for(planned) != d


def test_csrc_edit_moves_the_code_hash(tmp_path):
    """The code hash covers every ``csrc/*.cu`` and ``*.cuh``: a copy of
    the sources hashes the same, an edited kernel (or a new header) does
    not."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    assert aotcache.code_fingerprint(copy) == aotcache.code_fingerprint()
    edited = tmp_path / "edited"
    shutil.copytree(_build.CSRC, edited)
    with open(edited / "bitlife_vmem_batch.cu", "a") as fd:
        fd.write("\n// edited\n")
    assert aotcache.code_fingerprint(edited) != aotcache.code_fingerprint()
    added = tmp_path / "added"
    shutil.copytree(_build.CSRC, added)
    (added / "extra.cuh").write_text("// a new header\n")
    assert aotcache.code_fingerprint(added) != aotcache.code_fingerprint()


# -- the round trip ----------------------------------------------------------


def test_cold_build_then_warm_hit(tmp_path, make_board):
    """Pass 1 derives and persists one record a bucket; pass 2, a fresh
    cache (another process's view), loads every one, and its first results
    hold the oracle bit for bit, at any step count."""
    c1 = _cache(tmp_path)
    w1 = c1.warm([((16, 16), "uint8")], 4)
    assert w1 == {"hits": 0, "misses": 3, "corrupt": 0, "stale": 0,
                  "parity_failed": 0, "built": 3, "errors": 0,
                  "deserialize_s": 0.0, "build_s": w1["build_s"],
                  "programs": 3}
    assert len(glob.glob(str(tmp_path / "*.aot"))) == 3
    c2 = _cache(tmp_path)
    w2 = c2.warm([((16, 16), "uint8")], 4)
    assert w2["hits"] == 3 and w2["misses"] == 0 and w2["built"] == 0
    board = make_board(16, 16)
    stack = np.stack([board] * 2)
    digest, record, status = c2.ensure(stack.shape, stack.dtype)
    assert status == "memory" and record == {"path": "plain",
                                             "geometry": {},
                                             "libraries": {}}
    np.testing.assert_array_equal(c2.call_verified(digest, stack, 5)[0],
                                  oracle_n(board, 5))
    np.testing.assert_array_equal(c2.call_verified(digest, stack, 9)[1],
                                  oracle_n(board, 9))


def test_planned_bucket_records_the_plan(tmp_path, make_board):
    """With a plan installed the bucket's record is the plan's path and the
    planner's geometry for it, and it runs to the oracle's boards."""
    shape = (5, 20, 24)
    tnl.install_planned_path("life", shape, "bitsliced")
    c = _cache(tmp_path)
    digest, record, status = c.ensure(shape, np.uint8)
    assert status == "miss" and record["path"] == "bitsliced"
    assert record["geometry"] == json.loads(json.dumps(
        dataclasses.asdict(tb.plan_bitsliced((1, 20, 24)))))
    stack = np.stack([make_board(20, 24) for _ in range(5)])
    out = c.call_verified(digest, stack, 7)
    for b in range(5):
        np.testing.assert_array_equal(out[b], oracle_n(stack[b], 7))


@pytest.mark.parametrize("path,shape", [
    ("vmem-grid", (4, 500, 500)), ("bitsliced", (64, 500, 500)),
    ("fused", (2, 1024, 1024)), ("frame", (2, 500, 500)),
    ("frame", (512, 95, 130))])
def test_launch_records_derive_the_planner_geometry(path, shape):
    """Each kernel path's record holds the geometry the port's planner
    gives its stack, plain JSON, the same every time; on the CPU no
    library."""
    key = dict(_key(shape), engine_path=f"batch:{path}")
    record = aotcache.launch_record(key)
    assert record == aotcache.launch_record(key)
    assert record["path"] == path and record["libraries"] == {}
    assert record == json.loads(json.dumps(record))
    b, ny, nx = shape
    if path == "vmem-grid":
        assert record["geometry"]["strips"] == (
            tb.vmem_batch_launch_geometry(b, ny, nx).strips)
    elif path == "bitsliced":
        assert record["geometry"]["bands"] == tb.plan_bitsliced(
            (tb.n_planes(b), ny, nx)).bands
    else:
        plan = tb.plan_sharded_bits((ny, nx))
        assert record["geometry"]["plan"]["k_max"] == plan.k_max
        assert record["geometry"]["round"]["bands"] == (
            tb.fused_launch_geometry(plan.nw_s, plan.W, plan.h, plan.hx,
                                     plan.k_max).bands)
    with pytest.raises(ValueError, match="no launch record"):
        aotcache.launch_record(dict(key, engine_path="batch:xla"))


# -- hardening ---------------------------------------------------------------


def test_truncated_artifact_quarantined_and_rebuilt(tmp_path):
    _cache(tmp_path).warm([((12, 12), "uint8")], 1)
    (art,) = glob.glob(str(tmp_path / "*.aot"))
    with open(art, "r+b") as fd:
        fd.truncate(30)  # inside the header
    c = _cache(tmp_path)
    _, record, status = c.ensure((1, 12, 12), np.uint8)
    assert status == "corrupt" and record is not None
    assert c.stats()["corrupt"] == 1 and c.stats()["built"] == 1
    assert len(glob.glob(art + ".corrupt.*")) == 1
    assert os.path.exists(art)
    assert _cache(tmp_path).ensure((1, 12, 12), np.uint8)[2] == "hit"


def test_stale_key_artifact_rejected(tmp_path):
    """An intact envelope whose stored key drifted (here the code hash:
    edited kernels) is stale, quarantined, rebuilt."""
    key = _key((1, 12, 12))
    c0 = _cache(tmp_path)
    digest, record, _ = c0.ensure((1, 12, 12), np.uint8)
    path = str(tmp_path / (digest + ".aot"))
    aotcache.save_artifact(path, dict(key, code="0" * 16),
                           json.dumps(record).encode())
    with pytest.raises(aotcache.ArtifactError, match="code") as ei:
        aotcache.load_artifact(path, key)
    assert ei.value.kind == "stale"
    c = _cache(tmp_path)
    _, record2, status = c.ensure((1, 12, 12), np.uint8)
    assert status == "stale" and record2 == record
    assert glob.glob(path + ".stale.*")


def test_moved_geometry_is_stale(tmp_path):
    """The port's own check: a record whose geometry the planner no longer
    gives is stale, though its key matches."""
    shape = (4, 20, 24)
    tnl.install_planned_path("life", shape, "bitsliced")
    key = _key(shape)
    record = aotcache.launch_record(key)
    moved = dict(record, geometry=dict(record["geometry"], halo=99))
    path = str(tmp_path / (aotcache.digest_for(key) + ".aot"))
    aotcache.save_artifact(path, key, json.dumps(moved).encode())
    with pytest.raises(aotcache.ArtifactError, match="geometry") as ei:
        aotcache.load_artifact(path, key)
    assert ei.value.kind == "stale"
    _, got, status = _cache(tmp_path).ensure(shape, np.uint8)
    assert status == "stale" and got == record


def test_rebuilt_library_is_stale(tmp_path, monkeypatch):
    """On the card a record carries the sha256 of each library its path
    loads; a library rebuilt since (another hash) makes it stale. The
    hashes are faked here: no library is built on the CPU."""
    built = {"bitlife_vmem_batch": "a" * 64}
    monkeypatch.setattr(aotcache, "_library_hashes",
                        lambda names: {n: built[n] for n in names})
    key = dict(_key((4, 500, 500)), engine_path="batch:vmem-grid",
               platform="cuda")
    record = aotcache.launch_record(key)
    assert record["libraries"] == built
    path = str(tmp_path / "x.aot")
    aotcache.save_artifact(path, key, json.dumps(record).encode())
    assert aotcache.load_artifact(path, key) == record
    built["bitlife_vmem_batch"] = "b" * 64
    with pytest.raises(aotcache.ArtifactError, match="libraries") as ei:
        aotcache.load_artifact(path, key)
    assert ei.value.kind == "stale"


def test_undecodable_record_is_corrupt(tmp_path):
    key = _key((1, 12, 12))
    path = str(tmp_path / "x.aot")
    aotcache.save_artifact(path, key, b"\xff not json")
    with pytest.raises(aotcache.ArtifactError, match="decode") as ei:
        aotcache.load_artifact(path, key)
    assert ei.value.kind == "corrupt"
    with open(path, "r+b") as fd:
        fd.write(b"XXXX")
    with pytest.raises(aotcache.ArtifactError, match="magic") as ei:
        aotcache.load_artifact(path, key)
    assert ei.value.kind == "corrupt"


def test_parity_gate_catches_wrong_engine(tmp_path, make_board, monkeypatch):
    """A record that passes every check on disk but whose engine computes
    the wrong function (the plain loop replaced by the identity) fails the
    first-use oracle gate: quarantined, evicted, raised; the next ensure
    derives it afresh and it serves."""
    c = _cache(tmp_path)
    digest, _, status = c.ensure((1, 12, 12), np.uint8)
    assert status == "miss"
    stack = make_board(12, 12)[None]
    with monkeypatch.context() as m:
        m.setattr(tb, "life_run_bits_plain_batch", lambda boards, n: boards)
        with pytest.raises(aotcache.ParityError, match="oracle"):
            c.call_verified(digest, stack, 3)
    assert c.stats()["parity_failed"] == 1
    assert glob.glob(str(tmp_path / (digest + ".aot.corrupt.*")))
    _, record, status = c.ensure((1, 12, 12), np.uint8)
    assert status == "miss" and record is not None
    np.testing.assert_array_equal(c.call_verified(digest, stack, 3)[0],
                                  oracle_n(stack[0], 3))


# -- chaos -------------------------------------------------------------------


def test_chaos_token_parse_and_budget(monkeypatch):
    for spec, kind, k in [("aot_corrupt=bitflip:2", "bitflip", 2),
                          ("aot_corrupt=skew", "skew", 1)]:
        plan = chaos.FaultPlan.parse(spec)
        jplan = jchaos.FaultPlan.parse(spec)
        assert (plan.aot_corrupt_kind, plan.aot_corrupt) == (kind, k) == (
            jplan.aot_corrupt_kind, jplan.aot_corrupt)
    for bad in ["aot_corrupt=gamma:1", "aot_corrupt=bitflip:0",
                "aot_corrupt="]:
        with pytest.raises(ValueError, match="MOMP_CHAOS"):
            chaos.FaultPlan.parse(bad)
    monkeypatch.setenv("MOMP_CHAOS", "aot_corrupt=bitflip:2")
    chaos.reset()
    try:
        assert chaos.take_aot_corrupt() == "bitflip"
        with chaos.suppressed():
            assert chaos.take_aot_corrupt() is None
        assert chaos.take_aot_corrupt() == "bitflip"
        assert chaos.take_aot_corrupt() is None  # the budget is spent
    finally:
        chaos.reset()


@pytest.mark.parametrize("kind,status", [("bitflip", "corrupt"),
                                         ("skew", "stale")])
def test_chaos_corrupts_artifact_at_save(tmp_path, monkeypatch, kind,
                                         status, make_board):
    """The plan damages the first saved artifact on disk (the saving
    cache's record stays good); the next cache's load takes the planned
    rejection, quarantines, rebuilds, and the rebuilt record serves."""
    monkeypatch.setenv("MOMP_CHAOS", f"aot_corrupt={kind}:1")
    chaos.reset()
    try:
        w = _cache(tmp_path).warm([((12, 12), "uint8")], 2)
    finally:
        monkeypatch.delenv("MOMP_CHAOS")
        chaos.reset()
    assert w["built"] == 2
    c2 = _cache(tmp_path)
    w2 = c2.warm([((12, 12), "uint8")], 2)
    assert w2[status] == 1 and w2["hits"] == 1 and w2["built"] == 1
    assert len(glob.glob(str(tmp_path / f"*.{status}.*"))) == 1
    stack = np.stack([make_board(12, 12)] * 2)
    digest, _, _ = c2.ensure(stack.shape, stack.dtype)
    np.testing.assert_array_equal(c2.call_verified(digest, stack, 4)[1],
                                  oracle_n(stack[1], 4))
