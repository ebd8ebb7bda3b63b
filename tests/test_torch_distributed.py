"""The port across processes: two gloo processes on the CPU.

The port's counterpart of ``tests/test_distributed.py``: two Python
processes join one ``torch.distributed`` run (``parallel.procs``) and run
the meshes that span them. ``tests/_torch_dist_worker.py`` runs the JAX
worker's drill (integral, row halo Life and ``collect``, ring attention
and its gradients, zigzag, a process-0 snapshot); its results are held
bit for bit against the one-process run of the same meshes here, and the
board and the value against the JAX package's oracle. The CLI cases run
the port's CLIs with ``--distributed`` in two processes. Every process
runs on one torch thread, with a time limit, and is killed on failure.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpi_and_open_mp_tpu.ops.life_ops import life_step_numpy as jax_oracle
from mpi_and_open_mp_tpu_torch.models.integral import Integral
from mpi_and_open_mp_tpu_torch.models.life import LifeSim
from mpi_and_open_mp_tpu_torch.parallel import context, haloplan
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.parallel import procs
from mpi_and_open_mp_tpu_torch.utils.config import (
    config_from_board, save_config)
from mpi_and_open_mp_tpu_torch.utils.vtk import read_vtk, vtk_path

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
sys.path.insert(0, HERE)

import _torch_dist_worker as worker  # noqa: E402

TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv_of, n: int = 2) -> list[tuple[str, str]]:
    """Start ``n`` processes, ``argv_of(rank)`` each, on one torch thread;
    wait for all of them (``TIMEOUT_S``), kill any still running, and
    assert that every one exited 0. Returns each one's (stdout, stderr)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    ps = [subprocess.Popen([sys.executable, *argv_of(r)], cwd=ROOT,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           env=env, text=True) for r in range(n)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in ps]
    finally:
        # A rank hung in a collective would otherwise outlive the test,
        # holding the coordinator's port.
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(ps, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}\n{err}"
    return outs


def transport_of(err: str) -> str:
    """The transport the primary stamped on stderr (``_common``)."""
    return next(json.loads(line) for line in err.splitlines()
                if line.startswith("{"))["transport"]


def cli_ranks(module: str, args: list[str], n: int = 2):
    coord = f"localhost:{_free_port()}"
    return run_ranks(lambda r: [
        "-m", f"mpi_and_open_mp_tpu_torch.apps.{module}", *args,
        "--device", "cpu", "--distributed", "--coordinator", coord,
        "--num-processes", str(n), "--process-id", str(r)], n)


def test_two_process_worker_matches_one_process(tmp_path):
    coord = f"localhost:{_free_port()}"
    out_npz = tmp_path / "run.npz"
    outs = run_ranks(lambda r: [
        WORKER, str(r), "2", coord, "--device", "cpu",
        "--snapshot-dir", str(tmp_path),
        *(["--out", str(out_npz)] if r == 0 else [])])
    assert "DIST_OK" in outs[0][0] and "DIST_OK" not in outs[1][0]
    got = np.load(out_npz)
    assert str(got["transport"]) == "gloo"

    # The one-process run of the same meshes, bit for bit.
    m = mesh_lib.make_mesh_1d(2, axis="y", device="cpu")
    assert got["integral"] == Integral(worker.INTEGRAL_N, mesh=m).compute()
    board = worker.board0()
    sim = LifeSim(config_from_board(board, worker.LIFE_STEPS, 0),
                  layout="row", impl="halo", mesh=m)
    sim.step(worker.LIFE_STEPS)
    np.testing.assert_array_equal(got["board"], sim.collect())
    ref = board
    for _ in range(worker.LIFE_STEPS):
        ref = jax_oracle(ref)
    np.testing.assert_array_equal(got["board"], ref)
    sp = mesh_lib.make_mesh_1d(2, axis="sp", device="cpu")
    q, k, v = worker.ring_inputs("cpu")
    np.testing.assert_array_equal(
        got["ring"], context.ring_attention(q, k, v, mesh=sp,
                                            causal=True).numpy())
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad((context.ring_attention(
        *qkv, mesh=sp, causal=True) ** 2).sum(), qkv)
    for name, g in zip("qkv", grads):
        np.testing.assert_array_equal(got[f"d{name}"], g.numpy())
    qz, kz, vz = (context.zigzag_shard(x, 2) for x in (q, k, v))
    np.testing.assert_array_equal(got["zigzag"], context.ring_attention(
        qz, kz, vz, mesh=sp, causal=True, layout="zigzag").numpy())
    # Process 0 wrote the snapshot; process 1's directory was never made.
    names = sorted(os.listdir(tmp_path))
    assert [n for n in names if n.startswith("torch_dist_vtk_")] == [
        f"torch_dist_vtk_{coord.replace(':', '_')}_0"]


def test_two_process_hello_ring_ok():
    outs = cli_ranks("hello", ["--devices", "4"])
    for r, (out, _) in enumerate(outs):
        assert f"process {r} of 2; 4 device(s)" in out
        assert out.strip().endswith("ring ok")
        own = [line for line in out.splitlines() if "received" in line]
        assert own == [f"device {i} received hello from device {(i - 1) % 4}"
                       for i in (2 * r, 2 * r + 1)]
    assert transport_of(outs[0][1]) == "gloo"


@pytest.mark.parametrize("layout,impl,mesh_args,env", [
    ("row", "halo", ["--devices", "2"], {}),
    ("col", "native", ["--virtual-devices", "2"], {}),
    ("cart", "halo", ["--mesh", "2,2", "--virtual-devices", "2"], {}),
    ("cart", "native", ["--mesh", "2,2", "--virtual-devices", "2"],
     {"MOMP_HALO_RDMA": "1"}),
], ids=["row-halo", "col-native-4", "cart-halo-2x2", "cart-native-rdma"])
def test_two_process_life_cli_matches_jax_oracle(tmp_path, layout, impl,
                                                 mesh_args, env,
                                                 monkeypatch):
    """The Life CLI across two processes: the snapshot at step 3 (gathered,
    written by process 0) and the final population equal the JAX
    package's oracle; process 1 prints nothing on stdout. Under
    ``MOMP_HALO_RDMA=1`` on the CPU the run takes the deferred exchange,
    as the JAX package's two-process CPU run does."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    board = (np.random.default_rng(3).random((48, 40)) < 0.35).astype(
        np.uint8)
    cfg_path = tmp_path / "board.cfg"
    save_config(cfg_path, config_from_board(board, steps=6, save_steps=3))
    outdir = tmp_path / "vtk"
    outs = cli_ranks("life", [str(cfg_path), "--layout", layout, "--impl",
                              impl, *mesh_args, "--outdir", str(outdir),
                              "--print-final-population"])
    ref = [board]
    for _ in range(6):
        ref.append(jax_oracle(ref[-1]))
    assert sorted(os.listdir(outdir)) == ["life_000000.vtk",
                                          "life_000003.vtk"]
    np.testing.assert_array_equal(read_vtk(vtk_path(outdir, 3)), ref[3])
    float(outs[0][0].strip())  # the elapsed-seconds line
    assert str(int(ref[6].sum())) in outs[0][1].splitlines()
    assert transport_of(outs[0][1]) == "gloo"
    assert outs[1][0] == ""


@pytest.mark.parametrize("layout,mesh_args", [
    ("row", ["--devices", "2"]),
    ("cart", ["--mesh", "2,2", "--virtual-devices", "2"]),
], ids=["row-2", "cart-2x2"])
def test_two_process_bitfused_padded_frame_matches_jax_oracle(
        tmp_path, layout, mesh_args):
    """The packed path across two processes on a frame padded in y (200
    rows in 256, mirror rows on the last shard, which only process 1
    holds), across a fused-round boundary (k_max 64): the snapshot at
    step 66 and the population at 72 equal the JAX package's oracle."""
    board = (np.random.default_rng(5).random((200, 300)) < 0.35).astype(
        np.uint8)
    cfg_path = tmp_path / "board.cfg"
    save_config(cfg_path, config_from_board(board, steps=72, save_steps=66))
    outdir = tmp_path / "vtk"
    outs = cli_ranks("life", [str(cfg_path), "--layout", layout, "--impl",
                              "bitfused", *mesh_args, "--outdir",
                              str(outdir), "--print-final-population"])
    ref = [board]
    for _ in range(72):
        ref.append(jax_oracle(ref[-1]))
    np.testing.assert_array_equal(read_vtk(vtk_path(outdir, 66)), ref[66])
    assert str(int(ref[72].sum())) in outs[0][1].splitlines()
    assert outs[1][0] == ""


def test_two_process_integral_and_pingpong_cli():
    outs = cli_ranks("integral", ["100000", "--devices", "4",
                                  "--print-value"])
    value = float(next(line for line in outs[0][1].splitlines()
                       if line.startswith("3.14")))
    m = mesh_lib.make_mesh_1d(4, device="cpu")
    assert value == Integral(100000, mesh=m).compute()
    assert abs(value - np.pi) < 1e-3
    assert outs[1][0] == ""
    outs = cli_ranks("pingpong", ["--reps", "2", "--max-power", "2",
                                  "--fit"])
    lines = outs[0][0].strip().splitlines()
    assert lines[0] == "size,time" and len(lines) == 5
    fit = json.loads(lines[-1])
    assert fit["metric"] == "pingpong_fit" and fit["transport"] == "gloo"
    assert outs[1][0] == ""


@pytest.mark.parametrize("variant", ["ring", "ulysses"])
def test_two_process_attention_cli_grad(variant):
    """Ring and Ulysses attention across two processes, a full gradient
    step each, every process's rows against the dense oracle."""
    outs = cli_ranks("attention", [
        "--variant", variant, "--devices", "2", "--seq", "128", "--heads",
        "2", "--head-dim", "16", "--causal", "--grad", "--dtype",
        "float32"])
    assert "parity ok" in outs[0][1]
    assert f"variant={variant} seq=128 devices=2" in outs[0][1]


def test_rdma_rung_refused_across_processes_on_the_card(monkeypatch):
    """On the card the rung's kernels take every shard from one stack, so
    a mesh across processes refuses ``MOMP_HALO_RDMA=1`` naming the
    roadmap; on the CPU the flag gives the deferred exchange."""
    monkeypatch.setenv(haloplan.ENV_RDMA, "1")
    world = procs.World(2, 0, "gloo-staged", torch.device("cpu"))
    monkeypatch.setattr(procs, "_WORLD", world)
    monkeypatch.setattr(procs, "_AXES", {"y": True, "x": False})
    monkeypatch.setattr(haloplan, "on_card", lambda device: True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        haloplan.plan_halo("row", (2, 1), (16, 16), 1, 1, device="cpu")
    monkeypatch.setattr(haloplan, "on_card", lambda device: False)
    assert haloplan.plan_halo("row", (2, 1), (16, 16), 1, 1,
                              device="cpu").engine == "overlap:deferred"


def test_mesh_roles_and_local_parts(monkeypatch):
    """A mesh made in a run of two processes spans them on its first axis:
    each holds a contiguous run, an axis keeps one role per run, and
    ``local_part`` cuts the stack to this process's run."""
    world = procs.World(2, 1, "gloo", torch.device("cpu"))
    monkeypatch.setattr(procs, "_WORLD", world)
    monkeypatch.setattr(procs, "_AXES", {})
    m = mesh_lib.make_mesh_2d(4, 2, device="cpu")
    assert (m.procs, m.rank, m.local_sizes, m.first_shard) == (
        2, 1, (2, 2), 2)
    assert procs.span("y") is world and procs.span("x") is None
    with pytest.raises(ValueError, match="one role"):
        mesh_lib.make_mesh_1d(2, axis="x", device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.make_mesh_1d(3, axis="y", device="cpu")
    stack = mesh_lib.shard(torch.arange(8 * 6).reshape(8, 6), 4, 2)
    np.testing.assert_array_equal(mesh_lib.local_part(stack, m).numpy(),
                                  stack[2:].numpy())
    assert mesh_lib.default_shards("cpu") == 2


@pytest.mark.parametrize("device,cards,local,want", [
    ("cpu", 0, None, "gloo"), ("cpu", 4, "2", "gloo"),
    ("cuda", 1, None, "gloo-staged"), ("cuda", 2, None, "nccl"),
    ("cuda", 4, "8", "gloo-staged"), ("cuda", 4, "4", "nccl")],
    ids=["cpu", "cpu-cards", "one-card", "a-card-each", "cards-short",
         "local-size"])
def test_transport_rule(monkeypatch, device, cards, local, want):
    """The rule decided at the bootstrap: gloo for shards on the CPU, NCCL
    when the host has a card for each of its ranks (LOCAL_WORLD_SIZE,
    default the world size), else gloo staged through host memory."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert procs.transport_for(torch.device(device), 2) == want
