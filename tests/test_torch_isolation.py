"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless asked for the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "mpi_and_open_mp_tpu_torch")
GLIDER = os.path.join(ROOT, "tests", "fixtures", "glider_10x10.cfg")


def _port_sources():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                          "stencil_times.py",
                                          "window_times.py",
                                          "vmem_times.py",
                                          "sliced_times.py",
                                          "vmem_batch_times.py",
                                          "fused_times.py",
                                          "rung_times.py",
                                          "quad_times.py",
                                          "tests/_torch_dist_worker.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import mpi_and_open_mp_tpu_torch as p\n"
        "from mpi_and_open_mp_tpu_torch.apps import life\n"
        "from mpi_and_open_mp_tpu_torch.ops import native_life, _build\n"
        "from mpi_and_open_mp_tpu_torch.serve import batcher\n"
        "from mpi_and_open_mp_tpu_torch import stencils\n"
        "from mpi_and_open_mp_tpu_torch.stencils import engine, spec, sparse\n"
        "from mpi_and_open_mp_tpu_torch.ops import native_stencil\n"
        "from mpi_and_open_mp_tpu_torch.apps import attention\n"
        "from mpi_and_open_mp_tpu_torch.parallel import context\n"
        "from mpi_and_open_mp_tpu_torch.ops import native_flash, flash_hop_bwd\n"
        "from mpi_and_open_mp_tpu_torch.parallel import mesh, halo, haloplan\n"
        "from mpi_and_open_mp_tpu_torch.ops import native_halo\n"
        "assert haloplan._rdma_edge_pair and native_halo.edge_pair\n"
        "assert haloplan._rdma_frame and native_halo.halo_frame\n"
        "from mpi_and_open_mp_tpu_torch.models import life as model\n"
        "assert model.state_from_jax_sim and model.LAYOUTS\n"
        "from mpi_and_open_mp_tpu_torch.utils import checkpoint\n"
        "from mpi_and_open_mp_tpu_torch import robust\n"
        "from mpi_and_open_mp_tpu_torch.robust import chaos, guards, preempt\n"
        "assert checkpoint.save and model.LifeSim.from_checkpoint\n"
        "assert chaos.FaultPlan and guards.with_fallback\n"
        "assert preempt.EXIT_PREEMPTED == 75\n"
        "from mpi_and_open_mp_tpu_torch.ops import quadrature, native_quadrature\n"
        "from mpi_and_open_mp_tpu_torch.models import integral\n"
        "from mpi_and_open_mp_tpu_torch.parallel import fabric\n"
        "from mpi_and_open_mp_tpu_torch.apps import _common, hello, pingpong\n"
        "from mpi_and_open_mp_tpu_torch.apps import integral as integral_app\n"
        "from mpi_and_open_mp_tpu_torch.utils import timing\n"
        "assert native_quadrature.trapezoid_circle and integral.Integral\n"
        "assert fabric.fit_alpha_beta and timing.Timer and timing.write_csv_rows\n"
        "assert chaos.dispatch_delay and _common.is_primary()\n"
        "from mpi_and_open_mp_tpu_torch.stencils import sparse_sharded\n"
        "from mpi_and_open_mp_tpu_torch import obs\n"
        "from mpi_and_open_mp_tpu_torch.obs import metrics, trace, report\n"
        "assert sparse_sharded.SparseShardedEngine and obs.report\n"
        "assert metrics.snapshot and trace.span and report.report_dict\n"
        "from mpi_and_open_mp_tpu_torch import tune\n"
        "from mpi_and_open_mp_tpu_torch.tune import plans, runner, space\n"
        "from mpi_and_open_mp_tpu_torch.serve import aotcache\n"
        "assert tune.PlanStore and runner.tune and space.candidates\n"
        "assert aotcache.AOTCache and plans.load_plan\n"
        "from mpi_and_open_mp_tpu_torch.serve import policy, queue, wal\n"
        "from mpi_and_open_mp_tpu_torch.serve import daemon\n"
        "from mpi_and_open_mp_tpu_torch.robust import watchdog\n"
        "assert policy.ServePolicy and queue.ServeQueue and wal.replay\n"
        "assert daemon.ServingDaemon and watchdog.backoff_schedule\n"
        "from mpi_and_open_mp_tpu_torch.serve import pool\n"
        "from mpi_and_open_mp_tpu_torch.ops import native_pool\n"
        "assert pool.SessionPool and native_pool.pool_step\n"
        "from mpi_and_open_mp_tpu_torch.obs import telemetry\n"
        "from mpi_and_open_mp_tpu_torch.serve import router, fleet, loadgen\n"
        "assert telemetry.SnapshotShipper and router.FleetRouter\n"
        "assert fleet.Fleet and fleet.SPOOL_SCHEMA and loadgen.run_open_loop\n"
        "from mpi_and_open_mp_tpu_torch.utils import native, config, vtk\n"
        "from mpi_and_open_mp_tpu_torch import graft_entry\n"
        "from mpi_and_open_mp_tpu_torch.parallel import procs\n"
        "assert native.life_steps and config.load_config_py and vtk.write_vtk_py\n"
        "assert graft_entry.entry and graft_entry.dryrun_multichip\n"
        "assert procs.init and procs.ring_shift and procs.all_to_all\n"
        "sys.path.insert(0, 'tests')\n"
        "import _torch_dist_worker\n"
        "assert _torch_dist_worker.main\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'mpi_and_open_mp_tpu.')) or "
        "m == 'mpi_and_open_mp_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', p.__all__)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_sources_name_no_jax(path):
    text = open(path).read()
    imports = re.findall(r"^\s*(?:import|from)\s+(\S+)", text, re.MULTILINE)
    for mod in imports:
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "mpi_and_open_mp_tpu"), (path, mod)


def test_default_device_entry_points_raise_without_cuda():
    """No quiet fallback: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    from mpi_and_open_mp_tpu_torch import LifeSim, load_config, state_from_jax
    from mpi_and_open_mp_tpu_torch.apps import life as life_app

    cfg = load_config(GLIDER)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LifeSim(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_jax(np.zeros((1, 10), np.uint32), 10, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        life_app.main([GLIDER])


def _batched_sim():
    from mpi_and_open_mp_tpu_torch import LifeSim, load_config

    LifeSim(load_config(GLIDER), layout="serial",
            initial_board=np.zeros((3, 10, 10), np.uint8))


def _batched_cli():
    from mpi_and_open_mp_tpu_torch.apps import life as life_app

    life_app.main([GLIDER, "--layout", "serial", "--batch", "3"])


def _batcher():
    from mpi_and_open_mp_tpu_torch.serve import ShapeBucketBatcher

    ShapeBucketBatcher(max_batch=8)


@pytest.mark.parametrize("entry", [_batched_sim, _batched_cli, _batcher],
                         ids=["LifeSim-stack", "cli-batch", "batcher"])
def test_batched_entry_points_raise_without_cuda(entry):
    """The batched entry points default to the card too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def _session_pool():
    from mpi_and_open_mp_tpu_torch.serve import SessionPool

    SessionPool()


def _daemon_session():
    from mpi_and_open_mp_tpu_torch.serve import ServingDaemon

    ServingDaemon().create_session("s", np.zeros((8, 8), np.uint8))


@pytest.mark.parametrize("entry", [_session_pool, _daemon_session],
                         ids=["SessionPool", "daemon-create_session"])
def test_pool_entry_points_raise_without_cuda(entry):
    """The session pool defaults to the card too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def _fleet():
    from mpi_and_open_mp_tpu_torch.serve import Fleet

    Fleet(2)


def _fleet_cli(tmp_path):
    from mpi_and_open_mp_tpu_torch.serve import fleet

    fleet.main(["--workers", "2", "--requests", "4", "--dir", str(tmp_path)])


def _loadgen():
    from mpi_and_open_mp_tpu_torch.serve import Fleet, run_open_loop

    run_open_loop(Fleet(2), 10.0, 0.1)


def test_fleet_defaults_to_cuda():
    """``Fleet`` and the fleet CLI default to the card, and the CLI hands
    its device to every worker process it spawns."""
    import inspect

    from mpi_and_open_mp_tpu_torch.serve import Fleet, fleet

    assert inspect.signature(Fleet).parameters["device"].default == "cuda"
    args = fleet.build_parser().parse_args([])
    assert args.device == "cuda"
    assert fleet.build_parser().parse_args(
        ["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("entry", [_fleet, _fleet_cli, _loadgen],
                         ids=["Fleet", "cli-fleet", "run_open_loop"])
def test_fleet_entry_points_raise_without_cuda(entry, tmp_path):
    """No fleet carries on on the CPU when it finds no card: the fleet, the
    CLI (before it writes a spool or spawns a worker) and a load run on a
    default fleet all refuse."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(tmp_path) if entry is _fleet_cli else entry()
    assert os.listdir(tmp_path) == []


def _stencil_sim():
    from mpi_and_open_mp_tpu_torch import LifeSim, load_config

    LifeSim(load_config(GLIDER), workload="heat")


def _sharded_sim():
    from mpi_and_open_mp_tpu_torch import LifeSim, load_config

    LifeSim(load_config(GLIDER), layout="cart", impl="bitfused")


def _mesh():
    from mpi_and_open_mp_tpu_torch.parallel import mesh

    mesh.make_mesh_1d(8)


def _sharded_cli():
    from mpi_and_open_mp_tpu_torch.apps import life as life_app

    life_app.main([GLIDER, "--layout", "cart", "--mesh", "4,2",
                   "--virtual-devices", "8"])


@pytest.mark.parametrize("entry", [_sharded_sim, _mesh, _sharded_cli],
                         ids=["LifeSim-cart", "make_mesh_1d", "cli-cart"])
def test_sharded_entry_points_raise_without_cuda(entry):
    """The sharded layouts and their meshes default to the card too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def _rdma_sim():
    from mpi_and_open_mp_tpu_torch import LifeSim, load_config

    LifeSim(load_config(GLIDER), layout="cart", impl="halo")


def _rdma_run_sharded():
    from mpi_and_open_mp_tpu_torch import stencils
    from mpi_and_open_mp_tpu_torch.parallel import mesh

    stencils.run_sharded(stencils.get("heat"), np.zeros((16, 16), np.float32),
                         2, mesh=mesh.make_mesh_2d(4, 2), layout="cart")


@pytest.mark.parametrize("entry", [_rdma_sim, _rdma_run_sharded, _sharded_cli],
                         ids=["LifeSim-halo", "run_sharded", "cli-cart"])
def test_rdma_entry_points_raise_without_cuda(entry, monkeypatch):
    """Under ``MOMP_HALO_RDMA=1`` the sharded entry points still default
    to the card: the flag adds no quiet CPU path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    monkeypatch.setenv("MOMP_HALO_RDMA", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def _active_tiles():
    from mpi_and_open_mp_tpu_torch import stencils

    stencils.ActiveTileEngine(stencils.get("life"),
                              np.zeros((64, 64), np.uint8), tile=32)


@pytest.mark.parametrize("entry", [_stencil_sim, _active_tiles],
                         ids=["LifeSim-heat", "ActiveTileEngine"])
def test_stencil_entry_points_raise_without_cuda(entry):
    """The stencil entry points default to the card too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def _qkv():
    return [np.zeros((2, 64, 16), np.float32) for _ in range(3)]


def _flash():
    from mpi_and_open_mp_tpu_torch import flash_attention

    flash_attention(*_qkv(), causal=True)


def _ring():
    from mpi_and_open_mp_tpu_torch.parallel import ring_attention

    ring_attention(*[torch.from_numpy(x) for x in _qkv()])


def _gate():
    from mpi_and_open_mp_tpu_torch.parallel import gated_parity_check

    gated_parity_check(heads=2, n=64, dim=16)


def _attention_cli():
    from mpi_and_open_mp_tpu_torch.apps import attention

    attention.main(["--variant", "flash", "--seq", "64", "--heads", "2",
                    "--head-dim", "16"])


@pytest.mark.parametrize("entry", [_flash, _ring, _gate, _attention_cli],
                         ids=["flash_attention", "ring_attention",
                              "gated_parity_check", "cli-attention"])
def test_attention_entry_points_raise_without_cuda(entry):
    """The attention entry points default to the card too, whatever device
    their operands come from."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def _integral():
    from mpi_and_open_mp_tpu_torch.models.integral import Integral

    Integral(1000)


def _hello_cli():
    from mpi_and_open_mp_tpu_torch.apps import hello

    hello.main(["--devices", "8"])


def _integral_cli():
    from mpi_and_open_mp_tpu_torch.apps import integral

    integral.main(["1000", "--devices", "8"])


def _pingpong_cli():
    from mpi_and_open_mp_tpu_torch.apps import pingpong

    pingpong.main(["--devices", "8", "--max-power", "0", "--reps", "1"])


def _sweep():
    from mpi_and_open_mp_tpu_torch.parallel import fabric

    fabric.sweep(sizes=(1,), reps=1)


@pytest.mark.parametrize("entry", [_integral, _hello_cli, _integral_cli,
                                   _pingpong_cli, _sweep],
                         ids=["Integral", "cli-hello", "cli-integral",
                              "cli-pingpong", "fabric-sweep"])
def test_c1c4_entry_points_raise_without_cuda(entry):
    """The quadrature, the probe and the three CLIs of the reference's
    programs C1-C4 default to the card too: without ``--device cpu`` they
    try it and fail here, and never run on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_chip_smoke_refuses_without_cuda_and_alone(tmp_path):
    """The chip script exits non-zero and prints no result line when there
    is no card, and when it stands alone without the package."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    for cwd in (ROOT, str(tmp_path)):
        if cwd != ROOT:
            with open(script) as src:
                (tmp_path / "chip_smoke.py").write_text(src.read())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert res.returncode != 0, (cwd, res.stdout)
        assert '"ok"' not in res.stdout, cwd


def _procs_init():
    from mpi_and_open_mp_tpu_torch.parallel import procs

    procs.init("localhost:1", 2, 0)


def _worker():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _torch_dist_worker

    _torch_dist_worker.main(["0", "2", "localhost:1"])


def _graft_entry():
    from mpi_and_open_mp_tpu_torch import graft_entry

    graft_entry.entry()


def _graft_dryrun():
    from mpi_and_open_mp_tpu_torch import graft_entry

    graft_entry.main(["2"])


def _life_cli_distributed():
    from mpi_and_open_mp_tpu_torch.apps import life as life_app

    life_app.main([GLIDER, "--layout", "row", "--distributed",
                   "--coordinator", "localhost:1", "--num-processes", "2",
                   "--process-id", "0"])


@pytest.mark.parametrize("entry", [_procs_init, _worker, _graft_entry,
                                   _graft_dryrun, _life_cli_distributed],
                         ids=["procs-init", "dist-worker", "graft-entry",
                              "graft-dryrun", "cli-life-distributed"])
def test_distributed_and_graft_entry_points_raise_without_cuda(entry):
    """A run across processes, the two-process worker and the graft entry
    default to the card: without a card they raise before joining any
    run or doing any work, and never move to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
