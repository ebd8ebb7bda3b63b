"""The port's CLIs of the reference's programs C1-C4 (``apps/hello.py``,
``apps/integral.py``, ``apps/pingpong.py``) against the JAX package's
contracts, on the CPU (``--device cpu``).

The JAX CLIs run in this process on the tests' 8-device CPU mesh, except
where their device count must differ: a fresh process then, as in
``tests/test_torch_cli_mesh.py``.
"""

import json
import os
import subprocess
import sys

import pytest

from mpi_and_open_mp_tpu.apps import hello as jax_hello
from mpi_and_open_mp_tpu_torch.apps import hello, integral, pingpong

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def test_hello_ring_lines_equal_jax(capsys):
    assert jax_hello.main(["--devices", "8"]) == 0
    want = capsys.readouterr().out.strip().split("\n")
    assert hello.main(["--devices", "8", *CPU]) == 0
    got = capsys.readouterr().out.strip().split("\n")
    assert got[0] == "process 0 of 1; 8 device(s): " + str(["cpu"] * 8)
    assert got[1:] == want[1:]
    assert got[-1] == "ring ok"
    assert got[1] == "device 0 received hello from device 7"


def test_hello_refuses_an_oversized_mesh_as_jax_refuses():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "mpi_and_open_mp_tpu.apps.hello",
         "--virtual-devices", "4", "--devices", "8"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    want = res.stderr.strip().splitlines()[-1]
    assert want.startswith("ValueError: Number of devices 4 must be >= ")
    with pytest.raises(ValueError) as exc:
        hello.main(["--virtual-devices", "4", "--devices", "8", *CPU])
    assert f"ValueError: {exc.value}" == want


def test_integral_cli(capsys):
    assert integral.main(["100000", "--devices", "8", "--print-value",
                          *CPU]) == 0
    captured = capsys.readouterr()
    out = captured.out.strip().split("\n")
    assert len(out) == 1
    float(out[0])
    value = float(captured.err.strip())
    assert "3.14" in captured.err and abs(value - 3.141592653589793) < 1e-5


def test_integral_cli_times_file(tmp_path, capsys):
    times = tmp_path / "times.txt"
    for _ in range(2):
        assert integral.main(["1000", "--devices", "2", "--times-file",
                              str(times), *CPU]) == 0
    elapsed = capsys.readouterr().out.split()
    lines = times.read_text().strip().split("\n")
    assert len(lines) == 2 and len(elapsed) == 2
    for line, out in zip(lines, elapsed):
        assert line == f"{float(out):.3f}"


def test_integral_cli_truncate_32bit(capsys):
    """2^32 + 1 -> 1 trapezoid after truncation: (f(0) + f(2)) / 2 * 2."""
    assert integral.main(["4294967297", "--truncate-32bit", "--devices", "1",
                          "--print-value", *CPU]) == 0
    assert float(capsys.readouterr().err.strip()) == 2.0


def test_pingpong_cli(tmp_path, capsys):
    out_csv = tmp_path / "out.csv"
    assert pingpong.main(["--devices", "2", "--reps", "2", "--max-power",
                          "2", "--out", str(out_csv), "--fit", *CPU]) == 0
    captured = capsys.readouterr()
    lines = captured.out.strip().split("\n")
    assert lines[0] == "size,time"
    # header + sizes 1, 10, 100 + the --fit JSON tail line
    assert len(lines) == 5
    assert [int(line.split(",")[0]) for line in lines[1:4]] == [1, 10, 100]
    fit = json.loads(lines[-1])
    assert fit["metric"] == "pingpong_fit"
    assert {"alpha_us", "beta_us_per_byte", "bandwidth_mb_s", "r2",
            "identifiable"} <= fit.keys()
    assert "alpha=" in captured.err
    assert out_csv.read_text().split("\n")[1:4] == lines[1:4]


@pytest.mark.parametrize("flag", [
    ["--distributed"],
    ["--distributed", "--coordinator", "localhost:1234"],
    ["--distributed", "--coordinator", "localhost:1234", "--num-processes",
     "0", "--process-id", "0"],
    ["--distributed", "--coordinator", "localhost:1234", "--num-processes",
     "2", "--process-id", "2"]],
    ids=["distributed", "coordinator", "num-processes", "process-id"])
@pytest.mark.parametrize("app,args", [
    (hello, []), (integral, ["1000"]), (pingpong, ["--max-power", "0"])],
    ids=["hello", "integral", "pingpong"])
def test_multi_process_flags_exit_2(app, args, flag, capsys, monkeypatch):
    """A run across processes that the four flags (and the environment)
    cannot describe exits 2 with the reason before joining anything: no
    address, size or rank, or a rank outside the size. The runs they do
    describe are ``tests/test_torch_distributed.py``'s."""
    for name in ("JOB_COORDINATOR", "JOB_NUM_PROCS", "JOB_PROC_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit) as exc:
        app.main([*args, *flag, *CPU])
    assert exc.value.code == 2
    assert "--distributed" in capsys.readouterr().err


def test_integral_launcher_appends_one_line_a_shard_count(tmp_path):
    times = tmp_path / "times.txt"
    res = subprocess.run(
        ["bash", os.path.join(ROOT, "launchers", "run_integral_torch.sh"),
         "--n=1000", "--max-dev=2", "--device=cpu", f"--times-file={times}"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = times.read_text().strip().split("\n")
    assert len(lines) == 2
    for line in lines:
        float(line)
