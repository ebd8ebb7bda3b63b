"""The port's Life CLI sizes its mesh against ``--virtual-devices N`` as
the JAX package's does.

The JAX CLI runs on N simulated CPU devices and refuses a mesh of more
shards with ``ValueError: Number of devices N must be >= the product of
mesh_shape ...``. The port's shards are virtual shards of one device, so
its CLI checks the count itself and refuses with the same text. The JAX
CLI runs in a fresh process here: its device count is fixed when JAX
starts, and this process already holds the tests' 8-device mesh.
"""

import contextlib
import io
import os
import subprocess
import sys

import pytest

from mpi_and_open_mp_tpu_torch.apps import life as life_app

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "mix_40x20.cfg")


def _jax_cli(args):
    """(return code, stdout, stderr) of the JAX package's Life CLI."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "mpi_and_open_mp_tpu.apps.life", CFG, *args,
         "--impl", "roll", "--print-final-population"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    return res.returncode, res.stdout, res.stderr


def _port_cli(args):
    """The final population the port's CLI prints on the CPU."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        assert life_app.main([CFG, *args, "--impl", "roll", "--device", "cpu",
                              "--print-final-population"]) == 0
    return int(err.getvalue().split()[-1])


@pytest.mark.parametrize("args", [
    ["--layout", "cart", "--mesh", "2,2", "--virtual-devices", "2"],
    ["--layout", "row", "--devices", "4", "--virtual-devices", "2"],
], ids=["cart-2x2", "row-4"])
def test_oversized_mesh_refused_as_jax_refuses(args):
    rc, _, jerr = _jax_cli(args)
    assert rc != 0
    want = jerr.strip().splitlines()[-1]
    assert want.startswith("ValueError: Number of devices 2 must be >= ")
    with pytest.raises(ValueError) as exc:
        _port_cli(args)
    assert f"ValueError: {exc.value}" == want


@pytest.mark.parametrize("args", [
    ["--layout", "cart", "--mesh", "2,2", "--virtual-devices", "4"],
    ["--layout", "row", "--devices", "2", "--virtual-devices", "2"],
], ids=["cart-2x2-of-4", "row-2-of-2"])
def test_meshes_that_fit_still_run(args):
    rc, out, jerr = _jax_cli(args)
    assert rc == 0, jerr
    assert _port_cli(args) == int(jerr.strip().splitlines()[-1]) == 33
