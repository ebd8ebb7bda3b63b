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
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import mpi_and_open_mp_tpu_torch as p\n"
        "from mpi_and_open_mp_tpu_torch.apps import life\n"
        "from mpi_and_open_mp_tpu_torch.ops import native_life, _build\n"
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
