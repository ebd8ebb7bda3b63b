"""The port's shard-to-shard probe (``parallel/fabric.py``) against the
JAX package's on the CPU: data movement, CSV bytes, the α+βn fit and its
renderings, and the chaos delay inside the timed bracket."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_and_open_mp_tpu.parallel import fabric as jax_fabric
from mpi_and_open_mp_tpu.parallel import mesh as jax_mesh
from mpi_and_open_mp_tpu_torch.parallel import fabric, mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.robust import chaos

# The rows of tests/test_fabric.py: synthetic t = 2.5 + 0.001 n and
# t = 5 + 0.01 n, and two noise-dominated probes (β ≤ 0).
FIT_ROWS = {
    "synthetic": [(n, 2.5 + 0.001 * n)
                  for n in (1, 10, 100, 1000, 10**4, 10**5, 10**6)],
    "synthetic-100MB": [(n, 5.0 + 0.01 * n)
                        for n in (1, 10, 100, 1000, 10**4, 10**5)],
    "noise": [(1, 3200.0), (10, 3100.0), (100, 3300.0), (1000, 3150.0),
              (10**4, 3250.0), (10**5, 3050.0), (10**6, 3000.0)],
    "decreasing": [(1, 3200.0), (10, 3100.0), (100, 3000.0), (1000, 2900.0)],
}


def test_ring_shift_moves_data_as_jax():
    mesh = jax_mesh.make_mesh_1d(8, axis="i")
    jbuf = jax.device_put(jnp.arange(8, dtype=jnp.int8),
                          NamedSharding(mesh, P("i")))
    want = np.asarray(jax_fabric._ring_shift_loop(jbuf, axis="i", reps=3,
                                                  mesh=mesh))
    buf = torch.arange(8, dtype=torch.int8).reshape(8, 1)
    got = fabric.ring_shift(buf, "y", 3).flatten().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.roll(np.arange(8), 3))


@pytest.mark.parametrize("axis,shape", [("y", (4, 10)), ("x", (1, 4, 10))])
def test_buffer_stacks_one_payload_a_shard(axis, shape):
    mesh = mesh_lib.make_mesh_1d(4, axis=axis, device="cpu")
    buf = fabric.buffer(mesh, 10)
    assert buf.shape == shape and buf.dtype == torch.int8
    assert fabric.buffer(mesh, 0).shape[-1] == 1
    stack = torch.arange(4, dtype=torch.int8).reshape(shape[:-1] + (1,))
    np.testing.assert_array_equal(
        fabric.ring_shift(stack, axis, 1).flatten().numpy(), [3, 0, 1, 2])


def test_sweep_schema_and_csv(tmp_path):
    mesh = mesh_lib.make_mesh_1d(2, device="cpu")
    rows = fabric.sweep(mesh, sizes=(1, 10, 100), reps=3)
    assert [s for s, _ in rows] == [1, 10, 100]
    assert all(us > 0 for _, us in rows)
    path = tmp_path / "out.csv"
    fabric.write_csv(path, rows)
    lines = path.read_text().strip().split("\n")
    assert lines[0] == "size,time"
    assert lines[1].startswith("1,")


def test_write_csv_bytes_equal_jax(tmp_path):
    rows = [(1, 3.25), (10, 4.0000004), (10**6, 1234.5678901)]
    fabric.write_csv(tmp_path / "port.csv", rows)
    jax_fabric.write_csv(tmp_path / "jax.csv", rows)
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("name", list(FIT_ROWS))
def test_fit_render_and_json_equal_jax(name):
    rows = FIT_ROWS[name]
    got, want = fabric.fit_alpha_beta(rows), jax_fabric.fit_alpha_beta(rows)
    assert tuple(got) == tuple(want)
    assert got.render() == want.render()
    assert got.as_json() == want.as_json()
    text = json.dumps(got.as_json())
    assert "Infinity" not in text and json.loads(text) == got.as_json()
    assert got.identifiable == name.startswith("synthetic")


def test_fit_recovers_the_model():
    fit = fabric.fit_alpha_beta(FIT_ROWS["synthetic"])
    assert fit.alpha_us == pytest.approx(2.5, rel=1e-6)
    assert fit.bandwidth_mb_s == pytest.approx(1000.0, rel=1e-6)
    assert fit.r2 == pytest.approx(1.0, abs=1e-9)


def test_chaos_delay_lands_inside_the_timed_bracket(monkeypatch):
    """``MOMP_CHAOS=delay=0.01`` lengthens each hop's mean by at least
    delay / reps."""
    mesh = mesh_lib.make_mesh_1d(2, device="cpu")
    reps, delay = 5, 0.01
    monkeypatch.setenv(chaos.ENV, f"delay={delay}")
    chaos.reset()
    try:
        assert chaos.dispatch_delay() == delay
        assert fabric.ping(mesh, 1, reps=reps) >= delay / reps
    finally:
        monkeypatch.delenv(chaos.ENV)
        chaos.reset()
    assert chaos.dispatch_delay() == 0.0
