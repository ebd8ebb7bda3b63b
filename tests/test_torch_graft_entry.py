"""The port's graft entry (``mpi_and_open_mp_tpu_torch/graft_entry.py``)
against the JAX package's (``__graft_entry__.py``).

``entry(device="cpu")``'s step equals JAX's ``life_step_roll`` on JAX's
own board bit for bit; ``dryrun_multichip(8, device="cpu")`` passes on 8
virtual shards of the CPU; without a card both raise rather than move to
the CPU (the JAX dry run's probe-and-degrade branch is not carried
over). JAX's own ``test_dryrun_multichip_8`` is not this module's oracle.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_and_open_mp_tpu.ops.life_ops import life_step_numpy
from mpi_and_open_mp_tpu.ops.life_ops import life_step_roll as jax_roll
from mpi_and_open_mp_tpu_torch import graft_entry

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import __graft_entry__ as jax_graft  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_entry_cpu_step_matches_jax_bit_for_bit():
    fn, (board,) = graft_entry.entry(device="cpu")
    _, (jax_board,) = jax_graft.entry()
    assert board.device.type == "cpu" and board.dtype == torch.uint8
    assert tuple(board.shape) == graft_entry.BOARD_SHAPE
    np.testing.assert_array_equal(board.numpy(), np.asarray(jax_board))
    got = fn(board).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_roll(jnp.asarray(
        board.numpy()))))
    np.testing.assert_array_equal(got, life_step_numpy(board.numpy()))


def test_dryrun_multichip_8_on_cpu(capsys):
    assert graft_entry.main(["8", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "dryrun_multichip(8) OK"


def test_no_card_raises_instead_of_degrading(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(8)
