"""PyTorch/CUDA port of ``mpi_and_open_mp_tpu`` for NVIDIA Hopper.

Imports ``torch`` and never ``jax``; nothing here imports the JAX package.
Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``, where the hand-written kernels' plain PyTorch versions
run instead.
"""

from mpi_and_open_mp_tpu_torch.models.life import LifeSim
from mpi_and_open_mp_tpu_torch.ops.bitlife import state_from_jax
from mpi_and_open_mp_tpu_torch.utils.config import load_config

__all__ = ["LifeSim", "load_config", "state_from_jax"]
__version__ = "0.1.0"
