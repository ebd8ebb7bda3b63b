"""Stencil spec subsystem: every rule a servable workload.

Counterpart of ``mpi_and_open_mp_tpu/stencils`` on one device:
``stencils.spec`` (the declarative :class:`StencilSpec` and the registry),
``stencils.engine`` (roll, padded, oracle and engine-family steps, and the
stack runner over the hand-written padded kernel) and ``stencils.sparse``
(the active-tile engine for mostly-dead boards), the sharded runners over
a mesh of shards on one device (``make_sharded_runner``, ``run_sharded``),
and ``stencils.sparse_sharded`` (the active-tile skip composed with the
sharded halo rounds: a global tile mask, activation across shards).
"""

from mpi_and_open_mp_tpu_torch.stencils.engine import (  # noqa: F401
    ENGINE_FAMILIES,
    FFT_MIN_RADIUS,
    aggregate_roll,
    family_allowed,
    family_for_path,
    family_pinned,
    fft_supported,
    fused_steps_valid,
    make_sharded_runner,
    mesh_axes_for,
    native_batch_supported,
    offsets,
    oracle_run,
    parity_ok,
    parity_tol_for,
    run_family,
    run_family_batch,
    run_padded_native_batch,
    run_roll,
    run_roll_batch,
    run_sharded,
    separable_supported,
    sharded_pspec,
    step_fft,
    step_numpy,
    step_padded,
    step_padded_family,
    step_roll,
    step_sep,
)
from mpi_and_open_mp_tpu_torch.stencils.spec import (  # noqa: F401
    GRAY_SCOTT,
    HEAT,
    LENIA,
    LIFE,
    WIREWORLD,
    StencilSpec,
    get,
    make_lenia,
    names,
    register,
)
from mpi_and_open_mp_tpu_torch.stencils.sparse import (  # noqa: F401
    ActiveTileEngine,
)
from mpi_and_open_mp_tpu_torch.stencils.sparse_sharded import (  # noqa: F401
    SparseShardedEngine,
)
