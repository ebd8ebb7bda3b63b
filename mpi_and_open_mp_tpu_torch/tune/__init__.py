"""Autotuner and durable plan store.

Counterpart of ``mpi_and_open_mp_tpu/tune``: ``tune.space`` enumerates the
legal candidates for one (workload, stack shape, topology) on the port's
paths and gates; ``tune.runner`` holds each against the NumPy oracle and
times it on the device by chain differencing; ``tune.plans`` persists the
winner as a CRC-framed ``momp-plan/1`` record under the digest
``serve/aotcache.py`` computes, so one directory holds the choice
(``<digest>.plan``) beside its launch record (``<digest>.aot``), both
quarantined when corrupt or stale. An installed plan steers
``ops.native_life.native_path_batch`` ahead of the static ladder.

Knobs: ``MOMP_TUNE_PLANS`` names a store (the Life CLI's ``--plans``);
``MOMP_TUNE=0`` is the kill switch (the ladder only, the store untouched);
``MOMP_TUNE_FUSE_DEPTHS`` and ``MOMP_TUNE_SPARSE_FUSE`` widen the sharded
depths enumerated.
"""

from mpi_and_open_mp_tpu_torch.tune.plans import (  # noqa: F401
    PLAN_MAGIC,
    PLAN_SCHEMA,
    PlanError,
    PlanStore,
    fingerprint_for,
    load_plan,
    save_plan,
)
from mpi_and_open_mp_tpu_torch.tune.runner import tune, tune_sharded  # noqa: F401
from mpi_and_open_mp_tpu_torch.tune.space import (  # noqa: F401
    Candidate,
    axis_orders,
    candidates,
    heuristic_path,
    runner_for,
    sharded_candidates,
)
