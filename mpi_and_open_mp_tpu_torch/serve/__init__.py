"""The serving layer over the batched kernels.

Counterpart of the JAX package's ``serve`` package, whole:

``batcher``
    :class:`ShapeBucketBatcher`: callers submit independent boards,
    ``flush`` groups them into shape buckets and advances each bucket's
    stack at once (``ops.native_life.life_run_vmem_batch`` for Life, the
    spec's roll engine for other rules).
``policy``
    :class:`ServePolicy`: admission (depth, padding waste), deadlines,
    retry budget; the ``SHED_*`` vocabulary; the fleet's elasticity
    policy and controller.
``queue``
    :class:`ServeQueue` and :class:`Ticket`: the ticket ledger, buckets,
    deadlines, the drain checkpoint's tree (the JAX package's).
``wal``
    :class:`TicketWAL` and :func:`replay`: the write-ahead journal,
    byte-compatible with the JAX package's.
``aotcache``
    :class:`AOTCache`: each bucket's launch record (path, planner
    geometry, library hashes) on disk.
``pool``
    :class:`SessionPool`, :class:`Handle`, :class:`PoolError`: live Life
    sessions resident on the card as bit-lanes of board-sliced slabs,
    stepped by ``bitlife_bitsliced``'s rounds, the last in its tail mode
    (masked merge and change word), with
    spills under a hard budget, compaction and the settled skip.
``daemon``
    :class:`ServingDaemon`: the supervised loop, its engine ladder on the
    card, retries, preemption drain and the resume ladder (journal,
    checkpoint, fresh), and the pool's session methods;
    ``python -m mpi_and_open_mp_tpu_torch.serve.daemon``.
``router``
    :class:`FleetRouter` and :class:`ConsistentHashRing`: session affinity
    over a sha256 ring (JAX's placement for every key), the fleet-wide
    door, work stealing, the wedge ladder (journal replay and re-home),
    rejoin claims and graceful drains of whole buckets and slab groups,
    the fleet books.
``fleet``
    :class:`Fleet` and :class:`WorkerHandle`: N in-process daemons on one
    device behind one router, with elasticity and the telemetry tick;
    ``python -m mpi_and_open_mp_tpu_torch.serve.fleet`` runs the workers
    as processes, spools in and one JSON line out.
``loadgen``
    Open-loop load: seeded Poisson or traced arrivals over a
    :class:`ScenarioMix`, :func:`run_open_loop`, :func:`sweep` and
    :func:`saturation_knee` against an :class:`SLO`.
"""

from mpi_and_open_mp_tpu_torch.serve.batcher import (  # noqa: F401
    ShapeBucketBatcher,
    bucket_batch_size,
    retrace_counts,
)
from mpi_and_open_mp_tpu_torch.serve.policy import (  # noqa: F401
    SCALE_ADD,
    SCALE_DRAIN,
    SHED_DEPTH,
    SHED_DISPATCH,
    SHED_PADDING,
    SHED_REASONS,
    SHED_REHOMED,
    SHED_TIMEOUT,
    ElasticController,
    ElasticityPolicy,
    ServePolicy,
    rollup,
)
from mpi_and_open_mp_tpu_torch.serve.queue import (  # noqa: F401
    ServeQueue,
    Ticket,
)
from mpi_and_open_mp_tpu_torch.serve.wal import (  # noqa: F401
    FSYNC_POLICIES,
    TicketWAL,
    WALReplay,
    replay,
)
from mpi_and_open_mp_tpu_torch.serve.aotcache import AOTCache  # noqa: F401
from mpi_and_open_mp_tpu_torch.serve.pool import (  # noqa: F401
    DEFAULT_DEVICE_BUDGET,
    LANES_PER_PLANE,
    Handle,
    PoolError,
    SessionPool,
)
from mpi_and_open_mp_tpu_torch.serve.daemon import ServingDaemon  # noqa: F401
from mpi_and_open_mp_tpu_torch.serve.router import (  # noqa: F401
    DEFAULT_MISS_K,
    DEFAULT_VNODES,
    ConsistentHashRing,
    FleetRollup,
    FleetRouter,
    affinity_key,
)
from mpi_and_open_mp_tpu_torch.serve.fleet import (  # noqa: F401
    SPOOL_SCHEMA,
    Fleet,
    WorkerHandle,
)
from mpi_and_open_mp_tpu_torch.serve.loadgen import (  # noqa: F401
    SLO,
    LoadgenReport,
    ScenarioMix,
    arrivals_poisson,
    arrivals_trace,
    run_open_loop,
    saturation_knee,
    sweep,
)
