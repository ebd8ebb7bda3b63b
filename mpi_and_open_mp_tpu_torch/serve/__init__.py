"""Micro-batching front door over the batched Life engines.

Callers :meth:`~ShapeBucketBatcher.submit` independent boards;
:meth:`~ShapeBucketBatcher.flush` groups them into shape buckets and
advances each bucket's stack at once through
``ops.native_life.life_run_vmem_batch``. ``serve.aotcache`` keeps the
launch record of each bucket (path, planner geometry, library hashes) on
disk. Counterpart of the JAX package's ``serve`` package (its batcher and
AOT cache; the policy, queue, journal, pool, daemon and fleet are not
ported yet).
"""

from mpi_and_open_mp_tpu_torch.serve.batcher import (  # noqa: F401
    ShapeBucketBatcher,
    bucket_batch_size,
    retrace_counts,
)
