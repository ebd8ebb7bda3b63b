"""Shard meshes of one device (``mesh``), their ghost exchange (``halo``)
and its persistent overlap plans (``haloplan``), for the sharded Life
layouts; and long-context attention (``context``): flash attention on one
card, and ring and Ulysses attention over virtual shards of it."""

from mpi_and_open_mp_tpu_torch.parallel.context import (  # noqa: F401
    attention_reference,
    flash_attention,
    gated_parity_check,
    ring_attention,
    ring_hop_bwd_engine_for,
    ring_hop_engine_for,
    ulysses_attention,
    zigzag_order,
    zigzag_shard,
    zigzag_unshard,
)
