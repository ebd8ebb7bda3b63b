"""The RDMA rung across processes, on the CPU: the tables that point the
unchanged kernels into the ring neighbours' windows.

On the card ``ops.native_halo`` launches ``halo_frame`` and
``halo_edge_pair`` over one process's run of shards, on tables of element
offsets into this rank's window slot and its neighbours'
(``parallel.peers``). Those kernels and windows run only on the card
(``chip_smoke.py`` phase 30 and ``tests/_torch_dist_worker.py`` there);
here the tables are held to the one-process tables: every source that a
run's table names, mapped through the ranks' runs to a global shard,
must be the source the one-process table names for that shard, for row,
col and cart, 2 and 4 processes and runs of 1 and 2 shards. The offsets'
check against the element size, and the refusal of a window without a
run across processes, are held too.
"""

import numpy as np
import pytest
import torch

from mpi_and_open_mp_tpu_torch.ops import native_halo
from mpi_and_open_mp_tpu_torch.parallel import peers

# (layout, the axis that spans the processes, the mesh's other extent).
LAYOUTS = [("row", "y", 1), ("col", "x", 1), ("cart", "y", 2),
           ("cart", "y", 3)]
PROCS = [2, 4]
RUNS = [1, 2]


def _mesh(span, other, procs, run):
    n = procs * run
    return (n, other) if span == "y" else (other, n)


def _run_extent(mesh_axes, span, procs):
    py, px = mesh_axes
    return (py // procs, px) if span == "y" else (py, px // procs)


def _global(span, rank, local, ly, lx, n):
    """Global (i, j) of local shard ``local`` of rank ``rank``'s run."""
    i, j = divmod(local, lx)
    return (i + rank * n, j) if span == "y" else (i, j + rank * n)


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("procs", PROCS)
@pytest.mark.parametrize("layout,span,other", LAYOUTS,
                         ids=["row", "col", "cart-x2", "cart-x3"])
def test_run_frame_table_maps_to_one_process_table(layout, span, other,
                                                   procs, run):
    """Every rank's run table, its (holder, offset) pairs decoded to
    global shards, names each local shard's nine sources as
    ``frame_table`` on the whole stack names them."""
    mesh_axes = _mesh(span, other, procs, run)
    py, px = mesh_axes
    ly, lx = _run_extent(mesh_axes, span, procs)
    # Element strides of a stack of shards of 5 x 7 cells (3 channels).
    per = 3 * 5 * 7
    one = native_halo.frame_table(py, px, layout, (px * per, per),
                                  torch.device("cpu")).numpy()
    run_strides = (lx * per, per)
    for rank in range(procs):
        owners, offsets = native_halo.run_frame_table(
            mesh_axes, layout, span, procs, rank, run_strides)
        assert owners.shape == offsets.shape == (9, ly * lx)
        assert owners.dtype == offsets.dtype == np.int64
        for s in range(ly * lx):
            gi, gj = _global(span, rank, s, ly, lx, run)
            for k in range(9):
                r, off = owners[k, s], offsets[k, s]
                assert 0 <= r < procs and off % per == 0
                si, sj = _global(span, r, off // per, ly, lx, run)
                want = one[k, gi * px + gj]
                assert si * px * per + sj * per == want, (rank, s, k)
            # A source on another rank is a ring neighbour's.
            assert set(owners[:, s].tolist()) <= {
                rank, (rank - 1) % procs, (rank + 1) % procs}


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("procs", PROCS)
@pytest.mark.parametrize("layout,span,other", LAYOUTS,
                         ids=["row", "col", "cart-x2", "cart-x3"])
def test_run_edge_table_maps_to_one_process_table(layout, span, other,
                                                  procs, run):
    """Every rank's read-side edge table sends each local shard the edge
    that ``_offset_table``'s write-side table sends it on the whole stack:
    its predecessor's forward edge into ``from_prev``, its successor's
    backward edge into ``from_next``, along the spanning axis."""
    mesh_axes = _mesh(span, other, procs, run)
    py, px = mesh_axes
    ly, lx = _run_extent(mesh_axes, span, procs)
    per = 2 * 3 * 4
    one = native_halo._offset_table(py, px, span, (px * per, per),
                                    (px * per, per), per,
                                    torch.device("cpu")).numpy()
    # The one-process table, read-side: destination shard -> source shard.
    want_prev = {one[2, s] // per: one[0, s] // per for s in range(py * px)}
    want_next = {one[3, s] // per: one[1, s] // per for s in range(py * px)}
    local = ly * lx
    for rank in range(procs):
        owners, offsets = native_halo.run_edge_table(mesh_axes, span, procs,
                                                     rank, per)
        assert owners.shape == (2, local) and offsets.shape == (4, local)
        np.testing.assert_array_equal(offsets[2], np.arange(local) * per)
        np.testing.assert_array_equal(offsets[3], np.arange(local) * per)
        for t in range(local):
            gi, gj = _global(span, rank, t, ly, lx, run)
            g = gi * px + gj
            # Row 0 reads forward edges (the first half of a slot), row 1
            # backward edges (the second half).
            for row, base, want in ((0, 0, want_prev),
                                    (1, local * per, want_next)):
                r, off = owners[row, t], offsets[row, t] - base
                assert 0 <= off < local * per and off % per == 0
                si, sj = _global(span, r, off // per, ly, lx, run)
                assert si * px + sj == want[g], (rank, t, row)
                assert r in {(rank - 1) % procs, rank, (rank + 1) % procs}


def _fake_window(ptrs, rank=0):
    w = object.__new__(peers.Window)
    w.rank, w.ptrs = rank, ptrs
    return w


def test_window_offsets_add_each_holders_distance():
    """A table's offsets count from this rank's slot: a neighbour's
    entries move by its window's distance, in elements."""
    w = _fake_window({0: 1 << 20, 1: (1 << 20) + 4096 * 3, 3: 1 << 16})
    owners = np.array([[0, 1, 3], [1, 1, 0]], np.int64)
    offsets = np.array([[5, 6, 7], [0, 1, 2]], np.int64)
    got = w.offsets(owners, offsets, 4)
    np.testing.assert_array_equal(got, [[5, 6 + 3072, 7 - 245760],
                                        [3072, 3073, 2]])
    np.testing.assert_array_equal(offsets, [[5, 6, 7], [0, 1, 2]])


def test_window_offsets_refuse_a_distance_off_the_element_size():
    """A window whose distance from this rank's does not divide by the
    element size cannot be named by an element offset: refused."""
    w = _fake_window({0: 1 << 20, 1: (1 << 20) + 4098})
    owners = np.array([[0, 1]], np.int64)
    offsets = np.zeros((1, 2), np.int64)
    with pytest.raises(ValueError, match="not a multiple of the 4-byte"):
        w.offsets(owners, offsets, 4)
    assert w.offsets(owners, offsets, 2)[0, 1] == 2049


def test_window_needs_a_run_across_processes():
    """Without a world of several processes there is no neighbour to map:
    a window refuses before it allocates anything."""
    with pytest.raises(RuntimeError, match="run across processes"):
        peers.Window(256, torch.device("cuda"))
