"""Two parities of the port's sharded paths with the JAX package's that no
other test pins: the VTK snapshots of sharded runs, byte for byte, and
``stencils.engine.run_sharded`` in every engine family, within the
family's own tolerance (``parity_tol_for(family)``).

The JAX side runs on the 8 virtual CPU devices of ``conftest.py``, the
port on meshes of 8 virtual shards of the CPU. Boards are small, so each
case stays cheap.
"""

import os

import numpy as np
import pytest

from mpi_and_open_mp_tpu import stencils as jstencils
from mpi_and_open_mp_tpu.models.life import LifeSim as JaxSim
from mpi_and_open_mp_tpu.parallel import mesh as jmesh
from mpi_and_open_mp_tpu.stencils import engine as jengine
from mpi_and_open_mp_tpu.utils.config import load_config as jax_load_config

from mpi_and_open_mp_tpu_torch import LifeSim, load_config, stencils
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RPENTOMINO = os.path.join(ROOT, "tests", "fixtures", "rpentomino_40x32.cfg")


def _meshes(layout):
    """(port mesh on the CPU, JAX mesh): row 8, col 8 or cart 4x2."""
    if layout == "cart":
        return (mesh_lib.make_mesh_2d(4, 2, device="cpu"),
                jmesh.make_mesh_2d(4, 2))
    axis = "x" if layout == "col" else "y"
    return (mesh_lib.make_mesh_1d(8, axis=axis, device="cpu"),
            jmesh.make_mesh_1d(8, axis=axis))


@pytest.mark.parametrize("impl", ["roll", "halo"])
@pytest.mark.parametrize("layout", ["row", "col", "cart"])
def test_sharded_vtk_snapshots_match_jax(tmp_path, layout, impl):
    """``rpentomino_40x32`` (120 steps, a snapshot every 40): the three
    frames of a sharded run are byte-identical in both packages."""
    mesh, jm = _meshes(layout)
    ours = LifeSim(load_config(RPENTOMINO), layout=layout, impl=impl,
                   mesh=mesh, outdir=tmp_path / "port")
    theirs = JaxSim(jax_load_config(RPENTOMINO), layout=layout, impl=impl,
                    mesh=jm, outdir=tmp_path / "jax")
    assert np.array_equal(ours.run(), np.asarray(theirs.run()))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 3 and names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def _run_both(spec_name, family, layout, boundary, board):
    mesh, jm = _meshes(layout)
    kw = dict(layout=layout, fuse_steps=2, boundary_steps=boundary,
              family=family)
    got = stencils.engine.run_sharded(stencils.get(spec_name), board, 4,
                                      mesh=mesh, **kw).numpy()
    want = np.asarray(jengine.run_sharded(jstencils.get(spec_name), board,
                                          4, mesh=jm, **kw))
    return (got, stencils.engine.run_sharded.last_plan.engine, want,
            jengine.run_sharded.last_plan.engine)


@pytest.mark.parametrize("layout", ["row", "col", "cart"])
@pytest.mark.parametrize("workload", ["lenia", "heat", "gray_scott"])
@pytest.mark.parametrize("family", ["offset", "sep", "fft"])
def test_run_sharded_families_match_jax(family, workload, layout):
    """Each family on each layout, coupled rounds and ``boundary_steps=1``:
    stamps equal and boards within ``parity_tol_for(family)``; ``sep``
    on heat and gray_scott (weights of no low rank) is refused by both."""
    spec = stencils.get(workload)
    s = 160 if spec.radius > 1 else 48
    board = spec.init(np.random.default_rng(52), (s, s))
    if family == "sep" and workload != "lenia":
        mesh, jm = _meshes(layout)
        with pytest.raises(ValueError, match="separable"):
            stencils.engine.run_sharded(spec, board, 4, mesh=mesh,
                                        layout=layout, fuse_steps=2,
                                        family=family)
        with pytest.raises(ValueError, match="separable"):
            jengine.run_sharded(jstencils.get(workload), board, 4, mesh=jm,
                                layout=layout, fuse_steps=2, family=family)
        return
    tol = stencils.parity_tol_for(family)
    assert tol == jstencils.parity_tol_for(family)
    for boundary in (None, 1):
        got, stamp, want, jstamp = _run_both(workload, family, layout,
                                             boundary, board)
        assert stamp == jstamp, boundary
        assert got.shape == want.shape and got.dtype == want.dtype
        assert stencils.parity_ok(spec, got, want, **tol), boundary
