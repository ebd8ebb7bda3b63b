"""Game-of-Life simulation: one board, its stepper, and snapshot IO.

Counterpart of ``mpi_and_open_mp_tpu/models/life.py:LifeSim``. Layouts,
as the reference's four Life drivers:

* ``layout="row"`` (the default) - 1-D row strips (``3-life/life_mpi.c``);
* ``layout="col"`` - 1-D column strips (``4-life/life_mpi.c``);
* ``layout="cart"`` - 2-D Cartesian blocks (``6-cartesian/life_cart.c``);
* ``layout="serial"`` - the single-process oracle (``3-life/life2d.c``).

A sharded layout holds the board as the stacked shards of a
``parallel.mesh.Mesh`` (``(py, px, *C, hs, ws)``, every shard on one
device: virtual shards of the CPU or of one card), the counterpart of the
JAX package's one ``jax.Array`` sharded over a device mesh. On a mesh
across processes (``parallel.procs``) each process holds its run of the
mesh's first axis (y for row and cart, x for col); :meth:`collect` gathers
the board in every process (a collective), and only process 0 writes
snapshots and checkpoints, as the JAX package's ``collect`` and
``save_snapshot`` do. Its step is

* ``impl="roll"``: the global torus step by shifts. Any board size: a
  board that does not divide the mesh is stored padded to the next even
  multiple and un- and re-padded every step, so the torus stays on the
  logical ``(ny, nx)``;
* ``impl="halo"``: rounds of a depth-``k`` ghost exchange between the
  shards (``parallel.halo``) then ``k = fuse_steps`` local steps of the
  padded blocks, scheduled by a persistent plan that overlaps interior
  and boundary when the geometry allows (``parallel.haloplan``). The
  board must divide the mesh;
* ``impl="native"`` (the JAX package's ``"pallas"``): like ``halo``, the
  local step on the hand-written kernel - Life's padded step
  (``ops.native_life.life_step_padded_native``) or any other spec's
  (``ops.native_stencil.stencil_step_padded``), one launch over every
  shard. A 1-shard mesh runs Life through the serial resident kernels;
* ``impl="bitfused"``: each shard holds a bit-packed slab
  (``ops.bitlife``), exchanges up to 4 halo words (128 rows) and up to 128
  halo columns, then runs up to 128 fused steps before the next exchange:
  one launch of the window kernel over every shard when a shard's window
  fits shared memory (``"window"``), else the fused kernel per shard
  (``"tiled"``); row shards of an exact frame split each round into
  interior and edges (``"window+overlap:packed"``). Any board shape the
  planner (``bitlife.plan_sharded_bits``) accepts: unaligned boards live
  in a padded frame kept on the torus by mirror rows and columns. On the
  card a 1-shard mesh dispatches to the serial kernels
  (``"serial-1dev:<path>"``).

``impl="auto"``: serial boards pick ``native`` on the card and ``roll`` on
the CPU; sharded layouts pick ``bitfused`` on the card whenever the
planner covers the geometry, else ``halo`` when the board divides the
mesh, else ``roll`` (on the CPU never ``bitfused``, as the JAX package
off the TPU). ``plan_note`` names the schedule a sharded run takes, with
the JAX package's strings.

A stacked ``(B, ny, nx)`` ``initial_board`` puts the sim in batched mode
(serial layout only): all B boards advance together through
``ops.native_life.life_run_vmem_batch`` (``impl="native"``, which
``auto`` means on every device) or the roll step over the stack. Batched
runs have no snapshot channel, and ``debug_check`` holds every board
against the oracle on its own.

Any other registered stencil workload (``workload="heat"``, ``"gray_scott"``,
``"wireworld"``, ``"lenia"``, ...) runs through the same roll and halo
machinery in the spec's dtype, channels leading; ``native`` takes the
padded kernel on sharded layouts. The default board is
``spec.init(np.random.default_rng(0xD1CE), cfg.shape)``; ``auto`` means
``halo`` when the board divides the mesh, else ``roll``. The bit-packed
engines (``bitfused``, serial ``native``, batched mode) are Life only.

The run loop keeps the reference's order (``3-life/life_mpi.c:51-62``): at
step ``i``, save a snapshot when ``i % save_steps == 0`` (before stepping),
then advance. Between snapshots the board advances in one call.

Checkpoints and resume (the JAX package's, ``models/life.py:1006-1091``):
``checkpoint_dir`` adds a restart channel beside the VTK snapshots, one
``MOMP-STATE/1`` file ``step_NNNNNN.state`` of the logical uint8 board at
every save point and, with ``checkpoint_every=N``, every N steps
(``utils.checkpoint``); :meth:`LifeSim.from_checkpoint` and
:meth:`LifeSim.from_snapshot` resume on any layout, mesh and impl. While a
run that checkpoints is in ``run()``, SIGTERM or SIGINT flushes a
checkpoint at the next segment boundary and raises
``robust.preempt.Preempted`` (the CLI's exit 75). An active ``MOMP_CHAOS``
plan may fault the ghost exchanges, delay segments or preempt at a fixed
step; the guard (armed by the plan or ``MOMP_GUARD=1``, off by default)
checks each segment against the oracle and re-runs it clean, stamping
``recoveries``. With no save, no checkpoint cadence, no plan and no guard,
``run()`` advances the whole budget in one call. Checkpoints hold Life
boards only: the JAX package's restore casts every board to uint8, so
other workloads and batched sims refuse ``checkpoint_dir``.

Observability (``obs``), as the JAX package's: ``run()`` wraps the whole
advance of the default path in a ``life.advance`` span and each segment
of the loop in a ``life.segment`` span, each anchored on the board (a
sync only while ``MOMP_TRACE`` is set); the roll, halo and packed
advances tick ``jit.retrace{fn=life_advance_*}`` the first time a sim
runs them at a step count (the packed one once: its count is a run-time
scalar in the JAX package too), where the JAX package compiles a
program.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.obs import metrics, trace
from mpi_and_open_mp_tpu_torch.ops import (
    bitlife, life_ops, native_life, native_stencil)
from mpi_and_open_mp_tpu_torch.parallel import halo, haloplan
from mpi_and_open_mp_tpu_torch.parallel import mesh as mesh_lib
from mpi_and_open_mp_tpu_torch.robust import chaos, guards, preempt
from mpi_and_open_mp_tpu_torch.utils import checkpoint as checkpoint_lib
from mpi_and_open_mp_tpu_torch.utils import vtk as vtk_lib
from mpi_and_open_mp_tpu_torch.utils.config import LifeConfig
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device
from mpi_and_open_mp_tpu_torch.utils.timing import sync

LAYOUTS = ("serial", "row", "col", "cart")
IMPLS = ("auto", "roll", "halo", "native", "bitfused")

# On the CPU a 1-shard bitfused mesh runs the exchange machinery (so the
# tests exercise what the card's serial dispatch bypasses); tests flip
# this to cover the dispatch itself.
_BITFUSED_1DEV_SERIAL_ON_CPU = False


def _default_mesh(layout: str, device) -> mesh_lib.Mesh | None:
    if layout == "serial":
        return None
    if layout == "row":
        return mesh_lib.make_mesh_1d(axis="y", device=device)
    if layout == "col":
        return mesh_lib.make_mesh_1d(axis="x", device=device)
    return mesh_lib.make_mesh_2d(device=device)


def _mesh_divisors(layout: str, mesh) -> tuple[int, int]:
    """(py, px) the board axes are split into under ``layout``."""
    if layout == "serial" or mesh is None:
        return (1, 1)
    return stencils.engine.mesh_axes_for(layout, mesh)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


class LifeSim:
    """One Life run: board state on a device (stacked shards for a
    sharded layout), its stepper, snapshot IO."""

    def __init__(
        self,
        cfg: LifeConfig,
        layout: str = "row",
        impl: str = "auto",
        mesh: mesh_lib.Mesh | None = None,
        fuse_steps: int = 1,
        device: str | torch.device | None = None,
        outdir: str | os.PathLike | None = None,
        checkpoint_dir: str | os.PathLike | None = None,
        checkpoint_every: int = 0,
        initial_board: np.ndarray | None = None,
        initial_step: int = 0,
        workload: str = "life",
    ):
        if mesh is not None:
            if (device is not None
                    and resolve_device(device).type != mesh.device.type):
                raise ValueError(f"device={device!r} differs from the "
                                 f"mesh's device {mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device("cuda" if device is None else device)
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.workload = str(workload)
        self.spec = stencils.get(self.workload)
        if self.workload != "life":
            if impl == "bitfused":
                raise ValueError(
                    "impl='bitfused' is a bit-packed Life engine; "
                    f"workload={self.workload!r} runs 'roll', 'halo' or "
                    "'native' (sharded)")
            if impl == "native" and layout == "serial":
                raise ValueError(
                    "serial impl='native' runs the bit-packed Life kernels; "
                    f"workload={self.workload!r} uses impl='roll' (or "
                    "'auto'), or 'native' on a sharded layout")
        # Batched mode: a stacked (B, ny, nx) initial board. Serial layout
        # only, and no snapshot or checkpoint channel.
        self.batch: int | None = None
        if (initial_board is not None and np.asarray(initial_board).ndim
                == 3 + (self.spec.channels > 1)):
            if self.workload != "life":
                # A 3-D multi-channel array is one board (channels lead).
                raise ValueError(
                    f"workload={self.workload!r} has no batched mode; "
                    "submit stacks through the serve batcher instead")
            if layout != "serial":
                raise ValueError(
                    "stacked (B, ny, nx) boards need layout='serial'; "
                    "sharded layouts advance one board per program")
            if impl in ("halo", "bitfused"):
                raise ValueError(
                    f"impl={impl!r} has no batched form; use 'auto', "
                    "'native' (batched kernels) or 'roll'")
            if outdir is not None or checkpoint_dir is not None:
                raise ValueError(
                    "batched runs have no snapshot/checkpoint channels "
                    "(both serialise one board); drop outdir/checkpoint_dir")
            self.batch = int(np.asarray(initial_board).shape[0])
        if checkpoint_dir is not None and self.workload != "life":
            raise ValueError(
                f"checkpoint_dir holds Life boards (uint8); workload="
                f"{self.workload!r} would resume truncated by the JAX "
                "package's restore, which casts every board to uint8")
        self.cfg = cfg
        self.layout = layout
        self.mesh = (None if layout == "serial" else
                     mesh if mesh is not None
                     else _default_mesh(layout, self.device))
        self.fuse_steps = max(1, int(fuse_steps))
        on_card = self.device.type == "cuda"
        py, px = _mesh_divisors(layout, self.mesh)
        self._py, self._px = py, px
        divisible = cfg.ny % py == 0 and cfg.nx % px == 0
        plan = None
        if (impl in ("auto", "bitfused") and self.workload == "life"
                and layout != "serial"):
            plan = bitlife.plan_sharded_bits(
                cfg.shape, py, px, y_sharded=layout in ("row", "cart"),
                x_sharded=layout in ("col", "cart"))
        if impl == "auto" and self.workload != "life":
            impl = "halo" if (layout != "serial" and divisible) else "roll"
        elif impl == "auto":
            if self.batch is not None:
                # A stack takes the batched dispatch on every device.
                impl = "native"
            elif layout == "serial":
                impl = "native" if on_card else "roll"
            elif on_card and plan is not None:
                impl = "bitfused"
            elif divisible:
                impl = "halo"
            else:
                impl = "roll"
        if impl == "halo" and layout == "serial":
            raise ValueError(
                "impl='halo' needs a sharded layout (row/col/cart); serial "
                "runs use impl='roll' or 'native'")
        if impl in ("halo", "native") and layout != "serial" and not divisible:
            raise ValueError(
                f"impl={impl!r} needs board {cfg.shape} divisible by mesh "
                f"{self.mesh.shape}; use impl='roll' (uneven shards OK)")
        if impl == "bitfused":
            if layout == "serial":
                raise ValueError(
                    "impl='bitfused' needs a sharded layout (row/col/cart); "
                    "serial big boards already take the fused kernel via "
                    "impl='native'")
            if plan is None:
                raise ValueError(
                    f"impl='bitfused' can't plan board {cfg.shape} over mesh "
                    f"{self.mesh.shape}: a shard is too small to carry a "
                    "fused halo next to its frame padding; use impl='halo' "
                    "or 'roll'")
        self.impl = impl
        self._plan = plan if impl == "bitfused" else None
        if impl in ("halo", "native") and layout != "serial":
            local = min(cfg.ny // py, cfg.nx // px)
            if self.fuse_steps * self.spec.radius > local:
                raise ValueError(
                    f"fuse_steps={self.fuse_steps} x radius "
                    f"{self.spec.radius} exceeds the smallest local shard "
                    f"extent ({local}); a halo cannot be deeper than the "
                    "shard it pads")
        # Uneven boards are stored padded: to the next mesh-even multiple,
        # or to the packed path's frame.
        if self._plan is not None:
            self.padded_shape = self._plan.frame
        elif layout == "serial":
            self.padded_shape = cfg.shape
        else:
            self.padded_shape = (_ceil_to(cfg.ny, py), _ceil_to(cfg.nx, px))
        self.native_path = None  # the serial kernels' path, when they run
        self.plan_note = None    # the sharded schedule (JAX's plan_note)
        self.outdir = os.fspath(outdir) if outdir is not None else None
        self.checkpoint_dir = (os.fspath(checkpoint_dir)
                               if checkpoint_dir is not None else None)
        # Steps between restart points inside run() (0: only the save
        # cadence writes them), and the guard's recovery provenance.
        self.checkpoint_every = max(0, int(checkpoint_every))
        self.recoveries: list[str] = []
        self.step_count = int(initial_step)
        self._initial_step = int(initial_step)
        if initial_board is not None:
            board = np.asarray(initial_board, dtype=self.spec.np_dtype)
            expect = (self.spec.board_shape(*cfg.shape) if self.batch is None
                      else (self.batch, *cfg.shape))
            if board.shape != expect:
                raise ValueError(
                    f"initial_board {board.shape} != expected {expect}")
        elif self.workload == "life":
            board = cfg.board()
        else:
            # The cfg's cell list encodes a Life pattern; other specs bring
            # their own initialiser.
            board = self.spec.init(np.random.default_rng(0xD1CE), cfg.shape)
        self._initial = board
        self._probe = None
        self._retraced: set = set()
        self._advance = self._build_advance()
        self.board = self._place(board)

    # ------------------------------------------------------- board placement

    def _place(self, board: np.ndarray) -> torch.Tensor:
        """A host board (logical shape) as the stored state: on the device,
        padded to ``padded_shape`` and split into stacked shards for a
        sharded layout."""
        t = torch.from_numpy(np.ascontiguousarray(board)).to(self.device)
        if self.layout == "serial":
            return t
        ny, nx = self.cfg.shape
        fy, fx = self.padded_shape
        if (fy, fx) != (ny, nx):
            t = F.pad(t, (0, fx - nx, 0, fy - ny))
        return mesh_lib.local_part(mesh_lib.shard(t, self._py, self._px),
                                   self.mesh)

    def _global(self, board: torch.Tensor) -> torch.Tensor:
        """The stored state as the logical ``(*C, ny, nx)`` board (or the
        ``(B, ny, nx)`` stack), on the device: gathered from every process
        on a mesh across processes (a collective)."""
        if self.layout == "serial":
            return board
        ny, nx = self.cfg.shape
        return mesh_lib.unshard(mesh_lib.gather(board, self.mesh))[
            ..., :ny, :nx]

    # ---------------------------------------------------------- step builders

    def _halo_plan(self, k: int) -> haloplan.HaloPlan:
        """The persistent exchange plan for one ``k``-step fused round."""
        py, px = self._py, self._px
        return haloplan.plan_halo(
            self.layout, (py, px),
            (self.padded_shape[0] // py, self.padded_shape[1] // px),
            self.spec.radius, k, channels=self.spec.channels,
            device=self.device)

    def _padded_step(self, padded: torch.Tensor) -> torch.Tensor:
        """One step of every shard's halo-padded block (the stack)."""
        if self.impl == "native":
            if self.workload == "life":
                return native_life.life_step_padded_native(padded)
            return native_stencil.stencil_step_padded(self.spec, padded)
        return stencils.engine.channels_first(
            self.spec, padded,
            lambda b: stencils.step_padded(self.spec, b, torch))

    def _counted(self, fn: str, advance, per_count: bool = True):
        """``advance`` that ticks ``jit.retrace{fn=...}`` the first time
        this sim runs it at a step count (at all, with ``per_count``
        False): where the JAX package compiles its program."""
        def counted(board, n):
            metrics.inc_once(self._retraced, (fn, int(n) if per_count
                                              else None),
                             "jit.retrace", fn=fn)
            return advance(board, n)

        return counted

    def _build_advance(self):
        """``advance(board, n)``: the stored state advanced ``n`` steps (the
        argument itself is untouched)."""
        if self.layout == "serial":
            return self._build_serial_advance()
        if self.impl == "bitfused":
            return self._build_bitfused_advance()
        if (self.impl == "native" and self.workload == "life"
                and self.mesh.size == 1):
            # One shard: the whole board on the serial resident kernels.
            self.native_path = native_life.native_path(
                self.cfg.shape, on_card=self.device.type == "cuda")
            return lambda board, n: mesh_lib.shard(
                native_life.life_run_vmem(mesh_lib.unshard(board), n), 1, 1)
        if self.impl == "roll":
            return self._counted("life_advance_roll",
                                 self._build_roll_advance())
        # halo / native: rounds of k fused steps per exchange.
        k = self.fuse_steps
        plan_k = self._halo_plan(k)
        self.plan_note = plan_k.engine

        def advance(board, n):
            rounds, rem = divmod(int(n), k)
            for _ in range(rounds):
                board = haloplan.fused_step(plan_k, self._padded_step, board)
            if rem:
                board = haloplan.fused_step(self._halo_plan(rem),
                                            self._padded_step, board)
            return board

        return self._counted("life_advance_halo", advance)

    def _build_serial_advance(self):
        on_card = self.device.type == "cuda"
        if self.impl == "native":
            if self.batch is not None:
                self.native_path = "batch:" + native_life.native_path_batch(
                    (self.batch, *self.cfg.shape), on_card=on_card)
                return native_life.life_run_vmem_batch
            self.native_path = native_life.native_path(self.cfg.shape,
                                                       on_card=on_card)
            return native_life.life_run_vmem
        if self.workload != "life":
            return self._counted("life_advance_roll", lambda board, n: (
                stencils.run_roll(self.spec, board, n)))

        def advance(board, n):
            for _ in range(int(n)):
                board = life_ops.life_step_roll(board)
            return board

        return self._counted("life_advance_roll" if self.batch is None
                             else "life_advance_roll_batch", advance)

    def _build_roll_advance(self):
        """The global torus step over the assembled shards, un- and
        re-padded every step when the board does not divide the mesh."""
        ny, nx = self.cfg.shape
        fy, fx = self.padded_shape
        py, px = self._py, self._px

        def advance(board, n):
            b = mesh_lib.unshard(mesh_lib.gather(board, self.mesh))
            for _ in range(int(n)):
                if (fy, fx) != (ny, nx):
                    v = stencils.step_roll(self.spec, b[..., :ny, :nx])
                    b = F.pad(v, (0, fx - nx, 0, fy - ny))
                else:
                    b = stencils.step_roll(self.spec, b)
            return mesh_lib.local_part(mesh_lib.shard(b, py, px), self.mesh)

        return advance

    def _build_bitfused_advance(self):
        """The packed path: pack the shards once per call, then rounds of
        an exchange of packed halos and ``min(rem, k_max)`` fused steps."""
        plan = self._plan
        on_card = self.device.type == "cuda"
        ny, nx = self.cfg.shape
        fy, fx = plan.frame
        if self.mesh.size == 1 and (on_card or _BITFUSED_1DEV_SERIAL_ON_CPU):
            # No neighbours: the serial whole-board kernels, without the
            # halo window's redundant rows or the per-round exchange.
            self.native_path = native_life.native_path((ny, nx),
                                                       on_card=on_card)
            self.plan_note = f"serial-1dev:{self.native_path}"

            def advance(board, n):
                b = mesh_lib.unshard(board)[:ny, :nx].contiguous()
                out = F.pad(native_life.life_run_vmem(b, n),
                            (0, fx - nx, 0, fy - ny))
                return mesh_lib.shard(out, 1, 1)

            return self._counted("life_advance_bitfused", advance,
                                 per_count=False)

        # Window-mode row shards of an exact frame split each round into
        # the interior and two 3h-word edge windows (haloplan's gates).
        hp = None
        if bitlife.plan_overlap_supported(plan):
            hp = haloplan.plan_halo(
                "row", (plan.py, plan.px), (32 * plan.nw_s, plan.W),
                32 * plan.h, 1, pack_layout="packed", device=self.device)
        use_overlap = hp is not None and hp.overlap
        self.plan_note = f"{plan.mode}+{hp.engine}" if hp else plan.mode
        step_call = bitlife.make_plan_stepper(plan)
        if use_overlap:
            interior_call, edge_call = bitlife.make_overlap_steppers(plan)
        h, hx = plan.h, plan.hx

        def one_round(q, k):
            if use_overlap:
                top, bot = haloplan.packed_ghosts_y(q, h)
                mid = interior_call(k, q)
                lead = edge_call(k, torch.cat([top, q[..., : 2 * h, :]], -2))
                tail = edge_call(k, torch.cat([q[..., -2 * h:, :], bot], -2))
                return torch.cat([lead, mid, tail], dim=-2)
            # x first, then y on the x-extended shards: the corners ride
            # the y exchange. An unsharded axis wraps locally.
            e = q
            if plan.x_sharded:
                e = halo.packed_halo_x(e, "x", hx, pad=plan.pad_x)
            elif hx:
                e = torch.cat([e[..., -hx:], e, e[..., :hx]], dim=-1)
            if plan.y_sharded:
                e = halo.packed_halo_y(e, "y", h, pad=plan.pad_y)
            else:
                e = bitlife.local_wrap_y(plan, e)
            return step_call(k, e.contiguous())

        def advance(board, n):
            q = bitlife.pack_board_exact(board)
            rem = int(n)
            while rem > 0:
                k = min(rem, plan.k_max)
                q = one_round(q, k)
                rem -= k
            return bitlife.unpack_board_exact(q)

        return self._counted("life_advance_bitfused", advance,
                             per_count=False)

    # ------------------------------------------------------------ public API

    def step(self, n: int = 1) -> None:
        """Advance ``n`` steps."""
        self.board = self._advance(self.board, int(n))
        self.step_count += int(n)

    def sync(self) -> None:
        """Wait for all queued device work on the board to finish (the
        timing analog of the reference's ``MPI_Wtime`` bracket)."""
        sync(self.board)

    def reset(self) -> None:
        """Restore the initial board."""
        self.board = self._place(self._initial)
        self.step_count = self._initial_step

    def _next_stop(self, i: int, save: bool) -> int:
        """First step index after ``i`` where run() pauses the advance: the
        end of the budget, a snapshot or checkpoint boundary, or a pending
        simulated preemption (a segment never straddles it: the flush
        happens exactly there)."""
        cfg = self.cfg
        stops = [cfg.steps]
        if save and cfg.save_steps > 0:
            stops.append((i // cfg.save_steps + 1) * cfg.save_steps)
        ck = self.checkpoint_every
        if self.checkpoint_dir is not None and ck > 0:
            stops.append((i // ck + 1) * ck)
        plan = chaos.active_plan()
        if plan is not None and plan.preempt_pending(i):
            stops.append(plan.preempt_step)
        return min(s for s in stops if s > i)

    def _segment_lengths(self, save: bool = True) -> list[int]:
        """Distinct ``advance`` step counts a full ``run()`` will request."""
        save = (save and self.cfg.save_steps > 0
                and (self.outdir is not None
                     or self.checkpoint_dir is not None))
        i = self.step_count
        lengths = set()
        while i < self.cfg.steps:
            next_stop = self._next_stop(i, save)
            lengths.add(next_stop - i)
            i = next_stop
        return sorted(lengths)

    def warmup(self) -> None:
        """Run every segment length ``run()`` will use once on the current
        board and discard the result: builds the kernels (at first use) so
        that no build lands inside a timed bracket."""
        for n in self._segment_lengths():
            sync(self._advance(self.board, n))

    def collect(self) -> np.ndarray:
        """The board on the host, ``(ny, nx)`` in the spec's dtype (uint8
        for Life; ``(B, ny, nx)`` in batched mode, channels leading for a
        multi-channel spec), cropped from the padded frame and gathered
        from the shards."""
        return self._global(self.board).cpu().numpy().astype(
            self.spec.np_dtype, copy=False)

    def _divergence(self, got: np.ndarray, want: np.ndarray) -> str | None:
        """How ``got`` differs from the oracle's ``want``, or None: the
        differing cells, and in batched mode every diverging board."""
        if stencils.parity_ok(self.spec, got, want):
            return None
        off = (~np.isclose(got, want, rtol=1e-5, atol=1e-6)
               if self.spec.is_float else got != want)
        why = f"{int(off.sum())} cells diverge from the oracle"
        if self.batch is not None:
            bad = [f"board {b}: {int((got[b] != want[b]).sum())}"
                   for b in range(self.batch)
                   if not np.array_equal(got[b], want[b])]
            why += f" ({'; '.join(bad)})"
        return why

    def _oracle_step(self, board: np.ndarray) -> np.ndarray:
        if self.workload == "life":
            return life_ops.life_step_numpy(board)  # a stack steps per board
        return stencils.step_numpy(self.spec, board)

    def _consistency_violation(self) -> str | None:
        """One step of the configured stepper must equal one oracle
        (NumPy) step (within ``parity_ok`` for float specs), on the live
        board and on a fixed probe board (B distinct ones in batched mode),
        both placed as the live board is (padded, sharded); returns a
        description of the first failure, or None."""
        before = self.collect()
        if not self.spec.valid_board(before):
            return ("non-binary cells on the board" if self.workload == "life"
                    else "out-of-domain cells on the board")
        after = self._global(self._advance(self.board, 1)).cpu().numpy()
        why = self._divergence(after, self._oracle_step(before))
        if why is not None:
            return f"{why} after one {self.impl}/{self.layout} step"
        if self._probe is None:
            rng = np.random.default_rng(0xC0FFEE)
            if self.workload == "life":
                shape = self.cfg.shape
                if self.batch is not None:
                    shape = (self.batch, *shape)
                host = rng.integers(0, 2, shape, dtype=np.uint8)
            else:
                # The spec's own initialiser is the probe state.
                host = np.asarray(self.spec.init(rng, self.cfg.shape),
                                  dtype=self.spec.np_dtype)
            self._probe = (self._place(host), self._oracle_step(host))
        probe, probe_expect = self._probe
        after = self._global(self._advance(probe, 1)).cpu().numpy()
        why = self._divergence(after, probe_expect)
        if why is not None:
            return (f"{why} after one {self.impl}/{self.layout} step on the "
                    "fixed probe board")
        return None

    def debug_check(self) -> None:
        """Assert that one step of the stepper matches the oracle; raises
        AssertionError with a cell-diff count on mismatch."""
        why = self._consistency_violation()
        if why is not None:
            raise AssertionError(f"debug check failed: {why}")

    def save_snapshot(self) -> str:
        if self.outdir is None:
            raise ValueError("LifeSim(outdir=...) required to save")
        path = vtk_lib.vtk_path(self.outdir, self.step_count)
        board = self.collect()
        if self._writes_files():
            os.makedirs(self.outdir, exist_ok=True)
            vtk_lib.write_vtk(path, board)
        return path

    def _writes_files(self) -> bool:
        """Whether this process writes the run's files: always, but on a
        mesh across processes only process 0 (the board is gathered by
        every process first; the reference writes from one rank,
        ``3-life/life_mpi.c:54-57``)."""
        return self.mesh is None or self.mesh.rank == 0

    def save_state(self) -> None:
        """Persist the current step through every configured channel: a VTK
        snapshot (``outdir``) and a checkpoint (``checkpoint_dir``)."""
        if self.outdir is not None:
            self.save_snapshot()
        if self.checkpoint_dir is not None:
            self._checkpoint_now()

    def save_checkpoint(self, path: str | os.PathLike) -> None:
        """A checkpoint of the live board at ``path`` (``utils.checkpoint``:
        the logical uint8 ``(ny, nx)`` board, gathered from the shards and
        cropped from the padded frame, and the step)."""
        if self.batch is not None or self.workload != "life":
            raise ValueError("a checkpoint holds one Life board; batched "
                             "and non-Life sims have no checkpoint channel")
        board = self.collect()
        if self._writes_files():
            checkpoint_lib.save(path, board, self.step_count)

    @classmethod
    def from_checkpoint(cls, path: str | os.PathLike, cfg: LifeConfig,
                        **kwargs) -> "LifeSim":
        """A sim resumed from a checkpoint, on whatever layout, mesh and
        impl ``kwargs`` (the constructor's) ask for."""
        board, step = checkpoint_lib.restore(path)
        if board.shape != cfg.shape:
            raise ValueError(f"checkpoint {os.fspath(path)} holds a "
                             f"{board.shape} board; the config's is "
                             f"{cfg.shape}")
        return cls(cfg, initial_board=board, initial_step=step, **kwargs)

    @classmethod
    def from_snapshot(cls, cfg: LifeConfig, snapshot_path: str, step: int,
                      **kwargs) -> "LifeSim":
        """Resume from a VTK snapshot at ``step``: ``run()`` continues with
        the cfg's save cadence and step budget, the restart the reference
        lacks (SURVEY section 5)."""
        board = vtk_lib.read_vtk(snapshot_path)
        return cls(cfg, initial_board=board, initial_step=step, **kwargs)

    def _checkpoint_now(self) -> str:
        path = os.path.join(self.checkpoint_dir,
                            checkpoint_lib.checkpoint_name(self.step_count))
        self.save_checkpoint(path)
        return path

    def _guarded_step(self, n: int) -> None:
        """``step(n)`` with the consistency guard armed, as a
        ``guards.with_fallback`` chain: the segment; on a violation the
        segment again from the board before it, with injection suppressed
        (the port's hooks act at run time, so nothing needs a rebuild);
        then, for a board on the CPU only, a replay on the NumPy oracle.
        A board on the card that diverges on the clean re-run is a kernel
        fault, which raises ``guards.FallbackExhausted`` naming both
        divergences: the guard never moves the card's work to the host.
        Every recovery stamps ``recoveries`` and the process-wide log."""
        prev_board, prev_step = self.board, self.step_count

        def segment():
            self.board, self.step_count = prev_board, prev_step
            self.step(n)
            why = self._consistency_violation()
            if why is not None:
                raise AssertionError(why)

        def clean():
            with chaos.suppressed():
                segment()

        def oracle():
            board = self._global(prev_board).cpu().numpy()
            for _ in range(n):
                board = self._oracle_step(board)
            self.board = self._place(board.astype(self.spec.np_dtype,
                                                  copy=False))
            self.step_count = prev_step + n

        name = f"life_step:{self.impl}"
        engines = [(name, segment), (name, clean)]
        if self.device.type != "cuda":
            engines.append(("life_step:numpy-oracle", oracle))
        _, stamp, notes = guards.with_fallback(engines)
        if notes:
            self.recoveries.append(f"{stamp} ({'; then '.join(notes)})")
            guards.record_recovery(stamp)

    def run(self, save: bool | None = None) -> np.ndarray:
        """Run ``cfg.steps`` steps with the reference's save cadence:
        snapshots (and checkpoints) at every step index ``i < steps`` with
        ``i % save_steps == 0``, before stepping (``3-life/life_mpi.c:51-58``).
        Returns the final board on the host.

        All inert on the default path: checkpoints every
        ``checkpoint_every`` steps; SIGTERM/SIGINT flush a checkpoint at the
        next segment boundary and raise ``robust.preempt.Preempted``; an
        active ``MOMP_CHAOS`` plan may fault the halo exchanges (caught by
        the guarded step), delay segments, or preempt at a fixed step; the
        guards are armed by the plan or ``MOMP_GUARD=1``."""
        cfg = self.cfg
        if save is None:
            save = self.outdir is not None or self.checkpoint_dir is not None
        # save_steps <= 0 means "never save" (the reference's 999999 idiom).
        save = save and cfg.save_steps > 0
        plan = chaos.active_plan()
        guard = guards.guards_active()
        checkpointing = (self.checkpoint_dir is not None
                         and self.checkpoint_every > 0)
        if not save and not checkpointing and plan is None and not guard:
            # The default path: one advance over the whole budget. The loop
            # below would make the same single advance, but with a
            # checkpoint_dir it arms the signal handlers, and a SIGTERM in
            # its one segment would then be swallowed with nothing flushed;
            # here a signal keeps its default meaning.
            if cfg.steps > self.step_count:
                with trace.span("life.advance",
                                steps=cfg.steps - self.step_count,
                                impl=self.impl, layout=self.layout) as sp:
                    self.step(cfg.steps - self.step_count)
                    sp.anchor(self.board)
            return self.collect()
        i = self.step_count
        with preempt.flush_on_signal(
                enabled=self.checkpoint_dir is not None) as sig:
            while i < cfg.steps:
                if sig.fired is not None:
                    # The previous segment is enqueued; the flush collects
                    # the board, which waits for it.
                    path = (self._checkpoint_now()
                            if self.checkpoint_dir is not None else None)
                    raise preempt.Preempted(i, checkpoint=path,
                                            signum=sig.fired)
                if save and i % cfg.save_steps == 0:
                    self.save_state()
                elif (checkpointing and i > 0
                      and i % self.checkpoint_every == 0):
                    self._checkpoint_now()
                if plan is not None and plan.delay_s:
                    time.sleep(plan.delay_s)
                next_stop = self._next_stop(i, save)
                with trace.span("life.segment", start=i, stop=next_stop,
                                impl=self.impl, layout=self.layout,
                                guarded=guard) as sp:
                    if guard:
                        self._guarded_step(next_stop - i)
                    else:
                        self.step(next_stop - i)
                    sp.anchor(self.board)
                prev_i, i = i, next_stop
                if (plan is not None and plan.preempt_step is not None
                        and not plan.preempt_fired
                        and prev_i < plan.preempt_step <= i):
                    plan.preempt_fired = True
                    path = (self._checkpoint_now()
                            if self.checkpoint_dir is not None else None)
                    raise preempt.SimulatedPreemption(i, checkpoint=path)
        return self.collect()


def state_from_jax_sim(cfg: LifeConfig, board: np.ndarray, step: int,
                       **sim_kwargs) -> LifeSim:
    """A port sim that carries on from a JAX ``LifeSim``'s state: its
    ``board`` as numpy (the JAX sim's stored array, in its
    ``padded_shape``, channels leading for a multi-channel spec) at step
    ``step``. The board is cropped to the logical ``(ny, nx)`` and placed
    on the port's mesh in the port's own frame; ``sim_kwargs`` are
    :class:`LifeSim`'s (layout, impl, mesh, device, ...)."""
    board = np.asarray(board)
    ny, nx = cfg.shape
    if board.ndim < 2 or board.shape[-2] < ny or board.shape[-1] < nx:
        raise ValueError(f"board {board.shape} does not hold a "
                         f"({ny}, {nx}) board")
    # A copy: a JAX array's numpy view is read-only.
    return LifeSim(cfg, initial_board=board[..., :ny, :nx].copy(),
                   initial_step=int(step), **sim_kwargs)
