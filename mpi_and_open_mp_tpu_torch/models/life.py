"""Game-of-Life simulation: one board, its stepper, and snapshot IO.

Counterpart of ``mpi_and_open_mp_tpu/models/life.py:LifeSim``, serial
layout (the reference's single-process oracle ``3-life/life2d.c``). The
board is a ``(ny, nx)`` uint8 tensor on ``device``; the step is

* ``impl="native"`` (the counterpart of the JAX package's ``"pallas"``):
  the packed kernels picked by ``ops.native_life.native_path`` - on the CPU
  their plain versions;
* ``impl="roll"``: the unpacked torus step by circular shifts;
* ``impl="auto"``: ``native`` on the card, ``roll`` on the CPU.

A stacked ``(B, ny, nx)`` ``initial_board`` puts the sim in batched mode:
all B independent boards advance together, through
``ops.native_life.life_run_vmem_batch`` (``impl="native"``, which ``auto``
means on every device) or the roll step over the stack. Batched runs have
no snapshot or checkpoint channel (both serialise one board), and
``debug_check`` holds every board against the oracle on its own.

Any other registered stencil workload (``workload="heat"``,
``"gray_scott"``, ``"wireworld"``, ``"lenia"``, ...; see
``mpi_and_open_mp_tpu_torch.stencils``) runs one board through the spec's
roll step (``stencils.engine.run_roll``): the spec sets the cell dtype and
the board shape (channels leading), the default board is
``spec.init(np.random.default_rng(0xD1CE), cfg.shape)``, ``impl="auto"``
means ``roll``, and ``impl="native"`` (the packed Life kernels) and
stacked boards raise, as the JAX package's serial ``"pallas"`` and its
non-life batched mode do. Stacks of non-life boards go through the serve
batcher.

The run loop keeps the reference's order (``3-life/life_mpi.c:51-62``): at
step ``i``, save a snapshot when ``i % save_steps == 0`` (before stepping),
then advance. Between snapshots the board advances in one call.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.ops import life_ops, native_life
from mpi_and_open_mp_tpu_torch.utils import vtk as vtk_lib
from mpi_and_open_mp_tpu_torch.utils.config import LifeConfig
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device
from mpi_and_open_mp_tpu_torch.utils.timing import sync

LAYOUTS = ("serial", "row", "col", "cart")
IMPLS = ("auto", "roll", "native")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class LifeSim:
    """One Life run: board state on a device, its stepper, snapshot IO."""

    def __init__(
        self,
        cfg: LifeConfig,
        layout: str = "serial",
        impl: str = "auto",
        device: str | torch.device = "cuda",
        outdir: str | os.PathLike | None = None,
        checkpoint_dir: str | os.PathLike | None = None,
        initial_board: np.ndarray | None = None,
        initial_step: int = 0,
        workload: str = "life",
    ):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.workload = str(workload)
        self.spec = stencils.get(self.workload)
        if self.workload != "life" and impl == "native":
            raise ValueError(
                "serial impl='native' runs the bit-packed Life kernels; "
                f"workload={self.workload!r} uses impl='roll' (or 'auto')")
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
            if outdir is not None or checkpoint_dir is not None:
                raise ValueError(
                    "batched runs have no snapshot/checkpoint channels "
                    "(both serialise one board); drop outdir/checkpoint_dir")
            self.batch = int(np.asarray(initial_board).shape[0])
        if layout != "serial":
            raise _not_ported(f"layout={layout!r}", "3 (sharded layouts)")
        if checkpoint_dir is not None:
            raise _not_ported("checkpoint_dir", "4 (checkpoint and resume)")
        self.cfg = cfg
        self.layout = layout
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        if impl == "auto" and self.workload != "life":
            impl = "roll"
        elif impl == "auto":
            # A stack takes the batched dispatch on every device, as the
            # JAX package's batched auto does.
            impl = "native" if on_card or self.batch is not None else "roll"
        self.impl = impl
        # The engine native runs take (the JAX package's plan_note).
        if impl != "native":
            self.native_path = None
        elif self.batch is not None:
            self.native_path = "batch:" + native_life.native_path_batch(
                (self.batch, *cfg.shape), on_card=on_card)
        else:
            self.native_path = native_life.native_path(
                cfg.shape, on_card=on_card)
        self.outdir = os.fspath(outdir) if outdir is not None else None
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
        self.board = self._to_device(board)

    def _to_device(self, board: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(board)).to(self.device)

    def _advance(self, board: torch.Tensor, n: int) -> torch.Tensor:
        """``board`` advanced ``n`` steps (``board`` itself is untouched)."""
        if self.impl == "native":
            if self.batch is not None:
                return native_life.life_run_vmem_batch(board, n)
            return native_life.life_run_vmem(board, n)
        if self.workload != "life":
            return stencils.run_roll(self.spec, board, n)
        for _ in range(int(n)):
            board = life_ops.life_step_roll(board)
        return board

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
        self.board = self._to_device(self._initial)
        self.step_count = self._initial_step

    def _next_stop(self, i: int, save: bool) -> int:
        """First step index after ``i`` where run() pauses the advance: the
        end of the budget or the next snapshot boundary."""
        cfg = self.cfg
        stops = [cfg.steps]
        if save and cfg.save_steps > 0:
            stops.append((i // cfg.save_steps + 1) * cfg.save_steps)
        return min(s for s in stops if s > i)

    def _segment_lengths(self, save: bool = True) -> list[int]:
        """Distinct ``advance`` step counts a full ``run()`` will request."""
        save = save and self.outdir is not None and self.cfg.save_steps > 0
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
        multi-channel spec)."""
        return self.board.cpu().numpy().astype(self.spec.np_dtype, copy=False)

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
        board and on a fixed probe board (B distinct ones in batched mode);
        returns a description of the first failure, or None."""
        before = self.collect()
        if not self.spec.valid_board(before):
            return ("non-binary cells on the board" if self.workload == "life"
                    else "out-of-domain cells on the board")
        after = self._advance(self.board, 1).cpu().numpy()
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
            self._probe = (self._to_device(host), self._oracle_step(host))
        probe, probe_expect = self._probe
        after = self._advance(probe, 1).cpu().numpy()
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
        os.makedirs(self.outdir, exist_ok=True)
        vtk_lib.write_vtk(path, self.collect())
        return path

    def save_state(self) -> None:
        """Persist the current step: a VTK snapshot when ``outdir`` is set."""
        if self.outdir is not None:
            self.save_snapshot()

    def run(self, save: bool | None = None) -> np.ndarray:
        """Run ``cfg.steps`` steps with the reference's save cadence:
        snapshots at every step index ``i < steps`` with
        ``i % save_steps == 0``, before stepping (``3-life/life_mpi.c:51-58``).
        Returns the final board on the host."""
        cfg = self.cfg
        if save is None:
            save = self.outdir is not None
        # save_steps <= 0 means "never save" (the reference's 999999 idiom).
        save = save and cfg.save_steps > 0
        i = self.step_count
        while i < cfg.steps:
            if save and i % cfg.save_steps == 0:
                self.save_state()
            next_stop = self._next_stop(i, save)
            self.step(next_stop - i)
            i = next_stop
        return self.collect()
