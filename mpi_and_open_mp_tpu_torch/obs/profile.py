"""Work models, rooflines and memory gauges for the card.

Counterpart of ``mpi_and_open_mp_tpu/obs/profile.py``, with its calls,
its metric names and its peak table, in the card's terms:

* :func:`cost` - the work of a plain PyTorch function at its arguments'
  shapes and dtypes, ``{"flops", "bytes", "compile_seconds",
  "argument_bytes", "output_bytes"}``. The function runs on ``meta``
  tensors under a dispatch mode that counts each aten op: nothing
  executes, as the JAX package's abstract shapes lower without running.
  It counts what the computation needs, whatever implements it, so a
  hand-written kernel's time is held against the same work as its plain
  version's. Memoised per (name, shapes, dtypes), with the JAX package's
  ``profile.cost_cache{result=hit|miss}`` counters and
  ``profile.compile_seconds{fn=...}`` histogram.
* :func:`roofline` - achieved FLOP/s and bytes/s against a device kind's
  peaks (:func:`peaks_for`; ``MOMP_PEAK_FLOPS`` / ``MOMP_PEAK_BYTES_S``
  override them). ``peak_flops=`` passes the rate of the unit a kernel
  really issues on, such as INT32 for packed Life.
* :func:`record_memory_gauges` - live bytes, a process watermark and each
  card's bytes in use as registry gauges. On the card nothing falls back:
  a card asked for and not readable raises.

It also holds the card's issue rates and the bound functions that
``chip_smoke.py`` holds each kernel to: the least time for a kernel's work,
the larger of its operations over the rate of the unit that issues them
and its bytes (each input read once, each output written once) over HBM.

The H100 rates are NVIDIA's data-sheet figures (dense, no sparsity), each
part at its full power limit (700 W for the SXM part); a card set below
it runs slower under load.
The TPU and CPU rows are the JAX package's, so both packages' rooflines
agree on every device kind the JAX package knows; the CPU row is a
NOMINAL host-class placeholder that keeps the fraction finite, and
models no host.
"""

from __future__ import annotations

import gc
import math
import os
import time

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from mpi_and_open_mp_tpu_torch.obs import metrics
from mpi_and_open_mp_tpu_torch.utils.device import resolve_device

# H100 SXM at the full 700 W power limit. Integer rate: 132 SMs x 64
# INT32 lanes x 1.98 GHz boost clock (the clock behind the data sheet's 67
# TFLOP/s FP32 = 132 x 128 lanes x 2 x 1.98 GHz; Hopper issues INT32 at
# half the FP32 lane count). HBM3 at 3.35 TB/s.
N_SMS = 132
INT32_OPS_PER_S = N_SMS * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# FP32 peak of the data sheet (an FMA counts 2), for the float stencils.
FP32_FLOPS_PER_S = 67e12
# FP32 instruction issue rate: 132 SMs x 128 lanes x 1.98 GHz. A float
# stencil's multiply and add may not fuse into an FMA (the plain version
# rounds each), so each issues on its own: its issue bound counts each
# operation as one instruction at this rate, half the data sheet's 67 TFLOP/s.
FP32_ISSUE_PER_S = N_SMS * 128 * 1.98e9
# MUFU (special-function) issue rate: 132 SMs x 16 a clock x 1.98 GHz.
MUFU_PER_S = N_SMS * 16 * 1.98e9
# Dense BF16 tensor-core peak of the data sheet, for attention's products.
BF16_FLOPS_PER_S = 989.4e12
# PCIe 5.0 x16's nominal rate a direction, for the pool's lane ops.
PCIE5_X16_BYTES_PER_S = 63e9

# The fewest sm_90 instructions known for one packed word (32 cells) per
# step, counting each funnel shift (SHF) and each 3-input logic op (LOP3)
# as one: 2 SHF for the word's y neighbours, 2 LOP3 for its column's
# 3-cell sum (xor3, majority) and 2 for the sum without the centre (both
# shared with the words to either side), 4 to add the left and right
# column sums, 5 to add the centre column mod 8, 2 for (n0|c) & n1 & ~n2.
OPS_PER_WORD_STEP = 17
# The same count for a board-sliced word (32 boards at one cell): its eight
# neighbours are whole words, so the 2 SHF drop out.
OPS_PER_SLICED_WORD_STEP = 15
# Operations a word that the pool's tail mode adds to its launch: one
# 3-input LOP3 for the masked merge, an XOR and an OR for the change word.
POOL_TAIL_OPS_PER_WORD = 3
# Operations of each stencil rule per cell past the aggregate, counted from
# csrc/stencil_padded.cu's device functions (compares and logic for the
# integer rules; add, sub, mul, div, exp each 1 for the float ones; both
# channels for gray_scott).
# Indexed by the kernel's rule id: life, heat, gray_scott, wireworld, lenia.
STENCIL_RULE_OPS = (5, 4, 19, 12, 10)
# The lane ops' HBM bytes a cell of the plane: the write reads and writes
# a word, the read reads one.
POOL_LANE_HBM_BYTES = {"pool_lane_write": 8, "pool_lane_read": 4}

#: (device_kind substring, peak FLOP/s, peak bytes/s). Matched
#: case-insensitively in order; first hit wins, so the H100 PCIe and NVL
#: parts come before the SXM part's bare "h100". H100 rows: bf16 dense
#: tensor-core peak and HBM rate of the data sheet; TPU rows: bf16 peak +
#: HBM bandwidth of the public chip specs; the CPU row: NOMINAL.
_PEAKS: tuple[tuple[str, float, float], ...] = (
    ("h100 pcie", 756e12, 2.0e12),  # HBM2e
    ("h100 nvl", 835e12, 3.9e12),   # HBM3, 94 GB
    ("h100", BF16_FLOPS_PER_S, HBM_BYTES_PER_S),  # SXM, HBM3
    ("v5 lite", 197e12, 819e9),  # v5e ("TPU v5 lite" is the kind string)
    ("v5e", 197e12, 819e9),
    ("v5p", 459e12, 2765e9),
    ("v6", 918e12, 1640e9),
    ("v4", 275e12, 1228e9),
    ("v3", 123e12, 900e9),
    ("v2", 45e12, 700e9),
    ("cpu", 1e11, 2e10),
)
_DEFAULT_PEAKS = ("cpu-nominal", 1e11, 2e10)

_COST_CACHE: dict[tuple, dict] = {}


def peaks_for(device_kind: str | None) -> tuple[float, float, str]:
    """``(peak_flops_per_sec, peak_bytes_per_sec, label)`` for a device
    kind, env-overridable per component."""
    label, flops, bw = _DEFAULT_PEAKS
    kind = (device_kind or "").lower()
    for sub, f, b in _PEAKS:
        if sub in kind:
            label, flops, bw = f"{sub}-table", f, b
            break
    try:
        flops = float(os.environ.get("MOMP_PEAK_FLOPS", flops))
        bw = float(os.environ.get("MOMP_PEAK_BYTES_S", bw))
    except ValueError:
        pass
    return flops, bw, label


# Aten ops (overload packets; an in-place form counts as its op) that do
# one operation an output element. Everything else (views, moves, rolls,
# copies, casts, pads, cats, fills) counts 0.
_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "remainder", "fmod",
    "floor_divide", "pow", "exp", "exp2", "expm1", "log", "log2", "log1p",
    "sqrt", "rsqrt", "reciprocal", "sin", "cos", "tanh", "sigmoid", "erf",
    "floor", "ceil", "round", "trunc", "sign", "maximum", "minimum",
    "clamp", "clamp_min", "clamp_max", "where", "lerp", "addcmul",
    "addcdiv",
    "eq", "ne", "lt", "le", "gt", "ge", "isnan", "isinf",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "logical_and",
    "logical_or", "logical_xor", "logical_not",
))
# Reductions: one operation an input element.
_REDUCTIONS = frozenset((
    "sum", "mean", "prod", "amax", "amin", "max", "min", "any", "all",
    "argmax", "argmin", "cumsum", "logsumexp",
))


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


class _CountOps(TorchDispatchMode):
    """Counts the operations of every aten op dispatched under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__.rstrip("_")
        if packet in flop_counter.flop_registry:
            self.flops += flop_counter.flop_registry[packet](
                *args, **kwargs, out_val=out)
        elif name in _ELEMENTWISE:
            self.flops += sum(map(_numel, tree_flatten(out)[0]))
        elif name in _REDUCTIONS:
            self.flops += _numel(tree_flatten(args)[0][0])
        return out


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0]
               if isinstance(x, torch.Tensor))


def cost(fn, *args, name: str | None = None) -> dict:
    """FLOPs and bytes of the plain PyTorch function ``fn`` at ``args``'
    shapes and dtypes.

    ``args`` may be tensors on any device (``meta`` ones too): ``fn`` runs
    on ``meta`` tensors of their shapes and dtypes, so nothing executes.
    ``flops`` is ``torch.utils.flop_counter``'s count of mm, conv and
    attention products plus one an output element of each arithmetic,
    compare or logic op (one an input element of a reduction); ``bytes``
    is the arguments' and outputs' bytes, the least traffic any
    implementation must move. Raises whatever the meta trace raises.

    For ``ops.life_ops.life_step_roll`` on one board: 10 operations a cell
    (4 add, 1 sub, 3 eq, 1 and, 1 or; its 4 rolls and the cast count 0)
    and 2 bytes a uint8 cell, the board read and the next one written.
    """
    name = name or getattr(fn, "__name__", "fn")
    sig = (name, tuple(
        (tuple(a.shape), str(a.dtype)) if hasattr(a, "shape") else repr(a)
        for a in args), ())
    cached = _COST_CACHE.get(sig)
    if cached is not None:
        metrics.inc("profile.cost_cache", result="hit")
        return dict(cached)
    metrics.inc("profile.cost_cache", result="miss")
    meta = tree_map(
        lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta")
        if isinstance(a, torch.Tensor) else a, args)
    t0 = time.perf_counter()
    with _CountOps() as counter:
        out = fn(*meta)
    trace_seconds = time.perf_counter() - t0
    arg_bytes, out_bytes = _bytes(meta), _bytes(out)
    result = {
        "flops": float(counter.flops),
        "bytes": float(arg_bytes + out_bytes),
        "compile_seconds": round(trace_seconds, 6),
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
    }
    metrics.observe("profile.compile_seconds", trace_seconds, fn=name)
    _COST_CACHE[sig] = dict(result)
    return result


def roofline(flops_per_step: float, bytes_per_step: float,
             seconds_per_step: float, device_kind: str | None = None, *,
             peak_flops: float | None = None) -> dict:
    """Roofline placement of a measured per-step time against a cost
    model: achieved rates, peak fractions, and which ceiling binds.
    ``peak_flops`` replaces the table's compute peak (the rate of the unit
    the work really issues on); without it this is the JAX package's."""
    table_flops, peak_bw, label = peaks_for(device_kind)
    if peak_flops is None:
        peak_flops = table_flops
    if not (seconds_per_step > 0 and math.isfinite(seconds_per_step)):
        raise ValueError(
            f"seconds_per_step must be finite/positive: {seconds_per_step}")
    flops_rate = flops_per_step / seconds_per_step
    bytes_rate = bytes_per_step / seconds_per_step
    flops_frac = flops_rate / peak_flops
    bw_frac = bytes_rate / peak_bw
    return {
        "flops_per_step": flops_per_step,
        "bytes_per_step": bytes_per_step,
        "flops_per_sec": round(flops_rate, 1),
        "bytes_per_sec": round(bytes_rate, 1),
        "flops_pct": round(100 * flops_frac, 3),
        "bw_pct": round(100 * bw_frac, 3),
        # The binding ceiling: the larger fraction is the wall the
        # measured rate sits under.
        "bound": "memory" if bw_frac >= flops_frac else "compute",
        "roofline_pct": round(100 * max(flops_frac, bw_frac), 3),
        "peaks": label,
        "peak_flops_per_sec": peak_flops,
        "peak_bytes_per_sec": peak_bw,
    }


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    """The least milliseconds for ``ops`` INT32 operations and ``nbytes``
    over HBM, and which of the two bounds it."""
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stencil_ops(spec, rule: int, offsets, cells: int) -> int:
    """Operations of one stencil step: the aggregate (an add per tap past
    the first, a multiply per non-unit weight, per channel) plus the
    rule's."""
    taps = len(offsets)
    per_cell = spec.channels * (taps - 1 + sum(w != 1 for _, _, w in offsets))
    return cells * (per_cell + STENCIL_RULE_OPS[rule])


def stencil_bound_ms(spec, rule: int, offsets, cells: int, in_bytes: int,
                     out_bytes: int) -> tuple[float, str]:
    """The least time for one stencil step: the padded input read once and
    the interior written once over HBM, against :func:`stencil_ops` over
    the peak of the cell type (FP32 or INT32)."""
    ops = stencil_ops(spec, rule, offsets, cells)
    rate = FP32_FLOPS_PER_S if spec.is_float else INT32_OPS_PER_S
    t_ops = ops / rate * 1e3
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound_ms(products: int, h: int, n: int, d: int,
                       nbytes: int) -> tuple[float, str]:
    """The least time for ``products`` causal attention products of
    ``h n^2 d / 2`` multiply-adds each (the bench's count: the forward's
    two are ``2 h n^2 d`` FLOP) at the BF16 tensor-core peak, against
    ``nbytes`` read and written once over HBM."""
    t_ops = products * h * n * n * d / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def quadrature_bound_ms(points: int, needed_per_point: float,
                        mufu_per_point: float, nbytes: int
                        ) -> tuple[float, str, dict]:
    """The least time for ``points`` trapezoid points: the larger of their
    MUFU instructions at 16 a clock an SM, the arithmetic instructions each
    point needs (counted on the kernel's interior loop) at 128 lanes a
    clock an SM, and the chunk sums' bytes over HBM."""
    terms = {"mufu_ms": points * mufu_per_point / MUFU_PER_S * 1e3,
             "issue_ms": points * needed_per_point / FP32_ISSUE_PER_S * 1e3,
             "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    t_ops = max(terms["mufu_ms"], terms["issue_ms"])
    if t_ops >= terms["bytes_ms"]:
        return t_ops, "operations", terms
    return terms["bytes_ms"], "bytes", terms


def lane_bound_ms(name: str, cells: int,
                  rates: dict[str, float]) -> tuple[float, str]:
    """A lane op's least time: its board, 1 B a cell, over the link at the
    larger of the nominal and the measured rate that way (``rates["h2d"]``,
    ``rates["d2h"]``), against its plane's HBM bytes; returns the time and
    which term bounds it."""
    way = "h2d" if name == "pool_lane_write" else "d2h"
    t_link = cells / max(PCIE5_X16_BYTES_PER_S, rates[way]) * 1e3
    t_hbm = POOL_LANE_HBM_BYTES[name] * cells / HBM_BYTES_PER_S * 1e3
    return (t_link, "link") if t_link >= t_hbm else (t_hbm, "hbm")


_WATERMARK = 0


def live_buffer_bytes(device: str | torch.device = "cuda") -> int:
    """Bytes of live tensors: on the card, ``torch.cuda.memory_allocated``
    summed over the visible cards; on the CPU, the storages of the CPU
    tensors the garbage collector can reach, each counted once."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return sum(torch.cuda.memory_allocated(d)
                   for d in range(torch.cuda.device_count()))
    seen, total = set(), 0
    for obj in gc.get_objects():
        # type() and not isinstance: isinstance reads __class__, which
        # some lazily loaded module objects answer with a warning.
        if not issubclass(type(obj), torch.Tensor):
            continue
        if obj.device.type != "cpu" or obj.layout != torch.strided:
            continue
        storage = obj.untyped_storage()
        ptr = storage.data_ptr()
        if ptr and ptr not in seen:
            seen.add(ptr)
            total += storage.nbytes()
    return total


def record_memory_gauges(device: str | torch.device = "cuda") -> int:
    """Gauge live bytes and the process watermark, and on the card each
    card's bytes in use (the caching allocator's reserved bytes from
    ``torch.cuda.memory_stats``); returns the live total."""
    global _WATERMARK
    dev = resolve_device(device)
    live = live_buffer_bytes(dev)
    _WATERMARK = max(_WATERMARK, live)
    metrics.gauge("memory.live_buffer_bytes", live)
    metrics.gauge("memory.live_buffer_watermark_bytes", _WATERMARK)
    if dev.type == "cuda":
        for d in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(d)
            metrics.gauge("memory.device_bytes_in_use",
                          stats["reserved_bytes.all.current"], device=str(d))
    return live


def reset_cost_cache() -> None:
    """Empty the cost memo (tests)."""
    _COST_CACHE.clear()
