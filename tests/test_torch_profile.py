"""``obs/profile.py`` of the port against the JAX package's.

``roofline`` and ``peaks_for`` must give the JAX package's dicts and
tuples on every device kind its table knows (exact equality: the same
arithmetic on the same floats), the H100 names must resolve to the
data-sheet rows the kernel table's bounds use, ``cost`` must count the
plain step's work by hand and memoise under the JAX package's metric
names, the memory gauges must see a live tensor, and the bound functions
``chip_smoke.py`` imports must reproduce PERF.md's bound column at the
table's shapes, to its printed digits.
"""

import gc
import importlib.util
import math
import os

import pytest
import torch

from mpi_and_open_mp_tpu.obs import profile as jprofile
from mpi_and_open_mp_tpu_torch import stencils
from mpi_and_open_mp_tpu_torch.obs import metrics, profile
from mpi_and_open_mp_tpu_torch.ops import life_ops, native_stencil
from mpi_and_open_mp_tpu_torch.stencils import engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every device kind of the JAX package's table, a bare "cpu", an unknown
# kind and none at all.
JAX_KINDS = ["TPU v5 lite", "TPU v5e", "TPU v5p", "TPU v6e", "TPU v4",
             "TPU v3", "TPU v2", "cpu", "some accelerator", None]
PEAK_ENV = ("MOMP_PEAK_FLOPS", "MOMP_PEAK_BYTES_S")


@pytest.fixture
def no_peak_env(monkeypatch):
    for name in PEAK_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("kind", JAX_KINDS)
@pytest.mark.parametrize("flops,nbytes", [(1e12, 1e6), (1e6, 1e12)],
                         ids=["compute-bound", "memory-bound"])
def test_roofline_equals_jax(kind, flops, nbytes, no_peak_env):
    got = profile.roofline(flops, nbytes, 0.0123, kind)
    assert got == jprofile.roofline(flops, nbytes, 0.0123, kind)
    assert got["bound"] == ("compute" if flops > nbytes else "memory")


@pytest.mark.parametrize("seconds", [0.0, -1.0, math.nan, math.inf])
def test_roofline_raises_alike(seconds):
    with pytest.raises(ValueError) as jerr:
        jprofile.roofline(1.0, 1.0, seconds)
    with pytest.raises(ValueError, match="finite/positive") as err:
        profile.roofline(1.0, 1.0, seconds)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("env", [
    {}, {"MOMP_PEAK_FLOPS": "1e15"}, {"MOMP_PEAK_BYTES_S": "5e12"},
    {"MOMP_PEAK_FLOPS": "2e14", "MOMP_PEAK_BYTES_S": "1e12"},
    {"MOMP_PEAK_FLOPS": "not a number"}],
    ids=["none", "flops", "bytes", "both", "malformed"])
def test_peaks_for_with_env_overrides_equals_jax(env, monkeypatch):
    for name in PEAK_ENV:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for kind in JAX_KINDS:
        assert profile.peaks_for(kind) == jprofile.peaks_for(kind), kind


@pytest.mark.parametrize("kind,want", [
    ("NVIDIA H100 80GB HBM3", ("h100-table", 989.4e12, 3.35e12)),
    ("NVIDIA H100", ("h100-table", 989.4e12, 3.35e12)),
    ("NVIDIA H100 PCIe", ("h100 pcie-table", 756e12, 2.0e12)),
    ("NVIDIA H100 NVL", ("h100 nvl-table", 835e12, 3.9e12))])
def test_h100_names_resolve_to_their_rows(kind, want, no_peak_env):
    flops, bw, label = profile.peaks_for(kind)
    assert (label, flops, bw) == want
    # The SXM row is the rates the kernel table's bounds use.
    if label == "h100-table":
        assert (flops, bw) == (profile.BF16_FLOPS_PER_S,
                               profile.HBM_BYTES_PER_S)


def test_roofline_takes_the_issuing_units_rate(no_peak_env):
    kind = "NVIDIA H100 80GB HBM3"
    int32 = profile.roofline(10 * 500 * 500, 2 * 500 * 500, 0.5385e-6, kind,
                             peak_flops=profile.INT32_OPS_PER_S)
    headline = profile.roofline(10 * 500 * 500, 2 * 500 * 500, 0.5385e-6,
                                kind)
    assert int32["peak_flops_per_sec"] == profile.INT32_OPS_PER_S
    assert headline["peak_flops_per_sec"] == profile.BF16_FLOPS_PER_S
    assert int32["bw_pct"] == headline["bw_pct"]
    assert int32["flops_pct"] > 50 * headline["flops_pct"]
    assert headline["bound"] == "memory"


def _counts():
    snap = metrics.snapshot()
    hist = snap["histograms"].get(
        "profile.compile_seconds{fn=life_step_roll}", {})
    return (snap["counters"].get("profile.cost_cache{result=miss}", 0),
            snap["counters"].get("profile.cost_cache{result=hit}", 0),
            hist.get("count", 0))


def test_cost_is_memoised_under_the_jax_names():
    profile.reset_cost_cache()
    metrics.reset()
    board = torch.zeros((64, 64), dtype=torch.uint8)
    first = profile.cost(life_ops.life_step_roll, board)
    assert _counts() == (1, 0, 1)
    again = profile.cost(life_ops.life_step_roll, board)
    assert again == first
    assert _counts() == (1, 1, 1)
    profile.cost(life_ops.life_step_roll,
                 torch.zeros((65, 64), dtype=torch.uint8))
    assert _counts() == (2, 1, 2)
    profile.reset_cost_cache()
    profile.cost(life_ops.life_step_roll, board)
    assert _counts() == (3, 1, 3)


@pytest.mark.parametrize("n", [64, 500])
def test_cost_of_life_step_roll_is_the_hand_count(n):
    """10 operations a cell (4 add, 1 sub, 3 eq, 1 and, 1 or), the rolls
    and the cast 0; the board read and the next written, 1 B a cell
    each."""
    profile.reset_cost_cache()
    got = profile.cost(life_ops.life_step_roll,
                       torch.empty((n, n), dtype=torch.uint8, device="meta"))
    assert got["flops"] == 10 * n * n
    assert got["bytes"] == 2 * n * n
    assert (got["argument_bytes"], got["output_bytes"]) == (n * n, n * n)
    assert set(got) == {"flops", "bytes", "compile_seconds",
                        "argument_bytes", "output_bytes"}
    assert got["compile_seconds"] >= 0


def test_cost_runs_nothing_and_counts_products():
    """The function sees meta tensors, mm's flops are flop_counter's, a
    reduction counts its input, and what the trace raises, ``cost``
    raises."""
    seen = []

    def product(a, b):
        seen.append((a.device.type, b.device.type))
        return torch.mm(a, b) + 1

    profile.reset_cost_cache()
    got = profile.cost(product, torch.ones(64, 32), torch.ones(32, 16))
    assert seen == [("meta", "meta")]
    assert got["flops"] == 2 * 64 * 32 * 16 + 64 * 16
    assert got["bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)
    with pytest.raises(RuntimeError):
        profile.cost(product, torch.ones(64, 32), torch.ones(31, 16),
                     name="mismatched")
    # A reduction does one operation an input element; a copy none.
    summed = profile.cost(lambda x: x.clone().sum(), torch.ones(8, 16),
                          name="sum")
    assert (summed["flops"], summed["bytes"]) == (8 * 16, 4 * (8 * 16 + 1))


def test_memory_gauges_see_a_live_tensor_on_the_cpu():
    metrics.reset()
    gc.collect()  # no tensor left to be freed between the two readings
    before = profile.record_memory_gauges("cpu")
    held = torch.ones(256 * 1024, dtype=torch.uint8)
    view = held[1:]  # the same storage, counted once
    live = profile.record_memory_gauges("cpu")
    assert 2 * held.nbytes > live - before >= held.nbytes
    assert profile.live_buffer_bytes("cpu") >= held.nbytes
    gauges = metrics.snapshot()["gauges"]
    assert gauges["memory.live_buffer_bytes"] == live
    assert gauges["memory.live_buffer_watermark_bytes"] >= live
    assert not any(k.startswith("memory.device_bytes_in_use") for k in gauges)
    del held, view


def test_memory_gauges_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile.record_memory_gauges()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile.live_buffer_bytes("cuda")


# PERF.md section 6's bound column, each at its row's shapes and, for rows
# 11 and 12, the measured inputs its row states.
def _stencil(name, boards=64, edge=500):
    spec = stencils.get(name)
    r, size = spec.radius, 4 if spec.is_float else 1
    cells = boards * edge * edge
    return profile.stencil_bound_ms(
        spec, native_stencil.kernel_rule(spec).rule, engine.offsets(spec),
        cells, boards * (edge + 2 * r) ** 2 * size, cells * size)[0]


def _attention(products):
    h, n, d = 8, 32768, 128
    operand = h * n * d * 2
    return profile.attention_bound_ms(products, h, n, d,
                                      4 * operand + h * n * 4)[0]


def _packed(ops_per_word, words, steps):
    return profile.bound_ms(ops_per_word * words * steps, 2 * 4 * words)[0]


N_CHUNKS_1E12 = -(-10**12 // 131072)
LINK_RATES = {"h2d": 54.0e9, "d2h": 55.0e9}  # the highest measured

BOUND_ROWS = {
    "1 p46gun_big": (lambda: _packed(17, 500 * 16, 10000), "0.0813"),
    "2 10000^2 frame": (lambda: _packed(17, 10000 * 313, 128), "0.4072"),
    "2 16384^2": (lambda: _packed(17, 16384 * 512, 128), "1.0913"),
    "2 4096^2": (lambda: _packed(17, 4096 * 128, 128), "0.0682"),
    "3 row 8 windows": (
        lambda: profile.bound_ms(17 * 8000 * 32, 4 * (16000 + 8000))[0],
        "0.000260"),
    "4 4 x 500^2": (lambda: _packed(17, 4 * 500 * 16, 10000), "0.3252"),
    "5 64 x 500^2": (lambda: _packed(15, 2 * 500 * 500, 10000), "4.484"),
    "6 life shards": (
        lambda: profile.stencil_bound_ms(
            stencils.get("life"), 0, engine.offsets(stencils.get("life")),
            8 * 125 * 250, 8 * 127 * 252, 8 * 125 * 250)[0], "0.00018"),
    "7 heat": (lambda: _stencil("heat"), "0.0384"),
    "7 wireworld": (lambda: _stencil("wireworld"), "0.0182"),
    "7 life": (lambda: _stencil("life"), "0.0115"),
    "7 lenia": (lambda: _stencil("lenia"), "0.1397"),
    "8 dq": (lambda: _attention(3), "3.334"),
    "8 dk/dv": (lambda: _attention(4), "4.445"),
    "9 frame": (
        lambda: profile.bound_ms(0, 4 * 2 * 125 * 250 + 4 * 2 * 127 * 252)[0],
        "0.000151"),
    "10 forward": (lambda: _attention(2), "2.223"),
    "11 10^12": (lambda: profile.quadrature_bound_ms(
        10**12 + 1, 12, 1, 8 * N_CHUNKS_1E12 + 4)[0], "358.70"),
    "11 10^12 MUFU term": (lambda: profile.quadrature_bound_ms(
        10**12 + 1, 12, 1, 8 * N_CHUNKS_1E12 + 4)[2]["mufu_ms"], "239.13"),
    "12 tail 500^2": (
        lambda: profile.bound_ms(3 * 250000, 4 * 250000)[0], "0.000299"),
    "12 tail 48^2": (
        lambda: profile.bound_ms(3 * 48 * 48, 4 * 48 * 48)[0], "0.0000028"),
    "12 lane 500^2": (
        lambda: profile.lane_bound_ms("pool_lane_write", 250000,
                                      LINK_RATES)[0], "0.003968"),
    "12 lane 48^2": (
        lambda: profile.lane_bound_ms("pool_lane_read", 48 * 48,
                                      LINK_RATES)[0], "0.0000366"),
}


@pytest.mark.parametrize("row", list(BOUND_ROWS))
def test_bounds_reproduce_the_kernel_tables_column(row):
    fn, printed = BOUND_ROWS[row]
    digits = len(printed.split(".")[1])
    assert f"{fn():.{digits}f}" == printed


def test_chip_smoke_takes_its_rates_and_bounds_from_profile():
    """chip_smoke.py keeps no copy: its names are profile's objects, and
    its source assigns no rate and defines no bound function."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_test", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for name in ("bound_ms", "stencil_ops", "stencil_bound_ms",
                 "attention_bound_ms", "quadrature_bound_ms",
                 "lane_bound_ms", "N_SMS", "INT32_OPS_PER_S",
                 "FP32_ISSUE_PER_S", "OPS_PER_WORD_STEP",
                 "OPS_PER_SLICED_WORD_STEP", "POOL_TAIL_OPS_PER_WORD"):
        assert getattr(cs, name) is getattr(profile, name), name
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    for line in src.splitlines():
        assert not line.startswith("def ") or "bound_ms" not in line, line
        assert not (line.split("=")[0].strip().endswith("_PER_S")
                    and "=" in line and not line.startswith(" ")), line
