"""Subnormal floats through the PyTorch port, on the CPU, side by side
with the JAX package.

XLA runs the JAX package's computations with flush-to-zero and
denormals-are-zero: an arithmetic op, a comparison, a min/max, a
reduction or a float conversion reads a subnormal input as a zero of the
same sign and writes a subnormal result as one, while data movement
(indexing, gathers, scatter-sets, concatenation, ``where``) keeps the
bits. The port copies that rule (``tpustream_torch/arith.py``).

* The op sets of ``arith.py``, each op against a jitted JAX function.
* The chapter-2 mean under float32 at 1e-39 and exact at 1e-309, the
  chapter-2 rolling max at 1e-309, a float32 rolling sum near 1e-39.
* The ordered merge (``ops/ordered_scatter.py``) against a jitted
  ``p.at[idx].add(v, mode="drop")`` on subnormal, cancelling and
  negative values, and a hypothesis case over such values.
* A copy path that must keep subnormals: the chapter-2 median.
* One probe each for a user filter, the session mean, a count-window
  sum and the flagship under float32.
* What XLA computes without a flush: a batch of one row (no scan: a new
  key's value is a copy), the scan's interleave (``x + 0.0``: every zero
  it emits is +0.0), ``max_by``'s select of the compared field (a
  max/min instruction), and the algebraic simplifier's identities; and
  a correctly rounded ``sqrt``.

Tolerance: none. Every comparison is bitwise: rows, ``print()`` bytes
(so the sign of every zero), and plane bits.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import tpustream
import tpustream.api.windows as jax_windows
import tpustream.jobs.chapter2_avg as jax_avg
import tpustream.jobs.chapter2_max as jax_max
import tpustream.jobs.chapter2_median as jax_median
import tpustream.jobs.chapter3_bandwidth_eventtime as jax_ch3
import tpustream.runtime.sources as jax_sources
import tpustream_torch
import tpustream_torch.api.windows as torch_windows
import tpustream_torch.jobs.chapter2_avg as torch_avg
import tpustream_torch.jobs.chapter2_max as torch_max
import tpustream_torch.jobs.chapter2_median as torch_median
import tpustream_torch.jobs.chapter3_bandwidth_eventtime as torch_ch3
import tpustream_torch.runtime.sources as torch_sources
from tpustream_torch.arith import (
    COMPARED,
    CONVERSIONS,
    FLUSHED,
    flush_subnormal,
    reference_arithmetic,
)
from tpustream_torch.ops.ordered_scatter import (
    ordered_scatter_add,
    ordered_scatter_add_ref,
)

PKGS = {
    "jax": types.SimpleNamespace(
        pkg=tpustream, sources=jax_sources, windows=jax_windows,
        jobs={"avg": jax_avg, "max": jax_max, "median": jax_median,
              "ch3": jax_ch3}, cfg={}),
    "torch": types.SimpleNamespace(
        pkg=tpustream_torch, sources=torch_sources, windows=torch_windows,
        jobs={"avg": torch_avg, "max": torch_max, "median": torch_median,
              "ch3": torch_ch3}, cfg={"device": "cpu"}),
}

F64_TINY = np.finfo(np.float64).tiny
F32_TINY = np.finfo(np.float32).tiny


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({8: np.int64, 4: np.int32, 1: np.int8}[a.itemsize])


def _assert_bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(_bits(got), _bits(want)), (got, want)


# -- the flush itself and the op sets -------------------------------------

def test_subnormal_flush_keeps_sign_nan_and_inf():
    for dt, tiny in ((torch.float64, F64_TINY), (torch.float32, F32_TINY)):
        x = torch.tensor([tiny / 3, -tiny / 3, tiny, -tiny, 0.0, -0.0, 1.0,
                          float("nan"), float("inf"), -float("inf")], dtype=dt)
        got = flush_subnormal(x).numpy()
        want = x.numpy().copy()
        want[:2] = [0.0, -0.0]
        _assert_bitwise(got, want)
    ints = torch.tensor([1, 0, -3])
    assert flush_subnormal(ints) is ints


def _probe_inputs(dtype):
    tiny = F64_TINY if dtype == np.float64 else F32_TINY
    a = np.array([tiny / 8, -tiny / 8, tiny / 2, 1.5, -0.0, tiny * 1.5,
                  -tiny / 4, 2.0], dtype)
    b = np.array([tiny / 4, tiny / 8, -tiny / 2, -tiny / 2, tiny / 4,
                  -tiny * 1.25, -tiny / 4, 0.5], dtype)
    return a, b


# (name, torch op under reference_arithmetic, jnp op): every op reads its
# inputs after the flush or passes bits, as the JAX package's jit does
OPS = [
    ("add", lambda a, b: a + b, lambda a, b: a + b),
    ("sub", lambda a, b: a - b, lambda a, b: a - b),
    ("rsub", lambda a, b: 1.0 - a, lambda a, b: 1.0 - a),
    ("mul", lambda a, b: a * b, lambda a, b: a * b),
    ("mul_scalar", lambda a, b: a * 3.0, lambda a, b: a * 3.0),
    ("div", lambda a, b: a / (b + 4.0), lambda a, b: a / (b + 4.0)),
    ("div_constant", lambda a, b: a / 60, lambda a, b: a / 60),
    ("iadd", lambda a, b: a.clone().__iadd__(b), lambda a, b: a + b),
    ("maximum", torch.maximum, jnp.maximum),
    ("minimum", torch.minimum, jnp.minimum),
    ("clamp", lambda a, b: torch.clamp(a, -1.0, 1.0),
     lambda a, b: jnp.clip(a, -1.0, 1.0)),
    ("sum", lambda a, b: (a + 0 * b)[:3].sum(), lambda a, b: (a + 0 * b)[:3].sum()),
    ("cumsum", lambda a, b: torch.cumsum(a, 0), lambda a, b: jnp.cumsum(a)),
    ("floor", lambda a, b: torch.floor(a), lambda a, b: jnp.floor(a)),
    ("gt", lambda a, b: a > 0, lambda a, b: a > 0),
    ("eq", lambda a, b: a == b, lambda a, b: a == b),
    ("le", lambda a, b: a <= 0, lambda a, b: a <= 0),
    ("where", lambda a, b: torch.where(torch.arange(8) % 2 == 0, a, b),
     lambda a, b: jnp.where(jnp.arange(8) % 2 == 0, a, b)),
    ("gather", lambda a, b: a[torch.tensor([2, 0, 1])],
     lambda a, b: a[jnp.array([2, 0, 1])]),
    ("concat", lambda a, b: torch.cat([a, b]), lambda a, b: jnp.concatenate([a, b])),
    ("neg", lambda a, b: -a, lambda a, b: -a),
    ("abs", lambda a, b: torch.abs(a), lambda a, b: jnp.abs(a)),
    ("to_other_float", lambda a, b: a.to(torch.float32 if a.dtype == torch.float64
                                         else torch.float64),
     lambda a, b: a.astype(jnp.float32 if a.dtype == jnp.float64 else jnp.float64)),
    ("to_same_float", lambda a, b: a.to(a.dtype), lambda a, b: a.astype(a.dtype)),
    ("scatter_set", lambda a, b: torch.zeros_like(a).index_put_(
        (torch.arange(8),), b), lambda a, b: jnp.zeros_like(a).at[jnp.arange(8)].set(b)),
    ("sqrt", lambda a, b: torch.sqrt(torch.abs(a) + b * b),
     lambda a, b: jnp.sqrt(jnp.abs(a) + b * b)),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,top,jop", OPS, ids=[o[0] for o in OPS])
def test_subnormal_op_sets_match_jitted_xla(name, top, jop, dtype):
    """Each op of ``arith.py``'s sets (and the data movement it passes),
    under ``reference_arithmetic``, against the same op in a jitted JAX
    function on the same subnormal inputs: the same bits, the sign of
    every zero included."""
    a, b = _probe_inputs(dtype)
    want = np.asarray(jax.jit(jop)(a, b))
    with reference_arithmetic():
        got = top(torch.from_numpy(a.copy()), torch.from_numpy(b.copy())).numpy()
    _assert_bitwise(got, want)


def test_subnormal_op_sets_name_the_probed_ops():
    assert {"add", "sub", "mul", "div", "maximum", "minimum", "sum",
            "cumsum", "floor", "sqrt", "clamp", "add_"} <= FLUSHED
    # (sqrt is probed bitwise over many values in
    # test_subnormal_sqrt_is_correctly_rounded)
    assert {"gt", "eq", "le", "__gt__"} <= COMPARED
    assert "to" in CONVERSIONS
    # data movement and the sign-bit ops pass the bits
    for name in ("where", "index_put_", "cat", "neg", "abs", "copysign",
                 "__getitem__", "clone"):
        assert name not in FLUSHED | COMPARED | CONVERSIONS


@pytest.mark.parametrize("outer_flush", [True, False])
def test_subnormal_nested_reference_arithmetic_adds_no_mode(outer_flush):
    """A combiner enters its own ``reference_arithmetic`` inside a user
    function's: the inner entry adds no second mode (which would flush
    every result again) and keeps the outer one's flush."""
    from torch.overrides import _get_current_function_mode_stack

    a = torch.tensor([1.5e-38, -1.5e-38], dtype=torch.float32)
    b = torch.tensor([-1.4e-38, 1.4e-38], dtype=torch.float32)
    with reference_arithmetic(flush=outer_flush):
        depth = len(_get_current_function_mode_stack())
        with reference_arithmetic():
            assert len(_get_current_function_mode_stack()) == depth
            assert torch.get_default_dtype() == torch.float64
            got = (a + b).numpy()
        assert len(_get_current_function_mode_stack()) == depth
    want = (np.asarray(jax.jit(jnp.add)(a.numpy(), b.numpy())) if outer_flush
            else a.numpy() + b.numpy())
    _assert_bitwise(got, want)
    assert len(_get_current_function_mode_stack()) == 0


# -- jobs through both packages -------------------------------------------

def _ch2_items(scale, n=200, hosts=3, seed=0, minute_advances=True):
    """The chapter-2 lines ``ts host cpuN usage`` with ``usage =
    rng.random() * scale``, and processing-time advances that fire the
    1-minute windows."""
    rng = np.random.default_rng(seed)
    out = [f"{1563452000 + i} 10.8.0.{int(rng.integers(0, hosts))} cpu{i % 2} "
           f"{float(rng.random() * scale)!r}" for i in range(n)]
    if minute_advances:
        out.append(("advance", n * 400 + 120_000))
    return out


def _run(side, build, items, capsys, event_time=False, **cfg):
    """``build(ns, stream)``'s rows through one package: ``(repr of each
    collected row, print() bytes)``."""
    ns = PKGS[side]
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(**cfg, **ns.cfg))
    if event_time:
        env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    src = ns.sources.ReplaySource(
        [ns.sources.AdvanceProcessingTime(x[1]) if isinstance(x, tuple) else x
         for x in items], ms_per_record=400)
    stream = build(ns, env.add_source(src))
    handle = stream.collect()
    stream.print()
    capsys.readouterr()
    env.execute("subnormal")
    return [repr(t) for t in handle.items], capsys.readouterr().out


def _both(build, items, capsys, **cfg):
    want = _run("jax", build, items, capsys, **cfg)
    got = _run("torch", build, items, capsys, **cfg)
    assert got[0] == want[0]
    assert got[1] == want[1]  # print() bytes: the sign of every zero
    return got[0]


def _job(name):
    return lambda ns, text: ns.jobs[name].build(None, text)


@pytest.mark.parametrize("acc_dtype,scale", [("float32", 1e-39),
                                             ("float64", 1e-309)])
def test_subnormal_chapter2_mean_matches_the_jax_package(acc_dtype, scale,
                                                         capsys):
    """The chapter-2 mean over subnormal usages: under float32 at 1e-39
    (normal in float64, subnormal once the merge narrows it to its
    float32 plane) and exact at 1e-309 (subnormal in float64, flushed by
    the user's add). The JAX package prints 0.0 in every row."""
    rows = _both(_job("avg"), _ch2_items(scale), capsys, batch_size=64,
                 acc_dtype=acc_dtype)
    assert rows and set(rows) == {"0.0"}


def test_subnormal_chapter2_rolling_max_matches_the_jax_package(capsys):
    """The chapter-2 rolling max (``seq_rolling``'s plain version on the
    CPU) at 1e-309: every max the JAX package forms is flushed."""
    items = _ch2_items(1e-309, minute_advances=False)
    rows = _both(_job("max"), items, capsys, batch_size=64)
    assert len(rows) == 200 and all(r.endswith(",0.0)") for r in rows)


def test_subnormal_rolling_sum_float32_matches_the_jax_package(capsys):
    """A float32 rolling sum (the aggregated field stored in float32,
    widened for the fold) near 1e-39: the running sums are normal
    float64, the stored float32 value is flushed while it is below
    float32's tiny (2^-126) and kept once it is above. The usages are
    small multiples of 2^-130, so every float64 sum is exact and the
    fold's order (a tree in both packages, not the same tree) cannot
    show: only the flush can."""
    rng = np.random.default_rng(0)
    items = [f"{1563452000 + i} 10.8.0.{int(rng.integers(0, 3))} cpu{i % 2} "
             f"{int(rng.integers(1, 4)) * 2.0 ** -130!r}" for i in range(200)]

    def build(ns, text):
        def parse(line):
            f = line.split(" ")
            return ns.pkg.Tuple3(f[1], f[2], float(f[3]))
        return text.map(parse).key_by(0).sum(2)

    rows = _both(build, items, capsys, batch_size=16, acc_dtype="float32")
    assert len(rows) == 200


@pytest.mark.parametrize("scale", [1e-39, 1e-309])
def test_subnormal_chapter2_median_keeps_the_copies(scale, capsys):
    """The chapter-2 median copies the values into per-key buffers and
    takes the median on the host: a copy path, so the subnormals are
    printed in both packages (a flush at the step's entry would zero
    them)."""
    rows = _both(_job("median"), _ch2_items(scale), capsys, batch_size=64)
    assert rows and all(0.0 < float(r) < scale for r in rows)


def test_subnormal_user_filter_matches_the_jax_package(capsys):
    """A user filter ``usage > 0`` on the card's chain: a comparison,
    so a subnormal usage is not greater than 0."""
    items = [f"{1563452000 + i} 10.8.0.{i % 3} cpu0 {v!r}" for i, v in
             enumerate([1e-309, -1e-309, 5e-324, 1.0, 2e-308, 3e-308, 0.5])]

    def build(ns, text):
        def parse(line):
            f = line.split(" ")
            return ns.pkg.Tuple2(f[1], float(f[3]))
        return text.map(parse).filter(lambda t: t.f1 > 0.0)

    rows = _both(build, items, capsys, batch_size=4)
    assert len(rows) == 3


class Mean:
    """A float mean: (count, sum) summed, the result a division."""

    def create_accumulator(self):
        return (0, 0.0)

    def add(self, value, acc):
        return (acc[0] + 1, acc[1] + value.f2)

    def get_result(self, acc):
        return acc[1] / acc[0]

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])


def _ts(ns):
    class Ts(ns.pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(ns.pkg.Time.milliseconds(2000))

        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

    return Ts()


def _parse3(ns):
    def parse(line):
        f = line.split(" ")
        return ns.pkg.Tuple3(f[1], f[2], float(f[3]))

    return parse


def _event_lines(scale, n=120, seed=5):
    rng = np.random.default_rng(seed)
    return [f"{1000 * (i + 1) + 6000 * (i // 15)} h{int(rng.integers(0, 4))} "
            f"cpu{i % 3} {float(rng.random() * scale)!r}" for i in range(n)]


def test_subnormal_session_mean_matches_the_jax_package(capsys):
    def build(ns, text):
        w = text.assign_timestamps_and_watermarks(_ts(ns))
        win = w.map(_parse3(ns)).key_by(0).window(
            ns.windows.EventTimeSessionWindows.with_gap(ns.pkg.Time.seconds(4)))
        return win.aggregate(Mean())

    rows = _both(build, _event_lines(1e-309), capsys, event_time=True,
                 batch_size=8, key_capacity=8)
    assert len(rows) > 10


def test_subnormal_count_window_sum_matches_the_jax_package(capsys):
    def build(ns, text):
        return text.map(_parse3(ns)).key_by(0).count_window(5).reduce(
            lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))

    rows = _both(build, _event_lines(1e-309, seed=9), capsys, batch_size=7,
                 key_capacity=8)
    assert len(rows) > 10


def _ch3_lines(n=240, seed=3, float_flow=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m, s = divmod(i * 7, 60)
        flow = (repr(float(rng.random() * 1e-39)) if float_flow
                else str(int(rng.integers(0, 3))))
        out.append(f"2019-08-01T10:{m:02d}:{s:02d} ch{int(rng.integers(0, 4))} "
                   f"{flow}")
    return out


@pytest.mark.parametrize("flow", ["int", "float"])
def test_subnormal_flagship_float32_matches_the_jax_package(flow, capsys):
    """The flagship under ``acc_dtype="float32"``: its own integer flows
    (small, so the Mbps map's products are the only floats), and the same
    job with float flows at 1e-39, which the float32 window plane
    flushes."""
    def build(ns, text):
        if flow == "int":
            return ns.jobs["ch3"].build(None, text)
        mod = ns.jobs["ch3"]

        def parse(s):
            f = s.split(" ")
            return ns.pkg.Tuple3(0, f[1], float(f[2]))

        return (text.assign_timestamps_and_watermarks(
                    mod.IsoTimestampExtractor(ns.pkg.Time.minutes(1)))
                .map(parse).key_by(1)
                .time_window(ns.pkg.Time.minutes(5), ns.pkg.Time.seconds(5))
                .reduce(lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
                .map(lambda t: ns.pkg.Tuple2(t.f1, t.f2 * 8.0)))

    rows = _both(build, _ch3_lines(float_flow=flow == "float"), capsys,
                 event_time=True, batch_size=32, key_capacity=8,
                 acc_dtype="float32")
    assert len(rows) > 20


# -- the ordered merge against jitted XLA ---------------------------------

@jax.jit
def _xla_scatter_add(plane, cells, vals):
    return plane.at[cells].add(vals, mode="drop")


def _merge_case(plane, cells, vals, cell_dtype=np.int64):
    """The port's merge (the wrapper, so the CPU's plain version) against
    the JAX package's scatter, bitwise; the last cell is the sink, which
    takes nothing in the port: XLA's ``mode="drop"`` sees it as a cell,
    so cells at the sink are sent past the end for XLA."""
    plane = np.asarray(plane, np.float32)
    cells = np.asarray(cells, np.int64)
    vals = np.asarray(vals, np.float32)
    sink = plane.size - 1
    xla_cells = np.where(cells >= sink, plane.size + 5, cells)
    want = np.asarray(_xla_scatter_add(plane, xla_cells, vals))
    got = ordered_scatter_add(torch.from_numpy(plane.copy()),
                              torch.from_numpy(cells.astype(cell_dtype)),
                              torch.from_numpy(vals)).numpy()
    _assert_bitwise(got, want)
    return got


@pytest.mark.parametrize("cell_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("case", ["subnormal", "cancel", "negative"])
def test_subnormal_merge_matches_jitted_xla(case, cell_dtype):
    t = F32_TINY
    if case == "subnormal":
        # subnormal values and old values, alone and summed past tiny
        plane = [t / 4, 0.0, 1.0, -0.0, t / 2, 0.0]
        cells = [0, 0, 1, 2, 3, 4, 4, 5]
        vals = [t / 2, t / 2, t / 8, t / 8, t / 3, t / 2, t, 7.0]
        want_zero = [1]
    elif case == "cancel":
        # normal values whose sum falls into the subnormal range
        plane = [1.5e-38, 0.0, -1.5e-38, 2.0, 0.0]
        cells = [0, 0, 1, 1, 2, 3, 3]
        vals = [-1.4e-38, 3.0, 1.5e-38, -1.4e-38, 1.4e-38, 1.0, -1.0]
        want_zero = [1, 2]
    else:
        # negative subnormals: the sign of the zero they leave
        plane = [0.0, -0.0, -0.0, 0.0, -t / 2, 0.0]
        cells = [0, 1, 2, 2, 3, 4, 4]
        vals = [-t / 2, -t / 2, -t / 4, t / 4, -t / 3, t / 2, -t / 2]
        want_zero = [0, 1, 2, 3, 4]
    got = _merge_case(plane, cells, vals, cell_dtype)
    assert all(got[i] == 0.0 for i in want_zero)


_NEAR = st.sampled_from([0.0, -0.0, 1.0, -1.0]) | st.floats(
    min_value=-4 * float(F32_TINY), max_value=4 * float(F32_TINY),
    width=32, allow_subnormal=True)


@settings(max_examples=80, deadline=None)
@given(
    n_cells=st.integers(1, 6),
    rows=st.lists(st.tuples(st.integers(0, 7), _NEAR), min_size=0,
                  max_size=60),
    old=st.lists(_NEAR, min_size=7, max_size=7),
)
def test_subnormal_merge_hypothesis_matches_jitted_xla(n_cells, rows, old):
    """Cells and values drawn from the subnormal and near-subnormal
    ranges (and a few normal values), with the sink and cells past the
    plane among them: the merge and XLA give the same bits."""
    plane = np.asarray(old[: n_cells + 1], np.float32)
    cells = np.asarray([c for c, _ in rows], np.int64)
    vals = np.asarray([v for _, v in rows], np.float32)
    _merge_case(plane, cells, vals)
    ref = ordered_scatter_add_ref(torch.from_numpy(plane.copy()),
                                  torch.from_numpy(cells.astype(np.int32)),
                                  torch.from_numpy(vals)).numpy()
    _merge_case(plane, cells, vals, np.int32)
    _assert_bitwise(ref, _merge_case(plane, cells, vals))


# -- what XLA computes without a flush, and sqrt ---------------------------
# (each case below printed other rows, or other bits, before the port
# copied the rule it names)

TABLE_LINES = ["1563452000 10.8.0.1 cpu0 1e-309", "1563452001 10.8.0.1 cpu0 3e-309",
               "1563452002 10.8.0.2 cpu0 -2e-309"]
# the rows the JAX package prints for the chapter-2 rolling max over
# TABLE_LINES, by batch_size
TABLE_ROWS = {
    1: ["(10.8.0.1,cpu0,1e-309)", "(10.8.0.1,cpu0,0.0)", "(10.8.0.2,cpu0,-2e-309)"],
    4: ["(10.8.0.1,cpu0,0.0)", "(10.8.0.1,cpu0,0.0)", "(10.8.0.2,cpu0,0.0)"],
}
# zeros of both signs and subnormals after seen and new keys
ZERO_LINES = ["1 a c -1.0", "2 a c -2e-309", "3 b c -3e-309", "4 b c -1e-309",
              "5 c c 2.0", "6 c c -5e-324", "7 d c -0.0", "8 e c 0.0",
              "9 a c -1e-309", "10 c c 1e-309"]


def _rolling(op):
    def build(ns, text):
        return text.map(_parse3(ns)).key_by(0).__getattribute__(op)(2)
    return build


@pytest.mark.parametrize("op", ["max", "min", "sum"])
@pytest.mark.parametrize("batch_size", [1, 2])
def test_subnormal_rolling_one_row_batch_matches_the_jax_package(
        op, batch_size, capsys):
    """The one-row rule. The reference steps a batch of one row without its
    segmented scan, so a new key's first value is copied, subnormal and
    all, and only a combine with the stored value flushes; a last batch
    of one valid row at batch_size 2 is padded and scanned. The rolling
    max, min and sum (``seq_rolling``'s plain version) through both
    packages, over a subnormal per key and zeros of both signs."""
    rows = _both(_rolling(op), TABLE_LINES + ZERO_LINES, capsys,
                 batch_size=batch_size)
    if op == "max" and batch_size == 1:
        assert rows[:3] == TABLE_ROWS[1]


@pytest.mark.parametrize("op", ["max", "min", "sum"])
@pytest.mark.parametrize("batch_size", [3, 4])
def test_subnormal_rolling_scan_zero_sign_matches_the_jax_package(
        op, batch_size, capsys):
    """The scan's zeros. The reference's scan interleaves by adding 0.0 to
    every value, so a flushed negative subnormal and a -0.0 come out of
    it as +0.0, a new key's first value among them; the stored value's
    combine after it keeps its own sign rules."""
    rows = _both(_rolling(op), TABLE_LINES + ZERO_LINES, capsys,
                 batch_size=batch_size)
    if op == "max" and batch_size == 4:
        assert rows[:3] == TABLE_ROWS[4]


@pytest.mark.parametrize("op", ["max_by", "min_by"])
@pytest.mark.parametrize("batch_size", [1, 4])
def test_subnormal_rolling_by_record_matches_the_jax_package(
        op, batch_size, capsys):
    """The general rolling path (``max_by``/``min_by``): its scan adds
    0.0 as the kernel's path does, and its select between the two
    compared values is a max/min instruction in XLA, which flushes them
    (the record's other fields keep their bits)."""
    _both(_rolling(op), TABLE_LINES + ZERO_LINES, capsys,
          batch_size=batch_size)


def test_subnormal_kernel_plain_version_rules():
    """``seq_rolling_reduce_ref`` with and without ``fresh``: a batch of
    one row copies a fresh key's value and flushes a seen key's combine;
    a scanned batch folds ``plus_zero``'d values."""
    from tpustream_torch.ops.seq_rolling import IDENTITY, seq_rolling_reduce_ref

    ident = IDENTITY[torch.float64]["max"]
    plane = torch.tensor([ident, -1.0, ident], dtype=torch.float64)
    one = torch.tensor([-2e-309], dtype=torch.float64)
    got = seq_rolling_reduce_ref(plane, torch.tensor([0], dtype=torch.int32),
                                 one, "max", fresh=torch.tensor([True]))
    _assert_bitwise(got.numpy(), np.array([-2e-309]))
    _assert_bitwise(plane.numpy()[:1], np.array([-2e-309]))
    got = seq_rolling_reduce_ref(plane, torch.tensor([1], dtype=torch.int32),
                                 one, "max", fresh=torch.tensor([False]))
    _assert_bitwise(got.numpy(), np.array([-0.0]))
    got = seq_rolling_reduce_ref(
        plane, torch.tensor([2, 2], dtype=torch.int32),
        torch.tensor([-2e-309, -0.0], dtype=torch.float64), "max")
    _assert_bitwise(got.numpy(), np.array([0.0, 0.0]))


# XLA's algebraic simplifier removes these ops: the JAX
# package keeps a subnormal or a -0.0 through them
IDENTITY_OPS = [
    ("add_0", lambda x: x + 0.0, lambda x: x + 0.0),
    ("radd_0", lambda x: 0.0 + x, lambda x: 0.0 + x),
    ("add_neg0", lambda x: x + (-0.0), lambda x: x + (-0.0)),
    ("add_int0", lambda x: x + 0, lambda x: x + 0),
    ("sub_0", lambda x: x - 0.0, lambda x: x - 0.0),
    ("mul_1", lambda x: x * 1.0, lambda x: x * 1.0),
    ("rmul_1", lambda x: 1 * x, lambda x: 1 * x),
    ("div_1", lambda x: x / 1.0, lambda x: x / 1.0),
    ("pow_1", lambda x: x ** 1, lambda x: x ** 1),
    ("mul_neg1", lambda x: x * -1.0, lambda x: x * -1.0),
    ("div_neg1", lambda x: x / -1, lambda x: x / -1),
    ("neg0_sub", lambda x: -0.0 - x, lambda x: -0.0 - x),
    ("iadd_0", lambda x: x.clone().__iadd__(0.0), lambda x: x + 0.0),
    ("clamp_inf", lambda x: torch.clamp(x, -math.inf, math.inf),
     lambda x: jnp.clip(x, -math.inf, math.inf)),
    ("clamp_min_inf", lambda x: torch.clamp_min(x, -math.inf),
     lambda x: jnp.maximum(x, -math.inf)),
    ("clamp_max_inf", lambda x: torch.clamp(x, max=math.inf),
     lambda x: jnp.minimum(x, math.inf)),
    # not removed: computed, so flushed
    ("rsub_0", lambda x: 0.0 - x, lambda x: 0.0 - x),
    ("mul_0", lambda x: x * 0.0, lambda x: x * 0.0),
    ("add_tensor_0", lambda x: x + torch.zeros_like(x),
     lambda x: x + jax.lax.optimization_barrier(jnp.zeros_like(x))),
    ("pow_half", lambda x: x ** 0.5, lambda x: x ** 0.5),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,top,jop", IDENTITY_OPS,
                         ids=[o[0] for o in IDENTITY_OPS])
def test_subnormal_identities_match_jitted_xla(name, top, jop, dtype):
    """Each op of ``arith.IDENTITIES`` with a constant
    identity operand keeps ``x``'s bits, as XLA's simplifier does, and a
    near miss is computed and flushed; against a jitted JAX function."""
    tiny = F64_TINY if dtype == np.float64 else F32_TINY
    x = np.array([tiny / 8, -tiny / 8, -0.0, 0.0, 1.5, np.nan, -np.inf,
                  np.inf, tiny * 3, -2.0], dtype)
    want = np.asarray(jax.jit(jop)(x))
    with reference_arithmetic():
        got = top(torch.from_numpy(x.copy())).numpy()
    _assert_bitwise(got, want)


def test_subnormal_user_map_identity_matches_the_jax_package(capsys):
    """The simplifier's identities through a job: a user map ``t.f2 + 0.0`` keeps the
    subnormal usages in both packages."""
    def build(ns, text):
        return text.map(_parse3(ns)).map(
            lambda t: ns.pkg.Tuple2(t.f0, t.f2 + 0.0))

    rows = _both(build, TABLE_LINES, capsys, batch_size=4)
    assert rows == ["(10.8.0.1,1e-309)", "(10.8.0.1,3e-309)",
                    "(10.8.0.2,-2e-309)"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_subnormal_sqrt_is_correctly_rounded(dtype):
    """``sqrt`` and ``x ** 0.5`` under
    ``reference_arithmetic`` on a CPU vector give numpy's and the JAX
    package's correctly rounded roots (torch's own are one ulp off for
    about one value in a hundred), and an in-place root too."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.array([2.0, 3.0, 5.0, 0.5, -0.0, 0.0, -1.0,
                                  np.inf, -np.inf, np.nan, 1e-309], dtype),
                        (rng.random(20000) * 1000).astype(dtype)])
    want = np.asarray(jax.jit(jnp.sqrt)(x))
    with reference_arithmetic():
        t = torch.from_numpy(x.copy())
        got = torch.sqrt(t).numpy()
        pow_half = (t ** 0.5).numpy()
        t.sqrt_()
    _assert_bitwise(got, want)
    _assert_bitwise(t.numpy(), want)
    _assert_bitwise(pow_half, np.asarray(jax.jit(lambda v: v ** 0.5)(x)))
    with np.errstate(invalid="ignore"):
        _assert_bitwise(got[11:], np.sqrt(x[11:]))


def test_subnormal_rsqrt_is_left_within_one_ulp():
    """What the probe of ``rsqrt`` found and the port does not
    copy (fault 3.4 f, closed: the reference depends on the host): XLA
    computes ``rsqrt`` (and ``1 / sqrt(x)``, which it rewrites into it)
    by an approximation within one ulp of the true value. Its optimised
    LLVM IR (``XLA_FLAGS=--xla_dump_to``, jax 0.9.0 on the CPU) calls the
    processor's hardware estimate, ``llvm.x86.avx.rsqrt.ps.256`` for
    float32 and ``llvm.x86.avx512.rsqrt14.pd.256`` for float64, then two
    Newton-Raphson steps (a ``fmul`` by -0.5 ...), normal inputs sent
    down that path by an ``llvm.is.fpclass`` mask. The estimate's bits
    belong to the processor (Intel's and AMD's tables differ, and
    ``rsqrt14`` exists only with AVX-512), so the reference's ``rsqrt`` is
    a function of the host, not of the input alone: on the probing host
    it equalled the correctly rounded value for 85.1% of float32 and
    84.3% of float64 inputs drawn from [0.1, 100). No port can copy
    those bits on another machine or on the card; ``torch.rsqrt`` rounds
    twice, also within one ulp, so the two stay within two ulps of each
    other."""
    rng = np.random.default_rng(1)
    x = (rng.random(20000) * 1000 + 1e-3).astype(np.float64)
    xla = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    with reference_arithmetic():
        got = torch.rsqrt(torch.from_numpy(x)).numpy()
    ulps = np.abs(got - xla) / np.spacing(xla)
    assert ulps.max() <= 2.0
    assert np.array_equal(np.asarray(jax.jit(lambda v: 1 / jnp.sqrt(v))(x)), xla)


# -- fault 3.4 e, g, h: sorting, a select of the compared values, chains ----

def _probe_pair(dtype):
    """Subnormals of both signs, both zeros, NaNs of both signs, infinities
    and normal values, with ties, plus a seeded normal tail."""
    tiny = F64_TINY if dtype == np.float64 else F32_TINY
    rng = np.random.default_rng(7)
    a = np.concatenate([np.array(
        [tiny / 8, -tiny / 8, 0.0, -0.0, 1.5, np.nan, np.inf, tiny * 3,
         -np.nan, tiny / 2, -0.0, 0.0, -np.inf, -tiny / 4], dtype),
        (rng.standard_normal(602) * 10).astype(dtype)])
    b = np.concatenate([np.array(
        [tiny / 4, tiny / 8, -0.0, 0.0, 1.5, 1.0, np.nan, -tiny, 2.0,
         -tiny / 2, tiny / 8, -0.0, -np.inf, -tiny / 4], dtype),
        (rng.standard_normal(602) * 10).astype(dtype)])
    return a, b


# (name, torch op under reference_arithmetic, jitted jnp op)
SORT_OPS = [
    ("sort", lambda a, b: torch.sort(a).values, lambda a, b: jnp.sort(a)),
    ("sort_indices", lambda a, b: a.sort()[1], lambda a, b: jnp.argsort(a)),
    ("argsort", lambda a, b: torch.argsort(a), lambda a, b: jnp.argsort(a)),
    ("argsort_descending", lambda a, b: torch.argsort(a, descending=True),
     lambda a, b: jnp.argsort(a, descending=True)),
    ("sort_descending", lambda a, b: a.sort(descending=True).values,
     lambda a, b: jnp.sort(a, descending=True)),
    ("msort", lambda a, b: torch.msort(a.reshape(-1, 4)),
     lambda a, b: jnp.sort(a.reshape(-1, 4), axis=0)),
    ("sort_dim0", lambda a, b: torch.sort(a.reshape(-1, 2), dim=0)[1],
     lambda a, b: jnp.argsort(a.reshape(-1, 2), axis=0)),
    ("topk_values", lambda a, b: torch.topk(a, 40).values,
     lambda a, b: jax.lax.top_k(a, 40)[0]),
    ("topk_indices", lambda a, b: a.topk(40)[1],
     lambda a, b: jax.lax.top_k(a, 40)[1].astype(jnp.int64)),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,top,jop", SORT_OPS, ids=[o[0] for o in SORT_OPS])
def test_subnormal_sort_matches_jitted_xla(name, top, jop, dtype):
    """Fault 3.4 e: ``jnp.sort``/``argsort`` order the flushed values (a
    subnormal ties with both zeros, ``-0.0`` with ``+0.0``, NaNs last),
    stably, and move the original bits; ``lax.top_k`` orders by IEEE's
    total order. The port's sorts under ``reference_arithmetic`` give the
    same values and indices, bit for bit."""
    a, b = _probe_pair(dtype)
    want = np.asarray(jax.jit(jop)(a, b))
    with reference_arithmetic():
        got = top(torch.from_numpy(a.copy()), torch.from_numpy(b.copy())).numpy()
    if want.dtype.kind == "f":
        _assert_bitwise(got, want)
    else:
        assert np.array_equal(got, want.astype(got.dtype))


# every select of two tensors by a comparison of the same two, and a few
# selects of others
SELECT_OPS = [
    (f"where({p}{c}{q},{u},{v})",
     eval(f"lambda a, b: torch.where({p} {c} {q}, {u}, {v})"),
     eval(f"lambda a, b: jnp.where({p} {c} {q}, {u}, {v})"))
    for c in (">", ">=", "<", "<=")
    for p, q in (("a", "b"), ("b", "a"))
    for u, v in (("a", "b"), ("b", "a"))
] + [
    ("where_other", lambda a, b: torch.where(a > b, a, b * 2.0),
     lambda a, b: jnp.where(a > b, a, b * 2.0)),
    ("where_eq", lambda a, b: torch.where(a == b, a, b),
     lambda a, b: jnp.where(a == b, a, b)),
    ("where_method", lambda a, b: b.where(b > a, a),
     lambda a, b: jnp.where(b > a, b, a)),
    ("where_identity_copy", lambda a, b: torch.where(b > a, b, a * 1.0 + 0.0),
     lambda a, b: jnp.where(b > a, b, a * 1.0 + 0.0)),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,top,jop", SELECT_OPS,
                         ids=[o[0] for o in SELECT_OPS])
def test_subnormal_select_of_compared_matches_jitted_xla(name, top, jop, dtype):
    """Fault 3.4 g: XLA lowers a select of exactly the two tensors a
    strict comparison (``>``, ``<``) compared, in either order, to a
    max/min instruction that returns the flushed operand; after ``>=``,
    ``<=`` or ``==``, or of any other value, the select keeps the bits.
    A copy the simplifier removes (``a * 1.0 + 0.0``) is still ``a``."""
    a, b = _probe_pair(dtype)
    want = np.asarray(jax.jit(jop)(a, b))
    with reference_arithmetic():
        got = top(torch.from_numpy(a.copy()), torch.from_numpy(b.copy())).numpy()
    _assert_bitwise(got, want)


# a select between a tensor and the Python number it was compared with
CONST_COMPARISONS = (">", ">=", "<", "<=", "==", "!=")
CONSTANTS = (0.0, -0.0, 1.0, -1.0, 0.5, math.inf, -math.inf, math.nan, "sub")


def _constant(c, dtype):
    """A probe constant; ``"sub"`` is a subnormal of ``dtype``."""
    tiny = F64_TINY if dtype == np.float64 else F32_TINY
    return float(dtype(tiny / 4)) if c == "sub" else c


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("order", ["x_first", "c_first"])
@pytest.mark.parametrize("side", ["x_op_c", "c_op_x"])
@pytest.mark.parametrize("op", CONST_COMPARISONS)
@pytest.mark.parametrize("c", CONSTANTS, ids=[str(c) for c in CONSTANTS])
def test_subnormal_select_against_a_constant_matches_jitted_xla(
        c, op, side, order, dtype):
    """Fault 3.4 g, against a Python number: ``where(x OP c, x, c)`` and
    its mirrors, bitwise (with the sign of zero) against a jitted JAX
    function. XLA keeps the bits when the comparison can never hold
    (``x > inf``, ``x < -inf``, an ordered comparison with NaN), after
    ``==`` and ``!=``, and after ``>=``/``<=`` against ±0.0; it selects
    the flushed operands after ``>``/``<`` and after ``>=``/``<=``
    against any other number; a subnormal constant reads as a zero, and
    ``>=``/``<=`` then select as ``>``/``<`` do."""
    cv = _constant(c, dtype)
    x, _ = _probe_pair(dtype)
    src = (f"x {op} c" if side == "x_op_c" else f"c {op} x")
    sel = "m, x, c" if order == "x_first" else "m, c, x"
    jop = eval(f"lambda x, c: (lambda m: jnp.where({sel}))({src})")
    top = eval(f"lambda x, c: (lambda m: torch.where({sel}))({src})")
    want = np.asarray(jax.jit(lambda a: jop(a, cv))(x))
    with reference_arithmetic():
        got = top(torch.from_numpy(x.copy()), cv).numpy()
    _assert_bitwise(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_subnormal_select_of_another_constant_keeps_bits(dtype):
    """A select of ``x`` and a number other than the one compared is a
    plain select: its bits are kept."""
    x, _ = _probe_pair(dtype)
    want = np.asarray(jax.jit(lambda a: jnp.where(a > 1.0, a, 2.0))(x))
    with reference_arithmetic():
        t = torch.from_numpy(x.copy())
        got = torch.where(t > 1.0, t, 2.0).numpy()
    _assert_bitwise(got, want)


def _inplace_chain(a):
    y = a * 3.0
    y *= 7.0
    return y


CHAIN_OPS = [
    ("mul_mul", lambda a: a * 3.0 * 7.0),
    ("mul_div", lambda a: a * 0.1 / 10.0),
    ("div_mul", lambda a: a / 3.0 * 7.0),
    ("div_div", lambda a: a / 3.0 / 7.0),
    ("mul_mul_mul", lambda a: a * 1.7 * 2.3 * 0.9),
    ("half_two", lambda a: a * 0.5 * 2.0),
    ("reflected_mul", lambda a: 3.0 * a * 7.0),
    ("add_add", lambda a: a + 1.3 + 5.9),
    ("add_sub", lambda a: a + 1.3 - 0.7),
    ("sub_add", lambda a: a - 1.3 + 0.7),
    ("sub_sub", lambda a: a - 1.3 - 5.9),
    ("add_sub_identity", lambda a: a + 1.5 - 1.5),
    ("rsub_add", lambda a: (1.3 - a) + 5.9),
    ("rsub_sub", lambda a: (1.3 - a) - 5.9),
    ("add_then_mul", lambda a: (a + 1.3) * 2.3),
    ("div_constant", lambda a: a / 0.1),
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,fn", CHAIN_OPS + [("in_place", None)],
                         ids=[o[0] for o in CHAIN_OPS] + ["in_place"])
def test_subnormal_constant_chains_match_jitted_xla(name, fn, dtype):
    """Fault 3.4 h: XLA's simplifier folds a chain of multiplications (a
    division by a constant is one by its reciprocal) or of additions and
    subtractions with constants into one op with the constants combined
    in the tensor's dtype, which changes the rounding of normal values
    too; an identity that appears only after folding is removed. The
    port's ops under ``reference_arithmetic`` give the same bits."""
    a, _ = _probe_pair(dtype)
    jfn = (lambda x: x * 3.0 * 7.0) if fn is None else fn
    want = np.asarray(jax.jit(jfn)(a))
    with reference_arithmetic():
        got = (_inplace_chain if fn is None else fn)(
            torch.from_numpy(a.copy())).numpy()
    _assert_bitwise(got, want)


def test_subnormal_chain_sees_a_changed_base():
    """A chain folds only while its base is unchanged: after an in-place
    change of ``x`` the next op is computed on the tensor as it is."""
    x = torch.tensor([1.1, 2.2, 3.3], dtype=torch.float64)
    with reference_arithmetic():
        y = x * 3.0
        x.add_(1.0)
        z = y * 7.0
    assert torch.equal(z, (torch.tensor([1.1, 2.2, 3.3],
                                        dtype=torch.float64) * 3.0) * 7.0)
