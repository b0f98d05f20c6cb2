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

Tolerance: none. Every comparison is bitwise: rows, ``print()`` bytes
(so the sign of every zero), and plane bits.
"""

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
    # (sqrt is flushed but not probed bitwise: torch's float64 sqrt on
    # the CPU's vector path gives sqrt(2.0) one ulp below the correctly
    # rounded value that numpy and XLA give)
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
