"""The 32-bit accumulator configurations (``acc_dtype`` "float32" and
"int32") through the PyTorch port, on the CPU, side by side with the
JAX package.

* Rolling max/min/sum over a float64 and an int64 field: the
  aggregated field is stored in 32 bits (float32, or int64 wrapped to
  int32), combined with the batch's prefix in 64 bits; rows and
  ``print()`` bytes equal, and pass-through fields stay exact.
* Tumbling and sliding window ``reduce`` (the scatter-reduce path, and
  the exact path over 32-bit storage) and ``aggregate`` (the chapter-2
  mean, a float sum on the fixed-order merge): rows and ``print()``
  bytes equal; the fast path agrees with the exact one at rtol=1e-5.
* Session windows and the three count-window programs under float32.
* The fixed-order merge itself (``ops/ordered_scatter.py``) against
  ``np.add.at``, bitwise.

Tolerance: bitwise everywhere, except the one comparison of the 32-bit
fast path with the exact float64 path (rtol=1e-5, float32 rounding).
Values are not integers, so an add out of arrival order shows.
"""

import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import tpustream
import tpustream.api.windows as jax_windows
import tpustream.jobs.chapter2_avg as jax_avg
import tpustream.runtime.sources as jax_sources
import tpustream_torch
import tpustream_torch.api.windows as torch_windows
import tpustream_torch.jobs.chapter2_avg as torch_avg
import tpustream_torch.runtime.sources as torch_sources
from tpustream_torch.ops.ordered_scatter import (
    ordered_scatter_add,
    ordered_scatter_add_ref,
)

PKGS = {
    "jax": types.SimpleNamespace(pkg=tpustream, sources=jax_sources,
                                 windows=jax_windows, avg=jax_avg, cfg={}),
    "torch": types.SimpleNamespace(pkg=tpustream_torch, sources=torch_sources,
                                   windows=torch_windows, avg=torch_avg,
                                   cfg={"device": "cpu"}),
}
DTYPES = ("float32", "int32")


def _lines(n, seed, hosts=5, big=False):
    """``ts host cpuN value`` lines, one a second: a float value with all
    its digits, or (``big``) an int near the int32 range, so that 32-bit
    storage rounds or wraps."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h = int(rng.integers(0, hosts))
        if big:
            v = int(rng.integers(-2**31, 2**31))
        else:
            v = float(rng.random() * 1000.0 - 100.0)
        out.append(f"{1000 * (i + 1) + int(rng.integers(0, 500))} "
                   f"h{h} cpu{i % 3} {v!r}")
    return out


def _run(side, build, items, capsys, event_time=True, **cfg):
    """``build(ns, stream)``'s rows through one package: ``(repr of each
    collected row, print() bytes)``."""
    ns = PKGS[side]
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(**cfg, **ns.cfg))
    if event_time:
        env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    stream = build(ns, env.add_source(ns.sources.ReplaySource(items)))
    handle = stream.collect()
    stream.print()
    capsys.readouterr()
    env.execute("acc32")
    return [repr(t) for t in handle.items], capsys.readouterr().out


def _both(build, items, capsys, **cfg):
    want = _run("jax", build, items, capsys, **cfg)
    got = _run("torch", build, items, capsys, **cfg)
    assert got[0] == want[0]
    assert got[1] == want[1]  # print() bytes
    return got[0]


def _ts(ns, delay_ms=2000):
    class Ts(ns.pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(ns.pkg.Time.milliseconds(delay_ms))

        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

    return Ts()


def _parse3(ns, big):
    """(host, cpu, value) with a float64 or int64 value."""
    conv = int if big else float

    def parse(line):
        items = line.split(" ")
        return ns.pkg.Tuple3(items[1], items[2], conv(items[3]))

    return parse


# -- rolling --------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["max", "min", "sum"])
@pytest.mark.parametrize("field", ["f64", "i64"])
def test_acc32_rolling_matches_the_jax_package(field, op, dtype, capsys):
    big = field == "i64"
    items = _lines(90, seed=len(op) + big, big=big)

    def build(ns, text):
        keyed = text.map(_parse3(ns, big)).key_by(0)
        return getattr(keyed, op)(2)

    rows = _both(build, items, capsys, event_time=False, batch_size=7,
                 key_capacity=8, acc_dtype=dtype)
    assert len(rows) == len(items)
    if op == "sum" and not big:
        # the stored sums were rounded to float32: the rows differ from
        # the exact run's
        exact = _run("torch", build, items, capsys, event_time=False,
                     batch_size=7, key_capacity=8)[0]
        assert rows != exact


def test_acc32_rolling_keeps_passthrough_fields_exact():
    """The port's counterpart of tests/test_wordplanes_liveness.py::
    test_rolling_compact32_keeps_passthrough_fields_exact: under 32-bit
    storage only the aggregated column is truncated; a kept first-record
    int64 field (a timestamp past 2^32) stays exact."""
    from tpustream_torch.ops.rolling import init_rolling_state, rolling_step

    kinds = ["i64", "str", "f64"]  # big ts, key id, aggregated usage
    state = init_rolling_state(16, kinds, "max", 2, compact32=True)
    big_ts = 1_566_208_860_123_456  # > 2^32: wraps if wrongly compacted
    keys = torch.tensor([3, 3], dtype=torch.int32)
    cols = (torch.tensor([big_ts, big_ts + 1], dtype=torch.int64),
            torch.tensor([3, 3], dtype=torch.int32),
            torch.tensor([80.5, 78.4], dtype=torch.float64))
    state, emis = rolling_step(state, keys, cols, torch.ones(2, dtype=torch.bool),
                               kinds, "max", 2, compact32=True)
    assert emis[0].tolist() == [big_ts, big_ts]
    assert emis[2].tolist() == [80.5, 80.5]
    # the aggregated plane is 32-bit, the ts words are the exact pair
    dtypes = [p.dtype for p in state["planes"]]
    assert dtypes == [torch.int32, torch.int32, torch.int32, torch.float32]
    assert state["planes"][3][3].item() == np.float32(80.5)


def test_acc32_rolling_passthrough_job_matches_the_jax_package(capsys):
    """A rolling max whose record carries an int64 timestamp past 2^32:
    the job's rows keep it exact under float32, as the JAX package's."""
    items = _lines(40, seed=3)

    def build(ns, text):
        def parse(line):
            items = line.split(" ")
            return ns.pkg.Tuple3(int(items[0]) * 10_000_019, items[1],
                                 float(items[3]))
        return text.map(parse).key_by(1).max(2)

    rows = _both(build, items, capsys, event_time=False, batch_size=5,
                 key_capacity=8, acc_dtype="float32")
    assert all(int(r.strip("()").split(",")[0]) > 2**32 for r in rows)


# -- tumbling and sliding windows -----------------------------------------

def _window(ns, text, sliding, size_s=10):
    w = text.assign_timestamps_and_watermarks(_ts(ns))
    return w, (ns.pkg.Time.seconds(size_s),
               ns.pkg.Time.seconds(2) if sliding else None)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sliding", [False, True])
@pytest.mark.parametrize("shape", ["pair", "triple", "long"])
def test_acc32_window_reduce_matches_the_jax_package(shape, sliding, dtype,
                                                     capsys):
    """``pair``: (host, value) summed, the key rebuilt from the cell, so
    the float sum takes the scatter-reduce path through the ordered
    merge; ``triple``: a pass-through cpu field keeps the exact path over
    a 32-bit sum; ``long``: an int64 sum, wrapped in 32 bits."""
    big = shape == "long"
    items = _lines(120, seed=7 + sliding, big=big)

    def build(ns, text):
        w, (size, slide) = _window(ns, text, sliding)
        parse = _parse3(ns, big)
        if shape == "triple":
            keyed = w.map(parse).key_by(0)
            fn = lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2)  # noqa: E731
        else:
            keyed = w.map(lambda l: (lambda t: ns.pkg.Tuple2(t.f0, t.f2))(
                parse(l))).key_by(0)
            fn = lambda a, b: ns.pkg.Tuple2(a.f0, a.f1 + b.f1)  # noqa: E731
        win = keyed.time_window(size, slide) if slide else keyed.time_window(size)
        return win.reduce(fn)

    rows = _both(build, items, capsys, batch_size=9, key_capacity=8,
                 acc_dtype=dtype)
    assert len(rows) > 20


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sliding", [False, True])
def test_acc32_window_mean_matches_the_jax_package(sliding, dtype, capsys):
    items = _lines(150, seed=11 + sliding)

    def build(ns, text):
        w, (size, slide) = _window(ns, text, sliding)
        keyed = w.map(_parse3(ns, False)).key_by(0)
        win = keyed.time_window(size, slide) if slide else keyed.time_window(size)
        return win.aggregate(Mean())

    rows = _both(build, items, capsys, batch_size=16, key_capacity=8,
                 acc_dtype=dtype)
    assert len(rows) > 20


def _avg_items(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(f"{1563452000 + i} 10.8.0.{int(rng.integers(0, 7))} "
                   f"cpu{i % 4} {float(rng.random() * 100.0)!r}")
        if i % 97 == 96:
            out.append(("advance", i * 400 + 30_000))
    return out + [("advance", n * 400 + 120_000)]


def _avg_run(side, items, capsys, **cfg):
    """The chapter-2 mean (``AvgAggregate``, processing time)."""
    ns = PKGS[side]
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(**cfg, **ns.cfg))
    src = ns.sources.ReplaySource(
        [ns.sources.AdvanceProcessingTime(x[1]) if isinstance(x, tuple) else x
         for x in items], ms_per_record=400)
    stream = ns.avg.build(env, env.add_source(src))
    handle = stream.collect()
    stream.print()
    capsys.readouterr()
    env.execute("ComputeCpuAvg")
    return [repr(t) for t in handle.items], capsys.readouterr().out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch_size", [3, 64])
def test_acc32_chapter2_mean_matches_the_jax_package(batch_size, dtype, capsys):
    items = _avg_items(500, seed=batch_size)
    want = _avg_run("jax", items, capsys, batch_size=batch_size,
                    acc_dtype=dtype)
    got = _avg_run("torch", items, capsys, batch_size=batch_size,
                   acc_dtype=dtype)
    assert len(got[0]) > 20
    assert got == want


def test_acc32_aggregate_fast_path_matches_exact_approximately():
    """The port's counterpart of tests/test_wordplanes_liveness.py::
    test_aggregate_fast_path_matches_exact_approximately: the chapter-2
    mean takes the scatter-reduce path under float32 and agrees with the
    exact path to float32 precision."""
    from tpustream_torch import StreamExecutionEnvironment
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.runtime.plan import build_plan
    from tpustream_torch.runtime.sources import AdvanceProcessingTime, ReplaySource
    from tpustream_torch.runtime.step import build_program

    rng = np.random.default_rng(11)
    lines = [
        f"{1566208860 + i} 10.8.22.{i % 5} cpu{i % 3} "
        f"{rng.integers(1, 1000) / 10.0}"
        for i in range(400)
    ] + [AdvanceProcessingTime(300_000)]

    def run(acc_dtype):
        cfg = StreamConfig(batch_size=64, key_capacity=16, acc_dtype=acc_dtype,
                           device="cpu")
        env = StreamExecutionEnvironment(cfg)
        h = torch_avg.build(env, env.add_source(ReplaySource(lines))).collect()
        prog = build_program(build_plan(env, env._sinks), cfg)
        env.execute("avg")
        return sorted(float(x) for x in h.items), prog

    exact, p_exact = run("float64")
    fast, p_fast = run("float32")
    assert not p_exact.fast_reduce and p_fast.fast_reduce
    assert len(exact) == len(fast) > 0
    np.testing.assert_allclose(fast, exact, rtol=1e-5)


# -- sessions and count windows --------------------------------------------

@pytest.mark.parametrize("apply", ["reduce", "mean"])
def test_acc32_sessions_match_the_jax_package(apply, capsys):
    """Session state keeps each leaf at its kind's dtype in both
    packages whatever ``acc_dtype`` says: float32 rows equal the JAX
    package's, and the float64 run's."""
    items = _lines(120, seed=5)
    # gaps of 6 s now and then close sessions
    items = [f"{int(l.split(' ')[0]) + 6000 * (i // 15)} "
             + " ".join(l.split(" ")[1:]) for i, l in enumerate(items)]

    def build(ns, text):
        w = text.assign_timestamps_and_watermarks(_ts(ns))
        keyed = w.map(_parse3(ns, False)).key_by(0)
        win = keyed.window(
            ns.windows.EventTimeSessionWindows.with_gap(ns.pkg.Time.seconds(4)))
        if apply == "mean":
            return win.aggregate(Mean())
        return win.reduce(lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))

    rows = _both(build, items, capsys, batch_size=8, key_capacity=8,
                 acc_dtype="float32")
    assert len(rows) > 10
    exact = _run("torch", build, items, capsys, batch_size=8, key_capacity=8)[0]
    assert rows == exact


def _lister(key, ctx, elements, out):
    out.collect(f"{key}:{[e.f2 for e in elements]}")


@pytest.mark.parametrize("kind", ["tumbling", "sliding", "process"])
def test_acc32_count_windows_match_the_jax_package(kind, capsys):
    items = _lines(100, seed=9, hosts=4)

    def build(ns, text):
        keyed = text.map(_parse3(ns, False)).key_by(0)
        win = keyed.count_window(5, 2 if kind == "sliding" else None)
        if kind == "process":
            return win.process(_lister)
        return win.reduce(lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))

    rows = _both(build, items, capsys, event_time=False, batch_size=7,
                 key_capacity=8, acc_dtype="float32")
    assert len(rows) > 10
    exact = _run("torch", build, items, capsys, event_time=False,
                 batch_size=7, key_capacity=8)[0]
    assert rows == exact


# -- the fixed-order merge ------------------------------------------------

def _np_add_at(plane, cells, vals):
    out = plane.copy()
    n = plane.size - 1
    keep = (cells >= 0) & (cells < n)
    np.add.at(out, cells[keep], vals[keep])
    return out


@settings(max_examples=60, deadline=None)
@given(
    n_cells=st.integers(1, 9),
    cells=st.lists(st.integers(0, 9), min_size=0, max_size=200),
    seed=st.integers(0, 2**31 - 1),
)
def test_acc32_ordered_scatter_ref_is_np_add_at(n_cells, cells, seed):
    """Duplicate-heavy cell lists (at most 10 cells, the sink among
    them): the plain version gives ``np.add.at``'s bits."""
    rng = np.random.default_rng(seed)
    c = np.minimum(np.asarray(cells, dtype=np.int64), n_cells)
    vals = (rng.standard_normal(c.size)
            * 10.0 ** rng.integers(-3, 4, c.size)).astype(np.float32)
    plane = rng.standard_normal(n_cells + 1).astype(np.float32)
    want = _np_add_at(plane, c, vals)
    got = ordered_scatter_add_ref(torch.from_numpy(plane.copy()),
                                  torch.from_numpy(c), torch.from_numpy(vals))
    assert np.array_equal(got.numpy()[:-1].view(np.int32),
                          want[:-1].view(np.int32))
    # the sink takes nothing
    assert got.numpy()[-1].view(np.int32) == plane[-1].view(np.int32)


@pytest.mark.parametrize("case", ["uniform", "skewed", "one_key"])
def test_acc32_ordered_scatter_wrapper_takes_the_plain_version_on_cpu(case):
    rng = np.random.default_rng(1)
    n, b = 1000, 4096
    if case == "uniform":
        c = rng.integers(0, n + 1, b)
    elif case == "skewed":
        c = np.where(rng.random(b) < 0.7, 3, rng.integers(0, n + 1, b))
    else:
        c = np.full(b, 17)
    c = c.astype(np.int64)
    vals = rng.standard_normal(b).astype(np.float32)
    plane = rng.standard_normal(n + 1).astype(np.float32)
    got = ordered_scatter_add(torch.from_numpy(plane.copy()),
                              torch.from_numpy(c), torch.from_numpy(vals))
    assert np.array_equal(got.numpy().view(np.int32),
                          _np_add_at(plane, c, vals).view(np.int32))


def test_acc32_ordered_scatter_checks_its_arguments():
    plane = torch.zeros(5, dtype=torch.float32)
    cells = torch.zeros(3, dtype=torch.int64)
    vals = torch.zeros(3, dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        ordered_scatter_add(plane.double(), cells, vals)
    with pytest.raises(TypeError, match="int64"):
        ordered_scatter_add(plane, cells.int(), vals)
    with pytest.raises(ValueError, match="one length"):
        ordered_scatter_add(plane, cells[:2], vals)
    with pytest.raises(RuntimeError, match="no ordered_scatter_add kernel"):
        ordered_scatter_add(plane.to("meta"), cells.to("meta"), vals.to("meta"))
