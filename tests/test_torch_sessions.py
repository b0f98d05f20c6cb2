"""Session windows through the PyTorch port, on the CPU.

* The single-device cases of the JAX package's session suites
  (tests/test_session_windows.py, test_session_lateness.py,
  test_session_process.py), run through the port with ``device="cpu"``
  against the same oracles and inputs.
* Side-by-side runs against the JAX package on seeded inputs, comparing
  rows, late side-output rows, ``print()`` bytes and counters
  (tolerance: bitwise): ``reduce`` on the scatter-reduce path (an
  integer sum, ``acc_dtype`` "int32" and "float64"), ``aggregate`` with a
  float sum (the ordered path, with allowed lateness), allowed lateness
  with the late side output, a processing-time session and a session ``process()``, at
  batch sizes 1, 3 and 64.
* Key growth past the initial capacity, and state carried across from
  the JAX package into the port mid-stream.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpustream
import tpustream_torch as T
from tests.test_session_lateness import as_batches, oracle_sums
from tests.test_session_process import _records as process_records
from tests.test_session_process import oracle as process_oracle
from tests.test_session_windows import lines_of, session_oracle
from tpustream_torch.api.windows import (
    EventTimeSessionWindows,
    ProcessingTimeSessionWindows,
)
from tpustream_torch.runtime.session_program import SessionWindowProgram
from tpustream_torch.runtime.sources import AdvanceProcessingTime, ReplaySource

GAP_MS = 10_000
DELAY_MS = 2_000


def parse(value: str):
    items = value.split(" ")
    return T.Tuple2(items[1], int(items[2]))


class TsExtractor(T.BoundedOutOfOrdernessTimestampExtractor):
    def __init__(self):
        super().__init__(T.Time.milliseconds(DELAY_MS))

    def extract_timestamp(self, value: str) -> int:
        return int(value.split(" ")[0])


def _env(**cfg):
    env = T.StreamExecutionEnvironment(T.StreamConfig(device="cpu", **cfg))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    return env


def _sessions(env, lines):
    return (
        env.add_source(ReplaySource(lines))
        .assign_timestamps_and_watermarks(TsExtractor())
        .map(parse)
        .key_by(0)
        .window(EventTimeSessionWindows.with_gap(T.Time.milliseconds(GAP_MS)))
    )


def run_session_job(lines, batch_size=1, key_capacity=64):
    env = _env(batch_size=batch_size, key_capacity=key_capacity,
               alert_capacity=1024)
    h = _sessions(env, lines).reduce(lambda a, b: T.Tuple2(a.f0, a.f1 + b.f1)).collect()
    env.execute("SessionJob")
    return sorted((t.f0, t.f1) for t in h.items)


# ---------------------------------------------------------------------------
# tests/test_session_windows.py, through the port
# ---------------------------------------------------------------------------


def test_single_session_fires_on_watermark():
    recs = [(1_000, "a", 1), (4_000, "a", 2), (9_000, "a", 4), (25_000, "a", 8)]
    got = run_session_job(lines_of(recs))
    assert got == sorted((k, v) for k, v, _ in session_oracle(recs))
    assert got == [("a", 7), ("a", 8)]


def test_gap_splits_sessions_exactly():
    recs = [(0, "a", 1), (9_999, "a", 2), (20_000, "a", 4), (29_999, "a", 8),
            (60_000, "a", 16)]
    assert run_session_job(lines_of(recs)) == [("a", 3), ("a", 12), ("a", 16)]


def test_boundary_gap_exactly_equal_to_gap_splits():
    recs = [(0, "a", 1), (10_000, "a", 2), (50_000, "a", 4)]
    assert run_session_job(lines_of(recs)) == [("a", 1), ("a", 2), ("a", 4)]


def test_multiple_keys_independent_sessions():
    recs = [(0, "a", 1), (1_000, "b", 10), (5_000, "a", 2), (30_000, "b", 20),
            (31_000, "a", 4)]
    got = run_session_job(lines_of(recs))
    assert got == sorted((k, v) for k, v, _ in session_oracle(recs))
    assert got == [("a", 3), ("a", 4), ("b", 10), ("b", 20)]


def test_out_of_order_record_merges_sessions():
    recs = [(0, "a", 1), (2_000, "a", 2), (13_000, "a", 4), (7_000, "a", 8),
            (60_000, "a", 16)]
    got = run_session_job(lines_of(recs))
    assert got == sorted((k, v) for k, v, _ in session_oracle(recs))
    assert got == [("a", 15), ("a", 16)]


def test_late_record_dropped():
    recs = [(0, "a", 1), (50_000, "a", 2), (5_000, "a", 4), (90_000, "a", 8)]
    got = run_session_job(lines_of(recs))
    assert got == sorted((k, v) for k, v, _ in session_oracle(recs))
    assert ("a", 4) not in got and ("a", 5) not in got


def _random_recs(seed, n, step, keys, jitter):
    rng = np.random.default_rng(seed)
    t, recs = 0, []
    for _ in range(n):
        t += int(rng.integers(0, step))
        key = str(rng.choice(keys))
        j = int(rng.integers(0, jitter))
        recs.append((max(0, t - j), key, int(rng.integers(1, 100))))
    return recs


def test_batched_matches_oracle_modulo_watermark_cadence():
    recs = _random_recs(7, 200, 15_000, ["a", "b", "c"], DELAY_MS)
    got = run_session_job(lines_of(recs))
    assert got == sorted((k, v) for k, v, _ in session_oracle(recs))


def test_processing_time_sessions():
    env = T.StreamExecutionEnvironment(
        T.StreamConfig(device="cpu", batch_size=4, key_capacity=16, alert_capacity=64))
    env.set_stream_time_characteristic(T.TimeCharacteristic.ProcessingTime)
    text = env.add_source(ReplaySource(
        ["x a 1", "x a 2", AdvanceProcessingTime(100_000)],
        start_ms=1_000, ms_per_record=100))
    h = (
        text.map(lambda v: T.Tuple2(v.split(" ")[1], int(v.split(" ")[2])))
        .key_by(0)
        .window(ProcessingTimeSessionWindows.with_gap(T.Time.milliseconds(GAP_MS)))
        .reduce(lambda a, b: T.Tuple2(a.f0, a.f1 + b.f1))
        .collect()
    )
    env.execute("ProcSession")
    assert [(t.f0, t.f1) for t in h.items] == [("a", 3)]


def test_session_aggregate_function():
    class CountAgg(T.AggregateFunction):
        def create_accumulator(self):
            return T.Tuple2("", 0)

        def add(self, value, accumulator):
            return T.Tuple2(value.f0, accumulator.f1 + 1)

        def get_result(self, accumulator):
            return accumulator.f1

        def merge(self, a, b):
            return T.Tuple2(a.f0, a.f1 + b.f1)

    recs = [(0, "a", 1), (3_000, "a", 1), (40_000, "a", 1)]
    env = _env(batch_size=1, key_capacity=16, alert_capacity=64)
    h = _sessions(env, lines_of(recs)).aggregate(CountAgg()).collect()
    env.execute("SessionCount")
    assert sorted(h.items) == [1, 2]


def test_session_fast_path_matches_generic_path(monkeypatch):
    """The scatter-reduce path and the ordered path give the same output
    on the same randomized stream (integer sums: exact either way)."""
    recs = _random_recs(21, 150, 12_000, ["a", "b", "c", "d", "e"], DELAY_MS)
    fast = run_session_job(lines_of(recs), batch_size=8)
    orig = SessionWindowProgram._analyze_session_fast

    def force_generic(self):
        orig(self)
        assert self._sess_fast, "stream/job no longer fast-eligible"
        self._sess_fast = False
        self._rel_ts = False

    monkeypatch.setattr(SessionWindowProgram, "_analyze_session_fast", force_generic)
    assert run_session_job(lines_of(recs), batch_size=8) == fast


def test_session_aggregate_keep_first_acc_stays_on_generic_path():
    """An aggregate whose merge passes a leaf through is keep-first, not
    a cell-invariant key: the scatter-reduce path must not take it."""

    class FirstAndTotal(T.AggregateFunction):
        def create_accumulator(self):
            return T.Tuple2(-1, 0)

        def add(self, value, accumulator):
            first = torch.where(torch.as_tensor(accumulator.f1) == 0,
                                value.f1, accumulator.f0)
            return T.Tuple2(first, accumulator.f1 + value.f1)

        def get_result(self, accumulator):
            return accumulator

        def merge(self, a, b):
            return T.Tuple2(a.f0, a.f1 + b.f1)  # f0 = keep a's first

    recs = [(0, "a", 7), (1_000, "a", 3), (2_000, "a", 5), (40_000, "a", 1)]
    env = _env(batch_size=1, key_capacity=16, alert_capacity=64)
    h = _sessions(env, lines_of(recs)).aggregate(FirstAndTotal()).collect()
    env.execute("SessionFirstTotal")
    assert sorted((t.f0, t.f1) for t in h.items) == [(1, 1), (7, 15)]


# ---------------------------------------------------------------------------
# tests/test_session_lateness.py, through the port
# ---------------------------------------------------------------------------


def run_late_job(recs, lateness_ms=0, batch_size=1, with_late_tag=False):
    env = _env(batch_size=batch_size, key_capacity=64, alert_capacity=1024)
    w = _sessions(env, lines_of(recs))
    if lateness_ms:
        w = w.allowed_lateness(T.Time.milliseconds(lateness_ms))
    tag = T.OutputTag("late") if with_late_tag else None
    if tag is not None:
        w = w.side_output_late_data(tag)
    stream = w.reduce(lambda a, b: T.Tuple2(a.f0, a.f1 + b.f1))
    h = stream.collect()
    late_h = stream.get_side_output(tag).collect() if tag is not None else None
    env.execute("SessionLateness")
    got = sorted((t.f0, t.f1) for t in h.items)
    late = sorted((t.f0, t.f1) for t in late_h.items) if late_h else []
    return got, late, env.metrics.summary()


def test_solo_late_record_merges_into_open_session():
    recs = [(19_000, "a", 1), (28_000, "a", 2), (10_000, "a", 4), (70_000, "a", 8)]
    got, _, s = run_late_job(recs)
    assert got == oracle_sums(as_batches(recs))
    assert ("a", 7) in got
    assert s["late_dropped"] == 0


def test_genuinely_late_record_still_dropped():
    recs = [(0, "a", 1), (50_000, "a", 2), (5_000, "a", 4), (90_000, "a", 8)]
    got, _, s = run_late_job(recs)
    assert got == oracle_sums(as_batches(recs))
    assert s["late_dropped"] == 1


def test_late_record_refires_session_within_lateness():
    L = 30_000
    recs = [(0, "a", 1), (5_000, "a", 2), (30_000, "a", 4), (8_000, "a", 8),
            (90_000, "a", 16)]
    got, _, s = run_late_job(recs, lateness_ms=L)
    assert got == oracle_sums(as_batches(recs), lateness=L)
    assert ("a", 3) in got and ("a", 11) in got
    assert s["late_dropped"] == 0


def test_retained_session_does_not_refire_without_new_data():
    L = 30_000
    recs = [(0, "a", 1), (30_000, "a", 2), (31_000, "a", 4), (32_000, "a", 8),
            (99_000, "a", 16)]
    got, _, _ = run_late_job(recs, lateness_ms=L)
    assert got == oracle_sums(as_batches(recs), lateness=L)
    assert got.count(("a", 1)) == 1


def test_late_record_bridges_two_retained_sessions():
    L = 60_000
    recs = [(0, "a", 1), (15_000, "a", 2), (40_000, "a", 4), (9_000, "a", 8),
            (120_000, "a", 16)]
    got, _, s = run_late_job(recs, lateness_ms=L)
    assert got == oracle_sums(as_batches(recs), lateness=L)
    assert ("a", 11) in got
    assert s["late_dropped"] == 0


def test_drop_beyond_lateness_horizon_to_side_output():
    L = 5_000
    recs = [(0, "a", 1), (40_000, "a", 2), (3_000, "a", 4), (90_000, "a", 8)]
    got, late, s = run_late_job(recs, lateness_ms=L, with_late_tag=True)
    assert got == oracle_sums(as_batches(recs), lateness=L)
    assert late == [("a", 4)]
    assert s["late_dropped"] == 0


def test_intra_batch_rescue_closure():
    recs = [(0, "a", 1), (50_000, "a", 2), (40_000, "a", 4), (35_000, "a", 8),
            (120_000, "a", 16)]
    got, _, s = run_late_job(recs, batch_size=2)
    assert got == oracle_sums(as_batches(recs, 2))
    assert ("a", 12) in got
    assert s["late_dropped"] == 0


@pytest.mark.parametrize("lateness_ms,batch_size", [(0, 1), (15_000, 1), (15_000, 8)])
def test_randomized_stream_matches_flink_oracle(lateness_ms, batch_size):
    recs = _random_recs(11, 200, 9_000, ["a", "b", "c"], 30_000)
    got, _, _ = run_late_job(recs, lateness_ms=lateness_ms, batch_size=batch_size)
    assert got == oracle_sums(as_batches(recs, batch_size), lateness=lateness_ms)


# ---------------------------------------------------------------------------
# tests/test_session_process.py, through the port
# ---------------------------------------------------------------------------


def median_process(key, context, elements, out):
    vals = sorted(e.f1 for e in elements)
    if not vals:
        out.collect(T.Tuple2(key, 0.0))
    elif len(vals) % 2 == 1:
        out.collect(T.Tuple2(key, float(vals[len(vals) // 2])))
    else:
        out.collect(T.Tuple2(key, (vals[len(vals) // 2 - 1] + vals[len(vals) // 2]) / 2))


def run_process_job(lines, batch_size=2, lateness_ms=0, fn=median_process,
                    key_capacity=64):
    env = _env(batch_size=batch_size, key_capacity=key_capacity)
    w = _sessions(env, lines)
    if lateness_ms:
        w = w.allowed_lateness(T.Time.milliseconds(lateness_ms))
    h = w.process(fn).collect()
    env.execute("session-median")
    return [(t.f0, t.f1) for t in h.items]


@pytest.mark.parametrize("batch_size", [1, 4, 64])
def test_session_process_median_matches_oracle(batch_size):
    recs = process_records()
    got = run_process_job(lines_of(recs), batch_size=batch_size)
    want = process_oracle(recs)
    assert sorted(got) == sorted(want)
    assert len(want) >= 8


def test_adjacent_pane_sessions_do_not_merge():
    got = run_process_job(["1000000 a 1", "1019999 a 2", "1100000 b 3"],
                          batch_size=8, key_capacity=16)
    assert sorted(got) == [("a", 1.0), ("a", 2.0), ("b", 3.0)]


def test_session_process_context_bounds():
    seen = {}

    def probe(key, context, elements, out):
        seen[key] = (context.start, context.end, len(elements))
        out.collect(T.Tuple2(key, float(len(elements))))

    got = run_process_job(["1000000 a 1", "1003000 a 2", "1060000 a 9"],
                          batch_size=4, fn=probe, key_capacity=16)
    assert got == [("a", 2.0), ("a", 1.0)]
    assert seen["a"] == (1060000, 1060000 + GAP_MS, 1)


def test_session_process_lateness_refire():
    recs = [(1_000_000, "a", 1), (1_005_000, "a", 3), (1_030_000, "a", 9),
            (1_002_000, "a", 5), (1_090_000, "a", 7)]
    got = sorted(run_process_job(lines_of(recs), batch_size=1, lateness_ms=30_000))
    assert ("a", 2.0) in got
    assert ("a", 3.0) in got
    assert len([x for x in got if x[0] == "a"]) == 4


# ---------------------------------------------------------------------------
# side by side with the JAX package
# ---------------------------------------------------------------------------

SIDE_GAP = 1_000


def _side_lines(seed, n=140, floats=False):
    """``ts key value`` lines: bursts per key with pauses past the gap,
    out of order by up to 6 s (past the 1 s delay and the 1.5 s
    lateness: late records)."""
    rng = np.random.default_rng(seed)
    t = 1_600_000_000_000 + np.cumsum(rng.integers(0, 700, n))
    ts = t - rng.integers(0, 6_000, n) * (rng.random(n) < 0.2)
    keys = rng.integers(0, 5, n)
    if floats:
        vals = [f"{v:.3f}" for v in rng.standard_normal(n) * 100]
    else:
        vals = [str(v) for v in rng.integers(-1000, 1000, n)]
    return [f"{a} k{b} {c}" for a, b, c in zip(ts.tolist(), keys.tolist(), vals)]


def _side_job(pkg, text, kind):
    """The job of side-by-side case ``kind`` in package ``pkg``: (main
    stream, late side-output stream or None)."""
    windows = import_module(pkg.__name__ + ".api.windows")
    out_mod = import_module(pkg.__name__ + ".api.output")

    class Ext(pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(pkg.Time.milliseconds(1_000))

        def extract_timestamp(self, line):
            return int(line.split(" ")[0])

    def parse_int(line):
        p = line.split(" ")
        return pkg.Tuple2(p[1], int(p[2]))

    def parse_float(line):
        p = line.split(" ")
        return pkg.Tuple3(p[1], float(p[2]), int(p[0]))

    gap = pkg.Time.milliseconds(SIDE_GAP)
    if kind == "processing":
        return (text.map(parse_int).key_by(0)
                .window(windows.ProcessingTimeSessionWindows.with_gap(gap))
                .reduce(lambda a, b: pkg.Tuple2(a.f0, a.f1 + b.f1))), None
    stamped = text.assign_timestamps_and_watermarks(Ext())
    if kind == "mean":
        class Mean(pkg.AggregateFunction):
            def create_accumulator(self):
                return pkg.Tuple2(0, 0.0)

            def add(self, value, acc):
                return pkg.Tuple2(acc.f0 + 1, acc.f1 + value.f1)

            def get_result(self, acc):
                return acc.f1 / acc.f0

            def merge(self, a, b):
                return pkg.Tuple2(a.f0 + b.f0, a.f1 + b.f1)

        return (stamped.map(parse_float).key_by(0)
                .window(windows.EventTimeSessionWindows.with_gap(gap))
                .allowed_lateness(pkg.Time.milliseconds(1_500))
                .aggregate(Mean())), None
    w = stamped.map(parse_int).key_by(0).window(
        windows.EventTimeSessionWindows.with_gap(gap))
    if kind == "process":
        def lister(key, ctx, elements, out):
            out.collect(pkg.Tuple3(key, ctx.end, "/".join(str(e.f1) for e in elements)))

        return w.allowed_lateness(pkg.Time.milliseconds(1_500)).process(lister), None
    tag = None
    if kind == "lateness":
        tag = out_mod.OutputTag("late")
        w = w.allowed_lateness(pkg.Time.milliseconds(1_500)).side_output_late_data(tag)
    reduced = w.reduce(lambda a, b: pkg.Tuple2(a.f0, a.f1 + b.f1))
    late = reduced.get_side_output(tag) if tag is not None else None
    return reduced.map(lambda t: pkg.Tuple3(t.f0, t.f1, t.f1 * 2)), late


def _side_run(pkg, kind, items, capsys, key_capacity=8, **cfg):
    sources = import_module(pkg.__name__ + ".runtime.sources")
    if pkg is T:
        cfg["device"] = "cpu"
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(
        key_capacity=key_capacity, alert_capacity=256, print_parallelism=2, **cfg))
    env.set_stream_time_characteristic(
        pkg.TimeCharacteristic.ProcessingTime if kind == "processing"
        else pkg.TimeCharacteristic.EventTime)
    src = sources.ReplaySource(
        [sources.AdvanceProcessingTime(x) if isinstance(x, int) else x for x in items],
        start_ms=1_000, ms_per_record=150)
    stream, late = _side_job(pkg, env.add_source(src), kind)
    h = stream.collect()
    stream.print()
    late = late.collect() if late is not None else None
    capsys.readouterr()
    env.execute("side")
    m = env.metrics.summary()
    return ([repr(t) for t in h.items], capsys.readouterr().out,
            None if late is None else [repr(t) for t in late.items],
            {k: m[k] for k in ("window_fires", "late_dropped", "alert_overflow",
                               "evicted_unfired", "records_emitted")})


def _side_items(kind, seed):
    if kind == "processing":
        # a processing-time tick past the gap after every dozen lines
        lines = _side_lines(seed)
        items = []
        for i in range(0, len(lines), 12):
            items += lines[i:i + 12] + [1_000 + 150 * (i + 12) + 5_000 * (i // 12 + 1)]
        return items
    return _side_lines(seed, floats=(kind == "mean"))


SIDE_CASES = [("reduce", "int32"), ("reduce", "float64"), ("mean", "float64"),
              ("lateness", "float64"), ("processing", "float64"),
              ("process", "float64")]


@pytest.mark.parametrize("batch_size", [1, 3, 64])
@pytest.mark.parametrize("kind,acc_dtype", SIDE_CASES)
def test_side_by_side_with_jax_package(kind, acc_dtype, batch_size, capsys):
    items = _side_items(kind, seed=batch_size)
    want = _side_run(tpustream, kind, items, capsys, batch_size=batch_size,
                     acc_dtype=acc_dtype)
    got = _side_run(T, kind, items, capsys, batch_size=batch_size,
                    acc_dtype=acc_dtype)
    assert len(want[0]) >= 8
    assert got[0] == want[0]
    assert got[1] == want[1]  # print() bytes
    assert got[2] == want[2]  # late side output
    assert got[3] == want[3]
    if kind == "lateness":
        # late rows reach the side output, none is dropped (at batch 64 a
        # late record's session is mostly in its own batch: none is late)
        assert (batch_size == 64 or want[2]) and want[3]["late_dropped"] == 0


@pytest.mark.parametrize("kind", ["reduce", "mean", "process"])
def test_key_growth_past_the_initial_capacity(kind, capsys):
    """Thirteen keys through a capacity of 4: the cells grow (state
    carried over) and the rows equal a run with room for every key from
    the start, and the JAX package's."""
    lines = [f"{l.split(' ')[0]} k{i % 13} {l.split(' ')[2]}"
             for i, l in enumerate(_side_lines(4, n=80, floats=(kind == "mean")))]
    small = _side_run(T, kind, lines, capsys, key_capacity=4, batch_size=5)
    big = _side_run(T, kind, lines, capsys, key_capacity=64, batch_size=5)
    ref = _side_run(tpustream, kind, lines, capsys, key_capacity=64, batch_size=5)
    assert len(ref[0]) > 10
    assert small[:3] == big[:3] == ref[:3]


# ---------------------------------------------------------------------------
# state carried across from the JAX package
# ---------------------------------------------------------------------------


def _program(pkg, kind, batch, key_capacity, acc_dtype="float64"):
    plan_mod = import_module(pkg.__name__ + ".runtime.plan")
    step_mod = import_module(pkg.__name__ + ".runtime.step")
    records = import_module(pkg.__name__ + ".records")
    sources = import_module(pkg.__name__ + ".runtime.sources")
    cfg = dict(batch_size=batch, key_capacity=key_capacity, alert_capacity=256,
               acc_dtype=acc_dtype)
    if pkg is T:
        cfg["device"] = "cpu"
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    env.set_stream_time_characteristic(pkg.TimeCharacteristic.EventTime)
    stream, _ = _side_job(pkg, env.add_source(sources.ReplaySource([])), kind)
    stream.collect()
    plan = plan_mod.build_plan(env, env._sinks)
    if kind == "mean":
        plan.record_kinds.extend(["str", "f64", "i64"])
        plan.tables.extend([records.StringTable(), None, None])
    else:
        plan.record_kinds.extend(["str", "i64"])
        plan.tables.extend([records.StringTable(), None])
    for key in range(key_capacity):  # the key column's ids are the interned ids
        plan.tables[0].intern(f"k{key}")
    return step_mod.build_program(plan, env.config), plan


def _carry_feeds(kind, batch, n_keys):
    rng = np.random.default_rng(9)
    feeds, t = [], 1_600_000_000_000
    for _ in range(9):
        ts = t + np.sort(rng.integers(0, 2_500, batch)) - rng.integers(0, 2_000, batch)
        keys = rng.integers(0, n_keys, batch).astype(np.int32)
        if kind == "mean":
            cols = [keys, rng.standard_normal(batch) * 100, ts]
        else:
            cols = [keys, rng.integers(-100, 100, batch)]
        feeds.append((cols, ts, True, -(2**62)))
        t += 2_200
    zero = np.zeros(batch, np.int64)
    feeds.append(([c * 0 for c in feeds[0][0]], zero, False, 2**62))  # end of stream
    return feeds


def _jax_rows(jprog, jplan, jstate, em, process):
    """One JAX step's emitted rows, as the executor orders them."""
    if process:
        rows = []
        jprog.evaluate_fires(jstate, em["process_fire"], jplan.device_post,
                             lambda item, *a, **k: rows.append(repr(item)))
        return rows
    m = np.asarray(em["main"]["mask"])
    cols = [np.asarray(c) for c in em["main"]["cols"]] + [np.asarray(em["main"]["window_end"])]
    return [tuple(c[j].item() for c in cols) for j in np.nonzero(m)[0]]


def _torch_rows(tprog, state, em, process):
    if process:
        rows = []
        if "process_fire" in em:
            tprog.evaluate_fires(state, em["process_fire"],
                                 lambda item, subtask, *_: rows.append(repr(item)),
                                 lambda ts: [t.numpy() for t in ts])
        return rows
    n = int(em["main"]["count"])
    cols = [c[:n].numpy() for c in em["main"]["cols"]] + [em["main"]["window_end"][:n].numpy()]
    return [tuple(c[j].item() for c in cols) for j in range(n)]


@pytest.mark.parametrize("kind,acc_dtype", [("reduce", "int32"), ("mean", "float64"),
                                            ("process", "float64")])
def test_state_carried_across_from_the_jax_package(kind, acc_dtype):
    """The JAX package runs k steps; its session state (numpy) moves into
    the port, which runs the rest: the rows equal the JAX package's full
    run, in order."""
    batch, kcap, k = 24, 8, 4
    process = kind == "process"
    jprog, jplan = _program(tpustream, kind, batch, kcap, acc_dtype)
    tprog, _ = _program(T, kind, batch, kcap, acc_dtype)
    jstep = jax.jit(jprog._step)
    jstate, want, got, carried = jprog.init_state(), [], [], None
    feeds = _carry_feeds(kind, batch, kcap)
    for i, (cols, ts, valid, wm_lower) in enumerate(feeds):
        if i == k:
            carried = jax.device_get(jstate)
        jstate, em = jstep(jstate, tuple(jnp.asarray(c) for c in cols),
                           jnp.full(batch, valid), jnp.asarray(ts),
                           jnp.asarray(wm_lower, jnp.int64))
        rows = _jax_rows(jprog, jplan, jstate, em, process)
        want += rows
        if i < k:
            got += rows
    state = tprog.state_from_jax_numpy(carried)
    for cols, ts, valid, wm_lower in feeds[k:]:
        state, em = tprog.step(state, [torch.from_numpy(np.asarray(c)) for c in cols],
                               torch.full((batch,), valid), torch.from_numpy(ts),
                               wm_lower)
        got += _torch_rows(tprog, state, em, process)
    assert len(want) > 10 and got == want
