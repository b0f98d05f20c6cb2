"""Session and count windows on the card against the same runs on the CPU
(tolerance: bitwise), and against the goldens of the JAX package's
suites (tests/test_session_windows.py, test_session_lateness.py,
test_session_process.py, test_count_windows.py). Every test here needs a
CUDA device and skips without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_windows_gpu.py -q
"""

import numpy as np
import pytest
import torch

import tpustream_torch as T
from tpustream_torch.api.windows import (
    EventTimeSessionWindows,
    ProcessingTimeSessionWindows,
)
from tpustream_torch.runtime.sources import AdvanceProcessingTime, ReplaySource

pytestmark = pytest.mark.gpu

GAP_MS = 10_000
DELAY_MS = 2_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this checks the card's run")
    return "cuda"


class TsExtractor(T.BoundedOutOfOrdernessTimestampExtractor):
    def __init__(self, delay_ms=DELAY_MS):
        super().__init__(T.Time.milliseconds(delay_ms))

    def extract_timestamp(self, value: str) -> int:
        return int(value.split(" ")[0])


def parse(value: str):
    items = value.split(" ")
    return T.Tuple2(items[1], int(items[2]))


def parse_float(value: str):
    items = value.split(" ")
    return T.Tuple2(items[1], float(items[2]))


def parse_pair(value: str):
    items = value.split(" ")
    return T.Tuple2(items[0], float(items[1]))


def median(key, context, elements, out):
    vals = sorted(e.f1 for e in elements)
    mid = len(vals) // 2
    out.collect(T.Tuple2(key, float(vals[mid]) if len(vals) % 2
                         else (vals[mid - 1] + vals[mid]) / 2))


class Mean(T.AggregateFunction):
    def create_accumulator(self):
        return T.Tuple2(0, 0.0)

    def add(self, value, acc):
        return T.Tuple2(acc.f0 + 1, acc.f1 + value.f1)

    def get_result(self, acc):
        return acc.f1 / acc.f0

    def merge(self, a, b):
        return T.Tuple2(a.f0 + b.f0, a.f1 + b.f1)


def _session_job(text, kind, gap_ms=GAP_MS, delay_ms=DELAY_MS, lateness_ms=0):
    """(main stream, late stream or None) of a session job ``kind``."""
    gap = T.Time.milliseconds(gap_ms)
    if kind == "processing":
        return (text.map(parse).key_by(0)
                .window(ProcessingTimeSessionWindows.with_gap(gap))
                .reduce(lambda a, b: T.Tuple2(a.f0, a.f1 + b.f1))), None
    stamped = text.assign_timestamps_and_watermarks(TsExtractor(delay_ms))
    w = (stamped.map(parse_float if kind == "mean" else parse).key_by(0)
         .window(EventTimeSessionWindows.with_gap(gap)))
    if lateness_ms:
        w = w.allowed_lateness(T.Time.milliseconds(lateness_ms))
    if kind == "mean":
        return w.aggregate(Mean()), None
    if kind == "process":
        return w.process(median), None
    tag = T.OutputTag("late") if kind == "lateness" else None
    if tag is not None:
        w = w.side_output_late_data(tag)
    reduced = w.reduce(lambda a, b: T.Tuple2(a.f0, a.f1 + b.f1))
    return reduced, (reduced.get_side_output(tag) if tag is not None else None)


def _count_job(text, kind):
    w = text.map(parse_pair).key_by(0)
    if kind == "tumbling":
        return w.count_window(5).reduce(lambda a, b: T.Tuple2(a.f0, a.f1 + b.f1))
    if kind == "sliding":
        return w.count_window(6, 4).aggregate(Mean())

    def lister(key, ctx, elements, out):
        out.collect(T.Tuple3(key, len(elements), "/".join(repr(e.f1) for e in elements)))

    return w.count_window(4, 3).process(lister)


def _run(build, items, device, capsys, processing=False, **cfg):
    """Rows, late rows, print() bytes and counters of one run."""
    cfg.setdefault("key_capacity", 8)
    env = T.StreamExecutionEnvironment(T.StreamConfig(
        device=device, alert_capacity=256, print_parallelism=2, **cfg))
    env.set_stream_time_characteristic(
        T.TimeCharacteristic.ProcessingTime if processing
        else T.TimeCharacteristic.EventTime)
    stream, late = build(env.add_source(ReplaySource(
        items, start_ms=1_000, ms_per_record=150)))
    h = stream.collect()
    stream.print()
    late_h = late.collect() if late is not None else None
    capsys.readouterr()
    env.execute("job")
    m = env.metrics.summary()
    return ([repr(t) for t in h.items],
            None if late_h is None else [repr(t) for t in late_h.items],
            capsys.readouterr().out,
            {k: m[k] for k in ("window_fires", "late_dropped", "alert_overflow",
                               "buffer_overflow", "evicted_unfired", "records_emitted")})


def _both(build, items, card, capsys, **kw):
    got = _run(build, items, card, capsys, **kw)
    assert got == _run(build, items, "cpu", capsys, **kw)
    return got


def lines_of(recs):
    return [f"{ts} {key} {v}" for ts, key, v in recs]


# -- goldens of the JAX package's session and count suites ----------------

SESSION_GOLDENS = [
    ([(1_000, "a", 1), (4_000, "a", 2), (9_000, "a", 4), (25_000, "a", 8)], 1, 0,
     ["(a,7)", "(a,8)"]),
    ([(0, "a", 1), (9_999, "a", 2), (20_000, "a", 4), (29_999, "a", 8),
      (60_000, "a", 16)], 1, 0, ["(a,3)", "(a,12)", "(a,16)"]),
    ([(0, "a", 1), (10_000, "a", 2), (50_000, "a", 4)], 1, 0,
     ["(a,1)", "(a,2)", "(a,4)"]),
    ([(0, "a", 1), (2_000, "a", 2), (13_000, "a", 4), (7_000, "a", 8),
      (60_000, "a", 16)], 1, 0, ["(a,15)", "(a,16)"]),
    ([(19_000, "a", 1), (28_000, "a", 2), (10_000, "a", 4), (70_000, "a", 8)], 1, 0,
     ["(a,7)", "(a,8)"]),
    ([(0, "a", 1), (5_000, "a", 2), (30_000, "a", 4), (8_000, "a", 8),
      (90_000, "a", 16)], 1, 30_000, ["(a,3)", "(a,4)", "(a,11)", "(a,16)"]),
    ([(0, "a", 1), (15_000, "a", 2), (40_000, "a", 4), (9_000, "a", 8),
      (120_000, "a", 16)], 1, 60_000, ["(a,1)", "(a,2)", "(a,4)", "(a,11)", "(a,16)"]),
    ([(0, "a", 1), (50_000, "a", 2), (40_000, "a", 4), (35_000, "a", 8),
      (120_000, "a", 16)], 2, 0, ["(a,1)", "(a,2)", "(a,12)", "(a,16)"]),
]


@pytest.mark.parametrize("case", range(len(SESSION_GOLDENS)))
def test_session_goldens_card_equals_cpu(card, case, capsys):
    recs, batch, lateness, golden = SESSION_GOLDENS[case]
    got = _both(lambda t: _session_job(t, "reduce", lateness_ms=lateness),
                lines_of(recs), card, capsys, batch_size=batch)
    assert sorted(got[0]) == sorted(golden)


def test_session_side_output_card_equals_cpu(card, capsys):
    recs = [(0, "a", 1), (40_000, "a", 2), (3_000, "a", 4), (90_000, "a", 8)]
    got = _both(lambda t: _session_job(t, "lateness", lateness_ms=5_000),
                lines_of(recs), card, capsys, batch_size=1)
    assert sorted(got[0]) == ["(a,1)", "(a,2)", "(a,8)"]
    assert got[1] == ["(a,4)"] and got[3]["late_dropped"] == 0


def test_session_process_goldens_card_equals_cpu(card, capsys):
    got = _both(lambda t: _session_job(t, "process"),
                ["1000000 a 1", "1019999 a 2", "1100000 b 3"], card, capsys,
                batch_size=8)
    assert sorted(got[0]) == ["(a,1.0)", "(a,2.0)", "(b,3.0)"]
    recs = [(1_000_000, "a", 1), (1_005_000, "a", 3), (1_030_000, "a", 9),
            (1_002_000, "a", 5), (1_090_000, "a", 7)]
    got = _both(lambda t: _session_job(t, "process", lateness_ms=30_000),
                lines_of(recs), card, capsys, batch_size=1)
    assert "(a,2.0)" in got[0] and "(a,3.0)" in got[0] and len(got[0]) == 4


COUNT_LINES = ["a 1", "a 2", "b 10", "a 4", "b 20", "a 8", "b 30", "a 16", "a 32",
               "a 64", "b 40"]


def test_count_goldens_card_equals_cpu(card, capsys):
    def tumbling(text):
        return (text.map(parse_pair).key_by(0).count_window(3)
                .reduce(lambda a, b: T.Tuple2(a.f0, a.f1 + b.f1))), None

    def sliding(text):
        return (text.map(parse_pair).key_by(0).count_window(3, 2)
                .reduce(lambda a, b: T.Tuple2(a.f0, a.f1 + b.f1))), None

    got = _both(tumbling, COUNT_LINES, card, capsys, batch_size=4)
    assert got[0] == ["(a,7.0)", "(b,60.0)", "(a,56.0)"]
    got = _both(sliding, COUNT_LINES, card, capsys, batch_size=4)
    hist, want = {}, []
    for line in COUNT_LINES:
        k, v = line.split(" ")
        hist.setdefault(k, []).append(float(v))
        if len(hist[k]) % 2 == 0:
            want.append(f"({k},{sum(hist[k][-3:])})")
    assert got[0] == want


# -- seeded inputs, card against CPU --------------------------------------

def _session_lines(seed, n=140, floats=False):
    rng = np.random.default_rng(seed)
    t = 1_600_000_000_000 + np.cumsum(rng.integers(0, 700, n))
    ts = t - rng.integers(0, 6_000, n) * (rng.random(n) < 0.2)
    keys = rng.integers(0, 5, n)
    vals = ([f"{v:.3f}" for v in rng.standard_normal(n) * 100] if floats
            else [str(v) for v in rng.integers(-1000, 1000, n)])
    return [f"{a} k{b} {c}" for a, b, c in zip(ts.tolist(), keys.tolist(), vals)]


SESSION_KINDS = [("reduce", "int32"), ("reduce", "float64"), ("mean", "float64"),
                 ("lateness", "float64"), ("processing", "float64"),
                 ("process", "float64")]


@pytest.mark.parametrize("batch_size", [1, 3, 64])
@pytest.mark.parametrize("kind,acc_dtype", SESSION_KINDS)
def test_sessions_card_equals_cpu(card, kind, acc_dtype, batch_size, capsys):
    items = _session_lines(batch_size, floats=(kind == "mean"))
    if kind == "processing":
        ticked = []
        for i in range(0, len(items), 12):
            ticked += items[i:i + 12] + [
                AdvanceProcessingTime(1_000 + 150 * (i + 12) + 5_000 * (i // 12 + 1))]
        items = ticked
    got = _both(lambda t: _session_job(t, kind, gap_ms=1_000, delay_ms=1_000,
                                       lateness_ms=0 if kind == "reduce" else 1_500),
                items, card, capsys, batch_size=batch_size, acc_dtype=acc_dtype,
                processing=(kind == "processing"))
    assert len(got[0]) >= 8


@pytest.mark.parametrize("batch_size", [1, 3, 64])
@pytest.mark.parametrize("kind", ["tumbling", "sliding", "process"])
def test_count_windows_card_equals_cpu(card, kind, batch_size, capsys):
    rng = np.random.default_rng(batch_size)
    keys = np.minimum(rng.geometric(0.35, 120) - 1, 6)
    lines = [f"h{k} {v:.4f}" for k, v in zip(keys.tolist(),
                                             (rng.standard_normal(120) * 1000).tolist())]
    got = _both(lambda t: (_count_job(t, kind), None), lines, card, capsys,
                batch_size=batch_size,
                acc_dtype="int32" if kind == "tumbling" else "float64")
    assert len(got[0]) >= 15


@pytest.mark.parametrize("kind", ["reduce", "mean", "process", "count"])
def test_key_growth_card_equals_cpu(card, kind, capsys):
    lines = [f"{l.split(' ')[0]} k{i % 13} {l.split(' ')[2]}"
             for i, l in enumerate(_session_lines(4, n=80, floats=kind in ("mean", "count")))]
    if kind == "count":
        def build(t):
            return (t.map(lambda l: T.Tuple2(l.split(" ")[1], float(l.split(" ")[2])))
                    .key_by(0).count_window(3)
                    .reduce(lambda a, b: T.Tuple2(a.f0, a.f1 + b.f1))), None
    else:
        def build(t):
            return _session_job(t, kind, gap_ms=1_000, delay_ms=1_000)
    small = _run(build, lines, card, capsys, batch_size=5, key_capacity=4)
    assert small == _run(build, lines, "cpu", capsys, batch_size=5, key_capacity=64)
    assert len(small[0]) > 10
