"""Metrics and the ``strict_overflow`` policy in the PyTorch port, on the
CPU, against the JAX package: the single-device cases of
tests/test_metrics_strict.py. Late drops are counted without a late side
output, ``window_fires`` is wired, emit-latency percentiles are kept,
and a truncated ``process()`` buffer fails the job under
``strict_overflow``. With steps in flight the counters and rows do not
move: each case also runs at the ``deep`` pipeline setting. Tolerance:
identical rows and counters in both packages."""

import importlib

import pytest

from tests.test_torch_chains import PKGS

BASE = 1_200_000  # epoch seconds, multiple of 60
DEEP = dict(async_depth=4, h2d_depth=3, fetch_group=2)
COUNTERS = ("window_fires", "late_dropped", "records_in", "records_emitted",
            "buffer_overflow")


def seconds_extractor(ns):
    class SecondsExtractor(ns.pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(ns.pkg.Time.seconds(0))

        def extract_timestamp(self, line):
            return int(line.split(" ")[0]) * 1000

    return SecondsExtractor()


def parse(ns):
    def fn(line):
        p = line.split(" ")
        return ns.pkg.Tuple3(int(p[0]), p[1], int(p[2]))
    return fn


def run_reduce_job(side, lines, late_tag=False, **cfg):
    ns = PKGS[side]
    windows = importlib.import_module(ns.pkg.__name__ + ".api.windows")
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(
        batch_size=1, key_capacity=16, **cfg, **ns.cfg))
    env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    w = (env.add_source(ns.sources.ReplaySource(lines))
         .assign_timestamps_and_watermarks(seconds_extractor(ns))
         .map(parse(ns)).key_by(1)
         .window(windows.TumblingEventTimeWindows.of(ns.pkg.Time.seconds(60))))
    tag = ns.pkg.OutputTag("late") if late_tag else None
    if tag is not None:
        w = w.side_output_late_data(tag)
    summed = w.reduce(lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
    out = summed.collect()
    late = summed.get_side_output(tag).collect() if tag is not None else None
    env.execute("metrics")
    return ([repr(t) for t in out.items],
            [repr(t) for t in late.items] if late is not None else None,
            env.metrics.summary())


def both(fn, *args, **cfg):
    """``fn``'s result in the JAX package, in the port, and in the port
    with steps in flight; asserts rows and counters agree."""
    want = fn("jax", *args, **cfg)
    got = fn("torch", *args, **cfg)
    deep = fn("torch", *args, **cfg, **DEEP)
    for g in (got, deep):
        assert g[:-1] == want[:-1]
        assert {k: g[-1][k] for k in COUNTERS} == {
            k: want[-1][k] for k in COUNTERS}
    return got


def test_window_fires_and_late_dropped_without_side_output():
    lines = [
        f"{BASE + 10} www.a.com 100",
        f"{BASE + 10} www.b.com 5",
        f"{BASE + 70} www.a.com 7",    # wm -> BASE+70: [BASE, BASE+60) fires
        f"{BASE + 20} www.a.com 900",  # late: dropped, no side output here
        f"{BASE + 140} www.a.com 3",
    ]
    rows, _, s = both(run_reduce_job, lines)
    assert s["window_fires"] == 4
    assert s["late_dropped"] == 1
    assert s["records_in"] == 5
    assert s["records_emitted"] == len(rows) == 4
    assert s["emit_latency_p99_ms"] > 0.0
    assert s["emit_latency_p99_ms"] >= s["emit_latency_p50_ms"]
    assert all(not r.endswith(",1000)") for r in rows)


def test_late_to_side_output_not_counted_as_dropped():
    lines = [
        f"{BASE + 10} www.a.com 100",
        f"{BASE + 70} www.a.com 7",
        f"{BASE + 20} www.a.com 900",  # late -> side output, not dropped
    ]
    _, late, s = both(run_reduce_job, lines, late_tag=True)
    assert len(late) == 1
    assert s["late_dropped"] == 0


LINES4 = [
    "1563452056 10.8.22.1 cpu0 80.5",
    "1563452050 10.8.22.1 cpu0 78.4",
    "1563452056 10.8.22.1 cpu0 99.9",
    "1563452056 10.8.22.2 cpu1 20.2",
]


def run_median(side, **cfg):
    ns = PKGS[side]
    env = ns.pkg.StreamExecutionEnvironment(
        ns.pkg.StreamConfig(key_capacity=16, **cfg, **ns.cfg))
    text = env.add_source(ns.sources.ReplaySource(
        LINES4 + [ns.sources.AdvanceProcessingTime(61_000)]))

    def median(key, ctx, elements, out):
        vals = sorted(e.f2 for e in elements)
        out.collect(vals[len(vals) // 2] if vals else 0.0)

    def parse3(line):
        p = line.split(" ")
        return ns.pkg.Tuple3(p[1], p[2], float(p[3]))

    h = (text.map(parse3).key_by(0).time_window(ns.pkg.Time.minutes(1))
         .process(median).collect())
    env.execute("median")
    return [repr(t) for t in h.items], env.metrics.summary()


def test_process_window_fires_counted():
    _, s = both(run_median)
    assert s["window_fires"] == 2  # one a key
    assert s["buffer_overflow"] == 0


def test_process_buffer_overflow_counted_not_strict():
    _, s = both(run_median, process_buffer_capacity=2)
    # key 10.8.22.1 had 3 elements, capacity 2: one truncated
    assert s["buffer_overflow"] == 1


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_process_buffer_overflow_strict_raises(side):
    with pytest.raises(RuntimeError, match="strict_overflow.*buffer_overflow"):
        run_median(side, process_buffer_capacity=2, strict_overflow=True)
