"""Chained keyed stages (a ``key_by`` after a keyed operator), stream
fan-out and a computed key on a chain stage through the PyTorch port,
on the CPU, against the JAX package: the single-device cases of
tests/test_chained_stages.py, tests/test_branching.py and
tests/test_key_selector.py's chain-stage case, each run through both
packages on the same input. Tolerance: identical rows (and the suites'
golden rows), identical error messages."""

import types

import pytest

import tpustream
import tpustream.api.windows as jax_windows
import tpustream.runtime.sources as jax_sources
import tpustream_torch
import tpustream_torch.api.windows as torch_windows
import tpustream_torch.runtime.sources as torch_sources

PKGS = {
    "jax": types.SimpleNamespace(pkg=tpustream, sources=jax_sources,
                                 windows=jax_windows, cfg={}),
    "torch": types.SimpleNamespace(pkg=tpustream_torch, sources=torch_sources,
                                   windows=torch_windows, cfg={"device": "cpu"}),
}


def run_job(side, build, items, event_time=True, raw_batch=None, **cfg):
    """``build(ns, text)``'s stream through one package (``side`` is
    ``"jax"`` or ``"torch"``): ``(repr of each collected row, summary)``.
    ``raw_batch``: feed the lines as raw byte buffers of that many."""
    ns = PKGS[side]
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(**cfg, **ns.cfg))
    if event_time:
        env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    if raw_batch is None:
        src = ns.sources.ReplaySource(items)
    else:
        src = ns.sources.ReplayBytesSource([
            ("\n".join(items[i:i + raw_batch]).encode(),
             len(items[i:i + raw_batch]))
            for i in range(0, len(items), raw_batch)])
    handle = build(ns, env.add_source(src)).collect()
    env.execute("side-by-side")
    return [repr(t) for t in handle.items], env.metrics.summary()


def both(build, items, **kw):
    """The rows of both packages; asserts they are equal."""
    want, _ = run_job("jax", build, items, **kw)
    got, _ = run_job("torch", build, items, **kw)
    assert got == want
    return got


# -- tests/test_chained_stages.py -----------------------------------------

LINES = [
    "1000 a x 5",
    "2000 b y 7",
    "5000 a x 3",
    "12000 a y 4",
    "25000 b x 9",
]


def ts_assigner(ns, delay_ms=1000):
    class Ts(ns.pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(ns.pkg.Time.milliseconds(delay_ms))

        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

    return Ts()


def parse3(ns):
    def parse(line):
        items = line.split(" ")
        return ns.pkg.Tuple3(items[1], items[2], int(items[3]))
    return parse


def add3(ns):
    return lambda p, q: ns.pkg.Tuple3(p.f0, p.f1, p.f2 + q.f2)


def stage1(ns, text, slide=None):
    w = (text.assign_timestamps_and_watermarks(ts_assigner(ns))
         .map(parse3(ns)).key_by(0))
    w = (w.time_window(ns.pkg.Time.seconds(10)) if slide is None
         else w.time_window(ns.pkg.Time.seconds(10), ns.pkg.Time.seconds(slide)))
    return w.reduce(add3(ns))


@pytest.mark.parametrize("kind,golden", [
    ("max", ["(a,x,8)", "(b,y,7)", "(b,y,7)", "(a,x,9)"]),
    ("sum", ["(a,x,8)", "(b,y,7)", "(b,y,11)", "(a,x,17)"]),
    ("min", ["(a,x,8)", "(b,y,7)", "(b,y,4)", "(a,x,8)"]),
])
def test_chain_window_then_rekeyed_int_rolling(kind, golden):
    rows = both(lambda ns, t: getattr(stage1(ns, t).key_by(1), kind)(2),
                LINES, batch_size=2, key_capacity=16)
    assert rows == golden


def test_chain_window_then_processing_time_window():
    def build(ns, text):
        return (stage1(ns, text).key_by(1)
                .window(ns.windows.TumblingProcessingTimeWindows.of(
                    ns.pkg.Time.minutes(5)))
                .reduce(add3(ns)))

    rows = both(build, LINES, batch_size=2, key_capacity=16)
    assert sorted(rows) == ["(a,x,17)", "(b,y,11)"]


def event_time_two_stage(ns, text):
    return (stage1(ns, text).key_by(1).time_window(ns.pkg.Time.seconds(30))
            .reduce(add3(ns)))


@pytest.mark.parametrize("batch_size", [1, 2, 4, 8])
def test_chain_event_time_windows(batch_size):
    rows = both(event_time_two_stage, LINES, batch_size=batch_size,
                key_capacity=16)
    assert sorted(rows) == ["(a,x,17)", "(b,y,11)"]


def test_chain_metrics_count_both_stages():
    _, js = run_job("jax", event_time_two_stage, LINES, batch_size=2,
                    key_capacity=16)
    _, ts = run_job("torch", event_time_two_stage, LINES, batch_size=2,
                    key_capacity=16)
    for k in ("records_in", "records_emitted", "window_fires", "late_dropped"):
        assert ts[k] == js[k], k


def median_process(ns):
    def fn(key, ctx, elements, out):
        vals = sorted(e.f2 for e in elements)
        mid = len(vals) // 2
        med = (float(vals[mid]) if len(vals) % 2
               else (vals[mid - 1] + vals[mid]) / 2)
        out.collect(ns.pkg.Tuple2(key, med))
    return fn


def alternating(ns):
    def fn(key, ctx, elements, out):
        n = len(list(elements))
        out.collect(ns.pkg.Tuple2(key, n if n % 2 else n + 0.5))
    return fn


def test_chain_after_process_stage():
    def build(ns, text):
        return (text.assign_timestamps_and_watermarks(ts_assigner(ns))
                .map(parse3(ns)).key_by(0)
                .time_window(ns.pkg.Time.seconds(10))
                .process(median_process(ns))
                .key_by(0).time_window(ns.pkg.Time.seconds(30))
                .reduce(lambda p, q: ns.pkg.Tuple2(p.f0, p.f1 + q.f1)))

    rows = both(build, LINES, batch_size=2, key_capacity=16)
    assert sorted(rows) == ["(a,8.0)", "(b,16.0)"]


def process_then_pt_window(fn, ns, text):
    return (text.assign_timestamps_and_watermarks(ts_assigner(ns))
            .map(parse3(ns)).key_by(0)
            .time_window(ns.pkg.Time.seconds(10))
            .process(fn(ns))
            .key_by(0)
            .window(ns.windows.TumblingProcessingTimeWindows.of(
                ns.pkg.Time.minutes(5)))
            .reduce(lambda p, q: ns.pkg.Tuple2(p.f0, p.f1 + q.f1)))


def test_chain_after_process_mixed_rows_widen():
    rows = both(lambda ns, t: process_then_pt_window(alternating, ns, t),
                LINES, batch_size=2, key_capacity=16)
    assert sorted(rows) == ["(a,3.5)", "(b,2.0)"]


LATE_LINES = [
    "1000 a x 5",
    "12000 a x 3",     # fires [0,10s): count 1, the schema freezes
    "13000 a x 7",
    "26000 a x 9",     # fires [10,20s): count 2, a later emission
    "40000 a x 1",
]


def emitting(emit):
    def fn_of(ns):
        def fn(key, ctx, elements, out):
            out.collect(ns.pkg.Tuple2(key, emit(len(list(elements)))))
        return fn
    return fn_of


@pytest.mark.parametrize("name,emit,match", [
    ("float after int", lambda n: n if n % 2 else n + 0.5, "fractional"),
    ("str after int", lambda n: n if n == 1 else "oops", "non-numeric"),
    ("int after bool", lambda n: True if n == 1 else 5, "non-bool"),
    ("str after float", lambda n: 1.5 if n == 1 else "oops", "non-numeric"),
])
def test_chain_after_process_late_type_change_fails_loudly(name, emit, match):
    errors = []
    for side in ("jax", "torch"):
        with pytest.raises(ValueError, match=match) as e:
            run_job(side, lambda ns, t: process_then_pt_window(emitting(emit), ns, t),
                    LATE_LINES, batch_size=1, key_capacity=16)
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_chain_sliding_window_fed():
    rows = both(lambda ns, t: (stage1(ns, t, slide=5).key_by(1)
                               .time_window(ns.pkg.Time.seconds(30))
                               .reduce(add3(ns))),
                LINES, batch_size=2, key_capacity=16)
    assert sorted(rows) == ["(a,x,29)", "(b,x,9)", "(b,y,18)"]


def test_chain_session_fed():
    lines = ["1000 a 1", "2000 b 2", "3000 a 4", "9000 b 8",
             "20000 a 16", "22000 b 32", "23000 a 64",
             "40000 c 100", "55000 c 200"]

    def build(ns, text):
        add = lambda a, b: ns.pkg.Tuple2(a.f0, a.f1 + b.f1)  # noqa: E731
        return (text.assign_timestamps_and_watermarks(ts_assigner(ns))
                .map(lambda l: ns.pkg.Tuple2(l.split(" ")[1], int(l.split(" ")[2])))
                .key_by(0)
                .window(ns.windows.EventTimeSessionWindows.with_gap(
                    ns.pkg.Time.seconds(4)))
                .reduce(add)
                .key_by(0).time_window(ns.pkg.Time.seconds(30)).reduce(add))

    rows = both(build, lines, batch_size=4, key_capacity=16, alert_capacity=1024)
    assert sorted(rows) == ["(a,85)", "(b,42)", "(c,300)"]


@pytest.mark.parametrize("batch_size", [4, 32])
def test_chain_equal_ts_fires_split_across_subbatches(batch_size):
    lines = [f"{1000 + i * 900} k{i % 7} {i + 1}" for i in range(24)] + ["60000 kx 100"]

    def build(ns, text):
        add = lambda a, b: ns.pkg.Tuple2(a.f0, a.f1 + b.f1)  # noqa: E731
        return (text.assign_timestamps_and_watermarks(ts_assigner(ns))
                .map(lambda l: ns.pkg.Tuple2(l.split(" ")[1], int(l.split(" ")[2])))
                .key_by(0).time_window(ns.pkg.Time.seconds(4)).reduce(add)
                .key_by(0).time_window(ns.pkg.Time.seconds(12)).reduce(add))

    want, js = run_job("jax", build, lines, batch_size=batch_size, key_capacity=16)
    got, ts = run_job("torch", build, lines, batch_size=batch_size, key_capacity=16)
    assert got == want and ts["late_dropped"] == js["late_dropped"] == 0


def test_count_window_cannot_feed_an_event_time_stage():
    # GlobalWindow results carry no event timestamp (Flink): both
    # packages refuse by name
    def build(ns, text):
        return (text.assign_timestamps_and_watermarks(ts_assigner(ns))
                .map(parse3(ns)).key_by(0).count_window(2).reduce(add3(ns))
                .key_by(1).time_window(ns.pkg.Time.seconds(30)).reduce(add3(ns)))

    errors = []
    for side in ("jax", "torch"):
        with pytest.raises(NotImplementedError, match="GlobalWindow") as e:
            run_job(side, build, LINES, batch_size=2, key_capacity=16)
        errors.append(str(e.value))
    assert errors[1] == errors[0]


# -- tests/test_branching.py ------------------------------------------------

BRANCH_LINES = [
    "1 10.8.22.1 cpu0 95.5",
    "2 10.8.22.2 cpu1 50.0",
    "3 10.8.22.1 cpu0 99.9",
    "4 10.8.22.3 cpu2 91.0",
    "5 10.8.22.2 cpu1 10.0",
]


def parse_usage(ns):
    def parse(value):
        items = value.split(" ")
        return ns.pkg.Tuple3(items[1], items[2], float(items[3]))
    return parse


def branches(side, build, event_time=False, **cfg):
    """The rows of each collect sink of ``build(ns, text)`` (a list of
    streams) in one package."""
    ns = PKGS[side]
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(**cfg, **ns.cfg))
    if event_time:
        env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    handles = [s.collect() for s in
               build(ns, env.add_source(ns.sources.ReplaySource(BRANCH_LINES)))]
    env.execute("fanout")
    return [[repr(t) for t in h.items] for h in handles]


def test_branch_two_filters_one_stateless_stream():
    def build(ns, text):
        parsed = text.map(parse_usage(ns))
        return [parsed.filter(lambda t: t.f2 > 99),
                parsed.filter(lambda t: t.f2 > 90).map(
                    lambda t: ns.pkg.Tuple2(t.f0, t.f2))]

    got = branches("torch", build, batch_size=2)
    assert got == branches("jax", build, batch_size=2)
    assert got == [["(10.8.22.1,cpu0,99.9)"],
                   ["(10.8.22.1,95.5)", "(10.8.22.1,99.9)", "(10.8.22.3,91.0)"]]


def test_branch_after_windowed_aggregate():
    def build(ns, text):
        class Ts(ns.pkg.BoundedOutOfOrdernessTimestampExtractor):
            def __init__(self):
                super().__init__(ns.pkg.Time.milliseconds(1000))

            def extract_timestamp(self, value):
                return int(value.split(" ")[0]) * 10_000

        summed = (text.assign_timestamps_and_watermarks(Ts())
                  .map(parse_usage(ns)).key_by(0)
                  .time_window(ns.pkg.Time.seconds(10)).reduce(add3(ns)))
        return [summed, summed.filter(lambda t: t.f2 > 90)]

    kw = dict(event_time=True, batch_size=2, key_capacity=16)
    got = branches("torch", build, **kw)
    assert got == branches("jax", build, **kw)
    assert sorted(got[1]) == ["(10.8.22.1,cpu0,95.5)", "(10.8.22.1,cpu0,99.9)",
                              "(10.8.22.3,cpu2,91.0)"]
    assert len(got[0]) == 5


def test_branch_point_cannot_split_keyed_work():
    def build(ns, text):
        parsed = text.map(parse_usage(ns))
        return [parsed, parsed.key_by(0).max(2)]

    for side in ("jax", "torch"):
        with pytest.raises(NotImplementedError, match="branch"):
            branches(side, build, batch_size=2)


# -- tests/test_key_selector.py: a computed key on a chain stage ---------

def test_computed_key_selector_on_chain_stage():
    lines = ["a 1", "bb 10", "c 2", "dd 20", "e 4", "ff 40", "a 8"]

    def build(ns, text):
        add = lambda a, b: ns.pkg.Tuple2(a.f0, a.f1 + b.f1)  # noqa: E731
        return (text.map(lambda l: ns.pkg.Tuple2(l.split(" ")[0], float(l.split(" ")[1])))
                .key_by(0).reduce(add)
                .key_by(lambda r: len(r.f0)).reduce(add))

    rows = both(build, lines, event_time=False, batch_size=2, key_capacity=16)
    # the suite's record-at-a-time oracle of the two rolling stages
    s1, s2, expect = {}, {}, []
    for ln in lines:
        k, v = ln.split(" ")[0], float(ln.split(" ")[1])
        s1[k] = s1.get(k, 0.0) + v
        g = len(k)
        k0, v0 = s2.get(g, (k, 0.0))
        s2[g] = (k0, v0 + s1[k])
        expect.append(f"({s2[g][0]},{s2[g][1]})")
    assert rows == expect
