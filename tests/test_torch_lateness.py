"""Allowed lateness and the late-data side output through the PyTorch
port, on the CPU: the reference's end-to-end cases
(tests/test_lateness_sideoutput.py: drop by default, per-arrival
refire, side output past the lateness, refire exempt from the fire
budget), each also equal to the JAX package's main and side-output
rows; and side-by-side runs against the JAX package on a seeded
event-time stream with late records and a 20-minute gap, for window
``reduce`` (both ``acc_dtype`` configurations), ``aggregate`` and
``process``, comparing rows, side-output rows, ``print()`` bytes and
counters (tolerance: bitwise)."""

from importlib import import_module

import datetime

import numpy as np
import pytest

import tpustream
import tpustream_torch

BASE = 1_200_000  # epoch seconds, multiple of 60: window [BASE, BASE+60)


def _pkg_parts(pkg):
    out = import_module(pkg.__name__ + ".api.output")
    windows = import_module(pkg.__name__ + ".api.windows")
    sources = import_module(pkg.__name__ + ".runtime.sources")
    return out, windows, sources


def run_job(pkg, lines, lateness_s=0, tag=False, **cfg):
    """tests/test_lateness_sideoutput.py's job in ``pkg``: (main rows,
    side-output rows or None, late_dropped)."""
    out_mod, windows, sources = _pkg_parts(pkg)
    if pkg is tpustream_torch:
        cfg["device"] = "cpu"

    class SecondsExtractor(pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(pkg.Time.seconds(0))

        def extract_timestamp(self, line):
            return int(line.split(" ")[0]) * 1000

    def parse(line):
        p = line.split(" ")
        return pkg.Tuple3(int(p[0]), p[1], int(p[2]))

    env = pkg.StreamExecutionEnvironment(
        pkg.StreamConfig(batch_size=1, key_capacity=16, **cfg))
    env.set_stream_time_characteristic(pkg.TimeCharacteristic.EventTime)
    w = (
        env.add_source(sources.ReplaySource(lines))
        .assign_timestamps_and_watermarks(SecondsExtractor())
        .map(parse)
        .key_by(1)
        .window(windows.TumblingEventTimeWindows.of(pkg.Time.seconds(60)))
    )
    if lateness_s:
        w = w.allowed_lateness(pkg.Time.seconds(lateness_s))
    late_tag = out_mod.OutputTag("late-data") if tag else None
    if late_tag is not None:
        w = w.side_output_late_data(late_tag)
    summed = w.reduce(lambda a, b: pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
    main = summed.map(lambda t: pkg.Tuple2(t.f1, t.f2)).collect()
    late = summed.get_side_output(late_tag).collect() if tag else None
    env.execute("lateness")
    rows = [(t.f0, t.f1) for t in main.items]
    late_rows = None if late is None else [(t.f0, t.f1, t.f2) for t in late.items]
    return rows, late_rows, env.metrics.late_dropped


def both(lines, **kw):
    got = run_job(tpustream_torch, lines, **kw)
    assert got == run_job(tpustream, lines, **kw)
    return got


def test_late_record_dropped_by_default():
    lines = [
        f"{BASE + 10} www.a.com 100",
        f"{BASE + 70} www.a.com 7",    # wm -> BASE+70s: first window fires
        f"{BASE + 20} www.a.com 900",  # late for the fired window: dropped
        f"{BASE + 140} www.a.com 5",   # close stream-side windows
    ]
    rows, _, dropped = both(lines)
    assert ("www.a.com", 100) in rows          # fired without the late 900
    assert ("www.a.com", 1000) not in rows
    assert dropped == 1


def test_allowed_lateness_refires_with_updated_sum():
    lines = [
        f"{BASE + 10} www.a.com 100",
        f"{BASE + 70} www.a.com 7",    # fires [BASE, BASE+60) with sum 100
        f"{BASE + 20} www.a.com 900",  # within 5 min lateness: REFIRE
        f"{BASE + 400} www.a.com 5",
    ]
    rows, _, dropped = both(lines, lateness_s=300)
    assert ("www.a.com", 100) in rows           # the on-time firing
    assert ("www.a.com", 1000) in rows          # the per-arrival re-firing
    assert dropped == 0


def test_beyond_lateness_goes_to_side_output():
    lines = [
        f"{BASE + 10} www.a.com 100",
        f"{BASE + 70} www.a.com 7",
        f"{BASE + 20} www.a.com 900",  # beyond lateness 0: side output
        f"{BASE + 140} www.a.com 5",
    ]
    rows, late_rows, dropped = both(lines, lateness_s=0, tag=True)
    assert ("www.a.com", 100) in rows
    assert ("www.a.com", 1000) not in rows
    assert late_rows == [(BASE + 20, "www.a.com", 900)]
    assert dropped == 0  # delivered to the side output, not dropped


def test_allowed_lateness_refire_with_fire_budget():
    # the refire path is budget-exempt: max_fires_per_step=1 must not
    # swallow the re-firing
    lines = [
        f"{BASE + 10} www.a.com 100",
        f"{BASE + 70} www.a.com 7",
        f"{BASE + 20} www.a.com 900",
        f"{BASE + 400} www.a.com 5",
    ]
    rows, _, _ = both(lines, lateness_s=300, max_fires_per_step=1)
    assert ("www.a.com", 100) in rows
    assert ("www.a.com", 1000) in rows


# -- side by side on a seeded stream --------------------------------------

def late_lines(n, seed):
    """ISO lines over ~30 min: 12 channels, records up to 150 s behind
    the stream's front (past the 10 s out-of-orderness plus 20 s of
    allowed lateness for about two in five), a 20-minute gap at 2/3 (the
    jump sweep), and flows of 1e9 bytes on two channels."""
    rng = np.random.default_rng(seed)
    t0 = 1_566_957_600  # 2019-08-28T10:00:00+08:00
    step = rng.integers(0, 3, n).cumsum()
    step[2 * n // 3:] += 1200
    ts = t0 + step - np.where(rng.random(n) < 0.5, rng.integers(0, 151, n), 0)
    ch = rng.integers(0, 12, n)
    flow = np.where(ch >= 10, 10**9, rng.integers(1, 20_000, n))
    tz = datetime.timezone(datetime.timedelta(hours=8))
    iso = [datetime.datetime.fromtimestamp(int(s), tz).strftime("%Y-%m-%dT%H:%M:%S")
           for s in ts]
    return [f"{i} www.c{c}.com {f}" for i, c, f in zip(iso, ch, flow)]


class SumCount:
    """(count, sum) of the flow; the result is both, the sum doubled."""

    def create_accumulator(self):
        return (0, 0)

    def add(self, value, acc):
        return (acc[0] + 1, acc[1] + value.f2)

    def get_result(self, acc):
        return (acc[0], acc[1] * 2)

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])


def _late_job(pkg, env, text, apply):
    """The seeded stream keyed by channel: sliding windows of 60 s every
    20 s, 10 s of out-of-orderness, 20 s of allowed lateness, the rest to
    a side output (the stream's records come up to 90 s late)."""
    et = import_module(pkg.__name__ + ".jobs.chapter3_bandwidth_eventtime")
    out_mod, _, _ = _pkg_parts(pkg)
    tag = out_mod.OutputTag("late")
    w = (text.assign_timestamps_and_watermarks(
            et.IsoTimestampExtractor(pkg.Time.seconds(10)))
         .map(et.parse).key_by(1)
         .time_window(pkg.Time.seconds(60), pkg.Time.seconds(20))
         .allowed_lateness(pkg.Time.seconds(20))
         .side_output_late_data(tag))
    if apply == "reduce":
        main = w.reduce(lambda a, b: pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
    elif apply == "aggregate":
        main = w.aggregate(SumCount())
    else:
        class Total:
            def process(self, key, context, elements, out):
                out.collect(pkg.Tuple3(key, context.end, sum(e.f2 for e in elements)))

        main = w.process(Total())
    return main, main.get_side_output(tag)


def _side(pkg, lines, apply, capsys, **cfg):
    _, _, sources = _pkg_parts(pkg)
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    env.set_stream_time_characteristic(pkg.TimeCharacteristic.EventTime)
    main, late = _late_job(pkg, env, env.add_source(sources.ReplaySource(lines)), apply)
    # a side output keeps one sink per tag in both packages (the last
    # one added), so the late rows are collected and only the main
    # stream is printed
    h_main, h_late = main.collect(), late.collect()
    main.print()
    capsys.readouterr()
    env.execute("late")
    m = env.metrics.summary()
    counters = {k: m[k] for k in ("window_fires", "late_dropped", "alert_overflow",
                                  "evicted_unfired", "records_emitted")}
    return ([repr(t) for t in h_main.items], [repr(t) for t in h_late.items],
            capsys.readouterr().out, counters)


APPLY = {
    "reduce": {},
    "reduce_int32": {"acc_dtype": "int32", "max_fires_per_step": 4},
    "aggregate": {},
    "process": {},
}


@pytest.mark.parametrize("batch_size", [1, 3, 64])
@pytest.mark.parametrize("apply", sorted(APPLY))
def test_side_by_side_with_jax_package(apply, batch_size, capsys):
    lines = late_lines(500, seed=20 + batch_size)
    cfg = dict(APPLY[apply], batch_size=batch_size, key_capacity=16)
    kind = apply.split("_")[0]
    want = _side(tpustream, lines, kind, capsys, **cfg)
    got = _side(tpustream_torch, lines, kind, capsys, device="cpu", **cfg)
    assert len(got[0]) > 20 and len(got[1]) > 0
    assert got[0] == want[0]
    assert got[1] == want[1]  # the side output's rows
    assert got[2] == want[2]  # print() bytes
    assert got[3] == want[3]
