"""The chained builders of tests/test_config_equivalence.py through the
PyTorch port, on the CPU, against the JAX package: the re-key hand-off
of a window, rolling, session, ``process()`` and count-window stage,
and a computed key on the chain stage, over the suite's randomized
event-time stream (its seeds and sizes), at batch sizes 1, 16 and 64.
Tolerance: identical rows in identical order, with ``strict_overflow``
(no loss) on both sides."""

import pytest

from tests.test_config_equivalence import _stream
from tests.test_torch_chains import run_job
from tests.test_torch_config_fuzz import parse, ts_extractor


def add(ns):
    return lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2)


def stage1(ns, text):
    return text.assign_timestamps_and_watermarks(ts_extractor(ns)).map(parse(ns)).key_by(1)


def window_window(ns, text):
    return (stage1(ns, text).time_window(ns.pkg.Time.seconds(10)).reduce(add(ns))
            .key_by(1).time_window(ns.pkg.Time.seconds(20)).reduce(add(ns)))


def rolling_window(ns, text):
    return (stage1(ns, text).max(2)
            .key_by(1).time_window(ns.pkg.Time.seconds(8)).reduce(add(ns)))


def session_window(ns, text):
    return (stage1(ns, text)
            .window(ns.windows.EventTimeSessionWindows.with_gap(ns.pkg.Time.seconds(4)))
            .reduce(add(ns))
            .key_by(1).time_window(ns.pkg.Time.seconds(20)).reduce(add(ns)))


def process_window(ns, text):
    def median(key, ctx, elements, out):
        vals = sorted(e.f2 for e in elements)
        mid = len(vals) // 2
        med = float(vals[mid]) if len(vals) % 2 else (vals[mid - 1] + vals[mid]) / 2
        out.collect(ns.pkg.Tuple2(key, med))

    return (stage1(ns, text).time_window(ns.pkg.Time.seconds(10)).process(median)
            .key_by(0).time_window(ns.pkg.Time.seconds(30))
            .reduce(lambda p, q: type(p)(p.f0, p.f1 + q.f1)))


def count_window(ns, text):
    return (stage1(ns, text).count_window(3).reduce(add(ns))
            .key_by(1)
            .window(ns.windows.TumblingProcessingTimeWindows.of(ns.pkg.Time.minutes(5)))
            .reduce(add(ns)))


def computed_key(ns, text):
    return (stage1(ns, text).time_window(ns.pkg.Time.seconds(10)).reduce(add(ns))
            .key_by(lambda r: int(r.f1[1:]) % 3)
            .time_window(ns.pkg.Time.seconds(20)).reduce(add(ns)))


BUILDERS = {
    "window_window": (11, window_window),
    "rolling_window": (12, rolling_window),
    "session_window": (13, session_window),
    "process_window": (14, process_window),
    "count_window": (15, count_window),
    "computed_key": (16, computed_key),
}


@pytest.mark.parametrize("batch_size", [1, 16, 64])
@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_chained_builder_matches_jax(builder, batch_size):
    seed, build = BUILDERS[builder]
    lines = _stream(seed, n=110 if builder in ("session_window", "process_window")
                    else 180)
    cfg = dict(batch_size=batch_size, alert_capacity=2048, strict_overflow=True)
    want, js = run_job("jax", build, lines, **cfg)
    got, ts = run_job("torch", build, lines, **cfg)
    assert len(want) > (6 if builder == "count_window" else 10)
    assert got == want
    assert ts["late_dropped"] == js["late_dropped"]
