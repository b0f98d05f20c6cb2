"""Time cases through the PyTorch port, on the CPU, against the JAX
package on the same input: ingestion time (tests/test_ingestion_time.py)
at batch sizes 1, 2 and 4, the full-window ``process()`` under a
processing-time jump (tests/test_eventtime_jump.py), and a punctuated
watermark assigner, whose per-batch watermark makes later records late.
Also: the port's ``Metrics.summary()`` carries every key of the
reference's. Tolerance: identical rows and counters."""

import pytest

import tpustream.api.watermarks as jax_watermarks
import tpustream.jobs.chapter2_avg as jax_avg
import tpustream.jobs.chapter2_median as jax_median
import tpustream_torch.api.watermarks as torch_watermarks
import tpustream_torch.jobs.chapter2_avg as torch_avg
import tpustream_torch.jobs.chapter2_median as torch_median
from tests.test_torch_chains import PKGS

JOBS = {"jax": (jax_avg, jax_median, jax_watermarks),
        "torch": (torch_avg, torch_median, torch_watermarks)}

COUNTERS = ("window_fires", "late_dropped", "evicted_unfired", "records_in",
            "records_emitted")


def run(side, build, source_of, time_char, **cfg):
    ns = PKGS[side]
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(**cfg, **ns.cfg))
    env.set_stream_time_characteristic(getattr(ns.pkg.TimeCharacteristic, time_char))
    handle = build(side, ns, env.add_source(source_of(ns))).collect()
    env.execute("time-case")
    s = env.metrics.summary()
    return [repr(t) for t in handle.items], {k: s[k] for k in COUNTERS}


def both(*a, **kw):
    want = run("jax", *a, **kw)
    got = run("torch", *a, **kw)
    assert got == want
    return got


def ingestion_avg(side, ns, text):
    avg = JOBS[side][0]
    return (text.map(avg.parse).key_by(0).time_window(ns.pkg.Time.minutes(1))
            .aggregate(avg.AvgAggregate()))


INGESTION = {
    "bucket by arrival": [
        "1563452000 10.8.22.1 cpu0 10.0",
        "1563452000 10.8.22.1 cpu0 20.0",
        61_000,
        "1563452000 10.8.22.1 cpu0 99.0",
    ],
    "two keys": [
        "1 10.8.22.1 cpu0 30.0",
        "1 10.8.22.2 cpu1 20.2",
        "1 10.8.22.1 cpu0 50.0",
        61_000,
        "1 10.8.22.1 cpu0 7.0",
    ],
}


@pytest.mark.parametrize("batch_size", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(INGESTION))
def test_ingestion_time_windows(case, batch_size):
    def source_of(ns):
        return ns.sources.ReplaySource([
            ns.sources.AdvanceProcessingTime(i) if isinstance(i, int) else i
            for i in INGESTION[case]])

    rows, counters = both(ingestion_avg, source_of, "IngestionTime",
                          batch_size=batch_size, key_capacity=16)
    if case == "bucket by arrival":
        assert rows == ["15.0", "99.0"] and counters["window_fires"] == 2
    else:
        assert sorted(rows) == ["20.2", "40.0", "7.0"]
    assert counters["late_dropped"] == 0


def test_jump_full_window_process_drops_loudly():
    # the median (full-window process()) cannot sweep a jump: the records
    # it cannot cover are dropped and counted, never aliased
    lines = ["1565000000 10.8.22.1 cpu0 10.0", "1565000001 10.8.22.1 cpu0 20.0",
             "1564996400 10.8.22.1 cpu0 99.0"]

    def build(side, ns, text):
        return JOBS[side][1].build(None, text)

    def source_of(ns):
        return ns.sources.ReplaySource(lines, start_ms=1565000000_000,
                                       ms_per_record=3_600_000)

    rows, counters = both(build, source_of, "IngestionTime", batch_size=1,
                          key_capacity=8)
    assert all(float(r.rsplit(",", 1)[-1].rstrip(")")) in (10.0, 15.0, 20.0, 99.0)
               for r in rows)
    assert counters["evicted_unfired"] == 2


PUNCT_LINES = [
    "1000 a 1 -", "2000 b 2 -", "3000 a 4 wm", "4000 a 8 -",
    "2500 b 16 -", "15000 a 32 -", "11000 b 64 wm", "9000 a 128 -",
    "12000 b 256 -", "31000 a 512 -", "20000 b 1024 -",
]


def punctuated(side, ns, text):
    wm = JOBS[side][2]

    class Punct(wm.AssignerWithPunctuatedWatermarks):
        """A line marked ``wm`` moves the watermark 9 s past its own
        timestamp, ahead of the data."""

        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

        def check_and_get_next_watermark(self, element, extracted_timestamp):
            if element.split(" ")[3] == "wm":
                return wm.Watermark(extracted_timestamp + 9_000)
            return None

    return (text.assign_timestamps_and_watermarks(Punct())
            .map(lambda l: ns.pkg.Tuple2(l.split(" ")[1], int(l.split(" ")[2])))
            .key_by(0).time_window(ns.pkg.Time.seconds(10))
            .reduce(lambda a, b: ns.pkg.Tuple2(a.f0, a.f1 + b.f1)))


@pytest.mark.parametrize("batch_size", [1, 3, 64])
def test_punctuated_watermarks(batch_size):
    rows, counters = both(punctuated, lambda ns: ns.sources.ReplaySource(PUNCT_LINES),
                          "EventTime", batch_size=batch_size, key_capacity=16)
    assert rows
    if batch_size == 1:
        # the first mark (12 s) fires [0, 10 s) before 2500/b arrives, so
        # it is late; the second (20 s) makes 12000/b late for [10, 20 s)
        assert counters["late_dropped"] >= 1


def test_metrics_summary_has_every_reference_key():
    from tpustream.runtime.metrics import Metrics as JaxMetrics
    from tpustream_torch.runtime.metrics import Metrics

    ref = set(JaxMetrics().summary())
    port = Metrics().summary()
    assert ref <= set(port)
    for k in ("records_quarantined", "exchange_overflow", "cep_matches",
              "cep_timeouts", "emit_latency_p50_ms", "emit_latency_p99_ms"):
        assert port[k] == 0
    assert "exchange_overflow" in Metrics().overflow_counts()


def test_emit_latency_is_recorded_like_the_reference():
    # one sample a step that emitted: the rolling job emits on every step
    lines = [f"1 k{i % 3} {i}" for i in range(12)]

    def build(side, ns, text):
        return text.map(lambda l: ns.pkg.Tuple2(l.split(" ")[1], int(l.split(" ")[2]))) \
            .key_by(0).sum(1)

    for side in ("jax", "torch"):
        ns = PKGS[side]
        env = ns.pkg.StreamExecutionEnvironment(
            ns.pkg.StreamConfig(batch_size=4, **ns.cfg))
        build(side, ns, env.add_source(ns.sources.ReplaySource(lines))).collect()
        env.execute("latency")
        s = env.metrics.summary()
        assert len(env.metrics.emit_latencies_s) == 3, side
        assert 0 < s["emit_latency_p50_ms"] <= s["emit_latency_p99_ms"]
