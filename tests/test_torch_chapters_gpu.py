"""The chapter-1 and chapter-2 jobs, the general rolling path and
allowed lateness with the late side output, on the card against the same
runs on the CPU (tolerance: bitwise). Every test here needs a CUDA device
and skips without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chapters_gpu.py -q
"""

import datetime

import numpy as np
import pytest
import torch

import tpustream_torch as T
from tpustream_torch.api.windows import SlidingEventTimeWindows
from tpustream_torch.jobs import (
    chapter1_threshold,
    chapter2_avg,
    chapter2_max,
    chapter2_median,
    chapter3_bandwidth_eventtime,
)
from tpustream_torch.records import StringTable
from tpustream_torch.runtime.plan import build_plan
from tpustream_torch.runtime.sources import AdvanceProcessingTime, ReplaySource
from tpustream_torch.runtime.step import build_program

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this checks the card's run")
    return "cuda"


def host_lines(n, n_hosts, seed):
    """``ts host cpuN usage`` lines, usage in hundredths, about one in
    ten above 90."""
    rng = np.random.default_rng(seed)
    hosts = rng.integers(0, n_hosts, n)
    usage = np.where(rng.random(n) < 0.1, rng.integers(9001, 10000, n),
                     rng.integers(0, 9000, n)) / 100
    return [f"{1563452000 + i} 10.8.0.{h} cpu{i % 4} {u}"
            for i, (h, u) in enumerate(zip(hosts, usage))]


def with_ticks(lines):
    """A processing-time tick every 97 lines and a last one past the end
    (``ms_per_record=400``: a 1-minute window holds about 150 lines)."""
    items = []
    for i, line in enumerate(lines):
        items.append(line)
        if i % 97 == 96:
            items.append(AdvanceProcessingTime(i * 400 + 30_000))
    return items + [AdvanceProcessingTime(len(lines) * 400 + 120_000)]


def _run(build, items, device, **cfg):
    env = T.StreamExecutionEnvironment(T.StreamConfig(device=device, **cfg))
    stream = build(env, env.add_source(ReplaySource(items, ms_per_record=400)))
    h = stream.collect()
    env.execute("job")
    m = env.metrics.summary()
    counters = {k: m[k] for k in ("window_fires", "late_dropped", "alert_overflow",
                                  "buffer_overflow", "evicted_unfired",
                                  "records_emitted")}
    return [repr(t) for t in h.items], counters


JOBS = {
    "ch1": (chapter1_threshold.build, False),
    "avg": (chapter2_avg.build, True),
    "median": (chapter2_median.build, True),
}


@pytest.mark.parametrize("batch_size", [1, 3, 64])
@pytest.mark.parametrize("job", sorted(JOBS))
def test_job_card_equals_cpu(card, job, batch_size):
    build, ticks = JOBS[job]
    lines = host_lines(400, 9, seed=batch_size)
    items = with_ticks(lines) if ticks else lines
    got = _run(build, items, card, batch_size=batch_size)
    want = _run(build, items, "cpu", batch_size=batch_size)
    assert len(got[0]) > 20 and got == want


def _general(kind):
    def build(env, text):
        s = text.map(chapter2_max.parse).key_by(0)
        if kind == "reduce":
            return s.reduce(lambda a, b: T.Tuple3(a.f0, b.f1, a.f2 + b.f2))
        return getattr(s, kind)(2)

    return build


@pytest.mark.parametrize("kind", ["max_by", "min_by", "reduce"])
def test_general_rolling_card_equals_cpu(card, kind):
    lines = host_lines(300, 12, seed=7)
    got = _run(_general(kind), lines, card, batch_size=64)
    want = _run(_general(kind), lines, "cpu", batch_size=64)
    assert len(got[0]) == 300 and got == want


class SumCount:
    def create_accumulator(self):
        return (0, 0)

    def add(self, value, acc):
        return (acc[0] + 1, acc[1] + value.f2)

    def get_result(self, acc):
        return (acc[0], acc[1] * 2)

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])


class Total:
    def process(self, key, context, elements, out):
        out.collect(T.Tuple3(key, context.end, sum(e.f2 for e in elements)))


def late_lines(n, seed):
    """ISO ``ts channel flow`` lines over ~30 min, half of them up to
    150 s behind the front (many past 10 s of out-of-orderness plus 20 s
    of allowed lateness), and a 20-minute gap at 2/3."""
    rng = np.random.default_rng(seed)
    step = rng.integers(0, 3, n).cumsum()
    step[2 * n // 3:] += 1200
    ts = 1_566_957_600 + step - np.where(rng.random(n) < 0.5, rng.integers(0, 151, n), 0)
    ch = rng.integers(0, 12, n)
    tz = datetime.timezone(datetime.timedelta(hours=8))
    return [f"{datetime.datetime.fromtimestamp(int(s), tz).strftime('%Y-%m-%dT%H:%M:%S')}"
            f" www.c{c}.com {f}"
            for s, c, f in zip(ts, ch, rng.integers(1, 20_000, n))]


@pytest.mark.parametrize("apply", ["reduce", "aggregate", "process"])
def test_lateness_side_output_card_equals_cpu(card, apply):
    et = chapter3_bandwidth_eventtime
    lines = late_lines(400, seed=3)

    def run(device):
        env = T.StreamExecutionEnvironment(T.StreamConfig(
            device=device, batch_size=16, key_capacity=16))
        env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
        tag = T.OutputTag("late")
        w = (env.add_source(ReplaySource(lines))
             .assign_timestamps_and_watermarks(et.IsoTimestampExtractor(T.Time.seconds(10)))
             .map(et.parse).key_by(1)
             .window(SlidingEventTimeWindows.of(T.Time.seconds(60), T.Time.seconds(20)))
             .allowed_lateness(T.Time.seconds(20))
             .side_output_late_data(tag))
        if apply == "reduce":
            main = w.reduce(lambda a, b: T.Tuple3(a.f0, a.f1, a.f2 + b.f2))
        elif apply == "aggregate":
            main = w.aggregate(SumCount())
        else:
            main = w.process(Total())
        h_main, h_late = main.collect(), main.get_side_output(tag).collect()
        env.execute("late")
        return ([repr(t) for t in h_main.items], [repr(t) for t in h_late.items],
                env.metrics.window_fires)

    got, want = run(card), run("cpu")
    assert len(got[0]) > 20 and len(got[1]) > 0 and got == want


def _median_program(device):
    """The chapter-2 median's program, its schema filled in as the first
    batch would, with element buffers of 4 and hosts h0-h3 interned."""
    env = T.StreamExecutionEnvironment(T.StreamConfig(
        device=device, batch_size=8, key_capacity=4, process_buffer_capacity=4))
    chapter2_median.build(env, env.add_source(ReplaySource([]))).collect()
    plan = build_plan(env, env._sinks)
    plan.record_kinds.extend(["str", "f64"])
    plan.tables.extend([StringTable(), None])
    for h in range(4):
        plan.tables[0].intern(f"h{h}")
    return build_program(plan, env.config), plan


def test_counts_past_2_24_stay_exact_on_card(card):
    # a (key, slot) cell's count past 2^24 (a float count would round it):
    # its window is cleared unfired by a clock jump past the ring, and the
    # eviction counter takes the exact integer, on the card as on the CPU
    def run(device):
        prog, plan = _median_program(device)
        state = prog.init_state()
        keys = torch.tensor([1, 1, 1, 1, 0, 2, 3, 1], dtype=torch.int32)
        usage = torch.arange(8, dtype=torch.float64)
        ts = torch.zeros(8, dtype=torch.int64)
        valid = torch.ones(8, dtype=torch.bool)
        state, _ = prog.step(state, [keys.to(device), usage.to(device)],
                             valid.to(device), ts.to(device), 0)
        n = prog.ring.n_slots
        state["cnt"][1 * n + 0] = 2**24 + 3  # key 1, slot of pane 0
        far = torch.full((8,), 100 * 60_000, dtype=torch.int64)
        state, _ = prog.step(state, [keys.to(device), usage.to(device)],
                             valid.to(device), far.to(device), 0)
        return int(state["evicted_unfired"]), int(state["buffer_overflow"])

    got, want = run(card), run("cpu")
    # 2^24 + 3 in key 1's cell, one record each in keys 0, 2 and 3
    assert got == want and got[0] == 2**24 + 6
