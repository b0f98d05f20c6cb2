"""Chapter 4 (CEP) and chapter 5 (dynamic rules) on the card against the
same runs on the CPU (tolerance: bitwise): the chapter-4 job, a seeded
CEP run with timeouts and late rows, the chapter-5 job with updates
inside batches, and a rolling max on the kernel whose pre-chain filter
reads a rule. Every test here needs a CUDA device and skips without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cep_gpu.py -q
"""

import numpy as np
import pytest
import torch

import tpustream_torch as T
from tpustream_torch.javacompat import Double, Long
from tpustream_torch.jobs import chapter4_cep_alert, chapter5_dynamic_rules
from tpustream_torch.ops import seq_rolling as S
from tpustream_torch.runtime.sources import ReplaySource

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this checks the card's run")
    return "cuda"


def ch4_lines(n, seed):
    """``ISO-ts channel flow`` lines over 8 channels, about 40% of flows
    above the job's 5000 threshold, jittered back by up to 20 s."""
    import datetime

    rng = np.random.default_rng(seed)
    tz = datetime.timezone(datetime.timedelta(hours=8))
    t0 = 1_566_957_600
    ts = t0 + np.arange(n) * 7 - rng.integers(0, 21, n)
    ch = rng.integers(0, 8, n)
    flow = np.where(rng.random(n) < 0.4, rng.integers(5001, 9000, n),
                    rng.integers(0, 5000, n))
    return [f"{datetime.datetime.fromtimestamp(int(t), tz).strftime('%Y-%m-%dT%H:%M:%S')}"
            f" www.c{c}.com {f}" for t, c, f in zip(ts, ch, flow)]


def run_ch4(device, lines, batch):
    env = T.StreamExecutionEnvironment(T.StreamConfig(device=device, batch_size=batch))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    tag = T.OutputTag("breach-timeout")
    alerts = chapter4_cep_alert.build(env, env.add_source(ReplaySource(lines)),
                                      timeout_tag=tag)
    h = alerts.collect()
    ht = alerts.get_side_output(tag).collect()
    env.execute("cep")
    s = env.metrics.summary()
    return ([repr(t) for t in h.items], [repr(t) for t in ht.items],
            s["cep_matches"], s["cep_timeouts"])


@pytest.mark.parametrize("batch", [1, 16, 256])
def test_chapter4_card_equals_cpu(card, batch):
    lines = ch4_lines(600, seed=batch)
    got = run_ch4(card, lines, batch)
    assert got == run_ch4("cpu", lines, batch)
    assert got[0] and got[1]


def test_cep_late_and_lateness_card_equals_cpu(card):
    class Ts(T.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(T.Time.seconds(1))

        def extract_timestamp(self, e):
            return Long.parseLong(e.split(" ")[0]) * 1000

    rng = np.random.default_rng(4)
    secs = np.arange(300) - rng.integers(0, 6, 300)
    lines = [f"{t} k{k} {v}" for t, k, v in
             zip(secs, rng.integers(0, 5, 300), rng.integers(0, 30, 300))]

    def run(device):
        env = T.StreamExecutionEnvironment(T.StreamConfig(device=device, batch_size=9))
        env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
        keyed = (env.add_source(ReplaySource(lines))
                 .assign_timestamps_and_watermarks(Ts())
                 .map(lambda s: T.Tuple3(Long.parseLong(s.split(" ")[0]), s.split(" ")[1],
                                         Long.parseLong(s.split(" ")[2])))
                 .key_by(1))
        late, tmo = T.OutputTag("late"), T.OutputTag("timeout")
        pat = (T.Pattern.begin("a").where(lambda r: r.f2 > 12).times(2)
               .next("b").where(lambda r: r.f2 < 20).within(T.Time.seconds(8)))
        res = (T.CEP.pattern(keyed, pat).allowed_lateness(T.Time.seconds(1))
               .side_output_late_data(late).select(timeout_tag=tmo))
        hs = [res.collect(), res.get_side_output(tmo).collect(),
              res.get_side_output(late).collect()]
        env.execute("cep")
        return [[repr(t) for t in h.items] for h in hs]

    got = run(card)
    assert got == run("cpu")
    assert all(got)


def run_ch5(device, updates, batch):
    lines = [f"15634520{j % 100:02d} 10.8.22.{j % 5} cpu{j % 3} {60 + (j * 13) % 40}.5"
             for j in range(400)]
    env = T.StreamExecutionEnvironment(T.StreamConfig(device=device, batch_size=batch))
    rules = chapter5_dynamic_rules.make_rules()
    handle = chapter5_dynamic_rules.build(
        env, env.add_source(ReplaySource(lines)),
        env.add_source(ReplaySource(chapter5_dynamic_rules.control_lines(updates))),
        rules).collect()
    env.execute("ch5")
    want = [tuple(t) for t in chapter5_dynamic_rules.oracle(lines, updates)]
    return [tuple(t) for t in handle.items], want, rules.version


@pytest.mark.parametrize("batch", [7, 64])
def test_chapter5_card_equals_cpu_and_oracle(card, batch):
    updates = [(37, 95.0), (150, 70.0), (151, 85.0)]
    got, want, version = run_ch5(card, updates, batch)
    assert got == want == run_ch5("cpu", updates, batch)[0]
    assert version == 3


def test_rolling_max_reading_a_rule_on_the_kernel(card):
    """chapter2_max with the threshold filter ahead of the keyed max: on
    the card the max runs on seq_rolling.cu, with an update inside a
    batch."""
    rng = np.random.default_rng(9)
    lines = [f"{1563452000 + i} 10.0.0.{h} cpu{i % 8} {u / 100}" for i, (h, u) in
             enumerate(zip(rng.integers(0, 50, 2000), rng.integers(0, 10000, 2000)))]

    def run(device):
        rules = T.RuleSet()
        thr = rules.declare("threshold", 30.0, "f64")
        env = T.StreamExecutionEnvironment(T.StreamConfig(device=device, batch_size=256))
        env.from_collection([T.RuleUpdate("threshold", 70.0, 900)]).broadcast(rules)
        h = (env.add_source(ReplaySource(lines))
             .map(lambda s: T.Tuple3(s.split(" ")[1], s.split(" ")[2],
                                     Double.parseDouble(s.split(" ")[3])))
             .filter(lambda v: v.f2 > thr).key_by(0).max(2)).collect()
        S.reset_launches()
        env.execute("max")
        return [tuple(t) for t in h.items], S.seq_rolling_reduce.launches

    got, launches = run(card)
    cpu, _ = run("cpu")
    assert got == cpu and got
    assert launches >= 1
