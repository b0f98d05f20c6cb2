"""The chapter-3 jobs on the card against the same jobs on the CPU. Every
test here needs a CUDA device and skips without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_chapter3_gpu.py -q
"""

import pytest
import torch

import tpustream_torch as T
from tpustream_torch.jobs import chapter3_bandwidth, chapter3_bandwidth_eventtime
from tpustream_torch.runtime.sources import AdvanceProcessingTime, ReplaySource

pytestmark = pytest.mark.gpu

CONFIGS = {
    "float64": {},
    "int32": {"acc_dtype": "int32", "max_fires_per_step": 4},
}
ET_LINES = [
    "2019-08-28T10:00:00 www.163.com 10000",
    "2019-08-28T10:01:00 www.163.com 100",
    "2019-08-28T10:02:00 www.163.com 100",
    "2019-08-28T09:01:00 www.163.com 100",
    "2019-08-28T10:06:00 www.163.com 100",
]
# a five-minute jump inside one batch: the ring sweep
JUMP_LINES = [
    "2019-08-28T09:03:00 www.163.com 1000",
    "2019-08-28T09:04:00 www.163.com 2000",
    "2019-08-28T09:05:00 www.163.com 3000",
    "2019-08-28T09:01:00 www.163.com 9999",
    "2019-08-28T10:06:00 www.163.com 5000",
]
FLOW_LINES = [
    "2019-08-28T10:00:00 www.163.com 10000",
    "2019-08-28T10:01:00 www.163.com 100",
    "2019-08-28T10:02:00 www.163.com 100",
    "2019-08-28T10:03:00 www.163.com 1000",
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this checks the card's run")
    return "cuda"


def _event_time(lines, device, batch_size, **cfg):
    env = T.StreamExecutionEnvironment(T.StreamConfig(
        device=device, batch_size=batch_size, key_capacity=64, **cfg))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    h = chapter3_bandwidth_eventtime.build(
        env, env.add_source(ReplaySource(lines))).collect()
    env.execute("BandwidthMonitorWithEventTime")
    return [repr(t) for t in h.items], env.metrics.summary()


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("batch_size", [1, 3, 8])
@pytest.mark.parametrize("name", ["golden", "jump"])
def test_event_time_card_equals_cpu(card, name, batch_size, config):
    lines = ET_LINES if name == "golden" else JUMP_LINES
    got, m = _event_time(lines, card, batch_size, **CONFIGS[config])
    want, m_cpu = _event_time(lines, "cpu", batch_size, **CONFIGS[config])
    assert got and got == want
    for k in ("window_fires", "late_dropped", "alert_overflow", "evicted_unfired"):
        assert m[k] == m_cpu[k], k


@pytest.mark.parametrize("sliding,advance", [(False, 61_000), (True, 16_000)])
def test_processing_time_golden_on_card(card, sliding, advance):
    env = T.StreamExecutionEnvironment(T.StreamConfig(device=card))
    env.set_stream_time_characteristic(T.TimeCharacteristic.ProcessingTime)
    src = ReplaySource(FLOW_LINES + [AdvanceProcessingTime(advance)])
    h = chapter3_bandwidth.build(env, env.add_source(src), sliding=sliding).collect()
    env.execute("BandwidthMonitor")
    assert [repr(t) for t in h.items] == ["(www.163.com,11200)"]


def test_alert_overflow_is_counted_on_card(card):
    # an alert buffer of 4 rows: the fire's rows past it are counted,
    # and no index past the buffer reaches a scatter on the card
    lines = [f"2019-08-28T10:00:{s:02d} www.c{s}.com 100" for s in range(10)]
    lines.append("2019-08-28T10:10:00 www.c0.com 100")
    got, m = _event_time(lines, card, 16, alert_capacity=4)
    want, m_cpu = _event_time(lines, "cpu", 16, alert_capacity=4)
    assert got == want and m["alert_overflow"] == m_cpu["alert_overflow"] > 0
