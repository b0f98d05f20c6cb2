"""The executor pipeline on the card: pinned upload ring, copy stream and
events, count scalars copied with ``non_blocking``, steps in flight,
grouped fetches, compaction, the packed wire with a demotion, parse-ahead
and ingest lanes forked from a process with a live CUDA context. Each
job's rows on the card at every setting equal the synchronous run on the
CPU (tolerance: identical rows). Every test here needs a CUDA device and
skips without one.

This file imports nothing of JAX; where JAX is not installed, skip the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pipeline_gpu.py -q
"""

import numpy as np
import pytest
import torch

import tpustream_torch as T
from tpustream_torch.config import ObsConfig
from tpustream_torch.jobs import (
    chapter1_threshold,
    chapter2_max,
    chapter3_bandwidth_eventtime,
)
from tpustream_torch.runtime.sources import ReplayBytesSource, ReplaySource
from tpustream_torch.testing import FaultInjector, FaultPoint

pytestmark = pytest.mark.gpu

SYNC = dict(async_depth=1, h2d_depth=1, compaction_capacity=0,
            packed_wire=False, h2d_compress=False)
SETTINGS = {
    "defaults": {},
    "deep": dict(async_depth=4, h2d_depth=3, fetch_group=2, parse_ahead=2),
    "tight-compaction": dict(async_depth=3, compaction_capacity=4),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this checks the card's run")
    return "cuda"


def cpu_lines(n=2000, seed=3):
    rng = np.random.default_rng(seed)
    return [f"{1563452050 + i // 50} 10.8.22.{int(h)} cpu{int(c)} {v:.1f}"
            for i, (h, c, v) in enumerate(zip(
                rng.integers(0, 40, n), rng.integers(0, 4, n),
                rng.random(n) * 100))]


def et_lines(n=2000, seed=4):
    import datetime

    rng = np.random.default_rng(seed)
    t = 1_566_954_000 + np.cumsum(rng.integers(0, 3, n))
    t = t - rng.integers(0, 60, n) * (rng.random(n) < 0.1)
    return [f"{datetime.datetime.fromtimestamp(int(s)).strftime('%Y-%m-%dT%H:%M:%S')}"
            f" www.site{int(k)}.com {int(v)}"
            for s, k, v in zip(t, rng.integers(0, 50, n), rng.integers(1, 5000, n))]


def run(job, lines, device, event_time=False, raw=None, **cfg):
    env = T.StreamExecutionEnvironment(T.StreamConfig(
        device=device, batch_size=128, **cfg))
    if event_time:
        env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    src = ReplaySource(lines) if raw is None else ReplayBytesSource([
        ("\n".join(lines[i:i + raw]).encode(), len(lines[i:i + raw]))
        for i in range(0, len(lines), raw)])
    h = job.build(env, env.add_source(src)).collect()
    env.execute("pipeline-gpu")
    return [repr(t) for t in h.items], env.metrics


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("job,lines,event_time", [
    (chapter1_threshold, cpu_lines, False),
    (chapter2_max, cpu_lines, False),
    (chapter3_bandwidth_eventtime, et_lines, True),
], ids=["ch1", "ch2-kernel", "ch3"])
def test_card_rows_equal_cpu_sync_rows(card, job, lines, event_time, setting):
    items = lines()
    want, _ = run(job, items, "cpu", event_time, **SYNC)
    got, m = run(job, items, card, event_time, **SETTINGS[setting])
    assert want
    assert got == want
    assert m.summary()["alert_overflow"] == 0


def test_demotion_on_the_card(card):
    """A column that outgrows its 16-bit deltas mid-stream demotes once;
    the uint16 deltas travel as int16 bits and widen with a mask."""
    big = 3 << 31
    lines = ([f"1 a {i}" for i in range(300)] + [f"1 b {big}", f"1 a {-big}"]
             + [f"1 b {i}" for i in range(300)])

    class Job:
        @staticmethod
        def build(env, text):
            return (text.map(lambda l: T.Tuple2(l.split(" ")[1],
                                                int(l.split(" ")[2])))
                    .key_by(0).sum(1))

    want, _ = run(Job, lines, "cpu", **SYNC)
    got, m = run(Job, lines, card, obs=ObsConfig(enabled=True))
    assert got == want
    causes = [e.get("cause") for e in m.job_obs.flight.events()
              if e["kind"] == "program_compiled"]
    assert causes == ["initial", "batch_shape_change"]


def test_lanes_forked_beside_a_cuda_context(card):
    """Lane workers fork while the parent holds a CUDA context and
    threads; one is SIGKILLed mid-run and respawned (a fork mid-job).
    The children never touch the card; the rows are the single-lane
    rows."""
    torch.zeros(1, device=card)  # a live context before the fork
    items = cpu_lines(4000)
    want, _ = run(chapter2_max, items, "cpu", **SYNC)
    inj = FaultInjector(FaultPoint("lane_worker_crash", at=3, exit_code=-9))
    cfg = inj.install(T.StreamConfig(
        device=card, batch_size=128, ingest_lanes=4,
        obs=ObsConfig(enabled=True)))
    env = T.StreamExecutionEnvironment(cfg)
    h = chapter2_max.build(env, env.add_source(ReplayBytesSource([
        ("\n".join(items[i:i + 128]).encode(), len(items[i:i + 128]))
        for i in range(0, len(items), 128)]))).collect()
    env.execute("lanes-gpu")
    assert [repr(t) for t in h.items] == want
    kinds = [e["kind"] for e in env.metrics.job_obs.flight.events()]
    assert "ingest_lanes_enabled" in kinds
    assert "ingest_lane_restarted" in kinds
    assert "ingest_lane_folded" not in kinds
