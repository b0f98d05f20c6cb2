"""Supervised CEP recovery through the PyTorch port, on the CPU (the
cases of tests/test_cep_recovery.py): NFA registers ride the checkpoint format,
so a crash injected mid-pattern (``cep_step`` fault point) restarts from
the latest auto-checkpoint and replays to byte-identical match AND
timeout output — exactly-once over in-flight partial matches."""

import pytest

from tpustream_torch import (
    OutputTag,
    StreamExecutionEnvironment,
    TimeCharacteristic,
)
from tpustream_torch.config import ObsConfig, StreamConfig
from tpustream_torch.jobs.chapter4_cep_alert import build
from tpustream_torch.runtime.sources import ReplaySource
from tpustream_torch.runtime.supervisor import fixed_delay, no_restart
from tpustream_torch.testing import FaultInjected, FaultInjector, FaultPoint

# three-breach run split across batches (batch_size=2) so the injected
# crash lands BETWEEN the second and third breach — registers hold a
# live two-event partial at the failing step
LINES = [
    "2019-08-28T10:00:00 www.163.com 6000",
    "2019-08-28T10:00:10 www.163.com 7000",
    "2019-08-28T10:00:20 www.sina.com 100",
    "2019-08-28T10:00:30 www.163.com 8000",
    "2019-08-28T10:02:00 www.sina.com 9000",
    "2019-08-28T10:03:00 www.sina.com 200",
]


def run_cep_supervised(items, ckdir=None, strategy=None, injector=None,
                       **over):
    """One chapter-4 CEP run; returns (alerts, timeouts, result)."""
    over.setdefault("batch_size", 2)
    cfg = StreamConfig(device="cpu", **over)
    if ckdir is not None:
        cfg = cfg.replace(
            checkpoint_dir=str(ckdir), checkpoint_interval_batches=1
        )
    if injector is not None:
        cfg = injector.install(cfg)
    env = StreamExecutionEnvironment(cfg)
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    if strategy is not None:
        env.set_restart_strategy(strategy)
    text = env.add_source(ReplaySource(items))
    tag = OutputTag("breach-timeout")
    alerts = build(env, text, timeout_tag=tag)
    h = alerts.collect()
    ht = alerts.get_side_output(tag).collect()
    result = env.execute("cep-recovery-test")
    return [repr(v) for v in h.items], [repr(v) for v in ht.items], result


def test_cep_step_recovery_byte_identical(tmp_path):
    baseline_alerts, baseline_timeouts, _ = run_cep_supervised(LINES)
    assert len(baseline_alerts) == 1      # 163.com: 6000+7000+8000
    assert baseline_timeouts              # sina's lone 9000 spike expires

    inj = FaultInjector(FaultPoint("cep_step", at=2))
    alerts, timeouts, result = run_cep_supervised(
        LINES, ckdir=tmp_path, strategy=fixed_delay(3, 0.0), injector=inj,
        obs=ObsConfig(enabled=True),
    )
    assert inj.fired == 1
    assert alerts == baseline_alerts
    assert timeouts == baseline_timeouts
    series = result.metrics.obs_snapshot()["metrics"]["series"]
    restarts = [s for s in series if s["name"] == "job_restarts_total"]
    assert sum(s["value"] for s in restarts) == 1
    assert restarts[0]["labels"]["cause"] == "cep_step"


def test_cep_step_fault_without_restart_fails(tmp_path):
    inj = FaultInjector(FaultPoint("cep_step", at=2))
    with pytest.raises(FaultInjected):
        run_cep_supervised(
            LINES, ckdir=tmp_path, strategy=no_restart(), injector=inj
        )
    assert inj.fired == 1


def test_cep_step_fault_point_ignores_non_cep_jobs():
    """cep_step only fires for CEP programs: a windowed job runs clean
    through an armed injector."""
    from tpustream_torch.jobs.chapter2_max import build as build_max

    inj = FaultInjector(FaultPoint("cep_step", at=1))
    cfg = inj.install(StreamConfig(device="cpu", batch_size=2))
    env = StreamExecutionEnvironment(cfg)
    text = env.add_source(ReplaySource([
        "1563452056 10.8.22.1 cpu0 80.5",
        "1563452060 10.8.22.1 cpu0 99.9",
    ]))
    h = build_max(env, text).collect()
    env.execute("cep-fault-scope")
    assert inj.fired == 0
    assert h.items
