"""Chapter 6 (the multi-tenant job server) and the observability layer on
the card against the same runs on the CPU (tolerance: bitwise): a fleet
with quotas, updates, a removal, a late admission past the tenant
capacity (the rule vectors grow once), a keyed fleet whose rolling max
runs on the kernel, and obs-enabled runs of the chapter-3 job whose
rows, waits on the card and build count match the obs-off run. Every
test here needs a CUDA device and skips without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed; there, skip the repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tenancy_gpu.py -q
"""

import pytest
import torch

import tpustream_torch as T
from tpustream_torch.config import ObsConfig, StreamConfig
from tpustream_torch.jobs import chapter6_tenant_fleet as c6
from tpustream_torch.jobs.chapter3_bandwidth_eventtime import build as build_et
from tpustream_torch.ops import seq_rolling as S
from tpustream_torch.runtime.sources import ReplaySource

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this checks the card's run")
    return "cuda"


def run_fleet(device, batch_size, capacity=4):
    cfg = StreamConfig(device=device, batch_size=batch_size,
                       obs=ObsConfig(enabled=True))
    srv = T.JobServer(c6.make_plan(capacity), config=cfg)
    for i in range(4):
        t = f"g{i}"
        srv.add_tenant(t, rules={"threshold": 82.0 + i},
                       quota=T.TenantQuota(max_records=20) if i == 1 else None)
        srv.ingest(t, c6.tenant_lines(t, 16, base=75.0 + i))
    srv.update_tenant_rules("g0", {"threshold": 95.5})
    srv.remove_tenant("g3")
    srv.add_tenant("g4", rules={"threshold": 70.0})  # slot 4: grows 4 -> 8
    for i in range(5):
        srv.ingest(f"g{i}", c6.tenant_lines(f"g{i}", 16, base=85.0))
    res = srv.run("fleet")
    grown = [e for e in res.metrics.job_obs.flight.events()
             if e["kind"] == "tenant_capacity_grown"]
    return ({t: [repr(x) for x in srv.output(t)] for t in srv.tenants()},
            {t: srv.quota_output(t) for t in srv.tenants()},
            [(e["old_capacity"], e["new_capacity"]) for e in grown])


@pytest.mark.parametrize("batch_size", [3, 64])
def test_fleet_card_equals_cpu(card, batch_size):
    got = run_fleet(card, batch_size)
    assert got[2] == [(4, 8)]
    assert any(got[0].values())
    assert got == run_fleet("cpu", batch_size)


def _kv_parse(line):
    items = line.split(" ")
    return T.Tuple2(items[0], float(items[1]))


def run_keyed_fleet(device):
    rules = T.RuleSet()
    rules.declare("unused", 0.0, "f64")
    plan = T.TenantPlan(parse=_kv_parse, build=lambda s, r: s.key_by(0).max(1),
                        rules=rules, tenant_capacity=8)
    srv = T.JobServer(plan, config=StreamConfig(device=device, batch_size=16))
    for t in ("a", "b", "c"):
        srv.add_tenant(t)
    for i in range(40):
        for j, t in enumerate(("a", "b", "c")):
            srv.ingest(t, [f"h{(i + j) % 3} {(i * 37 + j * 11) % 101}.5"])
    srv.run("keyed fleet")
    return {t: [repr(x) for x in srv.output(t)] for t in srv.tenants()}


def test_keyed_fleet_on_the_kernel_card_equals_cpu(card):
    S.reset_launches()
    got = run_keyed_fleet(card)
    assert S.seq_rolling_reduce.launches >= 1
    assert got == run_keyed_fleet("cpu")


LINES = [
    f"2020-01-01T00:{m:02d}:{s:02d} ch{(m + s) % 3} {1234567 + 997 * s}"
    for m in range(4)
    for s in range(60)
]


def run_obs(device, enabled):
    obs = ObsConfig(enabled=enabled, latency_marker_interval_ms=1e-6 if enabled else 0.0,
                    snapshot_interval_s=1e-3 if enabled else 0.0)
    env = T.StreamExecutionEnvironment(StreamConfig(
        device=device, batch_size=16, key_capacity=64, obs=obs,
        acc_dtype="int32", max_fires_per_step=4))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    h = build_et(env, env.add_source(ReplaySource(LINES)),
                 size=T.Time.minutes(5), slide=T.Time.seconds(5),
                 delay=T.Time.minutes(1)).collect()
    env.execute("obs")
    return [repr(t) for t in h.items], env.metrics


def test_obs_run_card_equals_cpu_and_obs_off(card):
    on_rows, on = run_obs(card, True)
    off_rows, off = run_obs(card, False)
    cpu_rows, _ = run_obs("cpu", True)
    assert on_rows == off_rows == cpu_rows and on_rows
    assert on.d2h_syncs == off.d2h_syncs
    series = on.obs_snapshot()["metrics"]["series"]
    assert [s["value"] for s in series if s["name"] == "operator_compile_count"] == [1]
    assert not [s for s in series if s["name"] == "operator_recompile_cause"]
    env = on.job_obs.snapshotter.meta["env"]
    assert env["backend"] == "cuda"
    assert env["device_kind"] == torch.cuda.get_device_name(0)
