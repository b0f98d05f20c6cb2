"""The PyTorch port at parallelism 8 in one process, on the CPU: the
8-shard checks of the JAX package's suite that the port's sharded tests
did not yet cover.

* Chapter 4's CEP job (tests/test_cep.py:296): its alerts at 1 shard
  equal the JAX package's host NFA oracle in order, and at 8 shards as
  a multiset; the timeout rows likewise.
* Dynamic rules on the mesh (tests/test_broadcast.py:213,225): a window
  parameter updated mid-stream gives at 8 shards exactly the JAX
  package's rows at 8 shards (and one device's); the chapter-5 threshold
  updated mid-batch gives at 8 shards the oracle's rows.
* The exchange's overflow policy (tests/test_metrics_strict.py:159-210):
  a skewed batch through a shrunken exchange raises under
  ``strict_overflow``, is counted without it (the count equal to the JAX
  package's at 8 shards), and the default capacity loses nothing.
* A tenant fleet at 8 shards (tests/test_tenancy.py:813): every
  tenant's rows equal the JAX package's fleet at 8 shards, and one
  device's.
* The deep pipeline at 8 shards (tests/test_pipeline_parity.py:213):
  the rows equal the JAX package's deep pipeline at 8 shards, the
  synchronous setting's at 8 shards, and one device's as a multiset.

Tolerance: none (rows compare as ``repr`` strings or tuples).
"""

import importlib

import pytest

from tests.test_broadcast import LINES as CH5_LINES
from tests.test_cep import timeout_rows
from tests.test_torch_broadcast import _kv_parse, expect_ch5, run_ch5
from tests.test_torch_chains import PKGS
from tests.test_torch_pipeline import DEEP, SYNC, rolling_lines, run_rolling
from tests.test_torch_tenancy import make_server
import tpustream_torch as T

CH4_LINES = [
    "2019-08-28T10:00:00 www.163.com 6000",
    "2019-08-28T10:00:10 www.163.com 7000",
    "2019-08-28T10:00:20 www.163.com 8000",
    "2019-08-28T10:00:30 www.sina.com 6100",
    "2019-08-28T10:00:40 www.sina.com 7100",
    "2019-08-28T10:01:00 www.163.com 9000",
    "2019-08-28T10:00:50 www.sina.com 8100",  # out of order, in bound
    "2019-08-28T10:05:00 www.qq.com 50",      # advances the watermark
]


def _chapter4(parallelism):
    from tpustream_torch.jobs.chapter4_cep_alert import build
    from tpustream_torch.runtime.sources import ReplaySource

    env = T.StreamExecutionEnvironment(
        T.StreamConfig(device="cpu", batch_size=8, parallelism=parallelism))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    tag = T.OutputTag("breach-timeout")
    alerts = build(env, env.add_source(ReplaySource(CH4_LINES)),
                   timeout_tag=tag)
    h = alerts.collect()
    ht = alerts.get_side_output(tag).collect()
    env.execute(f"cep-chapter4-p{parallelism}")
    return [repr(t) for t in h.items], [repr(t) for t in ht.items]


def test_chapter4_at_eight_shards_matches_oracle():
    from tpustream.cep import run_oracle
    from tpustream.jobs.chapter4_cep_alert import make_pattern
    from tpustream.utils.timeutil import iso_local_to_epoch_sec

    recs = []
    for line in CH4_LINES:
        iso, ch, flow = line.split(" ")
        sec = iso_local_to_epoch_sec(iso)
        recs.append(((sec, ch, int(flow)), sec * 1000))
    m, t, _ = run_oracle(make_pattern(), [recs], delay_ms=5000)
    want = [f"({b0[1]},{b0[2] + b1[2] + b2[2]},{b0[0]},{b2[0]})"
            for b0, b1, b2 in m]
    a1, t1 = _chapter4(1)
    assert a1 == want and want
    assert sorted(t1) == sorted(repr(r) for r in timeout_rows(t, R=2))
    a8, t8 = _chapter4(8)
    assert sorted(a8) == sorted(a1)
    assert sorted(t8) == sorted(t1)


def _window_param(updates, batch_size, parallelism):
    rules = T.RuleSet()
    limit = rules.declare("sum_limit", 10.0, "f64")
    env = T.StreamExecutionEnvironment(T.StreamConfig(
        batch_size=batch_size, parallelism=parallelism, device="cpu"))
    data = env.from_collection([f"k {i}" for i in range(12)])
    ctrl = env.from_collection(
        [T.RuleUpdate("sum_limit", v, pos) for pos, v in updates])
    ctrl.broadcast(rules)
    handle = (data.map(_kv_parse).key_by(0).count_window(2).sum(1)
              .filter(lambda t: t.f1 < limit)).collect()
    env.execute("win-param-test")
    return [tuple(t) for t in handle.items]


def test_window_param_at_eight_shards_equals_one_device():
    from tests.test_broadcast import _run_window_param as jax_window_param

    updates = [(6, 100.0)]
    mesh = _window_param(updates, batch_size=8, parallelism=8)
    assert mesh == jax_window_param(updates, batch_size=8, parallelism=8)
    single = _window_param(updates, batch_size=8, parallelism=1)
    assert mesh == single
    assert single == [("k", 1.0), ("k", 5.0), ("k", 9.0),
                      ("k", 13.0), ("k", 17.0), ("k", 21.0)]


def test_threshold_at_eight_shards_mid_batch_matches_oracle():
    updates = [(13, 95.0)]
    _, single, _ = run_ch5(CH5_LINES, updates, batch_size=8)
    _, mesh, _ = run_ch5(CH5_LINES, updates, batch_size=8, parallelism=8)
    assert mesh == single == expect_ch5(CH5_LINES, updates)


BASE = 1_200_000  # epoch seconds, a multiple of 60
SKEWED = [f"{BASE + 10} www.hot.com {i}" for i in range(16)] + [
    f"{BASE + 140} www.hot.com 1"]


def _sharded_reduce(side, lines, **over):
    from tests.test_torch_metrics_strict import parse, seconds_extractor

    ns = PKGS[side]
    windows = importlib.import_module(ns.pkg.__name__ + ".api.windows")
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(
        batch_size=16, key_capacity=64, parallelism=8, print_parallelism=1,
        **over, **ns.cfg))
    env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    out = (env.add_source(ns.sources.ReplaySource(lines))
           .assign_timestamps_and_watermarks(seconds_extractor(ns))
           .map(parse(ns)).key_by(1)
           .window(windows.TumblingEventTimeWindows.of(ns.pkg.Time.seconds(60)))
           .reduce(lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
           .collect())
    env.execute("sharded-strict")
    return [repr(t) for t in out.items], env.metrics.summary()


def test_exchange_overflow_strict_raises_at_eight_shards():
    # every record keys to one shard: the factor leaves 2 slots of 16
    with pytest.raises(RuntimeError, match="strict_overflow.*exchange_overflow"):
        _sharded_reduce("torch", SKEWED, exchange_capacity_factor=0.125,
                        strict_overflow=True)


def test_exchange_overflow_counted_like_the_jax_package():
    got = _sharded_reduce("torch", SKEWED, exchange_capacity_factor=0.125)
    want = _sharded_reduce("jax", SKEWED, exchange_capacity_factor=0.125)
    assert got[1]["exchange_overflow"] > 0
    assert got[1]["exchange_overflow"] == want[1]["exchange_overflow"]
    assert got[0] == want[0]


def test_exchange_default_capacity_is_loss_free():
    rows, s = _sharded_reduce("torch", SKEWED, strict_overflow=True)
    assert s["exchange_overflow"] == 0
    assert s["window_fires"] == 2  # (hot, w0) and (hot, w2)
    assert rows == _sharded_reduce("jax", SKEWED, strict_overflow=True)[0]


def test_fleet_at_eight_shards_equals_one_device():
    import tpustream.jobs.chapter6_tenant_fleet as jax_c6
    from tests.test_tenancy import make_server as jax_make_server
    from tpustream_torch.jobs import chapter6_tenant_fleet as c6

    def run_fleet(side, parallelism):
        mk, jobs = ((make_server, c6) if side == "torch"
                    else (jax_make_server, jax_c6))
        srv = mk(batch_size=8, parallelism=parallelism)
        for i, t in enumerate(["a", "b", "c"]):
            srv.add_tenant(t, rules={"threshold": 84.0 + 4 * i})
            srv.ingest(t, jobs.tenant_lines(t, 16))
        srv.update_tenant_rules("b", {"threshold": 80.0})
        for t in ("a", "b", "c"):
            srv.ingest(t, jobs.tenant_lines(t, 16, base=85.0))
        srv.run(f"fleet-p{parallelism}")
        return {t: [repr(x) for x in srv.output(t)] for t in ("a", "b", "c")}

    mesh = run_fleet("torch", 8)
    assert mesh == run_fleet("jax", 8)
    assert mesh == run_fleet("torch", 1)
    assert any(mesh.values())


def test_deep_pipeline_at_eight_shards_equals_sync_and_one_device():
    from tests.test_torch_chains import run_job
    from tests.test_torch_pipeline import rolling_build

    lines = rolling_lines(64, 6)
    p8 = dict(parallelism=8, batch_size=8, key_capacity=64,
              print_parallelism=1)
    got, _ = run_rolling(lines, **DEEP, **p8)
    jax_got, _ = run_job("jax", rolling_build, lines, event_time=False,
                         **DEEP, **p8)
    assert got == jax_got
    want, _ = run_rolling(lines, **SYNC, **p8)
    assert got == want
    single, _ = run_rolling(lines, batch_size=8, **SYNC)
    assert sorted(got) == sorted(single)
