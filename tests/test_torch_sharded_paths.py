"""The PyTorch port's sharded programs at parallelism 8, side by side
with the JAX package at the same parallelism on the suite's 8 virtual
CPU devices: the paths around the families' steps. The 32-bit
scatter-reduce merge with a fire budget (deferred fires drained on
every shard at once), an ``exchange_capacity_factor`` whose overflow is
counted, the obs layer's sharded series (exchange staging bytes and
capacity, per-shard state bytes), and chained keyed stages (the
hand-off in the canonical (end, key) order; a rolling stage's
timestamps forwarded to an event-time window), and key-capacity growth
at 8 shards. Rows, ``print()`` bytes
and counters are compared exactly, as in ``tests/test_torch_sharded.py``.
"""

from importlib import import_module

import pytest

import tpustream
from test_torch_chains import LINES as CHAIN_LINES
from test_torch_chains import PKGS as CHAIN_PKGS
from test_torch_chains import stage1
from test_torch_sharded import _pkg, both, et_lines, flagship


def test_sharded_flagship_int32_matches_the_jax_package(capsys):
    """The scatter-reduce merge with a fire budget: deferred fires drain
    on every shard at once."""
    both(flagship, et_lines(16, 120), capsys, parallelism=8, batch_size=40,
         key_capacity=64, acc_dtype="int32", max_fires_per_step=4)


def test_sharded_flagship_counts_exchange_overflow(capsys):
    """A small ``exchange_capacity_factor``: rows past a bucket's
    capacity are counted, the same in both packages."""
    counters = both(flagship, et_lines(3, 120), capsys, parallelism=8,
                    batch_size=40, key_capacity=64,
                    exchange_capacity_factor=0.5)[3]
    assert counters["exchange_overflow"] > 0


def _series(metrics):
    out = {}
    for s in metrics.obs_snapshot()["metrics"]["series"]:
        out[(s["name"], s["labels"].get("operator"),
             s["labels"].get("shard"))] = s["value"]
    return out


def test_sharded_obs_series_match_the_jax_package():
    """Obs on at parallelism 8: the exchange series (the staging bytes a
    step makes, the capacity in rows) equal the JAX package's, the
    per-shard state bytes sum to the total, and the record accounting
    is the single-device run's."""
    lines = et_lines(n_keys=7, n_records=120)
    got = {}
    for side in ("jax", "torch"):
        pkg = _pkg(side)
        cfg = dict(parallelism=8, batch_size=40, key_capacity=64,
                   print_parallelism=1,
                   obs=import_module(pkg.__name__ + ".config").ObsConfig(enabled=True))
        if side == "torch":
            cfg["device"] = "cpu"
        env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
        env.set_stream_time_characteristic(pkg.TimeCharacteristic.EventTime)
        sources = import_module(pkg.__name__ + ".runtime.sources")
        h = flagship(pkg, env.add_source(sources.ReplaySource(lines)))[0].collect()
        env.execute("obs-sharded")
        got[side] = ([repr(t) for t in h.items], _series(env.metrics))
    (jrows, js), (trows, ts) = got["jax"], got["torch"]
    assert trows == jrows
    for name in ("operator_exchange_buffer_bytes",
                 "operator_exchange_capacity_rows", "records_in"):
        keys = [k for k in js if k[0] == name]
        assert keys and all(ts[k] == js[k] for k in keys), name
    shards = {k[2]: v for k, v in ts.items()
              if k[0] == "operator_hbm_state_bytes" and k[2] is not None}
    total = next(v for k, v in ts.items()
                 if k[0] == "operator_hbm_state_bytes" and k[2] is None)
    assert sorted(shards) == [str(i) for i in range(8)]
    assert all(v > 0 for v in shards.values()) and sum(shards.values()) == total


def _chain(kind):
    def build(pkg, text):
        ns = CHAIN_PKGS["jax" if pkg is tpustream else "torch"]
        out = stage1(ns, text).key_by(1)
        if kind == "rolling":
            return out.sum(2), None
        return out.time_window(pkg.Time.seconds(30)).reduce(
            lambda p, q: pkg.Tuple3(p.f0, p.f1, p.f2 + q.f2)), None
    return build


def rolling_then_window(pkg, text):
    ns = CHAIN_PKGS["jax" if pkg is tpustream else "torch"]
    from test_torch_chains import parse3, ts_assigner

    return (text.assign_timestamps_and_watermarks(ts_assigner(ns))
            .map(parse3(ns)).key_by(0).max(2).key_by(1)
            .time_window(pkg.Time.seconds(30))
            .reduce(lambda p, q: pkg.Tuple3(p.f0, p.f1, p.f2 + q.f2))), None


@pytest.mark.parametrize("build", [_chain("rolling"), _chain("window"),
                                   rolling_then_window],
                         ids=["window_rolling", "window_window",
                              "rolling_window"])
def test_sharded_chained_stages_match_the_jax_package(build, capsys):
    """Chained keyed stages at parallelism 8: the hand-off between the
    stages in the canonical (end, key) order, and a rolling stage's
    timestamps forwarded to an event-time window."""
    lines = CHAIN_LINES + [f"{30000 + 700 * i} {'abc'[i % 3]} {'xyz'[i % 2]} {i}"
                           for i in range(24)]
    rows = both(build, lines, capsys, parallelism=8, batch_size=8,
                key_capacity=16)[0]
    assert rows


@pytest.mark.parametrize("job", ["rolling", "flagship"])
def test_sharded_key_capacity_growth_matches_the_jax_package(job, capsys):
    """More keys than ``key_capacity`` at 8 shards: each shard's state
    grows in place (key ``g`` stays on shard ``g % 8`` at its row), and
    the rows equal the JAX package's, which grows its shard-major
    layout."""
    from test_torch_sharded import ch2_lines, rolling_max

    build, items, kw = {
        "rolling": (rolling_max, ch2_lines(100), dict(event_time=False)),
        "flagship": (flagship, et_lines(16, 120), {}),
    }[job]
    rows = both(build, items, capsys, parallelism=8, batch_size=16,
                key_capacity=8, **kw)[0]
    assert rows
