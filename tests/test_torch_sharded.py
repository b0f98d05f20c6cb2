"""The PyTorch port's sharded programs (``StreamConfig(parallelism=S)``,
S shards in one process) side by side with the JAX package at the same S
on the suite's 8 virtual CPU devices.

For each keyed family (rolling, tumbling/sliding window, session, session
``process()``, count, sliding count, count ``process()``, full-window
``process()``, CEP) at S = 8, and the flagship also at S = 4: the
collected rows (``repr``), the ``print()`` bytes with their ``n>``
subtask prefix, in order, and the counters (``exchange_overflow``, late,
evicted, fires, overflow) equal the JAX package's. The shapes are the
JAX package's sharded tests' (batch 40 or 16, key capacity 64).
``tests/test_torch_sharded_paths.py`` holds the paths around the
families' steps (the fire budget, a counted overflow, the obs series,
chained stages).

Tolerance: none; every comparison is exact. The p = S rows are compared
with the JAX package at the same S, not with p = 1: float sums combine
in another order at S > 1.
"""

from importlib import import_module

import numpy as np
import pytest

import tpustream
import tpustream_torch
from test_torch_sessions import _side_items, _side_job

COUNTERS = ("window_fires", "late_dropped", "alert_overflow",
            "evicted_unfired", "exchange_overflow", "buffer_overflow",
            "cep_matches", "cep_timeouts", "records_emitted")


def _pkg(side):
    return tpustream if side == "jax" else tpustream_torch


def run_side(side, build, items, capsys, *, event_time=True,
             proc_ms=None, **cfg):
    """``build(pkg, text) -> (stream, late stream or None)`` through one
    package: ``(collected reprs, late reprs, print() bytes, counters)``."""
    pkg = _pkg(side)
    sources = import_module(pkg.__name__ + ".runtime.sources")
    if side == "torch":
        cfg["device"] = "cpu"
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    env.set_stream_time_characteristic(
        pkg.TimeCharacteristic.EventTime if event_time
        else pkg.TimeCharacteristic.ProcessingTime)
    kw = {} if proc_ms is None else {"start_ms": 1_000, "ms_per_record": proc_ms}
    src = sources.ReplaySource(
        [sources.AdvanceProcessingTime(x) if isinstance(x, int) else x
         for x in items], **kw)
    stream, late = build(pkg, env.add_source(src))
    h = stream.collect()
    stream.print()
    hl = late.collect() if late is not None else None
    capsys.readouterr()
    env.execute("sharded")
    m = env.metrics.summary()
    return ([repr(t) for t in h.items],
            None if hl is None else [repr(t) for t in hl.items],
            capsys.readouterr().out,
            {k: m.get(k) for k in COUNTERS})


def both(build, items, capsys, **kw):
    want = run_side("jax", build, items, capsys, **kw)
    got = run_side("torch", build, items, capsys, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    return got


# -- inputs ------------------------------------------------------------------

def et_lines(n_keys=16, n_records=200):
    """tests/test_sharded_mesh.py's chapter-3 lines."""
    return [f"2019-08-28T10:{i // 20:02d}:{(i * 7) % 60:02d} www.ch{i % n_keys}.com "
            f"{100 + (i % 13) * 10}" for i in range(n_records)]


def ch2_lines(n=100):
    return [f"{i} 10.8.22.{i % 5} cpu{i % 3} {30 + ((i * 11) % 60)}.5"
            for i in range(n)]


def kv_lines(seed, n=90, keys="abcdefghij"):
    rng = np.random.default_rng(seed)
    return [f"{keys[int(rng.integers(0, len(keys)))]} "
            f"{float(rng.integers(1, 99)) + float(rng.random()):.3f}"
            for _ in range(n)]


# -- jobs ---------------------------------------------------------------------

def flagship(pkg, text):
    mod = import_module(pkg.__name__ + ".jobs.chapter3_bandwidth_eventtime")
    return mod.build(None, text), None


def rolling_max(pkg, text):
    mod = import_module(pkg.__name__ + ".jobs.chapter2_max")
    return mod.build(None, text), None


def median(pkg, text):
    mod = import_module(pkg.__name__ + ".jobs.chapter2_median")
    return mod.build(None, text), None


def _parse_kv(pkg):
    def parse(line):
        k, v = line.split(" ")
        return pkg.Tuple2(k, float(v))
    return parse


def count_reduce(pkg, text):
    return (text.map(_parse_kv(pkg)).key_by(0).count_window(3)
            .reduce(lambda a, b: pkg.Tuple2(a.f0, a.f1 + b.f1))), None


def sliding_count_reduce(pkg, text):
    return (text.map(_parse_kv(pkg)).key_by(0).count_window(4, 2)
            .reduce(lambda a, b: pkg.Tuple2(a.f0, a.f1 + b.f1))), None


def count_process(pkg, text):
    def fn(key, ctx, elements, out):
        out.collect(pkg.Tuple2(key, "/".join(repr(e.f1) for e in elements)))
    return (text.map(_parse_kv(pkg)).key_by(0).count_window(3, 2)
            .process(fn)), None


def cep_alert(pkg, text):
    mod = import_module(pkg.__name__ + ".jobs.chapter4_cep_alert")
    out_mod = import_module(pkg.__name__ + ".api.output")
    tag = out_mod.OutputTag("breach-timeout")
    alerts = mod.build(None, text, timeout_tag=tag)
    return alerts, alerts.get_side_output(tag)


def session(kind):
    def build(pkg, text):
        return _side_job(pkg, text, kind)
    return build


def cep_lines(n=160, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ch = f"www.c{int(rng.integers(0, 12))}.com"
        flow = int(rng.integers(4000, 9000))
        out.append(f"2019-08-28T10:{i // 12:02d}:{(i * 5) % 60:02d} {ch} {flow}")
    return out


def median_items(n=240, hosts=11, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(f"{1563452000 + i} 10.8.0.{int(rng.integers(0, hosts))} "
                   f"cpu{i % 2} {float(rng.random() * 100)!r}")
        if i % 60 == 59:
            out.append(1_000 + (i + 1) * 400 + 60_000)
    return out


# -- the families at S = 8 (and the flagship at S = 4) ------------------------

def test_sharded_rolling_max_matches_the_jax_package(capsys):
    rows = both(rolling_max, ch2_lines(), capsys, event_time=False,
                parallelism=8, batch_size=40, key_capacity=64)[0]
    assert len(rows) == 100


@pytest.mark.parametrize("p,n_keys,n_records", [(8, 16, 200), (4, 7, 120)])
def test_sharded_flagship_matches_the_jax_package(p, n_keys, n_records, capsys):
    rows, _, printed, counters = both(
        flagship, et_lines(n_keys, n_records), capsys, parallelism=p,
        batch_size=40, key_capacity=64)
    assert rows and counters["exchange_overflow"] == 0
    assert printed.startswith(tuple(f"{i}> " for i in range(1, p + 1)))


@pytest.mark.parametrize("kind", ["reduce", "mean", "lateness"])
def test_sharded_session_matches_the_jax_package(kind, capsys):
    both(session(kind), _side_items(kind, 3), capsys, parallelism=8,
         batch_size=40, key_capacity=64, alert_capacity=256)


def test_sharded_session_process_matches_the_jax_package(capsys):
    rows = both(session("process"), _side_items("process", 5), capsys,
                parallelism=8, batch_size=40, key_capacity=64,
                alert_capacity=256)[0]
    assert rows


@pytest.mark.parametrize("build", [count_reduce, sliding_count_reduce,
                                   count_process],
                         ids=["tumbling", "sliding", "process"])
def test_sharded_count_window_matches_the_jax_package(build, capsys):
    rows = both(build, kv_lines(1), capsys, event_time=False, parallelism=8,
                batch_size=16, key_capacity=64)[0]
    assert rows


def test_sharded_process_window_median_matches_the_jax_package(capsys):
    rows = both(median, median_items(), capsys, event_time=False,
                proc_ms=400, parallelism=8, batch_size=40, key_capacity=64)[0]
    assert rows


def test_sharded_cep_matches_the_jax_package(capsys):
    got = both(cep_alert, cep_lines(), capsys, parallelism=8, batch_size=40,
               key_capacity=64)
    assert got[0] and got[3]["cep_matches"] > 0

