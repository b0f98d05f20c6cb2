"""The chapter-2 windowed average (window ``aggregate``) through the
PyTorch port, on the CPU: the reference golden transcripts
(tests/test_chapter2_avg_golden.py), the accumulator layout and
liveness decisions against the JAX package's, and side-by-side runs
against the JAX package on seeded inputs with identical rows and
identical ``print()`` bytes (tolerance: bitwise; the mean's ``f1 / f0``
is an IEEE division in both)."""

import numpy as np
import pytest

import tpustream
import tpustream.jobs.chapter2_avg as jax_job
import tpustream.runtime.sources as jax_sources
import tpustream_torch
import tpustream_torch.jobs.chapter2_avg as torch_job
import tpustream_torch.runtime.sources as torch_sources
from tpustream_torch.runtime.sources import AdvanceProcessingTime, ReplaySource

LINES = [
    "1563452056 10.8.22.1 cpu0 80.5",
    "1563452050 10.8.22.1 cpu0 78.4",
    "1563452056 10.8.22.1 cpu0 99.9",
    "1563452056 10.8.22.2 cpu1 20.2",
]


def run(items, **cfg):
    env = tpustream_torch.StreamExecutionEnvironment(
        tpustream_torch.StreamConfig(device="cpu", **cfg))
    text = env.add_source(ReplaySource(items))
    handle = torch_job.build(env, text).collect()
    env.execute("ComputeCpuAvg")
    return handle.items


def test_windowed_avg_golden():
    # all four records land in the same 1-min processing-time window;
    # after ~1 minute the two per-host means appear, then silence
    out = run(LINES + [AdvanceProcessingTime(61_000)])
    assert out == [86.26666666666667, 20.2]
    assert repr(out[0]) == "86.26666666666667"  # Java Double.toString parity


def test_windowed_avg_silence_after_idle_minutes():
    out = run(
        LINES
        + [
            AdvanceProcessingTime(61_000),
            AdvanceProcessingTime(121_000),
            AdvanceProcessingTime(181_000),
        ]
    )
    assert out == [86.26666666666667, 20.2]


def test_windowed_avg_two_windows():
    out = run(
        LINES
        + [
            AdvanceProcessingTime(61_000),
            "1563452056 10.8.22.1 cpu0 10.0",
            "1563452056 10.8.22.1 cpu0 20.0",
            AdvanceProcessingTime(130_000),
        ]
    )
    assert out == [86.26666666666667, 20.2, 15.0]


def test_windowed_avg_batch_size_invariance():
    out = run(LINES + [AdvanceProcessingTime(61_000)], batch_size=1)
    assert out == [86.26666666666667, 20.2]


# -- the program against the JAX package's -------------------------------

class SumOnly:
    """An aggregate whose result reads only the sum: the count leaf is
    dead and is not stored."""

    def create_accumulator(self):
        return (0, 0.0)

    def add(self, value, acc):
        return (acc[0] + 1, acc[1] + value.f1)

    def get_result(self, acc):
        return acc[1] * 2

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])


def _program(pkg, agg, **cfg):
    from importlib import import_module

    plan_mod = import_module(pkg.__name__ + ".runtime.plan")
    step_mod = import_module(pkg.__name__ + ".runtime.step")
    records = import_module(pkg.__name__ + ".records")
    if pkg is tpustream_torch:
        cfg["device"] = "cpu"
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    src = import_module(pkg.__name__ + ".runtime.sources").ReplaySource([])
    job = jax_job if pkg is tpustream else torch_job
    (env.add_source(src).map(job.parse).key_by(0)
     .time_window(pkg.Time.minutes(1)).aggregate(agg).collect())
    plan = plan_mod.build_plan(env, env._sinks)
    plan.record_kinds.extend(["str", "f64"])
    plan.tables.extend([records.StringTable(), None])
    return step_mod.build_program(plan, env.config)


@pytest.mark.parametrize("name", ["avg", "sum_only"])
def test_accumulator_layout_and_liveness_match_the_jax_package(name):
    make = {"avg": lambda job: job.AvgAggregate(), "sum_only": lambda job: SumOnly()}[name]
    want = _program(tpustream, make(jax_job))
    got = _program(tpustream_torch, make(torch_job))
    # the count is I64 and the sum F64, the JAX package's kinds under x64
    assert got.acc_kinds == want.acc_kinds == ["i64", "f64"]
    assert got.result_kinds == want.result_kinds == ["f64"]
    for attr in ("live_idx", "stored_idx", "stored_kinds", "stored_ops",
                 "compact32", "fast_reduce", "key_leaf"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert got.live_idx == ([0, 1] if name == "avg" else [1])


def test_int32_mean_refuses_a_float_scatter_add():
    """The 32-bit configuration of the mean sums a float leaf by a
    scatter-add. The port no longer refuses it: it builds the JAX
    package's layout (an int32 count plane and a float32 sum plane on the
    scatter-reduce path), and the float sum goes through the fixed-order
    merge (ops/ordered_scatter.py) rather than an atomic scatter-add."""
    for dtype in ("int32", "float32"):
        want = _program(tpustream, jax_job.AvgAggregate(), acc_dtype=dtype)
        got = _program(tpustream_torch, torch_job.AvgAggregate(), acc_dtype=dtype)
        for attr in ("stored_ops", "compact32", "fast_reduce"):
            assert getattr(got, attr) == getattr(want, attr), attr
        assert got.fast_reduce and got.stored_ops == ["add", "add"]
        import torch
        assert got.plane_dtypes == [torch.int32, torch.float32]
        assert [str(d) for d in want.plane_dtypes] == ["int32", "float32"]


# -- side by side with the JAX package ----------------------------------

def seeded_items(n, seed):
    """``ts host cpuN usage`` lines from 9 hosts, usage in hundredths, and
    processing-time ticks now and then; with ``ms_per_record=400`` a
    1-minute window holds about 150 lines and a batch of 64 spans two
    windows."""
    rng = np.random.default_rng(seed)
    hosts = rng.integers(0, 9, n)
    usage = rng.integers(0, 10000, n) / 100
    items = []
    for i, (h, u) in enumerate(zip(hosts, usage)):
        items.append(f"{1563452000 + i} 10.8.0.{h} cpu{i % 4} {u}")
        if i % 97 == 96:
            items.append(AdvanceProcessingTime(i * 400 + 30_000))
    return items + [AdvanceProcessingTime(n * 400 + 120_000)]


def _side(pkg, job, sources, items, capsys, **cfg):
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    src = sources.ReplaySource(
        [sources.AdvanceProcessingTime(x.ms) if hasattr(x, "ms") else x
         for x in items], ms_per_record=400)
    stream = job.build(env, env.add_source(src))
    handle = stream.collect()
    stream.print()
    capsys.readouterr()
    env.execute("ComputeCpuAvg")
    m = env.metrics.summary()
    return ([repr(t) for t in handle.items], capsys.readouterr().out,
            {k: m[k] for k in ("window_fires", "late_dropped", "alert_overflow",
                               "evicted_unfired")})


@pytest.mark.parametrize("batch_size", [1, 3, 64])
def test_side_by_side_with_jax_package(batch_size, capsys):
    items = seeded_items(600, seed=batch_size)
    want = _side(tpustream, jax_job, jax_sources, items, capsys,
                 batch_size=batch_size)
    got = _side(tpustream_torch, torch_job, torch_sources, items, capsys,
                device="cpu", batch_size=batch_size)
    assert len(got[0]) > 20
    assert got[0] == want[0]
    assert got[1] == want[1]  # print() bytes
    assert got[2] == want[2]
