"""The chapter-2 windowed median (full-window ``process()``) through the
PyTorch port, on the CPU: the reference golden transcripts
(tests/test_chapter2_median_golden.py), side-by-side runs against the
JAX package on seeded inputs (rows and ``print()`` bytes, tolerance:
bitwise), the elements' (pane, arrival) order on sliding event-time
windows, and process state carried across from the JAX package."""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpustream
import tpustream.jobs.chapter2_median as jax_job
import tpustream.runtime.sources as jax_sources
import tpustream_torch
import tpustream_torch.jobs.chapter2_median as torch_job
import tpustream_torch.runtime.sources as torch_sources
from tests.test_torch_aggregate import seeded_items
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
    env.execute("ComputeCpuMiddle")
    return handle.items


def test_windowed_median_golden():
    out = run(LINES + [AdvanceProcessingTime(61_000)])
    assert out == [80.5, 20.2]


def test_windowed_median_even_count():
    out = run(
        [
            "1 h1 cpu0 1.0",
            "1 h1 cpu0 2.0",
            "1 h1 cpu0 10.0",
            "1 h1 cpu0 4.0",
            AdvanceProcessingTime(61_000),
        ]
    )
    # sorted [1,2,4,10] -> (2+4)/2
    assert out == [3.0]


def test_windowed_median_batch_invariance():
    out = run(LINES + [AdvanceProcessingTime(61_000)], batch_size=1)
    assert out == [80.5, 20.2]


def test_buffer_overflow_is_counted():
    # four elements into a 3-element buffer: the fourth is counted, the
    # window sees the first three
    items = ["1 h1 cpu0 1.0", "1 h1 cpu0 2.0", "1 h1 cpu0 10.0", "1 h1 cpu0 4.0",
             AdvanceProcessingTime(61_000)]
    env = tpustream_torch.StreamExecutionEnvironment(tpustream_torch.StreamConfig(
        device="cpu", process_buffer_capacity=3))
    h = torch_job.build(env, env.add_source(ReplaySource(items))).collect()
    env.execute("ComputeCpuMiddle")
    assert h.items == [2.0]
    assert env.metrics.buffer_overflow == 1
    env = tpustream_torch.StreamExecutionEnvironment(tpustream_torch.StreamConfig(
        device="cpu", process_buffer_capacity=3, strict_overflow=True))
    torch_job.build(env, env.add_source(ReplaySource(items))).collect()
    with pytest.raises(RuntimeError, match="buffer_overflow"):
        env.execute("ComputeCpuMiddle")


# -- side by side with the JAX package ----------------------------------

def _side(pkg, job, sources, items, capsys, **cfg):
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    src = sources.ReplaySource(
        [sources.AdvanceProcessingTime(x.ms) if hasattr(x, "ms") else x
         for x in items], ms_per_record=400)
    stream = job.build(env, env.add_source(src))
    handle = stream.collect()
    stream.print()
    capsys.readouterr()
    env.execute("ComputeCpuMiddle")
    m = env.metrics.summary()
    return ([repr(t) for t in handle.items], capsys.readouterr().out,
            {k: m[k] for k in ("window_fires", "late_dropped", "buffer_overflow",
                               "evicted_unfired", "records_emitted")})


@pytest.mark.parametrize("batch_size", [1, 3, 64])
def test_side_by_side_with_jax_package(batch_size, capsys):
    items = seeded_items(600, seed=10 + batch_size)
    want = _side(tpustream, jax_job, jax_sources, items, capsys,
                 batch_size=batch_size)
    got = _side(tpustream_torch, torch_job, torch_sources, items, capsys,
                device="cpu", batch_size=batch_size)
    assert len(got[0]) > 20
    assert got[0] == want[0]
    assert got[1] == want[1]  # print() bytes
    assert got[2] == want[2]


# -- sliding event-time windows: the elements' order ---------------------

BASE = 1_200_000  # epoch seconds, a multiple of 60


def _ordered_lines(n, seed):
    """``sec key value`` lines over about six minutes, out of order by up
    to 20 s, 5 keys, distinct values."""
    rng = np.random.default_rng(seed)
    ts = BASE + np.arange(n) * 360 // n - rng.integers(0, 21, n)
    keys = rng.integers(0, 5, n)
    return [f"{t} k{k} {i}" for i, (t, k) in enumerate(zip(ts, keys))]


def _list_job(pkg, env, text):
    """Per key and sliding window (60 s every 20 s), the window's bounds
    and its elements' values in the order process() receives them."""

    class Ext(pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(pkg.Time.seconds(30))

        def extract_timestamp(self, line):
            return int(line.split(" ")[0]) * 1000

    class Lister:
        def process(self, key, context, elements, out):
            vals = "/".join(str(e.f2) for e in elements)
            out.collect(pkg.Tuple3(key, context.end, vals))

    def parse(line):
        p = line.split(" ")
        return pkg.Tuple3(int(p[0]), p[1], int(p[2]))

    return (text.assign_timestamps_and_watermarks(Ext()).map(parse).key_by(1)
            .time_window(pkg.Time.seconds(60), pkg.Time.seconds(20))
            .process(Lister()))


def _run_list_job(pkg, lines, **cfg):
    sources = import_module(pkg.__name__ + ".runtime.sources")
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    env.set_stream_time_characteristic(pkg.TimeCharacteristic.EventTime)
    h = _list_job(pkg, env, env.add_source(sources.ReplaySource(lines))).collect()
    env.execute("lister")
    return [repr(t) for t in h.items], env.metrics.summary()["late_dropped"]


@pytest.mark.parametrize("batch_size", [1, 16])
def test_sliding_window_elements_in_pane_then_arrival_order(batch_size):
    lines = _ordered_lines(300, seed=batch_size)
    want = _run_list_job(tpustream, lines, batch_size=batch_size)
    got = _run_list_job(tpustream_torch, lines, batch_size=batch_size,
                        device="cpu")
    assert len(got[0]) > 30 and got == want


# -- state carried across from the JAX package ---------------------------

def _program(pkg, batch, key_capacity):
    plan_mod = import_module(pkg.__name__ + ".runtime.plan")
    step_mod = import_module(pkg.__name__ + ".runtime.step")
    records = import_module(pkg.__name__ + ".records")
    sources = import_module(pkg.__name__ + ".runtime.sources")
    cfg = dict(batch_size=batch, key_capacity=key_capacity,
               process_buffer_capacity=16)
    if pkg is tpustream_torch:
        cfg["device"] = "cpu"
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    env.set_stream_time_characteristic(pkg.TimeCharacteristic.EventTime)
    _list_job(pkg, env, env.add_source(sources.ReplaySource([]))).collect()
    plan = plan_mod.build_plan(env, env._sinks)
    plan.record_kinds.extend(["i64", "str", "i64"])
    plan.tables.extend([None, records.StringTable(), None])
    return step_mod.build_program(plan, env.config), plan


def _feeds(batch):
    rng = np.random.default_rng(5)
    feeds, t = [], BASE * 1000
    for _ in range(8):
        ts = t + rng.integers(0, 20_000, batch) - rng.integers(0, 25_000, batch)
        keys = rng.integers(0, 6, batch)
        vals = rng.integers(0, 1000, batch)
        feeds.append((ts, keys, vals, True, -(2**62)))
        t += 15_000
    feeds.append((np.zeros(batch, np.int64), np.zeros(batch, np.int64),
                  np.zeros(batch, np.int64), False, 2**62))  # end of stream
    return feeds


def test_process_state_carried_across_from_the_jax_package():
    """The JAX package runs k steps; its process state (element buffers,
    counts, ring metadata) moves into the port, which runs the rest: the
    rows equal the JAX package's full run, in order."""
    batch, kcap, k = 32, 8, 5
    jprog, jplan = _program(tpustream, batch, kcap)
    tprog, tplan = _program(tpustream_torch, batch, kcap)
    for key in range(6):  # the key column's ids are the interned ids
        jplan.tables[1].intern(f"k{key}")
        tplan.tables[1].intern(f"k{key}")
    jstep = jax.jit(jprog._step)
    jstate, want, got, carried = jprog.init_state(), [], [], None

    def jax_emit(rows):
        return lambda item, subtask, ts=None, order=None: rows.append(repr(item))

    for i, (ts, keys, vals, valid, wm_lower) in enumerate(_feeds(batch)):
        if i == k:
            carried = jax.device_get(jstate)
        cols = (jnp.asarray(ts // 1000), jnp.asarray(keys, jnp.int32), jnp.asarray(vals))
        jstate, em = jstep(jstate, cols, jnp.full(batch, valid), jnp.asarray(ts),
                           jnp.asarray(wm_lower, jnp.int64))
        rows = []
        jprog.evaluate_fires(jstate, em["process_fire"], jplan.device_post, jax_emit(rows))
        want += rows
        if i < k:
            got += rows
    state = tprog.state_from_jax_numpy(carried)
    fetch = lambda ts: [t.numpy() for t in ts]  # noqa: E731
    for ts, keys, vals, valid, wm_lower in _feeds(batch)[k:]:
        cols = (torch.from_numpy(ts // 1000), torch.from_numpy(keys).to(torch.int32),
                torch.from_numpy(vals))
        state, em = tprog.step(state, cols, torch.full((batch,), valid),
                               torch.from_numpy(ts), wm_lower)
        if "process_fire" in em:
            tprog.evaluate_fires(state, em["process_fire"],
                                 lambda item, subtask, *_: got.append(repr(item)), fetch)
    assert len(want) > 20 and got == want
