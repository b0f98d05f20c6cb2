"""The chapter-3 jobs through the PyTorch port, on the CPU: the golden
transcripts (tests/test_chapter3_golden.py), the randomized window
oracle (tests/test_window_oracle.py), the event-time jump cases
(tests/test_eventtime_jump.py), key-capacity growth, state carried
across from the JAX package, and side-by-side runs against the JAX
package with identical rows and ``print()`` bytes in both ``acc_dtype``
configurations."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpustream
import tpustream.jobs.chapter3_bandwidth_eventtime as jax_et
import tpustream.runtime.sources as jax_sources
import tpustream_torch
import tpustream_torch.jobs.chapter3_bandwidth as torch_pt
import tpustream_torch.jobs.chapter3_bandwidth_eventtime as torch_et
import tpustream_torch.runtime.sources as torch_sources
from tests.test_chapter3_golden import ET_LINES, FLOW_LINES, flink_sliding_event_time_oracle
from tests.test_eventtime_jump import LINES as JUMP_LINES
from tests.test_window_oracle import BASE, oracle
from tpustream_torch.runtime.sources import AdvanceProcessingTime, ReplaySource

CONFIGS = {
    "float64": {},
    # the __graft_entry__ config: 32-bit scatter-add planes, fire budget
    "int32": {"acc_dtype": "int32", "max_fires_per_step": 4},
}


def _env(time_char, **cfg):
    env = tpustream_torch.StreamExecutionEnvironment(
        tpustream_torch.StreamConfig(device="cpu", **cfg))
    env.set_stream_time_characteristic(time_char)
    return env


# -- the golden transcripts (chapter3/README.md:70-81, :283-297) ---------

@pytest.mark.parametrize("sliding,advance", [(False, 61_000), (True, 16_000)])
def test_processing_time_golden(sliding, advance):
    # README.md:80-81: (www.163.com,11200) after ~1 min (tumbling) or
    # ~15 s (sliding)
    env = _env(tpustream_torch.TimeCharacteristic.ProcessingTime)
    text = env.add_source(ReplaySource(FLOW_LINES + [AdvanceProcessingTime(advance)]))
    h = torch_pt.build(env, text, sliding=sliding).collect()
    env.execute("BandwidthMonitor")
    assert [repr(t) for t in h.items] == ["(www.163.com,11200)"]


def run_et(lines, batch_size=1, **cfg):
    env = _env(tpustream_torch.TimeCharacteristic.EventTime, batch_size=batch_size, **cfg)
    h = torch_et.build(env, env.add_source(ReplaySource(lines))).collect()
    env.execute("BandwidthMonitorWithEventTime")
    return list(h.items), env.metrics.summary()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_event_time_sliding_golden(config):
    out, _ = run_et(ET_LINES, **CONFIGS[config])
    values = [t.f1 for t in out]
    assert all(t.f0 == "www.163.com" for t in out)
    assert 0.0012715657552083333 in values
    assert 0.0012969970703125 in values
    assert values == flink_sliding_event_time_oracle(ET_LINES)


def test_event_time_oracle_prefix():
    out, m = run_et(ET_LINES)
    v1, v2, v3 = (s * 8.0 / 60 / 1024 / 1024 for s in (10000, 10100, 10200))
    values = [t.f1 for t in out]
    assert values[:12] == [v1] * 12
    assert values[12:24] == [v2] * 12
    assert values[24:60] == [v3] * 36
    assert m["late_dropped"] == 1 and m["window_fires"] == len(values)


def test_event_time_larger_batch_still_matches_per_batch_watermarks():
    out, m = run_et(ET_LINES, batch_size=64)
    assert len(out) > 0 and all(t.f0 == "www.163.com" for t in out)
    assert m["late_dropped"] == 0


# -- side by side with the JAX package ----------------------------------

def seeded_lines(n, seed):
    """ISO lines over ~35 min: 12 channels, jitter back up to 90 s (past
    the 60 s delay, so some records are late), a 20-minute gap at 2/3
    (the jump sweep), and flows of 1e9 bytes on two channels (filtered)."""
    rng = np.random.default_rng(seed)
    t0 = 1_566_957_600  # 2019-08-28T10:00:00+08:00
    step = rng.integers(0, 3, n).cumsum()
    step[2 * n // 3:] += 1200
    ts = t0 + step - rng.integers(0, 91, n)
    ch = rng.integers(0, 12, n)
    flow = np.where(ch >= 10, 10**9, rng.integers(1, 20_000, n))
    import datetime

    tz = datetime.timezone(datetime.timedelta(hours=8))
    iso = [datetime.datetime.fromtimestamp(int(s), tz).strftime("%Y-%m-%dT%H:%M:%S")
           for s in ts]
    return [f"{i} www.c{c}.com {f}" for i, c, f in zip(iso, ch, flow)]


def _side(pkg, job, sources, lines, capsys, **cfg):
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    env.set_stream_time_characteristic(pkg.TimeCharacteristic.EventTime)
    stream = job.build(env, env.add_source(sources.ReplaySource(lines)))
    handle = stream.collect()
    stream.print()
    capsys.readouterr()
    env.execute("BandwidthMonitorWithEventTime")
    m = env.metrics.summary()
    counters = {k: m[k] for k in ("window_fires", "late_dropped",
                                  "alert_overflow", "evicted_unfired")}
    return [repr(t) for t in handle.items], capsys.readouterr().out, counters


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("batch_size", [1, 3, 64])
@pytest.mark.parametrize("input_name", ["et_lines", "seeded_2k"])
def test_side_by_side_with_jax_package(input_name, batch_size, config, capsys):
    lines = ET_LINES if input_name == "et_lines" else seeded_lines(2000, seed=3)
    cfg = dict(CONFIGS[config], batch_size=batch_size)
    want = _side(tpustream, jax_et, jax_sources, lines, capsys, **cfg)
    got = _side(tpustream_torch, torch_et, torch_sources, lines, capsys,
                device="cpu", **cfg)
    assert len(got[0]) > 0
    assert got[0] == want[0]
    assert got[1] == want[1]  # print() bytes
    assert got[2] == want[2]


# -- the randomized window oracle (tests/test_window_oracle.py) ----------

def build_program_for(size_s, slide_s, delay_s, acc_dtype, key_capacity, batch):
    from tpustream_torch import BoundedOutOfOrdernessTimestampExtractor, Time, Tuple2, Tuple3
    from tpustream_torch.api.windows import SlidingEventTimeWindows
    from tpustream_torch.records import StringTable
    from tpustream_torch.runtime.plan import build_plan
    from tpustream_torch.runtime.step import build_program

    class Ext(BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(Time.seconds(delay_s))

        def extract_timestamp(self, line):
            return int(line.split(" ")[0])

    env = _env(tpustream_torch.TimeCharacteristic.EventTime, batch_size=batch,
               key_capacity=key_capacity, alert_capacity=4096, acc_dtype=acc_dtype)
    (
        env.add_source(ReplaySource([]))
        .assign_timestamps_and_watermarks(Ext())
        .map(lambda l: Tuple3(int(l.split(" ")[0]), l.split(" ")[1], int(l.split(" ")[2])))
        .key_by(1)
        .window(SlidingEventTimeWindows.of(Time.seconds(size_s), Time.seconds(slide_s)))
        .reduce(lambda a, b: Tuple3(a.f0, a.f1, a.f2 + b.f2))
        .map(lambda t: Tuple2(t.f1, t.f2))
        .collect()
    )
    plan = build_plan(env, env._sinks)
    if not plan.record_kinds:
        plan.record_kinds.extend(["i64", "str", "i64"])
        plan.tables.extend([None, StringTable(), None])
    return build_program(plan, env.config)


def _step_rows(prog, state, recs, wm_lower, valid=True):
    ts = torch.tensor([r[0] for r in recs], dtype=torch.int64)
    cols = (ts, torch.tensor([r[1] for r in recs], dtype=torch.int32),
            torch.tensor([r[2] for r in recs], dtype=torch.int64))
    state, em = prog.step(state, cols, torch.full((len(recs),), valid), ts, wm_lower)
    main, rows = em["main"], []
    n = int(main["count"])
    if n:
        kc, sc = (c[:n].tolist() for c in main["cols"])
        rows = list(zip(kc, main["window_end"][:n].tolist(), sc))
    return state, rows


def _oracle_batches(seed):
    rng = np.random.default_rng(seed)
    size_s = int(rng.choice([20, 30, 60]))
    slide_s = int(rng.choice([5, 10]))
    delay_s = int(rng.choice([0, 10, 30]))
    n_keys = int(rng.choice([3, 8, 16]))
    batch, t, batches = 64, BASE, []
    for _ in range(10):
        ts = t + rng.integers(0, 20_000, batch) - rng.integers(0, delay_s * 1000 + 15_000, batch)
        keys = rng.integers(0, n_keys, batch).astype(np.int32)
        flow = rng.integers(1, 1000, batch)
        batches.append(list(zip(ts.tolist(), keys.tolist(), flow.tolist())))
        t += 15_000
    return (size_s, slide_s, delay_s, max(16, n_keys), batch), batches


@pytest.mark.parametrize(
    "seed,acc_dtype",
    [(0, "float64"), (0, "int32"), (1, "float64"), (1, "int32"), (2, "float64")],
)
def test_window_program_matches_oracle(seed, acc_dtype):
    (size_s, slide_s, delay_s, cap, batch), batches = _oracle_batches(seed)
    prog = build_program_for(size_s, slide_s, delay_s, acc_dtype, cap, batch)
    assert prog.fast_reduce == (acc_dtype == "int32")
    state, got = prog.init_state(), []
    for b in batches:
        state, rows = _step_rows(prog, state, b, -(2**62))
        got += rows
    state, rows = _step_rows(prog, state, [(0, 0, 0)] * batch, 2**62, valid=False)
    got += rows
    assert sorted(got) == oracle(batches, size_s * 1000, slide_s * 1000, delay_s * 1000)


def _jax_feed(jstep, jstate, recs, wm_lower, valid):
    ts = jnp.asarray([r[0] for r in recs], jnp.int64)
    cols = (ts, jnp.asarray([r[1] for r in recs], jnp.int32),
            jnp.asarray([r[2] for r in recs], jnp.int64))
    jstate, em = jstep(jstate, cols, jnp.full(len(recs), valid, bool), ts,
                       jnp.asarray(wm_lower, jnp.int64))
    m = np.asarray(em["main"]["mask"])
    kc, sc = (np.asarray(c) for c in em["main"]["cols"])
    ec = np.asarray(em["main"]["window_end"])
    return jstate, [(int(kc[j]), int(ec[j]), int(sc[j])) for j in np.nonzero(m)[0]]


@pytest.mark.parametrize("acc_dtype", ["float64", "int32"])
def test_state_carried_across_from_the_jax_package(acc_dtype):
    """The JAX package runs k steps; its state (numpy) moves into the
    port, which runs the rest: the rows equal the JAX package's full run,
    in order."""
    from tests.test_window_oracle import build_program_for as jax_program_for

    (size_s, slide_s, delay_s, cap, batch), batches = _oracle_batches(1)
    k = 6
    feeds = [(b, -(2**62), True) for b in batches]
    feeds.append(([(0, 0, 0)] * batch, 2**62, False))  # end of stream
    jprog, _ = jax_program_for(size_s, slide_s, delay_s, acc_dtype, cap, batch)
    jstep = jax.jit(jprog._step)
    jstate, want, got = jprog.init_state(), [], []
    for i, feed in enumerate(feeds):
        if i == k:
            carried = jax.device_get(jstate)
        jstate, rows = _jax_feed(jstep, jstate, *feed)
        want += rows
        if i < k:
            got += rows
    prog = build_program_for(size_s, slide_s, delay_s, acc_dtype, cap, batch)
    state = prog.state_from_jax_numpy(carried)
    for feed in feeds[k:]:
        state, rows = _step_rows(prog, state, *feed)
        got += rows
    assert len(want) > len(got[:0]) + 10 and got == want


# -- event-time jumps (tests/test_eventtime_jump.py, one device) ---------

def _jump(batch_size):
    out, m = run_et(JUMP_LINES, batch_size=batch_size)
    sums = collections.Counter(round(t.f1 * 60 * 1024 * 1024 / 8) for t in out)
    return dict(sums), m


def test_jump_single_batch_exact_windows():
    sums, m = _jump(8)
    assert sums == {9999: 24, 10999: 12, 12999: 12, 15999: 12, 6000: 24,
                    5000: 72, 3000: 12}
    assert m["evicted_unfired"] == 0 and m["late_dropped"] == 0


def test_jump_per_record_batches_exact_windows():
    sums, m = _jump(1)
    assert sums == {1000: 12, 12999: 12, 15999: 12, 6000: 24, 5000: 72, 3000: 12}
    assert m["evicted_unfired"] == 0 and m["late_dropped"] == 0


# -- key-capacity growth --------------------------------------------------

GROWTH_LINES = [f"{1000 + i * 250} key{(i * 7) % 40} {(i % 9) + 1}" for i in range(120)]


def _growth(pkg, sources, **cfg):
    class Ts(pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(pkg.Time.milliseconds(1000))

        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

    env = pkg.StreamExecutionEnvironment(
        pkg.StreamConfig(batch_size=8, strict_overflow=True, **cfg))
    env.set_stream_time_characteristic(pkg.TimeCharacteristic.EventTime)
    h = (
        env.add_source(sources.ReplaySource(GROWTH_LINES))
        .assign_timestamps_and_watermarks(Ts())
        .map(lambda l: pkg.Tuple2(l.split(" ")[1], int(l.split(" ")[2])))
        .key_by(0)
        .time_window(pkg.Time.seconds(6))
        .reduce(lambda a, b: pkg.Tuple2(a.f0, a.f1 + b.f1))
        .collect()
    )
    env.execute("growth")
    return [repr(t) for t in h.items]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_key_capacity_growth_equals_the_jax_package(config):
    want = _growth(tpustream, jax_sources, key_capacity=64, **CONFIGS[config])
    got = _growth(tpustream_torch, torch_sources, key_capacity=4, device="cpu",
                  **CONFIGS[config])
    assert len(want) > 40 and got == want


# -- what this slice leaves out refuses by name ---------------------------

def test_unported_window_features_raise():
    """``acc_dtype="float32"`` runs since the 32-bit accumulators are
    ported: the flagship and a session job give the JAX package's rows.
    ``parallelism > 1`` runs since the sharded programs are ported: the
    session job at ``parallelism=2`` gives the JAX package's rows at 2."""
    T = tpustream_torch
    import tpustream.api.windows as jax_windows
    import tpustream_torch.api.windows as torch_windows

    def job(**cfg):
        env = _env(T.TimeCharacteristic.EventTime, **cfg)
        return env, env.add_source(ReplaySource(ET_LINES))

    def jax_env(**cfg):
        jenv = tpustream.StreamExecutionEnvironment(tpustream.StreamConfig(**cfg))
        jenv.set_stream_time_characteristic(tpustream.TimeCharacteristic.EventTime)
        return jenv, jenv.add_source(jax_sources.ReplaySource(ET_LINES))

    env, text = job(acc_dtype="float32")
    h = torch_et.build(env, text).collect()
    env.execute("x")
    jenv, jtext = jax_env(acc_dtype="float32")
    jh = jax_et.build(jenv, jtext).collect()
    jenv.execute("x")
    assert h.items and [repr(t) for t in h.items] == [repr(t) for t in jh.items]

    def sessions(pkg, et, windows, text):
        return (text.assign_timestamps_and_watermarks(
                    et.IsoTimestampExtractor(pkg.Time.minutes(1)))
                .map(et.parse).key_by(1)
                .window(windows.EventTimeSessionWindows.with_gap(pkg.Time.minutes(5)))
                .reduce(lambda a, b: pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2)))

    env, text = job(acc_dtype="float32")
    h = sessions(T, torch_et, torch_windows, text).collect()
    env.execute("x")
    jenv, jtext = jax_env(acc_dtype="float32")
    jh = sessions(tpustream, jax_et, jax_windows, jtext).collect()
    jenv.execute("x")
    assert h.items and [repr(t) for t in h.items] == [repr(t) for t in jh.items]

    def sessions_port(text):
        return sessions(T, torch_et, torch_windows, text)

    env, text = job(parallelism=2)
    h = sessions_port(text).collect()
    env.execute("x")
    jenv, jtext = jax_env(parallelism=2)
    jh = sessions(tpustream, jax_et, jax_windows, jtext).collect()
    jenv.execute("x")
    assert h.items and [repr(t) for t in h.items] == [repr(t) for t in jh.items]

    # chained stages run since the chain glue is ported: the same
    # two-stage job gives the JAX package's rows

    def chained(pkg, et, windows, env, sources):
        text = env.add_source(sources.ReplaySource(ET_LINES))
        h = (text.assign_timestamps_and_watermarks(
                 et.IsoTimestampExtractor(pkg.Time.minutes(1)))
             .map(et.parse).key_by(1)
             .window(windows.EventTimeSessionWindows.with_gap(pkg.Time.minutes(5)))
             .reduce(lambda a, b: pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
             .key_by(1).count_window(1)
             .reduce(lambda a, b: pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2)).collect())
        env.execute("x")
        return [repr(t) for t in h.items]

    jenv = tpustream.StreamExecutionEnvironment(tpustream.StreamConfig())
    jenv.set_stream_time_characteristic(tpustream.TimeCharacteristic.EventTime)
    want = chained(tpustream, jax_et, jax_windows, jenv, jax_sources)
    env = _env(T.TimeCharacteristic.EventTime)
    got = chained(T, torch_et, torch_windows, env, torch_sources)
    assert want and got == want
