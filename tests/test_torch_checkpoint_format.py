"""The snapshot format across the two packages: a snapshot written by the
JAX package restores in the PyTorch port, and one written by the port
restores in the JAX package.

For each program family (rolling f64, rolling i64, ``max_by``, stateless,
window exact, window int32, full-window ``process()``, session ``reduce``,
session ``process()``, count tumbling, count sliding, count
``process()``, CEP, a rule-bearing job, a two-stage chain, and the
32-bit accumulator layouts: rolling f64 under float32 and i64 under
int32, the flagship window and the chapter-2 mean under float32), the same
seeded input goes through both packages with a checkpoint after every
batch. Then, for one mid-stream snapshot of each:

* the leaf lists are equal in count, order, dtype, shape and bytes;
* the meta is equal apart from ``session`` and timings;
* the JAX package's snapshot restored by the port, and the port's
  restored by the JAX package, each emit the reference's remaining
  output (the rows after the snapshot's ``emitted``);
* the port's ``state_to_jax_numpy`` is the exact inverse of its
  ``state_from_jax_numpy`` on the JAX package's state.

Tolerance: bitwise everywhere. Runs on the CPU (``device="cpu"``).
"""

import glob
import os
import types

import numpy as np
import pytest

import tpustream
import tpustream.api.windows as jax_windows
import tpustream.runtime.checkpoint as jax_ckpt
import tpustream.runtime.sources as jax_sources
import tpustream_torch
import tpustream_torch.api.windows as torch_windows
import tpustream_torch.runtime.checkpoint as torch_ckpt
import tpustream_torch.runtime.sources as torch_sources

pytestmark = pytest.mark.fresh_cache

PKGS = {
    "jax": types.SimpleNamespace(pkg=tpustream, sources=jax_sources,
                                 windows=jax_windows, ckpt=jax_ckpt, cfg={}),
    "torch": types.SimpleNamespace(pkg=tpustream_torch, sources=torch_sources,
                                   windows=torch_windows, ckpt=torch_ckpt,
                                   cfg={"device": "cpu"}),
}


def _ts(ns, delay_ms=2000):
    class Ts(ns.pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(ns.pkg.Time.milliseconds(delay_ms))

        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

    return Ts()


def _kv(ns):
    return lambda l: ns.pkg.Tuple2(l.split(" ")[1], int(l.split(" ")[2]))


def _add(ns):
    return lambda a, b: ns.pkg.Tuple2(a.f0, a.f1 + b.f1)


def _median(ns):
    def median(key, ctx, elements, out):
        vals = sorted(e.f1 for e in elements)
        out.collect(ns.pkg.Tuple2(key, float(vals[len(vals) // 2])))
    return median


def _job(ns, name):
    return __import__(f"{ns.pkg.__name__}.jobs.{name}", fromlist=["build"])


# -- the families: (build(ns, env, text) -> [streams], lines (or a function
# of the package giving them), event time, extra StreamConfig) -------------

CH1 = [f"15634520{i % 60:02d} 10.8.22.{i % 5} cpu{i % 3} {(i * 37) % 100}.5"
       for i in range(24)]
KV = [f"{1000 + 700 * i} k{(i * 7) % 5} {i % 9 + 1}" for i in range(24)]
ISO = [f"2019-08-28T10:{m:02d}:{s:02d} www.ch{(m * 7 + s) % 5}.com {100 + m * 10 + s}"
       for m in range(8) for s in (0, 20, 40)]
CEP = [f"2019-08-28T10:{i // 6:02d}:{(i % 6) * 10:02d} www.c{i % 2}.com "
       f"{6000 + i if i % 5 != 4 else 100}" for i in range(24)]


def _ticked(ns):
    """CH1 with two processing-time minutes passing (the windows fire)."""
    tick = ns.sources.AdvanceProcessingTime
    return CH1[:12] + [tick(61_000)] + CH1[12:] + [tick(122_000)]


def _rolling_f64(ns, env, text):
    return [_job(ns, "chapter2_max").build(env, text)]


def _rolling_i64(ns, env, text):
    return [text.map(_kv(ns)).key_by(0).max(1)]


def _max_by(ns, env, text):
    return [text.map(_kv(ns)).key_by(0).max_by(1)]


def _stateless(ns, env, text):
    return [_job(ns, "chapter1_threshold").build(env, text)]


def _window(ns, env, text):
    return [_job(ns, "chapter3_bandwidth_eventtime").build(env, text)]


def _process(ns, env, text):
    return [_job(ns, "chapter2_median").build(env, text)]


def _avg(ns, env, text):
    return [_job(ns, "chapter2_avg").build(env, text)]


def _session_reduce(ns, env, text):
    w = ns.windows.EventTimeSessionWindows.with_gap(ns.pkg.Time.milliseconds(2500))
    return [text.assign_timestamps_and_watermarks(_ts(ns)).map(_kv(ns))
            .key_by(0).window(w).reduce(_add(ns))]


def _session_process(ns, env, text):
    w = ns.windows.EventTimeSessionWindows.with_gap(ns.pkg.Time.milliseconds(2500))
    return [text.assign_timestamps_and_watermarks(_ts(ns)).map(_kv(ns))
            .key_by(0).window(w).process(_median(ns))]


def _count_tumbling(ns, env, text):
    return [text.map(_kv(ns)).key_by(0).count_window(3).reduce(_add(ns))]


def _count_sliding(ns, env, text):
    return [text.map(_kv(ns)).key_by(0).count_window(4, 2).reduce(_add(ns))]


def _count_process(ns, env, text):
    return [text.map(_kv(ns)).key_by(0).count_window(4, 2).process(_median(ns))]


def _cep(ns, env, text):
    tag = ns.pkg.OutputTag("breach-timeout")
    alerts = _job(ns, "chapter4_cep_alert").build(env, text, timeout_tag=tag)
    return [alerts, alerts.get_side_output(tag)]


def _rules(ns, env, text):
    ch5 = _job(ns, "chapter5_dynamic_rules")
    rules = ch5.make_rules()
    ctrl = env.add_source(ns.sources.ReplaySource(
        ch5.control_lines([(5, 40.0), (13, 70.0)])))
    return [ch5.build(env, text, ctrl, rules)]


def _chain(ns, env, text):
    return [text.assign_timestamps_and_watermarks(_ts(ns)).map(_kv(ns))
            .key_by(0).time_window(ns.pkg.Time.seconds(5)).reduce(_add(ns))
            .key_by(lambda r: r.f0[:1])
            .time_window(ns.pkg.Time.seconds(15)).reduce(_add(ns))]


FAMILIES = {
    "rolling_f64": (_rolling_f64, CH1, False, {}),
    "rolling_i64": (_rolling_i64, KV, False, {}),
    "max_by": (_max_by, KV, False, {}),
    "stateless": (_stateless, CH1, False, {}),
    "window_exact": (_window, ISO, True, {}),
    "window_int32": (_window, ISO, True, {"acc_dtype": "int32"}),
    "process": (_process, _ticked, False, {}),
    "session_reduce": (_session_reduce, KV, True, {}),
    "session_process": (_session_process, KV, True, {}),
    "count_tumbling": (_count_tumbling, KV, False, {}),
    "count_sliding": (_count_sliding, KV, False, {}),
    "count_process": (_count_process, KV, False, {}),
    "cep": (_cep, CEP, True, {}),
    "rules": (_rules, CH1, False, {}),
    "chain": (_chain, KV, True, {}),
    "rolling_f64_float32": (_rolling_f64, CH1, False, {"acc_dtype": "float32"}),
    "rolling_i64_int32": (_rolling_i64, KV, False, {"acc_dtype": "int32"}),
    "window_float32": (_window, ISO, True, {"acc_dtype": "float32"}),
    "avg_float32": (_avg, _ticked, False, {"acc_dtype": "float32"}),
}


def run(side, family, ckdir=None, restore=None):
    """``family``'s job through one package: the repr of each collected
    row, one list a sink. ``ckdir``: a checkpoint after every batch,
    every one kept; ``restore``: resume from that snapshot."""
    build, lines, event_time, extra = FAMILIES[family]
    ns = PKGS[side]
    lines = lines(ns) if callable(lines) else lines
    cfg = ns.pkg.StreamConfig(batch_size=4, key_capacity=16, **extra, **ns.cfg)
    if ckdir is not None:
        cfg = cfg.replace(checkpoint_dir=str(ckdir), checkpoint_interval_batches=1,
                          checkpoint_keep=1000)
    env = ns.pkg.StreamExecutionEnvironment(cfg)
    if event_time:
        env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    if restore is not None:
        env.restore_from_checkpoint(restore)
    handles = [s.collect() for s in
               build(ns, env, env.add_source(ns.sources.ReplaySource(lines)))]
    env.execute("format")
    return [[repr(t) for t in h.items] for h in handles]


def mid_snapshot(ckdir):
    names = sorted(glob.glob(os.path.join(str(ckdir), "ckpt-*.npz")))
    assert len(names) >= 3
    return names[len(names) // 2]


def suffix(full, meta):
    return [rows[n:] for rows, n in zip(full, meta["sink_counts"])]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """family -> (JAX output, JAX snapshot, port output, port snapshot),
    each package's snapshots in its own directory; built on first use."""
    cache = {}

    def get(family):
        if family not in cache:
            base = tmp_path_factory.mktemp(family)
            full = run("jax", family, ckdir=base / "jax")
            got = run("torch", family, ckdir=base / "torch")
            assert got == full and any(full)
            snap = mid_snapshot(base / "jax")
            port_snap = os.path.join(str(base / "torch"), os.path.basename(snap))
            cache[family] = (full, snap, port_snap)
        return cache[family]

    return get


@pytest.mark.parametrize("family", list(FAMILIES))
def test_leaves_and_meta_equal(written, family):
    """The same cut written by both packages: equal leaf lists (count,
    order, dtype, shape, bytes) and equal meta but for the session."""
    _, snap, port_snap = written(family)
    meta, leaves = jax_ckpt._read_npz(snap)
    pmeta, pleaves = torch_ckpt._read_npz(port_snap)
    assert len(pleaves) == len(leaves)
    for i, (a, b) in enumerate(zip(leaves, pleaves)):
        assert (b.dtype, b.shape) == (a.dtype, a.shape), i
        assert a.tobytes() == b.tobytes(), i
    for m in (meta, pmeta):
        m.pop("session")
    assert pmeta == meta


@pytest.mark.parametrize("family", list(FAMILIES))
def test_snapshots_restore_across_packages(written, family):
    """A JAX snapshot restored by the port, and a port snapshot restored
    by the JAX package, each emit the reference's remaining rows."""
    full, snap, port_snap = written(family)
    want = suffix(full, jax_ckpt._read_meta(snap))
    assert run("torch", family, restore=snap) == want
    assert run("jax", family, restore=port_snap) == want


@pytest.mark.parametrize("family", list(FAMILIES))
def test_state_conversion_is_the_inverse(written, family):
    """``state_to_jax_numpy`` after ``state_from_jax_numpy`` gives the
    JAX package's leaves back, bit for bit, for every stage."""
    from tpustream_torch.runtime.executor import _restore
    from tpustream_torch.runtime.metrics import Metrics
    from tpustream_torch.runtime.plan import build_plan_chain
    from tpustream_torch.utils.tree import tree_leaves

    _, snap, _ = written(family)
    build, lines, event_time, extra = FAMILIES[family]
    ns = PKGS["torch"]
    lines = lines(ns) if callable(lines) else lines
    cfg = ns.pkg.StreamConfig(batch_size=4, key_capacity=16, **extra, **ns.cfg)
    env = ns.pkg.StreamExecutionEnvironment(cfg)
    if event_time:
        env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    for s in build(ns, env, env.add_source(ns.sources.ReplaySource(lines))):
        s.collect()
    plans = build_plan_chain(env, env._sinks)
    runner, _ = _restore(env, snap, plans, cfg, Metrics(), Metrics().job_obs,
                         env._sinks, None, None)
    got = [l for r in runner.chain()
           for l in tree_leaves(r.program.state_to_jax_numpy(r.state))]
    _, want = jax_ckpt._read_npz(snap)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert (b.dtype, b.shape) == (a.dtype, a.shape)
        assert a.tobytes() == b.tobytes()
