"""CEP pattern matching (chapter 4) through the PyTorch port, on the CPU.

* The single-device cases of the JAX package's suite
  (tests/test_cep.py, all 14 tests; the p=8 half of the chapter-4 test
  is left out), run through the port with ``device="cpu"`` against the
  same inputs and the port's copy of the host NFA oracle
  (``tpustream_torch/cep/oracle.py``).
* Side-by-side runs against the JAX package on seeded inputs at batch
  sizes 1, 2, 7 and 64: match rows, timeout rows, late rows, ``print()``
  bytes and the ``cep_*``/``late_dropped`` counters (tolerance:
  bitwise).
* The two ``compile_pattern``s equal over a seeded set of patterns, and
  a seeded fuzz of those patterns, port against JAX.
* Key growth past the initial capacity, and the JAX package's state
  carried into the port mid-stream (``state_from_jax_numpy``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpustream
import tpustream.runtime.plan as jax_plan
import tpustream.runtime.sources as jax_sources
import tpustream.runtime.step as jax_step
import tpustream_torch as T
import tpustream_torch.runtime.plan as torch_plan
import tpustream_torch.runtime.sources as torch_sources
import tpustream_torch.runtime.step as torch_step
from tests.test_cep import flat_matches, lines_of, timeout_rows
from tpustream.cep import compile_pattern as jax_compile_pattern
from tpustream.cep import run_oracle as jax_run_oracle
from tpustream.javacompat import Long as JLong
from tpustream_torch.cep import compile_pattern, run_oracle
from tpustream_torch.javacompat import Long
from tpustream_torch.runtime.sources import ReplaySource

PKGS = {
    "jax": types.SimpleNamespace(pkg=tpustream, sources=jax_sources,
                                 plan=jax_plan, step=jax_step, long=JLong,
                                 cfg={}),
    "torch": types.SimpleNamespace(pkg=T, sources=torch_sources,
                                   plan=torch_plan, step=torch_step, long=Long,
                                   cfg={"device": "cpu"}),
}


def extractor(ns, delay_ms=0):
    class SecondExtractor(ns.pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(ns.pkg.Time.milliseconds(delay_ms))

        def extract_timestamp(self, element):
            return ns.long.parseLong(element.split(" ")[0]) * 1000

    return SecondExtractor()


def parser(ns):
    def parse(s):
        items = s.split(" ")
        return ns.pkg.Tuple3(ns.long.parseLong(items[0]), items[1],
                             ns.long.parseLong(items[2]))

    return parse


def run_cep(events, pattern, select_fn=None, batch_size=2, delay=None,
            allowed_lateness=None, late_tag=None, timeout_tag=None, **cfg):
    """tests/test_cep.py's ``run_cep`` through the port on the CPU."""
    env = T.StreamExecutionEnvironment(
        T.StreamConfig(batch_size=batch_size, device="cpu", **cfg))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    text = env.add_source(ReplaySource(lines_of(events)))
    delay_ms = delay.to_milliseconds() if delay is not None else 0
    keyed = (text.assign_timestamps_and_watermarks(extractor(PKGS["torch"], delay_ms))
             .map(parser(PKGS["torch"])).key_by(1))
    ps = T.CEP.pattern(keyed, pattern)
    if allowed_lateness is not None:
        ps = ps.allowed_lateness(allowed_lateness)
    if late_tag is not None:
        ps = ps.side_output_late_data(late_tag)
    result = ps.select(select_fn, timeout_tag=timeout_tag)
    h = result.collect()
    ht = result.get_side_output(timeout_tag).collect() if timeout_tag else None
    hl = result.get_side_output(late_tag).collect() if late_tag else None
    env.execute("cep-test")
    return (h.items, ht.items if ht else [], hl.items if hl else [],
            env.metrics.summary())


def oracle_for(events, pattern, batch_size=2, delay_ms=0, allowed_lateness_ms=0):
    recs = [((t, ch, v), t * 1000) for t, ch, v in events]
    batches = [recs[i:i + batch_size] for i in range(0, len(recs), batch_size)]
    return run_oracle(pattern, batches, delay_ms=delay_ms,
                      allowed_lateness_ms=allowed_lateness_ms)


# ---------------------------------------------------------------------------
# tests/test_cep.py, single device
# ---------------------------------------------------------------------------


def test_pattern_builder_validation():
    with pytest.raises(ValueError, match="must be >= 1"):
        T.Pattern.begin("a").times(0)
    with pytest.raises(ValueError, match="positive"):
        T.Pattern.begin("a").within(0)
    with pytest.raises(ValueError, match="empty pattern"):
        compile_pattern(T.Pattern())
    with pytest.raises(ValueError, match="duplicate stage names"):
        compile_pattern(T.Pattern.begin("a").followed_by("a"))
    with pytest.raises(ValueError, match="plain filter"):
        compile_pattern(T.Pattern.begin("only"))
    with pytest.raises(ValueError, match="where"):
        T.Pattern().where(lambda r: True)


def test_compile_expands_times_and_strictness():
    p = (T.Pattern.begin("a").next("b").times(3).consecutive()
         .followed_by("c").within(T.Time.seconds(5)))
    cp = compile_pattern(p)
    assert cp.length == 5
    assert list(cp.stage_of) == [0, 1, 1, 1, 2]
    assert list(cp.strict) == [False, True, True, True, False]
    assert cp.within_ms == 5000
    t = cp.transition_table()
    assert t.shape == (6, 2)
    assert list(t[:, 1]) == [1, 2, 3, 4, 5, 5]
    assert list(t[:, 0]) == [0, -1, -1, -1, 4, 5]


def rel2():
    return (T.Pattern.begin("a").where(lambda r: r.f2 > 10)
            .followed_by("b").where(lambda r: r.f2 > 10))


def test_relaxed_skips_nonmatching_events():
    events = [(0, "k", 20), (1, "k", 5), (2, "k", 30), (3, "k", 40)]
    out, _, _, summ = run_cep(events, rel2())
    m, _, _ = oracle_for(events, rel2())
    assert out == flat_matches(m)
    assert [r[5] for r in out] == [30, 40]
    assert summ["cep_matches"] == 2 and summ["cep_timeouts"] == 0


def test_strict_next_kills_broken_runs():
    def strict():
        return (T.Pattern.begin("a").where(lambda r: r.f2 > 10)
                .next("b").where(lambda r: r.f2 > 10))

    events = [(0, "k", 20), (1, "k", 5), (2, "k", 30), (3, "k", 40)]
    out, _, _, _ = run_cep(events, strict())
    m, _, _ = oracle_for(events, strict())
    assert out == flat_matches(m)
    assert len(out) == 1 and out[0][2] == 30 and out[0][5] == 40


def test_times_overlapping_partials_match_oracle():
    def p():
        return T.Pattern.begin("a").where(lambda r: r.f2 > 10).times(3)

    events = [(0, "k", 20), (1, "k", 21), (2, "k", 5), (3, "k", 22),
              (4, "k", 23), (5, "k", 24)]
    out, _, _, _ = run_cep(events, p())
    m, _, _ = oracle_for(events, p())
    assert out == flat_matches(m)
    assert [(r[2], r[5], r[8]) for r in out] == [
        (20, 21, 22), (21, 22, 23), (22, 23, 24)]


def test_within_timeout_exactly_at_watermark_boundary():
    def p():
        return (T.Pattern.begin("a").where(lambda r: r.f2 > 10)
                .followed_by("b").where(lambda r: r.f2 > 10)
                .within(T.Time.seconds(10)))

    tag = T.OutputTag("to")
    events = [(0, "k", 20), (10, "k", 30)]
    out, tmo, _, summ = run_cep(events, p(), batch_size=1, timeout_tag=tag)
    m, t, _ = oracle_for(events, p(), batch_size=1)
    assert out == flat_matches(m) == []
    assert tmo == timeout_rows(t, R=1)
    assert [(r[0], r[1]) for r in tmo] == [(1, 0)]
    assert summ["cep_timeouts"] == 1
    events_in = [(0, "k", 20), (9, "k", 30)]
    out2, tmo2, _, _ = run_cep(events_in, p(), batch_size=1, timeout_tag=tag)
    m2, t2, _ = oracle_for(events_in, p(), batch_size=1)
    assert out2 == flat_matches(m2)
    assert len(out2) == 1 and tmo2 == timeout_rows(t2, R=1)


def test_late_events_under_allowed_lateness():
    late_tag = T.OutputTag("late")
    events = [(100, "k1", 20), (100, "k2", 1), (97, "k1", 30), (50, "k1", 99)]
    out, _, late, summ = run_cep(events, rel2(), batch_size=2,
                                 allowed_lateness=T.Time.seconds(5),
                                 late_tag=late_tag)
    m, _, l = oracle_for(events, rel2(), batch_size=2, allowed_lateness_ms=5000)
    assert out == flat_matches(m)
    assert len(out) == 1 and out[0][5] == 30
    assert [tuple(r) for r in late] == l == [(50, "k1", 99)]
    assert summ["late_dropped"] == 0


def test_select_function_dict_and_java_aliases():
    class SumSelect(T.PatternSelectFunction):
        def select(self, match):
            a0, a1 = match["spike"]
            end = match["probe"][0]
            return T.Tuple2(a0.f1, a0.f2 + a1.f2 + end.f2)

    p = (T.Pattern.begin("spike").where(lambda r: r.f2 > 10).times(2)
         .followedBy("probe").where(lambda r: r.f2 < 0))
    events = [(0, "k", 20), (1, "k", 22), (2, "k", -1)]
    out, _, _, _ = run_cep(events, p, select_fn=SumSelect())
    assert [repr(t) for t in out] == ["(k,41)"]


def test_multiple_keys_independent_state():
    def p():
        return (T.Pattern.begin("a").where(lambda r: r.f2 > 10)
                .next("b").where(lambda r: r.f2 > 10))

    events = [(0, "k1", 20), (1, "k2", 5), (2, "k1", 30), (3, "k2", 40),
              (4, "k2", 50)]
    out, _, _, _ = run_cep(events, p(), batch_size=2)
    m, _, _ = oracle_for(events, p(), batch_size=2)
    assert sorted(out) == sorted(flat_matches(m))
    assert len(out) == 2


def test_single_batch_multi_event_per_key_rounds():
    def p():
        return T.Pattern.begin("a").where(lambda r: r.f2 > 10).times(3)

    events = [(i, "k", 20 + i) for i in range(6)]
    out, _, _, _ = run_cep(events, p(), batch_size=8)
    m, _, _ = oracle_for(events, p(), batch_size=8)
    assert out == flat_matches(m)
    assert len(out) == 4


CH4_LINES = [
    "2019-08-28T10:00:00 www.163.com 6000",
    "2019-08-28T10:00:10 www.163.com 7000",
    "2019-08-28T10:00:20 www.163.com 8000",
    "2019-08-28T10:00:30 www.sina.com 6100",
    "2019-08-28T10:00:40 www.sina.com 7100",
    "2019-08-28T10:01:00 www.163.com 9000",
    "2019-08-28T10:00:50 www.sina.com 8100",
    "2019-08-28T10:05:00 www.qq.com 50",
]


def run_chapter4(side, lines, batch_size=8, **cfg):
    """The chapter-4 job of one package: (alert reprs, timeout reprs,
    print() output, summary)."""
    ns = PKGS[side]
    if side == "jax":
        from tpustream.jobs.chapter4_cep_alert import build
    else:
        from tpustream_torch.jobs.chapter4_cep_alert import build
    env = ns.pkg.StreamExecutionEnvironment(
        ns.pkg.StreamConfig(batch_size=batch_size, **cfg, **ns.cfg))
    env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    tag = ns.pkg.OutputTag("breach-timeout")
    alerts = build(env, env.add_source(ns.sources.ReplaySource(lines)),
                   timeout_tag=tag)
    h = alerts.collect()
    ht = alerts.get_side_output(tag).collect()
    env.execute("cep-chapter4")
    return ([repr(t) for t in h.items], [repr(t) for t in ht.items],
            env.metrics.summary())


def test_chapter4_job_matches_oracle_single_device():
    from tpustream_torch.jobs.chapter4_cep_alert import make_pattern
    from tpustream_torch.utils.timeutil import iso_local_to_epoch_sec

    recs = []
    for line in CH4_LINES:
        iso, ch, flow = line.split(" ")
        sec = iso_local_to_epoch_sec(iso)
        recs.append(((sec, ch, int(flow)), sec * 1000))
    m, t, _ = run_oracle(make_pattern(), [recs], delay_ms=5000)
    want_alerts = [f"({b0[1]},{b0[2] + b1[2] + b2[2]},{b0[0]},{b2[0]})"
                   for b0, b1, b2 in m]
    a1, t1, summ = run_chapter4("torch", CH4_LINES)
    assert a1 == want_alerts
    assert sorted(t1) == sorted(repr(r) for r in timeout_rows(t, R=2))
    # and the JAX package's run, byte for byte
    a_j, t_j, summ_j = run_chapter4("jax", CH4_LINES)
    assert (a1, t1) == (a_j, t_j)
    assert summ["cep_matches"] == summ_j["cep_matches"] == len(a1)
    assert summ["cep_timeouts"] == summ_j["cep_timeouts"] == len(t1)


def test_processing_time_pattern_no_assigner_needed():
    env = T.StreamExecutionEnvironment(T.StreamConfig(batch_size=2, device="cpu"))
    env.set_stream_time_characteristic(T.TimeCharacteristic.ProcessingTime)
    text = env.add_source(ReplaySource(lines_of([(0, "k", 20), (1, "k", 30)])))
    keyed = text.map(parser(PKGS["torch"])).key_by(1)
    h = T.CEP.pattern(keyed, rel2()).select(
        lambda match: T.Tuple2(match["a"][0].f1, match["b"][0].f2)).collect()
    env.execute("cep-proctime")
    assert [repr(t) for t in h.items] == ["(k,30)"]


def test_event_time_pattern_requires_assigner():
    env = T.StreamExecutionEnvironment(T.StreamConfig(device="cpu"))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    text = env.add_source(ReplaySource(lines_of([(0, "k", 20)])))
    keyed = text.map(parser(PKGS["torch"])).key_by(1)
    T.CEP.pattern(keyed, rel2()).select().collect()
    with pytest.raises(RuntimeError, match="event-time"):
        env.execute("cep-no-assigner")


def test_cep_requires_keyed_stream():
    env = T.StreamExecutionEnvironment(T.StreamConfig(device="cpu"))
    text = env.add_source(ReplaySource(["x"]))
    with pytest.raises(TypeError, match="keyed stream"):
        T.CEP.pattern(text, rel2())


# ---------------------------------------------------------------------------
# seeded patterns, the two compilers, and side by side with JAX
# ---------------------------------------------------------------------------


def pattern_spec(rng):
    """A random linear pattern: 1-3 stages, total length 2-5, strict and
    relaxed edges mixed, ``>``/``<`` thresholds on the value and a key
    test on some stages, with or without ``within``."""
    while True:
        n_stages = int(rng.integers(1, 4))
        stages = []
        for s in range(n_stages):
            stages.append(dict(
                strict=bool(rng.integers(0, 2)) if s else False,
                times=int(rng.integers(1, 4)),
                consecutive=bool(rng.integers(0, 2)),
                op=">" if rng.random() < 0.7 else "<",
                thr=int(rng.integers(5, 25)),
                key=None if rng.random() < 0.8 else f"k{int(rng.integers(0, 3))}",
            ))
        length = sum(st["times"] for st in stages)
        if 2 <= length <= 5:
            within = None if rng.random() < 0.3 else int(rng.integers(2, 12)) * 1000
            return stages, within


def build_pattern(ns, spec):
    stages, within = spec
    p = None
    for i, st in enumerate(stages):
        name = f"s{i}"
        if p is None:
            p = ns.pkg.Pattern.begin(name)
        elif st["strict"]:
            p = p.next(name)
        else:
            p = p.followed_by(name)
        thr = st["thr"]
        if st["op"] == ">":
            p = p.where(lambda r, thr=thr: r.f2 > thr)
        else:
            p = p.where(lambda r, thr=thr: r.f2 < thr)
        if st["key"] is not None:
            p = p.where(lambda r, k=st["key"]: r.f1 != k)
        if st["times"] > 1:
            p = p.times(st["times"])
            if st["consecutive"]:
                p = p.consecutive()
    if within is not None:
        p = p.within(ns.pkg.Time.milliseconds(within))
    return p


@pytest.mark.parametrize("seed", range(24))
def test_compile_pattern_equals_the_jax_package(seed):
    spec = pattern_spec(np.random.default_rng(seed))
    got = compile_pattern(build_pattern(PKGS["torch"], spec))
    want = jax_compile_pattern(build_pattern(PKGS["jax"], spec))
    assert got.length == want.length
    assert got.stage_names == want.stage_names
    assert got.within_ms == want.within_ms
    assert [len(c) for c in got.conds] == [len(c) for c in want.conds]
    for a, b in (("stage_of", "stage_of"), ("cond_of", "cond_of"),
                 ("strict", "strict")):
        x, y = getattr(got, a), getattr(want, b)
        assert x.dtype == y.dtype and x.tolist() == y.tolist()
    assert got.transition_table().tolist() == want.transition_table().tolist()


def seeded_events(rng, n, n_keys=4, jitter=3):
    """(sec, key, value) events over roughly ``n`` seconds, each second
    jittered back by up to ``jitter`` (some land behind the watermark),
    values 0-29."""
    secs = np.arange(n) - rng.integers(0, jitter + 1, n)
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, 30, n)
    return [(int(t), f"k{int(k)}", int(v)) for t, k, v in zip(secs, keys, vals)]


def run_side(side, events, spec, batch_size, capsys, select=False,
             delay_ms=1000, lateness_ms=0, late_side=True, **cfg):
    """One package's CEP run over ``events``: (rows, timeout rows, late
    rows, print() output, counters). Without ``late_side`` the late rows
    are dropped and counted in ``late_dropped``."""
    ns = PKGS[side]
    env = ns.pkg.StreamExecutionEnvironment(
        ns.pkg.StreamConfig(batch_size=batch_size, **cfg, **ns.cfg))
    env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    text = env.add_source(ns.sources.ReplaySource(lines_of(events)))
    keyed = (text.assign_timestamps_and_watermarks(extractor(ns, delay_ms))
             .map(parser(ns)).key_by(1))
    late_tag, t_tag = ns.pkg.OutputTag("late"), ns.pkg.OutputTag("timeout")
    ps = ns.pkg.CEP.pattern(keyed, build_pattern(ns, spec))
    if lateness_ms:
        ps = ps.allowed_lateness(lateness_ms)
    if late_side:
        ps = ps.side_output_late_data(late_tag)
    fn = None
    if select:
        def fn(m):
            first = m["s0"][0]
            last = m[sorted(m)[-1]][-1]
            return ns.pkg.Tuple3(first.f1, last.f0 - first.f0, first.f2 + last.f2)
    result = ps.select(fn, timeout_tag=t_tag)
    h = result.collect()
    result.print()
    ht = result.get_side_output(t_tag).collect()
    hl = result.get_side_output(late_tag).collect() if late_side else None
    capsys.readouterr()
    env.execute("cep-side-by-side")
    printed = capsys.readouterr().out
    s = env.metrics.summary()
    counters = {k: s[k] for k in ("cep_matches", "cep_timeouts", "late_dropped",
                                  "alert_overflow")}
    return ([repr(t) for t in h.items], [repr(t) for t in ht.items],
            [repr(t) for t in hl.items] if late_side else [], printed, counters)


@pytest.mark.parametrize("batch_size", [1, 2, 7, 64])
def test_side_by_side_with_the_jax_package(batch_size, capsys):
    rng = np.random.default_rng(100 + batch_size)
    events = seeded_events(rng, 90)
    spec = ([dict(strict=False, times=2, consecutive=False, op=">", thr=12, key=None),
             dict(strict=True, times=1, consecutive=False, op="<", thr=20, key=None)],
            12000)
    got = run_side("torch", events, spec, batch_size, capsys, select=True)
    want = run_side("jax", events, spec, batch_size, capsys, select=True)
    assert got == want
    rows, tmo, late, printed, counters = got
    assert rows and tmo and late and printed
    assert counters["cep_matches"] == len(rows)
    assert counters["cep_timeouts"] == len(tmo)
    assert counters["late_dropped"] == 0  # the late rows are routed


@pytest.mark.parametrize("seed", range(12))
def test_seeded_pattern_fuzz_matches_the_jax_package(seed, capsys):
    rng = np.random.default_rng(seed)
    spec = pattern_spec(rng)
    events = seeded_events(rng, 60, n_keys=int(rng.integers(1, 5)))
    batch_size = int(rng.choice([3, 8, 32]))  # batch 1: the side-by-side test
    lateness = int(rng.choice([0, 0, 2000]))
    late_side = seed % 3 != 0
    got = run_side("torch", events, spec, batch_size, capsys,
                   lateness_ms=lateness, late_side=late_side)
    want = run_side("jax", events, spec, batch_size, capsys,
                    lateness_ms=lateness, late_side=late_side)
    assert got == want
    # and the port's copy of the oracle, over the same batch boundaries
    recs = [((t, ch, v), t * 1000) for t, ch, v in events]
    batches = [recs[i:i + batch_size] for i in range(0, len(recs), batch_size)]
    m, t, late = run_oracle(build_pattern(PKGS["torch"], spec), batches,
                            delay_ms=1000, allowed_lateness_ms=lateness)
    assert sorted(got[0]) == sorted(repr(r) for r in flat_matches(m))
    L = compile_pattern(build_pattern(PKGS["torch"], spec)).length
    assert sorted(got[1]) == sorted(repr(r) for r in timeout_rows(t, R=L - 1))
    if late_side:
        assert got[2] == [repr(T.Tuple3(*r)) for r in late]
    else:
        assert got[4]["late_dropped"] == len(late)


def test_port_oracle_equals_the_jax_packages_oracle():
    rng = np.random.default_rng(7)
    for _ in range(8):
        spec = pattern_spec(rng)
        events = seeded_events(rng, 50)
        recs = [((t, ch, v), t * 1000) for t, ch, v in events]
        batches = [recs[i:i + 5] for i in range(0, len(recs), 5)]
        got = run_oracle(build_pattern(PKGS["torch"], spec), batches,
                         delay_ms=1000)
        want = jax_run_oracle(build_pattern(PKGS["jax"], spec), batches,
                              delay_ms=1000)
        assert got == want


def test_key_growth_past_the_initial_capacity(capsys):
    """Eleven keys through a capacity of 2: the NFA registers grow (old
    rows carried over) and the rows equal a run with room for every key
    from the start, and the JAX package's."""
    rng = np.random.default_rng(5)
    events = seeded_events(rng, 120, n_keys=11)
    spec = ([dict(strict=False, times=3, consecutive=False, op=">", thr=8, key=None)],
            20000)
    small = run_side("torch", events, spec, 7, capsys, key_capacity=2)
    big = run_side("torch", events, spec, 7, capsys, key_capacity=64)
    ref = run_side("jax", events, spec, 7, capsys, key_capacity=64)
    assert len(ref[0]) > 10
    assert small == big == ref


# ---------------------------------------------------------------------------
# state carried across from the JAX package
# ---------------------------------------------------------------------------


def _program(ns, batch, key_capacity, spec):
    """The CEP program of one package for ``spec`` over (sec, key, value)
    records, with keys ``k0``.. interned in order."""
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(
        batch_size=batch, key_capacity=key_capacity, **ns.cfg))
    env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    text = env.add_source(ns.sources.ReplaySource([]))
    keyed = (text.assign_timestamps_and_watermarks(extractor(ns, 1000))
             .map(parser(ns)).key_by(1))
    ns.pkg.CEP.pattern(keyed, build_pattern(ns, spec)).select().collect()
    plan = ns.plan.build_plan(env, env._sinks)
    for key in range(key_capacity):
        plan.tables[1].intern(f"k{key}")
    return ns.step.build_program(plan, env.config)


def test_state_carried_across_from_the_jax_package():
    """The JAX package runs k steps; its NFA state (numpy) moves into the
    port, which runs the rest: the match and timeout rows equal the JAX
    package's full run, in order."""
    batch, kcap, k = 16, 6, 3
    spec = ([dict(strict=False, times=2, consecutive=False, op=">", thr=10, key=None),
             dict(strict=False, times=1, consecutive=False, op="<", thr=25, key=None)],
            30000)
    jprog = _program(PKGS["jax"], batch, kcap, spec)
    tprog = _program(PKGS["torch"], batch, kcap, spec)
    jstep = jax.jit(jprog._step)
    rng = np.random.default_rng(3)
    feeds = []
    for i in range(8):
        secs = i * batch + np.arange(batch) - rng.integers(0, 3, batch)
        feeds.append((secs.astype(np.int64),
                      rng.integers(0, kcap, batch).astype(np.int32),
                      rng.integers(0, 30, batch).astype(np.int64)))

    def jax_rows(em):
        rows = []
        for name in ("main", "timeout"):
            m = np.asarray(em[name]["mask"])
            cols = [np.asarray(c) for c in em[name]["cols"]]
            rows.append([tuple(c[j].item() for c in cols) for j in np.nonzero(m)[0]])
        return rows

    def torch_rows(em):
        rows = []
        for name in ("main", "timeout"):
            n = int(em[name]["count"])
            rows.append([tuple(c[j].item() for c in em[name]["cols"])
                         for j in range(n)])
        return rows

    jstate, want, got, carried = jprog.init_state(), [], [], None
    low = jnp.asarray(-(2**62), jnp.int64)
    for i, (secs, keys, vals) in enumerate(feeds):
        if i == k:
            carried = jax.device_get(jstate)
        jstate, em = jstep(
            jstate, (jnp.asarray(secs), jnp.asarray(keys), jnp.asarray(vals)),
            jnp.ones(batch, bool), jnp.asarray(secs * 1000), low)
        rows = jax_rows(em)
        want.append(rows)
        if i < k:
            got.append(rows)
    state = tprog.state_from_jax_numpy(carried)
    for secs, keys, vals in feeds[k:]:
        state, em = tprog.step(
            state, [torch.from_numpy(secs), torch.from_numpy(keys),
                    torch.from_numpy(vals)],
            torch.ones(batch, dtype=torch.bool), torch.from_numpy(secs * 1000),
            -(2**62))
        got.append(torch_rows(em))
    assert sum(len(r[0]) for r in want) > 10
    assert sum(len(r[1]) for r in want) > 3
    assert got == want
    assert int(state["cep_matches"]) == int(jstate["cep_matches"])
    assert int(state["cep_timeouts"]) == int(jstate["cep_timeouts"])
