"""Dynamic rules over a broadcast control stream (chapter 5) through the
PyTorch port, on the CPU.

* The single-device cases of the JAX package's suite
  (tests/test_broadcast.py): record-exact updates against the chapter-5
  host oracle at four batch sizes, several updates inside one batch,
  updates before and after the stream, batch-size invariance, a window
  parameter updated mid-stream, a CEP predicate constant updated
  mid-stream (the JAX suite's compile-registry check becomes "each
  stage's program was built once"), and the RuleSet, control-line
  parser, control-feed and API guards.
* Side by side with the JAX package (tolerance: bitwise): a rolling max,
  a tumbling window and a session window that read a rule in their pre
  or post chain; a ``RuleParam`` on either side of arithmetic and
  comparison; ``col / param`` (an IEEE division, unlike ``col / 60``);
  an int64 rule against a float64 column and a float64 rule against an
  int64 column; the per-tenant host surface of ``RuleSet``.

The JAX package's runs with rules re-dispatch donated-buffer programs,
so this file runs against a cold compilation cache, as its JAX
counterpart does.
"""

import types

import numpy as np
import pytest
import torch

import tpustream
import tpustream.api.windows as jax_windows
import tpustream.broadcast.rules as jax_rules
import tpustream.runtime.sources as jax_sources
import tpustream_torch as T
import tpustream_torch.api.windows as torch_windows
import tpustream_torch.broadcast.rules as torch_rules
import tpustream_torch.runtime.executor as torch_executor
import tpustream_torch.runtime.sources as torch_sources
from tests.test_broadcast import LINES
from tpustream.javacompat import Double as JDouble
from tpustream.javacompat import Long as JLong
from tpustream_torch.broadcast import ControlFeed, parse_control_line
from tpustream_torch.javacompat import Double, Long
from tpustream_torch.jobs.chapter5_dynamic_rules import (
    build as build_ch5,
    control_lines,
    make_rules,
    oracle,
)
from tpustream_torch.runtime.sources import ReplaySource

pytestmark = pytest.mark.fresh_cache

PKGS = {
    "jax": types.SimpleNamespace(pkg=tpustream, sources=jax_sources,
                                 windows=jax_windows, rules=jax_rules,
                                 long=JLong, double=JDouble, cfg={}),
    "torch": types.SimpleNamespace(pkg=T, sources=torch_sources,
                                   windows=torch_windows, rules=torch_rules,
                                   long=Long, double=Double,
                                   cfg={"device": "cpu"}),
}


@pytest.fixture
def builds(monkeypatch):
    """Counts the port's program builds by plan: {id(plan): builds}."""
    counts = {}
    plain = torch_executor.build_program

    def counted(plan, cfg):
        counts[id(plan)] = counts.get(id(plan), 0) + 1
        return plain(plan, cfg)

    monkeypatch.setattr(torch_executor, "build_program", counted)
    return counts


def run_ch5(lines, updates, batch_size=4, ckdir=None, injector=None,
            strategy=None, **over):
    """One chapter-5 dynamic-threshold run through the port on the CPU;
    returns (result, tuples, rules)."""
    cfg = T.StreamConfig(batch_size=batch_size, device="cpu", **over)
    if ckdir is not None:
        cfg = cfg.replace(checkpoint_dir=str(ckdir), checkpoint_interval_batches=1)
    if injector is not None:
        cfg = injector.install(cfg)
    env = T.StreamExecutionEnvironment(cfg)
    if strategy is not None:
        env.set_restart_strategy(strategy)
    rules = make_rules()
    handle = build_ch5(
        env, env.add_source(ReplaySource(lines)),
        env.add_source(ReplaySource(control_lines(updates))), rules,
    ).collect()
    res = env.execute("dyn-rules-test")
    return res, [tuple(t) for t in handle.items], rules


def expect_ch5(lines, updates):
    return [tuple(t) for t in oracle(lines, updates)]


# ---------------------------------------------------------------------------
# tests/test_broadcast.py, single device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [3, 4, 16, 64])
def test_threshold_update_matches_oracle(batch_size, builds):
    updates = [(17, 95.0)]
    _, got, rules = run_ch5(LINES, updates, batch_size=batch_size)
    assert got == expect_ch5(LINES, updates)
    assert rules.version == 1
    assert rules.value("threshold") == 95.0
    assert list(builds.values()) == [1]  # the update rebuilt nothing


def test_multiple_updates_single_batch():
    updates = [(5, 95.0), (9, 70.0)]
    _, got, rules = run_ch5(LINES, updates, batch_size=16)
    assert got == expect_ch5(LINES, updates)
    assert rules.version == 2


def test_update_before_and_after_stream():
    updates = [(0, 75.0), (10_000, 99.0)]
    _, got, rules = run_ch5(LINES, updates, batch_size=8)
    assert got == expect_ch5(LINES, updates)
    assert rules.version == 2
    assert rules.value("threshold") == 99.0


def test_batch_size_invariance():
    outs = [run_ch5(LINES, [(13, 95.0), (29, 65.0)], batch_size=b)[1]
            for b in (2, 5, 40)]
    assert outs[0] == outs[1] == outs[2]
    assert outs[0] == expect_ch5(LINES, [(13, 95.0), (29, 65.0)])


def test_chapter5_job_matches_the_jax_package(capsys):
    """The chapter-5 job's print() bytes through both packages, with an
    update inside a batch."""
    from tpustream.jobs import chapter5_dynamic_rules as jax_ch5

    outs = []
    for side, mod in (("jax", jax_ch5), ("torch", None)):
        ns = PKGS[side]
        env = ns.pkg.StreamExecutionEnvironment(
            ns.pkg.StreamConfig(batch_size=8, **ns.cfg))
        rules = (mod.make_rules() if mod else make_rules())
        build = mod.build if mod else build_ch5
        lines_ctl = (mod.control_lines if mod else control_lines)([(13, 95.0), (30, 70.0)])
        build(env, env.add_source(ns.sources.ReplaySource(LINES)),
              env.add_source(ns.sources.ReplaySource(lines_ctl)), rules).print()
        capsys.readouterr()
        env.execute("ch5")
        outs.append((capsys.readouterr().out, rules.version))
    assert outs[0] == outs[1]
    assert outs[0][0].count("\n") == len(expect_ch5(LINES, [(13, 95.0), (30, 70.0)]))


def _kv_parse(s):
    items = s.split(" ")
    return T.Tuple2(items[0], Double.parseDouble(items[1]))


def _run_window_param(updates, batch_size=4):
    rules = T.RuleSet()
    limit = rules.declare("sum_limit", 10.0, "f64")
    env = T.StreamExecutionEnvironment(
        T.StreamConfig(batch_size=batch_size, device="cpu"))
    data = env.from_collection([f"k {i}" for i in range(12)])
    ctrl = env.from_collection(
        [T.RuleUpdate("sum_limit", v, pos) for pos, v in updates])
    ctrl.broadcast(rules)
    handle = (data.map(_kv_parse).key_by(0).count_window(2).sum(1)
              .filter(lambda t: t.f1 < limit)).collect()
    env.execute("win-param-test")
    return [tuple(t) for t in handle.items]


def test_window_param_update_mid_stream():
    got = _run_window_param([(6, 100.0)], batch_size=4)
    assert got == [("k", 1.0), ("k", 5.0), ("k", 9.0),
                   ("k", 13.0), ("k", 17.0), ("k", 21.0)]
    assert _run_window_param([], batch_size=4) == [
        ("k", 1.0), ("k", 5.0), ("k", 9.0)]


def test_cep_dynamic_predicate_built_once(builds):
    """A CEP ``where`` predicate reads a rule: raising the constant
    mid-stream changes which events match, and the NFA program is built
    once (the rule is data the step reads)."""

    class SecExtractor(T.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(T.Time.seconds(0))

        def extract_timestamp(self, element):
            return int(element.split(" ")[0]) * 1000

    rules = T.RuleSet()
    thr = rules.declare("flow_min", 50.0, "f64")
    vals = [30, 60, 80, 40, 70, 55, 90, 95, 20, 85]
    lines = [f"{100 + i} ch {v}" for i, v in enumerate(vals)]
    env = T.StreamExecutionEnvironment(T.StreamConfig(batch_size=2, device="cpu"))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    ctrl = env.from_collection([T.RuleUpdate("flow_min", 75.0, 5)])
    ctrl.broadcast(rules)
    keyed = (env.from_collection(lines)
             .assign_timestamps_and_watermarks(SecExtractor())
             .map(lambda s: T.Tuple2(s.split(" ")[1], float(s.split(" ")[2])))
             .key_by(0))
    pattern = (T.Pattern.begin("a").where(lambda r: r.f1 > thr)
               .next("b").where(lambda r: r.f1 > thr))
    handle = T.CEP.pattern(keyed, pattern).select(lambda m: m["b"][0].f1).collect()
    env.execute("cep-dyn-test")
    assert sorted(handle.items) == [80.0, 95.0]
    assert list(builds.values()) == [1]
    assert rules.version == 1


def test_ruleset_coercion_and_reset():
    rules = T.RuleSet()
    f = rules.declare("f", 1.5, "f64")
    i = rules.declare("i", 2, "i64")
    b = rules.declare("b", True, "bool")
    rules.apply(T.RuleUpdate("f", "3.25"))
    rules.apply(T.RuleUpdate("i", "95.0"))
    rules.apply(T.RuleUpdate("b", "false"))
    assert rules.value("f") == 3.25
    assert rules.value("i") == 95
    assert rules.value("b") is False
    assert rules.version == 3
    assert float(f) == 3.25 and int(i) == 95 and bool(b) is False
    rules.reset()
    assert rules.version == 0
    assert (rules.value("f"), rules.value("i"), rules.value("b")) == (1.5, 2, True)
    assert rules.getValue("i") == 2
    assert rules.getVersion() == 0
    assert rules.getParam("f").name == "f"
    with pytest.raises(ValueError):
        rules.declare("f", 0.0)
    with pytest.raises(KeyError):
        rules.value("nope")


def test_parse_control_line():
    assert parse_control_line("threshold 95 10") == T.RuleUpdate("threshold", "95", 10)
    assert parse_control_line(b"threshold 95") == T.RuleUpdate("threshold", "95", 0)
    assert parse_control_line("") is None
    assert parse_control_line("# comment") is None
    u = T.RuleUpdate("x", 1, 2)
    assert parse_control_line(u) is u
    with pytest.raises(ValueError):
        parse_control_line("just-a-name")


def test_control_feed_cursor_and_splits():
    rules = T.RuleSet()
    rules.declare("t", 90.0)
    feed = ControlFeed(rules)
    feed.add(T.RuleUpdate("t", 95.0, 10))
    feed.add(T.RuleUpdate("t", 80.0, 4))
    feed.add(T.RuleUpdate("t", 70.0, 10))
    assert [u.after_records for u in feed.pending()] == [4, 10, 10]
    splits = feed.splits_for(8, 8)
    assert [(off, [u.value for u in us]) for off, us in splits] == [
        (0, [80.0]), (2, [95.0, 70.0])]
    for _, us in splits:
        for u in us:
            rules.apply(u)
    assert feed.pending() == []
    assert rules.value("t") == 70.0


def test_one_broadcast_per_job():
    rules = T.RuleSet()
    rules.declare("t", 1.0)
    env = T.StreamExecutionEnvironment(T.StreamConfig(device="cpu"))
    env.from_collection([]).broadcast(rules)
    with pytest.raises(RuntimeError, match="one broadcast"):
        env.from_collection([]).broadcast(rules)


def test_broadcast_requires_source_stream():
    rules = T.RuleSet()
    rules.declare("t", 1.0)
    env = T.StreamExecutionEnvironment(T.StreamConfig(device="cpu"))
    with pytest.raises(NotImplementedError):
        env.from_collection([]).map(lambda x: x).broadcast(rules)


# ---------------------------------------------------------------------------
# side by side with the JAX package
# ---------------------------------------------------------------------------

KV_LINES = [f"{1000 + 700 * j} h{j % 5} {(j * 37) % 100}.{j % 10}5"
            for j in range(60)]


def run_rules_job(side, build, updates, rule_kind="f64", default=50.0,
                  lines=KV_LINES, batch_size=4, event_time=False, **cfg):
    """``build(ns, text, param)``'s stream through one package, with one
    rule ``p`` and the control stream ``updates`` ([(position, value)]):
    (repr of each row, rule version)."""
    ns = PKGS[side]
    rules = ns.pkg.RuleSet()
    param = rules.declare("p", default, rule_kind)
    env = ns.pkg.StreamExecutionEnvironment(
        ns.pkg.StreamConfig(batch_size=batch_size, **cfg, **ns.cfg))
    if event_time:
        env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    ctrl = env.from_collection([ns.pkg.RuleUpdate("p", v, pos) for pos, v in updates])
    ctrl.broadcast(rules)
    handle = build(ns, env.add_source(ns.sources.ReplaySource(lines)), param).collect()
    env.execute("rules-side-by-side")
    return [repr(t) for t in handle.items], rules.version


def both(build, updates, **kw):
    want = run_rules_job("jax", build, updates, **kw)
    got = run_rules_job("torch", build, updates, **kw)
    assert got == want
    assert got[0]
    return got[0]


def kv3(ns):
    def parse(s):
        items = s.split(" ")
        return ns.pkg.Tuple3(ns.long.parseLong(items[0]), items[1],
                             ns.double.parseDouble(items[2]))
    return parse


def ts_assigner(ns):
    class Ts(ns.pkg.BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(ns.pkg.Time.milliseconds(500))

        def extract_timestamp(self, value):
            return ns.long.parseLong(value.split(" ")[0])

    return Ts()


@pytest.mark.parametrize("batch_size", [3, 16])
def test_rolling_max_reading_a_rule_in_the_pre_chain(batch_size):
    """chapter2_max with the chapter-5 threshold as a pre-chain filter,
    updated inside a batch: the rolling max folds only the rows above
    the threshold active at each row."""
    rows = both(lambda ns, t, p: t.map(kv3(ns)).filter(lambda v: v.f2 > p)
                .key_by(1).max(2), [(11, 70.0), (40, 20.0)],
                batch_size=batch_size)
    assert len(rows) > 20


def test_rolling_max_reading_a_rule_in_the_post_chain():
    both(lambda ns, t, p: t.map(kv3(ns)).key_by(1).max(2)
         .map(lambda v: ns.pkg.Tuple2(v.f1, v.f2 - p)), [(25, 10.0)])


def test_tumbling_window_reading_a_rule():
    def build(ns, t, p):
        return (t.assign_timestamps_and_watermarks(ts_assigner(ns))
                .map(kv3(ns)).filter(lambda v: v.f2 > p).key_by(1)
                .time_window(ns.pkg.Time.seconds(5))
                .reduce(lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
                .map(lambda v: ns.pkg.Tuple2(v.f1, v.f2 / p)))

    both(build, [(20, 30.0), (41, 60.0)], event_time=True, batch_size=8)


def test_session_window_reading_a_rule():
    def build(ns, t, p):
        return (t.assign_timestamps_and_watermarks(ts_assigner(ns))
                .map(kv3(ns)).key_by(1)
                .window(ns.windows.EventTimeSessionWindows.with_gap(
                    ns.pkg.Time.seconds(3)))
                .reduce(lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
                .filter(lambda v: v.f2 > p))

    both(build, [(30, 150.0)], default=40.0, event_time=True, batch_size=8)


def test_cep_reading_a_rule_side_by_side():
    def build(ns, t, p):
        keyed = (t.assign_timestamps_and_watermarks(ts_assigner(ns))
                 .map(kv3(ns)).key_by(1))
        pat = (ns.pkg.Pattern.begin("a").where(lambda r: r.f2 > p)
               .followed_by("b").where(lambda r: r.f2 > p)
               .within(ns.pkg.Time.seconds(10)))
        return ns.pkg.CEP.pattern(keyed, pat).select(
            lambda m: ns.pkg.Tuple2(m["a"][0].f1, m["b"][0].f2 - m["a"][0].f2))

    both(build, [(18, 75.0), (37, 30.0)], event_time=True, batch_size=5)


ARITH = {
    "col > p": lambda v, p: v.f2 > p,
    "p < col": lambda v, p: p < v.f2,
    "col >= p": lambda v, p: v.f2 >= p,
    "p <= col": lambda v, p: p <= v.f2,
    "col == p": lambda v, p: v.f2 == p,
    "p != col": lambda v, p: p != v.f2,
    "col + p": lambda v, p: v.f2 + p,
    "p + col": lambda v, p: p + v.f2,
    "col - p": lambda v, p: v.f2 - p,
    "p - col": lambda v, p: p - v.f2,
    "col * p": lambda v, p: v.f2 * p,
    "p * col": lambda v, p: p * v.f2,
    "col / p": lambda v, p: v.f2 / p,
    "p / col": lambda v, p: p / v.f2,
    "col // p": lambda v, p: v.f2 // p,
    "col % p": lambda v, p: v.f2 % p,
    "-p + col": lambda v, p: -p + v.f2,
    "abs(p) * col": lambda v, p: abs(p) * v.f2,
}


@pytest.mark.parametrize("expr", sorted(ARITH))
def test_rule_param_operators_both_ways(expr):
    """A RuleParam on either side of each operator inside a map, with an
    update inside a batch, bitwise equal to the JAX package."""
    fn = ARITH[expr]
    both(lambda ns, t, p: t.map(kv3(ns)).map(
        lambda v: ns.pkg.Tuple2(v.f1, fn(v, p))), [(7, 3.0)], default=7.0,
        lines=KV_LINES[:20])


def test_division_by_a_rule_is_an_ieee_division():
    """``col / param`` divides (the JAX package divides by a traced
    leaf), while ``col / 60`` multiplies by the reciprocal (XLA's rewrite
    of a constant divisor): on these values the two differ in the last
    bit, and each package agrees with the other on both."""
    lines = [f"{i} h0 {v}" for i, v in enumerate([1.0, 7.0, 61.0, 1e9, 3.3])]
    by_rule = both(lambda ns, t, p: t.map(kv3(ns)).map(
        lambda v: ns.pkg.Tuple2(v.f1, v.f2 / p)), [], default=60.0, lines=lines)
    by_const = both(lambda ns, t, p: t.map(kv3(ns)).map(
        lambda v: ns.pkg.Tuple2(v.f1, v.f2 / 60)), [], lines=lines)
    vals = [1.0, 7.0, 61.0, 1e9, 3.3]
    assert by_rule == [f"(h0,{v / 60!r})" for v in vals]
    assert by_const == [f"(h0,{v * (1 / 60)!r})" for v in vals]
    assert by_rule != by_const


def test_int64_rule_against_a_float64_column():
    both(lambda ns, t, p: t.map(kv3(ns)).map(
        lambda v: ns.pkg.Tuple3(v.f1, v.f2 * p, v.f2 > p)),
         [(9, 3)], rule_kind="i64", default=40, lines=KV_LINES[:20])


def test_float64_rule_against_an_int64_column():
    both(lambda ns, t, p: t.map(kv3(ns)).map(
        lambda v: ns.pkg.Tuple3(v.f1, v.f0 + p, v.f0 > p)),
         [(9, 9500.5)], rule_kind="f64", default=5000.25, lines=KV_LINES[:20])


def test_bool_rule_as_a_filter():
    both(lambda ns, t, p: t.map(kv3(ns)).filter(lambda v: (v.f2 > 50) == p),
         [(5, False), (12, True)], rule_kind="bool", default=True,
         lines=KV_LINES[:20])


def test_chained_stages_share_one_ruleset(builds):
    """A window stage then a re-keyed rolling stage, both reading the
    rule: one update reaches both at the same record boundary, and each
    stage's program is built once."""
    def build(ns, t, p):
        return (t.assign_timestamps_and_watermarks(ts_assigner(ns))
                .map(kv3(ns)).filter(lambda v: v.f2 > p).key_by(1)
                .time_window(ns.pkg.Time.seconds(4))
                .reduce(lambda a, b: ns.pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
                .key_by(lambda v: v.f1[:1]).max(2)
                .map(lambda v: ns.pkg.Tuple2(v.f1, v.f2 + p)))

    both(build, [(21, 35.0), (44, 75.0)], event_time=True, batch_size=6)
    assert sorted(builds.values()) == [1, 1]


def test_tenant_rule_surface_matches_the_jax_package():
    """The per-tenant host surface (enable_tenancy, scoped updates,
    tenant_value, values/load, reset) of both packages' RuleSets, and
    the port's tenant-mode leaves."""
    out = {}
    for side in ("jax", "torch"):
        r = PKGS[side].rules
        rules = r.RuleSet(r.RuleDescriptor("t", 90.0, "f64"),
                          r.RuleDescriptor("n", 3, "i64"))
        rules.enable_tenancy(3)
        rules.apply(r.RuleUpdate("t", "95", tenant=2))
        rules.apply(r.RuleUpdate("n", 7))
        rules.ensure_tenant_slot(5)
        rules.apply(r.RuleUpdate(r.TENANT_ACTIVE_RULE, "on", tenant=5))
        vals = rules.values()
        restored = r.RuleSet(r.RuleDescriptor("t", 1.0, "f64"),
                             r.RuleDescriptor("n", 0, "i64"))
        restored.load(vals, rules.version)
        out[side] = (rules.tenant_capacity, rules.version, vals,
                     [rules.tenant_value("t", s) for s in range(8)],
                     restored.values(), restored.version, rules.names())
        leaves = rules.device_leaves()
        out[side + "_leaves"] = {k: np.asarray(v).tolist() for k, v in leaves.items()}
        rules.reset()
        out[side + "_reset"] = rules.values()
    assert out["torch"] == out["jax"]
    assert out["torch_leaves"] == out["jax_leaves"]
    assert out["torch_reset"] == out["jax_reset"]


def test_rule_param_resolves_to_the_bound_tensor():
    rules = T.RuleSet()
    p = rules.declare("p", 2.0, "f64")
    col = torch.tensor([1.0, 3.0], dtype=torch.float64)
    assert (col > p).tolist() == [False, True]
    with rules.bound({"p": torch.tensor(0.5, dtype=torch.float64)}):
        assert (col > p).tolist() == [True, True]
        assert torch.where(col > 2, p, col).tolist() == [1.0, 0.5]
    with rules.bound({"p": torch.tensor([10.0, 20.0, 30.0], dtype=torch.float64)}):
        with rules.bound_tenant(torch.tensor([2, 0])):
            assert (col + p).tolist() == [31.0, 13.0]


# ---------------------------------------------------------------------------
# tests/test_broadcast.py's durability cases: checkpoint meta and crash
# recovery across a rule update
# ---------------------------------------------------------------------------


def test_checkpoint_meta_carries_rules(tmp_path):
    import glob
    import os

    from tpustream_torch.runtime.checkpoint import load_checkpoint

    run_ch5(LINES, [(5, 95.0)], batch_size=4, ckdir=tmp_path)
    snaps = sorted(glob.glob(os.path.join(str(tmp_path), "ckpt-*.npz")))
    assert snaps
    ck = load_checkpoint(snaps[-1])
    assert ck.rule_values == {"threshold": 95.0}
    assert ck.rule_version == 1
    # and an early snapshot (if still retained) predates the update
    assert load_checkpoint(snaps[0]).rule_version in (0, 1)


def test_control_apply_crash_recovers_byte_identical(tmp_path):
    """A crash between a rule's application and the next data batch:
    the supervised restart restores the pre-update rule version from the
    checkpoint, replays, and re-applies the update at the same record
    boundary; the output equals an uninterrupted run's and the final
    version is exactly 1 (no double apply)."""
    from tpustream_torch.runtime.supervisor import fixed_delay
    from tpustream_torch.testing import FaultInjector, FaultPoint

    updates = [(17, 95.0)]
    want = expect_ch5(LINES, updates)
    _, clean, _ = run_ch5(LINES, updates, batch_size=4)
    assert clean == want
    inj = FaultInjector(FaultPoint("control_apply", at=0))
    _, got, rules = run_ch5(LINES, updates, batch_size=4, ckdir=tmp_path,
                            injector=inj, strategy=fixed_delay(3, 0.0))
    assert inj.fired == 1
    assert got == want
    assert rules.version == 1
    assert rules.value("threshold") == 95.0


def test_scratch_restart_replays_rule_timeline():
    """A crash before any checkpoint exists restarts from scratch: the
    RuleSet resets to its defaults and the control feed re-applies the
    update at its original boundary."""
    from tpustream_torch.runtime.supervisor import fixed_delay
    from tpustream_torch.testing import FaultInjector, FaultPoint

    updates = [(17, 95.0)]
    inj = FaultInjector(FaultPoint("device_step", at=0))
    _, got, rules = run_ch5(LINES, updates, batch_size=4, injector=inj,
                            strategy=fixed_delay(3, 0.0))
    assert inj.fired == 1
    assert got == expect_ch5(LINES, updates)
    assert rules.version == 1
