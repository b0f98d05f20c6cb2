"""Chapter 6, the multi-tenant job server, through the PyTorch port on
the CPU.

* The single-device cases of the JAX package's suite
  (tests/test_tenancy.py), with its helpers and the chapter-6 oracle:
  64 tenants in one program (the build registry shows no rebuild),
  batch-size invariance, solo parity, hot add/remove/update, quotas,
  the noisy-neighbour SLO fleet scraped over ``/tenants.json``,
  tenant-capacity growth tagged with its cause, keyed and windowed
  fleets, the RuleSet / TenantPlan / JobServer guards, a tenant_apply
  crash recovered byte-identically under supervision, and the tenant
  table and rule vectors in the checkpoint meta.
* Side by side with the JAX package (tolerance: bitwise, through
  ``repr``): a seeded fleet with random thresholds, admissions,
  removals, updates and quotas at random positions, at batch sizes 1,
  3 and 64 (per-tenant output, quota side outputs and ``state_dict()``
  all equal); a template that uses a tenant rule in arithmetic;
  admission at exactly the capacity edge.
* The build registry is honest: ``build_program`` calls, counted
  directly, equal ``operator_compile_count``.

The JAX package's fleet runs re-dispatch donated-buffer programs, so
this file runs against a cold compilation cache, as its JAX
counterpart does.
"""

import json
import random
import types
import urllib.request

import pytest
import torch

import tpustream
import tpustream.config as jax_config
import tpustream.jobs.chapter6_tenant_fleet as jax_c6
import tpustream_torch as T
import tpustream_torch.javacompat as jc
import tpustream_torch.runtime.executor as torch_executor
from tests.test_tenancy import recompile_causes, reprs
from tpustream_torch import (
    JobServer,
    RuleSet,
    RuleUpdate,
    StreamExecutionEnvironment,
    TenantPlan,
    TenantQuota,
    Tuple2,
)
from tpustream_torch.broadcast.rules import TENANT_VALUES_KEY
from tpustream_torch.config import ObsConfig, StreamConfig
from tpustream_torch.jobs import chapter6_tenant_fleet as c6
from tpustream_torch.obs import MetricsServer, TenantSLO
from tpustream_torch.runtime.sources import ReplaySource
from tpustream_torch.tenancy import TenantShapeError
from tpustream_torch.tenancy.server import TENANT_SEP

pytestmark = pytest.mark.fresh_cache


def cpu(**over) -> StreamConfig:
    return StreamConfig(device="cpu", **over)


def make_server(capacity=64, batch_size=8, obs=False, ckdir=None,
                injector=None, **over):
    cfg = cpu(batch_size=batch_size, **over)
    if obs:
        cfg = cfg.replace(obs=ObsConfig(enabled=True))
    if ckdir is not None:
        cfg = cfg.replace(checkpoint_dir=str(ckdir), checkpoint_interval_batches=1)
    if injector is not None:
        cfg = injector.install(cfg)
    return JobServer(c6.make_plan(capacity), config=cfg)


def run_solo(lines, updates, batch_size=8):
    """The SAME job a tenant runs, alone: the chapter-6 template chain
    with its rule timeline as a plain chapter-5 broadcast schedule
    (``updates``: [(after_records, value)], the initial threshold at
    position 0 included)."""
    env = StreamExecutionEnvironment(cpu(batch_size=batch_size))
    rules = c6.make_rules()
    env.add_source(ReplaySource(
        [RuleUpdate("threshold", v, pos) for pos, v in updates]
    )).broadcast(rules)
    handle = c6.build(
        env.from_collection(lines).map(c6.parse), rules
    ).collect()
    env.execute("solo")
    return handle.items


@pytest.fixture
def builds(monkeypatch):
    """Counts the port's program builds: a one-element list."""
    n = [0]
    plain = torch_executor.build_program

    def counted(plan, cfg):
        n[0] += 1
        return plain(plan, cfg)

    monkeypatch.setattr(torch_executor, "build_program", counted)
    return n


def compile_count(result) -> int:
    series = result.metrics.obs_snapshot()["metrics"]["series"]
    return sum(s["value"] for s in series
               if s["name"] == "operator_compile_count")


# ---------------------------------------------------------------------------
# the JAX suite's single-device cases
# ---------------------------------------------------------------------------
def test_64_tenants_one_program_zero_recompiles(builds):
    thresholds = {f"t{i:02d}": 80.0 + (i % 20) for i in range(64)}
    srv = make_server(capacity=64, batch_size=64, obs=True)
    for tenant, thr in thresholds.items():
        srv.add_tenant(tenant, rules={"threshold": thr})
    per_tenant = {t: c6.tenant_lines(t, 8) for t in thresholds}
    for i in range(8):
        for t in thresholds:
            srv.ingest(t, [per_tenant[t][i]])
    res = srv.run("fleet-64")
    for tenant, thr in thresholds.items():
        want = c6.expected(tenant, per_tenant[tenant], thr, [(0, thr)])
        assert reprs(srv.output(tenant)) == reprs(want), tenant
    assert recompile_causes(res, "config_change") == []
    assert recompile_causes(res, "tenant_capacity_growth") == []
    # "one program" is a build count here: counted directly, and equal
    # to what the build registry reports
    assert builds[0] == 1 == compile_count(res)


@pytest.mark.parametrize("batch_size", [3, 8, 64])
def test_demux_output_batch_size_invariant(batch_size):
    thresholds = {"a": 85.0, "b": 92.0}
    srv = make_server(batch_size=batch_size)
    for t, thr in thresholds.items():
        srv.add_tenant(t, rules={"threshold": thr})
        srv.ingest(t, c6.tenant_lines(t, 10))
    srv.run("fleet-bs")
    for t, thr in thresholds.items():
        want = c6.expected(t, c6.tenant_lines(t, 10), thr, [(0, thr)])
        assert reprs(srv.output(t)) == reprs(want)


def test_per_tenant_output_byte_identical_to_solo_run():
    srv = make_server(batch_size=4)
    fleets = {"acme": 84.0, "globex": 90.0, "initech": 96.0}
    lines = {t: c6.tenant_lines(t, 12, base=78.0 + i * 2)
             for i, t in enumerate(fleets)}
    for t, thr in fleets.items():
        srv.add_tenant(t, rules={"threshold": thr})
        srv.ingest(t, lines[t][:6])
    srv.update_tenant_rules("globex", {"threshold": 79.0})
    for t in fleets:
        srv.ingest(t, lines[t][6:])
    srv.run("fleet-parity")
    for t, thr in fleets.items():
        updates = [(0, thr)]
        if t == "globex":
            updates.append((6, 79.0))
        solo = run_solo(lines[t], updates)
        assert reprs(srv.output(t)) == reprs(solo), t
        assert reprs(solo) == reprs(c6.expected(t, lines[t], thr, updates)), t


def test_hot_add_remove_update_mid_stream_record_exact(builds):
    srv = make_server(batch_size=4, obs=True)
    srv.add_tenant("early", rules={"threshold": 85.0})
    srv.ingest("early", c6.tenant_lines("early", 8))
    srv.add_tenant("late", rules={"threshold": 88.0})
    srv.ingest("late", c6.tenant_lines("late", 8))
    srv.update_tenant_rules("early", {"threshold": 99.0})
    srv.ingest("early", c6.tenant_lines("early", 8, base=90.0))
    srv.remove_tenant("late")
    srv.ingest("late", c6.tenant_lines("late", 8, base=99.0))
    res = srv.run("fleet-hot")
    n_builds = builds[0]

    early_lines = c6.tenant_lines("early", 8) + c6.tenant_lines(
        "early", 8, base=90.0)
    assert reprs(srv.output("early")) == reprs(
        run_solo(early_lines, [(0, 85.0), (8, 99.0)]))
    assert reprs(srv.output("late")) == reprs(
        run_solo(c6.tenant_lines("late", 8), [(0, 88.0)]))
    assert recompile_causes(res, "config_change") == []
    assert n_builds == 1 == compile_count(res)
    series = res.metrics.obs_snapshot()["metrics"]["series"]
    rv = [s for s in series if s["name"] == "tenant_rule_version"]
    assert {s["labels"].get("tenant") for s in rv} == {"early"}
    assert [s for s in series if s["labels"].get("tenant") == "late"] == []


def test_quota_breach_side_output_does_not_perturb_others():
    srv = make_server(batch_size=4, obs=True)
    srv.add_tenant("noisy", rules={"threshold": 0.0},
                   quota=TenantQuota(max_records=5))
    srv.add_tenant("quiet", rules={"threshold": 85.0})
    noisy = c6.tenant_lines("noisy", 12)
    quiet = c6.tenant_lines("quiet", 12)
    for i in range(12):
        srv.ingest("noisy", [noisy[i]])
        srv.ingest("quiet", [quiet[i]])
    res = srv.run("fleet-quota")
    assert reprs(srv.output("noisy")) == reprs(
        c6.expected("noisy", noisy[:5], 0.0, [(0, 0.0)]))
    assert srv.quota_output("noisy") == noisy[5:]
    assert reprs(srv.output("quiet")) == reprs(run_solo(quiet, [(0, 85.0)]))
    assert srv.quota_output("quiet") == []
    series = res.metrics.obs_snapshot()["metrics"]["series"]
    by = {(s["name"], s["labels"].get("tenant")): s["value"] for s in series}
    assert by[("tenant_records_total", "noisy")] == 5
    assert by[("tenant_quota_exceeded_total", "noisy")] == 7
    assert by[("tenant_records_total", "quiet")] == 12
    assert by[("tenant_quota_exceeded_total", "quiet")] == 0
    assert by[("tenant_count", None)] == 2


def _noisy_fleet(obs, slo=None):
    """64 tenants; ``t00`` floods 20x its quota (160 offered, 8
    admitted)."""
    thresholds = {f"t{i:02d}": 80.0 + (i % 20) for i in range(64)}
    srv = make_server(capacity=64, batch_size=64, obs=obs)
    lines = {}
    for tenant, thr in thresholds.items():
        if tenant == "t00":
            srv.add_tenant(tenant, rules={"threshold": thr},
                           quota=TenantQuota(max_records=8))
            lines[tenant] = c6.tenant_lines(tenant, 160)
        else:
            srv.add_tenant(tenant, rules={"threshold": thr})
            lines[tenant] = c6.tenant_lines(tenant, 8)
        if slo is not None:
            srv.set_tenant_slo(tenant, slo)
        srv.ingest(tenant, lines[tenant])
    return srv, thresholds, lines


def test_noisy_neighbor_flooder_crit_others_ok():
    slo = TenantSLO(p99_ms=1e6, max_error_rate=0.01, budget_window_s=60.0)
    srv, thresholds, lines = _noisy_fleet(obs=True, slo=slo)
    res = srv.run("fleet-noisy")

    snap = res.metrics.obs_snapshot()
    err = {s["labels"]["tenant"]: s["value"] for s in snap["metrics"]["series"]
           if s["name"] == "tenant_error_rate"}
    assert err["t00"] == pytest.approx(152 / 160)
    assert all(err[t] == 0.0 for t in thresholds if t != "t00")

    rules = {r["rule"]: r for r in snap["health"]["rules"]}
    flood = rules["slo_err[t00]"]
    assert flood["level"] == "crit"
    assert flood["labels"] == {"tenant": "t00"}
    assert flood["budget_burn"] == pytest.approx(1.0)
    ok = [t for t in thresholds if t != "t00"
          and rules[f"slo_err[{t}]"]["level"] == "ok"
          and rules[f"slo_p99[{t}]"]["level"] == "ok"]
    assert len(ok) == 63
    state = {(s["labels"].get("rule"), s["labels"].get("tenant")): s["value"]
             for s in snap["metrics"]["series"]
             if s["name"] == "health_rule_state"}
    assert state[("slo_err[t00]", "t00")] == 2
    assert state[("slo_err[t01]", "t01")] == 0
    flight = srv.env.metrics.job_obs.flight
    assert any(e["kind"] == "health_transition"
               and e["rule"] == "slo_err[t00]" and e["to"] == "crit"
               for e in flight.tenant_events("t00"))
    assert flight.tenant_events("t01") == []

    server = MetricsServer(srv.env.metrics.job_obs, port=0).start()
    try:
        body = urllib.request.urlopen(
            server.url + "/tenants.json", timeout=5).read()
    finally:
        server.close()
    view = json.loads(body.decode("utf-8"))
    assert view["tenant_count"] == 64
    flood_view = view["tenants"]["t00"]
    assert flood_view["quota_exceeded"] == 152
    assert flood_view["error_rate"] == pytest.approx(152 / 160)
    assert flood_view["health"]["slo_err[t00]"]["level"] == "crit"
    ok_view = [t for t, e in view["tenants"].items() if t != "t00"
               and all(r["level"] == "ok" for r in e["health"].values())]
    assert len(ok_view) == 63

    plain, _, _ = _noisy_fleet(obs=False)
    plain.run("fleet-noisy-plain")
    for t in thresholds:
        assert reprs(srv.output(t)) == reprs(plain.output(t)), t
    assert srv.quota_output("t00") == plain.quota_output("t00")
    assert srv.quota_output("t00") == lines["t00"][8:]


def test_tenant_capacity_growth_cause_tagged(builds):
    srv = make_server(capacity=4, batch_size=4, obs=True)
    lines = {}
    for i in range(6):
        t = f"t{i}"
        srv.add_tenant(t, rules={"threshold": 82.0 + i})
        lines[t] = c6.tenant_lines(t, 6)
        srv.ingest(t, lines[t])
    res = srv.run("fleet-grow")
    assert srv.plan.rules.tenant_capacity == 8
    for i in range(6):
        t = f"t{i}"
        want = c6.expected(t, lines[t], 82.0 + i, [(0, 82.0 + i)])
        assert reprs(srv.output(t)) == reprs(want), t
    grown = [e for e in res.metrics.job_obs.flight.events()
             if e["kind"] == "tenant_capacity_grown"]
    assert grown and grown[-1]["old_capacity"] == 4
    assert grown[-1]["new_capacity"] == 8
    assert recompile_causes(res, "tenant_capacity_growth")
    assert recompile_causes(res, "config_change") == []
    # the growth reshaped the rule leaves: no program was rebuilt
    assert builds[0] == 1 and compile_count(res) == 2


def _kv_parse(line):
    items = line.split(" ")
    return Tuple2(items[0], float(items[1]))


def _kv_build(stream, rules):
    return stream.key_by(0).sum(1)


def _kv_plan(capacity=4):
    rules = RuleSet()
    rules.declare("unused", 0.0, "f64")
    return TenantPlan(parse=_kv_parse, build=_kv_build, rules=rules,
                      tenant_capacity=capacity)


def _two_kv_tenants(srv):
    srv.add_tenant("a")
    srv.add_tenant("b")
    a_lines = [f"k{i % 2} {i}" for i in range(8)]
    b_lines = [f"k{i % 2} {10 * i}" for i in range(8)]
    for i in range(8):
        srv.ingest("a", [a_lines[i]])
        srv.ingest("b", [b_lines[i]])
    return a_lines, b_lines


def test_keyed_fleet_namespaces_rolling_state_per_tenant():
    srv = JobServer(_kv_plan(), config=cpu(batch_size=4))
    a_lines, b_lines = _two_kv_tenants(srv)
    srv.run("fleet-keyed")

    def solo(lines):
        env = StreamExecutionEnvironment(cpu(batch_size=4))
        h = _kv_build(env.from_collection(lines).map(_kv_parse), None).collect()
        env.execute("solo-keyed")
        return h.items

    assert reprs(srv.output("a")) == reprs(solo(a_lines))
    assert reprs(srv.output("b")) == reprs(solo(b_lines))


def _expand(line):
    return line.split("|")


def test_fleet_flat_map_solo_parity():
    def tpl(stream, rules):
        threshold = rules.param("threshold")
        return stream.flat_map(_expand).filter(
            lambda value: value.f2 > threshold)

    plan = TenantPlan(parse=c6.parse, build=tpl, rules=c6.make_rules(),
                      tenant_capacity=4)
    srv = JobServer(plan, config=cpu(batch_size=4))
    thresholds = {"ta": 85.0, "tb": 95.0}
    for tenant, thr in thresholds.items():
        srv.add_tenant(tenant, rules={"threshold": thr})
    compound = {
        t: ["|".join(c6.tenant_lines(t, 8)[i:i + 2]) for i in range(0, 8, 2)]
        for t in thresholds
    }
    for i in range(4):
        for t in thresholds:
            srv.ingest(t, [compound[t][i]])
    srv.run("fleet-flatmap")

    def solo(lines, thr):
        env = StreamExecutionEnvironment(cpu(batch_size=4))
        h = (env.from_collection(lines).flat_map(_expand).map(c6.parse)
             .filter(lambda value, _t=thr: value.f2 > _t).collect())
        env.execute("solo-flatmap")
        return h.items

    for tenant, thr in thresholds.items():
        assert reprs(srv.output(tenant)) == reprs(
            solo(compound[tenant], thr)), tenant


def test_fleet_flat_map_after_parsed_op_rejected():
    bad = TenantPlan(
        parse=c6.parse,
        build=lambda s, r: s.filter(lambda v: v.f2 > 1).flat_map(_expand),
        rules=c6.make_rules(), tenant_capacity=4,
    )
    with pytest.raises(TenantShapeError, match="raw host stage"):
        JobServer(bad, config=cpu(batch_size=4))


class _FleetAvg:
    """Chapter-2 style Avg whose get_result folds in the tenant's
    ``threshold`` row (the port's twin of the JAX suite's, with
    ``torch.where``)."""

    def __init__(self, rules_or_const):
        self._thr = (rules_or_const.param("threshold")
                     if isinstance(rules_or_const, RuleSet)
                     else rules_or_const)

    def create_accumulator(self):
        return Tuple2(0, 0.0)

    def add(self, value, acc):
        return Tuple2(acc.f0 + 1, acc.f1 + value.f1)

    def merge(self, a, b):
        return Tuple2(a.f0 + b.f0, a.f1 + b.f1)

    def get_result(self, acc):
        return torch.where(acc.f0 == 0, 0.0, acc.f1 / acc.f0) + self._thr


def test_fleet_window_aggregate_binds_tenant_rules():
    plan = TenantPlan(
        parse=_kv_parse,
        build=lambda s, r: s.key_by(0).count_window(2).aggregate(_FleetAvg(r)),
        rules=c6.make_rules(), tenant_capacity=4,
    )
    srv = JobServer(plan, config=cpu(batch_size=4))
    srv.add_tenant("a", rules={"threshold": 100.0})
    srv.add_tenant("b", rules={"threshold": 200.0})
    a_lines = [f"k{i % 2} {i}" for i in range(8)]
    b_lines = [f"k{i % 2} {10 * i}" for i in range(8)]
    for i in range(8):
        srv.ingest("a", [a_lines[i]])
        srv.ingest("b", [b_lines[i]])
    srv.run("fleet-agg")

    def solo(lines, thr):
        env = StreamExecutionEnvironment(cpu(batch_size=4))
        h = (env.from_collection(lines).map(_kv_parse).key_by(0)
             .count_window(2).aggregate(_FleetAvg(thr)).collect())
        env.execute("solo-agg")
        return sorted(float(x) for x in h.items)

    got_a = sorted(float(x) for x in srv.output("a"))
    got_b = sorted(float(x) for x in srv.output("b"))
    assert got_a == pytest.approx(solo(a_lines, 100.0))
    assert got_b == pytest.approx(solo(b_lines, 200.0))
    assert all(100.0 <= x < 200.0 for x in got_a)
    assert all(x >= 200.0 for x in got_b)


def test_fleet_window_process_strips_namespace_and_tenant_field():
    seen = []

    def fn(key, ctx, elements, out):
        seen.append((key, list(elements)))
        out.collect(Tuple2(key, sum(e.f1 for e in elements)))

    plan = TenantPlan(
        parse=_kv_parse,
        build=lambda s, r: s.key_by(0).count_window(2).process(fn),
        rules=_kv_plan().rules, tenant_capacity=4,
    )
    srv = JobServer(plan, config=cpu(batch_size=4))
    a_lines, b_lines = _two_kv_tenants(srv)
    srv.run("fleet-process")

    assert seen, "process fn never fired"
    for key, elements in seen:
        assert TENANT_SEP not in key
        assert key in ("k0", "k1")
        for e in elements:
            assert isinstance(e, Tuple2), repr(e)

    def solo(lines):
        env = StreamExecutionEnvironment(cpu(batch_size=4))
        h = (env.from_collection(lines).map(_kv_parse).key_by(0)
             .count_window(2).process(fn).collect())
        env.execute("solo-process")
        return h.items

    assert reprs(srv.output("a")) == reprs(solo(a_lines))
    assert reprs(srv.output("b")) == reprs(solo(b_lines))


def test_ruleset_tenancy_vectors_and_growth():
    rules = RuleSet()
    rules.declare("t", 90.0, "f64")
    rules.enable_tenancy(3)
    assert rules.tenant_capacity == 4
    rules.apply(RuleUpdate("t", 95.0, tenant=1))
    assert rules.tenant_value("t", 1) == 95.0
    assert rules.tenant_value("t", 0) == 90.0
    rules.apply(RuleUpdate("t", 70.0))
    assert [rules.tenant_value("t", s) for s in range(4)] == [70.0] * 4
    rules.apply(RuleUpdate("t", 99.0, tenant=5))
    assert rules.tenant_capacity == 8
    assert rules.tenant_value("t", 5) == 99.0
    assert rules.tenant_value("t", 1) == 70.0
    assert rules.version == 3
    leaves = rules.device_leaves()
    assert tuple(leaves["t"].shape) == (8,)
    vals = rules.values()
    assert vals[TENANT_VALUES_KEY]["capacity"] == 8
    fresh = RuleSet()
    fresh.declare("t", 90.0, "f64")
    fresh.load(vals, rules.version)
    assert fresh.tenant_capacity == 8
    assert fresh.tenant_value("t", 5) == 99.0
    rules.reset()
    assert rules.version == 0
    assert rules.tenant_capacity == 8
    assert rules.tenant_value("t", 5) == 90.0


def test_ruleset_tenancy_guards():
    rules = RuleSet()
    rules.declare("t", 1.0)
    with pytest.raises(RuntimeError, match="enable_tenancy"):
        rules.ensure_tenant_slot(0)
    with pytest.raises(RuntimeError, match="tenancy is not enabled"):
        rules.apply(RuleUpdate("t", 2.0, tenant=0))
    with pytest.raises(ValueError, match=">= 1"):
        rules.enable_tenancy(0)
    rules.enable_tenancy(4)
    with pytest.raises(ValueError, match=">= 0"):
        rules.ensure_tenant_slot(-1)


def test_tenant_plan_shape_verification():
    plan = c6.make_plan()
    plan.verify(c6.build)
    with pytest.raises(TenantShapeError):
        plan.verify(lambda s, r: s.map(lambda v: v))
    with pytest.raises(TenantShapeError):
        plan.verify(lambda s, r: s.filter(lambda v: v.f2 > 1).filter(
            lambda v: v.f2 > 2))
    srv = JobServer(c6.make_plan(), config=cpu())
    srv.add_tenant("ok", build=c6.build)
    with pytest.raises(TenantShapeError):
        srv.add_tenant("bad", build=lambda s, r: s.map(lambda v: v))


def test_key_field_inference_and_guards():
    assert _kv_plan().inferred_key_field() == 0
    plan = TenantPlan(parse=_kv_parse, build=_kv_build, rules=RuleSet(),
                      key_field=1)
    assert plan.inferred_key_field() == 1
    bad = TenantPlan(parse=_kv_parse,
                     build=lambda s, r: s.key_by(lambda v: v.f0).sum(1),
                     rules=RuleSet())
    with pytest.raises(TenantShapeError, match="key_field"):
        bad.inferred_key_field()


def test_job_server_admission_guards():
    srv = JobServer(c6.make_plan(), config=cpu())
    srv.add_tenant("a")
    with pytest.raises(ValueError, match="already admitted"):
        srv.add_tenant("a")
    with pytest.raises(KeyError, match="unknown tenant"):
        srv.ingest("nope", ["x"])
    with pytest.raises(KeyError, match="unknown tenant"):
        srv.update_tenant_rules("nope", {"threshold": 1.0})
    assert TenantQuota(max_records=2).admits(1)
    assert not TenantQuota(max_records=2).admits(2)
    assert TenantQuota().admits(10**9)


def test_package_exports_and_javacompat_aliases():
    for name in ("JobServer", "TenantPlan", "TenantQuota", "TenantSLO",
                 "MetricsServer"):
        assert getattr(T, name) is getattr(jc, name)
        assert name in T.__all__
    srv = JobServer(c6.make_plan(), config=cpu())
    assert srv.addTenant == srv.add_tenant
    assert srv.removeTenant == srv.remove_tenant
    assert srv.updateTenantRules == srv.update_tenant_rules


# ---------------------------------------------------------------------------
# side by side with the JAX package
# ---------------------------------------------------------------------------
PKGS = {
    "jax": types.SimpleNamespace(
        pkg=tpustream, c6=jax_c6, cfg=lambda **kw: jax_config.StreamConfig(**kw)),
    "torch": types.SimpleNamespace(pkg=T, c6=c6, cfg=cpu),
}


def _seeded_fleet(side, seed, batch_size):
    """A fleet driven by a seeded schedule: 12 tenants with random
    thresholds, 8 admitted up front and 4 after ingestion began, random
    quotas, threshold updates at random positions, two removals, and
    round-robin ingestion in random-sized blocks."""
    ns = PKGS[side]
    rng = random.Random(seed)
    srv = ns.pkg.JobServer(ns.c6.make_plan(4),
                           config=ns.cfg(batch_size=batch_size))
    tenants = [f"f{i:02d}" for i in range(12)]
    lines = {t: ns.c6.tenant_lines(t, 24, base=70.0 + rng.random() * 20)
             for t in tenants}
    cursor = {t: 0 for t in tenants}

    def admit(t):
        q = rng.choice([None, None, rng.randint(3, 20)])
        srv.add_tenant(
            t, rules={"threshold": round(75.0 + rng.random() * 25, 3)},
            quota=ns.pkg.TenantQuota(max_records=q) if q else None)

    for t in tenants[:8]:
        admit(t)
    live = list(tenants[:8])
    for rnd in range(12):
        if rnd == 3:
            for t in tenants[8:]:
                admit(t)
                live.append(t)
        for t in list(live):
            k = rng.randint(0, 3)
            srv.ingest(t, lines[t][cursor[t]:cursor[t] + k])
            cursor[t] += k
        if rnd in (2, 5, 8):
            t = rng.choice(live)
            srv.update_tenant_rules(
                t, {"threshold": round(70.0 + rng.random() * 30, 3)})
        if rnd in (6, 9):
            t = rng.choice(live)
            srv.remove_tenant(t)
            live.remove(t)
    srv.run("seeded-fleet")
    return srv, tenants


@pytest.mark.parametrize("batch_size", [1, 3, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_fleet_matches_the_jax_package(seed, batch_size):
    jsrv, tenants = _seeded_fleet("jax", seed, batch_size)
    tsrv, _ = _seeded_fleet("torch", seed, batch_size)
    outputs = tsrv.outputs()
    assert sorted(outputs) == sorted(tsrv.tenants())
    for t in tenants:
        assert reprs(tsrv.output(t)) == reprs(jsrv.output(t)), t
        assert reprs(outputs.get(t, [])) == reprs(tsrv.output(t)), t
        assert tsrv.quota_output(t) == jsrv.quota_output(t), t
    assert tsrv.state_dict() == jsrv.state_dict()
    assert tsrv.plan.rules.tenant_capacity == jsrv.plan.rules.tenant_capacity


def _scaled_plan(ns, capacity=4):
    """A template that uses tenant rules in arithmetic: each record's
    usage is scaled by the tenant's ``factor`` and divided by its
    ``scale``, then compared with its ``threshold``. (A multiply then an
    add would not be bitwise: XLA's CPU backend contracts ``x * f + b``
    into one fused multiply-add, which torch's eager ops do not.)"""
    rules = ns.c6.make_rules()
    rules.declare("factor", 1.0, "f64")
    rules.declare("scale", 1.0, "f64")

    def tpl(stream, r):
        factor, scale = r.param("factor"), r.param("scale")
        thr = r.param("threshold")
        return stream.map(
            lambda v: ns.pkg.Tuple3(v.f0, v.f1, v.f2 * factor / scale)
        ).filter(lambda v: v.f2 > thr)

    return ns.pkg.TenantPlan(parse=ns.c6.parse, build=tpl, rules=rules,
                             tenant_capacity=capacity)


@pytest.mark.parametrize("batch_size", [3, 64])
def test_tenant_rule_in_arithmetic_is_bitwise(batch_size):
    outs = {}
    for side in ("jax", "torch"):
        ns = PKGS[side]
        srv = ns.pkg.JobServer(_scaled_plan(ns),
                               config=ns.cfg(batch_size=batch_size))
        for i in range(5):
            t = f"s{i}"
            srv.add_tenant(t, rules={"factor": 1.0 + 0.1 * i + 1e-3,
                                     "scale": 0.3 + 0.7 * i,
                                     "threshold": 84.3 / (0.3 + 0.7 * i)})
            srv.ingest(t, ns.c6.tenant_lines(t, 20, base=75.0 + i))
        srv.update_tenant_rules("s2", {"factor": 0.987654321})
        for i in range(5):
            srv.ingest(f"s{i}", ns.c6.tenant_lines(f"s{i}", 10, base=80.0))
        srv.run("scaled")
        outs[side] = {f"s{i}": reprs(srv.output(f"s{i}")) for i in range(5)}
    assert all(outs["torch"].values())
    assert outs["torch"] == outs["jax"]


def test_admission_at_exactly_the_capacity_edge(builds):
    """Slots 0-3 fill a capacity-4 fleet with no growth; the tenant
    admitted at slot 4 (the old capacity, mid-stream) grows the rule
    vectors once, before its first record reaches the device, and every
    tenant's output equals the JAX package's."""
    outs = {}
    for side in ("jax", "torch"):
        ns = PKGS[side]
        cfg = ns.cfg(batch_size=4)
        cfg = cfg.replace(obs=cfg.obs.replace(enabled=True))
        srv = ns.pkg.JobServer(ns.c6.make_plan(4), config=cfg)
        for i in range(4):
            srv.add_tenant(f"e{i}", rules={"threshold": 84.0 + i})
            srv.ingest(f"e{i}", ns.c6.tenant_lines(f"e{i}", 5))
        srv.add_tenant("edge", rules={"threshold": 70.0})
        srv.ingest("edge", ns.c6.tenant_lines("edge", 7))
        res = srv.run("edge")
        grown = [e for e in res.metrics.job_obs.flight.events()
                 if e["kind"] == "tenant_capacity_grown"]
        assert [(e["old_capacity"], e["new_capacity"]) for e in grown] == [(4, 8)]
        outs[side] = {t: reprs(srv.output(t)) for t in srv.tenants()}
        if side == "torch":
            assert builds[0] == 1
            assert len(recompile_causes(res, "tenant_capacity_growth")) == 1
    assert outs["torch"]["edge"] == reprs(
        c6.expected("edge", c6.tenant_lines("edge", 7), 70.0, [(0, 70.0)]))
    assert outs["torch"] == outs["jax"]


def test_build_count_equals_the_build_registry(builds):
    """Every path that builds a program goes through the registry: a
    chained job (two stages, two builds) and a fleet count the same
    builds both ways."""
    env = StreamExecutionEnvironment(cpu(batch_size=4, obs=ObsConfig(enabled=True)))
    (env.from_collection([f"k{i % 3} {i}" for i in range(12)])
     .map(_kv_parse).key_by(0).sum(1).key_by(0).max(1).collect())
    res = env.execute("chained")
    assert builds[0] == 2 == compile_count(res)
    builds[0] = 0
    srv = make_server(capacity=4, batch_size=4, obs=True)
    srv.add_tenant("x", rules={"threshold": 85.0})
    srv.ingest("x", c6.tenant_lines("x", 6))
    assert builds[0] == 0
    res = srv.run("fleet-builds")
    assert builds[0] == 1 == compile_count(res)


def test_chapter6_main_runs_on_the_cpu(monkeypatch, capsys):
    """The chapter-6 job's demo entry point, its fleet on the CPU."""
    plain = c6.make_fleet

    def on_cpu(thresholds, quotas=None, tenant_capacity=64, config=None):
        return plain(thresholds, quotas, tenant_capacity, config=cpu())

    monkeypatch.setattr(c6, "make_fleet", on_cpu)
    c6.main(n_tenants=4, records_per_tenant=8)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[0].startswith("tenant00: ")


# -- durability: tenant_apply crash recovery and the checkpoint meta ----------

def _durable_fleet(ckdir=None, injector=None):
    srv = make_server(batch_size=4, ckdir=ckdir, injector=injector)
    srv.add_tenant("acme", rules={"threshold": 84.0})
    srv.add_tenant("globex", rules={"threshold": 92.0})
    for t in ("acme", "globex"):
        srv.ingest(t, c6.tenant_lines(t, 8))
    srv.update_tenant_rules("acme", {"threshold": 95.0})
    for t in ("acme", "globex"):
        srv.ingest(t, c6.tenant_lines(t, 8, base=88.0))
    return srv


def test_tenant_apply_crash_recovers_byte_identical(tmp_path):
    """A crash between a tenant-scoped rule write and the next data
    batch: the supervised restart restores the tenant table and rule
    vectors from the checkpoint, replays, and re-applies the update at
    the same boundary; per-tenant output equals an uninterrupted
    fleet's, with no double apply."""
    from tpustream_torch.runtime.supervisor import fixed_delay
    from tpustream_torch.testing import FaultInjector, FaultPoint

    clean = _durable_fleet()
    clean.run("fleet-clean")
    inj = FaultInjector(FaultPoint("tenant_apply", at=1))
    srv = _durable_fleet(ckdir=tmp_path, injector=inj)
    srv.run("fleet-faulted", restart_strategy=fixed_delay(3, 0.0))
    assert inj.fired == 1
    for t in ("acme", "globex"):
        assert reprs(srv.output(t)) == reprs(clean.output(t)), t
    assert srv.plan.rules.tenant_value("threshold", 0) == 95.0
    assert srv.plan.rules.tenant_value("threshold", 1) == 92.0


def test_checkpoint_carries_tenant_table_and_rule_vectors(tmp_path):
    import glob
    import os

    from tpustream_torch.runtime.checkpoint import FORMAT_VERSION, load_checkpoint

    assert FORMAT_VERSION == 12
    srv = _durable_fleet(ckdir=tmp_path)
    srv.run("fleet-ckpt")
    snaps = sorted(glob.glob(os.path.join(str(tmp_path), "ckpt-*.npz")))
    assert snaps
    ck = load_checkpoint(snaps[-1])
    assert ck.tenancy is not None
    assert ck.tenancy["tenants"] == {"acme": 0, "globex": 1}
    assert ck.tenancy["capacity"] == 64
    vecs = ck.rule_values[TENANT_VALUES_KEY]
    assert vecs["capacity"] == 64
    assert vecs["vectors"]["threshold"][0] == 95.0
    assert vecs["vectors"]["threshold"][1] == 92.0
    # the rule vectors round-trip through a fresh RuleSet
    rules = c6.make_rules()
    rules.load(ck.rule_values, ck.rule_version)
    assert rules.tenant_value("threshold", 0) == 95.0
    assert rules.version == ck.rule_version
