"""The pre-flight plan analyzer of the PyTorch port
(``tpustream_torch/analysis``), side by side with the JAX package's.

Counterparts of tests/test_analysis.py's contracts, one test each. Every
job is built in both packages from the same code (``build(P)`` with
``P`` either package) and must give the same findings letter for letter:
``[str(f) for f in env.analyze()]``, node reprs included, since both
graphs are built with one node-id counter start. The one normalization:
the port's package name ``tpustream_torch`` is read as ``tpustream``
where a message or fix hint names a file of the package (TSM015's
catalog path) or a job module (the lint CLI's output). Then the
reference test's own contract is checked on the port's findings:

* every plan-lint rule has a broken job that produces its exact code and
  a clean job that does not;
* the purity analyzer flags mutable closures, nondeterministic calls,
  device side effects, host callbacks and dtype-widening maps;
* ``strict_analysis=True`` raises PlanAnalysisError at submission,
  before any program is built;
* with obs on, findings surface as ``analysis_findings_total{code=...}``
  counters and flight breadcrumbs;
* ``python -m tpustream_torch.analysis.lint`` exits 0/1/2 as the
  reference's does, and all nine of the port's chapter jobs self-lint
  with zero errors.
"""

import importlib
import io
import itertools
import json
import types

import numpy as np
import pytest

import tpustream
import tpustream_torch

NAMES = {"jax": "tpustream", "torch": "tpustream_torch"}
_START = itertools.count(1)


def _pkg(side):
    name = NAMES[side]
    root = importlib.import_module(name)

    def mod(path):
        return importlib.import_module(f"{name}.{path}")

    extra = {"device": "cpu"} if side == "torch" else {}

    def cfg(**kw):
        return root.StreamConfig(**kw, **extra)

    def env(**kw):
        return root.StreamExecutionEnvironment(cfg(**kw))

    return types.SimpleNamespace(
        side=side, name=name, root=root, mod=mod, cfg=cfg, env=env,
        parse=mod("jobs.chapter1_threshold").parse,
        ObsConfig=mod("config").ObsConfig, **{
            k: getattr(root, k) for k in (
                "CEP", "OutputTag", "Pattern", "PlanAnalysisError",
                "StreamExecutionEnvironment", "Time", "TimeCharacteristic",
                "Tuple3")})


PK = {side: _pkg(side) for side in NAMES}


def norm(text: str) -> str:
    """The port's package name read as the reference's."""
    return text.replace("tpustream_torch", "tpustream")


def each_package(call):
    """``call(P)`` in both packages, each with its graph's node ids
    counted from one start: ``{side: result}``."""
    start = 1_000_000 * next(_START)
    out = {}
    for side, P in PK.items():
        graph = P.mod("api.graph")
        saved = graph._ids
        graph._ids = itertools.count(start)
        try:
            out[side] = call(P)
        finally:
            graph._ids = saved
    return out


def build_both(build):
    """``build(P)`` in both packages, from one node-id start:
    ``{side: env}``."""
    return each_package(build)


def analyze_both(build):
    """The port's findings of ``build``'s graph, after holding them
    letter for letter against the JAX package's."""
    envs = build_both(build)
    want = [str(f) for f in envs["jax"].analyze()]
    got = envs["torch"].analyze()
    assert [norm(str(f)) for f in got] == want
    return got


def codes(findings):
    return [f.code for f in findings]


def good_job(P, env=None):
    """A clean chapter-2-style windowed job: parse -> key -> window sum."""
    env = env or P.env()
    (
        env.from_collection([])
        .map(P.parse)
        .key_by(0)
        .time_window(P.Time.seconds(5))
        .sum(2)
        .print()
    )
    return env


def good(**cfg):
    return lambda P: good_job(P, P.env(**cfg))


# ---------------------------------------------------------------------------
# plan-lint rules: broken job -> exact code; clean job -> silent
# ---------------------------------------------------------------------------


def test_port_clean_job_has_no_findings():
    found = analyze_both(good_job)
    analysis = tpustream_torch.analysis
    assert not analysis.has_errors(found)
    assert found == []


def test_port_tsm001_stateful_without_key_by():
    def build(P):
        env = P.env()
        stream = env.from_collection([]).map(P.parse)
        P.mod("api.datastream").KeyedStream(env, stream.node).max(2).print()
        return env

    found = analyze_both(build)
    assert "TSM001" in codes(found)
    assert "TSM014" not in codes(found)


def test_port_tsm002_event_time_window_without_assigner():
    def build(P):
        env = P.env()
        env.set_stream_time_characteristic(P.TimeCharacteristic.EventTime)
        good_job(P, env)
        return env

    found = analyze_both(build)
    assert next(f for f in found if f.code == "TSM002").severity == "error"


def test_port_tsm003_side_output_tag_collision():
    def build(P):
        env = P.env()
        env.set_stream_time_characteristic(P.TimeCharacteristic.EventTime)
        tag = P.OutputTag("late")
        text = env.from_collection([]).map(P.parse)
        for _ in range(2):
            (
                text.key_by(0)
                .time_window(P.Time.seconds(5))
                .allowed_lateness(P.Time.seconds(1))
                .side_output_late_data(tag)
                .sum(2)
                .print()
            )
        return env

    assert "TSM003" in codes(analyze_both(build))


def test_port_tsm004_timeout_tag_without_within():
    def build(P):
        env = P.env()
        pattern = P.Pattern.begin("a").where(lambda r: r.f2 > 0).times(2)
        keyed = env.from_collection([]).map(P.parse).key_by(0)
        alerts = P.CEP.pattern(keyed, pattern).select(
            lambda m: m["a"][0], timeout_tag=P.OutputTag("to"))
        alerts.print()
        alerts.get_side_output(P.OutputTag("to")).print()
        return env

    assert "TSM004" in codes(analyze_both(build))


def test_port_tsm004_lateness_on_processing_time():
    def build(P):
        env = P.env()
        (
            env.from_collection([]).map(P.parse).key_by(0)
            .time_window(P.Time.seconds(5))
            .allowed_lateness(P.Time.seconds(2))
            .sum(2).print()
        )
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM004")
    assert "processing-time" in f.message


def test_port_tsm005_nonreplayable_source_under_restart():
    def build(P):
        env = P.env(restart_strategy=P.mod("runtime.supervisor").fixed_delay(3))
        text = env.socket_text_stream("localhost", 19999)
        text.map(P.parse).filter(lambda v: v.f2 > 90).print()
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM005")
    assert f.severity == "error"
    assert "SocketTextSource" in f.message


def test_port_tsm005_silent_for_replayable_source():
    found = analyze_both(lambda P: good_job(
        P, P.env(restart_strategy=P.mod("runtime.supervisor").fixed_delay(3))))
    assert "TSM005" not in codes(found)


def test_port_tsm006_compaction_on_mesh():
    f = next(f for f in analyze_both(good(parallelism=2, compaction_capacity=128))
             if f.code == "TSM006")
    assert f.severity == "warn"
    f = next(f for f in analyze_both(good(parallelism=2)) if f.code == "TSM006")
    assert f.severity == "info"
    assert "TSM006" not in codes(analyze_both(good(compaction_capacity=128)))


def _fleet(P):
    c6 = P.mod("jobs.chapter6_tenant_fleet")
    server = c6.make_fleet({"t0": 90.0})
    env = P.StreamExecutionEnvironment(server.config)
    server.build_job(env)
    return server, env


def test_port_tsm008_tenant_chain_drift():
    servers = {}

    def build(P):
        servers[P.side], env = _fleet(P)
        return env

    envs = build_both(build)
    assert [str(f) for f in envs["jax"].analyze()] == []
    assert envs["torch"].analyze() == []

    # swap the fleet template out from under the built chain
    for side, P in PK.items():
        servers[side].plan = P.mod("tenancy").TenantPlan(
            parse=lambda s: s,
            build=lambda stream, rules: stream.filter(lambda v: True).map(
                lambda v: v),
            rules=P.mod("jobs.chapter6_tenant_fleet").make_rules(),
        )
    want = [str(f) for f in envs["jax"].analyze()]
    got = envs["torch"].analyze()
    assert [norm(str(f)) for f in got] == want
    assert next(f for f in got if f.code == "TSM008").severity == "error"


def test_port_tsm008_tolerates_leading_flat_map():
    servers = {}

    def plan(P, build):
        c6 = P.mod("jobs.chapter6_tenant_fleet")
        return P.root.TenantPlan(parse=c6.parse, build=build,
                                 rules=c6.make_rules(), tenant_capacity=4)

    def build(P):
        server = P.root.JobServer(plan(P, lambda s, r: s.flat_map(
            lambda line: line.split("|")).filter(
                lambda v: v.f2 > r.param("threshold"))), config=P.cfg())
        server.add_tenant("t0", rules={"threshold": 90.0})
        env = P.StreamExecutionEnvironment(server.config)
        server.build_job(env)
        servers[P.side] = server
        return env

    envs = build_both(build)
    assert [str(f) for f in envs["jax"].analyze()] == [
        norm(str(f)) for f in envs["torch"].analyze()]
    assert "TSM008" not in codes(envs["torch"].analyze())
    for side, P in PK.items():
        servers[side].plan = plan(P, lambda s, r: s.flat_map(
            lambda line: line.split("|")).map(lambda v: v))
    want = [str(f) for f in envs["jax"].analyze()]
    got = envs["torch"].analyze()
    assert [norm(str(f)) for f in got] == want
    assert "TSM008" in codes(got)


def test_port_tsm009_fetch_group_exceeds_window():
    assert "TSM009" in codes(analyze_both(good(async_depth=2, fetch_group=4)))
    assert "TSM009" not in codes(analyze_both(good(async_depth=4, fetch_group=2)))


def test_port_tsm010_window_process_forces_depth_one():
    def build(P):
        env = P.env(async_depth=2)
        (
            env.from_collection([]).map(P.parse).key_by(0)
            .time_window(P.Time.seconds(5))
            .process(lambda key, ctx, elems: []).print()
        )
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM010")
    assert f.severity == "info"


def test_port_tsm011_adaptive_bounds():
    def job(bounds):
        return lambda P: good_job(P, P.env(obs=P.ObsConfig(
            enabled=True, adaptive=True, adaptive_bounds=bounds)))

    f = next(f for f in analyze_both(job({"async_depth": (5, 2)}))
             if f.code == "TSM011")
    assert f.severity == "error"
    f = next(f for f in analyze_both(job({"warp_factor": (1, 2)}))
             if f.code == "TSM011")
    assert f.severity == "warn"


def test_port_tsm012_grouped_fetch_coarsens_latency():
    f = next(f for f in analyze_both(lambda P: good_job(P, P.env(
        obs=P.ObsConfig(enabled=True), async_depth=4, fetch_group=2)))
        if f.code == "TSM012")
    assert f.severity == "info"
    assert "per-group averages" in f.message
    assert "TSM012" not in codes(analyze_both(
        lambda P: good_job(P, P.env(obs=P.ObsConfig(enabled=True)))))


def test_port_tsm013_unproduced_side_output_tag():
    def build(P):
        env = P.env()
        env.set_stream_time_characteristic(P.TimeCharacteristic.EventTime)
        out = (env.from_collection([]).map(P.parse).key_by(0)
               .time_window(P.Time.seconds(5)).sum(2))
        out.print()
        out.get_side_output(P.OutputTag("never-declared")).print()
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM013")
    assert f.severity == "error"


def test_port_tsm014_planner_rejection_catch_all():
    def build(P):
        Node = P.mod("api.graph").Node
        env = P.env()
        stream = env.from_collection([])
        bogus = Node("transmogrify", stream.node, {})
        env._register_sink(Node("sink_print", bogus, {}))
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM014")
    assert f.severity == "error"
    assert "planner" in f.message


def test_port_tsm015_health_rule_unknown_series():
    def job(rules):
        return lambda P: good_job(P, P.env(obs=P.ObsConfig(
            enabled=True, health_rules=rules(P))))

    f = next(f for f in analyze_both(job(lambda P: (P.mod("obs.health").AlertRule(
        name="typo", metric="step_tme_s:p99", value=1.0),)))
        if f.code == "TSM015")
    assert f.severity == "warn"
    assert "step_tme_s" in f.message
    assert "TSM015" in codes(analyze_both(job(
        lambda P: ({"name": "d", "metric": "no_such_series"},))))


def test_port_tsm015_known_series_and_patterns_are_clean():
    def rules(P):
        AlertRule = P.mod("obs.health").AlertRule
        return (
            AlertRule(name="slow", metric="step_time_s:p99", value=0.5),
            AlertRule(name="sink", metric="sink0_e2e_latency_ms:p99", value=9.0),
            AlertRule(name="op", metric="operator_window_steps", kind="absence"),
            AlertRule(name="ts", metric="tenant_step_share", value=0.8),
        )

    found = analyze_both(lambda P: good_job(P, P.env(obs=P.ObsConfig(
        enabled=True, health_rules=rules(P)))))
    assert "TSM015" not in codes(found)


def test_port_tsm015_tenant_slo_series_are_cataloged():
    def build(P):
        c6 = P.mod("jobs.chapter6_tenant_fleet")
        server = c6.make_fleet({"t0": 90.0})
        server.set_tenant_slo("t0", P.mod("obs.slo").TenantSLO(
            p99_ms=50.0, max_error_rate=0.01))
        env = P.StreamExecutionEnvironment(server.config)
        server.build_job(env)
        return env

    assert "TSM015" not in codes(analyze_both(build))


def _socket_job(raw=False, **cfg):
    def build(P):
        env = P.env(**cfg)
        (
            env.add_source(P.mod("runtime.sources").SocketTextSource(
                "localhost", 9999, raw=raw))
            .map(P.parse).key_by(0).time_window(P.Time.seconds(5))
            .sum(2).print()
        )
        return env
    return build


def test_port_tsm016_lanes_over_nonsplittable_source():
    f = next(f for f in analyze_both(_socket_job(ingest_lanes=2))
             if f.code == "TSM016")
    assert f.severity == "error"
    assert "not line-splittable" in f.message


def test_port_tsm016_lanes_exceeding_host_cores():
    lanes = tpustream_torch.obs.resources.usable_cores() + 2
    assert tpustream.obs.resources.usable_cores() + 2 == lanes
    f = next(f for f in analyze_both(good(ingest_lanes=lanes))
             if f.code == "TSM016")
    assert f.severity == "warn"
    assert "usable core" in f.message


def test_port_tsm016_respects_cgroup_quota(monkeypatch):
    for P in PK.values():
        res = P.mod("obs.resources")
        monkeypatch.setattr(res, "affinity_cores", lambda: 96)
        monkeypatch.setattr(res, "cgroup_quota_cores", lambda *a: 2.0)
    f = next(f for f in analyze_both(good(ingest_lanes=4))
             if f.code == "TSM016" and "usable core" in f.message)
    assert f.severity == "warn"
    assert "ingest_lanes=4" in f.message and "2 usable" in f.message
    for P in PK.values():
        monkeypatch.setattr(P.mod("obs.resources"), "cgroup_quota_cores",
                            lambda *a: None)
    assert not [f for f in analyze_both(good(ingest_lanes=4))
                if f.code == "TSM016" and "usable core" in f.message]


def test_port_tsm016_lanes_under_multihost(monkeypatch):
    """The reference reads ``jax.process_count()``; the port reads
    ``torch.distributed``'s world size when a process group is up."""
    import jax
    import torch.distributed as dist

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    f = next(f for f in analyze_both(good(ingest_lanes=2))
             if f.code == "TSM016" and "multi-host" in f.message)
    assert f.severity == "info"


def test_port_tsm016_clean_configurations():
    assert "TSM016" not in codes(analyze_both(_socket_job()))
    assert "error" not in [f.severity for f in analyze_both(
        _socket_job(raw=True, ingest_lanes=2)) if f.code == "TSM016"]


def test_port_tsm017_lane_restarts_over_nonreplayable_source():
    f = next(f for f in analyze_both(_socket_job(
        raw=True, ingest_lanes=2, ingest_lane_restarts=2)) if f.code == "TSM017")
    assert f.severity == "error"
    assert "not replayable" in f.message


def test_port_tsm017_lane_restarts_over_nonsplittable_source():
    msgs = [f.message for f in analyze_both(_socket_job(
        ingest_lanes=2, ingest_lane_restarts=1)) if f.code == "TSM017"]
    assert any("not line-splittable" in m for m in msgs)


def test_port_tsm017_stall_limit_below_frame_deadline():
    f = next(f for f in analyze_both(good(
        ingest_lanes=2, max_batch_delay_ms=5.0, ingest_lane_stall_limit_ms=8.0))
        if f.code == "TSM017")
    assert f.severity == "warn"
    assert "recovered in a loop" in f.message


def test_port_tsm017_clean_configurations():
    assert "TSM017" not in codes(analyze_both(good(
        ingest_lanes=2, ingest_lane_restarts=2)))
    assert "TSM017" not in codes(analyze_both(_socket_job(
        raw=True, ingest_lanes=2, ingest_lane_restarts=0)))
    assert "TSM017" not in [f.code for f in analyze_both(good(
        ingest_lanes=2, ingest_lane_stall_limit_ms=0.0)) if f.severity == "warn"]


def _obs_job(**obs):
    return lambda P: good_job(P, P.env(obs=P.ObsConfig(**obs)))


def test_port_tsm018_trace_sampling_without_marker_carrier():
    f = next(f for f in analyze_both(_obs_job(trace_sample_rate=0.01))
             if f.code == "TSM018")
    assert f.severity == "error"
    assert "TSM018" in codes(analyze_both(_obs_job(
        enabled=True, latency_marker_interval_ms=0.0, trace_sample_rate=0.01)))


def test_port_tsm018_rate_outside_unit_interval():
    f = next(f for f in analyze_both(_obs_job(
        enabled=True, latency_marker_interval_ms=100.0, trace_sample_rate=5.0))
        if f.code == "TSM018")
    assert f.severity == "warn"


def test_port_tsm018_clean_configurations():
    assert "TSM018" not in codes(analyze_both(_obs_job(enabled=True)))
    assert "TSM018" not in codes(analyze_both(_obs_job(
        enabled=True, latency_marker_interval_ms=100.0, trace_sample_rate=0.01)))


def test_port_tsm019_dead_resource_sampler():
    f = next(f for f in analyze_both(_obs_job(enabled=True, resources=True))
             if f.code == "TSM019")
    assert f.severity == "error"
    assert "dead sampler" in f.message
    assert any(f.code == "TSM019" and f.severity == "error"
               for f in analyze_both(_obs_job(resources=True)))


def test_port_tsm019_lane_sweep_without_resources():
    f = next(f for f in analyze_both(lambda P: good_job(P, P.env(
        ingest_lanes=2, obs=P.ObsConfig(enabled=True, snapshot_interval_s=0.5))))
        if f.code == "TSM019")
    assert f.severity == "info"
    assert "resource sampling off" in f.message


def test_port_tsm019_clean_configuration():
    assert "TSM019" not in codes(analyze_both(lambda P: good_job(P, P.env(
        ingest_lanes=2, obs=P.ObsConfig(enabled=True, resources=True,
                                        snapshot_interval_s=0.5)))))


def test_port_tsm051_dead_ledger():
    f = next(f for f in analyze_both(_obs_job(ledger=True)) if f.code == "TSM051")
    assert f.severity == "error"
    assert "dead ledger" in f.message
    assert any(f.code == "TSM051" and f.severity == "error"
               for f in analyze_both(_obs_job(
                   enabled=True, snapshot_interval_s=0.0, ledger=True)))


def test_port_tsm051_anchors_never_land():
    f = next(f for f in analyze_both(_obs_job(
        enabled=True, snapshot_interval_s=0.5, ledger=True)) if f.code == "TSM051")
    assert f.severity == "warn"
    assert "anchor" in f.message


def test_port_tsm051_clean_configurations():
    assert "TSM051" not in codes(analyze_both(_obs_job(enabled=True)))
    assert "TSM051" not in codes(analyze_both(lambda P: good_job(P, P.env(
        checkpoint_dir="/tmp/tsm051-ck", checkpoint_interval_batches=2,
        obs=P.ObsConfig(enabled=True, snapshot_interval_s=0.5, ledger=True)))))
    assert "TSM051" not in codes(analyze_both(_obs_job(
        enabled=True, snapshot_interval_s=0.5, ledger=True,
        ledger_digests=False)))


def test_port_tsm052_dead_drill():
    f = next(f for f in analyze_both(good(
        checkpoint_dir="/tmp/tsm052-ck", checkpoint_interval_batches=1,
        restore_drill_interval_s=5.0)) if f.code == "TSM052")
    assert f.severity == "error"
    assert "dead drill" in f.message
    assert any(f.code == "TSM052" and f.severity == "error"
               for f in analyze_both(lambda P: good_job(P, P.env(
                   restore_drill_interval_s=5.0, obs=P.ObsConfig(enabled=True)))))


def test_port_tsm052_drill_faster_than_snapshots():
    f = next(f for f in analyze_both(lambda P: good_job(P, P.env(
        checkpoint_dir="/tmp/tsm052-ck", checkpoint_interval_batches=1,
        restore_drill_interval_s=0.5,
        obs=P.ObsConfig(enabled=True, snapshot_interval_s=5.0))))
        if f.code == "TSM052")
    assert f.severity == "warn"
    assert "shorter than" in f.message


def test_port_tsm052_clean_configurations():
    assert "TSM052" not in codes(analyze_both(_obs_job(enabled=True)))
    assert "TSM052" not in codes(analyze_both(lambda P: good_job(P, P.env(
        checkpoint_dir="/tmp/tsm052-ck", checkpoint_interval_batches=1,
        restore_drill_interval_s=10.0,
        obs=P.ObsConfig(enabled=True, snapshot_interval_s=5.0)))))


def test_port_tsm053_stranded_savepoint_request():
    def build(P):
        env = good_job(P, P.env(checkpoint_dir="/tmp/tsm053-ck"))
        env.savepoint("pre-rescale")
        env.config = env.config.replace(checkpoint_dir="")
        return env

    f = next(f for f in analyze_both(build) if f.code == "TSM053")
    assert f.severity == "error"
    assert "pre-rescale" in f.message


def test_port_tsm053_retention_below_inflight_budget():
    f = next(f for f in analyze_both(good(
        checkpoint_dir="/tmp/tsm053-ck", checkpoint_interval_batches=1,
        checkpoint_keep=1, checkpoint_async_inflight=3)) if f.code == "TSM053")
    assert f.severity == "warn"
    assert "in-flight" in f.message


def test_port_tsm053_keep_below_floor_is_visible():
    f = next(f for f in analyze_both(good(
        checkpoint_dir="/tmp/tsm053-ck", checkpoint_interval_batches=1,
        checkpoint_keep=0)) if f.code == "TSM053")
    assert f.severity == "warn"
    assert "clamps to 1" in f.message


def test_port_tsm053_clean_configurations():
    assert "TSM053" not in codes(analyze_both(good(
        checkpoint_dir="/tmp/tsm053-ck", checkpoint_interval_batches=1)))
    assert "TSM053" not in codes(analyze_both(good(
        checkpoint_dir="/tmp/tsm053-ck", checkpoint_interval_batches=1,
        checkpoint_keep=4, checkpoint_async_inflight=2)))

    def build(P):
        env = good_job(P, P.env(checkpoint_dir="/tmp/tsm053-ck"))
        env.savepoint("ok")
        return env

    assert "TSM053" not in codes(analyze_both(build))


def test_port_findings_sorted_errors_first():
    def build(P):
        env = P.env(async_depth=2)
        out = (env.from_collection([]).map(P.parse).key_by(0)
               .time_window(P.Time.seconds(5))
               .process(lambda key, ctx, elems: []))
        out.print()
        out.get_side_output(P.OutputTag("nope")).print()
        return env

    found = analyze_both(build)
    ranks = [{"error": 2, "warn": 1, "info": 0}[f.severity] for f in found]
    assert ranks == sorted(ranks, reverse=True)
    assert found[0].severity == "error"


# ---------------------------------------------------------------------------
# purity analyzer
# ---------------------------------------------------------------------------


def callable_both(fn, role, **kw):
    """``analyze_callable`` of one function in both packages."""
    want = [str(f) for f in tpustream.analysis.analyze_callable(fn, role, **kw)]
    got = tpustream_torch.analysis.analyze_callable(fn, role, **kw)
    assert [norm(str(f)) for f in got] == want
    return got


def test_port_tsm020_nondeterministic_call():
    import random

    def build(P):
        def jitter(v):
            return P.Tuple3(v.f0, v.f1, v.f2 * random.random())

        env = P.env()
        env.from_collection([]).map(P.parse).map(jitter).print()
        return env

    assert "TSM020" in codes(analyze_both(build))


def test_port_tsm021_mutable_closure():
    seen = []

    def remember(v):
        seen.append(v)
        return v

    assert codes(callable_both(remember, "map", device=True)) == ["TSM021"]
    threshold = 90.0
    assert callable_both(lambda v: v.f2 > threshold, "filter") == []


def test_port_tsm021_global_write():
    def bump(v):
        global _BUMP_COUNT
        _BUMP_COUNT += 1
        return v

    assert "TSM021" in codes(callable_both(bump, "map"))


def test_port_tsm022_print_in_device_fn():
    def shout(v):
        print("saw", v)
        return v

    assert "TSM022" in codes(callable_both(shout, "map", device=True))
    assert "TSM022" not in codes(callable_both(shout, "map", device=False))


def test_port_tsm023_host_callback_in_device_fn():
    """The port flags the JAX host-callback entry points by name, as the
    reference does (analysis/purity.py's note)."""
    def peek(v):
        import jax

        jax.debug.print("v={}", v)
        return v

    found = callable_both(peek, "map", device=True)
    assert next(f for f in found if f.code == "TSM023").severity == "error"


def test_port_tsm024_dtype_widening():
    """The port's abstract evaluation over 0-d tensors gives the dtypes
    ``jax.eval_shape`` gives, numpy scalars strongly typed as JAX types
    them."""
    def both(fn, value_dtype):
        want = [str(f) for f in tpustream.analysis.check_dtype_widening(
            fn, ["f64"], value_dtype=value_dtype)]
        got = tpustream_torch.analysis.check_dtype_widening(
            fn, ["f64"], value_dtype=value_dtype)
        assert [norm(str(f)) for f in got] == want
        return got

    widen = lambda v: v * np.float64(2.0)  # noqa: E731
    assert codes(both(widen, "float32")) == ["TSM024"]
    keep = lambda v: v * np.float32(2.0)  # noqa: E731
    assert both(keep, "float32") == []
    assert both(widen, "float64") == []


def test_port_purity_skips_unreadable_callables():
    assert callable_both(len, "map", device=True) == []


# ---------------------------------------------------------------------------
# strict mode + obs integration
# ---------------------------------------------------------------------------


def test_port_strict_analysis_blocks_before_compile(monkeypatch):
    """An ERROR finding raises PlanAnalysisError before the executor plans,
    builds a program or launches anything; the error lists the same
    findings as the JAX package's."""
    import tpustream_torch.runtime.executor as ex

    def no_build(*a, **k):
        raise AssertionError("a program was built under a failing analysis")

    monkeypatch.setattr(ex, "build_program", no_build)
    errors = {}
    for side, P in PK.items():
        env = P.env(strict_analysis=True)
        stream = env.from_collection(["1563452051 10.8.22.1 cpu2 99.2"])
        P.mod("api.datastream").KeyedStream(env, stream.map(P.parse).node).max(2).print()
        with pytest.raises(P.PlanAnalysisError) as ei:
            env.execute("broken")
        errors[side] = ei.value
        assert env.metrics is None
    assert any(f.code == "TSM001" for f in errors["torch"].findings)
    assert "strict_analysis" in str(errors["torch"])
    assert ([f.code for f in errors["torch"].findings]
            == [f.code for f in errors["jax"].findings])


def test_port_strict_analysis_off_by_default_and_warns_pass():
    rows = {}
    for side, P in PK.items():
        env = P.env(strict_analysis=True, async_depth=2, fetch_group=4)
        text = env.add_source(P.mod("runtime.sources").ReplaySource(
            ["1563452051 10.8.22.1 cpu2 99.2"]))
        handle = text.map(P.parse).filter(lambda v: v.f2 > 90).collect()
        env.execute("warn-only")
        rows[side] = [repr(t) for t in handle.items]
    assert rows["torch"] == rows["jax"] == ["(10.8.22.1,cpu2,99.2)"]


def test_port_obs_records_findings_and_clamp():
    seen = {}
    for side, P in PK.items():
        env = P.env(async_depth=2, fetch_group=4, obs=P.ObsConfig(enabled=True))
        text = env.add_source(P.mod("runtime.sources").ReplaySource(
            ["1563452051 10.8.22.1 cpu2 99.2"]))
        handle = text.map(P.parse).filter(lambda v: v.f2 > 90).collect()
        res = env.execute("obs-findings")
        series = {
            (s["name"], s["labels"].get("code")): s["value"]
            for s in res.metrics.obs_snapshot()["metrics"]["series"]
            if s["name"] == "analysis_findings_total"
        }
        events = res.metrics.job_obs.flight.events()
        crumbs = [{k: e[k] for k in ("code", "severity", "message")}
                  for e in events if e["kind"] == "analysis_finding"]
        clamp = next(e for e in events if e["kind"] == "config_clamped")
        seen[side] = ([repr(t) for t in handle.items], series, crumbs,
                      (clamp["knob"], clamp["effective"]))
    assert seen["torch"] == seen["jax"]
    rows, series, crumbs, clamp = seen["torch"]
    assert rows == ["(10.8.22.1,cpu2,99.2)"]
    assert series[("analysis_findings_total", "TSM009")] == 1
    assert crumbs and clamp == ("fetch_group", 1)


# ---------------------------------------------------------------------------
# lint CLI
# ---------------------------------------------------------------------------


CHAPTERS = (
    "chapter1_threshold", "chapter2_avg", "chapter2_max",
    "chapter2_median", "chapter3_bandwidth",
    "chapter3_bandwidth_eventtime", "chapter4_cep_alert",
    "chapter5_dynamic_rules", "chapter6_tenant_fleet",
)


def lint_both(argv):
    """Both lint CLIs on ``argv`` (a module name in the JAX package's
    form, ``{pkg}`` for the package): ``(rc, text)`` of each."""
    def lint(P):
        buf = io.StringIO()
        rc = P.mod("analysis.lint").main(
            [a.format(pkg=P.name) for a in argv], out=buf)
        return rc, buf.getvalue()

    out = each_package(lint)
    assert out["torch"][0] == out["jax"][0]
    assert norm(out["torch"][1]) == out["jax"][1]
    return out["torch"]


def test_port_lint_cli_all_chapters_clean():
    rc, text = lint_both([])
    assert rc == 0
    for ch in CHAPTERS:
        assert f"tpustream_torch.jobs.{ch}: ok (0 errors" in text


BAD_JOB = """
from {pkg} import StreamExecutionEnvironment
from {pkg}.api.datastream import KeyedStream

def lint_env():
    env = StreamExecutionEnvironment.get_execution_environment()
    stream = env.from_collection([])
    KeyedStream(env, stream.node).max(0).print()
    return env
"""


def _job_modules(tmp_path, monkeypatch, stem):
    """``<stem>_tpustream`` and ``<stem>_tpustream_torch``: the same bad
    job for each package."""
    for name in NAMES.values():
        (tmp_path / f"{stem}_{name}.py").write_text(BAD_JOB.format(pkg=name))
    monkeypatch.syspath_prepend(str(tmp_path))


def test_port_lint_cli_exit_codes(tmp_path, monkeypatch):
    rc, text = lint_both(["no.such.module"])
    assert rc == 2 and "IMPORT FAILED" in text
    _job_modules(tmp_path, monkeypatch, "badjob")
    rc, text = lint_both(["badjob_{pkg}"])
    assert rc == 1 and "TSM001" in text
    (tmp_path / "hookless.py").write_text("x = 1\n")
    rc, text = lint_both(["hookless"])
    assert rc == 0 and "skipped" in text


def test_port_catalog_is_stable():
    """Codes are append-only API: the port's catalog is the reference's,
    entry for entry (TSM015's hint names the port's catalog file)."""
    ref, port = tpustream.analysis.CATALOG, tpustream_torch.analysis.CATALOG
    assert list(port) == list(ref)
    for code, rule in port.items():
        r = ref[code]
        assert (rule.code, rule.severity, rule.title, rule.rationale,
                norm(rule.fix_hint)) == (r.code, r.severity, r.title,
                                         r.rationale, r.fix_hint)
        assert rule.severity in ("error", "warn", "info")
        assert rule.title and rule.rationale and rule.fix_hint


def test_port_all_chapters_schema_clean():
    """Schema inference over every chapter job of the port: zero TSM03x
    findings, and the sink schemas equal the reference's."""
    schema_codes = {"TSM030", "TSM031", "TSM032", "TSM033", "TSM034"}
    for ch in CHAPTERS:
        envs = build_both(lambda P: P.mod(f"jobs.{ch}").lint_env())
        got = envs["torch"].analyze()
        assert [norm(str(f)) for f in got] == [
            str(f) for f in envs["jax"].analyze()]
        assert not set(codes(got)) & schema_codes, ch
        reps = {side: P.mod("analysis").infer_schemas(envs[side])
                for side, P in PK.items()}
        kinds = {side: (r.sink.kinds if r.sink is not None else None)
                 for side, r in reps.items()}
        assert kinds["torch"] == kinds["jax"], ch
        if ch == "chapter1_threshold":
            assert kinds["torch"] == ["str", "str", "f64"]
        if ch == "chapter3_bandwidth":
            assert kinds["torch"] == ["str", "i64"]


def test_port_lint_cli_json_round_trips_catalog():
    rc, text = lint_both(["--format", "json"])
    assert rc == 0
    doc = json.loads(text)
    assert doc["exit"] == 0
    assert {r["module"].rsplit(".", 1)[1] for r in doc["modules"]} == set(CHAPTERS)
    catalog = tpustream_torch.analysis.CATALOG
    for rec in doc["modules"]:
        assert rec["status"] == "ok"
        for f in rec["findings"]:
            assert set(f) == {"code", "severity", "node", "message", "fix_hint"}
            assert f["severity"] == catalog[f["code"]].severity


def test_port_lint_cli_github_annotations(tmp_path, monkeypatch):
    _job_modules(tmp_path, monkeypatch, "ghjob")
    rc, text = lint_both(["ghjob_{pkg}", "--format", "github"])
    assert rc == 1
    lines = [ln for ln in text.splitlines() if ln]
    assert any(ln.startswith("::error title=TSM001 (ghjob_tpustream_torch)::")
               for ln in lines)
    assert all(ln.startswith("::") for ln in lines)


def test_port_nine_chapter_jobs_analyze_quickly_and_cleanly():
    """Every chapter job of the port self-lints with zero errors, and one
    ``analyze()`` of each takes well under a second here (the abstract
    evaluation runs on 0-d CPU tensors: no device, no build)."""
    import time

    for ch in CHAPTERS:
        env = importlib.import_module(f"tpustream_torch.jobs.{ch}").lint_env()
        t0 = time.perf_counter()
        found = env.analyze()
        assert time.perf_counter() - t0 < 5.0, ch
        assert not tpustream_torch.analysis.has_errors(found), ch
