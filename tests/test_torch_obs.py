"""The observability layer of the PyTorch port (``tpustream_torch/obs``),
on the CPU.

* Counterparts of the JAX package's tests/test_obs.py (its ``dump``
  CLI cases are in tests/test_torch_obs_dump.py). The unit cases run over BOTH
  packages, as cases of one parametrised test (fixture ``pk``): the
  registry, the Prometheus text (golden, byte-equal), the tracer ring,
  the snapshotter, the DerivedKeyTable snapshot invariant. The
  end-to-end cases run the port's executor: the chapter-3 event-time
  job with obs on and off (watermark-lag gauges, per-operator series,
  the span kinds, latency markers at every edge, a CRIT health rule,
  no instrument update with obs off, summary keys unchanged, equal
  ``d2h_syncs``, equal rows).
* Counterparts of tests/test_obs_device.py's build-registry cases: the
  registry over a bare OperatorObs, and one build a job.
* The same obs-enabled job in both packages mints the same series
  names and label sets, apart from the JAX-only series listed by name
  in ``JAX_ONLY_SERIES``.
* The spans under ``torch.profiler``: span names appear among the
  profiler's events.
"""

import functools
import importlib
import json
import math
import threading

import numpy as np
import pytest
import torch

import tpustream_torch as T
from tpustream_torch.config import ObsConfig, StreamConfig
from tpustream_torch.jobs import chapter1_threshold as ch1
from tpustream_torch.jobs.chapter3_bandwidth_eventtime import build as build_et
from tpustream_torch.obs import NULL_JOB_OBS, AlertRule, CompileObs, MetricsRegistry
from tpustream_torch.obs.flightrecorder import FlightRecorder
from tpustream_torch.obs.runtime import OperatorObs
from tpustream_torch.obs.tracing import NULL_TRACER
from tpustream_torch.runtime.sources import ReplaySource

PACKAGES = {"jax": "tpustream", "torch": "tpustream_torch"}

# every name the both-package obs tests use: (module under the package
# root, attribute)
NAMES = {
    'AlertRule': ('.obs', 'AlertRule'),
    'DerivedKeyTable': ('.records', 'DerivedKeyTable'),
    'EnvFingerprint': ('.obs.resources', 'EnvFingerprint'),
    'FlightRecorder': ('.obs', 'FlightRecorder'),
    'HealthEngine': ('.obs', 'HealthEngine'),
    'Histogram': ('.obs', 'Histogram'),
    'JobObs': ('.obs.runtime', 'JobObs'),
    'MarkerStamper': ('.obs', 'MarkerStamper'),
    'MetricsRegistry': ('.obs', 'MetricsRegistry'),
    'MetricsServer': ('.obs', 'MetricsServer'),
    'NULL_FLIGHT': ('.obs', 'NULL_FLIGHT'),
    'NULL_JOB_OBS': ('.obs.runtime', 'NULL_JOB_OBS'),
    'NULL_TRACE_LOG': ('.obs.tracing_export', 'NULL_TRACE_LOG'),
    'ObsConfig': ('.config', 'ObsConfig'),
    'PID_DEVICE': ('.obs.tracing_export', 'PID_DEVICE'),
    'PID_LANES': ('.obs.tracing_export', 'PID_LANES'),
    'PID_RECORDS': ('.obs.tracing_export', 'PID_RECORDS'),
    'PipelineProfiler': ('.obs.profiler', 'PipelineProfiler'),
    'RecordTrace': ('.obs', 'RecordTrace'),
    'RecordTraceLog': ('.obs', 'RecordTraceLog'),
    'ReplaySource': ('.runtime.sources', 'ReplaySource'),
    'ResourceSampler': ('.obs.resources', 'ResourceSampler'),
    'Snapshotter': ('.obs', 'Snapshotter'),
    'StepTracer': ('.obs.tracing', 'StepTracer'),
    'StreamConfig': ('.config', 'StreamConfig'),
    'StreamExecutionEnvironment': ('', 'StreamExecutionEnvironment'),
    'Time': ('', 'Time'),
    'TimeCharacteristic': ('', 'TimeCharacteristic'),
    'TimeSeries': ('.obs.timeseries', 'TimeSeries'),
    'as_rule': ('.obs', 'as_rule'),
    'build_et': ('.jobs.chapter3_bandwidth_eventtime', 'build'),
    'cgroup_quota_cores': ('.obs.resources', 'cgroup_quota_cores'),
    'collect_env_fingerprint': ('.obs.resources', 'collect_env_fingerprint'),
    'job_snapshot': ('.obs.snapshot', 'job_snapshot'),
    'jsonable_config': ('.obs', 'jsonable_config'),
    'monotonic_epoch_ms': ('.runtime.sources', 'monotonic_epoch_ms'),
    'timeline_from_parts': ('.obs.tracing_export', 'timeline_from_parts'),
    'timeline_from_snapshot': ('.obs.tracing_export', 'timeline_from_snapshot'),
    'usable_cores': ('.obs.resources', 'usable_cores'),
    'write_snapshot': ('.obs', 'write_snapshot'),
}


class Pkg:
    """One package's surface for the both-package tests: ``pk.AlertRule``
    is the JAX package's ``AlertRule`` or the port's. The port's
    ``StreamConfig`` asks for the CPU."""

    def __init__(self, side: str):
        self.side = side
        self.root = PACKAGES[side]

    def __getattr__(self, name):
        mod, attr = NAMES[name]
        value = getattr(importlib.import_module(self.root + mod), attr)
        if name == "StreamConfig" and self.side == "torch":
            value = functools.partial(value, device="cpu")
        setattr(self, name, value)
        return value

    def __repr__(self):
        return self.side


PKG = {side: Pkg(side) for side in PACKAGES}


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return PKG[request.param]


# ---------------------------------------------------------------------------
# tests/test_obs.py's unit cases, over both packages
# ---------------------------------------------------------------------------


def test_registry_scoping_and_labels(pk):
    reg = pk.MetricsRegistry()
    job = reg.group(job="j1")
    op = job.group(operator="window")
    shard = op.group(shard=0)

    c1 = op.counter("operator_records_in")
    c2 = job.group(operator="window").counter("operator_records_in")
    assert c1 is c2  # idempotent by (name, labels)
    c1.inc(3)
    c2.inc(2)
    assert c1.value == 5

    # a different label set is a different series
    c3 = shard.counter("operator_records_in")
    assert c3 is not c1
    assert c3.value == 0
    assert c3.labels == {"job": "j1", "operator": "window", "shard": "0"}

    names = [(s.name, s.labels) for s in reg.series()]
    assert ("operator_records_in", {"job": "j1", "operator": "window"}) in names
    assert (
        "operator_records_in",
        {"job": "j1", "operator": "window", "shard": "0"},
    ) in names


def test_registry_kind_mismatch_raises(pk):
    reg = pk.MetricsRegistry()
    g = reg.group(job="j")
    g.counter("x")
    with pytest.raises(TypeError):
        g.gauge("x")
    with pytest.raises(TypeError):
        g.histogram("x")


def test_gauge_set_fn_pull_and_exception_swallow(pk):
    reg = pk.MetricsRegistry()
    g = reg.group(job="j").gauge("depth")
    box = {"v": 7}
    g.set_fn(lambda: box["v"])
    assert g.value == 7
    box["v"] = 9
    assert g.value == 9

    def boom():
        raise RuntimeError("queue gone")

    g.set_fn(boom)
    # a dead callback is VISIBLE, not papered over: the read renders NaN
    # (a stale last-good value would hide the outage from dashboards)
    # and the failure is attributed in its own error counter
    assert math.isnan(g.value)
    assert math.isnan(g.value)  # stable across repeated scrapes
    errs = [
        s for s in reg.series()
        if s.name == "gauge_callback_errors"
    ]
    assert len(errs) == 1
    assert errs[0].labels == {"job": "j", "gauge": "depth"}
    assert errs[0].value == 2
    # NaN must survive prometheus rendering, not crash the formatter
    text = reg.to_prometheus_text()
    assert "tpustream_depth" in text and "NaN" in text


def test_histogram_percentiles_match_numpy(pk):
    rng = np.random.default_rng(7)
    vals = rng.exponential(scale=3.0, size=257)
    h = pk.Histogram("t", {})
    h.observe_many(vals.tolist())
    for q in (0, 10, 50, 90, 99, 100):
        assert h.percentile(q) == pytest.approx(
            float(np.percentile(vals, q)), rel=1e-12, abs=1e-12
        )
    assert h.count == len(vals)
    assert h.sum == pytest.approx(float(vals.sum()))


def test_histogram_ring_bound_keeps_exact_count_sum(pk):
    h = pk.Histogram("t", {}, max_samples=8)
    h.observe_many(range(100))
    assert h.count == 100
    assert h.sum == sum(range(100))
    assert len(h.samples) == 8
    assert sorted(h.samples) == list(range(92, 100))  # most recent retained


def test_prometheus_text_golden(pk):
    # pinned clock: epoch aligned so exposition timestamps are exactly
    # sample-time * 1000 ms — the golden asserts the full line including
    # the per-series timestamp suffix
    reg = pk.MetricsRegistry()
    reg.now = lambda: 1.5
    reg._epoch_wall = 0.0
    reg._epoch_perf = 0.0
    g = reg.group(job="demo", operator="window")
    g.counter("operator_records_in").inc(42)
    g.gauge("operator_inflight_steps").set(3)
    h = g.histogram("operator_step_time_s")
    # identical samples: every quantile is exactly 0.5, no float-repr
    # sensitivity in the golden (interpolation itself is pinned against
    # the numpy oracle above)
    h.observe_many([0.5, 0.5, 0.5, 0.5])
    assert reg.to_prometheus_text() == (
        '# TYPE tpustream_operator_inflight_steps gauge\n'
        'tpustream_operator_inflight_steps{job="demo",operator="window"} 3 1500\n'
        '# TYPE tpustream_operator_records_in counter\n'
        'tpustream_operator_records_in{job="demo",operator="window"} 42 1500\n'
        '# TYPE tpustream_operator_step_time_s summary\n'
        'tpustream_operator_step_time_s{job="demo",operator="window",quantile="0.5"} 0.5 1500\n'
        'tpustream_operator_step_time_s{job="demo",operator="window",quantile="0.9"} 0.5 1500\n'
        'tpustream_operator_step_time_s{job="demo",operator="window",quantile="0.99"} 0.5 1500\n'
        'tpustream_operator_step_time_s_sum{job="demo",operator="window"} 2 1500\n'
        'tpustream_operator_step_time_s_count{job="demo",operator="window"} 4 1500\n'
    )
    # back-to-back renders are byte-identical — rendering never advances
    # any sample clock
    assert reg.to_prometheus_text() == reg.to_prometheus_text()


def test_prometheus_text_escapes_hostile_label_values(pk):
    """Exposition golden for a label value containing every character
    the text format escapes: backslash, double quote, and newline."""
    reg = pk.MetricsRegistry()
    reg.now = lambda: 2.0
    reg._epoch_wall = 0.0
    reg._epoch_perf = 0.0
    reg.group(job="j", operator='he"llo\\wo\nrld').counter(
        "operator_records_in"
    ).inc(1)
    assert reg.to_prometheus_text() == (
        '# TYPE tpustream_operator_records_in counter\n'
        'tpustream_operator_records_in'
        '{job="j",operator="he\\"llo\\\\wo\\nrld"} 1 2000\n'
    )


def test_tracer_ring_overwrite_and_snapshot(pk):
    tr = pk.StepTracer(capacity=4)
    for i in range(6):
        with tr.span("dispatch", step=i, operator="window"):
            pass
    snap = tr.snapshot()
    assert snap["total_spans"] == 6
    assert snap["dropped_spans"] == 2
    assert len(snap["events"]) == 4
    assert [e["step"] for e in snap["events"]] == [2, 3, 4, 5]  # oldest dropped
    assert all(e["kind"] == "dispatch" for e in snap["events"])
    assert all(e["dur_s"] >= 0 for e in snap["events"])


def test_snapshotter_and_write_snapshot_roundtrip(pk, tmp_path):
    reg = pk.MetricsRegistry()
    reg.group(job="j").counter("batches").inc(5)
    tr = pk.StepTracer(capacity=8)
    with tr.span("fetch", step=1, operator="window"):
        pass
    jsonl = tmp_path / "series.jsonl"
    snapper = pk.Snapshotter(
        reg, tr, interval_s=1e9, jsonl_path=str(jsonl), meta={"job": "j"}
    )
    assert snapper.enabled
    assert snapper.maybe_snapshot() is None  # interval not yet elapsed
    snap = snapper.take()
    assert snap["version"] == 1
    assert snap["meta"]["job"] == "j"
    assert snap["trace"]["total_spans"] == 1
    # JSONL line parses back to the same snapshot
    assert json.loads(jsonl.read_text()) == json.loads(
        json.dumps(snap, sort_keys=True)
    )

    path = tmp_path / "snap.json"
    pk.write_snapshot(str(path), pk.job_snapshot(reg, tr, meta={"job": "j"}))
    loaded = json.loads(path.read_text())
    assert loaded["metrics"]["series"][0]["name"] == "batches"
    assert "tpustream_batches" in loaded["prometheus"]


def test_derived_key_table_snapshot_tear(pk):
    """state_dict must never pair a string with a missing original:
    intern_value appends the canonical string FIRST, so a concurrent
    snapshot (checkpoint under parse-ahead) can observe len(_to_str) >
    len(_originals) mid-intern. The capture-then-truncate order pins
    len(strings) == len(originals) with consistent pairs."""
    t = pk.DerivedKeyTable()
    done = threading.Event()
    err = []
    N = 20_000

    def hammer():
        for i in range(N):
            t.intern_value(f"k{i}")
        done.set()

    def check():
        try:
            checks = 0
            while not done.is_set() or checks < 10:
                d = t.state_dict()
                assert len(d["strings"]) == len(d["originals"])
                for s, o in zip(d["strings"], d["originals"]):
                    if o is not None:  # slot 0 is the reserved placeholder
                        assert s == f"{type(o).__name__}:{o!r}"
                checks += 1
        except BaseException as e:  # pragma: no cover
            err.append(e)

    w = threading.Thread(target=hammer)
    r = threading.Thread(target=check)
    w.start()
    r.start()
    w.join()
    r.join()
    assert not err
    d = t.state_dict()
    assert len(d["originals"]) == N + 1  # all keys + placeholder



# ---------------------------------------------------------------------------
# end to end through the port: the chapter-3 event-time job, obs on / off
# ---------------------------------------------------------------------------

# 240 lines / 16-row batches = 15 source polls, so the per-poll latency
# marker stamping yields >= 10 markers through the pipeline; flows small
# enough to pass the job's < 100 Mbps alert filter, so rows reach the sink
ET_LINES = [
    f"2020-01-01T00:{m:02d}:{s:02d} ch{(m + s) % 3} {1234567 + 997 * s}"
    for m in range(4)
    for s in range(60)
]

_CH3_CACHE = {}


def _run_ch3(enabled: bool):
    """One port run per obs setting, shared across the end-to-end
    tests: latency markers on every source poll and a watermark-lag
    rule the job's 1-minute bounded-out-of-orderness delay breaches."""
    if enabled in _CH3_CACHE:
        return _CH3_CACHE[enabled]
    obs = ObsConfig(
        enabled=enabled,
        latency_marker_interval_ms=1e-6 if enabled else 0.0,
        health_rules=(
            AlertRule(name="lag_crit", metric="watermark_lag_ms",
                      op=">", value=30_000, severity="crit"),
        ) if enabled else (),
    )
    cfg = StreamConfig(batch_size=16, key_capacity=64, obs=obs, device="cpu")
    env = T.StreamExecutionEnvironment(cfg)
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    handle = build_et(
        env,
        env.add_source(ReplaySource(ET_LINES)),
        size=T.Time.minutes(5),
        slide=T.Time.seconds(5),
        delay=T.Time.minutes(1),
    ).collect()
    env.execute("obs-e2e")
    _CH3_CACHE[enabled] = (env.metrics, [repr(t) for t in handle.items])
    return _CH3_CACHE[enabled]


def _series_by_operator(snap):
    return {(s["name"], s["labels"].get("operator")): s
            for s in snap["metrics"]["series"]}


def test_eventtime_job_obs_enabled():
    m, _ = _run_ch3(enabled=True)
    snap = m.obs_snapshot()
    series = _series_by_operator(snap)
    lag = series[("watermark_lag_ms", None)]
    assert lag["type"] == "gauge"
    assert lag["value"] == 60_000
    assert series[("watermark_ms", None)]["value"] > 0
    win_in = series[("operator_records_in", "window")]
    assert win_in["value"] == len(ET_LINES)
    assert series[("operator_steps", "window")]["value"] >= 1
    assert ("operator_step_time_s", "window") in series
    # the port stages a batch's columns straight onto the device: its
    # spans are parse, h2d, dispatch, fetch and emit (no separate pack)
    kinds = {e["kind"] for e in snap["trace"]["events"]}
    assert {"parse", "h2d", "dispatch", "fetch", "emit"} <= kinds
    assert "tpustream_watermark_lag_ms" in m.to_prometheus_text()
    assert "tpustream_watermark_lag_ms" in snap["prometheus"]


def test_eventtime_job_latency_markers_end_to_end():
    m, _ = _run_ch3(enabled=True)
    series = _series_by_operator(m.obs_snapshot())
    emitted = series[("latency_markers_emitted", None)]["value"]
    assert emitted >= 10
    for name in ("operator_e2e_latency_ms", "operator_sink0_e2e_latency_ms"):
        h = series[(name, "window")]
        assert h["type"] == "histogram"
        # every marker settles: none lost at the end-of-stream flush
        assert h["value"]["count"] == emitted
        assert h["value"]["p99"] >= h["value"]["p50"] > 0


def test_eventtime_job_health_rule_goes_crit():
    m, _ = _run_ch3(enabled=True)
    snap = m.obs_snapshot()
    health = snap["health"]
    assert health["level"] == "crit"
    (rule,) = [r for r in health["rules"] if r["rule"] == "lag_crit"]
    assert rule["level"] == "crit"
    assert rule["value"] == 60_000
    assert "watermark_lag_ms > 30000" in rule["reason"]
    states = {s["labels"].get("rule"): s["value"]
              for s in snap["metrics"]["series"]
              if s["name"] == "health_rule_state"}
    assert states["lag_crit"] == 2


def test_eventtime_job_obs_disabled_no_marker_injection():
    m, _ = _run_ch3(enabled=False)
    names = {s["name"] for s in m.obs_snapshot()["metrics"]["series"]}
    assert "latency_markers_emitted" not in names
    assert not any("e2e_latency" in n for n in names)


def test_eventtime_job_obs_disabled_no_instrument_updates():
    m, _ = _run_ch3(enabled=False)
    assert m.job_obs is NULL_JOB_OBS
    assert m.job_obs.tracer.total_spans == 0
    names = {s["name"] for s in m.obs_snapshot()["metrics"]["series"]}
    assert not any(n.startswith("operator_") for n in names)
    assert "watermark_lag_ms" not in names


def test_summary_keys_unchanged_by_obs():
    disabled, off_rows = _run_ch3(enabled=False)
    enabled, on_rows = _run_ch3(enabled=True)
    assert set(enabled.summary()) == set(disabled.summary())
    assert enabled.records_in == disabled.records_in == len(ET_LINES)
    # obs adds no wait on the device and changes no row
    assert enabled.d2h_syncs == disabled.d2h_syncs
    assert on_rows == off_rows and on_rows


# ---------------------------------------------------------------------------
# tests/test_obs_device.py: the build registry
# ---------------------------------------------------------------------------


def _compile_obs():
    reg = MetricsRegistry()
    group = reg.group(job="t", operator="op")
    flight = FlightRecorder(64)
    return CompileObs(OperatorObs(group, NULL_TRACER), flight), reg, flight


def _series(reg):
    return {(s.name, s.labels.get("cause")): s for s in reg.series()}


def test_build_registry_counts_builds_and_causes():
    """The counterpart of the JAX package's instrumented-step case: the
    first build is ``initial``, every later one a recompile under its
    cause, each timed and flight-recorded."""
    cobs, reg, flight = _compile_obs()
    assert cobs.build("initial", lambda: 7) == 7
    s = _series(reg)
    assert s[("operator_compile_count", None)].value == 1
    assert s[("operator_recompile_count", None)].value == 0
    assert s[("operator_compile_wall_ms", None)].count == 1
    cobs.build("key_capacity_growth", lambda: None)
    cobs.record_compile("tenant_capacity_growth", 0.5)
    s = _series(reg)
    assert s[("operator_compile_count", None)].value == 3
    assert s[("operator_recompile_count", None)].value == 2
    assert s[("operator_recompile_cause", "key_capacity_growth")].value == 1
    assert s[("operator_recompile_cause", "tenant_capacity_growth")].value == 1
    assert s[("operator_compile_wall_ms", None)].count == 3
    events = [e for e in flight.dump()["events"]
              if e["kind"] == "program_compiled"]
    assert [e["cause"] for e in events] == [
        "initial", "key_capacity_growth", "tenant_capacity_growth"]
    assert [e["compile_index"] for e in events] == [0, 1, 2]


def test_job_compile_registry_single_build():
    m, _ = _run_ch3(enabled=True)
    series = _series_by_operator(m.obs_snapshot())
    assert series[("operator_compile_count", "window")]["value"] == 1
    assert series[("operator_recompile_count", "window")]["value"] == 0
    wall = series[("operator_compile_wall_ms", "window")]["value"]
    assert wall["count"] == 1 and wall["sum"] > 0
    events = [e for e in m.job_obs.flight.dump()["events"]
              if e["kind"] == "program_compiled"]
    assert len(events) == 1 and events[0]["cause"] == "initial"
    assert events[0]["chain_ops"] == 0
    assert events[0]["chain_in_arity"] >= 1


def test_key_capacity_growth_is_a_cause_tagged_reshape():
    """12 distinct keys against key_capacity=8: the state grows once,
    mid-job, recorded as one recompile with cause
    ``key_capacity_growth`` (the port reshapes its state in place of a
    rebuild)."""
    lines = [
        f"2020-01-01T00:{i // 60:02d}:{i % 60:02d} "
        f"ch{i % (6 if i < 120 else 12)} 1234567"
        for i in range(240)
    ]
    cfg = StreamConfig(batch_size=16, key_capacity=8, device="cpu",
                       obs=ObsConfig(enabled=True))
    env = T.StreamExecutionEnvironment(cfg)
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    build_et(env, env.add_source(ReplaySource(lines)),
             size=T.Time.minutes(5), slide=T.Time.seconds(5),
             delay=T.Time.minutes(1)).collect()
    env.execute("growth")
    snap = env.metrics.obs_snapshot()
    by = {(s["name"], s["labels"].get("cause")): s["value"]
          for s in snap["metrics"]["series"]}
    assert by[("operator_compile_count", None)] == 2
    assert by[("operator_recompile_count", None)] == 1
    assert by[("operator_recompile_cause", "key_capacity_growth")] == 1
    events = env.metrics.job_obs.flight.dump()["events"]
    grown = [e for e in events if e["kind"] == "key_capacity_grown"]
    assert len(grown) == 1 and grown[0]["new_capacity"] == 16
    assert [e["cause"] for e in events if e["kind"] == "program_compiled"] \
        == ["initial", "key_capacity_growth"]


# ---------------------------------------------------------------------------
# both packages, one job: the same series
# ---------------------------------------------------------------------------

# series the JAX package mints that the port does not: the XLA
# cost/memory analysis of each compile (obs/compilation.py); the
# state-memory series (obs/memory.py) and the conservation ledger with
# its health rule (obs/ledger.py) are minted by both
JAX_ONLY_SERIES = {
    "operator_compile_argument_bytes", "operator_compile_bytes_accessed",
    "operator_compile_code_bytes", "operator_compile_flops",
    "operator_compile_output_bytes", "operator_compile_temp_bytes",
}


def test_same_series_as_the_jax_package():
    def run(pk):
        obs = pk.ObsConfig(enabled=True, latency_marker_interval_ms=1e-6)
        env = pk.StreamExecutionEnvironment(
            pk.StreamConfig(batch_size=16, key_capacity=64, obs=obs))
        env.set_stream_time_characteristic(pk.TimeCharacteristic.EventTime)
        h = pk.build_et(env, env.add_source(pk.ReplaySource(ET_LINES)),
                        size=pk.Time.minutes(5), slide=pk.Time.seconds(5),
                        delay=pk.Time.minutes(1)).collect()
        env.execute("obs-parity")
        snap = env.metrics.obs_snapshot()
        return ({(s["name"], tuple(sorted(s["labels"])))
                 for s in snap["metrics"]["series"]},
                [repr(t) for t in h.items],
                [e["kind"] for e in env.metrics.job_obs.flight.events()])

    jax_series, jax_rows, jax_kinds = run(PKG["jax"])
    port_series, port_rows, port_kinds = run(PKG["torch"])
    assert port_rows == jax_rows
    assert port_series <= jax_series
    assert {n for n, _ in jax_series - port_series} == JAX_ONLY_SERIES
    assert port_kinds == jax_kinds


# ---------------------------------------------------------------------------
# the torch.profiler bridge and chapter 1's self-monitoring rules
# ---------------------------------------------------------------------------


def test_profiler_bridge_names_spans_in_a_torch_profile():
    """The job's span recorder opens a ``record_function`` range a span
    whenever a capture records (the reference's ``profiler_bridge``
    knob has no counterpart): the ring's kinds and a sub-span."""
    cfg = StreamConfig(batch_size=16, key_capacity=64, device="cpu",
                       obs=ObsConfig(enabled=True))
    env = T.StreamExecutionEnvironment(cfg)
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    build_et(env, env.add_source(ReplaySource(ET_LINES[:64])),
             size=T.Time.minutes(5), slide=T.Time.seconds(5),
             delay=T.Time.minutes(1)).collect()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        env.execute("bridge")
    names = {e.name for e in prof.events()}
    for kind in ("parse", "h2d", "dispatch", "fetch", "emit", "step.fold"):
        assert f"tpustream.{kind}" in names, kind


def test_chapter1_health_rules_stay_ok_on_a_moving_job():
    rules = ch1.health_rules()
    assert [r.name for r in rules] == [
        "ingest_stalled", "emit_stalled", "backpressure"]
    lines = [f"1 10.8.22.{i % 5} cpu{i % 3} {40 + (i * 31) % 55}.5"
             for i in range(200)]
    env = T.StreamExecutionEnvironment(StreamConfig(
        batch_size=16, device="cpu",
        obs=ObsConfig(enabled=True, snapshot_interval_s=1e-6,
                      health_rules=rules)))
    h = ch1.build(env, env.add_source(ReplaySource(lines))).collect()
    env.execute("Window WordCount")
    assert h.items
    job_obs = env.metrics.job_obs
    # the snapshot ticks ran during the job and the engine ended at OK
    assert len(job_obs.snapshotter.snapshots) > 1
    assert job_obs.snapshotter.snapshots[-1]["health"]["level"] == "ok"
    assert job_obs.snapshot()["health"]["level"] == "ok"


def test_fetch_group_clamped_to_inflight_window():
    """tests/test_obs.py's clamp case: the effective fetch group is the
    requested one clamped to the in-flight window minus one (at least
    1), live, so the controller may move async_depth under a job."""
    import types

    from tpustream_torch.runtime.executor import Runner

    def eff(fetch_group, async_depth):
        fake = types.SimpleNamespace(
            cfg=types.SimpleNamespace(fetch_group=fetch_group),
            _max_inflight=max(0, async_depth - 1))
        return Runner._fetch_group.fget(fake)

    assert eff(8, 2) == 1   # a full-window group would drain the pipeline
    assert eff(8, 4) == 3   # clamped to async_depth - 1
    assert eff(2, 4) == 2   # under the window: honoured
    assert eff(4, 1) == 1   # no pipelining at all: a fetch a step
