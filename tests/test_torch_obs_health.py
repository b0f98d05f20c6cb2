"""Counterparts of the JAX package's tests/test_obs_health.py, all 17,
over both packages (fixture ``pk``): the health engine's threshold,
rate and absence rules with their debounce, rule validation, the flight
recorder's ring and dump, registry merge, the snapshotter's terminal
flush, the latency-marker stamper, the monotonic epoch clock, and a
failing chapter-3 job that writes its flight dump (the port's executor
in the ``torch`` cases).
"""

import json

import pytest

from tests.test_torch_obs import pk  # noqa: F401


def _gauge(name, value, **labels):
    return {"name": name, "type": "gauge", "labels": labels, "value": value}


def _counter(name, value, **labels):
    return {"name": name, "type": "counter", "labels": labels, "value": value}


def _hist(name, **labels):
    return {
        "name": name, "type": "histogram", "labels": labels,
        "value": {"count": 4, "sum": 8.0, "p50": 2.0, "p90": 3.0, "p99": 3.9},
    }


def test_threshold_rule_fires_and_clears_deterministically(pk):
    """The acceptance scenario: a watermark_lag_ms CRIT rule breaches,
    sustains through its for_s debounce, goes CRIT, then clears the
    moment the lag drops."""
    sink = []
    engine = pk.HealthEngine(
        [pk.AlertRule(name="lag", metric="watermark_lag_ms", op=">",
                   value=30_000, for_s=10.0, severity="crit")],
        alert_sink=sink.append,
    )
    lagged = [_gauge("watermark_lag_ms", 45_000, job="j")]
    ok = [_gauge("watermark_lag_ms", 1_000, job="j")]

    assert engine.evaluate(lagged, now_s=0.0)["level"] == "ok"   # debouncing
    assert engine.evaluate(lagged, now_s=5.0)["level"] == "ok"   # still
    state = engine.evaluate(lagged, now_s=10.0)                  # sustained
    assert state["level"] == "crit"
    assert state["rules"][0]["reason"] == (
        "watermark_lag_ms > 30000 (observed 45000)"
    )
    assert engine.evaluate(ok, now_s=12.0)["level"] == "ok"      # clears now

    assert [(t["from"], t["to"]) for t in engine.transitions] == [
        ("ok", "crit"), ("crit", "ok")
    ]
    assert sink == engine.transitions  # every transition hit the sink


def test_threshold_breach_reset_restarts_debounce(pk):
    engine = pk.HealthEngine(
        [pk.AlertRule(name="lag", metric="lag", op=">", value=10,
                   for_s=5.0, severity="warn")]
    )
    hi, lo = [_gauge("lag", 20, job="j")], [_gauge("lag", 0, job="j")]
    engine.evaluate(hi, now_s=0.0)
    engine.evaluate(lo, now_s=3.0)   # breach interrupted: clock resets
    engine.evaluate(hi, now_s=4.0)
    assert engine.evaluate(hi, now_s=8.0)["level"] == "ok"   # only 4s in
    assert engine.evaluate(hi, now_s=9.0)["level"] == "warn"


def test_threshold_histogram_field_and_label_filter_and_agg(pk):
    engine = pk.HealthEngine(
        [pk.AlertRule(name="slow", metric="e2e_ms:p99", op=">", value=3.0,
                   labels={"operator": "window"}, agg="max",
                   severity="warn")]
    )
    series = [
        _hist("e2e_ms", operator="window", job="j"),
        _gauge("e2e_ms", 0.0, operator="other", job="j"),  # filtered out
    ]
    state = engine.evaluate(series, now_s=1.0)
    assert state["level"] == "warn"
    assert state["rules"][0]["value"] == 3.9  # the p99 component


def test_rate_rule_derivative_between_ticks(pk):
    engine = pk.HealthEngine(
        [pk.AlertRule(name="bp", metric="queue_depth", kind="rate",
                   op=">", value=5.0, severity="crit")]
    )
    assert engine.evaluate(
        [_gauge("queue_depth", 0, job="j")], now_s=0.0
    )["level"] == "ok"  # no previous point yet
    # +20 over 2s = 10/s > 5/s
    assert engine.evaluate(
        [_gauge("queue_depth", 20, job="j")], now_s=2.0
    )["level"] == "crit"
    # flat: 0/s clears immediately
    assert engine.evaluate(
        [_gauge("queue_depth", 20, job="j")], now_s=4.0
    )["level"] == "ok"


def test_absence_rule_missing_series_and_stalled_series(pk):
    engine = pk.HealthEngine(
        [pk.AlertRule(name="live", metric="records_out", kind="absence",
                   severity="warn")]
    )
    # no matching series at all -> immediate breach (for_s=0)
    assert engine.evaluate([], now_s=0.0)["level"] == "warn"
    # series appears: first observation is benign
    moving = lambda v: [_counter("records_out", v, job="j")]
    assert engine.evaluate(moving(10), now_s=1.0)["level"] == "ok"
    # moving -> ok; stalled -> breach again
    assert engine.evaluate(moving(20), now_s=2.0)["level"] == "ok"
    assert engine.evaluate(moving(20), now_s=3.0)["level"] == "warn"
    assert engine.evaluate(moving(25), now_s=4.0)["level"] == "ok"


def test_rule_validation_errors(pk):
    with pytest.raises(ValueError):
        pk.AlertRule(name="x", metric="m", kind="wavelet")
    with pytest.raises(ValueError):
        pk.AlertRule(name="x", metric="m", op="~")
    with pytest.raises(ValueError):
        pk.AlertRule(name="x", metric="m", severity="fatal")
    with pytest.raises(ValueError):
        pk.AlertRule(name="x", metric="m", agg="median")
    with pytest.raises(ValueError):  # duplicate names
        pk.HealthEngine([pk.AlertRule(name="x", metric="a"),
                      pk.AlertRule(name="x", metric="b")])
    with pytest.raises(TypeError):
        pk.as_rule("not a rule")


def test_as_rule_accepts_dicts_and_labels_dicts(pk):
    r = pk.as_rule({"name": "lag", "metric": "watermark_lag_ms:value",
                 "op": ">=", "value": 1.0, "labels": {"job": "j"}})
    assert r.series_name == "watermark_lag_ms"
    assert r.field == "value"
    assert r.labels == (("job", "j"),)


def test_broken_alert_sink_is_swallowed_and_gauges_track_levels(pk):
    def boom(_report):
        raise RuntimeError("pager down")

    reg = pk.MetricsRegistry()
    engine = pk.HealthEngine(
        [pk.AlertRule(name="lag", metric="lag", op=">", value=10)],
        alert_sink=boom,
        gauge_group=reg.group(job="j"),
    )
    engine.evaluate([_gauge("lag", 99, job="j")], now_s=0.0)  # must not raise
    (series,) = [s for s in reg.series() if s.name == "health_rule_state"]
    assert series.labels == {"job": "j", "rule": "lag"}
    assert series.value == 2  # crit
    engine.evaluate([_gauge("lag", 0, job="j")], now_s=1.0)
    assert series.value == 0


def test_flight_ring_bound_seq_and_dump(pk, tmp_path):
    fl = pk.FlightRecorder(capacity=4)
    for i in range(7):
        fl.record("tick", i=i)
    fl.set_active("window")
    fl.record_exception(ValueError("boom"))
    dump = fl.dump(meta={"job": "j"})
    assert dump["total_events"] == 8
    assert dump["dropped_events"] == 4
    assert len(dump["events"]) == 4
    # seq survives overwrite: the retained tail is contiguous
    assert [e["seq"] for e in dump["events"]] == [5, 6, 7, 8]
    last = dump["events"][-1]
    assert last["kind"] == "exception"
    assert last["error_type"] == "ValueError"
    assert last["operator"] == "window"  # picked up from set_active
    assert dump["active_operator"] == "window"

    path = fl.write(str(tmp_path / "flight.json"), meta={"job": "j"})
    assert json.loads(open(path).read())["total_events"] == 8


def test_flight_write_survives_unserializable_payloads(pk, tmp_path):
    fl = pk.FlightRecorder(capacity=4)
    fl.record("config_resolved", config={"sink": lambda r: None})
    path = fl.write(str(tmp_path / "f.json"))
    assert "lambda" in json.loads(open(path).read())["events"][0]["config"]["sink"]


def test_null_flight_records_nothing(pk):
    pk.NULL_FLIGHT.record("tick")
    pk.NULL_FLIGHT.record_exception(ValueError("x"), operator="w")
    assert pk.NULL_FLIGHT.events() == []
    assert pk.NULL_FLIGHT.dump()["total_events"] == 0
    assert not pk.NULL_FLIGHT.enabled


def test_jsonable_config_nested_dataclass(pk):
    cfg = pk.StreamConfig(batch_size=16, obs=pk.ObsConfig(
        enabled=True, alert_sink=print))
    d = pk.jsonable_config(cfg)
    assert d["batch_size"] == 16
    assert d["obs"]["enabled"] is True
    assert isinstance(d["obs"]["alert_sink"], str)  # repr'd, not dropped
    json.dumps(d)  # fully serializable


def test_registry_merge_lossless(pk):
    a, b = pk.MetricsRegistry(), pk.MetricsRegistry()
    a.group(job="j", shard="0").counter("records_in").inc(10)
    b.group(job="j", shard="0").counter("records_in").inc(5)
    b.group(job="j", shard="1").counter("records_in").inc(7)  # minted in a
    a.group(job="j").gauge("depth").set(1)
    b.group(job="j").gauge("depth").set(3)
    ha = a.group(job="j").histogram("lat")
    hb = b.group(job="j").histogram("lat")
    ha.observe_many([1.0, 2.0])
    hb.observe_many([3.0, 4.0, 5.0])

    a.merge(b)
    series = {(s.name, s.labels.get("shard")): s for s in a.series()}
    assert series[("records_in", "0")].value == 15     # counters sum
    assert series[("records_in", "1")].value == 7      # missing series minted
    assert series[("depth", None)].value == 3          # gauges last-write
    merged = series[("lat", None)]
    assert merged.count == 5 and merged.sum == 15.0    # exact under merge


def test_snapshotter_close_flushes_terminal_snapshot(pk, tmp_path):
    """Satellite: a job whose snapshot interval never elapsed must not
    lose its final state — close() writes the terminal JSONL line."""
    reg = pk.MetricsRegistry()
    reg.group(job="j").counter("batches").inc(3)
    jsonl = tmp_path / "series.jsonl"
    snapper = pk.Snapshotter(reg, interval_s=1e9, jsonl_path=str(jsonl))
    assert snapper.maybe_snapshot() is None  # interval never elapses
    snap = snapper.close()
    assert snap is not None
    assert snapper.close() is snap  # idempotent
    lines = [json.loads(l) for l in jsonl.read_text().splitlines()]
    assert len(lines) == 1
    (s,) = lines[-1]["metrics"]["series"]
    assert (s["name"], s["value"]) == ("batches", 3)


def test_marker_stamper_interval_and_trace(pk):
    import time

    stamper = pk.MarkerStamper(interval_ms=1e9, source="src")
    m = stamper.poll(now_s=time.monotonic())
    assert m is not None  # first poll always stamps
    assert stamper.poll(now_s=time.monotonic()) is None  # interval gate
    age = m.observe("window")
    assert age >= 0
    age2 = m.observe("sink0")
    assert age2 >= age
    assert [e for e, _ in m.trace] == ["window", "sink0"]


def test_monotonic_epoch_tracks_wall_clock(pk):
    import time

    a = pk.monotonic_epoch_ms()
    b = pk.monotonic_epoch_ms()
    assert b >= a  # immune to wall-clock steps
    assert abs(a - time.time() * 1000.0) < 60_000  # same epoch, roughly


def test_failing_job_writes_flight_dump(pk, tmp_path):
    # flow=100 keeps records under the chapter-3 Mbps filter so the
    # sink actually sees emissions (and can blow up on the first one)
    lines = [
        f"2020-01-01T00:{m:02d}:{s:02d} ch{(m + s) % 3} 100"
        for m in range(4)
        for s in range(60)
    ]
    flight_path = tmp_path / "flight.json"
    jsonl_path = tmp_path / "series.jsonl"
    cfg = pk.StreamConfig(
        batch_size=16, key_capacity=64,
        obs=pk.ObsConfig(enabled=True,
                      flight_dump_path=str(flight_path),
                      snapshot_path=str(jsonl_path)),
    )
    env = pk.StreamExecutionEnvironment(cfg)
    env.set_stream_time_characteristic(pk.TimeCharacteristic.EventTime)

    def explode(record):
        raise RuntimeError("sink on fire")

    pk.build_et(
        env,
        env.add_source(pk.ReplaySource(lines)),
        size=pk.Time.minutes(5),
        slide=pk.Time.seconds(5),
        delay=pk.Time.minutes(1),
    ).add_sink(explode)

    with pytest.raises(RuntimeError, match="sink on fire"):
        env.execute("doomed")

    dump = json.loads(flight_path.read_text())
    kinds = [e["kind"] for e in dump["events"]]
    assert "config_resolved" in kinds
    assert "program_built" in kinds
    last = dump["events"][-1]
    assert last["kind"] == "exception"
    assert last["error_type"] == "RuntimeError"
    assert last["operator"] == "window"  # the stage that was active
    (cfg_ev,) = [e for e in dump["events"] if e["kind"] == "config_resolved"]
    assert cfg_ev["config"]["batch_size"] == 16  # resolved config aboard

    # the snapshotter flushed its terminal state on failure
    final = [json.loads(l) for l in jsonl_path.read_text().splitlines()][-1]
    assert any(s["name"] == "operator_records_in"
               for s in final["metrics"]["series"])

