"""Counterparts of the JAX package's tests/test_tracing_export.py
(the single-device cases: the timeline golden, the snapshot round
trip, stride sampling, the bounded trace log, a traced job's timeline,
trace on/off output parity) over both packages (fixture ``pk``).
"""

import json

import pytest

from tests.test_torch_obs import pk  # noqa: F401


def _canned_parts(pk):
    tr = pk.StepTracer(capacity=64)
    tr._epoch = 100.0
    tr._record("pack", 1, "window", 100.01, 0.002)
    tr._record("dispatch", 1, "window", 100.02, 0.010)
    tr._record("fetch", 1, "window", 100.04, 0.030)
    tr._record("lane_parse", -1, "lane0", 100.005, 0.004)
    tr._record("lane_parse", -1, "lane1", 100.006, 0.004)
    flight = pk.FlightRecorder(capacity=8)
    flight._t0 = 100.0
    flight.record("watermark_jump", from_ms=0, to_ms=99, jump_ms=99)
    rt = pk.RecordTrace(marker_id=3, trace_id=2, source_offset=5,
                     tenant="acme", born_s=100.001)
    rt.add_span("pack", t0=100.012, dur=0.002, step=1)
    rt.add_span("device_step", t0=100.020, dur=0.010, step=1)
    rt.add_span("sink0", t0=100.070, dur=0.0, age_ms=69.0)
    log = pk.RecordTraceLog(8)
    log.add(rt)
    return tr, flight, log


def test_timeline_golden_shape(pk):
    tr, flight, log = _canned_parts(pk)
    tl = pk.timeline_from_parts(
        tr.events(), flight_events=flight.events(),
        record_traces=log.traces(), tracer_epoch_s=tr.epoch,
        flight_epoch_s=100.0,
    )
    # valid JSON, loadable the way Perfetto loads it
    blob = json.dumps(tl)
    loaded = json.loads(blob)
    assert loaded["displayTimeUnit"] == "ms"
    evs = loaded["traceEvents"]
    assert evs, "timeline must carry events"
    # every event has the Chrome-trace envelope
    for e in evs:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] != "M":
            assert e["ts"] >= 0
    # non-metadata events are ts-sorted (monotonic timeline)
    ts = [e["ts"] for e in evs if e["ph"] != "M"]
    assert ts == sorted(ts)
    # complete events carry a duration, instants a scope
    for e in evs:
        if e["ph"] == "X":
            assert e["dur"] >= 0
        elif e["ph"] == "i":
            assert e["s"] in ("p", "t")
    # pid layout: device spans, lane spans (one tid per lane), lineage
    assert any(e["pid"] == pk.PID_DEVICE and e["ph"] == "X"
               and e["name"] == "dispatch" for e in evs)
    lane_tids = {e["tid"] for e in evs
                 if e["pid"] == pk.PID_LANES and e["ph"] == "X"}
    assert lane_tids == {1, 2}
    rec = [e for e in evs if e["pid"] == pk.PID_RECORDS and e["ph"] != "M"]
    assert [e["name"] for e in rec][0] == "source"
    assert [e["name"] for e in rec][-1] == "sink0"
    assert all(e["args"]["trace_id"] == 2 for e in rec)
    # flight events are process-scoped instants on the device track
    assert any(e["ph"] == "i" and e["pid"] == pk.PID_DEVICE
               and e["name"] == "watermark_jump" for e in evs)
    # track-naming metadata rides along
    names = {(e["pid"], e["args"]["name"]) for e in evs if e["ph"] == "M"
             and e["name"] == "process_name"}
    assert (pk.PID_DEVICE, "device pipeline") in names
    assert (pk.PID_LANES, "ingest lanes") in names
    assert (pk.PID_RECORDS, "record lineage") in names
    assert tl["meta"]["n_record_traces"] == 1
    assert tl["meta"]["n_lane_spans"] == 2
    assert tl["meta"]["n_flight_instants"] == 1


def test_timeline_from_snapshot_roundtrip(pk):
    tr, flight, log = _canned_parts(pk)
    snap = {
        "trace": tr.snapshot(),
        "trace_meta": {"tracer_epoch_s": tr.epoch, "flight_epoch_s": 100.0},
        "flight_events": flight.events(),
        "record_traces": log.traces(),
    }
    direct = pk.timeline_from_parts(
        tr.events(), flight_events=flight.events(),
        record_traces=log.traces(), tracer_epoch_s=tr.epoch,
        flight_epoch_s=100.0,
    )
    via_snap = pk.timeline_from_snapshot(json.loads(json.dumps(snap)))
    assert via_snap["meta"] == direct["meta"]
    assert len(via_snap["traceEvents"]) == len(direct["traceEvents"])
    # a snapshot without a trace section (obs off) yields no timeline
    assert pk.timeline_from_snapshot({"metrics": {"series": []}}) is None


def test_stride_sampling_is_deterministic_and_bounded(pk):
    """The stamper samples by record stride, no RNG: two identical
    replays pick the same records, and a batch mints at most one."""

    def offsets():
        st = pk.MarkerStamper(1.0, trace_sample_rate=0.01)
        out = []
        for _ in range(10):
            t = st.poll_trace(64)  # 640 records -> ~6 traces at 1%
            if t is not None:
                out.append((t.trace_id, t.source_offset))
        return out

    a, b = offsets(), offsets()
    assert a == b
    assert 1 <= len(a) <= 7
    assert all(0 <= off < 64 for _, off in a)
    # rate 0 never mints; rates are clamped into [0, 1]
    assert pk.MarkerStamper(1.0).poll_trace(10_000) is None
    st = pk.MarkerStamper(1.0, trace_sample_rate=7.5)  # clamped to 1.0
    assert st.poll_trace(4) is not None


def test_record_trace_log_is_bounded(pk):
    log = pk.RecordTraceLog(2)
    for i in range(5):
        log.add({"trace_id": i, "spans": []})
    assert log.total == 5
    assert [t["trace_id"] for t in log.traces()] == [3, 4]
    # the null twin has the same surface and does nothing
    pk.NULL_TRACE_LOG.add({"trace_id": 9})
    assert pk.NULL_TRACE_LOG.traces() == [] and pk.NULL_TRACE_LOG.total == 0


ET_LINES = [
    f"2020-01-01T00:{m:02d}:{s:02d} ch{(m + s) % 3} {100 + (m * 60 + s) % 997}"
    for m in range(4)
    for s in range(60)
]


def _run_traced(pk, sample_rate, lanes=1, parallelism=1, **over):
    obs = pk.ObsConfig(
        enabled=True,
        latency_marker_interval_ms=1e-6 if sample_rate else 0.0,
        trace_sample_rate=sample_rate,
    )
    cfg = pk.StreamConfig(batch_size=16, key_capacity=64, obs=obs)
    kw = {}
    if lanes > 1:
        kw["ingest_lanes"] = lanes
    if parallelism > 1:
        kw["parallelism"] = parallelism
        kw["print_parallelism"] = 1
    kw.update(over)
    if kw:
        cfg = cfg.replace(**kw)
    env = pk.StreamExecutionEnvironment(cfg)
    env.set_stream_time_characteristic(pk.TimeCharacteristic.EventTime)
    h = pk.build_et(
        env,
        env.add_source(pk.ReplaySource(ET_LINES)),
        size=pk.Time.minutes(5),
        slide=pk.Time.seconds(5),
        delay=pk.Time.minutes(1),
    ).collect()
    env.execute("trace-e2e")
    return env.metrics, [repr(t) for t in h.items]


def test_traced_job_timeline_carries_all_tracks(pk):
    m, _ = _run_traced(pk, 1.0, lanes=2)
    snap = m.obs_snapshot()
    assert snap.get("record_traces"), "sampled lineage must reach the sink"
    # each trace walked the full flight path, source -> sink
    spans = [s["name"] for s in snap["record_traces"][0]["spans"]]
    assert spans[0] == "source" and spans[-1] == "sink0"
    assert "device_step" in spans and "pack" in spans and "fetch" in spans
    lane_traced = [
        t for t in snap["record_traces"]
        if any(s["name"] == "lane_parse" for s in t["spans"])
    ]
    assert lane_traced, "lane-parsed frames must carry the lane span"
    la = next(s for t in lane_traced for s in t["spans"]
              if s["name"] == "lane_parse")
    assert la["args"]["lane"] in (0, 1) and la["args"]["frame_seq"] >= 0
    # the unified timeline: valid JSON with every track populated
    tl = pk.timeline_from_snapshot(json.loads(json.dumps(snap, default=str)))
    meta = tl["meta"]
    assert meta["n_device_spans"] > 0
    assert meta["n_lane_spans"] > 0
    assert meta["n_record_traces"] > 0
    assert meta["n_flight_instants"] > 0
    evs = tl["traceEvents"]
    assert any(e["pid"] == pk.PID_LANES and e["ph"] == "X" for e in evs)
    assert any(e["pid"] == pk.PID_RECORDS and e["name"] == "sink0"
               for e in evs)
    # the sampling counter is a real registry series
    sampled = [s for s in snap["metrics"]["series"]
               if s["name"] == "record_traces_sampled_total"]
    assert sampled and sampled[0]["value"] == snap["record_traces_total"]


@pytest.mark.parametrize("setting", [
    dict(), dict(lanes=2), dict(async_depth=1, h2d_depth=1)],
    ids=["defaults", "lanes", "unstaged"])
def test_trace_spans_equal_the_jax_package(setting):
    """The step tracer's spans (one ``emit`` a dispatched step, whatever
    it emitted; an ``h2d`` hop only for a staged upload) and every
    sampled record's hops, in order (``pack`` on the batch it rode),
    are the JAX package's."""
    from tests.test_torch_obs import PKG

    got = {}
    for side in ("jax", "torch"):
        m, rows = _run_traced(PKG[side], 1.0, **setting)
        snap = m.obs_snapshot()
        kinds = {}
        for e in snap["trace"]["events"]:
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        hops = [[s["name"] for s in t["spans"]] for t in snap["record_traces"]]
        got[side] = (rows, kinds, hops)
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][2] == got["jax"][2] and got["jax"][2]


def test_trace_parity_single_chip(pk):
    """Tracing is a control-lane concern: output is byte-identical with
    sampling at 100% vs fully off."""
    _, on_rows = _run_traced(pk, 1.0)
    _, off_rows = _run_traced(pk, 0.0)
    assert on_rows, "the parity job must produce output"
    assert on_rows == off_rows

