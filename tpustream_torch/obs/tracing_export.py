"""Unified Chrome-trace/Perfetto timeline export + record-trace log.

Counterpart of tpustream/obs/tracing_export.py (the port's own copy).

The obs stack already produces span fragments in three clocks:
:class:`~tpustream_torch.obs.tracing.StepTracer` spans (start times relative
to the tracer epoch), :class:`~tpustream_torch.obs.flightrecorder
.FlightRecorder` events (``t_s`` relative to the recorder's ``_t0``),
and sampled :class:`~tpustream_torch.obs.latency.RecordTrace` flight paths
(absolute ``perf_counter`` span starts). This module folds all of them
onto ONE timeline in the Chrome trace-event JSON format, loadable
directly by ``ui.perfetto.dev`` or ``chrome://tracing``:

- pid 1 "device pipeline" — StepTracer spans, one tid per span kind
  (pack / h2d / dispatch / fetch / emit / parse);
- pid 2 "ingest lanes" — ``lane_parse`` spans, one tid per lane;
- pid 3 "record lineage" — each sampled record trace on its own tid,
  hop durations as "X" slices and edge crossings as "i" instants;
- flight-recorder events — process-scoped "i" instants on pid 1.

Everything here is stdlib-only (``dump.py`` must run with no jax), and
all builders are pure functions over snapshot-shaped data, so a
timeline can be produced live (``/trace.json``), from a job snapshot
(``python -m tpustream_torch.obs.dump --trace``), or from a bench JSON tail.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Iterable, List, Optional

from .tracing import SPAN_KINDS

# stable pid layout for the exported timeline
PID_DEVICE = 1
PID_LANES = 2
PID_RECORDS = 3

_KIND_TID = {k: i + 1 for i, k in enumerate(SPAN_KINDS)}


class RecordTraceLog:
    """Bounded ring of completed record flight paths.

    The executor's terminal stage pushes each sampled
    :class:`RecordTrace` here after recording its sink edges; the ring
    keeps the newest ``capacity`` while ``total`` counts every trace
    ever finished (so a snapshot reveals eviction).
    """

    enabled = True

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._ring = deque(maxlen=self.capacity)
        self.total = 0

    def add(self, trace) -> None:
        self._ring.append(trace.to_dict() if hasattr(trace, "to_dict")
                          else dict(trace))
        self.total += 1

    def traces(self) -> List[dict]:
        return list(self._ring)


class _NullTraceLog:
    """Disabled twin: same surface, no state, no work."""

    enabled = False
    capacity = 0
    total = 0

    __slots__ = ()

    def add(self, trace) -> None:
        pass

    def traces(self) -> list:
        return []


NULL_TRACE_LOG = _NullTraceLog()


def _us(t_abs: float, base: float) -> float:
    return max(0.0, round((t_abs - base) * 1e6, 3))


def timeline_from_parts(
    trace_events: Iterable[dict],
    flight_events: Iterable[dict] = (),
    record_traces: Iterable[dict] = (),
    tracer_epoch_s: float = 0.0,
    flight_epoch_s: Optional[float] = None,
    meta: Optional[dict] = None,
) -> dict:
    """Fold span fragments into one Chrome-trace dict.

    ``trace_events`` are ``StepTracer.events()`` dicts (``t_start_s``
    relative to ``tracer_epoch_s``); ``flight_events`` are
    ``FlightRecorder.events()`` dicts (``t_s`` relative to
    ``flight_epoch_s`` — falls back to the tracer epoch when the caller
    has no recorder clock); ``record_traces`` are ``RecordTrace
    .to_dict()`` payloads (absolute span starts). Timestamps are
    re-based to the earliest event and exported in microseconds, as the
    format requires.
    """
    trace_events = list(trace_events or ())
    flight_events = list(flight_events or ())
    record_traces = list(record_traces or ())
    if flight_epoch_s is None:
        flight_epoch_s = tracer_epoch_s

    # pass 1: earliest absolute time across all three sources
    starts = []
    for ev in trace_events:
        starts.append(tracer_epoch_s + ev.get("t_start_s", 0.0))
    for ev in flight_events:
        starts.append(flight_epoch_s + ev.get("t_s", 0.0))
    for rt in record_traces:
        for sp in rt.get("spans", ()):
            starts.append(sp.get("t0_s", 0.0))
    base = min(starts) if starts else 0.0

    events: List[dict] = []

    # pass 2a: device-pipeline + lane spans
    lane_tids = {}
    for ev in trace_events:
        kind = ev.get("kind", "?")
        t_abs = tracer_epoch_s + ev.get("t_start_s", 0.0)
        args = {"step": ev.get("step", -1)}
        if ev.get("operator"):
            args["operator"] = ev["operator"]
        if kind == "lane_parse":
            # operator is "lane<N>" (runtime/ingest.py merge point)
            op = str(ev.get("operator", ""))
            try:
                lane = int(op[4:]) if op.startswith("lane") else len(lane_tids)
            except ValueError:
                lane = len(lane_tids)
            tid = lane_tids.setdefault(lane, lane + 1)
            pid = PID_LANES
        else:
            pid = PID_DEVICE
            tid = _KIND_TID.get(kind, len(SPAN_KINDS) + 1)
        events.append({
            "name": kind, "ph": "X", "pid": pid, "tid": tid,
            "ts": _us(t_abs, base),
            "dur": max(0.0, round(ev.get("dur_s", 0.0) * 1e6, 3)),
            "args": args,
        })

    # pass 2b: flight events as process-scoped instants
    for ev in flight_events:
        t_abs = flight_epoch_s + ev.get("t_s", 0.0)
        args = {k: v for k, v in ev.items() if k not in ("kind", "t_s")}
        events.append({
            "name": str(ev.get("kind", "flight")), "ph": "i", "s": "p",
            "pid": PID_DEVICE, "tid": 0, "ts": _us(t_abs, base),
            "args": args,
        })

    # pass 2c: record lineage — one tid per sampled record
    rec_tids = []
    for rt in record_traces:
        tid = rt.get("trace_id", len(rec_tids) + 1) or len(rec_tids) + 1
        rec_tids.append((tid, rt))
        for sp in rt.get("spans", ()):
            dur = sp.get("dur_s", 0.0)
            args = dict(sp.get("args") or {})
            args["trace_id"] = rt.get("trace_id", 0)
            ev = {
                "name": str(sp.get("name", "?")),
                "pid": PID_RECORDS, "tid": tid,
                "ts": _us(sp.get("t0_s", 0.0), base),
                "args": args,
            }
            if dur > 0:
                ev["ph"] = "X"
                ev["dur"] = round(dur * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)

    events.sort(key=lambda e: (e["ts"], e["pid"], e["tid"]))

    # metadata events first, so viewers label tracks before slices land
    md: List[dict] = []

    def _meta(pid, name, tid=None, tname=None):
        if tid is None:
            md.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": name}})
        else:
            md.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname}})

    _meta(PID_DEVICE, "device pipeline")
    for kind, tid in _KIND_TID.items():
        if kind != "lane_parse":
            _meta(PID_DEVICE, None, tid=tid, tname=kind)
    if lane_tids:
        _meta(PID_LANES, "ingest lanes")
        for lane, tid in sorted(lane_tids.items()):
            _meta(PID_LANES, None, tid=tid, tname=f"lane{lane}")
    if rec_tids:
        _meta(PID_RECORDS, "record lineage")
        for tid, rt in rec_tids:
            tname = f"trace {rt.get('trace_id', tid)}"
            if rt.get("tenant"):
                tname += f" [{rt['tenant']}]"
            _meta(PID_RECORDS, None, tid=tid, tname=tname)

    out_meta = {
        "n_device_spans": sum(
            1 for e in events if e["pid"] == PID_DEVICE and e["ph"] == "X"),
        "n_lane_spans": sum(1 for e in events if e["pid"] == PID_LANES),
        "n_flight_instants": sum(
            1 for e in events if e["pid"] == PID_DEVICE and e["ph"] == "i"),
        "n_record_traces": len(rec_tids),
        "base_perf_counter_s": round(base, 6),
    }
    if meta:
        out_meta.update(meta)
    return {
        "traceEvents": md + events,
        "displayTimeUnit": "ms",
        "meta": out_meta,
    }


def timeline_from_snapshot(snap: dict) -> Optional[dict]:
    """Build the timeline from a job snapshot dict (``JobObs.snapshot``
    / ``Metrics.obs_snapshot`` shape). Returns None when the snapshot
    carries no trace section (obs or tracing disabled)."""
    trace = snap.get("trace")
    if not isinstance(trace, dict):
        return None
    tm = snap.get("trace_meta") or {}
    return timeline_from_parts(
        trace.get("events", ()),
        flight_events=snap.get("flight_events", ()),
        record_traces=snap.get("record_traces", ()),
        tracer_epoch_s=tm.get("tracer_epoch_s", 0.0),
        flight_epoch_s=tm.get("flight_epoch_s"),
        meta={"snapshot_meta": snap.get("meta")} if snap.get("meta") else None,
    )


def timeline_json(timeline: dict) -> str:
    """Serialize a timeline dict; round-trips through ``json.loads``."""
    return json.dumps(timeline, default=str)
