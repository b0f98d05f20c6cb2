"""Continuous pipeline profiler: live per-stage wall-time attribution.

Counterpart of tpustream/obs/profiler.py (the port's own copy).

The offline story (``bench.py decompose_full_path``) answers "which
stage binds the pipeline" by re-running a workload stage by stage. A
production job can't re-run itself — but the StepTracer already times
every ``parse``/``pack``/``h2d``/``dispatch``/``fetch``/``emit`` span as
it happens. :class:`PipelineProfiler` drains those spans incrementally
into one bounded :class:`~tpustream_torch.obs.timeseries.TimeSeries` per
stage and, at every snapshot tick, turns the lookback window into:

* per-stage ``n/total_ms/mean_ms/p50_ms/p99_ms/share`` — share is the
  stage's fraction of summed stage time, the live analogue of the
  offline decomposition's attribution;
* the **binding stage** (largest share) as a live gauge
  (``profile_binding_stage``, valued by SPAN_KINDS index) — the signal
  the adaptive controller and a dashboard alert both want;
* **occupancy** — summed stage time divided by the wall-clock span the
  samples cover. Under a well-overlapped pipeline this exceeds 1.0
  (stages run concurrently); ~1.0 means serialized; far below 1.0 means
  the pipeline is starved (source-bound).

The ``profile()`` dict feeds the ``profile`` section of
``/snapshot.json`` and ``dump --profile``. Everything here is pure
stdlib over the tracer's ring — no jax, safe for the dump selftest.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from .registry import NULL_COUNTER, NULL_GAUGE
from .timeseries import TimeSeries
from .tracing import SPAN_KINDS


class PipelineProfiler:
    """Incremental span consumer + windowed stage attribution."""

    enabled = True

    def __init__(self, tracer, group=None, window_s: float = 30.0,
                 ring: int = 512, clock=None):
        self.tracer = tracer
        self.window_s = float(window_s)
        self._clock = clock or time.perf_counter
        self.series: Dict[str, TimeSeries] = {
            k: TimeSeries(ring, kind="sample") for k in SPAN_KINDS
        }
        self._consumed = 0  # tracer.total_spans already drained
        self.dropped = 0    # spans the tracer ring evicted before drain
        # FlightRecorder, set by JobObs post-construction: the FIRST
        # drain that loses spans leaves one breadcrumb (never spams)
        self.flight = None
        self._drop_breadcrumbed = False
        if group is not None:
            self._binding_gauge = group.gauge("profile_binding_stage")
            self._occupancy_gauge = group.gauge("profile_occupancy")
            self._dropped_counter = group.counter("profile_spans_dropped")
            self._share_gauges = {
                k: group.group(stage=k).gauge("profile_stage_share")
                for k in SPAN_KINDS
            }
            self._ms_gauges = {
                k: group.group(stage=k).gauge("profile_stage_ms")
                for k in SPAN_KINDS
            }
        else:
            self._binding_gauge = NULL_GAUGE
            self._occupancy_gauge = NULL_GAUGE
            self._dropped_counter = NULL_COUNTER
            self._share_gauges = {k: NULL_GAUGE for k in SPAN_KINDS}
            self._ms_gauges = {k: NULL_GAUGE for k in SPAN_KINDS}

    # -- ingestion -----------------------------------------------------------

    def collect(self) -> int:
        """Drain spans recorded since the last collect into the stage
        series. Cheap enough for every snapshot tick; returns the number
        of spans consumed."""
        total = self.tracer.total_spans
        new = total - self._consumed
        if new <= 0:
            return 0
        evs = self.tracer.raw_tail(new)
        lost = new - len(evs)
        if lost > 0:
            self.dropped += lost
            self._dropped_counter.inc(lost)
            if self.flight is not None and not self._drop_breadcrumbed:
                self._drop_breadcrumbed = True
                try:
                    self.flight.record(
                        "profile_spans_dropped", lost=lost,
                        capacity=getattr(self.tracer, "capacity", 0),
                    )
                except Exception:
                    pass
        epoch = getattr(self.tracer, "epoch", 0.0)
        for (kind, _step, _op, t0, dur) in evs:
            ser = self.series.get(kind)
            if ser is not None:
                # timestamped at span END (absolute registry-clock s)
                ser.record(epoch + t0 + dur, dur * 1000.0)
        self._consumed = total
        return len(evs)

    # -- attribution ---------------------------------------------------------

    def profile(self, window_s: Optional[float] = None,
                now: Optional[float] = None) -> dict:
        """Windowed attribution dict (see module docstring); also pushes
        the binding/occupancy/share gauges so the registry snapshot that
        wraps this call carries matching series."""
        self.collect()
        w = float(window_s) if window_s else self.window_s
        if now is None:
            now = self._clock()
        stages = {}
        totals = {}
        t_lo_seen: Optional[float] = None
        t_hi_seen: Optional[float] = None
        steps = 0
        for k in SPAN_KINDS:
            ser = self.series[k]
            pts = ser.points(w, now)
            n = len(pts)
            tot = sum(v for _, v in pts)
            totals[k] = tot
            steps = max(steps, n)
            if n:
                t_lo_seen = pts[0][0] if t_lo_seen is None else min(t_lo_seen, pts[0][0])
                t_hi_seen = pts[-1][0] if t_hi_seen is None else max(t_hi_seen, pts[-1][0])
            stages[k] = {
                "n": n,
                "total_ms": round(tot, 6),
                "mean_ms": round(tot / n, 6) if n else 0.0,
                "p50_ms": round(ser.quantile(0.5, w, now), 6) if n else 0.0,
                "p99_ms": round(ser.quantile(0.99, w, now), 6) if n else 0.0,
            }
        total_ms = sum(totals.values())
        binding = ""
        binding_share = 0.0
        for k in SPAN_KINDS:
            share = (totals[k] / total_ms) if total_ms > 0 else 0.0
            stages[k]["share"] = round(share, 6)
            if totals[k] > 0 and share > binding_share:
                binding, binding_share = k, share
        wall_ms = ((t_hi_seen - t_lo_seen) * 1000.0
                   if (t_lo_seen is not None and t_hi_seen is not None
                       and t_hi_seen > t_lo_seen) else 0.0)
        occupancy = (total_ms / wall_ms) if wall_ms > 0 else 0.0
        if binding:
            self._binding_gauge.set(float(SPAN_KINDS.index(binding)))
        self._occupancy_gauge.set(round(occupancy, 6))
        for k in SPAN_KINDS:
            self._share_gauges[k].set(stages[k]["share"])
            self._ms_gauges[k].set(stages[k]["total_ms"])
        return {
            "window_s": w,
            "stage_kinds": list(SPAN_KINDS),
            "binding_stage": binding,
            "binding_stage_index": SPAN_KINDS.index(binding) if binding else -1,
            "binding_share": round(binding_share, 6),
            "occupancy": round(occupancy, 6),
            "batch_wall_ms": round(total_ms / steps, 6) if steps else 0.0,
            "spans_dropped": self.dropped,
            "stages": stages,
        }
