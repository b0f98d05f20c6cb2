"""End-to-end latency markers, after Flink's ``LatencyMarker``.

Counterpart of tpustream/obs/latency.py (the port's own copy).

Batch- and step-scoped timings (``operator_step_time_s``,
``sink_emit_latency_s``) tell you how long *one hop* took; they cannot
answer "how long does a record take from ingestion to the sink" because
the pipeline overlaps stages (inflight emission groups, chained
runners, parse-ahead). Latency markers answer that directly: the
source-side stamper emits a :class:`LatencyMarker` every
``ObsConfig.latency_marker_interval_ms`` of wall time, and the marker
then rides the *same* pack/dispatch/fetch/emit path as data batches —
through every chained runner stage and emission group — so the time
from its birth to each downstream edge is a faithful sample of true
end-to-end latency, pipelining included.

Markers are control events, not records: they are excluded from
operator semantics (never keyed, aggregated, windowed, or emitted to
user sinks) and never enter jitted code. Each marker is O(1) per
*interval*, so the record path stays zero-cost — with obs disabled (or
``latency_marker_interval_ms == 0``) the stamper is not installed at
all and ``SourceBatch.markers`` stays ``None``.

Timestamps are ``time.monotonic_ns()`` so an NTP step can never produce
a negative latency; see :func:`tpustream_torch.runtime.sources.monotonic_epoch_ms`
for the same decision on the ingestion-timestamp side.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class LatencyMarker:
    """One latency probe, born at a source.

    ``emitted_at_ns`` is a ``monotonic_ns`` stamp taken when the marker
    entered the stream; ``age_ms`` against a later ``monotonic_ns``
    reading is the source→here latency. ``trace`` accumulates the
    ``(edge, age_ms)`` hops the marker has crossed — cheap (a handful of
    tuples per marker) and it turns any single marker into a readable
    per-stage latency breakdown in tests and flight dumps.

    ``tenant`` attributes the marker to one logical job of a fleet
    (docs/multitenancy.md): the JobServer's round-robin provider labels
    each minted marker with an active tenant, and the terminal stage
    routes its sink-edge age into that tenant's
    ``tenant_e2e_latency_ms{tenant=...}`` series alongside the fused
    job-level histogram. ``None`` (single-job runs) records the job-level
    series only.
    """

    marker_id: int
    source: str = "source"
    emitted_at_ns: int = 0
    trace: list = field(default_factory=list)
    tenant: Optional[str] = None

    def __post_init__(self):
        if not self.emitted_at_ns:
            self.emitted_at_ns = time.monotonic_ns()

    def age_ms(self, now_ns: int = 0) -> float:
        return ((now_ns or time.monotonic_ns()) - self.emitted_at_ns) / 1e6

    def observe(self, edge: str, now_ns: int = 0) -> float:
        """Record this marker crossing ``edge``; returns the age in ms."""
        age = self.age_ms(now_ns)
        self.trace.append((edge, round(age, 3)))
        return age


@dataclass
class RecordTrace(LatencyMarker):
    """A latency marker promoted to a full flight-path probe.

    Stands in for one sampled record (``source_offset`` is the record's
    offset within its source batch) and rides the exact same marker
    side-channel — excluded from operator semantics, so output is
    byte-identical with tracing on or off. On top of the ``(edge,
    age_ms)`` hop trace it accumulates ``spans``: dicts with absolute
    ``perf_counter`` start times so the exporter can place them on the
    same timeline as StepTracer spans and flight events. Every
    :meth:`observe` edge crossing (operator edges, ``sinkN``) also
    becomes a zero-duration span, so the pump chain needs no extra hooks.
    """

    trace_id: int = 0
    source_offset: int = -1
    born_s: float = 0.0          # perf_counter at birth (exporter clock)
    spans: list = field(default_factory=list)

    def __post_init__(self):
        super().__post_init__()
        if not self.born_s:
            self.born_s = time.perf_counter()
        self.spans.append({
            "name": "source", "t0_s": self.born_s, "dur_s": 0.0,
            "args": {"offset": self.source_offset, "tenant": self.tenant},
        })

    def add_span(self, name: str, t0: float = 0.0, dur: float = 0.0,
                 **attrs) -> None:
        self.spans.append({
            "name": name,
            "t0_s": t0 or time.perf_counter(),
            "dur_s": dur,
            "args": attrs,
        })

    def add_host_parse(self, t0: float, dur: float) -> None:
        """The main-loop parse/merge span for this trace's batch. Named
        ``merge`` when an ingest lane already parsed the frame (the
        main-loop work is then the seq-ordered merge), ``parse`` on the
        inline host path."""
        laned = any(s["name"] == "lane_parse" for s in self.spans)
        self.add_span("merge" if laned else "parse", t0=t0, dur=dur)

    def observe(self, edge: str, now_ns: int = 0) -> float:
        age = super().observe(edge, now_ns)
        self.add_span(edge, dur=0.0, age_ms=round(age, 3))
        return age

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "marker_id": self.marker_id,
            "source": self.source,
            "source_offset": self.source_offset,
            "tenant": self.tenant,
            "born_s": self.born_s,
            "spans": list(self.spans),
            "trace": list(self.trace),
        }


class MarkerStamper:
    """Decides when the next marker is due and mints it.

    One stamper per job; the executor asks :meth:`poll` once per source
    batch (batch-scoped, never per record). Interval accounting is
    monotonic and skew-proof: after a long stall only one marker is
    emitted, not a burst of catch-ups — markers sample latency, they do
    not backfill it.
    """

    def __init__(self, interval_ms: float, source: str = "source",
                 counter=None, tenant_provider=None,
                 trace_sample_rate: float = 0.0, trace_counter=None):
        self.interval_s = max(0.0, float(interval_ms)) / 1000.0
        self.source = source
        self._counter = counter      # obs Counter: markers emitted
        self._next_id = 0
        self._last_emit_s = None     # None -> first batch gets a marker
        # callable() -> Optional[str]: the tenant label for the NEXT
        # marker (the JobServer installs a round-robin over its active
        # tenants, bounded to top-K + "__other__"). None = unlabeled.
        self.tenant_provider = tenant_provider
        # record flight-path sampling: promote ~rate of records to
        # RecordTrace probes. Deterministic stride (no RNG) so a replay
        # of the same input samples the same records.
        rate = min(1.0, max(0.0, float(trace_sample_rate)))
        self.trace_sample_rate = rate
        self._trace_stride = int(round(1.0 / rate)) if rate > 0 else 0
        self._trace_counter = trace_counter
        self._records_seen = 0
        self._next_trace_at = 0      # record index of the next sample
        self._next_trace_id = 0

    def poll_trace(self, n_records: int):
        """-> RecordTrace if the sampling stride lands inside the next
        ``n_records`` records, else None. At most one trace per batch —
        lineage wants representative records, not bursts — so the stride
        boundary is advanced past the whole batch either way."""
        if not self._trace_stride or n_records <= 0:
            return None
        start = self._records_seen
        self._records_seen = start + n_records
        if self._next_trace_at >= self._records_seen:
            return None
        offset = max(0, self._next_trace_at - start)
        self._next_trace_at = self._records_seen + self._trace_stride - 1
        self._next_trace_id += 1
        self._next_id += 1
        tenant = (
            self.tenant_provider() if self.tenant_provider is not None
            else None
        )
        t = RecordTrace(
            marker_id=self._next_id, source=self.source, tenant=tenant,
            trace_id=self._next_trace_id, source_offset=offset,
        )
        if self._trace_counter is not None:
            self._trace_counter.inc()
        return t

    def poll(self, now_s: float = 0.0):
        """-> LatencyMarker if one is due at ``now_s`` (monotonic
        seconds), else None."""
        now_s = now_s or time.monotonic()
        if (self._last_emit_s is not None
                and now_s - self._last_emit_s < self.interval_s):
            return None
        self._last_emit_s = now_s
        self._next_id += 1
        tenant = (
            self.tenant_provider() if self.tenant_provider is not None
            else None
        )
        m = LatencyMarker(
            marker_id=self._next_id, source=self.source, tenant=tenant
        )
        if self._counter is not None:
            self._counter.inc()
        return m


def stamp_markers(batches, stamper: MarkerStamper):
    """Wrap a ``SourceBatch`` iterator, attaching a due marker to each
    batch's ``markers`` list. Installed by the executor only when obs is
    enabled and ``latency_marker_interval_ms > 0`` — the disabled path
    iterates the raw source directly."""
    for batch in batches:
        m = stamper.poll()
        if m is not None:
            if batch.markers is None:
                batch.markers = []
            batch.markers.append(m)
        t = stamper.poll_trace(getattr(batch, "n_records", 0))
        if t is not None:
            if batch.markers is None:
                batch.markers = []
            batch.markers.append(t)
        yield batch
