"""Observability: hierarchical metrics registry, structured step tracing,
and snapshot/exposition (Prometheus text + JSON).

Counterpart of tpustream/obs for the PyTorch port: the host-side modules
are the port's own copies. The reference tutorial
has no observability beyond the print sink; a production Flink-class
runtime ships per-operator metric groups, watermark-lag and
backpressure gauges, and a reporter surface (Flink's ``MetricGroup`` /
Prometheus reporter). This package provides:

* :mod:`tpustream_torch.obs.registry` — ``MetricsRegistry`` with
  Counter/Gauge/Histogram instruments scoped by ``job``/``operator``/
  ``shard`` label hierarchy.
* :mod:`tpustream_torch.obs.tracing` — per-step span events (parse,
  pack, h2d, dispatch, fetch, emit) in a bounded ring buffer, fed by
  the job's span recorder (``runtime/spans.py``), which also opens a
  ``torch.profiler.record_function`` range a span whenever a profiler
  capture records.
* :mod:`tpustream_torch.obs.timeseries` — bounded ``(timestamp,
  value)`` history rings behind every registry instrument with windowed
  ``rate()``/``delta()``/``mean()``/``quantile()``, mergeable.
* :mod:`tpustream_torch.obs.profiler` — continuous pipeline profiler:
  span time per stage, the live binding stage and stage shares.
* :mod:`tpustream_torch.obs.snapshot` — point-in-time JSON snapshots, a
  periodic snapshotter on an absolute deadline grid, and the Prometheus
  text renderer.
* :mod:`tpustream_torch.obs.latency` — end-to-end latency markers
  (Flink's ``LatencyMarker``) and sampled ``RecordTrace`` probes.
* :mod:`tpustream_torch.obs.tracing_export` — the unified Chrome-trace
  timeline (spans, flight events, record flight paths).
* :mod:`tpustream_torch.obs.health` — declarative ``AlertRule`` set
  evaluated at snapshot ticks by a ``HealthEngine`` (OK/WARN/CRIT).
* :mod:`tpustream_torch.obs.flightrecorder` — bounded ring of runtime
  incidents, dumped as postmortem JSON on failure or on demand.
* :mod:`tpustream_torch.obs.compilation` — the build registry: every
  device-program build and every state reshape (key-capacity growth,
  tenant-capacity growth) counted with its cause.
* :mod:`tpustream_torch.obs.memory` — state-memory accounting: the
  state's device bytes (``hbm_state_bytes``, the reference's name), its
  bytes by component, key-table capacity/occupancy/load factor, and the
  key-cardinality and hot-key-skew gauges.
* :mod:`tpustream_torch.obs.ledger` — the conservation ledger: per-edge
  record accounting (source, chain hand-offs, sink and side-output
  fan-out, retained contents) with latched violations behind a CRIT
  health rule, and per-sink digest anchors that checkpoints carry and
  restores verify.
* :mod:`tpustream_torch.obs.resources` — the resource plane: a
  ``/proc`` sampler and the ``EnvFingerprint`` (usable cores, NUMA
  nodes, the job's device, a hostname hash).
* :mod:`tpustream_torch.obs.serve` — opt-in live scrape endpoint
  (``ObsConfig.serve_port``): ``/metrics``, ``/healthz``,
  ``/snapshot.json``, ``/tenants.json``.
* :mod:`tpustream_torch.obs.slo` — per-tenant SLOs compiled into health
  rules.

* :mod:`tpustream_torch.obs.dump` — ``python -m tpustream_torch.obs.dump``
  pretty-prints a snapshot file (table, Prometheus text, health,
  tenants, ledger, profile, trace, a checkpoint directory's tree);
  ``--selftest`` needs no input.

Design stance: instruments update **per batch/step only** — never per
record — and every hot-path hook has a null twin
(:data:`tpustream_torch.obs.registry.NULL_COUNTER`,
:data:`tpustream_torch.obs.tracing.NULL_TRACER`) so a job with
``StreamConfig.obs.enabled = False`` does no observability work beyond
a no-op attribute call per step.
"""


from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricGroup,
    MetricsRegistry,
    NULL_COUNTER,
    NULL_GAUGE,
    NULL_HISTOGRAM,
)
from .timeseries import TimeSeries  # noqa: F401
from .tracing import NULL_TRACER, StepTracer  # noqa: F401
from .profiler import PipelineProfiler  # noqa: F401
from .snapshot import Snapshotter, job_snapshot, write_snapshot  # noqa: F401
from .latency import (  # noqa: F401
    LatencyMarker,
    MarkerStamper,
    RecordTrace,
    stamp_markers,
)
from .tracing_export import (  # noqa: F401
    NULL_TRACE_LOG,
    RecordTraceLog,
    timeline_from_parts,
    timeline_from_snapshot,
)
from .health import AlertRule, HealthEngine, as_rule  # noqa: F401
from .flightrecorder import (  # noqa: F401
    FlightRecorder,
    NULL_FLIGHT,
    jsonable_config,
)
from .runtime import (  # noqa: F401
    JobObs,
    NULL_JOB_OBS,
    NULL_OPERATOR_OBS,
    OperatorObs,
)
from .compilation import CompileObs  # noqa: F401
from .memory import StateMemoryTracker, leaf_nbytes  # noqa: F401
from .serve import MetricsServer  # noqa: F401
from .slo import (  # noqa: F401
    OTHER_TENANT,
    TenantSLO,
    compile_tenant_slo,
    slo_rule_names,
)
from .catalog import series_is_known, unknown_series  # noqa: F401
from .resources import (  # noqa: F401
    EnvFingerprint,
    ResourceSampler,
    collect_env_fingerprint,
    usable_cores,
)
