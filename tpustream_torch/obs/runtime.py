"""Runtime-facing observability bundles.

Counterpart of tpustream/obs/runtime.py (a copy; the root also names
the job's device for its environment fingerprint).

The executor talks to observability exclusively through two small
objects — :class:`JobObs` (one per job: shared registry, tracer,
snapshotter, job-scope gauges) and :class:`OperatorObs` (one per runner:
the operator-labelled counters/histograms/gauges, and the ring the
runner's spans go to through the job's span recorder).
Both have null twins with the identical surface, installed when
``StreamConfig.obs.enabled`` is False, so every hot-path call site is an
unconditional attribute call with no ``if obs:`` branches.

Naming scheme (see docs/observability.md): job-scope series carry a
``job`` label; operator-scope series add ``operator`` (and optionally
``shard``) and an ``operator_`` name prefix.
"""

from __future__ import annotations

from typing import Optional

from .flightrecorder import FlightRecorder, NULL_FLIGHT
from .health import HealthEngine
from .registry import MetricsRegistry, NULL_COUNTER, NULL_GAUGE, NULL_HISTOGRAM
from .snapshot import Snapshotter, job_snapshot
from .tracing import NULL_TRACER, StepTracer
from .tracing_export import NULL_TRACE_LOG, RecordTraceLog, timeline_from_parts


class OperatorObs:
    """Per-operator instrument bundle, minted by :meth:`JobObs.operator`."""

    enabled = True

    def __init__(self, group, tracer, hist_samples: int = 8192):
        self._group = group
        self.tracer = tracer
        self.name = group.labels.get("operator", "")
        self._hist_samples = int(hist_samples)
        self.records_in = group.counter("operator_records_in")
        self.records_emitted = group.counter("operator_records_emitted")
        self.steps = group.counter("operator_steps")
        # async enqueue time (the _run_step stopwatch) vs the blocking
        # fetch wait (_finish_group, divided per step) — together they
        # are the job-level step_times_s series, split by phase here
        self.dispatch_time_s = group.histogram(
            "operator_dispatch_time_s", max_samples=self._hist_samples
        )
        self.step_time_s = group.histogram(
            "operator_step_time_s", max_samples=self._hist_samples
        )
        self.inflight = group.gauge("operator_inflight_steps")

    def shard(self, index) -> "OperatorObs":
        """Same operator, one mesh shard: adds the ``shard`` label."""
        return OperatorObs(
            self._group.group(shard=str(index)), self.tracer, self._hist_samples
        )

    def scoped(self, **labels):
        """Raw label sub-scope under this operator (``cause=...``,
        ``component=...``, ``shard=...``) for series that need an extra
        dimension without minting a whole instrument bundle. Instrument
        names are NOT auto-prefixed here — callers pass the full
        ``operator_*`` name."""
        return self._group.group(**labels)

    def counter(self, name: str):
        return self._group.counter("operator_" + name)

    def gauge(self, name: str):
        return self._group.gauge("operator_" + name)

    def histogram(self, name: str):
        return self._group.histogram(
            "operator_" + name, max_samples=self._hist_samples
        )


class JobObs:
    """Per-job observability root: one registry + tracer + snapshotter
    shared by the Metrics facade and every runner's OperatorObs."""

    enabled = True

    def __init__(self, obs_cfg=None, job_name: str = "job",
                 registry: Optional[MetricsRegistry] = None,
                 flight: Optional[FlightRecorder] = None,
                 device: Optional[str] = None):
        cfg = obs_cfg
        trace = getattr(cfg, "trace", True)
        ring = getattr(cfg, "trace_ring_size", 4096)
        self.hist_samples = getattr(cfg, "step_histogram_samples", 8192)
        self.registry = registry or MetricsRegistry()
        # history/retention knobs must land before any series is minted
        # (they are applied at mint time); re-applying to a shared
        # registry across restart attempts is idempotent
        self.registry.history_capacity = int(getattr(cfg, "timeseries_ring", 512))
        self.registry.history_digest = int(getattr(cfg, "timeseries_digest", 64))
        self.registry.default_reservoir = int(
            getattr(cfg, "histogram_reservoir", 4096)
        )
        self.job_name = str(job_name)
        self.group = self.registry.group(job=self.job_name)
        self.tracer = StepTracer(ring) if trace else NULL_TRACER
        # completed record flight paths (obs/tracing_export.py): the
        # executor's terminal stage feeds this when trace_sample_rate>0
        self.traces = RecordTraceLog(getattr(cfg, "trace_max_records", 256))
        self.snapshotter = Snapshotter(
            self.registry,
            self.tracer,
            interval_s=getattr(cfg, "snapshot_interval_s", 0.0),
            jsonl_path=getattr(cfg, "snapshot_path", "") or None,
            meta={"job": self.job_name},
        )
        # continuous per-stage profiler (obs/profiler.py) rides the
        # tracer; snapshots embed its windowed attribution as "profile"
        self.profiler = None
        if trace:
            from .profiler import PipelineProfiler

            self.profiler = PipelineProfiler(
                self.tracer,
                self.group,
                window_s=getattr(cfg, "profile_window_s", 30.0),
                ring=self.registry.history_capacity or 512,
            )
        self.snapshotter.profiler = self.profiler
        self._op_names: dict = {}

        # environment fingerprint (obs/resources.py): what host/device
        # this job actually ran on, embedded in every snapshot's meta
        # and served at /env.json — collection is a handful of file
        # reads plus the job's device (``device``: StreamConfig.device)
        self.env_fingerprint = None
        try:
            from .resources import collect_env_fingerprint

            self.env_fingerprint = collect_env_fingerprint(device=device)
            self.snapshotter.meta["env"] = self.env_fingerprint.to_dict()
        except Exception:
            self.env_fingerprint = None

        # crash-dump flight recorder (obs/flightrecorder.py); a
        # supervised job passes ONE recorder through every restart
        # attempt so the postmortem ring spans failure -> restart ->
        # restored, not just the last attempt
        self.flight = flight if flight is not None else (
            FlightRecorder(getattr(cfg, "flight_ring_size", 512))
            if getattr(cfg, "flight_recorder", True)
            else NULL_FLIGHT
        )
        self.flight_dump_path = getattr(cfg, "flight_dump_path", "") or ""
        # span-drop accounting: tracer/profiler ring overflow counts
        # into trace_spans_dropped_total and leaves ONE flight
        # breadcrumb instead of silently losing spans
        if self.tracer.enabled:
            self.tracer.drop_counter = self.group.counter(
                "trace_spans_dropped_total"
            )
            self.tracer.on_first_drop = lambda: self.flight.record(
                "trace_spans_dropped", capacity=self.tracer.capacity
            )
        if self.profiler is not None:
            self.profiler.flight = self.flight

        # resource plane (obs/resources.py): /proc sampler riding the
        # snapshotter's pre-hook so host/lane series advance at exactly
        # the snapshot cadence; the executor attaches lane PIDs once the
        # ingest plane is up
        self.resources = None
        if getattr(cfg, "resources", False):
            from .resources import ResourceSampler

            self.resources = ResourceSampler(self.group, flight=self.flight)
            self.snapshotter.pre_hooks.append(self.resources.sample)

        # self-monitoring health engine (obs/health.py); rule state
        # gauges land in the job group so they are ordinary series
        rules = getattr(cfg, "health_rules", ()) or ()
        self.health = (
            HealthEngine(
                rules,
                alert_sink=getattr(cfg, "alert_sink", None),
                gauge_group=self.group,
                flight=self.flight,
            )
            if rules
            else None
        )
        self.snapshotter.health_engine = self.health
        # gauge callback errors leave a (once-per-gauge) breadcrumb
        self.registry.flight = self.flight
        # multi-tenant fleet root (tenancy/server.py attaches itself):
        # source of the /tenants.json view and the per-tenant SLO rules
        self.tenancy = None
        # conservation ledger (obs/ledger.py): the executor builds one
        # per attempt and attaches it here — source of the snapshot
        # "ledger" section and the /ledger.json view
        self.ledger = None
        # StateMemoryTracker instances register here (obs/memory.py) so
        # the fleet can read per-tenant keyed-state breakdowns
        self.state_trackers: list = []

        # live scrape endpoint (obs/serve.py): /metrics + /healthz +
        # /snapshot.json on a daemon thread, ephemeral port when 0
        self.server = None
        serve_port = getattr(cfg, "serve_port", None)
        if serve_port is not None and int(serve_port) >= 0:
            from .serve import MetricsServer

            self.server = MetricsServer(
                self,
                port=int(serve_port),
                host=getattr(cfg, "serve_host", "127.0.0.1"),
                flight=self.flight,
            ).start()
            self.flight.record(
                "serve_started",
                host=self.server.host,
                port=self.server.port,
            )
        self._closed = False

    def operator(self, name: str) -> OperatorObs:
        """Mint the operator scope for one runner. Chained stages that
        share a program kind get de-aliased names (``window``,
        ``window_2``, ...) so their series never merge."""
        n = self._op_names.get(name, 0)
        self._op_names[name] = n + 1
        label = name if n == 0 else f"{name}_{n + 1}"
        return OperatorObs(
            self.group.group(operator=label), self.tracer, self.hist_samples
        )

    def counter(self, name: str):
        return self.group.counter(name)

    def gauge(self, name: str):
        return self.group.gauge(name)

    def histogram(self, name: str):
        return self.group.histogram(name, max_samples=self.hist_samples)

    def maybe_snapshot(self):
        return self.snapshotter.maybe_snapshot()

    def env_snapshot(self) -> Optional[dict]:
        """The environment fingerprint dict (the /env.json body), or
        None when collection failed (the serve layer answers 404)."""
        if self.env_fingerprint is None:
            return None
        return self.env_fingerprint.to_dict()

    def env_compact(self) -> Optional[str]:
        """One-token fingerprint for flight breadcrumbs (checkpoint
        events carry this so a restored run can prove where it saved)."""
        if self.env_fingerprint is None:
            return None
        return self.env_fingerprint.compact()

    def snapshot(self, meta: Optional[dict] = None) -> dict:
        m = {"job": self.job_name}
        if self.env_fingerprint is not None:
            m["env"] = self.env_fingerprint.to_dict()
        m.update(meta or {})
        # profile first so its gauges land in this snapshot's series
        prof = self.profiler.profile() if self.profiler is not None else None
        snap = job_snapshot(self.registry, self.tracer, meta=m)
        if prof is not None:
            snap["profile"] = prof
        if self.health is not None:
            snap["health"] = self.health.state()
        if self.ledger is not None:
            snap["ledger"] = self.ledger.state()
        # flight-path tracing extras, so dump --trace can rebuild the
        # unified timeline offline (obs/tracing_export.py)
        if self.tracer.enabled:
            snap["trace_meta"] = {
                "tracer_epoch_s": round(self.tracer.epoch, 6),
                "flight_epoch_s": (
                    round(self.flight._t0, 6)
                    if self.flight.enabled else None
                ),
            }
            if self.flight.enabled:
                snap["flight_events"] = self.flight.events()
            if self.traces.total:
                snap["record_traces"] = self.traces.traces()
                snap["record_traces_total"] = self.traces.total
        return snap

    def trace_timeline(self) -> Optional[dict]:
        """The live unified Chrome-trace timeline (the /trace.json
        body), or None when step tracing is disabled."""
        if not self.tracer.enabled:
            return None
        return timeline_from_parts(
            self.tracer.events(),
            flight_events=self.flight.events() if self.flight.enabled else (),
            record_traces=self.traces.traces(),
            tracer_epoch_s=self.tracer.epoch,
            flight_epoch_s=(
                self.flight._t0 if self.flight.enabled else None
            ),
            meta={"job": self.job_name},
        )

    def to_prometheus_text(self) -> str:
        return self.registry.to_prometheus_text()

    # -- multi-tenancy ------------------------------------------------------

    def ensure_health(self) -> HealthEngine:
        """The job's health engine, created on demand: a fleet that
        declares per-tenant SLOs needs an engine even when the config
        set no static ``health_rules``."""
        if self.health is None:
            self.health = HealthEngine(
                (),
                alert_sink=None,
                gauge_group=self.group,
                flight=self.flight,
            )
            self.snapshotter.health_engine = self.health
        return self.health

    def attach_tenancy(self, server) -> None:
        """Install a JobServer as this job's fleet root: its per-tenant
        refresh runs before every snapshot (so derived series — rates,
        shares, error fractions — are current at exactly the snapshot
        cadence), and ``/tenants.json`` serves its fleet view."""
        self.tenancy = server
        refresh = getattr(server, "refresh_obs", None)
        if refresh is not None:
            self.snapshotter.pre_hooks.append(refresh)
        # the server registers declared TenantSLOs as health rules and
        # seeds its per-tenant instruments against THIS obs root
        hook = getattr(server, "on_obs_attached", None)
        if hook is not None:
            hook(self)

    def tenants_snapshot(self) -> Optional[dict]:
        """Live per-tenant fleet view (the /tenants.json body), or None
        on single-job runs (the serve layer answers 404)."""
        if self.tenancy is None:
            return None
        return self.tenancy.tenants_snapshot()

    def ledger_snapshot(self) -> Optional[dict]:
        """Live conservation-ledger view (the /ledger.json body), or
        None when the ledger is off (the serve layer answers 404)."""
        if self.ledger is None:
            return None
        return self.ledger.state()

    # -- lifecycle ----------------------------------------------------------

    def _default_dump_path(self) -> str:
        import os

        return self.flight_dump_path or os.path.join(
            os.getcwd(), f"tpustream-flight-{os.getpid()}.json"
        )

    def close(self, failed: bool = False, dump: bool = True) -> Optional[dict]:
        """Terminal flush: one final snapshot (with the health engine's
        last word) and — on failure, or whenever a dump path was
        configured — the flight-recorder postmortem JSON. Idempotent, so
        the failure wrapper and a user-level ``finally`` can both call
        it. ``dump=False`` skips the postmortem write (a supervised
        attempt that may restart defers the dump to the supervisor's
        terminal decision)."""
        if self._closed:
            return None
        self._closed = True
        if self.server is not None:
            # stop the scrape endpoint FIRST: the final snapshot below is
            # then the authoritative last word, and no socket outlives
            # the job
            self.server.close()
        snap = self.snapshotter.close()
        dump_path = None
        if self.flight.enabled and dump and (failed or self.flight_dump_path):
            dump_path = self._default_dump_path()
            try:
                self.flight.write(
                    dump_path,
                    meta={"job": self.job_name, "failed": bool(failed)},
                )
            except OSError:
                dump_path = None
        return {"snapshot": snap, "flight_dump_path": dump_path}

    def on_failure(
        self, exc: BaseException, operator: str = "", dump: bool = True
    ) -> None:
        """Record the terminal exception (with the operator that was
        active) and write the postmortem bundle."""
        self.flight.record_exception(exc, operator)
        self.close(failed=True, dump=dump)


class _NullGroup:
    """Disabled twin of MetricGroup: every mint is the null instrument."""

    __slots__ = ()

    def group(self, **labels):
        return self

    def counter(self, name: str):
        return NULL_COUNTER

    def gauge(self, name: str):
        return NULL_GAUGE

    def histogram(self, name: str, max_samples: int = 0):
        return NULL_HISTOGRAM


NULL_GROUP = _NullGroup()


class _NullOperatorObs:
    enabled = False
    name = ""
    tracer = NULL_TRACER
    records_in = NULL_COUNTER
    records_emitted = NULL_COUNTER
    steps = NULL_COUNTER
    dispatch_time_s = NULL_HISTOGRAM
    step_time_s = NULL_HISTOGRAM
    inflight = NULL_GAUGE

    __slots__ = ()

    def shard(self, index):
        return self

    def scoped(self, **labels):
        return NULL_GROUP

    def counter(self, name: str):
        return NULL_COUNTER

    def gauge(self, name: str):
        return NULL_GAUGE

    def histogram(self, name: str):
        return NULL_HISTOGRAM


NULL_OPERATOR_OBS = _NullOperatorObs()


class _NullJobObs:
    enabled = False
    registry = None
    tracer = NULL_TRACER
    traces = NULL_TRACE_LOG
    job_name = ""
    snapshotter = None
    profiler = None
    flight = NULL_FLIGHT
    health = None
    flight_dump_path = ""
    server = None
    tenancy = None
    ledger = None
    resources = None
    env_fingerprint = None

    __slots__ = ()

    def operator(self, name: str):
        return NULL_OPERATOR_OBS

    def env_snapshot(self):
        return None

    def env_compact(self):
        return None

    def ensure_health(self):
        return None

    def attach_tenancy(self, server) -> None:
        pass

    def tenants_snapshot(self):
        return None

    def ledger_snapshot(self):
        return None

    def counter(self, name: str):
        return NULL_COUNTER

    def gauge(self, name: str):
        return NULL_GAUGE

    def histogram(self, name: str):
        return NULL_HISTOGRAM

    def maybe_snapshot(self):
        return None

    def trace_timeline(self):
        return None

    def snapshot(self, meta: Optional[dict] = None) -> dict:
        return {"version": 0, "meta": dict(meta or {}), "metrics": {"series": []}}

    def to_prometheus_text(self) -> str:
        return ""

    def close(self, failed: bool = False, dump: bool = True):
        return None

    def on_failure(
        self, exc: BaseException, operator: str = "", dump: bool = True
    ) -> None:
        pass


NULL_JOB_OBS = _NullJobObs()
