"""Per-job metrics: batches, records, and where each batch's time went.

Counterpart of tpustream/runtime/metrics.py. Every time is a host-clock
interval. A step's time is its host issue plus its share of the wait for
its fetch group's count scalars: at ``async_depth=1`` that wait covers
the device's work for the batch; with steps in flight it is what the
host still waited, as in the reference. ``window_fires``,
``late_dropped``, ``cep_matches``, ``cep_timeouts`` and the loss
counters accumulate on the device and are folded in once per job
(``Runner.finalize_metrics``); a full-window ``process()`` job counts
its fires on the host. The summary carries every key of the
reference's; the sharded exchange's counter has no source in this
runtime yet and reads 0.

``Metrics`` is a facade over :class:`tpustream_torch.obs.registry
.MetricsRegistry`, as the reference's is: every counter the reference
keeps is a property backed by a job-scope registry Counter (``metrics
.records_in += n`` behaves as a plain int does), and the step, host and
emit-latency sample lists mirror each appended sample into a job-scope
Histogram. The port's own fields (``steps``, ``d2h_syncs``,
``d2h_bytes``, ``h2d_bytes``, ``compaction_spills``, the parse-path
counts, the upload/fetch/emit stage
lists, ``build_time_s``, the checkpoint captures and write reports) stay plain attributes, so an obs-enabled job
exposes the reference's series and no others. Callers that want
per-operator series, spans or exposition go through ``metrics.job_obs``
(a :class:`tpustream_torch.obs.runtime.JobObs`, the null twin unless
the job ran with ``StreamConfig.obs.enabled``) or ``metrics.registry``.
"""

from __future__ import annotations

import time
from typing import List, Optional

from ..obs.registry import MetricsRegistry
from ..obs.runtime import NULL_JOB_OBS
from ..obs.snapshot import job_snapshot


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


class _Samples(list):
    """A plain float list (callers slice it, sort it, feed it to numpy)
    that also mirrors every appended sample into a registry Histogram."""

    __slots__ = ("_hist",)

    def __init__(self, hist):
        super().__init__()
        self._hist = hist

    def append(self, v) -> None:
        list.append(self, v)
        self._hist.observe(v)

    def extend(self, vs) -> None:
        vs = list(vs)
        list.extend(self, vs)
        self._hist.observe_many(vs)


class Metrics:
    """Flat per-job counters and stage samples, backed by a metrics
    registry."""

    _COUNTER_FIELDS = (
        "batches",          # source batches pulled
        "records_in",       # records fed to the device program
        "records_emitted",  # records handed to the sinks
        "window_fires",     # (key, window) results fired
        "late_dropped",     # records behind the watermark, dropped
        "records_quarantined",  # poison lines diverted (dead_letter)
        "alert_overflow",   # fired rows past alert_capacity, lost
        "exchange_overflow",  # rows lost in a sharded exchange (no source yet)
        "buffer_overflow",  # window elements past process_buffer_capacity
        "evicted_unfired",  # records cleared from the ring unfired
        "cep_matches",      # CEP pattern matches
        "cep_timeouts",     # CEP partial matches expired (within)
    )

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 job_name: str = "job", build_time_s: float = 0.0):
        self.registry = registry if registry is not None else MetricsRegistry()
        group = self.registry.group(job=job_name)
        self._counters = {n: group.counter(n) for n in self._COUNTER_FIELDS}
        # a step's host issue plus its share of its fetch group's wait
        # for the count scalars (the whole wait at async_depth 1)
        self.step_times_s = _Samples(group.histogram("step_time_s"))
        self.host_times_s = _Samples(group.histogram("host_time_s"))  # parse
        # batch arrival (parse start) to the dispatch of its emissions,
        # one sample a step that emitted at least one record
        self.emit_latencies_s = _Samples(group.histogram("emit_latency_s"))
        self.upload_times_s: List[float] = []  # wire packing on the host
        self.fetch_times_s: List[float] = []   # device -> host
        self.emit_times_s: List[float] = []    # format + sinks
        self.steps = 0          # device steps run
        self.d2h_syncs = 0      # waits on a device-to-host copy
        self.d2h_bytes = 0      # bytes the executor copied device -> host
        self.h2d_bytes = 0      # wire bytes the executor staged host -> device
        self.compaction_spills = 0  # compacted fetches past the capacity
        self.build_time_s = build_time_s  # set-up: plan, host stage, program, state
        self.native_parses = 0  # parse-plan evaluations by the native parser
        self.numpy_parses = 0   # ... and by the numpy path
        # checkpoints: each barrier's capture (ms) and each completed
        # write's report (runtime/checkpoint.py write_snapshot)
        self.checkpoint_capture_ms: List[float] = []
        self.checkpoint_reports: List[dict] = []
        # replaced with a live JobObs by execute_job when
        # StreamConfig.obs.enabled; every Runner hot-path obs call routes
        # through it (or its no-op null twin)
        self.job_obs = NULL_JOB_OBS

    def overflow_counts(self) -> dict:
        """The loss counters a strict job must keep at zero."""
        return {
            "alert_overflow": self.alert_overflow,
            "exchange_overflow": self.exchange_overflow,
            "buffer_overflow": self.buffer_overflow,
            "evicted_unfired": self.evicted_unfired,
        }

    def summary(self) -> dict:
        step = sum(self.step_times_s)
        lat = sorted(self.emit_latencies_s)
        return {
            "batches": self.batches,
            "records_in": self.records_in,
            "records_emitted": self.records_emitted,
            "steps": self.steps,
            "d2h_syncs": self.d2h_syncs,
            "d2h_bytes": self.d2h_bytes,
            "window_fires": self.window_fires,
            "late_dropped": self.late_dropped,
            "records_quarantined": self.records_quarantined,
            "alert_overflow": self.alert_overflow,
            "exchange_overflow": self.exchange_overflow,
            "buffer_overflow": self.buffer_overflow,
            "evicted_unfired": self.evicted_unfired,
            "cep_matches": self.cep_matches,
            "cep_timeouts": self.cep_timeouts,
            "build_time_s": self.build_time_s,
            "native_parses": self.native_parses,
            "numpy_parses": self.numpy_parses,
            "host_time_s": sum(self.host_times_s),
            "upload_time_s": sum(self.upload_times_s),
            "device_time_s": step,
            "fetch_time_s": sum(self.fetch_times_s),
            "emit_time_s": sum(self.emit_times_s),
            "events_per_sec_device": (
                self.records_in / step if step > 0 else None
            ),
            "emit_latency_p50_ms": _percentile(lat, 0.50) * 1000.0,
            "emit_latency_p99_ms": _percentile(lat, 0.99) * 1000.0,
        }

    def obs_snapshot(self, meta: Optional[dict] = None) -> dict:
        """Full observability snapshot (all registry series + trace ring
        when the job ran with obs enabled; the job-scope series this
        facade maintains otherwise)."""
        if self.job_obs.enabled:
            return self.job_obs.snapshot(meta)
        return job_snapshot(self.registry, None, meta=meta)

    def to_prometheus_text(self) -> str:
        return self.registry.to_prometheus_text()


def _counter_property(name: str) -> property:
    def fget(self):
        return self._counters[name].value

    def fset(self, v):
        self._counters[name].set_total(v)

    return property(fget, fset)


for _name in Metrics._COUNTER_FIELDS:
    setattr(Metrics, _name, _counter_property(_name))
del _name


class Stopwatch:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
