"""Per-job metrics: batches, records, and where each batch's time went.

A plain counterpart of tpustream/runtime/metrics.py without its metrics
registry. Every time is a host-clock interval; the step interval ends in
a device synchronise, so it covers the device's work for the batch.
``window_fires``, ``late_dropped``, ``cep_matches``, ``cep_timeouts``
and the loss counters accumulate on the device and are folded in once
per job (``Runner.finalize_metrics``); a full-window ``process()`` job
counts its fires on the host. The summary carries every key of the
reference's; the counters that have no source in this runtime yet
(quarantine, the sharded exchange) read 0.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


@dataclass
class Metrics:
    batches: int = 0           # source batches pulled
    records_in: int = 0        # records fed to the device program
    records_emitted: int = 0   # records handed to the sinks
    steps: int = 0             # device steps run
    d2h_syncs: int = 0         # waits on a device-to-host copy
    d2h_bytes: int = 0         # bytes the executor copied device -> host
    window_fires: int = 0      # (key, window) results fired
    late_dropped: int = 0      # records behind the watermark, dropped
    records_quarantined: int = 0  # poison lines diverted (no source yet)
    alert_overflow: int = 0    # fired rows past alert_capacity, lost
    exchange_overflow: int = 0  # rows lost in a sharded exchange (no source yet)
    buffer_overflow: int = 0   # window elements past process_buffer_capacity
    evicted_unfired: int = 0   # records cleared from the ring unfired
    cep_matches: int = 0       # CEP pattern matches
    cep_timeouts: int = 0      # CEP partial matches expired (within)
    build_time_s: float = 0.0  # set-up: plan, host stage, program, state
    native_parses: int = 0     # parse-plan evaluations by the native parser
    numpy_parses: int = 0      # ... and by the numpy path
    host_times_s: List[float] = field(default_factory=list)   # parse
    upload_times_s: List[float] = field(default_factory=list)  # host -> device
    step_times_s: List[float] = field(default_factory=list)    # step + sync
    fetch_times_s: List[float] = field(default_factory=list)   # device -> host
    emit_times_s: List[float] = field(default_factory=list)    # format + sinks
    # batch arrival (parse start) to the dispatch of its emissions, one
    # sample a step that emitted at least one record
    emit_latencies_s: List[float] = field(default_factory=list)

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


class Stopwatch:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False
