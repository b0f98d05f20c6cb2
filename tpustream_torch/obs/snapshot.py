"""Point-in-time observability snapshots and the periodic snapshotter.

Counterpart of tpustream/obs/snapshot.py (the port's own copy).

A *snapshot* is one JSON-serializable dict bundling the registry's
series, the tracer's retained spans, and both exposition forms' inputs
(the Prometheus text itself is included so a snapshot file is
self-contained for scraping replay or the ``tpustream_torch.obs.dump`` CLI).

:class:`Snapshotter` gives the executor a cheap "is it time yet" check
— one ``perf_counter`` compare per batch — and appends periodic
snapshots to a bounded in-memory list (and optionally a JSONL file).
This module never imports jax.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional

SNAPSHOT_VERSION = 1


def job_snapshot(registry, tracer=None, meta: Optional[dict] = None) -> dict:
    """Bundle ``registry`` (a :class:`~tpustream_torch.obs.registry.MetricsRegistry`)
    and optional ``tracer`` into one serializable dict."""
    snap = {
        "version": SNAPSHOT_VERSION,
        "meta": dict(meta or {}),
        "metrics": registry.snapshot(),
        "prometheus": registry.to_prometheus_text(),
    }
    if tracer is not None:
        snap["trace"] = tracer.snapshot()
    return snap


def write_snapshot(path: str, snap: dict) -> str:
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


class Snapshotter:
    """Periodic snapshot taker driven from the executor's batch loop.

    ``maybe_snapshot()`` is the per-batch hook. Ticks live on an
    **absolute monotonic deadline grid** anchored at construction time
    (deadline *n* is ``t0 + n * interval_s``): a tick fires when the
    clock passes the next un-fired deadline, and a slow tick (or a long
    stall) advances past every missed deadline without shifting the grid
    — cadence never drifts by accumulated lateness, and a stall never
    burst-fires one snapshot per missed interval. How late each tick
    fired is recorded in the ``snapshotter_tick_skew_ms`` histogram (and
    ``meta["tick_skew_ms"]``). Retains at most ``max_snapshots`` (oldest
    dropped); when ``jsonl_path`` is set every snapshot is also appended
    there, one JSON object per line, so long jobs keep a full on-disk
    time series regardless of the in-memory bound.
    """

    def __init__(
        self,
        registry,
        tracer=None,
        interval_s: float = 0.0,
        max_snapshots: int = 64,
        jsonl_path: Optional[str] = None,
        meta: Optional[dict] = None,
        clock=None,
    ):
        self.registry = registry
        self.tracer = tracer
        self.interval_s = float(interval_s)
        self.max_snapshots = max(1, int(max_snapshots))
        self.jsonl_path = jsonl_path
        self.meta = dict(meta or {})
        self.snapshots: List[dict] = []
        self._clock = clock or time.perf_counter
        self._t0 = self._clock()
        self._n = 0  # index of the last fired deadline on the grid
        self._skew_hist = None
        # optional PipelineProfiler: when set, every take() embeds its
        # windowed stage attribution as snap["profile"]
        self.profiler = None
        # optional HealthEngine: evaluated at every take(), so alert
        # rules tick exactly as often as snapshots (the design point:
        # self-monitoring shares the snapshot cadence, no extra timers)
        self.health_engine = None
        # callables run at the START of every take(), before the
        # registry is read: push-style refreshers (the JobServer's
        # per-tenant admission/emit/share gauges) use this to make
        # derived series current at exactly the snapshot cadence
        # without paying on the batch path. Exceptions are swallowed —
        # a broken refresher must never abort a snapshot.
        self.pre_hooks: List = []
        # optional ConservationLedger: refresh() rides pre_hooks (so
        # residual gauges are current in this snapshot's series) and
        # every take() embeds the edge/anchor table as snap["ledger"]
        self.ledger = None
        self.closed = False

    @property
    def enabled(self) -> bool:
        return self.interval_s > 0.0

    def maybe_snapshot(self) -> Optional[dict]:
        if not self.enabled:
            return None
        now = self._clock()
        deadline = self._t0 + (self._n + 1) * self.interval_s
        if now < deadline:
            return None
        skew_ms = (now - deadline) * 1000.0
        self._n = int((now - self._t0) / self.interval_s)
        self._record_skew(skew_ms)
        return self.take(at_s=now - self._t0, skew_ms=skew_ms)

    def _record_skew(self, skew_ms: float) -> None:
        if self._skew_hist is None:
            labels = {}
            if "job" in self.meta:
                labels["job"] = self.meta["job"]
            try:
                self._skew_hist = self.registry.group(**labels).histogram(
                    "snapshotter_tick_skew_ms"
                )
            except Exception:
                return
        self._skew_hist.observe(skew_ms)

    def take(self, at_s: Optional[float] = None,
             skew_ms: Optional[float] = None) -> dict:
        meta = dict(self.meta)
        if at_s is None:
            at_s = self._clock() - self._t0
        meta["at_s"] = round(at_s, 6)
        if skew_ms is not None:
            meta["tick_skew_ms"] = round(skew_ms, 3)
        for hook in self.pre_hooks:
            try:
                hook()
            except Exception:
                pass
        # profile BEFORE the registry snapshot: profile() pushes the
        # binding/occupancy/share gauges, and this snapshot's series
        # should match its embedded profile section
        prof = self.profiler.profile() if self.profiler is not None else None
        snap = job_snapshot(self.registry, self.tracer, meta=meta)
        if prof is not None:
            snap["profile"] = prof
        if self.health_engine is not None:
            # evaluate AFTER the registry snapshot so rules see exactly
            # the series this snapshot carries
            snap["health"] = self.health_engine.evaluate(
                snap["metrics"].get("series", []), now_s=at_s
            )
        if self.ledger is not None:
            snap["ledger"] = self.ledger.state()
        self.snapshots.append(snap)
        if len(self.snapshots) > self.max_snapshots:
            del self.snapshots[0 : len(self.snapshots) - self.max_snapshots]
        if self.jsonl_path:
            try:
                with open(self.jsonl_path, "a") as f:
                    f.write(json.dumps(snap, sort_keys=True) + "\n")
            except OSError:
                pass
        return snap

    def close(self) -> Optional[dict]:
        """Final flush at job end (success OR failure): take one last
        snapshot so the JSONL tail always reflects the terminal state —
        a run whose last interval never elapsed would otherwise lose its
        final counters, and a health engine its final evaluation.
        Idempotent; returns the terminal snapshot (or None when there is
        nothing to flush)."""
        if self.closed:
            return self.snapshots[-1] if self.snapshots else None
        self.closed = True
        if not (self.enabled or self.jsonl_path
                or self.health_engine is not None):
            return None
        return self.take()
