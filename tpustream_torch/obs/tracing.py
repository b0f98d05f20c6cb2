"""Structured step tracing: lightweight span events per executor step.

Counterpart of tpustream/obs/tracing.py; the profiler bridge is
``torch.profiler.record_function``.

Each hot-path phase records one span per *batch/step* — never per
record — into a bounded ring buffer. The port's executor records
``parse``, ``h2d`` (a step's columns staged and copied to the device),
``dispatch``, ``fetch`` and ``emit``; ``pack`` and ``lane_parse`` stay
in ``SPAN_KINDS`` for the JAX package's packed uploads and ingest
lanes.

The bridge wraps each span in ``torch.profiler.record_function`` so a
``torch.profiler.profile(...)`` capture shows the host spans (named
``tpustream.<kind>``) beside the CUDA kernels they issued. It is opt-in
(``ObsConfig.profiler_bridge``) because annotations add a little
per-span overhead even when no trace is active. A span never waits on
the device: ``dispatch`` times the host's issue of a step, and device
time is the profiler's business.

``NULL_TRACER`` is the disabled twin: same surface, no state, no work.
"""

from __future__ import annotations

import time
from typing import List, Optional

# "lane_parse" is the ingest-lane worker's parse span (runtime/ingest.py
# re-records it at the merge point with the worker-measured duration) —
# appended LAST so the profiler's binding-stage gauge keeps its
# historical index values for the original six stages.
SPAN_KINDS = ("parse", "pack", "h2d", "dispatch", "fetch", "emit",
              "lane_parse")


class _Span:
    """Context manager handed out by :meth:`StepTracer.span`."""

    __slots__ = ("_tracer", "kind", "step", "operator", "_t0", "_ann")

    def __init__(self, tracer: "StepTracer", kind: str, step: int, operator: str):
        self._tracer = tracer
        self.kind = kind
        self.step = step
        self.operator = operator
        self._t0 = 0.0
        self._ann = None

    def __enter__(self) -> "_Span":
        if self._tracer._annotate is not None:
            self._ann = self._tracer._annotate(f"tpustream.{self.kind}")
            self._ann.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        self._tracer._record(self.kind, self.step, self.operator, self._t0, t1 - self._t0)


class StepTracer:
    """Bounded ring buffer of ``(kind, step, operator, t_start, dur_s)``
    span events.

    ``capacity`` bounds memory for arbitrarily long jobs; the ring keeps
    the most recent ``capacity`` spans while ``total_spans`` counts every
    span ever recorded (so a snapshot reveals truncation).
    """

    enabled = True

    def __init__(self, capacity: int = 4096, profiler_bridge: bool = False):
        self.capacity = max(1, int(capacity))
        self._ring: List[tuple] = []
        self._pos = 0
        self.total_spans = 0
        self._epoch = time.perf_counter()
        # span-drop accounting, wired by JobObs post-construction: a
        # Counter incremented per overwritten span, and a one-shot
        # callable fired on the FIRST drop (flight breadcrumb) so ring
        # overflow is never silent.
        self.drop_counter = None
        self.on_first_drop = None
        self._annotate = None
        if profiler_bridge:
            try:
                from torch.profiler import record_function

                self._annotate = record_function
            except Exception:
                self._annotate = None

    def span(self, kind: str, step: int = -1, operator: str = "") -> _Span:
        return _Span(self, kind, step, operator)

    def _record(self, kind: str, step: int, operator: str, t0: float, dur: float) -> None:
        ev = (kind, step, operator, t0 - self._epoch, dur)
        if len(self._ring) >= self.capacity:
            self._ring[self._pos] = ev
            self._pos = (self._pos + 1) % self.capacity
            if self.drop_counter is not None:
                self.drop_counter.inc()
            if self.on_first_drop is not None:
                hook, self.on_first_drop = self.on_first_drop, None
                try:
                    hook()
                except Exception:
                    pass
        else:
            self._ring.append(ev)
        self.total_spans += 1

    def raw_tail(self, n: int) -> List[tuple]:
        """The newest ``n`` retained raw span tuples
        ``(kind, step, operator, t_start_rel_s, dur_s)``, oldest first.
        The continuous profiler's incremental drain — no dict formatting
        on the consume path. ``t_start_rel_s`` is relative to
        :attr:`epoch` (registry-clock seconds at tracer construction)."""
        ordered = self._ring[self._pos:] + self._ring[: self._pos]
        if n < len(ordered):
            return ordered[len(ordered) - n:]
        return ordered

    @property
    def epoch(self) -> float:
        return self._epoch

    def events(self) -> List[dict]:
        """Spans in arrival order, oldest retained first."""
        ordered = self._ring[self._pos :] + self._ring[: self._pos]
        return [
            {
                "kind": k,
                "step": s,
                "operator": op,
                "t_start_s": round(t0, 6),
                "dur_s": round(d, 6),
            }
            for (k, s, op, t0, d) in ordered
        ]

    def snapshot(self) -> dict:
        return {
            "capacity": self.capacity,
            "total_spans": self.total_spans,
            "dropped_spans": max(0, self.total_spans - len(self._ring)),
            "events": self.events(),
        }


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_NULL_SPAN = _NullSpan()


class _NullTracer:
    """Disabled twin: ``span()`` hands back one shared no-op context
    manager, so tracing-off costs one method call per span site per
    step."""

    enabled = False
    capacity = 0
    total_spans = 0
    epoch = 0.0

    __slots__ = ()

    def span(self, kind: str, step: int = -1, operator: str = "") -> _NullSpan:
        return _NULL_SPAN

    def raw_tail(self, n: int) -> list:
        return []

    def events(self) -> list:
        return []

    def snapshot(self) -> dict:
        return {"capacity": 0, "total_spans": 0, "dropped_spans": 0, "events": []}


NULL_TRACER = _NullTracer()
