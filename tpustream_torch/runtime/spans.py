"""Host-clock spans of the port's stages, one recorder a job.

``Metrics.spans`` is the job's :class:`SpanRecorder`. One span, one pair
of clock reads, three records:

- its duration, appended to ``times_s[name]`` (the count of spans is
  the list's length, so a reader takes window deltas of both);
- its interval in the obs ring (``StepTracer``), when the caller hands
  its obs scope and the job traces; only the stage spans do, under the
  ring's own kinds (``parse``, ``pack``, ``h2d``, ``dispatch``,
  ``fetch``, ``emit``);
- a ``torch.profiler.record_function`` range named
  ``tpustream.<name>``, while a profiler capture records on this thread
  (the profiler's own enabled flag, tested once a span).

Stage spans: ``parse``, ``pack``, ``h2d``, ``dispatch``, ``fetch``,
``emit``. Sub-spans: ``step.merge`` (the window merge's host issue),
``step.fold`` (one window end's fold), ``step.read`` (a small
device-to-host read inside a step), ``step.advance`` (a CEP step's
arrival-rank rounds), ``step.timeout`` (a CEP step's ``within`` scan),
``emit.format`` (columns to Python rows), ``emit.sink`` (post ops and
sinks), ``parse.native`` (the native parser), ``parse.intern`` (the
string tables' sync and remap), ``build.program`` and ``build.state``.
Counters: ``fires`` (window ends folded, host side), ``rounds`` (a CEP
step's rounds, summed).

A span is taken once a step, a fire or a batch, never once a record,
and it never waits on the device. Code with no job (a program called
directly, a lane worker's parser) holds ``NULL_SPANS``, which records
nothing. This module imports nothing of torch until a recorder is made.
"""

from __future__ import annotations

import time
from collections import defaultdict

PREFIX = "tpustream."
_now = time.perf_counter


class _Span:
    """Context manager handed out by :meth:`SpanRecorder.span`; ``t0``
    and ``elapsed`` (host seconds) are readable after it exits."""

    __slots__ = ("_rec", "name", "_obs", "_step", "_range", "t0", "elapsed")

    def __init__(self, rec: "SpanRecorder", name: str, obs, step: int):
        self._rec = rec
        self.name = name
        self._obs = obs
        self._step = step
        self._range = None

    def __enter__(self) -> "_Span":
        rec = self._rec
        if rec._profiling():
            self._range = rec._record_function(PREFIX + self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.elapsed = dur = time.perf_counter() - self.t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._rec.times_s[self.name].append(dur)
        obs = self._obs
        if obs is not None and obs.tracer.enabled:
            obs.tracer._record(self.name, self._step,
                               getattr(obs, "name", ""), self.t0, dur)
        return False


class _Phase:
    """A span timed in pieces and recorded once (:meth:`SpanRecorder
    .phase`): each ``with`` adds its interval, under a profiler range of
    its own if a capture was recording when the phase was made;
    :meth:`close` records the sum. An entry costs two clock reads."""

    __slots__ = ("_rec", "name", "_ranges", "_range", "_t0", "elapsed")

    def __init__(self, rec: "SpanRecorder", name: str):
        self._rec = rec
        self.name = name
        self._ranges = rec._profiling()
        self._range = None
        self.elapsed = 0.0

    def __enter__(self) -> "_Phase":
        if self._ranges:
            self._range = self._rec._record_function(PREFIX + self.name)
            self._range.__enter__()
        self._t0 = _now()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.elapsed += _now() - self._t0
        if self._range is not None:
            self._range.__exit__(et, ev, tb)
            self._range = None
        return False

    def close(self) -> None:
        self._rec.times_s[self.name].append(self.elapsed)


class SpanRecorder:
    """A job's spans (``times_s``: name -> host seconds, one entry a
    span) and host counters (``counts``: name -> int)."""

    def __init__(self):
        from torch.autograd import _profiler_enabled
        from torch.profiler import record_function

        self._profiling = _profiler_enabled
        self._record_function = record_function
        self.times_s = defaultdict(list)
        self.counts = defaultdict(int)

    def span(self, name: str, obs=None, step: int = -1) -> _Span:
        """A span of ``name``. ``obs``: the caller's obs scope (an
        ``OperatorObs``, a ``JobObs`` or a null twin), whose ring takes
        the interval under ``name`` and ``step``; None for a sub-span."""
        return _Span(self, name, obs, step)

    def phase(self, name: str) -> _Phase:
        """A span of ``name`` timed in pieces, for work interleaved with
        other work (a step's rows formatted and sunk a chunk at a
        time): one entry in ``times_s`` when closed."""
        return _Phase(self, name)

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] += n


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _NullSpans:
    """Disabled twin: same surface, no state, no clock read."""

    times_s: dict = {}
    counts: dict = {}

    __slots__ = ()

    def span(self, name: str, obs=None, step: int = -1) -> _NullSpan:
        return _NULL_SPAN

    def phase(self, name: str) -> _NullSpan:
        return _NULL_SPAN

    def count(self, name: str, n: int = 1) -> None:
        pass


NULL_SPANS = _NullSpans()
