"""Declarative pattern surface — FlinkCEP's ``Pattern`` builder.

Mirrors the FlinkCEP API (rooted in the SASE+ NFA model of Agrawal et
al., "Efficient Pattern Matching over Event Streams", SIGMOD 2008):

    Pattern.begin("first").where(lambda r: r.f2 > 90) \\
           .next("second").where(lambda r: r.f2 > 90) \\
           .within(Time.seconds(60))

camelCase aliases (``followedBy``, ``oneOrMore``-style Java surface) are
provided so chapter-style jobs read like the Flink original.

Contiguity semantics per stage edge:

* ``next(name)``        — strict: the stage must match the IMMEDIATELY
  following event of the key; a non-matching event kills the partial.
* ``followed_by(name)`` — relaxed: non-matching events are skipped, the
  partial survives until it matches or times out.

``times(n)`` repeats the current stage n times (relaxed between
repetitions, Flink's default); chain ``.consecutive()`` to require the
repetitions to be contiguous. ``within(t)`` bounds the whole sequence:
first-to-last event time must be strictly less than the duration, and
partial matches whose window expires (watermark passes start + within)
are pruned — optionally to a timeout side output.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Union

from ..api.functions import as_callable
from ..api.timeapi import Time
from ..api.tuples import TupleBase, make_tuple


class _Stage:
    __slots__ = ("name", "conds", "times", "strict_entry", "strict_internal")

    def __init__(self, name: str, strict_entry: bool):
        self.name = name
        self.conds: List[Any] = []
        self.times = 1
        self.strict_entry = strict_entry
        # contiguity BETWEEN repetitions of this stage (times > 1):
        # Flink's times() is relaxed unless .consecutive() is chained
        self.strict_internal = False


class Pattern:
    """A linear event-sequence pattern over one keyed stream.

    Built by chaining; each call mutates and returns the same builder
    (compile the pattern once per job — reuse across jobs by rebuilding).
    """

    def __init__(self) -> None:
        self._stages: List[_Stage] = []
        self._within_ms: Optional[int] = None

    # -- construction -------------------------------------------------------
    @staticmethod
    def begin(name: str) -> "Pattern":
        p = Pattern()
        p._stages.append(_Stage(name, strict_entry=False))
        return p

    def next(self, name: str) -> "Pattern":
        """Append a stage with STRICT contiguity (Flink's ``next``)."""
        self._stages.append(_Stage(name, strict_entry=True))
        return self

    def followed_by(self, name: str) -> "Pattern":
        """Append a stage with RELAXED contiguity (``followedBy``)."""
        self._stages.append(_Stage(name, strict_entry=False))
        return self

    followedBy = followed_by

    def where(self, cond) -> "Pattern":
        """AND a condition onto the current stage. Accepts a callable
        over the record or an object with ``.filter(record)`` (Flink's
        SimpleCondition); conditions run as torch ops over whole
        columns, like ``filter`` functions."""
        if not self._stages:
            raise ValueError("where() requires a stage: call begin() first")
        self._stages[-1].conds.append(cond)
        return self

    def times(self, n: int) -> "Pattern":
        """The current stage must match exactly ``n`` events."""
        if n < 1:
            raise ValueError(f"times({n}): repetition count must be >= 1")
        self._stages[-1].times = int(n)
        return self

    def consecutive(self) -> "Pattern":
        """Require the repetitions of the current ``times(n)`` stage to
        be contiguous events of the key (Flink's ``consecutive()``)."""
        self._stages[-1].strict_internal = True
        return self

    def within(self, t: Union[Time, int]) -> "Pattern":
        """Bound first-to-last event time of a match; expired partials
        prune on watermark advance (timeout side output)."""
        ms = t.to_milliseconds() if isinstance(t, Time) else int(t)
        if ms <= 0:
            raise ValueError(f"within({ms}ms): duration must be positive")
        self._within_ms = ms
        return self

    # -- introspection (used by the compiler) -------------------------------
    @property
    def stages(self) -> List[_Stage]:
        return self._stages

    @property
    def within_ms(self) -> Optional[int]:
        return self._within_ms

    def __repr__(self) -> str:
        parts = []
        for i, s in enumerate(self._stages):
            head = "begin" if i == 0 else ("next" if s.strict_entry else "followed_by")
            t = f".times({s.times})" if s.times > 1 else ""
            c = ".consecutive()" if s.strict_internal else ""
            parts.append(f"{head}({s.name!r}){t}{c}")
        w = f".within({self._within_ms}ms)" if self._within_ms else ""
        return "Pattern." + ".".join(parts) + w


class PatternSelectFunction:
    """Flink-style SAM base: override ``select(match)`` where ``match``
    is ``{stage_name: [event, ...]}`` in sequence order. Runs on device
    (torch ops over whole columns), like a ``map`` function."""

    def select(self, match: dict):
        raise NotImplementedError


def make_select_adapter(compiled, select_fn) -> Callable:
    """Lower a PatternSelectFunction into a device ``map`` over the flat
    match record: the NFA program emits matches as L*C columns
    (event-major), the adapter reassembles Flink's
    ``{stage_name: [events]}`` view at trace time and applies the user
    function."""
    fn = as_callable(select_fn, "select")
    L = compiled.length
    stage_of = list(compiled.stage_of)
    names = compiled.stage_names

    def adapter(rec):
        vals = list(rec) if isinstance(rec, (TupleBase, tuple)) else [rec]
        c = len(vals) // L
        match: dict = {}
        for e in range(L):
            ev_vals = vals[e * c:(e + 1) * c]
            ev = ev_vals[0] if c == 1 else make_tuple(*ev_vals)
            match.setdefault(names[stage_of[e]], []).append(ev)
        return fn(match)

    return adapter
