"""TenantPlan: the shared job template of a multi-tenant fleet.

Counterpart of tpustream/tenancy/plan.py (which imports no JAX; this is
the port's own copy, on its own ``broadcast/rules.py``).

One built program can serve many logical jobs only when those jobs
share an operator-chain SHAPE — same op sequence, same key positions,
same window specs. What may differ per tenant is every parameter that
dynamic rules already moved out of the program and into the rule
tensors: thresholds, factors, predicate constants. A :class:`TenantPlan`
pins the template (parse fn + build fn + RuleSet) and can verify that a
tenant-submitted build fn has the identical shape before the JobServer
admits it, so a mismatched job is rejected at submission time instead
of corrupting the fleet's shared state.

Shape capture runs the build fn against a recording probe that mimics
the DataStream surface but executes nothing — the resulting op
signature is a plain tuple, comparable across builds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple

from ..broadcast.rules import RuleSet


class TenantShapeError(ValueError):
    """A tenant's job does not share the fleet template's chain shape."""


def _window_tag(spec):
    """A comparable tag for a window spec (WindowSpec is a frozen
    dataclass — it compares by value already)."""
    from ..api.windows import WindowSpec

    return spec if isinstance(spec, WindowSpec) else repr(spec)


class _Probe:
    """Records the op sequence a build fn would install on a stream."""

    def __init__(self, sig: list):
        self._sig = sig

    # stateless transforms: shape = op kind (the fn itself is the
    # per-tenant-parameterizable part, so it is NOT in the signature)
    def map(self, fn) -> "_Probe":
        self._sig.append(("map",))
        return self

    def filter(self, fn) -> "_Probe":
        self._sig.append(("filter",))
        return self

    def flat_map(self, fn) -> "_Probe":
        self._sig.append(("flat_map",))
        return self

    flatMap = flat_map

    def assign_timestamps_and_watermarks(self, assigner) -> "_Probe":
        self._sig.append(("assign_ts",))
        return self

    assignTimestampsAndWatermarks = assign_timestamps_and_watermarks

    def key_by(self, key) -> "_KeyedProbe":
        self._sig.append(
            ("key_by", key if isinstance(key, int) else "<computed>")
        )
        return _KeyedProbe(self._sig)

    keyBy = key_by


class _KeyedProbe(_Probe):
    def _rolling(self, kind: str, pos: int) -> _Probe:
        self._sig.append(("rolling", kind, pos))
        return _Probe(self._sig)

    def max(self, pos: int) -> _Probe:
        return self._rolling("max", pos)

    def min(self, pos: int) -> _Probe:
        return self._rolling("min", pos)

    def sum(self, pos: int) -> _Probe:
        return self._rolling("sum", pos)

    def max_by(self, pos: int) -> _Probe:
        return self._rolling("max_by", pos)

    def min_by(self, pos: int) -> _Probe:
        return self._rolling("min_by", pos)

    maxBy = max_by
    minBy = min_by

    def reduce(self, fn) -> _Probe:
        self._sig.append(("rolling_reduce",))
        return _Probe(self._sig)

    def time_window(self, size, slide=None) -> "_WindowProbe":
        self._sig.append((
            "time_window",
            size.to_milliseconds(),
            slide.to_milliseconds() if slide is not None else None,
        ))
        return _WindowProbe(self._sig)

    timeWindow = time_window

    def count_window(self, count: int, slide=None) -> "_WindowProbe":
        self._sig.append(("count_window", count, slide))
        return _WindowProbe(self._sig)

    countWindow = count_window

    def window(self, spec) -> "_WindowProbe":
        self._sig.append(("window", _window_tag(spec)))
        return _WindowProbe(self._sig)


class _WindowProbe:
    def __init__(self, sig: list):
        self._sig = sig

    def allowed_lateness(self, t) -> "_WindowProbe":
        self._sig.append(("allowed_lateness", t.to_milliseconds()))
        return self

    allowedLateness = allowed_lateness

    def side_output_late_data(self, tag) -> "_WindowProbe":
        self._sig.append(("late_tag",))
        return self

    sideOutputLateData = side_output_late_data

    def _apply(self, kind: str, *extra) -> _Probe:
        self._sig.append((f"window_{kind}",) + extra)
        return _Probe(self._sig)

    def reduce(self, fn) -> _Probe:
        return self._apply("reduce")

    def aggregate(self, fn) -> _Probe:
        return self._apply("aggregate")

    def process(self, fn) -> _Probe:
        return self._apply("process")

    def sum(self, pos: int) -> _Probe:
        return self._apply("reduce", ("sum", pos))

    def max(self, pos: int) -> _Probe:
        return self._apply("reduce", ("max", pos))

    def min(self, pos: int) -> _Probe:
        return self._apply("reduce", ("min", pos))


@dataclass
class TenantQuota:
    """Per-tenant admission limit: records past ``max_records`` divert
    to the tenant's ``quota_exceeded`` side output (JobServer
    .quota_output) instead of entering the shared stream — one noisy
    tenant cannot starve the fleet's batch budget."""

    max_records: Optional[int] = None

    def admits(self, admitted_so_far: int) -> bool:
        return self.max_records is None or admitted_so_far < self.max_records


@dataclass
class TenantPlan:
    """The fleet's shared job template.

    ``parse``: str -> record (the per-line host parse every tenant
    shares). ``build``: (stream, rules) -> stream, the operator chain;
    per-tenant variation lives in RuleParams, never in chain shape.
    ``key_field``: index of the STR key field in the PARSED record that
    tenant namespacing folds the tenant id into; inferred from the
    first positional key_by when omitted. ``tenant_capacity``: initial
    [T] rule-vector size (grows by doubling at runtime, cause-tagged).
    """

    parse: Callable[[str], Any]
    build: Callable[[Any, RuleSet], Any]
    rules: RuleSet
    key_field: Optional[int] = None
    tenant_capacity: int = 64
    _signature: Optional[Tuple] = field(default=None, repr=False)

    def signature(self) -> Tuple:
        """The template's op-shape signature (cached)."""
        if self._signature is None:
            self._signature = self._capture(self.build)
        return self._signature

    def _capture(self, build_fn) -> Tuple:
        sig: list = []
        build_fn(_Probe(sig), self.rules)
        return tuple(sig)

    def verify(self, build_fn) -> None:
        """Raise :class:`TenantShapeError` unless ``build_fn`` records
        the exact op signature of the template."""
        theirs = self._capture(build_fn)
        if theirs != self.signature():
            raise TenantShapeError(
                "tenant job shape does not match the fleet template:\n"
                f"  template: {self.signature()}\n"
                f"  submitted: {theirs}\n"
                "a fleet shares ONE built program; only rule "
                "parameters may differ per tenant"
            )

    def validate_fleet_ops(self) -> None:
        """Reject template shapes the fleet wrapper cannot thread the
        tenant field through — at ADMISSION time, not three layers deep
        at run time. Under a JobServer the stream starts raw and
        ``flat_map`` lowers onto the raw host stage
        (tenancy/server.py's ``_TenantStream``), so it is only legal
        before the first parsed-record op."""
        parsed = False
        for op in self.signature():
            if op[0] != "flat_map":
                parsed = True
            elif parsed:
                raise TenantShapeError(
                    "the template calls flat_map after a parsed-record "
                    "op; a fleet lowers flat_map onto the raw host "
                    "stage, so it must precede every other op "
                    "(docs/multitenancy.md)"
                )

    def inferred_key_field(self) -> Optional[int]:
        """The explicit key_field, or the first positional key_by in
        the template. A computed KeySelector cannot be namespaced
        implicitly — it needs an explicit key_field naming a STR field
        the selector reads."""
        if self.key_field is not None:
            return self.key_field
        reshaped = False
        for op in self.signature():
            if op[0] in ("map", "flat_map"):
                reshaped = True
            if op[0] == "key_by":
                if op[1] == "<computed>":
                    raise TenantShapeError(
                        "the template keys by a computed KeySelector; "
                        "pass TenantPlan(key_field=...) naming the STR "
                        "field to fold the tenant id into"
                    )
                if reshaped:
                    # a map between parse and key_by may have moved the
                    # field — the inferred position would namespace the
                    # wrong column silently
                    raise TenantShapeError(
                        "the template maps before key_by; pass "
                        "TenantPlan(key_field=...) naming the key "
                        "field's position in the PARSED record"
                    )
                return op[1]
        return None
