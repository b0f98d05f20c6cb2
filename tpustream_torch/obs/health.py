"""Self-monitoring health engine: declarative alert rules over the
metrics registry, evaluated at snapshot ticks.

Counterpart of tpustream/obs/health.py (the port's own copy).

The reference tutorial's whole point is monitoring *and alerting*
(chapter 1's threshold alert); this module lets the runtime apply the
same idea to itself. An :class:`AlertRule` names a registry series and
a predicate (threshold, rate-of-change, or absence); the
:class:`HealthEngine` evaluates every rule against a point-in-time
series list (``MetricsRegistry.snapshot()["series"]`` — or any snapshot
file's, so rules replay offline), runs a small OK/WARN/CRIT state
machine per rule, and emits :func:`HealthReport` transition dicts to a
configurable alert sink, the flight recorder, and per-rule state
gauges.

Rule grammar (see docs/observability.md):

* ``metric`` — ``"name"`` or ``"name:field"``; ``field`` picks a
  histogram snapshot component (``p50``/``p90``/``p99``/``count``/
  ``sum``), scalars ignore it.
* ``labels`` — optional label-subset filter; a rule matches every
  series whose labels are a superset.
* ``kind`` — ``threshold`` (compare the aggregated value),
  ``rate`` (compare its per-second derivative between evaluations), or
  ``absence`` (breach when no series matches, or when no matching
  series' value has changed since the previous evaluation — the
  ``records_out rate == 0`` liveness idiom).
* ``agg`` — how multiple matching series collapse to one value
  (``max``/``min``/``sum``; worst-case ``max`` by default).
* ``for_s`` — how long the predicate must hold before the rule leaves
  OK (alert debounce); clearing is immediate.
* ``severity`` — the level a sustained breach raises: ``warn``/``crit``.

Evaluation is O(rules x series) per tick and never runs on the record
path. This module imports nothing beyond the stdlib, so the
``tpustream_torch.obs.dump`` CLI can evaluate rules without a device runtime.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

LEVELS = ("ok", "warn", "crit")
LEVEL_VALUE = {"ok": 0, "warn": 1, "crit": 2}

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}

_AGGS = {
    "max": max,
    "min": min,
    "sum": sum,
}


@dataclass(frozen=True)
class AlertRule:
    """One declarative health rule. Frozen so a rule set is shareable
    across jobs/shards; all per-evaluation state lives in the engine."""

    name: str
    metric: str                        # "series" or "series:field"
    kind: str = "threshold"            # threshold | rate | absence
    op: str = ">"                      # threshold/rate comparator
    value: float = 0.0                 # comparison operand
    for_s: float = 0.0                 # sustain before leaving OK
    severity: str = "crit"             # warn | crit
    labels: Tuple[Tuple[str, str], ...] = ()  # label-subset filter
    agg: str = "max"                   # max | min | sum across matches
    #: extra labels minted onto this rule's ``health_rule_state`` gauge
    #: (and its transitions) — per-tenant SLO rules carry
    #: ``{"tenant": "<id>"}`` here so the fleet's rule states are
    #: addressable as ``health_rule_state{tenant=...}`` series.
    gauge_labels: Tuple[Tuple[str, str], ...] = ()
    #: > 0 enables error-budget accounting: the engine tracks the
    #: time-weighted fraction of the trailing window this rule spent in
    #: breach and publishes it as an ``slo_budget_burn`` gauge (0.0 =
    #: full budget left, 1.0 = the whole window breached).
    budget_window_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("threshold", "rate", "absence"):
            raise ValueError(f"unknown rule kind {self.kind!r}")
        if self.op not in _OPS:
            raise ValueError(f"unknown rule op {self.op!r}")
        if self.severity not in ("warn", "crit"):
            raise ValueError(f"unknown rule severity {self.severity!r}")
        if self.agg not in _AGGS:
            raise ValueError(f"unknown rule agg {self.agg!r}")
        if isinstance(self.labels, dict):
            object.__setattr__(
                self, "labels", tuple(sorted(self.labels.items()))
            )
        if isinstance(self.gauge_labels, dict):
            object.__setattr__(
                self, "gauge_labels", tuple(sorted(self.gauge_labels.items()))
            )

    @property
    def series_name(self) -> str:
        return self.metric.split(":", 1)[0]

    @property
    def field(self) -> Optional[str]:
        if ":" in self.metric:
            return self.metric.split(":", 1)[1]
        return None


def as_rule(r) -> AlertRule:
    """Coerce a rule spec (AlertRule or plain dict — the config-file /
    JSON form) into an AlertRule."""
    if isinstance(r, AlertRule):
        return r
    if isinstance(r, dict):
        return AlertRule(**r)
    raise TypeError(f"not an AlertRule or dict: {r!r}")


def _series_value(s: dict, fld: Optional[str]):
    v = s.get("value")
    if isinstance(v, dict):  # histogram snapshot {count,sum,p50,p90,p99}
        return v.get(fld or "p99")
    if fld in (None, "value"):
        return v
    return None


class HealthEngine:
    """Evaluates a rule set over series snapshots; per-rule OK/WARN/CRIT
    state machine with sustain (``for_s``) debounce.

    ``alert_sink`` is any callable taking one transition dict; sink
    exceptions are swallowed (an alerting bug must never take the job
    down with it). ``gauge_group`` (a registry :class:`MetricGroup`)
    mints one ``health_rule_state`` gauge per rule (0/1/2) so rule
    levels are scrapeable series themselves; ``flight`` (a
    :class:`~tpustream_torch.obs.flightrecorder.FlightRecorder`) receives a
    ``health_transition`` event per level change.
    """

    def __init__(
        self,
        rules,
        alert_sink: Optional[Callable[[dict], None]] = None,
        gauge_group=None,
        flight=None,
        max_transitions: int = 256,
    ):
        self.rules: List[AlertRule] = []
        self.alert_sink = alert_sink
        self.flight = flight
        self.max_transitions = int(max_transitions)
        self.transitions: List[dict] = []
        self._state: dict = {}
        # (rule_name, series_key) -> (t_s, value): previous observation
        # for rate / absence rules
        self._prev: dict = {}
        self._gauges = {}
        self._burn_gauges = {}
        self._gauge_group = gauge_group
        self.add_rules(rules)

    def add_rules(self, rules) -> None:
        """Extend the rule set post-construction — the per-tenant SLO
        compiler lands its rules here so a fleet can declare SLOs after
        the engine (and its static config rules) already exist."""
        fresh = [as_rule(r) for r in rules]
        names = [r.name for r in self.rules] + [r.name for r in fresh]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.rules.extend(fresh)
        for r in fresh:
            self._state[r.name] = {
                "level": "ok", "breach_since": None, "value": None,
                "reason": "", "burn": None, "burn_window": [],
            }
        if self._gauge_group is not None:
            for r in fresh:
                g = self._gauge_group.group(
                    rule=r.name, **dict(r.gauge_labels)
                )
                self._gauges[r.name] = g.gauge("health_rule_state")
                if r.budget_window_s > 0:
                    self._burn_gauges[r.name] = g.gauge("slo_budget_burn")

    def remove_rules(self, names) -> None:
        """Drop rules by name (idempotent) and retire their state
        gauges from the registry — the counterpart of :meth:`add_rules`
        for tenant removal, so a removed tenant's
        ``health_rule_state{tenant=...}`` series stop appearing in
        snapshots."""
        doomed = set(names)
        self.rules = [r for r in self.rules if r.name not in doomed]
        for n in doomed:
            self._state.pop(n, None)
            g = self._gauges.pop(n, None)
            bg = self._burn_gauges.pop(n, None)
            reg = getattr(self._gauge_group, "registry", None)
            if reg is not None:
                for inst in (g, bg):
                    if inst is not None:
                        reg.retire(inst.name, inst.labels)
        self._prev = {
            k: v for k, v in self._prev.items() if k[0] not in doomed
        }

    # -- evaluation --------------------------------------------------------

    def _matches(self, rule: AlertRule, s: dict) -> bool:
        if s.get("name") != rule.series_name:
            return False
        labels = s.get("labels") or {}
        return all(labels.get(k) == v for k, v in rule.labels)

    def _observe(self, rule: AlertRule, series: List[dict], now_s: float):
        """-> (breach, value, reason) for one rule at one tick."""
        matched = []
        for s in series:
            if self._matches(rule, s):
                v = _series_value(s, rule.field)
                if v is not None:
                    key = (rule.name, s["name"],
                           tuple(sorted((s.get("labels") or {}).items())))
                    matched.append((key, float(v)))
        agg = _AGGS[rule.agg]

        if rule.kind == "threshold":
            if not matched:
                return False, None, "no matching series"
            v = agg(x for _, x in matched)
            return _OPS[rule.op](v, rule.value), v, (
                f"{rule.metric} {rule.op} {rule.value} (observed {v:g})"
            )

        if rule.kind == "rate":
            rates = []
            for key, v in matched:
                prev = self._prev.get(key)
                self._prev[key] = (now_s, v)
                if prev is not None and now_s > prev[0]:
                    rates.append((v - prev[1]) / (now_s - prev[0]))
            if not rates:
                return False, None, "no rate yet"
            rv = agg(rates)
            return _OPS[rule.op](rv, rule.value), rv, (
                f"rate({rule.metric}) {rule.op} {rule.value}/s "
                f"(observed {rv:g}/s)"
            )

        # absence: nothing matched, or nothing moved since last tick
        if not matched:
            return True, None, f"{rule.metric} absent"
        moved = False
        have_prev = False
        v = agg(x for _, x in matched)
        for key, val in matched:
            prev = self._prev.get(key)
            self._prev[key] = (now_s, val)
            if prev is not None:
                have_prev = True
                if val != prev[1]:
                    moved = True
        if not have_prev:
            return False, v, "first observation"
        return (not moved), v, (
            f"{rule.metric} unchanged" if not moved else f"{rule.metric} moving"
        )

    def evaluate(self, series: List[dict], now_s: float) -> dict:
        """Evaluate every rule against ``series`` (a list of
        ``{"name","type","labels","value"}`` dicts) at time ``now_s``
        (seconds, any monotone epoch). Returns :meth:`state`."""
        for rule in list(self.rules):
            st = self._state[rule.name]
            breach, value, reason = self._observe(rule, series, now_s)
            st["value"] = value
            st["reason"] = reason
            if rule.budget_window_s > 0:
                self._account_burn(rule, st, breach, now_s)
            if breach:
                if st["breach_since"] is None:
                    st["breach_since"] = now_s
                target = (
                    rule.severity
                    if now_s - st["breach_since"] >= rule.for_s
                    else st["level"]
                )
            else:
                st["breach_since"] = None
                target = "ok"
            if target != st["level"]:
                self._transition(rule, st["level"], target, value, reason,
                                 now_s)
                st["level"] = target
            g = self._gauges.get(rule.name)
            if g is not None:
                g.set(LEVEL_VALUE[st["level"]])
        return self.state(now_s)

    def _account_burn(self, rule, st, breach: bool, now_s: float) -> None:
        """Error-budget burn: the time-weighted breach fraction over the
        trailing ``budget_window_s``. Each tick contributes the interval
        since the previous tick, attributed to that interval's breach
        state; intervals older than the window roll off. O(ticks in
        window) per rule per tick."""
        win = st["burn_window"]
        win.append((now_s, bool(breach)))
        lo = now_s - rule.budget_window_s
        while len(win) > 1 and win[1][0] <= lo:
            win.pop(0)
        if len(win) < 2:
            st["burn"] = 1.0 if breach else 0.0
        else:
            breached = total = 0.0
            for (t0, _), (t1, b1) in zip(win, win[1:]):
                dt = max(0.0, t1 - max(t0, lo))
                total += dt
                if b1:
                    breached += dt
            st["burn"] = breached / total if total > 0 else (
                1.0 if breach else 0.0
            )
        bg = self._burn_gauges.get(rule.name)
        if bg is not None:
            bg.set(round(st["burn"], 6))

    def _transition(self, rule, prev, new, value, reason, now_s):
        report = {
            "rule": rule.name,
            "from": prev,
            "to": new,
            "at_s": round(now_s, 6),
            "value": value,
            "reason": reason,
        }
        if rule.gauge_labels:
            report.update(dict(rule.gauge_labels))
        self.transitions.append(report)
        if len(self.transitions) > self.max_transitions:
            del self.transitions[: len(self.transitions)
                                 - self.max_transitions]
        if self.flight is not None:
            self.flight.record("health_transition", **report)
        if self.alert_sink is not None:
            try:
                self.alert_sink(report)
            except Exception:
                pass  # a broken alert sink must not fail the job

    # -- reporting ---------------------------------------------------------

    def level(self) -> str:
        """Worst level across all rules."""
        worst = "ok"
        for st in self._state.values():
            if LEVEL_VALUE[st["level"]] > LEVEL_VALUE[worst]:
                worst = st["level"]
        return worst

    def state(self, now_s: Optional[float] = None) -> dict:
        """JSON-serializable health section for snapshots / dumps."""
        rules = []
        for r in self.rules:
            st = self._state[r.name]
            entry = {
                "rule": r.name,
                "metric": r.metric,
                "kind": r.kind,
                "severity": r.severity,
                "level": st["level"],
                "value": st["value"],
                "reason": st["reason"],
                "breach_since_s": st["breach_since"],
            }
            if r.gauge_labels:
                entry["labels"] = dict(r.gauge_labels)
            if st.get("burn") is not None:
                entry["budget_burn"] = round(st["burn"], 6)
            rules.append(entry)
        out = {
            "level": self.level(),
            "rules": rules,
            "transitions": list(self.transitions),
        }
        if now_s is not None:
            out["evaluated_at_s"] = round(now_s, 6)
        return out
