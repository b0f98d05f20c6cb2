"""Supervised execution: the built-in health rules of the ingest plane.

Counterpart of the first part of tpustream/runtime/supervisor.py: the
built-in WARN rules a job with ``ingest_lanes > 1`` and obs on installs
before its obs root reads ``ObsConfig.health_rules``. Restart strategies
and checkpointed recovery (the rest of the reference module) are not
ported yet; the executor refuses ``restart_strategy`` by name.
"""

from __future__ import annotations

LANE_RESTART_HEALTH_RULE_NAME = "ingest_lane_restarted"
LANE_CONTENTION_HEALTH_RULE_NAME = "lane_core_contention"


def _install_builtin_health_rule(env, name: str, metric: str,
                                 severity: str = "warn",
                                 value: float = 0.0) -> None:
    """One built-in threshold rule (``sum(metric) > value``), skipped
    when the user already configured a rule with this name."""
    cfg = env.config
    rules = tuple(cfg.obs.health_rules or ())
    for r in rules:
        got = r.get("name") if isinstance(r, dict) else getattr(r, "name", "")
        if got == name:
            return
    from ..obs.health import AlertRule

    rule = AlertRule(
        name=name,
        metric=metric,
        kind="threshold",
        op=">",
        value=value,
        severity=severity,
        agg="sum",
    )
    env.config = cfg.replace(obs=cfg.obs.replace(health_rules=rules + (rule,)))


def _install_lane_restart_health_rule(env) -> None:
    """Built-in WARN rule for the self-healing ingest plane: trips once
    any lane worker has been respawned in place. Lane recovery keeps the
    job running with byte-identical output (no job restart), so without
    this rule a lane crash-looping toward fold-out would be visible only
    in the flight ring."""
    _install_builtin_health_rule(
        env, LANE_RESTART_HEALTH_RULE_NAME, "ingest_lane_restarts_total"
    )


def _install_lane_contention_health_rule(env) -> None:
    """Built-in WARN rule for the resource plane: trips once the
    ResourceSampler has observed lane workers contending for a core (two
    busy lanes on the same core, or the whole plane pinned at ~1 core of
    CPU)."""
    _install_builtin_health_rule(
        env, LANE_CONTENTION_HEALTH_RULE_NAME, "lane_core_contention_total"
    )
