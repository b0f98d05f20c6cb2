"""Per-tenant SLOs: declarative objectives compiled into health rules.

Counterpart of tpustream/obs/slo.py (the port's own copy).

A fleet operator does not think in ``AlertRule`` grammar — they think
"tenant acme gets a 250 ms p99 and at most 1% errors, measured over a
5-minute budget window". :class:`TenantSLO` is that declaration;
:func:`compile_tenant_slo` lowers it onto the
:class:`~tpustream_torch.obs.health.HealthEngine` as per-tenant
:class:`~tpustream_torch.obs.health.AlertRule` instances whose

* ``labels`` filter selects ONLY that tenant's series
  (``tenant_e2e_latency_ms{tenant=...}`` from the round-robin latency
  markers, ``tenant_error_rate{tenant=...}`` from the demux
  attribution), so one noisy tenant can never trip another's rule;
* ``gauge_labels`` carry the tenant onto the rule's
  ``health_rule_state{tenant=...}`` gauge and its transitions, so a
  scrape — or a postmortem flight dump — names the offending tenant;
* ``budget_window_s`` turns on the engine's error-budget accounting:
  the ``slo_budget_burn{tenant=...}`` gauge is the fraction of the
  trailing window the tenant spent out of SLO.

This module imports nothing beyond the stdlib (the dump CLI and the
analyzer evaluate SLOs offline).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from .health import AlertRule

#: the label value records of tenants past ObsConfig.tenant_series_topk
#: fold into — one bounded bucket instead of an unbounded label space
OTHER_TENANT = "__other__"


@dataclass(frozen=True)
class TenantSLO:
    """One tenant's service-level objective.

    ``p99_ms`` — end-to-end p99 latency bound (None = no latency SLO);
    evaluated against the tenant's ``tenant_e2e_latency_ms`` histogram.
    ``max_error_rate`` — bound on the fraction of the tenant's offered
    records that were rejected, quota-diverted, or dead-lettered (None =
    no error SLO); evaluated against ``tenant_error_rate``.
    ``budget_window_s`` — trailing window for error-budget burn.
    ``for_s`` — sustain time before a breach leaves OK (debounce).
    """

    p99_ms: Optional[float] = None
    max_error_rate: Optional[float] = None
    budget_window_s: float = 300.0
    for_s: float = 0.0
    severity: str = "crit"


def compile_tenant_slo(tenant: str, slo: TenantSLO) -> List[AlertRule]:
    """Lower one tenant's SLO into per-tenant health rules. Rule names
    embed the tenant (``slo_p99[acme]``) so fleets stay collision-free
    in one engine and ``HealthEngine.remove_rules`` can retire exactly
    one tenant's rules on removal."""
    rules: List[AlertRule] = []
    sel = (("tenant", str(tenant)),)
    if slo.p99_ms is not None:
        rules.append(AlertRule(
            name=f"slo_p99[{tenant}]",
            metric="tenant_e2e_latency_ms:p99",
            op=">",
            value=float(slo.p99_ms),
            for_s=slo.for_s,
            severity=slo.severity,
            labels=sel,
            gauge_labels=sel,
            budget_window_s=slo.budget_window_s,
        ))
    if slo.max_error_rate is not None:
        rules.append(AlertRule(
            name=f"slo_err[{tenant}]",
            metric="tenant_error_rate",
            op=">",
            value=float(slo.max_error_rate),
            for_s=slo.for_s,
            severity=slo.severity,
            labels=sel,
            gauge_labels=sel,
            budget_window_s=slo.budget_window_s,
        ))
    return rules


def slo_rule_names(tenant: str) -> List[str]:
    """Every rule name :func:`compile_tenant_slo` could have minted for
    ``tenant`` — the removal set for ``HealthEngine.remove_rules``."""
    return [f"slo_p99[{tenant}]", f"slo_err[{tenant}]"]
