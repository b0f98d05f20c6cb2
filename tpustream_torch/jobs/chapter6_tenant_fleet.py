"""Chapter 6: the chapter-5 dynamic-threshold alert as a TENANT FLEET.

Counterpart of tpustream/jobs/chapter6_tenant_fleet.py on the port's
package (its pre-flight ``lint_env`` is left out: the port has no
analyzer yet).

The reference runs one Flink job per process; a production monitoring
stack runs thousands of per-customer rule sets. This job multiplexes N
logical copies of the chapter-5 job onto ONE built device program
(``tpustream_torch.tenancy``, docs/multitenancy.md):

* every tenant shares the template chain (parse -> threshold filter) —
  chain SHAPE is verified at admission, so the fleet builds exactly
  one program no matter how many tenants join;
* each tenant's threshold is its own row of the [T] rule vector,
  gathered per record inside the step — admission, removal, and
  threshold changes are device row writes at exact record boundaries,
  ZERO program rebuilds;
* per-tenant record quotas divert over-quota lines to a
  ``quota_exceeded`` side output before they cost device time;
* the single collect sink demuxes back per tenant, byte-identical to
  running that tenant's job alone.

``oracle`` reuses the chapter-5 host oracle per tenant so tests can
assert fleet output == N independent solo runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from tpustream_torch import JobServer, RuleSet, TenantPlan, TenantQuota, Tuple3

from .chapter5_dynamic_rules import DEFAULT_THRESHOLD, oracle, parse


def make_rules() -> RuleSet:
    rules = RuleSet()
    rules.declare(
        "threshold", DEFAULT_THRESHOLD, "f64",
        description="per-tenant alert threshold",
    )
    return rules


def build(stream, rules: RuleSet):
    """The shared template chain: chapter 1's filter with the threshold
    read from the calling tenant's rule row."""
    threshold = rules.param("threshold")
    return stream.filter(lambda value: value.f2 > threshold)


def make_plan(tenant_capacity: int = 64) -> TenantPlan:
    return TenantPlan(
        parse=parse,
        build=build,
        rules=make_rules(),
        tenant_capacity=tenant_capacity,
    )


def make_fleet(
    thresholds: Dict[str, float],
    quotas: Optional[Dict[str, int]] = None,
    tenant_capacity: int = 64,
    config=None,
) -> JobServer:
    """A server with one tenant per entry of ``thresholds``."""
    server = JobServer(make_plan(tenant_capacity), config=config)
    for tenant, threshold in thresholds.items():
        q = (quotas or {}).get(tenant)
        server.add_tenant(
            tenant,
            rules={"threshold": threshold},
            quota=TenantQuota(max_records=q) if q is not None else None,
        )
    return server


def tenant_lines(tenant: str, n: int, base: float = 80.0) -> List[str]:
    """Deterministic per-tenant record stream in the chapter-1 line
    format (``ts host cpu usage``)."""
    return [
        f"2019-10-28T11:2{i % 10:d} {tenant}-host cpu{i % 4} "
        f"{base + (i * 7) % 25}"
        for i in range(n)
    ]


def expected(
    tenant: str,
    lines: Sequence[str],
    threshold: float,
    updates: Sequence = (),
) -> List[Tuple3]:
    """Per-tenant oracle: the chapter-5 host oracle on the tenant's own
    record stream (positions are TENANT-LOCAL here; callers translate
    with JobServer.position when scheduling fleet updates)."""
    return oracle(lines, updates, threshold=threshold)


def lint_env():
    """Constructed-but-never-executed fleet env for the pre-flight
    analyzer: two tenants through JobServer.build_job, so the tenant
    template check (TSM008) exercises the real fleet graph."""
    from tpustream_torch import StreamExecutionEnvironment

    server = make_fleet({"tenant00": 90.0, "tenant01": 95.0})
    env = StreamExecutionEnvironment(server.config)
    server.build_job(env)
    server.env = env
    return env


def main(n_tenants: int = 8, records_per_tenant: int = 64) -> None:
    """Demo: an n-tenant fleet through one built program, with a hot
    threshold update and a removal mid-stream."""
    thresholds = {
        f"tenant{i:02d}": 85.0 + (i % 10) for i in range(n_tenants)
    }
    server = make_fleet(thresholds, quotas={"tenant00": records_per_tenant // 2})
    for i, (tenant, _) in enumerate(thresholds.items()):
        server.ingest(tenant, tenant_lines(tenant, records_per_tenant // 2))
    server.update_tenant_rules("tenant01", {"threshold": 99.0})
    if n_tenants > 2:
        server.remove_tenant("tenant02")
    for tenant in thresholds:
        server.ingest(tenant, tenant_lines(tenant, records_per_tenant // 2))
    server.run("Chapter 6 Tenant Fleet")
    for tenant in thresholds:
        alerts = server.output(tenant)
        dropped = len(server.quota_output(tenant))
        print(
            f"{tenant}: {len(alerts)} alerts"
            + (f", {dropped} over quota" if dropped else "")
        )


if __name__ == "__main__":
    main()
