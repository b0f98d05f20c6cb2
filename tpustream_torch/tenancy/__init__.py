"""Multi-tenant serving: many logical jobs on ONE built device program.

Counterpart of tpustream/tenancy (see docs/multitenancy.md). The fleet shares a :class:`TenantPlan`
(template parse + operator chain + RuleSet); :class:`JobServer`
multiplexes tenants over it with per-tenant key namespaces, per-tenant
[T] rule rows, record quotas, and a demuxed collect sink — admission,
removal, and rule updates are all device buffer writes at exact record
boundaries, never program rebuilds.
"""

from .plan import TenantPlan, TenantQuota, TenantShapeError
from .server import JobServer, TenantDemuxHandle

__all__ = [
    "JobServer",
    "TenantDemuxHandle",
    "TenantPlan",
    "TenantQuota",
    "TenantShapeError",
]
