"""Pre-flight static analysis of constructed job graphs.

``analyze(env)`` runs every plan-lint rule (plan_rules), the
user-function purity analyzer (purity), and whole-chain schema
inference (schema) over the env's sink graph and returns typed
:class:`Finding` objects — all before any step program is built.
``StreamConfig.strict_analysis=True`` makes the executor call this at
submission and raise :class:`PlanAnalysisError` on ERROR findings;
``python -m tpustream_torch.analysis.lint`` is the CLI form and
``python -m tpustream_torch.analysis.audit`` the checkpoint state-layout
auditor (state_audit). The rule catalog lives in
:data:`findings.CATALOG` and docs/analysis.md.

This is the port's copy of the JAX package's ``tpustream/analysis``,
with the same rules, codes and messages. Where the reference evaluates
a user function abstractly with ``jax.eval_shape``, the port runs it
once over 0-d CPU tensors of the record's dtypes
(:func:`purity.abstract_record_eval`), and where it trees a program's
state abstractly, the port reads the program's
``jax_state_spec`` (state_audit).
"""

from __future__ import annotations

from typing import List, Optional

from .findings import (
    CATALOG,
    ERROR,
    INFO,
    WARN,
    Finding,
    PlanAnalysisError,
    Rule,
    has_errors,
    make_finding,
    worst_severity,
)
from .plan_rules import AnalysisContext, run_plan_rules
from .purity import analyze_callable, check_dtype_widening, run_purity_rules
from .schema import (
    FieldSchema,
    RecordSchema,
    SchemaReport,
    StageSchema,
    infer_schemas,
    run_schema_rules,
)

__all__ = [
    "AnalysisContext",
    "CATALOG",
    "ERROR",
    "FieldSchema",
    "Finding",
    "INFO",
    "PlanAnalysisError",
    "RecordSchema",
    "Rule",
    "SchemaReport",
    "StageSchema",
    "WARN",
    "analyze",
    "analyze_callable",
    "check_dtype_widening",
    "has_errors",
    "infer_schemas",
    "make_finding",
    "run_schema_rules",
    "worst_severity",
]


def analyze(env, sink_nodes=None) -> List[Finding]:
    """All findings for the env's constructed job graph, ERROR first.

    Pure inspection: walks Node chains, config, broadcast rules, and
    the tenancy template. Safe to call any number of times; the graph
    is never mutated and nothing compiles.
    """
    from .findings import severity_rank

    if sink_nodes is None:
        sink_nodes = getattr(env, "_sinks", [])
    if not sink_nodes:
        return []
    ctx = AnalysisContext(env, sink_nodes)
    findings = run_plan_rules(ctx) + run_purity_rules(ctx) + run_schema_rules(ctx)
    findings.sort(key=lambda f: (-severity_rank(f.severity), f.code))
    return findings
