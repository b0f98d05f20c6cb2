"""Static record-schema inference over a constructed job graph.

The analyzer's plan rules (plan_rules.py) lint graph SHAPE; this module
lints record FLOW: it derives the schema the host parse stage produces
(field kinds, numpy dtypes, nullability, key position) and propagates
it symbolically through every operator of every chained stage — device
maps/filters/flat_maps via the production :class:`DeviceChain` dry run,
reduces via the harness over wrap_record/unwrap_record that TSM024 uses
(``purity.abstract_record_eval``, where the reference uses
``jax.eval_shape``), CEP flat-match rows via the compiled pattern's
L×C layout, side-output tags, and the computed-KeySelector synthetic
trailing column. Everything runs before the build: no step program is
built (obs/compilation.py's ``program_compiled`` events stay at zero).

Findings: TSM030–TSM034 (see findings.CATALOG).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..records import BOOL, F64, I64, NUMPY_DTYPES, STR
from .findings import Finding, make_finding

__all__ = [
    "FieldSchema",
    "RecordSchema",
    "StageSchema",
    "SchemaReport",
    "infer_schemas",
    "run_schema_rules",
]


@dataclass(frozen=True)
class FieldSchema:
    """One record field: positional name, parse kind, wire dtype, and
    whether the column admits None (only interned STR columns do — the
    NONE_ID sentinel)."""

    name: str
    kind: str
    dtype: str            # numpy dtype string, e.g. "float64"
    nullable: bool

    def __str__(self) -> str:
        null = "?" if self.nullable else ""
        return f"{self.name}:{self.kind}{null}"


@dataclass(frozen=True)
class RecordSchema:
    """A record shape at one point in the stream."""

    fields: Tuple[FieldSchema, ...]
    key_pos: Optional[int] = None     # key column index (visible record)
    synthetic_key: bool = False       # computed KeySelector trailing col

    @property
    def arity(self) -> int:
        return len(self.fields)

    @property
    def kinds(self) -> List[str]:
        return [f.kind for f in self.fields]

    @property
    def key_kind(self) -> Optional[str]:
        if self.synthetic_key:
            return STR
        if self.key_pos is None or self.key_pos >= len(self.fields):
            return None
        return self.fields[self.key_pos].kind

    def __str__(self) -> str:
        inner = ", ".join(str(f) for f in self.fields)
        key = ""
        if self.synthetic_key:
            key = " key=<computed:str>"
        elif self.key_pos is not None:
            key = f" key=f{self.key_pos}"
        return f"({inner}){key}"


def _schema_from_kinds(kinds, key_pos=None, synthetic=False) -> RecordSchema:
    fields = tuple(
        FieldSchema(
            name=f"f{i}",
            kind=k,
            dtype=np.dtype(NUMPY_DTYPES[k]).name,
            nullable=(k == STR),
        )
        for i, k in enumerate(kinds)
    )
    return RecordSchema(fields=fields, key_pos=key_pos, synthetic_key=synthetic)


@dataclass
class StageSchema:
    """Schema flow through ONE chained stage: parse/hand-off input,
    post-pre-chain ("mid", what the stateful core and its state see),
    and the stage's emission schema feeding the next stage or the sinks.
    ``None`` anywhere means statically unknowable from that point on
    (adaptive parse fallback, full-window process(), aggregate)."""

    index: int
    input: Optional[RecordSchema]
    mid: Optional[RecordSchema]
    output: Optional[RecordSchema]
    stateful_kind: Optional[str] = None       # rolling | window | cep | None
    unknown_reason: Optional[str] = None      # why propagation stopped


@dataclass
class SchemaReport:
    """Everything schema inference derived from one job graph."""

    stages: List[StageSchema] = field(default_factory=list)
    #: schema of records reaching the main sinks (final stage output)
    sink: Optional[RecordSchema] = None
    #: OutputTag id -> [(producer description, RecordSchema|None), ...]
    tags: Dict[str, List[Tuple[str, Optional[RecordSchema]]]] = field(
        default_factory=dict
    )
    findings: List[Finding] = field(default_factory=list)

    @property
    def complete(self) -> bool:
        return self.sink is not None


# -- propagation mechanics ----------------------------------------------------

def _chain_out_kinds(ops, kinds, tables):
    """Push kinds through a device (op, fn) list with the production
    DeviceChain dry run — the same mechanism the runtime uses, so the
    inference cannot drift from execution. Returns (kinds, tables) or
    None when the dry run rejects the chain (TSM014 territory)."""
    if not ops:
        return list(kinds), list(tables)
    from ..runtime.device import DeviceChain

    try:
        chain = DeviceChain(list(ops), list(kinds), list(tables))
    except Exception:
        return None
    return list(chain.out_kinds), list(chain.out_tables)


def _reduce_out_kinds(fn, kinds, tables, value_dtype):
    """Abstractly evaluate a reduce fn over two records of ``kinds``
    (``purity.abstract_record_eval``: scalars, no build) and return the
    output kind list, or None when the fn itself fails to evaluate."""
    from .purity import abstract_record_eval

    try:
        _, out_kinds, _ = abstract_record_eval(
            fn, kinds, tables, value_dtype, n_records=2)
    except Exception:
        return None
    return list(out_kinds)


def _stage_parse_kinds(plan):
    """Stage-0 record kinds straight from the columnar parse plan
    (build_plan filled them from trace_host_map), or None when the
    parse fell back to the adaptive per-line path."""
    if plan.record_kinds:
        return list(plan.record_kinds), list(plan.tables)
    return None


def infer_schemas(env, sink_nodes=None) -> SchemaReport:
    """Infer the record schema at every point of the job: one
    :class:`StageSchema` per chained stage, the main-sink schema, and a
    per-tag map of side-output producer schemas. Pure graph work — no
    step program is built and nothing compiles."""
    from ..runtime.plan import build_plan_chain

    report = SchemaReport()
    sinks = list(sink_nodes if sink_nodes is not None else env._sinks)
    if not sinks:
        return report
    try:
        plans = build_plan_chain(env, sinks)
    except Exception:
        # an unplannable graph is TSM014's finding, not ours
        return report

    value_dtype = env.config.value_dtype
    upstream: Optional[RecordSchema] = None
    for i, plan in enumerate(plans):
        stage = StageSchema(index=i, input=None, mid=None, output=None)
        report.stages.append(stage)

        # ---- stage input schema ----
        if i == 0:
            parsed = _stage_parse_kinds(plan)
            if parsed is None:
                stage.unknown_reason = "adaptive parse (schema resolves at runtime)"
                upstream = None
                continue
            kinds, tables = parsed
        else:
            if upstream is None:
                stage.unknown_reason = "upstream schema unknown"
                continue
            kinds, tables = list(upstream.kinds), [None] * upstream.arity
            if plan.synthetic_key:
                kinds, tables = kinds + [STR], tables + [None]
        stage.input = _schema_from_kinds(
            kinds[:-1] if plan.synthetic_key else kinds,
            key_pos=plan.key_pos if not plan.synthetic_key else None,
            synthetic=plan.synthetic_key,
        )

        # ---- pre chain (visible record, synthetic col routed around) ----
        vis_kinds = kinds[:-1] if plan.synthetic_key else kinds
        vis_tables = tables[:-1] if plan.synthetic_key else tables
        mid = _chain_out_kinds(plan.device_pre, vis_kinds, vis_tables)
        if mid is None:
            stage.unknown_reason = "device pre-chain rejected the dry run"
            upstream = None
            continue
        mid_kinds, mid_tables = mid
        stage.mid = _schema_from_kinds(
            mid_kinds,
            key_pos=plan.key_pos if not plan.synthetic_key else None,
            synthetic=plan.synthetic_key,
        )

        # ---- stateful core ----
        st = plan.stateful
        out_kinds: Optional[list] = mid_kinds
        out_tables: Optional[list] = mid_tables
        if st is not None:
            stage.stateful_kind = st.kind
            if st.kind in ("rolling", "rolling_reduce"):
                # rolling aggregates and reduces are (T, T) -> T
                pass
            elif st.kind == "window":
                if st.apply_kind == "reduce":
                    pass  # (T, T) -> T; drift is TSM031's finding
                elif st.apply_kind == "aggregate":
                    # AggregateFunction.get_result may emit any shape;
                    # resolving it statically needs the accumulator type
                    stage.unknown_reason = "window aggregate result shape"
                    out_kinds = None
                elif st.apply_kind == "process":
                    # full-window process() collects arbitrary host rows;
                    # the runtime itself resolves this schema lazily
                    stage.unknown_reason = "full-window process() rows"
                    out_kinds = None
            elif st.kind == "cep":
                comp = st.cep
                L = getattr(comp, "length", None)
                if L is None:
                    stage.unknown_reason = "uncompiled CEP pattern"
                    out_kinds = None
                else:
                    # flat match record: L matched events' fields,
                    # event-major (cep_program.py match_kinds)
                    out_kinds = [k for _ in range(L) for k in mid_kinds]
                    out_tables = [t for _ in range(L) for t in mid_tables]

        # ---- post chain ----
        if out_kinds is not None:
            post = _chain_out_kinds(plan.device_post, out_kinds, out_tables)
            if post is None:
                stage.unknown_reason = "device post-chain rejected the dry run"
                out_kinds = None
            else:
                out_kinds, out_tables = post

        if out_kinds is None:
            upstream = None
            continue
        stage.output = _schema_from_kinds(out_kinds)
        upstream = stage.output

        # ---- side-output tags produced by this stage ----
        if st is not None and st.late_tag is not None:
            _add_tag(
                report, st.late_tag,
                f"stage {i} window late data",
                _schema_from_kinds(mid_kinds),
            )
        if st is not None and st.timeout_tag is not None:
            comp = st.cep
            R = getattr(comp, "length", 1) - 1 if comp is not None else 0
            # timeout record: (n_matched, start_ts, R capture slots)
            t_kinds = [I64, I64] + [k for _ in range(max(0, R)) for k in mid_kinds]
            _add_tag(
                report, st.timeout_tag,
                f"stage {i} CEP timeout",
                _schema_from_kinds(t_kinds),
            )

    report.sink = report.stages[-1].output if report.stages else None
    return report


def _add_tag(report, tag, producer: str, schema: Optional[RecordSchema]):
    tag_id = getattr(tag, "id", None) or str(tag)
    report.tags.setdefault(tag_id, []).append((producer, schema))


# -- schema rules (TSM030–TSM034) ---------------------------------------------

def run_schema_rules(ctx) -> List[Finding]:
    """Infer schemas for the context's sinks and evaluate the TSM03x
    rules over them. Returns findings (never raises: an uninferable
    graph simply yields none — shape problems are plan_rules' job)."""
    findings: List[Finding] = []
    report = infer_schemas(ctx.env, ctx.sinks)
    findings.extend(_check_float_keys(ctx, report))
    findings.extend(_check_reduce_drift(ctx, report))
    findings.extend(_check_tenant_template_schema(ctx, report))
    findings.extend(_check_never_narrow(ctx, report))
    findings.extend(_check_tag_schema_disagreement(ctx, report))
    return findings


def _check_float_keys(ctx, report) -> List[Finding]:
    """TSM030: keyed state routed by an f64 column — float equality as
    key identity, perturbed by the f32 wire/lane demotions and truncated
    by the int32 key routing."""
    out = []
    for stage in report.stages:
        schema = stage.mid or stage.input
        if schema is None or schema.synthetic_key or schema.key_pos is None:
            continue
        if schema.key_kind == F64:
            out.append(make_finding(
                "TSM030", None,
                f"stage {stage.index} keys by f{schema.key_pos}, an f64 "
                "column: float bits are the state-row identity, and the "
                "f32 wire demotion + int32 key routing both perturb them",
            ))
    return out


def _check_reduce_drift(ctx, report) -> List[Finding]:
    """TSM031: a window/rolling reduce whose output schema (arity or
    kinds) differs from its input stream."""
    out = []
    value_dtype = ctx.cfg.value_dtype
    try:
        from ..runtime.plan import build_plan_chain

        plans = build_plan_chain(ctx.env, ctx.sinks)
    except Exception:
        return out
    for stage, plan in zip(report.stages, plans):
        if stage.mid is None:
            continue
        st = plan.stateful
        fn = None
        if st is not None:
            if st.kind == "rolling_reduce":
                fn = st.rolling_fn
            elif st.kind == "window" and st.apply_kind == "reduce":
                fn = st.apply_fn
        if fn is None:
            continue
        in_kinds = stage.mid.kinds
        got = _reduce_out_kinds(fn, in_kinds, [None] * len(in_kinds), value_dtype)
        if got is not None and got != in_kinds:
            out.append(make_finding(
                "TSM031", None,
                f"stage {stage.index} reduce maps {in_kinds} -> {got}; a "
                "reduce must return the input schema (its output feeds "
                "back as the next accumulator)",
            ))
    return out


def _check_tenant_template_schema(ctx, report) -> List[Finding]:
    """TSM032: a fleet job whose parse map infers a different record
    schema than the TenantPlan template's parse, or whose key_field
    does not resolve to a STR column of that schema."""
    out = []
    server = ctx.tenancy
    plan = getattr(server, "plan", None)
    if plan is None:
        return out
    from .purity import _infer_parse_kinds

    template_kinds = _infer_parse_kinds(plan.parse)
    if template_kinds is None:
        return out  # adaptive template parse: nothing to compare
    stage0 = report.stages[0] if report.stages else None
    if stage0 is not None and stage0.input is not None:
        vis = stage0.input.kinds
        if vis != list(template_kinds):
            out.append(make_finding(
                "TSM032", None,
                f"fleet job parse schema {vis} != TenantPlan template "
                f"schema {list(template_kinds)}; tenants share one "
                "compiled program and one keyed-state block",
            ))
            return out
    try:
        kf = plan.inferred_key_field()
    except Exception:
        return out
    if kf is not None and (
        kf >= len(template_kinds) or template_kinds[kf] != STR
    ):
        got = template_kinds[kf] if kf < len(template_kinds) else "<missing>"
        out.append(make_finding(
            "TSM032", None,
            f"TenantPlan key_field={kf} resolves to kind {got!r} in the "
            "template schema; tenant namespacing folds the tenant id "
            "into a STR key column",
        ))
    return out


def _check_never_narrow(ctx, report) -> List[Finding]:
    """TSM033: packed_wire=True with h2d_compress=False leaves every i64
    column's wire mode chain at 'raw' (executor._initial_modes: the
    d16/d32 delta modes exist only under h2d_compress)."""
    cfg = ctx.cfg
    if not cfg.packed_wire or cfg.h2d_compress:
        return []
    stage0 = report.stages[0] if report.stages else None
    if stage0 is None or stage0.input is None:
        return []
    wide = [f.name for f in stage0.input.fields if f.kind == I64]
    if not wide:
        return []
    return [make_finding(
        "TSM033", None,
        f"h2d_compress=False pins i64 column(s) {', '.join(wide)} to the "
        "raw wire mode — packed_wire can never narrow them (the d16/d32 "
        "delta modes require h2d_compress)",
    )]


def _check_tag_schema_disagreement(ctx, report) -> List[Finding]:
    """TSM034: one OutputTag id fed records of different schemas by
    different producers (refines TSM003's collision with the schema
    detail)."""
    out = []
    for tag_id, producers in report.tags.items():
        known = [(who, s) for who, s in producers if s is not None]
        if len(known) < 2:
            continue
        shapes = {tuple(s.kinds) for _, s in known}
        if len(shapes) > 1:
            detail = "; ".join(f"{who}: {s}" for who, s in known)
            out.append(make_finding(
                "TSM034", None,
                f"side-output tag {tag_id!r} receives disagreeing "
                f"schemas — {detail}",
            ))
    return out
