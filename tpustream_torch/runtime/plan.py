"""Job planning: lazy graph -> host parse stage + device program + sinks.

Splits each job chain the way SURVEY.md §3 prescribes: string-typed
operators near the source (parse maps, timestamp extraction) become the
vectorized host stage; everything numeric compiles into ONE jitted device
step (stateless chain, keyed rolling aggregate, or windowed aggregation);
sinks and late-data side outputs run on the host over compacted emissions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

from ..api.graph import Node
from ..api.output import OutputTag
from ..api.timeapi import TimeCharacteristic
from ..api.watermarks import (
    AssignerWithPeriodicWatermarks,
    AssignerWithPunctuatedWatermarks,
    BoundedOutOfOrdernessTimestampExtractor,
)
from ..api.windows import WindowSpec
from ..records import STR, DerivedKeyTable, StringTable
from .. import hostparse


@dataclass
class HostOp:
    """A host-stage op over raw string lines."""

    op: str                     # map | filter | flat_map
    fn: Any
    plan: Optional[hostparse.HostMapPlan] = None  # symbolic plan for maps


class _FieldProbe:
    """Sentinel standing in for one record field during key-selector
    probing.

    Truthiness and ordering raise: a selector that BRANCHES on a field
    (``lambda r: r.f1 or 'default'``, ``r.f1 if r.f2 > 0 else ...``)
    is computing a key, not projecting one — the raise makes the probe
    fall through to the 'computed' classification instead of silently
    keying every record on the probed field."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def _no_probe(self, op: str):
        raise TypeError(
            f"KeySelector applies '{op}' to a record field at plan time; "
            "classifying it as a computed (host-evaluated) key"
        )

    def __bool__(self):
        self._no_probe("bool")

    def __eq__(self, other):
        # also covers !=: the default __ne__ delegates here. Defining
        # __eq__ makes the class unhashable, so set/dict membership
        # (`r.f0 in {'a','b'}`) raises too — __hash__ below only makes
        # that error say what happened
        self._no_probe("==")

    def __hash__(self):
        self._no_probe("hash")

    def __lt__(self, other):
        self._no_probe("<")

    def __le__(self, other):
        self._no_probe("<=")

    def __gt__(self, other):
        self._no_probe(">")

    def __ge__(self, other):
        self._no_probe(">=")


class _RecordProbe:
    """Record stand-in handed to a KeySelector at plan time: any
    ``fN`` / ``[N]`` access returns a field sentinel, so a selector that
    PROJECTS a field resolves to its index without running on data."""

    def __getattr__(self, name: str):
        if name.startswith("f") and name[1:].isdigit():
            return _FieldProbe(int(name[1:]))
        raise AttributeError(name)

    def __getitem__(self, i: int):
        return _FieldProbe(int(i))


def _probe_selector(key: Any):
    """(callable, probe_result) for a ``keyBy`` selector argument, or
    (None, None) when no candidate entry point runs.

    A KeySelector subclass may override either ``get_key`` or the
    Flink-style ``getKey`` alias; a bare lambda is the callable itself.
    Each candidate is probed ONCE with a sentinel record: a projecting
    selector returns a field sentinel, a computed selector typically
    chokes on the sentinel (still a valid host-side callable), and the
    un-overridden abstract base method raises NotImplementedError."""
    candidates = [
        getattr(key, meth)
        for meth in ("get_key", "getKey")
        if hasattr(key, meth)
    ]
    if callable(key):
        candidates.append(key)
    for fn in candidates:
        try:
            return fn, fn(_RecordProbe())
        except NotImplementedError:
            continue
        except Exception:
            return fn, None
    return None, None


def classify_key_selector(key: Any):
    """``("pos", index)`` or ``("computed", callable)`` for a ``keyBy``
    argument; raises for arguments that are no selector at all.

    Flink's surface accepts a field index or a ``KeySelector``; every
    reference job uses indices (chapter2/.../ComputeCpuMax.java:26), and
    in practice selectors project a field (``r -> r.f1``) — those
    resolve AT PLAN TIME to the field's index (the symbolic fast path).
    A selector that COMPUTES a derived key classifies as computed and
    runs host-side per record (plan.synthetic_key)."""
    # bool is an int subclass: key_by(True) would silently key on field
    # 1 — reject it as a non-selector instead
    if isinstance(key, int) and not isinstance(key, bool):
        return "pos", key
    fn, out = _probe_selector(key)
    if fn is None:
        raise NotImplementedError(
            f"key_by takes a tuple field index or a KeySelector "
            f"(a callable / get_key | getKey overrider); got "
            f"{type(key).__name__}: {key!r}"
        )
    if isinstance(out, _FieldProbe):
        return "pos", out.index
    return "computed", fn


def resolve_key_selector(key: Any) -> int:
    """Strict form of :func:`classify_key_selector`: the field index,
    or a raise for computed selectors (callers that cannot host-derive)."""
    kind, val = classify_key_selector(key)
    if kind == "pos":
        return val
    raise NotImplementedError(
        "this KeySelector does not project a single record field, so "
        "it must run as a computed (host-evaluated) key"
    )


@dataclass
class StatefulSpec:
    kind: str                   # rolling | rolling_reduce | window
    # rolling
    rolling_kind: Optional[str] = None   # max/min/sum/max_by/min_by
    rolling_pos: Optional[int] = None
    rolling_fn: Optional[Any] = None
    # window
    window: Optional[WindowSpec] = None
    apply_kind: Optional[str] = None     # reduce | aggregate | process
    apply_fn: Optional[Any] = None
    allowed_lateness_ms: int = 0
    late_tag: Optional[OutputTag] = None
    # cep: the CompiledPattern (tpustream/cep/nfa.py) and the side output
    # receiving within()-expired partial matches
    cep: Optional[Any] = None
    timeout_tag: Optional[OutputTag] = None


@dataclass
class SideOutputPlan:
    tag: OutputTag
    ops: List[tuple] = field(default_factory=list)  # (op, fn) applied per record on host
    sink_node: Optional[Node] = None


@dataclass
class BranchPlan:
    """One main-sink branch: host-side (op, fn) suffix past the shared
    compiled chain, then its sink. Branch fan-out (several sinks off one
    stream, each with its own map/filter tail) runs over the compacted
    emissions, so per-record host work is alert-scale, not input-scale."""

    ops: List[tuple]
    sink_node: Node


@dataclass
class JobPlan:
    source: Any
    host_ops: List[HostOp]
    ts_assigner: Optional[Any]           # assigner on raw lines (or None)
    ts_expr: Optional[hostparse.PExpr]   # symbolic timestamp plan
    ts_delay_ms: int                     # bounded out-of-orderness
    punctuated: bool
    record_kinds: List[str]
    tables: List[Optional[StringTable]]
    device_pre: List[tuple]              # (op, fn) before the stateful op
    key_pos: Optional[int]
    stateful: Optional[StatefulSpec]
    device_post: List[tuple]             # (op, fn) after the stateful op
    branches: List[BranchPlan]
    side_outputs: List[SideOutputPlan]
    time_characteristic: TimeCharacteristic
    # a second keyed stage (key_by after a stateful op) splits the chain:
    # these nodes form the NEXT stage's plan, fed by this stage's
    # compacted emissions (see build_plan_chain)
    chain_rest: List[Node] = field(default_factory=list)
    # chained stages: event timestamps arrive WITH the upstream emissions
    # (window results carry window_end - 1, Flink's result timestamp;
    # rolling aggregates forward the record's own timestamp), so
    # event-time windows need no assigner here
    upstream_supplies_ts: bool = False
    # computed KeySelector fallback: the host evaluates derived_key_fn
    # per record and interns the result into a SYNTHETIC trailing key
    # column (record_kinds[-1], a DerivedKeyTable). The column exists
    # only up to key extraction — user functions, stored state, and
    # emissions all see the visible record without it.
    synthetic_key: bool = False
    derived_key_fn: Optional[Any] = None
    # dynamic rules (tpustream/broadcast): every stage of a job shares
    # ONE RuleSet object, so a control-stream update reaches the whole
    # chain at the same record boundary. None = no dynamic parameters;
    # the state pytree then carries no rule leaves (treedef unchanged).
    rules: Optional[Any] = None
    broadcast: Optional[Any] = None      # the BroadcastStream, stage 0 only


def _is_raw_stage(kinds: Optional[List[str]]) -> bool:
    return kinds is None


def build_plan(env, sink_nodes: List[Node]) -> JobPlan:
    # dynamic-rules control stream, registered by DataStream.broadcast().
    # Its source node is NOT part of the sink walk below — control
    # records never enter the data path; the executor drains them into
    # rule-pytree updates between data batches.
    broadcast = getattr(env, "_broadcast", None)

    # separate main sinks from side-output sinks
    main_sinks: List[Node] = []
    side_sinks: List[Node] = []
    for s in sink_nodes:
        chain = s.chain_to_source()
        if any(n.op == "side_output" for n in chain):
            side_sinks.append(s)
        else:
            main_sinks.append(s)
    if not main_sinks:
        raise RuntimeError("a job needs at least one main (non-side-output) sink")

    # Branch fan-out: the longest common prefix of every main sink's
    # chain compiles into the device program; each branch's suffix must
    # be map/filter only and runs host-side over the emissions (Flink's
    # stream reuse — one stream, several consumers with their own tails)
    chains = [s.chain_to_source() for s in main_sinks]
    prefix_len = len(chains[0])
    for chain in chains[1:]:
        common = 0
        for a, b in zip(chains[0], chain):
            if a is not b:
                break
            common += 1
        prefix_len = min(prefix_len, common)
    # never include any sink node in the shared prefix
    prefix_len = min(
        prefix_len,
        next(
            (
                i
                for i, n in enumerate(chains[0])
                if n.op.startswith("sink_")
            ),
            prefix_len,
        ),
    )
    if prefix_len == 0 or chains[0][0].op != "source":
        raise NotImplementedError(
            "all sinks of a job must consume streams built from ONE "
            "source; run unrelated pipelines as separate jobs"
        )
    branches: List[BranchPlan] = []
    for s, chain in zip(main_sinks, chains):
        ops: List[tuple] = []
        for n in chain[prefix_len:-1]:
            if n.op in ("map", "filter"):
                ops.append((n.op, n.params["fn"]))
            else:
                raise NotImplementedError(
                    f"branched streams support map/filter tails only; "
                    f"operator {n.op} must come before the branch point "
                    f"(keyed/windowed work belongs to the shared stream)"
                )
        branches.append(BranchPlan(ops=ops, sink_node=s))

    nodes = chains[0][:prefix_len]
    assert nodes[0].op == "source"
    source = nodes[0].params["source"]

    host_ops: List[HostOp] = []
    ts_assigner = None
    ts_expr = None
    ts_delay_ms = 0
    punctuated = False
    record_kinds: Optional[List[str]] = None
    tables: List[Optional[StringTable]] = []
    device_pre: List[tuple] = []
    device_post: List[tuple] = []
    key_pos: Optional[int] = None
    stateful: Optional[StatefulSpec] = None
    pending_window: Optional[Node] = None
    chain_rest: List[Node] = []
    synthetic_key = False
    derived_key_fn = None

    for node in nodes[1:]:
        op = node.op
        if op in ("sink_print", "sink_collect", "sink_fn"):
            continue
        if op == "assign_ts":
            if not _is_raw_stage(record_kinds):
                raise NotImplementedError(
                    "assign_timestamps_and_watermarks must precede parsing maps "
                    "(as in reference chapter3/.../BandwidthMonitorWithEventTime.java:29)"
                )
            ts_assigner = node.params["assigner"]
            if isinstance(ts_assigner, BoundedOutOfOrdernessTimestampExtractor):
                ts_delay_ms = ts_assigner.get_max_out_of_orderness_in_millis()
            punctuated = isinstance(ts_assigner, AssignerWithPunctuatedWatermarks)
            ts_expr = hostparse.trace_timestamp_extractor(
                ts_assigner.extract_timestamp
            )
            continue
        if op in ("map", "filter", "flat_map"):
            fn = node.params["fn"]
            if _is_raw_stage(record_kinds):
                if op == "map":
                    plan = hostparse.trace_host_map(fn)
                    host_ops.append(HostOp(op, fn, plan))
                    if plan.fallback_fn is None:
                        record_kinds = list(plan.kinds)
                        tables = [
                            StringTable() if k == STR else None for k in record_kinds
                        ]
                    else:
                        record_kinds = []  # resolved adaptively on first batch
                        tables = []
                else:
                    host_ops.append(HostOp(op, fn))
                continue
            target = device_post if stateful is not None else device_pre
            if op == "flat_map":
                raise NotImplementedError(
                    "flat_map is only supported on the raw (pre-parse) stage"
                )
            target.append((op, fn))
            continue
        if op == "key_by":
            if stateful is not None:
                # chain split: everything from this key_by on becomes the
                # next stage, fed by this stage's emissions
                chain_rest = nodes[nodes.index(node):]
                break
            if synthetic_key:
                # a later key_by SUPERSEDES a computed key: drop its
                # synthetic column (else the runtime would silently
                # keep keying on the stale derived key)
                if record_kinds:
                    record_kinds = record_kinds[:-1]
                    tables = tables[:-1]
                synthetic_key = False
                derived_key_fn = None
            kind, val = classify_key_selector(node.params["key"])
            if kind == "pos":
                key_pos = val
            else:
                # computed KeySelector: host-evaluate per record into a
                # synthetic trailing key column (the symbolic fast path
                # stays for field projections). key_pos = -1 addresses
                # the trailing column whatever the record arity —
                # adaptive parse schemas append it on the first batch
                # (HostStage), resolved ones here.
                if any(o == "map" for o, _ in device_pre):
                    raise NotImplementedError(
                        "a computed KeySelector must follow the parse "
                        "map directly (filters in between are fine); "
                        "either move the map after the keyed operation "
                        "or add the derived field in the map and key on "
                        "it by index"
                    )
                derived_key_fn = val
                synthetic_key = True
                if record_kinds:
                    record_kinds = record_kinds + [STR]
                    tables = tables + [DerivedKeyTable()]
                key_pos = -1
            continue
        if op == "rolling":
            if key_pos is None:
                raise RuntimeError("rolling aggregates require key_by")
            stateful = StatefulSpec(
                "rolling",
                rolling_kind=node.params["kind"],
                rolling_pos=node.params["pos"],
            )
            continue
        if op == "rolling_reduce":
            if key_pos is None:
                raise RuntimeError("reduce on a keyed stream requires key_by")
            stateful = StatefulSpec("rolling_reduce", rolling_fn=node.params["fn"])
            continue
        if op == "window":
            if key_pos is None:
                raise RuntimeError("windows require key_by")
            pending_window = node
            continue
        if op in ("window_reduce", "window_aggregate", "window_process"):
            assert pending_window is not None
            spec: WindowSpec = pending_window.params["spec"]
            stateful = StatefulSpec(
                "window",
                window=spec,
                apply_kind=op.removeprefix("window_"),
                apply_fn=node.params.get("fn"),
                allowed_lateness_ms=pending_window.params.get(
                    "allowed_lateness_ms", 0
                ),
                late_tag=pending_window.params.get("late_tag"),
            )
            pending_window = None
            continue
        if op == "cep":
            if key_pos is None:
                raise RuntimeError(
                    "CEP.pattern requires a keyed stream: call key_by first"
                )
            from ..cep.nfa import compile_pattern
            from ..cep.pattern import make_select_adapter

            compiled = compile_pattern(node.params["pattern"])
            stateful = StatefulSpec(
                "cep",
                cep=compiled,
                allowed_lateness_ms=node.params.get("allowed_lateness_ms", 0),
                late_tag=node.params.get("late_tag"),
                timeout_tag=node.params.get("timeout_tag"),
            )
            sel_fn = node.params.get("select_fn")
            if sel_fn is not None:
                # the select adapter is the FIRST post op: user map/
                # filter tails see the selected record, not the raw
                # L*C flat match
                device_post.append(("map", make_select_adapter(compiled, sel_fn)))
            continue
        raise NotImplementedError(f"operator {op} not supported in this chain")

    # side outputs: ops between the side_output node and the sink
    side_outputs: List[SideOutputPlan] = []
    for s in side_sinks:
        chain = s.chain_to_source()
        idx = next(i for i, n in enumerate(chain) if n.op == "side_output")
        tag = chain[idx].params["tag"]
        ops = []
        for n in chain[idx + 1 :]:
            if n.op in ("map", "filter"):
                ops.append((n.op, n.params["fn"]))
            elif n.op.startswith("sink_"):
                pass
            else:
                raise NotImplementedError(
                    f"operator {n.op} not supported on a side-output stream"
                )
        side_outputs.append(SideOutputPlan(tag=tag, ops=ops, sink_node=s))

    if record_kinds is None:
        # no parse map at all: the stream stays raw strings end to end
        record_kinds = []
        tables = []

    return JobPlan(
        source=source,
        host_ops=host_ops,
        ts_assigner=ts_assigner,
        ts_expr=ts_expr,
        ts_delay_ms=ts_delay_ms,
        punctuated=punctuated,
        record_kinds=record_kinds,
        tables=tables,
        device_pre=device_pre,
        key_pos=key_pos,
        stateful=stateful,
        device_post=device_post,
        branches=branches,
        side_outputs=side_outputs,
        time_characteristic=env.time_characteristic,
        chain_rest=chain_rest,
        synthetic_key=synthetic_key,
        derived_key_fn=derived_key_fn,
        rules=getattr(broadcast, "rules", None),
        broadcast=broadcast,
    )


def build_plan_chain(env, sink_nodes: List[Node]) -> List[JobPlan]:
    """Plan a job that may re-key after a stateful operator: each
    ``key_by``-after-stateful starts a NEW stage whose input is the
    previous stage's compacted emissions (classic two-stage aggregation,
    e.g. per-channel windows then a cross-channel rollup). Sink fan-out
    attaches to the final stage; a stage's record schema resolves at
    runtime from its upstream program's output schema."""
    plans = [build_plan(env, sink_nodes)]
    while plans[-1].chain_rest:
        prev = plans[-1]
        plans.append(_plan_rest(env, prev.chain_rest))
        prev.chain_rest = []
    # watermark delay for chained event-time stages. Flink forwards
    # watermarks through operators, and a watermark arrives AFTER the
    # records preceding it — so a downstream window must never fire off
    # a record batch that is still being folded. Our chained stages
    # derive their watermark from DATA (max_ts - delay); with delay 0 a
    # window-fed stage would fire a window the instant a result at ts
    # end-1 folds, racing equal-ts results split across sub-batches
    # (observed drop: five same-ts fires split 4+1 over batch_size-4
    # sub-batches — the fifth arrived "late"). delay 1 closes the race:
    # a result at ts T cannot close a window ending T+1. Rolling stages
    # forward the ORIGINAL record timestamp, so the source assigner's
    # out-of-orderness bound still applies downstream.
    for up, down in zip(plans, plans[1:]):
        st = up.stateful
        if st is not None and st.kind in ("rolling", "rolling_reduce"):
            down.ts_delay_ms = max(1, up.ts_delay_ms)
        else:
            down.ts_delay_ms = 1
    if len(plans) > 1:
        # branches/sinks live on the LAST stage; intermediates feed the
        # chain glue in the executor. (Late side outputs stay on
        # plans[0]: they belong to stage 1's window and dispatch from
        # its runner.)
        plans[-1].branches = plans[0].branches
        plans[0].branches = []
    return plans


def _plan_rest(env, rest: List[Node]) -> JobPlan:
    """Plan a post-chain stage: input records arrive COLUMNAR from the
    upstream stage (record_kinds filled at runtime from its program's
    output schema), so there is no host parse stage, no timestamp
    assigner, and only device ops.

    NOTE: the operator dispatch here is a lean twin of build_plan's walk
    (minus the raw/host stage) — keep StatefulSpec construction and the
    ordering errors in lockstep with it."""
    device_pre: List[tuple] = []
    device_post: List[tuple] = []
    key_pos: Optional[int] = None
    stateful: Optional[StatefulSpec] = None
    pending_window: Optional[Node] = None
    chain_rest: List[Node] = []
    synthetic_key = False
    derived_key_fn = None

    for i, node in enumerate(rest):
        op = node.op
        if op in ("sink_print", "sink_collect", "sink_fn"):
            continue
        if op in ("map", "filter"):
            target = device_post if stateful is not None else device_pre
            target.append((op, node.params["fn"]))
            continue
        if op == "key_by":
            if stateful is not None:
                chain_rest = rest[i:]
                break
            if synthetic_key:
                # a later key_by supersedes the computed key (the
                # synthetic column is appended at runtime, so only the
                # flags reset here)
                synthetic_key = False
                derived_key_fn = None
            kind, val = classify_key_selector(node.params["key"])
            if kind == "pos":
                key_pos = val
            else:
                # computed KeySelector on a CHAIN stage: the chain glue
                # derives the key host-side from each hand-off batch
                # (the stage's schema resolves at runtime, so the
                # synthetic column appends in _make_runner_chain)
                if any(o == "map" for o, _ in device_pre):
                    raise NotImplementedError(
                        "a computed KeySelector must follow the re-key "
                        "hand-off directly (filters in between are "
                        "fine); add the derived field in the upstream "
                        "stage instead"
                    )
                derived_key_fn = val
                synthetic_key = True
                key_pos = -1
            continue
        if op == "rolling":
            if key_pos is None:
                raise RuntimeError("rolling aggregates require key_by")
            stateful = StatefulSpec(
                "rolling",
                rolling_kind=node.params["kind"],
                rolling_pos=node.params["pos"],
            )
            continue
        if op == "rolling_reduce":
            if key_pos is None:
                raise RuntimeError("reduce on a keyed stream requires key_by")
            stateful = StatefulSpec(
                "rolling_reduce", rolling_fn=node.params["fn"]
            )
            continue
        if op == "window":
            if key_pos is None:
                raise RuntimeError("windows require key_by")
            pending_window = node
            continue
        if op in ("window_reduce", "window_aggregate", "window_process"):
            assert pending_window is not None
            spec: WindowSpec = pending_window.params["spec"]
            stateful = StatefulSpec(
                "window",
                window=spec,
                apply_kind=op.removeprefix("window_"),
                apply_fn=node.params.get("fn"),
                allowed_lateness_ms=pending_window.params.get(
                    "allowed_lateness_ms", 0
                ),
                late_tag=pending_window.params.get("late_tag"),
            )
            pending_window = None
            continue
        if op == "cep":
            if key_pos is None:
                raise RuntimeError(
                    "CEP.pattern requires a keyed stream: call key_by first"
                )
            from ..cep.nfa import compile_pattern
            from ..cep.pattern import make_select_adapter

            compiled = compile_pattern(node.params["pattern"])
            stateful = StatefulSpec(
                "cep",
                cep=compiled,
                allowed_lateness_ms=node.params.get("allowed_lateness_ms", 0),
                late_tag=node.params.get("late_tag"),
                timeout_tag=node.params.get("timeout_tag"),
            )
            sel_fn = node.params.get("select_fn")
            if sel_fn is not None:
                device_post.append(("map", make_select_adapter(compiled, sel_fn)))
            continue
        raise NotImplementedError(
            f"operator {op} is not supported in a chained stage"
        )
    if key_pos is None or stateful is None:
        raise NotImplementedError(
            "a chained stage needs key_by followed by a stateful operator"
        )

    return JobPlan(
        source=None,
        host_ops=[],
        ts_assigner=None,
        ts_expr=None,
        ts_delay_ms=0,
        punctuated=False,
        record_kinds=[],     # filled from the upstream program's schema
        tables=[],
        device_pre=device_pre,
        key_pos=key_pos,
        stateful=stateful,
        device_post=device_post,
        branches=[],
        side_outputs=[],
        time_characteristic=env.time_characteristic,
        chain_rest=chain_rest,
        upstream_supplies_ts=True,
        synthetic_key=synthetic_key,
        derived_key_fn=derived_key_fn,
        # chained stages share stage 0's RuleSet: one control stream
        # parameterizes the whole chain at the same record boundary
        rules=getattr(getattr(env, "_broadcast", None), "rules", None),
    )
