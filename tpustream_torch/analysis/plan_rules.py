"""Plan-lint rules: a registry of checks over the constructed job graph.

Each rule is a function ``(ctx) -> iterable[Finding]`` registered with
``@rule``. Rules walk the raw ``Node`` chains (NOT the built JobPlan —
the planner raises on many of the hazards we want to *report*), plus the
StreamConfig, the broadcast RuleSet, and the tenancy template when
present. All checks are pure graph/config inspection: no trace, no
compile, no data.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

from ..api.output import OutputTag
from ..api.timeapi import TimeCharacteristic
from ..config import StreamConfig
from .findings import ERROR, INFO, WARN, Finding, make_finding


def process_count() -> int:
    """Processes of the job: ``torch.distributed``'s world size when a
    process group is up, else 1 (the reference's
    ``jax.process_count()`` on one host)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1

#: ops that allocate per-key device state
STATEFUL_OPS = ("rolling", "rolling_reduce", "window", "cep")

RULES: List[Callable] = []


def rule(fn: Callable) -> Callable:
    RULES.append(fn)
    return fn


class AnalysisContext:
    """Everything a rule may inspect, resolved once per analyze() call."""

    def __init__(self, env, sink_nodes=None):
        self.env = env
        self.cfg: StreamConfig = env.config
        self.sinks = list(sink_nodes if sink_nodes is not None else env._sinks)
        self.chains = [s.chain_to_source() for s in self.sinks]
        self.time_characteristic = getattr(
            env, "time_characteristic", TimeCharacteristic.ProcessingTime
        )
        self.broadcast = getattr(env, "_broadcast", None)
        self.rules_set = getattr(self.broadcast, "rules", None)
        self.tenancy = getattr(env, "_tenancy", None)

    # -- walk helpers --------------------------------------------------------
    def stateful_nodes(self):
        """(node, keyed, has_assigner) per stateful op, deduplicated
        across sink chains (branch fan-out shares prefixes)."""
        seen = set()
        out = []
        for chain in self.chains:
            keyed = False
            has_assigner = False
            stage_has_stateful = False
            for n in chain:
                if n.op == "assign_ts":
                    has_assigner = True
                elif n.op == "key_by":
                    if stage_has_stateful:
                        # re-key after a stateful op: a NEW chained stage
                        # whose event timestamps arrive with the upstream
                        # emissions (upstream_supplies_ts)
                        has_assigner = True
                        stage_has_stateful = False
                    keyed = True
                elif n.op in STATEFUL_OPS or n.op.startswith("window_"):
                    if n.op in STATEFUL_OPS and n.nid not in seen:
                        seen.add(n.nid)
                        out.append((n, keyed, has_assigner))
                    if n.op in STATEFUL_OPS:
                        stage_has_stateful = True
        return out

    def window_applies(self):
        """(window_node, apply_node) pairs, deduplicated."""
        seen = set()
        out = []
        for chain in self.chains:
            for parent, child in zip(chain, chain[1:]):
                if (
                    parent.op == "window"
                    and child.op.startswith("window_")
                    and child.nid not in seen
                ):
                    seen.add(child.nid)
                    out.append((parent, child))
        return out

    def nodes(self, *ops):
        """All nodes with the given op names, deduplicated by nid."""
        seen = set()
        out = []
        for chain in self.chains:
            for n in chain:
                if n.op in ops and n.nid not in seen:
                    seen.add(n.nid)
                    out.append(n)
        return out


# -- graph rules -------------------------------------------------------------

@rule
def check_keyed_state_without_key_by(ctx) -> Iterable[Finding]:
    """TSM001: rolling/window/CEP with no upstream key_by in its stage."""
    for node, keyed, _ in ctx.stateful_nodes():
        if not keyed:
            yield make_finding(
                "TSM001", node,
                f"stateful operator '{node.op}' has no upstream key_by: "
                "per-key state needs a key to route records by",
            )


def _event_time_domain(ctx, spec) -> bool:
    domain = getattr(spec, "time_domain", None)
    return domain == TimeCharacteristic.EventTime


@rule
def check_event_time_without_assigner(ctx) -> Iterable[Finding]:
    """TSM002: event-time windows / within()-bounded CEP with no
    timestamp assigner on the stage (chained stages get timestamps from
    the upstream emissions, so only stage-0 operators can trip this)."""
    for node, _, has_assigner in ctx.stateful_nodes():
        if has_assigner:
            continue
        if node.op == "window":
            spec = node.params.get("spec")
            if spec is not None and _event_time_domain(ctx, spec):
                yield make_finding(
                    "TSM002", node,
                    "event-time window has no timestamp assigner: with "
                    "no watermark source the window never fires",
                )
        elif node.op == "cep":
            pattern = node.params.get("pattern")
            within = getattr(pattern, "within_ms", None)
            if (
                within
                and ctx.time_characteristic == TimeCharacteristic.EventTime
            ):
                yield make_finding(
                    "TSM002", node,
                    "within()-bounded CEP pattern under EventTime has no "
                    "timestamp assigner: partials can never expire",
                )


@rule
def check_side_output_tag_collision(ctx) -> Iterable[Finding]:
    """TSM003: one OutputTag id emitted by more than one producer."""
    producers: dict = {}  # tag id -> {(nid, role): node}
    for chain in ctx.chains:
        for n in chain:
            roles = []
            if n.op == "window":
                tag = n.params.get("late_tag")
                if tag is not None:
                    roles.append((tag, "late_tag"))
            elif n.op == "cep":
                for key in ("late_tag", "timeout_tag"):
                    tag = n.params.get(key)
                    if tag is not None:
                        roles.append((tag, key))
            for tag, role in roles:
                producers.setdefault(tag.id, {})[(n.nid, role)] = n
    for tag_id, srcs in producers.items():
        if len(srcs) > 1:
            roles = ", ".join(
                sorted(f"{role}@{n!r}" for (_, role), n in srcs.items())
            )
            any_node = next(iter(srcs.values()))
            yield make_finding(
                "TSM003", any_node,
                f"OutputTag({tag_id!r}) is emitted by {len(srcs)} "
                f"producers ({roles}): their records would interleave "
                "on one side output",
            )


@rule
def check_lateness_misconfig(ctx) -> Iterable[Finding]:
    """TSM004: lateness/timeout settings that cannot take effect."""
    for node in ctx.nodes("window"):
        lateness = node.params.get("allowed_lateness_ms", 0)
        late_tag = node.params.get("late_tag")
        spec = node.params.get("spec")
        domain = getattr(spec, "time_domain", None)
        if lateness > 0 and domain == TimeCharacteristic.ProcessingTime:
            yield make_finding(
                "TSM004", node,
                f"allowed_lateness({lateness}ms) on a processing-time "
                "window: processing time has no late data, the bound "
                "never admits anything",
            )
        if lateness > 0 and late_tag is None and domain == TimeCharacteristic.EventTime:
            yield make_finding(
                "TSM004", node,
                f"allowed_lateness({lateness}ms) without "
                "side_output_late_data: records past the bound are "
                "silently dropped",
                severity=INFO,
            )
    for node in ctx.nodes("cep"):
        pattern = node.params.get("pattern")
        within = getattr(pattern, "within_ms", None)
        if node.params.get("timeout_tag") is not None and not within:
            yield make_finding(
                "TSM004", node,
                "CEP select(timeout_tag=...) without Pattern.within(): "
                "partials never time out, the side output stays empty",
            )


@rule
def check_nonreplayable_source_restart(ctx) -> Iterable[Finding]:
    """TSM005: restart strategy over a source that cannot replay."""
    if getattr(ctx.cfg, "restart_strategy", None) is None:
        return
    for node in ctx.nodes("source"):
        src = node.params.get("source")
        if src is not None and not getattr(src, "replayable", True):
            yield make_finding(
                "TSM005", node,
                f"restart strategy configured but source "
                f"{type(src).__name__} is not replayable: a restart "
                "cannot re-read lost records",
            )


@rule
def check_ingest_lane_misconfig(ctx) -> Iterable[Finding]:
    """TSM016: ingest_lanes settings the runtime would silently undo.

    Mirrors the runtime gates in runtime/ingest.py:build_ingest_plane —
    a non-splittable source or multi-host mesh forces lanes back to 1
    with only a flight breadcrumb; this rule surfaces the same facts
    before the job runs."""
    lanes = getattr(ctx.cfg, "ingest_lanes", 1)
    if lanes <= 1:
        return
    for node in ctx.nodes("source"):
        src = node.params.get("source")
        if src is not None and not getattr(src, "splittable", True):
            yield make_finding(
                "TSM016", node,
                f"ingest_lanes={lanes} but source {type(src).__name__} "
                "is not line-splittable: the runtime forces single-lane "
                "ingestion and the extra lanes never run",
            )
    # usable cores, not os.cpu_count(): a 96-core box under a 2-core
    # cgroup quota is a 2-core host (shared with the env fingerprint)
    from ..obs import resources as _res

    host_cores = _res.usable_cores()
    if lanes > host_cores:
        yield make_finding(
            "TSM016", None,
            f"ingest_lanes={lanes} exceeds this host's {host_cores} "
            "usable core(s) (scheduler affinity capped by the cgroup "
            "cpu quota): lane workers contend for cores instead of "
            "parallelising the parse",
            severity=WARN,
        )
    procs = process_count()
    if procs > 1:
        yield make_finding(
            "TSM016", None,
            f"ingest_lanes={lanes} under multi-host execution "
            f"({procs} processes): sharded ingestion is single-host "
            "only and will run with 1 lane",
            severity=INFO,
        )


@rule
def check_lane_supervision_misconfig(ctx) -> Iterable[Finding]:
    """TSM017: lane-supervision knobs that cannot deliver what they
    promise.

    In-place lane recovery itself needs no source cooperation (the
    producer retains raw frames until merged), but the ladder's last
    rung — StallWatchdog escalation to a supervised restart-with-cause
    (IngestStallError) — replays from a checkpoint, and a
    non-splittable source never engages the lanes at all (TSM016). So a
    restart budget over a non-splittable or non-replayable source is
    either dead config or a configured path to an unrecoverable
    failure. Separately, a heartbeat stall limit below ~2x the typical
    frame deadline (max_batch_delay_ms) reads healthy-but-slow lanes
    as hung and recovers them in a loop."""
    cfg = ctx.cfg
    lanes = getattr(cfg, "ingest_lanes", 1)
    if lanes <= 1:
        return
    restarts = getattr(cfg, "ingest_lane_restarts", 0)
    if restarts > 0:
        for node in ctx.nodes("source"):
            src = node.params.get("source")
            if src is None:
                continue
            splittable = getattr(src, "splittable", True)
            replayable = getattr(src, "replayable", True)
            if not splittable or not replayable:
                why = (
                    "is not line-splittable (the lanes never engage)"
                    if not splittable else
                    "is not replayable (a watchdog escalation has "
                    "nothing to replay)"
                )
                yield make_finding(
                    "TSM017", node,
                    f"ingest_lane_restarts={restarts} but source "
                    f"{type(src).__name__} {why}",
                )
    stall_ms = float(getattr(cfg, "ingest_lane_stall_limit_ms", 0.0))
    floor_ms = 2.0 * float(getattr(cfg, "max_batch_delay_ms", 0.0))
    if 0.0 < stall_ms < floor_ms:
        yield make_finding(
            "TSM017", None,
            f"ingest_lane_stall_limit_ms={stall_ms:g} is below 2x the "
            f"frame deadline (max_batch_delay_ms={floor_ms / 2.0:g}): "
            "healthy-but-slow lanes will be recovered in a loop",
            severity=WARN,
        )


@rule
def check_compaction_on_mesh(ctx) -> Iterable[Finding]:
    """TSM006: compaction_capacity on p>1 is silently ignored."""
    cfg = ctx.cfg
    if cfg.parallelism > 1 and cfg.compaction_capacity > 0:
        default = StreamConfig.__dataclass_fields__[
            "compaction_capacity"
        ].default
        explicit = cfg.compaction_capacity != default
        yield make_finding(
            "TSM006", None,
            f"compaction_capacity={cfg.compaction_capacity} with "
            f"parallelism={cfg.parallelism}: device output compaction is "
            "single-chip only and will be disabled on this mesh",
            severity=WARN if explicit else INFO,
        )


@rule
def check_rule_leaf_sharding(ctx) -> Iterable[Finding]:
    """TSM007: [T] tenant rule vectors on a p>1 mesh depend on the
    runtime forcing PartitionSpec() — surface the dependency."""
    rs = ctx.rules_set
    if rs is None or ctx.cfg.parallelism <= 1:
        return
    cap = getattr(rs, "tenant_capacity", 0)
    if cap:
        yield make_finding(
            "TSM007", None,
            f"RuleSet carries [{cap}] per-tenant vectors on a "
            f"p={ctx.cfg.parallelism} mesh: shape-based spec inference "
            "would shard them; the runtime pins rule leaves to "
            "PartitionSpec() (replicated) — this plan depends on that",
        )


# -- tenancy: static template verification -----------------------------------

def _norm_window_spec(spec) -> tuple:
    return (
        getattr(spec, "kind", repr(spec)),
        getattr(spec, "size_ms", 0),
        getattr(spec, "slide_ms", 0),
        getattr(spec, "gap_ms", 0),
        getattr(spec, "count", 0),
        getattr(spec, "count_slide", 0),
    )


def _norm_probe_sig(sig) -> list:
    """TenantPlan probe signature -> comparable canonical op list."""
    out = []
    for entry in sig:
        kind = entry[0]
        if kind == "time_window":
            size, slide = entry[1], entry[2]
            out.append((
                "window",
                ("tumbling" if slide is None else "sliding",
                 size, slide if slide is not None else size, 0, 0, 0),
            ))
        elif kind == "count_window":
            count, slide = entry[1], entry[2]
            out.append((
                "window",
                ("count", 0, 0, 0, count,
                 count if slide is None else slide),
            ))
        elif kind == "window":
            out.append(("window", _norm_window_spec(entry[1])))
        elif kind.startswith("window_"):
            out.append(("window_apply", kind.removeprefix("window_")))
        elif kind in ("allowed_lateness", "late_tag"):
            # order-insensitive window modifiers; folded below
            out.append((kind,) + tuple(entry[1:]))
        elif kind == "rolling":
            out.append(("rolling", entry[1], entry[2]))
        else:
            out.append(tuple(entry))
    return _fold_window_modifiers(out)


def _norm_node_chain(nodes) -> list:
    """Graph nodes -> the same canonical op list as _norm_probe_sig."""
    from ..runtime.plan import classify_key_selector

    out = []
    for n in nodes:
        op = n.op
        if op.startswith("sink_"):
            continue
        if op in ("map", "filter", "flat_map", "assign_ts"):
            out.append((op,))
        elif op == "key_by":
            try:
                kind, val = classify_key_selector(n.params["key"])
            except Exception:
                kind, val = "computed", None
            out.append(("key_by", val if kind == "pos" else "<computed>"))
        elif op == "rolling":
            out.append(("rolling", n.params["kind"], n.params["pos"]))
        elif op == "rolling_reduce":
            out.append(("rolling_reduce",))
        elif op == "window":
            out.append(("window", _norm_window_spec(n.params["spec"])))
            ms = n.params.get("allowed_lateness_ms", 0)
            if ms:
                out.append(("allowed_lateness", ms))
            if n.params.get("late_tag") is not None:
                out.append(("late_tag",))
        elif op.startswith("window_"):
            out.append(("window_apply", op.removeprefix("window_")))
        else:
            out.append((op,))
    return _fold_window_modifiers(out)


def _fold_window_modifiers(ops: list) -> list:
    """allowed_lateness/late_tag entries between a window and its apply
    are order-insensitive on the fluent surface: sort each run."""
    out = []
    i = 0
    while i < len(ops):
        out.append(ops[i])
        i += 1
        if out[-1][0] == "window":
            mods = []
            while i < len(ops) and ops[i][0] in ("allowed_lateness", "late_tag"):
                mods.append(ops[i])
                i += 1
            out.extend(sorted(mods))
    return out


@rule
def check_tenant_chain_matches_template(ctx) -> Iterable[Finding]:
    """TSM008: a JobServer-built env whose data chain drifted from the
    fleet's TenantPlan signature (one compiled program is shared — a
    drifted chain corrupts shared keyed state)."""
    server = ctx.tenancy
    if server is None:
        return
    plan = getattr(server, "plan", None)
    if plan is None:
        return
    try:
        template = _norm_probe_sig(plan.signature())
    except Exception:
        return
    for chain in ctx.chains:
        # JobServer.build_job shape: source -> [flat_map...] -> map(parse)
        # -> filter(gate) -> template ops -> sink. Template flat_map
        # lowers onto the raw stage BEFORE the lazily attached parse, so
        # any leading flat_map nodes belong to the template signature.
        if len(chain) < 4 or chain[0].op != "source":
            continue
        i = 1
        while i < len(chain) and chain[i].op == "flat_map":
            i += 1
        if i + 2 >= len(chain):
            continue
        if chain[i].op != "map" or chain[i + 1].op != "filter":
            continue
        actual = [("flat_map",)] * (i - 1) + _norm_node_chain(chain[i + 2:])
        if actual != template:
            yield make_finding(
                "TSM008", chain[3] if len(chain) > 3 else None,
                "multi-tenant job chain does not match the fleet "
                f"template signature:\n  template: {template}\n"
                f"  actual:   {actual}",
            )
        return  # one data chain per fleet env


# -- config-consistency rules ------------------------------------------------

@rule
def check_fetch_group_vs_async_depth(ctx) -> Iterable[Finding]:
    """TSM009: fetch_group past the in-flight window gets clamped."""
    cfg = ctx.cfg
    limit = max(1, cfg.async_depth - 1)
    if cfg.fetch_group > limit:
        yield make_finding(
            "TSM009", None,
            f"fetch_group={cfg.fetch_group} exceeds async_depth-1="
            f"{limit}: the effective group is clamped to {limit} (a "
            "full-window group would drain the pipeline every fetch)",
        )


@rule
def check_depth_forced_synchronous(ctx) -> Iterable[Finding]:
    """TSM010: configured overlap depths that this plan forces to 1."""
    cfg = ctx.cfg
    if cfg.async_depth <= 1 and cfg.h2d_depth <= 1:
        return
    reasons = []
    if cfg.max_fires_per_step is not None:
        reasons.append("max_fires_per_step paces the step loop")
    for _, apply_node in ctx.window_applies():
        if apply_node.op == "window_process":
            reasons.append(
                "full-window process() emissions reference live state"
            )
            break
    for reason in reasons:
        yield make_finding(
            "TSM010", None,
            f"async_depth={cfg.async_depth}/h2d_depth={cfg.h2d_depth} "
            f"configured, but {reason}: the runtime forces depth 1 for "
            "this plan",
        )


@rule
def check_adaptive_bounds(ctx) -> Iterable[Finding]:
    """TSM011: adaptive controller bounds that cannot work."""
    obs = ctx.cfg.obs
    if not getattr(obs, "adaptive", False):
        return
    if not obs.enabled:
        yield make_finding(
            "TSM011", None,
            "adaptive=True with obs.enabled=False: the controller reads "
            "the registry's rate history and never runs without obs",
            severity=WARN,
        )
    bounds = getattr(obs, "adaptive_bounds", None) or {}
    known = ("async_depth", "fetch_group", "h2d_depth")
    for knob, bound in bounds.items():
        try:
            lo, hi = bound
        except Exception:
            yield make_finding(
                "TSM011", None,
                f"adaptive_bounds[{knob!r}]={bound!r} is not a (lo, hi) "
                "pair",
            )
            continue
        if knob not in known:
            yield make_finding(
                "TSM011", None,
                f"adaptive_bounds names unknown knob {knob!r} (the knob "
                f"set is closed: {', '.join(known)}); it is silently "
                "ignored",
                severity=WARN,
            )
            continue
        if lo > hi or lo < 1:
            yield make_finding(
                "TSM011", None,
                f"adaptive_bounds[{knob!r}]=({lo}, {hi}) admits no legal "
                "value (need 1 <= lo <= hi)",
            )


@rule
def check_health_rule_series_exist(ctx) -> Iterable[Finding]:
    """TSM015: a HealthEngine rule (ObsConfig.health_rules) or a tenant
    SLO objective naming a series no instrument mints. The engine
    evaluates a missing series as "absent" forever, so the alert can
    never fire — a typo'd name fails silently at the worst time."""
    from ..obs.catalog import series_is_known
    from ..obs.health import as_rule

    specs = []
    for r in getattr(ctx.cfg.obs, "health_rules", ()) or ():
        try:
            specs.append(("ObsConfig.health_rules", as_rule(r)))
        except (TypeError, ValueError):
            continue
    server = ctx.tenancy
    if server is not None:
        from ..obs.slo import compile_tenant_slo

        for tenant, slo in getattr(server, "_slo", {}).items():
            try:
                for r in compile_tenant_slo(tenant, slo):
                    specs.append((f"TenantSLO({tenant!r})", r))
            except Exception:
                continue
    for origin, r in specs:
        name = r.series_name
        if not series_is_known(name):
            yield make_finding(
                "TSM015", None,
                f"{origin} rule {r.name!r} watches series {name!r}, "
                "which no instrument mints: it evaluates \"absent\" "
                "forever and the alert can never fire",
            )


@rule
def check_grouped_fetch_skew(ctx) -> Iterable[Finding]:
    """TSM012: fetch_group > 1 coarsens the step-latency series."""
    cfg = ctx.cfg
    eff = max(1, min(cfg.fetch_group, max(1, cfg.async_depth - 1)))
    if eff > 1 and cfg.obs.enabled:
        yield make_finding(
            "TSM012", None,
            f"fetch_group={eff} (effective): one grouped fetch's "
            "blocking wait is divided evenly over its steps, so "
            "step_times_s / step_ms_p90 report per-group averages "
            "(tails smoothed up to "
            f"{eff}x) — see docs/observability.md",
        )


@rule
def check_trace_sampling_carrier(ctx) -> Iterable[Finding]:
    """TSM018: record flight-path tracing configured without its
    marker carrier, or with a rate that is not a fraction in (0, 1].
    RecordTrace probes ride the latency-marker side-channel; without a
    stamper installed no trace is ever minted, silently."""
    obs = ctx.cfg.obs
    rate = getattr(obs, "trace_sample_rate", 0.0)
    if not rate:
        return
    if rate < 0 or rate > 1:
        yield make_finding(
            "TSM018", None,
            f"trace_sample_rate={rate} is outside (0, 1]; the stamper "
            "clamps it, which usually means a percent/fraction mixup "
            "(1% is 0.01, not 1)",
            severity=WARN,
        )
    if not obs.enabled or getattr(obs, "latency_marker_interval_ms", 0) <= 0:
        yield make_finding(
            "TSM018", None,
            f"trace_sample_rate={rate} with "
            f"obs.enabled={obs.enabled} and latency_marker_interval_ms="
            f"{getattr(obs, 'latency_marker_interval_ms', 0)}: record "
            "lineage rides the latency-marker side-channel, so no "
            "marker stamper means no trace is ever minted — "
            "/trace.json will carry no record lineage",
        )


@rule
def check_resource_sampling(ctx) -> Iterable[Finding]:
    """TSM019: resource-plane sampling that cannot run, or a lane
    sweep nothing can interpret.

    The ResourceSampler (obs/resources.py) only reads /proc at
    Snapshotter ticks, so ``resources=True`` with obs disabled or a
    zero snapshot interval is a dead sampler — every resource series
    stays empty while the config claims host telemetry is on (ERROR).
    The inverse shape is quieter but cost bench round r07 a day:
    multiple ingest lanes with no resource sampling means lane scaling
    (or inverse scaling) cannot be attributed to cores vs contention
    (INFO)."""
    obs = ctx.cfg.obs
    enabled = bool(getattr(obs, "resources", False))
    interval = float(getattr(obs, "snapshot_interval_s", 0.0) or 0.0)
    lanes = getattr(ctx.cfg, "ingest_lanes", 1)
    if enabled and (not obs.enabled or interval <= 0):
        yield make_finding(
            "TSM019", None,
            f"obs.resources=True with obs.enabled={obs.enabled} and "
            f"snapshot_interval_s={interval:g}: the resource sampler "
            "only runs at snapshot ticks, so no host/lane series is "
            "ever sampled (dead sampler)",
        )
    if lanes > 1 and not (enabled and obs.enabled):
        yield make_finding(
            "TSM019", None,
            f"ingest_lanes={lanes} with resource sampling off: without "
            "per-lane CPU/core series a lane sweep's scaling cannot be "
            "attributed to cores vs contention (set obs.resources=True)",
            severity=INFO,
        )


@rule
def check_ledger_config(ctx) -> Iterable[Finding]:
    """TSM051: conservation ledger configured so it cannot run, or so
    its digest anchors never land.

    The ledger's residuals are only evaluated at Snapshotter ticks, so
    an explicit ``obs.ledger=True`` with obs disabled or a zero
    snapshot interval is a dead ledger — every account is counted but
    conservation is never checked (ERROR). The quieter shape: an
    explicitly-enabled ledger with digests on but checkpointing off
    folds a sha256 per emitted row yet no (count, digest) anchor ever
    lands, so restores have nothing to verify against (WARN). Both
    arms require ``ledger is True``: the auto-on default (``None``
    with obs enabled) must not make every checkpoint-less job noisy.
    """
    obs = ctx.cfg.obs
    if getattr(obs, "ledger", None) is not True:
        return
    interval = float(getattr(obs, "snapshot_interval_s", 0.0) or 0.0)
    if not obs.enabled or interval <= 0:
        yield make_finding(
            "TSM051", None,
            f"obs.ledger=True with obs.enabled={obs.enabled} and "
            f"snapshot_interval_s={interval:g}: conservation residuals "
            "are only evaluated at snapshot ticks, so the ledger "
            "counts but never checks (dead ledger)",
        )
        return
    ck_on = bool(ctx.cfg.checkpoint_dir) and \
        ctx.cfg.checkpoint_interval_batches > 0
    if getattr(obs, "ledger_digests", True) and not ck_on:
        yield make_finding(
            "TSM051", None,
            "obs.ledger=True with ledger_digests on but checkpointing "
            f"disabled (checkpoint_dir={ctx.cfg.checkpoint_dir!r}, "
            f"interval={ctx.cfg.checkpoint_interval_batches}): digests "
            "are folded per emitted row yet no (count, digest) anchor "
            "ever lands in a checkpoint, so restores have nothing to "
            "verify against (set ledger_digests=False or enable "
            "checkpointing)",
            severity=WARN,
        )


@rule
def check_restore_drill_config(ctx) -> Iterable[Finding]:
    """TSM052: restore drill configured so it can never run, or so its
    verdict is invisible.

    The drill only arms when obs is on AND checkpointing writes
    snapshots (executor gates on both): a positive
    ``restore_drill_interval_s`` with either leg missing is a dead
    drill — the config claims continuous restore verification but no
    snapshot is ever exercised (ERROR). The quieter shape: a drill
    cadence faster than the obs snapshot interval, where verdict flips
    between scrapes never land in a snapshot (WARN).
    """
    cfg = ctx.cfg
    drill = float(getattr(cfg, "restore_drill_interval_s", 0.0) or 0.0)
    if drill <= 0:
        return
    obs = cfg.obs
    ck_on = bool(cfg.checkpoint_dir) and cfg.checkpoint_interval_batches > 0
    if not obs.enabled or not ck_on:
        yield make_finding(
            "TSM052", None,
            f"restore_drill_interval_s={drill:g} with "
            f"obs.enabled={obs.enabled} and checkpointing "
            f"{'on' if ck_on else 'off'} "
            f"(checkpoint_dir={cfg.checkpoint_dir!r}, "
            f"interval={cfg.checkpoint_interval_batches}): the drill "
            "dry-restores the newest snapshot and reports through obs "
            "health rules, so with either leg missing it never runs "
            "(dead drill)",
        )
        return
    snap = float(getattr(obs, "snapshot_interval_s", 0.0) or 0.0)
    if snap > 0 and drill < snap:
        yield make_finding(
            "TSM052", None,
            f"restore_drill_interval_s={drill:g} is shorter than "
            f"obs.snapshot_interval_s={snap:g}: drill verdicts can "
            "flip and flip back between obs snapshots, so a failed "
            "drill may never appear in a scrape (raise the drill "
            "interval to at least the snapshot interval)",
            severity=WARN,
        )


@rule
def check_checkpoint_retention_config(ctx) -> Iterable[Finding]:
    """TSM053: retention that can strand a recovery artifact.

    A savepoint requested before ``execute()`` with no
    ``checkpoint_dir`` has nowhere to land — the executor's savepoint
    block never consumes the request (ERROR). Retention below the
    async in-flight budget means pruning can outpace the writer:
    ``checkpoint_keep`` snapshots retained while up to
    ``checkpoint_async_inflight`` cuts are still being written leaves
    a window where a just-landed snapshot is pruned before it was ever
    the recovery floor (WARN). A requested ``checkpoint_keep < 1``
    is clamped at resolve time but signals a config that meant to
    disable retention and cannot (WARN).
    """
    cfg = ctx.cfg
    pending = list(getattr(ctx.env, "_savepoint_requests", ()) or ())
    if pending and not cfg.checkpoint_dir:
        tags = ", ".join(repr(t) for t in pending[:4])
        yield make_finding(
            "TSM053", None,
            f"{len(pending)} savepoint request(s) pending ({tags}) "
            "with checkpoint_dir unset: the executor writes savepoints "
            "next to the job's checkpoints, so the request can never "
            "be consumed (set checkpoint_dir before execute())",
        )
    keep = int(getattr(cfg, "checkpoint_keep", 3))
    if keep < 1:
        yield make_finding(
            "TSM053", None,
            f"checkpoint_keep={keep} requested: retention clamps to 1 "
            "at resolve time (the newest snapshot is the recovery "
            "floor) — retention cannot be disabled, only widened",
            severity=WARN,
        )
        keep = 1
    inflight = int(getattr(cfg, "checkpoint_async_inflight", 1) or 1)
    if (
        bool(cfg.checkpoint_dir)
        and getattr(cfg, "checkpoint_async", True)
        and inflight > keep
    ):
        yield make_finding(
            "TSM053", None,
            f"checkpoint_keep={keep} < checkpoint_async_inflight="
            f"{inflight}: with more cuts in flight than snapshots "
            "retained, pruning can delete a snapshot the moment it "
            "lands — raise checkpoint_keep to at least the in-flight "
            "budget",
            severity=WARN,
        )


@rule
def check_unproduced_side_output(ctx) -> Iterable[Finding]:
    """TSM013: get_side_output(tag) where the parent never emits tag."""
    for chain in ctx.chains:
        for n in chain:
            if n.op != "side_output":
                continue
            tag: OutputTag = n.params["tag"]
            produced = []
            for up in n.chain_to_source()[:-1]:
                if up.op == "window":
                    produced.append(up.params.get("late_tag"))
                elif up.op == "cep":
                    produced.append(up.params.get("late_tag"))
                    produced.append(up.params.get("timeout_tag"))
            if not any(t is not None and t.id == tag.id for t in produced):
                yield make_finding(
                    "TSM013", n,
                    f"get_side_output(OutputTag({tag.id!r})) but no "
                    "upstream window/CEP operator declares that tag: "
                    "the stream is empty forever",
                )


@rule
def check_plan_builds(ctx) -> Iterable[Finding]:
    """TSM014: the planner itself rejects the graph. Runs LAST so the
    targeted rules above get first say; skipped when a targeted rule
    already explains the failure."""
    from ..runtime.plan import build_plan_chain

    try:
        build_plan_chain(ctx.env, ctx.sinks)
    except (RuntimeError, NotImplementedError, AssertionError) as e:
        yield make_finding("TSM014", None, f"planner: {e}")


def run_plan_rules(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for fn in RULES:
        findings.extend(fn(ctx))
    # TSM014 is a catch-all: drop it when a targeted ERROR already
    # explains why the graph cannot plan
    targeted = [f for f in findings if f.severity == ERROR and f.code != "TSM014"]
    if targeted:
        findings = [f for f in findings if f.code != "TSM014"]
    return findings
