"""Typed findings for the pre-flight plan analyzer.

A finding is a static diagnosis of a constructed job graph, produced
BEFORE any step program is built: a stable ``TSM0xx`` code, a severity, the node it
anchors to, and a fix hint. The catalog below is the single source of
truth for codes — docs/analysis.md renders from the same entries, and
tests assert codes, not message text.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

ERROR = "error"
WARN = "warn"
INFO = "info"

#: ordering for "worst finding" comparisons
_SEVERITY_RANK = {ERROR: 2, WARN: 1, INFO: 0}


@dataclass(frozen=True)
class Finding:
    code: str                    # stable TSM0xx identifier
    severity: str                # ERROR | WARN | INFO
    node: Optional[Any]          # the graph Node (or None for config findings)
    message: str
    fix_hint: str = ""

    def __str__(self) -> str:  # CLI / log line form
        where = f" at {self.node!r}" if self.node is not None else ""
        hint = f" [fix: {self.fix_hint}]" if self.fix_hint else ""
        return f"{self.code} {self.severity.upper()}{where}: {self.message}{hint}"


class PlanAnalysisError(RuntimeError):
    """Raised pre-compile under ``StreamConfig.strict_analysis`` when the
    analyzer reports any ERROR finding. Carries the full finding list."""

    def __init__(self, findings: List[Finding]):
        self.findings = list(findings)
        errors = [f for f in self.findings if f.severity == ERROR]
        lines = "\n".join(f"  {f}" for f in errors)
        super().__init__(
            f"plan analysis found {len(errors)} error finding(s) "
            f"(strict_analysis=True blocks compilation):\n{lines}"
        )


def severity_rank(sev: str) -> int:
    return _SEVERITY_RANK.get(sev, -1)


def worst_severity(findings) -> Optional[str]:
    worst = None
    for f in findings:
        if worst is None or severity_rank(f.severity) > severity_rank(worst):
            worst = f.severity
    return worst


def has_errors(findings) -> bool:
    return any(f.severity == ERROR for f in findings)


@dataclass(frozen=True)
class Rule:
    """Catalog entry: one stable code with its default severity and the
    invariant it guards (docs/analysis.md is generated from these)."""

    code: str
    severity: str
    title: str
    rationale: str
    fix_hint: str


#: the full rule catalog, keyed by code. Codes are append-only: a rule
#: that stops firing keeps its number (like E999 in linters), so saved
#: baselines and suppression lists stay meaningful across versions.
CATALOG = {
    r.code: r
    for r in [
        Rule(
            "TSM001", ERROR, "keyed-state operator without key_by",
            "rolling aggregates, windows, and CEP allocate per-key HBM "
            "state; without an upstream key_by there is no key to route "
            "records by and planning fails at trace time.",
            "insert .key_by(field) before the stateful operator",
        ),
        Rule(
            "TSM002", ERROR, "event-time operator without a timestamp assigner",
            "an event-time window or within()-bounded CEP pattern never "
            "fires if no operator assigns event timestamps and watermarks "
            "(records carry ts=0, the watermark never advances).",
            "call assign_timestamps_and_watermarks(...) before the first "
            "parse map, or switch to ProcessingTime",
        ),
        Rule(
            "TSM003", ERROR, "side-output tag collision",
            "two different producers emit under one OutputTag id; "
            "get_side_output would silently interleave late data with "
            "CEP timeouts (or another stream's records).",
            "give each side output a distinct OutputTag id",
        ),
        Rule(
            "TSM004", WARN, "lateness / within() misconfiguration",
            "allowed_lateness under ProcessingTime never admits a late "
            "record (processing time has no late data); a CEP timeout_tag "
            "without within() never receives a timeout; lateness without "
            "a late tag silently drops post-fire records.",
            "match the lateness/timeout configuration to the time domain "
            "and pattern bounds",
        ),
        Rule(
            "TSM005", ERROR, "non-replayable source under a restart strategy",
            "supervised restarts resume by replaying the source from the "
            "last checkpoint; a socket or one-shot iterator source cannot "
            "seek back, so recovery would silently lose records.",
            "use a replayable source (from_collection / ReplaySource) or "
            "drop the restart strategy",
        ),
        Rule(
            "TSM006", WARN, "output compaction requested on a multi-chip mesh",
            "compaction_capacity only compiles a compaction stage on a "
            "single chip: the sharded compact gather's per-step all-gather "
            "rendezvous dwarfs the fetch saving, so the runtime keeps the "
            "full fetch path and the knob silently does nothing.",
            "leave compaction_capacity at default on p>1 meshes, or run "
            "single-chip for wire-bound jobs",
        ),
        Rule(
            "TSM007", INFO, "rule leaves rely on forced replication",
            "[T] per-tenant rule vectors have ndim 1; shape-based spec "
            "inference would shard them across the mesh and a per-record "
            "gather would read another shard's slice. The runtime pins "
            "rule leaves to PartitionSpec() — this finding documents that "
            "the plan depends on that forced replication.",
            "keep rule leaves replicated; do not add rule leaves to "
            "sharded state specs",
        ),
        Rule(
            "TSM008", ERROR, "tenant chain diverges from the fleet template",
            "a multi-tenant job's operator chain must match its "
            "TenantPlan signature exactly — the fleet shares ONE compiled "
            "program, and a drifted chain corrupts shared keyed state.",
            "rebuild the job through JobServer.build_job / TenantPlan."
            "verify, changing only rule parameters per tenant",
        ),
        Rule(
            "TSM009", WARN, "fetch_group exceeds the in-flight window",
            "a fetch group equal to the full async_depth window drains "
            "the pipeline empty on every grouped fetch, serializing "
            "dispatch against the round trip it was meant to amortize; "
            "the executor clamps the effective group to async_depth - 1.",
            "raise async_depth alongside fetch_group (the effective "
            "group is clamped to async_depth - 1)",
        ),
        Rule(
            "TSM010", INFO, "pipeline depth forced synchronous",
            "full-window process() emissions reference live device state "
            "and max_fires_per_step paces the step loop — either forces "
            "async_depth/h2d_depth to 1, so configured depths above 1 "
            "buy nothing for this plan.",
            "expect synchronous stepping, or restructure the window apply "
            "as reduce/aggregate to regain overlap",
        ),
        Rule(
            "TSM011", ERROR, "adaptive controller misconfiguration",
            "an adaptive_bounds entry with lo > hi (or lo < 1) can never "
            "admit a legal knob value; unknown knob names are silently "
            "ignored; the controller needs live obs to read rate history.",
            "fix the (lo, hi) bounds, name only async_depth/fetch_group/"
            "h2d_depth, and enable obs when adaptive=True",
        ),
        Rule(
            "TSM012", INFO, "grouped fetch coarsens step_ms_p90",
            "with fetch_group > 1 the blocking wait of one grouped fetch "
            "is divided evenly over its G steps, so step_times_s (and the "
            "step_ms_p90 summary) report per-group averages, not true "
            "per-step latencies — tails are smoothed by up to G×.",
            "interpret step_ms_p90 as a per-group average, or set "
            "fetch_group=1 when profiling per-step tails",
        ),
        Rule(
            "TSM013", ERROR, "side output reads a tag its stream never emits",
            "get_side_output(tag) on an operator whose window/CEP "
            "declares no matching late_tag/timeout_tag yields a stream "
            "that is silently empty forever.",
            "pass the tag to side_output_late_data(...) / select("
            "timeout_tag=...) on the producing operator",
        ),
        Rule(
            "TSM014", ERROR, "graph does not plan",
            "the planner rejects this operator chain outright (the "
            "attached message is the planner's own diagnosis).",
            "restructure the chain per the planner message",
        ),
        Rule(
            "TSM015", WARN, "health rule references a series no instrument mints",
            "HealthEngine rules and TenantSLO objectives name their "
            "series as strings; a typo'd or stale name evaluates "
            "\"absent\" forever, so the alert can never fire and the "
            "error budget never burns — silently.",
            "name a series from the catalog (tpustream_torch/obs/catalog.py, "
            "docs/observability.md); check for renames after upgrades",
        ),
        Rule(
            "TSM016", ERROR, "ingest_lanes misconfigured for this job",
            "sharded host ingestion (StreamConfig.ingest_lanes > 1) "
            "splits source frames across worker processes; a source "
            "that cannot be split by line framing would be silently "
            "forced back to one lane at runtime, lanes beyond the "
            "host's core count contend instead of parallelise, and "
            "multi-host execution always runs single-lane.",
            "use a line-splittable source (SocketTextSource needs "
            "raw=True), keep ingest_lanes <= host cores, or drop the "
            "knob back to 1",
        ),
        Rule(
            "TSM017", ERROR, "lane supervision misconfigured for this job",
            "the self-healing ingest plane (ingest_lane_restarts, "
            "ingest_lane_stall_limit_ms) recovers dead lane workers in "
            "place, but its escalation ladder ends at the supervisor: a "
            "wedged plane raises IngestStallError, and restarting from "
            "that needs a splittable, replayable source — otherwise the "
            "lanes never engage or the escalation kills the job with "
            "nothing to replay. A stall limit below ~2x the frame "
            "deadline recovers healthy-but-slow lanes in a loop.",
            "use a splittable, replayable source with lane restarts, "
            "or raise ingest_lane_stall_limit_ms comfortably above "
            "2x max_batch_delay_ms (0 disables heartbeat detection)",
        ),
        Rule(
            "TSM018", ERROR, "trace sampling has no marker carrier",
            "record flight-path tracing (ObsConfig.trace_sample_rate) "
            "promotes sampled records to RecordTrace probes that ride "
            "the latency-marker side-channel; with obs disabled or "
            "latency_marker_interval_ms == 0 the stamper is never "
            "installed, so no trace is ever minted and /trace.json "
            "silently carries no record lineage. A rate outside (0, 1] "
            "is clamped, which usually means a percent/fraction mixup.",
            "set ObsConfig.enabled = True and "
            "latency_marker_interval_ms > 0 alongside trace_sample_rate, "
            "and keep the rate in (0, 1] (e.g. 0.01 for 1%)",
        ),
        Rule(
            "TSM019", ERROR, "resource sampling misconfigured for this job",
            "the obs resource plane (ObsConfig.resources) reads /proc "
            "only at Snapshotter ticks: with obs disabled or "
            "snapshot_interval_s == 0 the sampler never runs and every "
            "host/lane series stays empty while the config claims host "
            "telemetry is on. Conversely, a multi-lane ingest job with "
            "resource sampling off cannot attribute its lane scaling — "
            "bench round r07's inverse scaling (more lanes, less "
            "throughput, one usable core) was only diagnosable by hand.",
            "set ObsConfig.enabled = True and snapshot_interval_s > 0 "
            "alongside resources = True; turn resources on whenever "
            "ingest_lanes > 1",
        ),
        Rule(
            "TSM020", WARN, "nondeterministic call in a user function",
            "time/random/datetime/uuid calls make replay diverge: a "
            "supervised restart reprocesses records from the last "
            "checkpoint and would compute different values the second "
            "time, breaking exactly-once output.",
            "derive values from record fields and event time; pass seeds "
            "or clocks in as data",
        ),
        Rule(
            "TSM021", WARN, "user function captures mutable state",
            "a closure over a list/dict/set (or a global/nonlocal write) "
            "is traced ONCE and vmapped — per-record mutation silently "
            "does not happen per record, and restarts reset it.",
            "move evolving values into keyed state (reduce/aggregate) or "
            "broadcast rules",
        ),
        Rule(
            "TSM022", WARN, "Python side effect in a device function",
            "print/open/logging inside a traced map/filter/predicate "
            "runs at TRACE time only (once), not per record — the "
            "side effect will appear to fire exactly once and never again.",
            "side-effect in a sink or host stage; use debug breadcrumbs "
            "via the obs layer",
        ),
        Rule(
            "TSM023", ERROR, "host callback inside a device function",
            "jax host callbacks (pure_callback/io_callback/debug.*) "
            "inside the fused step program stall the device on a host "
            "round trip per batch and break the multi-chip collective "
            "schedule.",
            "do host work in the host parse stage or a sink, not inside "
            "device maps/filters/predicates",
        ),
        Rule(
            "TSM024", WARN, "user function widens the value dtype",
            "a map returning a wider float than value_dtype re-traces "
            "the step program with new avals — one recompile, plus "
            "doubled wire bytes for every downstream column.",
            "cast back to the configured value_dtype inside the map, or "
            "widen value_dtype deliberately",
        ),
        Rule(
            "TSM025", INFO, "user-function source unavailable — purity checks skipped",
            "inspect.getsource fails for REPL lambdas, C extensions and "
            "exec'd callables, so the AST purity rules (TSM020–TSM024) "
            "silently skip them; the function may hide nondeterminism or "
            "side effects the analyzer cannot see.",
            "define user functions in importable .py modules so their "
            "source is lintable",
        ),
        Rule(
            "TSM030", WARN, "keyed state routed by a float key column",
            "key_by on an f64 column makes floating-point equality the "
            "key identity; the packed-wire f32 demotion and the lane "
            "transport both narrow f64 values when they round-trip, so "
            "the 'same' key can hash to different state rows depending "
            "on which side of the wire interned it, and NaN keys never "
            "equal themselves.",
            "key by a string or integer field; quantize float keys into "
            "an int (e.g. int(v * 1000)) inside the parse map",
        ),
        Rule(
            "TSM031", ERROR, "reduce/aggregate output schema drifts from its input",
            "a window or rolling reduce must be (T, T) -> T: its output "
            "feeds back as the next accumulator AND flows to the sink, "
            "so an output whose arity or field kinds differ from the "
            "input stream corrupts keyed state on the second fold (or "
            "fails the trace mid-compile).",
            "return a record with the same arity and field kinds as the "
            "reduce inputs",
        ),
        Rule(
            "TSM032", ERROR, "fleet job schema diverges from its TenantPlan template",
            "every tenant job in a fleet shares ONE compiled program and "
            "one keyed-state block; a job whose parse map infers a "
            "different record schema (arity or field kinds) than the "
            "template's would interleave mis-typed columns into shared "
            "state rows.",
            "build fleet jobs only through JobServer.build_job so every "
            "tenant reuses the template's parse map",
        ),
        Rule(
            "TSM033", INFO, "wide columns the wire demotion chains can never narrow",
            "the packed-wire i64 chain (d16/d32 deltas) only exists when "
            "h2d_compress is on — with h2d_compress=False every i64 "
            "column ships raw int64 no matter what packed_wire says, so "
            "the knob silently buys nothing for those columns (8 bytes/"
            "row each, every batch).",
            "re-enable h2d_compress alongside packed_wire, or accept "
            "raw int64 transfers for the listed columns",
        ),
        Rule(
            "TSM034", WARN, "producers of one side-output tag disagree on schema",
            "two streams emitting under the same OutputTag id hand "
            "get_side_output consumers records of different shapes — a "
            "late-data tag carries the window's input records while a "
            "CEP timeout tag carries (n_matched, start_ts, captures...), "
            "so a consumer written for one schema misreads the other.",
            "give each side output a distinct OutputTag id (TSM003) so "
            "each consumer sees one schema",
        ),
        Rule(
            "TSM040", ERROR, "checkpoint is missing expected state leaves",
            "the snapshot holds fewer state arrays than the program "
            "chain's init-state tree — an operator, rule leaf, or chain "
            "stage was added since the snapshot; restore_state would "
            "fail with a leaf-count mismatch mid-restore.",
            "restart from the source (or an older build) instead of "
            "resuming; the snapshot predates the current job graph",
        ),
        Rule(
            "TSM041", ERROR, "checkpoint carries unexpected extra state leaves",
            "the snapshot holds more state arrays than the program "
            "chain expects — an operator, rule leaf, or chain stage was "
            "removed since the snapshot; restore would fail rather than "
            "silently drop the orphaned state.",
            "restart from the source, or re-add the removed operator/"
            "rules before resuming",
        ),
        Rule(
            "TSM042", ERROR, "checkpoint leaf dtype differs from program state",
            "a state leaf was saved with a different dtype than the "
            "freshly built program allocates (value_dtype / acc_dtype / "
            "ts_dtype changed); restore_state rejects the leaf rather "
            "than silently reinterpreting its bytes.",
            "restore under the config the snapshot was written with, or "
            "restart from the source",
        ),
        Rule(
            "TSM043", ERROR, "checkpoint leaf shape incompatible with program state",
            "a state leaf's shape does not match the program's init "
            "state and is not a growable key-sharded prefix — "
            "batch_size, window, alert_capacity, or a shrunk "
            "key_capacity changed since the snapshot.",
            "restore under the snapshot's config; key_capacity may only "
            "grow across a restore, never shrink",
        ),
        Rule(
            "TSM044", ERROR, "tenant capacity mismatch between snapshot and fleet",
            "the snapshot's tenancy block was written at a different "
            "slot capacity than the fleet is configured for — per-tenant "
            "[T] rule vectors and the tenant→slot map would mis-index "
            "every tenant past the smaller capacity.",
            "restore with tenant_capacity >= the snapshot's capacity "
            "(fleet capacity only grows)",
        ),
        Rule(
            "TSM045", ERROR, "checkpoint format version gap",
            "the snapshot was written by a different tpustream format "
            "version; the migration table (runtime/checkpoint.py) lists "
            "what changed in between — restore would reject it outright, "
            "and latest_checkpoint skips it.",
            "restart from the source, or replay the snapshot under the "
            "build that wrote it",
        ),
        Rule(
            "TSM046", ERROR, "checkpoint unreadable or not a snapshot",
            "the file is not a loadable .npz with tpustream metadata — "
            "a partial write, a foreign file, or a truncated payload; "
            "latest_checkpoint skips such files automatically.",
            "delete the file (the next valid snapshot is used instead) "
            "or restore a copy from backup",
        ),
        Rule(
            "TSM047", INFO, "snapshot parallelism differs — restore will rescale",
            "the snapshot was written at a different mesh parallelism; "
            "restore permutes every key-sharded leaf through the "
            "canonical key-major order onto the new layout (a supported, "
            "lossless rescale — this finding just documents the work).",
            "none required; pin parallelism across restarts to skip the "
            "rescale permutation",
        ),
        Rule(
            "TSM051", ERROR, "conservation ledger configured but cannot run",
            "obs.ledger=True with observability off (or a zero snapshot "
            "interval) is a dead ledger: the accounts live on the "
            "metrics registry and residuals are only evaluated at "
            "snapshot ticks, so conservation is never checked while the "
            "config claims it is. The WARN shape: an explicitly-enabled "
            "ledger with digest anchoring on but checkpointing off — "
            "digests are computed per row yet no (count, digest) anchor "
            "ever lands in a snapshot, so restores have nothing to "
            "verify against.",
            "enable obs with snapshot_interval_s > 0 (or drop "
            "obs.ledger=True); for anchored digests also set "
            "checkpoint_dir + checkpoint_interval",
        ),
        Rule(
            "TSM052", ERROR, "restore drill configured but can never run",
            "restore_drill_interval_s > 0 with observability off or "
            "checkpointing off is a dead drill: the drill re-validates "
            "the newest snapshot at the batch boundary and reports "
            "through obs metrics/health rules, so with either leg "
            "missing no checkpoint is ever exercised while the config "
            "claims continuous restore verification. The WARN shape: a "
            "drill interval shorter than the obs snapshot interval — "
            "verdict flips between scrapes are invisible at that "
            "cadence.",
            "enable obs and checkpointing (checkpoint_dir + "
            "checkpoint_interval_batches) or set "
            "restore_drill_interval_s=0; keep the drill interval >= "
            "obs.snapshot_interval_s",
        ),
        Rule(
            "TSM053", ERROR, "checkpoint retention can strand recovery artifacts",
            "a savepoint was requested with no checkpoint_dir (the "
            "write has nowhere to land, savepoint() raises at the "
            "batch boundary), or retention is configured below the "
            "async in-flight budget — pruning can reach a snapshot the "
            "writer has not finished anchoring, so the retained window "
            "under-covers the in-flight cuts.",
            "set checkpoint_dir before requesting savepoints; keep "
            "checkpoint_keep >= checkpoint_async_inflight",
        ),
    ]
}


def make_finding(code: str, node=None, message: str = "",
                 severity: Optional[str] = None) -> Finding:
    """A Finding for a cataloged code; message defaults to the catalog
    title, severity to the catalog severity (rules may override, e.g.
    TSM006 downgrades to INFO at the default capacity)."""
    rule = CATALOG[code]
    return Finding(
        code=code,
        severity=severity or rule.severity,
        node=node,
        message=message or rule.title,
        fix_hint=rule.fix_hint,
    )
