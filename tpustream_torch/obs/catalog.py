"""The series-name catalog: every metric series the runtime can mint.

Counterpart of tpustream/obs/catalog.py (the port's own copy).

HealthEngine rules and TenantSLO objectives reference series by NAME
(``AlertRule.metric = "series[:field]"``); a typo there is silent — the
rule evaluates "absent" forever and the alert can never fire. The
pre-flight analyzer (TSM015, tpustream/analysis/plan_rules.py) checks
every configured rule against this catalog BEFORE the job runs.

Two tiers:

* ``KNOWN_SERIES`` — statically named instruments, collected from the
  runtime/obs/tenancy modules;
* ``KNOWN_PATTERNS`` — families minted with computed names (per-sink
  latency histograms, operator-scoped instruments, per-state-component
  gauges, controller knob gauges).

Keep this file in sync when adding an instrument: the TSM015 tests
(tests/test_analysis.py) pin a sample of both tiers.
"""

from __future__ import annotations

import re
from typing import Iterable

#: statically named series, by minting layer
KNOWN_SERIES = frozenset({
    # runtime executor / step loop
    "records_in", "rows", "step_time_s", "host_time_s", "emit_latency_s",
    "e2e_latency_ms", "fetch_bytes_total", "h2d_bytes_total",
    "pipeline_occupancy", "parse_ahead_queue_depth", "source_queue_depth",
    "chain_buffer_entries", "exchange_buffer_bytes", "exchange_capacity_rows",
    "compaction_ratio", "compaction_spills", "latency_markers_emitted",
    # sharded ingestion (runtime/ingest.py), lane-labelled
    "ingest_lane_records_total", "ingest_ring_occupancy",
    "ingest_lane_stall_ms",
    # lane supervision / self-healing (runtime/ingest.py), lane-labelled
    "ingest_lane_restarts_total", "ingest_lane_folded",
    "ingest_heartbeat_age_ms",
    # compile registry
    "compile_count", "recompile_count", "compile_wall_ms",
    "compile_flops", "compile_bytes_accessed", "compile_instrument_fallback",
    "operator_recompile_cause",
    # operator scope (static members of the operator_ family)
    "operator_records_in", "operator_records_emitted", "operator_steps",
    "operator_inflight_steps",
    # keyed state / memory tracker
    "hbm_state_bytes", "key_cardinality", "key_updates", "key_table_capacity",
    "key_table_occupancy", "key_table_load_factor", "hot_key_id",
    "hot_key_share", "window_fires",
    # event time
    "watermark_ms", "watermark_lag", "watermark_lag_ms",
    # CEP
    "cep_matches", "cep_timeouts",
    # broadcast rules
    "rule_version", "rule_updates_total", "rule_update_propagation_ms",
    # checkpoint / recovery
    "checkpoint_bytes", "checkpoint_save_ms", "recovery_wall_ms",
    "recovery_replay_batches", "job_restarts_total",
    # checkpoint plane: async writer + incremental format + drills
    "checkpoint_capture_ms", "checkpoint_write_wall_ms",
    "checkpoint_bytes_delta", "checkpoint_chunks_reused_total",
    "checkpoint_gc_deleted_total", "checkpoint_async_inflight",
    "restore_drill_ms", "restore_drill_verdict",
    "restore_drill_failures_total",
    # health / SLO engine
    "health_rule_state", "slo_budget_burn",
    # adaptive controller
    "controller_decisions_total", "controller_reverts_total",
    "controller_objective_rows_per_s", "controller_p99_ms",
    # continuous profiler
    "profile_stage_ms", "profile_stage_share", "profile_occupancy",
    "profile_binding_stage", "profile_spans_dropped",
    # record flight-path tracing (obs/tracing_export.py)
    "trace_spans_dropped_total", "record_traces_sampled_total",
    # analyzer
    "analysis_findings_total",
    # conservation ledger (obs/ledger.py), residuals edge-labelled; the
    # unified sink-emit family operator_sink_emitted{sink=...} (twin of
    # the legacy operator_sink{i}_emitted spellings) rides the
    # operator_ pattern below
    "ledger_conservation_residual", "ledger_violations_total",
    # resource plane (obs/resources.py), sampled at snapshot ticks
    "host_cpu_util", "lane_cpu_util", "lane_core", "process_rss_bytes",
    "ctx_switches_total", "lane_core_contention_total",
    # multi-tenant fleet (docs/multitenancy.md)
    "tenant_count", "tenant_records_total", "tenant_quota_exceeded_total",
    "tenant_emitted_total", "tenant_dead_letter_total", "tenant_error_rate",
    "tenant_step_share", "tenant_state_keys", "tenant_hbm_state_bytes",
    "tenant_rule_version", "tenant_e2e_latency_ms",
})

#: computed-name families (regex, fully anchored)
KNOWN_PATTERNS = tuple(re.compile(p) for p in (
    r"sink\d+_emitted",          # per-sink emit counters
    r"sink\d+_retries",
    r"sink\d+_e2e_latency_ms",   # per-sink latency edge histograms
    r"side_sink.+_emitted",      # side-output sinks, keyed by tag id
    r"operator_[a-z0-9_]+",      # operator-scoped instruments
    r"state_[a-z0-9_]+",         # per-state-component HBM gauges
    r"controller_[a-z0-9_]+",    # one gauge per adaptive knob
))


def series_is_known(name: str) -> bool:
    """True when ``name`` is a series some instrument can mint."""
    if name in KNOWN_SERIES:
        return True
    return any(p.fullmatch(name) for p in KNOWN_PATTERNS)


def unknown_series(names: Iterable[str]) -> list:
    """The subset of ``names`` no instrument mints, input order kept."""
    return [n for n in names if not series_is_known(n)]
