"""Supervised execution: Flink 1.8 restart strategies + crash recovery.

Counterpart of tpustream/runtime/supervisor.py. The reference tutorial
ends on "TaskManager crashes mid-window?" (chapter3/README.md:454-456);
Flink 1.8 answers with restart strategies (fixed-delay / failure-rate /
no-restart) that resume the job from the latest completed checkpoint.
:func:`supervise` wraps one execution attempt in a retry loop that

* catches any job failure (step, source, sink, checkpoint writer —
  whatever surfaced), consults the configured :class:`RestartStrategy`,
* picks the newest VALID checkpoint (``latest_checkpoint`` skips
  partial/corrupt/version-incompatible files), rebuilds the whole
  runner chain, and resumes exactly-once from it — a recovered run's
  sink output is byte-identical to an uninterrupted run (the executor
  rolls collect-sink/dead-letter output back to the snapshot's counts
  before replaying),
* keeps recovery observable: ``job_restarts_total`` per-cause counters
  and cumulative ``recovery_replay_batches`` re-seed each attempt's
  fresh registry, one flight-recorder ring spans every attempt
  (``job_failed`` -> ``job_restarting`` -> ``job_restored``), and a
  built-in WARN health rule trips once the job has restarted at all.

Restart requires a replayable source (``Source.replayable``; the
deterministic ReplaySource family). A non-replayable source still gets
the fail-fast paths (``no_restart``, flight dump) but a restart would
re-read nothing — the supervisor records a flight breadcrumb and fails.

A restart is in-process: the failed attempt's parse-ahead thread, ingest
lanes and checkpoint writer are torn down and rebuilt. A device-side
fault that poisons the CUDA context (a sticky error) cannot be recovered
this way; the faults this module handles are host-side.

Each candidate snapshot is audited against the job graph before the
restore commits to it (``_layout_audit``, the static state-layout
auditor of analysis/state_audit.py): one whose leaf tree cannot restore
is skipped with the audit's reason.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass
from typing import List, Optional


# ---------------------------------------------------------------------------
# Restart strategies (Flink 1.8 parity)
# ---------------------------------------------------------------------------


class RestartStrategy:
    """Decides whether (and after what delay) a failed job restarts.

    ``next_delay`` returns the restart delay in seconds, or None to give
    up (the failure then propagates to the caller unchanged).
    """

    def next_delay(
        self, restarts_done: int, failure_times: List[float], now: float
    ) -> Optional[float]:
        raise NotImplementedError


@dataclass(frozen=True)
class NoRestart(RestartStrategy):
    """Fail fast: any failure terminates the job (Flink's
    RestartStrategies.noRestart). The flight-recorder postmortem is
    still written by the failure path before the exception propagates.
    """

    def next_delay(self, restarts_done, failure_times, now):
        return None


@dataclass(frozen=True)
class FixedDelayRestart(RestartStrategy):
    """Restart up to ``attempts`` times, ``delay_s`` apart (Flink's
    fixedDelayRestart(restartAttempts, delayInterval))."""

    attempts: int = 3
    delay_s: float = 0.0

    def next_delay(self, restarts_done, failure_times, now):
        return self.delay_s if restarts_done < self.attempts else None


@dataclass(frozen=True)
class FailureRateRestart(RestartStrategy):
    """Restart unless more than ``max_failures`` failures landed inside
    the trailing ``window_s`` seconds (Flink's failureRateRestart(
    maxFailuresPerInterval, failureRateInterval, delayInterval))."""

    max_failures: int = 3
    window_s: float = 60.0
    delay_s: float = 0.0

    def next_delay(self, restarts_done, failure_times, now):
        recent = sum(1 for t in failure_times if now - t <= self.window_s)
        return None if recent > self.max_failures else self.delay_s


def fixed_delay(attempts: int = 3, delay_s: float = 0.0) -> FixedDelayRestart:
    return FixedDelayRestart(attempts=attempts, delay_s=delay_s)


def failure_rate(
    max_failures: int = 3, window_s: float = 60.0, delay_s: float = 0.0
) -> FailureRateRestart:
    return FailureRateRestart(
        max_failures=max_failures, window_s=window_s, delay_s=delay_s
    )


def no_restart() -> NoRestart:
    return NoRestart()


class RestartStrategies:
    """Flink-style factory surface
    (env.set_restart_strategy(RestartStrategies.fixedDelayRestart(3, 10)))."""

    fixed_delay_restart = staticmethod(fixed_delay)
    fixedDelayRestart = staticmethod(fixed_delay)
    failure_rate_restart = staticmethod(failure_rate)
    failureRateRestart = staticmethod(failure_rate)
    no_restart = staticmethod(no_restart)
    noRestart = staticmethod(no_restart)


# ---------------------------------------------------------------------------
# Supervision loop
# ---------------------------------------------------------------------------


RESTART_HEALTH_RULE_NAME = "job_restarted"
LANE_RESTART_HEALTH_RULE_NAME = "ingest_lane_restarted"
LANE_CONTENTION_HEALTH_RULE_NAME = "lane_core_contention"
LEDGER_HEALTH_RULE_NAME = "ledger_conservation"
DRILL_WARN_HEALTH_RULE_NAME = "restore_drill_failed"
DRILL_CRIT_HEALTH_RULE_NAME = "restore_drill_failing"


class SupervisionState:
    """Cross-attempt state the per-attempt executor reads back.

    Each attempt builds a fresh JobObs/Metrics registry (attempt-local
    counters keep the existing since-resume semantics), so cumulative
    supervision series are kept here and re-seeded into every new
    attempt's registry (``seed_metrics``). The flight ring is the one
    truly shared object — one postmortem covers the whole supervised
    life of the job.
    """

    def __init__(self, flight):
        self.flight = flight
        self.restarts = 0
        self.restarts_by_cause: dict = {}
        self.replay_batches_total = 0
        # written into each checkpoint's meta; the executor's restore
        # rollback only trusts a snapshot's absolute sink counts when it
        # was written by THIS supervised session (a pre-session snapshot
        # predates this process's sink output entirely)
        self.nonce = uuid.uuid4().hex
        self.base_counts: List[int] = []   # collect-sink lengths at start
        self.base_dead = 0                 # dead-letter length at start

    def seed_metrics(self, job_obs) -> None:
        """Re-seed a new attempt's registry with the cumulative
        supervision counters so scrapes/snapshots/health rules see the
        whole job's history, not just the current attempt's."""
        for cause, n in self.restarts_by_cause.items():
            job_obs.group.group(cause=cause).counter(
                "job_restarts_total"
            ).set_total(n)
        if self.replay_batches_total:
            job_obs.counter("recovery_replay_batches").set_total(
                self.replay_batches_total
            )


def _failure_cause(exc: BaseException) -> str:
    """Per-cause label: the injected fault point when there is one,
    else the exception type."""
    return getattr(exc, "point", None) or type(exc).__name__


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


def _install_restart_health_rule(env) -> None:
    """Built-in WARN rule: trips whenever the job has restarted at all
    (evaluated at snapshot ticks and at job close)."""
    _install_builtin_health_rule(
        env, RESTART_HEALTH_RULE_NAME, "job_restarts_total"
    )


def _install_lane_restart_health_rule(env) -> None:
    """Built-in WARN rule for the self-healing ingest plane: trips once
    any lane worker has been respawned in place. Lane recovery keeps the
    job running with byte-identical output (no job restart), so without
    this rule a lane quietly crash-looping toward fold-out would be
    invisible outside the flight ring."""
    _install_builtin_health_rule(
        env, LANE_RESTART_HEALTH_RULE_NAME, "ingest_lane_restarts_total"
    )


def _install_lane_contention_health_rule(env) -> None:
    """Built-in WARN rule for the resource plane: trips once the
    ResourceSampler has observed lane workers contending for a core
    (two busy lanes on the same core, or the whole plane pinned at ~1
    core of CPU)."""
    _install_builtin_health_rule(
        env, LANE_CONTENTION_HEALTH_RULE_NAME, "lane_core_contention_total"
    )


def _install_ledger_health_rule(env) -> None:
    """Built-in CRIT rule for the conservation ledger (obs/ledger.py):
    trips on the first latched invariant violation (a record lost or
    duplicated on an accounted edge, or a restored sink whose contents
    no longer match its checkpoint digest anchor). CRIT: output
    correctness is no longer proven, and /healthz answers 503."""
    _install_builtin_health_rule(
        env, LEDGER_HEALTH_RULE_NAME, "ledger_violations_total",
        severity="crit",
    )


def _install_restore_drill_health_rules(env) -> None:
    """Built-in WARN→CRIT pair for restore drills (runtime/checkpoint.py
    restore_drill): WARN on the first failed drill — the snapshot a
    crash would want first did not verify — and CRIT once drills fail
    repeatedly (> 1), the sustained-bit-rot shape where recovery from
    the nominal newest snapshot can be presumed broken."""
    _install_builtin_health_rule(
        env, DRILL_WARN_HEALTH_RULE_NAME, "restore_drill_failures_total"
    )
    _install_builtin_health_rule(
        env, DRILL_CRIT_HEALTH_RULE_NAME, "restore_drill_failures_total",
        severity="crit", value=1.0,
    )


def _layout_audit(env, sink_nodes, flight):
    """The ``latest_checkpoint(audit=...)`` hook: run the static
    state-layout auditor (analysis/state_audit.py) over each candidate
    snapshot BEFORE the supervisor commits to restoring it. A snapshot
    whose leaf tree cannot restore into the current job graph is
    skipped with the audit reason in the ``checkpoint_skipped``
    breadcrumb — instead of failing mid-restore on the next attempt.
    Every audit leaves a ``checkpoint_audit`` breadcrumb, a crashed one
    too (verdict ``"crashed"``); auditor crashes never block recovery
    (the restore path is authoritative)."""

    def audit(path):
        try:
            from ..analysis.state_audit import audit_checkpoint

            report = audit_checkpoint(env, path, sink_nodes)
        except Exception as e:
            flight.record("checkpoint_audit", path=path, verdict="crashed",
                          codes=[], error=f"{type(e).__name__}: {e}")
            return None
        flight.record(
            "checkpoint_audit",
            path=path,
            verdict=report.verdict,
            codes=[f.code for f in report.findings],
        )
        if report.verdict == "incompatible":
            return report.reason or "state layout incompatible"
        return None

    return audit


def supervise(env, sink_nodes, run_attempt):
    """Run ``run_attempt(env, sink_nodes)`` under the configured restart
    strategy until it completes or the strategy gives up."""
    from ..obs.flightrecorder import NULL_FLIGHT, FlightRecorder

    strategy = env.config.restart_strategy
    if env.config.obs.enabled:
        flight = (
            FlightRecorder(env.config.obs.flight_ring_size)
            if env.config.obs.flight_recorder
            else NULL_FLIGHT
        )
        _install_restart_health_rule(env)
    else:
        flight = NULL_FLIGHT
    state = SupervisionState(flight)
    dead = getattr(env, "dead_letters", None)
    collect_handles = [
        n.params["handle"] for n in sink_nodes if n.op == "sink_collect"
    ]
    state.base_counts = [len(h.items) for h in collect_handles]
    state.base_dead = len(dead) if dead is not None else 0
    user_restore = getattr(env, "_checkpoint_restore_path", None)
    env._supervision = state
    failure_times: List[float] = []
    try:
        while True:
            try:
                result = run_attempt(env, sink_nodes)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as exc:
                now = time.monotonic()
                failure_times.append(now)
                cause = _failure_cause(exc)
                flight.record(
                    "job_failed",
                    cause=cause,
                    error=f"{type(exc).__name__}: {exc}"[:500],
                    restarts_so_far=state.restarts,
                )
                delay = strategy.next_delay(
                    state.restarts, failure_times, now
                )
                source = _job_source(sink_nodes)
                if delay is not None and source is not None and not getattr(
                    source, "replayable", True
                ):
                    flight.record(
                        "restart_impossible",
                        reason=f"{type(source).__name__} is not replayable",
                    )
                    delay = None
                if delay is None:
                    flight.record(
                        "job_not_restarting",
                        cause=cause,
                        restarts=state.restarts,
                        strategy=repr(strategy),
                    )
                    # attempts under supervision defer the postmortem
                    # dump to this terminal decision, so it carries the
                    # give-up events recorded above
                    _rewrite_dump(env, flight)
                    raise
                state.restarts += 1
                state.restarts_by_cause[cause] = (
                    state.restarts_by_cause.get(cause, 0) + 1
                )
                ckpt = None
                if env.config.checkpoint_dir:
                    from .checkpoint import latest_checkpoint

                    ckpt = latest_checkpoint(
                        env.config.checkpoint_dir, flight=flight,
                        audit=_layout_audit(env, sink_nodes, flight),
                    )
                if ckpt is None:
                    ckpt = user_restore
                flight.record(
                    "job_restarting",
                    attempt=state.restarts,
                    cause=cause,
                    delay_s=delay,
                    checkpoint=ckpt or "",
                )
                # recovery wall clock starts at the restart decision:
                # the recovery_wall_ms the restored attempt records
                # includes the strategy delay + rebuild + state restore
                env._recovery_t0 = time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                if ckpt is None:
                    # nothing to resume from: restart from scratch —
                    # roll this process's outputs back to their pre-job
                    # baselines so the replay stays exactly-once
                    for h, b in zip(collect_handles, state.base_counts):
                        del h.items[b:]
                    if dead is not None:
                        del dead[state.base_dead:]
                env._checkpoint_restore_path = ckpt
                continue
            if state.restarts:
                flight.record("job_recovered", restarts=state.restarts)
            return result
    finally:
        env._checkpoint_restore_path = user_restore
        env._supervision = None


def _rewrite_dump(env, flight) -> None:
    """Write the flight-recorder postmortem when supervision gives up
    (failed attempts skip the per-attempt dump; the one ring spanning
    every attempt IS the postmortem, and it now holds the decision)."""
    if not getattr(flight, "enabled", False):
        return
    import os

    path = env.config.obs.flight_dump_path or os.path.join(
        os.getcwd(), f"tpustream-flight-{os.getpid()}.json"
    )
    try:
        flight.write(
            path, meta={"job": env.job_name or "job", "failed": True}
        )
    except OSError:
        pass


def _job_source(sink_nodes):
    """The graph's source object (walk any sink's chain to the root)."""
    if not sink_nodes:
        return None
    node = sink_nodes[0]
    while node.parent is not None:
        node = node.parent
    return node.params.get("source")
