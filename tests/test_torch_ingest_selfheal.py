"""The self-healing ingest plane of the PyTorch port (``runtime/ingest.py``,
``runtime/watchdog.py``), on the CPU: tests/test_ingest_selfheal.py:113-368,
with the checkpoint digests of the healed runs, and the escalation of
a hang past lane healing to the watchdog and a supervised restart. Lane
supervision
detects dead and hung workers, re-routes their un-merged frames inline,
respawns a lane within its restart budget and folds a lane out past it,
and the job's rows stay those of a single-lane run. The watchdog and
restart-policy units run over BOTH packages' modules as cases of one
parametrised test. A lane worker is forked while the parent holds
threads of its own (the watchdog, the ingest producer) and never touches
``torch``. Tolerance: identical rows."""

import hashlib
import importlib
import json
import time

import numpy as np
import pytest

from tests.test_torch_chains import PKGS, run_job
from tpustream_torch.config import ObsConfig
from tpustream_torch.runtime.checkpoint import load_checkpoint
from tpustream_torch.runtime.supervisor import (
    LANE_RESTART_HEALTH_RULE_NAME,
    fixed_delay,
)
from tpustream_torch.testing import FaultInjector, FaultPoint

PACKAGES = {"jax": "tpustream", "torch": "tpustream_torch"}

# long enough that the producer (at most 4 frames a lane ahead of the
# merge) is still mid-stream when a lane death is detected
LONG_LINES = [
    f"15634520{i:02d} 10.8.22.{i % 5} cpu{i % 3} {40 + (i * 31) % 55}.5"
    for i in range(72)
]


@pytest.fixture(params=sorted(PACKAGES))
def pk(request):
    return PACKAGES[request.param]


def ch2(ns, text):
    return importlib.import_module(
        ns.pkg.__name__ + ".jobs.chapter2_max").build(None, text)


@pytest.fixture(scope="module")
def base_rows():
    rows, _ = run_job("torch", ch2, LONG_LINES, event_time=False, batch_size=4)
    return rows


@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory):
    """The single-lane run's newest checkpoint (a snapshot every batch)."""
    d = tmp_path_factory.mktemp("base")
    run_job("torch", ch2, LONG_LINES, event_time=False, batch_size=4,
            checkpoint_dir=str(d), checkpoint_interval_batches=1)
    return d


def _digest(path, fields):
    ck = load_checkpoint(str(path))
    h = hashlib.sha256()
    for leaf in ck.leaves:
        a = np.asarray(leaf)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(json.dumps([getattr(ck, f) for f in fields]).encode())
    return h.hexdigest()


def checkpoint_digest(path):
    """The replayable checkpoint content: the state leaves and the
    stream cursors (the session and the informational lane cursor are
    left out)."""
    return _digest(path, ("source_pos", "emitted", "batches"))


def replay_state_digest(path):
    """The state leaves and the source cursor only: across a supervised
    restart ``emitted`` counts from the restore, by design."""
    return _digest(path, ("source_pos",))


def run_healed(injector, ckdir=None, strategy=None, **over):
    """The chapter-2 job through the port with lanes and the injector
    (``ckdir``: a checkpoint every batch): ``(rows, flight events,
    snapshot)``."""
    ns = PKGS["torch"]
    cfg = injector.install(ns.pkg.StreamConfig(
        batch_size=4, obs=ObsConfig(enabled=True), **over, **ns.cfg))
    if ckdir is not None:
        cfg = cfg.replace(checkpoint_dir=str(ckdir), checkpoint_interval_batches=1)
    env = ns.pkg.StreamExecutionEnvironment(cfg)
    if strategy is not None:
        env.set_restart_strategy(strategy)
    h = ch2(ns, env.add_source(ns.sources.ReplaySource(LONG_LINES))).collect()
    env.execute("ingest-selfheal-test")
    return ([repr(t) for t in h.items], list(env.metrics.job_obs.flight.events()),
            env.metrics.obs_snapshot())


def kinds(events):
    return [e["kind"] for e in events]


def series(snap, name):
    return [s for s in snap["metrics"]["series"] if s["name"] == name]


# -- watchdog and restart-policy units ---------------------------------------------

def _wd(pk):
    return importlib.import_module(pk + ".runtime.watchdog")


def test_stall_watchdog_fires_after_limit_and_disarm_cancels(pk):
    fired = []
    wd = _wd(pk).StallWatchdog(lambda name, limit: fired.append((name, limit)))
    try:
        wd.arm("a", 0.15)
        deadline = time.monotonic() + 3.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired == [("a", 0.15)]
        tok = wd.arm("b", 0.15)
        wd.disarm(tok)
        time.sleep(0.4)
        assert fired == [("a", 0.15)]
    finally:
        wd.close()


def test_stall_watchdog_poke_defers_the_deadline(pk):
    fired = []
    wd = _wd(pk).StallWatchdog(lambda name, limit: fired.append(name))
    try:
        tok = wd.arm("work", 0.4)
        for _ in range(5):
            time.sleep(0.15)
            wd.poke(tok)
        assert fired == []
        deadline = time.monotonic() + 3.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired == ["work"]
    finally:
        wd.close()


def test_stall_watchdog_guard_suppresses_and_rearms(pk):
    fired = []
    blocked_on_us = [False]
    wd = _wd(pk).StallWatchdog(lambda name, limit: fired.append(name))
    try:
        wd.arm("merge_wait", 0.15, guard=lambda: blocked_on_us[0])
        time.sleep(0.5)
        assert fired == []
        blocked_on_us[0] = True
        deadline = time.monotonic() + 3.0
        while not fired and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fired == ["merge_wait"]
    finally:
        wd.close()


def test_stall_watchdog_zero_limit_is_disabled(pk):
    fired = []
    wd = _wd(pk).StallWatchdog(lambda name, limit: fired.append(name))
    try:
        assert wd.arm("a", 0.0) == -1
        time.sleep(0.2)
        assert fired == []
    finally:
        wd.close()


def test_ingest_stall_error_carries_supervisor_cause(pk):
    err = _wd(pk).IngestStallError("merge_wait", 30.0)
    assert err.point == "ingest_stall"
    assert err.scope == "merge_wait"
    assert "merge_wait" in str(err)


def test_lane_restart_policy_budget_is_per_lane(pk):
    policy = importlib.import_module(pk + ".runtime.ingest").LaneRestartPolicy
    pol = policy(2)
    assert pol.may_restart(0)
    assert pol.note_restart(0) == 1
    assert pol.may_restart(0)
    assert pol.note_restart(0) == 2
    assert not pol.may_restart(0)
    assert pol.may_restart(1)
    assert not policy(0).may_restart(0)


# -- failure shapes: the lane heals in place --------------------------------------

def test_lane_crash_sigkill_inplace_recovery(base_rows, base_ckpt, tmp_path):
    inj = FaultInjector(FaultPoint("lane_worker_crash", at=3, exit_code=-9))
    rows, events, snap = run_healed(inj, ckdir=tmp_path, ingest_lanes=2)
    # byte-identical stream and checkpoint despite a dead worker
    assert rows == base_rows
    assert checkpoint_digest(tmp_path) == checkpoint_digest(base_ckpt)
    k = kinds(events)
    assert "ingest_lanes_enabled" in k
    assert "ingest_lane_died" in k and "ingest_lane_restarted" in k
    assert "job_failed" not in k
    died = [e for e in events if e["kind"] == "ingest_lane_died"]
    assert died[0]["shape"] == "exit"
    restarts = series(snap, "ingest_lane_restarts_total")
    assert sum(s["value"] for s in restarts) >= 1
    assert all("lane" in s["labels"] for s in restarts)


def test_lane_crash_trips_builtin_health_rule():
    inj = FaultInjector(FaultPoint("lane_worker_crash", at=2, exit_code=-9))
    _, _, snap = run_healed(inj, ingest_lanes=2)
    rules = [r for r in snap["health"]["rules"]
             if r["rule"] == LANE_RESTART_HEALTH_RULE_NAME]
    assert rules and rules[0]["level"] == "warn"


def test_premature_clean_exit_is_detected_not_hung(base_rows):
    inj = FaultInjector(FaultPoint("lane_worker_crash", at=2, exit_code=0))
    rows, events, _ = run_healed(inj, ingest_lanes=2)
    assert rows == base_rows
    died = [e for e in events if e["kind"] == "ingest_lane_died"]
    assert died and died[0]["shape"] == "premature_exit"
    assert "ingest_lane_restarted" in kinds(events)


def test_lane_hang_heartbeat_stall_inplace_recovery(base_rows, base_ckpt,
                                                    tmp_path):
    inj = FaultInjector(FaultPoint("lane_worker_hang", at=2))
    rows, events, _ = run_healed(inj, ckdir=tmp_path, ingest_lanes=2,
                                 ingest_lane_stall_limit_ms=300.0)
    assert rows == base_rows
    assert checkpoint_digest(tmp_path) == checkpoint_digest(base_ckpt)
    died = [e for e in events if e["kind"] == "ingest_lane_died"]
    assert died and died[0]["shape"] == "stall"
    assert died[0]["heartbeat_age_ms"] >= 300.0
    assert "ingest_lane_restarted" in kinds(events)


def test_hang_escalates_to_watchdog_and_supervised_restart(base_rows,
                                                           base_ckpt, tmp_path):
    """Lane healing off: the hung lane stalls the merge, the watchdog
    raises, and the supervisor restarts the job from its checkpoint,
    exactly-once."""
    inj = FaultInjector(FaultPoint("lane_worker_hang", at=2))
    rows, events, _ = run_healed(
        inj, ckdir=tmp_path, strategy=fixed_delay(3, 0.0), ingest_lanes=2,
        ingest_lane_stall_limit_ms=0.0,  # lane-level healing off
        extra={"ingest_watchdog_limit_ms": 700.0},
    )
    assert rows == base_rows
    assert replay_state_digest(tmp_path) == replay_state_digest(base_ckpt)
    k = kinds(events)
    assert "watchdog_fired" in k
    assert "job_failed" in k and "job_recovered" in k
    restarting = [e for e in events if e["kind"] == "job_restarting"]
    assert restarting and restarting[0]["cause"] == "ingest_stall"


def test_fold_out_ladder_degrades_to_inline(base_rows, base_ckpt, tmp_path):
    inj = FaultInjector(
        FaultPoint("lane_worker_crash", at=0, exit_code=-9),
        FaultPoint("lane_worker_crash", at=1, exit_code=-9),
    )
    rows, events, snap = run_healed(inj, ckdir=tmp_path, ingest_lanes=2,
                                    ingest_lane_restarts=0)
    assert rows == base_rows
    assert checkpoint_digest(tmp_path) == checkpoint_digest(base_ckpt)
    k = kinds(events)
    assert k.count("ingest_lane_folded") == 2
    assert "ingest_degraded" in k
    assert "ingest_lane_restarted" not in k
    folded = series(snap, "ingest_lane_folded")
    assert sorted(s["labels"]["lane"] for s in folded
                  if s["value"] == 1.0) == ["0", "1"]


def test_single_lane_death_folds_and_survivor_carries_stream(base_rows):
    inj = FaultInjector(FaultPoint("lane_worker_crash", at=1, exit_code=-9))
    rows, events, snap = run_healed(inj, ingest_lanes=2,
                                    ingest_lane_restarts=0)
    assert rows == base_rows
    k = kinds(events)
    assert k.count("ingest_lane_folded") == 1
    assert "ingest_degraded" not in k
    assert [s for s in series(snap, "ingest_lane_folded") if s["value"] == 0.0]


def test_lane_crash_with_steps_in_flight(base_rows):
    """A lane killed while steps are in flight and uploads are staged:
    the merge re-routes its frames and the pipeline sees the same
    stream."""
    inj = FaultInjector(FaultPoint("lane_worker_crash", at=3, exit_code=-9))
    rows, events, _ = run_healed(inj, ingest_lanes=2, async_depth=4,
                                 h2d_depth=3, fetch_group=2)
    assert rows == base_rows
    assert "ingest_lane_restarted" in kinds(events)
