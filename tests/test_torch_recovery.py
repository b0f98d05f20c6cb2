"""Supervised execution through the PyTorch port, on the CPU: the 24
cases of tests/test_recovery.py (restart strategies, automatic crash
recovery from the latest checkpoint, poison-record quarantine, sink retry
with capped backoff, and the checkpoint hardening: checksums, partial and
foreign files, mixed format versions). A deterministic injected fault
kills the job mid-stream; the recovered run's collected output must equal
an uninterrupted run's, which itself equals the JAX package's
(tolerance: identical rows).
"""

import glob
import json
import os

import pytest

import tpustream
import tpustream.runtime.sources as jax_sources
from tpustream_torch import StreamExecutionEnvironment
from tpustream_torch.config import ObsConfig, StreamConfig
from tpustream_torch.runtime.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    validate_checkpoint,
)
from tpustream_torch.runtime.sources import IterableSource, ReplaySource
from tpustream_torch.runtime.supervisor import (
    RESTART_HEALTH_RULE_NAME,
    FailureRateRestart,
    FixedDelayRestart,
    NoRestart,
    RestartStrategies,
    failure_rate,
    fixed_delay,
    no_restart,
)
from tpustream_torch.testing import (
    FaultInjected,
    FaultInjector,
    FaultPoint,
    poison_lines,
)


def jax_rows(lines, build_name="chapter2_max", **cfg):
    """The JAX package's rows for the same job (the reference output)."""
    mod = __import__(f"tpustream.jobs.{build_name}", fromlist=["build"])
    env = tpustream.StreamExecutionEnvironment(
        tpustream.StreamConfig(batch_size=2, **cfg))
    h = mod.build(env, env.add_source(jax_sources.ReplaySource(lines))).collect()
    env.execute("reference")
    return [repr(t) for t in h.items]


LINES = [
    "1563452056 10.8.22.1 cpu0 80.5",
    "1563452050 10.8.22.1 cpu0 78.4",
    "1563452056 10.8.22.2 cpu1 40.0",
    "1563452060 10.8.22.1 cpu0 99.9",
    "1563452061 10.8.22.2 cpu1 10.0",
    "1563452062 10.8.22.1 cpu0 50.0",
]


def run_supervised(
    items, build=None, ckdir=None, strategy=None, injector=None,
    source=None, **over
):
    """One job run; returns (env, collected items, JobResult)."""
    if build is None:
        from tpustream_torch.jobs.chapter2_max import build
    over.setdefault("batch_size", 2)
    cfg = StreamConfig(device="cpu", **over)
    if ckdir is not None:
        cfg = cfg.replace(
            checkpoint_dir=str(ckdir), checkpoint_interval_batches=1
        )
    if injector is not None:
        cfg = injector.install(cfg)
    env = StreamExecutionEnvironment(cfg)
    if strategy is not None:
        env.set_restart_strategy(strategy)
    text = env.add_source(source if source is not None else ReplaySource(items))
    handle = build(env, text).collect()
    result = env.execute("recovery-test")
    return env, handle.items, result


# ---------------------------------------------------------------------------
# restart strategy decisions (pure host logic, Flink 1.8 parity)
# ---------------------------------------------------------------------------
def test_restart_strategy_decisions():
    assert no_restart().next_delay(0, [], 0.0) is None
    fd = fixed_delay(attempts=2, delay_s=1.5)
    assert fd.next_delay(0, [0.0], 0.0) == 1.5
    assert fd.next_delay(1, [0.0, 1.0], 1.0) == 1.5
    assert fd.next_delay(2, [0.0, 1.0, 2.0], 2.0) is None
    fr = failure_rate(max_failures=2, window_s=10.0, delay_s=0.5)
    # 2 failures inside the window: still under the rate -> restart
    assert fr.next_delay(1, [99.0, 100.0], 100.0) == 0.5
    # 3 recent failures exceed max_failures=2 -> give up
    assert fr.next_delay(2, [98.0, 99.0, 100.0], 100.0) is None
    # old failures age out of the window
    assert fr.next_delay(5, [1.0, 2.0, 99.0, 100.0], 100.0) == 0.5


def test_restart_strategies_factory_and_env_api():
    s = RestartStrategies.fixedDelayRestart(4, 2.0)
    assert isinstance(s, FixedDelayRestart)
    assert (s.attempts, s.delay_s) == (4, 2.0)
    assert isinstance(RestartStrategies.noRestart(), NoRestart)
    assert isinstance(
        RestartStrategies.failureRateRestart(1, 5.0, 0.1), FailureRateRestart
    )
    env = StreamExecutionEnvironment(StreamConfig(device="cpu"))
    env.setRestartStrategy(s)  # Flink-style alias
    assert env.config.restart_strategy is s


# ---------------------------------------------------------------------------
# the tentpole: crash mid-stream, auto-restart, byte-identical output
# ---------------------------------------------------------------------------
def test_fixed_delay_recovery_exactly_once(tmp_path):
    """device_step fault at step 2 under fixed_delay: the job restarts
    from the latest auto-checkpoint and the collected output is
    byte-identical to an uninterrupted run. Asserts the full observable
    recovery story in one job: per-cause restart counter, replay/wall
    recovery series, checkpoint cost histograms, the flight-recorder
    failure->restart->restored->recovered sequence, and the built-in
    WARN health rule."""
    _, full, _ = run_supervised(LINES)
    inj = FaultInjector(FaultPoint("device_step", at=2))
    env, out, res = run_supervised(
        LINES, ckdir=tmp_path, strategy=fixed_delay(3, 0.0), injector=inj,
        obs=ObsConfig(enabled=True),
    )
    assert inj.fired == 1
    assert out == full, "recovered output must match an uninterrupted run"
    assert [repr(t) for t in full] == jax_rows(LINES)

    snap = res.metrics.obs_snapshot()
    series = snap["metrics"]["series"]
    restarts = [s for s in series if s["name"] == "job_restarts_total"]
    assert sum(s["value"] for s in restarts) == 1
    assert restarts[0]["labels"]["cause"] == "device_step"
    replay = next(s for s in series if s["name"] == "recovery_replay_batches")
    assert replay["value"] > 0
    names = {s["name"] for s in series}
    assert {"recovery_wall_ms", "checkpoint_save_ms", "checkpoint_bytes"} <= names

    kinds = [e["kind"] for e in res.metrics.job_obs.flight.events()]
    for want in (
        "job_failed", "job_restarting", "job_restored", "job_recovered"
    ):
        assert want in kinds, f"missing flight event {want}: {kinds}"
    assert kinds.index("job_failed") < kinds.index("job_restarting")
    assert kinds.index("job_restarting") < kinds.index("job_restored")

    health = snap["health"]
    rule = next(
        r for r in health["rules"] if r["rule"] == RESTART_HEALTH_RULE_NAME
    )
    assert rule["level"] == "warn"


def test_every_fault_point_recovers(tmp_path):
    """source_read / parse / sink_emit faults all restart-and-recover to
    identical output (device_step is the tentpole test above; exchange
    needs a mesh, test_recovery_sharded.py)."""
    _, full, _ = run_supervised(LINES)
    for point, at in (("source_read", 2), ("parse", 2), ("sink_emit", 3)):
        inj = FaultInjector(FaultPoint(point, at=at))
        _, out, _ = run_supervised(
            LINES, ckdir=tmp_path / point, strategy=fixed_delay(3, 0.0),
            injector=inj,
        )
        assert inj.fired == 1, point
        assert out == full, f"{point} recovery diverged"


def test_deep_pipeline_fault_recovery_exactly_once(tmp_path):
    """device_step and sink_emit faults injected while the async
    pipeline is several batches deep — staged H2D uploads (h2d_depth),
    a deep dispatch queue (async_depth), grouped count fetches, and
    device-side compaction all in flight — must still recover
    exactly-once from the latest checkpoint."""
    lines = [
        f"15634520{i:02d} 10.8.22.{i % 3} cpu{i % 2} {40 + (i * 17) % 55}.5"
        for i in range(16)
    ]
    deep = dict(
        async_depth=4, h2d_depth=3, fetch_group=2, compaction_capacity=64
    )
    _, sync_ref, _ = run_supervised(lines)
    _, full, _ = run_supervised(lines, **deep)
    assert full == sync_ref  # the pipeline itself is invisible
    for point, at in (("device_step", 4), ("sink_emit", 5)):
        inj = FaultInjector(FaultPoint(point, at=at))
        _, out, _ = run_supervised(
            lines, ckdir=tmp_path / point, strategy=fixed_delay(3, 0.0),
            injector=inj, **deep,
        )
        assert inj.fired == 1, point
        assert out == full, f"{point} deep-pipeline recovery diverged"


def test_restart_stops_the_failed_attempts_threads(tmp_path):
    """A restarted attempt builds its own parse-ahead thread and
    checkpoint writer: the failed attempt's are stopped and joined
    before the restart reads the source again, so the output stays
    exactly-once and no thread outlives the job."""
    import threading

    lines = [f"15634520{i:02d} 10.8.22.{i % 3} cpu0 {50 + (i * 31) % 47}.5"
             for i in range(16)]
    _, full, _ = run_supervised(lines)
    inj = FaultInjector(FaultPoint("device_step", at=3))
    _, out, _ = run_supervised(lines, ckdir=tmp_path, strategy=fixed_delay(3, 0.0),
                               injector=inj, parse_ahead=2)
    assert inj.fired == 1
    assert out == full
    names = {t.name for t in threading.enumerate() if t.is_alive()}
    assert "tpustream-parse-ahead" not in names
    assert "tpustream-ckpt-writer" not in names


def test_scratch_restart_without_checkpoints():
    """No checkpoint dir: the supervisor rolls collected output back to
    the pre-job baseline and replays from scratch — still exactly-once."""
    _, full, _ = run_supervised(LINES)
    inj = FaultInjector(FaultPoint("device_step", at=2))
    _, out, _ = run_supervised(LINES, strategy=fixed_delay(3, 0.0), injector=inj)
    assert inj.fired == 1
    assert out == full


def test_fixed_delay_gives_up_after_attempts(tmp_path):
    """A persistent fault exhausts fixed_delay(2): two restarts, then
    the third failure propagates."""
    inj = FaultInjector(FaultPoint("device_step", at=1, times=1000))
    with pytest.raises(FaultInjected):
        run_supervised(
            LINES, ckdir=tmp_path, strategy=fixed_delay(2, 0.0), injector=inj
        )
    assert inj.fired == 3  # initial attempt + 2 restarts


def test_no_restart_fails_fast_with_flight_dump(tmp_path):
    dump = tmp_path / "postmortem.json"
    inj = FaultInjector(FaultPoint("device_step", at=2))
    with pytest.raises(FaultInjected):
        run_supervised(
            LINES, ckdir=tmp_path / "ck", strategy=no_restart(), injector=inj,
            obs=ObsConfig(enabled=True, flight_dump_path=str(dump)),
        )
    assert inj.fired == 1
    assert dump.exists(), "failure must leave the postmortem dump"
    events = json.loads(dump.read_text())["events"]
    kinds = [e["kind"] for e in events]
    assert "exception" in kinds
    assert "job_not_restarting" in kinds  # the supervision decision


def test_non_replayable_source_refuses_restart():
    """A consumed-iterator source cannot re-yield the stream: the
    supervisor refuses the restart (flight breadcrumb) and fails."""
    inj = FaultInjector(FaultPoint("device_step", at=2))
    with pytest.raises(FaultInjected):
        run_supervised(
            LINES, strategy=fixed_delay(3, 0.0), injector=inj,
            source=IterableSource(iter(LINES)),
        )
    assert inj.fired == 1  # no second attempt ever ran


# ---------------------------------------------------------------------------
# poison-record quarantine (StreamConfig.dead_letter)
# ---------------------------------------------------------------------------
def test_poison_quarantine_chapter1():
    """Poison lines in the chapter-1 threshold input land in the
    dead-letter output with correct counts; the clean records' output is
    unchanged."""
    from tpustream_torch.jobs.chapter1_threshold import build

    clean = [
        "1563452051 10.8.22.1 cpu2 10.5",
        "1563452051 10.8.22.1 cpu2 99.2",
        "1563452052 10.8.22.3 cpu1 95.0",
    ]
    _, want, _ = run_supervised(clean, build=build)
    poisoned, n = poison_lines(clean, count=2, seed=7)
    env, out, res = run_supervised(poisoned, build=build, dead_letter=True)
    assert out == want
    assert n == 2 and len(env.dead_letters) == 2
    assert res.summary()["records_quarantined"] == 2
    for line, err in env.dead_letters:
        assert "poison" in line and err  # (line, reason) pairs


def test_poison_quarantine_chapter3_eventtime():
    from tpustream_torch import TimeCharacteristic
    from tpustream_torch.jobs.chapter3_bandwidth_eventtime import build

    clean = [
        "2019-08-28T09:00:00 www.163.com 1000",
        "2019-08-28T09:02:00 www.163.com 2000",
        "2019-08-28T09:03:00 www.163.com 3000",
        "2019-08-28T09:05:00 www.163.com 4000",
        "2019-08-28T09:07:00 www.163.com 500",
    ]

    def run(items, **kw):
        env = StreamExecutionEnvironment(
            StreamConfig(device="cpu", batch_size=2, **kw)
        )
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
        text = env.add_source(ReplaySource(items))
        handle = build(env, text).collect()
        env.execute("ch3-poison")
        return env, handle.items

    _, want = run(clean)
    poisoned, n = poison_lines(clean, count=3, seed=3)
    env, out = run(poisoned, dead_letter=True)
    assert out == want
    assert len(env.dead_letters) == n == 3


def test_quarantine_capacity_bounds_dead_letters():
    """dead_letter_capacity bounds the retained lines; the counter keeps
    the true total."""
    clean = list(LINES)
    poisoned, n = poison_lines(clean, count=3, seed=5)
    env, out, res = run_supervised(
        poisoned, dead_letter=True, dead_letter_capacity=1
    )
    _, want, _ = run_supervised(clean)
    assert out == want
    assert len(env.dead_letters) == 1
    assert res.summary()["records_quarantined"] == n == 3


def test_injected_parse_fault_escalates_past_quarantine():
    """Quarantine is for poison DATA; an injected parse fault models a
    crash and must escalate even with dead_letter on."""
    inj = FaultInjector(FaultPoint("parse", at=2))
    with pytest.raises(FaultInjected):
        run_supervised(LINES, dead_letter=True, injector=inj)


def test_quarantine_survives_restart(tmp_path):
    """Poison + a crash: the recovered run neither duplicates nor loses
    dead-letter records (they roll back with the sink outputs)."""
    clean = [
        f"15634520{i:02d} 10.8.22.{i % 3} cpu0 {50 + (i * 31) % 47}.5"
        for i in range(8)
    ]
    _, want, _ = run_supervised(clean)
    poisoned, n = poison_lines(clean, count=2, seed=11)
    inj = FaultInjector(FaultPoint("device_step", at=2))
    env, out, res = run_supervised(
        poisoned, ckdir=tmp_path, strategy=fixed_delay(3, 0.0), injector=inj,
        dead_letter=True,
    )
    assert inj.fired == 1
    assert out == want
    assert len(env.dead_letters) == n == 2
    assert res.summary()["records_quarantined"] == 2


# ---------------------------------------------------------------------------
# sink retry with capped exponential backoff
# ---------------------------------------------------------------------------
def test_sink_retry_recovers_transient_failure():
    """A sink_emit fault firing twice is absorbed by sink_retries=3 —
    no restart, identical output."""
    _, full, _ = run_supervised(LINES)
    inj = FaultInjector(FaultPoint("sink_emit", at=1, times=2))
    _, out, _ = run_supervised(
        LINES, injector=inj, sink_retries=3, sink_retry_base_ms=0.0
    )
    assert inj.fired == 2  # both injected failures were retried through
    assert out == full


def test_sink_failure_escalates_without_retries():
    inj = FaultInjector(FaultPoint("sink_emit", at=2))
    with pytest.raises(FaultInjected):
        run_supervised(LINES, injector=inj)


def test_sink_retry_backoff_is_capped():
    from tpustream_torch.runtime.sinks import RetryingSink

    class Flaky:
        obs_counter = None
        fails = 3

        def __init__(self):
            self.got = []

        def emit(self, value, subtask=None):
            if self.fails:
                self.fails -= 1
                raise RuntimeError("transient")
            self.got.append(value)

    import time

    inner = Flaky()
    sink = RetryingSink(inner, attempts=3, base_ms=1.0, max_ms=2.0)
    t0 = time.perf_counter()
    sink.emit("v")
    # delays 1ms, 2ms, 2ms (capped) — far below an uncapped 1+2+4
    assert time.perf_counter() - t0 < 0.5
    assert inner.got == ["v"]
    # exhausting attempts re-raises the sink error
    inner.fails = 99
    with pytest.raises(RuntimeError, match="transient"):
        sink.emit("w")


# ---------------------------------------------------------------------------
# checkpoint hardening (satellites 1+2): atomic writes, checksums,
# skipping partial/corrupt/incompatible snapshots
# ---------------------------------------------------------------------------
def _snaps(d):
    return sorted(glob.glob(os.path.join(str(d), "ckpt-*.npz")))


def test_corrupt_checkpoint_detected_and_skipped(tmp_path):
    run_supervised(LINES, ckdir=tmp_path)
    snaps = _snaps(tmp_path)
    assert len(snaps) >= 2
    newest = snaps[-1]
    # flip payload bytes near the end (past the metadata header)
    blob = bytearray(open(newest, "rb").read())
    blob[-64:-32] = bytes(32)
    with open(newest, "wb") as f:
        f.write(blob)
    reason = validate_checkpoint(newest)
    assert reason is not None and ("checksum" in reason or "unreadable" in reason)
    with pytest.raises((ValueError, Exception)):
        load_checkpoint(newest)

    class Ring:
        def __init__(self):
            self.events = []

        def record(self, kind, **payload):
            self.events.append((kind, payload))

    ring = Ring()
    picked = latest_checkpoint(str(tmp_path), flight=ring)
    assert picked in snaps and picked != newest
    assert validate_checkpoint(picked) is None
    assert any(
        k == "checkpoint_skipped" and p["path"] == newest
        for k, p in ring.events
    )


def test_partial_and_foreign_files_skipped(tmp_path):
    run_supervised(LINES, ckdir=tmp_path)
    snaps = _snaps(tmp_path)
    # a torn write that sorts NEWEST (and is named into the marker)
    partial = os.path.join(str(tmp_path), "ckpt-9999999999.npz")
    with open(partial, "wb") as f:
        f.write(b"PK\x03\x04 torn write")
    with open(os.path.join(str(tmp_path), "latest"), "w") as f:
        f.write(os.path.basename(partial))
    picked = latest_checkpoint(str(tmp_path))
    assert picked == snaps[-1]  # newest VALID snapshot, not the torn file


def test_recovery_prefers_newest_valid_snapshot(tmp_path):
    """End to end: corrupt the newest snapshot, crash the job — the
    restart restores from the older valid one and output still matches."""
    _, full, _ = run_supervised(LINES)

    # seed the dir with snapshots, then corrupt the newest
    run_supervised(LINES, ckdir=tmp_path)
    newest = _snaps(tmp_path)[-1]
    blob = bytearray(open(newest, "rb").read())
    blob[-64:-32] = bytes(32)
    with open(newest, "wb") as f:
        f.write(blob)

    inj = FaultInjector(FaultPoint("device_step", at=2))
    env, out, res = run_supervised(
        LINES, ckdir=tmp_path, strategy=fixed_delay(3, 0.0), injector=inj,
        obs=ObsConfig(enabled=True),
    )
    assert inj.fired == 1
    assert out == full
    # note: the crashed attempt usually re-saved a valid snapshot at the
    # corrupt name before failing; the breadcrumb only appears when the
    # corrupt file actually survived to restart time. Either way the
    # recovered output above is the contract.


def test_checkpoint_meta_records_recovery_fields(tmp_path):
    run_supervised(LINES, ckdir=tmp_path)
    ck = load_checkpoint(_snaps(tmp_path)[-1])
    assert ck.sink_counts is not None and len(ck.sink_counts) == 1
    assert ck.sink_counts[0] == ck.emitted  # single collect sink
    assert ck.quarantined == 0
    assert ck.session is None  # written outside supervision


def _rewrite_format_version(path, version):
    """Rewrite a snapshot's meta version in place (payload untouched, so
    the checksum stays valid — ONLY the format version mismatches),
    simulating a snapshot written by a pre-bump build."""
    import numpy as np

    from tpustream_torch.runtime.checkpoint import _META_KEY

    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != _META_KEY}
        meta = json.loads(bytes(z[_META_KEY]).decode())
    meta["version"] = version
    with open(path, "wb") as f:
        np.savez(f, **arrays, **{_META_KEY: np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)})


def test_mixed_version_directory_skips_older_format(tmp_path):
    """A checkpoint directory straddling a format bump (regression for
    the v9 dynamic-rules bump): ``latest_checkpoint`` must treat
    current-FORMAT_VERSION snapshots as valid while skipping the
    older-version ones with a ``checkpoint_skipped`` breadcrumb — never
    handing the supervisor an unloadable path."""
    from tpustream_torch.runtime.checkpoint import FORMAT_VERSION

    run_supervised(LINES, ckdir=tmp_path)
    snaps = _snaps(tmp_path)
    assert len(snaps) >= 2
    newest, older = snaps[-1], snaps[-2]
    # this build's snapshots ARE the current format — valid as written
    assert validate_checkpoint(newest) is None
    _rewrite_format_version(newest, FORMAT_VERSION - 1)
    reason = validate_checkpoint(newest)
    assert reason is not None and "version" in reason

    class Ring:
        def __init__(self):
            self.events = []

        def record(self, kind, **payload):
            self.events.append((kind, payload))

    ring = Ring()
    picked = latest_checkpoint(str(tmp_path), flight=ring)
    assert picked == older
    assert validate_checkpoint(picked) is None
    assert any(
        k == "checkpoint_skipped"
        and p["path"] == newest
        and "version" in p["reason"]
        for k, p in ring.events
    )


def test_recovery_survives_mixed_version_directory(tmp_path):
    """End to end: the newest snapshot is from an older format (a
    pre-upgrade run left it behind), the job crashes — the restart
    restores from the newest CURRENT-version snapshot and the output is
    still byte-identical to an uninterrupted run."""
    from tpustream_torch.runtime.checkpoint import FORMAT_VERSION

    _, full, _ = run_supervised(LINES)
    run_supervised(LINES, ckdir=tmp_path)
    _rewrite_format_version(_snaps(tmp_path)[-1], FORMAT_VERSION - 1)

    inj = FaultInjector(FaultPoint("device_step", at=2))
    _, out, _ = run_supervised(
        LINES, ckdir=tmp_path, strategy=fixed_delay(3, 0.0), injector=inj,
    )
    assert inj.fired == 1
    assert out == full


def test_mixed_version_directory_skips_newer_format(tmp_path):
    """The straddle in the OTHER direction (regression for the v10
    tenancy bump): a snapshot written by a newer build — e.g. v10 with
    tenancy meta — must be skipped by this reader with a
    ``checkpoint_skipped`` breadcrumb, restoring from the newest
    snapshot this build can actually load. A rolled-back binary must
    never crash on its successor's checkpoints."""
    from tpustream_torch.runtime.checkpoint import FORMAT_VERSION

    run_supervised(LINES, ckdir=tmp_path)
    snaps = _snaps(tmp_path)
    assert len(snaps) >= 2
    newest, older = snaps[-1], snaps[-2]
    _rewrite_format_version(newest, FORMAT_VERSION + 1)
    reason = validate_checkpoint(newest)
    assert reason is not None and "version" in reason

    class Ring:
        def __init__(self):
            self.events = []

        def record(self, kind, **payload):
            self.events.append((kind, payload))

    ring = Ring()
    picked = latest_checkpoint(str(tmp_path), flight=ring)
    assert picked == older
    assert validate_checkpoint(picked) is None
    assert any(
        k == "checkpoint_skipped"
        and p["path"] == newest
        and "version" in p["reason"]
        for k, p in ring.events
    )

    # and end to end: crash with the future-format snapshot newest —
    # the restart restores from the older current-format one, output
    # byte-identical to an uninterrupted run
    _, full, _ = run_supervised(LINES)
    inj = FaultInjector(FaultPoint("device_step", at=2))
    _, out, _ = run_supervised(
        LINES, ckdir=tmp_path, strategy=fixed_delay(3, 0.0), injector=inj,
    )
    assert inj.fired == 1
    assert out == full
