"""The conservation ledger (``obs/ledger.py``) through the PyTorch port,
on the CPU: the cases of tests/test_ledger.py, the 8-shard one among
them, run through the port's executor with ``device="cpu"``, plus
snapshots carrying anchors across the two packages.

The ledger observes the emit path and must never change a job's output
(equal rows with it on and off); every accounted invariant holds at a
residual of exactly 0; a restored attempt verifies its sinks against
the checkpoint's digest anchors; a hand-tampered sink trips the CRIT
health rule. Tolerance: exact (counts, digests and rows).
"""

import numpy as np
import pytest

from tpustream_torch import (
    BoundedOutOfOrdernessTimestampExtractor,
    StreamExecutionEnvironment,
    Time,
    TimeCharacteristic,
    Tuple3,
)
from tpustream_torch.config import ObsConfig, StreamConfig
from tpustream_torch.runtime.sources import ReplaySource
from tpustream_torch.runtime.supervisor import LEDGER_HEALTH_RULE_NAME, fixed_delay
from tpustream_torch.testing import FaultInjector, FaultPoint

LINES = [
    "1563452056 10.8.22.1 cpu0 80.5",
    "1563452050 10.8.22.1 cpu0 78.4",
    "1563452056 10.8.22.2 cpu1 40.0",
    "1563452060 10.8.22.1 cpu0 99.9",
    "1563452061 10.8.22.2 cpu1 10.0",
    "1563452062 10.8.22.1 cpu0 50.0",
]


def run_job(items=LINES, build=None, ckdir=None, strategy=None,
            injector=None, **over):
    """One chapter-2 job run: ``(env, collected items, JobResult)``."""
    if build is None:
        from tpustream_torch.jobs.chapter2_max import build
    over.setdefault("batch_size", 2)
    cfg = StreamConfig(device="cpu", **over)
    if ckdir is not None:
        cfg = cfg.replace(checkpoint_dir=str(ckdir),
                          checkpoint_interval_batches=1)
    if injector is not None:
        cfg = injector.install(cfg)
    env = StreamExecutionEnvironment(cfg)
    if strategy is not None:
        env.set_restart_strategy(strategy)
    handle = build(env, env.add_source(ReplaySource(items))).collect()
    result = env.execute("ledger-test")
    return env, handle.items, result


def _ledger_state(result):
    led = result.metrics.job_obs.ledger
    assert led is not None, "ledger expected on for this config"
    return led.state()


def _evaluated_residuals(state):
    return {e["edge"]: e["residual"] for e in state["edges"]
            if e.get("residual") is not None}


# -- the ledger observes, it never touches a record -------------------------

def test_ledger_output_byte_identical_single_chip():
    _, plain, _ = run_job(obs=ObsConfig(enabled=False))
    _, led_off, _ = run_job(obs=ObsConfig(enabled=True, ledger=False))
    _, led_on, res = run_job(obs=ObsConfig(enabled=True))
    assert led_on == plain
    assert led_off == plain
    state = _ledger_state(res)
    assert state["violations"]["total"] == 0
    assert all(r == 0 for r in _evaluated_residuals(state).values())


def test_ledger_output_byte_identical_eight_shards():
    """The same parity contract with the job sharded over 8 shards."""
    _, plain, _ = run_job(batch_size=8, parallelism=8,
                          obs=ObsConfig(enabled=False))
    _, led_on, res = run_job(batch_size=8, parallelism=8,
                             obs=ObsConfig(enabled=True))
    assert led_on == plain
    state = _ledger_state(res)
    assert state["violations"]["total"] == 0
    assert all(r == 0 for r in _evaluated_residuals(state).values())


# -- the invariants hold at 0 across job shapes -----------------------------

def test_ledger_residuals_zero_and_anchored():
    _, out, res = run_job(obs=ObsConfig(enabled=True))
    state = _ledger_state(res)
    residuals = _evaluated_residuals(state)
    assert {"source", "sink0", "contents:sink0"} <= set(residuals)
    assert all(r == 0 for r in residuals.values()), residuals
    src = next(e for e in state["edges"] if e["edge"] == "source")
    assert src["offered"] == len(LINES)
    a = state["anchors"]["sink0"]
    assert a["count"] == len(out)
    assert a["verifiable"] and len(a["digest"]) == 64

    snap = res.metrics.obs_snapshot()
    assert snap["ledger"]["violations"]["total"] == 0
    assert any(s["name"] == "ledger_conservation_residual"
               and s["labels"].get("edge") == "sink0"
               for s in snap["metrics"]["series"])


def test_ledger_chain_edge_balances():
    class Ts(BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(Time.milliseconds(1000))

        def extract_timestamp(self, value):
            return int(value.split(" ")[0])

    def parse(line: str) -> Tuple3:
        items = line.split(" ")
        return Tuple3(items[1], items[2], int(items[3]))

    lines = ["1000 a x 5", "2000 b y 7", "5000 a x 3", "12000 a y 4",
             "25000 b x 9"]
    env = StreamExecutionEnvironment(StreamConfig(
        device="cpu", batch_size=2, key_capacity=16,
        obs=ObsConfig(enabled=True)))
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    stage1 = (env.add_source(ReplaySource(lines))
              .assign_timestamps_and_watermarks(Ts())
              .map(parse).key_by(0)
              .time_window(Time.seconds(10))
              .reduce(lambda p, q: Tuple3(p.f0, p.f1, p.f2 + q.f2)))
    handle = stage1.key_by(1).max(2).collect()
    result = env.execute("ledger-chain")
    assert len(handle.items) == 4
    state = _ledger_state(result)
    chain = [e for e in state["edges"] if e["edge"].startswith("chain:")]
    assert chain, state["edges"]
    assert chain[0]["handed"] == chain[0]["received"] == 4
    assert chain[0]["residual"] == 0
    assert all(r == 0 for r in _evaluated_residuals(state).values())


def test_ledger_lanes_carveout_source_informational():
    _, plain, _ = run_job(obs=ObsConfig(enabled=False))
    _, out, res = run_job(ingest_lanes=2, obs=ObsConfig(enabled=True))
    assert out == plain
    state = _ledger_state(res)
    src = next(e for e in state["edges"] if e["edge"] == "source")
    assert src["residual"] is None
    assert "note" in src
    residuals = _evaluated_residuals(state)
    assert "source" not in residuals
    assert residuals.get("sink0") == 0
    assert state["violations"]["total"] == 0


def test_ledger_cep_side_output_edges_balance():
    from tpustream_torch import CEP, OutputTag, Pattern

    class Ts(BoundedOutOfOrdernessTimestampExtractor):
        def __init__(self):
            super().__init__(Time.milliseconds(0))

        def extract_timestamp(self, line):
            return int(line.split(" ")[0]) * 1000

    def parse(line):
        t, ch, v = line.split(" ")
        return Tuple3(int(t), ch, int(v))

    def run(obs):
        env = StreamExecutionEnvironment(
            StreamConfig(device="cpu", batch_size=1, obs=obs))
        env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
        pat = (Pattern.begin("a").where(lambda r: r.f2 > 10)
               .followed_by("b").where(lambda r: r.f2 > 10)
               .within(Time.seconds(10)))
        tag = OutputTag("to")
        lines = ["0 k1 20", "0 k2 20", "9 k1 30", "30 k1 50"]
        keyed = (env.add_source(ReplaySource(lines))
                 .assign_timestamps_and_watermarks(Ts())
                 .map(parse).key_by(1))
        result = CEP.pattern(keyed, pat).select(None, timeout_tag=tag)
        h = result.collect()
        ht = result.get_side_output(tag).collect()
        res = env.execute("ledger-cep")
        return h.items, ht.items, res

    main0, side0, _ = run(ObsConfig(enabled=False))
    main1, side1, res = run(ObsConfig(enabled=True))
    assert main1 == main0 and side1 == side0
    assert main1 and side1, "both streams must carry rows"
    state = _ledger_state(res)
    residuals = _evaluated_residuals(state)
    assert {"sink0", "side:to", "contents:side:to"} <= set(residuals)
    assert all(r == 0 for r in residuals.values()), residuals
    side_edge = next(e for e in state["edges"] if e["edge"] == "side:to")
    assert side_edge["emitted"] == len(side1)
    a = state["anchors"]["side:to"]
    assert a["count"] == len(side1) and len(a["digest"]) == 64
    assert state["violations"]["total"] == 0


def test_ledger_digest_gate():
    _, out, res = run_job(obs=ObsConfig(enabled=True, ledger_digests=False))
    state = _ledger_state(res)
    assert state["digests"] is False
    a = state["anchors"]["sink0"]
    assert a["count"] == len(out) and a["digest"] is None
    assert all(r == 0 for r in _evaluated_residuals(state).values())


def test_sink_counter_twin_naming_regression():
    import re

    _, out, res = run_job(obs=ObsConfig(enabled=True))
    prom = res.metrics.obs_snapshot()["prometheus"]
    legacy = re.search(r'tpustream_operator_sink0_emitted\{[^}]*\} (\d+)', prom)
    unified = re.search(
        r'tpustream_operator_sink_emitted\{[^}]*sink="0"[^}]*\} (\d+)', prom)
    assert legacy, "legacy spelling missing from exposition"
    assert unified, "unified labeled family missing from exposition"
    assert legacy.group(1) == unified.group(1) == str(len(out))


# -- recovery: digest anchors prove byte parity across a restore ------------

def test_sink_emit_fault_recovery_verifies_anchors(tmp_path):
    _, clean, _ = run_job()
    inj = FaultInjector(FaultPoint("sink_emit", at=3))
    _, out, res = run_job(ckdir=tmp_path, strategy=fixed_delay(3, 0.0),
                          injector=inj, obs=ObsConfig(enabled=True))
    assert inj.fired == 1
    assert out == clean
    state = _ledger_state(res)
    assert state["restore"] is not None, "restore verification must run"
    assert state["restore"]["mismatches"] == 0
    assert state["restore"]["verified"] >= 1
    assert state["violations"]["total"] == 0
    assert all(r == 0 for r in _evaluated_residuals(state).values())
    kinds = [e["kind"] for e in res.metrics.job_obs.flight.events()]
    assert "ledger_restore_digest_mismatch" not in kinds
    assert "ledger_violation" not in kinds


def test_checkpoints_carry_ledger_anchors(tmp_path):
    from tpustream_torch.runtime.checkpoint import latest_checkpoint, load_checkpoint

    run_job(ckdir=tmp_path, obs=ObsConfig(enabled=True))
    path = latest_checkpoint(str(tmp_path))
    assert path is not None
    ck = load_checkpoint(path)
    assert ck.ledger is not None
    assert "sink0" in ck.ledger
    assert ck.ledger["sink0"]["verifiable"]
    assert len(ck.ledger["sink0"]["digest"]) == 64

    # a ledger-off run writes checkpoints without anchors
    run_job(ckdir=tmp_path / "off", obs=ObsConfig(enabled=False))
    ck2 = load_checkpoint(latest_checkpoint(str(tmp_path / "off")))
    assert ck2.ledger is None


# -- the deliberately broken sink: caught, latched, CRIT --------------------

def test_hand_broken_sink_trips_crit_rule():
    env, out, res = run_job(obs=ObsConfig(enabled=True))
    jo = res.metrics.job_obs
    assert jo.ledger.state()["violations"]["total"] == 0
    # drop the last collected row behind the ledger, then drive one
    # snapshot tick: the pre-hook refresh mints the residual and the
    # health engine evaluates over the fresh series
    assert out, "job must have collected rows for the tamper to matter"
    out.pop()
    snap = jo.snapshotter.take()
    led = snap["ledger"]
    assert led["violations"]["total"] == 1
    assert "contents:sink0" in led["violations"]["edges"]
    bad = next(e for e in led["edges"] if e["edge"] == "contents:sink0")
    assert bad["residual"] == 1
    assert any(e["kind"] == "ledger_violation"
               and e.get("edge") == "contents:sink0"
               for e in jo.flight.events())
    rule = next(r for r in snap["health"]["rules"]
                if r["rule"] == LEDGER_HEALTH_RULE_NAME)
    assert rule["level"] == "crit"


def test_ledger_off_means_no_surfaces():
    env, _, res = run_job(obs=ObsConfig(enabled=True, ledger=False))
    assert res.metrics.job_obs.ledger is None
    snap = res.metrics.obs_snapshot()
    assert "ledger" not in snap
    names = {(r.get("name") if isinstance(r, dict) else getattr(r, "name", ""))
             for r in (env.config.obs.health_rules or ())}
    assert LEDGER_HEALTH_RULE_NAME not in names


# -- anchors across the two packages ----------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ledger_anchors_verify_across_packages(writer, tmp_path):
    """A snapshot written with the ledger on by one package carries its
    sinks' anchors; the other package restores it and runs the suffix,
    and that package's ledger, over the rows of its own run from the
    start, verifies the anchors (a row's digest bytes are its print
    form, the same in both). A tampered anchor is refused."""
    import glob
    import os

    import tpustream
    import tpustream.jobs.chapter2_max as jax_job
    import tpustream.runtime.checkpoint as jax_ck
    import tpustream.runtime.sources as jax_sources
    import tpustream_torch
    import tpustream_torch.jobs.chapter2_max as torch_job
    import tpustream_torch.runtime.checkpoint as torch_ck
    import tpustream_torch.runtime.sources as torch_sources

    rng = np.random.default_rng(5)
    lines = [f"{1563452000 + i} 10.8.22.{int(rng.integers(0, 4))} cpu0 "
             f"{float(rng.integers(0, 1000)) / 10.0}" for i in range(24)]
    import tpustream.config as jax_config
    import tpustream_torch.config as torch_config

    side = {
        "jax": (jax_config, jax_job, jax_sources, jax_ck, {}),
        "torch": (torch_config, torch_job, torch_sources, torch_ck,
                  {"device": "cpu"}),
    }
    reader = "torch" if writer == "jax" else "jax"

    def run(which, restore=None, ckdir=None):
        config, job, sources, _, extra = side[which]
        cfg = config.StreamConfig(batch_size=4,
                                  obs=config.ObsConfig(enabled=True), **extra)
        pkg = tpustream if which == "jax" else tpustream_torch
        if ckdir is not None:
            cfg = cfg.replace(checkpoint_dir=str(ckdir),
                              checkpoint_interval_batches=2)
        env = pkg.StreamExecutionEnvironment(cfg)
        if restore is not None:
            env.restore_from_checkpoint(restore)
        h = job.build(env, env.add_source(sources.ReplaySource(lines))).collect()
        res = env.execute("anchors")
        return [repr(t) for t in h.items], res

    full, _ = run(writer, ckdir=tmp_path)
    path = sorted(glob.glob(os.path.join(str(tmp_path), "ckpt-*.npz")))[0]
    ck = side[writer][3].load_checkpoint(path)
    anchors = ck.ledger
    assert anchors["sink0"]["verifiable"]
    assert anchors["sink0"]["count"] == ck.emitted > 0
    # the reader restores the snapshot and runs the suffix
    suffix, _ = run(reader, restore=path)
    assert suffix == full[ck.emitted:]
    # its own run from the start: its ledger holds the same rows
    again, res = run(reader)
    assert again == full
    led = res.metrics.job_obs.ledger
    assert led.verify_anchors(side[reader][3]._read_meta(path)["ledger"]) is None
    bad = {k: dict(v) for k, v in anchors.items()}
    bad["sink0"]["digest"] = "0" * 64
    assert led.verify_anchors(bad) is not None
