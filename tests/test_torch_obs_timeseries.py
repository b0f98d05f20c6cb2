"""Counterparts of the JAX package's tests/test_obs_timeseries.py over
both packages (fixture ``pk``): ``TimeSeries`` windowed statistics
against numpy, the cumulative baseline, capacity folding, both merge
modes, counter history and snapshot rates, the histogram reservoir
(exact count/sum over 100k observations), the snapshotter's absolute
deadline grid, and the pipeline profiler's stage attribution.

The adaptive controller (``runtime/controller.py``, a copy in the port)
runs over both packages too: a kept probe, a reverted one, the backoff
on a p99 breach, the user bounds and the series it mints.
``Runner.apply_knobs`` runs on a stub of the port's Runner (the depths
follow the knobs; the live-state guard wins), and an adaptive job's rows
equal those of the same job with obs off, with decisions recorded.
"""

import numpy as np
import pytest

from tests.test_torch_obs import pk  # noqa: F401


def pinned_registry(pk):
    """Registry on a settable fake clock with wall==perf epoch, so
    exposition timestamps are exactly sample-time * 1000."""
    reg = pk.MetricsRegistry()
    clk = [100.0]
    reg.now = lambda: clk[0]
    reg._epoch_wall = 0.0
    reg._epoch_perf = 0.0
    return reg, clk


def test_sample_series_windowed_stats_match_numpy(pk):
    ts = pk.TimeSeries(capacity=512, kind="sample")
    rng = np.random.default_rng(3)
    vals = rng.exponential(scale=2.0, size=200)
    for i, v in enumerate(vals):
        ts.record(float(i), float(v))
    # full-history stats
    assert ts.mean() == pytest.approx(float(vals.mean()))
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert ts.quantile(q) == pytest.approx(
            float(np.percentile(vals, q * 100)), rel=1e-9
        )
    # windowed: last 50 samples (t in (149, 199])
    tail = vals[150:]
    assert ts.mean(50.0) == pytest.approx(float(tail.mean()))
    assert ts.quantile(0.5, 50.0) == pytest.approx(
        float(np.percentile(tail, 50)), rel=1e-9
    )


def test_cumulative_series_rate_uses_pre_window_baseline(pk):
    ts = pk.TimeSeries(kind="cumulative")
    for t in range(11):  # counter grows 7/s from t=0..10
        ts.record(float(t), 7.0 * t)
    # window (6, 10]: baseline is the sample AT the window start t=6
    assert ts.delta(4.0) == pytest.approx(7.0 * 4)
    assert ts.rate(4.0) == pytest.approx(7.0)
    # the whole history
    assert ts.rate(10.0) == pytest.approx(7.0)
    assert ts.last() == (10.0, 70.0)


def test_sample_series_capacity_folds_not_forgets(pk):
    ts = pk.TimeSeries(capacity=64, kind="sample", digest=32)
    n = 5000
    for i in range(n):
        ts.record(float(i), float(i % 100))
    assert len(ts) <= 64 + 32
    assert ts.total_samples == n
    # the folded digest keeps the global mean exact (weighted means are
    # lossless under folding) and the quantile close
    exact = np.array([i % 100 for i in range(n)], dtype=float)
    assert ts.mean() == pytest.approx(float(exact.mean()))
    assert ts.quantile(0.5) == pytest.approx(
        float(np.percentile(exact, 50)), abs=5.0
    )


def test_cumulative_merge_is_a_step_sum(pk):
    a = pk.TimeSeries(kind="cumulative")
    b = pk.TimeSeries(kind="cumulative")
    for t in range(11):
        a.record(float(t), 3.0 * t)   # shard A: 3/s
        b.record(float(t), 5.0 * t)   # shard B: 5/s
    merged = pk.TimeSeries(kind="cumulative")
    merged.merge_from(a)
    merged.merge_from(b)
    assert merged.last() == (10.0, 80.0)
    assert merged.rate(10.0) == pytest.approx(8.0)
    assert merged.rate(4.0) == pytest.approx(8.0)


def test_sample_merge_pools_observations(pk):
    a = pk.TimeSeries(kind="sample")
    b = pk.TimeSeries(kind="sample")
    va = [1.0, 2.0, 3.0, 4.0]
    vb = [10.0, 20.0]
    for i, v in enumerate(va):
        a.record(float(i), v)
    for i, v in enumerate(vb):
        b.record(float(i) + 0.5, v)
    merged = pk.TimeSeries(kind="sample")
    merged.merge_from(a)
    merged.merge_from(b)
    pooled = np.array(va + vb)
    assert merged.total_samples == len(pooled)
    assert merged.mean() == pytest.approx(float(pooled.mean()))
    assert merged.quantile(0.5) == pytest.approx(
        float(np.percentile(pooled, 50)), rel=1e-9
    )


def test_counter_history_and_snapshot_rate(pk):
    reg, clk = pinned_registry(pk)
    c = reg.group(job="j").counter("records_in")
    for t, n in ((101.0, 500), (102.0, 700), (103.0, 800)):
        clk[0] = t
        c.inc(n)
    # rate over the (100, 103] window: 2000 rows in 3 s — the mint-time
    # zero anchor gives the first inc a baseline
    assert c.history.rate(3.0) == pytest.approx(2000.0 / 3.0)
    snap = reg.snapshot()
    row = next(s for s in snap["series"] if s["name"] == "records_in")
    assert row["ts_ms"] == 103000
    assert row["rate_per_s"] > 0


def test_histogram_reservoir_keeps_exact_count_sum_over_100k(pk):
    """Satellite regression: a registry-minted histogram under the
    default reservoir stays bounded while count/sum stay exact."""
    reg, clk = pinned_registry(pk)
    h = reg.group(job="j").histogram("emit_latency_s")
    n = 100_000
    for i in range(n):
        h.observe(float(i + 1))
    assert len(h.samples) <= 4096
    assert h.count == n
    assert h.sum == pytest.approx(n * (n + 1) / 2.0)
    # the uniform reservoir keeps quantiles representative (Algorithm R
    # over a uniform ramp: p50 within a few percent of the true median)
    assert h.percentile(50) == pytest.approx(n / 2.0, rel=0.10)


def test_histogram_reservoir_config_knob(pk):
    reg = pk.MetricsRegistry()
    reg.default_reservoir = 128  # what JobObs sets from ObsConfig
    h = reg.group(job="j").histogram("x")
    h.observe_many(range(10_000))
    assert len(h.samples) == 128
    assert h.count == 10_000


def test_snapshotter_slow_tick_does_not_shift_cadence(pk):
    reg, _ = pinned_registry(pk)
    clk = [0.0]
    snapper = pk.Snapshotter(
        reg, interval_s=1.0, meta={"job": "j"}, clock=lambda: clk[0]
    )
    clk[0] = 0.5
    assert snapper.maybe_snapshot() is None
    clk[0] = 1.2  # 200 ms late
    s1 = snapper.maybe_snapshot()
    assert s1 is not None
    assert s1["meta"]["tick_skew_ms"] == pytest.approx(200.0, abs=1e-6)
    clk[0] = 1.9  # next deadline is 2.0 on the GRID, not 1.2 + 1.0
    assert snapper.maybe_snapshot() is None
    # a long stall: deadlines 2, 3, 4 missed — exactly ONE tick fires
    # (no burst), with the lateness on the books
    clk[0] = 4.7
    s2 = snapper.maybe_snapshot()
    assert s2 is not None
    assert s2["meta"]["tick_skew_ms"] == pytest.approx(2700.0, abs=1e-6)
    clk[0] = 4.95
    assert snapper.maybe_snapshot() is None
    clk[0] = 5.05  # grid deadline 5.0: cadence never drifted
    s3 = snapper.maybe_snapshot()
    assert s3 is not None
    assert s3["meta"]["tick_skew_ms"] == pytest.approx(50.0, abs=1e-6)
    skews = [
        s for s in s3["metrics"]["series"]
        if s["name"] == "snapshotter_tick_skew_ms"
    ]
    assert skews and skews[0]["value"]["count"] == 3


def test_profiler_attributes_batch_time_to_stages(pk):
    tr = pk.StepTracer(capacity=64)
    tr._epoch = 0.0
    for i in range(4):
        t = 1.0 + i
        tr._record("parse", i, "src", t, 0.002)
        tr._record("h2d", i, "window", t + 0.003, 0.004)
        tr._record("dispatch", i, "window", t + 0.008, 0.010)
    reg, _ = pinned_registry(pk)
    prof = pk.PipelineProfiler(
        tr, reg.group(job="p"), window_s=60.0, clock=lambda: 6.0
    )
    p = prof.profile()
    assert p["binding_stage"] == "dispatch"
    assert p["binding_share"] == pytest.approx(10.0 / 16.0, abs=1e-6)
    assert p["stages"]["parse"]["n"] == 4
    assert p["stages"]["parse"]["mean_ms"] == pytest.approx(2.0, abs=1e-6)
    assert sum(s["share"] for s in p["stages"].values()) == pytest.approx(1.0)
    prom = reg.to_prometheus_text()
    assert "profile_binding_stage" in prom and 'stage="dispatch"' in prom


# ---------------------------------------------------------------------------
# the adaptive controller, over both packages
# ---------------------------------------------------------------------------


def make_controller(pk, **obs_over):
    import importlib

    controller = importlib.import_module(
        pk.root + ".runtime.controller").AdaptiveController
    obs_over.setdefault("adaptive_cooldown_ticks", 0)
    obs_cfg = pk.ObsConfig(enabled=True, adaptive=True,
                           snapshot_interval_s=1.0, **obs_over)
    cfg = pk.StreamConfig(obs=obs_cfg)
    job_obs = pk.JobObs(obs_cfg, job_name="ctl")
    reg = job_obs.registry
    clk = [100.0]
    reg.now = lambda: clk[0]
    reg._epoch_wall = 0.0
    reg._epoch_perf = 0.0
    ctl = controller(cfg, job_obs)
    return ctl, job_obs, clk, job_obs.counter("records_in")


def controller_events(job_obs):
    return [e for e in job_obs.flight.events()
            if e["kind"] == "controller_decision"]


def test_adaptive_is_off_by_default(pk):
    assert pk.ObsConfig().adaptive is False


def test_controller_keeps_improving_probe(pk):
    ctl, job_obs, clk, ingest = make_controller(pk)
    start = dict(ctl.knobs)
    clk[0] = 101.0
    ingest.inc(1000)
    clk[0] = 102.0
    knobs = ctl.on_tick()  # probes the first knob up one step
    assert knobs["async_depth"] == start["async_depth"] + 1
    clk[0] = 103.0
    ingest.inc(4000)  # the rate doubles, well past the hysteresis band
    clk[0] = 104.0
    assert ctl.on_tick() is None  # kept: nothing further to apply
    assert ctl.knobs["async_depth"] == start["async_depth"] + 1
    assert [e["action"] for e in controller_events(job_obs)] == [
        "probe", "keep"]
    for k, v in ctl.knobs.items():
        lo, hi = ctl.bounds[k]
        assert lo <= v <= hi


def test_controller_reverts_flat_probe_and_flips_direction(pk):
    ctl, job_obs, clk, ingest = make_controller(pk)
    start = dict(ctl.knobs)
    clk[0] = 101.0
    ingest.inc(1000)
    clk[0] = 102.0
    assert ctl.on_tick()["async_depth"] == start["async_depth"] + 1
    clk[0] = 103.0
    ingest.inc(1000)  # the same rate: inside the hysteresis band
    clk[0] = 104.0
    knobs = ctl.on_tick()
    assert knobs["async_depth"] == start["async_depth"]
    assert ctl._dir["async_depth"] == -1
    assert int(ctl._reverts.value) == 1
    assert [e["action"] for e in controller_events(job_obs)] == [
        "probe", "revert"]


def test_controller_backs_off_on_p99_breach(pk):
    ctl, job_obs, clk, ingest = make_controller(pk, adaptive_p99_ms=300.0)
    start = dict(ctl.knobs)
    lat = job_obs.histogram("emit_latency_s")
    clk[0] = 101.0
    ingest.inc(1000)
    lat.observe(0.5)  # 500 ms against a 300 ms bound
    clk[0] = 102.0
    knobs = ctl.on_tick()
    for k in ("async_depth", "h2d_depth"):
        assert knobs[k] == max(ctl.bounds[k][0], start[k] - 1)
    evs = controller_events(job_obs)
    assert evs and evs[-1]["action"] == "backoff"
    assert evs[-1]["p99_ms"] == pytest.approx(500.0, rel=1e-6)


def test_controller_respects_user_bounds(pk):
    ctl, _, clk, ingest = make_controller(
        pk, adaptive_bounds={"async_depth": (1, 2), "bogus_knob": (0, 99)})
    assert ctl.bounds["async_depth"] == (1, 2)
    assert "bogus_knob" not in ctl.bounds
    for i in range(12):
        clk[0] = 101.0 + i
        ingest.inc(1000 * (i + 1))
        clk[0] += 0.5
        ctl.on_tick()
        assert 1 <= ctl.knobs["async_depth"] <= 2


def test_controller_series_surface(pk):
    ctl, job_obs, clk, ingest = make_controller(pk)
    clk[0] = 101.0
    ingest.inc(1000)
    clk[0] = 102.0
    ctl.on_tick()
    names = {s["name"] for s in job_obs.registry.snapshot()["series"]}
    for want in ("controller_async_depth", "controller_fetch_group",
                 "controller_h2d_depth", "controller_decisions_total",
                 "controller_objective_rows_per_s"):
        assert want in names, want


# ---------------------------------------------------------------------------
# Runner.apply_knobs of the port, on a stub
# ---------------------------------------------------------------------------


def _stub_runner(ref_state=False, max_fires=None):
    import types

    from tpustream_torch.config import StreamConfig
    from tpustream_torch.runtime.executor import Runner

    resized = []
    stub = types.SimpleNamespace(
        cfg=StreamConfig(device="cpu", async_depth=2, fetch_group=1,
                         h2d_depth=2, max_fires_per_step=max_fires),
        program=types.SimpleNamespace(emissions_reference_state=ref_state),
        _max_inflight=0 if ref_state else 1,
        _h2d_ahead=0 if ref_state else 1,
        _wire=types.SimpleNamespace(resize=resized.append),
    )
    stub._stage_ok = lambda: Runner._stage_ok(stub)
    return stub, (lambda knobs: Runner.apply_knobs(stub, knobs)), resized


def test_apply_knobs_sets_depths_and_cfg():
    stub, apply_knobs, resized = _stub_runner()
    apply_knobs({"async_depth": 4, "fetch_group": 3, "h2d_depth": 3})
    assert stub._max_inflight == 3
    assert stub._h2d_ahead == 2
    assert (stub.cfg.async_depth, stub.cfg.fetch_group, stub.cfg.h2d_depth) == (
        4, 3, 3)
    assert resized == [4]  # the pinned ring: h2d_depth + 1 slots


@pytest.mark.parametrize("ref_state,max_fires", [(True, None), (False, 2)],
                         ids=["live-state", "fire-budget"])
def test_apply_knobs_live_state_guard_wins(ref_state, max_fires):
    """A state-referencing program stays at depth 1 and unstaged, and a
    fire budget stays unstaged, whatever the controller asks for."""
    stub, apply_knobs, _ = _stub_runner(ref_state, max_fires)
    apply_knobs({"async_depth": 4, "h2d_depth": 4})
    assert stub._h2d_ahead == 0
    assert stub._max_inflight == (0 if ref_state else 3)
    assert stub.cfg.async_depth == 4  # the request is recorded


def test_adaptive_controller_end_to_end_output_parity():
    import tpustream_torch as T
    from tpustream_torch.config import ObsConfig
    from tpustream_torch.runtime.sources import ReplaySource

    lines = [f"1 k{i % 5} {(i * 7) % 97}" for i in range(60)]

    def run(obs):
        env = T.StreamExecutionEnvironment(
            T.StreamConfig(device="cpu", batch_size=4, obs=obs))
        h = (env.add_source(ReplaySource(lines))
             .map(lambda line: T.Tuple2(line.split(" ")[1],
                                        int(line.split(" ")[2])))
             .key_by(0).sum(1).collect())
        env.execute("adaptive-parity")
        return [tuple(t) for t in h.items], env.metrics

    want, _ = run(ObsConfig(enabled=False))
    got, m = run(ObsConfig(enabled=True, adaptive=True,
                           snapshot_interval_s=1e-4,
                           adaptive_cooldown_ticks=0))
    assert got == want  # knob moves never change output
    names = {s["name"] for s in m.obs_snapshot()["metrics"]["series"]}
    assert {"controller_async_depth", "controller_decisions_total"} <= names
    evs = [e for e in m.job_obs.flight.events()
           if e["kind"] == "controller_decision"]
    assert evs, "ticks at flood rate must produce at least one decision"
    assert all(e["action"] in ("probe", "keep", "revert", "backoff")
               for e in evs)
