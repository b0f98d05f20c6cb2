"""Counterparts of the JAX package's tests/test_obs_timeseries.py over
both packages (fixture ``pk``): ``TimeSeries`` windowed statistics
against numpy, the cumulative baseline, capacity folding, both merge
modes, counter history and snapshot rates, the histogram reservoir
(exact count/sum over 100k observations), the snapshotter's absolute
deadline grid, and the pipeline profiler's stage attribution.

The JAX suite's nine adaptive-controller cases (``runtime/controller.py``
and ``Runner.apply_knobs``) have no counterpart yet: the controller
tunes the pipelining knobs (``async_depth``, ``h2d_depth``,
``fetch_group``), which the port does not read until its executor
pipeline is ported.
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
