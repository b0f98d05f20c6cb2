"""The chapter-2 rolling-max job through the PyTorch port, on the CPU:
the reference golden transcript and its edge cases
(tests/test_chapter2_max_golden.py), and a side-by-side run against the
JAX package with identical rows and identical ``print()`` bytes."""

import numpy as np
import pytest

import tpustream
import tpustream.jobs.chapter2_max as jax_job
import tpustream.runtime.sources as jax_sources
import tpustream_torch
import tpustream_torch.jobs.chapter2_max as torch_job
import tpustream_torch.runtime.sources as torch_sources


def run(lines, **cfg):
    env = tpustream_torch.StreamExecutionEnvironment(
        tpustream_torch.StreamConfig(device="cpu", **cfg))
    text = env.add_source(torch_sources.ReplaySource(lines))
    handle = torch_job.build(env, text).collect()
    env.execute("ComputeCpuMax")
    return handle.items


def test_rolling_max_golden():
    out = run(
        [
            "1563452056 10.8.22.1 cpu0 80.5",
            "1563452050 10.8.22.1 cpu0 78.4",
            "1563452056 10.8.22.1 cpu0 99.9",
        ]
    )
    assert [repr(t) for t in out] == [
        "(10.8.22.1,cpu0,80.5)",
        "(10.8.22.1,cpu0,80.5)",
        "(10.8.22.1,cpu0,99.9)",
    ]


def test_rolling_max_keeps_first_seen_fields():
    out = run(
        [
            "1 10.8.22.1 cpu0 50.0",
            "2 10.8.22.1 cpu7 60.0",
            "3 10.8.22.1 cpu3 55.0",
        ]
    )
    assert [repr(t) for t in out] == [
        "(10.8.22.1,cpu0,50.0)",
        "(10.8.22.1,cpu0,60.0)",
        "(10.8.22.1,cpu0,60.0)",
    ]


def test_rolling_max_multi_key_and_batches():
    lines = []
    rows = []
    vals = [(("h%d" % (i % 3)), 10.0 + ((i * 7) % 50)) for i in range(60)]
    for i, (h, v) in enumerate(vals):
        lines.append(f"{i} {h} cpu{i%2} {v}")
    state = {}
    for i, (h, v) in enumerate(vals):
        if h not in state:
            state[h] = [h, f"cpu{i%2}", v]
        else:
            state[h][2] = max(state[h][2], v)
        rows.append(tuple(state[h]))
    out_big = run(lines)
    out_small = run(lines, batch_size=7)
    assert [t.values() for t in out_big] == rows
    assert out_big == out_small


def _run_kind(lines, kind):
    env = tpustream_torch.StreamExecutionEnvironment(
        tpustream_torch.StreamConfig(device="cpu"))
    s = env.add_source(torch_sources.ReplaySource(lines)).map(
        torch_job.parse).key_by(0)
    h = getattr(s, kind)(2).collect()
    env.execute("k")
    return h.items


def test_rolling_min_and_sum():
    lines = ["1 h1 c 5.0", "2 h1 c 3.0", "3 h1 c 4.0"]
    assert [t.f2 for t in _run_kind(lines, "min")] == [5.0, 3.0, 3.0]
    assert [t.f2 for t in _run_kind(lines, "sum")] == [5.0, 8.0, 12.0]


def test_rolling_max_by_replaces_whole_record():
    # max_by takes the reference's general rolling path, which this
    # slice of the port leaves out: it must refuse, naming the feature
    lines = ["1 h1 cpu0 50.0", "2 h1 cpu7 60.0", "3 h1 cpu3 55.0"]
    with pytest.raises(NotImplementedError, match="max_by"):
        _run_kind(lines, "max_by")


def _lines(n, n_hosts, seed):
    rng = np.random.default_rng(seed)
    hosts = rng.integers(0, n_hosts, n)
    cpus = rng.integers(0, 8, n)
    usage = rng.integers(0, 10000, n) / 100
    return [f"{1563452000 + i} 10.8.0.{h} cpu{c} {u}"
            for i, (h, c, u) in enumerate(zip(hosts, cpus, usage))]


def _side_by_side(pkg, job, sources, lines, capsys, **cfg):
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(batch_size=64, **cfg))
    stream = job.build(env, env.add_source(sources.ReplaySource(lines)))
    handle = stream.collect()
    stream.print()
    capsys.readouterr()
    env.execute("ComputeCpuMax")
    return [repr(t) for t in handle.items], capsys.readouterr().out


def test_side_by_side_with_jax_package(capsys):
    lines = _lines(2000, 50, seed=9)
    want_rows, want_out = _side_by_side(
        tpustream, jax_job, jax_sources, lines, capsys)
    got_rows, got_out = _side_by_side(
        tpustream_torch, torch_job, torch_sources, lines, capsys, device="cpu")
    assert len(got_rows) == 2000
    assert got_rows == want_rows
    assert got_out.count("\n") == 2000
    assert got_out == want_out


@pytest.mark.parametrize("kind", ["min", "sum"])
def test_side_by_side_min_sum_with_jax_package(kind):
    # sum: f64 usage in hundredths, 40 rows a key; the reference adds a
    # batch's rows in tree order and the port in arrival order, so the
    # rows agree to rtol=1e-12, not bit for bit
    lines = _lines(600, 15, seed=10)

    def rows(pkg, job, sources, **cfg):
        env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(batch_size=64, **cfg))
        h = getattr(env.add_source(sources.ReplaySource(lines)).map(job.parse)
                    .key_by(0), kind)(2).collect()
        env.execute("k")
        return [t.values() for t in h.items]

    want = rows(tpustream, jax_job, jax_sources)
    got = rows(tpustream_torch, torch_job, torch_sources, device="cpu")
    assert [r[:2] for r in got] == [r[:2] for r in want]
    if kind == "min":
        assert got == want
    else:
        np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                                   rtol=1e-12, atol=0)


def test_key_past_capacity_fails_the_step_before_any_row_is_emitted(monkeypatch):
    # the keyed state normally grows before a batch whose keys would pass
    # it; with growth switched off the step's device counter of
    # out-of-range keys makes the Runner raise before its sink sees a row
    from tpustream_torch.runtime import executor

    monkeypatch.setattr(executor.Runner, "_check_capacity", lambda self: None)
    lines = [f"{i} 10.0.0.{i} cpu0 {i}.5" for i in range(6)]
    env = tpustream_torch.StreamExecutionEnvironment(
        tpustream_torch.StreamConfig(device="cpu", batch_size=3, key_capacity=4))
    handle = torch_job.build(
        env, env.add_source(torch_sources.ReplaySource(lines))).collect()
    with pytest.raises(IndexError, match="capacity of 4"):
        env.execute("ComputeCpuMax")
    # the first batch (keys 0..2) went out whole; the second (keys 3..5,
    # two past the capacity) emitted nothing
    assert [repr(t) for t in handle.items] == [
        f"(10.0.0.{i},cpu0,{i}.5)" for i in range(3)]
