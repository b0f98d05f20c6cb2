"""The chapter-1 threshold job through the PyTorch port, on the CPU: the
reference golden transcripts (tests/test_chapter1_golden.py) and
side-by-side runs against the JAX package on seeded inputs, with
identical rows and identical ``print()`` bytes (tolerance: bitwise)."""

import numpy as np
import pytest

import tpustream
import tpustream.jobs.chapter1_threshold as jax_job
import tpustream.runtime.sources as jax_sources
import tpustream_torch
import tpustream_torch.jobs.chapter1_threshold as torch_job
import tpustream_torch.runtime.sources as torch_sources
from tpustream_torch.runtime.sources import ReplaySource


def run_filter_job(lines, **cfg):
    env = tpustream_torch.StreamExecutionEnvironment(
        tpustream_torch.StreamConfig(device="cpu", **cfg))
    text = env.add_source(ReplaySource(lines))
    handle = torch_job.build(env, text).collect()
    env.execute("Window WordCount")
    return handle.items


def test_filter_gt90_golden():
    # chapter1/README.md:114-123: only the 99.2 record survives
    out = run_filter_job(
        [
            "1563452051 10.8.22.1 cpu2 10.5",
            "1563452051 10.8.22.1 cpu2 99.2",
        ]
    )
    assert out == [("10.8.22.1", "cpu2", 99.2)]
    assert repr(out[0]) == "(10.8.22.1,cpu2,99.2)"


def test_passthrough_map_golden(capsys):
    # chapter1/README.md:72-84: map+print with no filter
    env = tpustream_torch.StreamExecutionEnvironment(
        tpustream_torch.StreamConfig(device="cpu", print_parallelism=4))
    text = env.add_source(
        ReplaySource(
            [
                "1563452056 10.8.22.1 cpu0 80.5",
                "1563452051 10.8.22.1 cpu2 10.5",
                "1563452051 10.8.22.1 cpu2 10.5",
            ]
        )
    )
    text.map(torch_job.parse).print()
    env.execute("Window WordCount")
    lines = capsys.readouterr().out.strip().splitlines()
    payloads = [l.split("> ", 1)[1] for l in lines]
    assert payloads == [
        "(10.8.22.1,cpu0,80.5)",
        "(10.8.22.1,cpu2,10.5)",
        "(10.8.22.1,cpu2,10.5)",
    ]
    for l in lines:
        assert l[0] in "1234" and l[1:3] == "> "


def test_small_batches_equivalent():
    lines = [f"1563452051 10.8.22.{i%4} cpu{i%3} {50 + (i % 60)}.5" for i in range(100)]
    big = run_filter_job(lines)
    small = run_filter_job(lines, batch_size=7)
    assert big == small
    expected = [
        (f"10.8.22.{i%4}", f"cpu{i%3}", 50 + (i % 60) + 0.5)
        for i in range(100)
        if 50 + (i % 60) + 0.5 > 90
    ]
    assert big == expected


def test_only_kept_rows_are_copied_back():
    # the step compacts the kept rows on the device: the host copies the
    # count, then only those rows; once a step has fired, each later
    # step's copy of its count also carries a slice of the prefix sized
    # by the last firing step (twice its power-of-two bucket, at least
    # 32 rows), which serves a step whose count fits with one wait
    lines = [f"1 h{i % 5} cpu0 {91.5 if i % 16 == 0 else 50.5}" for i in range(256)]
    env = tpustream_torch.StreamExecutionEnvironment(
        tpustream_torch.StreamConfig(device="cpu", batch_size=64))
    h = torch_job.build(env, env.add_source(ReplaySource(lines))).collect()
    env.execute("Window WordCount")
    m = env.metrics.summary()
    assert len(h.items) == 16 and m["records_emitted"] == 16
    # a row is (int32 host, int32 cpu, float64 usage): 16 bytes. Per
    # batch a 4-byte count. At the default async_depth of 2 the second
    # batch is issued before the first one's count is read: the first
    # two batches copy their 4 rows after their count, the last two a
    # 32-row slice with it and nothing after; 8 bytes for the overflow
    # counter at the end
    row = 16
    assert m["d2h_bytes"] == 4 * 4 + 2 * 4 * row + 2 * 32 * row + 8
    # a wait a batch, one more for each of the first two batches' rows,
    # and one for the counter
    assert m["d2h_syncs"] == 4 + 2 + 1
    assert m["alert_overflow"] == 0


def seeded_lines(n, seed):
    """``ts host cpuN usage`` lines: 12 hosts, usage in hundredths, about
    one line in ten above the threshold."""
    rng = np.random.default_rng(seed)
    hosts = rng.integers(0, 12, n)
    cpus = rng.integers(0, 4, n)
    usage = np.where(rng.random(n) < 0.1, rng.integers(9001, 10000, n),
                     rng.integers(0, 9000, n)) / 100
    return [f"{1563452000 + i} 10.8.0.{h} cpu{c} {u}"
            for i, (h, c, u) in enumerate(zip(hosts, cpus, usage))]


def _side(pkg, job, sources, lines, capsys, **cfg):
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(print_parallelism=4, **cfg))
    stream = job.build(env, env.add_source(sources.ReplaySource(lines)))
    handle = stream.collect()
    stream.print()
    capsys.readouterr()
    env.execute("Window WordCount")
    return [repr(t) for t in handle.items], capsys.readouterr().out


@pytest.mark.parametrize("batch_size", [1, 3, 64])
def test_side_by_side_with_jax_package(batch_size, capsys):
    lines = seeded_lines(400, seed=batch_size)
    want = _side(tpustream, jax_job, jax_sources, lines, capsys,
                 batch_size=batch_size)
    got = _side(tpustream_torch, torch_job, torch_sources, lines, capsys,
                device="cpu", batch_size=batch_size)
    assert len(got[0]) > 20
    assert got[0] == want[0]
    assert got[1] == want[1]  # print() bytes, subtask prefixes included
