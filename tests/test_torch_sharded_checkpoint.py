"""Snapshots and supervised recovery of the PyTorch port's sharded
programs, on the CPU, side by side with the JAX package.

* Interchange: a snapshot written by either package at parallelism 8
  restores in both packages at parallelism 8, 4 and 1, and the two
  packages resume it into the same rows, in order; those rows are the
  uninterrupted run's remaining rows (as a multiset when the
  parallelism changed, since the emission order depends on it). The
  window's flat word planes, the rolling planes and the sliding count
  window's element log are covered.
* Supervised recovery at parallelism 8: a crash at data step 5 (the
  ``device_step`` fault point) and one inside the keyBy (the
  ``exchange`` fault point, raised on one shard's thread while the
  others wait in the all-to-all) restart from the latest checkpoint and
  reproduce the uninterrupted run, which equals the JAX package's.

Tolerance: none; rows are compared exactly.
"""

import glob
import os
from importlib import import_module

import pytest

import tpustream
import tpustream_torch

SHARD_CFG = dict(batch_size=16, key_capacity=64, print_parallelism=1)


def _pkg(side):
    return tpustream if side == "jax" else tpustream_torch


def et_items(minutes=8):
    return [f"2019-08-28T10:{m:02d}:{s:02d} www.ch{(m * 3 + s) % 5}.com "
            f"{100 + m * 10}" for m in range(minutes) for s in (0, 20, 40)]


def rolling_items():
    return [f"15634520{i:02d} 10.8.22.{i % 11} cpu{i % 3} {40 + (i * 13) % 60}.5"
            for i in range(48)]


def count_items():
    return [f"k{i % 7} {2 ** (i % 9)}" for i in range(48)]


def build_window(pkg, text):
    mod = import_module(pkg.__name__ + ".jobs.chapter3_bandwidth_eventtime")
    return mod.build(None, text)


def build_rolling(pkg, text):
    return import_module(pkg.__name__ + ".jobs.chapter2_max").build(None, text)


def build_sliding_count(pkg, text):
    return (text.map(lambda l: pkg.Tuple2(l.split(" ")[0],
                                          float(l.split(" ")[1])))
            .key_by(0).count_window(4, 2)
            .reduce(lambda a, b: pkg.Tuple2(a.f0, a.f1 + b.f1)))


JOBS = {
    "window": (build_window, et_items, True),
    "rolling": (build_rolling, rolling_items, False),
    "sliding_count": (build_sliding_count, count_items, False),
}


def run(side, job, parallelism, ckdir=None, restore=None, injector=None,
        strategy=None, items=None, **over):
    build, make_items, event_time = JOBS[job]
    pkg = _pkg(side)
    sources = import_module(pkg.__name__ + ".runtime.sources")
    cfg = dict(SHARD_CFG, parallelism=parallelism, **over)
    if side == "torch":
        cfg["device"] = "cpu"
    if ckdir is not None:
        cfg.update(checkpoint_dir=str(ckdir), checkpoint_interval_batches=1)
    config = pkg.StreamConfig(**cfg)
    if injector is not None:
        config = injector.install(config)
    env = pkg.StreamExecutionEnvironment(config)
    if event_time:
        env.set_stream_time_characteristic(pkg.TimeCharacteristic.EventTime)
    if strategy is not None:
        env.set_restart_strategy(strategy)
    if restore is not None:
        env.restore_from_checkpoint(restore)
    items = make_items() if items is None else items
    h = build(pkg, env.add_source(sources.ReplaySource(items))).collect()
    env.execute("sharded-checkpoint")
    return [repr(t) for t in h.items]


def mid_snapshot(ckdir, load, n_rows):
    """The oldest snapshot written after some rows and before the last."""
    for snap in sorted(glob.glob(os.path.join(str(ckdir), "ckpt-*.npz"))):
        ck = load(snap)
        if 0 < ck.emitted < n_rows:
            return snap, ck.emitted
    raise AssertionError("no snapshot inside the run")


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("job", sorted(JOBS))
def test_eight_shard_snapshot_restores_in_both_packages(job, writer, tmp_path):
    full = run(writer, job, 8, ckdir=tmp_path / "ck")
    assert full == run("torch" if writer == "jax" else "jax", job, 8)
    load = import_module(_pkg(writer).__name__
                         + ".runtime.checkpoint").load_checkpoint
    snap, emitted = mid_snapshot(tmp_path / "ck", load, len(full))
    for p in (8, 4, 1):
        got = run("torch", job, p, restore=snap)
        want = run("jax", job, p, restore=snap)
        assert got == want, f"restore at parallelism {p}"
        if p == 8:
            assert got == full[emitted:]
        else:
            assert sorted(got) == sorted(full[emitted:])


@pytest.mark.parametrize("point", ["device_step", "exchange"])
def test_eight_shard_supervised_crash_recovers(point, tmp_path):
    from tpustream_torch.runtime.supervisor import fixed_delay
    from tpustream_torch.testing import FaultInjector, FaultPoint

    items = et_items(minutes=16)  # 6 data steps of 8 rows
    full = run("torch", "window", 8, items=items, batch_size=8)
    assert full == run("jax", "window", 8, items=items, batch_size=8)
    inj = FaultInjector(FaultPoint(point, at=5))
    out = run("torch", "window", 8, ckdir=tmp_path, injector=inj,
              strategy=fixed_delay(3, 0.0), items=items, batch_size=8)
    assert inj.fired == 1
    assert out == full
