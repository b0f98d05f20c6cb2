"""Supervised recovery on the 8-shard mesh and the multi-fault soak,
through the PyTorch port on the CPU: the five cases of the JAX
package's ``tests/test_recovery_sharded.py``, each held against the JAX
package's run on the same inputs and against the port's own
uninterrupted run.

* a ``device_step`` and an ``exchange`` fault at parallelism 8 restart
  from the latest snapshot and give the uninterrupted rows, in order;
* a snapshot written at parallelism 1 is restored by the supervisor at
  parallelism 8 on its restart path: the rows equal the JAX package's
  restore of the same snapshot at parallelism 8, in order, and the
  uninterrupted run's remaining rows as a multiset;
* a ``checkpoint_write`` fault in the writer thread restarts from the
  newest valid snapshot, and every retained manifest validates in both
  packages;
* a seeded storm of ``device_step``, ``source_read`` and ``sink_emit``
  faults over poisoned lines converges to the clean rows; the faults
  fire at the same occurrences as in the JAX package's run of the same
  storm, and the dead letters are the JAX package's.

The JAX package's uninterrupted runs are made once for the file, one
module fixture a set of lines. Tolerance: none (rows compare as
``repr`` strings).
"""

import glob
import os
from importlib import import_module

import pytest

import tpustream
import tpustream_torch

LINES = [
    f"15634520{i:02d} 10.8.22.{i % 5} cpu{i % 3} {40 + (i * 13) % 60}.5"
    for i in range(24)
]
SOAK_LINES = [
    f"15634520{i:02d} 10.8.22.{i % 5} cpu{i % 3} {40 + (i * 13) % 60}.5"
    for i in range(32)
]
SHARD_CFG = dict(
    parallelism=8, batch_size=8, key_capacity=64, print_parallelism=1
)


def _mod(pkg, name):
    return import_module(f"{pkg.__name__}.{name}")


def run(pkg, items, ckdir=None, strategy=None, injector=None, restore=None,
        **over):
    """``(env, rows)`` of the chapter-2 max over ``items`` through
    ``pkg``, as the JAX package's ``test_recovery_sharded.run``."""
    over.setdefault("batch_size", 8)
    if pkg is tpustream_torch:
        over["device"] = "cpu"
    cfg = pkg.StreamConfig(**over)
    if ckdir is not None:
        cfg = cfg.replace(
            checkpoint_dir=str(ckdir), checkpoint_interval_batches=1)
    if injector is not None:
        cfg = injector.install(cfg)
    env = pkg.StreamExecutionEnvironment(cfg)
    if strategy is not None:
        env.set_restart_strategy(strategy)
    if restore is not None:
        env.restore_from_checkpoint(restore)
    text = env.add_source(_mod(pkg, "runtime.sources").ReplaySource(items))
    handle = _mod(pkg, "jobs.chapter2_max").build(env, text).collect()
    env.execute("recovery-sharded")
    return env, [repr(t) for t in handle.items]


def fault(pkg, *points, seed=0):
    testing = _mod(pkg, "testing")
    return testing.FaultInjector(
        *[testing.FaultPoint(name, **kw) for name, kw in points], seed=seed)


def fixed_delay(pkg, attempts):
    return _mod(pkg, "runtime.supervisor").fixed_delay(attempts, 0.0)


@pytest.fixture(scope="module")
def jax_lines(tmp_path_factory):
    """The JAX package's uninterrupted runs of ``LINES``: at parallelism
    8, and at 1 with a snapshot a batch (the directory is kept)."""
    ckdir = tmp_path_factory.mktemp("jax_p1")
    return {"p8": run(tpustream, LINES, **SHARD_CFG)[1],
            "p1": run(tpustream, LINES, ckdir=ckdir)[1], "p1_dir": ckdir}


@pytest.fixture(scope="module")
def jax_soak():
    """The JAX package's uninterrupted run of ``SOAK_LINES`` at batch 2."""
    return run(tpustream, SOAK_LINES, batch_size=2)[1]


@pytest.fixture(scope="module")
def torch_p8():
    return run(tpustream_torch, LINES, **SHARD_CFG)[1]


@pytest.mark.parametrize("point,at", [("device_step", 2), ("exchange", 1)])
def test_sharded_step_fault_recovers_exactly_once(point, at, tmp_path,
                                                  jax_lines, torch_p8):
    """A ``device_step`` fault on the p=8 mesh, and one inside the keyBy
    (the ``exchange`` point, which only meshes have): restart, restore
    onto fresh shards, the uninterrupted rows in order."""
    assert torch_p8 == jax_lines["p8"]
    inj = fault(tpustream_torch, (point, dict(at=at)))
    _, out = run(tpustream_torch, LINES, ckdir=tmp_path,
                 strategy=fixed_delay(tpustream_torch, 3), injector=inj,
                 **SHARD_CFG)
    assert inj.fired == 1
    assert out == torch_p8 == jax_lines["p8"]


def test_supervised_restart_rescales_the_p1_snapshot_to_p8(tmp_path,
                                                            jax_lines):
    """A snapshot written at p=1 is restored at p=8 by the supervisor on
    its restart path (a crash at the first data step after the
    restore). Its rows are the JAX package's restore of the same
    snapshot at p=8, in order."""
    load = _mod(tpustream_torch, "runtime.checkpoint").load_checkpoint
    ckdir = tmp_path / "p1"
    full = run(tpustream_torch, LINES, ckdir=ckdir)[1]
    assert full == jax_lines["p1"]
    snaps = sorted(glob.glob(os.path.join(str(ckdir), "ckpt-*.npz")))
    snap = next(s for s in snaps if 0 < load(s).emitted < len(full))
    ck = load(snap)
    inj = fault(tpustream_torch, ("device_step", dict(at=1)))
    _, out = run(tpustream_torch, LINES,
                 strategy=fixed_delay(tpustream_torch, 3), injector=inj,
                 restore=snap, **SHARD_CFG)
    assert inj.fired == 1
    # the emission order depends on the parallelism; the remaining
    # records, exactly once, do not
    assert sorted(out) == sorted(full[ck.emitted:])
    _, want = run(tpustream, LINES, restore=snap, **SHARD_CFG)
    assert out == want
    # the JAX package's own p=1 snapshot at the same batch restores into
    # the same rows
    jax_snap = os.path.join(str(jax_lines["p1_dir"]), os.path.basename(snap))
    assert run(tpustream_torch, LINES, restore=jax_snap, **SHARD_CFG)[1] == want


def test_sharded_checkpoint_write_fault_restores_a_valid_snapshot(
        tmp_path, jax_lines, torch_p8):
    """A crash in the writer thread mid-chunk-write on the p=8 mesh
    (the asynchronous incremental plane, the defaults): the failure
    re-raises at a barrier with its point, the supervisor restarts from
    the newest valid snapshot, the rows are the uninterrupted ones, and
    the store ends coherent: every retained manifest validates, in the
    port and in the JAX package."""
    inj = fault(tpustream_torch, ("checkpoint_write", dict(at=1)))
    _, out = run(tpustream_torch, LINES, ckdir=tmp_path,
                 strategy=fixed_delay(tpustream_torch, 3), injector=inj,
                 **SHARD_CFG)
    assert inj.fired == 1
    assert out == torch_p8 == jax_lines["p8"]
    port_ck = _mod(tpustream_torch, "runtime.checkpoint")
    jax_ck = _mod(tpustream, "runtime.checkpoint")
    assert port_ck.latest_checkpoint(str(tmp_path)) is not None
    manifests = glob.glob(os.path.join(str(tmp_path), "ckpt-*.npz"))
    assert manifests
    for p in manifests:
        assert port_ck.validate_checkpoint(p) is None, p
        assert jax_ck.validate_checkpoint(p) is None, p


SOAK_POINTS = [("device_step", dict(p=0.12, times=4)),
               ("source_read", dict(p=0.06, times=2)),
               ("sink_emit", dict(p=0.02, times=2))]


def test_multi_fault_soak_converges_as_the_jax_package(tmp_path, jax_soak):
    """A seeded fault storm over three points plus poisoned lines:
    ``fixed_delay(10)`` rides out every crash, the rows are the clean
    run's, the faults fire where they fire in the JAX package's run of
    the same storm, and the dead letters are the JAX package's."""
    want = run(tpustream_torch, SOAK_LINES, batch_size=2)[1]
    assert want == jax_soak
    poison = _mod(tpustream_torch, "testing").poison_lines
    poisoned, n = poison(SOAK_LINES, count=3, seed=13)
    envs, logs = {}, {}
    for pkg in (tpustream_torch, tpustream):
        inj = fault(pkg, *SOAK_POINTS, seed=99)
        envs[pkg], out = run(pkg, poisoned, ckdir=tmp_path / pkg.__name__,
                             strategy=fixed_delay(pkg, 10), injector=inj,
                             batch_size=2, dead_letter=True)
        assert out == want, pkg.__name__
        logs[pkg] = inj.log
    assert len(logs[tpustream_torch]) >= 2, \
        "the soak's seed produced too few faults to be a test"
    assert logs[tpustream_torch] == logs[tpustream]
    dead = envs[tpustream_torch].dead_letters
    assert len(dead) == n
    assert dead == envs[tpustream].dead_letters
