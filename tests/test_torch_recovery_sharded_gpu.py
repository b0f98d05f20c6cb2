"""Supervised recovery on the 8-shard mesh, on the card: the chapter-2
max of ``tests/test_torch_recovery_sharded.py``, with a snapshot
written at parallelism 1 restored by the supervisor at parallelism 8,
and with a ``checkpoint_write`` fault in the writer thread at
parallelism 8. Each run's rows equal the port's run of the same job on
the CPU (tolerance: identical rows, in order), and ``seq_rolling.cu``
launches exactly once a shard a data step on every attempt. Every test
here needs a CUDA device and skips without one.

This file imports nothing of JAX; where JAX is not installed, skip the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_recovery_sharded_gpu.py -q
"""

import glob
import os

import pytest
import torch

import tpustream_torch as T
from tpustream_torch.jobs import chapter2_max
from tpustream_torch.ops import seq_rolling as S
from tpustream_torch.runtime import executor
from tpustream_torch.runtime.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    validate_checkpoint,
)
from tpustream_torch.runtime.sources import ReplaySource
from tpustream_torch.runtime.supervisor import fixed_delay
from tpustream_torch.testing import FaultInjector, FaultPoint

pytestmark = pytest.mark.gpu

SHARDS = 8
LINES = [
    f"15634520{i:02d} 10.8.22.{i % 5} cpu{i % 3} {40 + (i * 13) % 60}.5"
    for i in range(24)
]
SHARD_CFG = dict(parallelism=SHARDS, batch_size=8, key_capacity=64,
                 print_parallelism=1)


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only there")


@pytest.fixture
def attempts(monkeypatch):
    """``[(launches, data steps)]`` of each attempt of a job, in order:
    the rolling kernel's launches and the attempt's own step count."""
    seen = []
    run_attempt = executor._run_attempt

    def attempt(env, sink_nodes):
        S.reset_launches()
        try:
            return run_attempt(env, sink_nodes)
        finally:
            seen.append((S.seq_rolling_reduce.launches, env.metrics.steps))

    monkeypatch.setattr(executor, "_run_attempt", attempt)
    return seen


def run(device, ckdir=None, fault=None, restore=None, **over):
    """The rows of the chapter-2 max over ``LINES``; ``fault``: a point
    and occurrence, under ``fixed_delay(3, 0)``."""
    cfg = T.StreamConfig(device=device, **over)
    if ckdir is not None:
        cfg = cfg.replace(checkpoint_dir=str(ckdir),
                          checkpoint_interval_batches=1)
    inj = None
    if fault is not None:
        inj = FaultInjector(FaultPoint(fault[0], at=fault[1]))
        cfg = inj.install(cfg)
    env = T.StreamExecutionEnvironment(cfg)
    if fault is not None:
        env.set_restart_strategy(fixed_delay(3, 0.0))
    if restore is not None:
        env.restore_from_checkpoint(restore)
    h = chapter2_max.build(env, env.add_source(ReplaySource(LINES))).collect()
    env.execute("recovery-sharded-gpu")
    if inj is not None:
        assert inj.fired == 1
    return [repr(t) for t in h.items]


def assert_one_launch_a_shard_a_step(attempts, n):
    assert len(attempts) == n, attempts
    for launches, steps in attempts:
        assert steps > 0 and launches == SHARDS * steps, attempts


def test_card_supervisor_rescales_a_p1_snapshot_to_p8(tmp_path, attempts):
    full = run("cuda", ckdir=tmp_path / "p1", batch_size=8)
    assert full == run("cpu", batch_size=8)
    del attempts[:]
    snaps = sorted(glob.glob(os.path.join(str(tmp_path / "p1"), "ckpt-*.npz")))
    snap = next(s for s in snaps if 0 < load_checkpoint(s).emitted < len(full))
    emitted = load_checkpoint(snap).emitted
    card = run("cuda", fault=("device_step", 1), restore=snap, **SHARD_CFG)
    assert_one_launch_a_shard_a_step(attempts, 2)
    cpu = run("cpu", fault=("device_step", 1), restore=snap, **SHARD_CFG)
    assert card == cpu
    assert sorted(card) == sorted(full[emitted:])


def test_card_checkpoint_write_fault_restores_a_valid_snapshot(tmp_path,
                                                               attempts):
    card = run("cuda", ckdir=tmp_path / "card",
               fault=("checkpoint_write", 1), **SHARD_CFG)
    assert_one_launch_a_shard_a_step(attempts, 2)
    cpu = run("cpu", ckdir=tmp_path / "cpu",
              fault=("checkpoint_write", 1), **SHARD_CFG)
    assert card == cpu == run("cpu", **SHARD_CFG)
    assert latest_checkpoint(str(tmp_path / "card")) is not None
    for p in glob.glob(os.path.join(str(tmp_path / "card"), "ckpt-*.npz")):
        assert validate_checkpoint(p) is None, p
