"""Supervised recovery on the card: the chapter-2 and flagship goldens,
checkpointed and crashed by an injected ``device_step`` fault, recover
to the rows of the same job on the CPU (tolerance: identical rows), and
a snapshot written on the card restores on the CPU and the other way
round. Every test here needs a CUDA device and skips without one.

This file imports nothing of JAX; where JAX is not installed, skip the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_recovery_gpu.py -q
"""

import glob
import os

import numpy as np
import pytest
import torch

import tpustream_torch as T
from tpustream_torch.config import ObsConfig
from tpustream_torch.jobs import chapter2_max, chapter3_bandwidth_eventtime
from tpustream_torch.runtime.checkpoint import load_checkpoint
from tpustream_torch.runtime.sources import ReplaySource
from tpustream_torch.runtime.supervisor import fixed_delay
from tpustream_torch.testing import FaultInjector, FaultPoint

pytestmark = pytest.mark.gpu

CH2 = [
    "1563452056 10.8.22.1 cpu0 80.5",
    "1563452050 10.8.22.1 cpu0 78.4",
    "1563452056 10.8.22.2 cpu1 40.0",
    "1563452060 10.8.22.1 cpu0 99.9",
    "1563452061 10.8.22.2 cpu1 10.0",
    "1563452062 10.8.22.1 cpu0 50.0",
]
CH3 = [f"2019-08-28T10:{m:02d}:{s:02d} www.ch{(m * 7 + s) % 5}.com {100 + m * 10 + s}"
       for m in range(8) for s in (0, 20, 40)]
JOBS = {"ch2": (chapter2_max, CH2, False), "flagship": (chapter3_bandwidth_eventtime, CH3, True)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: this checks the card's run")
    return "cuda"


def run(job, device, ckdir=None, at=None, restore=None, **over):
    """``(rows, metrics)`` of a job; ``at``: a device_step fault there,
    under a fixed-delay restart strategy (checkpoint every batch)."""
    module, lines, event_time = JOBS[job]
    cfg = T.StreamConfig(device=device, batch_size=2, key_capacity=64,
                         obs=ObsConfig(enabled=True), **over)
    if ckdir is not None:
        cfg = cfg.replace(checkpoint_dir=str(ckdir), checkpoint_interval_batches=1)
    inj = None
    if at is not None:
        inj = FaultInjector(FaultPoint("device_step", at=at))
        cfg = inj.install(cfg)
    env = T.StreamExecutionEnvironment(cfg)
    if event_time:
        env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    if at is not None:
        env.set_restart_strategy(fixed_delay(3, 0.0))
    if restore is not None:
        env.restore_from_checkpoint(restore)
    h = module.build(env, env.add_source(ReplaySource(lines))).collect()
    env.execute("recovery-gpu")
    if inj is not None:
        assert inj.fired == 1
    return [repr(t) for t in h.items], env.metrics


@pytest.mark.parametrize("job", sorted(JOBS))
def test_device_step_fault_recovers_to_the_cpu_rows(card, job, tmp_path):
    want, _ = run(job, "cpu")
    assert want
    got, m = run(job, card, ckdir=tmp_path, at=2)
    assert got == want
    kinds = [e["kind"] for e in m.job_obs.flight.events()]
    for k in ("job_failed", "job_restarting", "job_restored", "job_recovered"):
        assert k in kinds, kinds


@pytest.mark.parametrize("job", sorted(JOBS))
def test_snapshots_move_between_card_and_cpu(card, job, tmp_path):
    """A snapshot written on the card restores on the CPU, and one
    written on the CPU restores on the card: both resume to the suffix
    of the uninterrupted rows, and the two snapshots hold equal leaves."""
    full, _ = run(job, "cpu", ckdir=tmp_path / "cpu")
    assert run(job, card, ckdir=tmp_path / "card")[0] == full
    for src, dst in (("card", "cpu"), ("cpu", card)):
        snap = sorted(glob.glob(os.path.join(str(tmp_path / src), "ckpt-*.npz")))[0]
        ck = load_checkpoint(snap)
        got, _ = run(job, dst, restore=snap)
        assert got == full[ck.emitted:], (src, dst)
    a = load_checkpoint(str(tmp_path / "cpu")).leaves
    b = load_checkpoint(str(tmp_path / "card")).leaves
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
