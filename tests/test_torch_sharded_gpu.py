"""The sharded programs (``StreamConfig(parallelism=S)``, S shards in one
process) on the card: rows equal the same sharded job's on the CPU
(tolerance: identical rows, in order), with the two hand kernels
launched on every shard's path: ``seq_rolling.cu`` by the rolling max at
S = 8 and ``ordered_scatter.cu`` by the float32 window mean at S = 4; a
snapshot written on the card at S = 8 restores on the CPU at S = 4. Every
test here needs a CUDA device and skips without one.

This file imports nothing of JAX; where JAX is not installed, skip the
repository's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sharded_gpu.py -q
"""

import glob
import os

import pytest
import torch

import tpustream_torch as T
from tpustream_torch.jobs import chapter2_avg, chapter2_max, chapter3_bandwidth_eventtime
from tpustream_torch.ops import ordered_scatter as O
from tpustream_torch.ops import seq_rolling as S
from tpustream_torch.runtime.checkpoint import load_checkpoint
from tpustream_torch.runtime.sources import AdvanceProcessingTime, ReplaySource

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only there")


CH2 = [f"{1563452000 + i} 10.8.22.{i % 13} cpu{i % 3} {30 + ((i * 11) % 60)}.5"
       for i in range(160)]
CH3 = [f"2019-08-28T10:{i // 20:02d}:{(i * 7) % 60:02d} www.ch{i % 16}.com "
       f"{100 + (i % 13) * 10}" for i in range(200)]


def run(module, items, device, event_time=False, restore=None, **cfg):
    env = T.StreamExecutionEnvironment(T.StreamConfig(
        device=device, batch_size=40, key_capacity=64, **cfg))
    if event_time:
        env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    if restore is not None:
        env.restore_from_checkpoint(restore)
    h = module.build(env, env.add_source(ReplaySource(items))).collect()
    env.execute("sharded-gpu")
    return [repr(t) for t in h.items], env.metrics


def test_sharded_flagship_on_the_card_equals_the_cpu():
    card, m = run(chapter3_bandwidth_eventtime, CH3, "cuda", True, parallelism=8)
    cpu, _ = run(chapter3_bandwidth_eventtime, CH3, "cpu", True, parallelism=8)
    assert card and card == cpu and m.exchange_overflow == 0


def test_sharded_rolling_max_launches_the_kernel_on_every_shard():
    S.reset_launches()
    card, m = run(chapter2_max, CH2, "cuda", parallelism=8)
    assert S.seq_rolling_reduce.launches >= 8 * m.steps
    cpu, _ = run(chapter2_max, CH2, "cpu", parallelism=8)
    assert card == cpu and len(card) == len(CH2)


def test_sharded_float32_mean_launches_the_ordered_merge():
    items = CH2[:80] + [AdvanceProcessingTime(60_000)] + CH2[80:] + \
        [AdvanceProcessingTime(120_000)]
    O.reset_launches()
    card, _ = run(chapter2_avg, items, "cuda", parallelism=4, acc_dtype="float32")
    assert O.ordered_scatter_add.launches >= 4
    cpu, _ = run(chapter2_avg, items, "cpu", parallelism=4, acc_dtype="float32")
    assert card and card == cpu


def test_card_snapshot_at_eight_shards_restores_on_the_cpu_at_four(tmp_path):
    full, _ = run(chapter2_max, CH2, "cuda", parallelism=8,
                  checkpoint_dir=str(tmp_path), checkpoint_interval_batches=1)
    snaps = sorted(glob.glob(os.path.join(str(tmp_path), "ckpt-*.npz")))
    snap = next(s for s in snaps if 0 < load_checkpoint(s).emitted < len(full))
    done = load_checkpoint(snap).emitted
    cpu, _ = run(chapter2_max, CH2, "cpu", parallelism=4, restore=snap)
    assert sorted(cpu) == sorted(full[done:])
    torch.cuda.synchronize()
