"""One sharded job over two processes on the card: a ``gloo`` pair
(``tpustream_torch/parallel/distributed.py``), both processes on
``cuda:0``, 4 of the 8 shards each.

* The chapter-2 rolling max at 8 shards launches ``seq_rolling.cu`` on
  every local shard of every step, each launch bitwise equal to its
  plain version on the same inputs; the union of both processes' rows
  equals the same pair's on the CPU.
* The flagship (chapter 3, event time) at 8 shards: the union of both
  processes' rows equals the same pair's on the CPU, each process
  emitting a non-empty, strict part.

Tolerance: none (rows compare as ``repr`` strings). Every test here
needs a CUDA device and skips without one. This file imports nothing of
JAX; where JAX is not installed, skip the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_distributed_gpu.py -q
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import sys
    import torch
    pid, port, device = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    from tpustream_torch.parallel import distributed
    distributed.initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                           process_id=pid)
    import tpustream_torch as T
    from tpustream_torch.jobs import chapter2_max, chapter3_bandwidth_eventtime
    from tpustream_torch.ops import rolling
    from tpustream_torch.ops import seq_rolling as S
    from tpustream_torch.runtime.sources import ReplaySource

    CH2 = [f"{1563452000 + i} 10.8.22.{i % 13} cpu{i % 3} {30 + ((i * 11) % 60)}.5"
           for i in range(160)]
    CH3 = [f"2019-08-28T10:{i // 20:02d}:{(i * 7) % 60:02d} www.ch{i % 16}.com "
           f"{100 + (i % 13) * 10}" for i in range(200)]

    def run(module, items, event_time=False):
        env = T.StreamExecutionEnvironment(T.StreamConfig(
            device=device, batch_size=40, key_capacity=64, parallelism=8))
        if event_time:
            env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
        h = module.build(env, env.add_source(ReplaySource(items))).collect()
        env.execute("pair-gpu")
        return [repr(t) for t in h.items], env.metrics

    # every launch of the kernel held against its plain version
    plain, box = rolling.seq_rolling_reduce, {"checked": 0}
    def checked(plane, keys, vals, op="max", bad_keys=None, fresh=None):
        p0, k0, v0 = plane.clone(), keys.clone(), vals.clone()
        f0 = None if fresh is None else fresh.clone()
        out = plain(plane, keys, vals, op, bad_keys=bad_keys, fresh=fresh)
        if plane.is_cuda:
            bad = torch.zeros(1, dtype=torch.int32, device=plane.device)
            ref = S.seq_rolling_reduce_ref(p0, k0, v0, op, bad_keys=bad,
                                           fresh=f0)
            same = (torch.equal(out.view(torch.int64), ref.view(torch.int64))
                    and torch.equal(plane.view(torch.int64),
                                    p0.view(torch.int64)))
            assert same, "kernel != plain version"
            box["checked"] += 1
        return out
    rolling.seq_rolling_reduce = checked
    S.reset_launches()
    rows, m = run(chapter2_max, CH2)
    rolling.seq_rolling_reduce = plain
    print(f"LAUNCHES\\t{S.seq_rolling_reduce.launches}\\t{box['checked']}"
          f"\\t{m.steps}", flush=True)
    for r in rows:
        print(f"ROW\\tch2|{r}", flush=True)
    rows, m = run(chapter3_bandwidth_eventtime, CH3, event_time=True)
    for r in rows:
        print(f"ROW\\tch3|{r}", flush=True)
    print(f"DONE\\t{pid}", flush=True)
    """
)


def run_pair(tmp_path, device):
    """Both workers' stdout lines, split by tab, per process."""
    script = tmp_path / f"pair_{device}.py"
    script.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), port, device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        cwd=ROOT) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} on {device}:\n{out}"
    return [[line.split("\t") for line in out.splitlines() if "\t" in line]
            for out in outs]


def rows_of(parts, job):
    return [[r[1].split("|", 1)[1] for r in part
             if r[0] == "ROW" and r[1].startswith(job + "|")] for part in parts]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    # decided inside the fixture (every test here uses it), never at
    # import
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels run only there")
    tmp = tmp_path_factory.mktemp("pair_gpu")
    return run_pair(tmp, "cuda"), run_pair(tmp, "cpu")


def test_pair_rolling_max_launches_the_kernel_on_every_local_shard(pairs):
    card, cpu = pairs
    for part in card:
        (launches, checked, steps), = [r[1:] for r in part if r[0] == "LAUNCHES"]
        assert int(launches) >= 4 * int(steps)
        assert int(checked) == int(launches)
    got, want = rows_of(card, "ch2"), rows_of(cpu, "ch2")
    assert sorted(got[0] + got[1]) == sorted(want[0] + want[1])
    assert all(0 < len(p) < len(got[0] + got[1]) for p in got)


def test_pair_flagship_on_the_card_equals_the_cpu_pair(pairs):
    card, cpu = pairs
    got, want = rows_of(card, "ch3"), rows_of(cpu, "ch3")
    assert got == want
    union = got[0] + got[1]
    assert union and all(0 < len(p) < len(union) for p in got)
