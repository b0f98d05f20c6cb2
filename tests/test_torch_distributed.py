"""One sharded job over two processes: the port's ``torch.distributed``
pair (``tpustream_torch/parallel/distributed.py``) on the CPU, beside
the JAX package.

ONE worker pair serves the whole file (a process spawn and a group's
rendezvous are paid once, as the JAX package's
``tests/test_distributed.py`` does): two processes join a ``gloo``
group over ``tcp://127.0.0.1``, each running 4 of the mesh's 8 shards,
and run in order

* the set-up checks (``initialize`` idempotent, ``process_index``,
  ``is_coordinator``, the global mesh's size and each process's block),
  the analyzer's TSM016 finding for ingest lanes under two processes,
  and the flight recorder's reason for each feature a pair turns off
  (the controller, the ledger, ingest lanes);
* the collectives: ``psum`` of float tensors over the 8 shards, held
  bitwise against the one-process mesh's; 100 rounds of ``psum`` and
  ``pmax`` under a shortened switch interval, every result exact; and
  ``exchange_by_key``
  across the pair, held bitwise against the JAX package's under
  ``shard_map`` at 8 shards;
* the eleven job variants of the JAX package's
  ``MULTI_VARIANT_SNIPPET`` over its ``JOB_LINES`` at parallelism 8:
  the union of both processes' rows equals the JAX package's
  single-process runs at parallelism 8 and 1 (multisets), and each
  process emits a non-empty, strict part;
* the checkpoint matrix (``CKPT_EPILOGUE``'s ``chained`` and
  ``process_chained``): each process's resumed rows are the exact tail
  of its first run's; the pair's 8-shard snapshot then restores here,
  in one process, at 4 shards and at 1, in the port and in the JAX
  package: ``sorted(resumed) == sorted(full[ck.emitted:])``;
* a job with a restart strategy: both processes refuse it by name
  before any call on the group, and a ``psum`` after it is bitwise the
  one-process mesh's;
* last, a fault injected at ``exchange`` on rank 1: both processes exit
  non-zero, well inside the pair's limit.

The JAX references run in this process while the pair works. Tolerance:
none (rows compare as ``repr`` strings, floats as their bits).
"""

import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_distributed import (
    CKPT_VARIANT_SNIPPET,
    JOB_LINES,
    MULTI_VARIANT_SNIPPET,
)
from tests.test_torch_exchange import _inputs, _jax
from tpustream_torch.parallel import exchange as torch_exchange
from tpustream_torch.parallel import mesh as torch_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = [
    "rolling", "count", "process", "session_process", "rolling_growth",
    "chain_window", "chain_session", "chain_rolling", "chain_count",
    "chain_process", "chain_computed",
]
CKPT_VARIANTS = ["chained", "process_chained"]
# the pair's own limit, seconds (it takes well under a minute here)
PAIR_TIMEOUT_S = 300
PSUM_SEED, EXCHANGE_SEED, EXCHANGE_B = 11, 5, 128
STRESS_ROUNDS = 100
# the calls on a group that the refusal act counts
COLLECTIVES = (
    "all_gather", "all_gather_object", "all_to_all", "all_to_all_single",
    "all_reduce", "barrier", "broadcast", "broadcast_object_list", "gather",
    "gather_object", "reduce", "reduce_scatter", "scatter", "send", "recv")
# execute_job's refusal of a supervised job under several processes
REFUSAL = (
    "supervised restarts of a job over several processes are not "
    "supported: restart the processes from the latest snapshot "
    "(env.restore_from_checkpoint)")


def port_snippet(snippet: str, device: str = "cpu") -> str:
    """A JAX-package job snippet for the port: the same job through
    ``tpustream_torch``, on ``device``."""
    return (snippet
            .replace("from tpustream", "from tpustream_torch")
            .replace("StreamConfig(batch_size=16",
                     f"StreamConfig(device={device!r}, batch_size=16")
            .replace("dict(batch_size=16",
                     f"dict(device={device!r}, batch_size=16"))


WORKER_HEAD = textwrap.dedent(
    """
    import os, sys, threading
    import numpy as np
    import torch
    pid, port, ckdir, device, lines_path = (
        int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5])
    from tpustream_torch.parallel import distributed
    distributed.initialize(coordinator=f"127.0.0.1:{port}", num_processes=2,
                           process_id=pid)
    distributed.initialize()  # a second call is a no-op
    with open(lines_path) as f:
        lines = f.read().splitlines()

    def shard_threads(mesh, fn):
        out = {}
        def work(i):
            out[i] = mesh.run_shard(fn, i)
        ts = [threading.Thread(target=work, args=(i,))
              for i in mesh.local_shards]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return out
    """
)

WORKER_CHECKS = textwrap.dedent(
    """
    assert distributed.process_count() == 2
    assert distributed.process_index() == pid
    assert distributed.is_coordinator() == (pid == 0)
    mesh = distributed.global_mesh(8, device=device)
    assert mesh.size == 8, mesh.size
    assert list(mesh.local_shards) == list(range(4 * pid, 4 * pid + 4))
    print(f"SETUP\\t{pid}", flush=True)

    # the analyzer reads the group's size: lanes under two processes
    from tpustream_torch import StreamExecutionEnvironment
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.runtime.sources import ReplaySource
    env = StreamExecutionEnvironment(StreamConfig(
        device=device, ingest_lanes=2, parallelism=8))
    env.add_source(ReplaySource(lines)).map(lambda l: l).collect()
    for f in env.analyze():
        if f.code == "TSM016":
            print(f"FINDING\\t{f.code}\\t{f.severity}\\t{f.message}",
                  flush=True)

    # what a pair turns off, each with its reason in the flight recorder
    from tpustream_torch.config import ObsConfig
    env = StreamExecutionEnvironment(StreamConfig(
        device=device, batch_size=16, key_capacity=64, parallelism=8,
        ingest_lanes=2, obs=ObsConfig(enabled=True, adaptive=True)))
    text = env.add_source(ReplaySource(lines))
    text.map(lambda l: (l.split(" ")[1], int(l.split(" ")[2]))).key_by(0).max(1).collect()
    env.execute("features-off")
    for e in env.metrics.job_obs.flight.events():
        if e["kind"].endswith("_disabled"):
            print(f"OFF\t{pid}\t{e['kind']}\t{e.get('reason')}", flush=True)

    vals = np.random.default_rng(PSUM_SEED).normal(size=(8, 5)) * np.logspace(
        -8, 8, 5)
    got = shard_threads(mesh, lambda i: mesh.psum(
        i, torch.from_numpy(vals[i].copy()).to(device)))
    for i, v in got.items():
        print(f"PSUM\\t{i}\\t{v.cpu().numpy().tobytes().hex()}", flush=True)

    # a stress run: a shortened switch interval and many rounds; a lost
    # or stale post anywhere (a thread's slot, the group's call) would
    # break an exact sum or maximum
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = shard_threads(mesh, lambda i: [
            (mesh.psum(i, i + r), mesh.pmax(i, (i * 7 + r) % 8))
            for r in range(STRESS_ROUNDS)])
    finally:
        sys.setswitchinterval(prev)
    ok = all(v == [(28 + 8 * r, 7) for r in range(STRESS_ROUNDS)]
             for v in got.values())
    print(f"STRESS\\t{pid}\\t{int(ok)}", flush=True)

    from tpustream_torch.parallel.exchange import exchange_by_key
    rng = np.random.default_rng(EXCHANGE_SEED)
    b = EXCHANGE_B
    keys = rng.integers(0, 37, size=b).astype(np.int32)
    xvals, xts = rng.normal(size=b), rng.integers(0, 1000, size=b).astype(np.int64)
    valid = rng.random(b) > 0.2
    blk, cap = b // 8, b // 8
    def one(i):
        sl = slice(i * blk, (i + 1) * blk)
        k = torch.from_numpy(keys[sl].copy()).to(device)
        cols, v, t, ovf = exchange_by_key(
            [k, torch.from_numpy(xvals[sl].copy()).to(device)],
            torch.from_numpy(valid[sl].copy()).to(device),
            torch.from_numpy(xts[sl].copy()).to(device), k, 8, cap, mesh, i)
        return [x.cpu().numpy() for x in (cols[0], cols[1], t, v,
                                          ovf.reshape(1))]
    for i, outs in shard_threads(mesh, one).items():
        print(f"EXCHANGE\\t{i}\\t" + ",".join(o.tobytes().hex() for o in outs),
              flush=True)
    """
)

WORKER_TAIL = textwrap.dedent(
    """
    for variant in VARIANTS:
        for r in run_job(lines, variant):
            print(f"ROW\\t{variant}|{r}", flush=True)

    for variant in CKPT_VARIANTS:
        vdir = os.path.join(ckdir, variant)
        os.makedirs(vdir, exist_ok=True)
        r1 = run_ckpt_job(lines, variant, ckdir=vdir)
        r2 = run_ckpt_job(lines, variant, restore=vdir)
        ok = 0 < len(r2) < len(r1) and r2 == r1[len(r1) - len(r2):]
        print(f"CKPT\\t{variant}\\t{int(ok)}\\t{len(r1)}\\t{len(r2)}", flush=True)

    # a supervised job under two processes is refused before any call on
    # the group, and the group stays usable
    import torch.distributed as dist
    from tpustream_torch import StreamExecutionEnvironment
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.runtime.sources import ReplaySource
    from tpustream_torch.runtime.supervisor import fixed_delay
    group_calls = []
    originals = {name: getattr(dist, name) for name in COLLECTIVES}
    def counted(name, fn):
        def call(*a, **kw):
            group_calls.append(name)
            return fn(*a, **kw)
        return call
    for name, fn in originals.items():
        setattr(dist, name, counted(name, fn))
    env = StreamExecutionEnvironment(StreamConfig(
        device=device, batch_size=16, key_capacity=64, parallelism=8))
    env.set_restart_strategy(fixed_delay(3, 0.0))
    text = env.add_source(ReplaySource(lines))
    text.map(lambda l: (l.split(" ")[1], int(l.split(" ")[2]))).key_by(0).max(1).collect()
    try:
        env.execute("supervised")
        refused = "none"
    except Exception as e:
        refused = f"{type(e).__name__}\\t{e}"
    for name, fn in originals.items():
        setattr(dist, name, fn)
    print(f"REFUSED\\t{pid}\\t{len(group_calls)}\\t{refused}", flush=True)
    got = shard_threads(mesh, lambda i: mesh.psum(
        i, torch.from_numpy(vals[i].copy()).to(device)))
    for i, v in got.items():
        print(f"AFTER_REFUSAL\\t{i}\\t{v.cpu().numpy().tobytes().hex()}",
              flush=True)

    print(f"FAULT_NEXT\\t{pid}", flush=True)
    from tpustream_torch.testing import FaultInjector, FaultPoint
    cfg = StreamConfig(device=device, batch_size=16, key_capacity=64,
                       parallelism=8)
    if pid == 1:
        cfg = FaultInjector(FaultPoint("exchange", at=2)).install(cfg)
    env = StreamExecutionEnvironment(cfg)
    text = env.add_source(ReplaySource(lines))
    text.map(lambda l: (l.split(" ")[1], int(l.split(" ")[2]))).key_by(0).max(1).collect()
    env.execute("fault")
    print(f"NOT_FAILED\\t{pid}", flush=True)
    """
)


def worker_script(device: str) -> str:
    consts = (f"PSUM_SEED, EXCHANGE_SEED, EXCHANGE_B = {PSUM_SEED}, "
              f"{EXCHANGE_SEED}, {EXCHANGE_B}\nSTRESS_ROUNDS = {STRESS_ROUNDS}\n"
              f"VARIANTS = {VARIANTS!r}\nCKPT_VARIANTS = {CKPT_VARIANTS!r}\n"
              f"COLLECTIVES = {COLLECTIVES!r}\n")
    return (WORKER_HEAD + consts + WORKER_CHECKS
            + port_snippet(MULTI_VARIANT_SNIPPET, device)
            + port_snippet(CKPT_VARIANT_SNIPPET, device) + WORKER_TAIL)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_pair(tmp_dir, device: str = "cpu"):
    """The two workers, started, each reading JOB_LINES from a file, and
    a thread a worker that reads its output to the end and notes when
    it exited."""
    script = os.path.join(tmp_dir, "pair_worker.py")
    with open(script, "w") as f:
        f.write(worker_script(device))
    ckdir = os.path.join(tmp_dir, "ck")
    os.makedirs(ckdir, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "XLA_", "JAX_"))
           and k not in ("WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = ROOT
    lines_path = os.path.join(tmp_dir, "lines.txt")
    with open(lines_path, "w") as f:
        f.write("\n".join(JOB_LINES))
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, script, str(i), port, ckdir, device, lines_path],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, text=True, cwd=ROOT)
        for i in range(2)]
    return [watch(p) for p in procs], ckdir


def watch(proc):
    """``(proc, thread, box)``: the thread reads ``proc``'s output into
    ``box["out"]`` and notes its exit in ``box["exited"]``."""
    box = {}

    def read():
        box["out"] = proc.stdout.read()
        proc.wait()
        box["exited"] = time.perf_counter()

    t = threading.Thread(target=read, daemon=True)
    t.start()
    return proc, t, box


def finish_pair(workers, t0):
    """The outputs of the pair and its own wall: from ``t0`` to the
    second worker's exit, however long this process took meanwhile. A
    pair still running at ``PAIR_TIMEOUT_S`` is killed."""
    for _, t, _ in workers:
        t.join(timeout=max(0.0, t0 + PAIR_TIMEOUT_S - time.perf_counter()))
    if any(t.is_alive() for _, t, _ in workers):
        for p, _, _ in workers:
            p.kill()
        raise subprocess.TimeoutExpired("the worker pair", PAIR_TIMEOUT_S)
    outs = [box["out"] for _, _, box in workers]
    return outs, max(box["exited"] for _, _, box in workers) - t0


def parse_rows(outs):
    """``{variant: [rows of process 0, rows of process 1]}``."""
    per = {v: [[], []] for v in VARIANTS}
    for pid, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith("ROW\t"):
                variant, row = line.split("\t", 1)[1].split("|", 1)
                per[variant][pid].append(row)
    return per


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pair"))
    t0 = time.perf_counter()
    workers, ckdir = start_pair(tmp)
    # the JAX package's references, while the pair runs
    ns = {}
    exec(MULTI_VARIANT_SNIPPET, ns)
    refs = {(v, p): sorted(ns["run_job"](JOB_LINES, v, parallelism=p))
            for v in VARIANTS for p in (8, 1)}
    refs_s = time.perf_counter() - t0
    outs, wall = finish_pair(workers, t0)
    return {"outs": outs, "wall": wall, "refs": refs, "ckdir": ckdir,
            "refs_s": refs_s, "rcs": [p.returncode for p, _, _ in workers]}


def lines_of(pair, tag):
    return [line.split("\t")[1:] for out in pair["outs"]
            for line in out.splitlines() if line.startswith(tag + "\t")]


def test_pair_setup(pair):
    assert sorted(int(r[0]) for r in lines_of(pair, "SETUP")) == [0, 1], \
        pair["outs"]


def test_pair_analyzer_sees_two_processes(pair):
    """TSM016's multi-process finding fires in each process of the pair,
    as the JAX package's does under ``jax.distributed``."""
    rows = [r for r in lines_of(pair, "FINDING") if "2 processes" in r[2]]
    assert len(rows) == 2, lines_of(pair, "FINDING")
    assert all(r[0] == "TSM016" and r[1] == "info" for r in rows)


def test_pair_records_why_features_are_off(pair):
    """Under two processes the adaptive controller, the conservation
    ledger and ingest lanes are off, each leaving the reason
    ``multiprocess`` in the flight recorder, as in the JAX package."""
    off = sorted((int(r[0]), r[1], r[2]) for r in lines_of(pair, "OFF"))
    assert off == [(p, kind, "multiprocess") for p in (0, 1) for kind in (
        "controller_disabled", "ingest_lanes_disabled", "ledger_disabled")]


def assert_psum_bitwise_equals_one_process_mesh(rows):
    """The pair's ``psum`` rows (shard, result bytes) equal the
    one-process mesh's sum of the same values, bitwise."""
    vals = np.random.default_rng(PSUM_SEED).normal(size=(8, 5)) * np.logspace(
        -8, 8, 5)
    mesh = torch_mesh.make_mesh(8, device="cpu")
    got = {}

    def work(i):
        got[i] = mesh.run_shard(
            lambda: mesh.psum(i, torch.from_numpy(vals[i].copy())))

    ts = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(int(r[0]) for r in rows) == list(range(8))
    for shard, hexed in rows:
        assert hexed == got[int(shard)].numpy().tobytes().hex()


def test_pair_psum_bitwise_equals_one_process_mesh(pair):
    assert_psum_bitwise_equals_one_process_mesh(lines_of(pair, "PSUM"))


def test_pair_rendezvous_under_thread_switch_stress(pair):
    """Many rounds of collectives across the pair under a shortened
    switch interval: every round's sum and maximum exact on both
    processes, none hangs (the pair's own limit)."""
    assert sorted(lines_of(pair, "STRESS")) == [["0", "1"], ["1", "1"]]


def test_pair_exchange_bitwise_equals_jax_package(pair):
    rng = np.random.default_rng(EXCHANGE_SEED)
    b = EXCHANGE_B
    keys = rng.integers(0, 37, size=b).astype(np.int32)
    vals, ts = rng.normal(size=b), rng.integers(0, 1000, size=b).astype(np.int64)
    valid = rng.random(b) > 0.2
    cap = torch_exchange.exchange_capacity(b, 8)
    want = _jax(8, keys, vals, ts, valid, cap)
    rows = lines_of(pair, "EXCHANGE")
    assert sorted(int(r[0]) for r in rows) == list(range(8))
    per = [len(w) // 8 for w in want]
    for shard, hexed in rows:
        i = int(shard)
        for j, h in enumerate(hexed.split(",")):
            w = want[j][i * per[j]:(i + 1) * per[j]]
            assert h == np.ascontiguousarray(w).tobytes().hex(), (i, j)


@pytest.mark.parametrize("variant", VARIANTS)
def test_pair_job_union_equals_jax_single_process(pair, variant):
    per = parse_rows(pair["outs"])[variant]
    got = sorted(per[0] + per[1])
    want8, want1 = pair["refs"][(variant, 8)], pair["refs"][(variant, 1)]
    assert want1, f"the JAX package's {variant} emitted nothing"
    assert got == want8 and got == want1
    # the work split: each process emitted a part, none all of it
    assert all(0 < len(rows) < len(got) for rows in per), \
        (variant, [len(r) for r in per])


@pytest.mark.parametrize("variant", CKPT_VARIANTS)
def test_pair_resume_is_each_process_exact_tail(pair, variant):
    rows = [r for r in lines_of(pair, "CKPT") if r[0] == variant]
    assert len(rows) == 2, pair["outs"]
    assert all(r[1] == "1" for r in rows), rows


@pytest.mark.parametrize("package", ["torch", "jax"])
@pytest.mark.parametrize("parallelism", [4, 1])
def test_pair_snapshot_restores_alone(pair, package, parallelism):
    """The pair's parallelism-8 ``chained`` snapshot, restored in this
    one process at another parallelism: exactly once, as a multiset."""
    from tpustream.runtime.checkpoint import load_checkpoint

    vdir = os.path.join(pair["ckdir"], "chained")
    snippet = (CKPT_VARIANT_SNIPPET if package == "jax"
               else port_snippet(CKPT_VARIANT_SNIPPET))
    ns = {}
    exec(snippet, ns)
    full = ns["run_ckpt_job"](JOB_LINES, "chained", parallelism=parallelism)
    ck = load_checkpoint(vdir)
    assert ck.parallelism == 8
    resumed = ns["run_ckpt_job"](JOB_LINES, "chained", restore=vdir,
                                 parallelism=parallelism)
    assert 0 < ck.emitted < len(full)
    assert sorted(resumed) == sorted(full[ck.emitted:])


def test_pair_refuses_a_supervised_job_before_any_collective(pair):
    """A job with a restart strategy under two processes raises
    ``NotImplementedError`` by name in both processes, before any call
    on the group, and the group still sums bitwise afterwards."""
    rows = sorted(lines_of(pair, "REFUSED"))
    assert rows == [[str(p), "0", "NotImplementedError", REFUSAL]
                    for p in (0, 1)], pair["outs"]
    assert_psum_bitwise_equals_one_process_mesh(lines_of(pair, "AFTER_REFUSAL"))


def test_pair_fault_on_one_rank_fails_both(pair):
    """The last act of the pair: an injected ``exchange`` fault on rank
    1's shard 7 fails rank 1, and rank 0, waiting in the all-to-all,
    fails with it instead of waiting out the group's timeout."""
    assert sorted(int(r[0]) for r in lines_of(pair, "FAULT_NEXT")) == [0, 1]
    assert not lines_of(pair, "NOT_FAILED")
    assert all(rc != 0 for rc in pair["rcs"]), pair["rcs"]
    assert "FaultInjected" in pair["outs"][1]
    # the pair's own wall; the JAX references in this process may take
    # longer under load
    assert pair["wall"] < PAIR_TIMEOUT_S, (pair["wall"], pair["refs_s"])


def test_mesh_abort_tears_the_group_down_once(monkeypatch):
    """Every failing shard of a process calls ``Mesh.abort``, on its own
    thread and at about the same time: the group is destroyed once,
    never by two threads together."""
    import torch.distributed as dist

    mesh = torch_mesh.make_mesh(8, device="cpu")
    mesh.n_procs = 2  # as under a group of two processes
    live, calls = [True], []

    def destroy():
        calls.append(threading.get_ident())
        time.sleep(0.05)  # a teardown that takes a while
        live[0] = False

    monkeypatch.setattr(dist, "is_initialized", lambda: live[0])
    monkeypatch.setattr(dist, "destroy_process_group", destroy)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=mesh.abort) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        sys.setswitchinterval(prev)
    assert len(calls) == 1
    with pytest.raises(torch_mesh.MeshAborted):
        mesh.run_shard(mesh.psum, 0, 1.0)
