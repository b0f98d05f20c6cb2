"""Supervised restarts of one job over two processes, in the JAX
package: what the reference does when a fault hits one process of a
pair under ``fixed_delay``. The port refuses such a job by name
(``tpustream_torch/runtime/executor.py::execute_job``); this file
holds the evidence for keeping that refusal, or for lifting it at a
point where the reference recovers.

Each case starts a pair as ``tests/test_distributed.py::
_run_two_process_job`` does (two processes joined by
``jax.distributed``, 4 virtual CPU devices each) running
``CKPT_VARIANT_SNIPPET``'s ``chained`` job at parallelism 8 with a
snapshot every 2 batches, ``restart_strategy=fixed_delay(3, 0.0)`` on
both processes, and one fault: at ``exchange``, ``device_step`` or
``source_read`` on rank 1, or at ``checkpoint_write`` on rank 0 (only
the coordinator writes the pair's snapshots). A clean pair of the same
job runs beside them. Every pair has a hard limit of its own and is
killed with SIGKILL at it: a faulted reference pair ignores SIGTERM.

What each pair did is classified as one of

* ``recovers``: both processes exit 0 with the clean pair's rows;
* ``fails_both``: both exit non-zero within the limit;
* ``fails_one``: one exits non-zero, the other 0;
* ``wrong_rows``: both exit 0, rows unlike the clean pair's;
* ``no_finish``: a process is still running at the limit.

with each process's own status beside it (``rows``: exit 0 with its
rows of the clean pair; ``other_rows``; ``exit N``; ``running`` at the
limit; ``rows_then_running``: its clean rows printed and its job
returned, but the process still running at the limit, its exit waiting
on the peer), and held against :data:`REFERENCE_OUTCOME`, which
``ROADMAP.md`` §3 cites. None of the four points recovers: the
faulted process starts its second attempt and prints no row after the
fault, and a process is still running at the limit. Slow: the pairs
run at once, but a pair that does not finish costs its whole limit.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

import pytest

from tests.test_distributed import CKPT_VARIANT_SNIPPET, JOB_LINES

pytestmark = pytest.mark.slow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# point -> (the rank it fires on, its 0-based occurrence on that rank);
# each occurrence lies after the pair's first snapshot (batch 2)
FAULTS = {
    "exchange": (1, 6),
    "device_step": (1, 6),
    "source_read": (1, 2),
    "checkpoint_write": (0, 1),
}
POINTS = list(FAULTS)
# seconds a pair may run before it is killed; the clean pair takes well
# under a minute here
PAIR_LIMIT_S = 240

# what the JAX package's pair does at each point (this file's finding):
# the outcome, and the status of rank 0 and rank 1
REFERENCE_OUTCOME = {
    "exchange": ("no_finish", ["running", "running"]),
    "device_step": ("no_finish", ["running", "running"]),
    "source_read": ("no_finish", ["running", "running"]),
    "checkpoint_write": ("no_finish", ["running", "rows_then_running"]),
}

_ENV_HOOK = "env = StreamExecutionEnvironment(StreamConfig(**cfg))"
assert _ENV_HOOK in CKPT_VARIANT_SNIPPET

WORKER = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("JAX_COORDINATOR_ADDRESS", None)
    pid, port, ckdir, lines_path = (
        int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
    point, fault_rank, at = sys.argv[5], int(sys.argv[6]), int(sys.argv[7])
    from tpustream.parallel import distributed

    distributed.initialize(
        coordinator=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    import jax
    assert jax.process_count() == 2
    from tpustream.runtime.supervisor import fixed_delay
    from tpustream.testing import FaultInjected, FaultInjector, FaultPoint

    class Injector(FaultInjector):
        # says on stdout when and where the fault fired
        def check(self, name):
            try:
                super().check(name)
            except FaultInjected as e:
                print(f"FIRED\\t{pid}\\t{name}\\t{e.occurrence}", flush=True)
                raise

    inj = Injector(*([FaultPoint(point, at=at)]
                     if point != "clean" and pid == fault_rank else []))

    from tpustream.runtime import executor

    def attempt(env, sink_nodes, _run=executor._run_attempt):
        print(f"ATTEMPT\t{pid}", flush=True)
        return _run(env, sink_nodes)

    executor._run_attempt = attempt

    def configure(cfg):
        return inj.install(cfg.replace(restart_strategy=fixed_delay(3, 0.0)))

    with open(lines_path) as f:
        lines = f.read().splitlines()
    """
) + CKPT_VARIANT_SNIPPET.replace(
    _ENV_HOOK, "env = StreamExecutionEnvironment(configure(StreamConfig(**cfg)))"
) + textwrap.dedent(
    """
    rows = run_ckpt_job(lines, "chained", ckdir=ckdir)
    for r in rows:
        print("ROW\\t" + r, flush=True)
    print("COUNTS\\t" + json.dumps({p: inj.occurrences(p) for p in POINTS}),
          flush=True)
    print(f"DONE\\t{pid}", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(tmp_dir: str, name: str, lines_path: str, script: str):
    point = name
    fault_rank, at = FAULTS.get(name, (-1, -1))
    ckdir = os.path.join(tmp_dir, name, "ck")
    os.makedirs(ckdir)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = ROOT
    port = str(_free_port())
    procs = []
    for rank in range(2):
        log = open(os.path.join(tmp_dir, name, f"log{rank}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, script, str(rank), port, ckdir, lines_path,
             point, str(fault_rank), str(at)],
            stdin=subprocess.DEVNULL, stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=ROOT, start_new_session=True), log))
    return procs


def _finish(procs, deadline: float):
    """Exit codes (None: killed at the limit) and outputs of a pair."""
    rcs = []
    for p, _ in procs:
        try:
            rcs.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    for p, log in procs:
        if p.poll() is None:
            # the reference's faulted pair ignores SIGTERM
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        log.close()
    outs = []
    for _, log in procs:
        with open(log.name) as f:
            outs.append(f.read())
    return rcs, outs


def _rows(out: str) -> list:
    return [ln.split("\t", 1)[1] for ln in out.splitlines()
            if ln.startswith("ROW\t")]


def _status(rc, out: str, clean: list) -> str:
    if rc is None:
        done = any(ln.startswith("DONE\t") for ln in out.splitlines())
        return ("rows_then_running" if done and _rows(out) == clean
                else "running")
    if rc:
        return f"exit {rc}"
    return "rows" if _rows(out) == clean else "other_rows"


def _classify(rcs, outs, clean_rows) -> str:
    if any(rc is None for rc in rcs):
        return "no_finish"
    failed = [rc != 0 for rc in rcs]
    if all(failed):
        return "fails_both"
    if any(failed):
        return "fails_one"
    rows = [_rows(o) for o in outs]
    return "recovers" if rows == clean_rows else "wrong_rows"


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("restart_pairs"))
    lines_path = os.path.join(tmp, "lines.txt")
    with open(lines_path, "w") as f:
        f.write("\n".join(JOB_LINES))
    script = os.path.join(tmp, "worker.py")
    with open(script, "w") as f:
        f.write(f"POINTS = {POINTS!r}\n" + WORKER)
    started = {name: _start(tmp, name, lines_path, script)
               for name in ["clean"] + POINTS}
    deadline = time.monotonic() + PAIR_LIMIT_S
    done = {name: _finish(procs, deadline) for name, procs in started.items()}
    clean_rcs, clean_outs = done["clean"]
    assert clean_rcs == [0, 0], clean_outs
    clean_rows = [_rows(o) for o in clean_outs]
    return {"done": done, "clean_rows": clean_rows,
            "counts": [json.loads(next(
                ln.split("\t", 1)[1] for ln in o.splitlines()
                if ln.startswith("COUNTS\t"))) for o in clean_outs]}


def test_reference_clean_pair_splits_the_rows(pairs):
    """The clean pair (the restart strategy set, no fault) finishes with
    rows in both processes, and every fault's occurrence is reached on
    its rank, so each faulted pair really fires."""
    assert all(pairs["clean_rows"]), pairs["clean_rows"]
    for point, (rank, at) in FAULTS.items():
        assert pairs["counts"][rank][point] > at, (point, pairs["counts"])


@pytest.mark.parametrize("point", POINTS)
def test_reference_pair_under_fixed_delay(pairs, point):
    rcs, outs = pairs["done"][point]
    rank, at = FAULTS[point]
    fired = [ln for ln in outs[rank].splitlines() if ln.startswith("FIRED\t")]
    assert fired == [f"FIRED\t{rank}\t{point}\t{at}"], outs
    # the supervisor took the fault: the faulted process began again
    attempts = [ln for ln in outs[rank].splitlines()
                if ln.startswith("ATTEMPT\t")]
    assert len(attempts) == 2, outs
    clean = pairs["clean_rows"]
    got = (_classify(rcs, outs, clean),
           [_status(rc, o, c) for rc, o, c in zip(rcs, outs, clean)])
    assert got == REFERENCE_OUTCOME[point], (point, got, outs)
