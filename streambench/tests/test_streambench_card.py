"""On the card: the trace reads device time, and the command refuses to
run in a directory that holds only the benchmark."""

import os
import shutil
import subprocess
import sys

import pytest

from streambench.harness import HERE as BENCH, ROOT, Cell, run_cell


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bandwidth_eventtime.poll300s", "cpu_max.fleet128k"])
def test_a_traced_run_reads_the_device(card, tiny, name):
    cell = Cell(name, tiny, tiny.parent / "streambench")
    res, run = run_cell(cell, 2**31 + 3, 1.0, trace=True, device="cuda",
                        log=lambda *a: None)
    assert res["correct"], res["check"]
    dev = res["device"]
    assert dev["kind"] == card and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert 0 <= res["metrics"]["device_idle_pct"]["value"] < 100
    if name.startswith("cpu_max"):
        assert 0 < res["metrics"]["seq_rolling_roofline"]["value"] <= 105
    assert res["breakdown"]["device_ops"]


@pytest.mark.gpu
def test_the_command_refuses_without_the_port(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "streambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "streambench.run", "--workload",
         "bandwidth_eventtime.poll300s", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "{" not in out.stdout
