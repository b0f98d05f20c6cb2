"""Fixtures of the benchmark's tests: a copy of the benchmark cut to a
size the CPU runs in seconds, and the card check for the tests marked
``gpu`` (decided inside the fixture, never at import)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the CPU size of each configuration and cell: widths and window
# parameters as committed, scale cut
TINY_CONFIG = {"bandwidth_eventtime": {"batch_size": 256, "key_capacity": 1024,
                                       "alert_capacity": 1 << 14},
               "cpu_max": {"batch_size": 256, "key_capacity": 128}}
TINY_CELL = {"bandwidth_eventtime.poll300s": {"keys": 1024, "warm_batches": 2},
             "cpu_max.fleet128k": {"keys": 128, "warm_batches": 2}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


def full_copy(dest: Path) -> Path:
    """A copy of ``streambench/`` under ``dest`` with ``BENCHMARK.json``;
    returns the copy's manifest."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "streambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest / "BENCHMARK.json"


def tiny_copy(dest: Path) -> Path:
    """:func:`full_copy` with every configuration and cell cut to CPU
    size."""
    full_copy(dest)
    for name, sizes in TINY_CONFIG.items():
        p = dest / "streambench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["stream_config"].update(sizes)
        p.write_text(json.dumps(c))
    for name, params in TINY_CELL.items():
        p = dest / "streambench" / "workloads" / f"{name}.json"
        c = json.loads(p.read_text())
        c.update(params)
        p.write_text(json.dumps(c))
    return dest / "BENCHMARK.json"


@pytest.fixture
def tiny(tmp_path):
    return tiny_copy(tmp_path)


@pytest.fixture
def full(tmp_path):
    return full_copy(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port there")
    return torch.cuda.get_device_name(0)
