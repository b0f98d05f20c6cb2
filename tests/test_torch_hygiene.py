"""The PyTorch port stands alone: it imports neither JAX nor the
``tpustream`` package, names no path under ``tpustream/`` and loads no
file from there (its native parser is its own build under ``build/``),
and it never moves to the CPU unless asked."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "tpustream_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "tpustream" or top.startswith("jax")


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import tpustream_torch, tpustream_torch.jobs.chapter2_max\n"
        "import tpustream_torch.jobs.chapter3_bandwidth\n"
        "import tpustream_torch.jobs.chapter3_bandwidth_eventtime\n"
        "import tpustream_torch.runtime.executor, tpustream_torch.kernels\n"
        "import tpustream_torch.runtime.window_program\n"
        "import tpustream_torch.runtime.session_program\n"
        "import tpustream_torch.runtime.count_program\n"
        "import tpustream_torch.runtime.cep_program\n"
        "import tpustream_torch.jobs.chapter4_cep_alert\n"
        "import tpustream_torch.jobs.chapter5_dynamic_rules\n"
        "import tpustream_torch.tenancy, tpustream_torch.obs\n"
        "import tpustream_torch.jobs.chapter6_tenant_fleet\n"
        "import tpustream_torch.runtime.ingest, tpustream_torch.runtime.watchdog\n"
        "import tpustream_torch.runtime.controller\n"
        "import tpustream_torch.runtime.supervisor\n"
        "import tpustream_torch.runtime.checkpoint, tpustream_torch.utils.tree\n"
        "import tpustream_torch.parallel.lanes, tpustream_torch.testing\n"
        "import tpustream_torch.ops.ordered_scatter\n"
        "import tpustream_torch.obs.ledger, tpustream_torch.obs.memory\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True,
    ).stdout.split()
    assert "tpustream_torch.jobs.chapter2_max" in out
    assert "tpustream_torch.jobs.chapter3_bandwidth_eventtime" in out
    assert "tpustream_torch.runtime.cep_program" in out
    assert "tpustream_torch.broadcast.rules" in out
    assert "tpustream_torch.tenancy.server" in out
    assert "tpustream_torch.obs.compilation" in out
    assert "tpustream_torch.jobs.chapter6_tenant_fleet" in out
    assert "tpustream_torch.runtime.ingest" in out
    assert "tpustream_torch.parallel.lanes" in out
    assert "tpustream_torch.ops.ordered_scatter" in out
    assert "tpustream_torch.obs.ledger" in out
    assert "tpustream_torch.obs.memory" in out
    assert [m for m in out if _forbidden(m)] == []


def test_lane_worker_under_the_gate_imports_no_torch():
    """A lane worker starts in a fresh interpreter (the "spawn" start
    method) with ``TPUSTREAM_LANE_WORKER=1``: it parses a frame through
    the native plan and never imports torch, nor JAX, nor the JAX
    package; the public names still resolve, lazily."""
    code = (
        "import queue, sys, threading\n"
        "import tpustream_torch\n"
        "from tpustream_torch.hostparse import PExpr\n"
        "from tpustream_torch.parallel.lanes import (LaneSpec, ShmRing,\n"
        "    lane_worker_main, unpack_columns)\n"
        "from tpustream_torch.records import F64, STR\n"
        "spec = LaneSpec([PExpr.field(' ', 0),\n"
        "    PExpr('parse_f64', (PExpr.field(' ', 1),))], [STR, F64],\n"
        "    [True, False])\n"
        "a, b = ShmRing(1 << 16), ShmRing(1 << 16)\n"
        "qs = [queue.Queue() for _ in range(4)]\n"
        "stop = threading.Event()\n"
        "t = threading.Thread(target=lane_worker_main, args=(0, spec, a.name,\n"
        "    a.size, b.name, b.size, *qs, stop), daemon=True)\n"
        "t.start()\n"
        "data = b'x 1.5\\ny 2.5'\n"
        "off, cost = a.write(data, lambda: qs[2].get(timeout=10))\n"
        "qs[0].put(('frame', 0, off, cost, len(data), 2))\n"
        "r = qs[1].get(timeout=10)\n"
        "assert r[0] == 'frame', r\n"
        "cols = unpack_columns(r[6], spec.kinds, b.read(r[2], r[4]), 2)\n"
        "assert cols[1].tolist() == [1.5, 2.5], cols\n"
        "qs[0].put(('stop',)); stop.set(); t.join(10); a.close(); b.close()\n"
        "assert 'torch' not in sys.modules\n"
        "print(tpustream_torch.Tuple2.__name__)\n"
        "print('\\n'.join(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), TPUSTREAM_LANE_WORKER="1")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True,
    ).stdout.split()
    assert out[0] == "Tuple2"
    assert "tpustream_torch.parallel.lanes" in out
    assert "torch" not in out
    assert [m for m in out if _forbidden(m)] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_forbidden_import_in_source(path):
    assert [m for m in _imports(path) if _forbidden(m)] == []


def test_cuda_device_without_card_raises(monkeypatch):
    from tpustream_torch import StreamConfig, StreamExecutionEnvironment
    from tpustream_torch.jobs.chapter2_max import build
    from tpustream_torch.runtime.sources import ReplaySource

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = StreamExecutionEnvironment(StreamConfig())
    assert env.config.device == "cuda"
    handle = build(env, env.add_source(ReplaySource(["1 h cpu0 1.0"]))).collect()
    with pytest.raises(RuntimeError, match="cuda"):
        env.execute("k")
    assert handle.items == []


def test_flagship_on_cuda_without_card_raises(monkeypatch):
    from tpustream_torch import (
        StreamConfig,
        StreamExecutionEnvironment,
        TimeCharacteristic,
    )
    from tpustream_torch.jobs.chapter3_bandwidth_eventtime import build
    from tpustream_torch.runtime.sources import ReplaySource

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = StreamExecutionEnvironment(StreamConfig())
    env.set_stream_time_characteristic(TimeCharacteristic.EventTime)
    assert env.config.device == "cuda"
    lines = ["2019-08-28T10:00:00 www.163.com 10000",
             "2019-08-28T10:06:00 www.163.com 100"]
    handle = build(env, env.add_source(ReplaySource(lines))).collect()
    with pytest.raises(RuntimeError, match="cuda"):
        env.execute("BandwidthMonitorWithEventTime")
    assert handle.items == []


CITATION = re.compile(r"^tpustream/[\w/]+\.py:\d+(-\d+)?$")


def _string_constants(path: Path):
    """The string literals of a module that are not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = {
        id(node.body[0].value) for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef))
        and node.body and isinstance(node.body[0], ast.Expr)
        and isinstance(node.body[0].value, ast.Constant)
    }
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.value


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_path_under_the_reference_package(path):
    # a "file:line" citation of a reference kernel is not a path the
    # code opens; any other string naming tpustream/ (or the bare
    # component) could be one
    bad = [s for s in _string_constants(path)
           if s == "tpustream" or ("tpustream/" in s and not CITATION.match(s))]
    assert bad == []


def test_native_parser_loads_nothing_from_the_reference_package():
    # the port's parser library is its own build under build/, never the
    # reference's tpustream/native/_fastparse.so
    code = (
        "import tpustream_torch.native as n\n"
        "from tpustream_torch.hostparse import PlanEvaluator, trace_host_map\n"
        "from tpustream_torch.jobs.chapter1_threshold import parse\n"
        "from tpustream_torch.records import StringTable\n"
        "assert n.available(), n.build_error()\n"
        "p = trace_host_map(parse)\n"
        "ev = PlanEvaluator(p.outputs, [StringTable(), StringTable(), None])\n"
        "ev(['1 h cpu0 1.5'])\n"
        "assert ev.native_calls == 1\n"
        "print(open('/proc/self/maps').read())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    maps = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True,
    ).stdout
    mapped = {line.split()[-1] for line in maps.splitlines()
              if len(line.split()) >= 6}
    assert not [m for m in mapped if m.startswith(str(ROOT / "tpustream") + "/")]
    lib = [m for m in mapped if "libfastparse-" in m]
    assert lib and all(
        Path(m).parent == ROOT / "build" / "torch_native" for m in lib)
