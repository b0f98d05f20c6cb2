"""What a run loads: never JAX nor the JAX package (top-level module
names compared whole: ``tpustream_torch`` begins with ``tpustream``),
and the yardstick (references, comparison, generator) nothing of the
program."""

import ast
import json
import subprocess
import sys
import types

import pytest

from streambench.harness import FORBIDDEN, HERE as BENCH, ROOT, forbidden_modules

PROGRAM = ("tpustream_torch",)


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("tpustream_torch", "tpustream_torch.runtime", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == []
    for name in ("tpustream", "tpustream.runtime", "jaxlib", "flax.core"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert forbidden_modules() == ["flax.core", "jaxlib", "tpustream",
                                   "tpustream.runtime"]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported_roots(path) & set(FORBIDDEN), path


@pytest.mark.parametrize("sub", ["reference", "traffic", "check.py", "lines.py",
                                 "roofline.py"])
def test_the_yardstick_imports_nothing_of_the_program(sub):
    paths = [BENCH / sub] if sub.endswith(".py") else list((BENCH / sub).glob("*.py"))
    assert paths
    for path in paths:
        assert not imported_roots(path) & set(FORBIDDEN + PROGRAM), path


def test_a_run_loads_no_jax(tiny):
    """A whole CPU run of each cell in a fresh process, then the check
    the command makes once the window has closed."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from streambench.harness import Cell, run_cell, forbidden_modules\n"
        f"m = Path({str(tiny)!r})\n"
        "for name in ('bandwidth_eventtime.poll300s', 'cpu_max.fleet128k'):\n"
        "    res, _ = run_cell(Cell(name, m, m.parent / 'streambench'), 9, 0.3,\n"
        "                      device='cpu', log=lambda *a: None)\n"
        "    assert res['correct']\n"
        "print(json.dumps(forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tiny.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the command would run the cell")
    out = subprocess.run(
        [sys.executable, "-m", "streambench.run", "--workload",
         "bandwidth_eventtime.poll300s", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr
