"""``python -m tpustream_torch.analysis.lint`` — job-module lint CLI.

Imports job modules (``tpustream_torch.jobs.chapter*`` by default, or any
module path given on the command line), asks each for its lintable env
via the module's ``lint_env()`` hook, runs :func:`tpustream_torch.analysis
.analyze`, and prints findings. Exit status: 0 = no ERROR findings,
1 = at least one ERROR, 2 = a module could not be imported/linted.

Output formats (``--format``):

* ``text``   — human-readable per-module summaries (default)
* ``json``   — one stable machine-readable document: per-module status
  plus finding records (code/severity/node/message/fix_hint), the
  CI-consumable form
* ``github`` — GitHub Actions workflow annotations
  (``::error``/``::warning``/``::notice``), one line per finding

Job modules opt in by defining ``lint_env() -> StreamExecutionEnvironment``
returning a CONSTRUCTED (never executed) env — typically the module's
``build`` over a tiny ``from_collection`` source.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pkgutil
import sys
from typing import List, Optional

from . import analyze
from .findings import ERROR, Finding, WARN


def discover_job_modules() -> List[str]:
    from .. import jobs

    return sorted(
        f"tpustream_torch.jobs.{m.name}"
        for m in pkgutil.iter_modules(jobs.__path__)
        if m.name.startswith("chapter")
    )


def finding_record(f: Finding) -> dict:
    """The stable JSON form of one finding — keys are part of the CLI
    contract (tests round-trip them against the CATALOG)."""
    return {
        "code": f.code,
        "severity": f.severity,
        "node": repr(f.node) if f.node is not None else None,
        "message": f.message,
        "fix_hint": f.fix_hint,
    }


def _github_line(module: str, f: Finding) -> str:
    level = {"error": "error", "warn": "warning"}.get(f.severity, "notice")
    # annotation messages are single-line; %0A is the Actions escape
    msg = str(f).replace("%", "%25").replace("\r", "").replace("\n", "%0A")
    return f"::{level} title={f.code} ({module})::{msg}"


def lint_module(name: str, out=sys.stdout, fmt: str = "text"):
    """Lint one module; returns (exit status 0/1/2, module record)."""
    record = {"module": name, "status": "ok", "findings": []}
    try:
        mod = importlib.import_module(name)
    except Exception as e:
        record["status"] = "import-failed"
        record["error"] = str(e)
        if fmt == "text":
            print(f"{name}: IMPORT FAILED: {e}", file=out)
        return 2, record
    hook = getattr(mod, "lint_env", None)
    if hook is None:
        record["status"] = "skipped"
        if fmt == "text":
            print(f"{name}: no lint_env() hook — skipped", file=out)
        return 0, record
    try:
        env = hook()
        findings = analyze(env)
    except Exception as e:
        record["status"] = "lint-failed"
        record["error"] = f"{type(e).__name__}: {e}"
        if fmt == "text":
            print(f"{name}: LINT FAILED: {record['error']}", file=out)
        return 2, record
    errors = sum(1 for f in findings if f.severity == ERROR)
    warns = sum(1 for f in findings if f.severity == WARN)
    record["status"] = "fail" if errors else "ok"
    record["findings"] = [finding_record(f) for f in findings]
    if fmt == "text":
        status = "FAIL" if errors else "ok"
        print(
            f"{name}: {status} ({errors} errors, {warns} warnings, "
            f"{len(findings)} findings)",
            file=out,
        )
        for f in findings:
            print(f"  {f}", file=out)
    elif fmt == "github":
        for f in findings:
            print(_github_line(name, f), file=out)
    return (1 if errors else 0), record


def main(argv: Optional[List[str]] = None, out=sys.stdout) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpustream_torch.analysis.lint",
        description="pre-flight static analysis of tpustream_torch job modules",
    )
    parser.add_argument(
        "modules", nargs="*",
        help="job module paths (default: every tpustream_torch.jobs.chapter*)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "github"), default="text",
        dest="fmt", help="output format (json/github are CI-consumable)",
    )
    args = parser.parse_args(argv)
    modules = args.modules or discover_job_modules()
    rc = 0
    records = []
    for name in modules:
        code, record = lint_module(name, out=out, fmt=args.fmt)
        rc = max(rc, code)
        records.append(record)
    if args.fmt == "json":
        print(json.dumps({"modules": records, "exit": rc}, indent=2), file=out)
    return rc


if __name__ == "__main__":
    sys.exit(main())
