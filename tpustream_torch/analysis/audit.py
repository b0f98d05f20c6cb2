"""CLI for the checkpoint state-layout auditor.

    python -m tpustream_torch.analysis.audit <ckpt.npz> [--job MODULE] [--format F]

Without ``--job`` only the manifest + meta-level checks run (format
version, readability); with ``--job`` naming a module that exposes
``lint_env()`` (the lint CLI's hook) the snapshot is diffed against
that job's full expected state layout.

Exit codes mirror the lint CLI: 0 clean/compatible, 1 warnings only,
2 errors (incompatible).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import Optional

from .findings import ERROR, WARN
from .lint import finding_record
from .state_audit import AuditReport, audit_checkpoint, audit_manifest_only


def _report_json(report: AuditReport) -> dict:
    out = {
        "path": report.path,
        "verdict": report.verdict,
        "reason": report.reason,
        "findings": [finding_record(f) for f in report.findings],
    }
    if report.manifest is not None:
        out["manifest"] = {
            "meta_version": report.manifest.meta.get("version"),
            "job_name": report.manifest.meta.get("job_name"),
            "parallelism": report.manifest.meta.get("parallelism"),
            "leaves": [
                {"name": l.name, "dtype": l.dtype, "shape": list(l.shape)}
                for l in report.manifest.leaves
            ],
        }
    if report.expected is not None:
        out["expected"] = [
            {
                "name": l.name,
                "dtype": l.dtype,
                "shape": list(l.shape),
                "symbolic": l.symbolic,
                "component": l.component,
                "key_sharded": l.key_sharded,
            }
            for l in report.expected.leaves
        ]
    return out


def _print_text(report: AuditReport, out) -> None:
    print(f"{report.path}: {report.verdict}", file=out)
    if report.manifest is not None:
        meta = report.manifest.meta
        print(
            f"  snapshot: format v{meta.get('version')} "
            f"job={meta.get('job_name')!r} "
            f"parallelism={meta.get('parallelism', 1)} "
            f"leaves={len(report.manifest.leaves)}",
            file=out,
        )
    if report.expected is not None and report.expected.leaves:
        print(
            f"  expected: {len(report.expected.leaves)} leaves over "
            f"{report.expected.n_stages} stage(s)",
            file=out,
        )
        for l in report.expected.leaves:
            print(f"    {l.name}: {l.dtype} {l.symbolic}", file=out)
    for f in report.findings:
        print(f"  {f}", file=out)


def main(argv=None, out=None) -> int:
    out = out if out is not None else sys.stdout
    ap = argparse.ArgumentParser(
        prog="python -m tpustream_torch.analysis.audit",
        description="audit a checkpoint's state layout against a job graph",
    )
    ap.add_argument("checkpoint", help="path to a ckpt-*.npz snapshot")
    ap.add_argument(
        "--job",
        help="module exposing lint_env() whose job graph supplies the "
        "expected layout (e.g. tpustream_torch.jobs.chapter3_bandwidth)",
    )
    ap.add_argument(
        "--format", choices=("text", "json"), default="text", dest="fmt"
    )
    args = ap.parse_args(argv)

    env: Optional[object] = None
    if args.job:
        mod = importlib.import_module(args.job)
        hook = getattr(mod, "lint_env", None)
        if hook is None:
            print(f"{args.job}: no lint_env() hook", file=out)
            return 2
        env = hook()
    if env is not None:
        report = env.audit_checkpoint(args.checkpoint)
    else:
        report = audit_manifest_only(args.checkpoint)

    if args.fmt == "json":
        print(json.dumps(_report_json(report), indent=2), file=out)
    else:
        _print_text(report, out)
    if any(f.severity == ERROR for f in report.findings):
        return 2
    if any(f.severity == WARN for f in report.findings):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
