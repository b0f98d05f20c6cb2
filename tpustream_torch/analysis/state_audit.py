"""Static checkpoint state-layout audit.

Derives the EXPECTED checkpoint leaf tree straight from the constructed
job graph — component names from each program family's
``STATE_COMPONENT_KEYS``, leaf dtypes and shapes (symbolic in K/T/p)
from the program's ``jax_state_spec`` (its state in the JAX package's
snapshot layout, built on the ``meta`` device: nothing allocates) —
without running a step, then diffs it against an on-disk snapshot's
MANIFEST: the
``__meta__`` JSON plus each ``L%04d`` member's npy header (dtype +
shape). State arrays are never loaded; a multi-GB snapshot audits in
milliseconds.

The diff is phrased as TSM040–TSM047 findings (findings.CATALOG) and a
verdict that matches what restore would actually do:

* ``compatible``   — ``load_checkpoint`` + ``restore_state`` succeed
  (key-capacity growth and parallelism rescale are supported, so they
  stay compatible with INFO findings)
* ``incompatible`` — restore would raise (version gap, corrupt file,
  leaf-tree drift, dtype/shape mismatch, tenant-capacity drift)
* ``unknown``      — the layout is only partially derivable statically
  (a full-window process() feeds a lazily-schemed chain stage), so only
  meta-level checks ran

Surfaces: ``env.audit_checkpoint(path)``, the
``python -m tpustream_torch.analysis.audit`` CLI, and the supervisor's
``latest_checkpoint(audit=...)`` hook that pre-empts a mid-restore
failure with an explained ``checkpoint_skipped`` breadcrumb.
"""

from __future__ import annotations

import json
import zipfile
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .findings import ERROR, Finding, INFO, make_finding

__all__ = [
    "ExpectedLeaf",
    "ExpectedLayout",
    "ManifestLeaf",
    "Manifest",
    "AuditReport",
    "expected_layout",
    "read_manifest",
    "audit_checkpoint",
    "audit_manifest_only",
]


@dataclass(frozen=True)
class ExpectedLeaf:
    """One leaf of the expected checkpoint state tree."""

    name: str                 # "stage0/pane_ring/acc" — stage/component/key
    stage: int
    component: str            # STATE_COMPONENT_KEYS group, "rules", "scalars"
    dtype: str                # numpy dtype name
    shape: Tuple[int, ...]
    symbolic: str             # "(K, 3)" — dims matched against K/T/p/B
    key_sharded: bool         # leading dim splits over the key axis


@dataclass
class ExpectedLayout:
    """The full leaf tree a snapshot of this job must hold, in the
    exact order ``save_checkpoint`` flattens it."""

    leaves: List[ExpectedLeaf] = field(default_factory=list)
    format_version: int = 0
    n_stages: int = 0
    parallelism: int = 1
    tenant_capacity: int = 0          # 0 = no tenancy
    key_capacities: List[int] = field(default_factory=list)
    has_rules: bool = False
    #: True when a host-evaluated stage blocks static derivation of the
    #: downstream stages' leaves — structural diffs are skipped then
    partial: bool = False


@dataclass(frozen=True)
class ManifestLeaf:
    name: str                 # npz member name, "L0007"
    dtype: str
    shape: Tuple[int, ...]


@dataclass
class Manifest:
    """A snapshot's metadata + per-leaf headers (arrays never loaded)."""

    path: str
    meta: Dict[str, Any]
    leaves: List[ManifestLeaf]


@dataclass
class AuditReport:
    path: str
    verdict: str                          # compatible | incompatible | unknown
    findings: List[Finding]
    expected: Optional[ExpectedLayout] = None
    manifest: Optional[Manifest] = None

    @property
    def reason(self) -> Optional[str]:
        """Short one-line reason (first ERROR finding) for supervisor
        breadcrumbs; None when nothing blocks a restore."""
        for f in self.findings:
            if f.severity == ERROR:
                return f"{f.code} {f.message}"
        return None


# -- expected layout ----------------------------------------------------------

def _abstract_state(prog):
    """Leaf tree of the program's state in the JAX package's snapshot
    layout (``jax_state_spec``: zero-memory leaves of the right shape
    and dtype) as (path, leaf) pairs, in ``jax.tree_util`` order."""
    tree = prog.jax_state_spec()
    return _leaves_with_path(tree), tree


def _leaves_with_path(tree, path=()):
    """``jax.tree_util.tree_flatten_with_path``'s leaves of a nested
    dict/list state: dict keys by sorted key, list items by index."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree)
                for pl in _leaves_with_path(x, path + (i,))]
    return [(path, tree)]


def _path_key(path) -> str:
    """A tree path as "a/b/0" ('acc' from a one-key path)."""
    return "/".join(str(p) for p in path) if path else "<root>"


def _symbolic(shape, cfg, key_capacity, tenant_capacity) -> str:
    dims = []
    for d in shape:
        if d == key_capacity:
            dims.append("K")
        elif tenant_capacity and d == tenant_capacity:
            dims.append("T")
        elif cfg.parallelism > 1 and d == cfg.parallelism:
            dims.append("p")
        elif d == cfg.batch_size:
            dims.append("B")
        else:
            dims.append(str(d))
    return "(" + ", ".join(dims) + ")"


def expected_layout(env, sink_nodes=None, key_capacities=None) -> ExpectedLayout:
    """Derive the expected snapshot leaf tree from the job graph.

    ``key_capacities``: per-stage effective capacities (a snapshot's
    recorded capacities, already maxed against the config by the
    caller) — restore rebuilds each stage at that capacity, so the
    audit must derive shapes the same way.
    """
    from ..runtime.plan import build_plan_chain
    from ..runtime.step import RULES_KEY, build_program
    from ..utils.tree import tree_leaves
    from ..records import STR
    from ..records import DerivedKeyTable

    cfg = env.config
    sinks = list(sink_nodes if sink_nodes is not None else env._sinks)
    plans = build_plan_chain(env, sinks)
    layout = ExpectedLayout(
        format_version=_format_version(),
        n_stages=len(plans),
        parallelism=max(1, cfg.parallelism),
        tenant_capacity=(
            getattr(plans[0].rules, "tenant_capacity", 0)
            if plans[0].rules is not None else 0
        ),
        has_rules=plans[0].rules is not None,
    )
    upstream = None
    for i, plan in enumerate(plans):
        cap = cfg.key_capacity
        if key_capacities and i < len(key_capacities) and key_capacities[i]:
            cap = max(cap, int(key_capacities[i]))
        layout.key_capacities.append(cap)
        # the layout does not depend on the device: each stage's program
        # is built for the CPU, so the audit runs on a host without the
        # card and allocates nothing on one
        stage_cfg = replace(cfg, key_capacity=cap, device="cpu")
        if i > 0:
            if upstream is None or getattr(upstream, "host_evaluated", False):
                # a full-window process() feeds this stage: its schema
                # (and so its leaf tree) resolves only at runtime
                layout.partial = True
                break
            plan.record_kinds.extend(upstream.out_kinds)
            plan.tables.extend(upstream.out_tables)
            if plan.synthetic_key:
                plan.record_kinds.append(STR)
                plan.tables.append(DerivedKeyTable())
        try:
            prog = build_program(plan, stage_cfg)
        except Exception:
            layout.partial = True
            break
        leaves, tree = _abstract_state(prog)
        components = prog.state_components()
        # which leaves the reference's state_specs shard on the key axis
        # (its rule, per family, holds at any parallelism)
        sharded = tree_leaves(prog.key_sharded_leaves(tree))
        for (path, leaf), key_sharded in zip(leaves, sharded):
            key = _path_key(path)
            top = key.split("/")[0]
            if top == RULES_KEY or key.startswith(RULES_KEY):
                comp = "rules"
            else:
                comp = components.get(top, "scalars")
            layout.leaves.append(ExpectedLeaf(
                name=f"stage{i}/{comp}/{key}",
                stage=i,
                component=comp,
                dtype=np.dtype(leaf.dtype).name,
                shape=tuple(int(d) for d in leaf.shape),
                symbolic=_symbolic(
                    leaf.shape, cfg, cap, layout.tenant_capacity
                ),
                key_sharded=key_sharded,
            ))
        upstream = prog
    return layout


def _format_version() -> int:
    from ..runtime.checkpoint import FORMAT_VERSION

    return FORMAT_VERSION


# -- manifest reading ---------------------------------------------------------

def read_manifest(path: str) -> Manifest:
    """Read a snapshot's metadata and per-leaf npy HEADERS (dtype +
    shape) without loading any state array. An incremental manifest
    (v12+) carries its leaf headers in ``meta["chunks"]`` instead of
    ``L%04d`` members — both forms yield the same leaf list. Raises on
    files that are not tpustream snapshots (callers turn that into
    TSM046)."""
    from ..runtime.checkpoint import _META_KEY
    from numpy.lib import format as npfmt

    leaves: List[ManifestLeaf] = []
    meta = None
    with zipfile.ZipFile(path) as z:
        names = sorted(z.namelist())
        for name in names:
            base = name[:-4] if name.endswith(".npy") else name
            if base == _META_KEY:
                with z.open(name) as f:
                    meta = json.loads(npfmt.read_array(f).tobytes().decode())
            elif base.startswith("L"):
                with z.open(name) as f:
                    version = npfmt.read_magic(f)
                    if version == (1, 0):
                        shape, _, dtype = npfmt.read_array_header_1_0(f)
                    else:
                        shape, _, dtype = npfmt.read_array_header_2_0(f)
                leaves.append(ManifestLeaf(
                    name=base, dtype=np.dtype(dtype).name,
                    shape=tuple(int(d) for d in shape),
                ))
    if meta is None:
        raise KeyError(_META_KEY)
    if not leaves and meta.get("chunks"):
        # incremental manifest form (FORMAT_VERSION >= 12): the npz
        # holds only __meta__; each leaf's dtype/shape rides its chunk
        # reference, so the audit surface is identical without touching
        # the chunk store at all
        leaves = [
            ManifestLeaf(
                name=f"L{i:04d}",
                dtype=np.dtype(ref["dtype"]).name,
                shape=tuple(int(d) for d in ref["shape"]),
            )
            for i, ref in enumerate(meta["chunks"])
        ]
    return Manifest(path=path, meta=meta, leaves=leaves)


# -- the audit ----------------------------------------------------------------

def audit_checkpoint(env, path: str, sink_nodes=None) -> AuditReport:
    """Diff ``path``'s manifest against the job graph's expected state
    layout. Never loads state arrays; never compiles."""
    findings: List[Finding] = []
    try:
        manifest = read_manifest(path)
    except Exception as e:
        findings.append(make_finding(
            "TSM046", None,
            f"{path}: not a readable snapshot ({type(e).__name__}: {e})",
        ))
        return AuditReport(path, "incompatible", findings)

    meta = manifest.meta
    saved_caps = [int(c) for c in (meta.get("key_capacities") or [])]
    try:
        expected = expected_layout(env, sink_nodes, key_capacities=saved_caps)
    except Exception as e:
        findings.extend(_meta_findings(meta, None, env))
        findings.append(make_finding(
            "TSM046", None,
            f"expected layout underivable ({type(e).__name__}: {e})",
            severity=INFO,
        ))
        verdict = "incompatible" if any(
            f.severity == ERROR for f in findings
        ) else "unknown"
        return AuditReport(path, verdict, findings, manifest=manifest)

    findings.extend(_meta_findings(meta, expected, env))
    if not expected.partial:
        findings.extend(_diff_leaves(expected, manifest))
    findings.sort(key=lambda f: (-_rank(f.severity), f.code))
    if any(f.severity == ERROR for f in findings):
        verdict = "incompatible"
    elif expected.partial:
        verdict = "unknown"
    else:
        verdict = "compatible"
    return AuditReport(path, verdict, findings, expected, manifest)


def audit_manifest_only(path: str) -> AuditReport:
    """Meta-level audit with no job graph (the bare CLI form): version,
    readability, and a manifest listing — structural diffs need an env."""
    findings: List[Finding] = []
    try:
        manifest = read_manifest(path)
    except Exception as e:
        findings.append(make_finding(
            "TSM046", None,
            f"{path}: not a readable snapshot ({type(e).__name__}: {e})",
        ))
        return AuditReport(path, "incompatible", findings)
    findings.extend(_meta_findings(manifest.meta, None, None))
    verdict = "incompatible" if any(
        f.severity == ERROR for f in findings
    ) else "unknown"
    return AuditReport(path, verdict, findings, manifest=manifest)


def _rank(sev: str) -> int:
    from .findings import severity_rank

    return severity_rank(sev)


def _meta_findings(meta, expected, env) -> List[Finding]:
    from ..runtime.checkpoint import FORMAT_VERSION, MIGRATIONS

    out: List[Finding] = []
    version = meta.get("version")
    if version != FORMAT_VERSION:
        gap = _migration_narrative(version, FORMAT_VERSION, MIGRATIONS)
        out.append(make_finding(
            "TSM045", None,
            f"snapshot format v{version} != this build's "
            f"v{FORMAT_VERSION}{gap}",
        ))
    if expected is not None:
        saved_t = (meta.get("tenancy") or {}).get("capacity", 0)
        if expected.tenant_capacity and saved_t and (
            int(saved_t) != expected.tenant_capacity
        ):
            out.append(make_finding(
                "TSM044", None,
                f"snapshot tenant capacity {saved_t} != fleet capacity "
                f"{expected.tenant_capacity} — [T] rule vectors and the "
                "tenant→slot map would mis-index",
            ))
        saved_p = int(meta.get("parallelism", 1))
        if saved_p != expected.parallelism:
            out.append(make_finding(
                "TSM047", None,
                f"snapshot parallelism {saved_p} != configured "
                f"{expected.parallelism}; restore rescales every "
                "key-sharded leaf through the canonical key-major order",
            ))
    return out


def _migration_narrative(saved, current, migrations) -> str:
    """': vN changed ...' lines for every version between the snapshot's
    and this build's (either direction)."""
    if not isinstance(saved, int):
        return ""
    lo, hi = sorted((saved, current))
    steps = [
        f"  v{v}: {migrations[v]}"
        for v in range(lo + 1, hi + 1)
        if v in migrations
    ]
    if not steps:
        return " (a future format this build does not know)"
    return " — changed in between:\n" + "\n".join(steps)


def _diff_leaves(expected: ExpectedLayout, manifest: Manifest) -> List[Finding]:
    out: List[Finding] = []
    exp, got = expected.leaves, manifest.leaves
    if len(got) < len(exp):
        missing = ", ".join(l.name for l in exp[len(got):][:6])
        out.append(make_finding(
            "TSM040", None,
            f"snapshot holds {len(got)} state leaves, the job expects "
            f"{len(exp)} — missing tail: {missing}",
        ))
        return out
    if len(got) > len(exp):
        out.append(make_finding(
            "TSM041", None,
            f"snapshot holds {len(got)} state leaves, the job expects "
            f"{len(exp)} — {len(got) - len(exp)} orphaned leaf(s) past "
            f"{exp[-1].name if exp else '<empty layout>'}",
        ))
        return out
    for e, m in zip(exp, got):
        if e.dtype != m.dtype:
            out.append(make_finding(
                "TSM042", None,
                f"{e.name} ({m.name}): snapshot dtype {m.dtype} != "
                f"expected {e.dtype} {e.symbolic}",
            ))
            continue
        if e.shape == m.shape:
            continue
        growable = (
            e.key_sharded
            and len(m.shape) == len(e.shape)
            and m.shape[0] < e.shape[0]
            and m.shape[1:] == e.shape[1:]
        )
        if growable:
            out.append(make_finding(
                "TSM043", None,
                f"{e.name} ({m.name}): snapshot key rows {m.shape[0]} < "
                f"capacity {e.shape[0]} — restore grows the saved rows "
                "into the larger layout",
                severity=INFO,
            ))
        else:
            out.append(make_finding(
                "TSM043", None,
                f"{e.name} ({m.name}): snapshot shape {m.shape} != "
                f"expected {e.shape} {e.symbolic}",
            ))
    return out
