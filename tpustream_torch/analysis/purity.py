"""User-function purity analysis: AST inspection + abstract evaluation.

Device-side user functions (post-parse ``map``/``filter``, window
applies, CEP predicates and selects) run on the device over whole
batches, and the JAX package traces them ONCE into its step program;
host-side ones (parse maps, key selectors, timestamp extractors) run
per batch but replay on restart.
Either way the runtime's exactly-once story assumes they are pure.
This module flags the classic violations statically:

* TSM020 — nondeterministic calls (``time``/``random``/``datetime``/
  ``uuid``): replay computes different values after a restart.
* TSM021 — captured mutable closures and global/nonlocal writes: traced
  once, mutated never (device) or reset on restart (host).
* TSM022 — Python side effects (``print``/``open``/``logging``) in
  device fns: they fire at trace time, exactly once, then never again.
* TSM023 — jax host callbacks inside device fns: a host round trip per
  batch from inside the fused step program. The port flags the same
  JAX entry points (``pure_callback``, ``io_callback``,
  ``jax.debug.print``, ...) by name, as the reference does: a job
  written for both packages calls them only under JAX, and the rule
  must say the same of the same function in either package. torch has
  no host callback of its own inside a device function: a ``.item()``
  or ``.tolist()`` there fails on the batch's tensors.
* TSM024 — dtype-widening returns (via :func:`abstract_record_eval`,
  the record-wrapping harness over 0-d tensors; the reference uses
  ``jax.eval_shape``): one recompile + doubled wire bytes.

AST inspection is best-effort: builtins and lambdas without reachable
source skip the AST rules — but visibly, via an INFO TSM025 finding,
so the coverage gap shows up in lint output and the
``analysis_findings_total{code="TSM025"}`` counter instead of passing
for a clean bill.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np

import torch

from ..records import BOOL, F64, I64, STR
from ..utils.tree import numpy_dtype
from .findings import Finding, make_finding

#: call roots whose mere use is nondeterministic under replay
_NONDET_ROOTS = {"random", "secrets", "uuid"}
#: (root, attr) leaves that read a clock or entropy; keyed on the LAST
#: attribute so `datetime.datetime.now()` and `LocalDateTime.parse()`
#: are told apart — parse of a record field is deterministic
_NONDET_ATTRS = {
    "now", "utcnow", "today", "time", "time_ns", "monotonic",
    "perf_counter", "process_time", "random", "randint", "randrange",
    "uniform", "gauss", "choice", "choices", "shuffle", "sample",
    "normal", "rand", "randn", "uuid1", "uuid4", "token_bytes",
    "token_hex", "urandom", "getrandbits",
}
#: bare-name calls that are nondeterministic regardless of module
_NONDET_BARE = {"time_ns", "perf_counter", "monotonic", "urandom"}

#: side-effecting builtins (device fns only: they fire at trace time)
_SIDE_EFFECT_CALLS = {"print", "open", "input", "breakpoint", "exec", "eval"}
_SIDE_EFFECT_ATTRS = {"write", "writelines", "debug", "info", "warning",
                      "error", "critical", "log"}

#: jax host-callback entry points (ERROR inside device fns)
_HOST_CALLBACK_ATTRS = {
    "pure_callback", "io_callback", "host_callback", "id_tap", "call",
}
_HOST_CALLBACK_QUALS = {
    ("debug", "print"), ("debug", "callback"),
    ("host_callback", "call"), ("host_callback", "id_tap"),
}

_MUTABLE_TYPES = (list, dict, set, bytearray)


def _fn_label(fn: Any, where: str) -> str:
    name = getattr(fn, "__name__", None) or type(fn).__name__
    return f"{where} fn {name!r}"


def _get_tree(fn: Any) -> Optional[ast.AST]:
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError):
        return None
    stripped = textwrap.dedent(src).strip()
    candidates = [
        textwrap.dedent(src),
        # a lambda mid-expression: wrap so it parses standalone
        "(" + stripped.rstrip(",") + ")",
        # a lambda on a fluent-chain line (".filter(lambda t: ...)"):
        # getsource returns the line starting at the dot — prefix a
        # dummy receiver so the call (and the lambda inside) parses
        "_" + stripped.rstrip(","),
        "(" + stripped.rstrip(",").rstrip(")") + ")",
    ]
    for cand in candidates:
        try:
            return ast.parse(cand)
        except SyntaxError:
            continue
    return None


def _call_names(call: ast.Call):
    """(bare_name, attr_chain) for a Call node: ``f(x)`` -> ("f", []),
    ``a.b.c(x)`` -> (None, ["a", "b", "c"])."""
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id, []
    chain: List[str] = []
    while isinstance(fn, ast.Attribute):
        chain.append(fn.attr)
        fn = fn.value
    if isinstance(fn, ast.Name):
        chain.append(fn.id)
    chain.reverse()
    return None, chain


def _callable_target(fn: Any):
    """The underlying function object to introspect (unwrap SAM-style
    objects with .filter/.map/.select/.get_key methods)."""
    if inspect.isfunction(fn) or inspect.ismethod(fn):
        return fn
    for meth in ("filter", "map", "select", "get_key", "getKey",
                 "extract_timestamp", "__call__"):
        m = getattr(fn, meth, None)
        if inspect.isfunction(m) or inspect.ismethod(m):
            return m
    return fn if callable(fn) else None


def analyze_callable(fn: Any, where: str = "map",
                     device: bool = True, node=None) -> List[Finding]:
    """Purity findings for one user callable. ``where`` names the role
    (map/filter/cep-predicate/process/...); ``device=True`` enables the
    device-only rules (side effects, host callbacks)."""
    findings: List[Finding] = []
    target = _callable_target(fn)
    if target is None:
        return findings
    label = _fn_label(target, where)

    # -- closure + global-write inspection (no source needed) ---------------
    closure = getattr(target, "__closure__", None) or ()
    freevars = getattr(getattr(target, "__code__", None), "co_freevars", ())
    for name, cell in zip(freevars, closure):
        try:
            val = cell.cell_contents
        except ValueError:
            continue
        if isinstance(val, _MUTABLE_TYPES):
            findings.append(make_finding(
                "TSM021", node,
                f"{label} closes over mutable {type(val).__name__} "
                f"{name!r}: traced once, per-record mutation will not "
                "happen and restarts reset it",
            ))

    tree = _get_tree(target)
    if tree is None:
        if getattr(target, "__code__", None) is None:
            # a C-implemented callable (len, operator.add, a native
            # method): it cannot contain the Python-level hazards the
            # AST rules look for — silence, not a coverage gap
            return findings
        # PR 10 skipped unreadable sources silently; the gap is now a
        # visible INFO finding (TSM025) so lint output and the findings
        # counter show what the AST rules could not cover
        findings.append(make_finding(
            "TSM025", node,
            f"{label}: source unavailable — AST purity rules "
            "(TSM020–TSM024) skipped for this function",
        ))
        return findings

    for stmt in ast.walk(tree):
        if isinstance(stmt, (ast.Global, ast.Nonlocal)):
            findings.append(make_finding(
                "TSM021", node,
                f"{label} declares {'global' if isinstance(stmt, ast.Global) else 'nonlocal'} "
                f"{', '.join(stmt.names)}: writes from a traced/replayed "
                "fn are lost or double-applied",
            ))

    for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)):
        bare, chain = _call_names(call)
        last = chain[-1] if chain else None
        root = chain[0] if chain else None

        # TSM023 host callbacks (device fns): checked before TSM020 so
        # jax.debug.print reports as a callback, not a side effect
        if device and (
            last in _HOST_CALLBACK_ATTRS
            or any(
                len(chain) >= 2 and tuple(chain[-2:]) == q
                for q in _HOST_CALLBACK_QUALS
            )
        ):
            findings.append(make_finding(
                "TSM023", node,
                f"{label} calls host callback "
                f"{'.'.join(chain) or bare}(): a host round trip per "
                "batch from inside the fused step program",
            ))
            continue

        # TSM020 nondeterminism (host and device: replay diverges)
        if (
            (root in _NONDET_ROOTS)
            or (bare in _NONDET_BARE)
            or (last in _NONDET_ATTRS and root != "self")
        ):
            findings.append(make_finding(
                "TSM020", node,
                f"{label} calls {'.'.join(chain) or bare}(): "
                "nondeterministic under replay — a supervised restart "
                "recomputes different values",
            ))
            continue

        # TSM022 side effects (device fns: fire at trace time only)
        if device and (
            bare in _SIDE_EFFECT_CALLS or last in _SIDE_EFFECT_ATTRS
        ):
            findings.append(make_finding(
                "TSM022", node,
                f"{label} calls {'.'.join(chain) or bare}(): inside a "
                "traced fn this runs ONCE at trace time, not per record",
            ))
    return findings


# -- abstract dtype evaluation ------------------------------------------------

def _kind_dtype(kind: str, value_dtype: str):
    if kind == F64:
        return np.dtype(value_dtype)
    if kind == I64:
        return np.dtype(np.int64)
    if kind == STR:
        return np.dtype(np.int32)
    return np.dtype(np.bool_)


class _TypedNumpyScalars(torch.overrides.TorchFunctionMode):
    """numpy scalars as JAX types them: a strongly typed 0-d value of
    their own dtype (``v * np.float64(2.0)`` widens a float32 ``v``),
    where torch would take them as weak Python numbers."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args = tuple(
            torch.tensor(a.item(), dtype=torch.from_numpy(np.asarray(a)).dtype)
            if isinstance(a, (np.floating, np.integer)) else a
            for a in args)
        return func(*args, **(kwargs or {}))


def abstract_record_eval(fn: Any, kinds: Sequence[str],
                         tables: Sequence[Any], value_dtype: str,
                         n_records: int = 1):
    """``fn`` over ``n_records`` records of ``kinds``, each field a 0-d CPU
    tensor of its kind's dtype (``value_dtype`` for a float field; 1 as
    a number's value, so an integer division cannot divide by zero, and
    id 0 as a string's), under the reference's arithmetic: the
    ``(values, kinds, tables)`` of the record it returns. What ``fn``
    raises propagates. This is the port's ``jax.eval_shape`` over scalar
    specs: one call on scalars, with no device, no data and no build."""
    from ..arith import reference_arithmetic
    from ..runtime.device import unwrap_record, wrap_record

    def leaf(kind):
        if kind == STR:
            return torch.zeros((), dtype=torch.int32)
        return torch.from_numpy(np.ones((), _kind_dtype(kind, value_dtype)))

    with reference_arithmetic(), _TypedNumpyScalars():
        records = [wrap_record(list(kinds), list(tables), [leaf(k) for k in kinds])
                   for _ in range(n_records)]
        return unwrap_record(fn(*records))


def check_dtype_widening(fn: Any, kinds: Sequence[str],
                         value_dtype: str = "float64",
                         where: str = "map", node=None) -> List[Finding]:
    """TSM024 via :func:`abstract_record_eval`: evaluate ``fn`` over a
    record of the given kinds and flag float outputs wider than the
    configured ``value_dtype``. Runs the fn once on scalars, never on
    the job's data, and builds no program; fns the harness cannot
    evaluate (string compares against a live table, data-dependent
    control flow) are skipped silently."""
    vdt = np.dtype(value_dtype)
    if vdt.itemsize >= 8:
        return []  # already at the widest supported float
    try:
        out, _, _ = abstract_record_eval(
            fn, kinds, [None] * len(kinds), value_dtype)
    except Exception:
        return []
    widened = [
        o for o in (numpy_dtype(t.dtype) for t in out)
        if np.issubdtype(o, np.floating) and o.itemsize > vdt.itemsize
    ]
    if not widened:
        return []
    label = _fn_label(_callable_target(fn) or fn, where)
    return [make_finding(
        "TSM024", node,
        f"{label} returns {', '.join(str(d) for d in sorted(set(map(str, widened))))} "
        f"but value_dtype={value_dtype}: the widened column re-traces "
        "the step program and doubles its wire bytes",
    )]


def _cep_fn_sites(node) -> Iterable[tuple]:
    pattern = node.params.get("pattern")
    for stage in getattr(pattern, "stages", None) or []:
        for cond in getattr(stage, "conds", []):
            yield cond, f"cep-predicate[{stage.name}]"
    sel = node.params.get("select_fn")
    if sel is not None:
        yield sel, "cep-select"


def run_purity_rules(ctx) -> List[Finding]:
    """Walk every sink chain and analyze each user callable in its
    role. Host-side roles (raw-stage ops, key selectors, timestamp
    extractors) skip the device-only rules."""
    findings: List[Finding] = []
    seen: set = set()
    value_dtype = getattr(ctx.cfg, "value_dtype", "float64")
    for chain in ctx.chains:
        parsed = False  # first map on the raw stage is the host parse
        parse_kinds: Optional[List[str]] = None
        for n in chain:
            if n.nid in seen:
                # still track the parse boundary along shared prefixes
                if n.op == "map" and not parsed:
                    parsed = True
                continue
            seen.add(n.nid)
            if n.op in ("map", "filter", "flat_map"):
                fn = n.params.get("fn")
                device = parsed and n.op != "flat_map"
                findings.extend(
                    analyze_callable(fn, n.op, device=device, node=n)
                )
                if n.op == "map" and not parsed:
                    parsed = True
                    parse_kinds = _infer_parse_kinds(fn)
                elif device and n.op == "map" and parse_kinds:
                    findings.extend(check_dtype_widening(
                        fn, parse_kinds, value_dtype, "map", node=n
                    ))
                    parse_kinds = None  # arity may change past the first map
            elif n.op == "assign_ts":
                assigner = n.params.get("assigner")
                extract = getattr(assigner, "extract_timestamp", None)
                if extract is not None:
                    findings.extend(analyze_callable(
                        extract, "timestamp-extractor", device=False, node=n
                    ))
            elif n.op == "key_by":
                key = n.params.get("key")
                if not isinstance(key, int):
                    findings.extend(analyze_callable(
                        key, "key-selector", device=False, node=n
                    ))
            elif n.op == "rolling_reduce":
                findings.extend(analyze_callable(
                    n.params.get("fn"), "reduce", device=True, node=n
                ))
            elif n.op.startswith("window_"):
                fn = n.params.get("fn")
                if fn is not None:
                    findings.extend(analyze_callable(
                        fn, n.op.removeprefix("window_"), device=True, node=n
                    ))
            elif n.op == "cep":
                for fn, role in _cep_fn_sites(n):
                    findings.extend(analyze_callable(
                        fn, role, device=True, node=n
                    ))
    return findings


def _infer_parse_kinds(fn) -> Optional[List[str]]:
    """Record kinds the host parse map emits (via the symbolic host-map
    tracer); None when the parse falls back to adaptive resolution."""
    try:
        from .. import hostparse

        plan = hostparse.trace_host_map(fn)
    except Exception:
        return None
    if getattr(plan, "fallback_fn", None) is not None:
        return None
    kinds = list(getattr(plan, "kinds", []) or [])
    return kinds or None
