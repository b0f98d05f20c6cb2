"""Host-side parse planning: symbolic interpretation of string map functions.

The reference's jobs parse raw socket lines inside per-record
``MapFunction``s (``value.split(" ")`` + ``Double.parseDouble`` at
chapter1/.../Main.java:18-26; ISO-8601 + UTC+8 epoch at
chapter3/.../BandwidthMonitorWithEventTime.java:36-45). A JVM runs those
per record; a TPU framework must not. Instead the planner runs the user's
function ONCE with symbolic string values, records the expression tree it
builds (split/field/parse/arithmetic), and compiles it to a vectorized
columnar numpy parser.
Functions that defeat symbolic interpretation fall back to a per-record
Python loop with identical semantics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .api.functions import as_callable
from .api.tuples import TupleBase
from .records import BOOL, F64, I64, STR, StringTable
from .runtime.spans import NULL_SPANS
from .utils.timeutil import iso_local_to_epoch_sec_np


class NotSymbolic(Exception):
    """Raised when a user function cannot be interpreted symbolically."""


# ---------------------------------------------------------------------------
# Expression tree
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PExpr:
    op: str                  # raw | field | parse_f64 | parse_i64 | parse_iso | bin | const
    args: tuple = ()

    # convenience constructors
    @staticmethod
    def raw() -> "PExpr":
        return PExpr("raw")

    @staticmethod
    def field(sep: str, index: int) -> "PExpr":
        return PExpr("field", (sep, index))

    @staticmethod
    def const(v) -> "PExpr":
        return PExpr("const", (v,))


def _kind_of(e: PExpr) -> str:
    if e.op in ("raw", "field"):
        return STR
    if e.op == "parse_f64":
        return F64
    if e.op in ("parse_i64", "parse_iso"):
        return I64
    if e.op == "const":
        return F64 if isinstance(e.args[0], float) else I64
    if e.op == "bin":
        op, a, b = e.args
        if op == "truediv":
            return F64
        ka, kb = _kind_of(a), _kind_of(b)
        return F64 if F64 in (ka, kb) else I64
    raise NotSymbolic(f"unknown expr {e.op}")


# ---------------------------------------------------------------------------
# Symbolic values handed to the user function
# ---------------------------------------------------------------------------

class SymStr:
    """Symbolic string value (a raw line or a split field)."""

    def __init__(self, expr: PExpr):
        self._expr = expr

    def split(self, sep: str) -> "SymSplit":
        if self._expr.op != "raw":
            raise NotSymbolic("nested split is not supported symbolically")
        return SymSplit(sep)

    def __float__(self):  # pragma: no cover - defensive
        raise NotSymbolic("use Double.parseDouble / javacompat for symbolic parse")

    def __int__(self):  # pragma: no cover - defensive
        raise NotSymbolic("use Long.parseLong / javacompat for symbolic parse")


class SymSplit:
    def __init__(self, sep: str):
        self._sep = sep

    def __getitem__(self, i) -> SymStr:
        if not isinstance(i, int):
            raise NotSymbolic("split index must be a constant int")
        return SymStr(PExpr.field(self._sep, i))


def _coerce(v) -> PExpr:
    if isinstance(v, SymNum):
        return v._expr
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return PExpr.const(v)
    raise NotSymbolic(f"cannot mix symbolic value with {type(v).__name__}")


class SymNum:
    """Symbolic numeric value supporting +, -, *, / with constants."""

    def __init__(self, expr: PExpr):
        self._expr = expr

    def _bin(self, op: str, other, rev: bool = False) -> "SymNum":
        a, b = _coerce(self), _coerce(other)
        if rev:
            a, b = b, a
        return SymNum(PExpr("bin", (op, a, b)))

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, rev=True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, rev=True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, rev=True)

    def __truediv__(self, o):
        return self._bin("truediv", o)

    def __rtruediv__(self, o):
        return self._bin("truediv", o, rev=True)

    def __floordiv__(self, o):
        return self._bin("floordiv", o)

    def __float__(self):  # pragma: no cover - defensive
        raise NotSymbolic("symbolic numeric cannot be coerced to float")

    def __int__(self):  # pragma: no cover - defensive
        raise NotSymbolic("symbolic numeric cannot be coerced to int")


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@dataclass
class HostMapPlan:
    """Result of symbolically tracing a host (string-input) map function.

    ``outputs`` holds one expression per produced tuple field (arity 1 for a
    scalar-producing map). ``fallback_fn`` is set when symbolic interpretation
    failed and the function must run per record.
    """

    outputs: List[PExpr]
    kinds: List[str]
    fallback_fn: Optional[Any] = None


def trace_host_map(fn) -> HostMapPlan:
    call = as_callable(fn, "map")
    try:
        result = call(SymStr(PExpr.raw()))
    except NotSymbolic:
        return HostMapPlan([], [], fallback_fn=call)
    except Exception:
        return HostMapPlan([], [], fallback_fn=call)
    exprs: List[PExpr] = []
    if isinstance(result, TupleBase):
        vals = list(result)
    elif isinstance(result, tuple):
        vals = list(result)
    else:
        vals = [result]
    for v in vals:
        if isinstance(v, SymStr):
            exprs.append(v._expr)
        elif isinstance(v, SymNum):
            exprs.append(v._expr)
        elif isinstance(v, (int, float)):
            exprs.append(PExpr.const(v))
        else:
            return HostMapPlan([], [], fallback_fn=call)
    return HostMapPlan(exprs, [_kind_of(e) for e in exprs])


def trace_timestamp_extractor(extract) -> Optional[PExpr]:
    """Trace ``extract_timestamp(line) -> epoch ms`` symbolically, or None."""
    try:
        result = extract(SymStr(PExpr.raw()))
    except Exception:
        return None
    if isinstance(result, SymNum):
        return result._expr
    return None


# ---------------------------------------------------------------------------
# Vectorized evaluation
# ---------------------------------------------------------------------------

def _collect_fields(e: PExpr, acc: set) -> None:
    if e.op == "field":
        acc.add(e.args)
    elif e.op in ("parse_f64", "parse_i64"):
        _collect_fields(e.args[0], acc)
    elif e.op == "parse_iso":
        _collect_fields(e.args[0], acc)
    elif e.op == "bin":
        _collect_fields(e.args[1], acc)
        _collect_fields(e.args[2], acc)
    elif e.op == "raw":
        acc.add(("\0raw", 0))


def _decompose_bases(e: PExpr, sep_holder: list, bases: dict, table):
    """Rewrite ``e`` into a tree over native base columns.

    Returns a tree of ('base', i) / ('const', v) / ('bin', op, a, b), or
    None when the expression defeats the native parser.
    """
    from . import native as native_mod

    def base_key(field_expr, kind, tz):
        sep, idx = field_expr.args
        if sep_holder and sep_holder[0] != sep:
            return None
        if not sep_holder:
            sep_holder.append(sep)
        key = (idx, kind, tz, id(table) if kind == native_mod.KIND_STR else 0)
        if key not in bases:
            bases[key] = (len(bases), table if kind == native_mod.KIND_STR else None)
        return ("base", bases[key][0])

    if e.op == "field":
        if table is None:
            return None  # a bare string field needs an intern table
        return base_key(e, native_mod.KIND_STR, 0)
    if e.op == "parse_f64" and e.args[0].op == "field":
        return base_key(e.args[0], native_mod.KIND_F64, 0)
    if e.op == "parse_i64" and e.args[0].op == "field":
        return base_key(e.args[0], native_mod.KIND_I64, 0)
    if e.op == "parse_iso" and e.args[0].op == "field":
        return base_key(e.args[0], native_mod.KIND_ISO, e.args[1])
    if e.op == "const":
        return ("const", e.args[0])
    if e.op == "bin":
        op, a, b = e.args
        ra = _decompose_bases(a, sep_holder, bases, None)
        rb = _decompose_bases(b, sep_holder, bases, None)
        if ra is None or rb is None:
            return None
        return ("bin", op, ra, rb)
    return None


class PlanEvaluator:
    """Evaluates a set of parse expressions over a batch of raw lines.

    Splitting/parsing runs in the native C++ parser (``native/``) when
    the plan maps to single-separator base columns (the common case);
    otherwise the only per-record Python work is the split. Everything
    downstream is numpy-vectorized. ``native_calls`` and ``numpy_calls``
    count the batches each path parsed.
    """

    def __init__(self, exprs: Sequence[PExpr], tables: Sequence[Optional[StringTable]]):
        self.exprs = list(exprs)
        self.tables = list(tables)
        needed: set = set()
        for e in self.exprs:
            _collect_fields(e, needed)
        self.fields = sorted(needed)  # list of (sep, idx) and maybe ('\0raw',0)
        self.native_calls = 0
        self.numpy_calls = 0
        self._native = None
        self._native_trees = None
        self._try_native()

    def _try_native(self) -> None:
        from . import native as native_mod

        if not native_mod.available():
            return
        sep_holder: list = []
        bases: dict = {}
        trees = []
        for e, t in zip(self.exprs, self.tables):
            tree = _decompose_bases(e, sep_holder, bases, t)
            if tree is None:
                return
            trees.append(tree)
        if not bases or not sep_holder:
            return
        specs = [None] * len(bases)
        py_tables = [None] * len(bases)
        for (idx, kind, tz, _tid), (slot, table) in bases.items():
            specs[slot] = (idx, kind, tz)
            py_tables[slot] = table
        try:
            self._native = native_mod.NativeParser(sep_holder[0], specs, py_tables)
            self._native_trees = trees
        except Exception:
            self._native = None

    def _eval_tree(self, tree, base_vals, n):
        tag = tree[0]
        if tag == "base":
            return base_vals[tree[1]]
        if tag == "const":
            v = tree[1]
            dt = np.float64 if isinstance(v, float) else np.int64
            return np.full(n, v, dtype=dt)
        _, op, a, b = tree
        va, vb = self._eval_tree(a, base_vals, n), self._eval_tree(b, base_vals, n)
        if op == "add":
            return va + vb
        if op == "sub":
            return va - vb
        if op == "mul":
            return va * vb
        if op == "truediv":
            return np.asarray(va, np.float64) / np.asarray(vb, np.float64)
        return va // vb

    def parse_bytes(self, data: bytes, n_lines: int,
                    spans=NULL_SPANS) -> Optional[List[np.ndarray]]:
        """Native path over a raw newline-separated buffer; None if the
        native parser is unavailable for this plan, or if any line of
        the batch is malformed (the native parser zero-fills a bad field
        rather than raise, so such a batch takes the strict numpy path,
        which raises). ``spans``: the job's span recorder."""
        if self._native is None:
            return None
        base_vals, bad = self._native.parse(data, n_lines, spans=spans)
        if bad or len(base_vals[0]) != n_lines:
            return None
        self.native_calls += 1
        return [
            np.asarray(self._eval_tree(t, base_vals, n_lines))
            for t in self._native_trees
        ]

    def _extract(self, lines: Sequence[str]) -> dict:
        cols: dict = {f: [None] * len(lines) for f in self.fields}
        by_sep: dict = {}
        raw_needed = ("\0raw", 0) in cols
        for sep, idx in self.fields:
            if sep != "\0raw":
                by_sep.setdefault(sep, []).append(idx)
        for j, line in enumerate(lines):
            if raw_needed:
                cols[("\0raw", 0)][j] = line
            for sep, idxs in by_sep.items():
                parts = line.split(sep)
                for i in idxs:
                    cols[(sep, i)][j] = parts[i]
        return cols

    def _eval(self, e: PExpr, fields: dict, n: int):
        if e.op == "raw":
            return fields[("\0raw", 0)]
        if e.op == "field":
            return fields[e.args]
        if e.op == "const":
            v = e.args[0]
            dt = np.float64 if isinstance(v, float) else np.int64
            return np.full(n, v, dtype=dt)
        if e.op == "parse_f64":
            return np.asarray(self._eval(e.args[0], fields, n), dtype=np.float64)
        if e.op == "parse_i64":
            return np.asarray(self._eval(e.args[0], fields, n)).astype(np.int64)
        if e.op == "parse_iso":
            inner, tz = e.args
            return iso_local_to_epoch_sec_np(self._eval(inner, fields, n), tz)
        if e.op == "bin":
            op, a, b = e.args
            va, vb = self._eval(a, fields, n), self._eval(b, fields, n)
            if op == "add":
                return va + vb
            if op == "sub":
                return va - vb
            if op == "mul":
                return va * vb
            if op == "truediv":
                return np.asarray(va, np.float64) / np.asarray(vb, np.float64)
            if op == "floordiv":
                return va // vb
        raise NotSymbolic(f"cannot evaluate {e.op}")

    def __call__(self, lines: Sequence[str], spans=NULL_SPANS) -> List[np.ndarray]:
        n = len(lines)
        if self._native is not None and n:
            out = self.parse_bytes("\n".join(lines).encode("utf-8"), n, spans)
            if out is not None:
                return out
        self.numpy_calls += 1
        fields = self._extract(lines)
        out = []
        for e, table in zip(self.exprs, self.tables):
            v = self._eval(e, fields, n)
            if table is not None:  # STR output -> intern
                v = table.intern_many(v)
            out.append(np.asarray(v))
        return out


# ---------------------------------------------------------------------------
# Per-record fallback
# ---------------------------------------------------------------------------

def run_fallback_map(fn, lines: Sequence[str], tables: List[Optional[StringTable]]):
    """Run an arbitrary Python map per record, return columns + kinds.

    ``tables`` is extended in place the first time to match the output arity.
    """
    rows = [fn(line) for line in lines]
    if not rows:
        return [], []
    first = rows[0]
    vals0 = list(first) if isinstance(first, (TupleBase, tuple)) else [first]
    kinds = []
    for v in vals0:
        if isinstance(v, str):
            kinds.append(STR)
        elif isinstance(v, bool):
            kinds.append(BOOL)
        elif isinstance(v, float):
            kinds.append(F64)
        else:
            kinds.append(I64)
    cols: List[list] = [[] for _ in kinds]
    for r in rows:
        vals = list(r) if isinstance(r, (TupleBase, tuple)) else [r]
        for c, v in zip(cols, vals):
            c.append(v)
    while len(tables) < len(kinds):
        tables.append(None)
    out = []
    for i, (k, c) in enumerate(zip(kinds, cols)):
        if k == STR:
            if tables[i] is None:
                tables[i] = StringTable()
            out.append(tables[i].intern_many(c))
        else:
            out.append(np.asarray(c, dtype={F64: np.float64, I64: np.int64, BOOL: np.bool_}[k]))
    return out, kinds
