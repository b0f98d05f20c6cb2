"""Device-side record chains (PyTorch).

Counterpart of tpustream/runtime/device.py. Post-parse ``map``/``filter``
user functions (the Mbps conversion at reference
chapter3/.../BandwidthMonitorWithEventTime.java:48-53, the ``f2 > 90``
threshold at chapter1/.../Main.java:27-33) run on the device over a
whole batch at once: each field of the record a user function receives
is a ``[B]`` tensor, where the reference vmaps a per-record trace.
Filters never compact (masks only); string-typed fields travel as
interned int32 ids wrapped in ``StrVal`` so equality tests against
literals still work.

Every call into a user record function runs under
:func:`tpustream_torch.arith.reference_arithmetic` (float64 default
dtype, division by a constant as a multiply by its reciprocal), which
holds the arithmetic to the reference's bits.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.functions import as_callable
from ..api.tuples import TupleBase, make_tuple
from ..arith import reference_arithmetic
from ..broadcast.rules import RuleParam
from ..ops.wordplanes import TORCH_DTYPES
from ..records import BOOL, F64, I64, STR, StringTable


class StrVal:
    """A string-valued field on device: interned ids + their table."""

    def __init__(self, ids, table: StringTable):
        self.id = ids
        self.table = table

    def _other_id(self, other):
        if isinstance(other, StrVal):
            return other.id
        if isinstance(other, str):
            return self.table.intern(other)
        return NotImplemented

    def __eq__(self, other):  # type: ignore[override]
        oid = self._other_id(other)
        if oid is NotImplemented:
            return NotImplemented
        return self.id == oid

    def __ne__(self, other):  # type: ignore[override]
        oid = self._other_id(other)
        if oid is NotImplemented:
            return NotImplemented
        return self.id != oid

    def __hash__(self):  # pragma: no cover - tensors of ids are not keys
        raise TypeError("StrVal is not hashable")


def wrap_record(kinds: Sequence[str], tables: Sequence[Optional[StringTable]], values):
    vals = [
        StrVal(v, t) if k == STR else v
        for k, t, v in zip(kinds, tables, values)
    ]
    if len(vals) == 1:
        return vals[0]
    if len(vals) <= 4:
        return make_tuple(*vals)
    return tuple(vals)


def as_tensor(v) -> torch.Tensor:
    """``torch.as_tensor`` that also takes a dynamic rule's
    ``RuleParam`` (its tensor inside a step, its host value outside)."""
    return v._resolve() if isinstance(v, RuleParam) else torch.as_tensor(v)


def unwrap_record(rec) -> Tuple[list, list, list]:
    """Record -> (values, kinds, tables), classified by value type.
    Python constants become 0-d tensors of their kind's dtype."""
    vals = list(rec) if isinstance(rec, (TupleBase, tuple)) else [rec]
    values, kinds, tables = [], [], []
    for v in vals:
        table = None
        if isinstance(v, RuleParam):
            v = v._resolve()
        if isinstance(v, StrVal):
            t, kind, table = v.id, STR, v.table
        elif isinstance(v, (bool, np.bool_)):
            t, kind = torch.tensor(bool(v)), BOOL
        elif isinstance(v, (int, np.integer)):
            t, kind = torch.tensor(int(v), dtype=torch.int64), I64
        elif isinstance(v, (float, np.floating)):
            t, kind = torch.tensor(float(v), dtype=torch.float64), F64
        else:
            t = as_tensor(v)
            if t.dtype == torch.bool:
                kind = BOOL
            elif t.is_floating_point():
                kind = F64
            else:
                kind = I64
        values.append(t)
        kinds.append(kind)
        tables.append(table)
    return values, kinds, tables


def record_combiner(fn: Callable, kinds: Sequence[str],
                    tables: Sequence[Optional[StringTable]]) -> Callable:
    """A user two-record function (``reduce``, an aggregate's ``merge``)
    as a combiner on leaf tuples, run with the reference's arithmetic."""

    def combine(a, b):
        with reference_arithmetic():
            ra = wrap_record(kinds, tables, list(a))
            rb = wrap_record(kinds, tables, list(b))
            out, _, _ = unwrap_record(fn(ra, rb))
        return tuple(out)

    return combine


def dummy_leaf(kind: str) -> torch.Tensor:
    """A 0-d stand-in of a leaf kind for dry runs and graph tracing."""
    if kind == F64:
        return torch.tensor(1.0, dtype=torch.float64)
    if kind == BOOL:
        return torch.tensor(True)
    return torch.tensor(0, dtype=TORCH_DTYPES[kind])


class DeviceChain:
    """A sequence of map/filter ops over record columns.

    ``apply(cols, mask)`` runs the chain over ``[B]`` tensors;
    ``out_kinds``/``out_tables`` describe the emitted record layout
    (resolved at build time by a dry run on 0-d tensors).
    """

    def __init__(
        self,
        ops: List[Tuple[str, Callable]],
        in_kinds: List[str],
        in_tables: List[Optional[StringTable]],
    ):
        self.ops = [
            (op, as_callable(fn, "map" if op == "map" else "filter"))
            for op, fn in ops
        ]
        self.in_kinds = list(in_kinds)
        self.in_tables = list(in_tables)
        self.out_kinds, self.out_tables = self._infer_output()

    def describe(self) -> dict:
        """Static size of this chain, for the build registry's events:
        op count and arities."""
        n_map = sum(1 for op, _ in self.ops if op == "map")
        return {
            "chain_ops": len(self.ops),
            "chain_map_ops": n_map,
            "chain_filter_ops": len(self.ops) - n_map,
            "chain_in_arity": len(self.in_kinds),
            "chain_out_arity": len(self.out_kinds),
        }

    def _record_fn(self, values, keep):
        """The chain on one record whose fields are tensors of any one
        shape: (out values, keep, kinds, tables)."""
        with reference_arithmetic():
            rec = wrap_record(self.in_kinds, self.in_tables, values)
            for op, fn in self.ops:
                if op == "map":
                    rec = fn(rec)
                else:
                    keep = keep & as_tensor(fn(rec))
            out, kinds, tables = unwrap_record(rec)
        return out, keep, kinds, tables

    def _infer_output(self):
        dummy = [dummy_leaf(k) for k in self.in_kinds]
        _, _, kinds, tables = self._record_fn(dummy, torch.tensor(True))
        return kinds, tables

    def apply(self, cols: Sequence[Any], mask):
        """Vectorized over the batch: cols are [B] tensors, mask bool[B].
        Constants a map returns are broadcast to [B]."""
        if not self.ops:
            return list(cols), mask
        out, keep, _, _ = self._record_fn(list(cols), mask)
        shape, dev = mask.shape, mask.device
        out_cols = [
            torch.broadcast_to(
                v.to(device=dev, dtype=TORCH_DTYPES[k]), shape
            ).contiguous()
            for v, k in zip(out, self.out_kinds)
        ]
        return out_cols, torch.broadcast_to(keep.to(dev), shape)


def identity_chain(kinds, tables) -> DeviceChain:
    return DeviceChain([], kinds, tables)
