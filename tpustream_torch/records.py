"""Columnar record batches and string interning.

The TPU runtime never sees one record at a time: the host assembles
structure-of-arrays batches (SURVEY.md §7 design stance) — int64 event
timestamps, int32 interned string ids, float64/int64 values, and a validity
mask — and the jitted step consumes fixed-shape device arrays. Strings are
interned to dense ids so keyed state can live in dense HBM arrays and
``keyBy`` reduces to integer routing (the reference's hash-partitioned
exchange, chapter2/.../ComputeCpuMax.java:26, becomes ``id % shards``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

F64 = "f64"
I64 = "i64"
STR = "str"
BOOL = "bool"

NUMPY_DTYPES = {F64: np.float64, I64: np.int64, STR: np.int32, BOOL: np.bool_}


def _gather(values: list, ids) -> list:
    """``values[i]`` for each id of a column, indexed by Python ints."""
    if isinstance(ids, np.ndarray):
        ids = ids.tolist()
    return list(map(values.__getitem__, ids))


class StringTable:
    """Bidirectional string <-> dense int32 id map.

    Ids are assigned densely in first-seen order, so they double as keyed
    state slot indices. ``NONE_ID`` (-1) marks padding rows.
    """

    NONE_ID = -1

    def __init__(self) -> None:
        self._to_id: Dict[str, int] = {}
        self._to_str: List[str] = []

    def __len__(self) -> int:
        return len(self._to_str)

    def intern(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is None:
            i = len(self._to_str)
            self._to_id[s] = i
            self._to_str.append(s)
        return i

    def intern_many(self, strings) -> np.ndarray:
        out = np.empty(len(strings), dtype=np.int32)
        intern = self.intern
        for j, s in enumerate(strings):
            out[j] = intern(s)
        return out

    def lookup(self, i: int) -> str:
        return self._to_str[i]

    def lookup_many(self, ids) -> List[str]:
        """``lookup`` of each id in a column (an array or a list of
        non-negative ids), in one pass over Python ints."""
        return _gather(self._to_str, ids)

    def state_dict(self) -> dict:
        return {"strings": list(self._to_str)}

    def load_state_dict(self, state: dict) -> None:
        self._to_str = list(state["strings"])
        self._to_id = {s: i for i, s in enumerate(self._to_str)}


class DerivedKeyTable(StringTable):
    """Intern table for COMPUTED KeySelector results (a selector that
    derives a key rather than projecting a field). Values intern under
    a type-tagged canonical string (so ``True``/``1``/``"1"`` stay
    distinct keys, as under Java hashCode/equals), while ``lookup``
    returns the ORIGINAL value — user window/process functions receive
    the true derived key, never a stringified form. JSON-serializable
    for checkpoints (derived keys must be str/int/float/bool, the
    sensible hashable surface)."""

    # id 0 is a reserved placeholder, interned at construction: filter-
    # dropped rows in derive_key_column carry it, so a host/device
    # filter disagreement (float semantics, stateful predicate) routes
    # a record to this dead slot instead of aliasing the first REAL
    # derived key's state. The slot counts against key_capacity (ids
    # index state rows directly), so a computed-key job holds
    # key_capacity - 1 real keys before the automatic growth rebuild.
    PLACEHOLDER_ID = 0

    def __init__(self) -> None:
        super().__init__()
        self._originals: List = [None]
        # serializes the two-list append in intern_value against
        # state_dict's snapshot: the parse-ahead thread interns while a
        # checkpoint captures. The capture-then-truncate ordering below
        # already yields a consistent prefix on its own; the lock closes
        # the residual window where an intern lands BETWEEN the two list
        # appends, so a snapshot is now exact, not just prefix-safe.
        # Cost: one uncontended lock per DERIVED-key intern (already a
        # per-record host path doing dict+format work) — invisible next
        # to the canonical-string formatting.
        self._mutex = threading.Lock()
        pid = self.intern("\x00reserved:placeholder")
        assert pid == self.PLACEHOLDER_ID

    def intern_value(self, v) -> int:
        if isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        if not isinstance(v, (str, int, float, bool)):
            raise TypeError(
                f"a computed KeySelector must return str/int/float/bool, "
                f"got {type(v).__name__}: {v!r}"
            )
        with self._mutex:
            i = self.intern(f"{type(v).__name__}:{v!r}")
            # self-heal: a canonical string present without its original
            # (a torn legacy snapshot restored, see load_state_dict)
            # re-pairs here on first replay of the value
            if i == len(self._originals):
                self._originals.append(v)
        return i

    def intern_values(self, values) -> np.ndarray:
        out = np.empty(len(values), dtype=np.int32)
        for j, v in enumerate(values):
            out[j] = self.intern_value(v)
        return out

    def lookup(self, i: int):
        return self._originals[i]

    def lookup_many(self, ids) -> List:
        """The original values, as ``lookup`` gives them, never the
        canonical strings the ids were interned under."""
        return _gather(self._originals, ids)

    def state_dict(self) -> dict:
        # capture-then-truncate UNDER the intern mutex: the parse-ahead
        # thread may be interning while a checkpoint snapshots this
        # table. intern_value appends to _to_str (via intern) BEFORE
        # _originals, so even without the lock copying _originals FIRST
        # and truncating the _to_str copy to its length yields a
        # consistent prefix; the lock (shared with intern_value) makes
        # the snapshot exact — both lists at one logical length, never
        # a string whose original is still in flight.
        with self._mutex:
            originals = list(self._originals)
            strings = list(self._to_str)[: len(originals)]
        return {"strings": strings, "originals": originals}

    def load_state_dict(self, state: dict) -> None:
        # accepts torn legacy snapshots (strings longer than originals,
        # written by a pre-lock build mid-intern): the surplus strings
        # keep their ids and re-pair with their originals through the
        # intern_value self-heal on first replay
        with self._mutex:
            super().load_state_dict(state)
            self._originals = list(state.get("originals", []))


@dataclass
class Column:
    """One field column: numpy data plus logical kind."""

    kind: str                       # F64 | I64 | STR | BOOL
    data: np.ndarray
    table: Optional[StringTable] = None   # for STR columns

    def __post_init__(self) -> None:
        want = NUMPY_DTYPES[self.kind]
        if self.data.dtype != want:
            self.data = self.data.astype(want)


@dataclass
class Batch:
    """A host-side micro-batch: aligned columns + event-time + validity."""

    n: int
    columns: List[Column]
    ts: Optional[np.ndarray] = None       # int64 epoch ms (event time)
    proc_ts: Optional[np.ndarray] = None  # int64 epoch ms (processing time)
    valid: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        if self.valid is None:
            self.valid = np.ones(self.n, dtype=np.bool_)

    @property
    def arity(self) -> int:
        return len(self.columns)

    def pad_to(self, size: int) -> "Batch":
        """Pad all columns with invalid rows up to ``size`` (static shapes)."""
        if self.n == size:
            return self
        if self.n > size:
            raise ValueError(f"batch of {self.n} exceeds target size {size}")
        pad = size - self.n

        def _pad(a: np.ndarray, fill) -> np.ndarray:
            return np.concatenate([a, np.full(pad, fill, dtype=a.dtype)])

        cols = [
            Column(c.kind, _pad(c.data, StringTable.NONE_ID if c.kind == STR else 0), c.table)
            for c in self.columns
        ]
        ts = _pad(self.ts, 0) if self.ts is not None else None
        proc = _pad(self.proc_ts, 0) if self.proc_ts is not None else None
        valid = np.concatenate([self.valid, np.zeros(pad, dtype=np.bool_)])
        return Batch(size, cols, ts, proc, valid)

    def slice_rows(self, start: int, stop: int) -> "Batch":
        """The contiguous row range [start, stop) as its own Batch. The
        executor splits a data batch here when a broadcast rule update
        is positioned inside it, so update semantics are record-exact
        and batch-size independent (docs/dynamic_rules.md)."""
        cols = [
            Column(c.kind, c.data[start:stop], c.table)
            for c in self.columns
        ]
        ts = self.ts[start:stop] if self.ts is not None else None
        proc = self.proc_ts[start:stop] if self.proc_ts is not None else None
        return Batch(
            stop - start, cols, ts, proc, self.valid[start:stop]
        )

    def row(self, i: int):
        """Materialize row ``i`` as Python values (for slow/host paths)."""
        out = []
        for c in self.columns:
            v = c.data[i]
            if c.kind == STR:
                out.append(c.table.lookup(int(v)) if int(v) >= 0 else None)
            elif c.kind == F64:
                out.append(float(v))
            elif c.kind == BOOL:
                out.append(bool(v))
            else:
                out.append(int(v))
        return out
