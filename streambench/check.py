"""The comparison that decides ``correct``: every row the sink received
against the plain reference's rows, in order, and the program's loss
counters against 0. numpy only: nothing of the program is imported."""

from __future__ import annotations

import array
import operator
import struct

import numpy as np

# the port's loss counters (runtime/metrics.py), each held at 0
LOSS_COUNTERS = ("alert_overflow", "buffer_overflow", "evicted_unfired",
                 "exchange_overflow", "late_dropped", "records_quarantined")


def interned_ids(names: np.ndarray) -> np.ndarray:
    """Key ids as a job's string table gives them: 0, 1, 2, ... in order
    of first arrival."""
    _, first, inverse = np.unique(names, return_index=True,
                                  return_inverse=True)
    rank = np.empty(first.size, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(first.size)
    return rank[inverse.reshape(-1)]


def labels(codes: np.ndarray, fmt) -> np.ndarray:
    """``fmt(code)`` for each code as an object array, formatted once a
    distinct code."""
    uniq, inv = np.unique(codes, return_inverse=True)
    table = np.empty(uniq.size, dtype=object)
    table[:] = [fmt(int(c)) for c in uniq]
    return table[inv.reshape(-1)]


class Rows:
    """The job's sink. It keeps, in order, a 64-bit hash of each row's
    field values, and whole the rows whose hash is a multiple of
    ``SAMPLE`` (one in ``SAMPLE``, drawn by the process's hash seed).
    Keeping every row would grow the process by about 100 bytes a row,
    millions of rows a run: the emit then slowed by a fifth and its runs
    spread widely, a cost of the check and not of the program. What it
    keeps holds no object that the garbage collector tracks beyond its
    own few: flat arrays of numbers, and one flat list of the sampled
    rows' fields (strings and floats), so the collector's passes over
    the process do not grow as the window's rows come in."""

    SAMPLE = 64

    def __init__(self):
        self.hashes = array.array("q")
        self.sample_at = array.array("q")  # row index of each sampled row
        self.sample_n = array.array("q")   # its number of fields
        self.sample_vals = []              # their fields, one after another
        self._fields = {}

    def _getter(self, kind):
        names = getattr(kind, "_FIELDS", None)
        if names and len(names) > 1:
            get = operator.attrgetter(*names)
        elif names:
            get = lambda r: (getattr(r, names[0]),)  # noqa: E731
        else:
            get = lambda r: (r,)  # noqa: E731
        self._fields[kind] = get
        return get

    def sink(self):
        """The function the job's ``add_sink`` takes."""
        hashes, fields, getter = self.hashes, self._fields, self._getter
        append, mask = hashes.append, self.SAMPLE - 1
        at, n, vals = (self.sample_at.append, self.sample_n.append,
                       self.sample_vals.extend)

        def emit(row) -> None:
            kind = type(row)
            t = (fields.get(kind) or getter(kind))(row)
            h = hash(t)
            append(h)
            if not h & mask:
                at(len(hashes) - 1)
                n(len(t))
                vals(t)

        return emit

    def sampled(self):
        """``(row index, fields)`` of each sampled row."""
        o = 0
        for i, k in zip(self.sample_at, self.sample_n):
            yield i, self.sample_vals[o:o + k]
            o += k


def _same(a, b) -> bool:
    """Equal values of one type, floats bit for bit."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return struct.pack("<d", a) == struct.pack("<d", b)
    return a == b


def compare_rows(rows: Rows, want: list) -> dict:
    """The sink's rows against the reference's columns (object arrays
    of strings, or float64 arrays). A row is wrong where its hash
    differs from the reference row's, or where it is missing or extra;
    a hash equal where the values are not is a chance of 2^-64 a row.
    The sampled rows are compared whole: each field of the same type,
    floats bit for bit. Returns ``rows_due``, ``rows_wrong``,
    ``rows_failed`` (rows due that are wrong or missing),
    ``sampled_rows_wrong`` and ``first_wrong`` (-1 when none)."""
    n_due = len(want[0])
    cols = [c.tolist() for c in want]
    expect = np.fromiter(map(hash, zip(*cols)), np.int64, count=n_due)
    got = np.frombuffer(rows.hashes, np.int64)
    n_got = got.size
    n = min(n_got, n_due)
    bad = np.flatnonzero(got[:n] != expect[:n])
    first = int(bad[0]) if bad.size else (n if n_got != n_due else -1)
    sampled = sum(i >= n_due or len(t) != len(cols)
                  or not all(_same(v, c[i]) for v, c in zip(t, cols))
                  for i, t in rows.sampled())
    return {"rows_due": n_due,
            "rows_wrong": int(bad.size) + abs(n_got - n_due),
            "rows_failed": int(bad.size) + max(0, n_due - n_got),
            "sampled_rows_wrong": int(sampled),
            "first_wrong": first}
