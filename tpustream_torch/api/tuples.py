"""Positional tuples with Flink-style ``f0/f1/f2`` field access.

The reference jobs manipulate ``Tuple2``/``Tuple3`` values positionally
(e.g. ``value.f2 > 90`` at reference chapter1/.../Main.java:27-33); these
classes reproduce that surface. They are plain field containers: during
device tracing the fields hold jax scalars, on the host they hold Python
values, and the ``print()`` sink formats them Java-style as ``(a,b,c)``.
"""

from __future__ import annotations

from typing import Any, Iterator


class TupleBase:
    """Common behavior for fixed-arity positional tuples."""

    ARITY: int = 0
    _FIELDS: tuple = ()

    # --- positional access -------------------------------------------------
    def __getitem__(self, i: int) -> Any:
        return getattr(self, self._FIELDS[i])

    def __setitem__(self, i: int, v: Any) -> None:
        setattr(self, self._FIELDS[i], v)

    def __iter__(self) -> Iterator[Any]:
        return (getattr(self, f) for f in self._FIELDS)

    def __len__(self) -> int:
        return self.ARITY

    def values(self) -> tuple:
        return tuple(self)

    # --- comparison / display ---------------------------------------------
    def __eq__(self, other: Any) -> bool:
        if isinstance(other, TupleBase):
            return self.values() == other.values()
        if isinstance(other, tuple):
            return self.values() == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.values())

    def __repr__(self) -> str:
        inner = ",".join(_java_str(v) for v in self)
        return f"({inner})"


def _wrong_arity(t: TupleBase, values: tuple) -> None:
    raise TypeError(
        f"{type(t).__name__} expects {t.ARITY} values, got {len(values)}"
    )


def _java_str(v: Any) -> str:
    """Format one field the way Java's ``Tuple.toString`` would.

    Java prints ``Double.toString`` (80.5, 86.26666666666667) and longs
    without a decimal point — Python's ``repr`` matches for round-trippable
    doubles, and bools/ints need no massaging.
    """
    import numpy as np

    if isinstance(v, (bool,)):
        return "true" if v else "false"
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    return str(v)


# Each arity assigns its fields directly, with no loop over ``_FIELDS``:
# the emission formatter builds a step's rows with one constructor call
# each.
class Tuple2(TupleBase):
    ARITY = 2
    _FIELDS = ("f0", "f1")

    def __init__(self, *values: Any):
        if len(values) != 2:
            _wrong_arity(self, values)
        self.f0, self.f1 = values


class Tuple3(TupleBase):
    ARITY = 3
    _FIELDS = ("f0", "f1", "f2")

    def __init__(self, *values: Any):
        if len(values) != 3:
            _wrong_arity(self, values)
        self.f0, self.f1, self.f2 = values


class Tuple4(TupleBase):
    ARITY = 4
    _FIELDS = ("f0", "f1", "f2", "f3")

    def __init__(self, *values: Any):
        if len(values) != 4:
            _wrong_arity(self, values)
        self.f0, self.f1, self.f2, self.f3 = values


TUPLE_CLASSES = {2: Tuple2, 3: Tuple3, 4: Tuple4}


def make_tuple(*values: Any) -> TupleBase:
    cls = TUPLE_CLASSES.get(len(values))
    if cls is None:
        raise TypeError(f"unsupported tuple arity {len(values)}")
    return cls(*values)
