"""Sinks: Flink-style print with subtask prefixes, collect, callables.

The ``print()`` sink reproduces the reference's observable format
byte-for-byte (``3> (10.8.22.1,cpu0,80.5)``, chapter1/README.md:80-84):
tuples render Java-``Tuple.toString`` style, doubles as
``Double.toString`` round-trips, and the ``n>`` prefix is the 1-based
owning subtask — the key-owner shard for keyed streams, a rotating
assignment for stateless ones. Like Flink, the prefix is omitted when
print parallelism is 1.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..api.tuples import _java_str, make_tuple
from ..records import BOOL, F64, I64, STR


class _NullCounter:
    """Stand-in for a metrics counter: every sink counts its emits
    through ``obs_counter``, which does nothing until a caller installs
    a real counter."""

    def inc(self, n: int = 1) -> None:
        pass


NULL_COUNTER = _NullCounter()


class EmissionFormatter:
    """Turns emission columns (numpy, already masked/compacted) into Python
    row values using the planned field kinds and string tables."""

    def __init__(self, kinds: List[str], tables: List[Optional[object]]):
        self.kinds = kinds
        self.tables = tables

    def rows(self, cols: List[np.ndarray]):
        n = len(cols[0]) if cols else 0
        converted = []
        for kind, col, table in zip(self.kinds, cols, self.tables):
            if kind == STR:
                converted.append(
                    [table.lookup(int(i)) if int(i) >= 0 else None for i in col]
                )
            elif kind == F64:
                converted.append([float(v) for v in col])
            elif kind == BOOL:
                converted.append([bool(v) for v in col])
            else:
                converted.append([int(v) for v in col])
        for j in range(n):
            vals = tuple(c[j] for c in converted)
            if len(vals) == 1:
                yield vals[0]
            elif len(vals) <= 4:
                yield make_tuple(*vals)
            else:
                # wider than Tuple4 (e.g. CEP timeout records): plain tuple
                yield vals


class PrintSink:
    # per-sink emitted-record counter; the executor swaps in a real
    # registry Counter when StreamConfig.obs.enabled (otherwise every
    # emit pays one no-op call)
    obs_counter = NULL_COUNTER

    def __init__(self, parallelism: int = 1, stream=None):
        import sys

        self.parallelism = max(1, parallelism)
        self.stream = stream or sys.stdout
        self._rr = 0
        self.lines: List[str] = []  # retained for tests/inspection

    def emit(self, value, subtask: Optional[int] = None) -> None:
        body = repr(value) if not isinstance(value, str) else value
        if not isinstance(value, (str,)) and not hasattr(value, "_FIELDS"):
            body = _java_str(value)
        if self.parallelism > 1:
            if subtask is None:
                subtask = self._rr
                self._rr = (self._rr + 1) % self.parallelism
            line = f"{(subtask % self.parallelism) + 1}> {body}"
        else:
            line = body
        self.lines.append(line)
        print(line, file=self.stream)
        self.obs_counter.inc()


class CollectSink:
    obs_counter = NULL_COUNTER

    def __init__(self, handle):
        self.handle = handle

    def emit(self, value, subtask: Optional[int] = None) -> None:
        self.handle.append(value)
        self.obs_counter.inc()


class FnSink:
    obs_counter = NULL_COUNTER

    def __init__(self, fn: Callable):
        self.fn = fn

    def emit(self, value, subtask: Optional[int] = None) -> None:
        self.fn(value)
        self.obs_counter.inc()


class RetryingSink:
    """Wraps any sink's ``emit`` with capped exponential backoff
    (StreamConfig.sink_retries / sink_retry_base_ms / sink_retry_max_ms).
    A transient sink failure (a flaky downstream system) retries
    ``attempts`` times, delaying ``min(base * 2^i, max)`` ms between
    tries, before escalating to the supervisor (runtime/supervisor.py).
    ``fault`` is the optional fault-injection hook
    (tpustream_torch/testing/faults.py, point ``sink_emit``), checked per
    ATTEMPT so injected failures exercise the real retry path.

    The executor assigns ``sink.obs_counter`` directly on its sinks, so
    that attribute delegates to the wrapped sink; ``retry_counter``
    counts performed retries.
    """

    retry_counter = NULL_COUNTER

    def __init__(
        self,
        inner,
        attempts: int = 0,
        base_ms: float = 10.0,
        max_ms: float = 1000.0,
        fault: Optional[Callable] = None,
    ):
        self.inner = inner
        self.attempts = max(0, int(attempts))
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)
        self.fault = fault

    @property
    def obs_counter(self):
        return self.inner.obs_counter

    @obs_counter.setter
    def obs_counter(self, counter) -> None:
        self.inner.obs_counter = counter

    def emit(self, value, subtask: Optional[int] = None) -> None:
        import time

        for attempt in range(self.attempts + 1):
            try:
                if self.fault is not None:
                    self.fault("sink_emit")
                self.inner.emit(value, subtask=subtask)
                return
            except Exception:
                if attempt >= self.attempts:
                    raise
                self.retry_counter.inc()
                delay_ms = min(self.base_ms * (2.0 ** attempt), self.max_ms)
                if delay_ms > 0:
                    time.sleep(delay_ms / 1000.0)


class LedgerSink:
    """Conservation-ledger shim (obs/ledger.py): delegates ``emit`` and
    folds each row that actually landed into the sink's ledger account.
    Wraps OUTSIDE RetryingSink, so a row is folded exactly once, after
    every retry resolved; a raising emit folds nothing, which is what
    the emit-edge invariant needs.

    For a sink with retained contents the fold reads the appended tail
    element (PrintSink keeps the prefixed line, not the raw value), so
    the rolling digest can be re-derived from the contents alone."""

    def __init__(self, inner, acct):
        self.inner = inner
        self.acct = acct

    @property
    def obs_counter(self):
        return self.inner.obs_counter

    @obs_counter.setter
    def obs_counter(self, counter) -> None:
        self.inner.obs_counter = counter

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def emit(self, value, subtask: Optional[int] = None) -> None:
        self.inner.emit(value, subtask=subtask)
        if self.acct.contents_fn is not None:
            self.acct.fold_tail()
        else:
            self.acct.fold_value(value)
