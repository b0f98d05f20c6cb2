"""Hierarchical metrics registry: Counter/Gauge/Histogram instruments
scoped by label hierarchy (``job`` -> ``operator`` -> ``shard``).

Counterpart of tpustream/obs/registry.py (the port's own copy).

Mirrors Flink's ``MetricGroup`` tree flattened into Prometheus-style
label sets: every instrument is one *series* identified by
``(name, sorted labels)``, and a :class:`MetricGroup` is just a label
context that mints instruments against the shared registry. Series are
created once (idempotent lookup) and updated lock-free from the single
executor thread; the only cross-thread readers are snapshot/exposition,
which tolerate a torn read of one sample (values are monotone counters
or last-write-wins gauges).

Instruments update per batch/step — the registry is never consulted on
a per-record path. The ``NULL_*`` singletons are the disabled twins:
same method surface, no state, no work.

Every registry-minted instrument also carries a bounded
:class:`~tpustream_torch.obs.timeseries.TimeSeries` history (``inst.history``)
recorded on writes, so windowed ``rate()``/``delta()``/``mean()``/
``quantile()`` are available in-process — the profiler and the adaptive
controller read these. Each series remembers its last-write timestamp
(``_last_t``, registry clock), which the snapshot (``ts_ms``) and
Prometheus exposition (trailing millisecond timestamp) surface so a
scrape-side consumer can compute rates too. Pulled (``set_fn``) gauges
record history and refresh their timestamp only on explicit ``set()``
writes — a render must never mutate timestamps, or two back-to-back
scrapes of an idle job would disagree.
"""

from __future__ import annotations

import math
import random
import time
from typing import Callable, Dict, List, Optional, Tuple

from .timeseries import TimeSeries

PROM_PREFIX = "tpustream_"

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _touch(inst, v) -> None:
    """Stamp a write on a registry-minted instrument: refresh its
    last-write time and append to its bounded history ring."""
    reg = inst._registry
    if reg is None:
        return
    t = reg.now()
    inst._last_t = t
    h = inst.history
    if h is not None:
        try:
            h.record(t, float(v))
        except (TypeError, ValueError):
            pass  # non-numeric gauge payloads keep last-write only


class Counter:
    """Monotone (from the instrument's view) int counter.

    ``set_total`` exists for the ``Metrics`` facade, whose legacy
    attribute assignment (``metrics.records_in += n`` and checkpoint
    baseline folding via ``setattr``) writes absolute totals.
    """

    kind = "counter"
    __slots__ = ("name", "labels", "_value", "_registry", "history",
                 "_last_t")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._value = 0
        self._registry: Optional["MetricsRegistry"] = None
        self.history: Optional[TimeSeries] = None
        self._last_t: Optional[float] = None

    def inc(self, n: int = 1) -> None:
        self._value += n
        _touch(self, self._value)

    def set_total(self, v: int) -> None:
        self._value = int(v)
        _touch(self, self._value)

    @property
    def value(self) -> int:
        return self._value

    def snapshot_value(self):
        return self._value


class TwinCounter:
    """Fan-out facade incrementing two registered counters in lockstep.

    Exists for spelling migrations: the same logical count lands under
    both a legacy flat name (``operator_sink0_emitted``) and its new
    labeled family (``operator_sink_emitted{sink="0"}``) without the
    instrumented code knowing there are two series. Only the write path
    is forwarded — reads go to the registry, where both twins live as
    ordinary counters.
    """

    __slots__ = ("a", "b")

    def __init__(self, a: "Counter", b: "Counter"):
        self.a = a
        self.b = b

    def inc(self, n: int = 1) -> None:
        self.a.inc(n)
        self.b.inc(n)

    @property
    def value(self) -> int:
        return self.a.value


class Gauge:
    """Last-write-wins scalar; ``set_fn`` installs a pull callback
    evaluated at snapshot time (queue depths, live state reads) so the
    hot path never pays for it.

    A raising callback must never abort a snapshot or a live scrape: the
    error is counted in a ``gauge_callback_errors`` series (labelled with
    the failing gauge's name), logged ONCE to the registry's flight
    recorder, and the gauge reads NaN until the callback recovers — a
    visible hole in the series instead of a silently frozen stale value.
    """

    kind = "gauge"
    __slots__ = ("name", "labels", "_value", "_fn", "_registry", "_errored",
                 "history", "_last_t")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._value: float = 0.0
        self._fn: Optional[Callable[[], Optional[float]]] = None
        self._registry: Optional["MetricsRegistry"] = None
        self._errored = False
        self.history: Optional[TimeSeries] = None
        self._last_t: Optional[float] = None

    def set(self, v) -> None:
        self._value = v
        _touch(self, v)

    def set_fn(self, fn: Callable[[], Optional[float]]) -> None:
        self._fn = fn

    @property
    def value(self):
        if self._fn is not None:
            try:
                v = self._fn()
            except Exception as e:
                self._on_callback_error(e)
                return float("nan")
            if v is not None:
                self._value = v
        return self._value

    def _on_callback_error(self, exc: BaseException) -> None:
        reg = self._registry
        if reg is not None:
            labels = dict(self.labels)
            labels["gauge"] = self.name
            reg._series(Counter, "gauge_callback_errors", labels).inc()
            flight = getattr(reg, "flight", None)
            if flight is not None and not self._errored:
                flight.record(
                    "gauge_callback_error",
                    gauge=self.name,
                    labels=dict(self.labels),
                    error=repr(exc),
                )
        self._errored = True

    def snapshot_value(self):
        return self.value


class Histogram:
    """Sample-holding histogram with exact running count/sum.

    ``max_samples = 0`` keeps observations without a recency bound, but
    raw retention is capped by ``reservoir``: past that many samples the
    ring becomes a uniform random subsample of the full stream (Vitter's
    Algorithm R, deterministic per series name) — percentiles stay
    representative of the whole run while memory stays bounded over a
    long-running job. ``reservoir = 0`` restores truly unbounded
    retention. ``max_samples > 0`` keeps the most recent ``max_samples``
    observations in a recency ring instead (per-operator series that
    should reflect *current* behavior). ``count``/``sum`` are exact in
    every mode.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "max_samples", "reservoir", "_ring",
                 "_pos", "count", "sum", "_rng", "_registry", "history",
                 "_last_t")

    def __init__(self, name: str, labels: Dict[str, str],
                 max_samples: int = 0, reservoir: int = 4096):
        self.name = name
        self.labels = dict(labels)
        self.max_samples = int(max_samples)
        self.reservoir = max(0, int(reservoir))
        self._ring: List[float] = []
        self._pos = 0  # next overwrite slot when the ring is full
        self.count = 0
        self.sum = 0.0
        self._rng: Optional[random.Random] = None
        self._registry: Optional["MetricsRegistry"] = None
        self.history: Optional[TimeSeries] = None
        self._last_t: Optional[float] = None

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self._retain(v)
        _touch(self, v)

    def _retain(self, v: float) -> None:
        if self.max_samples:
            if len(self._ring) >= self.max_samples:
                self._ring[self._pos] = v
                self._pos = (self._pos + 1) % self.max_samples
            else:
                self._ring.append(v)
        elif self.reservoir and len(self._ring) >= self.reservoir:
            if self._rng is None:
                # seeded by series name: a replayed run keeps the same
                # retained subsample, so goldens stay stable
                self._rng = random.Random(self.name)
            j = self._rng.randrange(self.count)
            if j < self.reservoir:
                self._ring[j] = v
        else:
            self._ring.append(v)

    def observe_many(self, vs) -> None:
        for v in vs:
            self.observe(v)

    @property
    def samples(self) -> List[float]:
        return list(self._ring)

    def percentile(self, q: float) -> float:
        """``q`` in [0, 100]; linear interpolation between closest ranks
        (numpy's default ``np.percentile`` method) over the retained
        samples."""
        vals = sorted(self._ring)
        if not vals:
            return 0.0
        rank = (len(vals) - 1) * (q / 100.0)
        lo = math.floor(rank)
        hi = math.ceil(rank)
        if lo == hi:
            return vals[lo]
        frac = rank - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def snapshot_value(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }

    def merge_from(self, other: "Histogram") -> None:
        """Fold ``other``'s observations into this series: count/sum
        stay exact; samples are retained up to this ring's bound (the
        same loss contract a single-shard ring already has)."""
        self.count += other.count
        self.sum += other.sum
        for v in other.samples:
            self._retain(v)


class _NullInstrument:
    """Disabled twin of every instrument: full method surface, no work.

    One shared instance backs every hook when ``ObsConfig.enabled`` is
    False, so the per-step cost of disabled observability is a no-op
    method call."""

    kind = "null"
    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def set_fn(self, fn) -> None:
        pass

    def set_total(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def observe_many(self, vs) -> None:
        pass

    value = 0
    count = 0
    sum = 0.0
    history = None
    _last_t = None

    @property
    def samples(self) -> list:
        return []

    def percentile(self, q: float) -> float:
        return 0.0

    def rate(self, window_s=None, now=None) -> float:
        return 0.0

    def quantile(self, q, window_s=None, now=None) -> float:
        return 0.0


NULL_COUNTER = _NullInstrument()
NULL_GAUGE = NULL_COUNTER
NULL_HISTOGRAM = NULL_COUNTER


class MetricGroup:
    """A label scope: ``registry.group(job=...)``,
    ``group.group(operator=...)`` etc. Instrument calls mint (or fetch)
    the series named by this scope's merged labels."""

    def __init__(self, registry: "MetricsRegistry", labels: Dict[str, str]):
        self.registry = registry
        self.labels = dict(labels)

    def group(self, **labels) -> "MetricGroup":
        merged = dict(self.labels)
        merged.update({k: str(v) for k, v in labels.items()})
        return MetricGroup(self.registry, merged)

    def counter(self, name: str) -> Counter:
        return self.registry._series(Counter, name, self.labels)

    def gauge(self, name: str) -> Gauge:
        return self.registry._series(Gauge, name, self.labels)

    def histogram(self, name: str, max_samples: int = 0,
                  reservoir: Optional[int] = None) -> Histogram:
        kw = {"max_samples": max_samples}
        if reservoir is not None:
            kw["reservoir"] = reservoir
        return self.registry._series(Histogram, name, self.labels, **kw)


class MetricsRegistry:
    """Flat series store behind the MetricGroup hierarchy."""

    def __init__(self):
        self._by_key: Dict[Tuple[str, LabelKey], object] = {}
        # optional FlightRecorder (installed by JobObs) so instrument
        # error paths can leave a breadcrumb without an import cycle
        self.flight = None
        # clock + epoch pair: ``now()`` is the write-timestamp source
        # (monotonic; injectable in tests), the epoch pair maps its
        # readings onto wall-clock ms for exposition
        self.now: Callable[[], float] = time.perf_counter
        self._epoch_perf = time.perf_counter()
        self._epoch_wall = time.time()
        # per-instrument history knobs, applied at mint time (JobObs
        # overwrites these from ObsConfig before any series exists)
        self.history_capacity = 512
        self.history_digest = 64
        self.default_reservoir = 4096
        self.rate_window_s = 60.0  # window for snapshot()'s rate_per_s

    def wall_ms(self, t: Optional[float]) -> Optional[int]:
        """Map a registry-clock reading to integer wall-clock ms."""
        if t is None:
            return None
        return int(round((self._epoch_wall + (t - self._epoch_perf)) * 1000.0))

    def group(self, **labels) -> MetricGroup:
        return MetricGroup(self, {k: str(v) for k, v in labels.items()})

    def find(self, name: str, labels: Optional[Dict[str, str]] = None):
        """The instrument for exactly ``(name, labels)``, or None."""
        return self._by_key.get((name, _label_key(labels or {})))

    def _series(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels))
        inst = self._by_key.get(key)
        if inst is None:
            if cls is Histogram and "reservoir" not in kw:
                kw["reservoir"] = self.default_reservoir
            inst = cls(name, labels, **kw)
            inst._registry = self
            inst._last_t = self.now()
            if self.history_capacity > 0:
                inst.history = TimeSeries(
                    self.history_capacity,
                    kind="cumulative" if cls is Counter else "sample",
                    digest=self.history_digest,
                )
                if cls is Counter:
                    # anchor the step function at zero so the very first
                    # inc() already yields a two-point windowed rate
                    inst.history.record(inst._last_t, 0.0)
            self._by_key[key] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric series {name!r} {labels!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}"
            )
        return inst

    def series(self) -> List[object]:
        # list() first: the serve thread renders while the executor (or a
        # gauge error path) mints series; CPython's list(dict) is atomic,
        # a plain iteration over the dict is not
        return [self._by_key[k] for k in sorted(list(self._by_key))]

    def retire(self, name: Optional[str] = None,
               labels: Optional[Dict[str, str]] = None) -> int:
        """Drop every series matching ``name`` (None = any name) whose
        labels are a SUPERSET of ``labels`` — the lifecycle counterpart
        of idempotent minting. A fleet retires a removed tenant's
        per-tenant series (``retire(labels={"tenant": "acme"})``) so
        snapshots and scrapes stop carrying gauges for jobs that no
        longer exist; re-minting the same (name, labels) later starts a
        fresh instrument. Returns the number of series dropped."""
        want = _label_key(labels or {})
        doomed = [
            key for key, inst in list(self._by_key.items())
            if (name is None or key[0] == name)
            and all(item in key[1] for item in want)
        ]
        for key in doomed:
            del self._by_key[key]
        return len(doomed)

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry's series into this one, loss-free for
        totals: counters sum, gauges take the other's last write (or its
        pull value), histograms fold count/sum exactly and retain
        samples up to the ring bound. Series that only exist in
        ``other`` are minted here with the same name/labels/kind — the
        multi-shard aggregation path: per-shard registries (distinct
        ``shard`` labels, so nothing collides) merge into one scrape
        view, and health rules evaluate over the merged series. Series
        histories merge too (kind-aware, see TimeSeries.merge_from), and
        the merged timestamp is the newest of the two — totals fold with
        direct writes, not inc()/set(), so merging never fabricates
        present-time history samples."""
        for inst in other.series():
            if inst.kind == "counter":
                mine = self._series(Counter, inst.name, inst.labels)
                mine._value += inst.value
            elif inst.kind == "gauge":
                mine = self._series(Gauge, inst.name, inst.labels)
                mine._value = inst.value
            elif inst.kind == "histogram":
                mine = self._series(
                    Histogram, inst.name, inst.labels,
                    max_samples=inst.max_samples,
                    reservoir=getattr(inst, "reservoir", 4096),
                )
                mine.merge_from(inst)
            else:
                continue
            oh = getattr(inst, "history", None)
            if oh is not None and mine.history is not None:
                mine.history.merge_from(oh)
            ot = getattr(inst, "_last_t", None)
            if ot is not None and (mine._last_t is None or ot > mine._last_t):
                mine._last_t = ot
        return self

    # -- exposition --------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-serializable point-in-time view of every series.

        Each entry carries ``ts_ms`` (wall-clock ms of the last write —
        the explicit sample timestamp a JSON consumer needs to compute
        scrape-side rates) and, for counters with history, ``rate_per_s``
        over the registry's ``rate_window_s``."""
        out = []
        for inst in self.series():
            entry = {
                "name": inst.name,
                "type": inst.kind,
                "labels": dict(inst.labels),
                "value": inst.snapshot_value(),
            }
            ts = self.wall_ms(getattr(inst, "_last_t", None))
            if ts is not None:
                entry["ts_ms"] = ts
            h = getattr(inst, "history", None)
            if inst.kind == "counter" and h is not None:
                entry["rate_per_s"] = round(h.rate(self.rate_window_s), 9)
            out.append(entry)
        return {"series": out}

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition (0.0.4). Counters/gauges render
        directly; histograms render as summaries (quantile series plus
        ``_sum``/``_count``), the convention Flink's Prometheus reporter
        uses for its latency histograms. Every sample line carries the
        series' explicit last-write timestamp in ms (the text-format
        optional trailing field), so a scraper computes correct rates
        even when the scrape interval and the job's write cadence
        disagree; all of one histogram's lines share its timestamp."""
        by_name: Dict[str, List[object]] = {}
        for inst in self.series():
            by_name.setdefault(inst.name, []).append(inst)
        lines: List[str] = []
        for name in sorted(by_name):
            insts = by_name[name]
            kind = insts[0].kind
            prom = PROM_PREFIX + name
            if kind == "histogram":
                lines.append(f"# TYPE {prom} summary")
                for h in insts:
                    sfx = _prom_ts(self.wall_ms(getattr(h, "_last_t", None)))
                    for q, qv in (("0.5", 50), ("0.9", 90), ("0.99", 99)):
                        lbl = _prom_labels(h.labels, quantile=q)
                        lines.append(
                            f"{prom}{lbl} {_prom_num(h.percentile(qv))}{sfx}"
                        )
                    lbl = _prom_labels(h.labels)
                    lines.append(f"{prom}_sum{lbl} {_prom_num(h.sum)}{sfx}")
                    lines.append(f"{prom}_count{lbl} {h.count}{sfx}")
            else:
                lines.append(f"# TYPE {prom} {kind}")
                for inst in insts:
                    lbl = _prom_labels(inst.labels)
                    sfx = _prom_ts(self.wall_ms(getattr(inst, "_last_t", None)))
                    lines.append(
                        f"{prom}{lbl} {_prom_num(inst.snapshot_value())}{sfx}"
                    )
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_ts(ts_ms: Optional[int]) -> str:
    return f" {ts_ms}" if ts_ms is not None else ""


def _prom_num(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels: Dict[str, str], **extra) -> str:
    merged = dict(labels)
    merged.update(extra)
    if not merged:
        return ""
    body = ",".join(
        f'{k}="{_prom_escape(str(merged[k]))}"' for k in sorted(merged)
    )
    return "{" + body + "}"
