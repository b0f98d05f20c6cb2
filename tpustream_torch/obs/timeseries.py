"""Bounded time-series rings behind every registry instrument.

Counterpart of tpustream/obs/timeseries.py (the port's own copy).

Point-in-time counters answer "how many so far"; a monitoring job needs
"how fast over the last minute" and "what was p99 over the last 30 s"
*from inside the running process*. :class:`TimeSeries` is the primitive
that makes those windowed queries possible without unbounded memory:

* a ring of the newest ``capacity`` ``(timestamp, value)`` samples, and
* a t-digest-style tail of weighted centroids that evicted samples
  collapse into, so long-window ``mean()`` stays exact and long-window
  ``quantile()`` stays approximately right after the raw points are gone.

Two kinds, matching the two instrument shapes:

* ``kind="cumulative"`` — monotone running totals (Counters).
  ``rate()``/``delta()`` difference the step function; ``merge_from``
  sums the two step functions over the union of their timestamps (with
  flat-backward extrapolation before a series' first retained point), so
  the merged ring's ``rate()`` equals the sum of the per-shard rates.
* ``kind="sample"`` — independent observations (Gauge values, Histogram
  observations). ``quantile()``/``mean()`` weight ring points at 1 and
  centroids at their fold weight; ``merge_from`` interleaves by time.

Timestamps are caller-supplied monotonic seconds (the registry passes
its own clock, ``time.perf_counter`` by default). Windowed queries are
anchored at ``now`` — by default the newest retained sample's timestamp,
which keeps replayed/merged series and unit tests deterministic; live
callers pass their own ``now``. Everything here is pure stdlib.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

KINDS = ("sample", "cumulative")


class TimeSeries:
    """Bounded history of one instrument: ring + centroid digest."""

    __slots__ = ("capacity", "kind", "digest_size", "total_samples",
                 "_pts", "_centroids")

    def __init__(self, capacity: int = 512, kind: str = "sample",
                 digest: int = 64):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        self.capacity = max(1, int(capacity))
        self.kind = kind
        self.digest_size = max(0, int(digest))
        self.total_samples = 0
        self._pts: List[Tuple[float, float]] = []  # (t, v), time-ordered
        # (t_mean, v_mean, weight), kept sorted by v_mean; only the
        # "sample" kind folds evictions here — a cumulative series'
        # evicted prefix is summarized by flat-backward extrapolation
        self._centroids: List[Tuple[float, float, float]] = []

    # -- recording -----------------------------------------------------------

    def record(self, t: float, v: float) -> None:
        self.total_samples += 1
        pts = self._pts
        if pts and t < pts[-1][0]:
            t = pts[-1][0]  # clamp clock regressions; ring stays ordered
        pts.append((t, float(v)))
        if len(pts) > self.capacity:
            old_t, old_v = pts.pop(0)
            if self.kind == "sample":
                self._fold(old_t, old_v, 1.0)

    def _fold(self, t: float, v: float, w: float) -> None:
        """Absorb an evicted sample into the centroid digest."""
        if self.digest_size <= 0:
            return
        cents = self._centroids
        lo, hi = 0, len(cents)
        while lo < hi:
            mid = (lo + hi) // 2
            if cents[mid][1] < v:
                lo = mid + 1
            else:
                hi = mid
        cents.insert(lo, (t, v, w))
        if len(cents) > self.digest_size:
            self._compress()

    def _compress(self) -> None:
        """Merge the adjacent (by value) centroid pair with the smallest
        combined weight — the lightest information loss per merge."""
        cents = self._centroids
        while len(cents) > self.digest_size:
            best_i, best_w = 0, float("inf")
            for i in range(len(cents) - 1):
                w = cents[i][2] + cents[i + 1][2]
                if w < best_w:
                    best_i, best_w = i, w
            (t1, v1, w1), (t2, v2, w2) = cents[best_i], cents[best_i + 1]
            w = w1 + w2
            cents[best_i:best_i + 2] = [
                ((t1 * w1 + t2 * w2) / w, (v1 * w1 + v2 * w2) / w, w)
            ]

    # -- windowed queries ----------------------------------------------------

    def _now(self, now: Optional[float]) -> Optional[float]:
        if now is not None:
            return now
        if self._pts:
            return self._pts[-1][0]
        if self._centroids:
            return max(c[0] for c in self._centroids)
        return None

    def points(self, window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """Retained ring samples in the window, oldest first."""
        if window_s is None:
            return list(self._pts)
        now = self._now(now)
        if now is None:
            return []
        t_lo = now - window_s
        return [(t, v) for (t, v) in self._pts if t_lo < t <= now]

    def _weighted(self, window_s, now):
        """(value, weight) pairs from ring + digest inside the window."""
        items = [(v, 1.0) for _, v in self.points(window_s, now)]
        if self._centroids:
            if window_s is None:
                items.extend((v, w) for (_, v, w) in self._centroids)
            else:
                anchor = self._now(now)
                if anchor is not None:
                    t_lo = anchor - window_s
                    items.extend(
                        (v, w) for (t, v, w) in self._centroids
                        if t_lo < t <= anchor
                    )
        return items

    def last(self) -> Optional[Tuple[float, float]]:
        return self._pts[-1] if self._pts else None

    def delta(self, window_s: Optional[float] = None,
              now: Optional[float] = None) -> float:
        """Value change across the window (cumulative: counter growth).

        For cumulative series the point at-or-before the window start is
        used as the baseline when still retained, so the increment that
        crossed the window edge is not dropped.
        """
        base_last = self._window_endpoints(window_s, now)
        if base_last is None:
            return 0.0
        (_, v0), (_, v1) = base_last
        return v1 - v0

    def rate(self, window_s: Optional[float] = None,
             now: Optional[float] = None) -> float:
        """delta / elapsed, per second. 0.0 when under two points."""
        base_last = self._window_endpoints(window_s, now)
        if base_last is None:
            return 0.0
        (t0, v0), (t1, v1) = base_last
        dt = t1 - t0
        if dt <= 0.0:
            return 0.0
        return (v1 - v0) / dt

    def _window_endpoints(self, window_s, now):
        pts = self._pts
        if len(pts) < 2:
            return None
        if window_s is None:
            return pts[0], pts[-1]
        anchor = self._now(now)
        t_lo = anchor - window_s
        # last point at-or-before the window start = baseline (cumulative
        # semantics); for sample series it's simply the previous reading
        times = [p[0] for p in pts]
        i = bisect.bisect_right(times, t_lo)
        base_i = i - 1 if i > 0 else 0
        if base_i >= len(pts) - 1:
            return None
        last = pts[-1]
        if last[0] <= t_lo:
            return None
        return pts[base_i], last

    def mean(self, window_s: Optional[float] = None,
             now: Optional[float] = None) -> float:
        items = self._weighted(window_s, now)
        tot_w = sum(w for _, w in items)
        if tot_w <= 0.0:
            return 0.0
        return sum(v * w for v, w in items) / tot_w

    def quantile(self, q: float, window_s: Optional[float] = None,
                 now: Optional[float] = None) -> float:
        """Weighted quantile, ``q`` in [0, 1]. With unit weights (no
        evictions yet) this matches numpy's linear interpolation exactly;
        with centroids it is the t-digest-style approximation."""
        items = self._weighted(window_s, now)
        if not items:
            return 0.0
        items.sort()
        q = min(1.0, max(0.0, float(q)))
        total = sum(w for _, w in items)
        if total <= items[0][1]:
            return items[0][0]
        # center-of-mass ranks: cum_before + (w-1)/2, so unit weights land
        # on ranks 0..n-1 (numpy linear interpolation)
        target = q * (total - 1.0)
        cum = 0.0
        prev_v, prev_r = None, None
        for v, w in items:
            r = cum + (w - 1.0) / 2.0
            if r >= target:
                if prev_v is None or r <= prev_r:
                    return v
                f = (target - prev_r) / (r - prev_r)
                return prev_v + (v - prev_v) * f
            prev_v, prev_r = v, r
            cum += w
        return items[-1][0]

    # -- merging (shard fan-in) ----------------------------------------------

    def merge_from(self, other: "TimeSeries") -> None:
        """Fold another shard's history into this one, kind-aware."""
        if other is None or (not other._pts and not other._centroids):
            return
        if self.kind == "cumulative" and other.kind == "cumulative":
            self._merge_cumulative(other)
        else:
            self._merge_samples(other)
        self.total_samples += other.total_samples

    def _merge_cumulative(self, other: "TimeSeries") -> None:
        a, b = self._pts, other._pts
        if not a:
            self._pts = list(b)[-self.capacity:]
            return
        if not b:
            return
        # sum of two step functions over the union of timestamps, with
        # flat-backward extrapolation before each series' first retained
        # point (so a ring that already evicted its zero doesn't inject a
        # spurious jump at its first surviving sample)
        events = sorted(
            [(t, 0, v) for t, v in a] + [(t, 1, v) for t, v in b]
        )
        va, vb = a[0][1], b[0][1]
        out: List[Tuple[float, float]] = []
        for t, src, v in events:
            if src == 0:
                va = v
            else:
                vb = v
            s = va + vb
            if out and out[-1][0] == t:
                out[-1] = (t, s)
            else:
                out.append((t, s))
        self._pts = out[-self.capacity:]

    def _merge_samples(self, other: "TimeSeries") -> None:
        merged = sorted(self._pts + other._pts)
        while len(merged) > self.capacity:
            t, v = merged.pop(0)
            self._fold(t, v, 1.0)
        self._pts = merged
        for (t, v, w) in other._centroids:
            self._fold(t, v, w)

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        return len(self._pts)

    def __repr__(self) -> str:
        return (f"TimeSeries(kind={self.kind!r}, n={len(self._pts)}, "
                f"centroids={len(self._centroids)}, "
                f"total={self.total_samples})")
