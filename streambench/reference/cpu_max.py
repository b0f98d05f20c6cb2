"""Plain reference of chapter 2's ``ComputeCpuMax``
(``ComputeCpuMax.java:14-28``): ``keyBy(host).max(usage)`` with Flink's
rolling-aggregate rows. Every event emits ``(host, cpu, usage)`` where
``usage`` is the running max of its host's usages so far (float64) and
``cpu`` the host's first event's, in arrival order."""

from __future__ import annotations

import numpy as np

from streambench.check import labels


def expected(events: dict, config: dict) -> list:
    """``[host names, cpu names (object arrays), usage (float64)]``;
    ``value`` is usage in hundredths (``u / 100`` is what the line
    says)."""
    key, sub, u = events["key"], events["sub"], events["value"]
    if u.size and u.min() < 0:
        raise ValueError("the reference takes non-negative usages only")
    base = int(u.max()) + 1 if u.size else 1
    order = np.argsort(key, kind="stable")
    ks = key[order]
    # a running max that restarts at each host: offset hosts apart
    run = np.maximum.accumulate(ks * base + u[order]) - ks * base
    top = np.empty_like(u)
    top[order] = run
    uniq, first = np.unique(key, return_index=True)
    first_sub = sub[first][np.searchsorted(uniq, key)]
    host = labels(key, lambda h: f"10.{(h >> 16) & 255}.{(h >> 8) & 255}.{h & 255}")
    return [host, labels(first_sub, lambda c: f"cpu{c}"), top / 100]
