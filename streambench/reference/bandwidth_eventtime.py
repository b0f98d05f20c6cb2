"""Plain reference of the chapter-3 event-time bandwidth alert
(``BandwidthMonitorWithEventTime.java:24-57``).

Sliding event-time windows of ``size_s`` every ``slide_s`` per channel:
each channel's flows are summed per pane of ``slide_s``, a window sums
its panes exactly (int64, as the reference's ``long``), and the rows are
``(channel, Mbps)`` for every window under ``below_mbps``, in order of
window end, then of the channel's first arrival (its key id). The end
of the stream fires every window. Mbps is the job's ``sum * 8.0 / 60 /
1024 / 1024`` with each division by a constant taken as a multiply by
its reciprocal, as the JAX package computes it and the port must match
bit for bit. Nothing is late: the traffic's lateness stays under the
delay, and the harness holds ``late_dropped`` at 0.

Flows are non-negative, so a window's sum is at least each of its
panes' and Mbps only grows with the sum: a window passes only if every
pane in it passes alone. So only the windows of passing panes are
enumerated, and each is summed over all its panes.
"""

from __future__ import annotations

import numpy as np

from streambench.check import interned_ids, labels


def mbps(total_bytes: np.ndarray) -> np.ndarray:
    return total_bytes * 8.0 * (1 / 60) * (1 / 1024) * (1 / 1024)


def expected(events: dict, config: dict) -> list:
    """``[channel names (object array), Mbps (float64)]``."""
    w = config["window"]
    slide, n_win = int(w["slide_s"]), int(w["size_s"]) // int(w["slide_s"])
    below = float(w["below_mbps"])
    ts, ch, flow = events["ts"], events["key"], events["value"]
    if flow.size and flow.min() < 0:
        raise ValueError("the reference takes non-negative flows only")
    rank = interned_ids(ch)
    pane = ts // slide
    p0 = int(pane.min()) - n_win  # every window's first pane stays >= 0
    code = (rank << 32) | (pane - p0)
    order = np.argsort(code, kind="stable")
    cs = code[order]
    starts = np.flatnonzero(np.r_[True, cs[1:] != cs[:-1]])
    cells = cs[starts]
    sums = np.add.reduceat(flow[order], starts)
    prefix = np.concatenate([[0], np.cumsum(sums)])
    # pane p lies in the windows whose end pane is p + 1 .. p + n_win
    small = cells[mbps(sums) < below]
    ends = ((small & 0xFFFFFFFF)[:, None] + 1 + np.arange(n_win)).ravel()
    cand = np.unique((np.repeat(small >> 32, n_win) << 32) | ends)
    key, end = cand >> 32, cand & 0xFFFFFFFF
    lo = np.searchsorted(cells, (key << 32) | (end - n_win))
    hi = np.searchsorted(cells, (key << 32) | end)
    rate = mbps(prefix[hi] - prefix[lo])
    keep = rate < below
    key, end, rate = key[keep], end[keep], rate[keep]
    o = np.lexsort((key, end))
    channel = np.empty(int(rank.max()) + 1 if rank.size else 0, np.int64)
    channel[rank] = ch
    return [labels(channel[key[o]], lambda c: f"www.{c:07d}.com"), rate[o]]
