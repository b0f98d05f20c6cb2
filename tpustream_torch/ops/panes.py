"""Pane-ring window state (PyTorch).

Counterpart of tpustream/ops/panes.py. A sliding window of (size, slide)
is decomposed into panes of ``g = gcd(size, slide)`` ms; per-record work
is one scatter into a ``[n_slots, keys]`` ring indexed by
``pane_id % n_slots``, and a window fire composes its ``P = size // g``
panes (reference chapter3/.../BandwidthMonitorWithEventTime.java:46).

Ring metadata (the pane each slot holds, the head pane) is small and is
kept on the host as numpy and Python ints, so the decisions that depend
on it need no device round trip; the planes live on the device. Floor
division and modulo follow ``jnp.floor_divide``/``jnp.mod`` on negative
operands (``torch.div(..., rounding_mode="floor")``, ``torch.remainder``,
numpy's ``%``).

No index past a tensor's end ever reaches a scatter: where the
reference's ``mode="drop"`` scatters send masked rows to index
``capacity``, the buffers here carry one trailing sink cell there and
indices are clamped to it.

Watermark semantics follow the monotone ``max_seen - delay`` contract of
BoundedOutOfOrdernessTimestampExtractor (chapter3/README.md:380-396);
window end ``e`` fires when the watermark first reaches ``e - 1``, and
an element is late when its LAST window has fired past allowed lateness
(chapter3/README.md:209-213).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

W0 = -(2**62)  # "long min" safe against offset arithmetic


class RingSpec(NamedTuple):
    pane_ms: int            # pane granularity g
    panes_per_window: int   # P
    slide_ms: int
    size_ms: int
    n_slots: int            # N  (>= P + lateness horizon + slack)
    n_fire_candidates: int  # N + P

    @property
    def lateness_horizon_panes(self) -> int:
        return self.n_slots - self.panes_per_window


def make_ring_spec(
    size_ms: int,
    slide_ms: int,
    delay_ms: int,
    allowed_lateness_ms: int,
    slack: int = 16,
) -> RingSpec:
    g = math.gcd(size_ms, slide_ms)
    p = size_ms // g
    horizon = -(-(delay_ms + allowed_lateness_ms) // g)  # ceil
    n = p + horizon + slack
    return RingSpec(g, p, slide_ms, size_ms, n, n + p)


def pane_of(ts: torch.Tensor, g: int) -> torch.Tensor:
    return torch.div(ts, g, rounding_mode="floor")


def last_window_end(ts: torch.Tensor, spec: RingSpec) -> torch.Tensor:
    """End of the LAST window containing ts: the largest multiple of slide
    that is <= ts + size (window [e-size, e) with e > ts)."""
    return torch.div(ts + spec.size_ms, spec.slide_ms,
                     rounding_mode="floor") * spec.slide_ms


def late_mask(ts: torch.Tensor, wm: int, allowed_lateness_ms: int, spec: RingSpec):
    """True where the record is late beyond allowed lateness: all its
    windows have fired and purged."""
    return last_window_end(ts, spec) - 1 + allowed_lateness_ms <= wm


def slot_targets(hi_pane: int, spec: RingSpec) -> np.ndarray:
    """For each ring slot s, the unique pane id in (hi-N, hi] congruent to
    s mod N (int64 [N]). Slots for panes the stream hasn't reached stay
    empty."""
    n = spec.n_slots
    s = np.arange(n, dtype=np.int64)
    return np.int64(hi_pane) - np.mod(np.int64(hi_pane) - s, n)


def retarget_rows(
    plane_rows: Sequence[torch.Tensor],
    cnt_rows: torch.Tensor,
    slot_pane: np.ndarray,
    hi_pane: int,
    wm: int,
    spec: RingSpec,
    init_leaves: Sequence,
) -> Tuple[List[torch.Tensor], torch.Tensor, np.ndarray, Union[int, torch.Tensor]]:
    """Advance the ring to cover (hi-N, hi]: slots whose stored pane no
    longer matches their target are cleared, IN PLACE, in the slot-major
    ``[n_slots, keys]`` planes and counts.

    Returns ``(plane_rows, cnt_rows, new_slot_pane, evicted)``;
    ``evicted`` counts records in cleared panes whose last window had
    NOT fired yet (an undersized ring): a 0-d int64 device tensor, or 0
    when no such pane was cleared."""
    target = slot_targets(hi_pane, spec)
    stale = slot_pane != target
    last_end = (slot_pane + spec.panes_per_window) * spec.pane_ms
    unfired = stale & (last_end - 1 > wm)
    evicted: Union[int, torch.Tensor] = 0
    # runs of slots, not an index tensor: a host-built index would be a
    # blocking copy to the device (advancing the head clears at most two
    # runs, the ring wrapping once)
    for a, b in _runs(np.flatnonzero(unfired)):
        evicted = evicted + cnt_rows[a:b].sum(dtype=torch.int64)
    for a, b in _runs(np.flatnonzero(stale)):
        cnt_rows[a:b] = 0
        for p, init in zip(plane_rows, init_leaves):
            p[a:b] = init
    return list(plane_rows), cnt_rows, target, evicted


def _runs(idx: np.ndarray) -> List[Tuple[int, int]]:
    """``(start, stop)`` of each run of consecutive values in a sorted
    index array."""
    if idx.size == 0:
        return []
    cut = np.flatnonzero(np.diff(idx) != 1) + 1
    starts = idx[np.r_[0, cut]]
    stops = idx[np.r_[cut - 1, idx.size - 1]] + 1
    return list(zip(starts.tolist(), stops.tolist()))


def compact_positions(mask_flat: torch.Tensor, capacity: int, base=0):
    """The shared compaction core: scatter each set row's SOURCE index to
    its output position ``base + rank``. Returns ``(idx [capacity],
    count)``, ``count`` the total set rows (int32, may exceed capacity);
    rows past the capacity land in a sink cell that is cut off."""
    c = torch.cumsum(mask_flat.to(torch.int32), dim=0, dtype=torch.int32)
    count = c[-1]
    pos = base + c - 1
    pos = torch.where(mask_flat & (pos < capacity), pos, capacity)
    src = torch.arange(mask_flat.shape[0], dtype=torch.int32,
                       device=mask_flat.device)
    idx = torch.zeros(capacity + 1, dtype=torch.int32, device=mask_flat.device)
    idx.scatter_(0, pos.to(torch.int64), src)
    return idx[:capacity], count


def compact(mask_flat: torch.Tensor, cols, capacity: int):
    """Device-side compaction: the first ``capacity`` set rows of mask.
    Returns ``(indices [A], valid [A], overflow, gathered cols [A])``."""
    idx, count = compact_positions(mask_flat, capacity)
    out_cols = [x[idx.to(torch.int64)] for x in cols]
    valid = torch.arange(capacity, dtype=torch.int32,
                         device=mask_flat.device) < count
    overflow = torch.clamp(count - capacity, min=0).to(torch.int64)
    return idx, valid, overflow, out_cols


def append_compact(mask_flat, src_cols, out_cols, count, capacity: int):
    """Append the set rows of ``mask_flat`` after ``count`` existing rows
    of the fixed ``[capacity]`` output columns, which are written IN
    PLACE. Returns ``(out_cols, new_count, overflowed)``.

    The work per column is ``m = min(rows, capacity)`` gathers, not
    ``capacity``: the ``j``-th set row goes to ``count + j``, and the
    ``m`` candidate positions ``(count + j) % capacity`` are distinct
    (``count <= capacity``), so one scatter writes them all; a candidate
    that is no new row (``j`` past the set rows, or ``count + j`` past
    the capacity and wrapped onto an old row) is written its old value."""
    m = min(mask_flat.shape[0], capacity)
    src, added = compact_positions(mask_flat, m)
    j = torch.arange(m, dtype=torch.int32, device=mask_flat.device)
    at = count + j
    is_new = (j < added) & (at < capacity)
    pos = torch.remainder(at, capacity).to(torch.int64)
    gather = src.to(torch.int64)
    out_cols = [
        o.scatter_(0, pos, torch.where(is_new, s[gather].to(o.dtype), o[pos]))
        for o, s in zip(out_cols, src_cols)
    ]
    new_count = torch.clamp(count + added, max=capacity)
    overflowed = torch.clamp(count + added - capacity, min=0).to(torch.int64)
    return out_cols, new_count, overflowed
