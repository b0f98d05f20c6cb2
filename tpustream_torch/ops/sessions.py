"""Session-window machinery: gap-based merging windows on the pane ring
(PyTorch).

Counterpart of tpustream/ops/sessions.py. The reference documents
session windows (gap-separated activity bursts, chapter3/README.md:
412-428) with the standard Flink semantics: every element opens a window
``[ts, ts+gap)``; overlapping windows merge; the merged window fires
when the watermark passes ``last_ts + gap - 1``.

Panes are exactly ``gap`` ms. Two records in the same pane are < gap
apart, and records in panes that are >= 2 apart are >= gap apart, so
*only adjacent occupied panes can merge*. Each ring cell keeps, besides
the user accumulator, the min and max record timestamp it has seen; a
session is a maximal run of adjacent occupied panes whose boundary gaps
``min[o] - max[o-1]`` are < gap. Runs are reduced with segmented
associative scans over the pane axis, in ``jax.lax.associative_scan``'s
combination order (``segments.associative_scan``), so a float combiner
gives the reference's bits.

Firing a run is safe (no later merge possible): any future record has
``ts > wm >= session_max + gap - 1``, i.e. it cannot be within ``gap``
of the fired session.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from .panes import W0
from .segments import associative_scan

TS_MAX = 2**62  # empty-cell sentinel for per-cell min timestamp


def _bcast(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    extra = x.dim() - flag.dim()
    return flag.reshape(tuple(flag.shape) + (1,) * extra)


def seg_scan_axis0(values: Sequence[torch.Tensor], absorb_prev: torch.Tensor,
                   combine: Callable) -> List[torch.Tensor]:
    """Inclusive segmented scan along dim 0 of ``[O, ...]`` leaves.

    ``absorb_prev[o]`` True means row o continues row o-1's segment.
    ``values`` is a list of leaves whose dim 0 is O; trailing dims ride
    along elementwise (absorb flags broadcast). ``combine(a_tuple,
    b_tuple) -> tuple``."""
    n = len(values)

    def comb(a, b):
        fa, va = a[0], tuple(a[1:])
        fb, vb = b[0], tuple(b[1:])
        merged = combine(va, vb)
        out = [torch.where(_bcast(fb, x), m, x) for m, x in zip(merged, vb)]
        return [fa & fb] + out

    scanned = associative_scan(comb, [absorb_prev] + list(values))
    return list(scanned[1:n + 1])


def propagate_to_run(fire_at_end: torch.Tensor, link: torch.Tensor) -> torch.Tensor:
    """Spread a run-end flag to every member of its run.

    ``link[.., o]`` True means pane o belongs to the same run as o-1;
    ``fire_at_end`` is set only at run-end panes. Returns a mask that is
    True on every pane of a fired run: a reversed segmented OR-scan (in
    reverse order a segment starts at a run end)."""
    rf = torch.flip(fire_at_end, dims=[-1])
    # reversed element r (original o = O-1-r) absorbs reversed r-1
    # (original o+1) iff o+1 links back to o
    rl = torch.flip(link, dims=[-1])
    absorb = torch.cat([torch.zeros_like(rl[..., :1]), rl[..., :-1]], dim=-1)

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return [fa & fb, torch.where(fb, va | vb, vb)]

    x = torch.movedim(rf, -1, 0)
    fl = torch.movedim(absorb, -1, 0)
    _, out = associative_scan(comb, [fl, x])
    return torch.flip(torch.movedim(out, 0, -1), dims=[-1])


def session_links(occ, mn, mx, gap_ms: int, xp=torch):
    """THE session boundary predicate: ``link[:, o]`` true when pane o
    merges with pane o-1 (both occupied AND the inter-pane time gap is
    below ``gap_ms``: adjacent occupied panes do NOT always merge, two
    records can be up to 2*gap-1 apart in adjacent panes).

    ``xp`` is ``torch`` (the device step) or ``numpy`` (the host's
    ``process()`` evaluation), so both share ONE definition."""
    if xp is np:
        prev_occ = np.concatenate([np.zeros_like(occ[:, :1]), occ[:, :-1]], axis=1)
        prev_mx = np.concatenate([np.full_like(mx[:, :1], W0), mx[:, :-1]], axis=1)
    else:
        prev_occ = torch.cat([torch.zeros_like(occ[:, :1]), occ[:, :-1]], dim=1)
        prev_mx = torch.cat([torch.full_like(mx[:, :1], W0), mx[:, :-1]], dim=1)
    return occ & prev_occ & (mn - prev_mx < gap_ms)


def session_runs(occ: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                 gap_ms: int):
    """Link/run structure of the ring in ascending pane order: ``occ``
    ``[K, O]`` cell occupied, ``mn``/``mx`` per-cell min/max record ts.

    Returns (link [K,O], run_end [K,O]): ``link[:, o]`` true when pane o
    merges with pane o-1; ``run_end`` marks the last pane of each run."""
    link = session_links(occ, mn, mx, gap_ms)
    next_link = torch.cat([link[:, 1:], torch.zeros_like(link[:, :1])], dim=1)
    return link, occ & ~next_link


def ascending_slot_order(hi_pane: int, n_slots: int):
    """Ring slots reordered so panes ascend: ``(slot [O], pane_ids [O])``
    as host int64 arrays. The slot of pane p is ``p mod N``; the ring
    covers panes (hi-N, hi], so the ascending order is a cyclic rotation
    of the slot axis: ``x[:, slot]`` is ``torch.roll(x, -(hi+1), 1)``."""
    pane_ids = hi_pane - n_slots + 1 + np.arange(n_slots, dtype=np.int64)
    return np.mod(pane_ids, n_slots), pane_ids


def batch_rescue_closure(keys: torch.Tensor, ts: torch.Tensor,
                         mask: torch.Tensor, anchor: torch.Tensor,
                         gap_ms: int) -> torch.Tensor:
    """Order-insensitive intra-batch late-rescue closure.

    ``anchor`` marks records accepted outright (not hard-late, or
    rescued by a surviving state cell). A hard-late record is ALSO
    accepted when a chain of same-key batch records, each consecutive
    pair < gap apart in event time, links it to an anchor: every such
    chain is a Flink window merge under SOME arrival order, and a batch
    is a set of simultaneous arrivals. The closure is "runs of ts-sorted
    same-key records with consecutive gaps < gap accept all members iff
    they contain an anchor": a sort by (key, ts), invalid rows last, and
    two segmented OR-scans.

    The reference's ``lexsort((ts, key))`` is two stable sorts here: by
    ts, then by key. The result is a set, so the order of ties does not
    matter. Returns the accepted mask (invalid rows False)."""
    big = 2**31 - 1
    k32 = keys.to(torch.int32)
    by_ts = torch.sort(ts, stable=True).indices
    kk = torch.where(mask, k32, big)[by_ts]
    perm = by_ts[torch.sort(kk, stable=True).indices]
    sk = k32[perm]
    sts = ts[perm]
    sm = mask[perm]
    sa = anchor[perm]
    same = (sk[1:] == sk[:-1]) & sm[1:] & sm[:-1]
    close = (sts[1:] - sts[:-1]) < gap_ms
    false1 = torch.zeros(1, dtype=torch.bool, device=ts.device)
    link = torch.cat([false1, same & close])

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return [fa & fb, torch.where(fb, va | vb, vb)]

    _, fwd = associative_scan(comb, [link, sa])
    rl = torch.cat([link[1:], false1])
    _, bwd_r = associative_scan(comb, [torch.flip(rl, [0]), torch.flip(sa, [0])])
    acc_sorted = (fwd | torch.flip(bwd_r, [0])) & sm
    out = torch.zeros_like(mask)
    out[perm] = acc_sorted
    return out


def _pane_runs(stale: np.ndarray, slot_pane: np.ndarray):
    """``(start, stop)`` runs of stale slots along which both the slot
    index and the pane it holds go up by one: a run's panes are
    ``slot_pane[start] + arange(stop - start)``."""
    idx = np.flatnonzero(stale)
    if idx.size == 0:
        return []
    cut = np.flatnonzero((np.diff(idx) != 1) | (np.diff(slot_pane[idx]) != 1)) + 1
    starts = idx[np.r_[0, cut]]
    stops = idx[np.r_[cut - 1, idx.size - 1]] + 1
    return list(zip(starts.tolist(), stops.tolist()))


def session_retarget(acc_leaves: List[torch.Tensor], cnt: torch.Tensor,
                     cell_min: torch.Tensor, cell_max: torch.Tensor,
                     slot_pane: np.ndarray, hi_pane: int, wm: int, gap_ms: int,
                     ring, init_leaves: Sequence, cell_fired=None,
                     lateness_ms: int = 0, ts_base: bool = False,
                     mn_clear=TS_MAX, mx_clear=W0):
    """Advance the ring to (hi-N, hi]: the stale slots of the ``[K, N]``
    cell views are cleared IN PLACE.

    A stale cell still inside its retention horizon (``cell_max + gap -
    1 + lateness > wm``: unfired windows before lateness,
    refire-eligible retained cells within it) counts toward
    ``evicted_unfired`` (ring undersized for the session length /
    lateness horizon). ``ts_base``: the boundary planes store
    pane-RELATIVE int32 offsets (``SessionWindowProgram``'s
    scatter-reduce path), so ``cell_max`` is rebuilt to absolute from
    each slot's old pane; ``mn_clear``/``mx_clear`` are then the int32
    clear identities. The reference passes the per-slot base array;
    here the base is built on the device from the host ``slot_pane``.

    Returns ``(new slot_pane, evicted)``, ``evicted`` a 0-d int64 device
    tensor, or 0 when no slot went stale."""
    from .panes import slot_targets

    target = slot_targets(hi_pane, ring)
    stale = slot_pane != target
    evicted = 0
    # runs of slots, not an index tensor: a host-built index would be a
    # blocking copy to the device
    for a, b in _pane_runs(stale, slot_pane):
        c = cnt[:, a:b]
        mx = cell_max[:, a:b].to(torch.int64)
        if ts_base:
            first = int(slot_pane[a])
            mx = mx + (torch.arange(b - a, dtype=torch.int64, device=cnt.device)
                       + first) * ring.pane_ms
        keep = (c > 0) & (mx + gap_ms - 1 + lateness_ms > wm)
        evicted = evicted + torch.where(keep, c, 0).sum(dtype=torch.int64)
        c.zero_()
        cell_min[:, a:b] = mn_clear
        cell_max[:, a:b] = mx_clear
        for acc, init in zip(acc_leaves, init_leaves):
            acc[:, a:b] = init
        if cell_fired is not None:
            cell_fired[:, a:b] = False
    return target, evicted
