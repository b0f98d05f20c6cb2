"""Pure-Python reference NFA — the host-side oracle for CEP tests.

Replays the EXACT register semantics of runtime/cep_program.py one
event at a time, so device output can be
compared field-for-field:

* one register per non-start NFA state per key (occupancy, window-start
  timestamp, captured events); an event advances registers high-to-low
  simultaneously from the pre-event snapshot,
* an occupied target register that neither advanced out nor died keeps
  its OLDER partial; the incoming (younger) advance is dropped and its
  source is NOT consumed — the single-register-per-state resolution the
  vectorized program applies,
* strict edges (``next`` / ``consecutive``) kill a partial whose
  required next event failed to advance it,
* ``within``: an event at ``ts - start >= within_ms`` cannot extend a
  partial; partials time out when the watermark reaches
  ``start + within_ms`` (checked at batch granularity, AFTER the
  batch's events apply — matching the device's per-step watermark),
* late events (``ts + allowed_lateness <= wm_old``) divert to the late
  stream and never touch NFA state.

Timeout timing is batch-granular on device (the watermark advances once
per step), so the oracle consumes the stream as a list of BATCHES and
must be fed the same batch boundaries the runtime used
(StreamConfig.batch_size slicing).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from ..api.tuples import TupleBase, make_tuple
from ..ops.panes import W0
from .nfa import CompiledPattern, compile_pattern
from .pattern import Pattern


class _Reg:
    __slots__ = ("occ", "start", "events")

    def __init__(self):
        self.occ = False
        self.start = 0
        self.events: List[tuple] = []


def _view(rec):
    """Condition-facing view of a record: plain tuples wrap as TupleN so
    ``r.f2``-style conditions read the same as on device (wider-than-4
    records stay plain tuples, matching device wrap_record)."""
    if isinstance(rec, tuple) and not isinstance(rec, TupleBase) and 2 <= len(rec) <= 4:
        return make_tuple(*rec)
    return rec


def _cond_ok(conds, event) -> bool:
    for c in conds:
        f = getattr(c, "filter", c)
        if not f(event):
            return False
    return True


def run_oracle(
    pattern: "Pattern | CompiledPattern",
    batches: Sequence[Sequence[Tuple[tuple, int]]],
    *,
    delay_ms: int,
    allowed_lateness_ms: int = 0,
    key_of=None,
    eos: bool = True,
):
    """Run the reference NFA over ``batches`` (each a list of
    ``(record_tuple, ts_ms)`` in arrival order).

    ``key_of`` extracts the key value from a record tuple (default:
    field 1, the chapter jobs' channel column).

    Returns ``(matches, timeouts, late)`` where each match is the list
    of L matched event tuples in sequence order, each timeout is
    ``(n_captured, start_ts, [events...])``, and late is the list of
    diverted records. Matches appear in completing-event arrival order
    per batch; timeouts in (key-first-seen, register) order at each
    batch end — the device emission order."""
    cp = pattern if isinstance(pattern, CompiledPattern) else compile_pattern(pattern)
    L, R = cp.length, cp.length - 1
    within = cp.within_ms
    key_of = key_of if key_of is not None else (lambda rec: rec[1])

    regs: dict = {}          # key (first-seen order preserved) -> [R regs]
    matches: List[List[tuple]] = []
    timeouts: List[Tuple[int, int, List[tuple]]] = []
    late_out: List[tuple] = []
    wm = W0
    max_ts = W0

    def _advance(key, rec, ts):
        rr = regs.setdefault(key, [_Reg() for _ in range(R)])
        view = _view(rec)
        step_ok = [
            _cond_ok(cp.conds[cp.stage_of[j]], view) for j in range(L)
        ]
        # can_adv[j]: edge j (state j -> j+1) fires off the PRE-event snapshot
        can_adv = []
        for j in range(L):
            if j == 0:
                src_occ, src_start = True, ts
            else:
                src_occ, src_start = rr[j - 1].occ, rr[j - 1].start
            w_ok = within is None or (ts - src_start) < within
            can_adv.append(src_occ and step_ok[j] and w_ok)
        # resolve register collisions top-down: an accepted advance
        # consumes its source; a kept older partial rejects the advance
        adv_acc = [False] * (L + 1)
        adv_acc[L - 1] = can_adv[L - 1]          # accept state: always emits
        keep_old = [False] * R
        for i in range(R - 1, -1, -1):
            consumed = adv_acc[i + 1]
            killed = bool(cp.strict[i + 1]) and rr[i].occ and not consumed
            keep_old[i] = rr[i].occ and not consumed and not killed
            adv_acc[i] = can_adv[i] and not keep_old[i]
        if adv_acc[L - 1]:
            matches.append(list(rr[R - 1].events) + [rec])
        new = [(_Reg()) for _ in range(R)]
        for i in range(R):
            if adv_acc[i]:
                new[i].occ = True
                if i == 0:
                    new[i].start = ts
                    new[i].events = [rec]
                else:
                    new[i].start = rr[i - 1].start
                    new[i].events = list(rr[i - 1].events) + [rec]
            elif keep_old[i]:
                new[i] = rr[i]
        regs[key] = new

    def _sweep_timeouts(wm_now):
        if within is None:
            return
        for key in regs:                          # first-seen key order
            for i, r in enumerate(regs[key]):
                if r.occ and wm_now >= r.start + within:
                    timeouts.append((i + 1, r.start, list(r.events)))
                    regs[key][i] = _Reg()

    for batch in batches:
        wm_old = wm
        for rec, ts in batch:
            max_ts = max(max_ts, ts)
        for rec, ts in batch:
            if ts + allowed_lateness_ms <= wm_old:
                late_out.append(rec)
                continue
            _advance(key_of(rec), rec, ts)
        wm = max(wm, max_ts - delay_ms)
        _sweep_timeouts(wm)
    if eos:
        _sweep_timeouts(2**62)
    return matches, timeouts, late_out
