"""Session windows (PyTorch).

Counterpart of tpustream/runtime/session_program.py: the gap-based
merging windows the reference documents at chapter3/README.md:412-428,
with ``reduce``/``aggregate`` window functions (the
``AggregateFunction.merge`` contract, which Flink invokes only on window
merges, chapter2/README.md:144-147, runs on every pane merge here) and
with a full-window ``process()``.

Design (see ``ops/sessions.py``): panes of exactly ``gap`` ms, so only
adjacent occupied panes can merge; each (key, pane) cell keeps the user
accumulator plus min/max record timestamps; sessions are maximal linked
runs reduced by segmented scans over the pane axis; a run fires when
``run_max_ts + gap - 1 <= watermark`` and its cells are cleared.

Late handling matches Flink's merging-window operator:

* a record goes to the late side output only when its MERGED window
  would be late: its solo window ``[ts, ts+gap)`` is past ``watermark +
  allowed_lateness`` AND it overlaps no surviving session cell, and no
  chain of same-batch records links it to an accepted one;
* with ``allowed_lateness > 0`` fired sessions are RETAINED (cells
  marked fired) until ``end - 1 + lateness`` passes the watermark; a
  late record landing in or next to a retained session fires the merged
  session again. Runs fire only when they hold an unfired cell.

State is typed key-major ``[key * n_slots + slot]`` cells (flat, one
trailing sink cell each); the ring metadata (``slot_pane``, ``hi``, the
watermark) stays on the host, as in ``WindowProgram``, and the
reference's ``lax.cond``s are Python ``if``s on scalars read with one
small copy each (``host_reads``). Session programs do not sweep: a
record below the ring's coverage after an event-time jump is counted in
``evicted_unfired``, never written. ``slot_pane`` always equals
``slot_targets(hi)`` (the ring is retargeted whenever ``hi`` grows), so
"slot s holds pane q" is ``hi - N < q <= hi`` on the device.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..api.functions import Collector, WindowContext
from ..api.tuples import make_tuple
from ..ops import liveness
from ..ops import panes as pane_ops
from ..ops import sessions as sess_ops
from ..ops.panes import W0
from ..ops.sessions import TS_MAX
from ..records import NUMPY_DTYPES
from .device import TORCH_DTYPES, dummy_leaf
from .plan import JobPlan
from .process_program import ProcessWindowProgram, host_values
from ..utils.tree import to_host
from .step import BaseProgram, host_leaves, no_exchange
from .window_program import WindowProgram

COUNTERS = ("evicted_unfired", "alert_overflow", "window_fires", "late_dropped")


def _session_ring(program, spec, cfg) -> pane_ops.RingSpec:
    """Panes of gap ms, one pane per "window", and extra slack so
    multi-pane sessions have room to grow (and retained fired sessions
    have coverage through the lateness horizon)."""
    return pane_ops.make_ring_spec(
        spec.gap_ms, spec.gap_ms, program.delay_ms,
        program.allowed_lateness_ms,
        cfg.pane_ring_slack + cfg.session_extra_panes,
    )


def _ascending(x: torch.Tensor, hi: int) -> torch.Tensor:
    """``[K, N]`` slot-order columns in ascending pane order (the ring
    covers (hi-N, hi], so this is a cyclic rotation)."""
    return torch.roll(x, shifts=-(hi + 1) % x.shape[1], dims=1)


def _slot_order(x: torch.Tensor, hi: int) -> torch.Tensor:
    """The inverse of :func:`_ascending`."""
    return torch.roll(x, shifts=(hi + 1) % x.shape[1], dims=1)


class _SessionCommon:
    """The step's shared front half: the watermark, Flink's merged-window
    late test (probes of panes p-1, p, p+1 and the intra-batch rescue
    closure), the ring head, the coverage guard; and the session-run
    detection over a ring of cells."""

    # typed [K, N] cells shard on the key axis by rank
    key_sharded_leaves = BaseProgram.key_sharded_leaves
    # leading-key leaves rescale and grow with the base restack, not the
    # window's flat word planes
    rescale_key_leaf = BaseProgram.rescale_key_leaf
    grow_key_leaf = BaseProgram.grow_key_leaf

    @property
    def gap_ms(self) -> int:
        return self.plan.stateful.window.gap_ms

    def _make_ring(self, spec, cfg):
        return _session_ring(self, spec, cfg)

    def _mergeable(self, hi_old: int, kk: int, keys, ts, q, cnt, cmin, cmax,
                   rel_ts: bool) -> torch.Tensor:
        """Records whose solo window ``[ts, ts+gap)`` overlaps the
        surviving cell of pane ``q`` of their key."""
        n, gap = self.ring.n_slots, self.gap_ms
        s = torch.remainder(q, n)
        flat = keys.to(torch.int64).clamp(0, kk - 1) * n + s
        occ_q = (q > hi_old - n) & (q <= hi_old) & (cnt[flat] > 0)
        mn_q = cmin[flat].to(torch.int64)
        mx_q = cmax[flat].to(torch.int64)
        if rel_ts:
            # pane-relative int32 storage -> absolute (q is the probed
            # pane, which IS the occupied cell's pane)
            base = q * self.ring.pane_ms
            mn_q = base + mn_q
            mx_q = base + mx_q
        return occ_q & (mn_q < ts + gap) & (ts < mx_q + gap)

    def _admit(self, state, keys, ts, mask, pane, cnt, cmin, cmax,
               rel_ts: bool = False, batch_max_t=None):
        """Flink's merging-window late test and the step's host scalars.
        Returns ``(live, late, batch_max, hi)``: ``live`` the records
        that merge into the ring (late ones and those below its coverage
        after the head moved to ``hi`` removed; the latter counted in
        ``evicted_unfired``), ``late`` the late stream's rows.
        ``batch_max_t``: the newest timestamp of the shard's rows before
        the keyBy (a device scalar; by default ``ts``'s). ``batch_max``
        and ``hi`` are the shards' maxima."""
        n, gap = self.ring.n_slots, self.gap_ms
        kk = self.key_capacity(state)
        wm_old, hi_old = state["wm"], state["hi"]
        hard_late = (ts + gap - 1 + self.allowed_lateness_ms <= wm_old) & mask
        rescued = (
            self._mergeable(hi_old, kk, keys, ts, pane - 1, cnt, cmin, cmax, rel_ts)
            | self._mergeable(hi_old, kk, keys, ts, pane, cnt, cmin, cmax, rel_ts)
            | self._mergeable(hi_old, kk, keys, ts, pane + 1, cnt, cmin, cmax, rel_ts)
        )
        anchor = mask & (~hard_late | rescued)
        # the step's decisions need four scalars of the batch: one copy
        batch_max, max_key, n_unrescued, batch_hi = (
            int(v) for v in self._read(torch.stack([
                (torch.where(mask, ts, W0).max() if batch_max_t is None
                 else batch_max_t),
                torch.where(mask, keys.to(torch.int64), -1).max(),
                (hard_late & ~rescued).sum(dtype=torch.int64),
                torch.where(anchor, pane, -1).max(),
            ]))
        )
        if max_key >= kk:
            raise IndexError(
                f"a record carried key id {max_key}, past the window "
                f"state's key capacity of {kk}"
            )
        if n_unrescued:
            # intra-batch rescue: a hard-late record may also merge into
            # a session another record of this SAME batch opens
            accepted = sess_ops.batch_rescue_closure(keys, ts, mask, anchor, gap)
            (batch_hi,) = (int(v) for v in self._read(
                torch.where(accepted, pane, -1).max().reshape(1)))
        else:
            accepted = anchor
        batch_max = self._global_max(batch_max)
        batch_hi = self._global_max(batch_hi)
        late = mask & ~accepted
        live = mask & accepted
        if self.count_late_as_dropped:
            state["late_dropped"] += late.sum(dtype=torch.int64)
        hi = max(hi_old, batch_hi)
        # coverage guard: records below ring coverage after a jump would
        # alias mod N into live session cells; dropped and counted
        uncov = live & (pane <= hi - n)
        state["evicted_unfired"] += uncov.sum(dtype=torch.int64)
        return live & ~uncov, late, batch_max, hi

    def _runs(self, cnt_v, cmin_v, cmax_v, cfired_v, hi: int, wm: int,
              rel_ts: bool = False):
        """Session runs of the ring in ascending pane order, from the
        ``[K, N]`` cell views. Returns ``(link, fire, cleanup, mx)``
        ``[K, O]``: ``fire`` at run ends whose session crossed the
        watermark and holds an unfired (dirty) cell, ``cleanup`` at run
        ends past their lateness retention horizon, ``mx`` the cells'
        absolute max timestamps."""
        n, gap = self.ring.n_slots, self.gap_ms
        occ = _ascending(cnt_v, hi) > 0
        cm = _ascending(cmin_v, hi).to(torch.int64)
        cx = _ascending(cmax_v, hi).to(torch.int64)
        if rel_ts:
            base = (torch.arange(n, dtype=torch.int64, device=cm.device)
                    + (hi - n + 1)) * self.ring.pane_ms
            cm = base[None, :] + cm
            cx = base[None, :] + cx
        mn = torch.where(occ, cm, TS_MAX)
        mx = torch.where(occ, cx, W0)
        link, run_end = sess_ops.session_runs(occ, mn, mx, gap)
        # per-run count of dirty (unfired) cells: retained (all-fired)
        # runs cross the watermark every step but must not fire again
        unf = (occ & ~_ascending(cfired_v, hi)).to(torch.int32)
        (run_unf,) = sess_ops.seg_scan_axis0(
            [unf.t()], link.t(), lambda a, b: (a[0] + b[0],))
        fire = run_end & (mx + gap - 1 <= wm) & (run_unf.t() > 0)
        cleanup = run_end & (mx + gap - 1 + self.allowed_lateness_ms <= wm)
        return link, fire, cleanup, mx


class SessionWindowProgram(_SessionCommon, WindowProgram):
    """Session windows with ``reduce``/``aggregate``. A step: the late
    test, the ring retarget, the merge of the live records into the
    ``[K, N]`` cells (a scatter-reduce when every accumulator leaf is a
    commutative integer op, min/max or the key, else a sort and a
    segmented scan), then the fire of every due dirty session, compacted
    pane-major into ``fire_capacity`` rows, finalized, sent through the
    post chain and compacted again into ``alert_capacity``."""

    operator_name = "session_window"
    STATE_COMPONENT_KEYS = {
        "session_cells": ("acc", "cnt", "cell_min", "cell_max",
                          "cell_fired", "pending_mark", "pending_clear"),
        "pane_ring": ("slot_pane",),
    }

    accepted_kinds = ("session",)

    def __init__(self, plan: JobPlan, cfg):
        if plan.stateful.apply_kind == "process":
            raise NotImplementedError(
                "SessionWindowProgram takes reduce/aggregate window "
                "functions; process() is SessionProcessProgram"
            )
        super().__init__(plan, cfg)

    # WindowProgram.__init__ runs the word-plane analysis here; session
    # cells are typed planes, so the analysis is the scatter-reduce test
    def _analyze_columns(self) -> None:
        self._analyze_session_fast()

    def _analyze_session_fast(self) -> None:
        """Scatter-reduce eligibility for the typed session cells: when
        EVERY accumulator leaf is either a commutative primitive
        (add/min/max, read off the combiner's graph, ``ops/liveness.py``)
        or the cell-invariant projected KEY column, the batch merges with
        one non-unique scatter-reduce per plane: no sort, no scan, no
        gathers. A float ``add`` keeps the ordered path: a float
        scatter-add through atomics has no fixed order."""
        arity = len(self.acc_kinds)
        dummies = [dummy_leaf(k) for k in self.acc_kinds]

        def combine_probe(*ab):
            return self.combine(tuple(ab[:arity]), tuple(ab[arity:]))

        try:
            ops = liveness.leaf_algebraic_ops(combine_probe, dummies, arity)
            pt = liveness.passthrough_outputs(combine_probe, dummies + dummies,
                                              arity)
        except Exception:
            # an untraceable combiner simply keeps the generic path
            self._sess_ops = [None] * arity
            self._sess_key_leaf = None
            self._sess_fast = False
            self._rel_ts = False
            return
        # reduce only: reduce accumulators ARE the record, so leaf
        # key_pos is the key column (every writer to a cell carries the
        # same id). An AGGREGATE accumulator's leaf there is arbitrary; a
        # passthrough is keep-first, which a non-unique scatter-set would
        # corrupt
        self._sess_key_leaf = (
            self.key_pos
            if self.apply_kind == "reduce"
            and not self.plan.synthetic_key
            and self.key_pos < arity
            and pt[self.key_pos]
            else None
        )
        self._sess_ops = ops

        def leaf_ok(i: int) -> bool:
            if i == self._sess_key_leaf:
                return True
            if ops[i] in ("min", "max"):
                return True  # order-free for every dtype
            if ops[i] == "add":
                # exact for integers; float sums would drift from the
                # ordered path's arrival-order fold
                return not TORCH_DTYPES[self.acc_kinds[i]].is_floating_point
            return False

        self._sess_fast = all(leaf_ok(i) for i in range(arity))
        # pane-RELATIVE int32 boundary planes: a record's offset within
        # its cell's pane is < pane_ms (= gap), so gaps under ~24.8 days
        # store as int32 offsets; absolute timestamps are rebuilt as
        # pane * pane_ms + rel at every read site
        self._rel_ts = bool(self._sess_fast and self.ring.pane_ms < 2**31)

    _REL_MIN_IDENT = 2**31 - 1
    _REL_MAX_IDENT = -(2**31)

    def _sess_init_leaves(self) -> List:
        """Per-acc-leaf initial/reset value: the combiner's identity on
        the fast path (scatter-min/max meet the dtype's max/min in
        unoccupied cells), 0 otherwise (the generic path never reads
        unoccupied values)."""
        out = []
        for i, kd in enumerate(self.acc_kinds):
            dt = TORCH_DTYPES[kd]
            op = (self._sess_ops[i]
                  if self._sess_fast and i != self._sess_key_leaf else None)
            if op in ("min", "max"):
                info = torch.finfo(dt) if dt.is_floating_point else torch.iinfo(dt)
                out.append(info.max if op == "min" else info.min)
            else:
                out.append(0)
        return out

    def _clear_idents(self):
        if self._rel_ts:
            return self._REL_MIN_IDENT, self._REL_MAX_IDENT
        return TS_MAX, W0

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def init_state(self, key_capacity: int = None) -> dict:
        """Typed ``[K, N]`` cells, flat key-major with a trailing sink
        cell each: the accumulator leaves (identity-initialized: the
        scatter-reduce path merges straight into unoccupied cells),
        ``cnt``, the min/max record timestamps (pane-relative int32 on
        the scatter-reduce path) and ``cell_fired`` (cells of sessions
        already fired and retained for allowed-lateness refires); the
        host ring metadata and the device counters."""
        n, kk = self.ring.n_slots, key_capacity or self.cfg.key_capacity
        self._check_cells(kk)
        dev, size = self.device, n * kk + 1
        mn_c, mx_c = self._clear_idents()
        ts_dt = torch.int32 if self._rel_ts else torch.int64
        state = {
            "acc": [
                torch.full((size,), init, dtype=TORCH_DTYPES[kd], device=dev)
                for init, kd in zip(self._sess_init_leaves(), self.acc_kinds)
            ],
            "cnt": torch.zeros((size,), dtype=torch.int32, device=dev),
            "cell_min": torch.full((size,), mn_c, dtype=ts_dt, device=dev),
            "cell_max": torch.full((size,), mx_c, dtype=ts_dt, device=dev),
            "cell_fired": torch.zeros((size,), dtype=torch.bool, device=dev),
            "slot_pane": pane_ops.slot_targets(-1, self.ring),
            "hi": -1,
            "wm": W0,
            "max_ts": W0,
        }
        for name in COUNTERS:
            state[name] = torch.zeros((), dtype=torch.int64, device=dev)
        return self._with_rules(state)

    _CELL_KEYS = ("cnt", "cell_min", "cell_max", "cell_fired")

    def grow_state(self, state: dict, key_capacity: int) -> dict:
        """The same state at a larger ``key_capacity``: the layout is
        key-major and interned key ids are stable, so the old keys' cells
        are the new planes' head; new keys start empty."""
        head = self.key_capacity(state) * self.ring.n_slots
        new = self.init_state(key_capacity)
        for dst, src in zip(new["acc"] + [new[k] for k in self._CELL_KEYS],
                            state["acc"] + [state[k] for k in self._CELL_KEYS]):
            dst[:head] = src[:head]
        for name, v in state.items():
            if name != "acc" and name not in self._CELL_KEYS:
                new[name] = v
        return new

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        """Turn the reference package's session state (numpy ``[K, N]``
        ``acc`` leaves, ``cnt``, ``cell_min``, ``cell_max``,
        ``cell_fired``, ``slot_pane`` and the scalar leaves,
        tpustream/runtime/session_program.py init_state) into this
        program's state on its device."""
        dev = self.device
        mn_c, mx_c = self._clear_idents()
        want = np.int32 if self._rel_ts else np.int64
        if np.asarray(state_np["cell_min"]).dtype != want:
            raise ValueError(
                "the reference state's boundary planes do not match this "
                "program's merge path (pane-relative int32 or absolute)"
            )

        def flat(a, dtype, sink):
            a = np.asarray(a).reshape(-1).astype(dtype)
            return torch.from_numpy(np.append(a, np.asarray(sink, dtype))).to(dev)

        state = {
            "acc": [
                flat(a, NUMPY_DTYPES[kd], init)
                for a, kd, init in zip(state_np["acc"], self.acc_kinds,
                                       self._sess_init_leaves())
            ],
            "cnt": flat(state_np["cnt"], np.int32, 0),
            "cell_min": flat(state_np["cell_min"], want, mn_c),
            "cell_max": flat(state_np["cell_max"], want, mx_c),
            "cell_fired": flat(state_np["cell_fired"], np.bool_, False),
            "slot_pane": np.asarray(state_np["slot_pane"], np.int64).copy(),
        }
        for name in ("hi", "wm", "max_ts"):
            state[name] = int(state_np[name])
        for name in COUNTERS:
            state[name] = torch.tensor(int(state_np[name]), dtype=torch.int64,
                                       device=dev)
        _check_ring(self, state)
        return self._rules_from_jax_numpy(state, state_np)

    def state_to_jax_numpy(self, state: dict) -> dict:
        """The inverse of :meth:`state_from_jax_numpy`: the cell planes
        as ``[K, N]`` (sink cells dropped), the host ring metadata as
        int64 leaves, and the reference's ``exchange_overflow``."""
        n, kk = self.ring.n_slots, self.key_capacity(state)

        def cells(t):
            return to_host(t[:-1].view(kk, n))

        out = host_leaves(state, ("hi", "wm", "max_ts", "slot_pane") + COUNTERS)
        out["acc"] = [cells(a) for a in state["acc"]]
        for name in self._CELL_KEYS:
            out[name] = cells(state[name])
        out["exchange_overflow"] = no_exchange()
        return self._rules_to_jax_numpy(state, out)

    def _views(self, state):
        """``[K, N]`` views of the cell planes (sink cells left out)."""
        n, kk = self.ring.n_slots, self.key_capacity(state)

        def v(t):
            return t[: kk * n].view(kk, n)

        return ([v(a) for a in state["acc"]], v(state["cnt"]),
                v(state["cell_min"]), v(state["cell_max"]),
                v(state["cell_fired"]))

    # ------------------------------------------------------------------
    # the merge
    # ------------------------------------------------------------------
    def _scatter_session_fast(self, state, keys, mid_cols, live, pane, ts):
        """One non-unique scatter-reduce per plane (no sort, scan or
        gather): add/min/max leaves reduce commutatively, the key plane
        and the fired flag take constant writes (every writer to a cell
        carries the same value), ``cnt`` adds ones, and the boundary
        planes take the min/max pane-relative timestamps. Masked rows go
        to the sink cell."""
        n, kk = self.ring.n_slots, self.key_capacity(state)
        slot = torch.remainder(pane, n)
        flat = torch.where(live, keys.to(torch.int64) * n + slot, kk * n)
        for i, (a, col) in enumerate(zip(state["acc"], self.lift(mid_cols))):
            v = col.to(a.dtype)
            if i == self._sess_key_leaf:
                a.scatter_(0, flat, v)
            else:
                op = {"add": "sum", "min": "amin", "max": "amax"}[self._sess_ops[i]]
                a.scatter_reduce_(0, flat, v, op)
        if self._rel_ts:
            tv = (ts - pane * self.ring.pane_ms).to(torch.int32)
        else:
            tv = ts
        state["cell_min"].scatter_reduce_(0, flat, tv, "amin")
        state["cell_max"].scatter_reduce_(0, flat, tv, "amax")
        state["cell_fired"].scatter_(0, flat, torch.zeros_like(live))
        state["cnt"].index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))

    def _scatter_session(self, state, keys, mid_cols, live, pane, ts):
        """The merge of the batch's live records into the cells.
        Generic path: ``_scatter_cells`` with three extra leaves, the
        per-cell min/max record timestamps (session boundaries) and the
        fired flag (a cell that takes a record goes dirty, so a retained
        session becomes refire-eligible)."""
        if self._sess_fast:
            return self._scatter_session_fast(state, keys, mid_cols, live,
                                              pane, ts)
        n_user = len(state["acc"])

        def combine_ext(a, b):
            ua = self.combine(tuple(a[:n_user]), tuple(b[:n_user]))
            return tuple(ua) + (
                torch.minimum(a[n_user], b[n_user]),
                torch.maximum(a[n_user + 1], b[n_user + 1]),
                a[n_user + 2] & b[n_user + 2],
            )

        batch_leaves = tuple(self.lift(mid_cols)) + (ts, ts, torch.zeros_like(live))
        leaves = list(state["acc"]) + [
            state["cell_min"], state["cell_max"], state["cell_fired"]]
        self._scatter_cells(leaves, state["cnt"], self.key_capacity(state),
                            keys, batch_leaves, live, pane, combine_ext)

    # ------------------------------------------------------------------
    # the fire
    # ------------------------------------------------------------------
    def _fire_sessions(self, state, hi: int, wm: int):
        """Fire every completed DIRTY session (at least one unfired cell:
        a never-fired run, or a retained run a late record re-dirtied),
        then mark the cells of the runs fired and clear the runs past
        their lateness retention horizon (with lateness 0 the two
        coincide and clearing wins). Returns the ``main`` stream."""
        ring = self.ring
        n, kk = ring.n_slots, self.key_capacity(state)
        cap = self.cfg.alert_capacity
        acc, cnt, cmin, cmax, cfired = self._views(state)
        link, fire, cleanup, mx = self._runs(cnt, cmin, cmax, cfired, hi, wm,
                                             self._rel_ts)
        any_fire, any_clean = (bool(v) for v in self._read(
            torch.stack([fire.any(), cleanup.any()])))
        main = {"count": 0}
        if any_fire:
            main = self._emit_sessions(state, acc, cnt, link, fire, mx, hi)
            cfired |= _slot_order(sess_ops.propagate_to_run(fire, link), hi)
        if any_clean:
            clear = _slot_order(sess_ops.propagate_to_run(cleanup, link), hi)
            mn_c, mx_c = self._clear_idents()
            cfired.masked_fill_(clear, False)
            cnt.masked_fill_(clear, 0)
            cmin.masked_fill_(clear, mn_c)
            cmax.masked_fill_(clear, mx_c)
            for a, init in zip(acc, self._sess_init_leaves()):
                a.masked_fill_(clear, init)
        return main

    def _emit_sessions(self, state, acc, cnt, link, fire, mx, hi: int) -> dict:
        """The fired sessions' rows: inclusive segmented scans of the
        accumulators and counts along the pane axis (``[O, K]`` layout),
        then the sessions compacted in pane-major order (the reference's
        ``x.T.reshape(-1)``, which the ``print()`` bytes follow) into
        ``fire_capacity`` rows, finalized and sent through the post
        chain, and compacted again into ``alert_capacity`` rows."""
        n, kk = self.ring.n_slots, self.key_capacity(state)
        cap = self.cfg.alert_capacity
        fcap = self.cfg.fire_capacity or min(kk * n, max(cap, 1 << 20))
        dev = self.device

        def comb(a, b):
            ua = self.combine(tuple(a[:-1]), tuple(b[:-1]))
            return tuple(ua) + (a[-1] + b[-1],)

        scanned = sess_ops.seg_scan_axis0(
            [_ascending(a, hi).t() for a in acc] + [_ascending(cnt, hi).t()],
            link.t(), comb)
        sess_cnt = scanned[-1]                          # [O, K]
        emit_mask = fire.t() & (sess_cnt > 0)           # pane-major
        idx, count = pane_ops.compact_positions(emit_mask.reshape(-1), fcap)
        idx = idx.to(torch.int64)
        fvalid = torch.arange(fcap, dtype=torch.int32, device=dev) < count
        fire_ovf = torch.clamp(count - fcap, min=0).to(torch.int64)
        leaves = [x.reshape(-1)[idx].to(TORCH_DTYPES[kd])
                  for x, kd in zip(scanned[:-1], self.acc_kinds)]
        if self.finalize is not None:
            leaves = [
                torch.broadcast_to(r.to(device=dev, dtype=TORCH_DTYPES[kd]), (fcap,))
                for r, kd in zip(self.finalize(tuple(leaves)), self.result_kinds)
            ]
        post_cols, post_mask = self.post_chain.apply(list(leaves), fvalid)
        k_idx = torch.remainder(idx, kk)
        o_idx = torch.div(idx, kk, rounding_mode="floor")
        key_col = self._global_key_ids(k_idx)
        end_col = mx[k_idx, o_idx] + self.gap_ms
        out_idx, n_out = pane_ops.compact_positions(post_mask & fvalid, cap)
        out_idx = out_idx.to(torch.int64)
        cols = [c[out_idx] for c in list(post_cols) + [key_col, end_col]]
        state["alert_overflow"] += fire_ovf + torch.clamp(
            n_out - cap, min=0).to(torch.int64)
        # one fire per (key, session) with content, before the post filter
        state["window_fires"] += emit_mask.sum(dtype=torch.int64)
        return {
            "count": torch.clamp(n_out, max=cap),
            "cols": tuple(cols[:-2]),
            "key": cols[-2],
            "window_end": cols[-1],
        }

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def step(self, state, cols, valid, ts, wm_lower: int):
        """One batch: ``cols`` the record's ``[B]`` tensors, ``valid``
        bool[B], ``ts`` int64[B] (event or processing time), ``wm_lower``
        the host clock's watermark floor. Returns ``(state, {"main":
        stream, "late": stream})``; the main stream's rows are the first
        ``count`` of ``cols``, ``key`` and ``window_end``, in ascending
        end pane, then key id; ``count`` is 0 (a Python int) when
        nothing fired."""
        mid_cols, mask = self._apply_pre(cols, valid)
        batch_max_t = torch.where(mask, ts, W0).max()
        # keyBy: route the records to their key's owner shard
        mid_cols, mask, ts, _ = self._exchange(mid_cols, mask, ts)
        mid_cols, key_col = self._split_key_col(mid_cols)
        keys = self._local_keys(key_col)
        pane = pane_ops.pane_of(ts, self.ring.pane_ms)
        live, late, batch_max, hi = self._admit(
            state, keys, ts, mask, pane, state["cnt"], state["cell_min"],
            state["cell_max"], self._rel_ts, batch_max_t)
        wm_old = state["wm"]
        new_max = max(state["max_ts"], batch_max)
        wm_new = max(wm_old, max(new_max - self.delay_ms, wm_lower))
        if hi > state["hi"]:
            acc, cnt_v, cmin_v, cmax_v, cfired_v = self._views(state)
            mn_c, mx_c = self._clear_idents()
            state["slot_pane"], evicted = sess_ops.session_retarget(
                acc, cnt_v, cmin_v, cmax_v, state["slot_pane"], hi, wm_old,
                self.gap_ms, self.ring, self._sess_init_leaves(),
                cell_fired=cfired_v, lateness_ms=self.allowed_lateness_ms,
                ts_base=self._rel_ts, mn_clear=mn_c, mx_clear=mx_c)
            if isinstance(evicted, torch.Tensor):
                state["evicted_unfired"] += evicted
        self._scatter_session(state, keys, mid_cols, live, pane, ts)
        main = self._fire_sessions(state, hi, wm_new)
        state.update(hi=hi, wm=wm_new, max_ts=new_max)
        return state, {"main": main,
                       "late": {"mask": late, "cols": tuple(mid_cols)}}


def _check_ring(program, state) -> None:
    """The ring metadata the step relies on: ``slot_pane`` is
    ``slot_targets(hi)``, and the cells match the ring's slots."""
    if not np.array_equal(state["slot_pane"],
                          pane_ops.slot_targets(state["hi"], program.ring)):
        raise ValueError("the reference state's slot_pane is not the ring's "
                         "targets at its head pane")
    if (state["cnt"].shape[0] - 1) % program.ring.n_slots:
        raise ValueError("the reference state's cells do not match this "
                         "program's ring")


class SessionProcessProgram(_SessionCommon, ProcessWindowProgram):
    """Session windows with a full-window ProcessWindowFunction.

    Element buffers follow ProcessWindowProgram's key-major ``[K, N,
    cap]`` layout; session boundaries follow the per-cell
    min/max-timestamp run detection of SessionWindowProgram. A run fires
    when the watermark has passed ``run_max + gap - 1`` AND the run holds
    an unfired (dirty) cell. Fired runs are MARKED (``pending_mark``) and
    horizon-passed runs scheduled for clearing (``pending_clear``) at the
    START of the next step, because the host gathers the fired elements
    from the state the step left in between (the executor evaluates the
    fires before the next step)."""

    operator_name = "session_process"
    STATE_COMPONENT_KEYS = {
        "process_buffers": ("buf", "cnt"),
        "pane_ring": ("slot_pane",),
        "session_cells": ("cell_min", "cell_max", "cell_fired",
                          "pending_mark", "pending_clear"),
    }

    accepted_kinds = ("session",)
    _CELL_KEYS = ("cell_min", "cell_max", "cell_fired", "pending_mark",
                  "pending_clear")

    def init_state(self, key_capacity: int = None) -> dict:
        state = ProcessWindowProgram.init_state(self, key_capacity)
        n, kk = self.ring.n_slots, key_capacity or self.cfg.key_capacity
        dev, size = self.device, n * kk + 1
        state["cell_min"] = torch.full((size,), TS_MAX, dtype=torch.int64, device=dev)
        state["cell_max"] = torch.full((size,), W0, dtype=torch.int64, device=dev)
        for name in ("cell_fired", "pending_mark", "pending_clear"):
            state[name] = torch.zeros((size,), dtype=torch.bool, device=dev)
        # host: whether the pending masks hold anything to apply
        state["pending"] = False
        return state

    def grow_state(self, state: dict, key_capacity: int) -> dict:
        head = self.key_capacity(state) * self.ring.n_slots
        new = ProcessWindowProgram.grow_state(self, state, key_capacity)
        fresh = self.init_state(key_capacity)
        for name in self._CELL_KEYS:
            fresh[name][:head] = state[name][:head]
            new[name] = fresh[name]
        return new

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        """Turn the reference package's session-process state (its
        process-window leaves plus ``cell_min``, ``cell_max``,
        ``cell_fired``, ``pending_mark`` and ``pending_clear``, each
        ``[K, N]``) into this program's state on its device."""
        state = ProcessWindowProgram.state_from_jax_numpy(self, state_np)
        dev = self.device
        for name, dt, sink in (("cell_min", np.int64, TS_MAX),
                               ("cell_max", np.int64, W0),
                               ("cell_fired", np.bool_, False),
                               ("pending_mark", np.bool_, False),
                               ("pending_clear", np.bool_, False)):
            a = np.asarray(state_np[name]).reshape(-1).astype(dt)
            state[name] = torch.from_numpy(np.append(a, np.asarray(sink, dt))).to(dev)
        state["pending"] = bool(np.any(state_np["pending_mark"])
                                or np.any(state_np["pending_clear"]))
        _check_ring(self, state)
        return state

    def state_to_jax_numpy(self, state: dict) -> dict:
        """The inverse of :meth:`state_from_jax_numpy` (the host
        ``pending`` flag is derived, not stored)."""
        out = ProcessWindowProgram.state_to_jax_numpy(self, state)
        n, kk = self.ring.n_slots, self.key_capacity(state)
        for name in self._CELL_KEYS:
            out[name] = to_host(state[name][:-1].view(kk, n))
        return out

    def _cell_views(self, state):
        n, kk = self.ring.n_slots, self.key_capacity(state)
        return {name: state[name][: kk * n].view(kk, n)
                for name in ("cnt",) + self._CELL_KEYS}

    def step(self, state, cols, valid, ts, wm_lower: int):
        """One batch: apply the previous step's marks and clears, the late
        test, the retarget of the cell metadata, the append of the live
        records to their element buffers and boundary planes, and the
        dirty-gated fire decision. Returns ``(state, emissions)``:
        ``process_fire`` (when a session fires: ``fire`` the count and
        the new watermark ``wm``, host values, for
        :meth:`evaluate_fires`) and ``late``."""
        mid_cols, mask = self._apply_pre(cols, valid)
        ring = self.ring
        n, gap, L = ring.n_slots, self.gap_ms, self.allowed_lateness_ms
        kk = self.key_capacity(state)
        batch_max_t = torch.where(mask, ts, W0).max()
        # keyBy: route the records to their key's owner shard
        mid_cols, mask, ts, _ = self._exchange(mid_cols, mask, ts)
        mid_cols, key_col = self._split_key_col(mid_cols)
        keys = self._local_keys(key_col)
        v = self._cell_views(state)

        # the previous step's marks and clears (the host consumed those
        # fired buffers between the steps)
        if state["pending"]:
            pm, pc = v["pending_mark"], v["pending_clear"]
            v["cell_fired"] |= pm
            v["cell_fired"].masked_fill_(pc, False)
            v["cnt"].masked_fill_(pc, 0)
            v["cell_min"].masked_fill_(pc, TS_MAX)
            v["cell_max"].masked_fill_(pc, W0)
            pm.zero_()
            pc.zero_()
            state["pending"] = False

        pane = pane_ops.pane_of(ts, ring.pane_ms)
        wm_old = state["wm"]
        live, late, batch_max, hi = self._admit(
            state, keys, ts, mask, pane, state["cnt"], state["cell_min"],
            state["cell_max"], batch_max_t=batch_max_t)
        new_max = max(state["max_ts"], batch_max)
        wm_new = max(wm_old, max(new_max - self.delay_ms, wm_lower))

        # retarget: the element buffers are read only below their cell's
        # count, so only the cell metadata is cleared
        if hi > state["hi"]:
            state["slot_pane"], evicted = sess_ops.session_retarget(
                [], v["cnt"], v["cell_min"], v["cell_max"], state["slot_pane"],
                hi, wm_old, gap, ring, [], cell_fired=v["cell_fired"],
                lateness_ms=L)
            if isinstance(evicted, torch.Tensor):
                state["evicted_unfired"] += evicted

        self._append_elements(state, keys, mid_cols, live, pane)
        live_cell = torch.where(
            live, keys.to(torch.int64) * n + torch.remainder(pane, n), kk * n)
        state["cell_min"].scatter_reduce_(0, live_cell, ts, "amin")
        state["cell_max"].scatter_reduce_(0, live_cell, ts, "amax")
        # a cell that took a record goes dirty (refire-eligible)
        state["cell_fired"].scatter_(0, live_cell, torch.zeros_like(live))

        link, fire, cleanup, _ = self._runs(
            v["cnt"], v["cell_min"], v["cell_max"], v["cell_fired"], hi, wm_new)
        n_fired, any_clean = (int(x) for x in self._read(torch.stack([
            fire.sum(dtype=torch.int64), cleanup.any().to(torch.int64)])))
        if n_fired:
            v["pending_mark"].copy_(
                _slot_order(sess_ops.propagate_to_run(fire, link), hi))
        if any_clean:
            v["pending_clear"].copy_(
                _slot_order(sess_ops.propagate_to_run(cleanup, link), hi))
        state["pending"] = bool(n_fired or any_clean)
        state.update(hi=hi, wm=wm_new, max_ts=new_max)
        emissions = {"late": {"mask": late, "cols": tuple(mid_cols)}}
        if n_fired:
            emissions["process_fire"] = {"fire": n_fired, "wm": wm_new}
        return state, emissions

    # ------------------------------------------------------------------
    def _gather_fired(self, state, fetch: Callable):
        """The cells of ``pending_mark`` with their elements, on the host:
        ``(key rows, ascending-pane positions, stored counts, min ts, max
        ts, element columns)``, cells in (key row, ascending pane) order
        and each cell's elements in arrival order. Only those cells are
        copied, in two reads: the sizes, then the cells and elements."""
        n, cap = self.ring.n_slots, self.cfg.process_buffer_capacity
        kk, hi, dev = self.key_capacity(state), state["hi"], self.device
        v = self._cell_views(state)
        fired = _ascending(v["pending_mark"], hi).reshape(-1)
        stored = _ascending(v["cnt"], hi).reshape(-1).clamp(max=cap).to(torch.int64)
        idx, n_cells = pane_ops.compact_positions(fired, kk * n)
        n_cells, total = (int(x) for x in fetch([torch.stack([
            n_cells.to(torch.int64), torch.where(fired, stored, 0).sum()])])[0])
        cells = idx[:n_cells].to(torch.int64)
        key_row = torch.div(cells, n, rounding_mode="floor")
        o = torch.remainder(cells, n)
        flat = key_row * n + torch.remainder(o + hi + 1, n)
        counts = stored[cells]
        cell = torch.repeat_interleave(
            torch.arange(n_cells, device=dev), counts, output_size=total)
        first = torch.cumsum(counts, 0) - counts
        r = torch.arange(total, device=dev) - first[cell]
        pos = flat[cell] * cap + r
        got = fetch([key_row, o, counts, state["cell_min"][flat],
                     state["cell_max"][flat]] + [b[pos] for b in state["buf"]])
        return got[:5] + [got[5:]]

    def evaluate_fires(self, state, fire_info, emit: Callable,
                       fetch: Callable) -> int:
        """Host callback: the fired cells are ``pending_mark`` (the
        device's decision; no fire predicate is derived again), split
        into sessions with the SAME boundary predicate the device uses
        (``session_links`` with numpy): two fired sessions of one key can
        sit in ADJACENT panes when their records are gap..2*gap-1 apart.
        Runs the user ProcessWindowFunction over each session's elements
        in pane, then arrival order; Flink's session TimeWindow is
        ``[min_ts, max_ts + gap)``, and each result reaches ``emit`` with
        the session's result timestamp ``max_ts + gap - 1`` and its place
        in this loop (key, session ordinal, item ordinal). Returns the
        sessions fired."""
        gap, n = self.gap_ms, self.ring.n_slots
        kinds, tables = self.mid_kinds, self.mid_tables
        key_table = self.key_table()
        n_shards = max(1, self.cfg.parallelism)
        wm = fire_info["wm"]
        key_row, o, counts, cmin, cmax, cols = self._gather_fired(state, fetch)
        values = [host_values(kd, tb, col) for kd, tb, col in zip(kinds, tables, cols)]
        items = values[0] if len(values) == 1 else [make_tuple(*x) for x in zip(*values)]
        first = np.cumsum(counts) - counts
        # the fired keys' cells as a small dense [keys, O] ring for the
        # shared boundary predicate
        keys_u, row = np.unique(key_row, return_inverse=True)
        occ = np.zeros((keys_u.size, n), dtype=bool)
        mn = np.full((keys_u.size, n), TS_MAX, dtype=np.int64)
        mx = np.full((keys_u.size, n), W0, dtype=np.int64)
        occ[row, o], mn[row, o], mx[row, o] = True, cmin, cmax
        link = sess_ops.session_links(occ, mn, mx, gap, xp=np)[row, o]
        fired = 0
        c = 0
        while c < key_row.size:
            e = c + 1
            while e < key_row.size and link[e]:
                e += 1
            # cells c..e-1 are one session
            elements = []
            for j in range(c, e):
                elements += items[first[j]:first[j] + counts[j]]
            start_ts, end_ts = int(cmin[c:e].min()), int(cmax[c:e].max())
            key_id = self._global_key_id(key_row[c])
            key_val = key_table.lookup(key_id) if key_table is not None else key_id
            fired += 1
            out = Collector()
            self.process_fn(key_val, WindowContext(start_ts, end_ts + gap, wm),
                            elements, out)
            for ii, item in enumerate(out.items):
                emit(item, key_id % n_shards, end_ts + gap - 1,
                     (key_id, fired - 1, ii))
            c = e
        return fired
