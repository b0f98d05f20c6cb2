"""Full-window ProcessWindowFunction path (PyTorch).

Counterpart of tpustream/runtime/process_program.py, after reference
chapter2/.../ComputeCpuMiddle.java:34-49: the window buffers EVERY
element, and the user function sees them all at fire. Elements are kept
on the device in fixed-capacity per-(key, slot) buffers (key-major
``[K, n_slots, cap]``, flat, with one trailing sink cell) beside their
counts ``cnt [K, n_slots]``; the ring metadata stays on the host, as in
``WindowProgram``. At a fire the device gathers the fired window's
non-empty ``(key, slot)`` cells into one compact run and the host copies
only that run, then calls the Python ``process(key, context, elements,
collector)``. This is deliberately the slow path: the reference itself
warns that process "seriously affects efficiency" on big windows
(chapter2/README.md:231).

Elements reach ``process()`` in (pane, arrival) order, the reference's
order: event-time-bucketed rather than Flink's pure arrival order;
order-insensitive functions (sort/median, the reference's use) are
unaffected.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from ..api.functions import Collector, WindowContext, as_callable
from ..api.tuples import make_tuple
from ..ops import panes as pane_ops
from ..ops.panes import W0
from ..ops.segments import segment_ranks, segment_tails, sort_by_key
from ..records import BOOL, F64, NUMPY_DTYPES, STR
from .device import TORCH_DTYPES
from ..utils.tree import to_host
from .step import BaseProgram, host_leaves, no_exchange
from .window_program import WindowProgram, _dirty

COUNTERS = ("evicted_unfired", "buffer_overflow", "late_dropped")


def host_values(kind, table, col: np.ndarray) -> list:
    """Decode a fetched column of stored device values back to Python
    values (the reference's ``host_value``, a column at a time)."""
    if kind == STR:
        return [table.lookup(i) if i >= 0 else None for i in col.tolist()]
    if kind == F64:
        return col.astype(np.float64).tolist()
    if kind == BOOL:
        return col.astype(bool).tolist()
    return col.astype(np.int64).tolist()


class ProcessWindowProgram(WindowProgram):
    """Shares the watermark, ring and late machinery of WindowProgram but
    stores raw elements and leaves evaluation to the host. A step emits
    no ``main`` stream: :meth:`evaluate_fires` gathers the fired
    elements from the state the step left, so the executor calls it
    before the next step."""

    operator_name = "process_window"
    # [K, N, cap] buffers and [K, N] counts shard on the key axis by
    # rank, not as WindowProgram's flat planes do
    key_sharded_leaves = BaseProgram.key_sharded_leaves
    # leading-key leaves rescale and grow with the base restack, not the
    # window's flat word planes
    rescale_key_leaf = BaseProgram.rescale_key_leaf
    grow_key_leaf = BaseProgram.grow_key_leaf
    STATE_COMPONENT_KEYS = {
        "process_buffers": ("buf", "cnt"),
        "pane_ring": ("slot_pane",),
    }

    host_evaluated = True
    # evaluate_fires reads the window buffers the step left
    emissions_reference_state = True

    def _build_agg(self) -> None:
        # no incremental aggregation: the accumulators ARE the buffers
        self.acc_kinds = list(self.mid_kinds)
        self.result_kinds = list(self.mid_kinds)
        self.result_tables = list(self.mid_tables)
        self.lift = list
        self.combine = None
        self.finalize = None
        self.process_fn = as_callable(self.plan.stateful.apply_fn, "process")

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def key_capacity(self, state) -> int:
        return (state["cnt"].shape[0] - 1) // self.ring.n_slots

    def init_state(self, key_capacity: int = None) -> dict:
        """Flat key-major element buffers (one per record leaf) and
        per-cell counts, each with a trailing sink cell, host ring
        metadata and device counters. ``cnt`` counts every element a
        cell took, also those past ``process_buffer_capacity``."""
        n, kk = self.ring.n_slots, key_capacity or self.cfg.key_capacity
        cap = self.cfg.process_buffer_capacity
        self._check_cells(kk)
        dev = self.device
        state = {
            "buf": [
                torch.zeros((kk * n * cap + 1,), dtype=TORCH_DTYPES[kd], device=dev)
                for kd in self.acc_kinds
            ],
            "cnt": torch.zeros((kk * n + 1,), dtype=torch.int32, device=dev),
            "slot_pane": pane_ops.slot_targets(-1, self.ring),
            "hi": -1,
            "wm": W0,
            "max_ts": W0,
        }
        for name in COUNTERS:
            state[name] = torch.zeros((), dtype=torch.int64, device=dev)
        return self._with_rules(state)

    def grow_state(self, state: dict, key_capacity: int) -> dict:
        """The same state at a larger ``key_capacity``: the layout is
        key-major and interned key ids are stable, so the old keys' cells
        are the new buffers' head."""
        n, cap = self.ring.n_slots, self.cfg.process_buffer_capacity
        k_old = self.key_capacity(state)
        new = self.init_state(key_capacity)
        for dst, src in zip(new["buf"], state["buf"]):
            dst[: k_old * n * cap] = src[: k_old * n * cap]
        new["cnt"][: k_old * n] = state["cnt"][: k_old * n]
        for name, v in state.items():
            if name not in ("buf", "cnt"):
                new[name] = v
        return new

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        """Turn the reference package's process-window state (numpy
        ``buf`` leaves of ``[K, n_slots, cap]``, ``cnt [K, n_slots]``,
        ``slot_pane`` and the scalar leaves,
        tpustream/runtime/process_program.py init_state) into this
        program's state on its device."""
        dev = self.device

        def flat(a, dtype):
            a = np.asarray(a).reshape(-1).astype(dtype)
            return torch.from_numpy(np.append(a, np.zeros(1, dtype))).to(dev)

        state = {
            "buf": [
                flat(b, NUMPY_DTYPES[kd])
                for b, kd in zip(state_np["buf"], self.acc_kinds)
            ],
            "cnt": flat(state_np["cnt"], np.int32),
            "slot_pane": np.asarray(state_np["slot_pane"], np.int64).copy(),
        }
        for name in ("hi", "wm", "max_ts"):
            state[name] = int(state_np[name])
        for name in COUNTERS:
            state[name] = torch.tensor(
                int(state_np[name]), dtype=torch.int64, device=dev
            )
        if state["buf"][0].shape[0] - 1 != (
            self.key_capacity(state) * self.ring.n_slots
            * self.cfg.process_buffer_capacity
        ):
            raise ValueError(
                "the reference state's buffers do not match this program's "
                "ring and process_buffer_capacity"
            )
        return self._rules_from_jax_numpy(state, state_np)

    def state_to_jax_numpy(self, state: dict) -> dict:
        """The inverse of :meth:`state_from_jax_numpy`: ``buf`` as
        ``[K, n_slots, cap]`` and ``cnt`` as ``[K, n_slots]`` (sink cells
        dropped), the host ring metadata as int64 leaves, and the
        reference's ``exchange_overflow``."""
        n, cap = self.ring.n_slots, self.cfg.process_buffer_capacity
        kk = self.key_capacity(state)
        out = host_leaves(state, ("hi", "wm", "max_ts", "slot_pane") + COUNTERS)
        out["buf"] = [to_host(b[:-1].view(kk, n, cap)) for b in state["buf"]]
        out["cnt"] = to_host(state["cnt"][:-1].view(kk, n))
        out["exchange_overflow"] = no_exchange()
        return self._rules_to_jax_numpy(state, out)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _append_elements(self, state, keys, mid_cols, live, pane):
        """Append the batch's live records to their (key, slot) element
        buffers: sort by cell, rank within cell, write at ``cnt + rank``
        (a record past ``process_buffer_capacity`` is counted in
        ``buffer_overflow``, never written). Returns, under allowed
        lateness, bool ``[n_slots]``: the slots that took a record; else
        None."""
        n, cap = self.ring.n_slots, self.cfg.process_buffer_capacity
        kk = self.key_capacity(state)
        cnt = state["cnt"]
        slot = torch.remainder(pane, n)
        cell = keys.to(torch.int64) * n + slot
        perm, sc, sv, seg_starts = sort_by_key(cell, live, max_key=kk * n)
        rank = segment_ranks(seg_starts).to(torch.int64)
        cell_sorted = sc.clamp(0, kk * n - 1).to(torch.int64)
        write_pos = cnt[cell_sorted].to(torch.int64) + rank
        fits = sv & (write_pos < cap)
        flat_idx = torch.where(fits, cell_sorted * cap + write_pos, kk * n * cap)
        for b, c in zip(state["buf"], mid_cols):
            b.scatter_(0, flat_idx, c[perm].to(b.dtype))
        state["buffer_overflow"] += (sv & ~fits).sum(dtype=torch.int64)
        tails = segment_tails(seg_starts) & sv
        cnt.index_add_(
            0, torch.where(tails, cell_sorted, kk * n),
            torch.where(tails, rank + 1, 0).to(torch.int32),
        )
        if self.allowed_lateness_ms <= 0:
            return None
        touched = torch.zeros(n + 1, dtype=torch.bool, device=live.device)
        touched.index_fill_(0, torch.where(live, slot, n).to(torch.int64), True)
        return touched[:n]

    def step(self, state, cols, valid, ts, wm_lower: int):
        """One batch: append its live records, advance the clock and the
        ring, and name the windows that fire. Returns ``(state,
        emissions)``: ``process_fire`` (when a window fires: ``fire``,
        ``ends``, ``cand`` over the fire candidates and the new
        watermark ``wm``, all host values, for :meth:`evaluate_fires`)
        and ``late`` (the rows late past the allowed lateness)."""
        mid_cols, mask = self._apply_pre(cols, valid)
        ring = self.ring
        n, g, p_win = ring.n_slots, ring.pane_ms, ring.panes_per_window
        kk = self.key_capacity(state)
        batch_max_t = torch.where(mask, ts, W0).max()
        # keyBy: route the records to their key's owner shard
        mid_cols, mask, ts, _ = self._exchange(mid_cols, mask, ts)
        mid_cols, key_col = self._split_key_col(mid_cols)
        keys = self._local_keys(key_col)

        wm_old = state["wm"]
        late = pane_ops.late_mask(ts, wm_old, self.allowed_lateness_ms, ring) & mask
        live = mask & ~late
        pane = pane_ops.pane_of(ts, g)
        if self.count_late_as_dropped:
            state["late_dropped"] += late.sum(dtype=torch.int64)
        batch_max, batch_hi, max_key = (
            int(v) for v in self._read(torch.stack([
                batch_max_t,
                torch.where(live, pane, -1).max(),
                torch.where(live, keys.to(torch.int64), -1).max(),
            ]))
        )
        batch_max = self._global_max(batch_max)
        batch_hi = self._global_max(batch_hi)
        if max_key >= kk:
            raise IndexError(
                f"a record carried key id {max_key}, past the window "
                f"state's key capacity of {kk}"
            )
        new_max = max(state["max_ts"], batch_max)
        wm_new = max(wm_old, max(new_max - self.delay_ms, wm_lower))
        hi = max(state["hi"], batch_hi)

        # coverage guard: a record below the ring's new coverage would
        # alias mod N into another pane's slot; it is dropped and counted
        # (full-window fires read post-step state, so no sweep here)
        uncov = live & (pane <= hi - n)
        live = live & ~uncov
        state["evicted_unfired"] += uncov.sum(dtype=torch.int64)
        # retarget: clear the counts of stale slots (a buffer is read only
        # below its cell's count, so its elements need no clearing)
        cnt_rows = state["cnt"][: kk * n].view(kk, n).t()
        _, _, slot_pane, evicted = pane_ops.retarget_rows(
            [], cnt_rows, state["slot_pane"], hi, wm_old, ring, [])
        if isinstance(evicted, torch.Tensor):
            state["evicted_unfired"] += evicted
        state["slot_pane"] = slot_pane
        touched = self._append_elements(state, keys, mid_cols, live, pane)

        f = ring.n_fire_candidates
        cand = hi - n + 1 + np.arange(f, dtype=np.int64)
        ends = (cand + 1) * g
        aligned = np.mod(ends, ring.slide_ms) == 0
        fire = aligned & (ends - 1 <= wm_new) & (ends - 1 > wm_old)
        if touched is not None:
            may_refire = (aligned & (ends - 1 <= wm_old)
                          & (ends - 1 + self.allowed_lateness_ms > wm_old))
            if may_refire.any():
                wrote = self._read(touched).astype(bool)
                # refires are shard-agreed: a dirty pane on any shard
                # refires the candidate everywhere (fire stays the same
                # on every shard)
                dirty = self._global_max(_dirty(slot_pane, wrote, cand, p_win))
                fire = fire | (may_refire & dirty)
        state.update(hi=hi, wm=wm_new, max_ts=new_max)
        emissions = {"late": {"mask": late, "cols": tuple(mid_cols)}}
        if fire.any():
            emissions["process_fire"] = {
                "fire": fire, "ends": ends, "cand": cand, "wm": wm_new,
            }
        return state, emissions

    # ------------------------------------------------------------------
    # host-side window evaluation
    # ------------------------------------------------------------------
    def _gather_window(self, state, slots: List[int], fetch: Callable):
        """The elements of one window, key by key: ``(key ids, elements a
        key, columns)`` on the host, keys ascending and each key's
        elements in (slot order given, arrival) order. Only the non-empty
        cells' stored elements are copied, in two reads: the sizes, then
        the elements."""
        n, cap = self.ring.n_slots, self.cfg.process_buffer_capacity
        kk = self.key_capacity(state)
        dev = self.device
        sl = torch.tensor(slots, dtype=torch.int64, device=dev)
        m = len(slots)
        stored = (state["cnt"][: kk * n].view(kk, n).index_select(1, sl)
                  .clamp(max=cap).to(torch.int64))  # [K, m]
        per_key = stored.sum(dim=1)
        idx, n_keys = pane_ops.compact_positions(per_key > 0, kk)
        n_keys, total = (int(v) for v in fetch(
            [torch.stack([n_keys.to(torch.int64), per_key.sum()])])[0])
        keys = idx[:n_keys].to(torch.int64)
        counts = stored[keys].reshape(-1)
        cell = torch.repeat_interleave(
            torch.arange(counts.shape[0], device=dev), counts,
            output_size=total)
        first = torch.cumsum(counts, 0) - counts
        r = torch.arange(total, device=dev) - first[cell]
        pos = (keys[cell // m] * n + sl[cell % m]) * cap + r
        got = fetch([keys, per_key[keys]] + [b[pos] for b in state["buf"]])
        return got[0], got[1], got[2:]

    def fired_windows(self, state, fire_info, fetch: Callable) -> dict:
        """``{candidate index: slots}`` of the windows that fire and hold
        an element here, in candidate order (one read: a slot without an
        element adds nothing to a window)."""
        ring = self.ring
        n, p_win = ring.n_slots, ring.panes_per_window
        slot_pane = state["slot_pane"]
        kk = self.key_capacity(state)
        (occupied,) = fetch([(state["cnt"][: kk * n].view(kk, n) > 0).any(dim=0)])
        out = {}
        for j in np.flatnonzero(fire_info["fire"]):
            c = int(fire_info["cand"][j])
            slots = [q % n for q in range(c - p_win + 1, c + 1)
                     if slot_pane[q % n] == q and occupied[q % n]]
            if slots:
                out[int(j)] = slots
        return out

    def evaluate_window(self, state, fire_info, j: int, slots, emit: Callable,
                        fetch: Callable) -> int:
        """Fire candidate ``j``'s window over ``slots``: each key's
        elements through the user function, keys ascending. Returns the
        (key, window) invocations."""
        ring = self.ring
        kinds, tables = self.mid_kinds, self.mid_tables
        key_table = self.key_table()
        n_shards = max(1, self.cfg.parallelism)
        wm, end = fire_info["wm"], int(fire_info["ends"][j])
        key_rows, per_key, cols = self._gather_window(state, slots, fetch)
        values = [host_values(kd, tb, col)
                  for kd, tb, col in zip(kinds, tables, cols)]
        items = values[0] if len(values) == 1 else [
            make_tuple(*v) for v in zip(*values)]
        off = 0
        fired = 0
        for key_row, k_n in zip(key_rows.tolist(), per_key.tolist()):
            elements, off = items[off:off + k_n], off + k_n
            key_id = self._global_key_id(key_row)
            key_val = (key_table.lookup(key_id) if key_table is not None
                       else key_id)
            ctx = WindowContext(end - ring.size_ms, end, wm)
            fired += 1
            out = Collector()
            self.process_fn(key_val, ctx, elements, out)
            for ii, item in enumerate(out.items):
                emit(item, key_id % n_shards, end - 1,
                     (int(j), self._row_offset(self.key_capacity(state))
                      + key_row, ii))
        return fired

    def evaluate_fires(self, state, fire_info, emit: Callable,
                       fetch: Callable) -> int:
        """Host callback: gather each fired window's elements, run the
        user ProcessWindowFunction and hand each result it collects to
        ``emit(item, subtask, ts, order)`` (which runs the window's post
        ops): ``ts`` is Flink's window result timestamp ``end - 1``, which
        a chained stage consumes, and ``order`` the result's place in
        this evaluation loop (fire candidate, key row, item ordinal).
        ``fetch(tensors)`` copies device tensors to the host with one
        wait.

        Returns the (key, window) invocations, the ``window_fires``
        count."""
        fired = 0
        for j, slots in self.fired_windows(state, fire_info, fetch).items():
            fired += self.evaluate_window(state, fire_info, j, slots, emit,
                                          fetch)
        return fired
