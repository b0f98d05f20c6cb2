"""Count windows (PyTorch).

Counterpart of tpustream/runtime/count_program.py. Flink's
``countWindow(size)`` (named alongside the reference's window taxonomy,
chapter3/README.md:35-41) fires per key every ``size`` elements in
arrival order; partial windows never fire, not even at end of stream.
``countWindow(size, slide)`` is CountTrigger.of(slide) over a
GlobalWindow with CountEvictor.of(size): a fire at every ``slide``-th
element of a key over its most recent ``min(size, seen)`` elements.

* :class:`CountWindowProgram` (tumbling ``reduce``/``aggregate``): no
  element buffers; the accumulator folds in batch order with a sort by
  key and a segmented scan that restarts wherever a key's running
  element index crosses a multiple of ``size``, the stored partial
  folded into the key's first window, and ``acc``/``cnt`` written at
  segment tails.
* :class:`SlidingCountWindowProgram` and :class:`CountProcessProgram`
  keep the last ``size`` elements per key in a ``[K, size]`` circular
  element log and a per-key element total, written with one
  unique-index scatter a leaf (the last writer per (key, slot) wins).

No clock, no pane ring, no lateness. Emissions come back in arrival
order: the rows are put back from the sorted order on the device with
the inverse permutation (the reference leaves that to the host). Keyed
state is ``[K + 1]`` / ``[(K + 1) * size]`` with a trailing sink row
that masked rows of a scatter write to.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..api.functions import Collector, WindowContext, as_callable
from ..api.tuples import make_tuple
from ..ops import panes as pane_ops
from ..ops.segments import (
    inverse_permutation,
    segment_ranks,
    segment_tails,
    segmented_scan,
    sort_by_key,
)
from ..records import NUMPY_DTYPES
from .device import TORCH_DTYPES, DeviceChain
from .plan import JobPlan
from .process_program import host_values
from ..utils.tree import to_host
from .step import BaseProgram, host_leaves, no_exchange
from .window_program import WindowProgram


class CountWindowProgram(WindowProgram):
    """Borrows WindowProgram's aggregation plumbing (``_build_agg``: lift
    / combine / finalize over leaf tuples) but none of its time
    machinery."""

    operator_name = "count_window"
    # no pane ring: count state is per-key accumulators + open counts
    STATE_COMPONENT_KEYS = {"count_acc": ("acc", "cnt")}
    # the reference's count state shards as the rolling state does
    KEY_AXIS_MIN_NDIM = 1
    key_sharded_leaves = BaseProgram.key_sharded_leaves
    # leading-key leaves rescale and grow with the base restack, not the
    # window's flat word planes
    rescale_key_leaf = BaseProgram.rescale_key_leaf
    grow_key_leaf = BaseProgram.grow_key_leaf

    fires_on_clock = False
    main_emission_prefix = False  # a mask selects the rows

    def __init__(self, plan: JobPlan, cfg):
        BaseProgram.__init__(self, plan, cfg)
        st = plan.stateful
        self.key_pos = plan.key_pos
        # acc_dtype does not apply: the reference's count programs keep
        # every accumulator leaf at its kind's dtype under any acc_dtype
        self.apply_kind = st.apply_kind
        self.count_n = int(st.window.count)
        if self.count_n < 1:
            raise ValueError(f"count_window size must be >= 1, got {st.window.count}")
        self._build_agg()
        if self.apply_kind == "process":
            # the user function and the post ops run on the host
            self.post_chain = None
            self.out_kinds = list(self.result_kinds)
            self.out_tables = list(self.result_tables)
        else:
            self.post_chain = DeviceChain(
                plan.device_post, self.result_kinds, self.result_tables
            )
            self.out_kinds = self.post_chain.out_kinds
            self.out_tables = self.post_chain.out_tables
        # rows whose key id passed the state's capacity, counted on the
        # device; the Runner reads it with each step's fetch
        self.bad_keys = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.host_reads = 0  # the step reads nothing back itself

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def key_capacity(self, state) -> int:
        return state["cnt"].shape[0] - 1

    def init_state(self, key_capacity: int = None) -> dict:
        """Typed per-key accumulator leaves and the open window's element
        count, each ``[K + 1]``."""
        kk, dev = key_capacity or self.cfg.key_capacity, self.device
        return self._with_rules({
            "acc": [torch.zeros((kk + 1,), dtype=TORCH_DTYPES[kd], device=dev)
                    for kd in self.acc_kinds],
            "cnt": torch.zeros((kk + 1,), dtype=torch.int32, device=dev),
            "window_fires": torch.zeros((), dtype=torch.int64, device=dev),
        })

    def grow_state(self, state: dict, key_capacity: int) -> dict:
        """The same state at a larger ``key_capacity``: interned key ids
        are stable, so the old keys' rows are the new leaves' head."""
        return _grow_rows(self, state, key_capacity, ("acc", "cnt"))

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        """Turn the reference package's count state (numpy ``acc`` leaves
        and ``cnt`` of ``[K]``, ``window_fires``,
        tpustream/runtime/count_program.py init_state) into this
        program's state on its device."""
        dev = self.device
        return self._rules_from_jax_numpy({
            "acc": [_with_sink(a, NUMPY_DTYPES[kd], dev)
                    for a, kd in zip(state_np["acc"], self.acc_kinds)],
            "cnt": _with_sink(state_np["cnt"], np.int32, dev),
            "window_fires": torch.tensor(int(state_np["window_fires"]),
                                         dtype=torch.int64, device=dev),
        }, state_np)

    # the per-key leaves (a sink row each) and the scalar leaves
    _ROW_KEYS, _SCALAR_KEYS = ("acc", "cnt"), ("window_fires",)

    def state_to_jax_numpy(self, state: dict) -> dict:
        """The inverse of :meth:`state_from_jax_numpy`: the per-key
        leaves without their sink row, and the reference's
        ``exchange_overflow``."""
        out = host_leaves(state, self._SCALAR_KEYS)
        for name in self._ROW_KEYS:
            v = state[name]
            out[name] = ([to_host(a[:-1]) for a in v] if isinstance(v, list)
                         else to_host(v[:-1]))
        out["exchange_overflow"] = no_exchange()
        return self._rules_to_jax_numpy(state, out)

    def _sorted(self, keys, mask, kk: int):
        """The batch sorted by key (arrival order within a key), with the
        key rows clamped for gathers, and rows past the capacity counted
        in ``bad_keys``."""
        perm, sk, sv, seg_starts = sort_by_key(keys, mask, max_key=kk)
        self.bad_keys += (sv & (sk >= kk)).sum(dtype=torch.int32)
        safe_sk = torch.where(sv, sk, 0).clamp(0, kk - 1).to(torch.int64)
        return perm, sk, sv, seg_starts, safe_sk

    def _main(self, post_cols, post_mask, perm, safe_sk) -> dict:
        """The step's output stream, put back in arrival order."""
        inv = inverse_permutation(perm)
        n_shards = max(1, self.cfg.parallelism)
        return {
            "mask": post_mask[inv],
            "cols": tuple(c[inv] for c in post_cols),
            "subtask": (self._global_key_ids(safe_sk) % n_shards)[inv],
            "bad_keys": self.bad_keys,
        }

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def step(self, state, cols, valid, ts=None, wm_lower=None):
        """One batch: ``cols`` the record's ``[B]`` tensors, ``valid``
        bool[B] (no clock: ``ts`` and ``wm_lower`` are ignored). Returns
        ``(state, {"main": stream})``; the stream's rows are in arrival
        order, ``mask`` the records that closed a window."""
        mid_cols, mask = self._apply_pre(cols, valid)
        # keyBy: route the records to their key's owner shard
        mid_cols, mask, ts, _ = self._exchange(mid_cols, mask, ts)
        mid_cols, key_col = self._split_key_col(mid_cols)
        keys = self._local_keys(key_col)
        kk, N = self.key_capacity(state), self.count_n

        perm, sk, sv, seg_starts, safe_sk = self._sorted(keys, mask, kk)
        lifted = list(self.lift([c[perm] for c in mid_cols]))
        rank = segment_ranks(seg_starts)
        prev = state["cnt"][safe_sk]             # open-window count, 0..N-1
        tot = prev + rank                        # element's window position

        # a window OPENS wherever the position crosses a multiple of N:
        # restart the scan there so each (key, window) is its own segment
        win_start = torch.remainder(tot, N) == 0
        scan = segmented_scan(tuple(lifted), seg_starts | win_start, self.combine)
        # the key's first window this batch continues the stored partial
        stored = tuple(a[safe_sk] for a in state["acc"])
        folded_all = self.combine(stored, scan)
        fold = (tot < N) & (prev > 0) & sv
        folded = tuple(torch.where(fold, f, s) for f, s in zip(folded_all, scan))

        closes = (torch.remainder(tot + 1, N) == 0) & sv
        results = self._finalize(folded, sv.shape[0])
        post_cols, post_mask = self.post_chain.apply(results, closes)

        # per-key tail writes back the (possibly reset) accumulator; a
        # tail that exactly closed its window leaves cnt == 0, which
        # marks the stale acc value as empty
        tails = segment_tails(seg_starts) & sv & (sk < kk)
        idx = torch.where(tails, sk, kk).to(torch.int64)
        for a, f in zip(state["acc"], folded):
            a.scatter_(0, idx, f.to(a.dtype))
        state["cnt"].scatter_(0, idx, torch.remainder(tot + 1, N).to(torch.int32))
        state["window_fires"] += closes.sum(dtype=torch.int64)
        return state, {"main": self._main(post_cols, post_mask, perm, safe_sk)}

    def _finalize(self, leaves, b: int) -> list:
        """The window results of accumulator leaves, as ``[b]`` columns."""
        if self.finalize is None:
            return [x.to(TORCH_DTYPES[k]) for x, k in zip(leaves, self.result_kinds)]
        return [
            torch.broadcast_to(r.to(device=self.device, dtype=TORCH_DTYPES[k]), (b,))
            for r, k in zip(self.finalize(tuple(leaves)), self.result_kinds)
        ]


def _with_sink(a, dtype, dev) -> torch.Tensor:
    """A reference ``[K, ...]`` leaf with one zero sink row appended."""
    a = np.asarray(a).astype(dtype)
    sink = np.zeros((1,) + a.shape[1:], dtype)
    return torch.from_numpy(np.concatenate([a, sink])).to(dev)


def _grow_rows(program, state, key_capacity: int, keyed) -> dict:
    """``state`` at a larger key capacity: every keyed leaf's first
    ``K`` rows (of its leading key axis) carried over; the rest fresh."""
    k_old = program.key_capacity(state)
    new = program.init_state(key_capacity)
    for name in keyed:
        dsts = new[name] if isinstance(new[name], list) else [new[name]]
        srcs = state[name] if isinstance(state[name], list) else [state[name]]
        for dst, src in zip(dsts, srcs):
            dst[:k_old] = src[:k_old]
    for name, v in state.items():
        if name not in keyed:
            new[name] = v
    return new


class _ElementLogMixin:
    _ROW_KEYS = ("ebuf", "tot")
    # the circular element log dominates these variants' footprint
    STATE_COMPONENT_KEYS = {"element_log": ("ebuf", "tot")}
    """The count-window variants that need the last ``size`` elements
    per key (sliding reduce/aggregate, and process): a per-key circular
    element log ``[K + 1, size]`` plus a per-key total element count,
    updated with ONE unique-index scatter per leaf (the last writer per
    (key, slot) wins when a batch wraps the log)."""

    def key_capacity(self, state) -> int:
        return state["tot"].shape[0] - 1

    def _init_log(self, key_capacity: int = None) -> dict:
        kk, n, dev = key_capacity or self.cfg.key_capacity, self.count_n, self.device
        return {
            "ebuf": [torch.zeros((kk + 1, n), dtype=TORCH_DTYPES[kd], device=dev)
                     for kd in self.acc_kinds],
            "tot": torch.zeros((kk + 1,), dtype=torch.int64, device=dev),
        }

    def grow_state(self, state: dict, key_capacity: int) -> dict:
        return _grow_rows(self, state, key_capacity, ("ebuf", "tot"))

    def _log_from_jax_numpy(self, state_np: dict) -> dict:
        dev = self.device
        return {
            "ebuf": [_with_sink(a, NUMPY_DTYPES[kd], dev)
                     for a, kd in zip(state_np["ebuf"], self.acc_kinds)],
            "tot": _with_sink(state_np["tot"], np.int64, dev),
        }

    def _sorted_batch(self, state, keys, mask) -> dict:
        """Sort the batch by key and derive each record's global per-key
        element index: the per-row tensors the fire and log-update steps
        share."""
        kk = self.key_capacity(state)
        perm, sk, sv, seg_starts, safe_sk = self._sorted(keys, mask, kk)
        rank = segment_ranks(seg_starts)                    # int32
        prev = state["tot"][safe_sk]                        # int64
        b = sv.shape[0]
        pos = torch.arange(b, dtype=torch.int32, device=sv.device)
        seg_first = torch.cummax(torch.where(seg_starts, pos, 0), dim=0).values
        # position of each row's segment END (for last-writer detection)
        rev_start = torch.flip(segment_tails(seg_starts), [0])
        rev_first = torch.cummax(torch.where(rev_start, pos, 0), dim=0).values
        seg_last = (b - 1) - torch.flip(rev_first, [0])
        return dict(perm=perm, sk=sk, sv=sv, seg_starts=seg_starts,
                    safe_sk=safe_sk, prev=prev, idx=prev + rank,
                    seg_first=seg_first, seg_last=seg_last, pos=pos, K=kk)

    def _element_at(self, sb, log_leaves, batch_leaves, e):
        """Value of element index ``e`` (per-row int64): from the sorted
        batch when ``e >= prev`` (it arrived this step), else from the
        circular log. Rows whose ``e`` is not a valid index read clamped
        garbage that the caller does not use."""
        N = self.count_n
        b = sb["sv"].shape[0]
        in_batch = e >= sb["prev"]
        bpos = (sb["seg_first"] + (e - sb["prev"]).to(torch.int32)).clamp(0, b - 1)
        flat = sb["safe_sk"] * N + torch.remainder(e.clamp(min=0), N)
        return tuple(
            torch.where(in_batch, bl[bpos.to(torch.int64)], lg.reshape(-1)[flat])
            for bl, lg in zip(batch_leaves, log_leaves)
        )

    def _update_log(self, state, sb, batch_leaves) -> None:
        """Write the batch into the circular log IN PLACE (the last writer
        per (key, slot) wins: writers to one residue sit exactly ``size``
        apart in the sorted order) and advance the per-key totals."""
        N, kk = self.count_n, sb["K"]
        ok = sb["sv"] & (sb["sk"] < kk)
        is_last = ok & (sb["pos"] + N > sb["seg_last"])
        flat_idx = torch.where(is_last, sb["safe_sk"] * N + torch.remainder(sb["idx"], N),
                               kk * N)
        for lg, bl in zip(state["ebuf"], batch_leaves):
            lg.view(-1).scatter_(0, flat_idx, bl.to(lg.dtype))
        tails = segment_tails(sb["seg_starts"]) & ok
        state["tot"].scatter_(0, torch.where(tails, sb["sk"], kk).to(torch.int64),
                              sb["idx"] + 1)


class SlidingCountWindowProgram(_ElementLogMixin, CountWindowProgram):
    """``count_window(size, slide)`` with incremental reduce/aggregate.
    Sliding count windows overlap, so the accumulator cannot be folded
    destructively: each fire folds its ``min(size, seen)`` most recent
    elements from the circular log and the current sorted batch, oldest
    first, in ``size`` steps of the user combiner over ``[B]`` lanes (a
    Python loop where the reference runs a ``lax.scan``)."""

    operator_name = "sliding_count_window"

    def __init__(self, plan: JobPlan, cfg):
        super().__init__(plan, cfg)
        self.count_slide = int(plan.stateful.window.count_slide)
        if self.count_slide < 1:
            raise ValueError(f"count_window slide must be >= 1, got {self.count_slide}")

    def init_state(self, key_capacity: int = None) -> dict:
        state = self._init_log(key_capacity)
        state["window_fires"] = torch.zeros((), dtype=torch.int64, device=self.device)
        return self._with_rules(state)

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        state = self._log_from_jax_numpy(state_np)
        state["window_fires"] = torch.tensor(int(state_np["window_fires"]),
                                             dtype=torch.int64, device=self.device)
        return self._rules_from_jax_numpy(state, state_np)

    def step(self, state, cols, valid, ts=None, wm_lower=None):
        mid_cols, mask = self._apply_pre(cols, valid)
        # keyBy: route the records to their key's owner shard
        mid_cols, mask, ts, _ = self._exchange(mid_cols, mask, ts)
        mid_cols, key_col = self._split_key_col(mid_cols)
        keys = self._local_keys(key_col)
        N, S = self.count_n, self.count_slide

        sb = self._sorted_batch(state, keys, mask)
        lifted = list(self.lift([c[sb["perm"]] for c in mid_cols]))
        idx, sv = sb["idx"], sb["sv"]
        fire = (torch.remainder(idx + 1, S) == 0) & sv

        # fold the window, oldest element first: j counts back from the
        # fire element, so element index e = idx - j; j <= idx bounds the
        # window at min(size, idx+1) elements
        b, dev = sv.shape[0], sv.device
        has = torch.zeros((b,), dtype=torch.bool, device=dev)
        acc = tuple(torch.zeros((b,), dtype=TORCH_DTYPES[kd], device=dev)
                    for kd in self.acc_kinds)
        for j in range(N - 1, -1, -1):
            e = idx - j
            include = (j <= idx) & sv
            vals = self._element_at(sb, state["ebuf"], lifted, e)
            merged = self.combine(acc, vals)
            acc = tuple(
                torch.where(include & has, m, torch.where(include, v, a))
                for m, v, a in zip(merged, vals, acc)
            )
            has = has | include

        results = self._finalize(acc, b)
        post_cols, post_mask = self.post_chain.apply(results, fire)
        self._update_log(state, sb, lifted)
        state["window_fires"] += fire.sum(dtype=torch.int64)
        return state, {"main": self._main(post_cols, post_mask, sb["perm"],
                                          sb["safe_sk"])}


class CountProcessProgram(_ElementLogMixin, CountWindowProgram):
    """``count_window(size[, slide]).process(fn)``: a full-window
    function over the last ``min(size, seen)`` elements at every
    ``slide``-th element of a key (chapter2/README.md:177-196's contract
    on the count taxonomy of chapter3/README.md:4).

    The fired windows' elements are gathered on the device into ``[F,
    size]`` element matrices (``F`` = ``fire_capacity`` or the batch
    size) that ride the emission; the host reads their count once and
    copies only that prefix."""

    operator_name = "count_process"

    host_evaluated = True

    def _build_agg(self) -> None:
        # no incremental aggregation: the "accumulator" is the raw record
        self.acc_kinds = list(self.mid_kinds)
        self.result_kinds = list(self.mid_kinds)
        self.result_tables = list(self.mid_tables)
        self.lift = list
        self.combine = None
        self.finalize = None
        self.process_fn = as_callable(self.plan.stateful.apply_fn, "process")

    def __init__(self, plan: JobPlan, cfg):
        super().__init__(plan, cfg)
        self.count_slide = int(plan.stateful.window.count_slide)
        if self.count_slide < 1:
            raise ValueError(f"count_window slide must be >= 1, got {self.count_slide}")
        # the exact bound is the batch size; fire_capacity can shrink the
        # [F, size] element matrices (overflow counted)
        b = cfg.batch_size
        self.fire_rows = min(b, cfg.fire_capacity or b)

    def init_state(self, key_capacity: int = None) -> dict:
        # window fires are counted on the host in evaluate_fires
        state = self._init_log(key_capacity)
        state["alert_overflow"] = torch.zeros((), dtype=torch.int64, device=self.device)
        return self._with_rules(state)

    _SCALAR_KEYS = ("alert_overflow",)

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        state = self._log_from_jax_numpy(state_np)
        state["alert_overflow"] = torch.tensor(int(state_np["alert_overflow"]),
                                               dtype=torch.int64, device=self.device)
        return self._rules_from_jax_numpy(state, state_np)

    def step(self, state, cols, valid, ts=None, wm_lower=None):
        """One batch. Returns ``(state, {"process_fire": fires})``:
        ``count`` (fired windows, a device int32, at most ``F`` of them
        stored), ``elems`` (``[F, size]`` per record leaf, oldest element
        first), ``m`` (each window's element count), ``key`` and ``arr``
        (the closing record's arrival position), for
        :meth:`evaluate_fires`."""
        mid_cols, mask = self._apply_pre(cols, valid)
        # keyBy: route the records to their key's owner shard
        mid_cols, mask, ts, _ = self._exchange(mid_cols, mask, ts)
        mid_cols, key_col = self._split_key_col(mid_cols)
        keys = self._local_keys(key_col)
        N, S = self.count_n, self.count_slide

        sb = self._sorted_batch(state, keys, mask)
        sorted_cols = [c[sb["perm"]] for c in mid_cols]
        idx, sv = sb["idx"], sb["sv"]
        fire = (torch.remainder(idx + 1, S) == 0) & sv

        fidx, n_fire = pane_ops.compact_positions(fire, self.fire_rows)
        fidx = fidx.to(torch.int64)
        f_idx = idx[fidx]                              # fire element's index
        f_m = torch.clamp(f_idx + 1, max=N)            # elements in window
        # element j (0..N-1) of the fired window, OLDEST first:
        # e = f_idx - (m - 1) + j, valid while j < m
        j = torch.arange(N, dtype=torch.int64, device=sv.device)[None, :]
        e = (f_idx - f_m + 1)[:, None] + j             # [F, N]
        f_prev = sb["prev"][fidx][:, None]
        in_batch = e >= f_prev
        bpos = (sb["seg_first"][fidx][:, None].to(torch.int64) + (e - f_prev)).clamp(
            0, sv.shape[0] - 1)
        flat = sb["safe_sk"][fidx][:, None] * N + torch.remainder(e.clamp(min=0), N)
        elems = [torch.where(in_batch, bl[bpos], lg.reshape(-1)[flat])
                 for lg, bl in zip(state["ebuf"], sorted_cols)]

        self._update_log(state, sb, sorted_cols)
        state["alert_overflow"] += torch.clamp(
            n_fire - self.fire_rows, min=0).to(torch.int64)
        return state, {"process_fire": {
            "count": torch.clamp(n_fire, max=self.fire_rows),
            "elems": elems,
            "m": f_m,
            "key": self._global_key_ids(sb["safe_sk"][fidx]),
            # closing record's arrival position (in the shards' stacked
            # rows), for emission order
            "arr": self._row_offset(sv.shape[0]) + sb["perm"][fidx],
            "bad_keys": self.bad_keys,
        }}

    def evaluate_fires(self, state, fire_info, emit: Callable,
                       fetch: Callable) -> int:
        """Host callback: the fired windows' elements arrived IN the
        emission (the state is not read). Emits in the arrival order of
        each window's closing record, Flink's per-record trigger order,
        with the GlobalWindow context: a result carries no timestamp, and
        its order is (the closing record's arrival index, item ordinal).
        Returns the windows fired."""
        count, bad = (int(x) for x in fetch([torch.cat([
            fire_info["count"].reshape(1).to(torch.int64),
            fire_info["bad_keys"].to(torch.int64)])])[0])
        if bad:
            raise IndexError(
                f"{bad} rows carried a key id past the keyed state's "
                f"capacity of {self.key_capacity(state)}"
            )
        if count == 0:
            return 0
        N = self.count_n
        got = fetch([fire_info["m"][:count], fire_info["key"][:count],
                     fire_info["arr"][:count]]
                    + [e[:count] for e in fire_info["elems"]])
        m, key, arr = got[0], got[1], got[2]
        values = [
            host_values(kd, tb, col.reshape(-1))
            for kd, tb, col in zip(self.mid_kinds, self.mid_tables, got[3:])
        ]
        key_table = self.key_table()
        n_shards = max(1, self.cfg.parallelism)
        for r in np.argsort(arr, kind="stable").tolist():
            mm = int(m[r])
            row = [v[r * N:r * N + mm] for v in values]
            elements = row[0] if len(row) == 1 else [make_tuple(*x) for x in zip(*row)]
            key_id = int(key[r])
            key_val = key_table.lookup(key_id) if key_table is not None else key_id
            out = Collector()
            # count windows live in Flink's GlobalWindow: no time bounds
            self.process_fn(key_val, WindowContext(0, 2**62, -(2**62)), elements, out)
            for ii, item in enumerate(out.items):
                emit(item, key_id % n_shards, None, (int(arr[r]), ii))
        return count
