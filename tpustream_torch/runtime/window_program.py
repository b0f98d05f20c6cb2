"""Windowed keyed aggregation on a pane ring (PyTorch).

Counterpart of tpustream/runtime/window_program.py for ``reduce`` and
``aggregate`` over tumbling and sliding time windows, in processing and
event time (reference chapter2/.../ComputeCpuAvg.java:27-60,
chapter3/.../BandwidthMonitor.java:32-41,
chapter3/.../BandwidthMonitorWithEventTime.java:45-55), with bounded
out-of-orderness, allowed lateness and the late-data side output
(chapter3/README.md:195-228). One step:

  1. masked pre-chain (map/filter) over the batch, then the lift
     (``aggregate``: the user ``add`` of each record into a fresh
     accumulator),
  2. watermark update: monotone ``max(max_seen - delay, clock_hint)``,
  3. late split against the PRE-batch watermark and the allowed
     lateness (late rows are the ``late`` stream a side output reads),
  4. state merge into flat ``[slot * K + key]`` word planes, either a
     non-unique scatter-add/min/max (``acc_dtype="int32"`` with a
     commutative combiner) or a stable sort by cell, a segmented scan
     with the user combiner, a gather of the old cell and a set-scatter
     at segment tails (the exact default),
  5. fire: window ends that crossed the watermark fire IN ORDER, at most
     ``max_fires_per_step`` a step, and, under allowed lateness, ends
     already fired whose panes took a record this step fire again
     (exempt from the budget); each fire folds its panes densely over
     all keys, finalizes (``aggregate``: the user ``get_result``), runs
     the post chain, and append-compacts the rows it keeps into a
     ``[alert_capacity]`` buffer.

The reference's traced control flow (``lax.cond``, ``scan``,
``while_loop``) is Python control flow here. Ring metadata (``hi``,
``slot_pane``, the watermark, ``fired_through``, ``pending_fires``) is
kept on the host, so a step reads the device once for the batch's
decision scalars (its newest timestamp, newest and oldest live pane,
largest key), once per fire pass for the slots that hold a record (a
fire skips the others) and, under allowed lateness, the slots the step
wrote, and, only on the jump sweep, once per sweep iteration. The
loss and fire counters accumulate on the device and are read once per
job. Each flat plane carries one trailing sink cell that masked rows of
a scatter write to.

``process()`` windows keep raw elements instead
(``process_program.ProcessWindowProgram``, a subclass). Session windows
(``session_program``) keep typed key-major cells and reuse the lift,
combine and finalize here and the typed cell merge
:meth:`WindowProgram._scatter_cells`; count windows (``count_program``)
reuse the lift, combine and finalize only.

Under ``acc_dtype`` ``"int32"`` or ``"float32"`` the leaves the
combiner sums, takes the min or the max of are stored in 32 bits
(``ops/wordplanes.py``), as the reference stores them. On the
scatter-reduce path an integer add, a min and a max are exact in any
order, and a float sum goes through ``ops/ordered_scatter.py``, which
adds each cell's values in arrival order as the reference's CPU
scatter does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..api.functions import as_callable
from ..api.timeapi import TimeCharacteristic
from ..records import F64, STR
from ..ops import liveness
from ..ops import panes as pane_ops
from ..ops.ordered_scatter import ordered_scatter_add
from ..ops.panes import W0
from ..ops.segments import (
    segment_ranks,
    segment_tails,
    segmented_scan,
    sort_by_key,
)
from ..ops.wordplanes import pack_words, plane_dtypes, unpack_words
from ..arith import reference_arithmetic
from ..utils.tree import to_host
from .device import (
    TORCH_DTYPES,
    DeviceChain,
    dummy_leaf,
    record_combiner,
    unwrap_record,
    wrap_record,
)
from .plan import JobPlan
from .step import BaseProgram, all_false, host_leaves, no_exchange

INF = 2**62
COUNTERS = ("window_fires", "late_dropped", "alert_overflow", "evicted_unfired")


def _dirty(slot_pane: np.ndarray, touched: np.ndarray, cand: np.ndarray,
           p_win: int) -> np.ndarray:
    """bool ``[F]``: the candidate windows (last pane ``cand``) that hold
    a touched slot. The reference multiplies the int32 ``touched`` vector
    into the slot-by-window member matrix; an ``any`` over the member
    mask is the same test."""
    member = ((slot_pane[:, None] <= cand[None, :])
              & (slot_pane[:, None] > cand[None, :] - p_win))
    return (touched[:, None] & member).any(axis=0)


class _Emission:
    """The step's append-compacted output buffer: ``cols`` (post-chain
    columns, then the key id and the window end) of ``[capacity]`` rows,
    allocated at the first fire; ``count`` the rows written (a device
    int32)."""

    def __init__(self):
        self.cols: Optional[List[torch.Tensor]] = None
        self.count: Optional[torch.Tensor] = None

    def append(self, emit, src_cols, capacity: int):
        """Append the rows of ``src_cols`` where ``emit``, in key order,
        after the rows already written (``panes.append_compact``).
        Returns the rows that did not fit (a device int64)."""
        self.cols, self.count, overflowed = pane_ops.append_compact(
            emit, src_cols, self.cols, self.count, capacity
        )
        return overflowed


class WindowProgram(BaseProgram):
    operator_name = "window"
    STATE_COMPONENT_KEYS = {"pane_ring": ("planes", "cnt", "slot_pane")}

    def key_sharded_leaves(self, spec: dict) -> dict:
        """The reference's window state_specs: the flat word planes and
        ``cnt`` shard on the key axis, ring metadata and scalars do not."""
        out = all_false(spec)
        out["planes"] = [True for _ in spec["planes"]]
        out["cnt"] = True
        return out
    accepted_kinds = ("tumbling", "sliding")
    fires_on_clock = True
    main_emission_prefix = True  # append-compacted alert buffer

    def __init__(self, plan: JobPlan, cfg):
        super().__init__(plan, cfg)
        st = plan.stateful
        spec = st.window
        if spec.kind not in self.accepted_kinds:
            raise NotImplementedError(
                f"{type(self).__name__} takes {' or '.join(self.accepted_kinds)} "
                f"windows, not {spec.kind} windows"
            )
        self.apply_kind = st.apply_kind
        self.key_pos = plan.key_pos
        if (
            spec.time_domain == TimeCharacteristic.EventTime
            and plan.time_characteristic == TimeCharacteristic.EventTime
            and plan.ts_assigner is None
            and not plan.upstream_supplies_ts
        ):
            raise RuntimeError(
                "event-time windows need assign_timestamps_and_watermarks "
                "before other operators (reference "
                "chapter3/.../BandwidthMonitorWithEventTime.java:29)"
            )
        self.allowed_lateness_ms = st.allowed_lateness_ms
        # Flink's numLateRecordsDropped counts only records NOT consumed
        # by a late side output: with one configured they are delivered
        self.count_late_as_dropped = not plan.side_outputs
        self.domain = spec.time_domain
        # processing time: wm = max_proc_seen - 1 so a record at T fires
        # windows ending <= T (timer semantics); ingestion time rides the
        # event machinery with the assigner's delay
        self.delay_ms = (
            plan.ts_delay_ms if self.domain == TimeCharacteristic.EventTime else 1
        )
        self.ring = self._make_ring(spec, cfg)
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
            self._analyze_columns()
        self._check_cells(cfg.key_capacity)
        # device reads of this program (the executor counts its own)
        self.host_reads = 0
        self._key_ids = {}

    def _make_ring(self, spec, cfg) -> pane_ops.RingSpec:
        """The pane ring of ``spec`` (the session programs override it)."""
        return pane_ops.make_ring_spec(
            spec.size_ms, spec.slide_ms, self.delay_ms,
            self.allowed_lateness_ms, cfg.pane_ring_slack,
        )

    # ------------------------------------------------------------------
    # aggregation plumbing: lift / combine / finalize on leaf tuples
    # ------------------------------------------------------------------
    def _build_agg(self) -> None:
        """``lift`` (record columns -> accumulator leaves), ``combine``
        (two accumulators -> one) and ``finalize`` (accumulator ->
        result leaves; None for ``reduce``, whose accumulator is the
        record), with the accumulator's and the result's leaf kinds.
        Every call into a user function runs under
        :func:`reference_arithmetic`."""
        kinds, tables = self.mid_kinds, self.mid_tables
        if self.apply_kind == "reduce":
            fn = as_callable(self.plan.stateful.apply_fn, "reduce")
            self.combine = record_combiner(fn, kinds, tables)
            self.lift = list
            self.finalize = None
            self.acc_kinds = list(kinds)
            self.result_kinds = list(kinds)
            self.result_tables = list(tables)
            return
        agg = self.plan.stateful.apply_fn
        create = as_callable(agg, "create_accumulator")
        add = as_callable(agg, "add")
        get_result = as_callable(agg, "get_result")

        def add_fresh(cols):
            # a fresh accumulator each call: add() may mutate it
            with reference_arithmetic():
                out, out_kinds, out_tables = unwrap_record(
                    add(wrap_record(kinds, tables, list(cols)), create()))
            return out, out_kinds, out_tables

        # the accumulator's layout from one add on 0-d stand-ins: a count
        # that starts at Python 0 is I64, a sum that starts at 0.0 F64,
        # the JAX package's kinds under x64
        _, acc_kinds, acc_tables = add_fresh([dummy_leaf(k) for k in kinds])
        self.acc_kinds = acc_kinds

        def lift(cols):
            # the user add runs once over [B] fields; a leaf it returns
            # as a constant (the count's 0 + 1) is broadcast
            out, _, _ = add_fresh(cols)
            n, dev = cols[0].shape, cols[0].device
            return [
                torch.broadcast_to(v.to(device=dev, dtype=TORCH_DTYPES[k]), n)
                for v, k in zip(out, acc_kinds)
            ]

        def finalize(leaves):
            with reference_arithmetic():
                out, _, _ = unwrap_record(
                    get_result(wrap_record(acc_kinds, acc_tables, list(leaves))))
            return tuple(out)

        self.combine = record_combiner(
            as_callable(agg, "merge"), acc_kinds, acc_tables)
        self.lift = lift
        self.finalize = finalize
        with reference_arithmetic():
            res = get_result(wrap_record(
                acc_kinds, acc_tables, [dummy_leaf(k) for k in acc_kinds]))
            _, self.result_kinds, self.result_tables = unwrap_record(res)

    def _analyze_columns(self) -> None:
        """Which accumulator leaves to store (liveness over the post
        chain and the combiner), whether the key leaf is rebuilt from the
        cell index, and whether the scatter-reduce path applies."""
        arity = len(self.acc_kinds)
        dummies = [dummy_leaf(k) for k in self.acc_kinds]

        def result_probe(*acc):
            res = acc if self.finalize is None else self.finalize(acc)
            outs, keep, _, _ = self.post_chain._record_fn(
                list(res), torch.tensor(True)
            )
            return tuple(outs) + (keep,)

        def combine_probe(*ab):
            return self.combine(tuple(ab[:arity]), tuple(ab[arity:]))

        live = liveness.live_accumulator_leaves(
            result_probe, combine_probe, dummies, arity
        )
        self.live_idx = [i for i, l in enumerate(live) if l]
        # reduce keeps records: the key leaf is rebuilt from the cell
        # index when the combiner passes it through verbatim
        self.key_leaf: Optional[int] = None
        if self.apply_kind == "reduce":
            passthrough = liveness.passthrough_outputs(
                combine_probe, dummies + dummies, arity
            )
            if self.key_pos in self.live_idx and passthrough[self.key_pos]:
                self.key_leaf = self.key_pos
        self.stored_idx = [i for i in self.live_idx if i != self.key_leaf]
        self.stored_kinds = [self.acc_kinds[i] for i in self.stored_idx]
        ops = liveness.leaf_algebraic_ops(combine_probe, dummies, arity)
        self.stored_ops = [ops[i] for i in self.stored_idx]
        # 32-bit storage (StreamConfig.acc_dtype int32/float32) only for
        # the leaves the combiner aggregates: pass-through fields stay
        # exact, as in the reference
        wants32 = str(self.cfg.acc_dtype) in ("int32", "float32")
        self.compact32 = [
            wants32 and op in ("add", "min", "max") for op in self.stored_ops
        ]
        self.plane_dtypes = plane_dtypes(self.stored_kinds, self.compact32)
        self.fast_reduce = (
            wants32
            and all(op in ("add", "min", "max") for op in self.stored_ops)
            and len(self.plane_dtypes) == len(self.stored_idx)
        )

    def _check_cells(self, key_capacity: int) -> None:
        n = self.ring.n_slots
        if n * key_capacity >= 2**31 - 1:
            raise ValueError(
                f"pane ring cells ({n} slots x {key_capacity} keys) exceed "
                "int32 addressing; lower key_capacity or window/pane ratio"
            )

    def _plane_identities(self) -> List:
        """Value each plane starts at and is cleared to: the op's
        identity on the scatter-reduce path (it merges straight into the
        plane), else 0."""
        if not self.fast_reduce:
            return [0 for _ in self.plane_dtypes]
        out = []
        for dt, op in zip(self.plane_dtypes, self.stored_ops):
            info = torch.finfo(dt) if dt.is_floating_point else torch.iinfo(dt)
            out.append({"min": info.max, "max": info.min}.get(op, 0))
        return out

    def _combine_live(self, a_live, b_live) -> Tuple:
        """User combiner restricted to live leaves (dead inputs zero —
        sound because liveness closed over the combiner's dependence)."""
        arity = len(self.acc_kinds)
        like = a_live[0]

        def fill(live_vals):
            full = [None] * arity
            for pos, i in enumerate(self.live_idx):
                full[i] = live_vals[pos]
            for i in range(arity):
                if full[i] is None:
                    full[i] = torch.zeros(
                        (), dtype=TORCH_DTYPES[self.acc_kinds[i]],
                        device=like.device,
                    ).expand(like.shape)
            return tuple(full)

        out = self.combine(fill(a_live), fill(b_live))
        return tuple(out[i] for i in self.live_idx)

    def _live_from_stored(self, stored_vals: List, key_ids) -> List:
        """Assemble the live-leaf tuple from stored values + key ids."""
        out, si = [], 0
        for i in self.live_idx:
            if i == self.key_leaf:
                out.append(key_ids.to(TORCH_DTYPES[self.acc_kinds[i]]))
            else:
                out.append(stored_vals[si])
                si += 1
        return out

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def key_capacity(self, state) -> int:
        return (state["cnt"].shape[0] - 1) // self.ring.n_slots

    def init_state(self, key_capacity: int = None) -> dict:
        """Flat ``[slot * K + key]`` planes (plus a sink cell each), the
        per-cell record counts, host ring metadata and device counters."""
        n, kk = self.ring.n_slots, key_capacity or self.cfg.key_capacity
        self._check_cells(kk)
        dev = self.device
        state = {
            "planes": [
                torch.full((n * kk + 1,), ident, dtype=dt, device=dev)
                for dt, ident in zip(self.plane_dtypes, self._plane_identities())
            ],
            "cnt": torch.zeros((n * kk + 1,), dtype=torch.int32, device=dev),
            "slot_pane": pane_ops.slot_targets(-1, self.ring),
            "hi": -1,
            "wm": W0,
            "max_ts": W0,
            "fired_through": W0,
            "pending_fires": 0,
        }
        for name in COUNTERS:
            state[name] = torch.zeros((), dtype=torch.int64, device=dev)
        return self._with_rules(state)

    def grow_state(self, state: dict, key_capacity: int) -> dict:
        """The same state at a larger ``key_capacity``: interned key ids
        are stable, so each slot's old run of keys is copied to the head
        of its new, longer run; new keys start fresh."""
        n, k_old = self.ring.n_slots, self.key_capacity(state)
        new = self.init_state(key_capacity)
        for dst, src in zip(new["planes"] + [new["cnt"]],
                            state["planes"] + [state["cnt"]]):
            dst[: n * key_capacity].view(n, key_capacity)[:, :k_old] = \
                src[: n * k_old].view(n, k_old)
        for name, v in state.items():
            if name not in ("planes", "cnt"):
                new[name] = v
        return new

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        """Turn the reference package's window state (numpy flat
        ``planes`` and ``cnt`` of ``n_slots * K``, ``slot_pane`` and the
        scalar leaves, tpustream/runtime/window_program.py init_state)
        into this program's state on its device."""
        dev = self.device
        idents = self._plane_identities()
        planes = [
            torch.from_numpy(
                np.append(np.asarray(p), np.asarray(ident, dtype=np.asarray(p).dtype))
            ).to(dev)
            for p, ident in zip(state_np["planes"], idents)
        ]
        cnt_np = np.asarray(state_np["cnt"], np.int32)
        state = {
            "planes": planes,
            "cnt": torch.from_numpy(np.append(cnt_np, np.int32(0))).to(dev),
            "slot_pane": np.asarray(state_np["slot_pane"], np.int64).copy(),
        }
        for name in ("hi", "wm", "max_ts", "fired_through", "pending_fires"):
            state[name] = int(state_np[name])
        for name in COUNTERS:
            state[name] = torch.tensor(
                int(state_np[name]), dtype=torch.int64, device=dev
            )
        self._check_cells(self.key_capacity(state))
        return self._rules_from_jax_numpy(state, state_np)

    SCALARS = ("hi", "wm", "max_ts", "fired_through", "pending_fires")

    def state_to_jax_numpy(self, state: dict) -> dict:
        """The inverse of :meth:`state_from_jax_numpy`: the planes and
        ``cnt`` without their sink cell, the host ring metadata as
        int64 leaves, and the reference's ``exchange_overflow``."""
        out = host_leaves(state, self.SCALARS + COUNTERS + ("slot_pane",))
        out["planes"] = [to_host(p[:-1]) for p in state["planes"]]
        out["cnt"] = to_host(state["cnt"][:-1])
        out["exchange_overflow"] = no_exchange()
        return self._rules_to_jax_numpy(state, out)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """One device-to-host copy of a small tensor (one wait)."""
        self.host_reads += 1
        return t.cpu().numpy()

    def _emission_keys(self, kk: int) -> torch.Tensor:
        """The GLOBAL key id of each of this shard's ``kk`` state rows
        (``arange(kk)`` on one device)."""
        ids = self._key_ids.get(kk)
        if ids is None:
            ids = self._global_key_ids(
                torch.arange(kk, dtype=torch.int32, device=self.device))
            self._key_ids = {kk: ids}
        return ids

    def rescale_key_leaf(self, arr, from_parallelism: int):
        """Checkpoint rescale of the flat word planes (the reference's
        layout ``[shard][slot][local_key]``, one contiguous
        ``[n_slots * k_local]`` block a shard): the permutation goes
        through the canonical ``[slot][global_key]`` order
        (tpustream/runtime/window_program.py:340-361)."""
        S_o = max(1, from_parallelism)
        S_n = max(1, self.n_shards)
        if S_o == S_n:
            return arr
        n = self.ring.n_slots
        K = arr.shape[0] // n
        if K % S_o or K % S_n:
            raise ValueError(
                f"cannot rescale window state: key_capacity ({K}) must "
                f"divide evenly by both the snapshot parallelism ({S_o}) "
                f"and the target parallelism ({S_n})"
            )
        canon = arr.reshape(S_o, n, K // S_o).transpose(1, 2, 0).reshape(n, K)
        return np.ascontiguousarray(
            canon.reshape(n, K // S_n, S_n).transpose(2, 0, 1).reshape(-1))

    def grow_key_leaf(self, old, new_init, shards: int = None):
        """Key-capacity growth of the flat word planes: per shard, each
        slot's old run of local keys is the head of its new run."""
        S = shards or max(1, self.n_shards)
        n = self.ring.n_slots
        k_lo = old.shape[0] // (S * n)
        out = np.array(new_init)
        k_ln = out.shape[0] // (S * n)
        k = min(k_lo, k_ln)
        out.reshape(S, n, k_ln)[:, :, :k] = old.reshape(S, n, k_lo)[:, :, :k]
        return out

    # ------------------------------------------------------------------
    # the state merge
    # ------------------------------------------------------------------
    def _retarget(self, state, hi: int, wm: int) -> None:
        n = self.ring.n_slots
        kk = self.key_capacity(state)
        rows = [p[: n * kk].view(n, kk) for p in state["planes"]]
        _, _, state["slot_pane"], evicted = pane_ops.retarget_rows(
            rows, state["cnt"][: n * kk].view(n, kk), state["slot_pane"],
            hi, wm, self.ring, self._plane_identities(),
        )
        if isinstance(evicted, torch.Tensor):
            state["evicted_unfired"] += evicted

    def _scatter_words(self, state, keys, lifted, live, pane) -> Optional[torch.Tensor]:
        """Merge a batch's ``live`` rows (accumulator leaves ``lifted``)
        into the flat cell planes, in place. Returns, under allowed
        lateness, bool ``[n_slots]``: the slots that took a record (an
        already-fired window over them fires again); else None.

        Scatter-reduce path (commutative combiner, 32-bit planes): one
        non-unique scatter-add/min/max per plane straight into the
        identity-initialized state; a float32 sum adds in arrival order
        (:func:`ordered_scatter_add`). Exact path: stable sort by cell,
        combine same-cell records with a segmented scan over live leaves,
        merge each segment with the cell's old value, set-scatter at
        segment tails."""
        n = self.ring.n_slots
        kk = self.key_capacity(state)
        sink = n * kk
        planes, cnt = state["planes"], state["cnt"]
        slot = torch.remainder(pane, n).to(torch.int32)
        cell = slot * kk + keys  # slot-major == plane memory order
        touched = None
        if self.allowed_lateness_ms > 0:
            touched = torch.zeros(n + 1, dtype=torch.bool, device=live.device)
            touched.index_fill_(0, torch.where(live, slot, n).to(torch.int64), True)
            touched = touched[:n]

        if self.fast_reduce:
            idx32 = torch.where(live, cell, sink).clamp(0, sink).to(torch.int32)
            idx = idx32.to(torch.int64)
            for s, (p, i, op) in enumerate(
                zip(planes, self.stored_idx, self.stored_ops)
            ):
                (val,) = pack_words(
                    [lifted[i]], [self.acc_kinds[i]], [self.compact32[s]]
                )
                val = val.to(p.dtype)
                if op == "add" and p.is_floating_point():
                    # a float sum depends on its order: arrival order,
                    # with XLA's flush of subnormals
                    ordered_scatter_add(p, idx32, val.contiguous())
                elif op == "add":
                    p.index_add_(0, idx, val)
                else:
                    p.scatter_reduce_(0, idx, val, "a" + op)
            cnt.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
            return touched

        perm, sc, sv, seg_starts = sort_by_key(cell, live, max_key=sink)
        sc = sc.to(torch.int32)
        live_sorted = tuple(lifted[i][perm] for i in self.live_idx)
        prefix = segmented_scan(live_sorted, seg_starts, self._combine_live)
        tails = segment_tails(seg_starts) & sv

        seg_count = segment_ranks(seg_starts) + 1

        sc_c = sc.clamp(0, sink - 1).to(torch.int64)
        old_words = [p[sc_c] for p in planes]
        old_cnt = cnt[sc_c]
        old_stored = unpack_words(old_words, self.stored_kinds, self.compact32)
        old_live = self._live_from_stored(
            old_stored, self._global_key_ids(torch.remainder(sc_c, kk)))
        merged = self._combine_live(tuple(old_live), prefix)
        has_old = (old_cnt > 0) & sv
        new_live = [torch.where(has_old, m, p) for m, p in zip(merged, prefix)]
        new_stored = [new_live[self.live_idx.index(i)] for i in self.stored_idx]
        new_words = pack_words(new_stored, self.stored_kinds, self.compact32)

        flat_idx = torch.where(tails, sc, sink).to(torch.int64)
        for p, w in zip(planes, new_words):
            p.scatter_(0, flat_idx, w.to(p.dtype))
        cnt.scatter_(0, flat_idx, old_cnt + torch.where(tails, seg_count, 0))
        return touched

    def _scatter_cells(self, leaves, cnt, kk: int, keys, batch_leaves, live,
                       pane, combine) -> None:
        """Merge a batch into typed key-major cell state IN PLACE: flat
        ``[key * n_slots + slot]`` leaves and counts, each with a trailing
        sink cell. A stable sort by cell, a segmented scan of the batch
        leaves with ``combine`` (arrival order preserved), the merge of
        each segment with its cell's old value, and a set-scatter at
        segment tails (the session programs' generic path)."""
        n = self.ring.n_slots
        sink = kk * n
        slot = torch.remainder(pane, n)
        cell = keys.to(torch.int64) * n + slot
        perm, sc, sv, seg_starts = sort_by_key(cell, live, max_key=sink)
        prefix = segmented_scan(tuple(l[perm] for l in batch_leaves),
                                seg_starts, combine)
        tails = segment_tails(seg_starts) & sv
        seg_count = segment_ranks(seg_starts) + 1
        sc_c = sc.clamp(0, sink - 1)
        old_cnt = cnt[sc_c]
        merged = combine(tuple(a[sc_c] for a in leaves), prefix)
        has_old = (old_cnt > 0) & sv
        flat_idx = torch.where(tails, sc, sink)
        for a, m, p in zip(leaves, merged, prefix):
            a.scatter_(0, flat_idx, torch.where(has_old, m, p).to(a.dtype))
        cnt.scatter_(0, flat_idx, old_cnt + torch.where(tails, seg_count, 0))

    # ------------------------------------------------------------------
    # dense fire path
    # ------------------------------------------------------------------
    def _fire_dense(
        self, state, hi: int, wm_old: int, wm_new: int, ft: int,
        touched: Optional[torch.Tensor], emission: _Emission,
        budget_on: bool = True,
    ) -> Tuple[int, int]:
        """Fire due window ends from the ring, appending their rows to
        ``emission``. ``budget_on`` False suspends ``max_fires_per_step``
        on a sweep iteration that is not the last: a deferred fire there
        would fall out of ring coverage before a drain step reached it.
        ``touched`` (allowed lateness only): the slots this merge wrote;
        an end already fired, still within the allowed lateness of the
        pre-batch watermark ``wm_old``, whose window holds such a slot
        fires again (chapter3/README.md:212), exempt from the budget: a
        deferred refire would be lost with the step's ``touched``.
        Returns ``(fired_through, deferred fires)``."""
        ring = self.ring
        n, f, p_win = ring.n_slots, ring.n_fire_candidates, ring.panes_per_window
        cand = hi - n + 1 + np.arange(f, dtype=np.int64)
        ends = (cand + 1) * ring.pane_ms
        aligned = np.mod(ends, ring.slide_ms) == 0
        pending = aligned & (ends - 1 <= wm_new) & (ends - 1 > ft)
        budget = (self.cfg.max_fires_per_step or f) if budget_on else f
        fire_now = pending & (np.cumsum(pending) <= budget)
        n_deferred = int(pending.sum() - fire_now.sum())
        occupied = None
        if touched is not None:
            may_refire = (aligned & (ends - 1 <= ft)
                          & (ends - 1 + self.allowed_lateness_ms > wm_old))
            if may_refire.any():
                # one read: slot occupancy and the slots the merge wrote
                got = self._read(torch.cat([self._occupancy(state),
                                            touched.to(torch.int64)]))
                occupied, wrote = got[:n].astype(bool), got[n:].astype(bool)
                fire_now = fire_now | (
                    may_refire & _dirty(state["slot_pane"], wrote, cand, p_win))
        if not fire_now.any():
            return ft, n_deferred
        fired = fire_now & pending
        if fired.any():
            ft = max(ft, int(ends[fired].max()) - 1)
        if occupied is None:
            # one read: a slot without a record folds nothing (the windows
            # of a stream's first minutes reach back to panes before its
            # start)
            occupied = self._read(self._occupancy(state)).astype(bool)
        for jj in np.flatnonzero(fire_now):
            self._fire_one(state, int(cand[jj]), int(ends[jj]), p_win,
                           occupied, emission)
        return ft, n_deferred

    def _occupancy(self, state) -> torch.Tensor:
        """int64 ``[n_slots]``: 1 where the slot holds a record."""
        n, kk = self.ring.n_slots, self.key_capacity(state)
        return (state["cnt"][: n * kk].view(n, kk) > 0).any(dim=1).to(torch.int64)

    def _fire_one(self, state, e_pane: int, end: int, p_win: int,
                  occupied: np.ndarray, emission: _Emission) -> None:
        """One window end: fold its panes over all keys in pane order,
        run the post chain, append the rows it keeps."""
        n = self.ring.n_slots
        kk = self.key_capacity(state)
        slot_pane = state["slot_pane"]
        key_col = self._emission_keys(kk)
        has = acc = None
        for o in range(p_win):
            pane_sel = e_pane - (p_win - 1) + o
            slot_sel = pane_sel % n
            if (pane_sel < 0 or int(slot_pane[slot_sel]) != pane_sel
                    or not occupied[slot_sel]):
                continue  # another pane, or no record: nothing to fold
            row = slice(slot_sel * kk, (slot_sel + 1) * kk)
            present = state["cnt"][row] > 0
            stored = unpack_words(
                [p[row] for p in state["planes"]], self.stored_kinds,
                self.compact32,
            )
            cell = self._live_from_stored(stored, key_col)
            if has is None:
                acc = [
                    torch.where(present, c, torch.zeros((), dtype=c.dtype,
                                                        device=c.device))
                    for c in cell
                ]
                has = present
                continue
            merged = self._combine_live(tuple(acc), tuple(cell))
            both = present & has
            acc = [
                torch.where(both, m, torch.where(present, c, a))
                for m, c, a in zip(merged, cell, acc)
            ]
            has = has | present
        if has is None:
            return  # no pane of the window is in the ring

        full = [None] * len(self.acc_kinds)
        for posi, i in enumerate(self.live_idx):
            full[i] = acc[posi]
        for i, kd in enumerate(self.acc_kinds):
            if full[i] is None:
                full[i] = torch.zeros((kk,), dtype=TORCH_DTYPES[kd],
                                      device=self.device)
        if self.finalize is not None:
            full = [
                torch.broadcast_to(r.to(device=self.device,
                                        dtype=TORCH_DTYPES[kd]), (kk,))
                for r, kd in zip(self.finalize(tuple(full)), self.result_kinds)
            ]
        post_cols, post_mask = self.post_chain.apply(full, has)

        cap = self.cfg.alert_capacity
        if emission.cols is None:
            dtypes = [TORCH_DTYPES[k] for k in self.out_kinds] + [
                torch.int32, torch.int64,
            ]
            emission.cols = [
                torch.zeros((cap,), dtype=dt, device=self.device)
                for dt in dtypes
            ]
            emission.count = torch.zeros((), dtype=torch.int32, device=self.device)
        end_col = torch.full((), end, dtype=torch.int64,
                             device=self.device).expand(kk)
        state["alert_overflow"] += emission.append(
            post_mask & has, list(post_cols) + [key_col, end_col], cap
        )
        # every (key, window) with content is one window fire, counted
        # BEFORE the post-chain filter (Flink's per-trigger accounting)
        state["window_fires"] += has.sum(dtype=torch.int64)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def step(self, state, cols, valid, ts, wm_lower: int):
        """One batch: ``cols`` the record's ``[B]`` tensors, ``valid``
        bool[B], ``ts`` int64[B] (event or processing time), ``wm_lower``
        the host clock's watermark floor. Returns ``(state, {"main":
        stream})``; the stream's rows are the first ``count`` of ``cols``
        (post-chain columns), ``key`` and ``window_end``, in fire order
        then key id; ``count`` is 0 (a Python int) when nothing fired."""
        mid_cols, mask = self._apply_pre(cols, valid)
        ring = self.ring
        n, g = ring.n_slots, ring.pane_ms
        kk = self.key_capacity(state)
        # the newest timestamp of the shard's own rows, before the keyBy
        batch_max_t = torch.where(mask, ts, W0).max()
        mid_cols, mask, ts, _ = self._exchange(mid_cols, mask, ts)
        mid_cols, key_col = self._split_key_col(mid_cols)
        keys = self._local_keys(key_col)
        lifted = self.lift(mid_cols)

        wm_old = state["wm"]
        late = pane_ops.late_mask(ts, wm_old, self.allowed_lateness_ms, ring) & mask
        live = mask & ~late
        pane = pane_ops.pane_of(ts, g)
        if self.count_late_as_dropped:
            state["late_dropped"] += late.sum(dtype=torch.int64)
        # the step's decisions need four scalars of the batch: one copy
        batch_max, batch_hi, min_live_pane, max_key = (
            int(v) for v in self._read(torch.stack([
                batch_max_t,
                torch.where(live, pane, -1).max(),
                torch.where(live, pane, INF).min(),
                torch.where(live, keys.to(torch.int64), -1).max(),
            ]))
        )
        # the decision scalars every shard must agree on (pmax)
        batch_max = self._global_max(batch_max)
        batch_hi = self._global_max(batch_hi)
        min_live_pane = -self._global_max(-min_live_pane)
        if max_key >= kk:
            raise IndexError(
                f"a record carried key id {max_key}, past the window "
                f"state's key capacity of {kk}"
            )
        new_max = max(state["max_ts"], batch_max)
        wm_new = max(wm_old, max(new_max - self.delay_ms, wm_lower))
        hi = max(state["hi"], batch_hi)
        ft0 = state["fired_through"]

        # The fast path (retarget -> scatter -> one fire pass) is sound
        # only when retargeting to `hi` evicts no slot whose windows still
        # owe fires, and every live record's pane fits the ring at `hi`.
        # A large event-time jump breaks both; the sweep advances the ring
        # in safe chunks instead. Virgin slots (pane < 0) hold nothing.
        slot_pane = state["slot_pane"]
        stale = slot_pane != pane_ops.slot_targets(hi, ring)
        last_end = (slot_pane + ring.panes_per_window) * g
        may_evict = bool(np.any(stale & (last_end - 1 > ft0) & (slot_pane >= 0)))
        emission = _Emission()
        if not may_evict and min_live_pane > hi - n:
            if hi > state["hi"]:
                self._retarget(state, hi, ft0)
            touched = self._scatter_words(state, keys, lifted, live, pane)
            new_ft, pending = self._fire_dense(
                state, hi, wm_old, wm_new, ft0, touched, emission)
        else:
            new_ft, pending = self._sweep(
                state, hi, ft0, wm_old, wm_new, keys, lifted, live, pane,
                emission,
            )
        # ends whose last pane fell below ring coverage can never fire
        # again: advance fired_through past them
        new_ft = max(new_ft, min(wm_new, (hi - n + 1) * g - 1))
        state.update(hi=hi, wm=wm_new, max_ts=new_max, fired_through=new_ft,
                     pending_fires=pending)
        late_stream = {"mask": late, "cols": tuple(mid_cols)}
        if emission.cols is None:
            return state, {"main": {"count": 0}, "late": late_stream}
        cols = emission.cols
        main = {
            "count": emission.count,
            "cols": tuple(cols[:-2]),
            "key": cols[-2],
            "window_end": cols[-1],
        }
        return state, {"main": main, "late": late_stream}

    def _sweep(self, state, hi_target, ft0, wm_old, wm_new, keys, lifted,
               live, pane, emission) -> Tuple[int, int]:
        """Advance the ring from its current head to ``hi_target`` in
        safe chunks when one step spans more panes than the ring covers
        (a batch with a large event-time jump, or a stream gap).

        Each iteration picks the largest head advance that neither evicts
        a slot with due-but-unfired windows nor strips coverage from a
        record not yet scattered, retargets, scatters the newly covered
        records, and fires every end the watermark and the scatter
        frontier both allow. Flink parity: a record-at-a-time runtime
        interleaves fires with arrivals in exactly this order (reference
        chapter3/README.md:195-213). Returns ``(fired_through, deferred
        fires)``."""
        ring = self.ring
        n, g, p_win = ring.n_slots, ring.pane_ms, ring.panes_per_window
        first = True
        hi_cur = int(state["slot_pane"].max())
        scattered_hi = -INF
        ft, pending = ft0, 0
        while first or hi_cur < hi_target:
            unscat = live & (pane > scattered_hi)
            # one copy: each slot's occupancy and the oldest unscattered pane
            got = self._read(torch.cat([
                self._occupancy(state),
                torch.where(unscat, pane, INF).min().reshape(1),
            ]))
            occ, min_unscat = got[:n].astype(bool), int(got[n])
            slot_pane = state["slot_pane"]
            unsafe = occ & ((slot_pane + p_win) * g - 1 > ft)
            unsafe_min = int(slot_pane[unsafe].min()) if unsafe.any() else INF
            # the shards' occupancy differs; the head they advance to
            # must not (a global min)
            unsafe_min = -self._global_max(-unsafe_min)
            min_unscat = -self._global_max(-min_unscat)
            hi_next = min(hi_target, unsafe_min + (n - 1), min_unscat + (n - p_win))
            hi_next = max(hi_next, hi_cur)
            if hi_next > hi_cur:
                self._retarget(state, hi_next, ft)
            touched = self._scatter_words(
                state, keys, lifted, unscat & (pane <= hi_next), pane
            )
            is_final = hi_next >= hi_target
            wm_eff = wm_new if is_final else min(wm_new, hi_next * g - 1)
            ft, pending = self._fire_dense(
                state, hi_next, wm_old, wm_eff, ft, touched, emission,
                budget_on=is_final,
            )
            first, hi_cur, scattered_hi = False, hi_next, hi_next
        return ft, pending
