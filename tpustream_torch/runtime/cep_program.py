"""CEP pattern matching as torch ops on one device.

Counterpart of tpustream/runtime/cep_program.py. Executes a compiled
linear NFA (``tpustream_torch/cep/nfa.py``) over keyed device state: per
key, one register per non-start NFA state — occupancy bit
``occ[K, R]``, window-start timestamp ``start_ts[K, R]``, and captured
event columns ``cap<i>[K, R, R]`` (register r uses capture slots 0..r) —
where R = L - 1 for an L-step pattern. Every leaf carries one trailing
sink row (``occ[K]`` and so on) that the rows a scatter does not select
write to; it is never read.

One step (the reference's event-time skeleton):

  1. masked pre-chain; the watermark (monotone ``max_seen - delay``)
     and the late split against the pre-batch watermark (late events
     are the ``late`` stream),
  2. every stage condition evaluates over the batch's columns at once
     (the reference vmaps it over records), and the per-step transition
     bits gather through the compiled ``stage_of`` table into ``[B, L]``,
  3. records sort stably by key and take their arrival rank within the
     key; the host reads the number of ranks (one wait, with the batch's
     newest timestamp) and runs that many rounds of
     :meth:`CepProgram._advance_round`, each advancing AT MOST ONE event
     per key but every key at once. The reference's ``while_loop`` is a
     Python loop here. The advance resolves register collisions top-down
     (an accepted advance consumes its source; an occupied target that
     neither advanced out nor died keeps its OLDER partial), strict edges
     (``next``/``consecutive``) kill partials their event failed to
     extend, and ``within`` gates every edge by ``ts - start <
     within_ms``,
  4. completed matches (flat L*C event-major columns) go back to arrival
     order, run the post chain (the select adapter and the user's
     map/filter) and compact into ``alert_capacity`` rows, with the
     completing event's timestamp as the match's ``ts``; partials whose
     window the NEW watermark reached (``wm >= start + within``) emit on
     the ``timeout`` stream, in key id then register order, and clear.

The watermark and the newest timestamp are host ints; the counters
(``cep_matches``, ``cep_timeouts``, ``cep_partials``, ``late_dropped``,
``alert_overflow``, ``exchange_overflow``) accumulate on the device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..api.functions import as_callable
from ..api.timeapi import TimeCharacteristic
from ..arith import reference_arithmetic
from ..ops import panes as pane_ops
from ..ops.panes import W0
from ..ops.segments import inverse_permutation, segment_ranks, sort_by_key
from ..records import I64, NUMPY_DTYPES, STR
from .device import TORCH_DTYPES, DeviceChain, as_tensor, wrap_record
from .plan import JobPlan
from ..utils.tree import to_host
from .step import BaseProgram, host_leaves

COUNTERS = ("cep_matches", "cep_timeouts", "cep_partials", "late_dropped",
            "alert_overflow", "exchange_overflow")


class CepProgram(BaseProgram):
    operator_name = "cep"
    main_emission_prefix = True  # matches compact into a prefix buffer
    # the main stream always carries each match's timestamp, so the step
    # always takes the batch's timestamps
    emit_ts = True

    def __init__(self, plan: JobPlan, cfg):
        super().__init__(plan, cfg)
        st = plan.stateful
        cp = st.cep
        self.compiled = cp
        self.key_pos = plan.key_pos
        self.L = cp.length
        self.R = cp.length - 1
        self.STATE_COMPONENT_KEYS = {
            "nfa_registers": ("occ", "start_ts"),
            "nfa_captures": tuple(f"cap{i}"
                                  for i in range(len(self.mid_kinds))),
        }
        self.within_ms = cp.within_ms
        # only within() gives clock ticks (the end-of-stream flush)
        # anything to emit
        self.fires_on_clock = bool(cp.within_ms)
        self.allowed_lateness_ms = st.allowed_lateness_ms
        self.timeout_tag = st.timeout_tag
        if (
            plan.time_characteristic == TimeCharacteristic.EventTime
            and plan.ts_assigner is None
            and not plan.upstream_supplies_ts
        ):
            raise RuntimeError(
                "CEP patterns are event-time operators: add "
                "assign_timestamps_and_watermarks before the pattern "
                "(or run the job in processing time)"
            )
        if plan.time_characteristic == TimeCharacteristic.EventTime:
            self.delay_ms = plan.ts_delay_ms
        else:
            # processing time: wm = max_proc_seen - 1 (timer semantics)
            self.delay_ms = 1
        # Flink counts late records as dropped only when no side output
        # consumes them
        late_routed = st.late_tag is not None and any(
            so.tag == st.late_tag for so in plan.side_outputs
        )
        self.count_late_as_dropped = not late_routed

        # match record: the L matched events' fields, event-major
        # (ev0.f0, ev0.f1, .., ev1.f0, ..)
        match_kinds = [k for _ in range(self.L) for k in self.mid_kinds]
        match_tables = [t for _ in range(self.L) for t in self.mid_tables]
        self.post_chain = DeviceChain(plan.device_post, match_kinds, match_tables)
        self.out_kinds = self.post_chain.out_kinds
        self.out_tables = self.post_chain.out_tables
        # timeout record: (n_matched, start_ts, then R capture slots'
        # fields; slots >= n_matched padded with 0 / None)
        self.timeout_kinds = [I64, I64] + [
            k for _ in range(self.R) for k in self.mid_kinds
        ]
        self.timeout_tables = [None, None] + [
            t for _ in range(self.R) for t in self.mid_tables
        ]
        self._conds = self._build_conds()
        # device reads of this program (the executor counts its own)
        self.host_reads = 0
        # rounds of the advance in each step (the per-rank loop's length)
        self.rounds: List[int] = []

    # ------------------------------------------------------------------
    def _build_conds(self):
        """One batch-wide predicate per STAGE: its ANDed where()
        conditions over the visible record, whose fields are the batch's
        ``[B]`` columns, run with the reference's arithmetic."""
        kinds, tables = self.mid_kinds, self.mid_tables
        outs = []
        for stage_conds in self.compiled.conds:
            fns = tuple(as_callable(c, "filter") for c in stage_conds)

            def stage_fn(cols, _fns=fns):
                shape, dev = cols[0].shape, cols[0].device
                with reference_arithmetic():
                    rec = wrap_record(kinds, tables, list(cols))
                    ok = torch.ones((), dtype=torch.bool, device=dev)
                    for f in _fns:
                        ok = torch.logical_and(ok, as_tensor(f(rec)).to(dev))
                return torch.broadcast_to(ok, shape)

            outs.append(stage_fn)
        return outs

    def _cap_pad(self, kind: str) -> int:
        """Padding value for unoccupied capture slots: STR pads with the
        NONE_ID so the formatter renders None, everything else zeros."""
        return -1 if kind == STR else 0

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def key_capacity(self, state) -> int:
        return state["occ"].shape[0] - 1

    def _keyed_names(self):
        return ["occ", "start_ts"] + [f"cap{i}" for i in range(len(self.mid_kinds))]

    def init_state(self, key_capacity: int = None) -> dict:
        kk, R, dev = key_capacity or self.cfg.key_capacity, self.R, self.device
        state = {
            "occ": torch.zeros((kk + 1, R), dtype=torch.bool, device=dev),
            "start_ts": torch.full((kk + 1, R), W0, dtype=torch.int64, device=dev),
        }
        for i, kind in enumerate(self.mid_kinds):
            state[f"cap{i}"] = torch.full(
                (kk + 1, R, R), self._cap_pad(kind), dtype=TORCH_DTYPES[kind],
                device=dev,
            )
        for name in COUNTERS:
            state[name] = torch.zeros((), dtype=torch.int64, device=dev)
        state["wm"] = W0
        state["max_ts"] = W0
        # dynamic predicate constants (RuleParams in where() clauses)
        # read these tensors inside the step: a rule update writes them,
        # the program is never rebuilt
        return self._with_rules(state)

    def grow_state(self, state: dict, key_capacity: int) -> dict:
        """The same state at a larger ``key_capacity``: interned key ids
        are stable, so the old keys' registers are the new leaves' head;
        new keys start empty."""
        k_old = self.key_capacity(state)
        new = self.init_state(key_capacity)
        keyed = self._keyed_names()
        for name in keyed:
            new[name][:k_old] = state[name][:k_old]
        for name, v in state.items():
            if name not in keyed:
                new[name] = v
        return new

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        """Turn the reference package's CEP state (numpy ``occ [K, R]``,
        ``start_ts [K, R]``, ``cap<i> [K, R, R]``, the counters, ``wm``
        and ``max_ts``, tpustream/runtime/cep_program.py init_state) into
        this program's state on its device, with the sink row appended
        and the rules of this job attached."""
        dev = self.device

        def with_sink(a, dtype, pad):
            a = np.asarray(a).astype(dtype)
            sink = np.full((1,) + a.shape[1:], pad, dtype)
            return torch.from_numpy(np.concatenate([a, sink])).to(dev)

        state = {
            "occ": with_sink(state_np["occ"], np.bool_, False),
            "start_ts": with_sink(state_np["start_ts"], np.int64, W0),
        }
        for i, kind in enumerate(self.mid_kinds):
            state[f"cap{i}"] = with_sink(state_np[f"cap{i}"], NUMPY_DTYPES[kind],
                                         self._cap_pad(kind))
        for name in COUNTERS:
            state[name] = torch.tensor(int(state_np[name]), dtype=torch.int64,
                                       device=dev)
        state["wm"] = int(state_np["wm"])
        state["max_ts"] = int(state_np["max_ts"])
        return self._rules_from_jax_numpy(state, state_np)

    def state_to_jax_numpy(self, state: dict) -> dict:
        """The inverse of :meth:`state_from_jax_numpy`: the registers
        without their sink row, ``wm`` and ``max_ts`` as int64 leaves."""
        out = host_leaves(state, COUNTERS + ("wm", "max_ts"))
        for name in self._keyed_names():
            out[name] = to_host(state[name][:-1])
        return self._rules_to_jax_numpy(state, out)

    def _read(self, t: torch.Tensor) -> np.ndarray:
        """One device-to-host copy of a small tensor (one wait)."""
        self.host_reads += 1
        return t.cpu().numpy()

    # ------------------------------------------------------------------
    def _advance_round(self, sel, sk_c, sts, s_ok, s_cols, occ, start, caps,
                       kk: int):
        """One arrival-rank round: apply each selected row's event to its
        key's register file (vectorized over the batch axis), writing the
        selected rows' registers back in place; the other rows write the
        sink row. Returns (match mask [B], match event columns [B, L] per
        visible field): the mask is set only on ``sel`` rows that
        completed a match, which belong to this round alone, and the
        columns are read only there."""
        L, R = self.L, self.R
        strict = self.compiled.strict  # numpy bools: unrolled branches
        occ_g = occ[sk_c]              # [B, R]
        st_g = start[sk_c]             # [B, R]
        cap_g = [c[sk_c] for c in caps]  # [B, R, R] each

        # can_adv[j]: edge j (state j -> j+1) fires off the pre-event
        # snapshot; the start state (j == 0) is always active and a run
        # beginning at this event trivially satisfies within
        can_adv: List = [None] * L
        for j in range(L):
            ok = s_ok[:, j]
            if j > 0:
                ok = ok & occ_g[:, j - 1]
                if self.within_ms is not None:
                    ok = ok & ((sts - st_g[:, j - 1]) < self.within_ms)
            can_adv[j] = ok

        # resolve collisions top-down: an accepted advance consumes its
        # source; an occupied target that neither advanced out nor died
        # keeps its OLDER partial and rejects the incoming advance;
        # strict sources die when their event failed to move them
        adv_acc: List = [None] * L
        adv_acc[L - 1] = can_adv[L - 1]  # accept state: always emits
        keep_old: List = [None] * R
        for i in range(R - 1, -1, -1):
            consumed = adv_acc[i + 1]
            if strict[i + 1]:
                keep = torch.zeros_like(consumed)
            else:
                keep = occ_g[:, i] & ~consumed
            keep_old[i] = keep
            adv_acc[i] = can_adv[i] & ~keep

        match = adv_acc[L - 1]

        new_occ = torch.stack([keep_old[i] | adv_acc[i] for i in range(R)], dim=1)
        new_start = torch.stack(
            [
                torch.where(adv_acc[i], sts if i == 0 else st_g[:, i - 1],
                            st_g[:, i])
                for i in range(R)
            ],
            dim=1,
        )
        new_caps = []
        for g, col in zip(cap_g, s_cols):
            regs = []
            for i in range(R):
                reg = (g[:, i - 1, :] if i > 0 else g[:, i, :]).clone()
                reg[:, i] = col
                regs.append(torch.where(adv_acc[i][:, None], reg, g[:, i, :]))
            new_caps.append(torch.stack(regs, dim=1))

        idx = torch.where(sel, sk_c, kk)  # non-selected rows: the sink row
        occ[idx] = new_occ
        start[idx] = new_start
        for c, nc in zip(caps, new_caps):
            c[idx] = nc
        # matched event columns [B, L]: captures of the final register
        # (events 0..L-2) plus the completing event
        m_cols = [torch.cat([g[:, R - 1, :], col[:, None]], dim=1)
                  for g, col in zip(cap_g, s_cols)]
        return sel & match, m_cols

    # ------------------------------------------------------------------
    def step(self, state, cols, valid, ts, wm_lower=None):
        """One batch: ``cols`` the record's ``[B]`` tensors, ``valid``
        bool[B], ``ts`` int64[B] (event or processing time), ``wm_lower``
        the host clock's watermark floor. Returns ``(state, emissions)``:
        ``main`` (the first ``count`` rows of ``cols``, ``key`` and
        ``ts`` are the matches that passed the post chain, in arrival
        order of their completing events), ``late`` (mask and columns)
        and, with ``within``, ``timeout`` (the first ``count`` rows of
        ``cols``)."""
        L, R = self.L, self.R
        C = len(self.mid_kinds)
        dev = self.device
        cap = self.cfg.alert_capacity
        mid_cols, mask = self._apply_pre(cols, valid)
        batch_max_t = torch.where(mask, ts, W0).max()
        # keyBy: route the records to their key's owner shard
        mid_cols, mask, ts, _ = self._exchange(mid_cols, mask, ts)
        mid_cols, key_col = self._split_key_col(mid_cols)
        keys = self._local_keys(key_col).to(torch.int64)
        kk = self.key_capacity(state)

        wm_old = state["wm"]
        late = mask & ((ts + self.allowed_lateness_ms) <= wm_old)
        live = mask & ~late

        # stage conditions over the whole batch, then the per-step
        # transition bits through the compiled table's stage_of
        stage_ok = [f(mid_cols) for f in self._conds]
        step_ok = torch.stack(
            [stage_ok[int(s)] for s in self.compiled.stage_of], dim=1)

        perm, sk, sv, seg_starts = sort_by_key(keys, live, max_key=kk)
        ranks = segment_ranks(seg_starts)
        # the step's decisions need three scalars of the batch: one copy
        batch_max, n_rounds, max_key = (int(v) for v in self._read(torch.stack([
            batch_max_t,
            torch.where(sv, ranks.to(torch.int64) + 1, 0).max(),
            torch.where(live, keys, -1).max(),
        ])))
        batch_max = self._global_max(batch_max)
        if max_key >= kk:
            raise IndexError(
                f"a record carried key id {max_key}, past the CEP state's "
                f"key capacity of {kk}"
            )
        new_max = max(state["max_ts"], batch_max)
        floor = W0 if wm_lower is None else wm_lower
        wm_new = max(wm_old, max(new_max - self.delay_ms, floor))

        sk_c = sk.to(torch.int64).clamp(0, kk - 1)
        sts = ts[perm]
        s_ok = step_ok[perm]
        s_cols = [c[perm] for c in mid_cols]
        B = sv.shape[0]
        occ, start = state["occ"], state["start_ts"]
        caps = [state[f"cap{i}"] for i in range(C)]
        m_mask = torch.zeros((B,), dtype=torch.bool, device=dev)
        m_cols = [torch.zeros((B, L), dtype=c.dtype, device=dev) for c in s_cols]
        for r in range(n_rounds):
            sel = sv & (ranks == r)
            matched, mc = self._advance_round(
                sel, sk_c, sts, s_ok, s_cols, occ, start, caps, kk)
            m_mask = m_mask | matched
            m_cols = [torch.where(matched[:, None], c_new, c_old)
                      for c_new, c_old in zip(mc, m_cols)]
        self.rounds.append(n_rounds)

        # matches back to arrival order, flattened event-major, through
        # the post chain (select adapter + user map/filter), then
        # compacted into the alert prefix buffer
        inv = inverse_permutation(perm)
        m_mask_o = m_mask[inv]
        m_unperm = [c[inv] for c in m_cols]
        flat_cols = [m_unperm[c][:, e] for e in range(L) for c in range(C)]
        out_cols, keep = self.post_chain.apply(flat_cols, m_mask_o)
        gkey = self._global_key_ids(keys.clamp(0, kk - 1)).to(torch.int64)
        idx, count = pane_ops.compact_positions(keep, cap)
        idx = idx.to(torch.int64)
        gathered = [x[idx] for x in list(out_cols) + [gkey, ts]]
        main = {
            "count": torch.clamp(count, max=cap),
            "cols": tuple(gathered[:-2]),
            "key": gathered[-2],
            # the completing event's timestamp (Flink's match timestamp):
            # chained event-time stages consume it downstream
            "ts": gathered[-1],
        }
        emissions = {
            "main": main,
            "late": {"mask": late, "cols": tuple(mid_cols)},
        }

        # within() timeouts: partials whose window the NEW watermark
        # passed can never complete (any extending event would now be
        # late beyond allowed lateness): emit and clear
        if self.within_ms is not None:
            occ_k, start_k = occ[:kk], start[:kk]
            tmo = occ_k & (start_k + self.within_ms <= wm_new)
            idx, t_count = pane_ops.compact_positions(tmo.reshape(-1), cap)
            idx = idx.to(torch.int64)
            reg_idx = idx % R                            # register of the row
            t_cols = [reg_idx + 1, start_k.reshape(-1)[idx]]  # n_matched, start
            planes = [caps[c][:kk].reshape(kk * R, R)[idx] for c in range(C)]
            for e in range(R):
                for c in range(C):
                    # slots past the register's capture count are padded
                    # so the emitted rows are deterministic
                    plane = planes[c][:, e]
                    pad = torch.tensor(self._cap_pad(self.mid_kinds[c]),
                                       dtype=plane.dtype, device=dev)
                    t_cols.append(torch.where(reg_idx >= e, plane, pad))
            emissions["timeout"] = {
                "count": torch.clamp(t_count, max=cap),
                "cols": tuple(t_cols),
            }
            occ_k &= ~tmo
            state["cep_timeouts"] += tmo.sum(dtype=torch.int64)
            state["alert_overflow"] += torch.clamp(
                t_count - cap, min=0).to(torch.int64)

        state["cep_matches"] += m_mask.sum(dtype=torch.int64)
        # point-in-time gauge of the partial matches held
        state["cep_partials"] = occ[:kk].sum(dtype=torch.int64)
        if self.count_late_as_dropped:
            state["late_dropped"] += late.sum(dtype=torch.int64)
        state["alert_overflow"] += torch.clamp(count - cap, min=0).to(torch.int64)
        state.update(wm=wm_new, max_ts=new_max)
        return state, emissions
