"""Device programs: one ``(state, batch) -> (state, emissions)`` step per
job, run eagerly with PyTorch on ``StreamConfig.device``.

Counterpart of tpustream/runtime/step.py for one device. Ported: the
stateless map/filter chain (``StatelessProgram``), the keyed rolling
aggregates (``RollingProgram``: max/min/sum of float64 and int64 fields
through the hand-written kernel, the rest through the general path), the
tumbling/sliding window ``reduce`` and ``aggregate``
(``window_program.WindowProgram``), the full-window ``process``
(``process_program.ProcessWindowProgram``), session windows
(``session_program.SessionWindowProgram``, ``SessionProcessProgram``),
count windows (``count_program.CountWindowProgram``,
``SlidingCountWindowProgram``, ``CountProcessProgram``) and CEP
(``cep_program.CepProgram``). At ``parallelism > 1``
:func:`build_program` returns the sharded variant of each keyed family
(``runtime/sharded.py``): S shards in one process, each running the
family's own step, with the SPMD hooks of :class:`BaseProgram` (the
identity here) bound to the mesh's collectives (ROADMAP item 12a). A
step takes ``(state, cols, valid, ts, wm_lower)``, as in the reference.

Dynamic rules (``tpustream_torch.broadcast``): every family's
``init_state`` attaches the job's rule tensors to its state
(:meth:`BaseProgram._with_rules`), and the Runner steps through
:meth:`BaseProgram.run_step`, which binds them for the step so that
every ``RuleParam`` in a user function reads its tensor. A rule update
writes those tensors in place between steps; no program is rebuilt.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..api.functions import as_callable
from ..config import StreamConfig
from ..ops import panes as pane_ops
from ..ops import rolling as rolling_ops
from ..records import I64, STR
from ..utils.tree import to_host, tree_leaves, tree_unflatten
from .device import DeviceChain, record_combiner
from .plan import JobPlan

# dynamic-rule leaves ride the state under these keys (only when the plan
# declares a RuleSet: rule-less jobs keep their exact state layout)
RULES_KEY = "__rules__"
RULE_VERSION_KEY = "__rule_version__"


def host_leaves(state: dict, names) -> dict:
    """``{name: state[name]}`` as owned host arrays (:func:`to_host`)."""
    return {n: to_host(state[n]) for n in names}


def no_exchange() -> np.ndarray:
    """The reference's ``exchange_overflow`` counter: rows dropped by the
    sharded keyBy exchange, always 0 on one device."""
    return np.zeros((), dtype=np.int64)


def resolve_device(name: str) -> torch.device:
    """The torch device a job runs on. ``cuda`` without a visible card
    raises: a job never moves to the CPU unless it asked for it."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"StreamConfig.device is {name!r} but torch.cuda.is_available() "
            f"is False; pass StreamConfig(device='cpu') to run on the CPU"
        )
    return dev


class BaseProgram:
    """Common structure: pre chain -> stateful core -> post chain."""

    # False for programs with no time semantics: a clock tick or the end
    # of the stream can never make them emit, so the executor skips it
    fires_on_clock = False
    # True when the "main" emission's rows are a compacted prefix of its
    # buffers (``count`` rows), False when a ``mask`` selects them
    main_emission_prefix = False
    # set by _make_runner_chain when an event-time stage is downstream of
    # a rolling stage: the step's "main" stream then carries each row's
    # input timestamp as ``ts`` (window stages hand over their ends)
    emit_ts = False
    # True for programs whose fired windows the host evaluates (a user
    # process() function): a stage chained after one infers its record
    # schema from the rows the function collects
    host_evaluated = False
    # True when the host evaluates a step's emissions against the live
    # state (a full-window process() program reads its window buffers
    # at dispatch): such a program runs at async_depth 1, unstaged and
    # uncompacted, since a later step would rewrite what it reads
    emissions_reference_state = False
    # the operator label of this program's obs series (the reference's
    # names, so both packages' series line up)
    operator_name = "operator"
    # host-side scalar clocks the obs layer exposes as state_<name>
    # gauges at the end of a job
    OBS_STATE_SCALARS = ("wm", "max_ts", "hi", "pending_fires")
    # component name -> the state keys it holds, for the obs layer's
    # per-component state bytes (obs/memory.py); keys absent from a
    # family's state count nothing, other keys count as "scalars"
    STATE_COMPONENT_KEYS: dict = {}

    def state_components(self) -> dict:
        """Flat ``state key -> component name`` map derived from
        :data:`STATE_COMPONENT_KEYS`."""
        return {k: comp for comp, keys in self.STATE_COMPONENT_KEYS.items()
                for k in keys}

    def __init__(self, plan: JobPlan, cfg: StreamConfig):
        self.plan = plan
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # the pre chain wraps the VISIBLE record: a computed-KeySelector
        # job's synthetic trailing key column never reaches user ops
        in_kinds, in_tables = plan.record_kinds, plan.tables
        if plan.synthetic_key and in_kinds:
            in_kinds, in_tables = in_kinds[:-1], in_tables[:-1]
        # dynamic rules: RuleParams in user functions resolve to host
        # values at chain-build time (DeviceChain's output dry run) and
        # to the state's rule tensors inside run_step
        self.ruleset = plan.rules
        self.pre_chain = DeviceChain(plan.device_pre, in_kinds, in_tables)
        self.mid_kinds = self.pre_chain.out_kinds
        self.mid_tables = self.pre_chain.out_tables

    def _with_rules(self, state: dict) -> dict:
        """Attach the rule tensors to a family's init state: one 0-d
        tensor a rule on the program's device, plus the applied-update
        counter."""
        if self.ruleset is None:
            return state
        state[RULES_KEY] = self.ruleset.device_leaves(self.device)
        state[RULE_VERSION_KEY] = torch.tensor(
            self.ruleset.version, dtype=torch.int64, device=self.device)
        return state

    # -- snapshots (runtime/checkpoint.py) ---------------------------------
    # A snapshot holds the state in the JAX package's layout, so that
    # either package restores the other's: every family converts its live
    # state with state_to_jax_numpy (on the device, then one copy to the
    # host) and back with state_from_jax_numpy (onto the program's own
    # device). The rule leaves ride both ways here.

    def _rules_to_jax_numpy(self, state: dict, out: dict) -> dict:
        if RULES_KEY in state:
            out[RULES_KEY] = {k: to_host(v) for k, v in state[RULES_KEY].items()}
            out[RULE_VERSION_KEY] = to_host(state[RULE_VERSION_KEY])
        return out

    def _rules_from_jax_numpy(self, state: dict, state_np: dict) -> dict:
        """The rule leaves of ``state_np`` on this program's device, or,
        for a state that carries none, the RuleSet's current ones."""
        if self.ruleset is None:
            return state
        if RULES_KEY not in state_np:
            return self._with_rules(state)
        state[RULES_KEY] = {
            k: torch.from_numpy(np.array(v)).to(self.device)
            for k, v in state_np[RULES_KEY].items()
        }
        state[RULE_VERSION_KEY] = torch.tensor(
            int(state_np[RULE_VERSION_KEY]), dtype=torch.int64,
            device=self.device)
        return state

    def jax_state_spec(self, key_capacity: int = None) -> dict:
        """The state's layout in the JAX package's form at
        ``key_capacity``: the dict :meth:`state_to_jax_numpy` returns,
        with every device leaf a zero-memory array of its shape and
        dtype. Built on the ``meta`` device, so no state is allocated."""
        dev = self.device
        self.device = torch.device("meta")
        try:
            return self.state_to_jax_numpy(self.init_state(key_capacity))
        finally:
            self.device = dev

    # the reference's state_specs shard a leaf of this rank or more on
    # the key axis (tpustream/runtime/step.py BaseProgram.state_specs)
    KEY_AXIS_MIN_NDIM = 2

    def key_sharded_leaves(self, spec: dict) -> dict:
        """``spec`` (a :meth:`jax_state_spec`) with each leaf replaced by
        whether the reference's ``state_specs`` shard it on the key axis:
        by rank here, never a rule leaf. A restore grows such a leaf's
        leading key rows (the state audit's TSM043 reads it)."""
        out = tree_unflatten(spec, [np.ndim(x) >= self.KEY_AXIS_MIN_NDIM
                                    for x in tree_leaves(spec)])
        for k in (RULES_KEY, RULE_VERSION_KEY):
            if k in out:
                out[k] = all_false(out[k])
        return out

    def obs_state_scalars(self, state: dict) -> dict:
        """The OBS_STATE_SCALARS this program keeps in ``state`` as host
        ints (reading them never waits on the card)."""
        return {n: state[n] for n in self.OBS_STATE_SCALARS
                if isinstance(state.get(n), (int, np.integer))}

    def run_step(self, state: dict, cols, valid, ts=None, wm_lower=None) -> tuple:
        """:meth:`step` with the rules bound: the rule tensors leave the
        state for the step (the families see their own layout), every
        RuleParam of the job resolves to its tensor inside it, and they
        come back unchanged. Updates write them between steps."""
        if self.ruleset is None:
            return self.step(state, cols, valid, ts, wm_lower)
        rules, version = state[RULES_KEY], state[RULE_VERSION_KEY]
        inner = {k: v for k, v in state.items()
                 if k not in (RULES_KEY, RULE_VERSION_KEY)}
        with self.ruleset.bound(rules):
            new_state, emissions = self.step(inner, cols, valid, ts, wm_lower)
        new_state[RULES_KEY], new_state[RULE_VERSION_KEY] = rules, version
        return new_state, emissions

    def _apply_pre(self, cols, valid):
        """Run the pre chain over the visible record columns; the
        synthetic derived-key column (if any) bypasses user ops and
        reattaches as the trailing column."""
        if self.plan.synthetic_key:
            out, mask = self.pre_chain.apply(list(cols[:-1]), valid)
            return list(out) + [cols[-1]], mask
        return self.pre_chain.apply(cols, valid)

    def _split_key_col(self, mid_cols):
        """(visible mid cols, raw key column)."""
        if self.plan.synthetic_key:
            return list(mid_cols[:-1]), mid_cols[-1]
        return list(mid_cols), mid_cols[self.key_pos]

    def key_table(self):
        """Intern table of the key ids (None for a non-string key)."""
        if self.plan.synthetic_key:
            return self.plan.tables[-1] if self.plan.tables else None
        return self.mid_tables[self.key_pos]

    # -- SPMD hooks (tpustream/runtime/step.py:272-313): the identity on
    # one device; the shards of a sharded program (runtime/sharded.py)
    # bind them to the mesh's collectives ---------------------------------
    n_shards = 1
    shard = 0  # this program's shard (runtime/sharded.py)

    def _global_key_id(self, local_row: int) -> int:
        """A host int: this shard's state row -> global key id."""
        return int(local_row) * self.n_shards + self.shard

    def _row_offset(self, n_local_rows: int) -> int:
        """Offset of this shard's emission rows in the concatenated
        output (0 on one device; ``shard * n_local_rows`` on a mesh)."""
        return 0

    def _global_max(self, x):
        """``x`` maximized over the shards (host int or 0-d tensor)."""
        return x

    def _global_sum(self, x):
        """``x`` summed over the shards."""
        return x

    def _exchange(self, mid_cols, mask, ts):
        """keyBy: route the records to their key's owner shard. Returns
        ``(cols, mask, ts, overflow)``; on one device nothing moves."""
        return mid_cols, mask, ts, 0

    def _local_keys(self, key_col):
        """Global key id -> this shard's dense state row."""
        return key_col.to(torch.int32)

    def _global_key_ids(self, local_ids):
        """This shard's state row -> global key id."""
        return local_ids.to(torch.int32)

    def rescale_key_leaf(self, arr: np.ndarray, from_parallelism: int):
        """Re-lay a key-sharded leaf (the reference's layout) saved at
        another parallelism onto this program's shard-major layout
        (checkpoint rescale: Flink savepoints restore at any
        parallelism; tpustream/runtime/step.py:162-192).

        Default layout: the leading key axis stacked shard-major, row
        ``shard * k_local + local`` holding global key
        ``local * S + shard``. The global shape does not depend on the
        parallelism, so a rescale is a row permutation through the
        canonical key-major order. WindowProgram overrides it for its
        flat word planes."""
        S_o = max(1, from_parallelism)
        S_n = max(1, self.n_shards)
        if S_o == S_n:
            return arr
        K = arr.shape[0]
        if K % S_o or K % S_n:
            raise ValueError(
                f"cannot rescale keyed state: key_capacity ({K}) must "
                f"divide evenly by both the snapshot parallelism ({S_o}) "
                f"and the target parallelism ({S_n})"
            )
        rest = tuple(range(2, arr.ndim + 1))
        canon = arr.reshape(S_o, K // S_o, *arr.shape[1:]).transpose(
            1, 0, *rest).reshape(arr.shape)
        return np.ascontiguousarray(
            canon.reshape(K // S_n, S_n, *arr.shape[1:]).transpose(
                1, 0, *rest).reshape(arr.shape))

    def grow_key_leaf(self, old: np.ndarray, new_init: np.ndarray,
                      shards: int = None) -> np.ndarray:
        """Copy a key-sharded leaf (the reference's layout) into this
        program's larger key capacity: the shard count is unchanged and
        interned ids are stable, so key ``g`` stays on shard ``g % S`` at
        the same local row; new rows keep ``new_init``'s values
        (tpustream/runtime/step.py:194-230)."""
        S = shards or max(1, self.n_shards)
        k_lo = old.shape[0] // S
        out = np.array(new_init)
        k_ln = out.shape[0] // S
        k = min(k_lo, k_ln)
        out.reshape(S, k_ln, *old.shape[1:])[:, :k] = old.reshape(
            S, k_lo, *old.shape[1:])[:, :k]
        return out


def all_false(tree):
    """``tree``'s structure with False at every leaf."""
    return tree_unflatten(tree, [False] * len(tree_leaves(tree)))


class StatelessProgram(BaseProgram):
    """map/filter-only pipeline (reference chapter1 job,
    chapter1/.../Main.java:15-34).

    The rows the chain keeps are compacted on the device into a prefix
    of the step's output, so the host fetches the kept rows' count and
    then only that many rows: for a sparse filter like the > 90
    threshold, a small part of the batch."""

    operator_name = "stateless"

    main_emission_prefix = True

    def __init__(self, plan: JobPlan, cfg: StreamConfig):
        super().__init__(plan, cfg)
        self.out_kinds = self.mid_kinds
        self.out_tables = self.mid_tables
        # never lossy: a filterless pipeline emits the whole batch
        self.emit_capacity = max(cfg.alert_capacity, cfg.batch_size)
        self.host_reads = 0  # the step reads nothing back itself

    def key_table(self):
        return None  # no key: nothing to grow

    def init_state(self, key_capacity: int = None) -> dict:
        return self._with_rules({"alert_overflow": torch.zeros(
            (), dtype=torch.int64, device=self.device)})

    def state_to_jax_numpy(self, state: dict) -> dict:
        return self._rules_to_jax_numpy(
            state, {"alert_overflow": to_host(state["alert_overflow"])})

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        """The reference package's stateless state (the
        ``alert_overflow`` counter, tpustream/runtime/step.py
        StatelessProgram.init_state) on this program's device."""
        return self._rules_from_jax_numpy({"alert_overflow": torch.tensor(
            int(state_np["alert_overflow"]), dtype=torch.int64,
            device=self.device)}, state_np)

    def step(self, state: dict, cols, valid, ts=None, wm_lower=None) -> tuple:
        """One batch: ``cols`` the record's ``[B]`` tensors, ``valid``
        bool[B]. Returns ``(state, {"main": stream})``; the stream's rows
        are the first ``count`` of ``cols``, in arrival order."""
        out_cols, mask = self.pre_chain.apply(cols, valid)
        m = min(mask.shape[0], self.emit_capacity)
        idx, count = pane_ops.compact_positions(mask, m)
        idx = idx.to(torch.int64)
        state["alert_overflow"] += torch.clamp(
            count - self.emit_capacity, min=0).to(torch.int64)
        main = {
            "count": torch.clamp(count, max=self.emit_capacity),
            "cols": tuple(c[idx] for c in out_cols),
        }
        return state, {"main": main}


class RollingProgram(BaseProgram):
    """keyBy + rolling aggregate, emitting per record
    (reference chapter2/.../ComputeCpuMax.java:26). max/min/sum of a
    float64 or int64 field take the kernel's path; max_by, min_by, a user
    reduce and max/min/sum of a string or boolean field take the general
    path (:func:`rolling_ops.rolling_step_general`). Under ``acc_dtype``
    ``"int32"``/``"float32"`` the aggregated field of max/min/sum is
    stored in 32 bits (the reference's ``_compact32``); pass-through
    fields and every other combiner stay exact.

    ``emit_ts`` (set by ``_make_runner_chain`` when an event-time stage is
    downstream): the step's ``main`` stream also carries ``ts``, each
    row's input timestamp, which the rolling aggregate forwards."""

    operator_name = "rolling"
    STATE_COMPONENT_KEYS = {"rolling_planes": ("seen", "planes")}
    KEY_AXIS_MIN_NDIM = 1  # seen [K] and the [K] planes

    def __init__(self, plan: JobPlan, cfg: StreamConfig):
        super().__init__(plan, cfg)
        st = plan.stateful
        if st.kind == "rolling":
            self.kind, self.pos = st.rolling_kind, st.rolling_pos
        else:
            self.kind, self.pos = "reduce", None
        self.key_pos = plan.key_pos
        self.kernel_path = self.kind != "reduce" and rolling_ops.kernel_path(
            self.mid_kinds, self.kind, self.pos)
        # the state layout's kind: the general path's for every combiner
        # the kernel does not fold
        self.layout_kind = self.kind if self.kernel_path else "general"
        # the lossy 32-bit opt-in covers the aggregated field of max/min/
        # sum only (the reference's RollingProgram._compact32); a string
        # or boolean field is 32-bit anyway, so only the kernel's path
        # changes layout
        self.compact32 = bool(self.kernel_path and str(cfg.acc_dtype) in (
            "int32", "float32"))
        if self.kind == "reduce":
            self.combine = record_combiner(
                as_callable(st.rolling_fn, "reduce"), self.mid_kinds,
                self.mid_tables)
        elif not self.kernel_path:
            self.combine = rolling_ops.make_combiner(self.kind, self.pos)
        self.post_chain = DeviceChain(
            plan.device_post, self.mid_kinds, self.mid_tables
        )
        self.out_kinds = self.post_chain.out_kinds
        self.out_tables = self.post_chain.out_tables
        # rows whose key id passed the state's capacity, counted on the
        # device; the Runner reads it with each step's fetch
        self.bad_keys = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.host_reads = 0  # the step reads nothing back itself

    @property
    def sentinel_leaf(self):
        """Keep-first STR leaf whose plane doubles as occupancy (interned
        ids >= 0; -1 marks unseen); the kernel's path only."""
        if not self.kernel_path:
            return None
        for i, kd in enumerate(self.mid_kinds):
            if kd == STR and i != self.pos and i != self.key_pos:
                return i
        return None

    def init_state(self, key_capacity: int = None) -> dict:
        return self._with_rules(rolling_ops.init_rolling_state(
            key_capacity or self.cfg.key_capacity, self.mid_kinds,
            self.layout_kind, self.pos, sentinel_leaf=self.sentinel_leaf,
            device=self.device, compact32=self.compact32,
        ))

    def grow_state(self, state: dict, key_capacity: int) -> dict:
        return self._with_rules(rolling_ops.grow_rolling_state(
            state, key_capacity, self.mid_kinds, self.layout_kind, self.pos,
            sentinel_leaf=self.sentinel_leaf, compact32=self.compact32,
        ))

    def state_to_jax_numpy(self, state: dict) -> dict:
        """The inverse of :meth:`state_from_jax_numpy`: on the kernel's
        path a never-seen row's aggregate goes back to 0, an int64
        aggregate back to its two int32 words (low, high), and with a
        ``sentinel_leaf`` occupancy lives in the sentinel plane only
        (``seen`` all False), as the reference keeps them. A 32-bit
        aggregated plane is the reference's already."""
        planes, seen = list(state["planes"]), state["seen"]
        if self.kernel_path:
            kinds, pos = self.mid_kinds, self.pos
            slices = rolling_ops.plane_layout(kinds, self.kind, pos,
                                              self.compact32)[1]
            sentinel = self.sentinel_leaf
            if sentinel is not None:
                seen = torch.zeros(seen.shape, dtype=torch.bool,
                                   device=seen.device)
        if self.kernel_path and not self.compact32:
            agg = low = high = planes[slices[pos].start]
            # a leaf spec (the meta device) needs the layout only: an
            # arithmetic op there would load torch's Python meta kernels
            if agg.device.type != "meta":
                occupied = (planes[slices[sentinel].start] >= 0
                            if sentinel is not None else state["seen"])
                agg = torch.where(occupied, agg, torch.zeros_like(agg))
                if kinds[pos] == I64:
                    low = ((agg & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
                    high = agg >> 32
            if kinds[pos] == I64:
                planes[slices[pos]] = [low.to(torch.int32),
                                       high.to(torch.int32)]
            else:
                planes[slices[pos].start] = agg
        return self._rules_to_jax_numpy(state, {
            "seen": to_host(seen), "planes": [to_host(p) for p in planes]})

    def state_from_jax_numpy(self, state_np: dict) -> dict:
        """The reference package's rolling state
        (:func:`rolling_ops.state_from_jax_numpy`) on this program's
        device."""
        state = rolling_ops.state_from_jax_numpy(
            state_np, self.mid_kinds, self.kind, self.pos,
            self.sentinel_leaf, self.device, compact32=self.compact32)
        return self._rules_from_jax_numpy(state, state_np)

    def step(self, state: dict, cols, valid, ts=None, wm_lower=None) -> tuple:
        """One batch: ``cols`` are the record's ``[B]`` tensors, ``valid``
        bool[B]; a rolling aggregate has no clock, so ``wm_lower`` is
        ignored, and so is ``ts`` unless ``emit_ts`` is set. Returns
        ``(state, {"main": stream})``; the stream's rows are in arrival
        order: ``mask`` (rows that emit), ``cols`` and ``subtask`` (the
        key's owning subtask, for the print prefix), and with ``emit_ts``
        ``ts``; ``bad_keys`` counts rows whose key id was past the
        capacity, which makes the step's output void."""
        mid_cols, mask = self._apply_pre(cols, valid)
        # keyBy: route the records to their key's owner shard
        mid_cols, mask, ts, _ = self._exchange(mid_cols, mask, ts)
        mid_cols, gkeys = self._split_key_col(mid_cols)
        keys = self._local_keys(gkeys)
        if not self.kernel_path:
            state, emitted = rolling_ops.rolling_step_general(
                state, keys, tuple(mid_cols), mask, self.combine,
                self.mid_kinds, bad_keys=self.bad_keys,
            )
            return state, {"main": self._main(emitted, mask, keys, ts)}
        kwargs: Dict = {"sentinel_leaf": self.sentinel_leaf,
                        "bad_keys": self.bad_keys,
                        "compact32": self.compact32}
        key_kind = None if self.plan.synthetic_key else self.mid_kinds[self.key_pos]
        if self.key_pos != self.pos and key_kind in (STR, I64):
            # key column is key-invariant: emit it straight from the key
            # ids and never touch its state plane
            dt = torch.int32 if key_kind == STR else torch.int64
            kwargs["key_col"] = self.key_pos
            kwargs["key_emit"] = lambda k: self._global_key_ids(k).to(dt)
        state, emitted = rolling_ops.rolling_step(
            state, keys, tuple(mid_cols), mask, self.mid_kinds,
            self.kind, self.pos, **kwargs,
        )
        return state, {"main": self._main(emitted, mask, keys, ts)}

    def _main(self, emitted, mask, keys, ts) -> dict:
        """The step's output stream: the post chain over the arrival-order
        emissions, each row's owning subtask and, with ``emit_ts``, its
        input timestamp."""
        out_cols, out_mask = self.post_chain.apply(list(emitted), mask)
        n_shards = max(1, self.cfg.parallelism)
        # the key's owner from the GLOBAL key id (the print prefix)
        subtask = self._global_key_ids(torch.where(mask, keys, 0)) % n_shards
        main = {"mask": out_mask, "cols": tuple(out_cols), "subtask": subtask,
                "bad_keys": self.bad_keys}
        if self.emit_ts:
            main["ts"] = ts
        return main


def build_program(plan: JobPlan, cfg: StreamConfig) -> BaseProgram:
    """The program of ``plan``'s stateful operator; at ``parallelism > 1``
    its sharded variant (``runtime/sharded.py``), as the reference
    dispatches (tpustream/runtime/step.py:485-560)."""
    sharded = cfg.parallelism > 1
    if plan.stateful is None:
        return StatelessProgram(plan, cfg)
    if sharded:
        from . import sharded as sh
    if plan.stateful.kind in ("rolling", "rolling_reduce"):
        return (sh.ShardedRollingProgram if sharded else RollingProgram)(
            plan, cfg)
    if plan.stateful.kind == "window":
        spec = plan.stateful.window
        if spec is not None and spec.kind == "count":
            from .count_program import (
                CountProcessProgram,
                CountWindowProgram,
                SlidingCountWindowProgram,
            )

            if plan.stateful.apply_kind == "process":
                return (sh.ShardedCountProcessProgram if sharded
                        else CountProcessProgram)(plan, cfg)
            if spec.count_slide and spec.count_slide != spec.count:
                return (sh.ShardedSlidingCountWindowProgram if sharded
                        else SlidingCountWindowProgram)(plan, cfg)
            return (sh.ShardedCountWindowProgram if sharded
                    else CountWindowProgram)(plan, cfg)
        if spec is not None and spec.kind == "session":
            from .session_program import SessionProcessProgram, SessionWindowProgram

            if plan.stateful.apply_kind == "process":
                return (sh.ShardedSessionProcessProgram if sharded
                        else SessionProcessProgram)(plan, cfg)
            return (sh.ShardedSessionWindowProgram if sharded
                    else SessionWindowProgram)(plan, cfg)
        if plan.stateful.apply_kind == "process":
            from .process_program import ProcessWindowProgram

            return (sh.ShardedProcessWindowProgram if sharded
                    else ProcessWindowProgram)(plan, cfg)
        from .window_program import WindowProgram

        return (sh.ShardedWindowProgram if sharded else WindowProgram)(
            plan, cfg)
    if plan.stateful.kind == "cep":
        from .cep_program import CepProgram

        return (sh.ShardedCepProgram if sharded else CepProgram)(plan, cfg)
    raise NotImplementedError(f"unknown stateful operator {plan.stateful.kind}")
