"""Device programs: one ``(state, batch) -> (state, emissions)`` step per
job, run eagerly with PyTorch on ``StreamConfig.device``.

Counterpart of tpustream/runtime/step.py for one device. Ported: the
keyed rolling max/min/sum (``RollingProgram``) and the tumbling/sliding
window ``reduce`` (``window_program.WindowProgram``). Every other program
family, and ``parallelism > 1``, raises ``NotImplementedError`` from
:func:`build_program`. A step takes ``(state, cols, valid, ts,
wm_lower)``, as in the reference.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import StreamConfig
from ..ops import rolling as rolling_ops
from ..records import I64, STR
from .device import DeviceChain
from .plan import JobPlan


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

    def __init__(self, plan: JobPlan, cfg: StreamConfig):
        self.plan = plan
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        # the pre chain wraps the VISIBLE record: a computed-KeySelector
        # job's synthetic trailing key column never reaches user ops
        in_kinds, in_tables = plan.record_kinds, plan.tables
        if plan.synthetic_key and in_kinds:
            in_kinds, in_tables = in_kinds[:-1], in_tables[:-1]
        self.pre_chain = DeviceChain(plan.device_pre, in_kinds, in_tables)
        self.mid_kinds = self.pre_chain.out_kinds
        self.mid_tables = self.pre_chain.out_tables

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


class RollingProgram(BaseProgram):
    """keyBy + rolling max/min/sum, emitting per record
    (reference chapter2/.../ComputeCpuMax.java:26)."""

    def __init__(self, plan: JobPlan, cfg: StreamConfig):
        super().__init__(plan, cfg)
        st = plan.stateful
        if st.kind != "rolling" or st.rolling_kind not in rolling_ops.COMMUTATIVE:
            what = "a user reduce" if st.kind == "rolling_reduce" else st.rolling_kind
            raise NotImplementedError(
                f"rolling {what} is not ported to the PyTorch runtime yet: "
                f"only max/min/sum are (the general rolling path waits)"
            )
        if str(cfg.acc_dtype) != "float64":
            raise NotImplementedError(
                f"acc_dtype={cfg.acc_dtype!r} is not ported to the PyTorch "
                f"runtime yet: only the exact float64 accumulator is"
            )
        self.kind = st.rolling_kind
        self.pos = st.rolling_pos
        self.key_pos = plan.key_pos
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
        ids >= 0; -1 marks unseen)."""
        for i, kd in enumerate(self.mid_kinds):
            if kd == STR and i != self.pos and i != self.key_pos:
                return i
        return None

    def init_state(self, key_capacity: int = None) -> dict:
        return rolling_ops.init_rolling_state(
            key_capacity or self.cfg.key_capacity, self.mid_kinds, self.kind,
            self.pos, sentinel_leaf=self.sentinel_leaf, device=self.device,
        )

    def grow_state(self, state: dict, key_capacity: int) -> dict:
        return rolling_ops.grow_rolling_state(
            state, key_capacity, self.mid_kinds, self.kind, self.pos,
            sentinel_leaf=self.sentinel_leaf,
        )

    def step(self, state: dict, cols, valid, ts=None, wm_lower=None) -> tuple:
        """One batch: ``cols`` are the record's ``[B]`` tensors, ``valid``
        bool[B]; a rolling aggregate has no clock, so ``ts`` and
        ``wm_lower`` are ignored. Returns ``(state, {"main": stream})``; the stream's rows
        are in arrival order: ``mask`` (rows that emit), ``cols`` and
        ``subtask`` (the key's owning subtask, for the print prefix);
        ``bad_keys`` counts rows whose key id was past the capacity, which
        makes the step's output void."""
        mid_cols, mask = self._apply_pre(cols, valid)
        mid_cols, gkeys = self._split_key_col(mid_cols)
        keys = gkeys.to(torch.int32)
        kwargs: Dict = {"sentinel_leaf": self.sentinel_leaf,
                        "bad_keys": self.bad_keys}
        key_kind = None if self.plan.synthetic_key else self.mid_kinds[self.key_pos]
        if self.key_pos != self.pos and key_kind in (STR, I64):
            # key column is key-invariant: emit it straight from the key
            # ids and never touch its state plane
            dt = torch.int32 if key_kind == STR else torch.int64
            kwargs["key_col"] = self.key_pos
            kwargs["key_emit"] = lambda k: k.to(dt)
        state, emitted = rolling_ops.rolling_step(
            state, keys, tuple(mid_cols), mask, self.mid_kinds,
            self.kind, self.pos, **kwargs,
        )
        out_cols, out_mask = self.post_chain.apply(list(emitted), mask)
        n_shards = max(1, self.cfg.parallelism)
        subtask = torch.where(mask, keys, 0) % n_shards
        main = {"mask": out_mask, "cols": tuple(out_cols), "subtask": subtask,
                "bad_keys": self.bad_keys}
        return state, {"main": main}


def build_program(plan: JobPlan, cfg: StreamConfig) -> BaseProgram:
    if cfg.parallelism > 1:
        raise NotImplementedError(
            f"parallelism={cfg.parallelism} is not ported to the PyTorch "
            f"runtime yet: it runs on one device"
        )
    if plan.stateful is None:
        raise NotImplementedError(
            "stateless map/filter jobs are not ported to the PyTorch "
            "runtime yet"
        )
    if plan.stateful.kind in ("rolling", "rolling_reduce"):
        return RollingProgram(plan, cfg)
    if plan.stateful.kind == "window":
        from .window_program import WindowProgram

        return WindowProgram(plan, cfg)
    raise NotImplementedError(
        f"{plan.stateful.kind} programs are not ported to the PyTorch "
        f"runtime yet"
    )
