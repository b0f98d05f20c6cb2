"""Job execution: the host pipeline driving the PyTorch device program.

Counterpart of tpustream/runtime/executor.py, single device, in order:
the host turns source lines into columnar batches (``HostStage``), the
``Runner`` uploads each batch to ``StreamConfig.device``, runs one
program step, fetches the emissions and hands them to the sinks, and the
stream ends when the source yields its final batch. Output bytes match
the reference's for the same input.

Time: each step gets the batch's event timestamps (event time) or
processing timestamps, and a watermark floor from the host clock
(``proc_now - 1`` in processing time). A processing-time tick
(``AdvanceProcessingTime``) runs an empty step at the new clock, and the
end of the stream runs one at ``MAX_WATERMARK`` (event time) or at the
clock (processing time), so every remaining window fires. Under
``max_fires_per_step`` empty steps drain deferred fires after each step.

Emissions reach the sinks in the reference's order: a full-window
``process()`` program's fires are evaluated on the host against the
state the step left (before the next step), then the ``main`` stream's
rows go to every branch, then the rows late past the allowed lateness
go to each late-data side output, then a CEP program's expired partial
matches go to its timeout tag's side output (and only there).

Dynamic rules: a job with a broadcast control stream gets its control
feed from ``plan.broadcast``; a source batch is split at each pending
update's record position, rows before it run under the old rules, the
update lands (the chain drains, the RuleSet applies it, every stage's
rule tensors are written in place: :meth:`Runner.refresh_rules`) and the
rest runs under the new; updates positioned at or past the last record
apply before the end-of-stream flush.

Chained keyed stages (a ``key_by`` after a keyed operator) run as one
``Runner`` a stage, each feeding the next through the host as columns
(:meth:`Runner.pump_chain`, after every source batch): window and
session results in fire order, with Flink's result timestamp ``end - 1``
when an event-time stage is downstream; rolling results in arrival
order, with the record's timestamp; a ``process()`` stage's collected
rows, whose schema the next stage infers from them. A computed key on a
chain stage is derived from each hand-off batch.

Parse: a raw-bytes source batch goes through the native parser in one
pass (:meth:`HostStage.process_raw`) where the job's host stage allows
it, and through the line path otherwise. A punctuated watermark
assigner's per-batch maximum watermark raises the step's watermark
floor.

Not ported here, and refused by :func:`execute_job` rather than ignored:
checkpoints and restore, supervised restarts, the observability layer,
ingest lanes and dead-letter quarantine. The reference's pipelining knobs
(``async_depth``, ``h2d_depth``, ``fetch_group``, wire compression)
change no output and are not read.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api.functions import as_callable
from ..api.timeapi import TimeCharacteristic
from ..api.watermarks import LONG_MIN, MAX_WATERMARK, AssignerWithPunctuatedWatermarks
from ..config import StreamConfig
from ..hostparse import PlanEvaluator, run_fallback_map
from ..ops.panes import compact_positions
from ..records import (
    BOOL,
    F64,
    I64,
    NUMPY_DTYPES,
    STR,
    Batch,
    Column,
    DerivedKeyTable,
    StringTable,
)
from .metrics import Metrics, Stopwatch
from .plan import JobPlan, build_plan_chain
from .sinks import CollectSink, EmissionFormatter, FnSink, PrintSink
from .step import RULE_VERSION_KEY, RULES_KEY, build_program, resolve_device


class HostStage:
    """Raw lines -> columnar Batch (parse, timestamps, raw-stage ops)."""

    def __init__(self, plan: JobPlan, cfg: StreamConfig):
        self.plan = plan
        self.cfg = cfg
        self._ts_eval: Optional[PlanEvaluator] = None
        self._map_evals: Dict[int, PlanEvaluator] = {}
        self._raw_eval: Optional[PlanEvaluator] = None  # [ts?] + outputs
        self._raw_eval_built = False
        self._raw_has_ts = False
        if plan.ts_expr is not None:
            self._ts_eval = PlanEvaluator([plan.ts_expr], [None])

    def parse_counts(self) -> Dict[str, int]:
        """Parse-plan evaluations so far, by path: ``native`` (the C++
        parser) and ``numpy``."""
        evs = list(self._map_evals.values())
        evs += [e for e in (self._ts_eval, self._raw_eval) if e is not None]
        return {"native": sum(e.native_calls for e in evs),
                "numpy": sum(e.numpy_calls for e in evs)}

    def _build_raw_eval(self) -> Optional[PlanEvaluator]:
        """One native parse pass computing the event-time column (when
        assigned) AND the parse map's output columns straight from a raw
        byte buffer, with no per-line Python object. None when the job's
        host stage can't take it (a computed key, a fallback map, a
        raw-stage filter or flat_map, an untraceable timestamp extractor,
        punctuated watermarks) or the native parser is unavailable."""
        plan = self.plan
        if plan.synthetic_key or len(plan.host_ops) != 1:
            return None
        hop = plan.host_ops[0]
        if hop.op != "map" or hop.plan is None or hop.plan.fallback_fn is not None:
            return None
        if plan.ts_assigner is not None and plan.ts_expr is None:
            return None
        if isinstance(plan.ts_assigner, AssignerWithPunctuatedWatermarks):
            return None
        exprs, tbls = [], []
        self._raw_has_ts = plan.ts_expr is not None
        if self._raw_has_ts:
            exprs.append(plan.ts_expr)
            tbls.append(None)
        exprs.extend(hop.plan.outputs)
        tbls.extend(
            t if k == STR else None
            for k, t in zip(plan.record_kinds, plan.tables)
        )
        ev = PlanEvaluator(exprs, tbls)
        return ev if ev._native is not None else None

    def process_raw(self, raw: bytes, n: int, proc_ts: np.ndarray):
        """Raw-buffer twin of :meth:`process`: ``(Batch, wm_hint)``, or
        ``(None, None)`` when the native lane can't parse this batch (the
        caller then decodes it and takes the line path)."""
        if not n:
            return None, None
        if not self._raw_eval_built:
            self._raw_eval = self._build_raw_eval()
            self._raw_eval_built = True
        if self._raw_eval is None:
            return None, None
        cols = self._raw_eval.parse_bytes(raw, n)
        if cols is None:
            return None, None
        ts = None
        if self._raw_has_ts:
            ts = np.asarray(cols[0], dtype=np.int64)
            cols = cols[1:]
        plan = self.plan
        columns = [
            Column(k, c, t)
            for k, c, t in zip(plan.record_kinds, cols, plan.tables)
        ]
        return Batch(n, columns, ts=ts, proc_ts=proc_ts), None

    @staticmethod
    def _append_synthetic_schema(plan) -> None:
        """Adaptive parse schemas resolve on the first batch; the
        computed-KeySelector column appends right after."""
        if plan.synthetic_key:
            plan.record_kinds.append(STR)
            plan.tables.append(DerivedKeyTable())

    def _timestamps(self, lines: List[str]) -> Optional[np.ndarray]:
        plan = self.plan
        if plan.ts_assigner is None:
            return None
        if self._ts_eval is not None:
            (ts,) = self._ts_eval(lines)
            return np.asarray(ts, dtype=np.int64)
        extract = plan.ts_assigner.extract_timestamp
        return np.asarray([extract(l) for l in lines], dtype=np.int64)

    def _punctuated_wm(self, lines: List[str], ts: np.ndarray) -> Optional[int]:
        """The largest watermark a punctuated assigner returns for this
        batch's lines (None when it returns none, or the assigner is not
        punctuated)."""
        a = self.plan.ts_assigner
        if not isinstance(a, AssignerWithPunctuatedWatermarks):
            return None
        wm = None
        for line, t in zip(lines, ts):
            w = a.check_and_get_next_watermark(line, int(t))
            if w is not None:
                wm = w.timestamp if wm is None else max(wm, w.timestamp)
        return wm

    def process(self, lines: List[str], proc_ts: np.ndarray):
        """``(Batch, wm_hint)``: the parsed Batch (None for empty input)
        and the batch's punctuated watermark, if any."""
        plan = self.plan
        if not lines:
            return None, None
        ts = self._timestamps(lines)
        wm_hint = self._punctuated_wm(lines, ts) if ts is not None else None
        cols: Optional[List[np.ndarray]] = None
        for i, hop in enumerate(plan.host_ops):
            if hop.op == "filter":
                fn = as_callable(hop.fn, "filter")
                keep = [bool(fn(l)) for l in lines]
                lines = [l for l, k in zip(lines, keep) if k]
                sel = np.asarray(keep, dtype=bool)
                proc_ts = proc_ts[sel]
                if ts is not None:
                    ts = ts[sel]
                if not lines:
                    return None, wm_hint
                continue
            if hop.op == "flat_map":
                fn = as_callable(hop.fn, "flat_map")
                new_lines, new_proc, new_ts = [], [], []
                for j, l in enumerate(lines):
                    outs = list(fn(l))
                    new_lines.extend(outs)
                    new_proc.extend([proc_ts[j]] * len(outs))
                    if ts is not None:
                        new_ts.extend([ts[j]] * len(outs))
                lines = new_lines
                proc_ts = np.asarray(new_proc, dtype=np.int64)
                ts = np.asarray(new_ts, dtype=np.int64) if ts is not None else None
                if not lines:
                    return None, wm_hint
                continue
            # map: symbolic fast path or per-record fallback
            if hop.plan is not None and hop.plan.fallback_fn is None:
                ev = self._map_evals.get(i)
                if ev is None:
                    tables = [
                        t if k == STR else None
                        for k, t in zip(plan.record_kinds, plan.tables)
                    ]
                    ev = PlanEvaluator(hop.plan.outputs, tables)
                    self._map_evals[i] = ev
                cols = ev(lines)
            else:
                fb = hop.plan.fallback_fn if hop.plan else as_callable(hop.fn, "map")
                cols, kinds = run_fallback_map(fb, lines, plan.tables)
                if not plan.record_kinds:
                    plan.record_kinds.extend(kinds)
                    self._append_synthetic_schema(plan)
            break  # planner guarantees ops after the parse map are device-side

        if cols is None:
            # stream stays raw strings: one interned STR column
            if not plan.record_kinds:
                plan.record_kinds.append(STR)
                plan.tables.append(StringTable())
                self._append_synthetic_schema(plan)
            cols = [plan.tables[0].intern_many(lines)]

        if plan.synthetic_key:
            cols = list(cols) + [derive_key_column(plan, cols, len(lines))]

        columns = [
            Column(k, c, t)
            for k, c, t in zip(plan.record_kinds, cols, plan.tables)
        ]
        return Batch(len(lines), columns, ts=ts, proc_ts=proc_ts), wm_hint


def derive_key_column(plan, cols, n: int) -> np.ndarray:
    """Computed-KeySelector fallback: reconstruct each visible record
    from its columns, run the user selector, intern the result into the
    plan's trailing DerivedKeyTable (per-record Python). Used by the host
    parse stage and by the chain glue when a CHAIN stage keys by a
    computed selector. Rows that a filter between the parse map (or the
    re-key hand-off) and the key_by drops get the table's reserved
    PLACEHOLDER_ID, so a partial selector never sees them."""
    from ..api.tuples import make_tuple

    kinds = plan.record_kinds[:-1]
    tables = plan.tables[:-1]
    fn = plan.derived_key_fn  # already resolved to a callable
    filters = [
        as_callable(f, "filter")
        for op, f in plan.device_pre
        if op == "filter"
    ]
    vals = np.full(n, DerivedKeyTable.PLACEHOLDER_ID, dtype=np.int32)
    for j in range(n):
        fields = []
        for k, t, c in zip(kinds, tables, cols):
            v = c[j]
            if k == STR:
                fields.append(t.lookup(int(v)))
            elif k == "f64":
                fields.append(float(v))
            elif k == "bool":
                fields.append(bool(v))
            else:
                fields.append(int(v))
        rec = fields[0] if len(fields) == 1 else make_tuple(*fields)
        if all(f(rec) for f in filters):
            vals[j] = plan.tables[-1].intern_value(fn(rec))
    return vals


def _row_fields(row) -> list:
    """Positional fields of a user-collected row (Tuple / tuple / scalar)."""
    from ..api.tuples import TupleBase

    return list(row) if isinstance(row, (TupleBase, tuple)) else [row]


def _infer_row_kinds(rows) -> List[str]:
    """Column kinds for user-collected rows, WIDENED across every row
    (any str -> STR; else all bool -> BOOL; else any float -> F64; else
    I64)."""
    fields = [_row_fields(r) for r in rows]
    arity = len(fields[0])
    for f in fields:
        if len(f) != arity:
            raise ValueError(
                f"chained process() stage collected rows of mixed arity "
                f"({arity} vs {len(f)}); emit one consistent shape"
            )
    kinds = []
    for i in range(arity):
        vs = [f[i] for f in fields]
        if any(isinstance(v, str) for v in vs):
            kinds.append(STR)
        elif all(isinstance(v, bool) for v in vs):
            kinds.append(BOOL)
        elif any(isinstance(v, float) for v in vs):
            kinds.append(F64)
        else:
            kinds.append(I64)
    return kinds


def _bind_ops(ops):
    """Pre-resolve (op, fn) pairs to callables for per-record replay."""
    return [(op, as_callable(fn, op)) for op, fn in ops]


def _apply_ops(bound_ops, item):
    """Run a map/filter tail over one record; (item, kept)."""
    for op, fn in bound_ops:
        if op == "map":
            item = fn(item)
        elif not fn(item):
            return item, False
    return item, True


class JobResult:
    def __init__(self, metrics: Metrics):
        self.metrics = metrics

    def summary(self) -> dict:
        return self.metrics.summary()


def _make_sinks(plan: JobPlan, cfg: StreamConfig):
    """``(main, side)``: (host-side branch ops, sink) per main branch, and
    per side-output tag id; the ops run over the fetched emissions, as in
    the reference's stream fan-out."""
    pp = cfg.print_parallelism if cfg.print_parallelism is not None else cfg.parallelism

    def build_sink(node):
        if node.op == "sink_print":
            return PrintSink(parallelism=pp)
        if node.op == "sink_collect":
            return CollectSink(node.params["handle"])
        return FnSink(node.params["fn"])

    main = [
        (_bind_ops(branch.ops), build_sink(branch.sink_node))
        for branch in plan.branches
    ]
    side = {
        so.tag.id: (_bind_ops(so.ops), build_sink(so.sink_node))
        for so in plan.side_outputs
    }
    return main, side


class Runner:
    """Feeds batches through the program on its device and fans the
    emissions out to the sinks, or, for a stage with a ``downstream``
    stage, buffers them for :meth:`pump_chain`."""

    _COUNTER_NAMES = (
        "window_fires", "late_dropped", "alert_overflow", "buffer_overflow",
        "evicted_unfired", "exchange_overflow", "cep_matches", "cep_timeouts",
    )

    def __init__(self, plan: JobPlan, cfg: StreamConfig, metrics: Metrics):
        self.plan = plan
        self.cfg = cfg
        self.metrics = metrics
        self.program = build_program(plan, cfg)
        self.device = self.program.device
        self.state = self.program.init_state()
        self.sinks, self.side_sinks = _make_sinks(plan, cfg)
        # a host-evaluated window's post map/filter tail
        self.post_ops = _bind_ops(plan.device_post)
        self.formatter = EmissionFormatter(
            self.program.out_kinds, self.program.out_tables
        )
        self.late_formatter = EmissionFormatter(
            self.program.mid_kinds, self.program.mid_tables
        )
        self.event_time = plan.time_characteristic == TimeCharacteristic.EventTime
        self._empty: Optional[Batch] = None
        # chained stages: emissions feed the downstream runner as
        # columnar batches instead of the sinks. _chain_buf holds
        # (cols, ts or None) a step; _chain_rows (item, ts, order) from
        # process() fires; _lazy_plans the stages after a process()
        # stage, built once its collected rows give their schema
        self.downstream: Optional["Runner"] = None
        self._chain_buf: List[tuple] = []
        self._chain_rows: List[tuple] = []
        self._lazy_plans: List[JobPlan] = []
        self._chain_ts = False  # an event-time stage is downstream
        self._last_tick: Optional[int] = None
        self.count_input = True  # False for a stage fed by another

    # -- chained stages ---------------------------------------------------

    def chain_to(self, downstream: "Runner") -> None:
        self.downstream = downstream
        downstream.count_input = False

    def chain(self) -> List["Runner"]:
        out, r = [], self
        while r is not None:
            out.append(r)
            r = r.downstream
        return out

    @property
    def _chained(self) -> bool:
        return self.downstream is not None or bool(self._lazy_plans)

    @staticmethod
    def _downstream_is_event_time(d: "Runner") -> bool:
        return getattr(d.program, "domain", None) == TimeCharacteristic.EventTime

    def _build_lazy_downstream(self) -> "Runner":
        """A process()-fed chain resolves the downstream record schema
        from the buffered collected rows (the user function may emit any
        shape), then builds the remaining runner chain. Kinds WIDEN
        across all buffered rows: a median emits ints on odd counts and
        floats on even ones, and first-row inference would silently
        truncate the floats."""
        kinds = _infer_row_kinds([item for item, _, _ in self._chain_rows])
        p2 = self._lazy_plans[0]
        p2.record_kinds.extend(kinds)
        p2.tables.extend(StringTable() if k == STR else None for k in kinds)
        if p2.synthetic_key:
            p2.record_kinds.append(STR)
            p2.tables.append(DerivedKeyTable())
        d = _make_runner_chain(self._lazy_plans, self.cfg, self.metrics)
        self._lazy_plans = []
        self.chain_to(d)
        _wire_chain_ts(self, d)
        return d

    def _rows_to_cols(self):
        """Convert buffered process() rows to the downstream's columnar
        schema (established at the lazy build; values coerce to the
        widened plan kinds). A later emission of another type fails."""
        rows = [item for item, _, _ in self._chain_rows]
        ts = (
            np.asarray([t for _, t, _ in self._chain_rows], dtype=np.int64)
            if self._chain_ts
            else None
        )
        d = self.downstream
        kinds, tables = d.plan.record_kinds, d.plan.tables
        if d.plan.synthetic_key:
            # visible columns only; pump_chain appends the derived key
            kinds, tables = kinds[:-1], tables[:-1]
        fields = [_row_fields(r) for r in rows]

        def _bad(i, what, kind, hint=""):
            # the schema froze at the first pump; a later emission of a
            # different type would otherwise coerce silently (int ->
            # True, float -> truncated int) or die in an opaque numpy
            # TypeError (str under np.floor)
            raise ValueError(
                f"chained process() stage emitted a {what} value in "
                f"field {i} after its schema was inferred as {kind} "
                f"from earlier rows; emit one consistent type{hint}"
            )

        cols = []
        for i, (k, table) in enumerate(zip(kinds, tables)):
            vs = [f[i] for f in fields]
            if k == STR:
                cols.append(table.intern_many([str(v) for v in vs]))
                continue
            if k == BOOL:
                if not all(isinstance(v, (bool, np.bool_)) for v in vs):
                    _bad(i, "non-bool", "bool")
                cols.append(np.asarray(vs, dtype=np.bool_))
                continue
            if any(isinstance(v, (bool, np.bool_)) for v in vs):
                # np.asarray would fold True into 1/1.0 with no error
                _bad(i, "bool", "int" if k == I64 else "float")
            arr = np.asarray(vs)
            if arr.dtype.kind not in "iuf":
                _bad(i, "non-numeric", "int" if k == I64 else "float")
            if k == I64:
                if arr.dtype.kind == "f" and not np.all(arr == np.floor(arr)):
                    _bad(i, "fractional", "int", " (e.g. always float)")
                cols.append(arr.astype(np.int64))
            else:
                cols.append(arr.astype(np.float64))
        self._chain_rows = []
        return cols, ts, kinds, tables

    def pump_chain(self, proc_now: int) -> None:
        """Move buffered emissions to the downstream runner (or tick its
        processing-time clock when there are none), then cascade."""
        d = self.downstream
        if d is None and self._chain_rows and self._lazy_plans:
            d = self._build_lazy_downstream()
        if d is None:
            return
        cols: List[np.ndarray] = []
        if self._chain_rows:
            cols, ts, kinds, tables = self._rows_to_cols()
        elif self._chain_buf:
            bufs, self._chain_buf = self._chain_buf, []
            cols = [np.concatenate([b[0][i] for b in bufs])
                    for i in range(len(bufs[0][0]))]
            ts = np.concatenate([b[1] for b in bufs]) if self._chain_ts else None
            kinds, tables = self.program.out_kinds, self.program.out_tables
        fed = False
        if cols and len(cols[0]):
            n = len(cols[0])
            if d.plan.synthetic_key:
                # computed KeySelector on the downstream stage: derive
                # the key from this hand-off batch
                cols = list(cols) + [derive_key_column(d.plan, cols, n)]
                kinds = list(kinds) + [STR]
                tables = list(tables) + [d.plan.tables[-1]]
            columns = [Column(k, c, t) for k, c, t in zip(kinds, cols, tables)]
            batch = Batch(n, columns, ts=ts,
                          proc_ts=np.full(n, proc_now, dtype=np.int64))
            # event-time stages let the data drive the watermark; the
            # processing clock floor belongs to processing-time stages
            wl = (LONG_MIN + 1 if self._downstream_is_event_time(d)
                  else proc_now - 1)
            d.feed(batch, wl)
            d._last_tick = proc_now
            fed = True
        if (not fed and d._last_tick != proc_now
                and not self._downstream_is_event_time(d)):
            # a clock tick, at most once a distinct proc_now (event-time
            # stages fire from data and the end of the stream, never
            # the clock)
            d.flush(proc_now - 1)
            d._last_tick = proc_now
        d.pump_chain(proc_now)

    # -- dynamic rules ------------------------------------------------------

    def refresh_rules(self) -> None:
        """Write the RuleSet's current values and version into this
        stage's rule tensors in place (one fill a rule): the program is
        not rebuilt, and the next step reads the new values. A leaf whose
        shape changed (a per-tenant vector that grew) is replaced."""
        ruleset = self.program.ruleset
        if ruleset is None or RULES_KEY not in self.state:
            return
        leaves = self.state[RULES_KEY]
        for name, new in ruleset.device_leaves().items():
            old = leaves.get(name)
            if old is None or old.shape != new.shape:
                leaves[name] = new.to(self.device)
            elif new.dim() == 0:
                old.fill_(new.item())
            else:
                old.copy_(new)
        self.state[RULE_VERSION_KEY].fill_(ruleset.version)

    # -- steps --------------------------------------------------------------

    def _check_capacity(self) -> None:
        """Keyed state grows without bound, Flink's contract
        (chapter2/README.md:8-10): when the distinct-key count passes the
        capacity, the planes grow to the next power-of-two multiple and
        the old rows carry over. Runs before the batch whose new keys
        would overflow reaches the device, so no record is lost."""
        table = self.program.key_table()
        if table is None or len(table) <= self.cfg.key_capacity:
            return
        cap = self.cfg.key_capacity
        while cap < len(table):
            cap *= 2
        self.state = self.program.grow_state(self.state, cap)
        self.cfg = dataclasses.replace(self.cfg, key_capacity=cap)

    def feed(self, batch: Batch, wm_lower: int = LONG_MIN + 1,
             t_batch: Optional[float] = None) -> None:
        """Run ``batch`` in steps of at most ``batch_size`` rows;
        ``t_batch`` (the batch's arrival on the host clock) dates its
        emissions' latency."""
        if t_batch is None:
            t_batch = time.perf_counter()
        self._check_capacity()
        size = self.cfg.batch_size
        for start in range(0, batch.n, size):
            stop = min(start + size, batch.n)
            self._run_step(batch.slice_rows(start, stop), wm_lower, t_batch)
            if self.count_input:
                self.metrics.records_in += stop - start
            # deferred window ends fire before the next batch can move
            # the ring past them
            self._drain(wm_lower, t_batch)

    def flush(self, wm_lower: int, t_batch: Optional[float] = None) -> None:
        """Advance time with an empty batch (processing-time tick / end
        of stream), then drain any fires deferred by the budget."""
        if not self.program.fires_on_clock:
            return
        if t_batch is None:
            t_batch = time.perf_counter()
        self._run_step(self._empty_batch(), wm_lower, t_batch)
        self._drain(wm_lower, t_batch)

    def _drain(self, wm_lower: int, t_batch: float) -> None:
        """Empty steps until no window end stays deferred by
        ``max_fires_per_step`` (each still fires at most the budget)."""
        ring = getattr(self.program, "ring", None)  # a CEP program has none
        if (self.cfg.max_fires_per_step is None
                or not self.program.fires_on_clock or ring is None):
            return
        for _ in range(ring.n_fire_candidates + 2):
            if not self.state.get("pending_fires"):
                return
            self._run_step(self._empty_batch(), wm_lower, t_batch)

    def _empty_batch(self) -> Batch:
        """One invalid row of the input layout."""
        if self._empty is None:
            cols = [
                Column(k, np.zeros(1, dtype=NUMPY_DTYPES[k]), t)
                for k, t in zip(self.plan.record_kinds, self.plan.tables)
            ]
            zero = np.zeros(1, dtype=np.int64)
            self._empty = Batch(1, cols, ts=zero, proc_ts=zero,
                                valid=np.zeros(1, dtype=np.bool_))
        return self._empty

    def _upload(self, batch: Batch):
        pin = self.device.type == "cuda"

        def put(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                t = t.pin_memory()
            return t.to(self.device, non_blocking=pin)

        cols = [put(c.data) for c in batch.columns]
        if not (self.program.fires_on_clock or self.program.emit_ts):
            return cols, put(batch.valid), None
        if self.event_time and batch.ts is not None:
            ts = batch.ts
        elif batch.proc_ts is not None:
            ts = batch.proc_ts
        else:
            ts = np.zeros(batch.n, dtype=np.int64)
        return cols, put(batch.valid), put(ts)

    def _to_host(self, tensors) -> List[np.ndarray]:
        """Copy device tensors to the host with one wait for them all."""
        self.metrics.d2h_syncs += 1
        self.metrics.d2h_bytes += sum(t.numel() * t.element_size() for t in tensors)
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for o, t in zip(outs, tensors):
            o.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [o.numpy() for o in outs]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_step(self, batch: Batch, wm_lower: int, t_batch: float) -> None:
        m = self.metrics
        emitted_before = m.records_emitted
        with Stopwatch() as sw:
            cols, valid, ts = self._upload(batch)
            self._sync()
        m.upload_times_s.append(sw.elapsed)
        reads = self.program.host_reads
        with Stopwatch() as sw:
            self.state, emissions = self.program.run_step(
                self.state, cols, valid, ts, wm_lower)
            self._sync()
        m.step_times_s.append(sw.elapsed)
        m.d2h_syncs += self.program.host_reads - reads
        m.steps += 1
        fire_info = emissions.get("process_fire")
        if fire_info is not None:
            self._evaluate_fires(fire_info)
        main = emissions.get("main")
        if main is not None:
            # a stage that feeds an event-time stage hands over each
            # row's timestamp: a window's end - 1, or the record's own
            want = ("window_end", "ts") if self._chain_ts else ()
            with Stopwatch() as sw:
                out, subtask, extra = self._fetch(main, want)
            m.fetch_times_s.append(sw.elapsed)
            with Stopwatch() as sw:
                if self.downstream is not None:
                    if out and len(out[0]):
                        ts_rows = None
                        if self._chain_ts:
                            wend = extra.get("window_end")
                            ts_rows = wend - 1 if wend is not None else extra["ts"]
                        self._chain_buf.append((out, ts_rows))
                else:
                    for j, row in enumerate(self.formatter.rows(out)):
                        self._emit_row(
                            row, None if subtask is None else int(subtask[j]))
                    m.records_emitted += len(out[0]) if out else 0
            m.emit_times_s.append(sw.elapsed)
        late = emissions.get("late")
        if late is not None and self._late_sinks():
            with Stopwatch() as sw:
                self._dispatch_late(late)
            m.emit_times_s.append(sw.elapsed)
        timeout = emissions.get("timeout")
        if timeout is not None and self._timeout_sink() is not None:
            with Stopwatch() as sw:
                self._dispatch_timeout(timeout)
            m.emit_times_s.append(sw.elapsed)
        if m.records_emitted > emitted_before:
            m.emit_latencies_s.append(time.perf_counter() - t_batch)

    def _evaluate_fires(self, fire_info) -> None:
        """A full-window program's fires: the program gathers each fired
        window's elements from the live state and calls the user
        function on the host; each result takes the window's post ops,
        then goes to every branch (or to the chain buffer). Its copies
        count as fetch time, the rest as emit time."""
        m = self.metrics
        fetch_s = 0.0
        emitted = 0

        def emit(item, subtask, ts=None, order=None):
            nonlocal emitted
            item, keep = _apply_ops(self.post_ops, item)
            if keep:
                self._emit_row(item, subtask, ts, order)
                emitted += 1

        def fetch(tensors):
            nonlocal fetch_s
            with Stopwatch() as sw:
                got = self._to_host(tensors)
            fetch_s += sw.elapsed
            return got

        with Stopwatch() as sw:
            fired = self.program.evaluate_fires(
                self.state, fire_info, emit, fetch)
        m.fetch_times_s.append(fetch_s)
        m.emit_times_s.append(sw.elapsed - fetch_s)
        if not self._chained:
            m.records_emitted += emitted
        m.window_fires += fired

    def _late_sinks(self) -> list:
        """The late-data side outputs: every side sink but the CEP
        timeout tag's, which receives only the timeout stream."""
        tt = getattr(self.program, "timeout_tag", None)
        return [entry for tag_id, entry in self.side_sinks.items()
                if tt is None or tag_id != tt.id]

    def _timeout_sink(self):
        """(ops, sink) of the CEP timeout tag's side output, or None (the
        device counts expired partials in ``cep_timeouts`` either way)."""
        tt = getattr(self.program, "timeout_tag", None)
        return self.side_sinks.get(tt.id) if tt is not None else None

    def _dispatch_late(self, late) -> None:
        """Rows late past the allowed lateness, to every late-data side
        output (after its host-side ops). Their count is read first, then
        only that many rows, compacted on the device, are copied. (The
        device counts drops itself, in ``late_dropped``, for jobs with no
        side output.)"""
        mask = late["mask"]
        idx, count = compact_positions(mask, mask.shape[0])
        (n,) = self._to_host([count])
        n = int(n)
        if n == 0:
            return
        rows = idx[:n].to(torch.int64)
        cols = self._to_host([c[rows] for c in late["cols"]])
        for ops, sink in self._late_sinks():
            for row in self.late_formatter.rows(cols):
                item, keep = _apply_ops(ops, row)
                if keep:
                    sink.emit(item)

    def _dispatch_timeout(self, timeout) -> None:
        """CEP partial matches whose ``within`` expired, to the pattern's
        timeout side output (Flink's PatternTimeoutFunction stream): the
        row count, then that many rows."""
        (n,) = self._to_host([timeout["count"]])
        n = int(n)
        if n == 0:
            return
        cols = self._to_host([c[:n] for c in timeout["cols"]])
        ops, sink = self._timeout_sink()
        fmt = EmissionFormatter(self.program.timeout_kinds,
                                self.program.timeout_tables)
        for row in fmt.rows(cols):
            item, keep = _apply_ops(ops, row)
            if keep:
                sink.emit(item)

    def _fetch(self, main, want=()):
        """The step's emitted rows on the host: ``(columns, subtasks,
        extra)``; subtasks are None for a stream without a key, and
        ``extra`` holds the rows of each stream leaf named in ``want``
        that the stream has (``window_end``, ``ts``)."""
        n_shards = max(1, self.cfg.parallelism)
        names = [w for w in want if w in main]
        if self.program.main_emission_prefix:
            # read the count, then copy only that many rows
            count = main["count"]
            if isinstance(count, torch.Tensor):
                (count,) = self._to_host([count])
            n = int(count)
            key = main.get("key")
            if n == 0:
                return [], None, {}
            extra = [] if key is None else [key[:n]]
            n_cols = len(main["cols"])
            got = self._to_host([c[:n] for c in main["cols"]] + extra
                                + [main[w][:n] for w in names])
            got_extra = dict(zip(names, got[len(got) - len(names):]))
            if key is None:
                return got[:n_cols], None, got_extra
            return (got[:n_cols], got[n_cols].astype(np.int64) % n_shards,
                    got_extra)
        # checked before any row of the step reaches a sink
        bad = main.get("bad_keys")
        extra = [main[w] for w in names] + ([] if bad is None else [bad])
        got = self._to_host(
            [main["mask"], main["subtask"]] + list(main["cols"]) + extra)
        if bad is not None and int(got[-1][0]):
            raise IndexError(
                f"{int(got[-1][0])} rows carried a key id past the keyed "
                f"state's capacity of {self.cfg.key_capacity}"
            )
        sel = np.nonzero(got[0])[0]
        n_cols = len(main["cols"])
        cols = got[2:2 + n_cols]
        got_extra = {w: a[sel] for w, a in zip(names, got[2 + n_cols:])}
        return [c[sel] for c in cols], got[1][sel], got_extra

    def _emit_row(self, row, subtask: Optional[int], ts=None, order=None) -> None:
        """Fan one emitted record out to every branch: the branch's
        host-side map/filter tail, then its sink. A chained process()
        stage buffers the row, with its window timestamp and its place
        in the evaluation order, for the downstream runner."""
        if self._chained:
            self._chain_rows.append((row, ts, order))
            return
        for ops, sink in self.sinks:
            item, keep = _apply_ops(ops, row)
            if keep:
                sink.emit(item, subtask=subtask)

    def finalize_metrics(self) -> None:
        """Fold the device-side counters into Metrics (one read a job;
        the stages of a chain add theirs to the same Metrics)."""
        names = [n for n in self._COUNTER_NAMES if n in self.state]
        if names:
            vals = self._to_host([self.state[n] for n in names])
            for n, v in zip(names, vals):
                setattr(self.metrics, n, getattr(self.metrics, n) + int(v))

    def check_strict(self) -> None:
        """strict_overflow: fail loudly if any loss counter is nonzero
        (call after :meth:`finalize_metrics`)."""
        if not self.cfg.strict_overflow:
            return
        bad = {n: v for n, v in self.metrics.overflow_counts().items() if v}
        if bad:
            raise RuntimeError(
                "strict_overflow: records were lost or truncated: "
                + ", ".join(f"{n}={v}" for n, v in sorted(bad.items()))
                + " — raise the relevant capacity (alert_capacity / "
                "process_buffer_capacity / pane_ring_slack)"
            )


def _reject_count_ts(st) -> None:
    """Count-window results carry no event timestamps (Flink's
    GlobalWindow has none), so they cannot feed event-time stages."""
    if st is not None and st.window is not None and st.window.kind == "count":
        raise NotImplementedError(
            "count-window results carry no event timestamps (Flink's "
            "GlobalWindow); window the chained stage in processing time, "
            "or use a time window upstream"
        )


def _chain_needs_event_ts(plans) -> bool:
    """True when any stage in ``plans`` windows in event time (its input
    records then need timestamps from the upstream stage)."""
    for p in plans:
        st = p.stateful
        if (
            st is not None
            and st.window is not None
            and st.window.time_domain == TimeCharacteristic.EventTime
            and (st.window.is_time_window() or st.window.kind == "session")
        ):
            return True
    return False


def _wire_chain_ts(up: Runner, down: Runner) -> None:
    """Mark ``up`` to hand per-row event timestamps down its chain when
    any downstream stage windows in event time, and check that its
    program can provide them."""
    if not _chain_needs_event_ts([r.plan for r in down.chain()]):
        return
    up._chain_ts = True
    st = up.plan.stateful
    _reject_count_ts(st)
    if st is not None and st.kind in ("rolling", "rolling_reduce"):
        up.program.emit_ts = True


def _make_runner_chain(plans, cfg, metrics) -> Runner:
    """Build the runner for plans[0] plus downstream runners for any
    chained stages, wiring record schemas from each upstream program.

    A stage fed by a full-window process() stage resolves its schema
    from the user function's collected rows (the function may emit any
    shape), so its runner is built lazily, on the first pump that has
    rows."""
    runner = Runner(plans[0], cfg, metrics)
    up = runner
    for i, p2 in enumerate(plans[1:], start=1):
        if up.program.host_evaluated:
            up._lazy_plans = list(plans[i:])
            up._chain_ts = _chain_needs_event_ts(up._lazy_plans)
            if up._chain_ts:
                _reject_count_ts(up.plan.stateful)
            break
        p2.record_kinds.extend(up.program.out_kinds)
        p2.tables.extend(up.program.out_tables)
        if p2.synthetic_key:
            # computed KeySelector on this chain stage: the glue derives
            # the key from each hand-off batch into a trailing column
            p2.record_kinds.append(STR)
            p2.tables.append(DerivedKeyTable())
        r2 = Runner(p2, cfg, metrics)
        up.chain_to(r2)
        up = r2
    # wire timestamps only once the FULL chain exists: whether stage i
    # must hand them over depends on every stage after it
    r = runner
    while r is not None and r.downstream is not None:
        _wire_chain_ts(r, r.downstream)
        r = r.downstream
    return runner


def _check_supported(env, cfg: StreamConfig) -> None:
    refused = {
        "restart_strategy": cfg.restart_strategy is not None,
        "checkpoint_interval_batches": cfg.checkpoint_interval_batches > 0,
        "ingest_lanes": cfg.ingest_lanes > 1,
        "dead_letter": bool(cfg.dead_letter),
        "obs.enabled": bool(cfg.obs.enabled),
    }
    names = [k for k, on in refused.items() if on]
    if names:
        raise NotImplementedError(
            f"StreamConfig {', '.join(names)} not ported to the PyTorch "
            f"runtime yet"
        )


def _raw_lines(sb) -> List[str]:
    lines = sb.raw.decode("utf-8", "replace").split("\n")
    if len(lines) == sb.n_raw + 1 and lines[-1] == "":
        lines.pop()  # trailing newline
    if len(lines) != sb.n_raw:
        raise ValueError(
            f"raw source batch declares {sb.n_raw} lines "
            f"but contains {len(lines)}"
        )
    return lines


def _parse(host: HostStage, sb):
    """``(Batch or None, wm_hint)`` of one source batch: a raw buffer
    through the native lane when it can take it, else the line path."""
    if sb.raw is not None:
        batch, wm_hint = host.process_raw(sb.raw, sb.n_raw, sb.proc_ts)
        if batch is None and sb.n_raw:
            # native lane unavailable: decode and take the line path
            batch, wm_hint = host.process(_raw_lines(sb), sb.proc_ts)
        return batch, wm_hint
    return host.process(sb.lines, sb.proc_ts)


def execute_job(env, sink_nodes) -> JobResult:
    """Plan the job and run it to source exhaustion on
    ``env.config.device``."""
    cfg = env.config
    _check_supported(env, cfg)
    resolve_device(cfg.device)  # refuse a missing card before any work
    with Stopwatch() as setup:
        plans = build_plan_chain(env, sink_nodes)
        plan = plans[0]
        host = HostStage(plan, cfg)
    metrics = Metrics(build_time_s=setup.elapsed)
    env.metrics = metrics
    runner: Optional[Runner] = None
    processing_time = plan.time_characteristic == TimeCharacteristic.ProcessingTime
    proc_now = 0
    # dynamic rules: the control feed. A run replays the data from record
    # 0, so the rule timeline replays with it: the RuleSet goes back to
    # its defaults at version 0 and the feed applies every update at its
    # record position
    ruleset = plan.rules
    control_feed = None
    if plan.broadcast is not None and ruleset is not None:
        ruleset.reset()
        control_feed = plan.broadcast.feed(cfg.batch_size)
    lines_consumed = 0

    def apply_rule_updates(updates) -> None:
        """Land a group of rule updates at the current record boundary:
        every row fed so far finishes its way down the chain under the
        old rules, then the host RuleSet and every stage's rule tensors
        take the new values."""
        runner.pump_chain(proc_now)
        for u in updates:
            ruleset.apply(u)
        for r in runner.chain():
            r.refresh_rules()

    for sb in plan.source.batches(cfg.batch_size, cfg.max_batch_delay_ms):
        with Stopwatch() as hw:
            batch, wm_hint = _parse(host, sb)
        metrics.host_times_s.append(hw.elapsed)
        metrics.batches += 1
        lines_consumed += sb.n_records
        if sb.proc_ts.size:
            proc_now = max(proc_now, int(sb.proc_ts.max()))
        if sb.advance_proc_to is not None:
            proc_now = max(proc_now, int(sb.advance_proc_to))
        if batch is not None:
            if runner is None:
                # built on the first batch: an adaptive parse schema is
                # known only then
                with Stopwatch() as bw:
                    runner = _make_runner_chain(plans, cfg, metrics)
                metrics.build_time_s += bw.elapsed
            if processing_time:
                wm_lower = proc_now - 1
            else:
                wm_lower = wm_hint if wm_hint is not None else LONG_MIN + 1
            if control_feed is None:
                runner.feed(batch, wm_lower, t_batch=hw.t0)
            else:
                # split the batch at each pending update's record
                # position: rows before position N run under the old
                # rules, rows from N on under the new (record-exact and
                # batch-size independent)
                base = lines_consumed - sb.n_records
                cursor = 0
                for off, updates in control_feed.splits_for(base, sb.n_records):
                    off = min(off, batch.n)  # a host filter may drop rows
                    if off > cursor:
                        runner.feed(batch.slice_rows(cursor, off), wm_lower,
                                    t_batch=hw.t0)
                        cursor = off
                    apply_rule_updates(updates)
                rest = batch.slice_rows(cursor, batch.n) if cursor else batch
                if rest.n or not cursor:
                    runner.feed(rest, wm_lower, t_batch=hw.t0)
        elif sb.advance_proc_to is not None and runner is not None and processing_time:
            runner.flush(proc_now - 1)  # the processing-time clock ticked
        if runner is not None:
            runner.pump_chain(proc_now)
        if sb.final:
            break
    counts = host.parse_counts()
    metrics.native_parses, metrics.numpy_parses = counts["native"], counts["numpy"]
    if runner is not None:
        if control_feed is not None:
            # updates positioned at or after the last record still apply:
            # they govern the end-of-stream fires
            eos_updates = control_feed.remaining(lines_consumed)
            if eos_updates:
                apply_rule_updates(eos_updates)
        # Flink's end of input: a MAX watermark fires every remaining
        # event-time window; processing time fires up to the clock
        runner.flush(proc_now - 1 if processing_time else MAX_WATERMARK)
        # chained stages: push the final emissions down the chain, then
        # fire everything still windowed downstream; a pump may BUILD a
        # process()-fed stage here, so downstream is read after it
        r = runner
        while True:
            r.pump_chain(proc_now)
            d = r.downstream
            if d is None:
                break
            d.flush(MAX_WATERMARK)
            r = d
        for r in runner.chain():
            r.finalize_metrics()
            r.check_strict()
    return JobResult(metrics)
