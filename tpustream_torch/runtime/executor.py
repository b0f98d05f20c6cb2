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

Observability (``StreamConfig.obs.enabled``): the job gets a
``JobObs`` root and each runner an ``OperatorObs`` (the null twins when
obs is off, so a hook is a no-op attribute call). Spans ``parse``,
``h2d``, ``dispatch``, ``fetch`` and ``emit`` time the host's side of
each batch and step and never wait on the card: ``dispatch`` covers the
issue of a step, the wait for it is the step timer's. Every program
build and state reshape (key growth, tenant-capacity growth) lands in
the build registry (``obs/compilation.py``) with its cause; latency
markers stamped at the source ride the steps to each operator edge and
sink; snapshots tick from the batch loop; a fleet (``tenancy/``)
attaches its per-tenant series and SLOs to the root.

Not ported here, and refused by :func:`execute_job` rather than ignored:
checkpoints and restore, supervised restarts, ingest lanes and
dead-letter quarantine. The reference's pipelining knobs
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
from ..obs.compilation import (
    CAUSE_INITIAL,
    CAUSE_KEY_GROWTH,
    CAUSE_TENANT_GROWTH,
    CompileObs,
)
from ..obs.registry import TwinCounter
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
        with Stopwatch() as build_sw:
            self.program = build_program(plan, cfg)
            self.state = self.program.init_state()
        self.device = self.program.device
        self.sinks, self.side_sinks = _make_sinks(plan, cfg)
        # per-operator observability scope: counters/histograms labelled
        # {job, operator} plus span minting. The null twin (obs disabled)
        # makes every obs call below a no-op attribute call.
        self.obs = metrics.job_obs.operator(self.program.operator_name)
        self._flight = metrics.job_obs.flight
        self._step_idx = 0
        # end-to-end latency markers (obs/latency.py): markers accepted
        # here ride the next step and are recorded once its emissions
        # are dispatched; recorded markers park in _marker_out until
        # pump_chain hands them downstream. Both stay empty unless the
        # source stamper is installed (obs on + a marker interval).
        self._pending_markers: List = []
        self._marker_out: List = []
        # wire-traffic series: bytes the executor moves each way, and the
        # share of an emission buffer a fetch copies (null instruments
        # when obs is off); the port's prefix buffers hold every row, so
        # its spill counter stays 0
        self._h2d_bytes = self.obs.counter("h2d_bytes_total")
        self._fetch_bytes = self.obs.counter("fetch_bytes_total")
        self._compaction_gauge = self.obs.gauge("compaction_ratio")
        self.obs.counter("compaction_spills")
        self._compile_obs: Optional[CompileObs] = None
        if self.obs.enabled:
            # the build registry (obs/compilation.py): this build and
            # every later reshape of the state, with its cause
            self._compile_obs = CompileObs(
                self.obs, self._flight,
                meta=self.program.pre_chain.describe(),
            )
            # pull-style backpressure gauges, read at snapshot time: the
            # chain hand-off rows parked between pumps, and the steps in
            # flight (the port runs each step to its end: always 0)
            self.obs.gauge("chain_buffer_entries").set_fn(
                lambda: len(self._chain_buf) + len(self._chain_rows)
            )
            self.obs.gauge("pipeline_occupancy").set_fn(lambda: 0)
            # every sink counts under the legacy flat name and the one
            # labelled family, kept in lockstep
            for i, (_, sink) in enumerate(self.sinks):
                sink.obs_counter = TwinCounter(
                    self.obs.counter(f"sink{i}_emitted"),
                    self.obs.scoped(sink=str(i)).counter(
                        "operator_sink_emitted"),
                )
            for tag, (_, sink) in self.side_sinks.items():
                sink.obs_counter = TwinCounter(
                    self.obs.counter(f"side_sink{tag}_emitted"),
                    self.obs.scoped(sink=f"side:{tag}").counter(
                        "operator_sink_emitted"),
                )
        # marker latency series: source -> this operator's edge, and
        # (terminal stage) source -> each sink; tenant-labelled ones are
        # minted per label the fleet's round-robin stamper emits
        self._e2e_hist = self.obs.histogram("e2e_latency_ms")
        self._sink_e2e = [
            self.obs.histogram(f"sink{i}_e2e_latency_ms")
            for i in range(len(self.sinks))
        ]
        self._tenant_e2e: Dict[str, object] = {}
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
        # flight breadcrumb: one a program build (no-op when obs is off)
        self._flight.record(
            "program_built",
            operator=self.obs.name or self.program.operator_name,
            key_capacity=cfg.key_capacity,
            shards=1,
        )
        if self._compile_obs is not None:
            self._compile_obs.record_compile(
                CAUSE_INITIAL, build_sw.elapsed * 1e3)

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
        if self._marker_out:
            # markers recorded at this edge continue downstream with the
            # rows they rode
            d.accept_markers(self._marker_out)
            self._marker_out = []
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

    # -- latency markers (obs/latency.py) ------------------------------------

    def accept_markers(self, markers) -> None:
        """Markers arriving at this stage (from the source stamper or the
        upstream stage); they ride the next step."""
        if markers:
            self._pending_markers.extend(markers)

    def _take_markers(self) -> list:
        """Detach the pending markers for the step about to run."""
        if not self._pending_markers:
            return []
        ms, self._pending_markers = self._pending_markers, []
        return ms

    def _record_markers(self, markers) -> None:
        """A step's markers have now crossed this operator's edge:
        record their source->here age, then route them on — to the
        downstream stage, or (terminal stage) across every sink edge,
        with the fleet's tenant-labelled series."""
        now_ns = time.monotonic_ns()
        edge = self.obs.name or self.program.operator_name
        for m in markers:
            self._e2e_hist.observe(m.observe(edge, now_ns))
        if self.downstream is not None or self._lazy_plans:
            self._marker_out.extend(markers)
            return
        for m in markers:
            if m.tenant is None:
                continue
            h = self._tenant_e2e.get(m.tenant)
            if h is None:
                h = self.metrics.job_obs.group.group(
                    tenant=m.tenant
                ).histogram("tenant_e2e_latency_ms")
                self._tenant_e2e[m.tenant] = h
            h.observe(m.age_ms(now_ns))
        for i, h in enumerate(self._sink_e2e):
            for m in markers:
                h.observe(m.observe(f"sink{i}", now_ns))
        # sampled flight-path probes are complete at the terminal stage
        log = self.metrics.job_obs.traces
        for m in markers:
            if getattr(m, "trace_id", 0):
                log.add(m)

    def settle_markers(self) -> None:
        """End of stream: record any marker still waiting for a step (no
        stamped marker is lost), then cascade down the chain."""
        if self._pending_markers:
            self._record_markers(self._take_markers())
        if self.downstream is not None:
            if self._marker_out:
                self.downstream.accept_markers(self._marker_out)
                self._marker_out = []
            self.downstream.settle_markers()

    # -- dynamic rules ------------------------------------------------------

    def refresh_rules(self) -> None:
        """Write the RuleSet's current values and version into this
        stage's rule tensors in place (one fill a rule): the program is
        not rebuilt, and the next step reads the new values.

        One exception: when the tenant capacity grew since the last
        refresh (a fleet admitted a slot past the current ``[T]``), or
        the set of rule names changed, the leaves change shape. That
        routes through :meth:`_grow_tenant_capacity`: recorded in the
        flight ring and the build registry, as key growth is."""
        ruleset = self.program.ruleset
        if ruleset is None or RULES_KEY not in self.state:
            return
        leaves = self.state[RULES_KEY]
        new_leaves = ruleset.device_leaves()
        if set(new_leaves) != set(leaves) or any(
            tuple(v.shape) != tuple(leaves[k].shape)
            for k, v in new_leaves.items()
        ):
            self._grow_tenant_capacity(new_leaves)
            return
        for name, new in new_leaves.items():
            old = leaves[name]
            if new.dim() == 0:
                old.fill_(new.item())
            else:
                old.copy_(new)
        self.state[RULE_VERSION_KEY].fill_(ruleset.version)

    def _grow_tenant_capacity(self, new_leaves) -> None:
        """Re-shape the rule leaves after the RuleSet's tenant capacity
        (or its set of rule names) changed: the tenancy counterpart of
        key growth. The chain has drained (rule updates land at a batch
        boundary, after :meth:`pump_chain`), so only the rule leaves are
        replaced; no other state moves and no program is rebuilt. The
        reshape is flight-recorded with the old and new capacity and
        counted in the build registry, cause ``tenant_capacity_growth``."""
        ruleset = self.program.ruleset
        old = self.state[RULES_KEY]
        old_cap = next(
            (v.shape[0] for v in old.values() if v.dim() == 1), 0)
        self._flight.record(
            "tenant_capacity_grown",
            operator=self.obs.name or self.program.operator_name,
            old_capacity=old_cap,
            new_capacity=ruleset.tenant_capacity,
            cause=CAUSE_TENANT_GROWTH,
        )

        def place():
            self.state[RULES_KEY] = {
                k: v.to(self.device) for k, v in new_leaves.items()}
            self.state[RULE_VERSION_KEY].fill_(ruleset.version)

        if self._compile_obs is not None:
            self._compile_obs.build(CAUSE_TENANT_GROWTH, place)
        else:
            place()

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
        self._flight.record(
            "key_capacity_grown",
            operator=self.obs.name or self.program.operator_name,
            old_capacity=self.cfg.key_capacity,
            new_capacity=cap,
            cause=CAUSE_KEY_GROWTH,
        )

        def grow():
            return self.program.grow_state(self.state, cap)

        self.state = (grow() if self._compile_obs is None
                      else self._compile_obs.build(CAUSE_KEY_GROWTH, grow))
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
                self.obs.records_in.inc(stop - start)
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
        obs_on = self.obs.enabled

        def put(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if obs_on:
                self._h2d_bytes.inc(t.numel() * t.element_size())
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
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        self.metrics.d2h_syncs += 1
        self.metrics.d2h_bytes += nbytes
        self._fetch_bytes.inc(nbytes)
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
        obs = self.obs
        emitted_before = m.records_emitted
        self._step_idx += 1
        step_markers = self._take_markers()
        with obs.span("h2d", self._step_idx), Stopwatch() as sw:
            cols, valid, ts = self._upload(batch)
            self._sync()
        m.upload_times_s.append(sw.elapsed)
        for mk in step_markers:
            if getattr(mk, "trace_id", 0):
                mk.add_span("h2d", t0=sw.t0, dur=sw.elapsed)
        reads = self.program.host_reads
        self._flight.set_active(obs.name or self.program.operator_name)
        with Stopwatch() as sw:
            # the span times the host's issue of the step only: the
            # wait for the card below is the step timer's, never a span's
            with obs.span("dispatch", self._step_idx), Stopwatch() as dw:
                self.state, emissions = self.program.run_step(
                    self.state, cols, valid, ts, wm_lower)
            self._sync()
        m.step_times_s.append(sw.elapsed)
        m.d2h_syncs += self.program.host_reads - reads
        m.steps += 1
        obs.steps.inc()
        obs.dispatch_time_s.observe(dw.elapsed)
        obs.step_time_s.observe(sw.elapsed)
        for mk in step_markers:
            if getattr(mk, "trace_id", 0):
                mk.add_span("device_step", t0=sw.t0, dur=sw.elapsed,
                            step=self._step_idx,
                            operator=obs.name or self.program.operator_name)
        fire_info = emissions.get("process_fire")
        if fire_info is not None:
            self._evaluate_fires(fire_info)
        main = emissions.get("main")
        if main is not None:
            # a stage that feeds an event-time stage hands over each
            # row's timestamp: a window's end - 1, or the record's own
            want = ("window_end", "ts") if self._chain_ts else ()
            with obs.span("fetch", self._step_idx), Stopwatch() as sw:
                out, subtask, extra = self._fetch(main, want)
            m.fetch_times_s.append(sw.elapsed)
            for mk in step_markers:
                if getattr(mk, "trace_id", 0):
                    mk.add_span("fetch", t0=sw.t0, dur=sw.elapsed, group=1)
            with obs.span("emit", self._step_idx), Stopwatch() as sw:
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
        emitted_delta = m.records_emitted - emitted_before
        if emitted_delta:
            obs.records_emitted.inc(emitted_delta)
            m.emit_latencies_s.append(time.perf_counter() - t_batch)
        if step_markers:
            self._record_markers(step_markers)

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
        if fired:
            self.obs.counter("window_fires").inc(fired)

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
            # the share of the emission buffer's rows the fetch copies
            self._compaction_gauge.set(n / max(1, main["cols"][0].shape[0]))
            extra = [] if key is None else [key[:n]]
            n_cols = len(main["cols"])
            got = self._to_host([c[:n] for c in main["cols"]] + extra
                                + [main[w][:n] for w in names])
            got_extra = dict(zip(names, got[len(got) - len(names):]))
            if key is None:
                return got[:n_cols], None, got_extra
            return (got[:n_cols], got[n_cols].astype(np.int64) % n_shards,
                    got_extra)
        # checked before any row of the step reaches a sink; the whole
        # buffer is copied
        self._compaction_gauge.set(1.0)
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
                if int(v):
                    self.obs.counter(n).inc(int(v))
        if self.obs.enabled:
            self._finalize_obs_gauges()

    def _finalize_obs_gauges(self) -> None:
        """Expose the program's scalar clocks as gauges: the event-time
        watermark, the newest timestamp seen, the ring's high pane and
        the deferred-fire backlog (host ints in the port, read at no
        cost; obs-enabled runs only)."""
        vals = self.program.obs_state_scalars(self.state)
        for n, v in vals.items():
            self.obs.gauge("state_" + n).set(int(v))
        wm, max_ts = vals.get("wm"), vals.get("max_ts")
        if wm is not None and max_ts is not None and int(wm) > LONG_MIN:
            # 0 after the end-of-stream MAX watermark; the live lag
            # during a run is the job-scope host gauge (execute_job)
            self.obs.gauge("watermark_lag").set(max(0, int(max_ts) - int(wm)))

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
    ``env.config.device``. On any failure an obs-enabled job records the
    exception in its flight recorder and writes the postmortem dump
    before re-raising; either way its obs root closes (a final snapshot,
    the scrape endpoint stopped)."""
    try:
        result = _execute_job(env, sink_nodes)
    except BaseException as e:
        job_obs = getattr(getattr(env, "metrics", None), "job_obs", None)
        if job_obs is not None:
            job_obs.on_failure(e)
        raise
    env.metrics.job_obs.close()
    return result


def _make_job_obs(env, cfg: StreamConfig):
    """``(metrics, job_obs)``: the registry-backed Metrics facade and,
    with ``cfg.obs.enabled``, the job's obs root (else its null twin)."""
    if not cfg.obs.enabled:
        metrics = Metrics()
        return metrics, metrics.job_obs
    from ..obs.flightrecorder import jsonable_config
    from ..obs.runtime import JobObs

    job_obs = JobObs(cfg.obs, job_name=env.job_name or "job",
                     device=cfg.device)
    metrics = Metrics(registry=job_obs.registry, job_name=job_obs.job_name)
    metrics.job_obs = job_obs
    # fleet runs (tenancy/server.py): per-tenant gauges refresh at each
    # snapshot tick, tenant SLOs land as health rules, and /tenants.json
    # gets its provider
    if getattr(env, "_tenancy", None) is not None:
        job_obs.attach_tenancy(env._tenancy)
    # first flight event: the exact config the job ran with
    job_obs.flight.record(
        "config_resolved", job=job_obs.job_name,
        config=jsonable_config(cfg))
    from .. import native as _native_mod

    if not _native_mod.available():
        job_obs.flight.record(
            "native_parse_unavailable",
            error=_native_mod.build_error() or "build not attempted")
    else:
        job_obs.flight.record("native_parse_ready")
    return metrics, job_obs


def _execute_job(env, sink_nodes) -> JobResult:
    cfg = env.config
    _check_supported(env, cfg)
    resolve_device(cfg.device)  # refuse a missing card before any work
    with Stopwatch() as setup:
        plans = build_plan_chain(env, sink_nodes)
        plan = plans[0]
        host = HostStage(plan, cfg)
    metrics, job_obs = _make_job_obs(env, cfg)
    env.metrics = metrics
    metrics.build_time_s = setup.elapsed
    runner: Optional[Runner] = None
    processing_time = plan.time_characteristic == TimeCharacteristic.ProcessingTime
    proc_now = 0
    # host-side watermark gauges (obs on): fed per batch from the job's
    # periodic timestamp assigner; they stay nonzero during the run,
    # where the program's own clock reads 0 lag after the end-of-stream
    # MAX watermark
    assigner = plan.ts_assigner
    wm_gauge = lag_gauge = None
    wm_prev: Optional[int] = None
    if (job_obs.enabled and assigner is not None
            and hasattr(assigner, "observe")
            and hasattr(assigner, "get_current_watermark")):
        wm_gauge = job_obs.gauge("watermark_ms")
        lag_gauge = job_obs.gauge("watermark_lag_ms")
    if job_obs.enabled:
        job_obs.gauge("source_queue_depth").set_fn(plan.source.queue_depth)
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
    # perf_counter at the last rule application; the next non-empty feed
    # closes the propagation window (rule_update_propagation_ms)
    rule_apply_t0: List[Optional[float]] = [None]

    def apply_rule_updates(updates) -> None:
        """Land a group of rule updates at the current record boundary:
        every row fed so far finishes its way down the chain under the
        old rules, then the host RuleSet and every stage's rule tensors
        take the new values."""
        rule_apply_t0[0] = time.perf_counter()
        runner.pump_chain(proc_now)
        old_version = ruleset.version
        for u in updates:
            ruleset.apply(u)
        for r in runner.chain():
            r.refresh_rules()
        tenant_slots = sorted({u.tenant for u in updates
                               if getattr(u, "tenant", None) is not None})
        job_obs.gauge("rule_version").set(ruleset.version)
        job_obs.counter("rule_updates_total").inc(len(updates))
        if job_obs.enabled and tenant_slots:
            from ..broadcast.rules import TENANT_ACTIVE_RULE, _to_bool

            srv = getattr(env, "_tenancy", None)
            # a falsy __tenant_active__ update IS a removal: those slots
            # get their per-tenant series retired, not re-minted
            removed = {
                u.tenant for u in updates
                if getattr(u, "tenant", None) is not None
                and u.name == TENANT_ACTIVE_RULE and not _to_bool(u.value)
            }
            for slot in tenant_slots:
                if slot in removed:
                    continue
                label = srv.tenant_label(slot) if srv is not None else str(slot)
                job_obs.group.group(tenant=label).gauge(
                    "tenant_rule_version").set(ruleset.version)
            if removed and srv is not None:
                for slot in sorted(removed):
                    srv.retire_tenant_obs(slot, job_obs)
        job_obs.flight.record(
            "rule_applied",
            old_version=old_version,
            new_version=ruleset.version,
            rules={u.name: ruleset.value(u.name) for u in updates},
            tenants=tenant_slots or None,
        )

    def feed(b, wm_low, t0) -> None:
        runner.feed(b, wm_low, t_batch=t0)
        if rule_apply_t0[0] is not None and b.n:
            job_obs.histogram("rule_update_propagation_ms").observe(
                (time.perf_counter() - rule_apply_t0[0]) * 1000.0)
            rule_apply_t0[0] = None

    source_batches = plan.source.batches(cfg.batch_size, cfg.max_batch_delay_ms)
    if job_obs.enabled and cfg.obs.latency_marker_interval_ms > 0:
        # end-to-end latency markers, stamped at the source and riding
        # the same h2d/dispatch/fetch/emit path as the records; a fleet
        # labels them round-robin over its active tenants
        from ..obs.latency import MarkerStamper, stamp_markers

        tenancy = getattr(env, "_tenancy", None)
        source_batches = stamp_markers(
            source_batches,
            MarkerStamper(
                cfg.obs.latency_marker_interval_ms,
                counter=job_obs.counter("latency_markers_emitted"),
                tenant_provider=(tenancy.marker_tenant_provider()
                                 if tenancy is not None else None),
                trace_sample_rate=cfg.obs.trace_sample_rate,
                trace_counter=job_obs.counter("record_traces_sampled_total"),
            ),
        )
    marker_backlog: list = []
    for sb in source_batches:
        with job_obs.tracer.span("parse"), Stopwatch() as hw:
            batch, wm_hint = _parse(host, sb)
        if sb.markers:
            for mk in sb.markers:
                if getattr(mk, "trace_id", 0):
                    mk.add_host_parse(hw.t0, hw.elapsed)
            marker_backlog.extend(sb.markers)
        metrics.host_times_s.append(hw.elapsed)
        metrics.batches += 1
        lines_consumed += sb.n_records
        if (lag_gauge is not None and batch is not None
                and batch.ts is not None and batch.ts.size):
            # the batch max, then the monotone watermark and its lag
            assigner.observe(int(batch.ts.max()))
            wm_now = assigner.get_current_watermark().timestamp
            wm_gauge.set(wm_now)
            lag = getattr(assigner, "current_lag_ms", None)
            if lag is not None:
                lag_gauge.set(lag())
            if (wm_prev is not None
                    and wm_now - wm_prev > cfg.obs.flight_watermark_jump_ms):
                job_obs.flight.record(
                    "watermark_jump", from_ms=wm_prev, to_ms=wm_now,
                    jump_ms=wm_now - wm_prev)
            wm_prev = wm_now
        job_obs.maybe_snapshot()
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
            if marker_backlog:
                runner.accept_markers(marker_backlog)
                marker_backlog = []
            if processing_time:
                wm_lower = proc_now - 1
            else:
                wm_lower = wm_hint if wm_hint is not None else LONG_MIN + 1
            if control_feed is None:
                feed(batch, wm_lower, hw.t0)
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
                        feed(batch.slice_rows(cursor, off), wm_lower, hw.t0)
                        cursor = off
                    apply_rule_updates(updates)
                rest = batch.slice_rows(cursor, batch.n) if cursor else batch
                if rest.n or not cursor:
                    feed(rest, wm_lower, hw.t0)
        elif sb.advance_proc_to is not None and runner is not None and processing_time:
            if marker_backlog:
                runner.accept_markers(marker_backlog)
                marker_backlog = []
            runner.flush(proc_now - 1)  # the processing-time clock ticked
        if runner is not None:
            runner.pump_chain(proc_now)
        if sb.final:
            break
    counts = host.parse_counts()
    metrics.native_parses, metrics.numpy_parses = counts["native"], counts["numpy"]
    if runner is not None:
        if marker_backlog:
            # the last markers ride the end-of-stream flush
            runner.accept_markers(marker_backlog)
            marker_backlog = []
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
        # markers that met no further step still record at every
        # remaining edge: no stamped marker is lost
        runner.settle_markers()
        for r in runner.chain():
            r.finalize_metrics()
            r.check_strict()
    return JobResult(metrics)
