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
attaches its per-tenant series and SLOs to the root. Each runner counts
its state's device bytes and its key skew (``obs/memory.py``), and the
conservation ledger (``obs/ledger.py``, on with obs unless
``ObsConfig.ledger`` is False) accounts every source, chain, sink and
side-output edge, anchors each snapshot's sinks by digest and verifies
the anchors after a supervised restore and in each restore drill.

The pipeline (``Runner``; the reference's executor.py:979-2230):
each step's rows are packed into a narrow wire format on the host
(``h2d_compress``: int64 as 16- then 32-bit deltas against a per-batch
base; ``packed_wire``: float64 as exact float32, string ids as int16,
booleans and the valid mask as bits; a column whose rows stop fitting
demotes for good and the decode step is rebuilt once, cause
``batch_shape_change``). The copy is staged up to ``h2d_depth - 1`` feeds
ahead through a ring of pinned buffers and a copy stream. The step
decodes on the device, runs, and returns one count scalar a stream (and,
with ``compaction_capacity``, each mask-carrying stream gathered into a
fixed buffer of rows); the scalars go to pinned host memory without a
wait, up to ``async_depth - 1`` steps stay in flight, and a group of
``fetch_group`` steps waits once for its scalars, then copies only the
rows worth fetching (a compacted stream past its capacity spills to its
whole buffer, counted in ``compaction_spills``). A program whose
emissions the host evaluates against the live state runs at depth 1,
unstaged and uncompacted. The pipeline drains at every barrier: a rule
update, key or tenant-capacity growth, a wire demotion, the chain pump,
a processing-time tick, the end of the stream; a source that paused
longer than 50 ms fetches at once. None of it changes an output byte.

Around the loop (:func:`execute_job`): the config is resolved first
(``StreamConfig.resolve``, one ``config_clamped`` flight event a
clamp); ``parse_ahead`` parses on a thread ahead of the steps;
``ingest_lanes`` parse raw frames in worker processes behind
shared-memory rings and merge them in order (``runtime/ingest.py``,
self-healing); ``dead_letter`` quarantines the lines of a failed batch
that fail alone into ``env.dead_letters``; ``ObsConfig.adaptive`` moves
the pipeline depths at snapshot ticks (``runtime/controller.py``).

Checkpoints and recovery (the reference's executor.py:2568-3726): every
``checkpoint_interval_batches`` source batches a barrier drains the
pipeline down the chain and captures each stage's state in the JAX
package's snapshot layout (``runtime/checkpoint.py``), which a
background writer stores; savepoints are written on request and drills
verify the newest snapshot. A restore rebuilds the chain from a
snapshot and skips the lines it consumed. With a restart strategy each
attempt runs under ``runtime/supervisor.py``, which restarts a failed
attempt from the newest valid snapshot; an attempt's parse-ahead thread,
ingest lanes and writer stop with it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api.functions import as_callable
from ..arith import flush_subnormal
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
    CAUSE_BATCH_SHAPE,
    CAUSE_CONFIG,
    CAUSE_INITIAL,
    CAUSE_KEY_GROWTH,
    CAUSE_TENANT_GROWTH,
    CompileObs,
)
from ..obs.registry import TwinCounter
from ..parallel.distributed import (
    allgather_array,
    allgather_objects,
    process_count,
    process_index,
)
from .metrics import Metrics, Stopwatch
from .plan import JobPlan, build_plan_chain
from .sinks import (
    CollectSink,
    EmissionFormatter,
    FnSink,
    LedgerSink,
    PrintSink,
    RetryingSink,
)
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
        # conservation-ledger source terms (obs/ledger.py): when the
        # executor arms this dict, process() commits its filter drops and
        # flat_map fan counts here on success (an aborted parse commits
        # nothing, so a quarantine re-parse cannot count twice);
        # account_source drains it a batch. None: the ledger is off.
        self.ledger_counts: Optional[Dict[str, int]] = None
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

    def _ledger_commit(self, dropped: int, fm_in: int, fm_out: int) -> None:
        c = self.ledger_counts
        if c is not None:
            c["dropped"] += dropped
            c["fm_in"] += fm_in
            c["fm_out"] += fm_out

    def process(self, lines: List[str], proc_ts: np.ndarray):
        """``(Batch, wm_hint)``: the parsed Batch (None for empty input)
        and the batch's punctuated watermark, if any."""
        plan = self.plan
        if not lines:
            return None, None
        ts = self._timestamps(lines)
        wm_hint = self._punctuated_wm(lines, ts) if ts is not None else None
        # ledger source-edge deltas, committed only on a successful
        # return
        l_dropped = l_fm_in = l_fm_out = 0
        cols: Optional[List[np.ndarray]] = None
        for i, hop in enumerate(plan.host_ops):
            if hop.op == "filter":
                fn = as_callable(hop.fn, "filter")
                keep = [bool(fn(l)) for l in lines]
                lines = [l for l, k in zip(lines, keep) if k]
                l_dropped += len(keep) - len(lines)
                sel = np.asarray(keep, dtype=bool)
                proc_ts = proc_ts[sel]
                if ts is not None:
                    ts = ts[sel]
                if not lines:
                    self._ledger_commit(l_dropped, l_fm_in, l_fm_out)
                    return None, wm_hint
                continue
            if hop.op == "flat_map":
                fn = as_callable(hop.fn, "flat_map")
                l_fm_in += len(lines)
                new_lines, new_proc, new_ts = [], [], []
                for j, l in enumerate(lines):
                    outs = list(fn(l))
                    new_lines.extend(outs)
                    new_proc.extend([proc_ts[j]] * len(outs))
                    if ts is not None:
                        new_ts.extend([ts[j]] * len(outs))
                lines = new_lines
                l_fm_out += len(lines)
                proc_ts = np.asarray(new_proc, dtype=np.int64)
                ts = np.asarray(new_ts, dtype=np.int64) if ts is not None else None
                if not lines:
                    self._ledger_commit(l_dropped, l_fm_in, l_fm_out)
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
        self._ledger_commit(l_dropped, l_fm_in, l_fm_out)
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
    fault = _fault_hook(cfg)

    def build_sink(node):
        if node.op == "sink_print":
            sink = PrintSink(parallelism=pp)
        elif node.op == "sink_collect":
            sink = CollectSink(node.params["handle"])
        else:
            sink = FnSink(node.params["fn"])
        # transient-failure backoff (StreamConfig.sink_retries), and the
        # mount point for injected sink_emit faults: wrapped even at
        # retries=0 under injection, so the fault fires on the real emit
        # path and escalates like a genuine sink error
        if cfg.sink_retries > 0 or fault is not None:
            sink = RetryingSink(
                sink,
                attempts=cfg.sink_retries,
                base_ms=cfg.sink_retry_base_ms,
                max_ms=cfg.sink_retry_max_ms,
                fault=fault,
            )
        return sink

    main = [
        (_bind_ops(branch.ops), build_sink(branch.sink_node))
        for branch in plan.branches
    ]
    side = {
        so.tag.id: (_bind_ops(so.ops), build_sink(so.sink_node))
        for so in plan.side_outputs
    }
    return main, side


def _ledger_contents(sink):
    """``(contents_fn, persistent)`` for a sink's conservation-ledger
    account (obs/ledger.py): ``contents_fn`` exposes the retained row
    list a digest can be re-derived from; ``persistent`` marks contents
    that outlive a restart attempt (a collect handle, owned by the env),
    the only ones verified against restored checkpoint anchors (a
    PrintSink's line buffer is rebuilt empty each attempt)."""
    if isinstance(sink, RetryingSink):
        sink = sink.inner
    if isinstance(sink, CollectSink):
        return (lambda s=sink: s.handle.items), True
    if isinstance(sink, PrintSink):
        return (lambda s=sink: s.lines), False
    return None, False


def _fault_hook(cfg: StreamConfig):
    """The installed FaultInjector's check (``cfg.extra["fault_injector"]``,
    tpustream_torch/testing/faults.py), or None in a real run."""
    inj = cfg.extra.get("fault_injector") if cfg.extra else None
    return inj.check if inj is not None else None


@dataclasses.dataclass
class _Packed:
    """One step's rows in the wire format: the packed columns with their
    delta bases, the valid mask, the timestamps (None when the program
    reads none), the row count and the modes they were packed under."""
    cols: tuple
    bases: tuple
    valid: np.ndarray
    ts: Optional[np.ndarray]
    ts_base: int
    n: int
    col_modes: tuple
    ts_mode: str
    valid_mode: str


@dataclasses.dataclass
class _Uploaded:
    """A packed step's wire tensors on the device, and the event after
    their copy (None on the CPU)."""
    inputs: _Packed
    tensors: list
    event: object = None


class _Entry:
    """One step in flight: its emissions (and their compacted form), the
    names of its count scalars, their host copies and the event after
    them, and the markers that ride it."""

    __slots__ = ("emissions", "compact", "names", "t_batch", "markers",
                 "dispatch_s", "host", "event", "n_spec", "counts",
                 "spec_host")

    def __init__(self, emissions, compact, names, t_batch, markers):
        self.emissions = emissions
        self.compact = compact
        self.names = names
        self.t_batch = t_batch
        self.markers = markers
        self.dispatch_s = 0.0
        self.host: list = []
        self.event = None
        self.n_spec = 0
        self.counts: Dict[str, int] = {}
        self.spec_host: Optional[list] = None


class _WireRing:
    """The host side of the wire to one device.

    Uploads: on CUDA a ring of ``slots`` sets of pinned host buffers (one
    a wire column, reallocated only when a column's shape or dtype
    changes) replaces a ``pin_memory()`` call per column and step. A
    step's copy is issued with ``non_blocking=True`` on a dedicated copy
    stream and an event is recorded after it; the compute stream waits
    on that event before the step, and ``record_stream`` keeps the
    allocator from reusing the device tensors early. A slot is rewritten
    only after its last copy's event has completed.

    Count scalars: copied to pinned host memory with ``non_blocking=True``
    right after the step is issued, with an event; a fetch group waits
    once, on its last entry's event. On the CPU every copy is a view."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self._slots: List[list] = [[] for _ in range(max(2, slots))]
        self._events: list = [None] * len(self._slots)
        self._next = 0
        self._copy_stream = None

    def resize(self, slots: int) -> None:
        """A new ring size (at a drained barrier)."""
        slots = max(2, slots)
        if slots != len(self._slots):
            for ev in self._events:
                if ev is not None:
                    ev.synchronize()
            self._slots = [[] for _ in range(slots)]
            self._events = [None] * slots
            self._next = 0

    def put(self, inputs: _Packed) -> _Uploaded:
        arrays = list(inputs.cols) + [inputs.valid]
        if inputs.ts is not None:
            arrays.append(inputs.ts)
        if not self.cuda:
            return _Uploaded(inputs, [torch.from_numpy(a) for a in arrays])
        i = self._next
        self._next = (i + 1) % len(self._slots)
        if self._events[i] is not None:
            self._events[i].synchronize()  # the slot's last copy landed
        slot = self._slots[i]
        hosts = []
        for j, a in enumerate(arrays):
            h = slot[j] if j < len(slot) else None
            want = torch.from_numpy(a)
            if h is None or h.shape != want.shape or h.dtype != want.dtype:
                h = torch.empty(want.shape, dtype=want.dtype, pin_memory=True)
                if j < len(slot):
                    slot[j] = h
                else:
                    slot.append(h)
            h.copy_(want)
            hosts.append(h)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            devs = [h.to(self.device, non_blocking=True) for h in hosts]
        ev = torch.cuda.Event()
        ev.record(self._copy_stream)
        self._events[i] = ev
        return _Uploaded(inputs, devs, ev)

    def ready(self, up: _Uploaded) -> None:
        """Order the compute stream after the upload's copy."""
        if up.event is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(up.event)
        for t in up.tensors:
            t.record_stream(cur)

    def issue_counts(self, entry: _Entry, counts: list, spec) -> None:
        """Start the copy of a step's count scalars (one int32 vector)
        and of the speculative prefix slice."""
        tensors = [torch.stack(counts)] if counts else []
        if spec:
            tensors += spec
            entry.n_spec = len(spec)
        if not tensors:
            return
        if not self.cuda:
            entry.host = tensors
            return
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in tensors]
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        entry.host, entry.event = hosts, ev

    def wait_counts(self, entries, metrics) -> int:
        """Wait once for a group's count copies and read them into each
        entry's ``counts`` (and ``spec_host``); returns the bytes read."""
        last = next((e.event for e in reversed(entries)
                     if e.event is not None), None)
        if last is not None:
            last.synchronize()
        nbytes = 0
        for e in entries:
            arrs = [h.numpy() for h in e.host]
            nbytes += sum(int(a.nbytes) for a in arrs)
            if e.names:
                e.counts = dict(zip(e.names, (int(v) for v in arrs[0])))
            if e.n_spec:
                e.spec_host = arrs[len(arrs) - e.n_spec:]
        if any(e.host for e in entries):
            metrics.d2h_syncs += 1
            metrics.d2h_bytes += nbytes
        return nbytes


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
        # -- several processes (parallel/distributed.py) -------------------
        # every process runs this executor over the same replayed source;
        # the sharded program feeds and steps this process's shards only,
        # and each process dispatches its shards' emissions to its own
        # sinks (Flink's task-manager-local sinks; the reference's
        # tpustream/runtime/executor.py:501-524)
        mesh = getattr(self.program, "mesh", None)
        self._multiproc = process_count() > 1
        if self._multiproc:
            if mesh is None:
                raise NotImplementedError(
                    "multi-process execution needs a sharded program: set "
                    "StreamConfig.parallelism to the global shard count")
            if cfg.parallelism % process_count():
                raise ValueError(
                    f"parallelism ({cfg.parallelism}) must divide evenly "
                    f"by the process count ({process_count()})")
        # step epoch of each dispatch: the same on every process (one
        # dispatch a step), so it leads the cross-process merge order
        self._dispatch_seq = 0
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
        self._spill_counter = self.obs.counter("compaction_spills")
        self._fault = _fault_hook(cfg)
        # -- the pipeline (StreamConfig.async_depth, h2d_depth, fetch_group,
        # compaction_capacity, h2d_compress, packed_wire) -------------------
        # up to async_depth - 1 steps stay in flight before their emissions
        # are fetched; a program whose emissions the host evaluates against
        # the live state runs at depth 1, unstaged and uncompacted
        ref_state = self.program.emissions_reference_state
        depth = 1 if ref_state else cfg.async_depth
        self._max_inflight = max(0, depth - 1)
        self._inflight: List[_Entry] = []
        # staged uploads: a packed batch's copy is issued up to
        # h2d_depth - 1 feeds before the step that consumes it. Off for a
        # state-referencing program and under max_fires_per_step (a staged
        # batch would run after the drain steps that must follow it)
        self._h2d_ahead = max(0, cfg.h2d_depth - 1) if self._stage_ok() else 0
        self._upload_q: List[tuple] = []
        # device-side compaction: each mask-carrying stream also gathers
        # its emitted rows into [compaction_capacity] buffers, so a step
        # fetches about count rows instead of [B] buffers
        # Off at parallelism > 1, as in the reference
        # (tpustream/runtime/executor.py:577-583): the sharded emissions
        # are fetched whole, and a sharded prefix stream is gathered
        # into one prefix of the shards' prefixes already
        self._compact_cap = (int(cfg.compaction_capacity)
                             if cfg.compaction_capacity and not ref_state
                             and cfg.parallelism <= 1
                             else 0)
        self._spilled_streams: set = set()
        # sticky per-column wire modes, known at the first pack
        self._col_modes: Optional[tuple] = None
        self._ts_mode: Optional[str] = None
        self._valid_mode: Optional[str] = None
        self._stepped = False  # a step ran: a later demotion is a rebuild
        # rows of the last firing step's prefix stream, the size of the
        # slice fetched with the next step's count scalars
        self._prefix_hint = 0
        self._wire = _WireRing(self.device, cfg.h2d_depth + 1)
        self._compile_obs: Optional[CompileObs] = None
        if self.obs.enabled:
            # the build registry (obs/compilation.py): this build and
            # every later reshape of the state, with its cause
            self._compile_obs = CompileObs(
                self.obs, self._flight,
                meta=self.program.pre_chain.describe(),
            )
            # pull-style backpressure gauges, read at snapshot time: the
            # chain hand-off rows parked between pumps, and the staged
            # uploads plus the steps in flight
            self.obs.gauge("chain_buffer_entries").set_fn(
                lambda: len(self._chain_buf) + len(self._chain_rows)
            )
            self.obs.gauge("pipeline_occupancy").set_fn(
                lambda: len(self._upload_q) + len(self._inflight)
            )
            if self.program.n_shards > 1:
                from ..parallel.exchange import exchange_capacity

                self.obs.gauge("exchange_capacity_rows").set(
                    exchange_capacity(cfg.batch_size, self.program.n_shards,
                                      cfg.exchange_capacity_factor))
            # every sink counts under the legacy flat name and the one
            # labelled family, kept in lockstep
            for i, (_, sink) in enumerate(self.sinks):
                sink.obs_counter = TwinCounter(
                    self.obs.counter(f"sink{i}_emitted"),
                    self.obs.scoped(sink=str(i)).counter(
                        "operator_sink_emitted"),
                )
                if isinstance(sink, RetryingSink):
                    sink.retry_counter = self.obs.counter(f"sink{i}_retries")
            for tag, (_, sink) in self.side_sinks.items():
                sink.obs_counter = TwinCounter(
                    self.obs.counter(f"side_sink{tag}_emitted"),
                    self.obs.scoped(sink=f"side:{tag}").counter(
                        "operator_sink_emitted"),
                )
                if isinstance(sink, RetryingSink):
                    sink.retry_counter = self.obs.counter(
                        f"side_sink{tag}_retries")
        # marker latency series: source -> this operator's edge, and
        # (terminal stage) source -> each sink; tenant-labelled ones are
        # minted per label the fleet's round-robin stamper emits
        self._e2e_hist = self.obs.histogram("e2e_latency_ms")
        self._sink_e2e = [
            self.obs.histogram(f"sink{i}_e2e_latency_ms")
            for i in range(len(self.sinks))
        ]
        self._tenant_e2e: Dict[str, object] = {}
        # state-memory accounting and key-skew gauges (obs/memory.py)
        self._state_mem = None
        if self.obs.enabled:
            from ..obs.memory import StateMemoryTracker

            self._state_mem = StateMemoryTracker(self)
        # conservation ledger (obs/ledger.py): every sink gets a digest
        # account and an emit-edge invariant (in == emitted + filtered),
        # and chained hand-offs count handed and received rows. The wrap
        # comes AFTER the obs wiring above, so its RetryingSink checks
        # saw the raw sink; LedgerSink folds a row only after every
        # retry resolved.
        self._ledger = getattr(metrics.job_obs, "ledger", None)
        self._ledger_handed = 0    # rows appended to the chain hand-off
        self._ledger_received = 0  # rows fed to THIS runner by upstream
        self._ledger_edges: Optional[list] = None
        self._ledger_side: Optional[dict] = None
        if self._ledger is not None:
            led = self._ledger
            edges = []
            for i, (ops, sink) in enumerate(self.sinks):
                contents_fn, persistent = _ledger_contents(sink)
                acct = led.register_sink(f"sink{i}", contents_fn, persistent)
                self.sinks[i] = (ops, LedgerSink(sink, acct))
                edges.append(led.emit_edge(acct.name))
            self._ledger_edges = edges
            side = {}
            for tag in list(self.side_sinks):
                ops, sink = self.side_sinks[tag]
                contents_fn, persistent = _ledger_contents(sink)
                acct = led.register_sink(f"side:{tag}", contents_fn, persistent)
                self.side_sinks[tag] = (ops, LedgerSink(sink, acct))
                side[tag] = led.emit_edge(acct.name)
            self._ledger_side = side
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
        # (cols, ts or None, step, order key 1, order key 2) a step
        # (_buffer_chain); _chain_rows (item, ts, order) from process()
        # fires; _lazy_plans the stages after a process()
        # stage, built once its collected rows give their schema
        self.downstream: Optional["Runner"] = None
        self._chain_buf: List[tuple] = []
        self._chain_rows: List[tuple] = []
        self._lazy_plans: List[JobPlan] = []
        self._chain_ts = False  # an event-time stage is downstream
        self._last_tick: Optional[int] = None
        self.count_input = True  # False for a stage fed by another
        # a stage built from a process() stage's collected rows: its
        # inferred schema rides each checkpoint (lazy_schemas)
        self._lazy_schema = False
        # device counters as restored from a checkpoint: finalize_metrics
        # counts only what this run added
        self._counter_baseline: Dict[str, int] = {}
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
        if self._ledger is not None:
            # conservation on the hand-off: rows this runner handed ==
            # rows the downstream received + rows still parked in the
            # hand-off buffers (closures: the evaluator reads them live)
            self._ledger.register_chain_edge(
                "chain:" + (downstream.obs.name
                            or downstream.program.operator_name),
                lambda u=self, d=downstream: (
                    u._ledger_handed, d._ledger_received,
                    u._ledger_buffered()),
            )

    def _ledger_buffered(self) -> int:
        """Rows handed to the chain but not yet pumped downstream: the
        buffered term of the chain conservation edge."""
        n = len(self._chain_rows)
        for b in self._chain_buf:
            n += len(b[2])
        return n

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
        # the inferred schema is snapshotted with checkpoints, so that a
        # restored run can build this runner without re-inference
        d._lazy_schema = True
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

    def _buffer_chain(self, main: dict, out: list) -> None:
        """Park one step's main-stream rows for the downstream stage,
        with the keys of the canonical hand-off order
        (tpustream/runtime/executor.py:1718-1810, 2296-2310): the step,
        then (window end, key) for a window stage on a mesh, whose
        shards stack their rows where one device fires end-major then
        key; else the row's place in the single-process emission order
        (its global post-exchange row under several processes)."""
        n = len(out[0])
        wend, kcol = main.get("window_end"), main.get("key")
        if wend is not None and kcol is not None and self.program.n_shards > 1:
            k1, k2 = wend, kcol
        else:
            k1, k2 = main.get("row", np.arange(n)), np.zeros(n, np.int64)
        ts_rows = None
        if self._chain_ts:
            ts_rows = wend - 1 if wend is not None else main["ts"]
        self._chain_buf.append((
            out, ts_rows, np.full(n, self._dispatch_seq, np.int64),
            np.asarray(k1, np.int64), np.asarray(k2, np.int64)))
        self._ledger_handed += n

    def _take_chain_buf(self):
        """The buffered hand-off rows of every process (this one's alone
        in a single process) as one ``(cols, ts)`` batch in the canonical
        order of :meth:`_buffer_chain`. Under several processes it is
        called on every process alike, when some process holds a row."""
        bufs, self._chain_buf = self._chain_buf, []
        mine = None
        if bufs:
            mine = [np.concatenate([b[i] for b in bufs]) for i in (2, 3, 4)]
            mine.append([np.concatenate([b[0][i] for b in bufs])
                         for i in range(len(bufs[0][0]))])
            mine.append(np.concatenate([b[1] for b in bufs])
                        if self._chain_ts else None)
        parts = [p for p in allgather_objects(mine) if p is not None]
        seq, k1, k2 = (np.concatenate([p[i] for p in parts])
                       for i in range(3))
        o = np.lexsort((k2, k1, seq))
        cols = [np.concatenate([p[3][i] for p in parts])[o]
                for i in range(len(parts[0][3]))]
        ts = (np.concatenate([p[4] for p in parts])[o]
              if self._chain_ts else None)
        return cols, ts

    def pump_chain(self, proc_now: int) -> None:
        """Move buffered emissions to the downstream runner (or tick its
        processing-time clock when there are none), then cascade. The
        steps still in flight hand theirs over at a later pump, as in the
        reference (tpustream/runtime/executor.py:1756): the downstream
        stage's step boundaries, which order a sharded stage's rows,
        follow the same cadence; :meth:`drain_chain` is the barrier."""
        if not self._chained:
            return
        n_rows = len(self._chain_rows)
        n_buf = sum(len(b[2]) for b in self._chain_buf)
        if self._multiproc:
            # every process feeds its downstream stage the same global
            # batch: one gather of the counts a pump on every process
            # alike (pumps follow the source batches, which replay
            # identically); the rows' gathers only where some process
            # holds one. A process()-fed stage's rows merge by their
            # evaluation order (tpustream/runtime/executor.py:1718-1810)
            n_rows, n_buf = allgather_array(
                np.asarray([n_rows, n_buf], np.int64)).sum(axis=0)
            if n_rows:
                parts = allgather_objects(self._chain_rows)
                self._chain_rows = sorted(
                    (e for part in parts for e in part), key=lambda e: e[2])
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
        if n_rows:
            cols, ts, kinds, tables = self._rows_to_cols()
        elif n_buf:
            cols, ts = self._take_chain_buf()
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
            if self._ledger is not None:
                # the downstream side of the chain edge, counted here so
                # that feed() stays ledger-free for source-fed runners
                d._ledger_received += n
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
        self.drain_inflight()
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
        self._grow_to(cap, CAUSE_KEY_GROWTH)

    def _grow_to(self, cap: int, cause: str, grow=None) -> None:
        """Re-shape the keyed state to ``cap`` keys: recorded in the
        flight ring and the build registry with ``cause``.
        ``grow`` returns the new state (default: the program's
        ``grow_state`` of the current one); a restore passes the
        snapshot's state, already at ``cap``."""
        # a barrier: the staged uploads step and the steps in flight
        # dispatch against the state they were computed on
        self.drain_inflight()
        self._flight.record(
            "key_capacity_grown",
            operator=self.obs.name or self.program.operator_name,
            old_capacity=self.cfg.key_capacity,
            new_capacity=cap,
            cause=cause,
        )
        if grow is None:
            def grow():
                return self.program.grow_state(self.state, cap)

        self.state = (grow() if self._compile_obs is None
                      else self._compile_obs.build(cause, grow))
        self.cfg = dataclasses.replace(self.cfg, key_capacity=cap)

    def snapshot_counter_baseline(self) -> None:
        """Remember the device counters of a restored state, so that
        :meth:`finalize_metrics` adds only this run's part to Metrics
        (the snapshot's counts belong to the run that wrote it)."""
        names = [n for n in self._COUNTER_NAMES if n in self.state]
        if names:
            vals = self._to_host([self.state[n] for n in names])
            self._counter_baseline = {n: int(v) for n, v in zip(names, vals)}

    def release(self) -> None:
        """Drop this chain's device state, the steps in flight and the
        pinned wire buffers (a failed attempt, before its restart builds
        new ones)."""
        for r in self.chain():
            r.state = None
            r._inflight, r._upload_q = [], []
            r._wire = None

    def feed(self, batch: Batch, wm_lower: int = LONG_MIN + 1,
             t_batch: Optional[float] = None) -> None:
        """Run ``batch`` in steps of at most ``batch_size`` rows;
        ``t_batch`` (the batch's arrival on the host clock) dates its
        emissions' latency. Each step's rows are packed into the wire
        format, staged onto the device and stepped (at once, or up to
        ``h2d_depth - 1`` feeds later); its emissions are fetched up to
        ``async_depth - 1`` steps later."""
        if t_batch is None:
            t_batch = time.perf_counter()
        self._check_capacity()
        if self._state_mem is not None:
            self._state_mem.observe_batch(batch)
        # sampled flight-path probes get the pack hop timed, once (the
        # first sub-batch), on the batch they ride
        traced = [m for m in self._pending_markers
                  if getattr(m, "trace_id", 0)]
        size = self.cfg.batch_size
        for start in range(0, batch.n, size):
            stop = min(start + size, batch.n)
            sub = batch.slice_rows(start, stop)
            if sub.n == 1 and size > 1:
                # the reference steps every batch padded to batch_size,
                # and its scans add 0.0 to every float they emit once
                # they hold two rows (arith.plus_zero): one row alone
                # steps with one invalid row beside it
                sub = sub.pad_to(2)
            with self.obs.span("pack", self._step_idx + 1), Stopwatch() as pw:
                inputs = self._pack_batch(sub)
            for mk in traced:
                mk.add_span("pack", t0=pw.t0, dur=pw.elapsed,
                            step=self._step_idx + 1)
            traced = []
            self._stage_step(inputs, wm_lower, t_batch)
            if self.count_input:
                self.metrics.records_in += stop - start
                self.obs.records_in.inc(stop - start)
            # deferred window ends fire before the next batch can move
            # the ring past them
            self._drain(wm_lower, t_batch)

    def flush(self, wm_lower: int, t_batch: Optional[float] = None) -> None:
        """Advance time with an empty batch (processing-time tick / end
        of stream), then drain any fires deferred by the budget. A
        barrier: the staged uploads step and the steps in flight
        dispatch first."""
        self.drain_inflight()
        if not self.program.fires_on_clock:
            return
        if t_batch is None:
            t_batch = time.perf_counter()
        self._run_step(self._pack_batch(self._empty_batch()), wm_lower, t_batch)
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
            self._run_step(self._pack_batch(self._empty_batch()),
                           wm_lower, t_batch)

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

    # -- the wire: packing (tpustream/runtime/executor.py:979-1082) -----------

    _I32_SPAN = 0x7FFF_FFFF
    _U16_SPAN = 0xFFFF

    def _initial_modes(self) -> None:
        """Sticky per-column wire mode chains (narrowest first):
        int64 -> d16 (16-bit delta) -> d32 (int32 delta) -> raw;
        float64 -> f32 (exact-round-trip float32) -> raw;
        interned string ids (int32) -> i16 -> raw;
        bool columns and the valid mask -> bits (8 rows a byte).
        A demoted column stays demoted."""
        compress, packed = self.cfg.h2d_compress, self.cfg.packed_wire
        i64_mode = "d16" if compress and packed else "d32" if compress else "raw"
        modes = []
        for k in self.plan.record_kinds:
            if k == I64:
                modes.append(i64_mode)
            elif k == F64 and packed:
                modes.append("f32")
            elif k == STR and packed:
                modes.append("i16")
            elif k == BOOL and packed:
                modes.append("bits")
            else:
                modes.append("raw")
        self._col_modes = tuple(modes)
        self._ts_mode = i64_mode
        self._valid_mode = "bits" if packed else "raw"

    def _pack_batch(self, batch: Batch) -> "_Packed":
        """One step's rows in the wire format. The timestamp column ships
        only for a program that reads it."""
        cols = [np.ascontiguousarray(c.data) for c in batch.columns]
        ts = None
        if self.program.fires_on_clock or self.program.emit_ts:
            if self.event_time and batch.ts is not None:
                ts = batch.ts
            elif batch.proc_ts is not None:
                ts = batch.proc_ts
            else:
                ts = np.zeros(batch.n, dtype=np.int64)
            ts = np.ascontiguousarray(ts, dtype=np.int64)
        with Stopwatch() as sw:
            packed = self._pack(cols, np.ascontiguousarray(batch.valid), ts)
        self.metrics.upload_times_s.append(sw.elapsed)
        return packed

    def _pack(self, cols, valid, ts) -> "_Packed":
        """Numpy-side wire packing per the sticky column modes
        (h2d_compress delta coding, packed_wire narrowing); demotes a
        column down its mode chain, and rebuilds the decode step once,
        when a batch's valid rows no longer fit the narrow form. A
        16-bit delta travels as int16 bits and is widened with a mask."""
        if self._col_modes is None:
            self._initial_modes()
        all_valid = bool(valid.all())
        any_valid = all_valid or bool(valid.any())

        def pack_one(arr, mode):
            if mode in ("d32", "d16"):
                if not any_valid:
                    z = np.zeros(arr.shape,
                                 np.int16 if mode == "d16" else np.int32)
                    return z, 0, mode
                va = arr if all_valid else arr[valid]
                lo = int(va.min())
                # Python-int span: an int64 subtraction could wrap for
                # full-range columns and pass the check
                span = int(va.max()) - lo
                if mode == "d16" and span <= self._U16_SPAN:
                    # invalid rows wrap mod 2^16; nothing reads them
                    return ((arr - lo).astype(np.uint16).view(np.int16),
                            lo, mode)
                if span <= self._I32_SPAN:
                    mode = "d32" if self.cfg.h2d_compress else "raw"
                    if mode == "d32":
                        return (arr - lo).astype(np.int32), lo, mode
                return arr, 0, "raw"
            if mode == "f32":
                f = arr.astype(np.float32)
                ok = f.astype(np.float64) == arr  # NaN demotes
                if bool(ok.all() if all_valid else ok[valid].all()):
                    return f, 0, mode
                return arr, 0, "raw"
            if mode == "i16":
                va = arr if all_valid else arr[valid]
                if not any_valid or (
                        int(va.min()) >= -0x8000 and int(va.max()) <= 0x7FFF):
                    return arr.astype(np.int16), 0, mode
                return arr, 0, "raw"
            if mode == "bits":
                return np.packbits(arr.astype(bool)), 0, mode
            return arr, 0, mode

        packed, bases, modes = [], [], []
        for arr, mode in zip(cols, self._col_modes):
            p, b, m = pack_one(arr, mode)
            packed.append(p)
            bases.append(b)
            modes.append(m)
        ts_p, ts_b, ts_m = (None, 0, self._ts_mode) if ts is None \
            else pack_one(ts, self._ts_mode)
        if tuple(modes) != self._col_modes or ts_m != self._ts_mode:
            self._demote(tuple(modes), ts_m)
            return self._pack(cols, valid, ts)
        valid_p = np.packbits(valid) if self._valid_mode == "bits" else valid
        return _Packed(tuple(packed), tuple(bases), valid_p, ts_p, ts_b,
                       int(valid.shape[0]), self._col_modes, self._ts_mode,
                       self._valid_mode)

    def _demote(self, modes: tuple, ts_mode: str) -> None:
        """A wire-layout demotion: a barrier (staged uploads were packed
        under the old layout and step first, then the steps in flight
        dispatch), then the decode step is rebuilt once for the new
        layout, recorded under the cause ``batch_shape_change``."""
        self.drain_inflight()

        def rebuild():
            self._col_modes, self._ts_mode = modes, ts_mode

        if self._compile_obs is not None and self._stepped:
            self._compile_obs.build(CAUSE_BATCH_SHAPE, rebuild)
        else:
            # before the first step the layout is still being chosen:
            # nothing was built for the old one
            rebuild()

    @staticmethod
    def _wire_nbytes(inputs: "_Packed") -> int:
        """Wire bytes of one packed step: the packed columns, valid and
        ts, plus 8 bytes a base scalar."""
        n = sum(int(p.nbytes) for p in inputs.cols) + int(inputs.valid.nbytes)
        if inputs.ts is not None:
            n += int(inputs.ts.nbytes)
        return n + 8 * (len(inputs.bases) + 1)

    # -- staged uploads (tpustream/runtime/executor.py:1202-1270) -------------

    def _stage_ok(self) -> bool:
        return (process_count() == 1
                and not self.program.emissions_reference_state
                and self.cfg.max_fires_per_step is None)

    def _stage_step(self, inputs: "_Packed", wm_lower: int, t_batch) -> None:
        """Run one packed batch through the upload side of the pipeline:
        at h2d_depth 1 (or when staging is off) the step runs now;
        deeper, the batch's copy is issued now and its step runs up to
        ``h2d_depth - 1`` feeds later."""
        nbytes = self._wire_nbytes(inputs)
        self.metrics.h2d_bytes += nbytes
        self._h2d_bytes.inc(nbytes)
        if not self._h2d_ahead:
            self._run_step(inputs, wm_lower, t_batch)
            return
        traced = [m for m in self._pending_markers
                  if getattr(m, "trace_id", 0)]
        with self.obs.span("h2d", self._step_idx + len(self._upload_q) + 1), \
                Stopwatch() as sw:
            uploaded = self._wire.put(inputs)
        for m in traced:
            m.add_span("h2d", t0=sw.t0, dur=sw.elapsed)
        # markers detach at stage time so they ride THIS batch's step
        markers = self._take_markers()
        self._upload_q.append((uploaded, wm_lower, t_batch, markers))
        while len(self._upload_q) > self._h2d_ahead:
            self._pop_upload()

    def _pop_upload(self) -> None:
        uploaded, wm_lower, t_batch, markers = self._upload_q.pop(0)
        self._run_step(None, wm_lower, t_batch, markers=markers,
                       uploaded=uploaded)

    def _flush_uploads(self) -> None:
        """Run every staged batch's step."""
        while self._upload_q:
            self._pop_upload()

    # -- the counted step (tpustream/runtime/executor.py:1302-1405) -----------

    def _decode(self, uploaded: "_Uploaded"):
        """The step's ``(cols, valid, ts)`` from the wire tensors: delta
        expansion, dtype widening and bit unpacking on the device."""
        inp = uploaded.inputs
        n = inp.n
        t = uploaded.tensors

        def unpack_bits(p):
            shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=p.device)
            bits = (p[:, None] >> shifts) & 1
            return bits.reshape(-1)[:n].to(torch.bool)

        def expand(p, b, mode):
            if mode == "d16":
                return (p.to(torch.int64) & 0xFFFF) + b
            if mode == "d32":
                return p.to(torch.int64) + b
            if mode == "f32":
                # a float conversion on the device: XLA's flush reads a
                # float32 subnormal as a zero of its sign
                return flush_subnormal(p).to(torch.float64)
            if mode == "i16":
                return p.to(torch.int32)
            if mode == "bits":
                return unpack_bits(p)
            return p

        n_cols = len(inp.cols)
        cols = [expand(p, b, m) for p, b, m
                in zip(t[:n_cols], inp.bases, inp.col_modes)]
        valid = t[n_cols]
        if inp.valid_mode == "bits":
            valid = unpack_bits(valid)
        ts = None if inp.ts is None else expand(t[n_cols + 1], inp.ts_base,
                                                inp.ts_mode)
        return cols, valid, ts

    def _count_and_compact(self, emissions):
        """One count scalar a stream the host will read (the rows a mask
        selects, or a prefix stream's ``count``), each stream's
        ``bad_keys`` as of this step, and the compacted form of each
        mask-carrying stream: ``(names, counts, compact)``. Prefix
        streams are compact already and skip the gather."""
        names, counts, compact = [], [], {}
        wanted = {"main": True, "late": bool(self._late_sinks()),
                  "timeout": self._timeout_sink() is not None}
        for name, stream in emissions.items():
            if not wanted.get(name, False):
                continue
            bad = stream.get("bad_keys")
            if bad is not None:
                # the counter accumulates over steps: read it as of this one
                stream["bad_keys"] = bad = bad.clone()
                names.append(name + ":bad")
                counts.append(bad.reshape(()).to(torch.int32))
            if "mask" in stream:
                names.append(name)
                counts.append(stream["mask"].sum(dtype=torch.int32))
                if self._compact_cap:
                    compact[name] = self._compact_stream(stream)
            elif isinstance(stream.get("count"), torch.Tensor):
                names.append(name)
                counts.append(stream["count"].reshape(()).to(torch.int32))
        return names, counts, compact

    def _compact_stream(self, stream) -> dict:
        """Gather one stream's emitted rows, in emission order, into
        ``[compaction_capacity]`` buffers: the row indices (``__sel__``)
        and every ``[B]`` leaf. Rows past the capacity are absent; the
        host then spills to the full fetch."""
        mask, cap = stream["mask"], self._compact_cap
        nb = mask.shape[0]
        order = stream.get("order")
        if order is not None:
            # emission order is ascending j where mask[order[j]]
            pos, _ = compact_positions(mask[order], cap)
            sel = order[pos.to(torch.int64)]
        else:
            sel, _ = compact_positions(mask, cap)
        sel = sel.to(torch.int64)

        def gather(a):
            if isinstance(a, torch.Tensor) and a.dim() >= 1 and a.shape[0] == nb:
                return a[sel]
            if isinstance(a, tuple):
                return tuple(gather(x) for x in a)
            return a

        comp = {k: gather(v) for k, v in stream.items()
                if k not in ("mask", "order", "bad_keys")}
        comp["__sel__"] = sel
        return comp

    # -- steps in flight (tpustream/runtime/executor.py:1407-1496) ------------

    def _run_step(self, inputs: Optional["_Packed"], wm_lower: int, t_batch,
                  markers=None, uploaded=None) -> None:
        """One device step: upload (unless staged), decode, the program's
        step, the count scalars and compaction; the entry then waits in
        flight until its group is fetched. ``markers`` is the staged path
        handing over the markers it detached at stage time."""
        if self._fault is not None:
            self._fault("device_step")
            if self.program.operator_name == "cep":
                self._fault("cep_step")
        m, obs = self.metrics, self.obs
        self._step_idx += 1
        self._stepped = True
        step_markers = self._take_markers() if markers is None else markers
        if uploaded is None:
            # unstaged, the copy rides the step: no h2d hop of its own in
            # the trace, as in the reference (only staging times one)
            uploaded = self._wire.put(inputs)
        reads = self.program.host_reads
        self._flight.set_active(obs.name or self.program.operator_name)
        # the span times the host's issue of the step only: the wait for
        # the card is the fetch's
        with obs.span("dispatch", self._step_idx), Stopwatch() as dw:
            self._wire.ready(uploaded)
            cols, valid, ts = self._decode(uploaded)
            self.state, emissions = self.program.run_step(
                self.state, cols, valid, ts, wm_lower)
            names, counts, compact = self._count_and_compact(emissions)
            entry = _Entry(emissions, compact, names, t_batch, step_markers)
            self._wire.issue_counts(entry, counts, self._spec_leaves(emissions))
        entry.dispatch_s = dw.elapsed
        m.d2h_syncs += self.program.host_reads - reads
        m.steps += 1
        obs.steps.inc()
        obs.dispatch_time_s.observe(dw.elapsed)
        for mk in step_markers:
            if getattr(mk, "trace_id", 0):
                mk.add_span("device_step", t0=dw.t0, dur=dw.elapsed,
                            step=self._step_idx,
                            operator=obs.name or self.program.operator_name)
        self._inflight.append(entry)
        obs.inflight.set(len(self._inflight))
        while len(self._inflight) > self._max_inflight:
            g = self._fetch_group
            self._finish_group(self._inflight[:g])
            del self._inflight[:g]

    @property
    def _fetch_group(self) -> int:
        """Steps whose count scalars are read with one wait
        (``StreamConfig.fetch_group``), clamped to the in-flight window
        minus one: a group covering the whole window would drain the
        pipeline on every fetch. Several processes keep one step a
        fetch, as the reference does (executor.py:1483)."""
        if process_count() > 1:
            return 1
        return max(1, min(self.cfg.fetch_group, max(1, self._max_inflight)))

    def drain_inflight(self) -> None:
        """Dispatch every pending step's emissions (a barrier): staged
        uploads step first."""
        self._flush_uploads()
        if self._inflight:
            entries, self._inflight = self._inflight, []
            g = self._fetch_group
            for s in range(0, len(entries), g):
                self._finish_group(entries[s:s + g])
            self.obs.inflight.set(0)

    def drain_chain(self, proc_now: int) -> None:
        """Flush every stage's in-flight emissions down the chain: after
        this, the emissions of every consumed batch have reached the
        sinks or some stage's state."""
        r = self
        while r is not None:
            r.drain_inflight()
            r.pump_chain(proc_now)
            r = r.downstream

    def apply_knobs(self, knobs: dict) -> None:
        """Apply the barrier-safe pipeline knobs (``async_depth``,
        ``fetch_group``, ``h2d_depth``) at a drained barrier, the
        adaptive controller's application point. The build-time guards
        still win (a state-referencing program stays at depth 1,
        unstaged; max_fires_per_step stays unstaged), so output bytes
        never depend on a knob."""
        kw = {}
        if "async_depth" in knobs:
            d = max(1, int(knobs["async_depth"]))
            if d != self.cfg.async_depth:
                kw["async_depth"] = d
            if not self.program.emissions_reference_state:
                self._max_inflight = max(0, d - 1)
        if "fetch_group" in knobs:
            g = max(1, int(knobs["fetch_group"]))
            if g != self.cfg.fetch_group:
                kw["fetch_group"] = g  # read live through the property
        if "h2d_depth" in knobs:
            d = max(1, int(knobs["h2d_depth"]))
            if d != self.cfg.h2d_depth:
                kw["h2d_depth"] = d
            self._h2d_ahead = max(0, d - 1) if self._stage_ok() else 0
            self._wire.resize(d + 1)
        if kw:
            self.cfg = self.cfg.replace(**kw)

    # -- the fetch (tpustream/runtime/executor.py:1889-2078, 2192-2230) -------

    def _spec_leaves(self, emissions):
        """The prefix ``main`` stream's leaves to copy with this step's
        count scalars, sliced to the last firing step's rows (one wait
        then serves a step whose count fits), or None."""
        main = emissions.get("main")
        if (not self._prefix_hint or not self.program.main_emission_prefix
                or main is None or not isinstance(main.get("count"),
                                                  torch.Tensor)):
            return None
        leaves = self._prefix_leaves(main)
        b = min(self._prefix_hint, int(leaves[0].shape[0]))
        return [t[:b] for t in leaves]

    @property
    def _chain_leaves(self) -> tuple:
        """The hand-off's leaves a chained stage fetches beside its rows:
        the timestamps an event-time stage downstream reads, and, from a
        sharded stage, the window ends its canonical order sorts by."""
        if self._chain_ts:
            return ("window_end", "ts")
        if self.downstream is not None and self.program.n_shards > 1:
            return ("window_end",)
        return ()

    def _prefix_leaves(self, stream) -> List[torch.Tensor]:
        """A prefix stream's row leaves in a fixed order: its columns,
        then ``key``, then the chained hand-off's ``window_end``/``ts``."""
        leaves = list(stream["cols"])
        for k in ("key",) + self._chain_leaves:
            if k in stream:
                leaves.append(stream[k])
        return leaves

    def _rows_from(self, stream, arrays) -> dict:
        """Host arrays of a prefix or compacted stream's rows, in
        :meth:`_prefix_leaves` order, as ``{"cols", "key", ...}``."""
        n_cols = len(stream["cols"])
        out = {"cols": list(arrays[:n_cols])}
        i = n_cols
        for k in ("key",) + self._chain_leaves:
            if k in stream:
                out[k] = arrays[i]
                i += 1
        return out

    def _plan_stream(self, entry, name: str, c: int):
        """``(tensors, resolve)`` for one stream worth fetching: the
        tensors to copy, and a function from their host arrays to the
        stream's rows (``{"cols", "subtask"?, "key"?, "window_end"?,
        "ts"?}``, in emission order). A prefix stream copies its first
        ``c`` rows; a compacted stream within its capacity the first
        ``c`` compact rows; past it the stream spills to the full fetch,
        exact, counted in ``compaction_spills``."""
        stream = entry.emissions[name]
        if "mask" not in stream:
            spec = entry.spec_host
            if name == "main" and spec is not None and c <= spec[0].shape[0]:
                got = [a[:c] for a in spec]
                return [], lambda _got: self._rows_from(stream, got)
            leaves = [t[:c] for t in self._prefix_leaves(stream)]
            return leaves, lambda got: self._rows_from(stream, got)
        comp = entry.compact.get(name)
        if comp is not None:
            if c <= self._compact_cap:
                leaves = [t[:c] for t in self._prefix_leaves(comp)]
                sub = comp.get("subtask")
                if sub is not None:
                    leaves.append(sub[:c])

                def resolve(got):
                    rows = self._rows_from(comp, got)
                    if sub is not None:
                        rows["subtask"] = got[-1]
                    return rows

                return leaves, resolve
            self._spill_counter.inc()
            self.metrics.compaction_spills += 1
            if name not in self._spilled_streams:
                self._spilled_streams.add(name)
                self._flight.record(
                    "compaction_spill",
                    operator=self.obs.name or self.program.operator_name,
                    stream=name, count=int(c), capacity=self._compact_cap)
        leaves = [stream["mask"]] + self._prefix_leaves(stream)
        sub = stream.get("subtask")
        if sub is not None:
            leaves.append(sub)
        order = stream.get("order")
        if order is not None:
            leaves.append(order)

        def resolve_full(got):
            mask = got[0]
            if order is not None:
                o = got[-1].astype(np.int64)
                pos = np.nonzero(mask[o])[0]
                sel = o[pos]
                got = got[:-1]
            else:
                sel = pos = np.nonzero(mask)[0]
            rows = self._rows_from(stream, [a[sel] for a in got[1:]])
            if sub is not None:
                rows["subtask"] = got[-1][sel]
            if self._multiproc:
                # each row's place in the single-process emission order
                rows["row"] = pos + self._local_row_base(mask.shape[0])
            return rows

        return leaves, resolve_full

    def _finish_group(self, entries) -> None:
        """Fetch and dispatch a group of steps in order: one wait for
        every entry's count scalars (the last entry's copy follows the
        others on the stream), then one copy of every stream still worth
        fetching, then each entry's rows to the sinks."""
        m = self.metrics
        with self.obs.span("fetch", self._step_idx), Stopwatch() as sw:
            with Stopwatch() as ww:
                self._wire.wait_counts(entries, m)
            plans = []
            for e in entries:
                cnt = e.counts
                bad = max((v for k, v in cnt.items() if k.endswith(":bad")),
                          default=0)
                plan = {}
                if not bad:
                    for name in e.emissions:
                        c = cnt.get(name)
                        if c:
                            plan[name] = self._plan_stream(e, name, c)
                    main_c = cnt.get("main", 0)
                    if main_c and self.program.main_emission_prefix:
                        cap = int(e.emissions["main"]["cols"][0].shape[0]) \
                            if e.emissions["main"]["cols"] else 0
                        self._prefix_hint = min(
                            cap, 1 << max(5, (main_c - 1).bit_length() + 1))
                plans.append((plan, bad))
            tensors = [t for plan, _ in plans for lv, _ in plan.values()
                       for t in lv]
            got = self._to_host(tensors) if tensors else []
            if self.obs.enabled:
                self._account_fetch(entries, plans, got)
        per_wait = ww.elapsed / len(entries)
        per_rows = (sw.elapsed - ww.elapsed) / len(entries)
        i = 0
        for e, (plan, bad) in zip(entries, plans):
            rows = {}
            for name, (lv, resolve) in plan.items():
                rows[name] = resolve(got[i:i + len(lv)])
                i += len(lv)
            step_s = e.dispatch_s + per_wait
            m.step_times_s.append(step_s)
            self.obs.step_time_s.observe(step_s)
            m.fetch_times_s.append(per_rows)
            for mk in e.markers:
                if getattr(mk, "trace_id", 0):
                    mk.add_span("fetch", t0=sw.t0, dur=sw.elapsed,
                                group=len(entries))
            if bad:
                raise IndexError(
                    f"{int(bad)} rows carried a key id past the keyed "
                    f"state's capacity of {self.cfg.key_capacity}"
                )
            self._dispatch(e, rows)

    def _account_fetch(self, entries, plans, got) -> None:
        """``fetch_bytes_total`` and ``compaction_ratio`` (obs-enabled
        runs only): the bytes fetched against what the same streams
        would cost as whole buffers."""
        # the rows' copy counted itself (_to_host); the count scalars and
        # the speculative slices are counted here
        side = sum(sum(int(h.numel() * h.element_size()) for h in e.host)
                   for e in entries)
        self._fetch_bytes.inc(side)
        fetched = side + sum(int(a.nbytes) for a in got)
        full = 0
        for e, (plan, _) in zip(entries, plans):
            for name in plan:
                st = e.emissions[name]
                full += sum(t.numel() * t.element_size() for t in
                            ([st["mask"]] if "mask" in st else [])
                            + self._prefix_leaves(st))
        if full:
            self._compaction_gauge.set(fetched / full)

    def _dispatch(self, entry, rows) -> None:
        """One step's emissions to the sinks (or the chain buffer), in
        the reference's order: a full-window program's fires, the main
        stream, the late rows, the CEP timeouts; all of it under one
        ``emit`` span a step, as the reference's, then the step's
        markers."""
        with self.obs.span("emit", self._step_idx):
            self._dispatch_rows(entry, rows)
        if entry.markers:
            self._record_markers(entry.markers)

    def _dispatch_rows(self, entry, rows) -> None:
        m, obs = self.metrics, self.obs
        emitted_before = m.records_emitted
        self._dispatch_seq += 1
        fire_info = entry.emissions.get("process_fire")
        if fire_info is not None:
            self._evaluate_fires(fire_info)
        main = rows.get("main")
        if main is not None and len(main["cols"]) and len(main["cols"][0]):
            with Stopwatch() as sw:
                out = main["cols"]
                if self.downstream is not None:
                    self._buffer_chain(main, out)
                else:
                    subtask = main.get("subtask")
                    if subtask is None and main.get("key") is not None:
                        n_shards = max(1, self.cfg.parallelism)
                        subtask = main["key"].astype(np.int64) % n_shards
                    for j, row in enumerate(self.formatter.rows(out)):
                        self._emit_row(
                            row, None if subtask is None else int(subtask[j]))
                    m.records_emitted += len(out[0])
            m.emit_times_s.append(sw.elapsed)
        late = rows.get("late")
        if late is not None:
            with Stopwatch() as sw:
                self._dispatch_late(late["cols"])
            m.emit_times_s.append(sw.elapsed)
        timeout = rows.get("timeout")
        if timeout is not None:
            with Stopwatch() as sw:
                self._dispatch_timeout(timeout["cols"])
            m.emit_times_s.append(sw.elapsed)
        emitted_delta = m.records_emitted - emitted_before
        if emitted_delta:
            obs.records_emitted.inc(emitted_delta)
            m.emit_latencies_s.append(time.perf_counter() - entry.t_batch)

    def _local_row_base(self, n_rows: int) -> int:
        """The global row of this process's first emission row, in a
        sharded stream of ``n_rows`` local rows (its shards' blocks of
        the global stacked rows; tpustream/runtime/executor.py:1127)."""
        mesh = self.program.mesh
        return mesh.first * (n_rows // mesh.n_local)

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
            if self._multiproc and order is not None:
                # the step leads the cross-process merge order
                order = (self._dispatch_seq,) + tuple(order)
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
        """The late-data side outputs, ``(tag id, (ops, sink))`` each:
        every side sink but the CEP timeout tag's, which receives only
        the timeout stream."""
        tt = getattr(self.program, "timeout_tag", None)
        return [(tag_id, entry) for tag_id, entry in self.side_sinks.items()
                if tt is None or tag_id != tt.id]

    def _timeout_sink(self):
        """(ops, sink) of the CEP timeout tag's side output, or None (the
        device counts expired partials in ``cep_timeouts`` either way)."""
        tt = getattr(self.program, "timeout_tag", None)
        return self.side_sinks.get(tt.id) if tt is not None else None

    def _side_edge(self, tag_id):
        """The ledger's emit edge of one side output (None: ledger off)."""
        return (self._ledger_side.get(tag_id)
                if self._ledger_side is not None else None)

    @staticmethod
    def _emit_side(ops, sink, rows, edge) -> None:
        """One side output's rows through its host-side ops to its sink,
        accounting the emit edge (in == emitted + filtered)."""
        for row in rows:
            item, keep = _apply_ops(ops, row)
            if keep:
                sink.emit(item)
            elif edge is not None:
                edge["filtered"] += 1
            if edge is not None:
                edge["in"] += 1

    def _dispatch_late(self, cols) -> None:
        """Rows late past the allowed lateness, to every late-data side
        output (after its host-side ops). (The device counts drops
        itself, in ``late_dropped``, for jobs with no side output.)"""
        for tag_id, (ops, sink) in self._late_sinks():
            self._emit_side(ops, sink, self.late_formatter.rows(cols),
                            self._side_edge(tag_id))

    def _dispatch_timeout(self, cols) -> None:
        """CEP partial matches whose ``within`` expired, to the pattern's
        timeout side output (Flink's PatternTimeoutFunction stream)."""
        ops, sink = self._timeout_sink()
        fmt = EmissionFormatter(self.program.timeout_kinds,
                                self.program.timeout_tables)
        self._emit_side(ops, sink, fmt.rows(cols),
                        self._side_edge(self.program.timeout_tag.id))

    def _emit_row(self, row, subtask: Optional[int], ts=None, order=None) -> None:
        """Fan one emitted record out to every branch: the branch's
        host-side map/filter tail, then its sink. A chained process()
        stage buffers the row, with its window timestamp and its place
        in the evaluation order, for the downstream runner."""
        if self._chained:
            self._chain_rows.append((row, ts, order))
            self._ledger_handed += 1
            return
        if self._ledger_edges is None:
            for ops, sink in self.sinks:
                item, keep = _apply_ops(ops, row)
                if keep:
                    sink.emit(item, subtask=subtask)
            return
        # ledger on: account each branch's fan-out (in == emitted +
        # filtered); "in" counts after the emit resolved, so a sink that
        # raises (the attempt is abandoned and replayed) latches no false
        # violation
        for (ops, sink), edge in zip(self.sinks, self._ledger_edges):
            item, keep = _apply_ops(ops, row)
            if keep:
                sink.emit(item, subtask=subtask)
            else:
                edge["filtered"] += 1
            edge["in"] += 1

    def finalize_metrics(self) -> None:
        """Fold the device-side counters into Metrics (one read a job;
        the stages of a chain add theirs to the same Metrics)."""
        names = [n for n in self._COUNTER_NAMES if n in self.state]
        if names:
            vals = self._to_host([self.state[n] for n in names])
            for n, v in zip(names, vals):
                delta = int(v) - self._counter_baseline.get(n, 0)
                setattr(self.metrics, n, getattr(self.metrics, n) + delta)
                if delta:
                    self.obs.counter(n).inc(delta)
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


def _make_runner_chain(plans, cfg, metrics, lazy_schemas=None) -> Runner:
    """Build the runner for plans[0] plus downstream runners for any
    chained stages, wiring record schemas from each upstream program.

    A stage fed by a full-window process() stage resolves its schema
    from the user function's collected rows (the function may emit any
    shape), so its runner is built lazily, on the first pump that has
    rows, unless ``lazy_schemas`` (a checkpoint restore) supplies the
    schema each such stage had inferred: the chain then builds at once
    with the snapshot's kinds and tables."""
    lazy_schemas = list(lazy_schemas or [])
    runner = Runner(plans[0], cfg, metrics)
    up = runner
    for i, p2 in enumerate(plans[1:], start=1):
        if up.program.host_evaluated and lazy_schemas:
            saved = lazy_schemas.pop(0)
            p2.record_kinds.extend(saved["kinds"])
            last = len(saved["tables"]) - 1
            for ti, t in enumerate(saved["tables"]):
                if t is None:
                    p2.tables.append(None)
                    continue
                # a computed-key stage's trailing synthetic column
                # restores as a DerivedKeyTable
                table = (DerivedKeyTable() if p2.synthetic_key and ti == last
                         else StringTable())
                table.load_state_dict(t)
                p2.tables.append(table)
            r2 = Runner(p2, cfg, metrics)
            r2._lazy_schema = True
            up.chain_to(r2)
            up = r2
            continue
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


def _skip_lines(sb, n: int):
    """``(batch, taken)``: ``sb`` without its first ``min(n, len)``
    lines (a resumed run skips what the snapshot consumed)."""
    from .sources import SourceBatch

    take = min(n, sb.n_records)
    if sb.raw is not None:
        rest = b""
        if take < sb.n_raw:
            off = 0
            for _ in range(take):
                off = sb.raw.index(b"\n", off) + 1
            rest = sb.raw[off:]
        return SourceBatch([], sb.proc_ts[take:], sb.advance_proc_to, sb.final,
                           raw=rest, n_raw=sb.n_raw - take,
                           markers=sb.markers), take
    return SourceBatch(sb.lines[take:], sb.proc_ts[take:], sb.advance_proc_to,
                       sb.final, markers=sb.markers), take


def _restore(env, path, plans, cfg, metrics, job_obs, sink_nodes,
             supervision, dead_letters, ledger=None):
    """``(runner, checkpoint)``: the runner chain rebuilt from the
    snapshot at ``path``, in the reference's order. The intern tables,
    the host RuleSet and the fleet's tenant table come back before the
    programs build (their initial rule leaves read the RuleSet); a
    process()-fed stage builds from its snapshotted schema; each stage
    restores at the key capacity it ran at, growing past the configured
    one (cause ``config_change``) or growing the restored rows into a
    larger configured one; a computed-key chain stage gets its key
    table back; the device counters become the baseline. Under
    supervision the collect sinks and dead letters roll back to the
    snapshot, so the replayed suffix lands exactly once, and the
    ``ledger`` (if on) verifies the rolled-back sinks against the
    snapshot's digest anchors."""
    from .checkpoint import load_checkpoint

    plan = plans[0]
    ck = load_checkpoint(path)
    ck.restore_tables(plan)
    if plan.rules is not None and ck.rule_values is not None:
        # the control-feed cursor (= version) then skips the applied
        # prefix of the schedule; tenant mode restores the vectors too
        plan.rules.load(ck.rule_values, ck.rule_version)
    if ck.tenancy is not None and getattr(env, "_tenancy", None) is not None:
        env._tenancy.load_state_dict(ck.tenancy)
    runner = _make_runner_chain(plans, cfg, metrics,
                                lazy_schemas=ck.lazy_schemas)
    stages = runner.chain()
    # computed-KeySelector chain stages intern into tables built at run
    # time: reload them so saved state rows keep their key ids
    for r, t in zip(stages, ck.chain_key_tables or []):
        if t is not None and r.plan.synthetic_key and r.plan.tables:
            r.plan.tables[-1].load_state_dict(t)
    saved_caps = list(ck.key_capacities or [])
    caps = [saved_caps[i] if i < len(saved_caps) and saved_caps[i]
            else r.cfg.key_capacity for i, r in enumerate(stages)]
    states = ck.restore_chain([r.program for r in stages], caps)
    for r, state, cap in zip(stages, states, caps):
        if not hasattr(r.program, "grow_state") or cap == r.cfg.key_capacity:
            r.state = state
        elif cap > r.cfg.key_capacity:
            # key growth had taken the stage past its configured
            # capacity when the snapshot was written
            r._grow_to(cap, CAUSE_CONFIG, lambda state=state: state)
        else:
            # a capacity configured above the snapshot's wins: the
            # restored rows grow into it
            r.state = r.program.grow_state(state, r.cfg.key_capacity)
        r.snapshot_counter_baseline()
    if supervision is not None:
        # a snapshot of THIS supervised session records the collect
        # sinks' absolute lengths; an older or manual one describes
        # another process's handles, so those roll back to the
        # supervisor's pre-job baselines. An unsupervised restore (a
        # fresh env resuming by hand) never truncates.
        handles = [n.params["handle"] for n in sink_nodes
                   if n.op == "sink_collect"]
        same_session = ck.session is not None and ck.session == supervision.nonce
        counts = (list(ck.sink_counts)
                  if same_session and ck.sink_counts is not None
                  else list(supervision.base_counts))
        for h, keep in zip(handles, counts):
            del h.items[keep:]
        if dead_letters is not None:
            keep_dead = ck.quarantined if same_session else supervision.base_dead
            del dead_letters[keep_dead:]
            metrics.records_quarantined = len(dead_letters)
        if ledger is not None:
            # the truncated persistent sinks must now match the
            # snapshot's anchors: re-derive each digest over the rolled-
            # back contents and verify (same-session anchors only: an
            # older session's describe another process's contents), then
            # re-anchor every account
            ledger.on_restore(ck.ledger, verify=same_session)
        # recovery accounting: batches the resumed run skips to reach
        # the snapshot, and wall time from the restart decision
        # (including its delay) to the state back on the device
        supervision.replay_batches_total += ck.batches
        job_obs.counter("recovery_replay_batches").set_total(
            supervision.replay_batches_total)
        t0 = getattr(env, "_recovery_t0", None)
        if t0 is not None:
            job_obs.histogram("recovery_wall_ms").observe(
                (time.perf_counter() - t0) * 1000.0)
            env._recovery_t0 = None
        job_obs.flight.record(
            "job_restored", checkpoint=path, batches=ck.batches,
            emitted=ck.emitted, source_pos=ck.source_pos)
    return runner, ck


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
    ``env.config.device``, supervised when a restart strategy is
    configured.

    With ``StreamConfig.restart_strategy`` set, failures route through
    runtime/supervisor.py: the strategy decides whether the job
    restarts, and a restart rebuilds the chain and resumes exactly-once
    from the latest valid checkpoint. Unset (the default), the first
    failure propagates."""
    # pre-flight static analysis (tpustream_torch/analysis): runs ONCE
    # per submission, before supervision, planning, any allocation or
    # any launch. Under strict_analysis an ERROR finding aborts the job
    # here; otherwise (obs on) the findings stash on the env and the
    # first attempt's _execute_job turns them into counters + flight
    # breadcrumbs.
    if getattr(env.config, "strict_analysis", False) or env.config.obs.enabled:
        from ..analysis import PlanAnalysisError, analyze, has_errors

        findings = analyze(env, sink_nodes)
        if findings:
            env._analysis_findings = findings
        if getattr(env.config, "strict_analysis", False) and has_errors(findings):
            raise PlanAnalysisError(findings)
    if env.config.ingest_lanes > 1 and env.config.obs.enabled:
        # lane recovery keeps the job running with no restart: it
        # surfaces through a built-in WARN health rule, installed before
        # the obs root reads the rules
        from .supervisor import (
            _install_lane_contention_health_rule,
            _install_lane_restart_health_rule,
        )

        _install_lane_restart_health_rule(env)
        if getattr(env.config.obs, "resources", False):
            _install_lane_contention_health_rule(env)
    # conservation ledger (obs/ledger.py): a latched invariant violation
    # is a correctness event, so its built-in rule is CRIT; installed
    # before the obs root reads the rules, supervised or not
    from ..obs.ledger import ledger_effective

    if ledger_effective(env.config.obs):
        from .supervisor import _install_ledger_health_rule

        _install_ledger_health_rule(env)
    # restore drills (runtime/checkpoint.py restore_drill): a failed
    # dry-restore of the nominal newest snapshot is a WARN, repeated
    # failures CRIT; installed before the obs root reads the rules
    if (env.config.restore_drill_interval_s > 0 and env.config.obs.enabled
            and bool(env.config.checkpoint_dir)
            and env.config.checkpoint_interval_batches > 0):
        from .supervisor import _install_restore_drill_health_rules

        _install_restore_drill_health_rules(env)
    if env.config.restart_strategy is not None:
        if process_count() > 1:
            # a failed pair tears its group down (Mesh.abort): an attempt
            # restarted in the process would have no peers
            raise NotImplementedError(
                "supervised restarts of a job over several processes are "
                "not supported: restart the processes from the latest "
                "snapshot (env.restore_from_checkpoint)")
        from .supervisor import supervise

        return supervise(env, sink_nodes, _run_attempt)
    return _run_attempt(env, sink_nodes)


def _run_attempt(env, sink_nodes) -> JobResult:
    """One execution attempt. On any failure an obs-enabled job records
    the exception in its flight recorder (and, unsupervised, writes the
    postmortem dump) before re-raising. Either way the attempt's
    parse-ahead thread, ingest lanes and checkpoint writer stop, and a
    failed attempt's device state and pinned buffers are released, so a
    supervised restart builds all of them anew."""
    try:
        result = _execute_job(env, sink_nodes)
    except BaseException as e:
        job_obs = getattr(getattr(env, "metrics", None), "job_obs", None)
        if job_obs is not None:
            # a supervised attempt may restart: the postmortem dump is
            # the supervisor's call, made only when it gives up
            job_obs.on_failure(
                e, dump=getattr(env, "_supervision", None) is None)
        runner = env.__dict__.pop("_runner", None)
        if runner is not None:
            runner.release()
        raise
    finally:
        # the parse-ahead thread first: it may still be reading the
        # source, and a restart re-reads it from the start
        ahead = env.__dict__.pop("_parse_ahead", None)
        if ahead is not None:
            ahead.close()
        # lane workers and their shared-memory rings die with the
        # attempt, failed or not
        plane = env.__dict__.pop("_ingest_plane", None)
        if plane is not None:
            plane.close()
        # the checkpoint writer: an in-flight write may land (completed
        # snapshots are consistent); its failure is not re-raised here,
        # it crossed at a submit/flush or the attempt fails for its own
        # reason
        ck_plane = env.__dict__.pop("_checkpoint_plane", None)
        if ck_plane is not None:
            ck_plane.close(raise_error=False)
    env.__dict__.pop("_runner", None)
    env.metrics.job_obs.close()
    return result


class _ParseAhead:
    """The parse-ahead thread of one attempt: :meth:`close` stops it and
    waits for it, so that no thread of a failed attempt still reads the
    source when its restart does."""

    def __init__(self, stop, thread):
        self.stop, self.thread = stop, thread

    def close(self) -> None:
        self.stop.set()
        self.thread.join(timeout=30.0)


def _prefetch_iter(it, depth: int, depth_gauge=None, handle=None):
    """Drain ``it`` on a daemon thread into a bounded queue (size
    ``depth``): the producer blocks when the consumer falls behind, and a
    producer exception re-raises at the consumer. Used for
    ``StreamConfig.parse_ahead``; ``depth_gauge`` (obs) reads the queue
    depth at snapshot time; ``handle(_ParseAhead)`` receives the thread's
    stop handle. (A copy of the reference's.)"""
    import queue as queue_mod
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(1, depth))
    if depth_gauge is not None:
        depth_gauge.set_fn(q.qsize)
    stop = threading.Event()

    def put(item) -> bool:
        # gives up when the consumer abandoned the generator, so the
        # producer never blocks on a full queue forever
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def run():
        try:
            for item in it:
                if not put(("item", item)) or stop.is_set():
                    return
            put(("done", None))
        except BaseException as e:  # surfaces in the consumer
            put(("err", e))

    thread = threading.Thread(target=run, name="tpustream-parse-ahead",
                              daemon=True)
    thread.start()
    if handle is not None:
        handle(_ParseAhead(stop, thread))
    try:
        while True:
            kind, payload = q.get()
            if kind == "done":
                return
            if kind == "err":
                raise payload
            yield payload
    finally:
        stop.set()


def _make_job_obs(env, cfg: StreamConfig, supervision=None):
    """``(metrics, job_obs)``: the registry-backed Metrics facade and,
    with ``cfg.obs.enabled``, the job's obs root (else its null twin).
    Under supervision every attempt records into the one flight ring,
    and its registry starts from the cumulative restart counters."""
    if not cfg.obs.enabled:
        metrics = Metrics()
        return metrics, metrics.job_obs
    from ..obs.flightrecorder import jsonable_config
    from ..obs.runtime import JobObs

    job_obs = JobObs(
        cfg.obs, job_name=env.job_name or "job", device=cfg.device,
        flight=supervision.flight if supervision is not None else None)
    metrics = Metrics(registry=job_obs.registry, job_name=job_obs.job_name)
    metrics.job_obs = job_obs
    if supervision is not None:
        supervision.seed_metrics(job_obs)
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
        # the build flavor (default, or the asan sanitizer build) names
        # which parser ran
        job_obs.flight.record(
            "native_parse_ready", flavor=_native_mod.build_flavor())
    # pre-flight analysis findings (stashed by execute_job; popped so a
    # supervised restart doesn't double-count): WARN/ERROR go to the
    # flight ring, every finding increments the per-code counter
    pending_findings = env.__dict__.pop("_analysis_findings", None)
    if pending_findings and job_obs.enabled:
        for f in pending_findings:
            job_obs.group.group(code=f.code).counter(
                "analysis_findings_total"
            ).inc()
            if f.severity in ("error", "warn"):
                job_obs.flight.record(
                    "analysis_finding",
                    code=f.code,
                    severity=f.severity,
                    node=repr(f.node) if f.node is not None else None,
                    message=f.message,
                )
    return metrics, job_obs


def _execute_job(env, sink_nodes) -> JobResult:
    # the effective config: cross-knob clamps applied once, here;
    # env.config keeps the requested values
    cfg, resolve_notes = env.config.resolve()
    resolve_device(cfg.device)  # refuse a missing card before any work
    with Stopwatch() as setup:
        plans = build_plan_chain(env, sink_nodes)
        plan = plans[0]
        host = HostStage(plan, cfg)
    # supervised execution (runtime/supervisor.py): cross-attempt state,
    # the shared flight ring, the cumulative restart counters and the
    # session nonce checkpoints are stamped with
    supervision = getattr(env, "_supervision", None)
    metrics, job_obs = _make_job_obs(env, cfg, supervision)
    env.metrics = metrics
    metrics.build_time_s = setup.elapsed
    # one breadcrumb a resolution clamp
    for note in resolve_notes:
        job_obs.flight.record("config_clamped", **note)
    # several processes (parallel/distributed.py): each runs this loop
    # over the same replayed source, and every host decision before a
    # collective must come out the same on each; what reads a local
    # clock or a local count is off (tpustream/runtime/executor.py:
    # 2755-2800, 3450-3470, 3548-3556)
    single = process_count() == 1
    is_coordinator = process_index() == 0
    # the adaptive pipeline controller (runtime/controller.py): moves the
    # barrier-safe depths at snapshot ticks; it reads the live registry,
    # whose locally timed decisions would differ between processes
    controller = None
    if job_obs.enabled and getattr(cfg.obs, "adaptive", False):
        if single:
            from .controller import AdaptiveController

            controller = AdaptiveController(cfg, job_obs)
        else:
            job_obs.flight.record("controller_disabled", reason="multiprocess")
    # dead-letter quarantine output (StreamConfig.dead_letter): on the
    # env, where the user reads it after execute
    dead_letters = getattr(env, "dead_letters", None)
    if dead_letters is None and cfg.dead_letter:
        dead_letters = env.dead_letters = []
    # conservation ledger (obs/ledger.py): per-edge record accounting
    # and per-sink digest anchors, one per attempt beside the obs root.
    # Its refresh rides the snapshotter's pre-hooks, so the residual
    # gauges are evaluated at the snapshot cadence (and once at close).
    ledger = None
    from ..obs.ledger import ledger_effective

    if ledger_effective(cfg.obs) and not single:
        # a process's counts are partial: every edge's residual would be
        # off
        job_obs.flight.record("ledger_disabled", reason="multiprocess")
    elif ledger_effective(cfg.obs):
        from ..obs.ledger import ConservationLedger

        ledger = ConservationLedger(
            job_obs, digests=getattr(cfg.obs, "ledger_digests", True))
        job_obs.ledger = ledger
        job_obs.snapshotter.ledger = ledger
        job_obs.snapshotter.pre_hooks.append(ledger.refresh)
        if dead_letters is not None:
            ledger.register_dead_letters(dead_letters)
        if cfg.ingest_lanes > 1:
            # lane workers parse in processes whose host-op counts this
            # ledger cannot see: the source edge is informational; the
            # sink, chain and contents edges stay exact
            ledger.source_exact = False
            ledger.source_note = (
                "sharded ingestion: host-side terms are partial, "
                "residual not evaluated")
        else:
            host.ledger_counts = {
                "dropped": 0, "fm_in": 0, "fm_out": 0, "quarantined": 0}
    # the fault injector (testing/faults.py) outlives restart attempts,
    # so its occurrence counters keep counting across rebuilds
    fault = _fault_hook(cfg)
    injector = cfg.extra.get("fault_injector") if cfg.extra else None
    runner: Optional[Runner] = None
    processing_time = plan.time_characteristic == TimeCharacteristic.ProcessingTime
    proc_now = 0
    # a scratch restart (no checkpoint to restore): recovery ends when
    # the rebuilt attempt starts; a checkpointed restart observes it in
    # the restore block below, after the state is back on the device
    if (supervision is not None
            and getattr(env, "_recovery_t0", None) is not None
            and not getattr(env, "_checkpoint_restore_path", None)):
        job_obs.histogram("recovery_wall_ms").observe(
            (time.perf_counter() - env._recovery_t0) * 1000.0)
        env._recovery_t0 = None
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
    # -- checkpoint restore -------------------------------------------------
    skip_lines = 0
    restore_path = getattr(env, "_checkpoint_restore_path", None)
    if restore_path:
        runner, ck = _restore(env, restore_path, plans, cfg, metrics, job_obs,
                              sink_nodes, supervision, dead_letters, ledger)
        skip_lines, proc_now = ck.source_pos, ck.proc_now
        env._runner = runner
    lines_consumed = skip_lines
    ruleset = plan.rules
    control_feed = None
    if plan.broadcast is not None and ruleset is not None:
        if not restore_path:
            # a run from the start replays the data from record 0, so
            # the rule timeline replays with it: the RuleSet goes back
            # to its defaults at version 0 and the feed applies every
            # update at its record position (a restore resynced the
            # RuleSet to the snapshot, and the feed skips what applied)
            ruleset.reset()
        control_feed = plan.broadcast.feed(cfg.batch_size)
    # perf_counter at the last rule application; the next non-empty feed
    # closes the propagation window (rule_update_propagation_ms)
    rule_apply_t0: List[Optional[float]] = [None]

    def apply_rule_updates(updates) -> None:
        """Land a group of rule updates at the current record boundary:
        every row fed so far finishes its way down the chain under the
        old rules (a barrier: the pipeline drains), then the host RuleSet
        and every stage's rule tensors take the new values."""
        rule_apply_t0[0] = time.perf_counter()
        runner.drain_chain(proc_now)
        old_version = ruleset.version
        for u in updates:
            ruleset.apply(u)
        for r in runner.chain():
            r.refresh_rules()
        tenant_slots = sorted({u.tenant for u in updates
                               if getattr(u, "tenant", None) is not None})
        if fault is not None:
            fault("control_apply")
            if tenant_slots:
                fault("tenant_apply")
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

    def quarantine(sb, err):
        """Re-parse a failed batch line by line: the lines that parse
        feed the device as one batch, the rest land in
        ``env.dead_letters`` as ``(line, "Type: message")``, up to
        ``dead_letter_capacity`` (``records_quarantined`` counts past
        it). A batch that fails only as a whole re-raises."""
        lines = _raw_lines(sb) if sb.raw is not None else sb.lines
        good: List[str] = []
        good_idx: List[int] = []
        bad = 0
        first_err = None
        # the per-line probe parses commit no host-op ledger terms: the
        # probe AND the final re-parse of the good lines would count
        # every filter and flat_map twice
        saved_counts, host.ledger_counts = host.ledger_counts, None
        try:
            for i, line in enumerate(lines):
                try:
                    host.process([line], sb.proc_ts[i:i + 1])
                except Exception as line_err:
                    bad += 1
                    first_err = first_err if first_err is not None else line_err
                    if len(dead_letters) < cfg.dead_letter_capacity:
                        entry = (line,
                                 f"{type(line_err).__name__}: {line_err}")
                        if ledger is not None:
                            # append and digest-fold together (this may
                            # run on the parse-ahead thread)
                            ledger.note_dead_letter(dead_letters, entry)
                        else:
                            dead_letters.append(entry)
                else:
                    good.append(line)
                    good_idx.append(i)
        finally:
            host.ledger_counts = saved_counts
        if not bad:
            # every line parses alone: a batch-level error, not bad data
            raise err
        if saved_counts is not None:
            # every bad line leaves the stream here, counted even past
            # dead_letter_capacity, like records_quarantined
            saved_counts["quarantined"] += bad
        metrics.records_quarantined += bad
        job_obs.flight.record(
            "records_quarantined",
            count=bad,
            total=int(metrics.records_quarantined),
            error=f"{type(first_err).__name__}: {str(first_err)[:200]}",
        )
        return host.process(
            good, sb.proc_ts[np.asarray(good_idx, dtype=np.int64)])

    skip_state = [skip_lines]

    def prepare(sb):
        """The host stage of one source batch: ``(sb, Batch or None,
        wm_hint, stopwatch)``. Runs inline, on the parse-ahead thread, or
        (for the frames the ingest lanes cannot take) at the lanes'
        merge point; these calls come in sequence either way, so
        ``skip_state`` has one writer."""
        if skip_state[0] > 0 and sb.n_records:
            # resume: drop the source lines the snapshot already consumed
            sb, taken = _skip_lines(sb, skip_state[0])
            skip_state[0] -= taken
        with job_obs.tracer.span("parse"), Stopwatch() as hw:
            if fault is not None:
                fault("parse")
            try:
                batch, wm_hint = _parse(host, sb)
            except Exception as e:
                # injected faults model a crash, not bad data: they
                # escalate
                if dead_letters is None or getattr(e, "fault_injection", False):
                    raise
                batch, wm_hint = quarantine(sb, e)
        if ledger is not None:
            # ONE commit a batch (offered is after the resume trim): the
            # parse-ahead thread owns these terms and the evaluator reads
            # under the same lock, so it never sees a torn cut
            ledger.account_source(
                offered=sb.n_records,
                admitted=batch.n if batch is not None else 0,
                host=host.ledger_counts)
        return sb, batch, wm_hint, hw

    # -- checkpoints (runtime/checkpoint.py) --------------------------------
    ckpt_every = cfg.checkpoint_interval_batches
    ckpt_enabled = bool(cfg.checkpoint_dir) and ckpt_every > 0
    # the async plane: the barrier pays the capture only; encode, write,
    # prune and GC run on one background writer thread. _run_attempt
    # closes it, so a failed attempt never leaks a writer thread
    # the coordinator alone writes; the other processes still capture,
    # the gathers of a capture being collective
    ckpt_plane = None
    if ckpt_enabled and cfg.checkpoint_async and is_coordinator:
        from .checkpoint import CheckpointPlane

        ckpt_plane = env._checkpoint_plane = CheckpointPlane(
            cfg.checkpoint_dir,
            keep=cfg.checkpoint_keep,
            keep_every=cfg.checkpoint_keep_every,
            inflight=cfg.checkpoint_async_inflight,
            incremental=cfg.checkpoint_incremental,
            fault=fault,
        )

    def note_checkpoint_report(rep: dict) -> None:
        """One completed write's report to the metrics and the flight
        ring (main thread only: async reports cross via drain_reports)."""
        if "write_wall_ms" in rep:
            job_obs.histogram("checkpoint_write_wall_ms").observe(
                rep["write_wall_ms"])
        job_obs.histogram("checkpoint_bytes").observe(rep["bytes_total"])
        job_obs.histogram("checkpoint_bytes_delta").observe(rep["bytes_delta"])
        job_obs.counter("checkpoint_chunks_reused_total").inc(
            rep["chunks_reused"])
        if rep["gc_deleted"]:
            job_obs.counter("checkpoint_gc_deleted_total").inc(rep["gc_deleted"])
        metrics.checkpoint_reports.append(rep)
        job_obs.flight.record(
            "checkpoint_saved",
            path=rep["path"],
            batches=rep["batches"],
            source_pos=rep["source_pos"],
            write_ms=round(rep.get("write_wall_ms", 0.0), 3),
            bytes_delta=rep["bytes_delta"],
            chunks_reused=rep["chunks_reused"],
            env=job_obs.env_compact(),
        )

    def capture_cut():
        """One consistent cut at the checkpoint barrier. A real barrier:
        the staged uploads step and the steps in flight dispatch down
        the whole chain first (their emissions belong to batches the
        snapshot counts as consumed), so no copy or step writes a plane
        while it is read; each stage's state then converts to the
        reference layout on its device and copies to the host."""
        from .checkpoint import capture_checkpoint

        runner.drain_chain(proc_now)
        stages = runner.chain()
        jax_states = [r.program.state_to_jax_numpy(r.state) for r in stages]
        emitted = metrics.records_emitted
        if not single:
            # each process emits its shards' rows: the snapshot records
            # the global count
            emitted = int(allgather_array(
                np.asarray([emitted], np.int64)).sum())
        return capture_checkpoint(
            state=jax_states if len(stages) > 1 else jax_states[0],
            plan=plan,
            source_pos=lines_consumed,
            proc_now=proc_now,
            emitted=emitted,
            batches=metrics.batches,
            job_name=env.job_name,
            parallelism=max(1, cfg.parallelism),
            lazy_schemas=[
                {"kinds": list(r.plan.record_kinds),
                 "tables": [t.state_dict() if t is not None else None
                            for t in r.plan.tables]}
                for r in stages if r._lazy_schema
            ],
            key_capacities=[r.cfg.key_capacity for r in stages],
            # only non-lazy CHAIN stages: stage 0's derived table rides
            # meta["tables"], a lazy stage's its lazy schema
            chain_key_tables=[
                r.plan.tables[-1].state_dict()
                if si > 0 and r.plan.synthetic_key and not r._lazy_schema
                and r.plan.tables else None
                for si, r in enumerate(stages)
            ],
            # supervised recovery: the collect sinks' lengths and the
            # quarantine's at the cut, and the session that scopes them
            sink_counts=[len(n.params["handle"].items) for n in sink_nodes
                         if n.op == "sink_collect"],
            quarantined=len(dead_letters) if dead_letters is not None else 0,
            session=supervision.nonce if supervision is not None else None,
            # dynamic rules: the host RuleSet at the cut (a restore
            # resyncs the control-feed cursor from it)
            rule_values=ruleset.values() if ruleset is not None else None,
            rule_version=ruleset.version if ruleset is not None else 0,
            tenancy=(env._tenancy.state_dict()
                     if getattr(env, "_tenancy", None) is not None else None),
            ingest=ingest_plane.cursor() if ingest_plane is not None else None,
            # the ledger's per-sink (count, digest) anchors at this
            # barrier: the drain above makes them exact
            ledger=ledger.anchors() if ledger is not None else None,
        )

    def save_checkpoint_at_barrier() -> None:
        with Stopwatch() as ck_sw:
            with Stopwatch() as cap_sw:
                pending = capture_cut()
            if ckpt_plane is not None:
                # a full queue makes this wait; a writer failure
                # re-raises here with its original fault point
                ckpt_plane.submit(pending)
                job_obs.gauge("checkpoint_async_inflight").set(
                    float(ckpt_plane.inflight()))
            elif is_coordinator:
                from .checkpoint import write_snapshot

                with Stopwatch() as wr_sw:
                    rep = write_snapshot(
                        cfg.checkpoint_dir, pending,
                        keep=cfg.checkpoint_keep,
                        keep_every=cfg.checkpoint_keep_every,
                        incremental=cfg.checkpoint_incremental,
                        fault=fault,
                    )
                rep["write_wall_ms"] = wr_sw.elapsed * 1000.0
                note_checkpoint_report(rep)
        # checkpoint_save_ms is the barrier's whole cost (capture plus
        # the budget wait when async, plus the write when sync);
        # checkpoint_capture_ms the capture alone
        job_obs.histogram("checkpoint_capture_ms").observe(
            cap_sw.elapsed * 1000.0)
        job_obs.histogram("checkpoint_save_ms").observe(ck_sw.elapsed * 1000.0)
        metrics.checkpoint_capture_ms.append(cap_sw.elapsed * 1000.0)

    def write_savepoints() -> None:
        """Pinned self-contained snapshots on request, written at the
        batch boundary, exempt from retention and GC by name."""
        from .checkpoint import save_savepoint

        tags = list(env._savepoint_requests)
        env._savepoint_requests.clear()
        pending = capture_cut()
        for tag in tags:
            path = save_savepoint(cfg.checkpoint_dir, pending, tag=tag)
            env.savepoints.append(path)
            job_obs.flight.record(
                "savepoint_written", path=path, tag=tag,
                source_pos=lines_consumed, batches=metrics.batches)

    # restore drills: a time-gated dry restore of the nominal newest
    # snapshot (format and chunk-chain walk, the ledger's anchors
    # re-derived), so that rot is a health transition before a crash
    # needs the snapshot
    drill_interval = cfg.restore_drill_interval_s
    drill_last = [time.monotonic()]

    def maybe_restore_drill() -> None:
        if (drill_interval <= 0 or not ckpt_enabled or not is_coordinator
                or time.monotonic() - drill_last[0] < drill_interval):
            return
        drill_last[0] = time.monotonic()
        from .checkpoint import restore_drill

        with Stopwatch() as dr_sw:
            res = restore_drill(
                cfg.checkpoint_dir,
                verify_anchors=(ledger.verify_anchors
                                if ledger is not None else None))
        if res["ok"] is None:
            return  # nothing to drill yet
        job_obs.histogram("restore_drill_ms").observe(dr_sw.elapsed * 1000.0)
        job_obs.gauge("restore_drill_verdict").set(1.0 if res["ok"] else 0.0)
        if not res["ok"]:
            job_obs.counter("restore_drill_failures_total").inc()
            job_obs.flight.record("restore_drill_failed", path=res["path"],
                                  reason=res["reason"])

    source_batches = plan.source.batches(cfg.batch_size, cfg.max_batch_delay_ms)
    if injector is not None:
        # source_read faults fire between batch pulls
        source_batches = injector.wrap_source(source_batches)
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
    prepared = map(prepare, source_batches)
    # sharded host ingestion (runtime/ingest.py): lane worker processes
    # parse frames in parallel and the merge yields the same prepared
    # tuples in sequence order; execute_job closes the plane on any exit
    ingest_plane = None
    if cfg.ingest_lanes > 1:
        from .ingest import build_ingest_plane

        ingest_plane = env._ingest_plane = build_ingest_plane(
            host, cfg, plan, job_obs, single_process=single, fault=fault,
            skip_lines=skip_lines)
        if ingest_plane is not None:
            prepared = ingest_plane.frames(source_batches, prepare)
            resources = getattr(job_obs, "resources", None)
            if resources is not None:
                resources.attach_lanes(ingest_plane.lane_pids)
    prefetched = cfg.parse_ahead > 0 and ingest_plane is None and single
    if prefetched:
        # source and parse on their own thread: batch N+1 parses while N
        # steps (the native parser releases the GIL)
        prepared = _prefetch_iter(
            prepared, cfg.parse_ahead,
            depth_gauge=(job_obs.gauge("parse_ahead_queue_depth")
                         if job_obs.enabled else None),
            handle=lambda h: setattr(env, "_parse_ahead", h))
    # a paced source (idle gaps between batches) fetches synchronously:
    # results would otherwise wait in flight for async_depth batch
    # intervals. The gap is the wait inside the source, not parse time.
    t_iter_done: Optional[float] = None
    IDLE_GAP_S = 0.05
    STALL_GAP_S = 1.0  # source gaps beyond this become flight events
    marker_backlog: list = []
    for sb, batch, wm_hint, hw in prepared:
        now_ref = time.perf_counter() if prefetched else hw.t0
        src_gap = now_ref - t_iter_done if t_iter_done is not None else 0.0
        if src_gap > STALL_GAP_S:
            job_obs.flight.record(
                "source_stall", gap_s=round(src_gap, 3),
                batches_consumed=metrics.batches)
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
        tick = job_obs.maybe_snapshot()
        if controller is not None and tick is not None and runner is not None:
            knobs = controller.on_tick()
            if knobs:
                # at a drained barrier: output bytes never depend on them
                runner.drain_chain(proc_now)
                for r in runner.chain():
                    r.apply_knobs(knobs)
        if sb.proc_ts.size:
            proc_now = max(proc_now, int(sb.proc_ts.max()))
        if sb.advance_proc_to is not None:
            proc_now = max(proc_now, int(sb.advance_proc_to))
        if batch is not None:
            if runner is None:
                # built on the first batch: an adaptive parse schema is
                # known only then
                with Stopwatch() as bw:
                    runner = env._runner = _make_runner_chain(plans, cfg, metrics)
                metrics.build_time_s += bw.elapsed
            # the idle test reads the local clock: several processes keep
            # the pipelined path, or one could drain (and gather) alone
            idle = single and t_iter_done is not None and src_gap > IDLE_GAP_S
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
            if idle:
                runner.drain_inflight()
        elif sb.advance_proc_to is not None and runner is not None and processing_time:
            if marker_backlog:
                runner.accept_markers(marker_backlog)
                marker_backlog = []
            runner.flush(proc_now - 1)  # the processing-time clock ticked
        if runner is not None:
            runner.pump_chain(proc_now)
            if ckpt_enabled and metrics.batches % ckpt_every == 0:
                save_checkpoint_at_barrier()
        if ckpt_plane is not None:
            reports = ckpt_plane.drain_reports()
            for rep in reports:
                note_checkpoint_report(rep)
            if reports:
                job_obs.gauge("checkpoint_async_inflight").set(
                    float(ckpt_plane.inflight()))
        if env._savepoint_requests and runner is not None and cfg.checkpoint_dir:
            write_savepoints()
        maybe_restore_drill()
        t_iter_done = time.perf_counter()
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
        runner.drain_inflight()
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
            d.drain_inflight()
            r = d
        # markers that met no further step still record at every
        # remaining edge: no stamped marker is lost
        runner.settle_markers()
        for r in runner.chain():
            r.finalize_metrics()
            r.check_strict()
    if ckpt_plane is not None:
        # land every queued write before the job returns, and surface a
        # writer failure even when no later barrier submitted
        ckpt_plane.flush()
        for rep in ckpt_plane.drain_reports():
            note_checkpoint_report(rep)
        job_obs.gauge("checkpoint_async_inflight").set(0.0)
    return JobResult(metrics)
