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
go to each late-data side output.

Not ported here, and refused by :func:`execute_job` rather than ignored:
checkpoints and restore, supervised restarts, the observability layer,
ingest lanes, dead-letter quarantine and chained stages. The reference's
pipelining knobs (``async_depth``, ``h2d_depth``, ``fetch_group``, wire
compression) change no output and are not read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api.functions import as_callable
from ..api.timeapi import TimeCharacteristic
from ..api.watermarks import LONG_MIN, MAX_WATERMARK, AssignerWithPunctuatedWatermarks
from ..config import StreamConfig
from ..hostparse import PlanEvaluator, run_fallback_map
from ..ops.panes import compact_positions
from ..records import NUMPY_DTYPES, STR, Batch, Column, DerivedKeyTable, StringTable
from .metrics import Metrics, Stopwatch
from .plan import JobPlan, build_plan_chain
from .sinks import CollectSink, EmissionFormatter, FnSink, PrintSink
from .step import build_program, resolve_device


class HostStage:
    """Raw lines -> columnar Batch (parse, timestamps, raw-stage ops)."""

    def __init__(self, plan: JobPlan, cfg: StreamConfig):
        self.plan = plan
        self.cfg = cfg
        self._ts_eval: Optional[PlanEvaluator] = None
        self._map_evals: Dict[int, PlanEvaluator] = {}
        if plan.ts_expr is not None:
            self._ts_eval = PlanEvaluator([plan.ts_expr], [None])

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

    def process(self, lines: List[str], proc_ts: np.ndarray) -> Optional[Batch]:
        """The parsed Batch, or None for empty input."""
        plan = self.plan
        if not lines:
            return None
        ts = self._timestamps(lines)
        if ts is not None and isinstance(
            plan.ts_assigner, AssignerWithPunctuatedWatermarks
        ):
            raise NotImplementedError(
                "punctuated watermarks are not ported to the PyTorch runtime yet"
            )
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
                    return None
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
                    return None
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
        return Batch(len(lines), columns, ts=ts, proc_ts=proc_ts)


def derive_key_column(plan, cols, n: int) -> np.ndarray:
    """Computed-KeySelector fallback: reconstruct each visible record
    from its columns, run the user selector, intern the result into the
    plan's trailing DerivedKeyTable (per-record Python). Rows that a
    filter between the parse map and the key_by drops get the table's
    reserved PLACEHOLDER_ID, so a partial selector never sees them."""
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
    emissions out to the sinks."""

    _COUNTER_NAMES = (
        "window_fires", "late_dropped", "alert_overflow", "buffer_overflow",
        "evicted_unfired",
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

    def feed(self, batch: Batch, wm_lower: int = LONG_MIN + 1) -> None:
        self._check_capacity()
        size = self.cfg.batch_size
        for start in range(0, batch.n, size):
            stop = min(start + size, batch.n)
            self._run_step(batch.slice_rows(start, stop), wm_lower)
            self.metrics.records_in += stop - start
            # deferred window ends fire before the next batch can move
            # the ring past them
            self._drain(wm_lower)

    def flush(self, wm_lower: int) -> None:
        """Advance time with an empty batch (processing-time tick / end
        of stream), then drain any fires deferred by the budget."""
        if not self.program.fires_on_clock:
            return
        self._run_step(self._empty_batch(), wm_lower)
        self._drain(wm_lower)

    def _drain(self, wm_lower: int) -> None:
        """Empty steps until no window end stays deferred by
        ``max_fires_per_step`` (each still fires at most the budget)."""
        if self.cfg.max_fires_per_step is None or not self.program.fires_on_clock:
            return
        for _ in range(self.program.ring.n_fire_candidates + 2):
            if not self.state.get("pending_fires"):
                return
            self._run_step(self._empty_batch(), wm_lower)

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
        if not self.program.fires_on_clock:
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

    def _run_step(self, batch: Batch, wm_lower: int) -> None:
        m = self.metrics
        with Stopwatch() as sw:
            cols, valid, ts = self._upload(batch)
            self._sync()
        m.upload_times_s.append(sw.elapsed)
        reads = self.program.host_reads
        with Stopwatch() as sw:
            self.state, emissions = self.program.step(
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
            with Stopwatch() as sw:
                out, subtask = self._fetch(main)
            m.fetch_times_s.append(sw.elapsed)
            with Stopwatch() as sw:
                for j, row in enumerate(self.formatter.rows(out)):
                    self._emit_row(row, None if subtask is None else int(subtask[j]))
                m.records_emitted += len(out[0]) if out else 0
            m.emit_times_s.append(sw.elapsed)
        late = emissions.get("late")
        if late is not None and self.side_sinks:
            with Stopwatch() as sw:
                self._dispatch_late(late)
            m.emit_times_s.append(sw.elapsed)

    def _evaluate_fires(self, fire_info) -> None:
        """A full-window program's fires: the program gathers each fired
        window's elements from the live state and calls the user
        function on the host; each result takes the window's post ops,
        then goes to every branch. Its copies count as fetch time, the
        rest as emit time."""
        m = self.metrics
        fetch_s = 0.0
        emitted = 0

        def emit(item, subtask):
            nonlocal emitted
            item, keep = _apply_ops(self.post_ops, item)
            if keep:
                self._emit_row(item, subtask)
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
        m.records_emitted += emitted
        m.window_fires += fired

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
        for ops, sink in self.side_sinks.values():
            for row in self.late_formatter.rows(cols):
                item, keep = _apply_ops(ops, row)
                if keep:
                    sink.emit(item)

    def _fetch(self, main):
        """The step's emitted rows on the host: (columns, subtasks);
        subtasks are None for a stream without a key."""
        n_shards = max(1, self.cfg.parallelism)
        if self.program.main_emission_prefix:
            # read the count, then copy only that many rows
            count = main["count"]
            if isinstance(count, torch.Tensor):
                (count,) = self._to_host([count])
            n = int(count)
            key = main.get("key")
            if n == 0:
                return [], None
            extra = [] if key is None else [key[:n]]
            got = self._to_host([c[:n] for c in main["cols"]] + extra)
            if key is None:
                return got, None
            return got[:-1], got[-1].astype(np.int64) % n_shards
        # checked before any row of the step reaches a sink
        bad = main.get("bad_keys")
        extra = [] if bad is None else [bad]
        got = self._to_host(
            [main["mask"], main["subtask"]] + list(main["cols"]) + extra)
        if bad is not None and int(got[-1][0]):
            raise IndexError(
                f"{int(got[-1][0])} rows carried a key id past the keyed "
                f"state's capacity of {self.cfg.key_capacity}"
            )
        sel = np.nonzero(got[0])[0]
        cols = got[2:len(got) - len(extra)]
        return [c[sel] for c in cols], got[1][sel]

    def _emit_row(self, row, subtask: Optional[int]) -> None:
        """Fan one emitted record out to every branch: the branch's
        host-side map/filter tail, then its sink."""
        for ops, sink in self.sinks:
            item, keep = _apply_ops(ops, row)
            if keep:
                sink.emit(item, subtask=subtask)

    def finalize_metrics(self) -> None:
        """Fold the device-side counters into Metrics (one read a job)."""
        names = [n for n in self._COUNTER_NAMES if n in self.state]
        if names:
            vals = self._to_host([self.state[n] for n in names])
            for n, v in zip(names, vals):
                setattr(self.metrics, n, int(v))

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


def _lines(sb) -> List[str]:
    if sb.raw is None:
        return sb.lines
    lines = sb.raw.decode("utf-8", "replace").split("\n")
    if len(lines) == sb.n_raw + 1 and lines[-1] == "":
        lines.pop()  # trailing newline
    if len(lines) != sb.n_raw:
        raise ValueError(
            f"raw source batch declares {sb.n_raw} lines "
            f"but contains {len(lines)}"
        )
    return lines


def execute_job(env, sink_nodes) -> JobResult:
    """Plan the job and run it to source exhaustion on
    ``env.config.device``."""
    cfg = env.config
    _check_supported(env, cfg)
    resolve_device(cfg.device)  # refuse a missing card before any work
    with Stopwatch() as setup:
        plans = build_plan_chain(env, sink_nodes)
        if len(plans) > 1:
            raise NotImplementedError(
                "chained stages (key_by after a keyed operator) are not "
                "ported to the PyTorch runtime yet (roadmap queue item 8)"
            )
        plan = plans[0]
        host = HostStage(plan, cfg)
    metrics = Metrics(build_time_s=setup.elapsed)
    env.metrics = metrics
    runner: Optional[Runner] = None
    processing_time = plan.time_characteristic == TimeCharacteristic.ProcessingTime
    proc_now = 0
    for sb in plan.source.batches(cfg.batch_size, cfg.max_batch_delay_ms):
        with Stopwatch() as hw:
            batch = host.process(_lines(sb), sb.proc_ts)
        metrics.host_times_s.append(hw.elapsed)
        metrics.batches += 1
        if sb.proc_ts.size:
            proc_now = max(proc_now, int(sb.proc_ts.max()))
        if sb.advance_proc_to is not None:
            proc_now = max(proc_now, int(sb.advance_proc_to))
        if batch is not None:
            if runner is None:
                # built on the first batch: an adaptive parse schema is
                # known only then
                with Stopwatch() as bw:
                    runner = Runner(plan, cfg, metrics)
                metrics.build_time_s += bw.elapsed
            runner.feed(batch, proc_now - 1 if processing_time else LONG_MIN + 1)
        elif sb.advance_proc_to is not None and runner is not None and processing_time:
            runner.flush(proc_now - 1)  # the processing-time clock ticked
        if sb.final:
            break
    if runner is not None:
        # Flink's end of input: a MAX watermark fires every remaining
        # event-time window; processing time fires up to the clock
        runner.flush(proc_now - 1 if processing_time else MAX_WATERMARK)
        runner.finalize_metrics()
        runner.check_strict()
    return JobResult(metrics)
