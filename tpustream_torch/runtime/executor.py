"""Job execution: the host pipeline driving the PyTorch device program.

Counterpart of tpustream/runtime/executor.py, single device, in order:
the host turns source lines into columnar batches (``HostStage``), the
``Runner`` uploads each batch to ``StreamConfig.device``, runs one
program step, fetches the emissions and hands them to the sinks, and the
stream ends when the source yields its final batch. Output bytes match
the reference's for the same input.

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
from ..api.watermarks import AssignerWithPunctuatedWatermarks
from ..config import StreamConfig
from ..hostparse import PlanEvaluator, run_fallback_map
from ..records import STR, Batch, Column, DerivedKeyTable, StringTable
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
    """(host-side branch ops, sink) per main branch; the ops run over the
    fetched emissions, as in the reference's stream fan-out."""
    pp = cfg.print_parallelism if cfg.print_parallelism is not None else cfg.parallelism

    def build_sink(node):
        if node.op == "sink_print":
            return PrintSink(parallelism=pp)
        if node.op == "sink_collect":
            return CollectSink(node.params["handle"])
        return FnSink(node.params["fn"])

    return [
        (_bind_ops(branch.ops), build_sink(branch.sink_node))
        for branch in plan.branches
    ]


class Runner:
    """Feeds batches through the program on its device and fans the
    emissions out to the sinks."""

    def __init__(self, plan: JobPlan, cfg: StreamConfig, metrics: Metrics):
        self.plan = plan
        self.cfg = cfg
        self.metrics = metrics
        self.program = build_program(plan, cfg)
        self.device = self.program.device
        self.state = self.program.init_state()
        self.sinks = _make_sinks(plan, cfg)
        self.formatter = EmissionFormatter(
            self.program.out_kinds, self.program.out_tables
        )

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

    def feed(self, batch: Batch) -> None:
        self._check_capacity()
        size = self.cfg.batch_size
        for start in range(0, batch.n, size):
            stop = min(start + size, batch.n)
            self._run_step(batch.slice_rows(start, stop))
            self.metrics.records_in += stop - start

    def _upload(self, batch: Batch):
        pin = self.device.type == "cuda"

        def put(a: np.ndarray) -> torch.Tensor:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                t = t.pin_memory()
            return t.to(self.device, non_blocking=pin)

        return [put(c.data) for c in batch.columns], put(batch.valid)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_step(self, batch: Batch) -> None:
        m = self.metrics
        with Stopwatch() as sw:
            cols, valid = self._upload(batch)
            self._sync()
        m.upload_times_s.append(sw.elapsed)
        with Stopwatch() as sw:
            self.state, emissions = self.program.step(self.state, cols, valid)
            self._sync()
        m.step_times_s.append(sw.elapsed)
        m.steps += 1
        main = emissions["main"]
        with Stopwatch() as sw:
            # checked before any row of the step reaches a sink
            bad = main.get("bad_keys")
            n_bad = 0 if bad is None else int(bad.cpu()[0])
            if n_bad:
                raise IndexError(
                    f"{n_bad} rows carried a key id past the keyed state's "
                    f"capacity of {self.cfg.key_capacity}"
                )
            mask = main["mask"].cpu().numpy()
            sel = np.nonzero(mask)[0]
            out = [c.cpu().numpy()[sel] for c in main["cols"]]
            subtask = main["subtask"].cpu().numpy()[sel]
        m.fetch_times_s.append(sw.elapsed)
        with Stopwatch() as sw:
            for j, row in enumerate(self.formatter.rows(out)):
                self._emit_row(row, int(subtask[j]))
            m.records_emitted += int(sel.size)
        m.emit_times_s.append(sw.elapsed)

    def _emit_row(self, row, subtask: int) -> None:
        """Fan one emitted record out to every branch: the branch's
        host-side map/filter tail, then its sink."""
        for ops, sink in self.sinks:
            item, keep = _apply_ops(ops, row)
            if keep:
                sink.emit(item, subtask=subtask)


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
    plans = build_plan_chain(env, sink_nodes)
    if len(plans) > 1:
        raise NotImplementedError(
            "chained stages (key_by after a keyed operator) are not ported "
            "to the PyTorch runtime yet"
        )
    plan = plans[0]
    if plan.side_outputs:
        raise NotImplementedError(
            "side outputs are not ported to the PyTorch runtime yet"
        )
    host = HostStage(plan, cfg)
    metrics = Metrics()
    env.metrics = metrics
    runner: Optional[Runner] = None
    for sb in plan.source.batches(cfg.batch_size, cfg.max_batch_delay_ms):
        with Stopwatch() as hw:
            batch = host.process(_lines(sb), sb.proc_ts)
        metrics.host_times_s.append(hw.elapsed)
        metrics.batches += 1
        if batch is not None:
            if runner is None:
                # built on the first batch: an adaptive parse schema is
                # known only then
                runner = Runner(plan, cfg, metrics)
            runner.feed(batch)
        if sb.final:
            break
    return JobResult(metrics)
