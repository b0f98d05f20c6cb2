"""Sharded host ingestion: the IngestPlane, now self-healing.

Counterpart of tpustream/runtime/ingest.py, copied: the plane is host
code (worker processes, shared-memory rings, the merge) and touches no
device; the executor feeds what it merges to the device as any parsed
batch. Figures quoted below are the reference's.

The single-lane host stage is one socket -> one parse thread -> one H2D
lane; its measured single-stream wire ceiling (~531K rows/s, BENCH_r05)
is the end-to-end flood bottleneck while the device sustains tens of
millions of events/s. This module shards that host data plane the way
Flink scales sources (parallel source subtasks feeding a partitioned
exchange): ``StreamConfig.ingest_lanes`` worker processes
(parallel/lanes.py) each own a shared-memory ring of length-framed
batches, run the compiled columnar parse plan, and ship transport-packed
columns back; the merge point below interleaves them deterministically.

Determinism contract — the whole design hangs off it:

* the producer assigns a SEQUENCE NUMBER to every source batch and
  frames them round-robin over the LIVE lanes;
* the merge consumes strictly in sequence order, so sink output is
  byte-identical to the single-lane path regardless of worker timing;
* per-lane interned-string ids are remapped onto the job's plan tables
  AT THE MERGE, in frame order, so global id assignment order equals
  the single-lane first-appearance order;
* per-lane sticky transport demotion chains are lossless encodings
  reconciled (exactly inverted) at the merge, so column values never
  depend on where a lane's chain sits;
* exactly-once recovery is unchanged: frames past the merge point are
  reflected in the source cursor, frames still in a ring are not — a
  restart replays them like any unread source data. Checkpoints record
  the per-lane frame cursor (informational ``ingest`` meta).

Frames the lanes cannot take (resume skip in progress, empty/final
batches, blank lines defeating the native parser, oversized frames)
fall back to the executor's ordinary inline ``_prepare`` path AT THEIR
SEQUENCE POSITION, so the interleave — and therefore the output — stays
exact.

Lane supervision (the self-healing layer). Flink restarts failed TASKS,
not jobs; before this layer, one OOM-killed lane worker burned a full
supervised restart + checkpoint replay, and a hung worker (alive but
stuck) or one that exited 0 before EOS was never detected at all — the
merge spun on its wait forever. Supervision rests on the same retention
rule that makes fallback frames exact: the producer keeps every raw
SourceBatch in ``_meta`` until its seq is merged, so a dead lane's
un-merged frames simply re-route to the inline host path at their exact
sequence positions — byte-identical output, exactly-once untouched, no
FORMAT_VERSION change. The pieces:

* each worker stamps a shared monotonic HEARTBEAT per frame and per
  idle/backpressure tick (parallel/lanes.py);
* ``_scan_lanes`` (called on every merge wait tick) detects all three
  death shapes: nonzero exit, PREMATURE clean exit (exit 0 before the
  producer sent that lane ``eos``), and a heartbeat stall past
  ``StreamConfig.ingest_lane_stall_limit_ms`` with work outstanding;
* recovery re-routes the lane's retained frames inline, then a bounded
  :class:`LaneRestartPolicy` (``StreamConfig.ingest_lane_restarts`` per
  lane) respawns the worker with fresh ShmRings and re-enters it into
  the round-robin — or, budget exhausted, FOLDS the lane out for good
  (the round-robin redistributes over survivors). All lanes folded
  degrades the plane to the inline path with an ``ingest_degraded``
  breadcrumb: the job keeps running slower instead of dying;
* a :class:`~tpustream_torch.runtime.watchdog.StallWatchdog` arms around the
  producer's ring-credit waits and the merge waits, so a WEDGED plane
  (not just a dead worker) escalates as a typed ``IngestStallError``
  the supervisor restarts-with-cause instead of hanging forever.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, List, Optional

import numpy as np

from ..parallel.lanes import LaneSpec, ShmRing, spawn_lane, unpack_columns
from ..records import STR, Batch, Column
from .watchdog import IngestStallError, StallWatchdog

#: default per-direction shared-memory ring bytes per lane
#: (override via StreamConfig.extra["ingest_ring_bytes"])
DEFAULT_RING_BYTES = 8 << 20

#: producer look-ahead bound, in frames past the merge cursor — keeps an
#: eager source from buffering the whole stream in host-frame metadata
_MAX_AHEAD_FRAMES = 4

#: fault points forwarded into lane workers (mirrors
#: testing/faults.py LANE_FAULT_POINTS without importing the test module)
_LANE_FAULT_POINTS = ("lane_worker_crash", "lane_worker_hang")


class _Remap:
    """Lane-local string id -> global plan id, kept as a grow-by-doubling
    int32 array so the per-frame gather indexes a live prefix. A plain
    list re-materialized with np.asarray per frame would be O(total
    strings interned) per frame per str column — quadratic over a
    long-running stream with a growing intern table."""

    __slots__ = ("_buf", "_n")

    def __init__(self):
        self._buf = np.empty(256, dtype=np.int32)
        self._n = 0

    def extend(self, ids) -> None:
        m = len(ids)
        if self._n + m > self._buf.shape[0]:
            cap = self._buf.shape[0]
            while cap < self._n + m:
                cap *= 2
            buf = np.empty(cap, dtype=np.int32)
            buf[: self._n] = self._buf[: self._n]
            self._buf = buf
        self._buf[self._n : self._n + m] = ids
        self._n += m

    def view(self) -> np.ndarray:
        return self._buf[: self._n]


class LaneRestartPolicy:
    """Bounded per-lane respawn budget: ``budget`` restarts per lane,
    then the lane folds out permanently. A separate object (not a bare
    counter on the lane) so the ladder is testable in isolation and the
    budget survives the lane's incarnation churn."""

    def __init__(self, budget: int):
        self.budget = max(0, int(budget))
        self.used: dict = {}

    def may_restart(self, lane_idx: int) -> bool:
        return self.used.get(lane_idx, 0) < self.budget

    def note_restart(self, lane_idx: int) -> int:
        n = self.used.get(lane_idx, 0) + 1
        self.used[lane_idx] = n
        return n


class _Incarnation:
    """One spawned lane worker and everything that dies with it: both
    ShmRings, all four queues, the shared heartbeat, and its private
    stop event. A respawned lane gets a FRESH incarnation — fresh rings
    (the old ones may hold frames the dead worker half-consumed), fresh
    queues (the old ones may hold a dead worker's stale descriptors),
    fresh lane-local intern state on the worker side."""

    __slots__ = (
        "gen", "proc", "in_ring", "out_ring", "in_q", "out_q",
        "ack_in", "ack_out", "heartbeat", "stop_ev",
    )

    def __init__(self, ctx, lane_idx: int, gen: int, spec, ring_bytes,
                 lane_faults):
        self.gen = gen
        self.in_ring = ShmRing(ring_bytes)
        self.out_ring = ShmRing(ring_bytes)
        self.in_q, self.out_q = ctx.Queue(), ctx.Queue()
        self.ack_in, self.ack_out = ctx.Queue(), ctx.Queue()
        self.heartbeat = ctx.Value("d", time.monotonic())
        self.stop_ev = ctx.Event()
        self.proc = spawn_lane(
            ctx, lane_idx, spec,
            (self.in_ring.name, ring_bytes, self.out_ring.name, ring_bytes,
             self.in_q, self.out_q, self.ack_in, self.ack_out,
             self.stop_ev, self.heartbeat, lane_faults),
        )

    def heartbeat_age_s(self) -> float:
        return time.monotonic() - self.heartbeat.value


class _Lane:
    """One supervised round-robin slot: the current incarnation plus the
    state the producer and merge share under the plane's condition
    variable. ``state``: "up" (dispatchable), "folded" (restart budget
    spent — permanently out), "done" (died after EOS; nothing left to
    assign, so no respawn). ``inflight`` holds the seqs dispatched to
    the current incarnation whose replies the merge still owes."""

    __slots__ = ("idx", "inc", "state", "restarts", "inflight", "eos_sent",
                 "remaps", "merged")

    def __init__(self, idx: int, inc: _Incarnation, str_slots):
        self.idx = idx
        self.inc = inc
        self.state = "up"
        self.restarts = 0
        self.inflight: set = set()
        self.eos_sent = False
        self.merged = 0
        self.remaps = [_Remap() if s else None for s in str_slots]


class _LaneGone(Exception):
    """The lane died while the producer was mid-dispatch to it."""


def build_ingest_plane(
    host, cfg, plan, job_obs, single_process: bool,
    fault=None, skip_lines: int = 0,
) -> Optional["IngestPlane"]:
    """Gate + construct: an IngestPlane when ``cfg.ingest_lanes`` > 1 and
    the job can take it, else None with a flight breadcrumb naming the
    reason (the analyzer's TSM016 flags the same conditions pre-flight).
    """
    lanes = int(cfg.ingest_lanes)
    if lanes <= 1:
        return None

    def _disabled(reason: str) -> None:
        job_obs.flight.record(
            "ingest_lanes_disabled", lanes=lanes, reason=reason
        )
        return None

    if not single_process:
        return _disabled("multiprocess")
    if not getattr(plan.source, "splittable", True):
        return _disabled("source_not_splittable")
    # force the raw-eval build (the same lazy hook process_raw uses):
    # lanes need the SAME eligibility — one native parse-map plan, no
    # computed key, no punctuated watermarks
    if not host._raw_eval_built:
        host._raw_eval = host._build_raw_eval()
        host._raw_eval_built = True
    if host._raw_eval is None:
        return _disabled("no_native_columnar_plan")
    exprs: list = []
    kinds: list = []
    str_slots: list = []
    tables: list = []  # GLOBAL plan tables aligned with exprs
    if host._raw_has_ts:
        exprs.append(plan.ts_expr)
        kinds.append("i64")
        str_slots.append(False)
        tables.append(None)
    hop = plan.host_ops[0]
    exprs.extend(hop.plan.outputs)
    kinds.extend(plan.record_kinds)
    for k, t in zip(plan.record_kinds, plan.tables):
        str_slots.append(k == STR)
        tables.append(t if k == STR else None)
    extra = cfg.extra or {}
    stall_ms = float(getattr(cfg, "ingest_lane_stall_limit_ms", 0.0))
    inj = extra.get("fault_injector")
    plane = IngestPlane(
        lanes=lanes,
        spec=LaneSpec(exprs, kinds, str_slots),
        global_tables=tables,
        has_ts=host._raw_has_ts,
        record_kinds=list(plan.record_kinds),
        record_tables=list(plan.tables),
        job_obs=job_obs,
        fault=fault,
        skip_lines=skip_lines,
        spans=host.spans,
        ring_bytes=int(extra.get("ingest_ring_bytes", DEFAULT_RING_BYTES)),
        stall_limit_s=max(0.0, stall_ms) / 1000.0,
        restart_budget=int(getattr(cfg, "ingest_lane_restarts", 0)),
        watchdog_limit_s=float(
            extra.get(
                "ingest_watchdog_limit_ms", max(30_000.0, 4.0 * stall_ms)
            )
        ) / 1000.0,
        fault_points=list(getattr(inj, "points", ()) or ()),
    )
    job_obs.flight.record("ingest_lanes_enabled", lanes=lanes)
    return plane


class IngestPlane:
    """N supervised lane worker processes + the deterministic merge."""

    def __init__(
        self, lanes: int, spec: LaneSpec, global_tables: list,
        has_ts: bool, record_kinds: list, record_tables: list,
        job_obs, spans, fault, skip_lines: int, ring_bytes: int,
        stall_limit_s: float = 0.0, restart_budget: int = 0,
        watchdog_limit_s: float = 30.0, fault_points: Optional[list] = None,
    ):
        import multiprocessing as mp

        self.lanes = lanes
        self.spec = spec
        self._global_tables = global_tables
        self._has_ts = has_ts
        self._record_kinds = record_kinds
        self._record_tables = record_tables
        self._job_obs = job_obs
        self._spans = spans  # the job's span recorder (the parse span)
        self._fault = fault
        self._skip_left = int(skip_lines)
        self._ring_bytes = ring_bytes
        self._stall_limit_s = stall_limit_s
        self._policy = LaneRestartPolicy(restart_budget)

        # fork when the platform has it: the worker inherits the already-
        # imported parse modules and skips spawn's re-exec of the user's
        # __main__. The parent may hold a live CUDA context: the child
        # never touches torch.cuda (a forked child that did would raise,
        # PyTorch marks it a bad fork) and only runs the numpy/native
        # parse loop, also when a respawn forks mid-job. spawn is the
        # fallback; there the
        # TPUSTREAM_LANE_WORKER gate keeps the child's package import
        # light and the gate's lazy __getattr__ keeps user scripts
        # importable.
        try:
            self._ctx = mp.get_context("fork")
        except ValueError:
            self._ctx = mp.get_context("spawn")
        self._lane_faults = self._build_lane_faults(fault_points or [])

        # merge/producer shared state. The lock is re-entrant: lane
        # recovery runs under the condition variable from code paths
        # that already hold it (_scan_lanes inside the wait loops).
        self._cv = threading.Condition(threading.RLock())
        self._meta: dict = {}   # seq -> ("host"|"lane", _Lane|None, sb)
        self._produced = 0
        self._merged = 0
        self._eos: Optional[int] = None
        self._perror = None           # (seq, exception) from the producer
        self._producer: Optional[threading.Thread] = None
        self._closed = False
        self._host_frames = 0
        self._rr = 0                  # round-robin cursor over live lanes
        self._degraded = False        # all lanes folded -> inline path
        self._stalled = None          # (scope, limit_s) once the watchdog fires
        self._pphase = "route"        # producer phase, for watchdog guards
        self._graveyard: List[ShmRing] = []  # dead incarnations' rings

        self._lanes: List[_Lane] = [
            _Lane(i, self._spawn_incarnation(i, gen=0), spec.str_slots)
            for i in range(lanes)
        ]

        enabled = getattr(job_obs, "enabled", False)
        self._rec_counters = [
            job_obs.group.group(lane=str(i)).counter(
                "ingest_lane_records_total"
            ) if enabled else None
            for i in range(lanes)
        ]
        self._occ_gauges = [
            job_obs.group.group(lane=str(i)).gauge("ingest_ring_occupancy")
            if enabled else None
            for i in range(lanes)
        ]
        self._restart_counters = [
            job_obs.group.group(lane=str(i)).counter(
                "ingest_lane_restarts_total"
            ) if enabled else None
            for i in range(lanes)
        ]
        self._stall_hist = (
            job_obs.histogram("ingest_lane_stall_ms") if enabled else None
        )
        if enabled:
            for lane in self._lanes:
                g = job_obs.group.group(lane=str(lane.idx))
                g.gauge("ingest_lane_folded").set(0)
                # heartbeat age is a pull gauge: scrapes read the live
                # worker clock; a folded/done lane reads -1
                g.gauge("ingest_heartbeat_age_ms").set_fn(
                    lambda lane=lane: (
                        lane.inc.heartbeat_age_s() * 1000.0
                        if lane.state == "up" else -1.0
                    )
                )

        # plane-level stall escalation: a wedged producer or merge wait
        # (not just a dead worker) surfaces as IngestStallError instead
        # of hanging the job forever
        self._watchdog_limit_s = watchdog_limit_s
        self._watchdog = StallWatchdog(self._on_watchdog_fire)
        job_obs.flight.record(
            "watchdog_armed",
            scopes=["merge_wait", "producer_ring"],
            limit_ms=round(watchdog_limit_s * 1000.0, 1),
            stall_limit_ms=round(stall_limit_s * 1000.0, 1),
            lane_restart_budget=self._policy.budget,
        )

    # -- lane lifecycle ------------------------------------------------------

    def _build_lane_faults(self, fault_points) -> tuple:
        """Picklable lane fault specs from the installed FaultInjector's
        points, duck-typed (the runtime never imports testing/faults).
        The shared fire counter is cached ON the FaultPoint object so a
        spent budget survives worker respawns and supervised restarts —
        both replay the sequence numbers that already fired."""
        specs = []
        for fp in fault_points:
            point = getattr(fp, "point", None)
            at = getattr(fp, "at", None)
            if point not in _LANE_FAULT_POINTS or at is None:
                continue
            fires = getattr(fp, "_lane_fires", None)
            if fires is None:
                fires = self._ctx.Value("i", 0)
                try:
                    fp._lane_fires = fires
                except Exception:
                    pass
            specs.append((
                point, int(at), int(getattr(fp, "times", 1)),
                int(getattr(fp, "exit_code", 1)), fires,
            ))
        return tuple(specs)

    def _spawn_incarnation(self, lane_idx: int, gen: int) -> _Incarnation:
        return _Incarnation(
            self._ctx, lane_idx, gen, self.spec, self._ring_bytes,
            self._lane_faults,
        )

    def _scan_lanes(self) -> None:
        """Detect the three lane failure shapes (call with _cv held, on
        every wait tick): nonzero exit, premature clean exit (exit 0
        before this lane's ``eos`` was sent), heartbeat stall past the
        limit with work outstanding. Detection hands straight to
        :meth:`_recover_lane` — the caller's wait loop then re-evaluates
        its condition against the rewritten metadata."""
        now = time.monotonic()
        for lane in self._lanes:
            if lane.state != "up":
                continue
            proc = lane.inc.proc
            if not proc.is_alive():
                code = proc.exitcode
                if code == 0 and lane.eos_sent:
                    continue  # legitimate: drained its frames, saw eos
                shape = "premature_exit" if code == 0 else "exit"
                self._recover_lane(lane, shape, exitcode=code)
            elif (
                self._stall_limit_s > 0.0
                and lane.inflight
                and now - lane.inc.heartbeat.value > self._stall_limit_s
            ):
                self._recover_lane(
                    lane, "stall",
                    heartbeat_age_ms=round(
                        (now - lane.inc.heartbeat.value) * 1000.0, 1
                    ),
                )

    def _recover_lane(self, lane: _Lane, shape: str, **info) -> None:
        """In-place lane recovery (call with _cv held).

        1. Re-route: every retained, un-merged frame assigned to this
           lane is rewritten to the inline host path at its exact
           sequence position (the producer kept the raw SourceBatch in
           ``_meta``) — output bytes and exactly-once are untouched.
        2. Reap the dead incarnation (its rings go to the graveyard:
           the producer may still be inside a write to them).
        3. Respawn a fresh incarnation while the LaneRestartPolicy
           budget lasts, else fold the lane out permanently; all lanes
           folded degrades the whole plane to the inline path.
        """
        flight = self._job_obs.flight
        rerouted = 0
        for s, (mode, l, sb) in list(self._meta.items()):
            if mode == "lane" and l is lane:
                self._meta[s] = ("host", None, sb)
                rerouted += 1
        lane.inflight.clear()
        flight.record(
            "ingest_lane_died",
            lane=lane.idx, gen=lane.inc.gen, shape=shape,
            rerouted_frames=rerouted, **info,
        )
        self._reap(lane.inc)
        if self._eos is not None:
            # nothing will ever be assigned past EOS: a respawn would
            # only idle, so retire the lane without burning budget
            lane.state = "done"
        elif self._policy.may_restart(lane.idx):
            n = self._policy.note_restart(lane.idx)
            lane.restarts = n
            lane.remaps = [
                _Remap() if s else None for s in self.spec.str_slots
            ]
            lane.inc = self._spawn_incarnation(lane.idx, gen=lane.inc.gen + 1)
            lane.eos_sent = False
            lane.state = "up"
            c = self._restart_counters[lane.idx]
            if c is not None:
                c.inc()
            flight.record(
                "ingest_lane_restarted",
                lane=lane.idx, gen=lane.inc.gen, restarts=n,
                budget=self._policy.budget,
            )
        else:
            lane.state = "folded"
            if getattr(self._job_obs, "enabled", False):
                self._job_obs.group.group(lane=str(lane.idx)).gauge(
                    "ingest_lane_folded"
                ).set(1)
            flight.record(
                "ingest_lane_folded",
                lane=lane.idx, restarts=lane.restarts,
                budget=self._policy.budget,
            )
            if not any(l.state == "up" for l in self._lanes):
                self._degraded = True
                flight.record("ingest_degraded", lanes=self.lanes)
        self._cv.notify_all()

    def _reap(self, inc: _Incarnation) -> None:
        """Terminate + join a dead incarnation and retire its resources.
        Rings are NOT closed here — the producer thread may be inside a
        write to the input ring's buffer; they close with the plane."""
        inc.stop_ev.set()
        proc = inc.proc
        try:
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=2.0)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=1.0)
        except Exception:
            pass
        for q in (inc.in_q, inc.out_q, inc.ack_in, inc.ack_out):
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:
                pass
        self._graveyard.extend((inc.in_ring, inc.out_ring))

    # -- watchdog ------------------------------------------------------------

    def _on_watchdog_fire(self, scope: str, limit_s: float) -> None:
        """Runs on the watchdog thread: flag the stall and wake every
        waiter — the stalled loops raise IngestStallError on their own
        threads, which escalates through frames() to the supervisor."""
        with self._cv:
            if self._stalled is None and not self._closed:
                self._stalled = (scope, limit_s)
                self._job_obs.flight.record(
                    "watchdog_fired", scope=scope,
                    limit_ms=round(limit_s * 1000.0, 1),
                )
            self._cv.notify_all()

    def _raise_if_stalled(self) -> None:
        if self._stalled is not None:
            raise IngestStallError(*self._stalled)

    # -- producer -----------------------------------------------------------

    def _frame_payload(self, sb):
        """(data, n) when the batch can ship to a lane, else None. Lines
        render exactly the way PlanEvaluator.__call__ would feed the
        native parser, so lane results match the inline path bit for
        bit."""
        if sb.final or sb.n_records == 0:
            return None
        if sb.raw is not None:
            return sb.raw, sb.n_raw
        return "\n".join(sb.lines).encode("utf-8"), len(sb.lines)

    def _producer_main(self, source_batches) -> None:
        seq = 0
        try:
            it = iter(source_batches)
            while True:
                self._pphase = "source"
                try:
                    sb = next(it)
                except StopIteration:
                    break
                self._pphase = "route"
                with self._cv:
                    while (
                        self._produced - self._merged
                        >= _MAX_AHEAD_FRAMES * self.lanes
                        and not self._closed
                        and self._stalled is None
                    ):
                        self._cv.wait(0.2)
                    if self._closed or self._stalled is not None:
                        return
                mode, lane, inc = "host", None, None
                if self._skip_left > 0:
                    # resume replay: the executor's _prepare owns the
                    # line-exact trim; frames route inline until the
                    # skip is exhausted
                    self._skip_left -= min(self._skip_left, sb.n_records)
                else:
                    payload = self._frame_payload(sb)
                    if payload is not None:
                        # sampled flight-path probes riding this batch:
                        # their ids travel in the frame's optional trace
                        # slot so the merge can attribute the lane span
                        tids = tuple(
                            m.trace_id for m in (sb.markers or ())
                            if getattr(m, "trace_id", 0)
                        )
                        lane, inc = self._dispatch(seq, payload, tids)
                        if lane is not None:
                            mode = "lane"
                with self._cv:
                    if lane is not None and (
                        lane.state != "up" or lane.inc is not inc
                    ):
                        # the lane died between the ring write and this
                        # commit (recovery may even have respawned it):
                        # the bytes sit in a graveyard ring no worker
                        # will read, so this frame goes inline too
                        mode, lane = "host", None
                    if mode == "lane":
                        lane.inflight.add(seq)
                    self._meta[seq] = (mode, lane, sb)
                    self._produced += 1
                    self._cv.notify_all()
                seq += 1
            self._pphase = "done"
            with self._cv:
                self._eos = seq
                # a worker may exit 0 only after eos: send it to every
                # live lane so legitimate exits are distinguishable from
                # the premature-clean-exit failure shape
                for lane in self._lanes:
                    if lane.state == "up" and not lane.eos_sent:
                        try:
                            lane.inc.in_q.put(("eos",))
                        except Exception:
                            pass
                        lane.eos_sent = True
                self._cv.notify_all()
        except BaseException as e:
            self._pphase = "done"
            if isinstance(e, _LaneGone):
                e = RuntimeError(f"ingest producer aborted: {e}")
            with self._cv:
                if self._stalled is None and not self._closed:
                    self._perror = (seq, e)
                self._cv.notify_all()

    def _next_live_lane(self) -> Optional[_Lane]:
        """Round-robin over lanes still standing (call with _cv held)."""
        for k in range(self.lanes):
            lane = self._lanes[(self._rr + k) % self.lanes]
            if lane.state == "up":
                self._rr = (self._rr + k + 1) % self.lanes
                return lane
        return None

    def _dispatch(self, seq: int, payload, trace_ids=()):
        """Frame one payload into a live lane's input ring; returns
        ``(lane, incarnation)`` or ``(None, None)`` to route the frame
        inline (no live lane, or the frame never fits). A lane dying
        mid-write aborts the write and the frame tries the next
        survivor — each configured slot at most once."""
        data, n = payload
        for _ in range(self.lanes):
            with self._cv:
                if self._degraded or self._stalled is not None:
                    return None, None
                lane = self._next_live_lane()
                if lane is None:
                    return None, None
                inc = lane.inc
            if not inc.in_ring.fits(len(data)):
                return None, None
            self._pphase = "ring"
            tok = self._watchdog.arm("producer_ring", self._watchdog_limit_s)
            try:
                off, cost = inc.in_ring.write(
                    data, lambda: self._credit(lane, inc)
                )
                frame = ("frame", seq, off, cost, len(data), n)
                if trace_ids:
                    frame = frame + (trace_ids,)
                inc.in_q.put(frame)
            except _LaneGone:
                continue  # recovery owns the lane; try a survivor
            finally:
                self._watchdog.disarm(tok)
                self._pphase = "route"
            # dispatch stamps the heartbeat too: a long-idle lane's last
            # worker-side stamp may predate the gap, and the stall clock
            # must start at hand-off, not at the previous frame
            inc.heartbeat.value = time.monotonic()
            g = self._occ_gauges[lane.idx]
            if g is not None:
                g.set(inc.in_ring.size - inc.in_ring.free)
            return lane, inc
        return None, None

    def _credit(self, lane: _Lane, inc: _Incarnation):
        """One input-ring credit, aborting when the plane is closing or
        THIS incarnation is gone (died, respawned, or folded)."""
        import queue as _queue

        while True:
            try:
                return inc.ack_in.get(timeout=0.2)
            except _queue.Empty:
                if self._closed or self._stalled is not None:
                    raise RuntimeError("ingest plane closed")
                with self._cv:
                    if lane.state != "up" or lane.inc is not inc:
                        raise _LaneGone(f"lane {lane.idx} died")

    # -- merge --------------------------------------------------------------

    def frames(self, source_batches, prepare) -> Iterator[tuple]:
        """Yield ``(sb, batch, wm_hint, hw)`` in strict sequence order —
        drop-in for the executor's ``map(_prepare, source_batches)``.
        ``prepare`` is that same inline closure; host-routed frames take
        it unchanged (resume skip, quarantine, fault hooks included).
        """
        self._producer = threading.Thread(
            target=self._producer_main, args=(source_batches,),
            name="tpustream-torch-ingest-producer", daemon=True,
        )
        self._producer.start()
        try:
            seq = 0
            while True:
                with self._cv:
                    self._raise_if_stalled()
                    if (
                        seq not in self._meta
                        and (self._eos is None or seq < self._eos)
                        and self._perror is None
                    ):
                        # the producer is quiet: watch the wait, but let
                        # a paced/idle SOURCE be quiet for free — only a
                        # producer wedged past the source counts
                        tok = self._watchdog.arm(
                            "merge_wait", self._watchdog_limit_s,
                            guard=lambda: self._pphase != "source",
                        )
                        try:
                            while (
                                seq not in self._meta
                                and (self._eos is None or seq < self._eos)
                                and self._perror is None
                                and self._stalled is None
                            ):
                                self._cv.wait(0.5)
                                self._scan_lanes()
                        finally:
                            self._watchdog.disarm(tok)
                        self._raise_if_stalled()
                    if seq not in self._meta:
                        if self._perror is not None:
                            raise self._perror[1]
                        break  # end of stream
                    mode, lane, sb = self._meta.pop(seq)
                if mode == "host":
                    self._host_frames += 1
                    yield prepare(sb)
                else:
                    yield self._merge_lane_frame(seq, lane, sb, prepare)
                with self._cv:
                    self._merged += 1
                    self._cv.notify_all()
                seq += 1
        finally:
            self.close()

    def _next_from_lane(self, seq: int, lane: _Lane):
        """The next descriptor from ``lane``, or ``(None, None)`` when
        the lane died and recovery re-routed ``seq`` inline. Returns the
        incarnation the descriptor came from — its output ring holds the
        payload even if the lane has respawned since."""
        import queue as _queue

        tok = self._watchdog.arm("merge_wait", self._watchdog_limit_s)
        try:
            while True:
                with self._cv:
                    self._raise_if_stalled()
                    if lane.state != "up" or seq not in lane.inflight:
                        return None, None
                    inc = lane.inc
                try:
                    desc = inc.out_q.get(timeout=0.5)
                except _queue.Empty:
                    with self._cv:
                        self._scan_lanes()
                    continue
                if desc[0] == "err":
                    # a worker-side exception is a lane failure, not a
                    # job failure: recover (re-route + respawn/fold)
                    # exactly like a crash
                    with self._cv:
                        if lane.state == "up" and lane.inc is inc:
                            self._recover_lane(
                                lane, "error", error=str(desc[2])[:200]
                            )
                    return None, None
                with self._cv:
                    lane.inflight.discard(desc[1])
                return desc, inc
        finally:
            self._watchdog.disarm(tok)

    def _merge_lane_frame(self, seq: int, lane: _Lane, sb, prepare):
        t_wait = time.perf_counter()
        desc, inc = self._next_from_lane(seq, lane)
        if self._stall_hist is not None:
            self._stall_hist.observe(
                (time.perf_counter() - t_wait) * 1000.0
            )
        if desc is None:
            # the lane died under this frame: its retained SourceBatch
            # re-parses inline at this exact sequence position
            self._host_frames += 1
            return prepare(sb)
        if desc[0] == "host":
            # the lane could not take this frame (blank lines defeating
            # the native plan, oversized packed output): inline parse at
            # the same sequence position keeps the interleave exact
            if desc[1] != seq:
                raise RuntimeError(
                    f"ingest lane frame out of order: expected seq {seq}, "
                    f"got {desc[1]}"
                )
            self._host_frames += 1
            return prepare(sb)
        _, dseq, off, cost, nbytes, n, metas, new_strings, dur = desc[:9]
        trace_ids = desc[9] if len(desc) > 9 else ()
        if dseq != seq:
            raise RuntimeError(
                f"ingest lane frame out of order: expected seq {seq}, "
                f"got {dseq}"
            )
        job_obs = self._job_obs
        with self._spans.span("parse", job_obs) as hw:
            if self._fault is not None:
                self._fault("parse")
            payload = inc.out_ring.read(off, nbytes)
            inc.ack_out.put(cost)
            cols = unpack_columns(metas, self.spec.kinds, payload, n)
            # lane-local interned ids -> the job's plan tables, extended
            # in frame order: global id assignment order equals the
            # single-lane first-appearance order
            remaps = lane.remaps
            for j, news in enumerate(new_strings):
                if remaps[j] is None:
                    continue
                if news:
                    table = self._global_tables[j]
                    remaps[j].extend([table.intern(s) for s in news])
                cols[j] = remaps[j].view()[cols[j]]
            ts = None
            if self._has_ts:
                ts = np.asarray(cols[0], dtype=np.int64)
                cols = cols[1:]
            columns = [
                Column(k, c, t)
                for k, c, t in zip(
                    self._record_kinds, cols, self._record_tables
                )
            ]
            batch = Batch(n, columns, ts=ts, proc_ts=sb.proc_ts)
        if job_obs.tracer.enabled:
            # the worker-side parse span, re-anchored to this clock so
            # the profiler's binding-stage attribution can name the
            # ingest plane
            now = time.perf_counter()
            job_obs.tracer._record(
                "lane_parse", -1, f"lane{lane.idx}", now - dur, dur
            )
            if trace_ids and sb.markers:
                # attribute the worker-side parse to the flight-path
                # probes riding this frame (obs/tracing_export.py)
                want = set(trace_ids)
                for m in sb.markers:
                    if getattr(m, "trace_id", 0) in want:
                        m.add_span(
                            "lane_parse", t0=now - dur, dur=dur,
                            lane=lane.idx, frame_seq=seq,
                        )
        c = self._rec_counters[lane.idx]
        if c is not None:
            c.inc(n)
        lane.merged += 1
        return sb, batch, None, hw

    # -- resource-plane export (obs/resources.py) ---------------------------

    def lane_pids(self) -> dict:
        """Live lane worker PIDs keyed by lane index, for per-lane CPU
        attribution by the obs ResourceSampler. Re-read at every sample
        tick, so a respawned incarnation shows up under its lane index
        with the fresh PID; folded/done lanes drop out."""
        with self._cv:
            out = {}
            for lane in self._lanes:
                if lane.state != "up":
                    continue
                pid = getattr(lane.inc.proc, "pid", None)
                if pid:
                    out[lane.idx] = pid
            return out

    def lane_heartbeat_ages(self) -> dict:
        """Seconds since each live lane's worker last pulsed, keyed by
        lane index — the watchdog's stall signal, exported so resource
        samples can distinguish a starved lane (high heartbeat age, low
        CPU) from a busy one."""
        with self._cv:
            return {
                lane.idx: lane.inc.heartbeat_age_s()
                for lane in self._lanes
                if lane.state == "up"
            }

    # -- checkpoint / shutdown ---------------------------------------------

    def cursor(self) -> dict:
        """Per-lane frame cursor for checkpoint meta: which frames the
        merge has consumed. Frames still in a ring are NOT in the source
        cursor either, so recovery replays them exactly once. The
        supervision fields are informational (no FORMAT_VERSION change):
        restore never needs them — a restored plane starts fresh."""
        return {
            "lanes": self.lanes,
            "merged_frames": self._merged,
            "lane_frames": [lane.merged for lane in self._lanes],
            "host_frames": self._host_frames,
            "lane_restarts": [lane.restarts for lane in self._lanes],
            "lanes_folded": [
                lane.idx for lane in self._lanes if lane.state == "folded"
            ],
            "degraded": self._degraded,
        }

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._watchdog.close()
        for lane in self._lanes:
            lane.inc.stop_ev.set()
            try:
                lane.inc.in_q.put(("stop",))
            except Exception:
                pass
        if self._producer is not None:
            self._producer.join(timeout=3.0)
        for lane in self._lanes:
            inc = lane.inc
            inc.proc.join(timeout=5.0)
            if inc.proc.is_alive():
                inc.proc.terminate()
                inc.proc.join(timeout=2.0)
            for q in (inc.in_q, inc.out_q, inc.ack_in, inc.ack_out):
                try:
                    q.close()
                    q.cancel_join_thread()
                except Exception:
                    pass
            self._graveyard.extend((inc.in_ring, inc.out_ring))
        for r in self._graveyard:
            r.close()
        self._graveyard = []
