"""Ingest-lane worker plane: shared-memory rings, transport packing,
and the lane worker process entry.

One lane = one worker process owning two shared-memory rings: the
producer (runtime/ingest.py) writes length-framed raw line batches into
the lane's input ring; the worker runs the compiled columnar parse plan
(hostparse.PlanEvaluator over native/_fastparse) and writes
transport-packed column buffers into its output ring. Frames carry the
producer's sequence number end to end, so the merge point can interleave
N lanes deterministically — output bytes never depend on worker timing.

Workers are spawned with ``TPUSTREAM_LANE_WORKER=1`` in the environment,
which makes ``tpustream_torch/__init__`` skip torch and the API surface: a
lane worker's import closure is hostparse + records + native (numpy
only), so worker start-up costs a numpy import, not a torch one.

Counterpart of tpustream/parallel/lanes.py, copied: the lane plane is
host code that touches no device.

Transport packing mirrors the device packed-wire policy
(StreamConfig.packed_wire): each column ships in the narrowest encoding
its values admit, demotions are sticky per lane per column (a column
that once needed a wider mode never narrows again), and the merge point
unpacks exactly — the encodings below are all lossless, so lane output
reconciles bit-identically with the single-lane path no matter where
each lane's demotion chain currently sits.
"""

from __future__ import annotations

import os
import queue as _queue
import struct
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..records import BOOL, F64, I64, STR

#: per-kind transport mode chains, narrowest first; the per-column sticky
#: level is an index into the chain and only ever moves right
TRANSPORT_CHAINS = {
    I64: ("d16", "d32", "raw"),   # uint16 / int32 deltas from base, raw int64
    F64: ("f32", "raw"),          # float32 when every value round-trips
    STR: ("i16", "i32"),          # interned ids (NONE_ID=-1 fits int16)
    BOOL: ("bits",),              # bit-packed, 8 rows/byte
}

_FRAME_HEADER = struct.Struct("<Q")  # payload byte length


class ShmRing:
    """A single-writer single-reader shared-memory byte ring of
    length-framed payloads.

    Free-space accounting lives entirely on the WRITER side: every write
    returns its ``cost`` (header + payload + any skipped wrap tail), the
    reader echoes that cost back over an ack queue once the frame is
    consumed, and the writer credits it before the blocking check. Acks
    arrive in FIFO order (the merge consumes frames in sequence order),
    so ``free >= cost`` guarantees the next ``cost`` bytes past ``head``
    hold only already-consumed frames.
    """

    HEADER = _FRAME_HEADER.size

    def __init__(self, size: int, name: Optional[str] = None):
        from multiprocessing import shared_memory

        if name is None:
            self.shm = shared_memory.SharedMemory(create=True, size=size)
            self._owner = True
        else:
            self.shm = shared_memory.SharedMemory(name=name)
            self._owner = False
        self.size = size
        self.name = self.shm.name
        self.head = 0
        self.free = size

    def write_cost(self, nbytes: int) -> int:
        """The cost a payload of ``nbytes`` would incur at the current
        head (including the skipped tail when it must wrap to 0)."""
        need = self.HEADER + nbytes
        if self.head + need > self.size:
            return need + (self.size - self.head)
        return need

    def fits(self, nbytes: int) -> bool:
        """Whether a payload of ``nbytes`` can EVER fit (empty ring)."""
        return self.HEADER + nbytes <= self.size

    def write(self, payload, wait_credit) -> "tuple[int, int]":
        """Frame ``payload`` into the ring; returns ``(offset, cost)``.

        Blocks via ``wait_credit()`` (which returns one freed cost and
        may raise to abort) until the ring has room.
        """
        nbytes = len(payload)
        need = self.HEADER + nbytes
        cost = self.write_cost(nbytes)
        if cost > self.size:
            # wrap tail + frame exceeds the ring (need > head): no
            # amount of acked credit can ever cover it from this head.
            # Drain completely, restart at 0, and charge the frame
            # alone — the abandoned tail holds only consumed frames.
            while self.free < self.size:
                self.free += wait_credit()
            self.head = 0
            cost = need
        else:
            while self.free < cost:
                self.free += wait_credit()
            if self.head + need > self.size:
                self.head = 0
        off = self.head
        buf = self.shm.buf
        _FRAME_HEADER.pack_into(buf, off, nbytes)
        buf[off + self.HEADER : off + need] = payload
        self.head = off + need
        self.free -= cost
        return off, cost

    def read(self, off: int, nbytes: int) -> bytes:
        """Copy one frame's payload out (validating the length header)."""
        (stored,) = _FRAME_HEADER.unpack_from(self.shm.buf, off)
        if stored != nbytes:
            raise RuntimeError(
                f"ingest ring frame corrupt at {off}: header says "
                f"{stored} bytes, descriptor says {nbytes}"
            )
        return bytes(self.shm.buf[off + self.HEADER : off + self.HEADER + nbytes])

    def close(self) -> None:
        try:
            self.shm.close()
            if self._owner:
                self.shm.unlink()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# Transport packing (lossless, sticky per-column demotion)
# ---------------------------------------------------------------------------

def pack_columns(cols: List[np.ndarray], kinds: List[str], sticky: List[int]):
    """Encode aligned columns into one payload buffer.

    Returns ``(metas, payload)`` and advances ``sticky`` in place; each
    meta is ``(mode, base, nbytes)``. Every mode is exactly invertible —
    :func:`unpack_columns` reproduces the input arrays bit for bit.
    """
    parts: List[bytes] = []
    metas = []
    for i, (c, k) in enumerate(zip(cols, kinds)):
        chain = TRANSPORT_CHAINS[k]
        lvl = sticky[i]
        mode = chain[-1]
        base = 0
        n = len(c)
        if k == I64:
            c = np.ascontiguousarray(c, dtype=np.int64)
            lo = int(c.min()) if n else 0
            span = (int(c.max()) - lo) if n else 0
            if lvl <= 0 and span <= 0xFFFF:
                mode, base = "d16", lo
                buf = (c - lo).astype(np.uint16)
            elif lvl <= 1 and span <= 0x7FFFFFFF:
                mode, base = "d32", lo
                buf = (c - lo).astype(np.int32)
            else:
                buf = c
        elif k == F64:
            c = np.ascontiguousarray(c, dtype=np.float64)
            narrow = c.astype(np.float32)
            # demote only on a BIT-exact round trip: value equality (even
            # with equal_nan) would demote NaNs whose payload bits f32
            # truncates, breaking the bit-for-bit transport guarantee
            if lvl <= 0 and np.array_equal(
                narrow.astype(np.float64).view(np.int64), c.view(np.int64)
            ):
                mode, buf = "f32", narrow
            else:
                buf = c
        elif k == STR:
            c = np.ascontiguousarray(c, dtype=np.int32)
            if lvl <= 0 and (n == 0 or int(c.max()) < (1 << 15)):
                mode, buf = "i16", c.astype(np.int16)
            else:
                buf = c
        else:  # BOOL
            mode = "bits"
            buf = np.packbits(np.ascontiguousarray(c, dtype=np.bool_))
        sticky[i] = max(lvl, chain.index(mode))
        raw = buf.tobytes()
        metas.append((mode, base, len(raw)))
        parts.append(raw)
    return metas, b"".join(parts)


def unpack_columns(
    metas, kinds: List[str], payload: bytes, n: int
) -> List[np.ndarray]:
    """Exact inverse of :func:`pack_columns` (fresh arrays, safe to keep
    after the ring slot is recycled)."""
    out: List[np.ndarray] = []
    off = 0
    for (mode, base, nbytes), k in zip(metas, kinds):
        raw = payload[off : off + nbytes]
        off += nbytes
        if mode == "d16":
            c = np.frombuffer(raw, dtype=np.uint16).astype(np.int64) + base
        elif mode == "d32":
            c = np.frombuffer(raw, dtype=np.int32).astype(np.int64) + base
        elif mode == "f32":
            c = np.frombuffer(raw, dtype=np.float32).astype(np.float64)
        elif mode == "i16":
            c = np.frombuffer(raw, dtype=np.int16).astype(np.int32)
        elif mode == "bits":
            c = np.unpackbits(
                np.frombuffer(raw, dtype=np.uint8), count=n
            ).astype(np.bool_)
        else:  # raw
            dt = {I64: np.int64, F64: np.float64, STR: np.int32}[k]
            c = np.frombuffer(raw, dtype=dt).copy()
        out.append(np.ascontiguousarray(c))
    return out


# ---------------------------------------------------------------------------
# Worker entry
# ---------------------------------------------------------------------------

@dataclass
class LaneSpec:
    """Picklable parse-plan payload shipped to every lane worker.

    ``exprs`` is the SAME expression list the executor's raw-eval path
    compiles ([ts_expr?] + parse-map outputs, hostparse.PExpr trees);
    ``str_slots`` marks which outputs intern (the worker builds fresh
    LANE-LOCAL StringTables for those — the merge point remaps lane ids
    onto the job's plan tables). ``kinds`` are transport kinds aligned
    with ``exprs`` (the ts column rides as I64).
    """

    exprs: list
    kinds: list
    str_slots: list

    def build_evaluator(self):
        """(PlanEvaluator or None, lane-local tables). None when the
        native parser is unavailable in this process — the worker then
        marks every frame for host-side parsing."""
        from ..hostparse import PlanEvaluator
        from ..records import StringTable

        tables = [StringTable() if s else None for s in self.str_slots]
        ev = PlanEvaluator(self.exprs, tables)
        if ev._native is None:
            return None, tables
        return ev, tables


def _drain_credit(q, stop_ev, timeout: float = 0.2, heartbeat=None):
    """Block for one ring credit, aborting when the plane shuts down.

    The credit wait stamps the worker heartbeat per tick: a worker
    backpressured on a full output ring is healthy, and the lane
    supervisor must not read its silence as a stall."""
    while True:
        try:
            return q.get(timeout=timeout)
        except _queue.Empty:
            if stop_ev.is_set():
                raise _LaneStop()
            _stamp(heartbeat)


def _stamp(heartbeat) -> None:
    """Stamp this worker's shared heartbeat (monotonic is system-wide on
    the platforms the plane runs on, so parent-side age math is valid)."""
    if heartbeat is not None:
        heartbeat.value = time.monotonic()


def _check_lane_faults(faults, seq: int) -> None:
    """Evaluate testing/faults.py lane fault specs inside the worker.

    Each spec is ``(point, at, times, exit_code, fires)`` with ``fires``
    a shared-memory counter living on the injector's FaultPoint — spent
    budgets survive worker respawns AND supervised job restarts, so a
    fault fires exactly ``times`` times per test no matter how many
    processes replay frame ``at``.
    """
    for point, at, times, exit_code, fires in faults:
        if not (at <= seq < at + max(1, times)):
            continue
        with fires.get_lock():
            if fires.value >= max(1, times):
                continue
            fires.value += 1
        if point == "lane_worker_crash":
            if exit_code < 0:
                os.kill(os.getpid(), -exit_code)
                time.sleep(60)  # pending-signal window; never returns
            os._exit(exit_code)
        else:  # lane_worker_hang: stop dead, no heartbeat, until killed
            time.sleep(3600)


class _LaneStop(Exception):
    pass


def lane_worker_main(
    lane_id: int,
    spec: LaneSpec,
    in_name: str,
    in_size: int,
    out_name: str,
    out_size: int,
    in_q,
    out_q,
    ack_in_q,
    ack_out_q,
    stop_ev,
    heartbeat=None,
    faults=(),
) -> None:
    """One lane worker: input ring frames -> parse plan -> packed output
    ring frames, sequence numbers passed through untouched.

    Replies per input frame, in order:
      ``("frame", seq, off, cost, nbytes, n, metas, new_strings, dur_s)``
      — parsed and packed; ``new_strings`` lists the strings interned
      into each lane-local table SINCE THE PREVIOUS FRAME (in first-seen
      order), which is all the merge needs to extend its lane->global
      remap deterministically; or
      ``("host", seq)`` — this frame defeats the native plan (blank
      lines, oversized, no native parser): the producer-retained source
      batch takes the ordinary inline parse path at the merge point.

    Input frames may carry an OPTIONAL 7th element: a tuple of record
    trace ids (obs flight-path sampling rides the batch whose frame
    this is). The worker echoes it back verbatim as an optional 10th
    ``"frame"`` reply element so the merge can attribute the lane span
    to those traces; untraced frames stay at the original arity.

    ``heartbeat`` (a shared double) is stamped per frame AND per idle /
    credit-wait tick, so the lane supervisor (runtime/ingest.py) reads
    a fresh timestamp from any healthy worker — idle, parsing, or
    backpressured — and a stale one only from a genuinely hung process.
    The worker may exit 0 only after an ``("eos",)`` message (or
    ``("stop",)`` at shutdown); the supervisor treats any earlier clean
    exit as lane death. ``faults`` carries testing/faults.py lane fault
    specs, checked at each frame's sequence number before parsing.
    """
    in_ring = out_ring = None
    # kernel-visible identity: the multiprocessing name is Python-only,
    # so without this every lane reads as "python" in ps/top and in the
    # /proc/<pid>/comm the obs ResourceSampler attributes CPU time by.
    # comm is capped at 15 bytes; best-effort (no /proc off Linux).
    try:
        with open("/proc/self/comm", "w") as f:
            f.write(f"tsm-lane{lane_id}")
    except OSError:
        pass
    try:
        in_ring = ShmRing(in_size, name=in_name)
        out_ring = ShmRing(out_size, name=out_name)
        ev, tables = spec.build_evaluator()
        shipped = [0] * len(tables)
        sticky = [0] * len(spec.kinds)
        _stamp(heartbeat)
        while True:
            try:
                msg = in_q.get(timeout=0.5)
            except _queue.Empty:
                if stop_ev.is_set():
                    break
                _stamp(heartbeat)
                continue
            if msg[0] in ("stop", "eos"):
                break
            _, seq, off, cost, nbytes, n_lines = msg[:6]
            trace_ids = msg[6] if len(msg) > 6 else ()
            if faults:
                _check_lane_faults(faults, seq)
            _stamp(heartbeat)
            t0 = time.perf_counter()
            data = in_ring.read(off, nbytes)
            cols = ev.parse_bytes(data, n_lines) if ev is not None else None
            ack_in_q.put(cost)
            if cols is None:
                out_q.put(("host", seq))
                continue
            metas, payload = pack_columns(cols, spec.kinds, sticky)
            if not out_ring.fits(len(payload)):
                # host-route BEFORE the shipped bookkeeping: the strings
                # this frame interned ride out with the lane's next
                # shipped frame (same as the cols-is-None path), keeping
                # the merge's lane->global remap aligned
                out_q.put(("host", seq))
                continue
            new_strings = []
            for j, t in enumerate(tables):
                if t is None:
                    new_strings.append(None)
                else:
                    new_strings.append(t._to_str[shipped[j] :])
                    shipped[j] = len(t._to_str)
            dur = time.perf_counter() - t0
            off2, cost2 = out_ring.write(
                payload,
                lambda: _drain_credit(ack_out_q, stop_ev, heartbeat=heartbeat),
            )
            reply = ("frame", seq, off2, cost2, len(payload), n_lines,
                     metas, new_strings, dur)
            if trace_ids:
                reply = reply + (trace_ids,)
            out_q.put(reply)
            _stamp(heartbeat)
    except _LaneStop:
        pass
    except Exception as e:  # pragma: no cover - surfaced via merge
        try:
            out_q.put(("err", lane_id, f"{type(e).__name__}: {e}"))
        except Exception:
            pass
    finally:
        for r in (in_ring, out_ring):
            if r is not None:
                r.close()


def spawn_lane(ctx, lane_id: int, spec: LaneSpec, args) -> "object":
    """Spawn one lane worker with the light-import gate set (the child
    inherits os.environ at spawn): tpustream_torch/__init__ skips torch
    and the worker pays a numpy import, not a torch one."""
    import warnings

    prev = os.environ.get("TPUSTREAM_LANE_WORKER")
    os.environ["TPUSTREAM_LANE_WORKER"] = "1"
    try:
        p = ctx.Process(
            target=lane_worker_main,
            args=(lane_id, spec) + tuple(args),
            daemon=True,
            name=f"tpustream-torch-lane-{lane_id}",
        )
        with warnings.catch_warnings():
            # Python warns on any os.fork() of a multithreaded process
            # (a live CUDA context runs threads of its own) because a
            # child that re-enters such a runtime can deadlock. Lane
            # workers never do: they only ever run the numpy/native
            # parse loop and never touch torch.cuda (glibc's atfork
            # handlers cover malloc; CPython reinits its own locks
            # post-fork).
            warnings.filterwarnings(
                "ignore", message=r"This process .* is multi-threaded",
                category=DeprecationWarning,
            )
            p.start()
        return p
    finally:
        if prev is None:
            os.environ.pop("TPUSTREAM_LANE_WORKER", None)
        else:
            os.environ["TPUSTREAM_LANE_WORKER"] = prev
