"""Sharded host ingestion in the PyTorch port (``runtime/ingest.py``,
``parallel/lanes.py``), on the CPU, against the JAX package: lane worker
processes parse line frames behind shared-memory rings, and the merge
re-interleaves them in sequence order, so the executor sees the stream a
single-lane run sees.

* tests/test_ingest_lanes.py:78-377: the transport packing, the shared-memory ring, the worker's string remap,
  the merge's remap array, each run over BOTH packages' modules as cases
  of one parametrised test; two-lane and four-lane output against the
  single-lane run and the JAX package, with the per-lane record counts;
  the two-lane checkpoints equal the single-lane ones; a four-lane job
  crashed at a device step recovers exactly-once under supervision.
* tests/test_raw_ingest.py:50-180: the raw-bytes source through the
  native parser, equal to the line path (chapter 1, chapter 3 event
  time, a per-record map that decodes, a raw socket), and a resume that
  skips the consumed lines inside a raw buffer.

Tolerance: identical rows."""

import importlib
import socket
import threading
import time

import numpy as np
import pytest

from tests.test_torch_chains import PKGS, run_job

PACKAGES = {"jax": "tpustream", "torch": "tpustream_torch"}

LINES = [
    f"15634520{i:02d} 10.8.22.{i % 5} cpu{i % 3} {40 + (i * 31) % 55}.5"
    for i in range(24)
]


@pytest.fixture(params=sorted(PACKAGES))
def lanes(request):
    return importlib.import_module(PACKAGES[request.param] + ".parallel.lanes")


@pytest.fixture
def records(lanes):
    return importlib.import_module(lanes.__name__.split(".")[0] + ".records")


def ch2(ns, text):
    return importlib.import_module(
        ns.pkg.__name__ + ".jobs.chapter2_max").build(None, text)


# -- transport packing ----------------------------------------------------------

def test_transport_roundtrip_narrow_modes(lanes, records):
    r = records
    kinds = [r.I64, r.F64, r.STR, r.BOOL]
    cols = [
        np.array([1_563_452_000_000, 1_563_452_000_500, 1_563_452_001_000]),
        np.array([80.5, 78.25, -1.0]),
        np.array([0, 1, 2], dtype=np.int32),
        np.array([True, False, True]),
    ]
    sticky = [0, 0, 0, 0]
    metas, payload = lanes.pack_columns(cols, kinds, sticky)
    assert [m[0] for m in metas] == ["d16", "f32", "i16", "bits"]
    out = lanes.unpack_columns(metas, kinds, payload, 3)
    for a, b in zip(cols, out):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sticky == [0, 0, 0, 0]


def test_transport_demotion_is_sticky_and_lossless(lanes, records):
    r = records
    kinds = [r.I64, r.F64, r.STR]
    sticky = [0, 0, 0]
    wide = [
        np.array([0, 1 << 40], dtype=np.int64),
        np.array([0.1, 2.0**53 + 1]),
        np.array([5, 1 << 15], dtype=np.int32),
    ]
    metas, payload = lanes.pack_columns(wide, kinds, sticky)
    assert [m[0] for m in metas] == ["raw", "raw", "i32"]
    for a, b in zip(wide, lanes.unpack_columns(metas, kinds, payload, 2)):
        assert np.array_equal(a, b)
    chains = lanes.TRANSPORT_CHAINS
    assert sticky == [chains[r.I64].index("raw"), chains[r.F64].index("raw"),
                      chains[r.STR].index("i32")]
    narrow = [np.array([10, 11], dtype=np.int64), np.array([1.5, 2.5]),
              np.array([0, 1], dtype=np.int32)]
    metas2, payload2 = lanes.pack_columns(narrow, kinds, sticky)
    assert [m[0] for m in metas2] == ["raw", "raw", "i32"]
    for a, b in zip(narrow, lanes.unpack_columns(metas2, kinds, payload2, 2)):
        assert np.array_equal(a, b)


def test_transport_i64_intermediate_rung(lanes, records):
    kinds = [records.I64]
    sticky = [0]
    mid = np.array([0, 1 << 20], dtype=np.int64)
    metas, payload = lanes.pack_columns([mid], kinds, sticky)
    assert metas[0][0] == "d32"
    assert np.array_equal(lanes.unpack_columns(metas, kinds, payload, 2)[0], mid)
    metas2, _ = lanes.pack_columns([np.array([3, 4], dtype=np.int64)],
                                   kinds, sticky)
    assert metas2[0][0] == "d32"


def test_transport_empty_and_nan_columns(lanes, records):
    kinds = [records.I64, records.F64]
    sticky = [0, 0]
    cols = [np.empty(0, np.int64), np.array([np.nan, 1.0])]
    metas, payload = lanes.pack_columns(cols, kinds, sticky)
    out = lanes.unpack_columns(metas, kinds, payload, 0)
    assert len(out[0]) == 0
    assert metas[1][0] == "f32"
    assert np.array_equal(out[1].view(np.int64), cols[1].view(np.int64))


def test_transport_f64_nan_payload_rides_raw(lanes, records):
    weird_nan = np.array([0x7FF8000000000001], dtype=np.int64).view(np.float64)
    cols = [np.concatenate([weird_nan, [1.0]])]
    sticky = [0]
    metas, payload = lanes.pack_columns(cols, [records.F64], sticky)
    assert metas[0][0] == "raw"
    out = lanes.unpack_columns(metas, [records.F64], payload, 2)
    assert np.array_equal(out[0].view(np.int64), cols[0].view(np.int64))


# -- the shared-memory ring -----------------------------------------------------

def test_shm_ring_write_read_credit_and_wrap(lanes):
    ring = lanes.ShmRing(64)
    try:
        credits = []

        def wait_credit():
            assert credits, "ring blocked with no outstanding credit"
            return credits.pop(0)

        p1, p2, p3 = b"a" * 16, b"b" * 16, b"c" * 16
        off1, cost1 = ring.write(p1, wait_credit)
        off2, cost2 = ring.write(p2, wait_credit)
        assert (off1, cost1) == (0, 24) and (off2, cost2) == (24, 24)
        assert ring.read(off1, 16) == p1 and ring.read(off2, 16) == p2
        credits.append(cost1)
        off3, cost3 = ring.write(p3, wait_credit)
        assert off3 == 0 and cost3 == 24 + (64 - 48)
        assert ring.read(off3, 16) == p3
        assert not credits
        with pytest.raises(RuntimeError, match="corrupt"):
            ring.read(off3, 15)
        assert ring.fits(64 - ring.HEADER) and not ring.fits(64)
    finally:
        ring.close()


def test_shm_ring_large_frame_after_wrap_drains_and_resets(lanes):
    ring = lanes.ShmRing(1000)
    try:
        credits = []

        def wait_credit():
            assert credits, "ring blocked with no outstanding credit"
            return credits.pop(0)

        off1, cost1 = ring.write(b"a" * 400, wait_credit)
        assert ring.read(off1, 400) == b"a" * 400
        credits.append(cost1)
        off2, cost2 = ring.write(b"b" * 600, wait_credit)
        assert (off2, cost2) == (0, ring.HEADER + 600)
        assert ring.read(off2, 600) == b"b" * 600
        assert not credits
        credits.append(cost2)
        off3, _ = ring.write(b"c" * 900, wait_credit)
        assert off3 == 0 and ring.read(off3, 900) == b"c" * 900
    finally:
        ring.close()


def test_worker_oversized_frame_keeps_string_remap_aligned(lanes, records):
    """A frame whose packed payload can never fit the output ring is
    host-routed; its strings ride out with the lane's next shipped
    frame, so the merge's lane -> global remap stays aligned."""
    import queue

    hostparse = importlib.import_module(
        lanes.__name__.split(".")[0] + ".hostparse")
    PExpr = hostparse.PExpr
    spec = lanes.LaneSpec(
        exprs=[PExpr.field(" ", 0), PExpr("parse_f64", (PExpr.field(" ", 1),))],
        kinds=[records.STR, records.F64],
        str_slots=[True, False],
    )
    ev, _ = spec.build_evaluator()
    if ev is None:
        pytest.skip("native parser unavailable")
    in_ring, out_ring = lanes.ShmRing(1 << 16), lanes.ShmRing(64)
    in_q, out_q = queue.Queue(), queue.Queue()
    ack_in, ack_out = queue.Queue(), queue.Queue()
    stop_ev = threading.Event()
    worker = threading.Thread(
        target=lanes.lane_worker_main,
        args=(0, spec, in_ring.name, in_ring.size, out_ring.name,
              out_ring.size, in_q, out_q, ack_in, ack_out, stop_ev),
        daemon=True,
    )
    worker.start()
    try:
        def send(seq, lines):
            data = "\n".join(lines).encode("utf-8")
            off, cost = in_ring.write(data, lambda: ack_in.get(timeout=10))
            in_q.put(("frame", seq, off, cost, len(data), len(lines)))

        send(0, [f"s{i} {i}.5" for i in range(30)])
        assert out_q.get(timeout=10) == ("host", 0)
        send(1, ["s0 0.5", "s30 1.5", "s1 2.5", "s31 3.5"])
        reply = out_q.get(timeout=10)
        assert reply[0] == "frame" and reply[1] == 1, reply
        _, _, off, cost, nbytes, n, metas, new_strings, _ = reply
        assert new_strings[0] == [f"s{i}" for i in range(30)] + ["s30", "s31"]
        assert new_strings[1] is None
        payload = out_ring.read(off, nbytes)
        ack_out.put(cost)
        cols = lanes.unpack_columns(metas, spec.kinds, payload, n)
        assert [new_strings[0][i] for i in cols[0]] == ["s0", "s30", "s1", "s31"]
    finally:
        in_q.put(("stop",))
        stop_ev.set()
        worker.join(timeout=10)
        in_ring.close()
        out_ring.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES.values()))
def test_merge_remap_grow_array(pkg):
    r = importlib.import_module(pkg + ".runtime.ingest")._Remap()
    expect = []
    for start in range(0, 1200, 100):
        ids = list(range(start * 7, (start + 100) * 7, 7))
        r.extend(ids)
        expect.extend(ids)
        got = r.view()
        assert got.dtype == np.int32 and got.tolist() == expect


# -- end to end: multi-lane output equals single-lane ---------------------------

def run_lanes(side, lines, raw_batch=None, **cfg):
    """``(rows, metrics)`` of the chapter-2 job through one package."""
    ns = PKGS[side]
    obs_cfg = importlib.import_module(ns.pkg.__name__ + ".config").ObsConfig
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(
        batch_size=4, obs=obs_cfg(enabled=True), **cfg, **ns.cfg))
    if raw_batch is None:
        src = ns.sources.ReplaySource(lines)
    else:
        src = ns.sources.ReplayBytesSource([
            ("\n".join(lines[i:i + raw_batch]).encode(),
             len(lines[i:i + raw_batch]))
            for i in range(0, len(lines), raw_batch)])
    h = ch2(ns, env.add_source(src)).collect()
    env.execute("ingest-lanes-test")
    return [repr(t) for t in h.items], env.metrics


def lane_records(metrics):
    series = metrics.obs_snapshot()["metrics"]["series"]
    return {s["labels"]["lane"]: s["value"] for s in series
            if s["name"] == "ingest_lane_records_total"}


@pytest.mark.parametrize("lanes_n,raw_batch", [(2, None), (4, 4)],
                         ids=["two-lanes-lines", "four-lanes-raw"])
def test_multi_lane_output_parity(lanes_n, raw_batch):
    base, _ = run_job("torch", ch2, LINES, event_time=False, batch_size=4)
    multi, m = run_lanes("torch", LINES, raw_batch=raw_batch,
                         ingest_lanes=lanes_n)
    assert multi == base, "multi-lane output diverged from single-lane"
    # the plane really engaged: a disabled plane would pass the parity
    # check without testing anything
    kinds = [e["kind"] for e in m.job_obs.flight.events()]
    assert "ingest_lanes_enabled" in kinds, kinds
    counts = lane_records(m)
    assert set(counts) == {str(i) for i in range(lanes_n)}
    assert sum(counts.values()) == len(LINES)
    jmulti, jm = run_lanes("jax", LINES, raw_batch=raw_batch,
                           ingest_lanes=lanes_n)
    assert multi == jmulti
    assert counts == lane_records(jm)


def test_lanes_with_the_pipeline_deep():
    """Lanes feeding a deep pipeline: staged uploads and steps in flight
    behind the merge change nothing."""
    base, _ = run_job("torch", ch2, LINES, event_time=False, batch_size=4)
    got, _ = run_lanes("torch", LINES, ingest_lanes=2, async_depth=4,
                       h2d_depth=3, fetch_group=2)
    assert got == base


def test_unsplittable_plane_disables_with_a_reason():
    """A job whose parse the native plan cannot take runs inline, with an
    ``ingest_lanes_disabled`` breadcrumb naming the reason."""
    def build(ns, text):
        def pymap(line):
            p = line.split(" ")
            return ns.pkg.Tuple2(p[1], float(p[3]) if len(p) > 3 else 0.0)
        return text.map(pymap).key_by(0).max(1)

    ns = PKGS["torch"]
    from tpustream_torch.config import ObsConfig

    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(
        batch_size=4, ingest_lanes=2, obs=ObsConfig(enabled=True), **ns.cfg))
    h = build(ns, env.add_source(ns.sources.ReplaySource(LINES))).collect()
    env.execute("inline")
    assert len(h.items) == len(LINES)
    events = [e for e in env.metrics.job_obs.flight.events()
              if e["kind"].startswith("ingest_lanes_")]
    assert [e["kind"] for e in events] == ["ingest_lanes_disabled"]


# -- tests/test_raw_ingest.py ----------------------------------------------------

def _ch1(ns, text):
    return importlib.import_module(
        ns.pkg.__name__ + ".jobs.chapter1_threshold").build(None, text)


def _ch3(ns, text):
    return importlib.import_module(
        ns.pkg.__name__ + ".jobs.chapter3_bandwidth_eventtime").build(None, text)


def test_ch1_raw_equals_line_path():
    lines = [f"1563452051 10.8.22.{i % 4} cpu{i % 3} {50 + (i % 60)}.5"
             for i in range(100)]
    want, _ = run_job("torch", _ch1, lines, event_time=False, batch_size=16)
    got, s = run_job("torch", _ch1, lines, event_time=False, batch_size=16,
                     raw_batch=16)
    assert got == want
    assert s["records_in"] == 100
    assert got == run_job("jax", _ch1, lines, event_time=False,
                          batch_size=16, raw_batch=16)[0]


def test_ch3_eventtime_raw_equals_line_path():
    lines = []
    for m in range(12):
        for s in (3, 17, 41):
            lines.append(f"2019-08-28T10:{m:02d}:{s:02d} www.163.com {700 + m}")
            lines.append(f"2019-08-28T10:{m:02d}:{s:02d} www.btime.com {80000 + m}")
    want, _ = run_job("torch", _ch3, lines, batch_size=8)
    got, _ = run_job("torch", _ch3, lines, batch_size=8, raw_batch=8)
    assert want
    assert got == want
    assert got == run_job("jax", _ch3, lines, batch_size=8, raw_batch=8)[0]


def test_raw_fallback_decodes_for_non_symbolic_jobs():
    lines = ["1 a x 5", "2 b y 7"]

    def build(ns, text):
        def pymap(line):
            parts = line.split(" ")
            return (parts[1], float(parts[3]))
        return text.map(pymap)

    want, _ = run_job("torch", build, lines, event_time=False, batch_size=4)
    got, _ = run_job("torch", build, lines, event_time=False, batch_size=4,
                     raw_batch=2)
    assert got == want


def test_socket_raw_mode_equals_line_mode():
    lines = [f"1563452051 10.8.22.{i % 4} cpu{i % 3} {50 + (i % 60)}.5"
             for i in range(64)]
    payload = ("\n".join(lines) + "\n").encode()

    def serve(srv):
        conn, _ = srv.accept()
        # two sends with a gap: block re-assembly mid-stream
        conn.sendall(payload[: len(payload) // 2])
        time.sleep(0.05)
        conn.sendall(payload[len(payload) // 2:])
        conn.close()
        srv.close()

    def run(raw):
        srv = socket.create_server(("127.0.0.1", 0))
        port = srv.getsockname()[1]
        t = threading.Thread(target=serve, args=(srv,), daemon=True)
        t.start()
        ns = PKGS["torch"]
        env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(
            batch_size=16, max_batch_delay_ms=100.0, **ns.cfg))
        h = _ch1(ns, env.socket_text_stream("127.0.0.1", port, raw=raw)).collect()
        env.execute("ch1-socket")
        t.join(timeout=10)
        return [repr(x) for x in h.items]

    want = run(raw=False)
    assert want
    assert run(raw=True) == want


# -- checkpoints and supervised recovery with lanes ---------------------------

def checkpoint_digest(path):
    """Digest of the replayable checkpoint content: the state leaves and
    the stream cursors (the session and the informational lane cursor
    are left out)."""
    import hashlib
    import json

    from tpustream_torch.runtime.checkpoint import load_checkpoint

    ck = load_checkpoint(str(path))
    h = hashlib.sha256()
    for leaf in ck.leaves:
        a = np.asarray(leaf)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(json.dumps([ck.source_pos, ck.emitted, ck.batches]).encode())
    return h.hexdigest()


def test_two_lane_output_and_checkpoint_parity(tmp_path):
    ck = dict(checkpoint_interval_batches=1)
    base, _ = run_lanes("torch", LINES, checkpoint_dir=str(tmp_path / "one"), **ck)
    multi, m = run_lanes("torch", LINES, checkpoint_dir=str(tmp_path / "two"),
                         ingest_lanes=2, **ck)
    assert multi == base, "multi-lane output diverged from single-lane"
    assert "ingest_lanes_enabled" in [e["kind"] for e in m.job_obs.flight.events()]
    assert sum(lane_records(m).values()) == len(LINES)
    # the replayable checkpoint content is byte-identical too
    assert checkpoint_digest(tmp_path / "one") == checkpoint_digest(tmp_path / "two")


def test_four_lane_crash_recovery_exactly_once(tmp_path):
    """device_step fault at step 2 with ingest_lanes=4: the supervisor
    stops the lane fleet with the attempt, restarts from the latest
    checkpoint, and the recovered output equals an uninterrupted
    single-lane run: frames still in a lane ring at the crash replay
    exactly once through the source cursor."""
    from tpustream_torch.runtime.supervisor import fixed_delay
    from tpustream_torch.testing import FaultInjector, FaultPoint

    full, _ = run_lanes("torch", LINES)
    inj = FaultInjector(FaultPoint("device_step", at=2))
    ns = PKGS["torch"]
    cfg = inj.install(ns.pkg.StreamConfig(
        batch_size=4, ingest_lanes=4, checkpoint_dir=str(tmp_path),
        checkpoint_interval_batches=1,
        obs=importlib.import_module("tpustream_torch.config").ObsConfig(enabled=True),
        **ns.cfg))
    env = ns.pkg.StreamExecutionEnvironment(cfg)
    env.set_restart_strategy(fixed_delay(3, 0.0))
    h = ch2(ns, env.add_source(ns.sources.ReplaySource(LINES))).collect()
    env.execute("ingest-lanes-recovery")
    assert inj.fired == 1
    assert [repr(t) for t in h.items] == full
    kinds = [e["kind"] for e in env.metrics.job_obs.flight.events()]
    # the plane engaged on the first attempt AND after the restart
    assert kinds.count("ingest_lanes_enabled") == 2, kinds
    for want in ("job_failed", "job_restarting", "job_recovered"):
        assert want in kinds, kinds


def test_raw_resume_skips_consumed_lines(tmp_path):
    """The only checkpoint lands after 32 of 40 lines; the resume reads
    the stream in buffers of 12, so the skip ends 8 lines into the
    third buffer (the newline scan of a partial raw trim)."""
    lines = [f"1563452051 10.8.22.{i % 2} cpu0 {91 + (i % 5)}.5" for i in range(40)]
    ns = PKGS["torch"]

    def buffers(n):
        return ns.sources.ReplayBytesSource([
            ("\n".join(lines[i:i + n]).encode(), len(lines[i:i + n]))
            for i in range(0, len(lines), n)])

    ckdir = str(tmp_path / "ck")
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(
        batch_size=8, checkpoint_dir=ckdir, checkpoint_interval_batches=4,
        **ns.cfg))
    h1 = _ch1(ns, env.add_source(buffers(8))).collect()
    env.execute("ch1-ck")
    full = h1.items
    env2 = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(batch_size=8, **ns.cfg))
    env2.restore_from_checkpoint(ckdir)
    h2 = _ch1(ns, env2.add_source(buffers(12))).collect()
    env2.execute("ch1-resume")
    # 8 lines remain past the checkpoint; all alert (usage > 90)
    assert 0 < len(h2.items) < len(full)
    assert h2.items == full[len(full) - len(h2.items):]
