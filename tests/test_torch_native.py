"""The port's copy of the native C++ parser (``tpustream_torch/native``),
on the CPU: its columns equal the port's numpy path and the JAX
package's parse on tests/test_native_parser.py's inputs, the raw-bytes
lane of the host stage included; a failed build leaves the numpy path
running and says why (tests/test_native_fallback.py); the library is
built under ``build/`` with a hashed name. Tolerance: identical
columns and rows."""

import os
import subprocess
import sys
from importlib import import_module

import numpy as np
import pytest

import tpustream
import tpustream.hostparse as jax_hostparse
import tpustream.jobs.chapter1_threshold as jax_ch1
import tpustream.jobs.chapter2_max as jax_ch2
import tpustream.jobs.chapter3_bandwidth_eventtime as jax_ch3
import tpustream.records as jax_records
import tpustream_torch
import tpustream_torch.hostparse as torch_hostparse
import tpustream_torch.jobs.chapter1_threshold as torch_ch1
import tpustream_torch.jobs.chapter2_max as torch_ch2
import tpustream_torch.jobs.chapter3_bandwidth_eventtime as torch_ch3
import tpustream_torch.native as native
import tpustream_torch.records as torch_records
from tests.test_torch_chains import run_job
from tpustream_torch.hostparse import PlanEvaluator, trace_timestamp_extractor
from tpustream_torch.records import STR, StringTable

JOBS = {tpustream: {"ch1": jax_ch1, "ch2": jax_ch2, "ch3": jax_ch3},
        tpustream_torch: {"ch1": torch_ch1, "ch2": torch_ch2, "ch3": torch_ch3}}

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native parser failed to build: {native.build_error()}"
)

CH1_LINES = [f"15634520{i % 60:02d} 10.8.22.{i % 7} cpu{i % 4} {i % 100}.5"
             for i in range(1000)]
CH3_LINES = [f"2019-08-28T{h:02d}:{m:02d}:{s:02d} www.ch{m % 5}.com {100 + s}"
             for h in (0, 9, 23) for m in (0, 30, 59) for s in (0, 1, 59)]


def make_eval(fn, force_numpy=False, side="torch"):
    """(evaluator, tables) of ``fn``'s parse plan in the port, or in the
    JAX package."""
    hp, recs = ((jax_hostparse, jax_records) if side == "jax"
                else (torch_hostparse, torch_records))
    plan = hp.trace_host_map(fn)
    assert plan.fallback_fn is None
    tables = [recs.StringTable() if k == STR else None for k in plan.kinds]
    ev = hp.PlanEvaluator(plan.outputs, tables)
    if force_numpy:
        ev._native = None
    return ev, tables


def as_values(ev, cols):
    """Columns with interned ids replaced by their strings."""
    return [[t.lookup(int(i)) for i in c] if t is not None else c.tolist()
            for c, t in zip(cols, ev.tables)]


@pytest.mark.parametrize("job,lines", [("ch1", CH1_LINES), ("ch3", CH3_LINES)])
def test_native_equals_numpy_and_jax_package(job, lines):
    port_job, jax_job = JOBS[tpustream_torch][job], JOBS[tpustream][job]
    ev_n, _ = make_eval(port_job.parse)
    ev_p, _ = make_eval(port_job.parse, force_numpy=True)
    ev_j, _ = make_eval(jax_job.parse, force_numpy=True, side="jax")
    assert ev_n._native is not None
    got = as_values(ev_n, ev_n(lines))
    assert got == as_values(ev_p, ev_p(lines))
    assert got == as_values(ev_j, ev_j(lines))
    assert (ev_n.native_calls, ev_n.numpy_calls) == (1, 0)
    assert (ev_p.native_calls, ev_p.numpy_calls) == (0, 1)


def test_native_timestamp_extractor():
    from tpustream_torch import Time

    ex = torch_ch3.IsoTimestampExtractor(Time.minutes(1))
    ev = PlanEvaluator([trace_timestamp_extractor(ex.extract_timestamp)], [None])
    assert ev._native is not None
    (ts_ms,) = ev(CH3_LINES)
    want = [ex.extract_timestamp(line) for line in CH3_LINES]
    assert np.array_equal(ts_ms, want)


def test_native_id_namespace_shared_with_python_interning():
    ev, tables = make_eval(torch_ch1.parse)
    tables[0].intern("10.8.22.9")
    cols = ev(["1 10.8.22.9 cpu0 1.0", "2 10.8.22.1 cpu1 2.0"])
    assert int(cols[0][0]) == 0 and tables[0].lookup(int(cols[0][1])) == "10.8.22.1"


@pytest.mark.parametrize("bad", ["not-a-number", "1.5x", ""])
def test_malformed_field_parses_as_the_jax_packages_native_parser(bad):
    lines = ["1 10.8.22.1 cpu0 1.0", f"2 10.8.22.1 cpu1 {bad}"]
    ev, _ = make_eval(torch_ch1.parse)
    ev_j, _ = make_eval(jax_ch1.parse, side="jax")
    assert ev_j._native is not None
    assert as_values(ev, ev(lines)) == as_values(ev_j, ev_j(lines))


def test_multithreaded_parse_identical_to_serial():
    lines = CH1_LINES * 40  # past the 1 MiB threshold of the chunked kernel
    data = "\n".join(lines).encode()
    assert len(data) > 1 << 20
    specs = [(1, native.KIND_STR, 0), (3, native.KIND_F64, 0), (0, native.KIND_I64, 0)]
    one = native.NativeParser(" ", specs, [StringTable(), None, None])
    many = native.NativeParser(" ", specs, [StringTable(), None, None])
    a, bad_a = one.parse(data, len(lines), threads=1)
    b, bad_b = many.parse(data, len(lines), threads=4)
    assert bad_a == bad_b == 0
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def job_of(name):
    """A side-by-side builder of the chapter job ``name``."""
    return lambda ns, text: JOBS[ns.pkg][name].build(None, text)


flagship = job_of("ch3")


@pytest.mark.parametrize("batch_size", [3, 16])
def test_raw_bytes_lane_equals_lines_and_jax(batch_size):
    lines = CH3_LINES + ["2019-08-28T23:59:59 www.ch1.com 5"]
    want, _ = run_job("jax", flagship, lines, batch_size=batch_size, raw_batch=batch_size)
    got, s = run_job("torch", flagship, lines, batch_size=batch_size,
                     raw_batch=batch_size)
    by_line, s_lines = run_job("torch", flagship, lines, batch_size=batch_size)
    assert got == want == by_line and got
    # raw: one native pass a batch (timestamps and columns together);
    # lines: one for the timestamps and one for the columns
    n_batches = -(-len(lines) // batch_size)
    assert (s["native_parses"], s["numpy_parses"]) == (n_batches, 0)
    assert (s_lines["native_parses"], s_lines["numpy_parses"]) == (2 * n_batches, 0)


def test_library_is_built_under_build_with_a_hashed_name():
    path = native.library_path()
    root = native.NATIVE_DIR.parents[1]
    assert path.parent == root / "build" / "torch_native"
    assert path.name.startswith("libfastparse-") and path.exists()
    assert not list(native.NATIVE_DIR.glob("*.so"))


@pytest.fixture
def broken_native(monkeypatch, tmp_path):
    """The next load goes through a failing build: no loaded library, an
    empty build directory and a compiler that always errors."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)

    def fail(cmd, **kw):
        raise subprocess.CalledProcessError(1, cmd, stderr=b"fatal error: no such toolchain")

    monkeypatch.setattr(native.subprocess, "run", fail)
    return native


def test_build_failure_surfaces_error_and_stays_unavailable(broken_native):
    assert not broken_native.available()
    err = broken_native.build_error()
    assert "make" in err and "g++" in err and "no such toolchain" in err
    assert not broken_native.available()  # cached: no rebuild a call


def test_numpy_fallback_runs_the_job(broken_native):
    build = job_of("ch2")
    lines = ["1563452056 10.8.22.1 cpu0 80.5", "1563452050 10.8.22.1 cpu0 78.4",
             "1563452056 10.8.22.2 cpu1 40.0", "1563452060 10.8.22.1 cpu0 99.9"]
    got, s = run_job("torch", build, lines, event_time=False, batch_size=2)
    want, _ = run_job("jax", build, lines, event_time=False, batch_size=2)
    assert got == want and len(got) == 4
    assert s["native_parses"] == 0 and s["numpy_parses"] == 2


def test_dlopen_failure_triggers_one_rebuild(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native.library_path().write_bytes(b"\x7fELF not really a library")
    calls = []

    def fake_build(out):
        calls.append(out)
        native._build_error = "rebuild failed too"
        return False

    monkeypatch.setattr(native, "_build", fake_build)
    assert not native.available()
    assert len(calls) == 1
    err = native.build_error()
    assert "dlopen" in err and "rebuild failed too" in err


def _flight_events(side, kind):
    """The flight events of ``kind`` of a chapter-2 job with obs on,
    with the recorder's own fields (time, sequence) left out."""
    pkg = tpustream if side == "jax" else tpustream_torch
    config = import_module(pkg.__name__ + ".config")
    sources = import_module(pkg.__name__ + ".runtime.sources")
    cfg = dict(batch_size=4, obs=config.ObsConfig(enabled=True))
    if side == "torch":
        cfg["device"] = "cpu"
    env = pkg.StreamExecutionEnvironment(config.StreamConfig(**cfg))
    text = env.add_source(sources.ReplaySource(CH1_LINES[:8]))
    JOBS[pkg]["ch2"].build(env, text).collect()
    res = env.execute("flavor")
    return [{k: v for k, v in e.items() if k not in ("t", "seq", "t_s")}
            for e in res.metrics.job_obs.flight.events() if e["kind"] == kind]


def test_native_parse_ready_names_the_build_flavor_as_the_jax_package():
    got = _flight_events("torch", "native_parse_ready")
    assert got == _flight_events("jax", "native_parse_ready")
    assert got == [{"kind": "native_parse_ready", "flavor": "default"}]


@pytest.mark.parametrize("flavor", ["asan", "default", "no-such-flavor"])
def test_build_flavor_follows_the_environment_as_the_jax_package(flavor):
    """``TPUSTREAM_NATIVE_FLAVOR`` selects the flavor in both packages
    (an unknown one falls back to ``default``), and the asan build is a
    library of its own."""
    code = ("import {m}.native as n; print(n.build_flavor(), "
            "getattr(n, 'library_path', lambda: '')())")
    env = {**os.environ, "TPUSTREAM_NATIVE_FLAVOR": flavor}
    out = {m: subprocess.run(
        [sys.executable, "-c", code.format(m=m)], env=env,
        capture_output=True, text=True, check=True,
        cwd=str(native.NATIVE_DIR.parents[1])).stdout.split()
        for m in ("tpustream", "tpustream_torch")}
    want = "asan" if flavor == "asan" else "default"
    assert out["tpustream_torch"][0] == out["tpustream"][0] == want
    stem = "libfastparse_asan-" if want == "asan" else "libfastparse-"
    assert out["tpustream_torch"][1].rsplit("/", 1)[1].startswith(stem)
