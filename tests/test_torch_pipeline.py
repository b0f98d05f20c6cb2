"""The executor pipeline of the PyTorch port, on the CPU, against the JAX
package: staged uploads (``h2d_depth``), steps in flight
(``async_depth``), grouped count fetches (``fetch_group``), device-side
compaction (``compaction_capacity``), the packed wire (``packed_wire``,
``h2d_compress``) and parse-ahead (``parse_ahead``).

* Counterparts of tests/test_pipeline_parity.py's single-device cases:
  the keyed rolling sum at five settings and the chapter-3 event-time
  job at two, each equal to the fully synchronous run and to the JAX
  package's; the final checkpoint of the synchronous and the deep
  pipeline equal leaf for leaf, and equal to the JAX package's; the compaction
  spill, exact past the capacity and counted as the JAX package counts
  it; the compact fetch engaged below it; the staged ``h2d`` spans.
* The single-stage ``sync_depth1``, ``no_compress``, ``grouped_fetch``
  and ``parse_ahead`` strategies of tests/test_config_equivalence.py.
* Aliasing: the port writes state in place, so a step's emissions must
  not alias anything a later step rewrites before the fetch. Every
  program family runs at ``async_depth=4`` (three later steps run
  before a step's rows are read) and at a compaction capacity below
  its emission density, against the synchronous run.
* A program whose emissions reference the live state (full-window
  ``process()``) runs at depth 1, unstaged and uncompacted.

Tolerance: identical rows and printed bytes."""

import collections
import functools

import numpy as np
import pytest

import tpustream_torch as T
from tpustream_torch.config import ObsConfig
from tpustream_torch.runtime import executor as torch_executor
from tests.test_config_equivalence import _stream
from tests.test_torch_chains import run_job
from tests.test_torch_config_fuzz import build as fuzz_build

# the synchronous reference: one step in flight, no staging, no
# compaction, no narrowing
SYNC = dict(async_depth=1, h2d_depth=1, compaction_capacity=0,
            packed_wire=False)
# everything on, deeper than the defaults
DEEP = dict(async_depth=4, h2d_depth=3, fetch_group=2)


def rolling_build(ns, text):
    def parse(line):
        items = line.split(" ")
        return ns.pkg.Tuple2(items[1], int(items[2]))
    return text.map(parse).key_by(0).sum(1)


def rolling_lines(n=40, keys=5):
    return [f"1 k{i % keys} {(i * 7) % 97}" for i in range(n)]


@functools.lru_cache(maxsize=None)
def jax_rows(case: str, n: int, keys: int, batch_size: int):
    """The JAX package's rows of a case, at its synchronous setting."""
    if case == "rolling":
        rows, _ = run_job("jax", rolling_build, rolling_lines(n, keys),
                          event_time=False, batch_size=batch_size, **SYNC)
        return rows
    rows, _ = run_job("jax", ch3_build, CH3, batch_size=batch_size, **SYNC)
    return rows


def run_rolling(lines, obs=None, **over):
    over.setdefault("batch_size", 4)
    if obs is not None:
        over["obs"] = obs
    return run_job("torch", rolling_build, lines, event_time=False, **over)


@pytest.mark.parametrize(
    "variant",
    [{}, dict(async_depth=4, h2d_depth=3), dict(compaction_capacity=8),
     dict(packed_wire=False, h2d_depth=2), DEEP],
    ids=["defaults", "deep-h2d", "tight-compaction", "unpacked", "all-deep"],
)
def test_rolling_parity_across_depths(variant):
    lines = rolling_lines()
    want, _ = run_rolling(lines, **SYNC)
    got, _ = run_rolling(lines, **variant)
    assert got == want == jax_rows("rolling", 40, 5, 4)


CH3 = [
    "2019-08-28T09:00:00 www.163.com 1000",
    "2019-08-28T09:02:00 www.163.com 2000",
    "2019-08-28T09:01:00 www.baidu.com 900",
    "2019-08-28T09:03:00 www.163.com 3000",
    "2019-08-28T09:05:00 www.baidu.com 400",
    "2019-08-28T09:05:30 www.163.com 4000",
    "2019-08-28T09:07:00 www.163.com 500",
    "2019-08-28T09:09:00 www.baidu.com 800",
]


def ch3_build(ns, text):
    import importlib

    job = importlib.import_module(
        ns.pkg.__name__ + ".jobs.chapter3_bandwidth_eventtime")
    return job.build(None, text)


@pytest.mark.parametrize("variant", [{}, DEEP], ids=["defaults", "all-deep"])
def test_window_job_parity_across_depths(variant):
    want, _ = run_job("torch", ch3_build, CH3, batch_size=2, **SYNC)
    got, _ = run_job("torch", ch3_build, CH3, batch_size=2, **variant)
    assert want
    assert got == want == jax_rows("ch3", 0, 0, 2)


def _series_sum(metrics, suffix):
    series = metrics.obs_snapshot()["metrics"]["series"]
    return sum(s["value"] for s in series
               if s["type"] in ("counter", "gauge") and s["name"].endswith(suffix))


def test_compaction_overflow_spills_exact():
    """Every record emits, so batch 8 against capacity 2 overflows each
    step: the fetch spills to the full buffers (exact), every spill is
    counted, as in the JAX package, and the first one a stream leaves a
    flight breadcrumb."""
    lines = rolling_lines(64, 3)
    want, _ = run_rolling(lines, batch_size=8, **SYNC)
    got = {side: _spill_run(side, lines) for side in ("jax", "torch")}
    assert got["torch"][0] == got["jax"][0] == want
    m_torch, m_jax = got["torch"][1], got["jax"][1]
    spills = _series_sum(m_torch, "compaction_spills")
    assert spills >= 8 and spills == _series_sum(m_jax, "compaction_spills")
    crumbs = [e for e in m_torch.job_obs.flight.events()
              if e["kind"] == "compaction_spill"]
    assert len(crumbs) == 1
    assert crumbs[0]["stream"] == "main"
    assert crumbs[0]["capacity"] == 2 and crumbs[0]["count"] > 2


def _spill_run(side, lines):
    """One package's rolling run at batch 8 against compaction capacity
    2, obs on: ``(rows, metrics)``."""
    from tests.test_torch_chains import PKGS

    ns = PKGS[side]
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(
        batch_size=8, compaction_capacity=2, obs=_obs(side), **ns.cfg))
    h = rolling_build(ns, env.add_source(ns.sources.ReplaySource(lines))).collect()
    env.execute("spill")
    return [repr(t) for t in h.items], env.metrics


def _obs(side, **kw):
    import importlib

    pkg = "tpustream" if side == "jax" else "tpustream_torch"
    return importlib.import_module(pkg + ".config").ObsConfig(enabled=True, **kw)


def test_compact_fetch_is_exercised_and_counted():
    lines = rolling_lines(32, 3)
    env = T.StreamExecutionEnvironment(T.StreamConfig(
        device="cpu", batch_size=8, obs=ObsConfig(enabled=True)))
    from tests.test_torch_chains import PKGS

    h = rolling_build(PKGS["torch"], env.add_source(
        PKGS["torch"].sources.ReplaySource(lines))).collect()
    env.execute("compact")
    want, _ = run_rolling(lines, batch_size=8, **SYNC)
    assert [repr(t) for t in h.items] == want
    m = env.metrics
    assert _series_sum(m, "compaction_spills") == 0
    assert _series_sum(m, "h2d_bytes_total") > 0
    assert _series_sum(m, "fetch_bytes_total") > 0
    assert _series_sum(m, "compaction_ratio") > 0


def test_h2d_spans_traced_when_staged():
    """h2d_depth > 1 with obs on records an ``h2d`` span a staged batch."""
    from tests.test_torch_chains import PKGS

    env = T.StreamExecutionEnvironment(T.StreamConfig(
        device="cpu", batch_size=4, h2d_depth=2,
        obs=ObsConfig(enabled=True, trace=True)))
    rolling_build(PKGS["torch"], env.add_source(
        PKGS["torch"].sources.ReplaySource(rolling_lines(24, 3)))).collect()
    env.execute("trace")
    snap = env.metrics.obs_snapshot()
    kinds = {e["kind"] for e in snap.get("trace", {}).get("events", [])}
    assert "h2d" in kinds


# -- tests/test_config_equivalence.py, single-stage strategies ------------------

@pytest.mark.parametrize("name,cfg", [
    ("sync_depth1", dict(async_depth=1)),
    ("no_compress", dict(h2d_compress=False)),
    ("grouped_fetch", dict(async_depth=8, fetch_group=4)),
    ("parse_ahead", dict(parse_ahead=2)),
])
def test_execution_strategies_match_the_jax_package(name, cfg):
    lines = _stream(0, n=300)
    want = _equiv_jax_rows()
    got, _ = run_job("torch", fuzz_build, lines, batch_size=16, **cfg)
    assert sum(want.values()) > 20  # windows actually fired
    assert collections.Counter(got) == want, name


@functools.lru_cache(maxsize=None)
def _equiv_jax_rows():
    rows, _ = run_job("jax", fuzz_build, _stream(0, n=300), batch_size=16)
    return collections.Counter(rows)


# -- aliasing: every program family with steps in flight ------------------------

ALIAS = dict(async_depth=4, h2d_depth=3, fetch_group=2)


def _torch_job(build, lines, event_time, capsys, **cfg):
    """rows and printed bytes of ``build`` through the port."""
    from tests.test_torch_chains import PKGS

    ns = PKGS["torch"]
    env = T.StreamExecutionEnvironment(T.StreamConfig(device="cpu", **cfg))
    if event_time:
        env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    stream = build(ns, env.add_source(ns.sources.ReplaySource(lines)))
    h = stream.collect()
    stream.print()
    capsys.readouterr()
    env.execute("alias")
    return [repr(t) for t in h.items], capsys.readouterr().out


def _job_module(name):
    import importlib

    return importlib.import_module("tpustream_torch.jobs." + name)


def _ch1(ns, text):
    return _job_module("chapter1_threshold").build(None, text)


def _ch2_max(ns, text):
    return _job_module("chapter2_max").build(None, text)


def _ch2_max_by(ns, text):
    def parse(line):
        p = line.split(" ")
        return ns.pkg.Tuple3(p[1], p[2], float(p[3]))
    return text.map(parse).key_by(0).max_by(2)


def _ch2_avg(ns, text):
    return _job_module("chapter2_avg").build(None, text)


def _ch2_median(ns, text):
    return _job_module("chapter2_median").build(None, text)


def _cpu_lines(n=300, hosts=6):
    rng = np.random.default_rng(11)
    return [f"{1563452050 + i // 20} 10.8.22.{int(h)} cpu{int(c)} {v:.1f}"
            for i, (h, c, v) in enumerate(zip(
                rng.integers(0, hosts, n), rng.integers(0, 3, n),
                rng.random(n) * 100))]


def _ch3_lines(n=120):
    rng = np.random.default_rng(12)
    t = 1_566_954_000 + np.cumsum(rng.integers(0, 40, n))
    t = t - rng.integers(0, 90, n) * (rng.random(n) < 0.15)
    import datetime

    return [
        f"{datetime.datetime.fromtimestamp(int(s)).strftime('%Y-%m-%dT%H:%M:%S')}"
        f" www.site{int(k)}.com {int(v)}"
        for s, k, v in zip(t, rng.integers(0, 5, n), rng.integers(1, 5000, n))]


def _ch3(ns, text):
    return _job_module("chapter3_bandwidth_eventtime").build(None, text)


FAMILIES = {
    # name: (build, lines, event_time, batch_size)
    "stateless": (_ch1, _cpu_lines, False, 8),
    "rolling-kernel": (_ch2_max, _cpu_lines, False, 8),
    "rolling-general": (_ch2_max_by, _cpu_lines, False, 8),
    "window-aggregate": (_ch2_avg, _cpu_lines, False, 8),
    "window-process": (_ch2_median, _cpu_lines, False, 8),
    "window-reduce-eventtime": (_ch3, _ch3_lines, True, 8),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_steps_in_flight_do_not_alias_state(family, capsys):
    build, lines_fn, event_time, bs = FAMILIES[family]
    lines = lines_fn()
    if not event_time:
        # a processing-time minute every 60 lines fires the windows
        from tpustream_torch.runtime.sources import AdvanceProcessingTime

        lines = [x for i, l in enumerate(lines)
                 for x in ([l] + ([AdvanceProcessingTime(60_000 * (i // 60 + 1))]
                                  if i % 60 == 59 else []))]
    want = _torch_job(build, lines, event_time, capsys, batch_size=bs, **SYNC)
    assert want[0]
    for cfg in (ALIAS, dict(ALIAS, compaction_capacity=2)):
        assert _torch_job(build, lines, event_time, capsys, batch_size=bs,
                          **cfg) == want, cfg


@pytest.mark.parametrize("kind", ["reduce", "lateness", "processing", "process"])
def test_session_steps_in_flight_do_not_alias_state(kind, capsys):
    from tests.test_torch_sessions import _side_items, _side_run

    items = _side_items(kind, 3)
    want = _side_run(T, kind, items, capsys, batch_size=3, **SYNC)
    assert want[0]
    for cfg in (ALIAS, dict(ALIAS, compaction_capacity=2)):
        assert _side_run(T, kind, items, capsys, batch_size=3, **cfg) == want


@pytest.mark.parametrize("kind", ["tumbling-reduce", "sliding-aggregate",
                                  "process"])
def test_count_window_steps_in_flight_do_not_alias_state(kind, capsys):
    from tests.test_torch_count_windows import _side_lines, _side_run

    lines = _side_lines(3)
    want = _side_run(T, kind, lines, capsys, batch_size=3, **SYNC)
    assert want[0]
    for cfg in (ALIAS, dict(ALIAS, compaction_capacity=2)):
        assert _side_run(T, kind, lines, capsys, batch_size=3, **cfg) == want


def test_cep_steps_in_flight_do_not_alias_state(capsys):
    from tests.test_torch_cep import run_side, seeded_events

    events = seeded_events(np.random.default_rng(7), 60)
    spec = ([dict(strict=False, times=2, consecutive=False, op=">", thr=12,
                  key=None),
             dict(strict=True, times=1, consecutive=False, op="<", thr=20,
                  key=None)], 12000)
    want = run_side("torch", events, spec, 4, capsys, select=True, **SYNC)
    assert want[0] and want[1] and want[2]  # matches, timeouts, late rows
    for cfg in (ALIAS, dict(ALIAS, compaction_capacity=2)):
        assert run_side("torch", events, spec, 4, capsys, select=True,
                        **cfg) == want


# -- the live-state guard ---------------------------------------------------------

def _runners(monkeypatch):
    """Every Runner a job builds, captured."""
    built = []
    orig = torch_executor.Runner.__init__

    def init(self, *a, **kw):
        orig(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(torch_executor.Runner, "__init__", init)
    return built


@pytest.mark.parametrize("family,forced", [
    ("window-process", True), ("rolling-kernel", False),
    ("window-aggregate", False)])
def test_state_referencing_program_runs_at_depth_one(family, forced,
                                                     monkeypatch, capsys):
    built = _runners(monkeypatch)
    build, lines_fn, event_time, bs = FAMILIES[family]
    _torch_job(build, lines_fn(60), event_time, capsys, batch_size=bs,
               **DEEP)
    (r,) = built
    assert r.program.emissions_reference_state is forced
    if forced:
        assert (r._max_inflight, r._h2d_ahead, r._compact_cap) == (0, 0, 0)
    else:
        assert r._max_inflight == 3 and r._compact_cap == 4096
        assert r._h2d_ahead == (0 if r.cfg.max_fires_per_step else 2)


def test_count_process_keeps_its_pipeline(monkeypatch, capsys):
    """A count window's process() fires travel in the emission (the
    JAX package's CountProcessProgram keeps the flag False too)."""
    from tests.test_torch_count_windows import _side_lines, _side_run

    built = _runners(monkeypatch)
    _side_run(T, "process", _side_lines(3), capsys, batch_size=3, **DEEP)
    (r,) = built
    assert r.program.emissions_reference_state is False
    assert r._max_inflight == 3


def test_resolved_config_records_each_clamp():
    """``execute`` resolves the config: a fetch group past
    ``async_depth - 1`` runs clamped, one ``config_clamped`` breadcrumb
    a clamp, as in the JAX package."""
    lines = rolling_lines(16, 3)
    env = T.StreamExecutionEnvironment(T.StreamConfig(
        device="cpu", batch_size=4, async_depth=3, fetch_group=8,
        obs=ObsConfig(enabled=True)))
    from tests.test_torch_chains import PKGS

    rolling_build(PKGS["torch"], env.add_source(
        PKGS["torch"].sources.ReplaySource(lines))).collect()
    env.execute("clamp")
    notes = [e for e in env.metrics.job_obs.flight.events()
             if e["kind"] == "config_clamped"]
    assert [(e["knob"], e["requested"], e["effective"]) for e in notes] == [
        ("fetch_group", 8, 2)]
    assert env.config.fetch_group == 8  # the requested value stays


def test_final_checkpoint_identical_sync_vs_deep(tmp_path):
    """Same input at async_depth/h2d_depth 1 vs N: the final
    checkpoint's state arrays (not just the sink output) match byte for
    byte, and match the JAX package's: the pipeline may not smear state
    across a snapshot barrier."""
    import glob
    import os

    from tpustream_torch.runtime.checkpoint import _read_npz

    lines = rolling_lines(48, 7)
    ck = dict(checkpoint_interval_batches=1)
    want, _ = run_rolling(lines, checkpoint_dir=str(tmp_path / "sync"), **ck, **SYNC)
    got, _ = run_rolling(lines, checkpoint_dir=str(tmp_path / "deep"), **ck, **DEEP)
    assert got == want
    run_job("jax", rolling_build, lines, event_time=False, batch_size=4,
            checkpoint_dir=str(tmp_path / "jax"), **ck, **SYNC)

    def last_leaves(d):
        path = sorted(glob.glob(os.path.join(str(d), "ckpt-*.npz")))[-1]
        return _read_npz(path)[1]

    a = last_leaves(tmp_path / "sync")
    for other in ("deep", "jax"):
        b = last_leaves(tmp_path / other)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), other
