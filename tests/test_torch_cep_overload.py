"""The link-overload CEP deployment (``jobs/link_overload.py``)
and its benchmark cell ``cep_overload.telemetry10s``, on the CPU.

* The cell's plain reference (``streambench/reference/cep_overload.py``)
  against a brute-force per-key NFA written here, on seeded random
  streams, on hand cases and on the cell's generator.
* The port against the reference through the harness at a tiny size
  (1,024 channels, blocks of 256 lines): every row equal; the
  configuration's control, the reference's sums in int32 and float32,
  and the benchmark's three faults come out not correct.
* The CEP step's spans (``step.advance``, ``step.timeout``) and its
  ``rounds`` counter; the stage readers the cell shares with the other
  cells, on the CPU.
* The job is chapter 4's with its threshold and nothing more.
"""

import ast
import datetime
import json

import numpy as np
import pytest
import torch

import tpustream_torch as T
from streambench.check import Rows, compare_rows
from streambench.harness import HERE as BENCH, ROOT, Cell, load_module, run_cell
from streambench.tests.conftest import full_copy
from streambench.tests.test_streambench_port import FAULTS
from tpustream_torch.config import StreamConfig
from tpustream_torch.jobs import chapter4_cep_alert as ch4
from tpustream_torch.jobs import link_overload as overload
from tpustream_torch.runtime.sources import ReplaySource

CELL = "cep_overload.telemetry10s"
SEED = 2**31 + 12345
T0 = 1566957600
CONFIG = json.loads((BENCH / "configs" / "cep_overload.json").read_text())
PATTERN = CONFIG["pattern"]
THRESHOLD = PATTERN["threshold_bytes"]
HIGH, LOW = THRESHOLD + 1, THRESHOLD  # a breach is strictly above


def reference():
    return load_module(BENCH / "reference" / "cep_overload.py",
                       "ref_cep_overload")


def brute(ts, key, value, pattern=PATTERN):
    """Each key's partial runs, event by event in stream order: a
    breach extends every run whose first event lies less than
    ``within_s`` before it and starts a run of its own; a run of
    ``times`` events is a match; anything else kills the key's runs."""
    n, within, thr = pattern["times"], pattern["within_s"], pattern["threshold_bytes"]
    runs, rows = {}, []
    for t, k, v in zip(ts.tolist(), key.tolist(), value.tolist()):
        if v <= thr:
            runs[k] = []
            continue
        kept = []
        for run in runs.get(k, []):
            if t - run[0][0] >= within:
                continue
            run = run + [(t, v)]
            if len(run) == n:
                rows.append((f"www.{k:07d}.com", sum(x[1] for x in run),
                             run[0][0], t))
            else:
                kept.append(run)
        runs[k] = kept + [[(t, v)]]
    return rows


def ref_rows(ts, key, value):
    cols = reference().expected(
        {"ts": np.asarray(ts, np.int64), "key": np.asarray(key, np.int64),
         "value": np.asarray(value, np.int64)}, CONFIG)
    return list(zip(*[c.tolist() for c in cols]))


def one_key(values, gaps=None):
    """One channel's samples every 10 s (or after ``gaps``)."""
    gaps = gaps or [10] * (len(values) - 1)
    ts = T0 + np.concatenate([[0], np.cumsum(gaps)]).astype(np.int64)
    return ts, np.full(len(values), 7, np.int64), np.array(values, np.int64)


HAND = {
    "two_breaches": ([HIGH] * 2, None, 0),
    "three_breaches": ([HIGH] * 3, None, 1),
    "four_breaches": ([HIGH] * 4, None, 2),
    "five_breaches": ([HIGH] * 5, None, 3),
    "a_non_breach_between": ([HIGH, HIGH, LOW, HIGH, HIGH], None, 0),
    "a_non_breach_then_three": ([HIGH, LOW, HIGH, HIGH, HIGH], None, 1),
    "third_at_60_s": ([HIGH] * 3, [30, 30], 0),
    "third_at_59_s": ([HIGH] * 3, [30, 29], 1),
    "third_past_a_minute": ([HIGH] * 3, [10, 55], 0),
    "a_run_again_after_a_minute": ([HIGH] * 5, [10, 55, 5, 5], 1),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_reference_on_hand_cases(case):
    values, gaps, n_rows = HAND[case]
    ts, key, value = one_key(values, gaps)
    want = brute(ts, key, value)
    assert len(want) == n_rows
    assert ref_rows(ts, key, value) == want


def test_reference_on_two_channels_interleaved():
    # channel 1 breaches three times in a row, channel 2 breaks its own
    # run in between; neither's events break the other's run
    key = np.array([1, 2, 1, 2, 2, 1, 2, 1], np.int64)
    value = np.array([HIGH, HIGH, HIGH, LOW, HIGH, HIGH, HIGH, LOW], np.int64)
    ts = T0 + 5 * np.arange(key.size, dtype=np.int64)
    want = brute(ts, key, value)
    assert [r[0] for r in want] == ["www.0000001.com"]
    assert ref_rows(ts, key, value) == want


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 3])
def test_reference_matches_brute_force_on_random_streams(seed):
    """Few channels, breaches more often than not, gaps that cross the
    minute: many runs of each length, some expiring."""
    rng = np.random.default_rng(seed)
    n = 4000
    key = rng.integers(0, 12, n)
    ts = T0 + np.cumsum(rng.integers(0, 8, n))
    value = np.where(rng.random(n) < 0.7,
                     rng.integers(HIGH, 2 * THRESHOLD, n),
                     rng.integers(0, LOW + 1, n))
    want = brute(ts, key, value)
    assert len(want) > 200
    assert ref_rows(ts, key, value) == want


def test_reference_on_the_generator(tiny_cell):
    cell = tiny_cell()
    ev = cell.traffic(77).events(160)
    want = brute(ev["ts"], ev["key"], ev["value"])
    assert want
    got = list(zip(*[c.tolist() for c in cell.reference().expected(ev, cell.config)]))
    assert got == want


def test_the_reference_imports_nothing_of_the_port_or_jax():
    tree = ast.parse((BENCH / "reference" / "cep_overload.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= {"__future__", "torch", "streambench"}


def test_the_configuration_is_the_jobs():
    assert PATTERN["threshold_bytes"] == overload.OVERLOAD_BYTES
    assert PATTERN["times"] == 3 and PATTERN["within_s"] == 60
    assert CONFIG["job"] == overload.__name__
    flagship = json.loads((BENCH / "configs" / "bandwidth_eventtime.json").read_text())
    assert CONFIG["line"] == flagship["line"]
    sc = CONFIG["stream_config"]
    assert sc["alert_capacity"] >= sc["key_capacity"] * (PATTERN["times"] - 1)


# ---------------------------------------------------------------------------
# the port through the harness, at a tiny size


@pytest.fixture
def tiny_cell(tmp_path):
    """A factory of the cell in a copy of the benchmark cut to CPU size:
    1,024 channels, blocks of 256 lines. A row is due about once in
    4,096 events, so the untimed warm blocks are 128 (32 intervals):
    the rows of a run's first 128 blocks are drawn from the seed alone
    (6 for ``SEED``), and a run has rows to get wrong however few blocks
    a slow machine takes in its timed window."""
    manifest = full_copy(tmp_path)
    bench = tmp_path / "streambench"
    p = bench / "configs" / "cep_overload.json"
    c = json.loads(p.read_text())
    c["stream_config"].update(batch_size=256, key_capacity=1024,
                              alert_capacity=2048)
    p.write_text(json.dumps(c))
    p = bench / "workloads" / f"{CELL}.json"
    c = json.loads(p.read_text())
    c.update(keys=1024, warm_batches=128)
    p.write_text(json.dumps(c))
    return lambda: Cell(CELL, manifest, bench)


def run(cell, seconds=2.0, **kw):
    return run_cell(cell, SEED, seconds, device="cpu", log=lambda *a: None, **kw)


def test_every_row_equals_the_reference(tiny_cell):
    res, r = run(tiny_cell())
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["check"].values())
    assert set(res["metrics"]) == {"events_per_s", "setup_s"}
    # the window's rows are some of the run's, after the warm blocks'
    assert r.count["records_emitted"] < res["attempted"]


def test_control_is_not_correct(tiny_cell):
    """``alert_capacity`` 1: the port's own match buffer keeps a step's
    first row. At this size a step seldom completes two matches, so the
    drops show first in the count of timed-out partials past the
    buffer; on the card's blocks they show in the rows too."""
    res, _ = run(tiny_cell(), control=True)
    assert not res["correct"]
    assert res["check"]["alert_overflow"]["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res, _ = run(tiny_cell())
    assert not res["correct"]
    assert res["check"]["rows_wrong"]["value"] > 0


def test_the_step_records_its_advance_timeout_and_rounds(tiny_cell, monkeypatch):
    from tpustream_torch.runtime import executor

    programs = []
    plain = executor.build_program

    def build(plan, cfg):
        programs.append(plain(plan, cfg))
        return programs[-1]

    monkeypatch.setattr(executor, "build_program", build)
    res, r = run(tiny_cell(), seconds=0.5)
    assert res["correct"], res["check"]
    (prog,) = programs
    spans = prog.spans
    advance, timeout = spans.times_s["step.advance"], spans.times_s["step.timeout"]
    # one of each a step that saw records, and one timeout scan a step
    assert len(advance) == len(prog.rounds) == len(timeout)
    assert spans.counts["rounds"] == sum(prog.rounds) > 0
    # each channel appears once a block: one round a step
    assert set(prog.rounds) <= {0, 1}
    inner = sum(advance) + sum(timeout) + sum(spans.times_s["step.read"])
    assert inner <= sum(spans.times_s["dispatch"])


STAGE_READERS = ("build_s", "parse_us_per_event", "pack_us_per_event",
                 "step_ms", "d2h_syncs_per_step", "fetch_ms_per_step",
                 "emit_us_per_row")


def test_the_cells_readers_on_the_cpu(tiny_cell):
    res, r = run(tiny_cell(), seconds=2.0, trace=True)
    assert res["correct"], res["check"]
    m = res["metrics"]
    # a row is due about once in 4,096 events: emit reads where rows came
    want = set(STAGE_READERS) - (set() if r.count["records_emitted"]
                                 else {"emit_us_per_row"})
    for k in want:
        assert m[k]["value"] > 0, k
    # no device on the CPU: the device reader finds nothing, never 0
    assert set(m) == want
    assert r.stage["step_times_s"] > 0 and r.count["steps"] > 0


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("seed", [3, 2**31 + 7, 2**33 + 1])
def test_the_reference_in_a_lower_precision_is_not_correct(tiny_cell, seed, dtype):
    """The stated precision's control: the reference's sums in int32
    (three samples over 1.125e9 pass 2^31 and wrap) or float32 (rounded
    to 256 at that size), as rows through the harness's own sink and
    comparison, against the reference in int64."""
    cell = tiny_cell()
    ev = cell.traffic(seed).events(400)
    ref = cell.reference()
    want = ref.expected(ev, cell.config)
    low = ref.expected(ev, cell.config, sum_dtype=getattr(torch, dtype))
    assert low[1].dtype == want[1].dtype

    def sunk(cols):
        rows = Rows()
        emit = rows.sink()
        for row in zip(*[c.tolist() for c in cols]):
            emit(T.Tuple4(*row))
        return rows

    got = compare_rows(sunk(low), want)
    assert got["rows_due"] > 0
    if dtype == "int32":
        assert got["rows_wrong"] == got["rows_due"]
    assert got["rows_wrong"] > 0
    # the same rows in int64 are right
    assert compare_rows(sunk(want), want)["rows_wrong"] == 0


# ---------------------------------------------------------------------------
# the job


def lines_of(ts, key, value):
    tz = datetime.timezone(datetime.timedelta(hours=8))
    return [f"{datetime.datetime.fromtimestamp(t, tz):%Y-%m-%dT%H:%M:%S} "
            f"www.{k:07d}.com {v}"
            for t, k, v in zip(ts.tolist(), key.tolist(), value.tolist())]


def test_the_job_is_chapter_4_with_its_threshold():
    rng = np.random.default_rng(21)
    n = 600
    key = rng.integers(0, 8, n)
    ts = T0 + np.cumsum(rng.integers(0, 5, n))
    value = np.where(rng.random(n) < 0.6, HIGH + rng.integers(0, 10**8, n),
                     rng.integers(10**6, LOW + 1, n))
    lines = lines_of(ts, key, value)

    def rows(build):
        env = T.StreamExecutionEnvironment(StreamConfig(
            device="cpu", batch_size=64, key_capacity=16))
        env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
        out = build(env, env.add_source(ReplaySource(lines))).collect()
        env.execute("overload")
        return [tuple(r.values()) for r in out.items]

    mine = rows(overload.build)
    theirs = rows(lambda env, text: ch4.build(env, text, threshold=1_125_000_000))
    assert mine == theirs
    assert mine == ref_rows(ts, key, value) and len(mine) > 20


def test_benchmark_names_the_cell_and_its_readers():
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    (w,) = [w for w in m["workloads"] if w["name"] == CELL]
    assert (w["config"], w["chips"]) == ("cep_overload", 1)
    per = {p["name"]: p for p in m["per_layer"]}
    # the cell reads the stage and device metrics the other cells read,
    # under their names: none of its own
    mine = {n for n, p in per.items() if CELL in p.get("workloads", [CELL])}
    assert mine == set(STAGE_READERS) | {"device_idle_pct"}
    for name in mine:
        assert per[name]["workloads"][-1] == CELL
        assert (BENCH / "metrics" / f"{name}.py").is_file()
