"""The port's span recorder (``tpustream_torch/runtime/spans.py``), on
the CPU: one recorder a job (``Metrics.spans``) times the stages and
their parts, counts the window ends folded, feeds the obs ring under
its own kinds, and opens ``torch.profiler`` ranges only while a capture
records.

* A small chapter-3 event-time job records every stage span, every
  sub-span and ``fires``; a chapter-4 job records its reads; a sharded
  job's shards record into the job's recorder.
* ``fires`` equals the window ends due on the input, counted by hand.
* Each job's sub-spans fit inside their stage: ``step.merge`` +
  ``step.fold`` + ``step.read`` within the step times, ``emit.format`` +
  ``emit.sink`` within the emit times, ``parse.native`` +
  ``parse.intern`` within the parse times.
* The rows are the same with and without a ``torch.profiler`` capture;
  the capture names the spans; without one no range is entered.
* The obs ring holds the stage spans' own intervals and no sub-span.
* A program called directly holds the null twin; handed a recorder, its
  ``fires`` equals the window ends its rows carry.
"""

import numpy as np
import pytest
import torch

import tpustream_torch as T
from tpustream_torch import native
from tpustream_torch.config import ObsConfig, StreamConfig
from tpustream_torch.jobs import chapter4_cep_alert as ch4
from tpustream_torch.jobs.chapter3_bandwidth_eventtime import build as build_et
from tpustream_torch.runtime.sources import ReplaySource
from tpustream_torch.runtime.spans import NULL_SPANS, SpanRecorder

SIZE_S, SLIDE_S = 300, 5  # the chapter-3 job's window

STAGES = ("parse", "pack", "dispatch", "fetch", "emit")
SUB_SPANS = ("step.merge", "step.fold", "step.read", "emit.format",
             "emit.sink", "parse.native", "parse.intern", "build.program",
             "build.state")


def _lines(offsets_s):
    """Chapter-3 lines at ``offsets_s`` seconds after midnight."""
    return [f"2020-01-01T{s // 3600:02d}:{s // 60 % 60:02d}:{s % 60:02d} "
            f"ch{s % 3} {1234567 + 997 * (s % 60)}" for s in offsets_s]


STEADY = list(range(720))  # one line a second for 12 minutes
# an hour's gap mid-stream: the ring sweeps past it
GAP = list(range(300)) + list(range(3900, 4200))


def _run(offsets, obs=False, profile=False, **cfg):
    kw = dict(batch_size=64, key_capacity=64, device="cpu",
              obs=ObsConfig(enabled=obs))
    kw.update(cfg)
    env = T.StreamExecutionEnvironment(StreamConfig(**kw))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    out = build_et(env, env.add_source(ReplaySource(_lines(offsets)))).collect()
    prof = None
    if profile:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            env.execute("spans")
    else:
        env.execute("spans")
    return env.metrics, out.items, prof


def _ends_by_hand(offsets):
    """Window ends with a record in their window, seconds after
    midnight: every ``SLIDE_S``-aligned end in ``(t, t + SIZE_S]``. The
    end of the stream fires them all."""
    ends = set()
    for t in offsets:
        first = (t // SLIDE_S + 1) * SLIDE_S
        ends.update(range(first, t + SIZE_S + 1, SLIDE_S))
    return ends


def _total(m, name):
    return sum(m.spans.times_s.get(name, ()))


def test_an_event_time_job_records_every_span_and_fires():
    assert native.available(), native.build_error()
    m, rows, _ = _run(STEADY)
    assert rows
    spans = m.spans.times_s
    for name in STAGES + SUB_SPANS:
        assert spans.get(name), name
        assert all(d >= 0 for d in spans[name]), name
    assert m.fires > 0
    # once a step, a fire or a batch: the stage spans once a batch or
    # step, the fold once an end, never once a row
    assert len(spans["dispatch"]) == m.steps
    assert len(spans["step.fold"]) >= m.fires
    assert len(spans["emit.sink"]) <= m.steps
    assert len(spans["build.program"]) == len(spans["build.state"]) == 1
    # the stage lists keep their own sizes
    assert len(m.step_times_s) == m.steps
    assert len(m.host_times_s) == len(spans["parse"])


@pytest.mark.parametrize("offsets", [STEADY, GAP], ids=["steady", "gap"])
def test_fires_counts_the_window_ends_folded(offsets):
    m, _, _ = _run(offsets)
    assert m.fires == len(_ends_by_hand(offsets))
    if offsets is GAP:
        # the sweep merges in more than one pass on the step over the gap
        assert len(m.spans.times_s["step.merge"]) > m.steps


@pytest.mark.parametrize("offsets", [STEADY, GAP], ids=["steady", "gap"])
def test_sub_spans_fit_inside_their_stage(offsets):
    m, _, _ = _run(offsets)
    step = (_total(m, "step.merge") + _total(m, "step.fold")
            + _total(m, "step.read"))
    assert 0 < step <= sum(m.step_times_s)
    assert step <= _total(m, "dispatch")
    emit = _total(m, "emit.format") + _total(m, "emit.sink")
    assert 0 < emit <= sum(m.emit_times_s)
    parse = _total(m, "parse.native") + _total(m, "parse.intern")
    assert 0 < parse <= sum(m.host_times_s)


def test_rows_are_the_same_under_a_profiler_capture():
    _, plain, _ = _run(STEADY)
    m, profiled, _ = _run(STEADY, profile=True)
    assert plain and profiled == plain
    assert m.fires == len(_ends_by_hand(STEADY))


def test_a_capture_names_the_spans_and_no_capture_enters_no_range(monkeypatch):
    entered = []
    plain = torch.profiler.record_function

    class Counting(plain):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    # the recorder binds record_function when a job's Metrics is made
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    _run(STEADY)
    assert entered == []
    _, _, prof = _run(STEADY, profile=True)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    for name in STAGES + SUB_SPANS:
        assert f"tpustream.{name}" in names, name
    assert {n[len("tpustream."):] for n in entered} >= set(STAGES + SUB_SPANS)


def test_the_obs_ring_holds_the_stage_spans_and_no_sub_span():
    m, _, _ = _run(STEADY, obs=True)
    tracer = m.job_obs.tracer
    ring = tracer.raw_tail(tracer.capacity)
    assert tracer.total_spans == len(ring)  # nothing dropped
    kinds = {k for k, *_ in ring}
    assert kinds <= set(STAGES) | {"h2d"}
    assert set(STAGES) <= kinds
    for kind in kinds:
        got = [d for k, _, _, _, d in ring if k == kind]
        assert got == m.spans.times_s[kind], kind
    # the runner's spans carry its operator and step, the parse spans none
    assert {op for k, _, op, _, _ in ring if k == "dispatch"} == {"window"}
    assert [s for k, s, *_ in ring if k == "dispatch"] == list(
        range(1, m.steps + 1))
    assert {op for k, _, op, _, _ in ring if k == "parse"} == {""}


def test_obs_on_and_off_give_the_same_spans_and_rows():
    off, rows_off, _ = _run(STEADY)
    on, rows_on, _ = _run(STEADY, obs=True)
    assert rows_on == rows_off
    assert on.fires == off.fires
    assert ({n: len(v) for n, v in on.spans.times_s.items()}
            == {n: len(v) for n, v in off.spans.times_s.items()})
    assert on.d2h_syncs == off.d2h_syncs


def test_a_sharded_job_records_into_the_jobs_recorder():
    one, rows_one, _ = _run(STEADY)
    two, rows_two, _ = _run(STEADY, parallelism=2)
    assert sorted(map(repr, rows_two)) == sorted(map(repr, rows_one))
    # every shard folds every due end over its own keys
    assert two.fires == 2 * one.fires
    assert len(two.spans.times_s["step.fold"]) >= two.fires
    assert two.spans.times_s["step.read"]


def test_a_cep_job_records_its_reads():
    lines = _lines(range(0, 1200, 7))
    env = T.StreamExecutionEnvironment(StreamConfig(
        device="cpu", batch_size=32, key_capacity=64))
    env.set_stream_time_characteristic(T.TimeCharacteristic.EventTime)
    ch4.build(env, env.add_source(ReplaySource(lines))).collect()
    env.execute("cep")
    m = env.metrics
    reads = m.spans.times_s["step.read"]
    assert reads and len(reads) <= m.d2h_syncs
    assert sum(reads) <= sum(m.step_times_s)
    assert m.fires == 0  # no window program


def test_a_direct_program_call_holds_the_null_twin():
    from tests.test_torch_chapter3 import _step_rows, build_program_for

    prog = build_program_for(SIZE_S, SLIDE_S, 60, "float64", 16, 64)
    assert prog.spans is NULL_SPANS
    base = 1_577_808_000_000  # 5 s aligned
    batches = [[(base + 1000 * (64 * b + j), j % 3, 1000 + j)
                for j in range(64)] for b in range(12)]

    def run(p):
        state, got = p.init_state(), []
        for recs in batches:
            state, rows = _step_rows(p, state, recs, -(2**62))
            got += rows
        state, rows = _step_rows(p, state, [(0, 0, 0)] * 64, 2**62,
                                 valid=False)
        return got + rows

    plain = run(prog)
    assert plain and NULL_SPANS.times_s == {} and NULL_SPANS.counts == {}
    with NULL_SPANS.span("step.fold") as s:
        pass
    assert not hasattr(s, "elapsed")
    # handed a recorder, the same program times its parts and counts
    # each end it folds: every end with a record emits rows
    rec = SpanRecorder()
    prog2 = build_program_for(SIZE_S, SLIDE_S, 60, "float64", 16, 64)
    prog2.spans = rec
    assert run(prog2) == plain
    assert rec.counts["fires"] == len({end for _, end, _ in plain})
    assert len(rec.times_s["step.fold"]) >= rec.counts["fires"]
    assert rec.times_s["step.merge"] and rec.times_s["step.read"]
    ts = np.asarray([r[0] for b in batches for r in b]) - base
    assert rec.counts["fires"] == len(_ends_by_hand(ts // 1000))


@pytest.mark.parametrize("parallelism", [1, 2])
def test_emit_in_chunks_keeps_rows_and_subtasks(monkeypatch, capsys,
                                                 parallelism):
    """The emit formats and sinks a step's rows a chunk at a time; a
    chunk far smaller than a step gives the same printed lines, subtask
    prefixes and order, and one ``emit.format`` and ``emit.sink`` span a
    step."""
    from tpustream_torch.jobs import chapter2_max as ch2
    from tpustream_torch.runtime import executor

    lines = [f"{1563452000 + i // 40} 10.0.{i % 7}.{i % 5} cpu{i % 4} "
             f"{(i * 37) % 100}.{i % 10}" for i in range(400)]

    def printed():
        env = T.StreamExecutionEnvironment(StreamConfig(
            device="cpu", batch_size=64, key_capacity=64,
            parallelism=parallelism, print_parallelism=4))
        ch2.build(env, env.add_source(ReplaySource(lines))).print()
        capsys.readouterr()
        env.execute("max")
        return capsys.readouterr().out.splitlines(), env.metrics

    whole, _ = printed()
    monkeypatch.setattr(executor, "EMIT_CHUNK", 3)
    chunked, m = printed()
    assert len(whole) == len(lines) and chunked == whole
    # keyed rows print under their key's subtask
    assert ({ln.split(">")[0] for ln in whole}
            == {str(s + 1) for s in range(parallelism)})
    spans = m.spans.times_s
    assert len(spans["emit.format"]) == len(spans["emit.sink"]) == m.steps
