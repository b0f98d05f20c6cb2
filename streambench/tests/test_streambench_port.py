"""The port on the CPU at a tiny size through the harness (a test-only
call: the command line refuses to run without a card): every row equal
to the reference; the configuration's control and each fault a cell can
have come out not correct."""

import copy

import pytest

from streambench.harness import Cell, run_cell

CELLS = ("bandwidth_eventtime.poll300s", "cpu_max.fleet128k")
SEED = 2**31 + 12345


def run(tiny, name, **kw):
    cell = Cell(name, tiny, tiny.parent / "streambench")
    kw.setdefault("seconds", 0.5)
    return run_cell(cell, SEED, device="cpu", log=lambda *a: None, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_every_row_equals_the_reference(tiny, name):
    res, r = run(tiny, name)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"events_per_s", "setup_s"}
    assert r.events > 0 and r.window_s >= 0.5
    assert list(res)[-1] == "check"
    assert all(c["limit"] == 0 for c in res["check"].values())


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_stage_metrics(tiny, name):
    res, r = run(tiny, name, trace=True)
    assert res["correct"], res["check"]
    m = res["metrics"]
    for k in ("build_s", "parse_us_per_event", "pack_us_per_event",
              "step_ms", "d2h_syncs_per_step", "fetch_ms_per_step",
              "emit_us_per_row"):
        assert m[k]["value"] > 0, k
    # no device on the CPU: the device readers find nothing, never 0
    assert "device_idle_pct" not in m and "seq_rolling_roofline" not in m
    assert res["device"]["window_s"] > 0
    stages = {n for n, _ in res["breakdown"]["idle_gaps"]}
    assert {"parse", "step", "emit"} <= stages
    assert r.stage["host_times_s"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny, name):
    """The configuration's control, the program's own lower-precision
    path (int32 pane sums; a float32 max), put in the program's place."""
    res, _ = run(tiny, name, control=True)
    assert not res["correct"]
    assert res["check"]["rows_wrong"]["value"] > 0


def state_unchanged(monkeypatch):
    from tpustream_torch.runtime.step import BaseProgram

    plain = BaseProgram.run_step

    def run_step(self, state, *a, **k):
        before = copy.deepcopy(state)
        _, emissions = plain(self, state, *a, **k)
        return before, emissions

    monkeypatch.setattr(BaseProgram, "run_step", run_step)


def half_batch(monkeypatch):
    from tpustream_torch.runtime.executor import Runner

    plain = Runner.feed

    def feed(self, batch, *a, **k):
        return plain(self, batch.slice_rows(0, batch.n // 2), *a, **k)

    monkeypatch.setattr(Runner, "feed", feed)


def answer_altered(monkeypatch):
    from tpustream_torch.api.tuples import make_tuple
    from tpustream_torch.runtime.sinks import EmissionFormatter

    plain = EmissionFormatter.rows
    done = []

    def rows(self, cols):
        for row in plain(self, cols):
            if not done:
                done.append(row)
                vals = row.values()
                row = make_tuple(*vals[:-1], vals[-1] + 1.0)
            yield row

    monkeypatch.setattr(EmissionFormatter, "rows", rows)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, name, fault):
    """The rest of a run over a timed path broken underneath: a step
    that returns its state unchanged, half of each batch left out, one
    answer altered where it is produced. (One chip: no exchange between
    chips to leave out.)"""
    FAULTS[fault](monkeypatch)
    res, _ = run(tiny, name)
    assert not res["correct"]
    assert res["check"]["rows_wrong"]["value"] > 0
