"""Dead-letter quarantine in the PyTorch port (``StreamConfig.dead_letter``),
on the CPU, against the JAX package: the unsupervised quarantine cases of
tests/test_recovery.py. A batch that fails to parse is re-parsed line by
line; the lines that parse feed the device as one batch, the rest land in
``env.dead_letters`` as ``(line, "Type: message")`` up to
``dead_letter_capacity``, and ``records_quarantined`` keeps counting past
it. An injected parse fault models a crash and escalates. Tolerance:
identical rows, dead letters and counters in both packages."""

import pytest

import tpustream_torch
from tests.test_torch_chains import PKGS, run_job
from tpustream_torch.testing import (
    FaultInjected,
    FaultInjector,
    FaultPoint,
    poison_lines,
)

LINES = [
    f"15634520{i:02d} 10.8.22.{i % 3} cpu{i % 2} {50 + (i * 31) % 47}.5"
    for i in range(24)
]


def job(name):
    def build(ns, text):
        import importlib

        return importlib.import_module(
            f"{ns.pkg.__name__}.jobs.{name}").build(None, text)
    return build


def run(side, lines, name="chapter2_max", event_time=False, **cfg):
    """One package's run: ``(rows, dead letters, summary)``."""
    ns = PKGS[side]
    env = ns.pkg.StreamExecutionEnvironment(ns.pkg.StreamConfig(**cfg, **ns.cfg))
    if event_time:
        env.set_stream_time_characteristic(ns.pkg.TimeCharacteristic.EventTime)
    h = job(name)(ns, env.add_source(ns.sources.ReplaySource(lines))).collect()
    env.execute("dead-letters")
    return ([repr(t) for t in h.items], getattr(env, "dead_letters", None),
            env.metrics.summary())


def test_poison_quarantine_chapter1():
    clean = [
        "1563452051 10.8.22.1 cpu2 10.5",
        "1563452051 10.8.22.1 cpu2 99.2",
        "1563452052 10.8.22.3 cpu1 95.0",
    ]
    want, _, _ = run("torch", clean, "chapter1_threshold")
    poisoned, n = poison_lines(clean, count=2, seed=7)
    got, dead, s = run("torch", poisoned, "chapter1_threshold",
                       dead_letter=True)
    assert got == want
    assert n == 2 and len(dead) == 2 and s["records_quarantined"] == 2
    for line, err in dead:
        assert "poison" in line and err  # (line, reason) pairs
    jgot, jdead, js = run("jax", poisoned, "chapter1_threshold",
                          dead_letter=True)
    assert (got, dead, s["records_quarantined"]) == (
        jgot, jdead, js["records_quarantined"])


def test_poison_quarantine_chapter3_eventtime():
    clean = [
        "2019-08-28T09:00:00 www.163.com 1000",
        "2019-08-28T09:02:00 www.163.com 2000",
        "2019-08-28T09:03:00 www.163.com 3000",
        "2019-08-28T09:05:00 www.163.com 4000",
        "2019-08-28T09:07:00 www.163.com 500",
    ]
    name = "chapter3_bandwidth_eventtime"
    want, _, _ = run("torch", clean, name, event_time=True, batch_size=2)
    poisoned, n = poison_lines(clean, count=3, seed=3)
    got, dead, _ = run("torch", poisoned, name, event_time=True,
                       batch_size=2, dead_letter=True)
    assert got == want and want
    assert len(dead) == n == 3
    jgot, jdead, _ = run("jax", poisoned, name, event_time=True,
                         batch_size=2, dead_letter=True)
    assert (got, dead) == (jgot, jdead)


def test_quarantine_capacity_bounds_dead_letters():
    poisoned, n = poison_lines(list(LINES), count=3, seed=5)
    got, dead, s = run("torch", poisoned, batch_size=4, dead_letter=True,
                       dead_letter_capacity=1)
    want, _, _ = run("torch", LINES, batch_size=4)
    assert got == want
    assert len(dead) == 1
    assert s["records_quarantined"] == n == 3
    jgot, jdead, js = run("jax", poisoned, batch_size=4, dead_letter=True,
                          dead_letter_capacity=1)
    assert (got, dead, s["records_quarantined"]) == (
        jgot, jdead, js["records_quarantined"])


def test_injected_parse_fault_escalates_past_quarantine():
    inj = FaultInjector(FaultPoint("parse", at=2))
    cfg = inj.install(tpustream_torch.StreamConfig(
        device="cpu", batch_size=4, dead_letter=True))
    env = tpustream_torch.StreamExecutionEnvironment(cfg)
    ns = PKGS["torch"]
    job("chapter2_max")(ns, env.add_source(ns.sources.ReplaySource(LINES))).collect()
    with pytest.raises(FaultInjected):
        env.execute("parse-fault")
    assert inj.fired == 1


def test_batch_level_error_re_raises():
    """A batch that fails only as a whole (every line parses alone) is
    not bad data: quarantine re-raises its error."""
    def build(ns, text):
        seen = []

        def parse(line):
            seen.append(line)
            if len(seen) == 6:  # the second batch's second line, once
                raise ValueError("batch-level failure")
            p = line.split(" ")
            return ns.pkg.Tuple2(p[1], float(p[3]))
        return text.map(parse).key_by(0).max(1)

    with pytest.raises(ValueError, match="batch-level"):
        run_job("torch", build, LINES, event_time=False, batch_size=4,
                dead_letter=True)


def test_dead_letters_on_raw_bytes_through_the_native_parser():
    """A raw byte buffer with a malformed line fails the native parse as
    a whole: it is decoded, re-parsed line by line, and only the bad
    line is quarantined."""
    poisoned, n = poison_lines(list(LINES), count=2, seed=11)
    got, _ = run_job("torch", job("chapter2_max"), poisoned,
                     event_time=False, batch_size=4, raw_batch=4,
                     dead_letter=True)
    want, _ = run_job("torch", job("chapter2_max"), LINES, event_time=False,
                      batch_size=4)
    jgot, _ = run_job("jax", job("chapter2_max"), poisoned, event_time=False,
                      batch_size=4, raw_batch=4, dead_letter=True)
    assert got == want == jgot
