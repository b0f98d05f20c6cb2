"""Count windows through the PyTorch port, on the CPU.

* The single-device cases of tests/test_count_windows.py (Flink's
  ``countWindow(N)`` fires per key every N elements in arrival order,
  partial windows never fire; ``countWindow(size, slide)`` fires every
  ``slide`` elements over the last ``size``), run through the port with
  ``device="cpu"`` against the same oracles and inputs.
* Side-by-side runs against the JAX package on seeded inputs, comparing
  rows, ``print()`` bytes and counters (tolerance: bitwise): tumbling and
  sliding ``reduce`` and ``aggregate`` and a ``process()``, at batch
  sizes 1, 3 and 64.
* Key growth past the initial capacity, and state carried across from
  the JAX package into the port mid-stream.
"""

import random
from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpustream
import tpustream_torch as T
from tests.test_count_windows import LINES, oracle_process, oracle_sliding_sum
from tpustream_torch.runtime.sources import ReplaySource


def parse(line):
    p = line.split(" ")
    return T.Tuple2(p[0], float(p[1]))


def _run(lines, n, slide=None, apply="reduce", fn=None, **cfg):
    cfg.setdefault("batch_size", 4)
    cfg.setdefault("key_capacity", 16)
    env = T.StreamExecutionEnvironment(T.StreamConfig(device="cpu", **cfg))
    w = env.add_source(ReplaySource(lines)).map(parse).key_by(0).count_window(n, slide)
    if apply == "reduce":
        out = w.reduce(lambda a, b: T.Tuple2(a.f0, a.f1 + b.f1))
    elif apply == "aggregate":
        out = w.aggregate(fn)
    else:
        out = w.process(fn)
    handle = out.collect()
    env.execute("count")
    return handle.items, env.metrics.summary()


def run_reduce(lines, n, **cfg):
    items, s = _run(lines, n, **cfg)
    return [(t.f0, t.f1) for t in items], s


def run_sliding_reduce(lines, size, slide, **cfg):
    items, s = _run(lines, size, slide, **cfg)
    return [(t.f0, t.f1) for t in items], s


def _lister(key, ctx, elements, out):
    out.collect(T.Tuple2(key, [e.f1 for e in elements]))


def run_process(lines, size, slide=None, **cfg):
    items, s = _run(lines, size, slide, apply="process", fn=_lister, **cfg)
    return [(t.f0, t.f1) for t in items], s


# ---------------------------------------------------------------------------
# tests/test_count_windows.py, through the port
# ---------------------------------------------------------------------------


def test_count_window_reduce_fires_every_n():
    rows, s = run_reduce(LINES, 3)
    assert ("a", 7.0) in rows
    assert ("a", 56.0) in rows
    assert ("b", 60.0) in rows
    assert len(rows) == 3              # partials (a:64, b:40) never fire
    assert s["window_fires"] == 3


def test_count_window_batch_invariance():
    expect, _ = run_reduce(LINES, 3)
    for bs in (1, 2, 11):
        rows, _ = run_reduce(LINES, 3, batch_size=bs)
        assert sorted(rows) == sorted(expect)


def test_count_window_runs_under_a_fire_budget():
    """``max_fires_per_step`` bounds time-window fires; a count window has
    no clock and no deferred fires, so its rows are the same."""
    expect, _ = run_reduce(LINES, 3)
    assert run_reduce(LINES, 3, max_fires_per_step=1)[0] == expect


def test_count_window_many_closes_per_batch_per_key():
    lines = [f"k {2 ** i}" for i in range(9)]
    rows, s = run_reduce(lines, 2, batch_size=16)
    assert rows == [("k", 3.0), ("k", 12.0), ("k", 48.0), ("k", 192.0)]
    assert s["window_fires"] == 4


class Avg(T.AggregateFunction):
    def create_accumulator(self):
        return T.Tuple2(0, 0.0)

    def add(self, value, acc):
        acc.f0 = acc.f0 + 1
        acc.f1 = acc.f1 + value.f1
        return acc

    def get_result(self, acc):
        return torch.where(torch.as_tensor(acc.f0) == 0, 0.0, acc.f1 / acc.f0)

    def merge(self, a, b):
        a.f0 = a.f0 + b.f0
        a.f1 = a.f1 + b.f1
        return a


def test_count_window_aggregate():
    items, _ = _run(["a 1", "a 3", "b 5", "a 10", "a 20"], 2, apply="aggregate",
                    fn=Avg(), batch_size=3)
    assert items == [2.0, 15.0]


def test_sliding_count_window_matches_oracle():
    rows, s = run_sliding_reduce(LINES, 3, 2)
    expect = oracle_sliding_sum(LINES, 3, 2)
    assert sorted(rows) == sorted(expect)
    assert s["window_fires"] == len(expect)


def test_sliding_count_window_partial_first_windows():
    lines = [f"k {2 ** i}" for i in range(7)]
    rows, _ = run_sliding_reduce(lines, 4, 2, batch_size=16)
    assert rows == oracle_sliding_sum(lines, 4, 2)


def test_sliding_count_window_batch_invariance_random():
    """tests/test_count_windows.py::test_sliding_count_window_batch_invariance_fuzz
    through the port (renamed: that name is in the suite's slow tier)."""
    rng = random.Random(7)
    lines = [f"{rng.choice('abcd')} {rng.randint(1, 9)}" for _ in range(60)]
    expect = oracle_sliding_sum(lines, 5, 3)
    for bs in (1, 4, 17, 64):
        rows, _ = run_sliding_reduce(lines, 5, 3, batch_size=bs)
        assert sorted(rows) == sorted(expect), f"batch_size={bs}"


def test_sliding_count_window_wraps_log_across_batches():
    lines = [f"k {i}" for i in range(1, 23)]
    rows, _ = run_sliding_reduce(lines, 4, 2, batch_size=3)
    assert rows == oracle_sliding_sum(lines, 4, 2)


def test_count_window_process_tumbling():
    rows, s = run_process(LINES, 3)
    expect = oracle_process(LINES, 3, 3)
    assert sorted(rows) == sorted(expect)
    assert s["window_fires"] == len(expect)


def test_count_window_process_sliding_elements_in_arrival_order():
    lines = [f"k {i}" for i in range(1, 12)]
    rows, _ = run_process(lines, 4, 2, batch_size=5)
    assert rows == oracle_process(lines, 4, 2)


def test_count_window_process_batch_invariance():
    rng = random.Random(3)
    lines = [f"{rng.choice('ab')} {rng.randint(1, 9)}" for _ in range(30)]
    expect = oracle_process(lines, 3, 2)
    for bs in (1, 7, 32):
        rows, _ = run_process(lines, 3, 2, batch_size=bs)
        assert sorted(rows) == sorted(expect)


# ---------------------------------------------------------------------------
# side by side with the JAX package
# ---------------------------------------------------------------------------


def _side_lines(seed, n=120):
    """``key value`` lines over 7 keys, skewed toward the first two, a
    float value with a fractional part."""
    rng = np.random.default_rng(seed)
    keys = np.minimum(rng.geometric(0.35, n) - 1, 6)
    vals = rng.standard_normal(n) * 1000
    return [f"h{k} {v:.4f}" for k, v in zip(keys.tolist(), vals.tolist())]


def _side_job(pkg, text, kind):
    def parse_line(line):
        p = line.split(" ")
        return pkg.Tuple2(p[0], float(p[1]))

    class Mean(pkg.AggregateFunction):
        def create_accumulator(self):
            return pkg.Tuple2(0, 0.0)

        def add(self, value, acc):
            return pkg.Tuple2(acc.f0 + 1, acc.f1 + value.f1)

        def get_result(self, acc):
            return acc.f1 / acc.f0

        def merge(self, a, b):
            return pkg.Tuple2(a.f0 + b.f0, a.f1 + b.f1)

    def lister(key, ctx, elements, out):
        out.collect(pkg.Tuple3(key, len(elements),
                               "/".join(repr(e.f1) for e in elements)))

    size, slide = {"tumbling": (5, None), "sliding": (6, 4)}.get(
        kind.split("-")[0], (4, 3))
    w = text.map(parse_line).key_by(0).count_window(size, slide)
    if kind.endswith("reduce"):
        return (w.reduce(lambda a, b: pkg.Tuple2(a.f0, a.f1 + b.f1))
                .map(lambda t: pkg.Tuple3(t.f0, t.f1, t.f1 * 0.5)))
    if kind.endswith("aggregate"):
        return w.aggregate(Mean())
    return w.process(lister)


def _side_run(pkg, kind, lines, capsys, key_capacity=8, **cfg):
    sources = import_module(pkg.__name__ + ".runtime.sources")
    if pkg is T:
        cfg["device"] = "cpu"
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(
        key_capacity=key_capacity, print_parallelism=2, **cfg))
    stream = _side_job(pkg, env.add_source(sources.ReplaySource(lines)), kind)
    h = stream.collect()
    stream.print()
    capsys.readouterr()
    env.execute("side")
    m = env.metrics.summary()
    return ([repr(t) for t in h.items], capsys.readouterr().out,
            {k: m[k] for k in ("window_fires", "alert_overflow", "records_emitted")})


SIDE_KINDS = ["tumbling-reduce", "tumbling-aggregate", "sliding-reduce",
              "sliding-aggregate", "process"]


@pytest.mark.parametrize("batch_size", [1, 3, 64])
@pytest.mark.parametrize("kind", SIDE_KINDS)
def test_side_by_side_with_jax_package(kind, batch_size, capsys):
    lines = _side_lines(batch_size)
    want = _side_run(tpustream, kind, lines, capsys, batch_size=batch_size)
    got = _side_run(T, kind, lines, capsys, batch_size=batch_size,
                    acc_dtype="int32" if kind == "tumbling-reduce" else "float64")
    assert len(want[0]) >= 15
    assert got[0] == want[0]
    assert got[1] == want[1]  # print() bytes
    assert got[2] == want[2]


@pytest.mark.parametrize("kind", ["tumbling-reduce", "sliding-aggregate", "process"])
def test_key_growth_past_the_initial_capacity(kind, capsys):
    """Eleven keys through a capacity of 2: the keyed state grows (rows
    carried over) and the rows equal a run with room for every key from
    the start, and the JAX package's."""
    lines = [f"h{i % 11} {l.split(' ')[1]}" for i, l in enumerate(_side_lines(5, 160))]
    small = _side_run(T, kind, lines, capsys, key_capacity=2, batch_size=7)
    big = _side_run(T, kind, lines, capsys, key_capacity=64, batch_size=7)
    ref = _side_run(tpustream, kind, lines, capsys, key_capacity=64, batch_size=7)
    assert len(ref[0]) > 20
    assert small == big == ref


# ---------------------------------------------------------------------------
# state carried across from the JAX package
# ---------------------------------------------------------------------------


def _program(pkg, kind, batch, key_capacity):
    plan_mod = import_module(pkg.__name__ + ".runtime.plan")
    step_mod = import_module(pkg.__name__ + ".runtime.step")
    records = import_module(pkg.__name__ + ".records")
    sources = import_module(pkg.__name__ + ".runtime.sources")
    cfg = dict(batch_size=batch, key_capacity=key_capacity)
    if pkg is T:
        cfg["device"] = "cpu"
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    _side_job(pkg, env.add_source(sources.ReplaySource([])), kind).collect()
    plan = plan_mod.build_plan(env, env._sinks)
    plan.record_kinds.extend(["str", "f64"])
    plan.tables.extend([records.StringTable(), None])
    for key in range(key_capacity):  # the key column's ids are the interned ids
        plan.tables[0].intern(f"h{key}")
    return step_mod.build_program(plan, env.config), plan


def _jax_rows(jprog, jplan, em, process):
    """One JAX step's emitted rows, as the executor orders them."""
    if process:
        rows = []
        jprog.evaluate_fires(None, em["process_fire"], jplan.device_post,
                             lambda item, *a, **k: rows.append(repr(item)))
        return rows
    main = em["main"]
    order, m = np.asarray(main["order"]), np.asarray(main["mask"])
    cols = [np.asarray(c) for c in main["cols"]]
    return [tuple(c[order[j]].item() for c in cols)
            for j in range(order.size) if m[order[j]]]


def _torch_rows(tprog, state, em, process):
    if process:
        rows = []
        tprog.evaluate_fires(state, em["process_fire"],
                             lambda item, subtask, *_: rows.append(repr(item)),
                             lambda ts: [t.numpy() for t in ts])
        return rows
    m = em["main"]["mask"].numpy()
    cols = [c.numpy() for c in em["main"]["cols"]]
    return [tuple(c[j].item() for c in cols) for j in np.nonzero(m)[0]]


@pytest.mark.parametrize("kind", ["tumbling-aggregate", "sliding-reduce", "process"])
def test_state_carried_across_from_the_jax_package(kind):
    """The JAX package runs k steps; its keyed state (numpy) moves into
    the port, which runs the rest: the rows equal the JAX package's full
    run, in order."""
    batch, kcap, k = 16, 6, 3
    process = kind == "process"
    jprog, jplan = _program(tpustream, kind, batch, kcap)
    tprog, _ = _program(T, kind, batch, kcap)
    jstep = jax.jit(jprog._step)
    rng = np.random.default_rng(2)
    feeds = [(rng.integers(0, kcap, batch).astype(np.int32),
              np.round(rng.standard_normal(batch) * 100, 3)) for _ in range(8)]
    jstate, want, got, carried = jprog.init_state(), [], [], None
    zero = jnp.zeros(batch, jnp.int64)
    for i, (keys, vals) in enumerate(feeds):
        if i == k:
            carried = jax.device_get(jstate)
        jstate, em = jstep(jstate, (jnp.asarray(keys), jnp.asarray(vals)),
                           jnp.ones(batch, bool), zero, jnp.asarray(0, jnp.int64))
        rows = _jax_rows(jprog, jplan, em, process)
        want += rows
        if i < k:
            got += rows
    state = tprog.state_from_jax_numpy(carried)
    for keys, vals in feeds[k:]:
        state, em = tprog.step(state, [torch.from_numpy(keys), torch.from_numpy(vals)],
                               torch.ones(batch, dtype=torch.bool))
        got += _torch_rows(tprog, state, em, process)
    assert len(want) > 10 and got == want
