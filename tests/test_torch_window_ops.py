"""The PyTorch port's window ops against the JAX package's, on the CPU:
pane arithmetic, ring retarget and compaction (``ops/panes.py``), the
stable sort and the segmented scan (``ops/segments.py``), the 32-bit
word planes (``ops/wordplanes.py``), the liveness decisions
(``ops/liveness.py``) and the float64 record functions
(``runtime/device.py``). The same seeded numpy inputs go through both;
every comparison is bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpustream
import tpustream.ops.panes as jpanes
import tpustream.ops.segments as jseg
import tpustream.ops.wordplanes as jwords
import tpustream_torch
import tpustream_torch.ops.panes as tpanes
import tpustream_torch.ops.segments as tseg
import tpustream_torch.ops.wordplanes as twords
from tpustream_torch.ops import liveness as tliveness
from tpustream_torch.runtime.device import DeviceChain

SPECS = [(300_000, 5_000, 60_000), (60_000, 60_000, 1), (20_000, 5_000, 0)]


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


def _specs(size, slide, delay):
    return (tpanes.make_ring_spec(size, slide, delay, 0),
            jpanes.make_ring_spec(size, slide, delay, 0))


@pytest.mark.parametrize("size,slide,delay", SPECS)
def test_ring_spec_and_slot_targets(size, slide, delay):
    ts, js = _specs(size, slide, delay)
    assert tuple(ts) == tuple(js)
    for hi in (-1, 0, 3, ts.n_slots - 1, ts.n_slots, 1000, 341_934_720):
        _same(tpanes.slot_targets(hi, ts),
              jpanes.slot_targets(jnp.asarray(hi, jnp.int64), js))


@pytest.mark.parametrize("size,slide,delay", SPECS)
def test_pane_of_last_end_and_late_mask(size, slide, delay):
    rng = np.random.default_rng(1)
    ts_np = np.concatenate([
        rng.integers(-400_000, 400_000, 200),
        1_566_957_600_000 + rng.integers(-900_000, 900_000, 200),
    ]).astype(np.int64)
    t, j = torch.from_numpy(ts_np), jnp.asarray(ts_np)
    tspec, jspec = _specs(size, slide, delay)
    _same(tpanes.pane_of(t, tspec.pane_ms), jpanes.pane_of(j, jspec.pane_ms))
    _same(tpanes.last_window_end(t, tspec), jpanes.last_window_end(j, jspec))
    for wm in (-(2**62), -1, 0, 1_566_957_600_000):
        _same(tpanes.late_mask(t, wm, 0, tspec),
              jpanes.late_mask(j, jnp.asarray(wm, jnp.int64), 0, jspec))


@pytest.mark.parametrize("hi0,hi,wm", [
    (-1, 5, -(2**62)),        # cold start: every slot virgin
    (40, 60, 10),             # some stale slots already fired
    (40, 60, -(2**62)),       # stale slots unfired: evicted counts
    (100, 100, 0),            # no move: nothing stale
    (100, 500, 10**9),        # the whole ring turns over
])
def test_retarget_rows(hi0, hi, wm):
    tspec, jspec = _specs(20_000, 5_000, 0)
    n, k = tspec.n_slots, 16
    rng = np.random.default_rng(hi0 + 7)
    planes = [rng.integers(-1000, 1000, (n, k)).astype(np.int32) for _ in range(2)]
    cnt = rng.integers(0, 3, (n, k)).astype(np.int32)
    slot_pane = tpanes.slot_targets(hi0, tspec)
    inits = [0, -7]
    tp, tc, tt, tev = tpanes.retarget_rows(
        [torch.from_numpy(p.copy()) for p in planes],
        torch.from_numpy(cnt.copy()), slot_pane, hi, wm, tspec, inits)
    jp, jc, jt, jev = jpanes.retarget_rows(
        [jnp.asarray(p) for p in planes], jnp.asarray(cnt),
        jnp.asarray(slot_pane), jnp.asarray(hi, jnp.int64),
        jnp.asarray(wm, jnp.int64), jspec,
        [jnp.asarray(v, jnp.int32) for v in inits])
    for a, b in zip(tp + [tc], list(jp) + [jc]):
        _same(a, b)
    _same(tt, jt)
    assert int(tev) == int(jev)


@pytest.mark.parametrize("n,capacity,count", [
    (50, 64, 0), (50, 16, 0), (50, 16, 10), (50, 16, 16), (1000, 300, 250),
    (10, 16, 12), (10, 16, 3),
])
def test_append_compact_and_compact(n, capacity, count):
    rng = np.random.default_rng(n + capacity + count)
    mask = rng.random(n) < 0.4
    src = [rng.integers(-9, 9, n).astype(np.int64), rng.random(n)]
    out = [rng.integers(-9, 9, capacity).astype(np.int64), rng.random(capacity)]
    t_out, t_cnt, t_ovf = tpanes.append_compact(
        torch.from_numpy(mask), [torch.from_numpy(s) for s in src],
        [torch.from_numpy(o.copy()) for o in out],  # written in place
        torch.tensor(count, dtype=torch.int32), capacity)
    j_out, j_cnt, j_ovf = jpanes.append_compact(
        jnp.asarray(mask), [jnp.asarray(s) for s in src],
        [jnp.asarray(o) for o in out], jnp.asarray(count, jnp.int32), capacity)
    for a, b in zip(t_out, j_out):
        _same(a, b)
    _same(t_cnt, j_cnt)
    _same(t_ovf, j_ovf)
    got = tpanes.compact(torch.from_numpy(mask), [torch.from_numpy(s) for s in src],
                         capacity)
    want = jpanes.compact(jnp.asarray(mask), [jnp.asarray(s) for s in src], capacity)
    for a, b in zip(got[:3], want[:3]):
        _same(a, b)
    for a, b in zip(got[3], want[3]):
        _same(a, b)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1001])
@pytest.mark.parametrize("max_key", [40, None])
def test_sort_by_key_tails_and_ranks(n, max_key):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 40, n).astype(np.int32 if max_key else np.int64)
    valid = rng.random(n) < 0.8
    got = tseg.sort_by_key(torch.from_numpy(keys), torch.from_numpy(valid), max_key)
    want = jax.jit(jseg.sort_by_key, static_argnums=2)(
        jnp.asarray(keys), jnp.asarray(valid), max_key)
    _same(got[0], np.asarray(want[0]).astype(np.int64))  # perm
    for a, b in zip(got[1:], want[1:]):
        _same(a, b)
    _same(tseg.segment_tails(got[3]), jseg.segment_tails(want[3]))
    _same(tseg.segment_ranks(got[3]), jseg.segment_ranks(want[3]))


def _combiners():
    return {
        "int_add": (lambda a, b: (a[0] + b[0],), lambda a, b: (a[0] + b[0],),
                    lambda r, n: r.integers(-10**6, 10**6, n).astype(np.int64)),
        "max": (lambda a, b: (torch.maximum(a[0], b[0]),),
                lambda a, b: (jnp.maximum(a[0], b[0]),),
                lambda r, n: r.integers(-10**6, 10**6, n).astype(np.int64)),
        # float add: bitwise only if the combination order is jax's own
        "float_add": (lambda a, b: (a[0] + b[0],), lambda a, b: (a[0] + b[0],),
                      lambda r, n: r.standard_normal(n) * 10 ** r.integers(0, 12, n)),
    }


@pytest.mark.parametrize("name", ["int_add", "max", "float_add"])
@pytest.mark.parametrize("n", [1, 2, 3, 8, 77, 1000])
def test_segmented_scan_bitwise(name, n):
    tcomb, jcomb, make = _combiners()[name]
    rng = np.random.default_rng(n)
    keys = rng.integers(0, max(1, n // 6), n).astype(np.int32)
    valid = rng.random(n) < 0.9
    vals = make(rng, n)
    _, _, _, tstarts = tseg.sort_by_key(torch.from_numpy(keys), torch.from_numpy(valid), 64)
    # the JAX package runs both inside its jitted step
    _, _, _, jstarts = jax.jit(jseg.sort_by_key, static_argnums=2)(
        jnp.asarray(keys), jnp.asarray(valid), 64)
    (got,) = tseg.segmented_scan((torch.from_numpy(vals),), tstarts, tcomb)
    (want,) = jax.jit(jseg.segmented_scan, static_argnums=2)(
        (jnp.asarray(vals),), jstarts, jcomb)
    _same(got, want)


def test_segmented_scan_float_add_is_not_a_left_fold():
    # the check above can tell orders apart: a sequential per-segment
    # sum of these values differs from jax's tree order in some bits
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(1000) * 10 ** rng.integers(0, 12, 1000)
    starts = np.zeros(1000, bool)
    starts[0] = True
    (got,) = tseg.segmented_scan((torch.from_numpy(vals),),
                                 torch.from_numpy(starts), lambda a, b: (a[0] + b[0],))
    assert not np.array_equal(got.numpy(), np.cumsum(vals))


@pytest.mark.parametrize("compact32", [False, True, [True, False, False, False],
                                       [False, True, False, False]])
def test_wordplanes_compact32(compact32):
    from tpustream.records import BOOL, F64, I64, STR

    kinds = [I64, F64, STR, BOOL]
    rng = np.random.default_rng(5)
    cols = [
        np.concatenate([rng.integers(-2**62, 2**62, 60), [2**31, -2**31 - 1, 2**32 + 5, -1]]),
        rng.standard_normal(64) * 1e40,
        rng.integers(-1, 1000, 64).astype(np.int32),
        rng.random(64) < 0.5,
    ]
    tw = twords.plane_dtypes(kinds, compact32)
    jw = jwords.plane_dtypes(kinds, compact32)
    assert [str(d).removeprefix("torch.") for d in tw] == [d.name for d in jw]
    assert twords.leaf_plane_slices(kinds, compact32) == \
        jwords.leaf_plane_slices(kinds, compact32)
    tp = twords.pack_words([torch.from_numpy(c) for c in cols], kinds, compact32)
    jp = jwords.pack_words([jnp.asarray(c) for c in cols], kinds, compact32)
    for a, b in zip(tp, jp):
        _same(a, b)
    for a, b in zip(twords.unpack_words(tp, kinds, compact32),
                    jwords.unpack_words(jp, kinds, compact32)):
        _same(a, b)


# -- liveness: the port's torch-graph decisions against the jaxpr ones --

def _window_program(pkg, reduce_fn, post, acc_dtype):
    from tpustream_torch.records import StringTable as TTable
    from tpustream.records import StringTable as JTable

    if pkg is tpustream:
        from tpustream.runtime.plan import build_plan
        from tpustream.runtime.sources import ReplaySource
        from tpustream.runtime.step import build_program
        cfg = tpustream.StreamConfig(acc_dtype=acc_dtype, key_capacity=16)
        table = JTable
    else:
        from tpustream_torch.runtime.plan import build_plan
        from tpustream_torch.runtime.sources import ReplaySource
        from tpustream_torch.runtime.step import build_program
        cfg = tpustream_torch.StreamConfig(acc_dtype=acc_dtype, key_capacity=16,
                                           device="cpu")
        table = TTable
    env = pkg.StreamExecutionEnvironment(cfg)
    stream = (
        env.add_source(ReplaySource([]))
        .map(lambda l: pkg.Tuple3(int(l.split(" ")[0]), l.split(" ")[1],
                                  int(l.split(" ")[2])))
        .key_by(1)
        .time_window(pkg.Time.seconds(10))
        .reduce(reduce_fn)
    )
    for op, fn in post:
        stream = getattr(stream, op)(fn)
    stream.collect()
    plan = build_plan(env, env._sinks)
    if not plan.record_kinds:
        plan.record_kinds.extend(["i64", "str", "i64"])
        plan.tables.extend([None, table(), None])
    return build_program(plan, cfg)


def _cases(pkg):
    T3, T2 = pkg.Tuple3, pkg.Tuple2
    mx = torch.maximum if pkg is tpustream_torch else jnp.maximum
    mbps = [("map", lambda t: T2(t.f1, t.f2 * 8.0 / 60 / 1024 / 1024)),
            ("filter", lambda t: t.f1 < 100.0)]
    return {
        "flagship": (lambda a, b: T3(a.f0, a.f1, a.f2 + b.f2), mbps),
        "passthrough_key_from_b": (lambda a, b: T3(a.f0, b.f1, a.f2 + b.f2), mbps),
        "max": (lambda a, b: T3(a.f0, a.f1, mx(a.f2, b.f2)), mbps),
        "dead_leaf": (lambda a, b: T3(a.f0, a.f1, a.f2 + b.f2),
                      [("map", lambda t: t.f1)]),
        "reads_both_leaves": (lambda a, b: T3(a.f0 + b.f0, a.f1, a.f2 + b.f0), mbps),
    }


@pytest.mark.parametrize("acc_dtype", ["float64", "int32"])
@pytest.mark.parametrize("case", ["flagship", "passthrough_key_from_b", "max",
                                  "dead_leaf", "reads_both_leaves"])
def test_liveness_decisions_equal_the_jax_package(case, acc_dtype):
    progs = [_window_program(pkg, *_cases(pkg)[case], acc_dtype)
             for pkg in (tpustream, tpustream_torch)]
    want, got = progs
    for attr in ("live_idx", "key_leaf", "stored_idx", "stored_ops",
                 "compact32", "fast_reduce"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert [str(d).removeprefix("torch.") for d in got.plane_dtypes] == \
        [np.dtype(d).name for d in want.plane_dtypes]


def test_liveness_refuses_a_combiner_it_cannot_trace():
    # Python control flow on a traced value: make_jaxpr refuses it, and
    # so does the port, instead of storing every leaf
    def branchy(a, b):
        return a if bool(a.f2 > b.f2) else b

    with pytest.raises(Exception):
        _window_program(tpustream, branchy, [], "float64")
    with pytest.raises(Exception, match="data-dependent|Could not guard"):
        _window_program(tpustream_torch, branchy, [], "float64")


def test_used_inputs_and_algebraic_ops_directly():
    d = [torch.tensor(0, dtype=torch.int64)] * 3
    assert tliveness.used_inputs(lambda a, b, c: (a + c,), d) == {0, 2}
    ops = tliveness.leaf_algebraic_ops(
        lambda a0, a1, b0, b1: (torch.minimum(b0, a0), a1 + a1), d[:2], 2)
    assert ops == ["min", None]


# -- float64 record functions -------------------------------------------

def test_mbps_is_float64_and_bit_equal_to_the_jax_package():
    from tpustream.records import StringTable as JTable
    from tpustream.runtime.device import DeviceChain as JChain
    from tpustream_torch.records import StringTable

    ops = _cases(tpustream_torch)["flagship"][1]
    jops = _cases(tpustream)["flagship"][1]
    rng = np.random.default_rng(11)
    sums = np.concatenate([rng.integers(1, 10**12, 2000), [1, 3, 7, 10000, 11200]])
    ids = np.arange(sums.size, dtype=np.int32)
    assert torch.get_default_dtype() == torch.float32  # torch's own default
    chain = DeviceChain(ops, ["i64", "str", "i64"], [None, StringTable(), None])
    out, mask = chain.apply(
        [torch.zeros(sums.size, dtype=torch.int64), torch.from_numpy(ids),
         torch.from_numpy(sums)], torch.ones(sums.size, dtype=torch.bool))
    assert torch.get_default_dtype() == torch.float32  # restored after
    assert chain.out_kinds == ["str", "f64"] and out[1].dtype == torch.float64
    jchain = JChain(jops, ["i64", "str", "i64"], [None, JTable(), None])
    jout, jmask = jax.jit(jchain.apply)(
        [jnp.zeros(sums.size, jnp.int64), jnp.asarray(ids), jnp.asarray(sums)],
        jnp.ones(sums.size, bool))
    _same(out[1], jout[1])
    _same(mask, jmask)
    # the reference's compiler divides by a constant as a multiply by its
    # reciprocal: IEEE division (Python's, Java's) differs in the last bit
    # for some of these values, and so would the port without the rewrite
    ieee = sums * 8.0 / 60 / 1024 / 1024
    assert np.any(ieee != out[1].numpy())
    _same(out[1], sums * 8.0 * (1 / 60) * (1 / 1024) * (1 / 1024))
    # under torch's float32 default the same function gives other bits:
    # the float64 default inside record functions keeps parity
    f32 = (torch.from_numpy(sums) * 8.0 / 60 / 1024 / 1024).to(torch.float64)
    assert not np.array_equal(f32.numpy(), out[1].numpy())


def test_chain_broadcasts_constants_and_keeps_string_literals():
    from tpustream_torch.records import StringTable

    table = StringTable()
    table.intern("a")
    T2 = tpustream_torch.Tuple2
    chain = DeviceChain(
        [("map", lambda t: T2(t.f0, 1)), ("filter", lambda t: t.f0 != "a")],
        ["str", "f64"], [table, None])
    assert chain.out_kinds == ["str", "i64"]
    out, mask = chain.apply(
        [torch.tensor([0, 1, 0], dtype=torch.int32), torch.zeros(3, dtype=torch.float64)],
        torch.tensor([True, True, False]))
    assert out[1].tolist() == [1, 1, 1] and out[1].dtype == torch.int64
    assert mask.tolist() == [False, True, False]
