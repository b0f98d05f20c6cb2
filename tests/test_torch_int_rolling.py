"""Rolling ``max``/``min``/``sum`` over integer fields through the
PyTorch port, on the CPU, against the JAX package: seeded jobs side by
side (identical rows and ``print()`` bytes), ``key_by(p).sum(p)``, a sum
that wraps past the int64 range, the rolling job of
tests/test_pipeline_parity.py, the plain int64 keyed reduce against a
sequential numpy fold, and the reference's int64 word planes carried
into the port's state. Tolerance: bitwise everywhere."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tpustream
import tpustream.runtime.sources as jax_sources
import tpustream_torch
import tpustream_torch.runtime.sources as torch_sources
from tpustream.ops import rolling as R
from tpustream_torch.ops import rolling as TR
from tpustream_torch.ops import seq_rolling as S

CPU = torch.device("cpu")
I64_MAX = 2**63 - 1


def side_by_side(build, lines, capsys, **cfg):
    """``build(pkg, text)``'s stream in the JAX package and in the port
    over the same lines: ``[(rows, print bytes, summary)]``, JAX first."""
    out = []
    for pkg, sources, extra in ((tpustream, jax_sources, {}),
                                (tpustream_torch, torch_sources, {"device": "cpu"})):
        env = pkg.StreamExecutionEnvironment(
            pkg.StreamConfig(print_parallelism=4, **cfg, **extra))
        stream = build(pkg, env.add_source(sources.ReplaySource(lines)))
        handle = stream.collect()
        stream.print()
        capsys.readouterr()
        env.execute("int-rolling")
        out.append(([repr(t) for t in handle.items], capsys.readouterr().out,
                    env.metrics.summary()))
    return out


def seeded_lines(n, seed, lo=-10**6, hi=10**6, hosts=9):
    rng = np.random.default_rng(seed)
    return [f"{i} h{h} {v}" for i, (h, v) in enumerate(
        zip(rng.integers(0, hosts, n).tolist(), rng.integers(lo, hi, n).tolist()))]


def parse_long(pkg):
    def parse(line):
        items = line.split(" ")
        return pkg.Tuple3(items[1], int(items[0]) % 4, int(items[2]))
    return parse


@pytest.mark.parametrize("batch_size", [1, 3, 64])
@pytest.mark.parametrize("kind", ["sum", "max", "min"])
def test_int_rolling_side_by_side(kind, batch_size, capsys):
    lines = seeded_lines(150, seed=batch_size)

    def build(pkg, text):
        return getattr(text.map(parse_long(pkg)).key_by(0), kind)(2)

    (jrows, jout, _), (trows, tout, _) = side_by_side(
        build, lines, capsys, batch_size=batch_size)
    assert len(jrows) == len(lines) and trows == jrows and tout == jout


@pytest.mark.parametrize("batch_size", [1, 3, 64])
def test_int_key_field_summed_by_itself(batch_size, capsys):
    # key_by(p).sum(p): the emitted key field is the running sum, not
    # the key (the keyed column is not key-invariant here)
    def build(pkg, text):
        return text.map(parse_long(pkg)).key_by(1).sum(1)

    (jrows, jout, _), (trows, tout, _) = side_by_side(
        build, seeded_lines(90, seed=5), capsys, batch_size=batch_size,
        key_capacity=16)
    assert trows == jrows and tout == jout
    assert any(int(r.split(",")[1]) >= 4 for r in trows)


@pytest.mark.parametrize("batch_size", [1, 3, 64])
def test_int_sum_wraps_like_the_reference(batch_size, capsys):
    # values near INT64_MAX: the running sums wrap in two's complement,
    # as the JAX package's int64 sum and Java's long do
    lines = seeded_lines(70, seed=9, lo=I64_MAX - 10**6, hi=I64_MAX, hosts=3)

    def build(pkg, text):
        return text.map(parse_long(pkg)).key_by(0).sum(2)

    (jrows, jout, _), (trows, tout, _) = side_by_side(
        build, lines, capsys, batch_size=batch_size)
    assert trows == jrows and tout == jout
    assert any(int(r.rsplit(",", 1)[1][:-1]) < 0 for r in trows)


def test_pipeline_parity_rolling_job(capsys):
    # tests/test_pipeline_parity.py's keyed rolling sum over an int field
    lines = [f"1 k{i % 5} {(i * 7) % 97}" for i in range(40)]

    def build(pkg, text):
        def parse(line):
            items = line.split(" ")
            return pkg.Tuple2(items[1], int(items[2]))
        return text.map(parse).key_by(0).sum(1)

    (jrows, jout, js), (trows, tout, ts) = side_by_side(
        build, lines, capsys, batch_size=4)
    assert trows == jrows and tout == jout and len(trows) == 40
    assert ts["records_emitted"] == js["records_emitted"] == 40


def fold(plane, keys, vals, op):
    """Sequential record-at-a-time fold in Python ints, wrapped to int64."""
    plane = [int(p) for p in plane]
    emis = []
    for k, v in zip(keys.tolist(), vals.tolist()):
        if k < 0:
            emis.append(v)
            continue
        a = plane[k]
        if op == "sum":
            r = (a + v + 2**63) % 2**64 - 2**63
        else:
            r = max(a, v) if op == "max" else min(a, v)
        plane[k] = r
        emis.append(r)
    return np.array(plane, np.int64), np.array(emis, np.int64)


@pytest.mark.parametrize("op", ["max", "min", "sum"])
@pytest.mark.parametrize("scale", ["small", "near-max"])
def test_plain_int64_matches_sequential_fold(op, scale):
    rng = np.random.default_rng(17)
    B, K = 700, 50
    keys = rng.integers(-1, K, B).astype(np.int32)
    if scale == "small":
        vals = rng.integers(-1000, 1000, B)
    else:
        vals = rng.integers(I64_MAX - 2**40, I64_MAX, B, dtype=np.int64)
        vals[::2] = -vals[::2]
    plane = rng.integers(-5, 5, K).astype(np.int64)
    plane[rng.random(K) < 0.5] = S.IDENTITY[torch.int64][op]
    want_plane, want_emis = fold(plane, keys, vals, op)
    tplane = torch.from_numpy(plane.copy())
    got = S.seq_rolling_reduce(tplane, torch.from_numpy(keys),
                               torch.from_numpy(vals), op).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(got, want_emis)
    assert np.array_equal(tplane.numpy(), want_plane)


INT_KINDS = ["str", "i64", "i64"]
POS, KEY_COL = 2, 0


def _batches(seed, n, B=40, K=32):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, min(K, 8 * (b + 1)), B).astype(np.int32),
             rng.integers(-2**40, 2**40, B), rng.integers(-2**62, 2**62, B),
             rng.random(B) > 0.1) for b in range(n)]


def _jax_step(state, batch, kind):
    keys, tag, vals, valid = batch
    state, emis, sv, sk, inv = R.rolling_step(
        state, jnp.asarray(keys),
        (jnp.asarray(keys), jnp.asarray(tag), jnp.asarray(vals)),
        jnp.asarray(valid), R.make_combiner(kind, POS), INT_KINDS,
        rolling_kind=kind, rolling_pos=POS, key_col=KEY_COL,
        key_emit=lambda s: s.astype(jnp.int32),
    )
    inv = np.asarray(inv)
    return state, [np.asarray(e)[inv] for e in emis]


def _torch_step(state, batch, kind):
    keys, tag, vals, valid = batch
    t = torch.from_numpy
    state, emis = TR.rolling_step(
        state, t(keys), (t(keys), t(tag), t(vals)), t(valid), INT_KINDS,
        kind, POS, key_col=KEY_COL, key_emit=lambda k: k.to(torch.int32))
    return state, [e.numpy() for e in emis]


@pytest.mark.parametrize("kind", ["max", "min", "sum"])
def test_int_state_from_the_jax_package(kind):
    # batches through the reference, its int64 word planes converted into
    # the port's one int64 plane, the next batches through both
    batches = _batches(41, 5)
    jstate = R.init_rolling_state(32, INT_KINDS)
    for batch in batches[:3]:
        jstate, _ = _jax_step(jstate, batch, kind)
    state_np = {"seen": np.asarray(jstate["seen"]),
                "planes": [np.asarray(p) for p in jstate["planes"]]}
    tstate = TR.state_from_jax_numpy(state_np, INT_KINDS, kind, POS, None, CPU)
    agg = tstate["planes"][3]
    assert agg.dtype == torch.int64 and len(tstate["planes"]) == 4
    assert np.all(agg.numpy()[~state_np["seen"]] == S.IDENTITY[torch.int64][kind])
    for batch in batches[3:]:
        jstate, want = _jax_step(jstate, batch, kind)
        tstate, got = _torch_step(tstate, batch, kind)
        for g, w in zip(got, want):
            assert np.array_equal(g[batch[3]], w[batch[3]])
