"""The port's rolling step (tpustream_torch/ops/rolling.py) against the
reference ``rolling_step`` commutative path (tpustream/ops/rolling.py),
batch by batch, with the chapter-2 record layout of bench.py's rolling
configuration: kinds [str, str, f64], keyed on leaf 0, the cpu leaf as
the occupancy sentinel, aggregating leaf 2.

The reference emits in key-sorted order with ``inv`` to undo it; the
port emits in arrival order. Tolerances: max/min exact (same bits);
float64 sum ``rtol=1e-12``, because the reference adds a key's rows
within a batch in associative-scan tree order and the port in arrival
order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpustream.ops import rolling as R
from tpustream_torch.ops import rolling as TR

KINDS = ["str", "str", "f64"]
POS, KEY_COL, SENTINEL = 2, 0, 1
K, B = 64, 48
CPU = torch.device("cpu")


def _batches(seed, n):
    """``n`` batches over a growing key range, so each mixes keys seen in
    earlier batches with new ones; a few rows are padding."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        hi = min(K, 16 * (b + 1))
        keys = rng.integers(0, hi, B).astype(np.int32)
        cpu = rng.integers(0, 8, B).astype(np.int32)
        usage = rng.integers(0, 10000, B) / 100.0
        valid = rng.random(B) > 0.1
        out.append((keys, cpu, usage, valid))
    return out


def _jax_step(state, batch, kind):
    keys, cpu, usage, valid = batch
    state, emis, sv, sk, inv = R.rolling_step(
        state, jnp.asarray(keys),
        (jnp.asarray(keys), jnp.asarray(cpu), jnp.asarray(usage)),
        jnp.asarray(valid), R.make_combiner(kind, POS), KINDS,
        rolling_kind=kind, rolling_pos=POS, key_col=KEY_COL,
        key_emit=lambda s: s.astype(jnp.int32), sentinel_leaf=SENTINEL,
    )
    inv = np.asarray(inv)
    return state, [np.asarray(e)[inv] for e in emis]


def _torch_step(state, batch, kind):
    keys, cpu, usage, valid = batch
    t = torch.from_numpy
    state, emis = TR.rolling_step(
        state, t(keys), (t(keys), t(cpu), t(usage)), t(valid), KINDS,
        kind, POS, key_col=KEY_COL, key_emit=lambda k: k.to(torch.int32),
        sentinel_leaf=SENTINEL,
    )
    return state, [e.numpy() for e in emis]


def _check_rows(got, want, valid, kind):
    for g, w in zip(got, want):
        g, w = g[valid], w[valid]
        if kind == "sum" and g.dtype == np.float64:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            assert g.dtype == w.dtype
            assert np.array_equal(g, w)


def _check_state(tstate, jstate, kind):
    jplanes = [np.asarray(p) for p in jstate["planes"]]
    tplanes = [p.numpy() for p in tstate["planes"]]
    seen = jplanes[SENTINEL] >= 0
    for i, (tp, jp) in enumerate(zip(tplanes, jplanes)):
        if i == POS:
            # the reference leaves unseen rows at 0, the port at identity
            assert np.all(tp[~seen] == TR.IDENTITY[torch.float64][kind])
            tp, jp = tp[seen], jp[seen]
            if kind == "sum":
                np.testing.assert_allclose(tp, jp, rtol=1e-12, atol=0)
                continue
        assert np.array_equal(tp, jp)


@pytest.mark.parametrize("kind", ["max", "min", "sum"])
def test_rolling_step_matches_reference(kind):
    jstate = R.init_rolling_state(K, KINDS, sentinel_leaf=SENTINEL)
    tstate = TR.init_rolling_state(K, KINDS, kind, POS, SENTINEL, CPU)
    for batch in _batches(21, 5):
        jstate, want = _jax_step(jstate, batch, kind)
        tstate, got = _torch_step(tstate, batch, kind)
        _check_rows(got, want, batch[3], kind)
        _check_state(tstate, jstate, kind)


@pytest.mark.parametrize("kind", ["max", "sum"])
def test_state_carries_over_from_reference(kind):
    # three batches through the reference, its state converted, the
    # fourth batch through both packages
    batches = _batches(33, 4)
    jstate = R.init_rolling_state(K, KINDS, sentinel_leaf=SENTINEL)
    for batch in batches[:3]:
        jstate, _ = _jax_step(jstate, batch, kind)
    state_np = {
        "seen": np.asarray(jstate["seen"]),
        "planes": [np.asarray(p) for p in jstate["planes"]],
    }
    # the sentinel path never writes "seen": occupancy is the cpu plane
    assert not state_np["seen"].any() and (state_np["planes"][SENTINEL] >= 0).any()
    tstate = TR.state_from_jax_numpy(state_np, KINDS, kind, POS, SENTINEL, CPU)
    assert np.array_equal(tstate["seen"].numpy(), state_np["planes"][SENTINEL] >= 0)
    _check_state(tstate, jstate, kind)
    jstate, want = _jax_step(jstate, batches[3], kind)
    tstate, got = _torch_step(tstate, batches[3], kind)
    _check_rows(got, want, batches[3][3], kind)
    _check_state(tstate, jstate, kind)


def test_state_without_sentinel_uses_seen_bitmap():
    # without a sentinel leaf the reference keeps "seen" itself
    rng = np.random.default_rng(4)
    kinds = ["str", "f64"]
    jstate = R.init_rolling_state(K, kinds)
    keys = rng.integers(0, 20, B).astype(np.int32)
    usage = rng.integers(0, 100, B) / 4.0
    valid = np.ones(B, bool)
    jstate, *_ = R.rolling_step(
        jstate, jnp.asarray(keys), (jnp.asarray(keys), jnp.asarray(usage)),
        jnp.asarray(valid), R.make_combiner("min", 1), kinds,
        rolling_kind="min", rolling_pos=1, key_col=0,
        key_emit=lambda s: s.astype(jnp.int32),
    )
    state_np = {"seen": np.asarray(jstate["seen"]),
                "planes": [np.asarray(p) for p in jstate["planes"]]}
    tstate = TR.state_from_jax_numpy(state_np, kinds, "min", 1, None, CPU)
    seen = state_np["seen"]
    assert np.array_equal(tstate["seen"].numpy(), seen)
    agg = tstate["planes"][1].numpy()
    assert np.array_equal(agg[seen], state_np["planes"][1][seen])
    assert np.all(agg[~seen] == np.inf)


def test_general_rolling_path_not_ported():
    """The general path under the 32-bit ``acc_dtype`` modes: they no
    longer refuse. As in the JAX package, 32-bit storage covers only the
    aggregated field of max/min/sum, so ``max_by`` keeps its exact state
    and gives the JAX package's rows, equal to the float64 run's."""
    import tpustream
    import tpustream.jobs.chapter2_max as jax_ch2
    import tpustream.runtime.sources as jax_sources
    import tpustream_torch
    import tpustream_torch.jobs.chapter2_max as torch_ch2
    import tpustream_torch.runtime.sources as torch_sources

    lines = [f"{i} h{i % 3} cpu{i % 2} {(i * 37) % 100 + 0.125}"
             for i in range(12)]

    def run(pkg, job, sources, **cfg):
        env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(
            batch_size=4, **cfg))
        h = (env.add_source(sources.ReplaySource(lines)).map(job.parse)
             .key_by(0).max_by(2).collect())
        env.execute("k")
        return [repr(t) for t in h.items]

    exact = run(tpustream_torch, torch_ch2, torch_sources, device="cpu")
    for acc in ("int32", "float32"):
        got = run(tpustream_torch, torch_ch2, torch_sources, device="cpu",
                  acc_dtype=acc)
        want = run(tpustream, jax_ch2, jax_sources, acc_dtype=acc)
        assert got == want == exact


# -- the general path (max_by, min_by, a user reduce) ----------------------

def _jax_general(state, batch, kind):
    keys, cpu, usage, valid = batch
    state, emis, sv, sk, inv = R.rolling_step(
        state, jnp.asarray(keys),
        (jnp.asarray(keys), jnp.asarray(cpu), jnp.asarray(usage)),
        jnp.asarray(valid), R.make_combiner(kind, POS), KINDS,
        rolling_kind=kind, rolling_pos=POS,
    )
    inv = np.asarray(inv)
    return state, [np.asarray(e)[inv] for e in emis]


def _torch_general(state, batch, kind):
    keys, cpu, usage, valid = batch
    t = torch.from_numpy
    state, emis = TR.rolling_step_general(
        state, t(keys), (t(keys), t(cpu), t(usage)), t(valid),
        TR.make_combiner(kind, POS), KINDS,
    )
    return state, [e.numpy() for e in emis]


def _check_general_state(tstate, jstate):
    assert np.array_equal(tstate["seen"].numpy(), np.asarray(jstate["seen"]))
    for tp, jp in zip(tstate["planes"], jstate["planes"]):
        assert np.array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("kind", ["max_by", "min_by"])
def test_general_rolling_step_matches_reference(kind):
    # rows in arrival order (the reference's un-permuted with its inv) and
    # the state planes, bitwise
    jstate = R.init_rolling_state(K, KINDS)
    tstate = TR.init_rolling_state(K, KINDS, kind, POS, None, CPU)
    for batch in _batches(41, 5):
        jstate, want = _jax_general(jstate, batch, kind)
        tstate, got = _torch_general(tstate, batch, kind)
        _check_rows(got, want, batch[3], kind)
        _check_general_state(tstate, jstate)


@pytest.mark.parametrize("kind", ["max_by", "min_by"])
def test_general_state_carries_over_from_reference(kind):
    # three batches through the reference, its state carried across, the
    # fourth batch through both packages
    batches = _batches(43, 4)
    jstate = R.init_rolling_state(K, KINDS)
    for batch in batches[:3]:
        jstate, _ = _jax_general(jstate, batch, kind)
    state_np = {"seen": np.asarray(jstate["seen"]),
                "planes": [np.asarray(p) for p in jstate["planes"]]}
    assert state_np["seen"].any()
    tstate = TR.state_from_jax_numpy(state_np, KINDS, kind, POS, None, CPU)
    _check_general_state(tstate, jstate)
    jstate, want = _jax_general(jstate, batches[3], kind)
    tstate, got = _torch_general(tstate, batches[3], kind)
    _check_rows(got, want, batches[3][3], kind)
    _check_general_state(tstate, jstate)


def test_wordplanes_match_reference_layout():
    # the same leaves pack into the same planes, bit for bit, in both
    # packages, and unpack back to the leaves
    from tpustream.ops import wordplanes as JW
    from tpustream_torch.ops import wordplanes as TW

    rng = np.random.default_rng(6)
    kinds = ["i64", "f64", "str", "bool", "i64"]
    cols = [
        rng.integers(-2**62, 2**62, 32, dtype=np.int64),
        rng.standard_normal(32),
        rng.integers(0, 1000, 32).astype(np.int32),
        rng.random(32) < 0.5,
        np.array([-1, 0, 2**31, -2**31, 2**32 - 1] * 6 + [7, -7], np.int64),
    ]
    assert [str(d).replace("torch.", "") for d in TW.plane_dtypes(kinds)] == [
        np.dtype(d).name for d in JW.plane_dtypes(kinds)]
    assert TW.leaf_plane_slices(kinds) == JW.leaf_plane_slices(kinds)
    want = [np.asarray(w) for w in JW.pack_words([jnp.asarray(c) for c in cols], kinds)]
    got = TW.pack_words([torch.from_numpy(c) for c in cols], kinds)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    for c, back in zip(cols, TW.unpack_words(got, kinds)):
        assert np.array_equal(back.numpy(), c)
