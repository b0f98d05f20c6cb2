"""The wire format of the PyTorch port's executor (``Runner._pack``,
``Runner._decode``), on the CPU, against the JAX package: the five cases
of tests/test_h2d_compress.py. int64 columns and timestamps ship as
16-bit, then 32-bit deltas against a per-batch base, float64 as
exact-round-trip float32, interned string ids as int16, booleans and the
valid mask as bits; a batch whose valid rows no longer fit demotes its
column for good, and the decode step is rebuilt once, recorded under the
cause ``batch_shape_change``. Tolerance: identical rows in every
setting, equal to the JAX package's and to the exact sums."""

import numpy as np
import pytest

import tpustream
import tpustream_torch
from tpustream.runtime.sources import ReplaySource as JaxReplay
from tpustream_torch.config import ObsConfig
from tpustream_torch.runtime.sources import ReplaySource as TorchReplay

PKGS = {"jax": (tpustream, JaxReplay, {}),
        "torch": (tpustream_torch, TorchReplay, {"device": "cpu"})}


def parse_int(pkg):
    def parse(line):
        items = line.split(" ")
        return pkg.Tuple2(items[1], int(items[2]))
    return parse


def parse_float(pkg):
    def parse(line):
        items = line.split(" ")
        return pkg.Tuple2(items[1], float(items[2]))
    return parse


def run(side, lines, batch_size=4, parse=parse_int, obs=False, **cfg):
    """The keyed rolling sum over ``lines`` through one package:
    ``(rows, metrics)``."""
    pkg, replay, base = PKGS[side]
    if obs:
        cfg["obs"] = ObsConfig(enabled=True)
    env = pkg.StreamExecutionEnvironment(
        pkg.StreamConfig(batch_size=batch_size, **cfg, **base))
    handle = (env.add_source(replay(lines)).map(parse(pkg)).key_by(0)
              .sum(1).collect())
    env.execute("h2d")
    return [tuple(t) for t in handle.items], env.metrics


def shape_rebuilds(metrics) -> int:
    """Recompiles with cause ``batch_shape_change`` in the build
    registry (the flight recorder's ``program_compiled`` events)."""
    return sum(1 for e in metrics.job_obs.flight.events()
               if e["kind"] == "program_compiled"
               and e.get("cause") == "batch_shape_change")


def exact_int_sums(lines):
    totals, out = {}, []
    for line in lines:
        _, k, v = line.split(" ")
        totals[k] = totals.get(k, 0) + int(v)
        out.append((k, totals[k]))
    return out


def check(lines, variants, **kw):
    """Rows of the port at the defaults (obs on, for the build registry)
    and at each variant, and of the JAX package: all equal. Returns the
    port's rows and metrics at the defaults."""
    got, m = run("torch", lines, obs=True, **kw)
    assert got == run("jax", lines, **kw)[0]
    for v in variants:
        assert run("torch", lines, **v, **kw)[0] == got, v
    return got, m


def test_mid_stream_span_overflow_demotes_exactly():
    big = 3 << 31
    lines = (
        ["1 a 5", "1 b 7", "1 a 11", "1 b 13"]
        + [f"1 a {big}", f"1 b {-big}", "1 a 17", "1 b 19"]
        + ["1 a 23", "1 b 29", "1 a 31", "1 b 37"]
    )
    got, m = check(lines, [dict(h2d_compress=False)])
    assert got == exact_int_sums(lines)
    # d16 -> raw, once; the later small batches ride the demoted column
    assert shape_rebuilds(m) == 1


def test_d16_span_overflow_demotes_to_d32_exactly():
    lines = (
        ["1 a 5", "1 b 7", "1 a 11", "1 b 13"]
        + ["1 a 100000", "1 b 3", "1 a 200000", "1 b 4"]
        + ["1 a 23", "1 b 29", "1 a 31", "1 b 37"]
    )
    got, m = check(lines, [dict(packed_wire=False),
                           dict(h2d_compress=False, packed_wire=False)])
    assert got == exact_int_sums(lines)
    assert shape_rebuilds(m) == 1


def test_f32_inexact_value_demotes_exactly():
    lines = (
        ["1 a 1.5", "1 b 2.5", "1 a 0.25", "1 b 4.0"]
        + ["1 a 16777217.0", "1 b 0.5", "1 a 1.0", "1 b 2.0"]
        + ["1 a 0.125", "1 b 8.0", "1 a 16.0", "1 b 32.0"]
    )
    got, m = check(lines, [dict(packed_wire=False)], parse=parse_float)
    totals = {}
    for line in lines:
        _, k, v = line.split(" ")
        totals[k] = totals.get(k, 0.0) + float(v)
    assert got[-1] == ("b", totals["b"]) and got[-2] == ("a", totals["a"])
    assert shape_rebuilds(m) == 1


def test_i16_id_overflow_demotes_exactly():
    n = (1 << 15) + 4096  # crosses 32767 in the final batches
    lines = [f"1 k{i} {i % 13}" for i in range(n)]
    cfg = dict(batch_size=4096, key_capacity=1 << 16, alert_capacity=4096)
    got, m = check(lines, [dict(packed_wire=False)], **cfg)
    assert got[-1] == (f"k{n - 1}", (n - 1) % 13)
    assert shape_rebuilds(m) == 1


def test_full_range_column_never_compresses():
    lo, hi = -(2**62), 2**62
    lines = [f"1 a {lo}", f"1 a {hi}", "1 a 1", "1 a 2"]
    got, _ = check(lines, [dict(h2d_compress=False)])
    assert got[-1] == ("a", lo + hi + 1 + 2)


@pytest.mark.parametrize("kind", ["i64", "f64", "str", "bool", "ts"])
def test_pack_then_decode_round_trips_each_mode(kind):
    """Each narrow mode, packed on the host and decoded as the step
    decodes it, gives back the column bit for bit (rows past the batch's
    row count are sliced off the bit unpack)."""
    from tpustream_torch.config import StreamConfig
    from tpustream_torch.runtime.executor import Runner
    from tpustream_torch.runtime.executor import _WireRing
    import types
    import torch

    rng = np.random.default_rng(5)
    n = 13
    col = {
        "i64": rng.integers(1 << 40, (1 << 40) + 60000, n),
        "f64": rng.integers(-1000, 1000, n) / 8.0,
        "str": rng.integers(0, 30000, n).astype(np.int32),
        "bool": rng.random(n) < 0.5,
        "ts": rng.integers(0, 10, n),
    }[kind]
    record_kind = {"i64": "i64", "f64": "f64", "str": "str", "bool": "bool",
                   "ts": "i64"}[kind]
    stub = types.SimpleNamespace(
        cfg=StreamConfig(device="cpu"), _col_modes=None, _ts_mode=None,
        _valid_mode=None, _I32_SPAN=Runner._I32_SPAN,
        _U16_SPAN=Runner._U16_SPAN,
        plan=types.SimpleNamespace(record_kinds=[record_kind]))
    stub._initial_modes = lambda: Runner._initial_modes(stub)
    valid = np.ones(n, dtype=bool)
    valid[3] = False
    ts = np.arange(n, dtype=np.int64) + 1_563_452_000_000
    packed = Runner._pack(stub, [col], valid, ts)
    assert packed.col_modes[0] == {"i64": "d16", "f64": "f32", "str": "i16",
                                   "bool": "bits", "ts": "d16"}[kind]
    up = _WireRing(torch.device("cpu"), 2).put(packed)
    cols, v, t = Runner._decode(None, up)
    assert np.array_equal(cols[0].numpy(), col)
    assert cols[0].numpy().dtype == np.asarray(col).dtype
    assert np.array_equal(v.numpy(), valid)
    assert np.array_equal(t.numpy(), ts)
