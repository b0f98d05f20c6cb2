"""The port's emission formatter (``runtime/sinks.py::EmissionFormatter``),
which turns a step's emission columns into rows a whole column at a
time, held against the value-by-value conversion it replaced (the
oracle below, written out here): for every kind, the dtypes the programs
emit, each table class, arities 1-5 and up, and zero rows, each row's
class and each field's Python type and value are the oracle's, floats
bit for bit. Besides: ``rows`` stays lazy; a wrapper of ``rows`` (the
benchmark's ``answer_altered`` fault) still reaches the sink; the
public ``Tuple2``-``Tuple4`` keep their behaviour; ``DerivedKeyTable``'s
column lookup gives
the original values, as its ``lookup`` does; and ``print()`` bytes at
parallelism 4, a late-data side output's included, equal the JAX
package's. Tolerance: none; every comparison is exact."""

import struct
from importlib import import_module
from itertools import islice

import numpy as np
import pytest

import tpustream
import tpustream_torch
import tpustream_torch.jobs.chapter2_max as torch_ch2
import tpustream_torch.native as native
import tpustream_torch.runtime.sources as torch_sources
from tpustream_torch.api.tuples import (TUPLE_CLASSES, Tuple2, Tuple3,
                                        Tuple4, make_tuple)
from tpustream_torch.records import BOOL, F64, I64, STR, DerivedKeyTable, StringTable
from tpustream_torch.runtime.sinks import EmissionFormatter


def oracle(kinds, tables, cols):
    """The conversion value by value: one Python call a value, one
    ``make_tuple`` a row."""
    n = len(cols[0]) if cols else 0
    converted = []
    for kind, col, table in zip(kinds, cols, tables):
        if kind == STR:
            converted.append(
                [table.lookup(int(i)) if int(i) >= 0 else None for i in col])
        elif kind == F64:
            converted.append([float(v) for v in col])
        elif kind == BOOL:
            converted.append([bool(v) for v in col])
        else:
            converted.append([int(v) for v in col])
    out = []
    for j in range(n):
        vals = tuple(c[j] for c in converted)
        if len(vals) == 1:
            out.append(vals[0])
        elif len(vals) <= 4:
            out.append(make_tuple(*vals))
        else:
            out.append(vals)
    return out


def same_value(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return struct.pack("<d", a) == struct.pack("<d", b)
    return a == b


def assert_rows_equal(got, want):
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        assert type(g) is type(w), (j, g, w)
        if isinstance(w, (tuple, Tuple2, Tuple3, Tuple4)):
            assert len(g) == len(w)
            for f, (x, y) in enumerate(zip(g, w)):
                assert same_value(x, y), (j, f, x, y)
        else:
            assert same_value(g, w), (j, g, w)


# -- columns -----------------------------------------------------------------

def _bits64(*words):
    return np.array(words, dtype=np.uint64).view(np.float64)


def _bits32(*words):
    return np.array(words, dtype=np.uint32).view(np.float32)


FLOAT64 = np.concatenate([
    np.array([0.0, -0.0, 1.5, np.inf, -np.inf, 86.26666666666667, 1e308,
              5e-324, 2.2250738585072014e-308 / 3, -7.25e-310]),
    _bits64(0x7FF8000000000123, 0xFFF0000000000001, 0x7FF4000000000000),
])
FLOAT32 = np.concatenate([
    np.array([0.0, -0.0, 0.1, np.inf, -np.inf, 3.4e38, 1e-45, -1.2e-39],
             dtype=np.float32),
    _bits32(0x7FC00123, 0xFF800001),
])


def _string_table():
    t = StringTable()
    for s in ("10.8.22.1", "cpu0", "", "www.ch1.com", "é"):
        t.intern(s)
    return t


def _derived_table():
    t = DerivedKeyTable()
    for v in ("a", 5, 2.5, True, "5", 1, -0.0):
        t.intern_value(v)
    return t


def _native_table():
    """The Python table behind a native parser's ``NativeTable``, filled
    by a native parse."""
    if not native.available():
        pytest.skip(f"native parser failed to build: {native.build_error()}")
    p = native.NativeParser(" ", [(1, native.KIND_STR, 0)], [StringTable()])
    ids, bad = p.parse(b"1 b\n2 a\n3 b\n4 c\n", 4, threads=1)
    assert bad == 0 and ids[0].tolist() == [0, 1, 0, 2]
    return p.tables[0].py_table


# name -> (kind, column, table factory)
COLUMNS = {
    "str_int32": (STR, np.array([0, 3, -1, 1, 4, 2, -1], np.int32), _string_table),
    "str_int64": (STR, np.array([4, -1, 0, 2], np.int64), _string_table),
    "str_all_absent": (STR, np.array([-1, -1], np.int32), _string_table),
    "str_derived": (STR, np.array([0, 1, 2, 3, 4, 5, 6, 7, -1], np.int32),
                    _derived_table),
    "str_native": (STR, np.array([2, 0, 1, -1], np.int32), _native_table),
    "f64_float64": (F64, FLOAT64, None),
    "f64_float32": (F64, FLOAT32, None),
    "f64_int64": (F64, np.array([0, -3, 2**53 + 1, 2**63 - 1], np.int64), None),
    "bool_bool": (BOOL, np.array([True, False, True]), None),
    "bool_uint8": (BOOL, np.array([0, 1, 2, 255], np.uint8), None),
    "bool_int32": (BOOL, np.array([-1, 0, 7], np.int32), None),
    "bool_float64": (BOOL, np.array([0.0, -0.0, np.nan, 0.5]), None),
    "int_int32": (I64, np.array([-2**31, -1, 0, 2**31 - 1], np.int32), None),
    "int_int64": (I64, np.array([-2**63, 0, 2**63 - 1], np.int64), None),
    "int_uint8": (I64, np.array([0, 255], np.uint8), None),
    "int_bool": (I64, np.array([True, False]), None),
    "int_float64": (I64, np.array([2.7, -2.7, -0.0, 1e20]), None),
    "int_float32": (I64, np.array([2.5, -1e10], np.float32), None),
}


def _column(name, n=None):
    kind, col, make = COLUMNS[name]
    if n is not None:
        col = np.resize(col, n)
    return kind, col, None if make is None else make()


@pytest.mark.parametrize("name", sorted(COLUMNS))
def test_each_kind_and_dtype_as_the_value_by_value_oracle(name):
    kind, col, table = _column(name)
    got = list(EmissionFormatter([kind], [table]).rows([col]))
    assert_rows_equal(got, oracle([kind], [table], [col]))


ARITIES = {
    2: ("str_int32", "f64_float64"),
    3: ("str_derived", "str_int32", "f64_float32"),
    4: ("str_native", "int_int64", "bool_uint8", "f64_float64"),
    5: ("str_int64", "int_int32", "int_int32", "bool_bool", "f64_float64"),
    7: ("int_int64", "str_int32", "str_derived", "f64_float32", "bool_int32",
        "int_float64", "int_uint8"),
}


@pytest.mark.parametrize("n", [0, 1, 13])
@pytest.mark.parametrize("arity", sorted(ARITIES))
def test_each_arity_as_the_oracle(arity, n):
    kinds, cols, tables = zip(*(_column(c, n) for c in ARITIES[arity]))
    got = list(EmissionFormatter(list(kinds), list(tables)).rows(list(cols)))
    want = oracle(kinds, tables, cols)
    assert_rows_equal(got, want)
    want_type = {2: Tuple2, 3: Tuple3, 4: Tuple4}.get(arity, tuple)
    assert all(type(r) is want_type for r in got)


def test_zero_rows_at_arity_one():
    fmt = EmissionFormatter([STR], [_string_table()])
    assert list(fmt.rows([np.empty(0, np.int32)])) == []


@pytest.mark.parametrize("arity", [2, 3, 4])
def test_public_tuples_keep_their_behaviour(arity):
    cls = TUPLE_CLASSES[arity]
    vals = ("h", "cpu0", 80.5, True)[:arity]
    t = cls(*vals)
    assert type(t) is cls and t == vals and hash(t) == hash(vals)
    assert t == make_tuple(*vals) and t.values() == vals and len(t) == arity
    assert vars(t) == dict(zip(cls._FIELDS, vals))
    assert repr(t) == "(" + ",".join(("h", "cpu0", "80.5", "true")[:arity]) + ")"
    t[1] = "cpu1"
    assert t.f1 == "cpu1"
    for n in (arity - 1, arity + 1):
        with pytest.raises(TypeError,
                           match=f"Tuple{arity} expects {arity} values, got {n}"):
            cls(*("x",) * n)


def test_rows_are_built_lazily(monkeypatch):
    built = []

    def counting(*vals):
        built.append(1)
        return Tuple3(*vals)

    monkeypatch.setitem(TUPLE_CLASSES, 3, counting)
    kinds, cols, tables = zip(*(_column(c, 2000) for c in ARITIES[3]))
    it = EmissionFormatter(list(kinds), list(tables)).rows(list(cols))
    assert not built
    first = list(islice(it, 512))
    assert len(first) == 512 and len(built) == 512
    list(islice(it, 512))
    assert len(built) == 1024
    assert len(list(it)) == 2000 - 1024 and len(built) == 2000


@pytest.mark.parametrize("as_list", [False, True])
def test_derived_key_table_column_lookup_gives_the_originals(as_list):
    t = _derived_table()
    ids = np.arange(len(t), dtype=np.int32)
    got = t.lookup_many(ids.tolist() if as_list else ids)
    want = [t.lookup(i) for i in range(len(t))]
    assert [(type(v), v) for v in got] == [(type(v), v) for v in want]
    assert got[0] is None  # the placeholder
    assert got[1:5] == ["a", 5, 2.5, True] and type(got[4]) is bool
    # never the canonical strings the values were interned under
    assert got != [t._to_str[i] for i in range(len(t))]


@pytest.mark.parametrize("make", [_string_table, _native_table])
def test_string_table_column_lookup_agrees_with_lookup(make):
    t = make()
    ids = np.arange(len(t), dtype=np.int64)[::-1]
    assert t.lookup_many(ids) == [t.lookup(int(i)) for i in ids]


# -- through a job -----------------------------------------------------------

CH2_LINES = [f"{i} 10.8.22.{i % 5} cpu{i % 3} {30 + ((i * 11) % 60)}.5"
             for i in range(200)]


def _run_ch2(lines):
    env = tpustream_torch.StreamExecutionEnvironment(
        tpustream_torch.StreamConfig(device="cpu", batch_size=64))
    h = torch_ch2.build(env, env.add_source(
        torch_sources.ReplaySource(lines))).collect()
    env.execute("ComputeCpuMax")
    return h.items


def test_a_wrapper_of_rows_still_reaches_the_sink(monkeypatch):
    """The pattern of the benchmark's ``answer_altered`` fault: a
    wrapper of ``EmissionFormatter.rows`` that alters the first row."""
    plain_rows = _run_ch2(CH2_LINES)
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
    altered = _run_ch2(CH2_LINES)
    assert len(done) == 1 and len(altered) == len(plain_rows) == 200
    assert altered[0] != plain_rows[0]
    assert altered[0].f2 == plain_rows[0].f2 + 1.0
    assert altered[1:] == plain_rows[1:]


def ch2_max(pkg, text):
    mod = import_module(pkg.__name__ + ".jobs.chapter2_max")
    return mod.build(None, text), None


def ch3_late(pkg, text):
    """Chapter 3's event-time job with its late rows to a side output:
    1-minute windows every 30 s, 10 s out of order, no lateness."""
    mod = import_module(pkg.__name__ + ".jobs.chapter3_bandwidth_eventtime")
    tag = import_module(pkg.__name__ + ".api.output").OutputTag("late-data")
    summed = (
        text.assign_timestamps_and_watermarks(
            mod.IsoTimestampExtractor(pkg.Time.seconds(10)))
        .map(mod.parse)
        .key_by(1)
        .time_window(pkg.Time.minutes(1), pkg.Time.seconds(30))
        .side_output_late_data(tag)
        .reduce(lambda a, b: pkg.Tuple3(a.f0, a.f1, a.f2 + b.f2))
    )
    alerts = summed.map(lambda t: pkg.Tuple2(t.f1, t.f2 * 8.0 / 60 / 1024 / 1024))
    return alerts, summed.get_side_output(tag)


def ch3_lines():
    """Ordered polls of 6 channels, one every 20 s, with every 9th line
    10 minutes behind the stream: late past its windows' ends."""
    out = []
    for i in range(240):
        s = 3600 + 20 * i - (600 if i % 9 == 8 else 0)
        out.append(f"2019-08-28T{10 + s // 3600:02d}:{s // 60 % 60:02d}:{s % 60:02d} "
                   f"www.ch{i % 6}.com {100 + (i * 37) % 900}")
    return out


def _printed(pkg, build, lines, capsys, **cfg):
    sources = import_module(pkg.__name__ + ".runtime.sources")
    if pkg is tpustream_torch:
        cfg["device"] = "cpu"
    env = pkg.StreamExecutionEnvironment(pkg.StreamConfig(**cfg))
    env.set_stream_time_characteristic(pkg.TimeCharacteristic.EventTime)
    main, late = build(pkg, env.add_source(sources.ReplaySource(lines)))
    main.print()
    if late is not None:
        late.print()
    capsys.readouterr()
    env.execute("emit-format")
    return capsys.readouterr().out, env.metrics.late_dropped


@pytest.mark.parametrize("job", ["ch2_max", "ch3_late"])
def test_print_bytes_at_parallelism_4_equal_the_jax_package(job, capsys):
    build, lines = {"ch2_max": (ch2_max, CH2_LINES),
                    "ch3_late": (ch3_late, ch3_lines())}[job]
    cfg = dict(parallelism=4, batch_size=16, key_capacity=64)
    want, want_dropped = _printed(tpustream, build, lines, capsys, **cfg)
    got, got_dropped = _printed(tpustream_torch, build, lines, capsys, **cfg)
    assert got == want and got_dropped == want_dropped == 0
    prefixes = {line.split("> ", 1)[0] for line in got.splitlines()}
    assert prefixes == {"1", "2", "3", "4"}
    if job == "ch3_late":
        # the side output's rows, each a late record's (epoch s, channel, bytes)
        # (line 8 rides the first batch, before any watermark: on time)
        late = [ln for ln in got.splitlines() if ln.count(",") == 2]
        assert len(late) == sum(1 for i in range(16, 240) if i % 9 == 8)
