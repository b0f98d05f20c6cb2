"""The generator: deterministic by seed, its bytes say what its arrays
say, and the committed cells' traffic holds its parameters."""

import datetime
import json

import numpy as np
import pytest

from streambench.harness import HERE as BENCH, Cell
from streambench.lines import centi, decimal

CELLS = ("bandwidth_eventtime.poll300s", "cpu_max.fleet128k")


def cell_traffic(name, seed, manifest=None):
    cell = Cell(name) if manifest is None else Cell(
        name, manifest, manifest.parent / "streambench")
    return cell, cell.traffic(seed)


def parse_lines(raw: bytes):
    return [ln.split(" ") for ln in raw.decode().split("\n")[:-1]]


def test_decimal_and_centi_render_as_python_does():
    v = np.array([0, 5, 10, 99, 100, 1234, 9999, 2**36 - 1], np.int64)
    got = [bytes(r[r != 0]).decode() for r in decimal(v)]
    assert got == [str(x) for x in v.tolist()]
    assert [bytes(r[r != 0]).decode() for r in decimal(v[:4], 7)] == [
        f"{x:07d}" for x in v[:4].tolist()]
    u = np.arange(0, 10000, dtype=np.int64)
    assert [bytes(r[r != 0]).decode() for r in centi(u)] == [
        repr(x / 100) for x in u.tolist()]


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_stream_other_seed_other_order(name, tiny):
    _, a = cell_traffic(name, 2**31 + 7, tiny)
    _, b = cell_traffic(name, 2**31 + 7, tiny)
    _, c = cell_traffic(name, 2**33 + 1, tiny)
    for i in (0, 1, a.pool_blocks + 1):
        assert a.block(i) == b.block(i)
    ea, ec = a.events(2 * a.pool_blocks), c.events(2 * c.pool_blocks)
    assert not np.array_equal(ea["key"], ec["key"])
    # the same polls and lines, in another order
    assert np.array_equal(np.sort(ea["key"]), np.sort(ec["key"]))
    assert np.array_equal(np.sort(ea["sub"]), np.sort(ec["sub"]))


@pytest.mark.parametrize("name", CELLS)
def test_bytes_say_what_the_arrays_say(name, tiny):
    cell, t = cell_traffic(name, 123456789012, tiny)
    ev = t.events(2 * t.pool_blocks + 1)
    B = t.batch_size
    tz = datetime.timezone(datetime.timedelta(hours=8))
    for i in (0, t.pool_blocks - 1, t.pool_blocks + 1, 2 * t.pool_blocks):
        rows = parse_lines(t.block(i))
        assert len(rows) == B
        sl = slice(i * B, (i + 1) * B)
        ts, key, sub, val = (ev[k][sl] for k in ("ts", "key", "sub", "value"))
        if name.startswith("bandwidth"):
            assert [r[0] for r in rows] == [
                datetime.datetime.fromtimestamp(int(x), tz).strftime(
                    "%Y-%m-%dT%H:%M:%S") for x in ts]
            assert [r[1] for r in rows] == [f"www.{k:07d}.com" for k in key]
            assert [int(r[2]) for r in rows] == val.tolist()
        else:
            assert [int(r[0]) for r in rows] == ts.tolist()
            assert [r[1] for r in rows] == [
                f"10.{(k >> 16) & 255}.{(k >> 8) & 255}.{k & 255}" for k in key]
            assert [r[2] for r in rows] == [f"cpu{c}" for c in sub]
            assert [float(r[3]) for r in rows] == (val / 100).tolist()


def test_poll300s_holds_its_parameters(full):
    """Every channel once an interval, 1 poll in 128 under the
    threshold, dealt to other channels in each interval, the rest past
    2^31 bytes (so a 32-bit pane sum wraps), out of order by at most
    30 s, and about 7.5 window ends passed a batch."""
    cell, t = cell_traffic("bandwidth_eventtime.poll300s", 2**32 + 3, full)
    p = cell.params
    ev = t.events(3 * t.pool_blocks)
    n, B = t.pool_lines, t.batch_size
    key, flow, ts = ev["key"], ev["value"], ev["ts"]
    alert = flow < 2**31
    alerting = []
    for k in range(3):
        now = slice(k * n, (k + 1) * n)
        assert np.array_equal(np.sort(key[now]), np.arange(p["keys"]))
        assert alert[now].sum() == p["keys"] // 128
        alerting.append(np.sort(key[now][alert[now]]))
        # each block keeps its set of channels, its times and its flows
        for b in range(t.pool_blocks):
            here, first = slice(k * n + b * B, k * n + (b + 1) * B), slice(b * B, (b + 1) * B)
            assert np.array_equal(np.sort(key[here]), np.sort(key[first]))
            assert np.array_equal(flow[here], flow[first])
            assert np.array_equal(ts[here] - ts[first], np.full(B, k * p["interval_s"]))
    assert np.array_equal(alerting[0], np.arange(0, p["keys"], 128))
    # another interval, other alerting channels
    for a, b in ((0, 1), (1, 2), (0, 2)):
        assert np.intersect1d(alerting[a], alerting[b]).size < alerting[a].size // 8
    assert flow[alert].min() >= 10**6 and flow[alert].max() <= 7 * 10**8
    assert flow[~alert].min() >= 2**31 and flow[~alert].max() < 2**36
    late = np.maximum.accumulate(ts) - ts
    assert late.max() <= p["jitter_s"] < cell.config["window"]["delay_s"]
    maxes = np.maximum.accumulate(ts)[B - 1::B]
    w = cell.config["window"]
    ends = (maxes - w["delay_s"]) // w["slide_s"]
    per_batch = np.diff(ends)[1:].mean()
    assert 7.0 <= per_batch <= 8.0


def test_fleet128k_holds_its_parameters(full):
    """Every host's 8 cpu lines together, once every 10 s, the usages
    0.00-99.99, and 16,384 hosts a batch."""
    cell, t = cell_traffic("cpu_max.fleet128k", 2**31 + 99, full)
    ev = t.events(2 * t.pool_blocks)
    key, sub, ts = (ev[k].reshape(-1, 8) for k in ("key", "sub", "ts"))
    assert (key == key[:, :1]).all() and (ts == ts[:, :1]).all()
    assert (sub == np.arange(8)).all()
    hosts = key[:, 0]
    n = cell.params["keys"]
    assert np.array_equal(np.sort(hosts[:n]), np.arange(n))
    first, second = np.empty(n, np.int64), np.empty(n, np.int64)
    first[hosts[:n]], second[hosts[n:]] = ts[:n, 0], ts[n:, 0]
    assert (second - first == cell.params["interval_s"]).all()
    assert ev["value"].min() >= 0 and ev["value"].max() <= 9999
    for i in range(t.pool_blocks):
        assert np.unique(t.block_keys(i)).size == t.batch_size // 8


def test_setup_does_not_grow_with_the_run(tiny):
    """Blocks past the pool replay it: the pool is one interval."""
    _, t = cell_traffic("cpu_max.fleet128k", 5, tiny)
    pool = len(t.pool)
    t.block(10 * t.pool_blocks + 3)
    assert len(t.pool) == pool == t.pool_blocks


def test_committed_cells_name_a_known_generator():
    for name in CELLS:
        params = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
        assert (BENCH / "traffic" / f"{params['generator']}.py").is_file()
