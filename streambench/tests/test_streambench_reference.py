"""The plain references against brute-force dict oracles at a tiny
size, on the generator's events and on events drawn to stress them."""

import json

import numpy as np
import pytest

from streambench.harness import HERE as BENCH, load_module


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def reference(name):
    return load_module(BENCH / "reference" / f"{name}.py", f"ref_{name}")


def brute_bandwidth(ts, ch, flow, w):
    slide, n_win = w["slide_s"], w["size_s"] // w["slide_s"]
    sums, rank = {}, {}
    for t, c, f in zip(ts.tolist(), ch.tolist(), flow.tolist()):
        rank.setdefault(c, len(rank))
        p = t // slide
        for end in range(p + 1, p + n_win + 1):
            sums[(end, c)] = sums.get((end, c), 0) + f
    rows = []
    for (end, c), s in sums.items():
        mbps = s * 8.0 * (1 / 60) * (1 / 1024) * (1 / 1024)
        if mbps < w["below_mbps"]:
            rows.append((end, rank[c], f"www.{c:07d}.com", mbps))
    rows.sort()
    return [(r[2], r[3]) for r in rows]


def brute_cpu_max(key, sub, u):
    state, rows = {}, []
    for k, c, v in zip(key.tolist(), sub.tolist(), u.tolist()):
        s = state.setdefault(k, [f"cpu{c}", v])
        s[1] = max(s[1], v)
        rows.append((f"10.{(k >> 16) & 255}.{(k >> 8) & 255}.{k & 255}",
                     s[0], s[1] / 100))
    return rows


def as_rows(cols):
    return list(zip(*[c.tolist() for c in cols]))


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**40 + 3])
def test_bandwidth_reference_matches_brute_force(seed):
    """Flows drawn so that many windows pass, some only just, and some
    hold several panes of one channel."""
    rng = np.random.default_rng(seed)
    n = 3000
    ts = 1566957600 + np.sort(rng.integers(0, 1800, n)) - rng.integers(0, 31, n)
    ch = rng.integers(0, 40, n)
    flow = rng.integers(0, 3 * 10**8, n)
    cfg = config("bandwidth_eventtime")
    want = brute_bandwidth(ts, ch, flow, cfg["window"])
    got = as_rows(reference("bandwidth_eventtime").expected(
        {"ts": ts, "key": ch, "value": flow}, cfg))
    assert len(want) > 1000
    assert got == want


def test_bandwidth_reference_on_the_generator(tiny):
    from streambench.harness import Cell

    cell = Cell("bandwidth_eventtime.poll300s", tiny, tiny.parent / "streambench")
    ev = cell.traffic(77).events(10)
    want = brute_bandwidth(ev["ts"], ev["key"], ev["value"], cell.config["window"])
    got = as_rows(cell.reference().expected(ev, cell.config))
    assert len(want) > 0 and got == want


def test_bandwidth_reference_refuses_negative_flows():
    cfg = config("bandwidth_eventtime")
    ev = {"ts": np.array([1566957600]), "key": np.array([1]),
          "value": np.array([-1])}
    with pytest.raises(ValueError):
        reference("bandwidth_eventtime").expected(ev, cfg)


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_cpu_max_reference_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    n = 5000
    key = rng.integers(0, 300, n) * 4099  # hosts across all three octets
    sub = rng.integers(0, 8, n)
    u = rng.integers(0, 10000, n)
    got = as_rows(reference("cpu_max").expected(
        {"ts": np.zeros(n, np.int64), "key": key, "sub": sub, "value": u},
        config("cpu_max")))
    assert got == brute_cpu_max(key, sub, u)


def test_the_comparison_counts_each_wrong_missing_or_extra_row():
    from tpustream_torch.api.tuples import make_tuple

    from streambench.check import Rows, compare_rows

    want = [np.array(["a", "b", "c", "d"], dtype=object),
            np.array([1.0, 2.0, 0.0, 4.0])]
    def fed(values, sample_all=False):
        rows = Rows()
        if sample_all:
            rows.SAMPLE = 1
        emit = rows.sink()
        for name, v in values:
            emit(make_tuple(name, v))
        return compare_rows(rows, want)

    ok = [("a", 1.0), ("b", 2.0), ("c", 0.0), ("d", 4.0)]
    assert fed(ok)["rows_wrong"] == 0 and fed(ok)["first_wrong"] == -1
    r = fed([("a", 1.0), ("b", 2.5), ("c", 0.0), ("d", 4.0)])
    assert (r["rows_wrong"], r["rows_failed"], r["first_wrong"]) == (1, 1, 1)
    r = fed(ok[:3])
    assert (r["rows_wrong"], r["rows_failed"], r["first_wrong"]) == (1, 1, 3)
    r = fed(ok + [("e", 5.0)])
    assert (r["rows_wrong"], r["rows_failed"]) == (1, 0)
    # a sampled row is held whole: the sign of a zero, an int for a float
    r = fed([("a", 1.0), ("b", 2.0), ("c", -0.0), ("d", 4.0)], sample_all=True)
    assert (r["rows_wrong"], r["sampled_rows_wrong"]) == (0, 1)
    r = fed([("a", 1), ("b", 2.0), ("c", 0.0), ("d", 4.0)], sample_all=True)
    assert (r["rows_wrong"], r["sampled_rows_wrong"]) == (0, 1)
    assert fed(ok, sample_all=True)["sampled_rows_wrong"] == 0


def test_mbps_rounds_as_the_jax_package_not_as_the_java_division():
    """The reference takes Mbps as ``sum * 8.0 * (1/60) * (1/1024) *
    (1/1024)``, as the JAX package does and the port must match bit for
    bit; the published Java divides, ``sum * 8.0 / 60 / 1024 / 1024``.
    On window sums of the cell's flows the two differ in the last bit
    of some rows, so the choice shows in an exact comparison."""
    params = json.loads(
        (BENCH / "workloads" / "bandwidth_eventtime.poll300s.json").read_text())
    gen = load_module(BENCH / "traffic" / "periodic.py", "periodic_mbps")
    key = np.arange(1 << 16, dtype=np.int64)
    rng = np.random.default_rng(2**31 + 5)
    sums = gen.draw_values(params["values"], key, rng)
    sums = sums + gen.draw_values(params["values"], key, rng) * (key % 3 == 0)
    ours = reference("bandwidth_eventtime").mbps(sums)
    java = np.array([s * 8.0 / 60 / 1024 / 1024 for s in sums.tolist()])
    differ = ours != java
    assert differ.any() and not differ.all()
    assert np.all(np.abs(ours - java) <= np.spacing(java))
    # the alerting rows too: those under 100 Mbps
    low = java < float(config("bandwidth_eventtime")["window"]["below_mbps"])
    assert (differ & low).any()
